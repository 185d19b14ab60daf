"""The control: the plain reference put in the package's place one precision
below the configuration's (the drivers' ``control``) fails the cell's check,
here at a tiny size on the CPU and, marked ``chip``, at the cells' own size
on a card."""

import pytest

from portbench import control, harness
from portbench.tests.tiny import tiny_run


@pytest.mark.parametrize("cell", ["fin5_res8.da_fom", "fin5_res32.fom_sweep"])
def test_the_control_is_not_correct(cell):
    run, out = tiny_run(cell, 41, seconds=0.5, control=True)
    assert not out["correct"], out["checks"]


@pytest.mark.chip
@pytest.mark.parametrize("cell", ["fin5_res8.da_fom", "fin5_res32.fom_sweep"])
def test_the_control_fails_at_the_cells_size(card, cell):
    spec = harness.load_spec()
    run = control.run_control(harness.find_cell(spec, cell), 9101, 4.0, card)
    assert not harness.correct(run.checks), run.checks
