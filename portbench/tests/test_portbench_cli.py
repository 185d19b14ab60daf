"""The command: without a card it exits with a code other than 0 and prints
no result, in the checkout and in a folder that holds only BENCHMARK.json and
the benchmark's files; it refuses an unknown cell."""

import shutil
import subprocess
import sys

import pytest

from portbench import harness

CELL = ["--workload", "fin5_res8.da_fom", "--seed", "12345678901", "--seconds", "1", "--trace", "0"]


def _run(cwd, args):
    return subprocess.run([sys.executable, "portbench/run.py", *args], cwd=cwd, capture_output=True,
                          text=True, timeout=300)


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here: this test is of the run without one")
    out = _run(harness.ROOT, CELL)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "cuda" in out.stderr.lower()


def test_alone_no_result(tmp_path):
    shutil.copytree(harness.BENCH, tmp_path / "portbench", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = _run(tmp_path, CELL)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_unknown_cell_refused():
    out = _run(harness.ROOT, ["--workload", "nope", "--seed", "1", "--seconds", "1"])
    assert out.returncode != 0 and out.stdout.strip() == ""
