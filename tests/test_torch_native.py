"""The port's native binding (bayesianinferencedl_tpu_torch.native): the
host arrays of the C++ assembler equal the port's NumPy assembler and the
JAX package's binding, to 1e-14 (summation order) at res1 and res2, and
FiveParamFin.create prefers it. Skips only where make or g++ is missing,
as tests/test_native.py does."""

import shutil

import numpy as np
import pytest
import torch

from bayesianinferencedl_tpu.native import assemble_fin_dia_native as j_native
from bayesianinferencedl_tpu_torch.fem.dia import assemble_fin_dia
from bayesianinferencedl_tpu_torch.geometry.mesh import build_fin_mesh
from bayesianinferencedl_tpu_torch.models.five_param import FiveParamFin
from bayesianinferencedl_tpu_torch.native import (
    assemble_fin_dia_native,
    build_native,
    native_available,
)

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs

pytestmark = pytest.mark.skipif(shutil.which("make") is None or shutil.which("g++") is None,
                                reason="native toolchain (make, g++) unavailable")

FIELDS = ("comp_vals", "ext_mass", "fixed", "F_root", "qoi", "qoi_root")


@pytest.mark.parametrize("res", [1, 2])
def test_native_equals_numpy_and_jax_binding(res):
    assert native_available()
    nat = assemble_fin_dia_native(res, pad_to=128)
    ref = assemble_fin_dia(build_fin_mesh(res), pad_to=128)
    jnat = j_native(res, pad_to=128)
    for other in (ref, jnat):
        assert nat.n_grid == other.n_grid and nat.resolution == other.resolution
        np.testing.assert_array_equal(nat.offsets, other.offsets)
        for f in FIELDS:
            np.testing.assert_allclose(getattr(nat, f), getattr(other, f), rtol=0, atol=1e-14,
                                       err_msg=f)


def test_fin_prefers_native_and_build_is_idempotent():
    assert build_native() and build_native()
    fin = FiveParamFin.create(resolution=1, device="cpu", pad_to=128)
    assert fin.assembler == "native"
    ref = assemble_fin_dia(fin.mesh, pad_to=128)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(fin.host, f), getattr(ref, f), rtol=0, atol=1e-14)
