"""The single layout's route between K4r and K4 (bayesianinferencedl_tpu_torch.ops.pcg_stencil:
``grid_route``, ``grid_strips``, ``resident_bytes``) and the two facts K4r's
design rests on that a CPU can show: the plain version gives the same answer
on the true grid as on the padded one, so K4r may skip the padding; and the
wrapper takes the plain version for CPU tensors.

The route is fed an H100's numbers as arguments (132 SMs, 232,448 bytes of
shared memory a block can opt in to: the hopper-kernels table), never read
from a card. K4r itself runs only on the card, where chip_smoke.py holds it
against the plain version."""

import numpy as np
import pytest
import torch

from bayesianinferencedl_tpu_torch.models.five_param import FiveParamFin
from bayesianinferencedl_tpu_torch.ops import pcg_stencil as K

H100_SM = 132
H100_SMEM = 232_448


def _shape0(res: int) -> tuple[int, int]:
    """The fin's true grid at a resolution: (24 res + 1, 16 res + 1)."""
    return 24 * res + 1, 16 * res + 1


ROUTES = [(22, "resident"), (32, "resident"), (38, "resident"),
          (39, "stream"), (48, "stream"), (64, "stream")]


@pytest.mark.parametrize("res,route", ROUTES, ids=[f"res{r}" for r, _ in ROUTES])
def test_grid_route_on_h100(res, route):
    X0, Y0 = _shape0(res)
    assert K.grid_route(X0, Y0, H100_SM, H100_SMEM) == route
    nbytes = K.resident_bytes(X0, Y0, H100_SM)
    assert (nbytes <= H100_SMEM) == (route == "resident"), nbytes


def test_grid_route_res32_numbers():
    """res32: 769 rows over 132 blocks, 5 or 6 rows of 513 each, ~157 KB a block."""
    X0, Y0 = _shape0(32)
    assert (X0, Y0) == (769, 513)
    sizes = {b - a for a, b in K.grid_strips(X0, H100_SM)}
    assert sizes == {5, 6}
    assert K.resident_bytes(X0, Y0, H100_SM) == 1024 + 4 * (11 * 6 * 513 + 8 * 515 + 2 * 513)
    assert 150_000 < K.resident_bytes(X0, Y0, H100_SM) < 160_000


@pytest.mark.parametrize("res", [1, 2, 22, 32, 38])
def test_strips_cover_rows_once_and_fit(res):
    X0, Y0 = _shape0(res)
    nb = min(H100_SM, X0)
    strips = K.grid_strips(X0, nb)
    assert len(strips) == nb
    rows = np.concatenate([np.arange(a, b) for a, b in strips])
    np.testing.assert_array_equal(rows, np.arange(X0))  # every row once, in order
    longest = max(b - a for a, b in strips)
    assert longest == -(-X0 // nb) and min(b - a for a, b in strips) >= 1
    # no strip needs more than the bytes the route counts for the longest one
    per_rows = lambda rows: 1024 + 4 * (11 * rows * Y0 + (rows + 2) * (Y0 + 2) + 2 * Y0)
    assert all(per_rows(b - a) <= K.resident_bytes(X0, Y0, nb) for a, b in strips)
    assert K.resident_bytes(X0, Y0, nb) <= H100_SMEM


def test_small_grids_take_fewer_blocks_than_sms():
    # res1's 25 rows: 25 blocks of one row each, never an empty strip
    X0, Y0 = _shape0(1)
    assert K.grid_strips(X0, min(H100_SM, X0)) == [(i, i + 1) for i in range(X0)]
    assert K.grid_route(X0, Y0, H100_SM, H100_SMEM) == "resident"
    assert K.grid_route(X0, Y0, H100_SM, K.resident_bytes(X0, Y0, X0) - 1) == "stream"


TOLS = {torch.float64: 1e-10, torch.float32: 1e-6}
EXTENT = [(res, dt) for res in (1, 2) for dt in TOLS]


@pytest.mark.parametrize("res,dtype", EXTENT, ids=[f"res{r}-{str(d)[6:]}" for r, d in EXTENT])
def test_reference_true_extent_equals_padded(res, dtype):
    """The plain version on the true (X0, Y0) grid and on the padded (X, Y)
    one: the padded cells hold zero planes and zero F, so p, r and Ap stay
    zero there and every dot gets only zeros from them. x and the counts
    agree; what can differ is only the order of the float sums."""
    fin = FiveParamFin.create(resolution=res, dtype=dtype, device="cpu")
    op = fin.op
    X0, Y0 = op.grid_shape0
    X, Y = op.grid_shape
    assert (X0, Y0) == _shape0(res) and (X, Y) != (X0, Y0)
    ks = torch.tensor(np.exp(np.random.default_rng(7).uniform(np.log(0.1), np.log(10), (3, 5))),
                      dtype=dtype)
    v2, F2 = op.vals_grid(ks), op.to_grid(op.F_root)
    assert (v2[..., X0:, :] == 0).all() and (v2[..., Y0:] == 0).all()
    assert (F2[X0:] == 0).all() and (F2[:, Y0:] == 0).all()
    kw = dict(tol=TOLS[dtype], maxiter=800)
    x_pad, it_pad = K.pcg_stencil_grid_reference(v2, F2, **kw)
    x_true, it_true = K.pcg_stencil_grid_reference(v2[..., :X0, :Y0].contiguous(),
                                                   F2[:X0, :Y0].contiguous(), **kw)
    assert (it_pad > 0).all() and (it_pad < 800).all()
    np.testing.assert_array_equal(it_true.numpy(), it_pad.numpy())
    assert (x_pad[:, X0:] == 0).all() and (x_pad[:, :, Y0:] == 0).all()
    gate = 1e-12 if dtype == torch.float64 else 2e-6  # the float sums' order; see the docstring
    rel = (torch.linalg.norm((x_pad[:, :X0, :Y0] - x_true).flatten(1), dim=1)
           / torch.linalg.norm(x_true.flatten(1), dim=1))
    assert rel.max() < gate, rel


def test_wrapper_takes_plain_version_on_cpu():
    fin = FiveParamFin.create(resolution=1, device="cpu")
    op = fin.op
    ks = torch.tensor(np.exp(np.random.default_rng(8).uniform(np.log(0.1), np.log(10), (2, 5))),
                      dtype=torch.float32)
    v2, F2 = op.vals_grid(ks), op.to_grid(op.F_root)
    before = (K.grid_launches, K.grid_resident_launches)
    x, it = K.pcg_stencil_grid(v2, F2, tol=1e-6, maxiter=800, shape0=op.grid_shape0)
    assert (K.grid_launches, K.grid_resident_launches) == before  # no kernel, no library
    xr, itr = K.pcg_stencil_grid_reference(v2, F2, tol=1e-6, maxiter=800)
    assert torch.equal(x, xr) and torch.equal(it, itr)
    X, Y = op.grid_shape
    for bad in ((X + 1, Y), (0, Y), (X, Y + 1)):
        with pytest.raises(ValueError, match="shape0"):
            K.pcg_stencil_grid(v2, F2, tol=1e-6, maxiter=3, shape0=bad)
