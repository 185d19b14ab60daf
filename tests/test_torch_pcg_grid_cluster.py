"""K4c's plan (bayesianinferencedl_tpu_torch.ops.pcg_stencil: ``grid_cluster``,
``grid_strips`` over a cluster, ``cluster_bytes``) and its launcher's input
checks, which a CPU can show. K4c itself runs only on the card, where
chip_smoke.py holds it against the plain version.

The cluster capacities are an H100's as ``cudaOccupancyMaxActiveClusters``
gives them for K4c's one-block-per-SM blocks (132, 66, 30 and 15 clusters of
1, 2, 4 and 8 blocks; 7 or 8 of 16, by how the card's SMs fall into its
GPCs), passed as arguments, never read from a card."""

import numpy as np
import pytest
import torch

from bayesianinferencedl_tpu_torch.ops import _build
from bayesianinferencedl_tpu_torch.ops import pcg_stencil as K

H100_SMEM = 232_448


def _capacity(c16: int) -> dict[int, int]:
    return {1: 132, 2: 66, 4: 30, 8: 15, 16: c16}


def _shape0(res: int) -> tuple[int, int]:
    """The fin's true grid at a resolution: (24 res + 1, 16 res + 1)."""
    return 24 * res + 1, 16 * res + 1


# (B, clusters of 16 the card holds, the pick): waves = ceil(B / capacity[c]),
# the pick minimises waves / c, a tie to the smaller c
PICKS = [(1, 8, 16), (8, 8, 16), (64, 8, 2), (256, 8, 1), (1000, 8, 16),
         (1, 7, 16), (8, 7, 8), (64, 7, 2), (256, 7, 1), (1000, 7, 1)]


@pytest.mark.parametrize("B,c16,pick", PICKS, ids=[f"B{b}-c16x{c}" for b, c, _ in PICKS])
def test_grid_cluster_picks_on_h100(B, c16, pick):
    cap = _capacity(c16)
    assert K.grid_cluster(B, cap) == pick
    share = lambda c: -(-B // cap[c]) / c
    assert all(share(pick) <= share(c) for c in K.GRID_CLUSTERS)


def test_grid_cluster_tie_goes_to_smaller_size():
    # B = 64 on an H100: 64 clusters of 2 in one wave and 8 waves of 8 clusters
    # of 16 give the same waves per block share, 1/2; the smaller c wins
    cap = _capacity(8)
    assert -(-64 // cap[2]) / 2 == -(-64 // cap[16]) / 16 == 0.5
    assert K.grid_cluster(64, cap) == 2
    # equal capacities: every size takes one wave, so the largest c is best
    assert K.grid_cluster(4, {c: 4 for c in K.GRID_CLUSTERS}) == 16
    # one wave of 1 against two of 2: the same share, so 1
    assert K.grid_cluster(4, {1: 4, 2: 2}) == 1


@pytest.mark.parametrize("cap", [{}, {c: 0 for c in K.GRID_CLUSTERS}, {32: 4}, {3: 10}],
                         ids=["empty", "zeros", "c32", "c3"])
def test_grid_cluster_raises_when_nothing_fits(cap):
    with pytest.raises(RuntimeError, match="no K4c cluster"):
        K.grid_cluster(8, cap)


def test_grid_cluster_skips_sizes_the_card_cannot_hold():
    assert K.grid_cluster(1, {1: 132, 2: 66, 4: 30, 8: 15, 16: 0}) == 8
    assert K.grid_cluster(1, {1: 132}) == 1


ROWS = [(res, c) for res in (39, 40, 64) for c in K.GRID_CLUSTERS]


@pytest.mark.parametrize("res,c", ROWS, ids=[f"res{r}-c{c}" for r, c in ROWS])
def test_cluster_rows_cover_true_grid_once(res, c):
    """Block j of a cluster of c owns rows [j X0 / c, (j + 1) X0 / c) of the
    true grid (the kernel's split): every row once, in order, none empty, the
    longest at most one row longer than the shortest."""
    X0, _ = _shape0(res)
    strips = K.grid_strips(X0, c)
    assert len(strips) == c and strips[0][0] == 0 and strips[-1][1] == X0
    rows = np.concatenate([np.arange(a, b) for a, b in strips])
    np.testing.assert_array_equal(rows, np.arange(X0))
    sizes = [b - a for a, b in strips]
    assert min(sizes) >= 1 and max(sizes) - min(sizes) <= 1


@pytest.mark.parametrize("res", [39, 40, 64, 128])
def test_cluster_bytes_fit_h100(res):
    """A K4c block's shared memory: the 560-byte reduction head and an
    18-row tile of p over the 4-cell groups with 4 zero cells on each side;
    it fits an H100 block up to res128 (where K4r's strips stopped at res38),
    and the groups never reach past the padded row (Y, a multiple of 128)."""
    X0, Y0 = _shape0(res)
    groups = -(-Y0 // 4)
    assert K.cluster_bytes(Y0) == 560 + 4 * 18 * (4 * groups + 8)
    assert K.cluster_bytes(Y0) <= H100_SMEM
    Y = -(-Y0 // 128) * 128
    assert 4 * groups <= Y
    if res == 40:
        assert (X0, Y0) == (961, 641) and K.cluster_bytes(Y0) == 47_504


BAD_SIZES = [0, 3, 5, 32, -1]


@pytest.mark.parametrize("c", BAD_SIZES)
def test_launcher_refuses_other_cluster_sizes_before_loading(monkeypatch, c):
    def no_library(name):
        raise AssertionError(f"load_library({name!r}) called")

    monkeypatch.setattr(_build, "load_library", no_library)
    v2 = torch.zeros((2, 7, 8, 8))
    F2 = torch.zeros((8, 8))
    with pytest.raises(ValueError, match="cluster size"):
        K._launch_grid_cluster(v2, F2, None, (8, 8), tol=1e-7, maxiter=10, cluster=c)


@pytest.mark.parametrize("c", K.GRID_CLUSTERS)
def test_launcher_takes_every_built_size_to_the_library(monkeypatch, c):
    """A size K4c is built for passes the check and reaches the library
    (stubbed here, so nothing launches or counts)."""
    class Loaded(Exception):
        pass

    def stub(name):
        assert name == "pcg_stencil_grid_cluster"
        raise Loaded

    monkeypatch.setattr(_build, "load_library", stub)
    before = K.grid_cluster_launches
    with pytest.raises(Loaded):
        K._launch_grid_cluster(torch.zeros((1, 7, 8, 8)), torch.zeros((8, 8)), None, (8, 8),
                               tol=1e-7, maxiter=10, cluster=c)
    assert K.grid_cluster_launches == before
