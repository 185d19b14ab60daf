"""Kernel K3r's host side (bayesianinferencedl_tpu_torch.ops.pcg_stencil:
``tile_cluster``, ``tile_ranges``, ``pcg_stencil_tile`` and the checks of
``_launch_tile_mma``).

``tile_cluster`` is fed the cluster capacity an H100 reports for K3r's
deflated blocks (132, 66, 30 and 15 clusters of 1, 2, 4 and 8, from
``cudaOccupancyMaxActiveClusters`` in chip_smoke.py's route line) as an
argument, never read from a card. K3r itself runs only on the card, where
chip_smoke.py holds it against the plain version; on CPU tensors the wrapper
runs that plain version."""

import pytest
import torch

from bayesianinferencedl_tpu_torch.fem.dia import StencilOperator, assemble_fin_dia
from bayesianinferencedl_tpu_torch.geometry import build_fin_mesh
from bayesianinferencedl_tpu_torch.ops import pcg_stencil as K
from bayesianinferencedl_tpu_torch.ops.deflation import DeflationBasis

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs

H100_CAPACITY = {1: 132, 2: 66, 4: 30, 8: 15}
BIOT = 0.1

CLUSTERS = [(1024, 1), (256, 8), (250, 8), (128, 4), (32, 8), (1, 8), (2048, 1)]


@pytest.mark.parametrize("B,c", CLUSTERS, ids=[f"B{b}" for b, _ in CLUSTERS])
def test_tile_cluster_on_h100(B, c):
    """The cluster size with the fewest waves per block share, ceil(tiles /
    capacity[c]) / c; a tie goes to the smaller c."""
    assert K.tile_cluster(B, H100_CAPACITY) == c
    tiles = -(-B // 8)
    cost = {k: -(-tiles // v) / k for k, v in H100_CAPACITY.items()}
    assert cost[c] == min(cost.values())
    assert all(k >= c for k, v in cost.items() if v == cost[c])


def test_tile_cluster_skips_sizes_the_card_cannot_hold():
    assert K.tile_cluster(1, {**H100_CAPACITY, 8: 0}) == 4
    assert K.tile_cluster(1024, {1: 0, 2: 66, 4: 30, 8: 15}) == 2
    with pytest.raises(RuntimeError, match="no K3r cluster"):
        K.tile_cluster(256, dict.fromkeys(K.TILE_CLUSTERS, 0))


@pytest.fixture(scope="module")
def sublanes_ns():
    """n of every resolution whose batches take the sublanes route (res7-21)."""
    ns = {}
    for res in range(7, 23):
        n = assemble_fin_dia(build_fin_mesh(res)).F_root.shape[0]
        if K.layout_for(n) == "sublanes":
            ns[res] = n
    return ns


@pytest.mark.parametrize("c", K.TILE_CLUSTERS)
def test_tile_ranges_cover_nodes_once(sublanes_ns, c):
    assert sorted(sublanes_ns) == list(range(7, 22))
    for res, n in sublanes_ns.items():
        ranges = K.tile_ranges(n, c)
        assert len(ranges) == c
        assert ranges[0][0] == 0 and ranges[-1][1] == n, res
        sizes = []
        for (a, b), (a2, _) in zip(ranges, ranges[1:] + [(n, n)]):
            assert b == a2  # contiguous: every node once, in order
            assert a % K.TILE_ROW == 0 and b % K.TILE_ROW == 0
            sizes.append(b - a)
        assert min(sizes) > 0 and max(sizes) - min(sizes) <= K.TILE_ROW, (res, sizes)


def test_tile_ranges_reject():
    with pytest.raises(ValueError, match="multiple of 16"):
        K.tile_ranges(24_968, 4)
    with pytest.raises(ValueError, match="cluster size"):
        K.tile_ranges(24_960, 3)


@pytest.fixture(scope="module")
def res1():
    host = assemble_fin_dia(build_fin_mesh(1), pad_to=128)
    op = StencilOperator.from_host(host, biot=BIOT, dtype=torch.float32, device="cpu")
    defl = DeflationBasis.create(host, biot=BIOT, m=64, device="cpu")
    g = torch.Generator().manual_seed(3)
    ks = torch.exp(torch.empty(6, 5).uniform_(-2.3, 2.3, generator=g))
    vals4 = K.upper_planes(op.vals(ks))
    return op, defl, vals4, defl.coarse_inverses(ks, op.biot).contiguous()


def test_cpu_route_is_the_plain_version(res1):
    op, defl, vals4, Binv = res1
    kw = dict(offsets=op.offsets[4:], tol=1e-6, maxiter=400, Wt=defl.Wt_bf16, Binv=Binv)
    before = (K.tile_mma_launches, K.tile_launches)
    x, it = K.pcg_stencil_tile(vals4, op.F_root, None, **kw)
    xp, itp = K.pcg_stencil_reference(vals4, op.F_root, None, **kw)
    assert (K.tile_mma_launches, K.tile_launches) == before  # CPU tensors: no launch
    assert torch.equal(x, xp) and torch.equal(it, itp)
    assert it.dtype == torch.int32 and 0 < int(it.max()) < 400


def test_launch_checks_before_the_card(res1):
    """K3r's own conditions raise before anything reaches a card: n in whole
    16-node row tiles, m in 16-mode tiles."""
    op, defl, vals4, Binv = res1
    n = op.n
    kw = dict(offsets=op.offsets[4:], tol=1e-6, maxiter=8, check_every=16)
    with pytest.raises(ValueError, match="multiple of 16"):
        K._launch_tile_mma(vals4[:, :, : n - 8].contiguous(), op.F_root[: n - 8], None, Wt=None,
                           Binv=None, **kw)
    with pytest.raises(ValueError, match="16-mode tiles"):
        K._launch_tile_mma(vals4, op.F_root, None, Wt=defl.Wt_bf16[:8].contiguous(),
                           Binv=Binv[:, :8, :8].contiguous(), **kw)
