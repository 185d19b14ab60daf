"""Kernel K5's module (bayesianinferencedl_tpu_torch.experimental.shift_cost)
against the JAX package's shift-cost probe (``scripts/diag_roll_cost.run``,
loaded by path) in interpret mode, in float64 at res1: 16 samples in tiles
of 8, with and without the stencil shifts.

The reference rolls with wrap-around onto zero planes, the port masks reads
outside the vector; the two loops do the same arithmetic, so with the shifts
they agree to 1e-10 relative over 32 iterations. Without the shifts the
operator is the diagonal of A's row sums, which vanish up to rounding at
every node off the convective boundary: from the second iteration on,
p.Ap is a sum of rounding errors whose value depends on the summation order,
and alpha = r.z / p.Ap amplifies it without bound. That variant is compared
after its one determined iteration, and its growth is checked over 32. On the CPU the wrapper runs the plain version; chip_smoke.py holds
the CUDA kernel against it."""

import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from bayesianinferencedl_tpu.fem.dia import StencilOperator as JStencil
from bayesianinferencedl_tpu.fem.dia import assemble_fin_dia as j_assemble
from bayesianinferencedl_tpu_torch.experimental import shift_cost as K5
from bayesianinferencedl_tpu_torch.fem.dia import StencilOperator, assemble_fin_dia

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs

B, TILE, N_ITERS = 16, 8, 32


@pytest.fixture(scope="module")
def setup(mesh_r1):
    path = Path(__file__).resolve().parents[1] / "scripts" / "diag_roll_cost.py"
    spec = importlib.util.spec_from_file_location("diag_roll_cost", path)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    jop = JStencil.from_host(j_assemble(mesh_r1, pad_to=128), biot=0.1, dtype=jnp.float64)
    top = StencilOperator.from_host(assemble_fin_dia(mesh_r1, pad_to=128), biot=0.1,
                                    dtype=torch.float64, device="cpu")
    ks = np.exp(np.random.default_rng(6).uniform(np.log(0.1), np.log(10), (B, 5)))
    return ref, jop, top, ks


@pytest.mark.parametrize("use_rolls,n_iters", [(True, N_ITERS), (False, 1)], ids=["shifts", "no_shifts"])
def test_plain_version_matches_reference(setup, use_rolls, n_iters):
    ref, jop, top, ks = setup
    jvals = jnp.stack([jop.vals(jnp.asarray(k)) for k in ks])
    with pltpu.force_tpu_interpret_mode():
        xj = np.asarray(ref.run(jvals, jop.F_root, offsets=tuple(int(o) for o in jop.offsets),
                                n_iters=n_iters, use_rolls=use_rolls, tile=TILE))
    before = K5.launches
    vals = top.vals(torch.from_numpy(ks))
    xt = K5.shift_cost(vals, top.F_root, offsets=top.offsets, n_iters=n_iters, use_rolls=use_rolls,
                       tile=TILE).numpy()
    assert K5.launches == before  # CPU tensors: the plain version, no launch
    assert xt.shape == (B, top.n) and np.isfinite(xt).all()
    for b in range(B):
        rel = np.linalg.norm(xt[b] - xj[b]) / np.linalg.norm(xj[b])
        assert rel < 1e-10, (b, rel)
    if not use_rolls:  # the growth the module docstring describes
        grown = K5.shift_cost(vals, top.F_root, offsets=top.offsets, n_iters=N_ITERS, use_rolls=False,
                              tile=TILE)
        assert np.abs(xt).max() < 1e3 and grown.abs().max() > 1e6


def test_wrapper_checks_inputs(setup):
    _, _, top, ks = setup
    vals = top.vals(torch.from_numpy(ks))
    kw = dict(offsets=top.offsets, n_iters=2, use_rolls=True)
    assert K5.shift_cost(vals, top.F_root, tile=TILE, **kw).shape == (B, top.n)
    with pytest.raises(ValueError, match="tile"):
        K5.shift_cost(vals, top.F_root, tile=3, **kw)
    with pytest.raises(ValueError, match="tile"):
        K5.shift_cost(vals[:12], top.F_root, tile=TILE, **kw)
    with pytest.raises(ValueError, match="offsets"):
        K5.shift_cost(vals, top.F_root, tile=TILE, offsets=top.offsets[::-1], n_iters=2, use_rolls=True)
    with pytest.raises(ValueError, match=r"\(B, n, 7\)"):
        K5.shift_cost(vals[..., :4], top.F_root, tile=TILE, **kw)
    with pytest.raises(TypeError):
        K5.shift_cost(vals.half(), top.F_root.half(), tile=TILE, **kw)
    with pytest.raises(ValueError, match="F must be"):
        K5.shift_cost(vals, top.F_root[:-1], tile=TILE, **kw)


def test_main_prints_reference_keys(capsys):
    K5.main(["1", "8", "cpu"])
    lines = [line for line in capsys.readouterr().out.splitlines() if line.startswith("{")]
    rows = [json.loads(line) for line in lines]
    assert [r["use_rolls"] for r in rows] == [True, False]
    for r in rows:
        assert set(r) == {"res", "tile", "use_rolls", "per_tile_iter_us", "total_s"}
        assert r["res"] == 1 and r["tile"] == 8 and r["total_s"] > 0


# --- K5r: the plan, the route and the chunked matvec, which a CPU can show.
# K5r itself runs only on the card, where chip_smoke.py holds it against the
# plain version. The cluster capacities are an H100's as
# cudaOccupancyMaxActiveClusters gives them for one-block-per-SM blocks (132,
# 66, 30 and 15 clusters of 1, 2, 4 and 8 blocks; 7 or 8 of 16), passed as
# arguments, never read from a card.

H100_SMEM = 232_448


def _capacity(c16: int) -> dict[int, int]:
    return {1: 132, 2: 66, 4: 30, 8: 15, 16: c16}


def _fin(res: int):
    from bayesianinferencedl_tpu_torch.models.five_param import FiveParamFin

    op = FiveParamFin.create(resolution=res, biot=0.1, dtype=torch.float32, device="cpu").op
    return op.n, op.offsets


# (res, clusters of 16 the card holds, route, cluster, nodes and threads a
# block, shared bytes, waves) at B = 64: a block's shared memory is 4 (8 L +
# 4 H) bytes and 16 + 256 + 16 c of reduction scratch; the plan minimises
# waves * L, then waves, then c
PLANS = [(1, 7, "K5r", 2, 256, 256, 8_784, 1), (4, 7, "K5r", 2, 3_200, 800, 103_760, 1),
         (8, 7, "K5r", 8, 3_120, 800, 102_320, 5), (8, 8, "K5r", 16, 1_560, 800, 52_528, 8),
         (12, 7, "K5r", 16, 3_488, 896, 115_248, 10), (12, 8, "K5r", 16, 3_488, 896, 115_248, 8),
         (16, 7, "K5", None, None, None, None, None), (16, 8, "K5", None, None, None, None, None)]


@pytest.mark.parametrize("res,c16,route,c,L,T,smem,waves", PLANS,
                         ids=[f"res{p[0]}-c16x{p[1]}" for p in PLANS])
def test_route_and_plan_on_h100(res, c16, route, c, L, T, smem, waves):
    n, offsets = _fin(res)
    cap = _capacity(c16)
    H = K5.halo(offsets)
    assert H == 16 * res + 2  # the fin's (+-1, +-1) neighbour: one grid row and one node
    assert K5.shift_route(n, offsets, H100_SMEM, cap) == route
    plan = K5.k5r_plan(n, offsets, 64, H100_SMEM, cap)
    if route == "K5":
        # res16: 6,192 nodes a block even on 16, over the 3,584 a block holds
        assert plan is None and K5.k5r_configs(n, offsets, H100_SMEM, cap) == []
        assert -(-n // 16) > K5.R_MAX_NODES
        return
    got = (plan["cluster"], plan["nodes"], plan["threads"], plan["smem"], plan["waves"])
    assert got == (c, L, T, smem, waves)
    assert plan["nodes"] == -(-n // c) >= H and 2 * H <= plan["threads"] and plan["smem"] <= H100_SMEM
    assert plan["clusters"] == min(cap[c], 64)
    assert c in K5.k5r_configs(n, offsets, H100_SMEM, cap)


def test_halo_wider_than_a_chunk_is_refused():
    n, offsets = 512, (-600, -599, -1, 0, 1, 599, 600)
    cap = _capacity(8)
    assert K5.shift_route(n, offsets, H100_SMEM, cap) == "K5"
    assert K5.k5r_plan(n, offsets, 64, H100_SMEM, cap) is None
    # a halo of 200: only one block (L = 512) holds it, and 400 <= its 512 threads
    offsets = (-200, -199, -1, 0, 1, 199, 200)
    assert K5.k5r_configs(n, offsets, H100_SMEM, cap) == [1]
    assert K5.k5r_plan(n, offsets, 64, H100_SMEM, cap)["cluster"] == 1
    # the card holds no cluster of 1: nothing fits
    assert K5.shift_route(n, offsets, H100_SMEM, {**cap, 1: 0}) == "K5"


def test_launcher_rejects_off_contract_plans_before_loading(monkeypatch):
    from bayesianinferencedl_tpu_torch.ops import _build

    def no_load(name):
        raise AssertionError(f"library {name} loaded before the plan was checked")

    monkeypatch.setattr(_build, "load_library", no_load)
    n, offsets = _fin(1)
    vals, F = torch.zeros((8, n, 7)), torch.zeros(n)
    kw = dict(offsets=offsets, n_iters=4, use_rolls=True)
    for bad in (dict(cluster=3, clusters=1), dict(cluster=32, clusters=1), dict(cluster=2, clusters=0),
                dict(cluster=2, clusters=9), dict(cluster=2, clusters=1, floor="none")):
        with pytest.raises(ValueError, match="clusters of"):
            K5._launch_r(vals, F, **kw, **bad)
    with pytest.raises(ValueError, match="halo"):  # H = 40 > L = 32 on 16 blocks
        K5._launch_r(vals, F, offsets=(-40, -39, -1, 0, 1, 39, 40), n_iters=4, use_rolls=True, cluster=16,
                     clusters=1)
    n16, off16 = 99_072, (-258, -257, -1, 0, 1, 257, 258)  # res16: 6,192 nodes a block on 16
    with pytest.raises(ValueError, match="over 3584 nodes"):
        K5._launch_r(torch.zeros((2, n16, 7)), torch.zeros(n16), offsets=off16, n_iters=4, use_rolls=True,
                     cluster=16, clusters=1)
    # a thread for each halo node: 16 blocks of 32 nodes have 32 threads, the halo 2 x 18 nodes
    with pytest.raises(ValueError, match="threads"):
        K5._launch_r(vals, F, cluster=16, clusters=1, **kw)
    # in contract (8 blocks of L = 64 >= H = 18 on 64 threads): the loader is reached
    with pytest.raises(AssertionError, match="shift_cost_cluster"):
        K5._launch_r(vals, F, cluster=8, clusters=8, floor="mbarrier", **kw)
    # CPU tensors: the plain version, neither kernel, nothing loaded
    before = (K5.launches, K5.r_launches)
    assert K5.shift_cost(vals, F, tile=TILE, **kw).shape == (8, n)
    assert (K5.launches, K5.r_launches) == before


def _chunked_matvec(planes, r, inv, p_old, beta, offsets, c, first):
    """K5r's matvec on the CPU, block by block: block j of c forms p on its
    chunk [j L, min((j + 1) L, n)) from its own r, 1/diag and old p, and on
    the H nodes either side from the z = D^-1 r its neighbours computed on
    their edge nodes and its own copy of the halo's old p (zero outside
    [0, n)), with the owner's operations; then Ap on its chunk from [halo |
    own | halo], the diagonal term first. Returns (p, Ap), each (B, n)."""
    B, _, n = planes.shape
    L, H = -(-n // c), K5.halo(offsets)
    chunks = [(j * L, min((j + 1) * L, n)) for j in range(c)]
    z = [inv[:, a:b] * r[:, a:b] for a, b in chunks]  # each block's own z

    def new_p(zv, po):
        return zv if first else zv + beta * po

    p_out, ap_out = torch.empty_like(r), torch.empty_like(r)
    for j, (a, b) in enumerate(chunks):
        own = new_p(z[j], p_old[:, a:b])
        left = torch.zeros((B, H), dtype=r.dtype)
        right = torch.zeros((B, H), dtype=r.dtype)
        if j > 0:  # rank j - 1's last H nodes, sent as z
            left = new_p(z[j - 1][:, -H:], p_old[:, a - H:a])
        if b < n:  # rank j + 1's first H nodes
            right = new_p(z[j + 1][:, :H], p_old[:, b:b + H])
        ext = torch.cat([left, own, right], dim=1)
        pc = ext[:, H:H + (b - a)]
        acc = planes[:, K5.DIAG_SLOT, a:b] * pc
        for s, o in enumerate(offsets):
            if s != K5.DIAG_SLOT:
                acc = acc + planes[:, s, a:b] * ext[:, H + o:H + o + (b - a)]
        p_out[:, a:b], ap_out[:, a:b] = own, acc
    return p_out, ap_out


# (n, c): the res1 fin's 512 nodes on 2-8 blocks, and 500 and 470 of them (a
# ragged last chunk of 125, 59 and 57 nodes, each over the halo of 18)
CHUNKINGS = [(512, 2), (512, 4), (512, 8), (500, 4), (500, 8), (470, 8)]


@pytest.mark.parametrize("n,c", CHUNKINGS, ids=[f"n{n}-c{c}" for n, c in CHUNKINGS])
def test_chunked_matvec_is_the_plain_one_bit_for_bit(setup, n, c):
    """The halo's p formed from the neighbours' z and each block's own copy
    of the halo's old p gives the plain version's matvec to the last bit in
    float64, on the first iteration (p = z) and on a later one (p = z +
    beta p_old)."""
    _, _, top, ks = setup
    planes = top.vals(torch.from_numpy(ks[:4])).transpose(1, 2)[:, :, :n].contiguous()
    assert K5._chunks_hold_halo(n, K5.halo(top.offsets), c)
    rng = np.random.default_rng(9)
    r = torch.from_numpy(rng.normal(size=(4, n)))
    p_old = torch.from_numpy(rng.normal(size=(4, n)))
    diag = planes[:, K5.DIAG_SLOT]
    inv = torch.where(diag != 0, 1.0 / torch.where(diag != 0, diag, 1.0), 0.0)
    beta = 0.37
    for first in (True, False):
        p, ap = _chunked_matvec(planes, r, inv, p_old, beta, top.offsets, c, first)
        p_ref = inv * r if first else inv * r + beta * p_old
        assert torch.equal(p, p_ref)
        assert torch.equal(ap, K5.reference_matvec(planes, p_ref, top.offsets, True))
