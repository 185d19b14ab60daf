"""K2r's plan and arithmetic (bayesianinferencedl_tpu_torch.experimental.pcn_fused:
``k2r_plan``, ``k2r_smem_bytes``, ``k2r_astack_stride``, the assembly's
indexing against ``stacked_amat``) and the lanes route
(``ops.pcg_stencil.lanes_route``), which a CPU can show. K2r itself runs only
on the card, where chip_smoke.py holds it against the plain version.

The card's numbers are an H100's (132 SMs, 232,448 bytes of shared memory a
block may opt into), passed as arguments, never read from a card."""

import numpy as np
import pytest
import torch

from bayesianinferencedl_tpu_torch.experimental import pcn_fused as K2
from bayesianinferencedl_tpu_torch.ops import _build
from bayesianinferencedl_tpu_torch.ops import pcg_stencil as K

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs

H100_SMS, H100_SMEM = 132, 232_448


def test_plan_at_the_slice_widths():
    """C = 1,024 chains at r = 40, h = 64: the r = 40 instance with 10 x 5
    tiles of A(k) and P0 in registers, 4 warps a block, so 256 blocks cover
    all 132 SMs; the block's shared memory is astack (40 rows of 244),
    fhat, Bhat^T, the MLP padded to 64 wide and 4 warps' 16 uniforms."""
    plan = K2.k2r_plan(1024, 40, 64, 64, H100_SMS)
    assert plan.r_pad == 40 and plan.instance == "pcn_fused_r_kernel<40>"
    assert plan.tile == (10, 5) and (plan.a_in, plan.p0_in) == ("registers", "registers")
    assert (plan.warps, plan.blocks) == (4, 256) and plan.blocks >= H100_SMS
    assert K2.k2r_astack_stride(40) == 244
    block = 40 * 244 + 40 + 40 * 8 + 8 * 64 + 64 + 64 * 64 + 64 + 64 * 8 + 8 + 16 + 8
    assert plan.smem_bytes == 4 * (block + 4 * 16) == 61_856


@pytest.mark.parametrize("r", [1, 8, 13, 32, 40, 48, 49, 64])
def test_astack_stride_spreads_an_assembly_step_over_the_banks(r):
    """One assembly step's 32 reads (lane cb + 8 rb at word (rp / 4) rb S +
    (rp / 8) cb) hit a bank no more often under the chosen stride than under
    any other S in [6 rp, 6 rp + 32), and once each at the slice's r = 40."""
    rp = 8 * -(-r // 8)

    def ways(S):
        banks = [((rp // 4) * (lane >> 3) * S + (rp // 8) * (lane & 7)) % 32 for lane in range(32)]
        return max(banks.count(b) for b in banks)

    S = K2.k2r_astack_stride(r)
    candidates = range(6 * rp, 6 * rp + 32)
    assert S in candidates and ways(S) == min(map(ways, candidates))
    assert all(ways(T) > ways(S) for T in candidates if T < S)
    if r == 40:
        assert ways(S) == 1


# r -> (padded r, where A(k) and P0 live)
INSTANCES = {1: (8, "registers"), 8: (8, "registers"), 40: (40, "registers"),
             48: (48, "registers"), 49: (56, "shared"), 64: (64, "shared")}


@pytest.mark.parametrize("r", sorted(INSTANCES))
def test_plan_instance_and_storage(r):
    rp, where = INSTANCES[r]
    plan = K2.k2r_plan(1024, r, 64, 64, H100_SMS)
    assert (plan.r_pad, plan.a_in, plan.p0_in, plan.tile) == (rp, where, where, (rp // 4, rp // 8))
    assert plan.smem_bytes == K2.k2r_smem_bytes(r, 64, 64, plan.warps) <= H100_SMEM
    assert plan.smem_bytes % 16 == 0
    # a warp's own shared memory: 16 uniforms, and its chain's A(k) (rp, rp)
    # where the tiles are not in registers
    grow = K2.k2r_smem_bytes(r, 64, 64, 2) - K2.k2r_smem_bytes(r, 64, 64, 1)
    assert grow == 4 * (16 + (rp * rp if where == "shared" else 0))
    # the MLP is staged padded to 64 wide: the hidden widths do not change it
    assert K2.k2r_smem_bytes(r, 8, 16, 1) == K2.k2r_smem_bytes(r, 64, 64, 1)


@pytest.mark.parametrize("C,warps", [(1, 1), (131, 1), (132, 1), (264, 2), (528, 4), (1024, 4),
                                     (1056, 8), (4096, 8)])
def test_plan_warps_cover_the_sms(C, warps):
    """The most warps a block that still give one block per SM, else 1."""
    plan = K2.k2r_plan(C, 40, 64, 64, H100_SMS)
    assert plan.warps == warps and plan.blocks == -(-C // warps)
    assert plan.blocks >= min(C, H100_SMS)


def test_plan_caps_warps_by_shared_memory():
    """At r = 64, with each chain's A(k) in shared memory, 8 warps do not fit."""
    assert K2.k2r_smem_bytes(64, 64, 64, 8) > H100_SMEM >= K2.k2r_smem_bytes(64, 64, 64, 4)
    assert K2.k2r_plan(4096, 64, 64, 64, H100_SMS).warps == 4


@pytest.mark.parametrize("r,h1,h2", [(65, 64, 64), (40, 65, 64), (40, 64, 65), (0, 8, 8)])
def test_widths_past_the_kernel_raise_before_loading(monkeypatch, r, h1, h2):
    def no_library(name):
        raise AssertionError(f"load_library({name!r}) called")

    monkeypatch.setattr(_build, "load_library", no_library)
    with pytest.raises(ValueError, match="r <= 64"):
        K2.k2r_plan(1024, r, h1, h2)
    rr = max(r, 1)
    ops = K2.FusedOperands(
        theta0=torch.zeros(4, 8), astack=torch.zeros(rr, 6 * rr), P0=torch.zeros(rr, rr),
        fhat=torch.zeros(rr), bhatT=torch.zeros(rr, 8), w1=torch.zeros(8, h1), b1=torch.zeros(h1),
        w2=torch.zeros(h1, h2), b2=torch.zeros(h2), w3=torch.zeros(h2, 8), b3=torch.zeros(8),
        xnorm=torch.zeros(2, 8), data=torch.zeros(8), consts=torch.zeros(4), d=5)
    if r >= 1:
        with pytest.raises(ValueError, match="r <= 64"):
            K2._launch(ops, n_steps=2, n_burn=0, cg_iters=1, seed=0, uniforms=None,
                       keep_uniforms=False)


def test_launcher_reaches_the_library_for_a_slice_shape(monkeypatch):
    """Widths the kernel takes pass the checks and reach K2r's library
    (stubbed here, so nothing launches or counts)."""
    class Loaded(Exception):
        pass

    def stub(name):
        assert name == "pcn_fused_r"
        raise Loaded

    monkeypatch.setattr(_build, "load_library", stub)
    r, h = 40, 64
    ops = K2.FusedOperands(
        theta0=torch.zeros(4, 8), astack=torch.zeros(r, 6 * r), P0=torch.zeros(r, r),
        fhat=torch.zeros(r), bhatT=torch.zeros(r, 8), w1=torch.zeros(8, h), b1=torch.zeros(h),
        w2=torch.zeros(h, h), b2=torch.zeros(h), w3=torch.zeros(h, 8), b3=torch.zeros(8),
        xnorm=torch.zeros(2, 8), data=torch.zeros(8), consts=torch.zeros(4), d=5)
    before = (K2.r_launches, K2.launches)
    with pytest.raises(Loaded):
        K2._launch(ops, n_steps=2, n_burn=0, cg_iters=1, seed=0, uniforms=None, keep_uniforms=False)
    assert (K2.r_launches, K2.launches) == before


@pytest.mark.parametrize("r,d", [(40, 5), (13, 3), (1, 1)])
def test_assembled_operator_equals_stacked_product(r, d):
    """Component j of astack is its columns j r .. (j + 1) r and Bi*Mhat
    (j = 5) has weight 1: A(k) built that way, times p, equals the plain
    version's stacked product in float64 on 16 chains; its own assembly,
    entry by entry, is the kernel's (astack[m, j r + i] weighted by k_j)."""
    rng = np.random.default_rng(r)
    C = 16
    astack = torch.from_numpy(rng.standard_normal((r, 6 * r)))
    theta = np.zeros((C, 8))
    theta[:, :d] = rng.normal(0.0, 0.7, (C, d))
    ops = K2.FusedOperands(*([None] * 14), d=d)
    k_aug = K2._k_aug(ops, torch.from_numpy(theta))
    assert torch.all(k_aug[:, d:5] == 0) and torch.all(k_aug[:, 5] == 1)
    p = torch.from_numpy(rng.standard_normal((C, r)))
    # K2r's assembly: entry (m, i) = sum_j k_j astack[m, j r + i]
    comps = astack.reshape(r, 6, r).permute(1, 0, 2)  # comps[j] = astack[:, j r:(j + 1) r]
    A = torch.einsum("cj,jmi->cmi", k_aug, comps)
    assert A.shape == (C, r, r)
    got = torch.einsum("cm,cmi->ci", p, A)
    want = K2.stacked_amat(astack, k_aug, p)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-12 * float(want.abs().max()))
    m, i, c = r // 2, r - 1, C - 1
    entry = sum(float(k_aug[c, j]) * float(astack[m, j * r + i]) for j in range(6))
    assert float(A[c, m, i]) == pytest.approx(entry, rel=1e-14, abs=1e-14)


def _fin_n(res: int) -> int:
    """The fin's n at a resolution: the (24 res + 1) x (16 res + 1) grid,
    padded to a multiple of 128 (fem.dia.assemble_fin_dia)."""
    return -(-(24 * res + 1) * (16 * res + 1) // 128) * 128


@pytest.mark.parametrize("res", [1, 2, 3, 4])
def test_lanes_route_takes_k3r_on_the_fins_lanes_meshes(res):
    n = _fin_n(res)
    assert K.layout_for(n) == "lanes"
    assert K.lanes_route(n, 0) == K.lanes_route(n, 128) == "K3r"
    # K3r's own contract holds there: whole 16-node row tiles
    assert K.tile_ranges(n, 8)[-1][1] == n


@pytest.mark.parametrize("n,m", [(6_408, 128), (6_400 + 8, 0), (6_400, 120), (6_400, 8),
                                 (6_400, 144), (6_400, 256), (1_000, 0)])
def test_lanes_route_keeps_k1_outside_k3rs_contract(n, m):
    assert K.lanes_route(n, m) == "K1"
