"""The online precision tiers (utils/precision.py tier_matmul, threaded
through rom/galerkin.py and the pipeline) against a float64 emulation.

JAX on the CPU ignores the matmul precision, so the oracle of "high"
(bf16x3) and "fast" (one bf16 pass) is an emulation in float64 of the same
bf16 splits, the rounding done by JAX's bfloat16 (``jnp.astype``):
hi = bf16(x), lo = bf16(x - hi); "high" sums hi.hi + hi.lo + lo.hi, "fast"
takes hi.hi.

1. Each tier's product (64 x 40 @ 40 x 240, the operator's shape at r =
   40) equals the emulation to float32 rounding (1e-6); its error against
   the exact product is the tier's (bf16x3 ~1e-5 or below, bf16 ~1e-3).
   Its backward is the transposed product at the tier.
2. A 20-iteration reduced PCG at each tier equals a float64 emulation of
   the same PCG with the same splits to float32 rounding: 1e-5 relative
   for "highest" and "high"; for "fast" 1e-4, since an operand whose
   float32 and float64 values straddle a bf16 rounding boundary rounds one
   bf16 ulp (2^-8) apart on the two sides; each a tenth of the tier's own
   error. "highest" is the pre-tier code bit for bit.
3. A build at each tier: the error dataset's y_rom is that tier's
   fast_forward bit for bit (the surrogate learns the deployed path), the
   pipeline forwards run at the tier, and the differentiable route's values
   equal the plain route's; its gradient at "high" is "highest"'s to 2e-3
   of the largest component (the 15-iteration solve at bf16x3 is ~4e-5 off
   in its values at this size), and "fast"'s is not.
Sizes: res1, r = 8, 32 chains; float32."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinferencedl_tpu_torch import api
from bayesianinferencedl_tpu_torch import config as tcfg
from bayesianinferencedl_tpu_torch.rom.snapshots import sample_log_uniform
from bayesianinferencedl_tpu_torch.utils.precision import fp32_matmul, tier_matmul, tier_operand
from test_torch_slice import cached_build_pipeline

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs

TIERS = ("highest", "high", "fast")


def _bf16(x: np.ndarray) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float64))


def _emul(a, b, tier: str) -> np.ndarray:
    """a @ b at the tier, in float64 from the bf16 splits."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if tier == "highest":
        return a @ b
    ah, bh = _bf16(a), _bf16(b)
    if tier == "fast":
        return ah @ bh
    return ah @ bh + ah @ _bf16(b - bh) + _bf16(a - ah) @ bh


def _rel(x, y) -> float:
    return float(np.linalg.norm(np.asarray(x, np.float64) - y) / np.linalg.norm(y))


@pytest.mark.parametrize("tier,err_range", [("high", (1e-7, 2e-5)), ("fast", (1e-4, 1e-2))])
def test_tier_products_equal_the_emulation(tier, err_range):
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn((64, 40), generator=g), torch.randn((40, 240), generator=g)
    op = tier_operand(b, tier)
    y = tier_matmul(a, op)
    assert y.dtype == torch.float32
    emul = _emul(a.numpy(), b.numpy(), tier)
    assert _rel(y.numpy(), emul) <= 1e-6
    err = _rel(emul, a.double().numpy() @ b.double().numpy())
    assert err_range[0] < err < err_range[1], err
    # the backward: g @ b^T at the same tier
    a_ = a.clone().requires_grad_(True)
    w = torch.randn((64, 240), generator=g)
    (ga,) = torch.autograd.grad(torch.sum(tier_matmul(a_, op) * w), a_)
    assert _rel(ga.numpy(), _emul(w.numpy(), b.numpy().T, tier)) <= 1e-6


@pytest.fixture(scope="module")
def builds():
    """One res1 build at each tier, float32."""
    out = {}
    for tier in TIERS:
        cfg = tcfg.PipelineConfig(
            mesh=tcfg.MeshConfig(resolution=1), fem=tcfg.FEMConfig(biot=0.1, cg_tol=1e-7, cg_maxiter=1500),
            rom=tcfg.ROMConfig(n_snapshots=32, basis_size=8, online_precision=tier),
            surrogate=tcfg.SurrogateConfig(hidden=(16, 16), n_train=64, epochs=5),
            mcmc=tcfg.MCMCConfig(noise_sigma=1e-2))
        out[tier] = cached_build_pipeline(cfg, device="cpu")
    return out


def _pcg_emul(rom, P0, ks: np.ndarray, n_iters: int, tier: str) -> np.ndarray:
    """The reduced PCG of rom/galerkin.py in float64, each product at the tier."""
    A, M = rom.Ahat.double().numpy(), rom.Mhat.double().numpy()
    F, P0T = rom.Fhat.double().numpy(), P0.T.double().numpy()
    C, r = ks.shape[0], A.shape[-1]
    AT = np.concatenate([A, M[None]], 0).transpose(0, 2, 1).transpose(1, 0, 2).reshape(r, -1)
    w = np.concatenate([ks, np.full((C, 1), rom.biot)], 1)[:, :, None]
    amat = lambda p: np.sum(w * _emul(p, AT, tier).reshape(C, -1, r), 1)
    b = np.broadcast_to(F, (C, r))
    x = _emul(b, P0T, tier)
    res = b - amat(x)
    z = _emul(res, P0T, tier)
    p, rz = z, np.sum(res * z, -1)
    for _ in range(n_iters):
        Ap = amat(p)
        pAp = np.sum(p * Ap, -1)
        alpha = (rz / np.where(pAp != 0, pAp, 1.0))[:, None]
        x, res = x + alpha * p, res - alpha * Ap
        z = _emul(res, P0T, tier)
        rz_new = np.sum(res * z, -1)
        p = z + (rz_new / np.where(rz != 0, rz, 1.0))[:, None] * p
        rz = rz_new
    return x


def test_reduced_solve_at_each_tier_equals_the_emulation(builds):
    pipe = builds["highest"]
    rom, P0 = pipe.rom, pipe.P0
    ks = np.exp(np.random.default_rng(1).normal(0.0, 0.6, (32, 5)))
    kt = torch.tensor(ks, dtype=torch.float32)
    exact = _pcg_emul(rom, P0, ks, 20, "highest")
    for tier in TIERS:
        x = rom.solve_pcg(kt, P0, 20, tier).numpy()
        emul = _pcg_emul(rom, P0, ks, 20, tier)
        gap = np.abs(x - emul).max() / np.abs(emul).max()
        assert gap <= (1e-4 if tier == "fast" else 1e-5), (tier, gap)
        if tier != "highest":
            assert gap < 0.1 * np.abs(emul - exact).max() / np.abs(exact).max(), tier
    # "highest" is the code before the tiers, bit for bit: one (C, r) @ (r, 6r)
    # product and P0 products, all under fp32_matmul
    C, r = kt.shape[0], rom.r
    AT = torch.cat([rom.Ahat, rom.Mhat[None]], 0).transpose(1, 2).permute(1, 0, 2).reshape(r, -1)
    w = torch.cat([kt, torch.full_like(kt[:, :1], rom.biot)], 1)[:, :, None]
    amat = lambda p: torch.sum(w * (p @ AT).view(C, -1, r), 1)
    with fp32_matmul():
        b = rom.Fhat.expand(C, r)
        x = b @ P0.T
        res = b - amat(x)
        z = res @ P0.T
        p, rz = z, torch.sum(res * z, -1)
        for _ in range(20):
            Ap = amat(p)
            pAp = torch.sum(p * Ap, -1)
            alpha = (rz / torch.where(pAp != 0, pAp, 1.0))[:, None]
            x, res = x + alpha * p, res - alpha * Ap
            z = res @ P0.T
            rz_new = torch.sum(res * z, -1)
            p = z + (rz_new / torch.where(rz != 0, rz, 1.0))[:, None] * p
            rz = rz_new
    assert torch.equal(rom.solve_pcg(kt, P0, 20), x)
    assert torch.equal(rom.solve_pcg(kt, P0, 20, "highest"), x)


@pytest.mark.parametrize("tier", TIERS)
def test_build_trains_on_the_deployed_tier(builds, tier):
    pipe = builds[tier]
    cfg = pipe.config
    assert pipe.rom_precision == tier
    ff = pipe.rom.fast_forward(pipe.P0, pipe.rom_pcg_iters, tier)
    ks = sample_log_uniform(torch.Generator().manual_seed(cfg.surrogate.seed + 1), cfg.surrogate.n_train,
                            dtype=torch.float32)
    assert torch.equal(pipe.dataset.y_rom, ff(ks))
    th = torch.randn((16, 5), generator=torch.Generator().manual_seed(2)) * 0.6
    assert torch.equal(pipe.batched_forward_fn("rom")(th), ff(torch.exp(th)))
    # the differentiable route: the same values, and at "high" the gradient
    # of "highest" to the tier's accuracy
    th_ = th.clone().requires_grad_(True)
    yd = pipe.batched_forward_fn("rom_nn", differentiable=True)(th_)
    torch.testing.assert_close(yd.detach(), pipe.batched_forward_fn("rom_nn")(th), rtol=0, atol=0)
    if tier != "highest":
        base = builds["highest"]
        same_rom = api.Pipeline(**{**pipe.__dict__, "rom": base.rom, "P0": base.P0,
                                   "surrogate": base.surrogate})
        grads = []
        for p in (same_rom, base):
            t = th.clone().requires_grad_(True)
            (g,) = torch.autograd.grad(torch.sum(p.batched_forward_fn("rom", differentiable=True)(t)), t)
            grads.append(g)
        gap = float((grads[0] - grads[1]).abs().max() / grads[1].abs().max())
        assert (gap <= 2e-3) == (tier == "high"), (tier, gap)
    with pytest.raises(ValueError, match="online_precision"):
        pipe.rom.fast_forward(pipe.P0, 5, "tf32")
