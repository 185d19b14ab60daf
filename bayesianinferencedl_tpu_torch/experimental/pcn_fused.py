"""The fully fused pCN sampler (kernels K2r and K2).

One launch runs the whole sampler for C chains and ``n_steps`` steps; per
step and chain:

  1. two rows of 8 uniforms -> Box-Muller normals (columns 0:d) and the
     accept uniform (column 7 of the second row)
  2. pCN proposal with a per-chain adaptive step size beta = exp(log beta)
  3. ROM solve: ``cg_iters`` fixed preconditioned-CG iterations whose
     operator apply is p @ [Ahat_1 | .. | Ahat_5 | Bi*Mhat] (r, 6r) plus a
     k-weighted sum and whose preconditioner is v @ P0^T
  4. tanh MLP correction with 2 hidden layers, the output normaliser folded
     into W3 and b3
  5. Metropolis accept; Robbins-Monro log-beta adaptation with step
     0.5 (1+t)^-0.6 during burn-in
  6. one (C, 8) row [theta(5) | phi | log beta | accept] of the (T, C, 8)
     trace

On CUDA tensors ``run_pcn_fused`` launches K2r (``csrc/pcn_fused_r.cu``):
one warp per chain, the step loop inside the kernel, each chain's
A(k) = sum_j k_j Ahat_j + Bi*Mhat assembled once per proposal and held in
registers for the whole reduced CG, so a product costs r^2 FMAs where the
stacked form of step 3 costs 6 r^2; ``k2r_plan`` gives its launch shape. K2
(``csrc/pcn_fused.cu``, the stacked product with the operators in shared
memory) computes the same function and stays built, off the main path,
reachable only through ``_launch``, as the record ``chip_smoke.py`` times K2r
against. On CPU tensors ``run_pcn_fused`` runs ``pcn_fused_reference``, the
plain torch version of the same step, which the tests hold against the JAX
Pallas kernel and against ``infer.pcn.run_pcn``, and ``chip_smoke.py`` holds
both CUDA kernels against.

Random numbers: uniforms come from Philox4x32-10 keyed by ``seed`` with the
counter (chain, step, draw, 0); draw q = 0..3 gives uniforms 4q..4q+3 of the
step's 16 ([u1 | u2]). Each 32-bit word maps to (bits >> 8) 2^-24 + 2^-25
in float32, never 0, as the reference maps its hardware bits. The plain
version computes the same Philox stream in torch, so on the same seed the
two versions draw the same uniforms. Either version takes injected uniforms
``(u1, u2)`` in place of the generator's and can return the ones it used.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from bayesianinferencedl_tpu_torch.utils.precision import fp32_matmul

STATE_COLS = 8  # [theta_0..theta_4 | phi | log_beta | accept]
TARGET_ACCEPT = 0.234
MAX_DIM = 5
MAX_OBS = 8
# one warp per chain, each lane holding two entries of an h-vector (and, in
# K2, of an r-vector; K2r holds r-vectors and matrices in tiles, r <= 64)
MAX_R = 64
MAX_H = 64
LOG_BETA_LO, LOG_BETA_HI = math.log(1e-4), math.log(0.9999)

_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK32 = 0xFFFFFFFF

launches = 0  # K2 launches in this process (off the main path: ``_launch`` only)
r_launches = 0  # K2r launches in this process (the CUDA path of ``run_pcn_fused``)

# K2r's launch plan (csrc/pcn_fused_r.cu, whose constants these mirror)
K2R_WARPS = (8, 4, 2, 1)  # warps (chains) per block it is launched with
K2R_REG_MAX = 48  # A(k) and P0 in registers up to this padded r, else in shared memory
MAX_SMEM = 232_448  # the shared memory a block may opt into on an H100
H100_SMS = 132


class FusedPCNResult(NamedTuple):
    samples: torch.Tensor  # (n_kept, C, d)
    phi_trace: torch.Tensor  # (n_kept, C)
    accept_rate: torch.Tensor  # (C,)
    beta: torch.Tensor  # (C,) final step sizes
    trace: Optional[torch.Tensor] = None  # (n_steps, C, 8) every step's state row
    uniforms: Optional[tuple] = None  # (u1, u2), each (n_steps, C, 8), when asked for


class FusedOperands(NamedTuple):
    """The sampler's operands, packed as the reference packs them."""

    theta0: torch.Tensor  # (C, 8): columns 0:d initial thetas, rest 0
    astack: torch.Tensor  # (r, 6r): [Ahat_1 | .. | Ahat_5 | biot*Mhat]
    P0: torch.Tensor  # (r, r)
    fhat: torch.Tensor  # (r,)
    bhatT: torch.Tensor  # (r, 8): Bhat^T, zero-padded to 8 observables
    w1: torch.Tensor  # (8, h1): rows d:8 zero
    b1: torch.Tensor  # (h1,)
    w2: torch.Tensor  # (h1, h2)
    b2: torch.Tensor  # (h2,)
    w3: torch.Tensor  # (h2, 8): W3 * y_std, zero-padded columns
    b3: torch.Tensor  # (8,): b3 * y_std + y_mean, zero-padded
    xnorm: torch.Tensor  # (2, 8): x_mean, 1 / x_std (padding 0)
    data: torch.Tensor  # (8,): observations, zero-padded
    consts: torch.Tensor  # (4,): prior mean, prior sigma, 1 / (2 noise^2), initial beta
    d: int


def _mulhilo(a: int, b: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """High and low 32-bit words of a * b for a < 2^32 and int64 b < 2^32,
    in 16-bit halves so that no product leaves int64."""
    p0 = a * (b & 0xFFFF)
    t = a * (b >> 16) + (p0 >> 16)
    return t >> 16, ((t & 0xFFFF) << 16) | (p0 & 0xFFFF)


def philox4x32(c0, c1, c2, c3, key: int):
    """Philox4x32-10 on int64 tensors holding 32-bit words; ``key`` is the
    64-bit key (low word first). Returns the four output words."""
    k0, k1 = key & _MASK32, (key >> 32) & _MASK32
    for _ in range(10):
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + _PHILOX_W[0]) & _MASK32, (k1 + _PHILOX_W[1]) & _MASK32
    return c0, c1, c2, c3


def philox_uniforms(seed: int, step: int, n_chains: int, dtype=torch.float32, device="cpu"):
    """Step ``step``'s uniforms (u1, u2), each (C, 8), as the kernel draws
    them."""
    chain = torch.arange(n_chains, dtype=torch.int64, device=device)[:, None]
    draw = torch.arange(4, dtype=torch.int64, device=device)[None, :]
    zero = torch.zeros((n_chains, 4), dtype=torch.int64, device=device)
    words = philox4x32(chain + zero, zero + step, draw + zero, zero, seed)
    bits = torch.stack(words, -1).reshape(n_chains, 16)  # draw q -> columns 4q..4q+3
    u = (bits >> 8).to(dtype) * 2.0**-24 + 2.0**-25
    return u[:, :STATE_COLS].contiguous(), u[:, STATE_COLS:].contiguous()


def _is_iid(prior) -> bool:
    mean, chol = prior.mean, prior.chol
    return bool((mean == mean[0]).all()) and bool(
        torch.equal(chol, chol[0, 0] * torch.eye(chol.shape[0], dtype=chol.dtype, device=chol.device))
    )


def pack_operands(rom, P0, surrogate_params, surrogate_norm, prior, data, noise_sigma,
                  theta0, beta) -> FusedOperands:
    """Check the sampler's limits and pack its operands in theta0's dtype
    and device, as the reference's wrapper packs them."""
    C, d = theta0.shape
    r = rom.r
    m = rom.Bhat.shape[0]
    if d > MAX_DIM:
        raise ValueError(f"the fused sampler takes at most {MAX_DIM} parameters, got d = {d}")
    if m > MAX_OBS:
        raise ValueError(f"the fused sampler takes at most {MAX_OBS} observables, got {m}")
    if len(surrogate_params) != 3:
        raise ValueError(f"the fused sampler supports the 2-hidden-layer MLP, got "
                         f"{len(surrogate_params) - 1} hidden layers")
    if not _is_iid(prior):
        raise ValueError("the fused sampler needs an iid Gaussian prior (equal means, chol = sigma I)")
    (W1, b1), (W2, b2), (W3, b3) = surrogate_params
    h1, h2 = W1.shape[1], W2.shape[1]
    if r > MAX_R or max(h1, h2) > MAX_H:
        raise ValueError(f"the fused kernel takes r <= {MAX_R} and hidden widths <= {MAX_H} "
                         f"(got r = {r}, widths {h1}, {h2})")
    dt, dev = theta0.dtype, theta0.device
    f = lambda t: torch.as_tensor(t, dtype=dt, device=dev).detach()
    norm = surrogate_norm

    def pad(t, shape, index):
        out = torch.zeros(shape, dtype=dt, device=dev)
        out[index] = f(t)
        return out

    astack = torch.cat([f(rom.Ahat[i]) for i in range(5)] + [f(rom.biot) * f(rom.Mhat)], 1)
    y_std = f(norm.y_std)
    consts = torch.stack([
        f(prior.mean[0]), f(prior.chol[0, 0]),
        torch.tensor(0.5, dtype=dt, device=dev) / torch.tensor(noise_sigma, dtype=dt, device=dev) ** 2,
        torch.tensor(beta, dtype=dt, device=dev),
    ])
    return FusedOperands(
        theta0=pad(theta0, (C, STATE_COLS), (slice(None), slice(0, d))),
        astack=astack.contiguous(),
        P0=f(P0).contiguous(),
        fhat=f(rom.Fhat).contiguous(),
        bhatT=pad(rom.Bhat.T, (r, STATE_COLS), (slice(None), slice(0, m))),
        w1=pad(W1, (STATE_COLS, h1), slice(0, d)),
        b1=f(b1).contiguous(),
        w2=f(W2).contiguous(),
        b2=f(b2).contiguous(),
        w3=pad(f(W3) * y_std[None, :], (h2, STATE_COLS), (slice(None), slice(0, m))),
        b3=pad(f(b3) * y_std + f(norm.y_mean), (STATE_COLS,), slice(0, m)),
        xnorm=torch.stack([pad(norm.x_mean, (STATE_COLS,), slice(0, d)),
                           pad(1.0 / f(norm.x_std), (STATE_COLS,), slice(0, d))]),
        data=pad(data, (STATE_COLS,), slice(0, m)),
        consts=consts,
        d=d,
    )


def _k_aug(ops: FusedOperands, theta: torch.Tensor) -> torch.Tensor:
    """(C, 6) weights of astack's components at theta (C, 8): exp(theta_j)
    for j < d, 0 for d <= j < 5, and 1 for Bi*Mhat."""
    col_mask = torch.arange(STATE_COLS, device=theta.device) < ops.d
    k = torch.where(col_mask, torch.exp(theta), 0.0)
    return torch.cat([k[:, :5], torch.ones_like(k[:, :1])], 1)


def stacked_amat(astack: torch.Tensor, k_aug: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """A(k) p as the reference forms it (K2's product): one p @ astack
    (C, 6r), then the k-weighted sum of its r-column blocks."""
    r = astack.shape[0]
    comp = p @ astack  # (C, 6r)
    acc = k_aug[:, 0:1] * comp[:, :r]
    for j in range(1, 6):
        acc = acc + k_aug[:, j:j + 1] * comp[:, j * r:(j + 1) * r]
    return acc


@fp32_matmul()
def _misfit(ops: FusedOperands, theta: torch.Tensor, cg_iters: int) -> torch.Tensor:
    """phi (C,) at theta (C, 8) with columns d:8 zero: the reference's
    likelihood_phi, operation for operation."""
    C = theta.shape[0]
    r = ops.astack.shape[0]
    k_aug = _k_aug(ops, theta)  # (C, 6)

    def amat(p):
        return stacked_amat(ops.astack, k_aug, p)

    def prec(v):
        return v @ ops.P0.T

    b = ops.fhat.expand(C, r)
    x = prec(b)
    res = b - amat(x)
    z = prec(res)
    p = z
    rz = torch.sum(res * z, 1, keepdim=True)
    for _ in range(cg_iters):
        Ap = amat(p)
        pAp = torch.sum(p * Ap, 1, keepdim=True)
        alpha = rz / torch.where(pAp != 0, pAp, 1.0)
        x = x + alpha * p
        res = res - alpha * Ap
        z = prec(res)
        rz_new = torch.sum(res * z, 1, keepdim=True)
        beta = rz_new / torch.where(rz != 0, rz, 1.0)
        p = z + beta * p
        rz = rz_new
    y_rom = x @ ops.bhatT

    xs = (theta - ops.xnorm[0]) * ops.xnorm[1]
    h1 = torch.tanh(xs @ ops.w1 + ops.b1)
    h2 = torch.tanh(h1 @ ops.w2 + ops.b2)
    e = h2 @ ops.w3 + ops.b3
    rres = y_rom + e - ops.data
    return torch.sum(rres * rres, 1) * ops.consts[2]


def pcn_fused_reference(ops: FusedOperands, *, n_steps: int, n_burn: int, cg_iters: int,
                        seed: int = 0, uniforms: Optional[tuple] = None,
                        keep_uniforms: bool = False):
    """The plain torch sampler: K2's step, batched over chains, in ops'
    dtype. uniforms: optional (u1, u2), each (n_steps, C, 8); else Philox
    draws from ``seed``. Returns (trace (n_steps, C, 8), the drawn (u1, u2)
    if ``keep_uniforms`` else None)."""
    theta0 = ops.theta0
    C = theta0.shape[0]
    dt, dev = theta0.dtype, theta0.device
    pm, ps, _, beta0 = ops.consts
    col = torch.arange(STATE_COLS, device=dev)
    col_mask = col < ops.d
    two_pi = torch.tensor(2.0 * math.pi, dtype=torch.float32).to(dt)

    theta = torch.where(col_mask, theta0, 0.0)
    phi = _misfit(ops, theta, cg_iters)
    lbeta = torch.log(beta0).expand(C)
    out = torch.empty((n_steps, C, STATE_COLS), dtype=dt, device=dev)
    kept_u = [] if keep_uniforms else None
    for t in range(n_steps):
        if uniforms is not None:
            u1, u2 = uniforms[0][t], uniforms[1][t]
        else:
            u1, u2 = philox_uniforms(seed, t, C, dt, dev)
        if kept_u is not None:
            kept_u.append((u1, u2))
        normals = torch.sqrt(-2.0 * torch.log(u1)) * torch.cos(two_pi * u2)
        u_acc = u2[:, 7]

        beta = torch.exp(lbeta)[:, None]
        contract = torch.sqrt(torch.clamp(1.0 - beta * beta, min=0.0))
        prop = pm + contract * (theta - pm) + beta * ps * normals
        prop = torch.where(col_mask, prop, 0.0)
        phi_prop = _misfit(ops, prop, cg_iters)
        accept = torch.log(u_acc) < phi - phi_prop

        theta = torch.where(accept[:, None] & col_mask, prop, theta)
        phi = torch.where(accept, phi_prop, phi)
        acc = accept.to(dt)
        if t < n_burn:
            decay = torch.exp(torch.tensor(-0.6, dtype=dt) * torch.log(torch.tensor(1.0 + t, dtype=dt)))
            lbeta = lbeta + (0.5 * decay).to(dev) * (acc - TARGET_ACCEPT)
        lbeta = torch.clamp(lbeta, LOG_BETA_LO, LOG_BETA_HI)
        out[t] = theta
        out[t, :, 5] = phi
        out[t, :, 6] = lbeta
        out[t, :, 7] = acc
    if kept_u is not None:
        kept_u = tuple(torch.stack(u) for u in zip(*kept_u))
    return out, kept_u


def run_pcn_fused(
    rom,  # rom.galerkin.ReducedOperator
    P0: torch.Tensor,
    surrogate_params,  # [(W, b)] x 3: the tanh MLP with exactly 2 hidden layers
    surrogate_norm,  # models.surrogate.Normalizer
    prior,  # infer.priors.GaussianPrior (iid)
    data: torch.Tensor,  # (m,)
    noise_sigma: float,
    theta0: torch.Tensor,  # (C, d)
    seed: int,
    *,
    n_steps: int,
    n_burn: int = 0,
    beta: float = 0.25,
    cg_iters: int = 20,
    uniforms: Optional[tuple] = None,
    return_uniforms: bool = False,
) -> FusedPCNResult:
    """Run the fully fused pCN sampler on theta0's device.

    Limits (each raises ValueError): iid Gaussian prior, d <= 5 parameters,
    m <= 8 observables, an MLP of exactly 2 hidden layers (tanh is applied,
    as in the reference), r <= 64 and hidden widths <= 64. The last pair is
    the kernels' layout (one warp per chain: K2r holds an (r/4, r/8) tile of
    A(k) and of P0 in each lane, and two entries of each hidden layer);
    ``k2r_plan`` gives the launch, its template instance and its shared
    memory.

    The operands are packed in theta0's dtype; the kernel (K2r) takes
    float32, and on a CUDA tensor a failed build or launch raises.
    ``uniforms``: optional (u1, u2), each (n_steps, C, 8), used in place of
    the Philox draws from ``seed``; ``return_uniforms`` puts the uniforms
    the run used into the result. ``cg_iters = pipe.rom_pcg_iters`` targets
    the posterior of ``run_inversion``'s pcn."""
    if n_steps < 1 or not 0 <= n_burn <= n_steps or cg_iters < 0:
        raise ValueError(f"need n_steps >= 1, 0 <= n_burn <= n_steps, cg_iters >= 0 "
                         f"(got {n_steps}, {n_burn}, {cg_iters})")
    if not 0 <= int(seed) < 2**64:
        raise ValueError(f"seed must be a 64-bit unsigned integer, got {seed}")
    ops = pack_operands(rom, P0, surrogate_params, surrogate_norm, prior, data, noise_sigma,
                        theta0, beta)
    C, dev = theta0.shape[0], theta0.device
    if uniforms is not None:
        uniforms = tuple(uniforms)
        for u in uniforms:
            if tuple(u.shape) != (n_steps, C, STATE_COLS) or u.dtype != theta0.dtype or u.device != dev:
                raise ValueError(f"uniforms must be two {theta0.dtype} tensors of shape "
                                 f"{(n_steps, C, STATE_COLS)} on {dev}")
    kw = dict(n_steps=n_steps, n_burn=n_burn, cg_iters=cg_iters, seed=int(seed), uniforms=uniforms,
              keep_uniforms=return_uniforms and uniforms is None)
    if dev.type == "cpu":
        out, drawn = pcn_fused_reference(ops, **kw)
    elif dev.type == "cuda":
        out, drawn = _launch(ops, **kw)
    else:
        raise ValueError(f"K2r runs on CUDA or CPU tensors, got {dev}")
    kept = out[n_burn:]
    return FusedPCNResult(
        samples=kept[:, :, :ops.d],
        phi_trace=kept[:, :, 5],
        accept_rate=torch.mean(kept[:, :, 7], 0),
        beta=torch.exp(out[-1, :, 6]),
        trace=out,
        uniforms=(uniforms or drawn) if return_uniforms else None,
    )


class K2rPlan(NamedTuple):
    """K2r's launch for C chains at widths (r, h1, h2) (``k2r_plan``)."""

    r_pad: int  # r rounded up to a multiple of 8: the template instance
    instance: str  # the kernel's template instance
    tile: tuple  # (rows, columns) of A(k) and of P0 each lane holds: (r_pad / 4, r_pad / 8)
    a_in: str  # where a chain's A(k) lives: "registers" or "shared"
    p0_in: str  # where P0 lives: "registers" or "shared"
    warps: int  # warps (chains) per block
    blocks: int
    smem_bytes: int  # dynamic shared memory of one block


def _check_widths(r: int, h1: int, h2: int) -> None:
    if not (1 <= r <= MAX_R and 1 <= h1 <= MAX_H and 1 <= h2 <= MAX_H):
        raise ValueError(f"the fused kernels take 1 <= r <= {MAX_R} and hidden widths 1..{MAX_H} "
                         f"(got r = {r}, widths {h1}, {h2})")


def k2r_astack_stride(r: int) -> int:
    """The row stride of astack in K2r's shared memory (the kernel's
    ``astack_stride``), where it is held zero-padded to (rp, 6 rp): the
    least S >= 6 rp for which the 32 lanes' reads of one assembly step,
    lane cb + 8 rb at word (rp / 4) rb S + (rp / 8) cb, fall on the fewest
    words of one of the 32 banks."""
    rp = 8 * -(-r // 8)
    hr, wc = rp // 4, rp // 8

    def ways(S):
        banks = [(hr * (lane >> 3) * S + wc * (lane & 7)) % 32 for lane in range(32)]
        return max(banks.count(b) for b in set(banks))

    return min(range(6 * rp, 6 * rp + 32), key=lambda S: (ways(S), S))


def k2r_smem_bytes(r: int, h1: int, h2: int, warps: int) -> int:
    """One K2r block's dynamic shared memory, as the kernel's ``layout``
    counts it: astack (rp rows of ``k2r_astack_stride``), P0 transposed
    (rp, rp) where it is not in registers, fhat (rp), Bhat^T (rp, 8), the
    MLP padded to 64 wide, x_norm and the data; then per warp 16 uniforms
    and, where it is not in registers, the chain's A(k) (rp, rp). rp is r
    rounded up to a multiple of 8; every section starts on a 16-byte
    boundary. h1 and h2 do not change it."""
    _check_widths(r, h1, h2)
    rp = 8 * -(-r // 8)
    mats = rp * rp if rp > K2R_REG_MAX else 0
    up4 = lambda n: -(-n // 4) * 4
    block = [rp * k2r_astack_stride(r), mats, rp, rp * STATE_COLS, STATE_COLS * MAX_H, MAX_H,
             MAX_H * MAX_H, MAX_H, MAX_H * STATE_COLS, STATE_COLS, 2 * STATE_COLS, STATE_COLS]
    per_warp = [2 * STATE_COLS, mats]
    return 4 * (sum(map(up4, block)) + warps * sum(map(up4, per_warp)))


def k2r_plan(C: int, r: int, h1: int, h2: int, sms: int = H100_SMS) -> K2rPlan:
    """K2r's launch shape on a card of ``sms`` SMs. One warp per chain; the
    warps per block are the most of ``K2R_WARPS`` whose block fits the
    shared memory and still gives at least one block per SM (C = 1,024 on
    132 SMs: 4, so 256 blocks, two to an SM where the card holds them), else
    the fewest that fit. Raises ValueError for widths the kernel does not
    take."""
    _check_widths(r, h1, h2)
    if C < 1 or sms < 1:
        raise ValueError(f"need C >= 1 and sms >= 1 (got {C}, {sms})")
    rp = 8 * -(-r // 8)
    fits = [w for w in K2R_WARPS if k2r_smem_bytes(r, h1, h2, w) <= MAX_SMEM]
    cover = [w for w in fits if -(-C // w) >= sms]
    warps = max(cover) if cover else min(fits)
    where = "registers" if rp <= K2R_REG_MAX else "shared"
    return K2rPlan(r_pad=rp, instance=f"pcn_fused_r_kernel<{rp}>", tile=(rp // 4, rp // 8),
                   a_in=where, p0_in=where, warps=warps, blocks=-(-C // warps),
                   smem_bytes=k2r_smem_bytes(r, h1, h2, warps))


def _launch(ops: FusedOperands, *, n_steps, n_burn, cg_iters, seed, uniforms, keep_uniforms,
            kernel="K2r"):
    """Launch K2r (``kernel="K2r"``, the main path's, on ``k2r_plan``'s
    shape) or K2 (``kernel="K2"``, off the main path: ``chip_smoke.py``
    times it beside K2r) and count the launch.
    Returns (trace (n_steps, C, 8), the drawn (u1, u2) if ``keep_uniforms``
    else None)."""
    global launches, r_launches
    from bayesianinferencedl_tpu_torch.ops import _build

    if kernel not in ("K2r", "K2"):
        raise ValueError(f"kernel is K2r or K2, got {kernel!r}")
    operands = [ops.theta0, ops.astack, ops.P0, ops.fhat, ops.bhatT, ops.w1, ops.b1, ops.w2,
                ops.b2, ops.w3, ops.b3, ops.xnorm, ops.data]
    u_in = tuple(u.contiguous() for u in uniforms) if uniforms is not None else (None, None)
    for t in operands + [u for u in u_in if u is not None]:
        if t.dtype != torch.float32:
            raise TypeError(f"{kernel} takes float32 operands, got {t.dtype}")
    C = ops.theta0.shape[0]
    r = ops.astack.shape[0]
    h1, h2 = ops.w2.shape
    _check_widths(r, h1, h2)
    if kernel == "K2r":
        fn = _build.load_library("pcn_fused_r").pcn_fused_r_launch
        shape_types = [ctypes.c_int] * 9
    else:
        fn = _build.load_library("pcn_fused").pcn_fused_launch
        shape_types = [ctypes.c_int] * 8
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 18 + shape_types + [ctypes.c_float] * 4
        + [ctypes.c_ulonglong, ctypes.c_void_p]
    )
    dev = ops.theta0.device
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        shape = [C, r, h1, h2, ops.d, n_steps, n_burn, cg_iters]
        if kernel == "K2r":
            plan = k2r_plan(C, r, h1, h2, torch.cuda.get_device_properties(dev).multi_processor_count)
            shape.append(plan.warps)
        out = torch.empty((n_steps, C, STATE_COLS), dtype=torch.float32, device=dev)
        u_out = tuple(torch.empty_like(out) for _ in range(2)) if keep_uniforms else (None, None)
        pm, ps, inv2n2, beta0 = (float(v) for v in ops.consts.cpu())
        err = fn(
            *(ptr(t) for t in operands), *(ptr(u) for u in u_in), *(ptr(u) for u in u_out),
            ptr(out), *shape, pm, ps, inv2n2, beta0, seed,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{kernel}'s launch failed with cudaError_t {err}")
    if kernel == "K2r":
        r_launches += 1
    else:
        launches += 1
    return out, (u_out if keep_uniforms else None)
