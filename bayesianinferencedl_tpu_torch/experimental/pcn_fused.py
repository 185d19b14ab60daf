"""The fully fused pCN sampler (kernel K2).

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

On CUDA tensors ``run_pcn_fused`` launches the hand-written kernel in
``csrc/pcn_fused.cu`` (one warp per chain, the step loop inside the kernel,
the operators in shared memory). On CPU tensors it runs
``pcn_fused_reference``, the plain torch version of the same step, which the
tests hold against the JAX Pallas kernel and against ``infer.pcn.run_pcn``,
and ``chip_smoke.py`` holds the CUDA kernel against.

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

STATE_COLS = 8  # [theta_0..theta_4 | phi | log_beta | accept]
TARGET_ACCEPT = 0.234
MAX_DIM = 5
MAX_OBS = 8
# one warp per chain, each lane holding two entries of an r- or h-vector
MAX_R = 64
MAX_H = 64
LOG_BETA_LO, LOG_BETA_HI = math.log(1e-4), math.log(0.9999)

_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK32 = 0xFFFFFFFF

launches = 0  # K2 launches in this process (the CUDA path only)


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


def _misfit(ops: FusedOperands, theta: torch.Tensor, cg_iters: int) -> torch.Tensor:
    """phi (C,) at theta (C, 8) with columns d:8 zero: the reference's
    likelihood_phi, operation for operation."""
    C = theta.shape[0]
    r = ops.astack.shape[0]
    col_mask = torch.arange(STATE_COLS, device=theta.device) < ops.d
    k = torch.where(col_mask, torch.exp(theta), 0.0)
    k_aug = torch.cat([k[:, :5], torch.ones_like(k[:, :1])], 1)  # (C, 6)

    def amat(p):
        comp = p @ ops.astack  # (C, 6r)
        acc = k_aug[:, 0:1] * comp[:, :r]
        for j in range(1, 6):
            acc = acc + k_aug[:, j:j + 1] * comp[:, j * r:(j + 1) * r]
        return acc

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
    the kernel's layout (one warp per chain, two vector entries per lane);
    at r = 64 and h = 64 the operands the kernel stages in one block's
    shared memory come to about 138 KB of the 227 KB a block may use.

    The operands are packed in theta0's dtype; the kernel takes float32.
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
        raise ValueError(f"K2 runs on CUDA or CPU tensors, got {dev}")
    kept = out[n_burn:]
    return FusedPCNResult(
        samples=kept[:, :, :ops.d],
        phi_trace=kept[:, :, 5],
        accept_rate=torch.mean(kept[:, :, 7], 0),
        beta=torch.exp(out[-1, :, 6]),
        trace=out,
        uniforms=(uniforms or drawn) if return_uniforms else None,
    )


def _launch(ops: FusedOperands, *, n_steps, n_burn, cg_iters, seed, uniforms, keep_uniforms):
    global launches
    from bayesianinferencedl_tpu_torch.ops._build import load_library

    operands = [ops.theta0, ops.astack, ops.P0, ops.fhat, ops.bhatT, ops.w1, ops.b1, ops.w2,
                ops.b2, ops.w3, ops.b3, ops.xnorm, ops.data]
    u_in = tuple(u.contiguous() for u in uniforms) if uniforms is not None else (None, None)
    for t in operands + [u for u in u_in if u is not None]:
        if t.dtype != torch.float32:
            raise TypeError(f"K2 takes float32 operands, got {t.dtype}")
    lib = load_library("pcn_fused")
    fn = lib.pcn_fused_launch
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 18
        + [ctypes.c_int] * 8
        + [ctypes.c_float] * 4
        + [ctypes.c_ulonglong, ctypes.c_void_p]
    )
    C = ops.theta0.shape[0]
    r = ops.astack.shape[0]
    h1, h2 = ops.w2.shape
    dev = ops.theta0.device
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        out = torch.empty((n_steps, C, STATE_COLS), dtype=torch.float32, device=dev)
        u_out = tuple(torch.empty_like(out) for _ in range(2)) if keep_uniforms else (None, None)
        pm, ps, inv2n2, beta0 = (float(v) for v in ops.consts.cpu())
        err = fn(
            *(ptr(t) for t in operands), *(ptr(u) for u in u_in), *(ptr(u) for u in u_out),
            ptr(out), C, r, h1, h2, ops.d, n_steps, n_burn, cg_iters,
            pm, ps, inv2n2, beta0, seed, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"pcn_fused_launch failed with cudaError_t {err}")
    launches += 1
    return out, (u_out if keep_uniforms else None)
