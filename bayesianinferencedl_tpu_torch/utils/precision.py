"""Matmul precision, chosen per call: full fp32 and the online tiers.

The JAX package pins its accuracy-critical contractions with
``Precision.HIGHEST``, one call at a time. The port's counterpart is
``fp32_matmul()``: inside it, float32 matmuls on the card run in full fp32
(no TF32), whatever the caller has set for the rest of the process; on
leaving it, the caller's settings are restored, also when the body raises.
It works as a context manager and as a function decorator. This module is
the only place in the port that writes the TF32 flags.

The reduced solves' online tiers (``ROMConfig.online_precision``) are the
reference's ``Precision.HIGH`` and ``DEFAULT`` on a TPU's MXU, emulated
exactly and never by TF32 or a process-wide flag (``tier_matmul``):

- "highest": ``a @ b``, run by its caller under ``fp32_matmul()``;
- "high", bf16x3: each float32 factor x splits into hi = bf16(x) and
  lo = bf16(x - hi), and hi.hi + hi.lo + lo.hi is summed in float32;
- "fast": one bf16 product, bf16(a) . bf16(b) summed in float32.

A product of two bf16 values is exact in float32, so the tiers differ from
one another only in what the splits drop; the summation order is the
library's. On the card each tier product is one bf16 tensor-core matmul
with float32 output (the three bf16x3 terms as one matmul over the
concatenated splits); on the CPU the same bf16 parts are upcast and
multiplied under ``fp32_matmul()``.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

TIERS = ("highest", "high", "fast")


@contextlib.contextmanager
def fp32_matmul():
    """Run the body with TF32 off for cuBLAS and cuDNN and the float32
    matmul precision at "highest"; restore the caller's three settings
    after it. The flags are read when a matmul is enqueued, so the
    contractions the body launches (an autograd backward included, if it
    runs inside) keep full fp32 on the card."""
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.set_float32_matmul_precision("highest")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        # the precision first: setting it rewrites the cuBLAS flag, which
        # the next line then puts back as the caller had it
        torch.set_float32_matmul_precision(saved[2])
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]


def check_tier(kind: str) -> str:
    if kind not in TIERS:
        raise ValueError(f"online_precision must be one of {TIERS}, got {kind!r}")
    return kind


class TierOperand(NamedTuple):
    """The fixed right factor b (K, N) of tier products, split once.

    mat: b itself ("highest"), [bf16(b); bf16(b - bf16(b)); bf16(b)] stacked
    to (3K, N) ("high", the factor of [hi_a | hi_a | lo_a]), or bf16(b)
    ("fast"). matT: the same split of b^T, which the product's backward
    multiplies by (the transposed product runs at the same tier, as JAX's
    transpose of a dot_general keeps its precision)."""

    tier: str
    mat: torch.Tensor
    matT: torch.Tensor


def _split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) = (bf16(x), bf16(x - hi)); x - hi is exact in float32."""
    hi = x.to(torch.bfloat16)
    return hi, (x - hi.to(x.dtype)).to(torch.bfloat16)


def _right(b: torch.Tensor, tier: str) -> torch.Tensor:
    if tier == "highest":
        return b
    if tier == "fast":
        return b.to(torch.bfloat16).contiguous()
    hi, lo = _split(b)
    return torch.cat([hi, lo, hi], 0).contiguous()


def tier_operand(b: torch.Tensor, tier: str) -> TierOperand:
    """b (K, N) prepared as the right factor of ``tier_matmul``."""
    check_tier(tier)
    return TierOperand(tier, _right(b, tier), _right(b.T, tier))


def _left(a: torch.Tensor, tier: str) -> torch.Tensor:
    """The left factor (M, K) as ``op.mat`` expects it: bf16(a) ("fast") or
    [hi | hi | lo] (M, 3K) ("high"), the latter written in three passes."""
    if tier == "fast":
        return a.to(torch.bfloat16)
    K = a.shape[-1]
    out = torch.empty((a.shape[0], 3 * K), dtype=torch.bfloat16, device=a.device)
    hi = out[:, :K]
    hi.copy_(a)
    out[:, K:2 * K].copy_(hi)
    torch.sub(a, hi, out=out[:, 2 * K:])  # a - hi is exact in float32, rounded once to bf16
    return out


def bf16_mm_plain(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """``bf16_mm``'s plain version on any device: the bf16 factors upcast to
    float32 (their products are exact there) and one fp32 matmul."""
    with fp32_matmul():
        return (a.to(torch.float32) @ b.to(torch.float32)).to(out_dtype)


def bf16_mm(a: torch.Tensor, b: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    """a (M, K) @ b (K, N), bf16 factors, summed in float32 and returned as
    out_dtype: on the card one bf16 tensor-core matmul with float32 output,
    on the CPU its plain version."""
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32).to(out_dtype)
    return bf16_mm_plain(a, b, out_dtype)


class _TierMM(torch.autograd.Function):
    """a @ b at a bf16 tier, differentiable in a: the backward is g @ b^T at
    the same tier (itself differentiable, so a second backward works)."""

    @staticmethod
    def forward(ctx, a, op):
        ctx.op = op
        return bf16_mm(_left(a, op.tier), op.mat, a.dtype)

    @staticmethod
    def backward(ctx, g):
        op = ctx.op
        return tier_matmul(g, TierOperand(op.tier, op.matT, op.mat)), None


def tier_matmul(a: torch.Tensor, op: TierOperand) -> torch.Tensor:
    """a (..., K) @ b at op's tier (module docstring). At "highest" it is the
    plain float32 product, which the caller pins by running it inside
    ``fp32_matmul()`` (one context around a whole solve, not one a product)."""
    if op.tier == "highest":
        return a @ op.mat
    lead = a.shape[:-1]
    out = _TierMM.apply(a.reshape(-1, a.shape[-1]), op)
    return out.reshape(*lead, out.shape[-1])
