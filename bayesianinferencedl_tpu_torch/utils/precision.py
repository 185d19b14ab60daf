"""Full-fp32 matmuls, pinned per call.

The JAX package pins its accuracy-critical contractions with
``Precision.HIGHEST``, one call at a time. The port's counterpart is
``fp32_matmul()``: inside it, float32 matmuls on the card run in full fp32
(no TF32), whatever the caller has set for the rest of the process; on
leaving it, the caller's settings are restored, also when the body raises.
It works as a context manager and as a function decorator. This module is
the only place in the port that writes the TF32 flags.
"""

from __future__ import annotations

import contextlib

import torch


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
