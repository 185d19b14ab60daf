"""The benchmark's frozen yardstick for kernel work: the peaks of the card,
the least time a launch could take, and the streaming floor.

Copied, so that a later change to the package cannot move it, from
``bayesianinferencedl_tpu_torch/utils/roofline.py`` (the H100 peaks, the 26
float32 operations a node and iteration of the stencil PCG,
``stencil_pcg_flops_flat``, and the two (n x m) deflation products,
``deflation_mxu_flops``) and from ``chip_smoke.py`` (``_bound``,
``_k1_bound``, ``_k4_bound``, ``_stream_floor``, ``K3R_BYTES``), as they
stood when the benchmark was written; PERF.md's bounds paragraph states the
same counts, which this copy takes on the fin's own nodes (``fin_nodes``)
rather than on the padded lattice the package's kernels sweep.

Peaks of one NVIDIA H100 80GB HBM3 (SXM, NVIDIA's data sheet, dense rates, at
its 700 W power limit): 3.35 TB/s of HBM, 67 TFLOP/s float32 on the CUDA
cores, 989 TFLOP/s bf16 on the tensor cores.
"""

from __future__ import annotations

import numpy as np

PEAK_HBM = 3.35e12  # bytes/s
PEAK_F32 = 67e12  # FLOP/s
PEAK_BF16 = 989e12  # FLOP/s

K3R_BYTES = 64  # bytes K3r's design moves a node and iteration when state streams from HBM


def bound(nbytes: float, f32_ops: float, bf16_ops: float = 0.0) -> tuple[float, str]:
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of the bytes over the memory rate and the operations over the
    peak rate of their type."""
    t_bytes = nbytes / PEAK_HBM
    t_ops = f32_ops / PEAK_F32 + bf16_ops / PEAK_BF16
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def k3r_bound(B: int, n: int, m: int, iters: np.ndarray) -> tuple[float, str]:
    """One deflated batch of the tile kernels (K1, K3, K3r) on a fin of n
    nodes with these per-sample iteration counts, each sample also doing one
    setup residual. Per iteration and sample: 26 n float32 operations (the
    4-plane stencil, the dots, the vector updates, the Jacobi scaling), the
    coarse solve Binv y (2 m^2, float32) and the two deflation products
    (2 m n each, bf16 operands with float32 sums). Bytes: the (B, 4, n)
    planes, F, the basis (bf16) and the coarse inverses read once, x and the
    counts written once."""
    its = float(np.sum(np.asarray(iters, dtype=np.float64) + 1))
    f32 = its * (26 * n + 2 * m * m)
    bf16 = its * 4 * m * n
    nbytes = 4 * (4 * B * n + n + B * m * m + B * n + B) + 2 * m * n
    return bound(nbytes, f32, bf16)


def k4_bound(B: int, n: int, iters: np.ndarray) -> tuple[float, str]:
    """One cold batch of the single-sample grid kernels (K4, K4r, K4c) on a
    fin of n nodes: 26 float32 operations a node and iteration (each sample
    also does one setup residual); bytes: the (B, 7, n) planes and F read
    once, x and the counts written once."""
    f32 = float(np.sum(np.asarray(iters, dtype=np.float64) + 1)) * 26 * n
    nbytes = 4 * (7 * B * n + n + B * n + B)
    return bound(nbytes, f32)


def stream_floor(bytes_per: int, n: int, iters: np.ndarray) -> float:
    """A streaming kernel's floor (ms): the bytes its design moves per node,
    sample and iteration, times n and the batch's sum(iters + 1), over the
    memory rate."""
    return bytes_per * n * float(np.sum(np.asarray(iters, dtype=np.float64) + 1)) / PEAK_HBM * 1e3


def fin_nodes(resolution: int) -> int:
    """Nodes of the fin's own mesh at this resolution (the plain reference's
    N): the post's (4 R + 1) (16 R + 1) lattice nodes and, for each of the
    four subfins, its R + 1 rows of 24 R + 1 nodes less the post's 4 R + 1.
    The work a solve needs is counted on these; the package's kernels also
    sweep the rest of the (24 R + 1) x (16 R + 1) lattice, padded, which the
    bound does not count."""
    R = int(resolution)
    return (4 * R + 1) * (16 * R + 1) + 4 * (R + 1) * 20 * R
