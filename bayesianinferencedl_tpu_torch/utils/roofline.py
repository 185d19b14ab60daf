"""Roofline accounting for the port's hot paths: analytic counts of the work
each algorithm does, and the peaks of the card they run on, so that a
measured time reads as a share of what the card could do.

The peaks are those of the NVIDIA H100 80GB HBM3 (SXM, 700 W power limit),
the card the port's bounds in PERF.md use: HBM3 at 3.35 TB/s, 67 TFLOP/s of
dense float32 on the CUDA cores, 989 TFLOP/s of dense bf16 on the tensor
cores. A card set below 700 W runs slower under load; write its name and
limit (``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``)
beside any share computed from these.

The counts are the JAX package's tallies of the same algorithms (the
stencil PCG, the two-level deflation, the reduced chain step), so the two
packages' figures compare term for term.
"""

from __future__ import annotations

CARD = "NVIDIA H100 80GB HBM3, 700 W"
H100_HBM_BYTES_PER_S = 3.35e12
H100_F32_FLOPS = 67e12
H100_BF16_TENSOR_FLOPS = 989e12


def stencil_pcg_flops(grid_x: int, grid_y: int, iters: float) -> float:
    """FLOPs of one PCG solve on the 7-diagonal stencil over an (X, Y) grid:
    per iteration and cell the 7-point matvec (7 mul + 6 add), three vector
    updates (6), the Jacobi apply (1) and three reductions (~6), ~26."""
    return 26.0 * grid_x * grid_y * iters


def stencil_pcg_flops_flat(n: int, iters: float) -> float:
    """The same 26 flops a cell and iteration on the flat padded length n
    (the lanes and tile layouts, which never touch the grid's padding)."""
    return 26.0 * n * iters


def deflation_mxu_flops(n: int, m: int, iters: float) -> float:
    """Matrix-unit FLOPs of the two-level coarse correction a solve: two
    (n x m) products an iteration (the m x m part is negligible)."""
    return 2.0 * 2.0 * n * m * iters


def stencil_pcg_vmem_bytes_per_sample(n: int, iters: float) -> float:
    """On-chip traffic a solve in the tiled layouts: ~11 arrays of n float32
    touched an iteration (4 stored planes, 3 shifted products, the state
    vectors), 11 * n * 4 * iters bytes a sample."""
    return 11.0 * 4.0 * n * iters


def stencil_pcg_xla_bytes(grid_x: int, grid_y: int, iters: float) -> float:
    """Memory traffic of the same algorithm run as separate array
    operations (``fem/solve.py``): each iteration streams the 7 planes and
    ~6 state vectors, ~17 array passes of 4 bytes a cell. A fused kernel
    that keeps them on chip avoids this."""
    return 17.0 * 4.0 * grid_x * grid_y * iters


def rom_chain_step_flops(r: int, n_iters: int, d: int, m: int, hidden=(64, 64)) -> float:
    """FLOPs of one pCN chain step on the ROM+NN likelihood: the reduced PCG
    (~16 r^2 to start, ~14 r^2 an iteration), the QoI lift 2 m r, the MLP
    2 (d h1 + h1 h2 + h2 m) and the proposal and accept ~2 d^2 + 8 d."""
    pcg = 16.0 * r * r + 14.0 * r * r * n_iters
    lift = 2.0 * m * r
    h1, h2 = hidden
    mlp = 2.0 * (d * h1 + h1 * h2 + h2 * m)
    proposal = 2.0 * d * d + 8.0 * d
    return pcg + lift + mlp + proposal


def pct(achieved: float, peak: float) -> float:
    return round(100.0 * achieved / peak, 2)
