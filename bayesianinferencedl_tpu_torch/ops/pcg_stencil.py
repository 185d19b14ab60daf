"""Fused batched Jacobi-PCG on the 7-diagonal stencil (kernels K1, K3r, K3, K4r, K4c, K4).

A FOM solve is CG on the symmetric stencil operator of ``fem/dia.py``. Three
hand-written CUDA kernels compute it, one for each layout of the JAX
package's ``solve_fom_stencil_pallas``, chosen by the mesh size alone
(``layout_for``, the JAX package's ``pick_layout`` rule):

- "lanes", K1, ``pcg_stencil`` (``csrc/pcg_stencil.cu``): one thread block
  per sample, with the optional two-level deflation preconditioner of
  ``ops/deflation.py``, up to n = 18,618 (res4);
- "sublanes", ``pcg_stencil_tile``, up to n = 182,044 (res8 to res21): a
  tile of 8 samples shares each pass over the deflation basis. On the card
  K3r (``csrc/pcg_stencil_tile_mma.cu``) computes it: each tile runs on a
  thread-block cluster of ``tile_cluster`` blocks, each block a range of
  16-node row tiles (``tile_ranges``), the two deflation products on the
  tensor cores. K3 (``csrc/pcg_stencil_tile.cu``, one block per tile) stays
  built beside it, off the main path, and ``chip_smoke.py`` holds both
  against the plain version;
- "single", ``pcg_stencil_grid``: one sample's undeflated Jacobi-PCG on its
  2-D grid, above that (res >= 22). Like the JAX package's single-sample
  layout, it applies no deflation even when one is passed, and checks
  convergence every iteration. Two kernels compute it, chosen by
  ``grid_route`` from the grid's size and the card's shared memory: K4r
  (``csrc/pcg_stencil_grid_resident.cu``) keeps one sample's whole solve in
  the shared memory of every SM, one row strip per SM, wherever the strips
  fit (res22-38 on an H100); K4c (``csrc/pcg_stencil_grid_cluster.cu``)
  streams each sample's state from device memory over the true grid, one
  sample per thread-block cluster of ``grid_cluster`` blocks, beyond that.
  K4 (``csrc/pcg_stencil_grid.cu``, one block per sample) stays built beside
  them, off the main path, and ``chip_smoke.py`` holds all three against the
  plain version.

On a CUDA tensor a wrapper launches its kernel; on a CPU tensor it runs the
plain batched torch version of the same math (``pcg_stencil_reference``,
``pcg_stencil_grid_reference``), which the tests hold against the JAX Pallas
kernels and ``chip_smoke.py`` holds the CUDA kernels against.

Semantics shared by K1, K3 and K3r (those of the JAX kernels' ``_jacobi_cg``,
except that convergence is per sample, not per tile of samples):

- the operator is given by its 4 upper diagonal planes [0, +o1, +o2, +o3]
  (A is symmetric); reads outside [0, n) count as zero;
- z = D^-1 r, plus Wt^T bf16(Binv_b (Wt bf16(r))) when deflated, with Wt
  held in bf16 and f32 accumulation; D^-1 is 0 where the diagonal is 0;
- alpha and beta are 0 where their denominators are not positive;
- a sample stops once ||r||^2 <= tol^2 ||F||^2, tested every
  ``check_every`` iterations, or at ``maxiter`` iterations; the returned
  count is per sample; a stopped sample is frozen while the others iterate;
- x0 = None starts from zero (the JAX sublanes kernel's cold-start variant).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from bayesianinferencedl_tpu_torch.fem.solve import pcg

DIAG_SLOT = 3  # index of offset 0 in the ascending 7-offset DIA layout

launches = 0  # K1 launches in this process (the CUDA path only)
tile_launches = 0  # K3 launches in this process (the CUDA path only)
tile_mma_launches = 0  # K3r launches in this process (the CUDA path only)
grid_launches = 0  # K4 launches in this process (the CUDA path only)
grid_resident_launches = 0  # K4r launches in this process (the CUDA path only)
grid_cluster_launches = 0  # K4c launches in this process (the CUDA path only)

# the JAX package's 2-D stencil offsets (dx, dy), in the DIA plane order
# [-(ny+2), -(ny+1), -1, 0, 1, ny+1, ny+2]
OFFSETS_2D = ((-1, -1), (-1, 0), (0, -1), (0, 0), (0, 1), (1, 0), (1, 1))

# The largest n the JAX package solves with its lanes kernel: that layout's
# VMEM working set, 11 * n * 128 * 4 bytes, must fit its 100 MiB budget
# (bayesianinferencedl_tpu/ops/pcg_stencil.py, pick_layout). Up to this
# size the port takes K1, above it K3. res4 (n = 6,400) is below; res8
# (24,960) and res16 (99,072) are above.
LANES_MAX_N = (100 * 1024 * 1024) // (11 * 128 * 4)  # 18,618
# The largest n the JAX package solves with its sublanes kernel: a tile of 8
# samples needs ~18 * 8 * n * 4 bytes of its 100 MiB VMEM budget (the same
# pick_layout). Above it the JAX package takes its single-sample kernel and
# the port its single layout: res21 (n = 170,240) is below, res22 (186,752) and res32
# (394,624) are above.
SUBLANES_MAX_N = (100 * 1024 * 1024) // (18 * 8 * 4)  # 182,044
TILE_MAX_M = 128  # the largest coarse space K3 and K3r are built for
TILE_ROW = 16  # K3r's MMA row tile: its node ranges are whole row tiles
TILE_CLUSTERS = (1, 2, 4, 8)  # the cluster sizes K3r is launched with (8: the portable maximum)


def upper_planes(vals: torch.Tensor) -> torch.Tensor:
    """(B, n, 7) DIA values -> (B, 4, n) contiguous [diag, +o1, +o2, +o3]."""
    return vals[..., DIAG_SLOT:].transpose(-1, -2).contiguous()


def pcg_stencil_reference(
    vals4: torch.Tensor,
    F: torch.Tensor,
    x0: torch.Tensor | None = None,
    *,
    offsets: tuple,
    tol: float,
    maxiter: int,
    Wt: torch.Tensor | None = None,
    Binv: torch.Tensor | None = None,
    check_every: int = 16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain batched torch PCG: the contract of K1 and K3 (module docstring).

    vals4 (B, 4, n); F (n,); x0 (B, n) or None; offsets: the 3 positive
    flat offsets; Wt (m, n) bf16 and Binv (B, m, m), both or neither.
    Returns (x (B, n), iters (B,) int32). Converged samples are frozen
    while the others iterate, so each sample sees exactly its own run."""
    B, _, n = vals4.shape
    dt = vals4.dtype

    def matvec(p):
        acc = vals4[:, 0] * p
        for j, o in enumerate(offsets):
            v = vals4[:, 1 + j]
            acc[:, : n - o] += v[:, : n - o] * p[:, o:]
            acc[:, o:] += v[:, : n - o] * p[:, : n - o]
        return acc

    diag = vals4[:, 0]
    nz = diag != 0
    inv_diag = torch.where(nz, 1.0 / torch.where(nz, diag, torch.ones_like(diag)), 0.0)
    Wf = None if Wt is None else Wt.to(dt)

    def precond(r):
        z = inv_diag * r
        if Wf is not None:
            y = r.to(torch.bfloat16).to(dt) @ Wf.T
            c = (Binv @ y[:, :, None])[:, :, 0]
            z = z + c.to(torch.bfloat16).to(dt) @ Wf
        return z

    tol2 = torch.tensor(tol * tol, dtype=dt, device=F.device) * torch.sum(F * F)
    x = torch.zeros((B, n), dtype=dt, device=F.device) if x0 is None else x0.clone()
    r = F - matvec(x)
    z = precond(r)
    p = z
    rz = torch.sum(r * z, -1)
    iters = torch.zeros(B, dtype=torch.int32, device=F.device)
    active = torch.ones(B, dtype=torch.bool, device=F.device)
    done = 0
    while True:
        active = active & (torch.sum(r * r, -1) > tol2)
        if done >= maxiter or not bool(active.any()):
            break
        inner = min(check_every, maxiter - done)
        a = active[:, None]
        for _ in range(inner):
            Ap = matvec(p)
            pAp = torch.sum(p * Ap, -1)
            alpha = torch.where(pAp > 0, rz / torch.where(pAp > 0, pAp, 1.0), 0.0)
            x = torch.where(a, x + alpha[:, None] * p, x)
            r = torch.where(a, r - alpha[:, None] * Ap, r)
            z = precond(r)
            rz_new = torch.sum(r * z, -1)
            beta = torch.where(rz > 0, rz_new / torch.where(rz > 0, rz, 1.0), 0.0)
            p = torch.where(a, z + beta[:, None] * p, p)
            rz = torch.where(active, rz_new, rz)
        iters = iters + active.to(torch.int32) * inner
        done += inner
    return x, iters


def _check(t: torch.Tensor | None, name: str, shape: tuple, dtype, device) -> None:
    if t is None:
        return
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _checked(kernel, vals4, F, x0, *, offsets, maxiter, Wt, Binv, check_every, words_always,
             max_m=None) -> dict:
    """The checks both wrappers make; returns the keyword arguments of the
    plain version. words_always: n % 8 == 0 even without deflation (K3 reads
    every vector in 8-value words)."""
    if vals4.dim() != 3 or vals4.shape[1] != 4:
        raise ValueError(f"vals4 must be (B, 4, n), got {tuple(vals4.shape)}")
    B, _, n = vals4.shape
    dev = vals4.device
    if (Wt is None) != (Binv is None):
        raise ValueError("Wt and Binv come together (deflation) or not at all")
    if len(offsets) != 3 or not all(0 < int(o) < n for o in offsets):
        raise ValueError(f"offsets must be 3 positive flat offsets below n, got {offsets}")
    if maxiter < 0 or check_every < 1:
        raise ValueError("need maxiter >= 0 and check_every >= 1")
    m = 0 if Wt is None else Wt.shape[0]
    if (m or words_always) and n % 8:
        raise ValueError(f"{kernel} reads 8-value words: n must be a multiple of 8, got {n}")
    if max_m is not None and m > max_m:
        raise ValueError(f"{kernel} takes a coarse space of at most {max_m} modes, got {m}")
    _check(vals4, "vals4", (B, 4, n), torch.float32, dev)
    _check(F, "F", (n,), torch.float32, dev)
    _check(x0, "x0", (B, n), torch.float32, dev)
    _check(Wt, "Wt", (m, n), torch.bfloat16, dev)
    _check(Binv, "Binv", (B, m, m), torch.float32, dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{kernel} runs on CUDA or CPU tensors, got {dev}")
    return dict(offsets=tuple(int(o) for o in offsets), maxiter=maxiter, Wt=Wt, Binv=Binv,
                check_every=check_every)


def pcg_stencil(
    vals4: torch.Tensor,
    F: torch.Tensor,
    x0: torch.Tensor | None = None,
    *,
    offsets: tuple,
    tol: float,
    maxiter: int,
    Wt: torch.Tensor | None = None,
    Binv: torch.Tensor | None = None,
    check_every: int = 16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1's wrapper: the CUDA kernel on CUDA tensors, the plain version on
    CPU tensors. Arguments as for ``pcg_stencil_reference``."""
    kw = _checked("K1", vals4, F, x0, offsets=offsets, maxiter=maxiter, Wt=Wt, Binv=Binv,
                  check_every=check_every, words_always=False)
    if vals4.device.type == "cpu":
        return pcg_stencil_reference(vals4, F, x0, tol=tol, **kw)
    return _launch("pcg_stencil", vals4, F, x0, tol=tol, **kw)


def pcg_stencil_tile(
    vals4: torch.Tensor,
    F: torch.Tensor,
    x0: torch.Tensor | None = None,
    *,
    offsets: tuple,
    tol: float,
    maxiter: int,
    Wt: torch.Tensor | None = None,
    Binv: torch.Tensor | None = None,
    check_every: int = 16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The sublanes layout's wrapper: on CUDA tensors K3r, a tile of 8 samples
    per cluster of ``tile_cluster`` blocks; on CPU tensors the plain
    version. Arguments as for ``pcg_stencil_reference``; n must be a
    multiple of 16 (``assemble_fin_dia`` pads it to 128) and m a multiple of
    16, at most 128. A cluster the card cannot hold raises."""
    kw = _checked("K3", vals4, F, x0, offsets=offsets, maxiter=maxiter, Wt=Wt, Binv=Binv,
                  check_every=check_every, words_always=True, max_m=TILE_MAX_M)
    if vals4.device.type == "cpu":
        return pcg_stencil_reference(vals4, F, x0, tol=tol, **kw)
    return _launch_tile_mma(vals4, F, x0, tol=tol, **kw)


def tile_cluster(B: int, capacity: dict[int, int]) -> int:
    """K3r's cluster size for a batch of B. ``capacity[c]`` is how many
    clusters of c blocks the card holds at once (``tile_capacity``). A tile
    of 8 samples on c blocks takes about 1/c of one block's time, and the
    ceil(B / 8) tiles run in ceil(tiles / capacity[c]) waves, so c minimises
    waves / c; a tie goes to the smaller c (fewer blocks to agree). On an
    H100, which holds 132, 66, 30 and 15 clusters of 1, 2, 4 and 8 deflated
    K3r blocks: B = 1,024 -> 1, 256 -> 8, 128 -> 4, 1 -> 8."""
    tiles = -(-B // 8)
    fits = [c for c in TILE_CLUSTERS if capacity.get(c, 0) > 0]
    if not fits:
        raise RuntimeError(f"the card holds no K3r cluster of any size in {TILE_CLUSTERS}")
    return min(fits, key=lambda c: (-(-tiles // capacity[c]) / c, c))


@functools.lru_cache(maxsize=None)
def tile_capacity(m: int, device: int) -> dict[int, int]:
    """How many clusters of each size in ``TILE_CLUSTERS`` card ``device``
    holds at once with K3r's blocks for a coarse space of m (0: undeflated),
    by ``cudaOccupancyMaxActiveClusters``. A failed query raises."""
    from bayesianinferencedl_tpu_torch.ops._build import load_library

    fn = load_library("pcg_stencil_tile_mma").pcg_stencil_tile_mma_max_clusters
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    out = {}
    with torch.cuda.device(device):
        for c in TILE_CLUSTERS:
            held = ctypes.c_int()
            err = fn(m, c, ctypes.byref(held))
            if err != 0:
                raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed with cudaError_t {err} for "
                                   f"K3r clusters of {c} (m = {m})")
            out[c] = held.value
    return out


def tile_ranges(n: int, c: int) -> list[tuple[int, int]]:
    """The node ranges of K3r's c blocks (the kernel's own split): block j
    owns [16 floor(j n16 / c), 16 floor((j + 1) n16 / c)) with n16 = n / 16,
    whole 16-node row tiles that cover [0, n) once."""
    if n % TILE_ROW:
        raise ValueError(f"K3r splits nodes into {TILE_ROW}-node row tiles: n must be a multiple "
                         f"of {TILE_ROW}, got {n}")
    if c not in TILE_CLUSTERS:
        raise ValueError(f"K3r's cluster size is one of {TILE_CLUSTERS}, got {c}")
    n16 = n // TILE_ROW
    return [(TILE_ROW * (j * n16 // c), TILE_ROW * ((j + 1) * n16 // c)) for j in range(c)]


def layout_for(n: int) -> str:
    """The JAX package's layout for an n-node batch of 256 (its
    ``pick_layout``): "lanes" (K1) up to ``LANES_MAX_N``, "sublanes" (K3r) up
    to ``SUBLANES_MAX_N``, "single" (K4r / K4c) above."""
    if n <= LANES_MAX_N:
        return "lanes"
    return "sublanes" if n <= SUBLANES_MAX_N else "single"


# K4r's float64 reduction scratch per block: 4 * 32 doubles
RESIDENT_RED_BYTES = 1024


def grid_strips(X0: int, n_blocks: int) -> list[tuple[int, int]]:
    """K4r's row strips: block j owns the true grid rows [j X0 // n_blocks,
    (j + 1) X0 // n_blocks), ceil(X0 / n_blocks) rows or one fewer."""
    return [(j * X0 // n_blocks, (j + 1) * X0 // n_blocks) for j in range(n_blocks)]


def resident_bytes(X0: int, Y0: int, n_blocks: int) -> int:
    """The shared memory one K4r block needs for its strip of the true
    (X0, Y0) grid over n_blocks blocks (the kernel's ``strip_bytes``): per
    cell of its rows the 7 planes, D^-1, x, r and Ap (11 float32); p with a
    halo row above and below and a zero column on each side; D^-1 of the two
    halo rows; and the reduction scratch."""
    rows = -(-X0 // n_blocks)
    floats = 11 * rows * Y0 + (rows + 2) * (Y0 + 2) + 2 * Y0
    return RESIDENT_RED_BYTES + 4 * floats


def grid_route(X0: int, Y0: int, n_sm: int, smem_per_block: int) -> str:
    """The kernel for one sample's grid solve on a card with ``n_sm`` SMs and
    ``smem_per_block`` bytes of shared memory a block can opt in to:
    "resident" (K4r: one block per SM, min(n_sm, X0) blocks, each holding its
    strip) where a strip fits, else "stream" (K4c). A pure function of its
    arguments; ``pcg_stencil_grid`` passes the card's own numbers."""
    nb = min(n_sm, X0)
    return "resident" if resident_bytes(X0, Y0, nb) <= smem_per_block else "stream"


GRID_CLUSTERS = (1, 2, 4, 8, 16)  # K4c's cluster sizes (16: Hopper's non-portable maximum)
CLUSTER_CHUNK = 16  # rows of p K4c forms in shared memory at a time
CLUSTER_HEAD_BYTES = (2 * 32 + 4) * 8 + 16  # K4c's reduction scratch, slots and sample index


def cluster_bytes(Y0: int) -> int:
    """The shared memory one K4c block asks for on a true grid Y0 cells wide
    (the kernel's ``smem_bytes``): the reduction scratch and a tile of p,
    CLUSTER_CHUNK + 2 rows of the ceil(Y0 / 4) 4-cell groups and 4 zero cells
    on each side."""
    return CLUSTER_HEAD_BYTES + 4 * (CLUSTER_CHUNK + 2) * (4 * -(-Y0 // 4) + 8)


def grid_cluster(B: int, capacity: dict[int, int]) -> int:
    """K4c's cluster size for a batch of B samples, one per cluster.
    ``capacity[c]`` is how many clusters of c blocks the card holds at once
    (``grid_capacity``). A sample on c blocks streams at about c times one
    block's rate, and the B samples run in ceil(B / capacity[c]) waves, so c
    minimises waves / c; a tie goes to the smaller c (fewer blocks to agree).
    On an H100 holding 132, 66, 30, 15 and 8 clusters of 1, 2, 4, 8 and 16
    blocks: B = 1 -> 16, 8 -> 16, 64 -> 2, 256 -> 1, 1,000 -> 16 (with 7 of
    16: 8 -> 8 and 1,000 -> 1)."""
    fits = [c for c in GRID_CLUSTERS if capacity.get(c, 0) > 0]
    if not fits:
        raise RuntimeError(f"the card holds no K4c cluster of any size in {GRID_CLUSTERS}")
    return min(fits, key=lambda c: (-(-B // capacity[c]) / c, c))


@functools.lru_cache(maxsize=None)
def grid_capacity(device: int, Y0: int) -> dict[int, int]:
    """How many clusters of each size in ``GRID_CLUSTERS`` card ``device``
    holds at once with K4c's blocks for a true grid Y0 cells wide, by
    ``cudaOccupancyMaxActiveClusters``. A failed query raises."""
    from bayesianinferencedl_tpu_torch.ops._build import load_library

    fn = load_library("pcg_stencil_grid_cluster").pcg_stencil_grid_cluster_max_clusters
    fn.restype, fn.argtypes = ctypes.c_int, [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    out = {}
    with torch.cuda.device(device):
        for c in GRID_CLUSTERS:
            held = ctypes.c_int()
            err = fn(c, Y0, ctypes.byref(held))
            if err != 0:
                raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed with cudaError_t {err} for "
                                   f"K4c clusters of {c} (Y0 = {Y0})")
            out[c] = held.value
    return out


def pcg_stencil_grid_reference(
    vals2d: torch.Tensor,
    F2d: torch.Tensor,
    x02d: torch.Tensor | None = None,
    *,
    tol: float,
    maxiter: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain batched torch version of K4: each sample's undeflated
    Jacobi-PCG on its 2-D grid, the JAX package's ``_pcg_kernel``.

    vals2d (B, 7, X, Y) planes in ``OFFSETS_2D`` order; F2d (X, Y); x02d
    (B, X, Y) warm starts or None (zeros). Reads outside the grid count as
    zero and the matvec sums the diagonal term first, as the JAX kernel
    does. The loop is ``fem.solve.pcg`` over (B, X * Y) views: z = D^-1 r
    with D^-1 = 0 where the diagonal is 0; alpha and beta are 0 where their
    denominators are not positive; a sample runs while ||r||^2 > tol^2
    ||F||^2, tested before every iteration, and at most ``maxiter``
    iterations, frozen once it stops. Returns (x (B, X, Y), iters (B,)
    int32)."""
    B, _, X, Y = vals2d.shape

    def matvec(p):
        p = p.reshape(B, X, Y)
        pp = torch.nn.functional.pad(p, (1, 1, 1, 1))
        acc = vals2d[:, DIAG_SLOT] * p
        for s, (dx, dy) in enumerate(OFFSETS_2D):
            if s != DIAG_SLOT:
                acc = acc + vals2d[:, s] * pp[:, 1 + dx : 1 + dx + X, 1 + dy : 1 + dy + Y]
        return acc.reshape(B, X * Y)

    x, iters, _ = pcg(matvec, F2d.reshape(1, X * Y).expand(B, -1),
                      vals2d[:, DIAG_SLOT].reshape(B, X * Y), tol=tol, maxiter=maxiter,
                      x0=None if x02d is None else x02d.reshape(B, X * Y))
    return x.reshape(B, X, Y), iters


def pcg_stencil_grid(
    vals2d: torch.Tensor,
    F2d: torch.Tensor,
    x02d: torch.Tensor | None = None,
    *,
    tol: float,
    maxiter: int,
    shape0: tuple[int, int] | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The single layout's wrapper: on CUDA tensors (float32) K4r or K4c, as
    ``grid_route`` says for this grid and card; on CPU tensors the plain
    version (float32, or float64 for oracle tests). Arguments as for
    ``pcg_stencil_grid_reference``; Y must be a multiple of 4
    (``StencilOperator.grid_shape`` pads it to 128). shape0: the true grid
    (X0, Y0) in the top-left corner of (X, Y) (``op.grid_shape0``), None for
    all of it; cells outside it must hold zero planes, zero F and zero
    x02d (the grid views give them so), and the solution is zero there."""
    if vals2d.dim() != 4 or vals2d.shape[1] != 7:
        raise ValueError(f"vals2d must be (B, 7, X, Y), got {tuple(vals2d.shape)}")
    B, _, X, Y = vals2d.shape
    dev = vals2d.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"K4 runs on CUDA or CPU tensors, got {dev}")
    if maxiter < 0:
        raise ValueError("need maxiter >= 0")
    X0, Y0 = (X, Y) if shape0 is None else (int(shape0[0]), int(shape0[1]))
    if not (0 < X0 <= X and 0 < Y0 <= Y):
        raise ValueError(f"shape0 {shape0} must lie inside the grid {(X, Y)}")
    if Y % 4:
        raise ValueError(f"K4 reads 4-cell words along a grid row: Y must be a multiple of 4, got {Y}")
    dt = vals2d.dtype
    if dt != torch.float32 and not (dt == torch.float64 and dev.type == "cpu"):
        raise TypeError(f"K4 takes float32 (float64 only on the CPU), got {dt}")
    _check(vals2d, "vals2d", (B, 7, X, Y), dt, dev)
    _check(F2d, "F2d", (X, Y), dt, dev)
    _check(x02d, "x02d", (B, X, Y), dt, dev)
    if dev.type == "cpu":
        return pcg_stencil_grid_reference(vals2d, F2d, x02d, tol=tol, maxiter=maxiter)
    n_sm, smem = device_limits(dev)
    if grid_route(X0, Y0, n_sm, smem) == "resident":
        return _launch_grid_resident(vals2d, F2d, x02d, (X0, Y0), min(n_sm, X0), tol=tol,
                                     maxiter=maxiter)
    return _launch_grid_cluster(vals2d, F2d, x02d, (X0, Y0), tol=tol, maxiter=maxiter)


_limits: dict[int, tuple[int, int]] = {}


def device_limits(dev: torch.device) -> tuple[int, int]:
    """(SM count, shared memory a block can opt in to) of a CUDA device, read
    from the card by K4r's library."""
    idx = torch.device(dev).index
    idx = torch.cuda.current_device() if idx is None else idx
    if idx not in _limits:
        from bayesianinferencedl_tpu_torch.ops._build import load_library

        fn = load_library("pcg_stencil_grid_resident").pcg_stencil_grid_resident_device
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        n_sm, smem = ctypes.c_int(), ctypes.c_int()
        err = fn(idx, ctypes.byref(n_sm), ctypes.byref(smem))
        if err != 0:
            raise RuntimeError(f"pcg_stencil_grid_resident_device failed with cudaError_t {err}")
        _limits[idx] = (n_sm.value, smem.value)
    return _limits[idx]


def _launch_grid_resident(vals2d, F2d, x02d, shape0, n_blocks, *, tol, maxiter):
    """Launch ``csrc/pcg_stencil_grid_resident.cu`` (a cooperative grid of
    n_blocks blocks) and count the launch. A launch the card refuses raises."""
    global grid_resident_launches
    from bayesianinferencedl_tpu_torch.ops._build import load_library

    fn = load_library("pcg_stencil_grid_resident").pcg_stencil_grid_resident_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    B, _, X, Y = vals2d.shape
    X0, Y0 = shape0
    dev = vals2d.device
    with torch.cuda.device(dev):
        x = torch.empty((B, X, Y), dtype=torch.float32, device=dev)
        iters = torch.empty((B,), dtype=torch.int32, device=dev)
        counter = torch.zeros((1,), dtype=torch.int64, device=dev)  # the grid barrier's
        slots = torch.empty((4, n_blocks), dtype=torch.float64, device=dev)  # per-block partials
        pub = torch.empty((n_blocks, 2, Y0), dtype=torch.float32, device=dev)  # r's edge rows
        err = fn(
            vals2d.data_ptr(), F2d.data_ptr(), None if x02d is None else x02d.data_ptr(),
            x.data_ptr(), iters.data_ptr(), counter.data_ptr(), slots.data_ptr(), pub.data_ptr(),
            B, X, Y, X0, Y0, n_blocks, float(tol * tol), int(maxiter),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"pcg_stencil_grid_resident_launch failed with cudaError_t {err}")
    grid_resident_launches += 1
    return x, iters


def _launch_grid_cluster(vals2d, F2d, x02d, shape0, *, tol, maxiter, cluster=None):
    """Launch ``csrc/pcg_stencil_grid_cluster.cu`` (K4c) as clusters of
    ``grid_cluster`` blocks (or of ``cluster``, for a sweep over the sizes),
    one sample per cluster, and count the launch. A cluster size outside
    ``GRID_CLUSTERS`` raises ValueError before any library loads; a launch
    the card refuses, or a cluster it cannot hold, raises RuntimeError."""
    global grid_cluster_launches
    if cluster is not None and cluster not in GRID_CLUSTERS:
        raise ValueError(f"K4c's cluster size is one of {GRID_CLUSTERS}, got {cluster}")
    for t, what in ((vals2d, "vals2d"), (F2d, "F2d"), (x02d, "x02d")):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{what} must be 16-byte aligned")
    from bayesianinferencedl_tpu_torch.ops._build import load_library

    fn = load_library("pcg_stencil_grid_cluster").pcg_stencil_grid_cluster_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    B, _, X, Y = vals2d.shape
    X0, Y0 = shape0
    dev = vals2d.device
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    c = grid_cluster(B, grid_capacity(idx, Y0)) if cluster is None else cluster
    with torch.cuda.device(dev):
        x = torch.empty((B, X, Y), dtype=torch.float32, device=dev)
        iters = torch.empty((B,), dtype=torch.int32, device=dev)
        scratch = torch.empty((B, 4, X, Y), dtype=torch.float32, device=dev)  # r, p0, p1, Ap
        nxt = torch.zeros((1,), dtype=torch.int32, device=dev)  # the clusters' next sample
        err = fn(
            vals2d.data_ptr(), F2d.data_ptr(), None if x02d is None else x02d.data_ptr(),
            x.data_ptr(), iters.data_ptr(), scratch.data_ptr(), nxt.data_ptr(),
            B, X, Y, X0, Y0, c, float(tol * tol), int(maxiter),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"pcg_stencil_grid_cluster_launch failed with cudaError_t {err} "
                           f"(B = {B}, cluster of {c} blocks)")
    grid_cluster_launches += 1
    return x, iters


def _launch_grid(vals2d, F2d, x02d, *, tol, maxiter):
    """Launch ``csrc/pcg_stencil_grid.cu`` (K4) and count the launch. K4 is
    off the main path (``pcg_stencil_grid`` takes K4r or K4c);
    ``chip_smoke.py`` calls it here to hold it beside them."""
    global grid_launches
    from bayesianinferencedl_tpu_torch.ops._build import load_library

    fn = load_library("pcg_stencil_grid").pcg_stencil_grid_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    B, _, X, Y = vals2d.shape
    for t, what in ((vals2d, "vals2d"), (F2d, "F2d"), (x02d, "x02d")):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{what} must be 16-byte aligned")
    with torch.cuda.device(vals2d.device):
        x = torch.empty((B, X, Y), dtype=torch.float32, device=vals2d.device)
        iters = torch.empty((B,), dtype=torch.int32, device=vals2d.device)
        scratch = torch.empty((B, 3, X * Y), dtype=torch.float32, device=vals2d.device)
        err = fn(
            vals2d.data_ptr(), F2d.data_ptr(), None if x02d is None else x02d.data_ptr(),
            x.data_ptr(), iters.data_ptr(), scratch.data_ptr(), B, X, Y,
            float(tol * tol), int(maxiter), torch.cuda.current_stream(vals2d.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"pcg_stencil_grid_launch failed with cudaError_t {err}")
    grid_launches += 1
    return x, iters


def _launch_tile_mma(vals4, F, x0, *, offsets, tol, maxiter, Wt, Binv, check_every, cluster=None):
    """Launch ``csrc/pcg_stencil_tile_mma.cu`` (K3r) as clusters of
    ``tile_cluster`` blocks (or of ``cluster``, for a sweep over the sizes)
    and count the launch. A launch the card refuses, or a cluster it cannot
    hold, raises."""
    global tile_mma_launches
    from bayesianinferencedl_tpu_torch.ops._build import load_library

    B, _, n = vals4.shape
    m = 0 if Wt is None else Wt.shape[0]
    if n % TILE_ROW:
        raise ValueError(f"K3r splits nodes into {TILE_ROW}-node row tiles: n must be a multiple "
                         f"of {TILE_ROW}, got {n}")
    if m % TILE_ROW:
        raise ValueError(f"K3r takes the coarse space in 16-mode tiles: m must be a multiple of "
                         f"{TILE_ROW}, got {m}")
    for t, what in ((vals4, "vals4"), (x0, "x0"), (Wt, "Wt")):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{what} must be 16-byte aligned")
    fn = load_library("pcg_stencil_tile_mma").pcg_stencil_tile_mma_launch
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 8
        + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    )
    dev = vals4.device
    c = tile_cluster(B, tile_capacity(m, dev.index)) if cluster is None else cluster
    with torch.cuda.device(dev):
        x = torch.empty((B, n), dtype=torch.float32, device=dev)
        iters = torch.empty((B,), dtype=torch.int32, device=dev)
        scratch = torch.empty((B, 5, n), dtype=torch.float32, device=dev)  # r, z, Ap, p, p
        ptr = lambda t: None if t is None else t.data_ptr()
        err = fn(
            ptr(vals4), ptr(F), ptr(x0), ptr(Wt), ptr(Binv), ptr(x), ptr(iters), ptr(scratch),
            B, n, m, *offsets, float(tol * tol), int(maxiter), int(check_every), c,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"pcg_stencil_tile_mma_launch failed with cudaError_t {err} "
                           f"(B = {B}, cluster of {c} blocks)")
    tile_mma_launches += 1
    return x, iters


def _launch(name, vals4, F, x0, *, offsets, tol, maxiter, Wt, Binv, check_every):
    """Launch ``csrc/<name>.cu`` (K1 and K3 share one C signature) and count
    the launch. K3 is off the main path (``pcg_stencil_tile`` takes K3r);
    ``chip_smoke.py`` calls it here to hold it beside K3r."""
    global launches, tile_launches
    from bayesianinferencedl_tpu_torch.ops._build import load_library

    fn = getattr(load_library(name), f"{name}_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = (
        [ctypes.c_void_p] * 8
        + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    )
    B, _, n = vals4.shape
    m = 0 if Wt is None else Wt.shape[0]
    for t, what in ((vals4, "vals4"), (x0, "x0"), (Wt, "Wt")):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{what} must be 16-byte aligned")
    with torch.cuda.device(vals4.device):
        x = torch.empty((B, n), dtype=torch.float32, device=vals4.device)
        iters = torch.empty((B,), dtype=torch.int32, device=vals4.device)
        scratch = torch.empty((B, 4, n), dtype=torch.float32, device=vals4.device)
        ptr = lambda t: None if t is None else t.data_ptr()
        err = fn(
            ptr(vals4), ptr(F), ptr(x0), ptr(Wt), ptr(Binv), ptr(x), ptr(iters), ptr(scratch),
            B, n, m, *offsets,
            float(tol * tol), int(maxiter), int(check_every),
            torch.cuda.current_stream(vals4.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{name}_launch failed with cudaError_t {err}")
    if name == "pcg_stencil":
        launches += 1
    else:
        tile_launches += 1
    return x, iters


def solve_fom_stencil(
    op,
    ks: torch.Tensor,
    *,
    tol: float,
    maxiter: int,
    x0: torch.Tensor | None = None,
    deflation=None,
    coarse_inv: torch.Tensor | None = None,
    check_every: int = 16,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched FOM solve A(k_b) u_b = F through K1, K3r or the single
    layout's K4r / K4c, by the mesh size (``layout_for``, then
    ``grid_route``).

    op: fem.dia.StencilOperator; ks: (B, 5). Returns (u (B, n), iters (B,)).
    x0: optional (B, n) warm starts.
    deflation: optional ops.deflation.DeflationBasis for K1 and K3r; its
    per-sample coarse inverses are a batched Cholesky before the launch
    unless ``coarse_inv`` (B, m, m) is given. A sample whose coarse inverse
    is not finite (a failed factorisation) gets a NaN solution: the guards on
    alpha and beta would otherwise leave it at its start, finite and wrong.
    The "single" layout, as in the JAX package, neither applies nor computes
    deflation and checks convergence every iteration. Not differentiable:
    snapshot and dataset sweeps, the synthetic-truth solve and the fom
    likelihood (``fem/solve.py`` is the differentiable solve)."""
    layout = layout_for(op.n)
    ks = torch.as_tensor(ks, dtype=op.dtype, device=op.device)
    if layout == "single":
        x02d = None if x0 is None else op.to_grid(x0)
        x2d, iters = pcg_stencil_grid(op.vals_grid(ks), op.to_grid(op.F_root), x02d, tol=tol,
                                      maxiter=maxiter, shape0=op.grid_shape0)
        return op.from_grid(x2d), iters
    vals4 = upper_planes(op.vals(ks))
    Wt = Binv = None
    if deflation is not None:
        Wt = deflation.Wt_bf16
        Binv = coarse_inv if coarse_inv is not None else deflation.coarse_inverses(ks, op.biot)
        Binv = Binv.to(op.dtype).contiguous()
    if x0 is not None:
        x0 = x0.contiguous()
    kernel = pcg_stencil if layout == "lanes" else pcg_stencil_tile
    x, iters = kernel(
        vals4, op.F_root, x0, offsets=op.offsets[DIAG_SLOT + 1:], tol=tol,
        maxiter=maxiter, Wt=Wt, Binv=Binv, check_every=check_every,
    )
    if Binv is not None:
        x = torch.where(torch.isfinite(Binv).all(dim=(1, 2))[:, None], x, torch.nan)
    return x, iters
