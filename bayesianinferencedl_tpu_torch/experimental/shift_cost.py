"""The shift-cost probe (kernels K5r and K5): what the stencil's neighbour
reads cost in a CG iteration on the card.

The counterpart of the JAX package's ``scripts/diag_roll_cost.py``: a
fixed-iteration CG loop (no convergence test) over tiles of samples, run
twice, once with the real stencil matvec (7 planes, 6 of them read through
the generic flat offsets of ``fem/dia.py``) and once with the shifts removed
(the same operations and bytes, every plane multiplying p itself). The gap
between the two is the shift cost. The no-shift loop is not a CG of an SPD
operator: its operator is the diagonal of A's row sums, which vanish up to
rounding off the convective boundary, so from its second iteration on p.Ap
is a sum of rounding errors and the values grow without bound. Two
summation orders agree on it only over its first iteration.

    python -m bayesianinferencedl_tpu_torch.experimental.shift_cost [res] [tile] [device]

(defaults 8, 8, cuda) builds the fin at ``res``, 64 log-uniform samples,
and prints one JSON line per variant with the reference's keys: ``res``,
``tile``, ``use_rolls``, ``per_tile_iter_us`` (the time of the timed run
over (64 / tile) tiles and 256 iterations, as the reference divides it; the
card runs all samples at once, where the TPU ran the tiles one after
another) and ``total_s``. On the card the run is timed with CUDA
events after an untimed one on other samples.

On CUDA tensors ``shift_cost`` launches the kernel ``shift_route`` names for
the mesh and the card: K5r (``csrc/shift_cost_cluster.cu``, each sample
resident in the shared memory and registers of a thread-block cluster, on
the plan ``k5r_plan`` makes) where one sample's state fits a cluster of at
most 16 blocks and the stencil's halo a block's chunk (res <= 12 on an H100),
else K5 (``csrc/shift_cost.cu``, one block per tile of samples). ``tile``
keeps the reference's meaning (its division of the time, and K5's blocks);
K5r's launch does not depend on it. A failed build or launch raises; on CPU
tensors the wrapper runs ``shift_cost_reference``, the plain torch version.
"""

from __future__ import annotations

import ctypes
import functools
import json
import sys
import time

import torch

DIAG_SLOT = 3
TILES = (8, 16, 32)  # the tile sizes csrc/shift_cost.cu is built for: the reference's sublane tiles
B_PROBE = 64
N_ITERS = 256

R_CLUSTERS = (1, 2, 4, 8, 16)  # K5r's cluster sizes (16: Hopper's non-portable maximum)
R_THREADS = 1024  # the most threads a K5r block has
R_MAX_NODES = 4 * 896  # the most nodes a K5r block holds: 4 a thread on 896 threads (72 registers each)
R_MAX_SMEM = 232_448  # the most shared memory a block may opt into on Hopper (227 KB)

launches = 0  # K5 launches in this process (the CUDA path only)
r_launches = 0  # K5r launches


def reference_matvec(planes: torch.Tensor, p: torch.Tensor, offsets: tuple,
                     use_rolls: bool) -> torch.Tensor:
    """The plain version's matvec: planes (B, 7, n), p (B, n). The diagonal
    term first, then the others in ascending offset order, each read
    q[i] = p[i + o] zero outside [0, n) (or q = p without the shifts)."""

    def shift(p, o):
        if o > 0:
            return torch.nn.functional.pad(p[:, o:], (0, o))
        return torch.nn.functional.pad(p[:, :o], (-o, 0))

    acc = planes[:, DIAG_SLOT] * p
    for s, o in enumerate(offsets):
        if s != DIAG_SLOT:
            acc = acc + planes[:, s] * (shift(p, o) if use_rolls else p)
    return acc


def shift_cost_reference(vals: torch.Tensor, F: torch.Tensor, *, offsets: tuple, n_iters: int,
                         use_rolls: bool) -> torch.Tensor:
    """Plain torch version of K5. vals (B, n, 7) diagonal values, F (n,),
    offsets the 7 flat offsets in ascending order (0 at slot 3). A shifted
    read q[i] = p[i + o] counts as zero outside [0, n) (the reference's roll
    wraps onto zero planes). Returns x (B, n) after exactly ``n_iters``
    iterations from x0 = 0."""
    planes = vals.transpose(-1, -2)  # (B, 7, n)
    diag = planes[:, DIAG_SLOT]
    nz = diag != 0
    inv_diag = torch.where(nz, 1.0 / torch.where(nz, diag, torch.ones_like(diag)), 0.0)

    def matvec(p):
        return reference_matvec(planes, p, offsets, use_rolls)

    def psum(a):
        return torch.sum(a, -1, keepdim=True)

    x = torch.zeros_like(diag)
    r = F - matvec(x)
    z = inv_diag * r
    p = z
    rz = psum(r * z)
    for _ in range(n_iters):
        Ap = matvec(p)
        pAp = psum(p * Ap)
        alpha = torch.where(pAp > 0, rz / torch.where(pAp > 0, pAp, 1.0), 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = inv_diag * r
        rz_new = psum(r * z)
        beta = torch.where(rz > 0, rz_new / torch.where(rz > 0, rz, 1.0), 0.0)
        p = z + beta * p
        rz = rz_new
    return x


def shift_cost(vals: torch.Tensor, F: torch.Tensor, *, offsets: tuple, n_iters: int, use_rolls: bool,
               tile: int) -> torch.Tensor:
    """The probe's wrapper: on CUDA tensors (float32) K5r or K5, as
    ``shift_route`` says for this mesh and card (K5r on ``k5r_plan``'s
    launch, K5 one block per tile of ``tile`` samples); the plain version on
    CPU tensors. Arguments as for ``shift_cost_reference``; B must be a
    multiple of tile, and tile one of ``TILES``."""
    if vals.dim() != 3 or vals.shape[2] != 7:
        raise ValueError(f"vals must be (B, n, 7), got {tuple(vals.shape)}")
    B, n, _ = vals.shape
    dev = vals.device
    offsets = tuple(int(o) for o in offsets)
    if len(offsets) != 7 or offsets[DIAG_SLOT] != 0 or list(offsets) != sorted(offsets):
        raise ValueError(f"offsets must be the 7 ascending flat offsets with 0 at slot 3, got {offsets}")
    if tile not in TILES or B % tile:
        raise ValueError(f"tile must be one of {TILES} and divide B = {B}, got {tile}")
    if n_iters < 0:
        raise ValueError("need n_iters >= 0")
    if vals.dtype != torch.float32 and not (vals.dtype == torch.float64 and dev.type == "cpu"):
        raise TypeError(f"K5 takes float32 (float64 only on the CPU), got {vals.dtype}")
    if F.dtype != vals.dtype or F.device != dev or tuple(F.shape) != (n,):
        raise ValueError(f"F must be ({n},) {vals.dtype} on {dev}")
    if dev.type == "cpu":
        return shift_cost_reference(vals, F, offsets=offsets, n_iters=n_iters, use_rolls=use_rolls)
    if dev.type != "cuda":
        raise ValueError(f"K5 runs on CUDA or CPU tensors, got {dev}")
    vals, F = vals.contiguous(), F.contiguous()
    plan = k5r_plan(n, offsets, B, *shift_limits(dev, n, halo(offsets)))
    if plan is None:
        return _launch(vals, F, offsets=offsets, n_iters=n_iters, use_rolls=use_rolls, tile=tile)
    return _launch_r(vals, F, offsets=offsets, n_iters=n_iters, use_rolls=use_rolls,
                     cluster=plan["cluster"], clusters=plan["clusters"])


def halo(offsets: tuple) -> int:
    """The stencil's reach, max |o|: the nodes a K5r block reads on either
    side of its chunk."""
    return max(abs(int(o)) for o in offsets)


def k5r_bytes(n: int, H: int, cluster: int) -> int:
    """The shared memory one K5r block asks for (the kernel's
    ``smem_bytes``): two mbarriers, the block's reduction scratch (a float64
    a warp) and the slots (a float64 for each of 2 sums and block of the
    cluster), then the chunk's L = ceil(n / cluster) nodes of 7 planes, p on
    the chunk and its 2 H halo nodes, and the neighbours' z on the halo
    (1/diag, r, p, x and Ap stay in registers)."""
    L = -(-n // cluster)
    return 16 + 8 * (R_THREADS // 32) + 16 * cluster + 4 * (8 * L + 4 * H)


def k5r_threads(L: int) -> int:
    """A K5r block's threads for a chunk of L nodes (the kernel's
    ``block_threads``): 1, 2 or 4 nodes a thread, the fewest that 1,024
    threads cover (896 with 4), on the fewest warps that hold them (res8 on
    8 blocks: 3,120 nodes, 4 a thread on 800 threads)."""
    npt = 1 if L <= R_THREADS else 2 if L <= 2 * R_THREADS else 4
    return 32 * -(-L // (32 * npt))


def _chunks_hold_halo(n: int, H: int, cluster: int) -> bool:
    """K5r's split of n nodes over ``cluster`` blocks of L = ceil(n / c)
    holds the halo and fits the threads: every chunk, the last too, has at
    least H nodes (so the halo lies in the next ranks), L <= 3,584 (4 nodes
    a thread on 896) and 2 H <= the block's threads (a thread a halo node)."""
    L = -(-n // cluster)
    return (n - (cluster - 1) * L >= max(H, 1) and L <= R_MAX_NODES
            and 2 * H <= k5r_threads(L))


def k5r_configs(n: int, offsets: tuple, smem_per_block: int, capacity: dict[int, int]) -> list[int]:
    """Every cluster size c K5r can run n nodes on, on a card whose blocks
    can opt in to ``smem_per_block`` bytes and which holds ``capacity[c]``
    clusters of c K5r blocks: the card holds such a cluster, every chunk
    holds the halo (``_chunks_hold_halo``) and a sample's state fits a
    block's shared memory."""
    H = halo(offsets)
    return [c for c in R_CLUSTERS
            if capacity.get(c, 0) > 0 and _chunks_hold_halo(n, H, c) and k5r_bytes(n, H, c) <= smem_per_block]


def shift_route(n: int, offsets: tuple, smem_per_block: int, capacity: dict[int, int]) -> str:
    """The kernel for the probe on such a card: "K5r" where one sample's
    state fits a cluster of at most 16 blocks (``k5r_configs`` is not
    empty), else "K5". On an H100: res <= 12 -> K5r, res16 (n = 99,072:
    6,192 nodes a block on 16) -> K5."""
    return "K5r" if k5r_configs(n, offsets, smem_per_block, capacity) else "K5"


def k5r_plan(n: int, offsets: tuple, B: int, smem_per_block: int,
             capacity: dict[int, int]) -> dict | None:
    """K5r's launch for B samples of n nodes, or None where ``shift_route``
    names K5. Over ``k5r_configs``: the B samples run one a cluster,
    min(capacity[c], B) clusters at a time, in waves = ceil(B /
    capacity[c]) rounds. A block's time in an iteration grows with the
    nodes it holds (L) and every round pays two cluster reductions an
    iteration, so the plan minimises waves * L, then waves, then c (fewer
    blocks to agree). Returns {"cluster", "nodes" (L), "threads" (a
    block's), "halo" (H), "smem" (bytes a block), "clusters", "waves"}. On
    an H100 (132, 66, 30, 15 and 7 clusters of 1-16) at B = 64: res8 -> 8
    blocks of 3,120 nodes, 5 waves; res12 -> 16 of 3,488, 10 waves."""
    if shift_route(n, offsets, smem_per_block, capacity) != "K5r":
        return None
    H = halo(offsets)
    best = None
    for c in k5r_configs(n, offsets, smem_per_block, capacity):
        L = -(-n // c)
        waves = -(-B // capacity[c])
        key = (waves * L, waves, c)
        if best is None or key < best[0]:
            best = (key, dict(cluster=c, nodes=L, threads=k5r_threads(L), halo=H, smem=k5r_bytes(n, H, c),
                              clusters=min(capacity[c], B), waves=waves))
    return best[1]


@functools.lru_cache(maxsize=None)
def _limits(idx: int, n: int, H: int) -> tuple[int, dict[int, int]]:
    from bayesianinferencedl_tpu_torch.ops._build import load_library

    lib = load_library("shift_cost_cluster")
    lib.shift_cost_cluster_smem_optin.restype = ctypes.c_int
    lib.shift_cost_cluster_smem_optin.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn = lib.shift_cost_cluster_max_clusters
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
    smem = ctypes.c_int()
    err = lib.shift_cost_cluster_smem_optin(idx, ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(f"cudaDeviceGetAttribute failed with cudaError_t {err} on device {idx}")
    out = {}
    with torch.cuda.device(idx):
        for c in R_CLUSTERS:
            held = ctypes.c_int()
            err = fn(n, c, H, ctypes.byref(held))
            if err != 0:
                raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed with cudaError_t {err} for "
                                   f"K5r clusters of {c} (n = {n}, halo {H})")
            out[c] = held.value
    return smem.value, out


def shift_limits(dev: torch.device, n: int, H: int) -> tuple[int, dict[int, int]]:
    """(shared memory a block of CUDA device ``dev`` can opt in to, how many
    clusters of each size in ``R_CLUSTERS`` it holds at once with K5r's
    blocks for one sample of n nodes and halo H), read by K5r's library, the
    clusters by ``cudaOccupancyMaxActiveClusters`` (0 where the block does
    not fit). A failed query raises."""
    idx = torch.device(dev).index
    return _limits(torch.cuda.current_device() if idx is None else idx, int(n), int(H))


FLOORS = {None: 0, "mbarrier": 1, "cluster_barrier": 2}  # K5r's floor runs: how the reductions meet


def _launch_r(vals, F, *, offsets, n_iters, use_rolls, cluster, clusters, floor=None):
    """Launch ``csrc/shift_cost_cluster.cu`` (K5r) on ``clusters`` clusters
    of ``cluster`` blocks (``k5r_plan``'s), a sample a cluster at a time,
    and count the launch. ``floor`` (a key of ``FLOORS``): the same launch
    with the per-node work of the iterations removed, its reductions met as
    K5r meets them ("mbarrier") or each closed by a cluster barrier
    ("cluster_barrier"); its output is not the probe's. A plan outside the
    kernel's contract (cluster size, clusters outside [1, B], a chunk
    narrower than the halo or over ``R_MAX_NODES``, more shared memory than
    a block can have) raises ValueError before any library loads; a launch
    the card refuses raises RuntimeError."""
    global r_launches
    B, n, _ = vals.shape
    H = halo(offsets)
    if cluster not in R_CLUSTERS or not 1 <= clusters <= B or floor not in FLOORS:
        raise ValueError(f"K5r runs on 1 to B = {B} clusters of {R_CLUSTERS} blocks (floor one of "
                         f"{tuple(FLOORS)}), got {clusters} of {cluster} and {floor!r}")
    if not _chunks_hold_halo(n, H, cluster):
        raise ValueError(f"n = {n} nodes on {cluster} blocks: a chunk is narrower than the halo ({H} nodes), "
                         f"or the halo than a block's threads, or the chunk over {R_MAX_NODES} nodes")
    if k5r_bytes(n, H, cluster) > R_MAX_SMEM:
        raise ValueError(f"K5r needs {k5r_bytes(n, H, cluster)} B of shared memory a block "
                         f"(n = {n} on {cluster} blocks), more than {R_MAX_SMEM}")
    from bayesianinferencedl_tpu_torch.ops._build import load_library

    fn = load_library("shift_cost_cluster").shift_cost_cluster_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    with torch.cuda.device(vals.device):
        x = torch.empty((B, n), dtype=torch.float32, device=vals.device)
        err = fn(vals.data_ptr(), F.data_ptr(), x.data_ptr(), B, n, (ctypes.c_int * 7)(*offsets), cluster,
                 clusters, n_iters, int(bool(use_rolls)), FLOORS[floor],
                 torch.cuda.current_stream(vals.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"shift_cost_cluster_launch failed with cudaError_t {err} "
                           f"({clusters} clusters of {cluster})")
    r_launches += 1
    return x


def _launch(vals, F, *, offsets, n_iters, use_rolls, tile):
    """Launch ``csrc/shift_cost.cu`` (K5) and count the launch."""
    global launches
    from bayesianinferencedl_tpu_torch.ops._build import load_library

    fn = load_library("shift_cost").shift_cost_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.POINTER(ctypes.c_int)] + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]
    B, n, _ = vals.shape
    with torch.cuda.device(vals.device):
        planes = vals.transpose(1, 2).contiguous()  # (B, 7, n)
        x = torch.empty((B, n), dtype=torch.float32, device=vals.device)
        scratch = torch.empty((B, 3, n), dtype=torch.float32, device=vals.device)
        err = fn(planes.data_ptr(), F.data_ptr(), x.data_ptr(), scratch.data_ptr(), B, n,
                 (ctypes.c_int * 7)(*offsets), tile, n_iters, int(bool(use_rolls)),
                 torch.cuda.current_stream(vals.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"shift_cost_launch failed with cudaError_t {err}")
    launches += 1
    return x


def main(argv=None) -> None:
    from bayesianinferencedl_tpu_torch.models.five_param import FiveParamFin
    from bayesianinferencedl_tpu_torch.rom.snapshots import sample_log_uniform

    argv = sys.argv[1:] if argv is None else argv
    res = int(argv[0]) if len(argv) > 0 else 8
    tile = int(argv[1]) if len(argv) > 1 else 8
    device = argv[2] if len(argv) > 2 else "cuda"
    fin = FiveParamFin.create(resolution=res, biot=0.1, dtype=torch.float32, device=device,
                              cg_tol=1e-7, cg_maxiter=2000)
    op = fin.op
    dev = op.device
    vals = [op.vals(sample_log_uniform(torch.Generator(device=dev).manual_seed(s), B_PROBE))
            for s in (1, 2)]
    for use_rolls in (True, False):
        def f(v):
            return shift_cost(v, op.F_root, offsets=op.offsets, n_iters=N_ITERS, use_rolls=use_rolls,
                              tile=tile)

        float(f(vals[0]).sum())  # untimed: builds the kernel
        if dev.type == "cuda":
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            f(vals[1])
            e1.record()
            e1.synchronize()
            dt = e0.elapsed_time(e1) / 1e3
        else:
            t0 = time.perf_counter()
            f(vals[1])
            dt = time.perf_counter() - t0
        print(json.dumps({"res": res, "tile": tile, "use_rolls": use_rolls,
                          "per_tile_iter_us": dt / (B_PROBE // tile) / N_ITERS * 1e6, "total_s": dt}),
              flush=True)


if __name__ == "__main__":
    main()
