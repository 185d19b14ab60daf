"""The shift-cost probe (kernel K5): what the stencil's neighbour reads cost
in a CG iteration on the card.

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
card runs the tiles at once, one block each, where the TPU ran them one
after another) and ``total_s``. On the card the run is timed with CUDA
events after an untimed one on other samples.

On CUDA tensors ``shift_cost`` launches ``csrc/shift_cost.cu``; on CPU
tensors it runs ``shift_cost_reference``, the plain torch version.
"""

from __future__ import annotations

import ctypes
import json
import sys
import time

import torch

DIAG_SLOT = 3
TILES = (8, 16, 32)  # the tile sizes csrc/shift_cost.cu is built for: the reference's sublane tiles
B_PROBE = 64
N_ITERS = 256

launches = 0  # K5 launches in this process (the CUDA path only)


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

    def shift(p, o):
        if o > 0:
            return torch.nn.functional.pad(p[:, o:], (0, o))
        return torch.nn.functional.pad(p[:, :o], (-o, 0))

    def matvec(p):
        acc = planes[:, DIAG_SLOT] * p
        for s, o in enumerate(offsets):
            if s != DIAG_SLOT:
                acc = acc + planes[:, s] * (shift(p, o) if use_rolls else p)
        return acc

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
    """K5's wrapper: the CUDA kernel (one block per tile of ``tile``
    samples, float32) on CUDA tensors, the plain version on CPU tensors.
    Arguments as for ``shift_cost_reference``; B must be a multiple of
    tile, and tile one of ``TILES``."""
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
    return _launch(vals, F.contiguous(), offsets=offsets, n_iters=n_iters, use_rolls=use_rolls,
                   tile=tile)


def _launch(vals, F, *, offsets, n_iters, use_rolls, tile):
    """Launch ``csrc/shift_cost.cu`` and count the launch."""
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
