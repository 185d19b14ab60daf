"""Device meshes, the rank launcher and the collectives of the sharded paths.

The JAX package is single-controller: one process drives a 1-D
``jax.sharding.Mesh`` through ``shard_map``. The port is SPMD instead: one
process per card, rank r on ``cuda:r``, NCCL between cards (gloo between CPU
ranks). The port's chain step is host-bound, so one Python thread driving
several cards would serialise their steps; one process per card gives each
card its own host thread.

A mesh is a 1-D ``torch.distributed.device_mesh.DeviceMesh`` whose one
dimension is named ``"devices"``, PyTorch's counterpart of the reference's
1-D mesh. Every rank of a sharded call runs the same code on its own shard
and ends with the whole result.

- ``device_mesh`` returns the mesh of the world this process belongs to,
  joining one that ``torchrun`` set up, or starting a world of 1 in-process.
- ``launch`` starts n ranks with ``torch.multiprocessing.spawn`` (never
  fork) that meet through a ``FileStore`` in a temporary directory, so
  several launches on one machine never race for a port.
- The collectives are written once here: the rank-major ``gather_rows``
  along a chain axis, ``sum_all`` and ``mean_all``, and the halo exchange
  ``halo_rows``. The backend follows the card (NCCL for a ``cuda`` mesh,
  gloo for a ``cpu`` one), and nothing switches backend or device when an
  init or a collective fails.
"""

from __future__ import annotations

import atexit
import hashlib
import os
import shutil
import tempfile
from typing import Callable, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from bayesianinferencedl_tpu_torch.utils.device import resolve_device

AXIS = "devices"
_THREAD_VARS = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def _backend(dev: torch.device) -> str:
    return "nccl" if dev.type == "cuda" else "gloo"


def init_world(rank: int, world_size: int, store_path: str, device="cuda") -> None:
    """Join rank ``rank`` of a ``world_size`` world that meets through the
    FileStore at ``store_path``: NCCL on ``cuda:rank`` for a card, gloo for
    the CPU."""
    dev = resolve_device(device)
    kw = {}
    if dev.type == "cuda":
        if rank >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank} needs cuda:{rank}, but the machine shows "
                               f"{torch.cuda.device_count()} card(s)")
        torch.cuda.set_device(rank)
        kw["device_id"] = torch.device("cuda", rank)
    dist.init_process_group(_backend(dev), store=dist.FileStore(store_path, world_size), rank=rank,
                            world_size=world_size, **kw)


def device_mesh(n_devices: Optional[int] = None, axis_name: str = AXIS, device="cuda") -> DeviceMesh:
    """The 1-D mesh over this process's world, its one dimension named
    ``axis_name``. With no world yet: a process that ``torchrun`` started
    joins the world torchrun set up (its environment); otherwise a world of
    1 starts in-process (a FileStore in a temporary directory). n_devices,
    when given, must be the world's size: the ranks are the devices, and a
    world is started by ``launch`` or torchrun."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
            rank = int(os.environ["RANK"])
            if dev.type == "cuda":
                torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)))
            dist.init_process_group(_backend(dev), init_method="env://")
        elif n_devices in (None, 1):
            store_dir = tempfile.mkdtemp(prefix="bidl_world_")
            atexit.register(shutil.rmtree, store_dir, ignore_errors=True)
            init_world(0, 1, os.path.join(store_dir, "store"), dev)
        else:
            raise RuntimeError(f"device_mesh({n_devices}) needs a world of {n_devices} ranks: "
                               "start them with parallel.mesh.launch or torchrun")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"device_mesh({n_devices}) in a world of {world} ranks")
    return init_device_mesh(dev.type, (world,), mesh_dim_names=(axis_name,))


def _rank_entry(rank: int, world_size: int, store_path: str, device: str, fn: Callable,
                args: tuple) -> None:
    if torch.device(device).type == "cpu":
        torch.set_num_threads(1)  # the CPU ranks share the machine's cores
    init_world(rank, world_size, store_path, device)
    try:
        fn(device_mesh(world_size, device=device if device == "cpu" else f"cuda:{rank}"), *args)
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, n_ranks: int, *args, device="cuda") -> None:
    """Run ``fn(mesh, *args)`` on ``n_ranks`` processes started by
    ``torch.multiprocessing.spawn``, rank r on ``cuda:r`` (device "cuda") or
    on the CPU under gloo (device "cpu", each rank on one torch thread).
    fn must be importable by name (a module-level function), and its module
    should import only torch and this package: each rank imports it anew.
    Returns when every rank has; a rank's exception is raised here. Results
    come back through files."""
    dev = resolve_device(device)
    if dev.type == "cuda" and n_ranks > torch.cuda.device_count():
        raise RuntimeError(f"{n_ranks} ranks need {n_ranks} cards; the machine shows "
                           f"{torch.cuda.device_count()}")
    # CPU ranks share the machine's cores: one BLAS / OpenMP thread each,
    # set before the children load those libraries (idle spinning threads
    # otherwise slow every rank several-fold)
    pinned = {k: "1" for k in _THREAD_VARS} if dev.type == "cpu" else {}
    saved = {k: os.environ.get(k) for k in pinned}
    os.environ.update(pinned)
    try:
        with tempfile.TemporaryDirectory(prefix="bidl_launch_") as tmp:
            torch.multiprocessing.spawn(
                _rank_entry, args=(n_ranks, os.path.join(tmp, "store"), dev.type, fn, args),
                nprocs=n_ranks, join=True, start_method="spawn")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# --- the collectives ------------------------------------------------------------


def rank_of(mesh: DeviceMesh) -> int:
    return mesh.get_local_rank()


def size_of(mesh: DeviceMesh) -> int:
    return mesh.size()


def shard_rows(mesh: DeviceMesh, x, dim: int = 0):
    """This rank's block of x along ``dim`` (rank-major, equal blocks); None
    passes through."""
    if x is None:
        return None
    n, r = size_of(mesh), rank_of(mesh)
    L = x.shape[dim]
    if L % n:
        raise ValueError(f"axis {dim} of length {L} does not divide over {n} ranks")
    return x.narrow(dim, r * (L // n), L // n)


def gather_rows(mesh: DeviceMesh, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Every rank's x concatenated along ``dim`` in rank order (the
    reference's ``out_specs`` P(axis) on that axis): each rank gets the
    whole. Equal shapes on every rank."""
    n = size_of(mesh)
    dt = x.dtype
    y = (x.to(torch.uint8) if dt == torch.bool else x).contiguous()
    parts = [torch.empty_like(y) for _ in range(n)]
    dist.all_gather(parts, y, group=mesh.get_group())
    out = torch.cat(parts, dim=dim)
    return out.to(torch.bool) if dt == torch.bool else out


def sum_all(mesh: DeviceMesh, x: torch.Tensor) -> torch.Tensor:
    """The sum of x over the ranks (the reference's ``psum``), on every rank."""
    y = x.clone()
    dist.all_reduce(y, op=dist.ReduceOp.SUM, group=mesh.get_group())
    return y


def mean_all(mesh: DeviceMesh, x):
    """The mean of x over the ranks (the reference's ``pmean``): the sum
    divided by the world size, on every rank. x a tensor, or a list of
    tensors of one dtype reduced together in one all-reduce (a step's
    gradients and loss: one collective's latency instead of one each)."""
    if torch.is_tensor(x):
        return sum_all(mesh, x) / size_of(mesh)
    flat = sum_all(mesh, torch.cat([t.reshape(-1) for t in x])) / size_of(mesh)
    return [f.view_as(t) for f, t in zip(flat.split([t.numel() for t in x]), x)]


def halo_rows(mesh: DeviceMesh, u: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """One-row halos of the rank's (Xl, ...) block along its first axis:
    (the previous rank's last row, the next rank's first row), zero rows at
    the ends of the world (the reference's ppermute pair,
    ``parallel/domain.py:39-44``). Point-to-point sends and receives."""
    n, r = size_of(mesh), rank_of(mesh)
    g = mesh.get_group()
    above = torch.zeros_like(u[:1])
    below = torch.zeros_like(u[:1])
    ops = []
    if r > 0:
        ops += [dist.P2POp(dist.irecv, above, dist.get_global_rank(g, r - 1), group=g),
                dist.P2POp(dist.isend, u[:1].contiguous(), dist.get_global_rank(g, r - 1), group=g)]
    if r < n - 1:
        ops += [dist.P2POp(dist.irecv, below, dist.get_global_rank(g, r + 1), group=g),
                dist.P2POp(dist.isend, u[-1:].contiguous(), dist.get_global_rank(g, r + 1), group=g)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return above, below


def rank_generator(gen: Optional[torch.Generator], mesh: DeviceMesh) -> Optional[torch.Generator]:
    """The rank's generator, the counterpart of the reference's
    ``fold_in(key, axis_index)``: rank 0 draws from ``gen`` itself, so a
    world of 1 is the unsharded run draw for draw; rank r > 0 from a fresh
    generator seeded by a hash of gen's state and r, leaving gen untouched.
    gen=None (the global generator on rank 0) hashes ``torch.initial_seed()``."""
    r = rank_of(mesh)
    if r == 0:
        return gen
    state = (gen.get_state().numpy().tobytes() if gen is not None
             else torch.initial_seed().to_bytes(8, "little"))
    seed = int.from_bytes(hashlib.blake2b(state + r.to_bytes(8, "little"), digest_size=8).digest(),
                          "little") >> 1
    dev = gen.device if gen is not None else torch.device(mesh.device_type)
    return torch.Generator(device=dev).manual_seed(seed)
