"""Data parallelism over `torch.distributed`: one process per device.

Counterpart of `pde_control_tpu/parallel/mesh.py`. The JAX package shards
the batch over a 1-axis `('data',)` device mesh inside one program and
lets XLA insert the gradient all-reduce. Here every rank is a process of
its own (SPMD, launched by `torchrun` or spawned): it holds a replica of
the parameters and the optimizer state, draws the same global batch as
every other rank and keeps its contiguous slice (`shard_batch`), and
`ControlTraining` all-reduces the gradient and the metrics. A `Mesh`
names its axis and size, this rank and its device.

`make_mesh` uses the default process group, and initialises it from
torchrun's environment when it is not yet initialised: NCCL on
`cuda:LOCAL_RANK`, or gloo with `device="cpu"`. It never falls back: a
world of another size than asked raises, and a CUDA mesh without a card
raises where the JAX package would warn and move to CPU devices.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A device mesh of SPMD processes: the default process group's ranks.
    `shape` maps each axis name to its size, as `jax.sharding.Mesh.shape`
    does; `rank` is this process's rank, `device` its device and `backend`
    the group's ('nccl' or 'gloo')."""

    axis_names: tuple[str, ...]
    shape: dict
    rank: int
    device: torch.device
    backend: str

    @property
    def size(self) -> int:
        """The number of ranks (the JAX mesh's `devices.size`)."""
        return int(np.prod(list(self.shape.values())))


def _init_default_group(device) -> None:
    """`init_process_group` from torchrun's environment (MASTER_ADDR,
    MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK): NCCL bound to
    cuda:LOCAL_RANK, or gloo for the CPU."""
    missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
               if k not in os.environ]
    if missing:
        raise ValueError(
            f"make_mesh: no process group and no torchrun environment "
            f"({', '.join(missing)} unset); launch with `torchrun "
            f"--nproc-per-node N …` or call "
            f"torch.distributed.init_process_group first")
    if device is not None and torch.device(device).type == "cpu":
        dist.init_process_group("gloo")
        return
    if not torch.cuda.is_available():
        raise RuntimeError("make_mesh: no CUDA device for an NCCL mesh; pass "
                           "device='cpu' for a gloo mesh on the CPU")
    local = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    torch.cuda.set_device(local)
    dist.init_process_group("nccl", device_id=local)


def make_mesh(n_devices: int | None = None, axis: str = "data",
              device=None) -> Mesh:
    """A 1D mesh over the default process group's ranks (all of them).

    The group is initialised from torchrun's environment when it is not
    yet (see `_init_default_group`). `n_devices`, when given, must be the
    world size. `device`: this rank's device; by default cuda:LOCAL_RANK
    on an NCCL group and the CPU on a gloo group started here with
    device='cpu'. A gloo group the caller started may also hold CUDA
    tensors (several ranks on one card, eager steps only)."""
    if not dist.is_initialized():
        _init_default_group(device)
    world = dist.get_world_size()
    if n_devices is not None and world != n_devices:
        raise ValueError(f"make_mesh: requested {n_devices} devices, the "
                         f"process group has {world} ranks")
    backend = dist.get_backend()
    if device is None:
        device = (torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
                  if backend == "nccl" else torch.device("cpu"))
    device = torch.device(device)
    if backend == "nccl" and device.type != "cuda":
        raise ValueError("make_mesh: an NCCL group needs CUDA tensors")
    return Mesh((axis,), {axis: world}, dist.get_rank(), device, backend)


def _shard(x, axis: int, mesh: Mesh):
    n = x.shape[axis]
    if n % mesh.size:
        raise ValueError(f"batch axis of {n} not divisible by the mesh size "
                         f"{mesh.size}")
    k = n // mesh.size
    index = (slice(None),) * axis + (slice(mesh.rank * k, (mesh.rank + 1) * k),)
    return x[index]


def shard_batch(batch: dict, mesh: Mesh, axis: str = "data") -> dict:
    """This rank's contiguous slice of the leading (batch) axis of every
    array of `batch` (numpy arrays or tensors)."""
    return {k: _shard(v, 0, mesh) for k, v in batch.items()}


def shard_batch_multi(batches: dict, mesh: Mesh, axis: str = "data") -> dict:
    """This rank's slice of the second axis of stacked batches (K, B, …):
    the per-step batch that progress_multi's steps take."""
    return {k: _shard(v, 1, mesh) for k, v in batches.items()}


def replicate(tensors, mesh: Mesh):
    """Broadcast every tensor of `tensors` (an iterable) from rank 0, in
    place; returns them."""
    tensors = list(tensors)
    for t in tensors:
        dist.broadcast(t, src=0)
    return tensors


def all_reduce_mean(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The mean of `t` over the mesh's ranks, in place."""
    dist.all_reduce(t)
    return t.div_(mesh.size)


def is_writer(mesh: Mesh | None) -> bool:
    """Whether this process writes files: rank 0, or the only process."""
    return mesh is None or mesh.rank == 0


def barrier(mesh: Mesh | None) -> None:
    if mesh is not None:
        dist.barrier()


@contextlib.contextmanager
def rank0_first(mesh: Mesh | None):
    """Rank 0 runs the body first (writing a cache, say); the other ranks
    run it after it has finished (reading it)."""
    if not is_writer(mesh):
        barrier(mesh)
    yield
    if is_writer(mesh) and mesh is not None:
        barrier(mesh)
