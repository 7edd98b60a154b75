"""Process groups for multi-device jobs: one process a device.

The JAX package runs a multi-device job as one SPMD program over a
device pool (``jax.devices()[:n]`` reshaped to ``Plan.mesh_shape``).
PyTorch runs one process a device, so a job of n devices is n ranks of
one process group:

- :func:`init_group` joins rank ``rank`` of ``world_size`` through a
  store address: NCCL for a CUDA device (bound with ``device_id``, and
  with NCCL's async error handling on), gloo for the CPU.  The group
  has an explicit timeout, so a collective that waits on a dead peer
  raises instead of blocking for ever.
- The store is a :func:`file_store` in the job's directory, a fresh file
  for every group, so concurrent jobs (or test workers) never race for
  a port; ``"env://"`` reads ``MASTER_ADDR``/``MASTER_PORT`` as
  ``torchrun`` sets them.
- :class:`Mesh` lays the group out as ``Plan.mesh_axes`` with a
  ``DeviceMesh``; each named axis, and each tuple of axes made one, is
  an :class:`Axis`: its process group, this rank's index on it and its
  size.
- :func:`spawn` runs a function on n spawned ranks of a fresh group and
  returns rank 0's result, or raises with the failing rank's traceback;
  no rank outlives it.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import multiprocessing
import os
import queue
import shutil
import tempfile
import time
import traceback
import uuid
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 300.0
SPAWN_TIMEOUT_S = 600.0


def file_store(directory: str, name: str = "group") -> str:
    """A fresh ``file://`` store in ``directory``: a new file name for
    every group, since a store file must not be reused."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(os.path.abspath(directory),
                        f"{name}.{uuid.uuid4().hex}.store")
    return "file://" + path


def remove_store(store: Optional[str]) -> None:
    """Delete a :func:`file_store`'s file once its group is gone."""
    if store and store.startswith("file://"):
        try:
            os.remove(store[len("file://"):])
        except FileNotFoundError:
            pass


@dataclasses.dataclass(frozen=True)
class Axis:
    """One mesh axis as this rank sees it."""
    name: str
    group: object          # torch.distributed ProcessGroup
    rank: int              # this rank's index along the axis
    size: int


@dataclasses.dataclass
class Group:
    """This process's place in a job's process group."""
    rank: int
    size: int
    device: torch.device
    backend: str
    store: str

    def mesh(self, mesh_axes: Tuple[Tuple[str, int], ...],
             flat: Sequence[Tuple[str, ...]] = ()) -> "Mesh":
        return Mesh(self, mesh_axes, flat)

    def destroy(self) -> None:
        if dist.is_initialized():
            dist.destroy_process_group()


def init_group(rank: int, world_size: int, store: str, device,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> Group:
    """Join the default process group as ``rank`` of ``world_size``.
    ``device`` is this rank's device; its CUDA context is made current
    before the group starts, so NCCL binds to it."""
    dev = torch.device(device)
    kw = {}
    if dev.type == "cuda":
        if dev.index is None:
            raise ValueError("a rank's CUDA device needs an index "
                             f"(got {str(dev)!r})")
        torch.cuda.set_device(dev)
        # a failed collective tears the communicator down and raises,
        # where it would otherwise leave the rank blocked
        os.environ.setdefault("TORCH_NCCL_ASYNC_ERROR_HANDLING", "1")
        backend = "nccl"
        kw["device_id"] = dev
    else:
        backend = "gloo"
    dist.init_process_group(
        backend, init_method=store, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s), **kw)
    return Group(rank, world_size, dev, backend, store)


def nccl_version() -> Optional[str]:
    if not torch.cuda.is_available():
        return None
    v = torch.cuda.nccl.version()
    return ".".join(map(str, v)) if isinstance(v, tuple) else str(v)


class Mesh:
    """``Plan.mesh_axes`` over a group's ranks, row-major, as the JAX
    package reshapes its device pool.  Besides each named axis, each
    tuple of axes in ``flat`` (in mesh order, such as ``("pod",
    "data")``) is one axis over their product: this rank's slice of
    them, indexed row-major, as a ``PartitionSpec`` entry of that tuple
    lays a dim out.  Only this rank's group of a flattened axis is made
    (a group-local ``new_group``)."""

    def __init__(self, group: Group, mesh_axes: Tuple[Tuple[str, int], ...],
                 flat: Sequence[Tuple[str, ...]] = ()):
        from torch.distributed.device_mesh import DeviceMesh
        names = tuple(a for a, _ in mesh_axes)
        shape = tuple(n for _, n in mesh_axes)
        if math.prod(shape) != group.size:
            raise ValueError(f"mesh {dict(mesh_axes)} needs "
                             f"{math.prod(shape)} ranks; the group has "
                             f"{group.size}")
        self.group = group
        self.names, self.shape = names, shape
        self.device_mesh = DeviceMesh(
            group.device.type, torch.arange(group.size).reshape(shape),
            mesh_dim_names=names)
        self.axes: Dict[object, Axis] = {
            name: Axis(name, self.device_mesh.get_group(name),
                       self.device_mesh.get_local_rank(name), n)
            for name, n in mesh_axes}
        self.coords = tuple(self.axes[a].rank for a in names)
        for axes in flat:
            self.flatten(tuple(axes))

    def flatten(self, axes: Tuple[str, ...]) -> None:
        """Make the tuple ``axes`` one axis; every rank of the job calls
        it at the same point of its program."""
        if len(axes) == 1 or axes in self.axes:
            return
        pos = [self.names.index(a) for a in axes]
        if pos != sorted(pos):
            raise ValueError(f"axes {axes} are not in mesh order "
                             f"{self.names}")
        grid = torch.arange(self.group.size).reshape(self.shape)
        index = tuple(slice(None) if i in pos else c
                      for i, c in enumerate(self.coords))
        ranks = grid[index].reshape(-1).tolist()
        pg = dist.new_group(ranks, use_local_synchronization=True)
        self.axes[axes] = Axis("+".join(axes), pg,
                               ranks.index(self.group.rank), len(ranks))

    def axis(self, name) -> Axis:
        """A named axis, or a tuple of names made one axis in ``flat``."""
        if isinstance(name, tuple) and len(name) == 1:
            name = name[0]
        return self.axes[name]

    def size(self, name) -> int:
        names = name if isinstance(name, tuple) else (name,)
        return math.prod(self.shape[self.names.index(a)] for a in names)

    def __contains__(self, name: str) -> bool:
        return name in self.axes


# ---------------------------------------------------------------- spawn

def _rank_main(rank, devices, store, fn, args, q):
    try:
        dev = torch.device(devices[rank])
        if dev.type == "cpu":
            torch.set_num_threads(1)
        group = init_group(rank, len(devices), store, dev)
        out = fn(group, *args)
        if rank == 0:
            q.put(("ok", rank, out))
        group.destroy()
    except BaseException:
        q.put(("error", rank, traceback.format_exc()))
        raise


def _failures(q, errors, wait_s: float = 5.0) -> str:
    """Every rank's traceback that arrives within ``wait_s`` of the
    first, in rank order: the first to report is often a peer that saw
    the failing rank's connection close."""
    deadline = time.monotonic() + wait_s
    while time.monotonic() < deadline:
        try:
            kind, rank, out = q.get(timeout=0.2)
        except queue.Empty:
            continue
        if kind == "error":
            errors[rank] = out
    return "\n".join(f"rank {r} failed:\n{errors[r]}"
                     for r in sorted(errors))


def spawn(fn, devices: Sequence[str], *args,
          timeout_s: float = SPAWN_TIMEOUT_S):
    """``fn(group, *args)`` on one spawned rank a device of ``devices``
    (rank r on ``devices[r]``; a CPU rank runs one torch thread), in one
    new process group; returns rank 0's result.  ``fn`` is pickled by
    its import path.  Raises RuntimeError with the failing ranks'
    tracebacks if a rank raises or dies, and TimeoutError past
    ``timeout_s``; no rank outlives the call."""
    ctx = multiprocessing.get_context("spawn")
    devices = [str(d) for d in devices]
    work = tempfile.mkdtemp(prefix="saturn_group_")
    q = ctx.Queue()
    store = file_store(work)
    procs = [ctx.Process(target=_rank_main,
                         args=(r, devices, store, fn, args, q), daemon=True)
             for r in range(len(devices))]
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.start()
        while True:
            try:
                kind, rank, out = q.get(timeout=0.2)
            except queue.Empty:
                dead = [p for p in procs if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"rank {procs.index(dead[0])} died with exit code "
                        f"{dead[0].exitcode}") from None
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{len(procs)} ranks gave no result "
                                       f"in {timeout_s:.0f} s") from None
                continue
            if kind == "error":
                raise RuntimeError(_failures(q, {rank: out}))
            break
        for p in procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
            p.join(timeout=10.0)
        shutil.rmtree(work, ignore_errors=True)
