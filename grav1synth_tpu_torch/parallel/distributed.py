"""Frame sharding over several processes (the counterpart of the JAX
package's mesh after ``jax.distributed.initialize``, and of
``jax.experimental.multihost_utils.process_allgather`` and
``sync_global_devices``).

``initialize`` joins this process to a process group and returns a
``ProcessMesh``: its rank, the world size and its local ``DeviceMesh``.
The global mesh is every rank's local mesh, process-major, as JAX orders
``jax.devices()`` in a pod: rank r owns the r-th contiguous range of a
global batch (``ProcessMesh.frame_range``), which its local mesh shards
further. ``parallel.sharded_apply_with_stats``, ``sharded_apply``,
``ops.diff_estimate.mesh_pair_stats_per_frame`` and
``sharded_diff_stats`` take a ``ProcessMesh`` in the mesh's place, with
this rank's frames, as the JAX functions take a global mesh and each
process's addressable shards.

Frames never leave their devices. Only statistics cross processes, as
host copies over gloo: the apply's energy and frame count, the diff's
per-frame Gram and moment sums (a few KB a frame, which the diff path
downloads to the host in any case). gloo is the one backend: it runs
several ranks on one card, which NCCL refuses, and the CPU pods of the
tests. Every wait ends at the group's timeout, so a dead rank fails the
others instead of hanging them.
"""

from __future__ import annotations

import datetime
import hashlib
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

BACKEND = "gloo"
# seconds any rank waits for the others, at start-up and in each collective
DEFAULT_TIMEOUT = 300.0


@dataclass(frozen=True)
class ProcessMesh:
    """This process's place in a multi-process mesh: its rank, the world
    size, and the devices of this process (``local``, a ``DeviceMesh``).
    Every rank has a local mesh of the same size."""

    rank: int
    world_size: int
    local: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        """The global device count: world size x local size."""
        return self.world_size * len(self.local)

    def frame_range(self, n_frames: int) -> Tuple[int, int]:
        """[start, stop) of the ``n_frames`` global batch that this rank
        owns: contiguous and process-major, the order in which
        ``P("data")`` lays frames over ``jax.devices()``. The batch must
        divide over the global device count (``pad_batch`` first)."""
        if n_frames % self.size:
            raise ValueError(
                f"a batch of {n_frames} frames does not divide over {self.size} "
                "devices; pad it first (pad_batch)"
            )
        k = n_frames // self.world_size
        return self.rank * k, (self.rank + 1) * k


def _init_method(coordinator_address: str) -> str:
    if "://" in coordinator_address:
        return coordinator_address
    return f"tcp://{coordinator_address}"


def initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    local: Optional[Sequence] = None,
    timeout: float = DEFAULT_TIMEOUT,
) -> ProcessMesh:
    """Join the process group (``jax.distributed.initialize``) and return
    this process's ``ProcessMesh``. ``coordinator_address`` is rank 0's
    ``host:port``. ``local`` defaults to ``make_mesh()``, every card of
    this host, and raises without one; the tests pass
    ``DeviceMesh(["cpu"] * n)``. Raises on every rank if the local sizes
    differ, and after ``timeout`` seconds if a rank does not join."""
    from .mesh import DeviceMesh, make_mesh

    local = make_mesh() if local is None else DeviceMesh(local)
    dist.init_process_group(
        BACKEND,
        init_method=_init_method(coordinator_address),
        world_size=num_processes,
        rank=process_id,
        timeout=datetime.timedelta(seconds=timeout),
    )
    sizes = process_allgather(np.array([len(local)], np.int64))[:, 0]
    if (sizes != len(local)).any():
        shutdown()
        raise ValueError(f"every rank needs a local mesh of one size: {sizes.tolist()}")
    return ProcessMesh(process_id, num_processes, local)


def shutdown() -> None:
    """Leave the process group (``jax.distributed.shutdown``)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def split_mesh(mesh) -> Tuple[Sequence[torch.device], Optional[ProcessMesh]]:
    """(this process's devices, the ``ProcessMesh`` or None) of a mesh
    argument: a ``ProcessMesh`` or a sequence of devices."""
    if isinstance(mesh, ProcessMesh):
        return mesh.local, mesh
    return mesh, None


def _all_gather(t: torch.Tensor) -> List[torch.Tensor]:
    """Every rank's host copy of ``t`` (same shape and dtype on every
    rank), in rank order."""
    t = t.detach().to("cpu").contiguous()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return out


def process_allgather(x) -> np.ndarray:
    """Every rank's ``x`` stacked as (P, ...) in rank order
    (``multihost_utils.process_allgather``); ``x`` has the same shape and
    dtype on every rank."""
    return np.stack([t.numpy() for t in _all_gather(torch.from_numpy(np.array(x)))])


def sync_global_devices(name: str) -> None:
    """A barrier (``multihost_utils.sync_global_devices``): returns once
    every rank has called it, and raises if they passed different names."""
    tag = int.from_bytes(hashlib.sha256(name.encode()).digest()[:8], "little", signed=True)
    tags = process_allgather(np.array([tag], np.int64))[:, 0]
    if (tags != tag).any():
        raise RuntimeError(f"sync_global_devices({name!r}): the ranks passed different names")


def global_batch(n_local: int) -> int:
    """The global batch size: the sum of every rank's frame count, which
    must be equal (one global array, split process-major). Raises on every
    rank otherwise."""
    counts = process_allgather(np.array([n_local], np.int64))[:, 0]
    if (counts != n_local).any():
        raise ValueError(f"every rank must hold the same number of frames: {counts.tolist()}")
    return int(counts.sum())


def all_sum(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` added, on the host, in ``t``'s dtype (int64 sums
    stay exact)."""
    t = t.detach().to("cpu", copy=True).contiguous()
    dist.all_reduce(t)
    return t


def gather_frames(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """Per-frame tensors of this rank's frames (one dtype, equal leading
    dimension) -> the same tensors over the global batch, every rank's in
    rank order, on the host: one exchange for all of them."""
    n = tensors[0].shape[0]
    global_batch(n)
    flat = torch.cat([t.detach().to("cpu").reshape(n, -1) for t in tensors], 1)
    rows = torch.cat(_all_gather(flat))
    widths = [t[:1].numel() for t in tensors]
    return [
        part.reshape(rows.shape[0], *t.shape[1:])
        for part, t in zip(torch.split(rows, widths, 1), tensors)
    ]
