"""Frame sharding over a device mesh (counterpart of
grav1synth_tpu/parallel/mesh.py).

The video's frame axis is the parallel dimension. A batch is cut into
contiguous frame shards, one per mesh entry; each device grains its shard
with grain patterns made on that device (pattern generation is per frame,
so it shards the same way), and only scalar statistics cross devices: the
noise energy and the frame count are summed on the mesh's first device,
where the JAX package psums them. One host thread issues every shard's
work, each on its own device's current stream, so the devices run at the
same time.

A mesh may name one device more than once: the CPU in the tests (the
counterpart of the JAX tests' 8 virtual CPU devices), one card in
``chip_smoke.py``. Its shards then run one after another on that device.
Each shard's apply runs the parameter program of its device and shape
(``ops.program``), a CUDA graph on a card; shards on one device run on its
current stream one after another, so one program's outputs are consumed
by a shard's grain kernels before the next shard's replay writes them.

Across processes, the same entry points take a ``distributed.ProcessMesh``
in the mesh's place, with this rank's frames: each rank runs the path
above over its local devices, and the statistics are added over the
process group. Multi-process sharding of the host subcommands is
``parallel.host_shard``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..obu.types import FilmGrainParams
from ..ops.grain import GrainParamsBatch, apply_grain
from .distributed import all_sum, global_batch, split_mesh


class DeviceMesh(tuple):
    """An ordered tuple of ``torch.device``s, one per frame shard."""

    def __new__(cls, devices):
        devs = tuple(torch.device(d) for d in devices)
        if not devs:
            raise ValueError("a device mesh needs at least one device")
        return super().__new__(cls, devs)


def make_mesh(n_devices: Optional[int] = None) -> DeviceMesh:
    """A mesh over the distinct CUDA devices (the first ``n_devices``)."""
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("no CUDA device available for a device mesh")
    if n_devices is not None:
        n = min(n, n_devices)
    return DeviceMesh(torch.device("cuda", i) for i in range(n))


def pad_frames(items: Sequence, n: int) -> list:
    """``items`` (a batch's frames, tables or planes) to a multiple of the
    mesh size ``n``: the last one repeated. The padded frames are dropped
    after the step."""
    return list(items) + list(items[-1:]) * ((-len(items)) % n)


def pad_batch(
    planes: Sequence[np.ndarray], params: List[FilmGrainParams], n: int
) -> Tuple[List[np.ndarray], List[FilmGrainParams], int]:
    """Pad a frame batch to a multiple of the mesh size with
    ``pad_frames``: (planes, params, the real frame count), as
    grav1synth_tpu.parallel.mesh.pad_batch returns them (whose module
    imports JAX)."""
    return [np.stack(pad_frames(pl, n)) for pl in planes], pad_frames(params, n), len(params)


def frame_shards(n_frames: int, n_shards: int) -> List[Tuple[int, int]]:
    """Contiguous [start, end) frame ranges for multi-process sharding of
    inspect/diff (a copy of grav1synth_tpu.parallel.mesh.frame_shards)."""
    base = n_frames // n_shards
    rem = n_frames % n_shards
    out = []
    start = 0
    for i in range(n_shards):
        size = base + (1 if i < rem else 0)
        out.append((start, start + size))
        start += size
    return out


def shard_slices(n_frames: int, n_shards: int) -> List[slice]:
    """Equal contiguous frame shards; the batch must divide evenly (as
    under shard_map): ``pad_batch`` first."""
    if n_frames % n_shards:
        raise ValueError(
            f"a batch of {n_frames} frames does not divide over {n_shards} "
            "devices; pad it first (pad_batch)"
        )
    k = n_frames // n_shards
    return [slice(i * k, (i + 1) * k) for i in range(n_shards)]


def _to(t: Optional[torch.Tensor], device: torch.device) -> Optional[torch.Tensor]:
    return None if t is None else t.to(device, non_blocking=True)


def _shard_params(p: GrainParamsBatch, sl: slice, device: torch.device) -> GrainParamsBatch:
    """Rows ``sl`` of a parameter batch, on ``device``: one copy of its
    buffer's rows (pinned first when they go from the host to a card)."""
    buf = p.buffer[sl]
    if device.type == "cuda" and buf.device.type == "cpu":
        buf = buf.pin_memory()
    return GrainParamsBatch(buf.to(device, non_blocking=True), p.touches_chroma)


def sharded_apply_with_stats(
    mesh,
    y: torch.Tensor,
    cb: Optional[torch.Tensor],
    cr: Optional[torch.Tensor],
    p: GrainParamsBatch,
    bit_depth: int,
    sub_x: int = 1,
    sub_y: int = 1,
    monochrome: bool = False,
):
    """Apply grain with frames sharded over the mesh; returns (y', cb',
    cr', noise_energy, frame_count), the planes concatenated on
    ``mesh[0]``. ``noise_energy`` is sum((y' - y)^2) over the luma of
    every frame, an exact int64 sum per shard, summed on ``mesh[0]`` and
    returned as a float64 scalar; ``frame_count`` an int64 scalar there.
    Patterns are made on each shard's device (``apply_grain``). The batch
    must divide evenly over the mesh.

    With a ``ProcessMesh``, the planes and ``p`` are this rank's frames
    and the planes come back on its first local device; ``noise_energy``
    and ``frame_count`` are every rank's, the same on every rank."""
    devices, pm = split_mesh(mesh)
    home = devices[0]
    outs, energies = [], []
    for dev, sl in zip(devices, shard_slices(y.shape[0], len(devices))):
        ys = _to(y[sl], dev)
        planes = apply_grain(
            ys,
            None if cb is None else _to(cb[sl], dev),
            None if cr is None else _to(cr[sl], dev),
            _shard_params(p, sl, dev), bit_depth, sub_x, sub_y, monochrome,
        )
        d = planes[0].to(torch.int32) - ys.to(torch.int32)
        energies.append((d * d).sum(dtype=torch.int64))
        outs.append(planes)

    def gather(k):
        if outs[0][k] is None:
            return None
        return torch.cat([o[k].to(home) for o in outs])

    energy = torch.stack([e.to(home) for e in energies]).sum()
    n_frames = y.shape[0]
    if pm is not None:
        n_frames = global_batch(n_frames)
        energy = all_sum(energy).to(home)
    frames = torch.tensor(n_frames, dtype=torch.int64, device=home)
    return gather(0), gather(1), gather(2), energy.to(torch.float64), frames


def sharded_apply(mesh, y, cb, cr, p, bit_depth, **kw):
    """Sharded apply without the statistics."""
    y2, cb2, cr2, _, _ = sharded_apply_with_stats(mesh, y, cb, cr, p, bit_depth, **kw)
    return y2, cb2, cr2
