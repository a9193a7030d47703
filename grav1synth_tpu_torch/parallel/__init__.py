"""Frame sharding over several devices (counterpart of
grav1synth_tpu/parallel/mesh.py).

The multi-process host sharding of inspect/apply/remove stays the JAX
package's ``grav1synth_tpu.parallel.host_shard`` (host code, no device
work)."""

from .mesh import (
    DeviceMesh,
    frame_shards,
    make_mesh,
    pad_batch,
    sharded_apply,
    sharded_apply_with_stats,
)

__all__ = [
    "DeviceMesh",
    "frame_shards",
    "make_mesh",
    "pad_batch",
    "sharded_apply",
    "sharded_apply_with_stats",
]
