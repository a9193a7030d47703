"""Sharding over several devices and processes.

- ``mesh`` (counterpart of grav1synth_tpu/parallel/mesh.py): frame
  sharding of the apply and diff paths over a ``DeviceMesh``;
- ``host_shard`` (a copy of grav1synth_tpu/parallel/host_shard.py): the
  multi-process GOP sharding of ``inspect``, ``apply`` and ``remove``
  (host code, no device work).

The mesh names are imported on first use, so the spawned ``host_shard``
workers, which import this package, do not import torch.
"""

from .host_shard import sharded_inspect_ivf, sharded_rewrite_ivf

_MESH_NAMES = (
    "DeviceMesh",
    "frame_shards",
    "make_mesh",
    "pad_batch",
    "sharded_apply",
    "sharded_apply_with_stats",
)

__all__ = [*_MESH_NAMES, "sharded_inspect_ivf", "sharded_rewrite_ivf"]


def __getattr__(name):
    if name in _MESH_NAMES:
        from . import mesh

        return getattr(mesh, name)
    raise AttributeError(name)
