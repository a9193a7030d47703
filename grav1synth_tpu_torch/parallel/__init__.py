"""Sharding over several devices and processes.

- ``mesh`` (counterpart of grav1synth_tpu/parallel/mesh.py): frame
  sharding of the apply and diff paths over a ``DeviceMesh``;
- ``distributed`` (counterpart of ``jax.distributed`` and
  ``multihost_utils``): a gloo process group whose ``ProcessMesh`` the
  same entry points take in the mesh's place, and its collectives;
- ``host_shard`` (a copy of grav1synth_tpu/parallel/host_shard.py): the
  multi-process GOP sharding of ``inspect``, ``apply`` and ``remove``
  (host code, no device work).

The mesh and process-group names are imported on first use, so the
spawned ``host_shard`` workers, which import this package, do not import
torch.
"""

from .host_shard import sharded_inspect_ivf, sharded_rewrite_ivf

_LAZY = {
    "mesh": (
        "DeviceMesh",
        "frame_shards",
        "make_mesh",
        "pad_batch",
        "sharded_apply",
        "sharded_apply_with_stats",
    ),
    "distributed": (
        "ProcessMesh",
        "initialize",
        "process_allgather",
        "shutdown",
        "sync_global_devices",
    ),
}

__all__ = [*(n for names in _LAZY.values() for n in names), "sharded_inspect_ivf",
           "sharded_rewrite_ivf"]


def __getattr__(name):
    for module, names in _LAZY.items():
        if name in names:
            from importlib import import_module

            return getattr(import_module(f".{module}", __name__), name)
    raise AttributeError(name)
