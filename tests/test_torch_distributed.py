"""The port's multi-process frame sharding on CPU pods.

Two or four OS processes, each with a local mesh that names the CPU four
or two times, join one gloo process group through
``parallel.distributed.initialize``: an 8-device global mesh, as the JAX
package's pod in tests/test_multihost.py. Each process is this file run
as a script (its ``__main__`` block, which imports only the port, torch
and numpy); it reads its inputs from files the test writes and writes its
results back. Held:

(a) ``sharded_apply_with_stats`` over the ``ProcessMesh`` at 64x64 4:2:0
    and monochrome 10-bit, 16 frames, patterns made in the process: every
    rank's frames equal ``grain_ref`` and the JAX package's sharded apply
    on its 8 virtual CPU devices (tolerance 0); energy equal on every rank
    and to the single-process port, within rtol 1e-5 of the JAX package's
    float32 psum; frames 16;
(b) ``mesh_pair_stats_per_frame`` (with and without chroma) and
    ``sharded_diff_stats``: equal on every rank to the single-process
    port, and within rtol 1e-5 of the JAX package's sharded functions;
(c) the per-host rewrite of tests/multihost_worker.py through the port's
    ``host_shard`` and ``process_allgather``: the merged IVF byte-identical
    to the JAX package's serial ``apply_table``.

A rank that exits before joining makes the other fail within the group's
timeout. Every process is waited for with a timeout and killed after it.
"""

import dataclasses
import os
import pickle
import socket
import subprocess
import sys
import time

import numpy as np

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS_DIR)
BIT_DEPTH = 10
LAG = 2


def _worker(rank, world, port, local, workdir, group_timeout, mode):
    """One rank of the pod; returns its exit code."""
    rank, world, local = int(rank), int(world), int(local)
    if mode == "die":
        return 3  # exits before joining the group
    sys.path.insert(0, REPO)
    import torch

    from grav1synth_tpu_torch.container import ivf
    from grav1synth_tpu_torch.obu.types import FilmGrainParams
    from grav1synth_tpu_torch.ops import diff_estimate as td
    from grav1synth_tpu_torch.ops import grain as tg
    from grav1synth_tpu_torch.parallel import (
        DeviceMesh,
        initialize,
        process_allgather,
        sharded_apply_with_stats,
        shutdown,
        sync_global_devices,
    )
    from grav1synth_tpu_torch.parallel.host_shard import _rewrite_shard, keyframe_flags, plan_shards
    from grav1synth_tpu_torch.tables import load_table

    pm = initialize(f"127.0.0.1:{port}", world, rank, local=DeviceMesh(["cpu"] * local),
                    timeout=float(group_timeout))
    assert (pm.rank, pm.world_size, pm.size) == (rank, world, 8)
    with open(os.path.join(workdir, "inputs.pkl"), "rb") as fh:
        inputs = pickle.load(fh)
    out = {}

    # (a) the sharded apply, this rank's frames
    for arm, (planes, params) in inputs["apply"].items():
        a, b = pm.frame_range(len(params))
        mine = [None if p is None else torch.from_numpy(p[a:b]) for p in planes]
        pb = tg.pack_params([FilmGrainParams(**d) for d in params[a:b]], "cpu")
        y2, cb2, cr2, energy, frames = sharded_apply_with_stats(
            pm, *mine, pb, BIT_DEPTH, monochrome=arm == "mono"
        )
        assert energy.dtype == torch.float64 and frames.dtype == torch.int64
        out[arm] = dict(
            range=(a, b), planes=[None if t is None else t.numpy() for t in (y2, cb2, cr2)],
            energy=float(energy), frames=int(frames),
        )

    # (b) the sharded diff statistics
    planes = inputs["diff"]
    a, b = pm.frame_range(len(planes[0]))
    mine = [p[a:b] for p in planes]
    kw = dict(lag=LAG, bit_depth=BIT_DEPTH, sub_x=1, sub_y=1)
    per = td.mesh_pair_stats_per_frame(pm, *mine, **kw, has_chroma=True)
    luma = td.mesh_pair_stats_per_frame(pm, *mine[:2], None, None, None, None, **kw,
                                        has_chroma=False)
    assert luma[1] is None and luma[2] is None
    out["per_frame"] = [{k: v.numpy() for k, v in d.items()} for d in per]
    out["per_frame_luma"] = {k: v.numpy() for k, v in luma[0].items()}
    out["sums"] = td.sharded_diff_stats(pm, mine[0::2], mine[1::2], LAG, BIT_DEPTH)

    # (c) the per-host rewrite (tests/multihost_worker.py), counts over the group
    ivf_path, table_path = inputs["rewrite"]
    segments = load_table(table_path)
    _, packets = ivf.read_ivf(ivf_path)
    shards = plan_shards(keyframe_flags(packets), 2 * world)
    owned = [i for i in range(len(shards)) if i % world == rank]
    phase1 = {i: _rewrite_shard((ivf_path, *shards[i], segments, None)) for i in owned}
    deltas = np.zeros((len(shards), len(segments)), np.float32)
    for i, (_, counts) in phase1.items():
        deltas[i] = counts
    gathered = process_allgather(deltas)
    assert gathered.shape == (world, len(shards), len(segments))
    merged = gathered.sum(axis=0)
    prefix = np.zeros(len(segments))
    for i in range(len(shards)):
        if i in owned:
            shard_out = phase1[i][0]
            if i > 0 and prefix.any():
                shard_out, _ = _rewrite_shard(
                    (ivf_path, *shards[i], segments, [int(v) for v in prefix])
                )
            with open(os.path.join(workdir, f"shard_{i}.pkl"), "wb") as fh:
                pickle.dump(shard_out, fh)
        prefix += merged[i]
    sync_global_devices("shards-written")
    out["n_shards"] = len(shards)

    with open(os.path.join(workdir, f"out_{rank}.pkl"), "wb") as fh:
        pickle.dump(out, fh)
    shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(_worker(*sys.argv[1:]))

# ---------------------------------------------------------------------------
# The tests (pytest imports this module; a worker stops above)

import pytest  # noqa: E402

from test_multihost import grainy_ivf  # noqa: E402,F401  (a fixture)

POD_TIMEOUT = 300  # seconds a pod may take
POD_GROUP_TIMEOUT = 120  # the process group's timeout in a healthy pod
DEAD_GROUP_TIMEOUT = 5  # ... where a rank dies before joining


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(world, workdir, group_timeout, dead=None):
    """Start a pod of ``world`` ranks; wait for each with a timeout, kill
    them all after it. Returns each rank's (return code, output)."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), str(rank), str(world), str(port),
             str(8 // world), str(workdir), str(group_timeout),
             "die" if rank == dead else "run"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        )
        for rank in range(world)
    ]
    results = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=POD_TIMEOUT)
            results.append((p.returncode, out.decode(errors="replace")))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return results


def _planes(b, mono, seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 1 << BIT_DEPTH, (b, 64, 64)).astype(np.int16)
    if mono:
        return [y, None, None]
    return [y] + [rng.integers(0, 1 << BIT_DEPTH, (b, 32, 32)).astype(np.int16) for _ in range(2)]


@pytest.fixture(scope="module")
def references():
    """Inputs, and what the JAX package, grain_ref and the single-process
    port give on them."""
    import torch

    from grav1synth_tpu.ops import diff_estimate as jd
    from grav1synth_tpu.ops import grain_jax, grain_ref
    from grav1synth_tpu.parallel import mesh as jax_mesh
    from grav1synth_tpu_torch.ops import diff_estimate as td
    from grav1synth_tpu_torch.ops import grain as tg
    from grav1synth_tpu_torch.parallel import DeviceMesh, sharded_apply_with_stats
    from test_torch_cuda import pattern_zoo
    from test_torch_diff import _stats_inputs

    cpu8 = DeviceMesh(["cpu"] * 8)
    jmesh = jax_mesh.make_mesh()
    ref = {"apply": {}, "inputs": {"apply": {}}}
    for arm, mono in (("420", False), ("mono", True)):
        params = pattern_zoo(71 + mono, n=16)
        planes = _planes(16, mono, seed=5 + mono)
        jb = grain_jax.pack_params(params)
        t = [None if p is None else torch.from_numpy(p) for p in planes]
        alone = sharded_apply_with_stats(cpu8, *t, tg.from_jax_params(jb, "cpu"), BIT_DEPTH,
                                         monochrome=mono)
        jax = jax_mesh.sharded_apply_with_stats(jmesh, *planes, jb, BIT_DEPTH, monochrome=mono)
        nplanes = 1 if mono else 3
        grain = [
            grain_ref.apply_grain_frame([p[i] for p in planes[:nplanes]], params[i], BIT_DEPTH)
            for i in range(16)
        ]
        ref["apply"][arm] = dict(
            nplanes=nplanes,
            alone=[None if x is None else x.numpy() for x in alone[:3]],
            energy=float(alone[3]),
            jax=[np.asarray(x) for x in jax[:nplanes]],
            jax_energy=float(jax[3]),
            grain_ref=[np.stack([g[k] for g in grain]) for k in range(nplanes)],
        )
        ref["inputs"]["apply"][arm] = (planes, [dataclasses.asdict(p) for p in params])

    planes = [np.concatenate(parts) for parts in zip(*(
        _stats_inputs(seed, 1, 1, BIT_DEPTH, np.int16, 64, 64) for seed in range(1, 9)
    ))]
    ref["inputs"]["diff"] = planes
    kw = dict(lag=LAG, bit_depth=BIT_DEPTH, sub_x=1, sub_y=1)
    ref["per_frame"] = td.mesh_pair_stats_per_frame(cpu8, *planes, **kw, has_chroma=True)
    ref["per_frame_luma"] = td.mesh_pair_stats_per_frame(
        cpu8, *planes[:2], None, None, None, None, **kw, has_chroma=False)[0]
    ref["sums"] = td.sharded_diff_stats(cpu8, planes[0::2], planes[1::2], LAG, BIT_DEPTH)
    ref["jax_per_frame"] = jd.mesh_pair_stats_per_frame(jmesh, *planes, *kw.values(), True)
    ref["jax_sums"] = jd.sharded_diff_stats(jmesh, planes[0::2], planes[1::2], LAG, BIT_DEPTH)
    return ref


@pytest.fixture(scope="module", params=[2, 4], ids=["2x4", "4x2"])
def pod(request, references, grainy_ivf, tmp_path_factory):
    """One pod run: every rank's results."""
    world = request.param
    workdir = tmp_path_factory.mktemp(f"pod{world}")
    ivf_path, table_path, _ = grainy_ivf
    with open(workdir / "inputs.pkl", "wb") as fh:
        pickle.dump({**references["inputs"], "rewrite": (ivf_path, table_path)}, fh)
    results = _launch(world, workdir, POD_GROUP_TIMEOUT)
    for rank, (rc, out) in enumerate(results):
        assert rc == 0, f"rank {rank} failed:\n{out[-4000:]}"
    outs = []
    for rank in range(world):
        with open(workdir / f"out_{rank}.pkl", "rb") as fh:
            outs.append(pickle.load(fh))
    return dict(world=world, workdir=workdir, outs=outs)


@pytest.mark.parametrize("arm", ["420", "mono"])
def test_pod_sharded_apply(pod, references, arm):
    ref = references["apply"][arm]
    starts = []
    for out in (o[arm] for o in pod["outs"]):
        a, b = out["range"]
        starts.append(a)
        assert b - a == 16 // pod["world"]
        for k in range(3):
            if k >= ref["nplanes"]:
                assert out["planes"][k] is None
                continue
            got = out["planes"][k]
            assert got.dtype == np.int16
            assert np.array_equal(got, ref["alone"][k][a:b]), k
            assert np.array_equal(got, ref["jax"][k][a:b].astype(np.int16)), k
            assert np.array_equal(got.astype(np.int64), ref["grain_ref"][k][a:b].astype(np.int64)), k
        assert out["frames"] == 16
        assert out["energy"] == ref["energy"]
        assert abs(out["energy"] - ref["jax_energy"]) <= 1e-5 * ref["energy"]
    assert starts == [16 // pod["world"] * r for r in range(pod["world"])]


def _equal(got: dict, want: dict, what):
    assert set(got) == set(want), what
    for k in want:
        w = want[k].numpy() if hasattr(want[k], "numpy") else want[k]
        assert got[k].dtype == np.float64 and np.array_equal(got[k], w), (what, k)


def test_pod_diff_stats(pod, references):
    from test_torch_diff import _close
    import torch

    for rank, out in enumerate(pod["outs"]):
        for name, g, a, j in zip(("y", "cb", "cr"), out["per_frame"], references["per_frame"],
                                 references["jax_per_frame"]):
            assert g["ata"].shape[0] == 16
            _equal(g, a, (rank, "per frame", name))
            _close({k: torch.from_numpy(v) for k, v in g.items()},
                   {k: np.asarray(v) for k, v in j.items()}, (rank, "jax per frame", name))
        _equal(out["per_frame_luma"], references["per_frame_luma"], (rank, "luma"))
        for name, g, a, j in zip(("y", "cb", "cr"), out["sums"], references["sums"],
                                 references["jax_sums"]):
            _equal(g, a, (rank, "sums", name))
            _close({k: torch.from_numpy(v) for k, v in g.items()},
                   {k: np.asarray(v) for k, v in j.items()}, (rank, "jax sums", name))


def test_pod_rewrite_merges_to_the_serial_file(pod, grainy_ivf):
    from grav1synth_tpu.container import ivf as ivf_mod

    ivf_path, _, serial_path = grainy_ivf
    header, packets = ivf_mod.read_ivf(ivf_path)
    n_shards = pod["outs"][0]["n_shards"]
    assert n_shards > 1 and all(o["n_shards"] == n_shards for o in pod["outs"])
    flat = []
    for i in range(n_shards):
        with open(pod["workdir"] / f"shard_{i}.pkl", "rb") as fh:
            flat.extend(pickle.load(fh))
    assert len(flat) == len(packets)
    merged = pod["workdir"] / "merged.ivf"
    ivf_mod.write_ivf(str(merged), header,
                      [ivf_mod.IvfPacket(p.pts, d) for p, d in zip(packets, flat)])
    with open(serial_path, "rb") as fh:
        assert merged.read_bytes() == fh.read()


@pytest.mark.parametrize("dead", [0, 1])
def test_a_dead_rank_fails_the_pod(tmp_path, dead):
    """A rank that exits before joining: the other fails at the group's
    timeout (connecting to rank 0, or rank 0 waiting for it) and does not
    hang."""
    t0 = time.perf_counter()
    results = _launch(2, tmp_path, DEAD_GROUP_TIMEOUT, dead=dead)
    elapsed = time.perf_counter() - t0
    assert results[dead][0] == 3
    rc, out = results[1 - dead]
    assert rc != 0, out[-4000:]
    assert "timed out" in out.lower(), out[-4000:]
    assert elapsed < POD_TIMEOUT


def test_process_mesh_layout_and_no_fallback():
    import torch

    from grav1synth_tpu_torch.parallel import DeviceMesh, ProcessMesh, initialize

    pm = ProcessMesh(1, 4, DeviceMesh(["cpu"] * 2))
    assert pm.size == 8
    assert [ProcessMesh(r, 4, pm.local).frame_range(16) for r in range(4)] == [
        (0, 4), (4, 8), (8, 12), (12, 16)
    ]
    with pytest.raises(ValueError, match="pad_batch"):
        pm.frame_range(12)
    if not torch.cuda.is_available():
        # the default local mesh is every card of the host: none here
        with pytest.raises(RuntimeError, match="no CUDA device"):
            initialize(f"127.0.0.1:{_free_port()}", 1, 0)


def test_a_one_process_group_equals_the_device_mesh(references):
    """World size 1 in this process: the ProcessMesh path gives what the
    DeviceMesh path gives, and DiffEstimator.diff_batch refuses it."""
    import torch

    from grav1synth_tpu_torch.ops import diff_estimate as td
    from grav1synth_tpu_torch.ops import grain as tg
    from grav1synth_tpu_torch.parallel import (
        DeviceMesh, initialize, process_allgather, sharded_apply_with_stats, shutdown,
        sync_global_devices,
    )

    pm = initialize(f"127.0.0.1:{_free_port()}", 1, 0, local=DeviceMesh(["cpu"] * 8), timeout=30)
    try:
        planes, params = references["inputs"]["apply"]["420"]
        from grav1synth_tpu_torch.obu.types import FilmGrainParams

        pb = tg.pack_params([FilmGrainParams(**d) for d in params], "cpu")
        got = sharded_apply_with_stats(pm, *(torch.from_numpy(p) for p in planes), pb, BIT_DEPTH)
        ref = references["apply"]["420"]
        for k in range(3):
            assert np.array_equal(got[k].numpy(), ref["alone"][k])
        assert float(got[3]) == ref["energy"] and int(got[4]) == 16
        diff = references["inputs"]["diff"]
        per = td.mesh_pair_stats_per_frame(pm, *diff, lag=LAG, bit_depth=BIT_DEPTH, sub_x=1,
                                           sub_y=1, has_chroma=True)
        for g, a in zip(per, references["per_frame"]):
            _equal({k: v.numpy() for k, v in g.items()}, a, "one process")
        x = np.arange(6, dtype=np.int64).reshape(2, 3)
        assert np.array_equal(process_allgather(x), x[None])
        sync_global_devices("one")
        est = td.DiffEstimator((24, 1), device="cpu")
        with pytest.raises(TypeError, match="single-process"):
            est.diff_batch([[p[0] for p in diff[0::2]]], [[p[0] for p in diff[1::2]]], mesh=pm)
    finally:
        shutdown()
