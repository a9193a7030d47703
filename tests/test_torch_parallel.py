"""The port's frame sharding over a device mesh, on the CPU.

A port mesh may name the CPU several times: the counterpart of the JAX
tests' 8 virtual CPU devices (tests/conftest.py), so the sharded code
runs here. Held to the JAX package's sharded paths on its 8-device CPU
mesh and to the port's own unsharded results:

- ``sharded_apply_with_stats``: planes identical, ``frames`` exact,
  energy within rtol 1e-5 (the JAX package sums float32 squares; the port
  sums int64 exactly);
- ``pad_batch``, ``frame_shards``: equal to the JAX package's;
- ``mesh_pair_stats_per_frame``, ``sharded_diff_stats``: within rtol 1e-5
  (of each array's largest magnitude) of the JAX package's, identical to
  the port's unsharded statistics;
- ``DiffEstimator`` tables, ``pipelines.render`` y4m and
  ``pipelines.diff`` table files: identical with and without shards.
"""

import numpy as np
import pytest
import torch

from grav1synth_tpu import pipelines as jax_pipelines
from grav1synth_tpu.ops import diff_estimate as jd
from grav1synth_tpu.ops import grain_jax
from grav1synth_tpu.parallel import mesh as jax_mesh
from grav1synth_tpu_torch import cli as torch_cli
from grav1synth_tpu_torch import pipelines
from grav1synth_tpu_torch.ops import diff_estimate as td
from grav1synth_tpu_torch.ops import grain as tg
from grav1synth_tpu_torch.parallel import (
    DeviceMesh,
    frame_shards,
    make_mesh,
    pad_batch,
    sharded_apply,
    sharded_apply_with_stats,
)

from test_render import _grainy_ivf
from test_torch_cuda import pattern_zoo
from test_torch_diff import _close, _scene_change_clip, _segments, _stats_inputs, _write_pair

CPU8 = DeviceMesh(["cpu"] * 8)
CPU4 = DeviceMesh(["cpu"] * 4)


@pytest.mark.parametrize("b,n", [(5, 8), (8, 8), (9, 4), (3, 1)])
def test_pad_batch_equals_jax(b, n):
    rng = np.random.default_rng(b * 10 + n)
    planes = [rng.integers(0, 256, (b, 4, 6)).astype(np.int16) for _ in range(3)]
    params = pattern_zoo(b, n=b)
    mine = pad_batch(planes, params, n)
    theirs = jax_mesh.pad_batch(planes, params, n)
    assert mine[2] == theirs[2] == b and mine[1] == theirs[1]
    assert len(mine[1]) % n == 0
    for m, t in zip(mine[0], theirs[0]):
        assert np.array_equal(m, t)


@pytest.mark.parametrize("n_frames,n_shards", [(100, 8), (7, 3), (3, 5), (16, 4)])
def test_frame_shards_equal_jax(n_frames, n_shards):
    assert frame_shards(n_frames, n_shards) == jax_mesh.frame_shards(n_frames, n_shards)


def _planes(b, mono, seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 1024, (b, 64, 64)).astype(np.int16)
    if mono:
        return y, None, None
    return y, *(rng.integers(0, 1024, (b, 32, 32)).astype(np.int16) for _ in range(2))


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("mono", [False, True], ids=["420", "mono"])
def test_sharded_apply_matches_jax_and_unsharded(mono):
    params = pattern_zoo(61 + mono)
    y, cb, cr = _planes(len(params), mono, seed=3)
    jb = grain_jax.pack_params(params)
    pb = tg.from_jax_params(jb, "cpu")
    got = sharded_apply_with_stats(CPU8, _t(y), _t(cb), _t(cr), pb, 10, monochrome=mono)
    want = jax_mesh.sharded_apply_with_stats(
        jax_mesh.make_mesh(), y, cb, cr, jb, 10, monochrome=mono
    )
    alone = tg.apply_grain(_t(y), _t(cb), _t(cr), pb, 10, monochrome=mono)
    nplanes = 1 if mono else 3
    assert all(g is None for g in got[nplanes:3])
    for k in range(nplanes):
        assert np.array_equal(got[k].numpy(), np.asarray(want[k]).astype(np.int16)), k
        assert torch.equal(got[k], alone[k]), k
    energy, frames = got[3], got[4]
    assert frames.dtype == torch.int64 and int(frames) == float(want[4]) == len(params)
    d = alone[0].to(torch.int64) - torch.from_numpy(y).to(torch.int64)
    assert energy.dtype == torch.float64 and float(energy) == float((d * d).sum())
    assert abs(float(energy) - float(want[3])) <= 1e-5 * float(energy)
    # four shards of two frames each: the same planes
    four = sharded_apply(CPU4, _t(y), _t(cb), _t(cr), pb, 10, monochrome=mono)
    for k in range(nplanes):
        assert torch.equal(four[k], alone[k]), k


def test_sharded_apply_needs_a_batch_that_divides():
    params = pattern_zoo(3, n=5)
    y, cb, cr = _planes(5, False, seed=1)
    with pytest.raises(ValueError, match="pad_batch"):
        sharded_apply(CPU4, _t(y), _t(cb), _t(cr), tg.pack_params(params, "cpu"), 10)


def test_meshes():
    assert CPU4 == tuple(torch.device("cpu") for _ in range(4))
    with pytest.raises(ValueError, match="at least one device"):
        DeviceMesh([])
    cpu = torch.device("cpu")
    assert pipelines.device_mesh(cpu, 1) is None
    assert pipelines.device_mesh(cpu, 3) == DeviceMesh([cpu] * 3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


def _stats_batch():
    """(sy, dy, sc, dc, sr, dr) of 8 frame pairs, 64x64 10-bit 4:2:0
    (``_stats_inputs`` makes two pairs per seed)."""
    chunks = [_stats_inputs(seed, 1, 1, 10, np.int16, 64, 64) for seed in range(1, 5)]
    return [np.concatenate(parts) for parts in zip(*chunks)]


def test_mesh_pair_stats_per_frame_matches_jax_and_unsharded():
    planes = _stats_batch()
    kw = dict(lag=2, bit_depth=10, sub_x=1, sub_y=1, has_chroma=True)
    got = td.mesh_pair_stats_per_frame(CPU8, *planes, **kw)
    alone = td.batch_pair_stats_per_frame(*(torch.from_numpy(a) for a in planes), **kw)
    want = jd.mesh_pair_stats_per_frame(jax_mesh.make_mesh(), *planes, *kw.values())
    for name, g, a, w in zip(("y", "cb", "cr"), got, alone, want):
        assert set(g) == set(a)
        for k in a:
            assert torch.equal(g[k], a[k]), (name, k)
        _close(g, {k: np.asarray(v) for k, v in w.items()}, f"jax {name}")
    luma = td.mesh_pair_stats_per_frame(CPU4, *planes[:2], None, None, None, None,
                                        **{**kw, "has_chroma": False})
    assert luma[1] is None and luma[2] is None
    for k in alone[0]:
        assert torch.equal(luma[0][k], alone[0][k]), k


def test_sharded_diff_stats_matches_jax_and_unsharded():
    sy, dy, sc, dc, sr, dr = _stats_batch()
    got = td.sharded_diff_stats(CPU8, [sy, sc, sr], [dy, dc, dr], 2, 10)
    alone = td.batch_pair_stats_per_frame(
        *(torch.from_numpy(a) for a in (sy, dy, sc, dc, sr, dr)),
        lag=2, bit_depth=10, sub_x=1, sub_y=1, has_chroma=True,
    )
    want = jd.sharded_diff_stats(jax_mesh.make_mesh(), [sy, sc, sr], [dy, dc, dr], 2, 10)
    for name, g, a, w in zip(("y", "cb", "cr"), got, alone, want):
        assert set(g) == set(a)
        for k in a:
            assert g[k].dtype == np.float64
            assert np.array_equal(g[k], a[k].sum(0).numpy()), (name, k)
        _close({k: torch.from_numpy(v) for k, v in g.items()},
               {k: np.asarray(v) for k, v in w.items()}, f"jax {name}")
    luma = td.sharded_diff_stats(CPU4, [sy], [dy], 2, 10)
    assert luma[1] is None and luma[2] is None
    for k in alone[0]:
        assert np.array_equal(luma[0][k], alone[0][k].sum(0).numpy()), k


def test_diff_batch_tables_with_a_mesh_equal_without():
    """Batches of 6 over a 4-entry mesh (each padded to 8) and over an
    8-entry one: the same table as unsharded, and as the JAX package's."""
    grainy, clean = _scene_change_clip()
    kw = dict(chunk_frames=9, min_chunk_frames=4, sigma_jump=0.25)

    def batched(est, mesh):
        for i in range(0, len(grainy), 6):
            est.diff_batch(
                [list(f) for f in grainy[i : i + 6]], [list(f) for f in clean[i : i + 6]],
                mesh=mesh,
            )
        return _segments(est.finish())

    alone = batched(td.DiffEstimator((24, 1), device="cpu", **kw), None)
    assert len(alone) >= 2
    for mesh in (CPU4, CPU8):
        assert batched(td.DiffEstimator((24, 1), device="cpu", **kw), mesh) == alone
    theirs = batched(jd.DiffEstimator((24, 1), **kw), jax_mesh.make_mesh(4))
    assert theirs == alone


def test_render_sharded_matches_jax_and_one_shard(tmp_path):
    """render --shards 8 (batch 5 on 8 shards: padding) is byte-identical
    to the JAX package's render --shards 8 and to one shard; the CLI's
    --shards reaches it."""
    path, _ = _grainy_ivf(tmp_path, 96, 66, 8, False, 7, "")
    outs = {}
    for name, fn, kw in (
        ("one", pipelines.render, dict(device="cpu")),
        ("eight", pipelines.render, dict(shards=8, device="cpu")),
        ("jax8", jax_pipelines.render, dict(shards=8)),
    ):
        out = tmp_path / f"{name}.y4m"
        assert fn(path, str(out), batch=5, progress=False, **kw) == 7
        outs[name] = out.read_bytes()
    assert outs["eight"] == outs["one"] == outs["jax8"]
    cli_out = tmp_path / "cli.y4m"
    assert torch_cli.main(
        ["render", path, "-o", str(cli_out), "--batch", "3", "--shards", "2",
         "--device", "cpu", "-y"]
    ) == 0
    assert cli_out.read_bytes() == outs["one"]


def test_pipeline_diff_sharded_identical(tmp_path):
    src, den = _write_pair(tmp_path, 128, 128, 8, 12, seed=3)
    one, eight = tmp_path / "one.tbl", tmp_path / "eight.tbl"
    pipelines.diff(src, den, str(one), progress=False, device="cpu")
    pipelines.diff(src, den, str(eight), progress=False, batch=5, shards=8, device="cpu")
    assert one.read_text().startswith("filmgrn1")
    assert eight.read_bytes() == one.read_bytes()
