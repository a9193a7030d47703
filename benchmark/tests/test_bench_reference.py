"""The benchmark's reference against the port's plain CPU path on tiny
frames of each path, and its frozen copies against their originals; the
reference imports nothing of the port or of JAX."""

import ast
import glob
import os
import sys

import numpy as np
import pytest

import harness
import inputs
from conftest import BENCH
from reference import fit, grain_ref, stats
from reference.types import FilmGrainParams as RefParams

CFG = {"width": 100, "height": 70, "planes": 3, "subsampling": [1, 1],
       "grain": {"y_points": 4, "cb_points": 2, "cr_points": 2, "ar_lag": 2, "overlap": True,
                 "chroma_scaling_from_luma": False, "clip_to_restricted_range": False}}


def frames(bd, n=3, grainy=True):
    cfg = dict(CFG, bit_depth=bd)
    clean = inputs.film_frames(2**31 + 3, n, cfg, "cpu")
    return clean, inputs.grainy(2**31 + 3, clean, cfg) if grainy else None


@pytest.mark.parametrize("bd", [8, 10])
def test_apply_reference_equals_the_port(bd):
    from grav1synth_tpu_torch.obu.types import FilmGrainParams
    from grav1synth_tpu_torch.ops import grain

    clean, _ = frames(bd, grainy=False)
    tables = inputs.draw_tables(7, dict(CFG["grain"], ar_lag=3), 3)
    p = grain.pack_params([FilmGrainParams(**t) for t in tables], "cpu")
    out = grain.apply_grain(*clean, p, bd, 1, 1, False)
    for i, t in enumerate(tables):
        want = grain_ref.apply_grain_frame([c[i].numpy().astype(np.int32) for c in clean],
                                           RefParams(**t), bd, 1, 1)
        for got, w in zip(out, want):
            np.testing.assert_array_equal(got[i].numpy().astype(np.int32), w.astype(np.int32))


def test_frozen_grain_ref_equals_the_original():
    from grav1synth_tpu_torch.obu.types import FilmGrainParams
    from grav1synth_tpu_torch.ops import grain_ref as original

    clean, _ = frames(10, n=1, grainy=False)
    t = inputs.draw_tables(11, CFG["grain"], 1)[0]
    planes = [c[0].numpy().astype(np.int32) for c in clean]
    for a, b in zip(grain_ref.apply_grain_frame(planes, RefParams(**t), 10, 1, 1),
                    original.apply_grain_frame(planes, FilmGrainParams(**t), 10, 1, 1)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bd", [8, 10])
def test_diff_statistics_equal_the_port(bd):
    from grav1synth_tpu_torch.ops import diff_estimate as de

    clean, noisy = frames(bd)
    got = de.batch_pair_stats_per_frame(noisy[0], clean[0], noisy[1], clean[1], noisy[2], clean[2],
                                        lag=2, bit_depth=bd, sub_x=1, sub_y=1, has_chroma=True)
    for i in range(clean[0].shape[0]):
        want = stats.pair_stats([p[i] for p in noisy], [p[i] for p in clean], 2, bd)
        for g, w in zip(got, want):
            for k in w:
                np.testing.assert_array_equal(g[k][i].numpy(), w[k])


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("lag", [1, 2, 3])
def test_estimate_statistics_equal_the_port(bd, lag):
    from grav1synth_tpu_torch.ops import estimate as es

    _, noisy = frames(bd)
    y, cb, _ = noisy
    got_y = es.batch_self_stats(y, lag, bd)
    got_c = es.batch_self_stats_chroma(cb, y, lag, bd, 1, 1)
    for i in range(y.shape[0]):
        want = stats.self_stats([p[i] for p in noisy], lag, bd)
        for g, w in ((got_y, want[0]), (got_c, want[1])):
            for k in w:
                np.testing.assert_array_equal(g[k][i].numpy(), w[k])


def test_frozen_fit_equals_the_estimators():
    """The frozen fit, chunking and calibration give the port's tables on
    the same frames."""
    from grav1synth_tpu_torch.ops.diff_estimate import DiffEstimator
    from grav1synth_tpu_torch.ops.estimate import NoiseEstimator

    cfg = dict(CFG, width=256, height=160, bit_depth=10)
    clean = inputs.film_frames(5, 6, cfg, "cpu")
    noisy = inputs.grainy(5, clean, cfg)
    host_n, host_c = inputs.to_host(noisy, 10), inputs.to_host(clean, 10)
    est = NoiseEstimator((24, 1), 10, device="cpu")
    est.push_batch(host_n)
    dif = DiffEstimator((24, 1), 10, 10, chunk_frames=4, device="cpu")
    dif.diff_batch(host_n, host_c)

    def push(fr, bd, lag):
        return stats.self_stats_frames(fr, bd, lag)

    ref = fit.NoiseChunk((24, 1), 10, 12, push)
    chunks = fit.DiffChunks((24, 1), 10, 2, 12, chunk_frames=4)
    for f, c in zip(host_n, host_c):
        ref._ingest(*stats.self_stats([stats.as_tensor(p, "cpu") for p in f], 2, 10))
        chunks.add_frame(*stats.pair_stats([stats.as_tensor(p, "cpu") for p in f],
                                           [stats.as_tensor(p, "cpu") for p in c], 2, 10))
    assert ref.per_frame_sigma == est.per_frame_sigma
    for got, want in ((est.finish(), ref.finish()), (dif.finish(), chunks.finish())):
        assert len(got) == len(want) and got
        for a, b in zip(got, want):
            assert (a.start_time, a.end_time) == (b.start_time, b.end_time)
            assert all(getattr(a.params, f) == getattr(b.params, f) for f in vars(b.params))


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(
    glob.glob(os.path.join(BENCH, "*.py")) + glob.glob(os.path.join(BENCH, "*", "*.py"))))
def test_sources_import_no_jax_and_only_drivers_the_port(path):
    mods = set(_imports(path))
    assert not mods & set(harness.FORBIDDEN)
    rel = os.path.relpath(path, BENCH)
    if not (rel.startswith("paths" + os.sep) or rel.startswith("tests" + os.sep)):
        assert "grav1synth_tpu_torch" not in mods, rel


def test_forbidden_modules_compare_whole_names(monkeypatch):
    import grav1synth_tpu_torch  # noqa: F401  (begins with the JAX package's name)

    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "grav1synth_tpu.ops", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert harness.forbidden_modules() == ["grav1synth_tpu", "jaxlib"]
