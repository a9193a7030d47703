"""The PyTorch port's render against ``grav1synth_tpu render`` and
dav1d's own grain-on decode, on the CPU (the plain PyTorch path,
``--device cpu``): the y4m must be byte-identical to the JAX package's
and every sample equal to dav1d's. Also: the port's CLI, and that the
port never imports JAX."""

import logging
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from grav1synth_tpu import pipelines as jax_pipelines
from grav1synth_tpu.container.y4m import read_y4m
from grav1synth_tpu_torch import cli as torch_cli
from grav1synth_tpu_torch import pipelines
from grav1synth_tpu_torch.utils import spans

from test_render import _dav1d_frames, _grainy_ivf

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_IVF = os.path.join(REPO, ".bench_cache", "bench_4k10_grainy.ivf")

CASES = [
    # (name, w, h, bd, mono, n, opts)
    ("8bit", 96, 66, 8, False, 5, ""),
    ("10bit-odd", 97, 65, 10, False, 4, ""),
    ("mono", 64, 64, 8, True, 4, ""),
]


@pytest.mark.parametrize("name,w,h,bd,mono,n,opts", CASES, ids=[c[0] for c in CASES])
def test_render_matches_jax_and_dav1d(tmp_path, name, w, h, bd, mono, n, opts):
    path, datas = _grainy_ivf(tmp_path, w, h, bd, mono, n, opts)
    mine = tmp_path / "torch.y4m"
    theirs = tmp_path / "jax.y4m"
    assert pipelines.render(path, str(mine), batch=3, progress=False, device="cpu") == n
    jax_pipelines.render(path, str(theirs), batch=3, progress=False)
    assert mine.read_bytes() == theirs.read_bytes()

    frames, _, rbd, _, rmono = read_y4m(str(mine))
    oracle = _dav1d_frames(datas, True)
    assert rbd == bd and rmono == mono and len(frames) == len(oracle) == n
    for got, want in zip(frames, oracle):
        for pi in range(1 if mono else 3):
            assert (got[pi].astype(np.int64) == want.planes[pi].astype(np.int64)).all()


def test_render_no_grain_matches_clean_decode(tmp_path):
    path, datas = _grainy_ivf(tmp_path, 96, 66, 8, False, 4, "")
    out = str(tmp_path / "clean.y4m")
    pipelines.render(path, out, grain=False, progress=False, device="cpu")
    frames, *_ = read_y4m(out)
    clean = _dav1d_frames(datas, False)
    assert len(frames) == len(clean) == 4
    for got, want in zip(frames, clean):
        for pi in range(3):
            assert (got[pi] == want.planes[pi]).all()


@pytest.mark.parametrize("strided", [False, True], ids=["contiguous", "strided"])
@pytest.mark.parametrize("dtype,bd", [(np.uint8, 8), (np.uint16, 10), (np.uint16, 12)],
                         ids=["8bit", "10bit", "12bit"])
def test_upload_equals_the_stacked_cast(dtype, bd, strided):
    """``_upload``'s one pass gives, sample for sample, the int16 stack of
    the planes, the depth's ends included; a strided plane (a decoder's
    rows inside a wider buffer) goes in as it is."""
    rng = np.random.default_rng(bd)
    h, w = 33, 47
    wide = rng.integers(0, 1 << bd, (4, h, w + 13 if strided else w), dtype=dtype)
    planes = [f[:, 5 : 5 + w] if strided else f for f in wide]
    planes[0][0, :2] = (0, (1 << bd) - 1)
    assert all(p.flags.c_contiguous != strided for p in planes)
    got = pipelines._upload(planes, torch.device("cpu"))
    assert got.dtype == torch.int16
    assert torch.equal(got, torch.from_numpy(np.stack(planes).astype(np.int16)))


def test_render_stage_stats(tmp_path, caplog):
    """render's stages are spans: with the spans logger at DEBUG each is
    summed, and render logs the summary at its end."""
    path, _ = _grainy_ivf(tmp_path, 96, 66, 8, False, 6, "")
    spans.reset()
    with caplog.at_level(logging.DEBUG, logger="spans"):
        n = pipelines.render(path, str(tmp_path / "s.y4m"), batch=3, progress=False, device="cpu")
    assert n == 6
    got = spans.snapshot()["spans"]
    stages = {k: got[k]["count"] for k in got if k.startswith("render.")}
    # six frames and the decoder's end; two batches of three
    assert stages == {"render.decode": 7, "render.dispatch": 2, "render.download": 2,
                      "render.mux": 2}
    assert got["render.dispatch"]["total_ms"] > 0 and got["render.mux"]["total_ms"] > 0
    # the dispatch holds the upload, the parameters and the launches
    assert got["upload.stack"]["count"] == got["upload.pin"]["count"] == 6
    assert got["grain.pack"]["count"] == got["program.replay"]["count"] == 2
    assert got["render.dispatch"]["self_ms"] < got["render.dispatch"]["total_ms"]
    assert "render.dispatch" in caplog.text and "upload.stack" in caplog.text


def test_render_refuses_what_is_not_ported(tmp_path):
    """--shards runs (tests/test_torch_parallel.py holds it to the JAX
    package); a CUDA device that is missing is refused, not replaced."""
    path, _ = _grainy_ivf(tmp_path, 64, 64, 8, False, 2, "")
    one, two = tmp_path / "one.y4m", tmp_path / "two.y4m"
    assert pipelines.render(path, str(one), progress=False, device="cpu") == 2
    assert pipelines.render(path, str(two), progress=False, shards=2, device="cpu") == 2
    assert two.read_bytes() == one.read_bytes()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pipelines.render(path, str(tmp_path / "o.y4m"), device="cuda")


def test_cli(tmp_path, capsys):
    path, _ = _grainy_ivf(tmp_path, 64, 64, 8, False, 3, "")
    out = tmp_path / "o.y4m"
    assert torch_cli.main(
        ["render", path, "-o", str(out), "--batch", "2", "--device", "cpu", "-y"]
    ) == 0
    assert len(read_y4m(str(out))[0]) == 3
    # host subcommands run in the port (tests/test_torch_host.py holds
    # them to the JAX package byte for byte)
    table = tmp_path / "t.txt"
    assert torch_cli.main(["inspect", path, "-o", str(table), "-y"]) == 0
    assert table.read_text().startswith("filmgrn1")
    # diff runs on the port (the two inputs are the same content in two
    # files: the guards refuse one path given twice)
    (tmp_path / "b").mkdir()
    other, _ = _grainy_ivf(tmp_path / "b", 64, 64, 8, False, 3, "")
    diff_out = tmp_path / "d.txt"
    assert torch_cli.main(
        ["diff", path, other, "-o", str(diff_out), "--batch", "2", "--device", "cpu"]
    ) == 0
    assert diff_out.read_text().startswith("filmgrn1")
    for argv in (
        ["diff", path, path, "-o", str(tmp_path / "e.txt")],
        ["diff", path, other, "-o", other],
        ["diff", path, other, "-o", str(diff_out), "--device", "cpu"],  # exists, no -y
    ):
        with pytest.raises(SystemExit):
            torch_cli.main(argv)
    # estimate runs on the port too, with the JAX CLI's guards
    est_out, raw = tmp_path / "e.tbl", tmp_path / "e.raw"
    assert torch_cli.main(
        ["estimate", path, "-o", str(est_out), "--raw", str(raw), "--device", "cpu"]
    ) == 0
    assert est_out.read_text().startswith("filmgrn1")
    assert len(raw.read_text().splitlines()) == 3
    for argv in (
        ["estimate", path, "-o", path, "-y"],
        ["estimate", path, "-o", str(tmp_path / "f.tbl"), "--raw", path, "-y"],
        ["estimate", path, "-o", str(est_out), "--device", "cpu"],  # exists, no -y
    ):
        with pytest.raises(SystemExit):
            torch_cli.main(argv)


def test_port_never_imports_jax(tmp_path):
    """Imports every module of the port, runs the plain apply, with the
    tables' chroma fact and sharded over a two-entry CPU mesh, the diff
    and estimate statistics, and the host subcommand ``inspect`` through
    the port's CLI, in a fresh interpreter (this test process has JAX
    loaded by conftest): neither jax nor any module of the JAX package
    ``grav1synth_tpu`` is loaded."""
    code = textwrap.dedent(
        """
        import importlib, pkgutil, sys
        import numpy as np, torch
        import grav1synth_tpu_torch
        modules = [m.name for m in pkgutil.walk_packages(
            grav1synth_tpu_torch.__path__, "grav1synth_tpu_torch.")
            if not m.name.endswith(".__main__")]  # importing __main__ runs the CLI
        for name in modules:
            importlib.import_module(name)
        assert "grav1synth_tpu_torch.container.ffshim" in modules, modules
        assert "grav1synth_tpu_torch.parallel.host_shard" in modules, modules
        from grav1synth_tpu_torch import cli
        from grav1synth_tpu_torch.ops import diff_estimate, estimate, grain
        from grav1synth_tpu_torch.parallel import DeviceMesh, sharded_apply_with_stats
        from grav1synth_tpu_torch.obu.types import FilmGrainParams
        p = FilmGrainParams(grain_seed=7, scaling_points_y=[(0, 20), (255, 40)],
                            scaling_points_cb=[(0, 10), (255, 12)], cb_mult=128,
                            cb_luma_mult=192, cb_offset=256, overlap_flag=True)
        y = torch.full((1, 40, 40), 100, dtype=torch.int16)
        c = torch.full((1, 20, 20), 128, dtype=torch.int16)
        out = grain.apply_grain(y, c, c.clone(), grain.pack_params([p], "cpu"), 8)
        assert out[0].shape == y.shape and not torch.equal(out[0], y)
        pb = grain.pack_params([p, p], "cpu")
        y2, c2 = y.repeat(2, 1, 1), c.repeat(2, 1, 1)
        sharded = sharded_apply_with_stats(DeviceMesh(["cpu", "cpu"]), y2, c2, c2.clone(), pb, 8)
        assert torch.equal(sharded[0], grain.apply_grain(y2, c2, c2.clone(), pb, 8)[0])
        est = diff_estimate.DiffEstimator((24, 1), device="cpu")
        est.diff_batch([[np.full((40, 40), 9, np.uint8)]], [[np.full((40, 40), 8, np.uint8)]])
        assert est.finish() == []
        ne = estimate.NoiseEstimator((24, 1), device="cpu")
        ne.push_batch([np.full((40, 40), 9, np.uint8)])
        assert ne.per_frame_sigma == [0.0] and ne.finish() == []
        table = sys.argv[2]
        assert cli.main(["inspect", sys.argv[1], "-o", table, "-y"]) == 0
        assert open(table).read().startswith("filmgrn1")
        assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
        jax_package = sorted(
            m for m in sys.modules if m == "grav1synth_tpu" or m.startswith("grav1synth_tpu.")
        )
        assert not jax_package, jax_package
        print("ok")
        """
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO
    res = subprocess.run(
        [sys.executable, "-c", code, BENCH_IVF, str(tmp_path / "t.txt")],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "ok"
