"""The PyTorch port's own copy of the host layer against the JAX
package's, on the CPU: the CLI's host subcommands write byte-identical
files, and grain_ref, the native pattern generator, photon noise and the
grain-table codec give the same results."""

import dataclasses
import json
import os

import numpy as np
import pytest

from av1_builder import (
    MiniSeqConfig,
    build_frame,
    build_sequence_header,
    build_temporal_delimiter,
    default_ivf_header,
    sample_grain_params,
)
from grav1synth_tpu import cli as jax_cli
from grav1synth_tpu.container import ffshim as jax_ffshim
from grav1synth_tpu.container.ffshim import Encoder
from grav1synth_tpu.container.ivf import IvfHeader, IvfPacket, write_ivf
from grav1synth_tpu.obu import GrainTableSegment
from grav1synth_tpu.obu.types import FrameType
from grav1synth_tpu.ops import grain_ref as jax_grain_ref
from grav1synth_tpu.ops import photon_noise as jax_photon_noise
from grav1synth_tpu.tables import dump_table as jax_dump_table
from grav1synth_tpu.tables import load_table as jax_load_table
from grav1synth_tpu_torch import cli as torch_cli
from grav1synth_tpu_torch import tables as torch_tables
from grav1synth_tpu_torch.container import ffshim as torch_ffshim
from grav1synth_tpu_torch.ops import grain_ref as torch_grain_ref
from grav1synth_tpu_torch.ops import photon_noise as torch_photon_noise

from test_photon_noise import GOLDEN, MATRIX, _key
from test_torch_cuda import pattern_zoo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_IVF = os.path.join(REPO, ".bench_cache", "bench_4k10_grainy.ivf")


def _builder_ivf(path):
    """A parsed-only stream from tests/av1_builder.py: 12 frames with grain
    headers, a keyframe with a sequence header every 4 (three GOPs for
    --shards)."""
    cfg = MiniSeqConfig(film_grain_params_present=True)
    packets = []
    for i in range(12):
        key = i % 4 == 0
        data = build_temporal_delimiter() + (build_sequence_header(cfg) if key else b"")
        data += build_frame(
            cfg, FrameType.KEY if key else FrameType.INTER, grain=sample_grain_params(seed=100 + i)
        )
        packets.append(IvfPacket(pts=i, data=data))
    write_ivf(str(path), default_ivf_header(cfg, len(packets)), packets)


def _encoded_ivf(path, tmp):
    """24 libaom frames with a keyframe every 6, grained by the JAX CLI's
    apply (a decodable stream with grain headers)."""
    rng = np.random.default_rng(7)
    frames = []
    for _ in range(24):
        y = rng.integers(0, 255, (64, 64)).astype(np.uint8)
        u = np.full((32, 32), 128, np.uint8)
        frames.append((y, u, u.copy()))
    enc = Encoder(64, 64, 8, extra_opts="g=6:keyint_min=6")
    pkts = enc.encode_frames(frames)
    enc.close()
    clean = tmp / "clean.ivf"
    write_ivf(
        str(clean),
        IvfHeader(width=64, height=64, timebase_den=24, timebase_num=1),
        [IvfPacket(p.pts, p.data) for p in pkts],
    )
    tbl = tmp / "grain.tbl"
    jax_dump_table([GrainTableSegment(0, 10**14, sample_grain_params(seed=5))], str(tbl))
    assert jax_cli.main(["apply", str(clean), "-o", str(path), "-g", str(tbl), "-y"]) == 0


@pytest.fixture(scope="module")
def streams(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("host")
    out = {"builder": tmp / "builder.ivf", "encoded": tmp / "encoded.ivf", "bench": BENCH_IVF}
    _builder_ivf(out["builder"])
    _encoded_ivf(out["encoded"], tmp)
    # a two-segment table for apply (a segment boundary inside the stream)
    mid = -(-12 * 10_000_000 // 24)
    out["table"] = tmp / "apply.tbl"
    jax_dump_table(
        [GrainTableSegment(0, mid, sample_grain_params(seed=5)),
         GrainTableSegment(mid, 10**14, sample_grain_params(seed=901))],
        str(out["table"]),
    )
    return {k: str(v) for k, v in out.items()}


COMMANDS = [
    # (name, argv after the input, with {out} and {table} filled in)
    ("inspect", ["-o", "{out}"]),
    ("inspect-shards2", ["-o", "{out}", "--shards", "2"]),
    ("apply", ["-o", "{out}", "-g", "{table}"]),
    ("apply-shards2", ["-o", "{out}", "-g", "{table}", "--shards", "2"]),
    ("remove", ["-o", "{out}"]),
    ("remove-shards2", ["-o", "{out}", "--shards", "2"]),
    ("generate", ["-o", "{out}", "--iso", "1600"]),
    ("generate-chroma", ["-o", "{out}", "--iso", "800", "--chroma"]),
]


@pytest.mark.parametrize("stream", ["builder", "encoded", "bench"])
@pytest.mark.parametrize("name,args", COMMANDS, ids=[c[0] for c in COMMANDS])
def test_cli_host_subcommands_byte_identical(tmp_path, streams, stream, name, args):
    outs = {}
    for pkg, main in (("jax", jax_cli.main), ("torch", torch_cli.main)):
        out = tmp_path / f"{pkg}.out"
        argv = [name.split("-")[0], streams[stream]] + [
            a.format(out=out, table=streams["table"]) for a in args
        ]
        assert main(argv + ["-y"]) == 0, pkg
        outs[pkg] = out.read_bytes()
    assert outs["torch"] == outs["jax"]
    assert outs["torch"]


@pytest.mark.parametrize("monochrome", [False, True], ids=["color", "mono"])
@pytest.mark.parametrize("bd,sub_x,sub_y", [(8, 1, 1), (10, 1, 0), (12, 0, 0)])
def test_grain_ref_apply_grain_frame_equal_to_original(bd, sub_x, sub_y, monochrome):
    rng = np.random.default_rng(bd + 3 * sub_y)
    h, w = 41, 77
    hc, wc = (h + sub_y) >> sub_y, (w + sub_x) >> sub_x
    maxv = (1 << bd) - 1
    shapes = [(h, w)] if monochrome else [(h, w), (hc, wc), (hc, wc)]
    for p in pattern_zoo(bd, 5):
        planes = [rng.integers(0, maxv + 1, s).astype(np.int32) for s in shapes]
        want = jax_grain_ref.apply_grain_frame(planes, p, bd, sub_x, sub_y)
        got = torch_grain_ref.apply_grain_frame(planes, p, bd, sub_x, sub_y)
        assert len(got) == len(want)
        for g, wnt in zip(got, want):
            assert g.dtype == wnt.dtype and np.array_equal(g, wnt)


@pytest.mark.parametrize("monochrome", [False, True], ids=["color", "mono"])
@pytest.mark.parametrize("bd,sub_x,sub_y", [(8, 1, 1), (10, 1, 0), (12, 0, 0)])
def test_generate_patterns_native_equal_to_original(bd, sub_x, sub_y, monochrome):
    params = pattern_zoo(50 + bd)
    want = jax_ffshim.generate_patterns_native(params, bd, sub_x, sub_y, monochrome)
    got = torch_ffshim.generate_patterns_native(params, bd, sub_x, sub_y, monochrome)
    assert [g is None for g in got] == [w is None for w in want]
    for g, wnt in zip(got, want):
        if wnt is not None:
            assert g.dtype == wnt.dtype and np.array_equal(g, wnt)


def test_native_shims_are_separate_builds():
    """Each package builds and loads its own copy of the libav* shim."""
    assert torch_ffshim._SO_PATH != jax_ffshim._SO_PATH
    assert os.path.dirname(torch_ffshim._SO_PATH).startswith(
        os.path.join(REPO, "grav1synth_tpu_torch")
    )
    assert torch_ffshim.load_native() is not jax_ffshim.load_native()
    assert os.path.exists(torch_ffshim._SO_PATH)


def test_photon_noise_matches_golden():
    with open(GOLDEN) as fh:
        golden = json.load(fh)
    for iso, w, h, tf, fr in MATRIX:
        p = torch_photon_noise.generate_photon_noise_params(iso, w, h, tf, chroma=True, full_range=fr)
        key = _key(iso, w, h, tf, fr)
        assert golden[key]["y"] == [list(pt) for pt in p.scaling_points_y], key
        assert golden[key]["uv"] == [list(pt) for pt in p.scaling_points_cb], key
        assert p.scaling_points_cb == p.scaling_points_cr


@pytest.mark.parametrize("chroma", [False, True], ids=["luma", "chroma"])
def test_photon_noise_segment_equal_to_original(chroma):
    for iso, w, h, tf, fr in MATRIX:
        want = jax_photon_noise.photon_noise_segment(iso, w, h, tf, chroma, fr)
        got = torch_photon_noise.photon_noise_segment(iso, w, h, tf, chroma, fr)
        assert (got.start_time, got.end_time) == (want.start_time, want.end_time)
        assert dataclasses.astuple(got.params) == dataclasses.astuple(want.params)


def _tables():
    """Grain tables to round-trip: two film segments, a photon-noise one,
    and a luma-only one with chroma scaling from luma."""
    csfl = dataclasses.replace(
        sample_grain_params(seed=3), scaling_points_cb=[], scaling_points_cr=[],
        chroma_scaling_from_luma=True, clip_to_restricted_range=True,
    )
    return {
        "film": [GrainTableSegment(0, 5_000_000, sample_grain_params(seed=1)),
                 GrainTableSegment(5_000_000, 10**13, sample_grain_params(seed=2))],
        "photon": [jax_photon_noise.photon_noise_segment(1600, 3840, 2160, "smpte2084", True, False)],
        "csfl": [GrainTableSegment(0, 10**13, csfl)],
    }


@pytest.mark.parametrize("which", ["film", "photon", "csfl"])
def test_table_round_trips_identical(tmp_path, which):
    segs = _tables()[which]
    theirs, mine, again = (tmp_path / n for n in ("jax.tbl", "torch.tbl", "again.tbl"))
    jax_dump_table(segs, str(theirs))
    torch_tables.dump_table(segs, str(mine))
    assert mine.read_bytes() == theirs.read_bytes()
    loaded = torch_tables.load_table(str(theirs))
    want = jax_load_table(str(theirs))
    assert [(s.start_time, s.end_time, dataclasses.astuple(s.params)) for s in loaded] == [
        (s.start_time, s.end_time, dataclasses.astuple(s.params)) for s in want
    ]
    torch_tables.dump_table(loaded, str(again))
    assert again.read_bytes() == theirs.read_bytes()

