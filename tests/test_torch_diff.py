"""The PyTorch port's diff path against the JAX package's, on the CPU.

Each kernel wrapper runs its plain PyTorch version on CPU tensors. Held
to the JAX package with the tolerances it holds itself to:

- ``flat_blocks``: identical to ``diff_pallas.pallas_flat_blocks``
  (interpret mode) and to ``diff_estimate._flat_blocks_batch``;
- per-frame statistics: within rtol 1e-5 (of each array's largest
  magnitude) of ``batch_pair_stats_per_frame`` with ``backend="pallas"``
  and with ``backend="xla"``, the bar tests/test_diff_quality.py sets
  between those two;
- the copied host fit: equal to the JAX package's on the same statistics;
- ``DiffEstimator`` tables and ``pipelines.diff`` table files: identical.

The CUDA kernels are held against the plain versions, to the last bit, by
tests/test_torch_cuda.py (skipped without a GPU) and ``chip_smoke.py``.
"""

import dataclasses
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grav1synth_tpu import pipelines as jax_pipelines
from grav1synth_tpu.container.ffshim import Encoder
from grav1synth_tpu.container.ivf import IvfHeader, IvfPacket, write_ivf
from grav1synth_tpu.ops import diff_estimate as jd
from grav1synth_tpu.ops import diff_pallas
from grav1synth_tpu_torch import pipelines
from grav1synth_tpu_torch.ops import diff_estimate as td
from grav1synth_tpu_torch.ops import diff_kernels as dk
from grav1synth_tpu_torch.utils import spans

from test_diff_quality import film_like_clip, film_params, inject_grain
from test_torch_cuda import EXTREME_CASES, extreme_stats_inputs, tall_stats_inputs


def _denoised(rng, b, h, w, bd):
    """Flat on the upper half, random below: both sides of the median."""
    maxv = (1 << bd) - 1
    d = rng.integers(0, maxv + 1, (b, h, w))
    d[:, : h // 2] = maxv // 3 + rng.integers(0, 3, (b, h // 2, w))
    return d


@pytest.mark.parametrize(
    "b,h,w,bd,dtype",
    [
        (2, 150, 260, 10, np.int16),
        (1, 64, 64, 8, np.uint8),
        (2, 33, 47, 12, np.int16),
        (1, 16, 16, 8, np.uint8),
        (2, 40, 301, 10, np.int16),
        (2, 12, 40, 8, np.uint8),
    ],
)
def test_flat_blocks_match_jax(b, h, w, bd, dtype):
    d = _denoised(np.random.default_rng(h * w), b, h, w, bd).astype(dtype)
    got = td.flat_blocks(torch.from_numpy(d).to(torch.int16))
    assert got.dtype == torch.uint8 and tuple(got.shape) == (b, h // 16, w // 16)
    if got.numel() == 0:
        return  # the JAX package never builds a map without a full block
    want = np.asarray(jd._flat_blocks_batch(jnp.asarray(d)))
    assert np.array_equal(got.numpy(), want.astype(np.uint8))
    want_p = np.asarray(diff_pallas.pallas_flat_blocks(jnp.asarray(d), 16))
    assert np.array_equal(got.numpy(), want_p.astype(np.uint8))
    if got.numel() >= 4:
        assert 0 < int(got.sum()) < got.numel()  # both sides of the threshold


@pytest.mark.parametrize(
    "h,w,lo,hi",
    [
        (37, 50, 0, 4096),
        (16, 16, -32768, 32768),  # one block, no row or column past it
        (32, 48, -32768, 32768),  # exactly HB * 16 x WB * 16
        (17, 527, -32768, 32768),  # H mod 16 = 1, W mod 16 = 15
        (31, 513, -32768, 32768),  # H mod 16 = 15, W mod 16 = 1
        (48, 536, -32768, 32768),  # W mod 16 = 8
        (33, 519, -32768, -32766),  # W mod 16 = 7, the bottom of the range
        (20, 40, None, None),  # alternating -32768 and 32767: every step 65535
    ],
)
def test_flat_block_activity_plain_is_the_block_sum(h, w, lo, hi):
    """Each full block's sum of |horizontal| + |vertical| steps, a step
    counted where its right or lower sample is inside the plane, against a
    loop over the samples."""
    if lo is None:
        i, j = np.mgrid[0:h, 0:w]
        d = np.stack([np.where((i + j) % 2, -32768, 32767)] * 2).astype(np.int16)
    else:
        d = np.random.default_rng(h * w).integers(lo, hi, (2, h, w)).astype(np.int16)
    got = dk.flat_block_activity(torch.from_numpy(d))
    v = d.astype(np.int64)
    hb, wb = h // 16, w // 16
    want = np.zeros((2, hb, wb), np.int64)
    for bi in range(2):
        for i in range(hb * 16):
            for j in range(wb * 16):
                a = abs(v[bi, i, j + 1] - v[bi, i, j]) if j + 1 < w else 0
                a += abs(v[bi, i + 1, j] - v[bi, i, j]) if i + 1 < h else 0
                want[bi, i // 16, j // 16] += a
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


STATS_CASES = [
    # lag, sub_x, sub_y, bd, dtype, h, w
    (1, 1, 1, 8, np.uint8, 70, 100),
    (2, 1, 1, 10, np.int16, 150, 260),
    (3, 1, 0, 10, np.int16, 64, 96),
    (2, 0, 0, 8, np.uint8, 48, 80),
    (3, 0, 0, 10, np.int16, 40, 56),
    (1, 1, 0, 8, np.int16, 33, 47),
    (2, 1, 1, 8, np.uint8, 12, 40),  # luma under 16 rows: no full block
    (3, 1, 1, 10, np.int16, 30, 64),  # chroma under 16 rows
]


def _stats_inputs(lag, sub_x, sub_y, bd, dtype, h, w):
    rng = np.random.default_rng(lag * 1000 + h)
    maxv = (1 << bd) - 1
    hc, wc = (h + sub_y) >> sub_y, (w + sub_x) >> sub_x
    out = []
    for ph, pw in ((h, w), (hc, wc), (hc, wc)):
        d = _denoised(rng, 2, ph, pw, bd)
        s = np.clip(d + rng.integers(-30, 31, d.shape), 0, maxv)
        out += [s.astype(dtype), d.astype(dtype)]
    return out


def _close(got: dict, want: dict, what):
    assert set(got) == set(want)
    for k in want:
        cv = np.asarray(want[k], np.float64)
        av = got[k].numpy()
        assert av.shape == cv.shape, (what, k)
        scale = max(np.abs(cv).max(), 1.0)
        assert np.abs(av - cv).max() / scale < 1e-5, (what, k)


@pytest.mark.parametrize("lag,sub_x,sub_y,bd,dtype,h,w", STATS_CASES)
def test_batch_stats_match_jax(lag, sub_x, sub_y, bd, dtype, h, w):
    planes = _stats_inputs(lag, sub_x, sub_y, bd, dtype, h, w)
    kw = dict(lag=lag, bit_depth=bd, sub_x=sub_x, sub_y=sub_y, has_chroma=True)
    got = td.batch_pair_stats_per_frame(*(torch.from_numpy(a) for a in planes), **kw)
    # the XLA formulation cannot take a plane without a full block (its
    # median of an empty block map fails); the Pallas path zeroes the mask
    small = min(planes[2].shape[1:]) < 16
    for backend in ("pallas",) if small else ("pallas", "xla"):
        want = jd.batch_pair_stats_per_frame(
            *(jnp.asarray(a) for a in planes), backend=backend, **kw
        )
        for name, g, wnt in zip(("y", "cb", "cr"), got, want):
            _close(g, wnt, f"{backend} {name}")
    if min(h, w) < 16:
        assert float(got[0]["n_ar"].sum()) == 0 and float(got[0]["ata"].abs().sum()) == 0


@pytest.mark.parametrize("name,s_val,d_val,aux_val", EXTREME_CASES, ids=[c[0] for c in EXTREME_CASES])
@pytest.mark.parametrize("lag", [1, 2, 3])
def test_plane_stats_plain_matches_jax_at_the_ends_of_its_ranges(lag, name, s_val, d_val, aux_val):
    """The plain version is what the card holds the statistics kernel to:
    12-bit planes at r = +-4095 with the aux column at +-16380, every block
    flat, against the Pallas kernel in interpret mode (its block-mask
    mode, as ``batch_pair_stats_per_frame`` calls it)."""
    s, d, blocks, aux = extreme_stats_inputs(s_val, d_val, aux_val, h=80, w=144)
    for a in (None, aux):
        got = dk.plane_stats(*(torch.from_numpy(x) for x in (s, d, blocks)),
                             None if a is None else torch.from_numpy(a), lag, 12)
        want = diff_pallas.pallas_plane_stats(
            jnp.asarray(s), jnp.asarray(d), jnp.asarray(blocks),
            None if a is None else jnp.asarray(a), lag, 12, has_aux=a is not None,
            mask_blocks=16,
        )
        _close(got, want, f"{name} lag {lag} aux {a is not None}")
    assert float(got["ata"].abs().max()) > 2.0**32


def test_plane_stats_plain_on_a_tall_plane_is_the_closed_form():
    """10,000 rows of r = 4095 and aux = 16380: every sum of the plain
    version is a count times a product, exactly, and one column's r * r sum
    is past 2^32."""
    s, d, blocks, aux = (torch.from_numpy(a) for a in tall_stats_inputs())
    lag = 2
    got = dk.plane_stats(s, d, blocks, aux, lag, 12)
    n = (10000 - 2 * lag) * (32 - 2 * lag)
    assert float(got["n_ar"][0]) == n and 4095.0**2 * (10000 - 2 * lag) > 2.0**32
    k = len(dk.offsets(lag)) - 1
    want_ata = torch.full((k + 1, k + 1), 4095.0**2 * n, dtype=torch.float64)
    want_ata[k, :] = want_ata[:, k] = 4095.0 * 16380 / 4 * n
    want_ata[k, k] = 16380.0**2 / 16 * n
    assert torch.equal(got["ata"][0], want_ata)
    assert torch.equal(got["atb"][0], want_ata[0])
    assert float(got["bin_cnt"][0, 0]) == 10000 * 32
    assert float(got["bin_sumsq"][0, 0]) == 4095.0**2 * 10000 * 32


def test_stats_kernel_32bit_sums_cannot_overflow():
    """The statistics kernel adds products in 32 bits over bounded runs of
    rows. Its source states the ranges and the rows per run as constants
    and static_asserts; this redoes the arithmetic from the constants as
    they stand in the source, so a change of tile height, flush interval
    or bit depth that breaks a bound fails here, where no nvcc runs."""
    import os
    import re

    path = os.path.join(os.path.dirname(td.__file__), "..", "csrc", "diff_kernels.cu")
    with open(path) as fh:
        src = fh.read()

    def const(name):
        m = re.search(rf"constexpr (?:int|long long) {name} = ([^;]+);", src)
        assert m, name
        return m.group(1).strip()

    fb, tile_rows = int(const("FB")), int(const("ST_TR"))
    max_bits = int(const("MAX_BIT_DEPTH"))
    assert const("MAX_RES") == "(1LL << MAX_BIT_DEPTH) - 1" and const("MAX_AUX") == "4 * MAX_RES"
    assert const("ROWS_PER_FLUSH_RES") == "ST_TR" and const("ROWS_PER_FLUSH_AUX") == "FB"
    assert const("ST_SEGS") == "ST_TR / FB" and tile_rows % fb == 0
    max_res = (1 << max_bits) - 1
    max_aux = 4 * max_res
    # the wrapper admits exactly the depths the bounds cover, and the aux
    # column is the x4 luma residual: a sum of four residuals at most
    assert max_bits == 12 and "bit_depth > MAX_BIT_DEPTH" in src
    assert tile_rows * max_res * max_res <= 2**31 - 1  # r * r over a thread's column
    assert fb * max_res * max_aux <= 2**31 - 1  # r * aux over a segment
    assert fb * max_aux * max_aux <= 2**32 - 1  # aux * aux over a segment, unsigned
    assert fb * max_aux * max_aux > 2**31 - 1  # ... which is why it is unsigned
    assert tile_rows * max_res * max_res <= 2**32 - 1  # the bin moments of a column
    # a CTA's sums in shared memory: 16-bit halves of its threads' pair sums,
    # and per bin the sum of r and the halves of the sum of r * r
    tile_cols = int(const("ST_TW"))
    assert const("ST_THREADS") == "ST_TW"
    assert tile_cols * 65535 <= 2**31 - 1
    assert tile_rows * tile_cols * max_res <= 2**31 - 1
    assert tile_rows * tile_cols * 65535 <= 2**32 - 1
    for text in (
        "ROWS_PER_FLUSH_RES * MAX_RES * MAX_RES <= INT32_LIMIT",
        "ROWS_PER_FLUSH_AUX * MAX_RES * MAX_AUX <= INT32_LIMIT",
        "ROWS_PER_FLUSH_AUX * MAX_AUX * MAX_AUX <= UINT32_LIMIT",
        "ST_THREADS * 65535LL <= INT32_LIMIT",
        "ST_TR * ST_TW * MAX_RES <= INT32_LIMIT",
        "ST_TR * ST_TW * 65535LL <= UINT32_LIMIT",
    ):
        assert f"static_assert({text}" in src, text
    assert const("INT32_LIMIT") == "2147483647LL" and const("UINT32_LIMIT") == "4294967295LL"


def test_luma_only_stats_match_jax():
    planes = _stats_inputs(2, 1, 1, 10, np.int16, 70, 100)[:2]
    got = td.batch_pair_stats_per_frame(
        *(torch.from_numpy(a) for a in planes), None, None, None, None,
        lag=2, bit_depth=10, sub_x=1, sub_y=1, has_chroma=False,
    )
    want = jd.batch_pair_stats_per_frame(
        *(jnp.asarray(a) for a in planes), None, None, None, None,
        lag=2, bit_depth=10, sub_x=1, sub_y=1, has_chroma=False, backend="xla",
    )
    assert got[1] is None and got[2] is None and want[1] is None
    _close(got[0], want[0], "y")


@pytest.mark.parametrize("sub_x,sub_y,h,w", [(1, 1, 33, 47), (1, 0, 20, 31), (0, 0, 18, 18)])
def test_chroma_lavg4_matches_jax(sub_x, sub_y, h, w):
    rng = np.random.default_rng(h)
    s = rng.integers(0, 4096, (2, h, w)).astype(np.int16)
    d = rng.integers(0, 4096, (2, h, w)).astype(np.int16)
    hc, wc = (h + sub_y) >> sub_y, (w + sub_x) >> sub_x
    got = td.chroma_lavg4(torch.from_numpy(s), torch.from_numpy(d), hc, wc, sub_x, sub_y)
    want = np.asarray(jd._chroma_lavg4(jnp.asarray(s), jnp.asarray(d), hc, wc, sub_x, sub_y))
    assert got.dtype == torch.int16
    assert np.array_equal(got.numpy(), want)


def _film_stats():
    """Per-frame statistics of a grained film-like clip, from the JAX
    package's XLA path, as host numpy dicts."""
    clean = film_like_clip(n=6)
    grainy = inject_grain(clean, film_params())
    planes = [np.stack([f[k] for f in frames]) for k in range(3) for frames in (grainy, clean)]
    out = jd.batch_pair_stats_per_frame(
        *(jnp.asarray(a) for a in planes), lag=2, bit_depth=8, sub_x=1, sub_y=1,
        has_chroma=True, backend="xla",
    )
    return [{k: np.asarray(v) for k, v in d.items()} for d in out]


def test_fit_params_equal_to_jax():
    stats = _film_stats()
    k = len(dk.offsets(2)) - 1
    mine, theirs = td._ChunkStats.zero(k), jd._ChunkStats.zero(k)
    for cs in (mine, theirs):
        for i in range(6):
            for plane, st in zip((cs.y, cs.cb, cs.cr), stats):
                plane.add({key: v[i] for key, v in st.items()})
        cs.frames = 6
    for plane in ("y", "cb", "cr"):
        a, b = getattr(mine, plane), getattr(theirs, plane)
        assert np.array_equal(td._solve_coeffs(a, 6), jd._solve_coeffs(b, 6))
        va, ma = a.sigma_bins(1.0)
        vb, mb = b.sigma_bins(1.0)
        assert td._curve_points(va, ma, 14) == jd._curve_points(vb, mb, 14)
    got = td._fit_params(mine, 2, 8, 7391)
    want = jd._fit_params(theirs, 2, 8, 7391)
    assert got is not None and dataclasses.astuple(got) == dataclasses.astuple(want)
    for st in stats:
        per = {key: v[0] for key, v in st.items()}
        assert td._frame_sigma(per) == jd._frame_sigma(per)


def _segments(segs):
    """Segments as plain tuples: the two packages have their own
    FilmGrainParams classes, so their instances never compare equal."""
    return [(s.start_time, s.end_time, dataclasses.astuple(s.params)) for s in segs]


def _scene_change_clip():
    """tests/test_diff_quality.TestBatchedDiff._clip_with_scene_change:
    20 frames whose grain grows much stronger at frame 10."""
    params = film_params()
    clean = film_like_clip(n=20)
    grainy = inject_grain(clean, params)
    strong = dataclasses.replace(
        params, scaling_points_y=[(0, 90), (128, 110), (255, 80)]
    )
    grainy[10:] = inject_grain(clean[10:], strong)
    return grainy, clean


def test_diff_batch_tables_match_jax_with_scene_cut():
    grainy, clean = _scene_change_clip()
    kw = dict(chunk_frames=9, min_chunk_frames=4, sigma_jump=0.25)

    def batched(est):
        for i in range(0, len(grainy), 6):
            est.diff_batch(
                [list(f) for f in grainy[i : i + 6]], [list(f) for f in clean[i : i + 6]]
            )
        return est.finish()

    mine = batched(td.DiffEstimator((24, 1), device="cpu", **kw))
    theirs = batched(jd.DiffEstimator((24, 1), **kw))
    assert len(mine) >= 2  # chunking and the scene cut both fired
    assert _segments(mine) == _segments(theirs)
    # frame by frame through diff_frame: the same table again
    est = td.DiffEstimator((24, 1), device="cpu", **kw)
    for g, c in zip(grainy, clean):
        est.diff_frame(list(g), list(c))
    assert _segments(est.finish()) == _segments(theirs)


def test_diff_batch_mono_and_mixed_depth_match_jax():
    clean = film_like_clip(n=8)
    grainy = inject_grain(clean, film_params())
    src = [[f[0]] for f in grainy]
    den10 = [[f[0].astype(np.int32) << 2] for f in clean]
    tables = []
    for est in (
        td.DiffEstimator((24, 1), denoised_bit_depth=10, chunk_frames=1000, device="cpu"),
        jd.DiffEstimator((24, 1), denoised_bit_depth=10, chunk_frames=1000),
    ):
        est.diff_batch(src, den10)
        tables.append(est.finish())
    assert len(tables[0]) == 1 and not tables[0][0].params.scaling_points_cb
    assert _segments(tables[0]) == _segments(tables[1])


def test_diff_batch_chroma_mismatch_matches_jax():
    """A denoised copy whose chroma geometry differs from the source's:
    the batch goes frame by frame and each mismatched plane is skipped."""
    clean = film_like_clip(n=4)
    grainy = inject_grain(clean, film_params())
    den = [[c[0], np.repeat(np.repeat(c[1], 2, 0), 2, 1), c[2]] for c in clean]
    tables = []
    for est in (
        td.DiffEstimator((24, 1), chunk_frames=1000, device="cpu"),
        jd.DiffEstimator((24, 1), chunk_frames=1000),
    ):
        est.diff_batch([list(g) for g in grainy], den)
        tables.append(est.finish())
    assert _segments(tables[0]) == _segments(tables[1])


def test_diff_batch_refuses_a_mesh_and_mismatched_luma():
    """A mesh is taken (three frames over two shards, padded to four: the
    table of the unsharded batch); mismatched luma is refused."""
    from grav1synth_tpu_torch.parallel import DeviceMesh

    clean = film_like_clip(n=3)
    grainy = inject_grain(clean, film_params())
    tables = []
    for mesh in (None, DeviceMesh(["cpu", "cpu"])):
        est = td.DiffEstimator((24, 1), chunk_frames=1000, device="cpu")
        est.diff_batch([list(f) for f in grainy], [list(f) for f in clean], mesh=mesh)
        tables.append(_segments(est.finish()))
    assert tables[0] and tables[1] == tables[0]
    est = td.DiffEstimator((24, 1), device="cpu")
    y = np.zeros((32, 32), np.uint8)
    with pytest.raises(ValueError, match="dimensions differ"):
        est.diff_batch([[y]], [[y[:16]]])


def _write_pair(tmp_path, w, h, bd, n, seed):
    """Source (clean + gaussian noise) and clean copy, libaom-encoded."""
    rng = np.random.default_rng(seed)
    maxv = (1 << bd) - 1
    dt = np.uint8 if bd == 8 else np.uint16
    hc, wc = (h + 1) // 2, (w + 1) // 2
    noisy, clean = [], []
    for i in range(n):
        y = np.full((h, w), 60 + (i % 3), np.float64) * (maxv / 255)
        y[:, w // 2 :] = (180 + (i % 3)) * maxv / 255
        u = np.full((hc, wc), (maxv + 1) // 2, dt)
        clean.append((y.astype(dt), u, u.copy()))
        yn = np.clip(y + rng.normal(0, 6.0 * maxv / 255, (h, w)), 0, maxv)
        noisy.append((yn.astype(dt), u, u.copy()))
    paths = []
    for name, frames in (("src", noisy), ("den", clean)):
        enc = Encoder(w, h, bd, extra_opts="crf=10")
        pkts = enc.encode_frames(frames)
        enc.close()
        path = tmp_path / f"{name}.ivf"
        write_ivf(
            str(path), IvfHeader(width=w, height=h, timebase_den=24, timebase_num=1),
            [IvfPacket(p.pts, p.data) for p in pkts],
        )
        paths.append(str(path))
    return paths


@pytest.mark.parametrize("w,h,bd,n", [(128, 128, 8, 12), (97, 65, 10, 6)], ids=["8bit", "10bit-odd"])
def test_pipeline_diff_matches_jax(tmp_path, w, h, bd, n, caplog):
    src, den = _write_pair(tmp_path, w, h, bd, n, seed=w)
    theirs = tmp_path / "jax.tbl"
    jax_pipelines.diff(src, den, str(theirs), progress=False)
    mine = tmp_path / "torch.tbl"
    spans.reset()
    with caplog.at_level(logging.DEBUG, logger="spans"):
        segs = pipelines.diff(src, den, str(mine), progress=False, device="cpu")
    assert segs and segs[0].params.scaling_points_y
    assert mine.read_bytes() == theirs.read_bytes()
    got = spans.snapshot()["spans"]
    # one batch of n pairs (and the streams' end), three planes a side
    assert {k: got[k]["count"] for k in ("diff.decode", "stage.planes", "diff.launch",
                                         "diff.download", "diff.chunk")} == {
        "diff.decode": n + 1, "stage.planes": 6, "diff.launch": 1, "diff.download": 1,
        "diff.chunk": 1}
    assert got["diff.fit"]["count"] >= 1 and got["diff.launch"]["total_ms"] > 0
    assert "diff.launch" in caplog.text
    mine3 = tmp_path / "torch_b3.tbl"
    pipelines.diff(src, den, str(mine3), progress=False, batch=3, device="cpu")
    assert mine3.read_bytes() == theirs.read_bytes()


def test_pipeline_diff_refuses_what_is_not_ported(tmp_path):
    """--shards runs (the table of one shard); a CUDA device that is
    missing is refused, not replaced."""
    src, den = _write_pair(tmp_path, 64, 64, 8, 2, seed=1)
    one, two = tmp_path / "one.tbl", tmp_path / "two.tbl"
    pipelines.diff(src, den, str(one), progress=False, device="cpu")
    pipelines.diff(src, den, str(two), progress=False, shards=2, device="cpu")
    assert two.read_bytes() == one.read_bytes()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            pipelines.diff(src, den, str(tmp_path / "t.tbl"), device="cuda")
