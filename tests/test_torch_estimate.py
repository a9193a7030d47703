"""The PyTorch port's single-input estimate path against the JAX
package's, on the CPU (the flat-block kernel's plain version).

- the blurred plane ``den`` and the flat map: identical to the JAX
  intermediates (``round(_box_blur)``, ``_flat_mask``), at 8/10/12 bits on
  planes 1-12 samples tall or wide, odd and even, and uint8 at 8 bits;
- per-frame statistics: within rtol 1e-5 (of each array's largest
  magnitude) of ``batch_self_stats`` / ``batch_self_stats_chroma``, the
  bar the JAX package holds its own two stats backends to, at lags 0-3,
  also on a textured plate where only some blocks are flat;
  all zero on planes with no full 16x16 block or under 9 samples;
- the copied host code (``highpass_np``, ``_fallback_lag0``): equal;
- ``NoiseEstimator`` tables (calibration on): identical, per-frame
  sigmas within rtol 1e-5; ``pipelines.estimate`` table and ``--raw``
  files: byte-identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from grav1synth_tpu import pipelines as jax_pipelines
from grav1synth_tpu.container.ffshim import Encoder
from grav1synth_tpu.container.ivf import IvfHeader, IvfPacket, write_ivf
from grav1synth_tpu.ops import diff_estimate as jd
from grav1synth_tpu.ops import estimate as je
from grav1synth_tpu.ops import grain_ref
from grav1synth_tpu_torch import pipelines
from grav1synth_tpu_torch.ops import diff_kernels as dk
from grav1synth_tpu_torch.ops import estimate as te

from test_estimate_quality import (
    inject,
    inject_chroma,
    smooth_clip,
    smooth_clip_chroma,
    true_params,
    true_params_chroma,
)
from test_torch_cuda import textured_plate
from test_torch_diff import _segments


def _planes(rng, b, h, w, bd, sub_x, sub_y):
    """Luma and chroma with smooth and textured halves plus noise: both
    sides of the flat-block threshold."""
    maxv = (1 << bd) - 1
    out = []
    for ph, pw in ((h, w), ((h + sub_y) >> sub_y, (w + sub_x) >> sub_x)):
        yy, xx = np.mgrid[0:ph, 0:pw]
        base = (0.2 + 0.5 * xx / pw + 0.1 * yy / ph) * maxv
        tex = rng.integers(0, maxv + 1, (b, ph, pw))
        p = np.where(yy[None] < ph // 2, base[None], tex)
        p = p + rng.normal(0, 0.02 * maxv, (b, ph, pw))
        out.append(np.clip(np.round(p), 0, maxv).astype(np.int16))
    return out


# planes 1-12 samples tall or wide, odd and even sizes
SMALL_SIZES = [(1, 1), (1, 12), (12, 1), (5, 7), (8, 9), (9, 8), (12, 12)]


@pytest.mark.parametrize(
    "bd,h,w",
    [(8, 37, 53), (10, 64, 70), (12, 33, 81)] + [(bd, h, w) for bd in (8, 10, 12)
                                                 for h, w in SMALL_SIZES],
)
def test_den_and_flat_map_identical_to_jax(bd, h, w):
    (y,) = _planes(np.random.default_rng(bd), 2, h, w, bd, 0, 0)[:1]
    maxv = (1 << bd) - 1
    inputs = [y] + ([y.astype(np.uint8)] if bd == 8 else [])
    for f in inputs:
        den, q = te.self_blur(torch.from_numpy(f), bd)
        assert den.dtype == torch.int16 and q.dtype == torch.int32
        for i in range(2):
            sm = je._box_blur(jnp.asarray(y[i], jnp.float32))
            want = np.clip(np.round(np.asarray(sm)), 0, maxv)
            assert np.array_equal(den[i].numpy(), want)
            # r = q / 81 is the JAX residual f - sm up to float32 rounding
            r = q[i].numpy() / 81.0
            assert np.abs(r - (y[i] - np.asarray(sm, np.float64))).max() < 1e-3
            if h < 16 or w < 16:  # no full block: the JAX flat mask takes a median of none
                continue
            flat = dk._pixel_flat(te.flat_blocks(den[i : i + 1]), h, w)[0]
            assert np.array_equal(flat.numpy(), np.asarray(jd._flat_mask(jnp.asarray(want))) > 0)


def _close(got: dict, want: dict, what):
    assert set(got) == set(want)
    for k in want:
        cv = np.asarray(want[k], np.float64)
        av = got[k].numpy()
        assert av.shape == cv.shape, (what, k)
        scale = max(np.abs(cv).max(), 1.0)
        assert np.abs(av - cv).max() / scale < 1e-5, (what, k, np.abs(av - cv).max() / scale)


SIZES = [(37, 53), (49, 70), (33, 81)]  # odd, with full 16x16 blocks


@pytest.mark.parametrize("sub_x,sub_y", [(1, 1), (1, 0), (0, 0)])
@pytest.mark.parametrize("bd", [8, 10, 12])
@pytest.mark.parametrize("lag", [1, 2, 3, 0])
def test_self_stats_match_jax(lag, bd, sub_x, sub_y):
    """At lag 0 the JAX luma statistics raise (an empty design: its lag
    window has no offset), so luma lag 0 is held to the JAX lag-1 run on
    what does not depend on the lag (n_ar and the bins), and its Gram is
    empty."""
    h, w = SIZES[(lag + bd) % 3]
    y, c = _planes(np.random.default_rng(lag * 100 + bd), 2, h, w, bd, sub_x, sub_y)
    ty, tc = torch.from_numpy(y), torch.from_numpy(c)
    jy, jc = jnp.asarray(y, jnp.int32), jnp.asarray(c, jnp.int32)
    got_y = te.batch_self_stats(ty, lag, bd)
    got_c = te.batch_self_stats_chroma(tc, ty, lag, bd, sub_x, sub_y)
    if lag == 0:
        moments = ("n_ar", "bin_cnt", "bin_sum", "bin_sumsq")
        want = je.batch_self_stats(jy, 1, bd)
        assert tuple(got_y["ata"].shape) == (2, 0, 0) and tuple(got_y["atb"].shape) == (2, 0)
        _close({k: got_y[k] for k in moments}, {k: want[k] for k in moments}, "y")
    else:
        _close(got_y, je.batch_self_stats(jy, lag, bd), "y")
    _close(got_c, je.batch_self_stats_chroma(jc, jy, lag, bd, sub_x, sub_y), "chroma")
    # every frame of both planes has flat pixels in the statistics
    for st in (got_y, got_c):
        assert float(st["n_ar"].min()) > 0 and float(st["bin_cnt"].sum(1).min()) > 0


@pytest.mark.parametrize("bd,sub_x,sub_y", [(10, 1, 1), (12, 0, 0)], ids=["10-bit 420", "12-bit 444"])
@pytest.mark.parametrize("lag", [0, 1, 2, 3])
def test_self_stats_match_jax_on_textured_plate(lag, bd, sub_x, sub_y):
    """A textured plate (``textured_plate``): flat blocks on the band's
    edge, whole statistics tiles without a flat block, a partial last block
    row and column. Luma lag 0 as in test_self_stats_match_jax."""
    rng = np.random.default_rng(60 + lag + bd)
    h, w = 103, 517
    y = textured_plate(rng, 2, h, w, bd)
    c = textured_plate(rng, 2, (h + sub_y) >> sub_y, (w + sub_x) >> sub_x, bd)
    ty, tc = torch.from_numpy(y), torch.from_numpy(c)
    jy, jc = jnp.asarray(y, jnp.int32), jnp.asarray(c, jnp.int32)
    got_y = te.batch_self_stats(ty, lag, bd)
    got_c = te.batch_self_stats_chroma(tc, ty, lag, bd, sub_x, sub_y)
    if lag == 0:
        moments = ("n_ar", "bin_cnt", "bin_sum", "bin_sumsq")
        want = je.batch_self_stats(jy, 1, bd)
        _close({k: got_y[k] for k in moments}, {k: want[k] for k in moments}, "y")
    else:
        _close(got_y, je.batch_self_stats(jy, lag, bd), "y")
    _close(got_c, je.batch_self_stats_chroma(jc, jy, lag, bd, sub_x, sub_y), "chroma")
    # some blocks are flat, some are not; in luma whole 2 x 8-block tiles
    # (the card kernel's) have none
    for plane in (ty, tc):
        flat = te.flat_blocks(te.self_blur(plane, bd)[0])
        assert 0 < float(flat.float().mean()) < 1
    flat_y = te.flat_blocks(te.self_blur(ty, bd)[0])[:, :6, :32]
    tiles = flat_y.reshape(2, 3, 2, 4, 8).amax((2, 4))
    assert int((tiles == 0).sum()) > 0
    for st in (got_y, got_c):
        assert float(st["n_ar"].min()) > 0


def test_no_full_block_gives_zero_stats():
    """12x40, 8x64, 40x8 and 16x8 planes have no full 16x16 block (and
    the last three are under 9 samples in one dimension). The port gives
    zero statistics at lags 0, 2 and 3; the reference's batch_self_stats
    raises there (a median of an empty block map), a defect of the
    reference, so there is no JAX comparison."""
    for h, w in ((12, 40), (8, 64), (40, 8), (16, 8)):
        rng = np.random.default_rng(1 if (h, w) == (12, 40) else h + w)
        y = torch.from_numpy(rng.integers(0, 256, (2, h, w)).astype(np.int16))
        c = y[:, : (h + 1) // 2, : (w + 1) // 2].contiguous()
        for lag in (2, 0, 3):
            for st in (
                te.batch_self_stats(y, lag, 8),
                te.batch_self_stats_chroma(c, y, lag, 8, 1, 1),
            ):
                for k, v in st.items():
                    assert float(v.abs().sum()) == 0, (h, w, lag, k)


def test_highpass_np_equal_to_original():
    pat = grain_ref.generate_grain(true_params(), 8, True, 1, 1).luma[3:, 3:-3]
    assert te.highpass_np(pat) == je.highpass_np(pat)
    rnd = np.random.default_rng(2).normal(0, 9, (38, 44))
    assert te.highpass_np(rnd) == je.highpass_np(rnd)


def test_fallback_lag0_equal_to_original():
    """The sigma-curve escape hatch on the same moments: the same table."""
    stats = je.batch_self_stats(
        jnp.asarray(np.stack(inject(smooth_clip(n=3), true_params())), jnp.int32), 2, 8
    )
    stats = {k: np.asarray(v) for k, v in stats.items()}
    tables = []
    for est in (te.NoiseEstimator((24, 1), device="cpu"), je.NoiseEstimator((24, 1))):
        for i in range(3):
            est._ingest({k: v[i] for k, v in stats.items()})
        tables.append(est._fallback_lag0())
    assert tables[0] and tables[0][0].params.ar_coeff_lag == 0
    assert _segments(tables[0]) == _segments(tables[1])


def _run(est, frames):
    est.push_batch(frames[:7])
    est.push_batch(frames[7:])
    return est.finish()


@pytest.mark.parametrize("chroma", [False, True], ids=["luma", "chroma"])
def test_noise_estimator_tables_match_jax(chroma):
    if chroma:
        frames = inject_chroma(smooth_clip_chroma(), true_params_chroma())
    else:
        frames = inject(smooth_clip(), true_params())
    mine_est = te.NoiseEstimator((24, 1), bit_depth=8, device="cpu")
    theirs_est = je.NoiseEstimator((24, 1), bit_depth=8)
    mine, theirs = _run(mine_est, frames), _run(theirs_est, frames)
    assert len(mine) == 1 and mine[0].params.ar_coeff_lag == 2
    if chroma:
        assert mine[0].params.scaling_points_cb and mine[0].params.scaling_points_cr
    assert _segments(mine) == _segments(theirs)
    np.testing.assert_allclose(mine_est.per_frame_sigma, theirs_est.per_frame_sigma, rtol=1e-5)


def test_push_frame_equals_push_batch():
    frames = inject(smooth_clip(n=4), true_params())
    e1 = te.NoiseEstimator((24, 1), device="cpu", calibrate=False)
    e2 = te.NoiseEstimator((24, 1), device="cpu", calibrate=False)
    sig = [e1.push_frame(f) for f in frames]
    e2.push_batch(frames)
    assert sig == e1.per_frame_sigma
    np.testing.assert_allclose(e1.per_frame_sigma, e2.per_frame_sigma, rtol=1e-12)
    assert e1.finish()[0].params == e2.finish()[0].params


def _noisy_ivf(tmp_path):
    """tests/test_pipelines.py TestEstimate's clip: 6 frames of flat
    128x128 luma plus gaussian noise, libaom-encoded."""
    rng = np.random.default_rng(7)
    frames = []
    for _ in range(6):
        y = np.clip(
            np.full((128, 128), 100.0) + rng.normal(0, 8.0, (128, 128)), 0, 255
        ).astype(np.uint8)
        u = np.full((64, 64), 128, np.uint8)
        frames.append((y, u, u.copy()))
    enc = Encoder(128, 128, 8, extra_opts="crf=10")
    pkts = enc.encode_frames(frames)
    enc.close()
    src = tmp_path / "in.ivf"
    write_ivf(
        str(src), IvfHeader(width=128, height=128, timebase_den=24, timebase_num=1),
        [IvfPacket(p.pts, p.data) for p in pkts],
    )
    return str(src)


def test_pipeline_estimate_matches_jax(tmp_path):
    src = _noisy_ivf(tmp_path)
    jax_pipelines.estimate(src, str(tmp_path / "j.tbl"), str(tmp_path / "j.raw"), progress=False)
    segs = pipelines.estimate(
        src, str(tmp_path / "t.tbl"), str(tmp_path / "t.raw"), progress=False, device="cpu"
    )
    assert len(segs) == 1 and segs[0].params.scaling_points_y
    assert (tmp_path / "t.tbl").read_bytes() == (tmp_path / "j.tbl").read_bytes()
    assert (tmp_path / "t.raw").read_bytes() == (tmp_path / "j.raw").read_bytes()
    assert len((tmp_path / "t.raw").read_text().splitlines()) == 6
