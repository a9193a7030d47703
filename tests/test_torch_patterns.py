"""The port's grain-pattern generation against the JAX package, on the CPU.

``ops.grain.generate_patterns`` is the plain version of the pattern
kernel (K7, csrc/pattern_kernels.cu); the kernel's wrapper,
``grain_kernels.generate_patterns_packed``, runs it on CPU tensors. The
same parameter batches, made from numpy seeds, go through it and through
``grain_jax.generate_patterns``, ``grain_ref.generate_grain`` and the
native shim's ``generate_patterns_native``. ``apply_grain``, which makes
its patterns on the tensors' device, is held against
``grain_jax.apply_grain_batch_pallas`` and
``grain_jax.apply_grain_device_patterns`` (Pallas in interpret mode) and
``grain_ref``. Integer arithmetic throughout: every comparison is exact.
"""

import numpy as np
import pytest
import torch

from grav1synth_tpu.container.ffshim import generate_patterns_native
from grav1synth_tpu.ops import grain_jax, grain_ref
from grav1synth_tpu_torch.ops import grain as tg
from grav1synth_tpu_torch.ops import grain_kernels as gk

from test_torch_cuda import (
    PATTERN_LAYOUT_IDS,
    PATTERN_LAYOUTS,
    pattern_zoo,
    stray_slot_frames,
    stray_slots,
    uniform_lag_zoo,
)


def _equal(got, want, what):
    got = np.asarray(got).astype(np.int64)
    want = np.asarray(want).astype(np.int64)
    assert got.shape == want.shape, what
    bad = int((got != want).sum())
    assert bad == 0, f"{what}: {bad} mismatching samples"


@pytest.mark.parametrize("sub_x,sub_y,mono", PATTERN_LAYOUTS, ids=PATTERN_LAYOUT_IDS)
@pytest.mark.parametrize("bd", [8, 10, 12])
def test_generate_patterns_matches_jax_ref_and_native(bd, sub_x, sub_y, mono):
    params = pattern_zoo(100 * bd + 10 * sub_x + 2 * sub_y + mono)
    jb = grain_jax.pack_params(params)
    pb = tg.from_jax_params(jb, "cpu")
    mine = tg.generate_patterns(pb, bd, sub_x, sub_y, mono)
    theirs = grain_jax.generate_patterns(jb, bd, sub_x, sub_y, mono)
    native = generate_patterns_native(params, bd, sub_x, sub_y, mono)
    nplanes = 1 if mono else 3
    assert all(m is None for m in mine[nplanes:])
    for k in range(nplanes):
        assert mine[k].dtype == torch.int32
        _equal(mine[k], theirs[k], f"grain_jax plane {k}")
        _equal(mine[k], native[k], f"native plane {k}")
    for i, p in enumerate(params):
        ref = grain_ref.generate_grain(p, bd, mono, sub_x, sub_y)
        for k, want in enumerate((ref.luma, ref.cb, ref.cr)[:nplanes]):
            _equal(mine[k][i], want, f"grain_ref frame {i} plane {k}")
    # the kernel's wrapper on CPU tensors: the native shim's patterns,
    # packed, and unpacked again to the same planes
    packed = gk.generate_patterns_packed(pb, bd, sub_x, sub_y, mono)
    host = tg.pack_patterns(*(None if a is None else torch.from_numpy(a) for a in native))
    assert packed.dtype == torch.int16 and torch.equal(packed, host)
    chroma_shape = None if mono else tg.chroma_pattern_shape(sub_x, sub_y)
    for k, plane in enumerate(tg._unpack_patterns(packed, chroma_shape)[:nplanes]):
        _equal(plane, native[k], f"unpacked plane {k}")


@pytest.mark.parametrize("lag", [0, 1, 2, 3])
def test_packed_reference_at_each_lag_matches_jax_and_ref(lag):
    """``generate_patterns_packed_reference`` is what the card holds the
    pattern kernel to, and the kernel's filter is a template on the frame's
    lag: batches of one lag each, every layout, against ``grain_jax`` and
    ``grain_ref``."""
    for bd, (sub_x, sub_y, mono) in zip((8, 10, 12, 10), PATTERN_LAYOUTS):
        params = uniform_lag_zoo(lag, bd + sub_x + sub_y + mono)
        jb = grain_jax.pack_params(params)
        pb = tg.from_jax_params(jb, "cpu")
        got = gk.generate_patterns_packed_reference(pb, bd, sub_x, sub_y, mono)
        theirs = grain_jax.generate_patterns(jb, bd, sub_x, sub_y, mono)
        nplanes = 1 if mono else 3
        want = np.concatenate(
            [np.asarray(t).reshape(len(params), -1) for t in theirs[:nplanes]], 1
        )
        assert got.dtype == torch.int16
        _equal(got, want, f"grain_jax lag {lag} {bd}-bit {sub_x}{sub_y} mono={mono}")
        for i, p in enumerate(params):
            ref = grain_ref.generate_grain(p, bd, mono, sub_x, sub_y)
            flat = np.concatenate([a.reshape(-1) for a in (ref.luma, ref.cb, ref.cr)[:nplanes]])
            _equal(got[i], flat, f"grain_ref lag {lag} frame {i}")


@pytest.mark.parametrize("sub_x,sub_y,mono", PATTERN_LAYOUTS, ids=PATTERN_LAYOUT_IDS)
def test_packed_reference_reads_stray_lag3_slots_as_jax_does(sub_x, sub_y, mono):
    """Lag-2 frames with one non-zero lag-3 slot each (the rows carry all
    24 slots): the plain version filters them as ``grain_jax`` does, and
    not as the clean lag-2 frames."""
    import dataclasses

    jb = grain_jax.pack_params(stray_slot_frames())
    pb = stray_slots(tg.from_jax_params(jb, "cpu"))
    jb = dataclasses.replace(
        jb, coeffs_y=np.array(pb.coeffs_y), coeffs_cb=np.array(pb.coeffs_cb),
        coeffs_cr=np.array(pb.coeffs_cr),
    )
    got = gk.generate_patterns_packed_reference(pb, 10, sub_x, sub_y, mono)
    theirs = grain_jax.generate_patterns(jb, 10, sub_x, sub_y, mono)
    want = np.concatenate([np.asarray(t).reshape(4, -1) for t in theirs[: 1 if mono else 3]], 1)
    _equal(got, want, "grain_jax")
    clean = tg.pack_params(stray_slot_frames(), "cpu")
    moved = (got != gk.generate_patterns_packed_reference(clean, 10, sub_x, sub_y, mono)).any(1)
    assert moved.tolist() == [True, not mono, not mono, False]


def _frames(b, h, w, bd, sub_x, sub_y, mono, seed):
    rng = np.random.default_rng(seed)
    maxv = (1 << bd) - 1
    hc, wc = (h + sub_y) >> sub_y, (w + sub_x) >> sub_x
    y = rng.integers(0, maxv + 1, (b, h, w)).astype(np.int16)
    if mono:
        return y, None, None
    cb = rng.integers(0, maxv + 1, (b, hc, wc)).astype(np.int16)
    cr = rng.integers(0, maxv + 1, (b, hc, wc)).astype(np.int16)
    return y, cb, cr


def _t(a):
    return None if a is None else torch.from_numpy(a)


# (id, sub_x, sub_y, mono, bit_depth, h, w)
APPLY_CASES = [
    ("420-10-64x64", 1, 1, False, 10, 64, 64),
    ("422-8-40x70", 1, 0, False, 8, 40, 70),
    ("444-12-33x64", 0, 0, False, 12, 33, 64),
    ("mono-8-64x64", 1, 1, True, 8, 64, 64),
]


@pytest.mark.parametrize(
    "sub_x,sub_y,mono,bd,h,w", [c[1:] for c in APPLY_CASES], ids=[c[0] for c in APPLY_CASES]
)
def test_apply_without_patterns_matches_jax_device_paths_and_ref(sub_x, sub_y, mono, bd, h, w):
    params = pattern_zoo(7 * bd + sub_y, n=5)
    y, cb, cr = _frames(len(params), h, w, bd, sub_x, sub_y, mono, seed=bd)
    jb = grain_jax.pack_params(params)
    pb = tg.from_jax_params(jb, "cpu")
    out = tg.apply_grain(_t(y), _t(cb), _t(cr), pb, bd, sub_x, sub_y, mono)
    n_seg, chroma_static = grain_jax._host_metadata(params, mono)
    # the port's batch from the host tables, with their chroma fact
    packed = tg.pack_params(params, "cpu")
    assert chroma_static and packed.touches_chroma
    mine_facts = tg.apply_grain(_t(y), _t(cb), _t(cr), packed, bd, sub_x, sub_y, mono)
    batch = grain_jax.apply_grain_batch_pallas(y, cb, cr, jb, bd, sub_x, sub_y, mono)
    dev = grain_jax.apply_grain_device_patterns(
        y, cb, cr, jb, bd, sub_x, sub_y, mono, n_seg=n_seg, chroma_static=chroma_static
    )
    nplanes = 1 if mono else 3
    assert all(o is None for o in out[nplanes:])
    for k in range(nplanes):
        assert out[k].dtype == torch.int16
        _equal(out[k], batch[k], f"apply_grain_batch_pallas plane {k}")
        _equal(out[k], dev[k], f"apply_grain_device_patterns plane {k}")
        _equal(mine_facts[k], dev[k], f"pack_params' batch: plane {k}")
    planes = [y, cb, cr][:nplanes]
    for i, p in enumerate(params):
        ref = grain_ref.apply_grain_frame(
            [pl[i].astype(np.int32) for pl in planes], p, bd, sub_x, sub_y
        )
        for k in range(nplanes):
            _equal(out[k][i], ref[k], f"grain_ref frame {i} plane {k}")


def test_device_patterns_luma_only_batch_returns_chroma_untouched():
    """No frame touches chroma (``pack_params`` records it, as the JAX
    package's ``chroma_static``): the luma kernel alone, cb/cr returned as
    they came, as in the JAX package."""
    params = pattern_zoo(5, n=4)
    for p in params:
        p.scaling_points_cb, p.scaling_points_cr = [], []
        p.chroma_scaling_from_luma = False
        p.ar_coeffs_cb, p.ar_coeffs_cr = [], []
    y, cb, cr = _frames(len(params), 64, 64, 10, 1, 1, False, seed=2)
    jb = grain_jax.pack_params(params)
    n_seg, chroma_static = grain_jax._host_metadata(params, False)
    pb = tg.pack_params(params, "cpu")
    assert not chroma_static and not pb.touches_chroma
    cb_t, cr_t = _t(cb), _t(cr)
    out = tg.apply_grain(_t(y), cb_t, cr_t, pb, 10)
    assert out[1] is cb_t and out[2] is cr_t
    want = grain_jax.apply_grain_device_patterns(
        y, cb, cr, jb, 10, n_seg=n_seg, chroma_static=chroma_static
    )
    _equal(out[0], want[0], "luma")
    _equal(want[1], cb, "JAX cb untouched")


def test_pattern_params_fold_the_activity_rules():
    """The kernel's per-frame row: inactive chroma planes get zero
    coefficients, a chroma luma tap needs luma points."""
    params = pattern_zoo(11, n=5)
    pb = tg.pack_params(params, "cpu")
    rows = gk.pattern_params(pb)
    assert rows.dtype == torch.int32 and tuple(rows.shape) == (5, gk.Q_LEN)
    for i, p in enumerate(params):
        has_y = bool(p.scaling_points_y)
        cb_on = bool(p.scaling_points_cb) or p.chroma_scaling_from_luma
        cr_on = bool(p.scaling_points_cr) or p.chroma_scaling_from_luma
        r = rows[i].tolist()
        assert r[gk.Q_SEED] == p.grain_seed and r[gk.Q_HAS_Y] == has_y
        assert (r[gk.Q_CB_ACTIVE], r[gk.Q_CR_ACTIVE]) == (cb_on, cr_on)
        assert r[gk.Q_AR_SHIFT] == p.ar_coeff_shift
        assert r[gk.Q_GRAIN_SCALE_SHIFT] == p.grain_scale_shift
        for on, q_luma, q_coeffs, k in (
            (cb_on, gk.Q_CB_LUMA, gk.Q_COEFFS_CB, "cb"),
            (cr_on, gk.Q_CR_LUMA, gk.Q_COEFFS_CR, "cr"),
        ):
            full = getattr(pb, f"coeffs_{k}")[i].tolist()
            assert r[q_coeffs : q_coeffs + 24] == (full[:24] if on else [0] * 24)
            assert r[q_luma] == (full[24] if on and has_y else 0)


def test_pattern_wrapper_refuses_other_devices():
    """On any device but the CPU the wrapper launches the kernel or
    raises: it never falls back to the plain version."""
    pb = tg.pack_params(pattern_zoo(1, n=2), "cpu")
    meta = tg.GrainParamsBatch(pb.buffer.to("meta"))
    with pytest.raises(ValueError, match="one CUDA device or on the CPU"):
        gk.generate_patterns_packed(meta, 10)
