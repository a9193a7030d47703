"""The PyTorch port's grain application against the JAX package, on the
CPU (plain PyTorch versions of the kernels).

The same numpy inputs, made from a seed, go through the port and through
``grain_jax.apply_grain`` (pallas in interpret mode, and xla) and
``grain_ref.apply_grain_frame``. Grain synthesis is integer arithmetic,
so every comparison is exact (tolerance 0).
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from av1_builder import sample_grain_params
from grav1synth_tpu.ops import grain_jax, grain_pallas, grain_ref
from grav1synth_tpu_torch.obu.types import FilmGrainParams as PortParams
from grav1synth_tpu_torch.ops import grain as tg
from grav1synth_tpu_torch.ops import grain_kernels as gk
from grav1synth_tpu_torch.utils import spans

from test_torch_cuda import ref_patterns

DENSE_Y = [(x, (x * 7 + 13 * (i % 5)) % 256) for i, x in enumerate(range(0, 256, 19))][:14]
EXTREME_Y = [(0, 0), (1, 255), (2, 0), (128, 200), (255, 10)]


def _params(variant):
    """Batches of FilmGrainParams for one apply call."""
    p0 = sample_grain_params(seed=777)
    if variant == "mixed":  # overlap off, csfl, restricted-range clip
        p1 = copy.deepcopy(p0)
        p1.grain_seed, p1.overlap_flag = 4242, False
        p2 = copy.deepcopy(p0)
        p2.grain_seed, p2.chroma_scaling_from_luma = 31337, True
        p2.scaling_points_cb, p2.scaling_points_cr = [], []
        p3 = copy.deepcopy(p0)
        p3.grain_seed, p3.clip_to_restricted_range = 9001, True
        return [p0, p1, p2, p3]
    if variant == "dense":  # 14-point and extreme curves beside a sparse one
        p1 = sample_grain_params(seed=9)
        p1.scaling_points_y = DENSE_Y
        p1.scaling_points_cb = DENSE_Y[:10]
        p2 = sample_grain_params(seed=3)
        p2.scaling_points_y = EXTREME_Y
        p3 = sample_grain_params(seed=10)
        p3.scaling_points_y = [(0, 30), (255, 60)]
        return [p1, p2, p3]
    if variant in ("luma_only", "mono"):  # photon-noise style tables
        p0.scaling_points_cb, p0.scaling_points_cr = [], []
        p0.ar_coeffs_cb, p0.ar_coeffs_cr = [], []
        p1 = copy.deepcopy(p0)
        p1.grain_seed, p1.overlap_flag = 555, False
        return [p0, p1]
    raise ValueError(variant)


def _frames(b, h, w, bd, sub_x, sub_y, mono, seed=5):
    rng = np.random.default_rng(seed)
    maxv = (1 << bd) - 1
    y = rng.integers(0, maxv + 1, (b, h, w)).astype(np.int16)
    if mono:
        return y, None, None
    hc, wc = (h + sub_y) >> sub_y, (w + sub_x) >> sub_x
    cb = rng.integers(0, maxv + 1, (b, hc, wc)).astype(np.int16)
    cr = rng.integers(0, maxv + 1, (b, hc, wc)).astype(np.int16)
    return y, cb, cr


def _t(a):
    return None if a is None else torch.from_numpy(a)


def _equal(got, want, what):
    got = np.asarray(got).astype(np.int64)
    want = np.asarray(want).astype(np.int64)
    assert got.shape == want.shape, what
    bad = int((got != want).sum())
    assert bad == 0, f"{what}: {bad} mismatching samples"


def check_apply(sub_x, sub_y, mono, bd, h, w, variant):
    """The port's apply_grain on ``pack_params``' batch, with the tables'
    chroma fact (and apply_grain_reference on grain_ref's patterns), on
    the CPU against grain_jax.apply_grain (pallas, xla, with the native
    shim's patterns) and grain_ref."""
    params = _params(variant)
    y, cb, cr = _frames(len(params), h, w, bd, sub_x, sub_y, mono)
    jb = grain_jax.pack_params(params)
    pt = tg.from_jax_params(jb, "cpu")
    pb = tg.pack_params(params, "cpu")
    assert pb.touches_chroma == (variant not in ("luma_only", "mono"))
    out = tg.apply_grain(_t(y), _t(cb), _t(cr), pb, bd, sub_x, sub_y, mono)
    plain = tg.apply_grain_reference(
        _t(y), _t(cb), _t(cr), *ref_patterns(params, bd, sub_x, sub_y, mono), pt, bd, sub_x,
        sub_y, mono
    )
    nplanes = 1 if mono else 3
    assert all(o is None for o in out[nplanes:])
    for backend in ("pallas", "xla"):
        want = grain_jax.apply_grain(
            y, cb, cr, jb, bd, sub_x, sub_y, mono, backend=backend, host_params=params
        )
        for pi in range(nplanes):
            _equal(out[pi], want[pi], f"{backend} plane {pi}")
            _equal(plain[pi], want[pi], f"apply_grain_reference vs {backend} plane {pi}")
    planes = [y, cb, cr][:nplanes]
    for i, p in enumerate(params):
        ref = grain_ref.apply_grain_frame(
            [pl[i].astype(np.int32) for pl in planes], p, bd, sub_x, sub_y
        )
        for pi in range(nplanes):
            _equal(out[pi][i], ref[pi], f"grain_ref frame {i} plane {pi}")


# 4:2:0 and monochrome; 4:2:2 and 4:4:4 are in test_torch_subsampling.py
# (id, sub_x, sub_y, mono, bit_depth, h, w, variant)
APPLY_CASES = [
    ("420-8-64x64-mixed", 1, 1, False, 8, 64, 64, "mixed"),
    ("420-10-40x301-mixed", 1, 1, False, 10, 40, 301, "mixed"),
    ("420-12-128x160-dense", 1, 1, False, 12, 128, 160, "dense"),
    ("420-8-40x99-mixed", 1, 1, False, 8, 40, 99, "mixed"),
    ("420-10-64x64-luma_only", 1, 1, False, 10, 64, 64, "luma_only"),
    ("mono-8-64x64", 1, 1, True, 8, 64, 64, "mono"),
    ("mono-12-70x100", 1, 1, True, 12, 70, 100, "mono"),
]


@pytest.mark.parametrize(
    "sub_x,sub_y,mono,bd,h,w,variant",
    [c[1:] for c in APPLY_CASES],
    ids=[c[0] for c in APPLY_CASES],
)
def test_apply_grain_matches_jax_and_ref(sub_x, sub_y, mono, bd, h, w, variant):
    check_apply(sub_x, sub_y, mono, bd, h, w, variant)


def test_luma_only_batch_returns_chroma_untouched():
    params = _params("luma_only")
    y, cb, cr = _frames(len(params), 64, 64, 8, 1, 1, False)
    cb_t, cr_t = _t(cb), _t(cr)
    pb = tg.pack_params(params, "cpu")
    assert not pb.touches_chroma
    _, cb_o, cr_o = tg.apply_grain(_t(y), cb_t, cr_t, pb, 8)
    assert cb_o is cb_t and cr_o is cr_t


def test_apply_grain_needs_patterns():
    """The patterns are made on the tensors' device, inside the batch's
    parameter program (the pattern kernel's plain version here): the same
    planes as ``apply_grain_reference`` on grain_ref's patterns."""
    params = _params("mixed")
    y, cb, cr = _frames(len(params), 32, 32, 8, 1, 1, False)
    pb = tg.pack_params(params, "cpu")
    got = tg.apply_grain(_t(y), _t(cb), _t(cr), pb, 8)
    want = tg.apply_grain_reference(_t(y), _t(cb), _t(cr), *ref_patterns(params, 8, 1, 1, False),
                                    pb, 8)
    for pi in range(3):
        assert torch.equal(got[pi], want[pi].to(torch.int16)), f"plane {pi}"


# ---------------------------------------------------------------------------
# The pieces


def _param_zoo():
    zoo = _params("mixed") + _params("dense") + _params("luma_only")
    lag0 = sample_grain_params(seed=1)
    lag0.ar_coeff_lag = 0
    lag0.ar_coeffs_y, lag0.ar_coeffs_cb, lag0.ar_coeffs_cr = [], [1], [-1]
    lag3 = sample_grain_params(seed=2)
    lag3.ar_coeff_lag = 3
    lag3.ar_coeffs_y = list(range(-12, 12))
    lag3.ar_coeffs_cb = list(range(-12, 13))
    lag3.ar_coeffs_cr = list(range(12, -13, -1))
    nothing = sample_grain_params(seed=65535)
    nothing.scaling_points_y = nothing.scaling_points_cb = nothing.scaling_points_cr = []
    return zoo + [lag0, lag3, nothing]


def test_pack_params_matches_jax():
    params = _param_zoo()
    mine = tg.pack_params(params, "cpu")
    theirs = grain_jax.pack_params(params)
    for name in tg.PARAM_COLUMNS:
        _equal(getattr(mine, name), getattr(theirs, name), name)
        assert getattr(mine, name).dtype == torch.int32, name
    assert mine.batch == len(params)


def _port(p, **changes):
    """``p`` as the port's own FilmGrainParams (its lists copied), with
    ``changes``."""
    return PortParams(**{**dataclasses.asdict(p), **changes})


def _reseeded(p, n, first=1000):
    """``n`` copies of ``p``, each with a seed of its own."""
    return [_port(p, grain_seed=first + 97 * i) for i in range(n)]


def _changed(value):
    """Another value of a table field's type: a flag flipped, a number
    moved, a point's y or the first coefficient changed."""
    if isinstance(value, bool):
        return not value
    if isinstance(value, int):
        return value + 1
    if value and isinstance(value[0], (tuple, list)):
        (x, y), *rest = value
        return [(x, y ^ 1), *rest]
    return [value[0] ^ 1, *value[1:]]


def _lag_table(lag):
    n = 2 * lag * (lag + 1)
    return _port(
        sample_grain_params(seed=1), ar_coeff_lag=lag,
        ar_coeffs_y=[(5 * i + 3) % 19 - 9 for i in range(n)],
        ar_coeffs_cb=[(3 * i + 1) % 17 - 8 for i in range(n + 1)],
        ar_coeffs_cr=[(7 * i + 2) % 23 - 11 for i in range(n + 1)],
    )


def _luma_only(**changes):
    # chroma coefficients left in place: an inactive plane packs zeros
    return _port(sample_grain_params(seed=2), scaling_points_cb=[], scaling_points_cr=[],
                 **changes)


def _from_luma(**changes):
    return _port(sample_grain_params(seed=3), chroma_scaling_from_luma=True,
                 scaling_points_cb=[], scaling_points_cr=[], **changes)


_A = sample_grain_params(seed=11)
_B = _port(_A, cb_offset=200, ar_coeff_lag=1, ar_coeffs_y=[1, 2, 3, 4])
# the fields equal_ignoring_seed compares: every field of the table but the seed
TABLE_FIELDS = [f.name for f in dataclasses.fields(PortParams) if f.name != "grain_seed"]

# case -> (the batch, the rows it builds: one a run of frames whose tables
# are equal ignoring the seed)
PACK_CASES = {
    "one_table_new_seeds": (lambda: _reseeded(_A, 8), 1),
    "every_frame_another_table": (lambda: [_port(p) for p in _param_zoo()], len(_param_zoo())),
    "A_A_B_B_A": (lambda: _reseeded(_A, 2) + _reseeded(_B, 2, 5) + _reseeded(_A, 1, 9), 3),
    "lag_0": (lambda: _reseeded(_lag_table(0), 3) + _reseeded(_lag_table(2), 2), 2),
    "lag_3": (lambda: _reseeded(_lag_table(3), 3) + _reseeded(_lag_table(1), 2), 2),
    "luma_only": (lambda: _reseeded(_luma_only(), 3) + _reseeded(_luma_only(overlap_flag=False), 2), 2),
    # luma's points gone: the chroma planes keep their coefficients, not slot 24
    "chroma_scaling_from_luma": (
        lambda: _reseeded(_from_luma(), 3) + _reseeded(_from_luma(scaling_points_y=[]), 2), 2),
    "no_points": (lambda: _reseeded(_port(_A, scaling_points_y=[], scaling_points_cb=[],
                                          scaling_points_cr=[]), 3) + _reseeded(_A, 1), 2),
    # equal values, yet a list of lists is not equal to a list of tuples:
    # two runs, the same rows
    "points_lists_and_tuples": (lambda: _reseeded(_A, 2) + _reseeded(_port(
        _A, **{k: [list(pt) for pt in getattr(_A, k)] for k in
               ("scaling_points_y", "scaling_points_cb", "scaling_points_cr")}), 2), 2),
    **{f"differs_in_{name}": (
        lambda name=name: _reseeded(_A, 2) + _reseeded(
            _port(_A, **{name: _changed(getattr(_A, name))}), 2, 7), 2)
       for name in TABLE_FIELDS},
}


@pytest.mark.parametrize("case", list(PACK_CASES))
def test_pack_params_builds_one_row_a_run(case):
    """Every column equal to the JAX package's ``pack_params``, with one
    row built a run of frames that share a table."""
    make, runs = PACK_CASES[case]
    params = make()
    frames, rows = spans.counter("pack.frames"), spans.counter("pack.rows")
    mine = tg.pack_params(params, "cpu")
    assert spans.counter("pack.frames") - frames == len(params)
    assert spans.counter("pack.rows") - rows == runs
    theirs = grain_jax.pack_params(params)
    for name in tg.PARAM_COLUMNS:
        _equal(getattr(mine, name), getattr(theirs, name), f"{case}: {name}")
    assert mine.buffer.shape == (len(params), tg.PARAMS_WIDTH)


def test_pack_params_reads_tables_edited_in_place():
    """Nothing is kept between calls: a table edited in place between two
    batches packs to its new values, beside copies of its old ones."""
    t = _port(sample_grain_params(seed=5))
    params = [t, t] + _reseeded(t, 2)
    before = tg.pack_params(params, "cpu").buffer.clone()
    t.cb_mult += 7
    t.scaling_points_y[1] = (40, 77)
    t.ar_coeffs_cr[0] = 9
    after = tg.pack_params(params, "cpu")
    theirs = grain_jax.pack_params(params)
    for name in tg.PARAM_COLUMNS:
        _equal(getattr(after, name), getattr(theirs, name), name)
    assert not torch.equal(after.buffer[:2], before[:2])
    assert torch.equal(after.buffer[2:], before[2:])


@pytest.mark.parametrize("nbits", [8, 11])
def test_lfsr_outputs_matches_jax(nbits):
    seeds = np.random.default_rng(3).integers(0, 1 << 16, 37).astype(np.int32)
    mine = tg.lfsr_outputs(torch.from_numpy(seeds), 300, nbits)
    _equal(mine, grain_jax.lfsr_outputs(seeds, 300, nbits), "lfsr")


def test_block_offsets_matches_jax_and_ref():
    seeds = np.asarray([0, 1, 777, 0xB524, 65535], dtype=np.int32)
    mine = tg.block_offsets(torch.from_numpy(seeds), 68, 120)
    _equal(mine, grain_jax.block_offsets(seeds, 68, 120), "grain_jax.block_offsets")
    for i, s in enumerate(seeds):
        _equal(mine[i], grain_ref._block_offsets(int(s), 68, 120), f"seed {s}")


CURVES = {
    "sample": sample_grain_params().scaling_points_y,
    "dense": DENSE_Y,
    "extreme": EXTREME_Y,
    "single": [(64, 100)],
    "empty": [],
}


@pytest.mark.parametrize("bd", [8, 10, 12])
def test_scaling_matches_ref_lut(bd):
    names = list(CURVES)
    fake = [sample_grain_params() for _ in names]
    for p, n in zip(fake, names):
        p.scaling_points_y = CURVES[n]
    pt = tg.pack_params(fake, "cpu")
    lut8 = tg.scaling_lut(pt.pts_y, pt.num_y)
    v = torch.arange(1 << bd, dtype=torch.int32).expand(len(names), -1)
    by_lut = tg.lut_scale(v, lut8, bd)
    closed = tg.scaling_lookup(v, pt.pts_y, pt.num_y, bd)
    for i, n in enumerate(names):
        _equal(lut8[i], grain_ref.build_scaling_lut(CURVES[n], 8), f"{n} lut8")
        want = grain_ref.build_scaling_lut(CURVES[n], bd)
        _equal(by_lut[i], want, f"{n} lut_scale {bd}-bit")
        _equal(closed[i], want, f"{n} scaling_lookup {bd}-bit")


# pack_plane_params row slot -> grain_pallas.pack_plane_params slot
_PALLAS_SLOTS = {
    gk.P_ACTIVE: grain_pallas.P_ACTIVE,
    gk.P_SCALING_SHIFT: grain_pallas.P_SCALING_SHIFT,
    gk.P_OVERLAP: grain_pallas.P_OVERLAP,
    gk.P_CLIP_LO: grain_pallas.P_CLIP_LO,
    gk.P_CLIP_HI: grain_pallas.P_CLIP_HI,
    gk.P_GMIN: grain_pallas.P_GMIN,
    gk.P_GMAX: grain_pallas.P_GMAX,
    gk.P_USE_MULT: grain_pallas.P_USE_MULT,
    gk.P_MULT: grain_pallas.P_MULT,
    gk.P_LUMA_MULT: grain_pallas.P_LUMA_MULT,
    gk.P_OFFSET: grain_pallas.P_OFFSET,
}


@pytest.mark.parametrize("plane", ["y", "cb", "cr"])
@pytest.mark.parametrize("bd", [8, 12])
def test_pack_plane_params_matches_pallas(plane, bd):
    params = _param_zoo()
    jb = grain_jax.pack_params(params)
    mine = gk.pack_plane_params(tg.from_jax_params(jb, "cpu"), plane, bd)
    theirs = np.asarray(grain_pallas.pack_plane_params(jb, plane, bd))
    for slot, pslot in _PALLAS_SLOTS.items():
        _equal(mine[:, slot], theirs[:, pslot], f"slot {slot}")
    for i, p in enumerate(params):
        pts = p.scaling_points_y
        if plane != "y" and not p.chroma_scaling_from_luma:
            pts = p.scaling_points_cb if plane == "cb" else p.scaling_points_cr
        _equal(mine[i, gk.P_LUT :], grain_ref.build_scaling_lut(pts, 8), f"frame {i} lut")


@pytest.mark.parametrize("sub_x,sub_y", [(0, 0), (1, 0), (1, 1)])
@pytest.mark.parametrize("overlap", [False, True])
def test_noise_plane_matches_ref(sub_x, sub_y, overlap):
    p = sample_grain_params(seed=1234)
    h, w = 75, 107
    hc, wc = (h + sub_y) >> sub_y, (w + sub_x) >> sub_x
    pats = grain_ref.generate_grain(p, 10, False, sub_x, sub_y)
    offs = grain_ref._block_offsets(p.grain_seed, (h + 31) // 32, (w + 31) // 32)
    got = tg._noise_plane(
        torch.from_numpy(pats.cb)[None], torch.from_numpy(offs)[None], hc, wc,
        sub_x, sub_y, torch.tensor([int(overlap)]),
        torch.tensor([pats.grain_min]), torch.tensor([pats.grain_max]),
    )
    want = grain_ref.assemble_noise_plane(
        pats.cb, offs, hc, wc, sub_x, sub_y, overlap, pats.grain_min, pats.grain_max
    )
    _equal(got[0], want, "noise plane")
