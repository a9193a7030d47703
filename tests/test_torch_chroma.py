"""The port's single-chroma-plane grain kernel (``apply_plane_chroma``,
the counterpart of ``grain_pallas.apply_plane_chroma``), on the CPU.

On CPU tensors the wrapper runs its plain PyTorch version. The same numpy
inputs, made from a seed, go through it, through the Pallas kernel in
interpret mode and through ``grain_ref.apply_grain_frame``. Grain
synthesis is integer arithmetic: tolerance 0. The CUDA kernel itself is
held against the plain version by tests/test_torch_cuda.py (skipped
without a GPU) and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from grav1synth_tpu.container.ffshim import generate_patterns_native
from grav1synth_tpu.ops import grain_jax, grain_pallas, grain_ref
from grav1synth_tpu_torch.ops import grain as tg
from grav1synth_tpu_torch.ops import grain_kernels as gk

from test_torch_grain import _equal, _frames, _params

CASES = [
    # sub_x, sub_y, bd, h, w, planes held to the Pallas kernel
    (1, 1, 10, 70, 100, ("cb", "cr")),
    (1, 0, 12, 64, 64, ("cb",)),
    (0, 0, 8, 48, 80, ("cb",)),
    (1, 1, 8, 40, 301, ("cb", "cr")),
]


def _setup(sub_x, sub_y, bd, h, w):
    # a batch that mixes csfl, overlap off and the restricted clip
    params = _params("mixed")
    y, cb, cr = _frames(len(params), h, w, bd, sub_x, sub_y, False, seed=h + w)
    jb = grain_jax.pack_params(params)
    pats = generate_patterns_native(params, bd, sub_x, sub_y, False)
    offs = np.array(grain_jax.block_offsets(jb.seed, (h + 31) // 32, (w + 31) // 32))
    hc, wc = cb.shape[1:]
    avg = np.asarray(grain_jax._avg_luma(y.astype(np.int32), hc, wc, sub_x, sub_y))
    return params, jb, (y, cb, cr), pats, offs, avg


@pytest.mark.parametrize("sub_x,sub_y,bd,h,w,jax_planes", CASES)
def test_chroma_plain_matches_pallas_and_grain_ref(sub_x, sub_y, bd, h, w, jax_planes):
    params, jb, (y, cb, cr), (_, cbp, crp), offs, avg = _setup(sub_x, sub_y, bd, h, w)
    pt = tg.from_jax_params(jb, "cpu")
    got = {}
    for plane, src, pat in (("cb", cb, cbp), ("cr", cr, crp)):
        out = gk.apply_plane_chroma(
            torch.from_numpy(src), torch.from_numpy(avg.astype(np.int16)),
            torch.from_numpy(pat.astype(np.int16)), torch.from_numpy(offs),
            gk.pack_plane_params(pt, plane, bd), bd, sub_x, sub_y,
        )
        assert out.dtype == torch.int16 and tuple(out.shape) == src.shape
        got[plane] = out
        if plane in jax_planes:
            want = grain_pallas.apply_plane_chroma(
                src.astype(np.int32), avg, pat, offs,
                grain_pallas.pack_plane_params(jb, plane, bd), bd, sub_x, sub_y,
            )
            _equal(out, want, f"{plane} vs pallas")
    for i, p in enumerate(params):
        ref = grain_ref.apply_grain_frame(
            [y[i].astype(np.int32), cb[i].astype(np.int32), cr[i].astype(np.int32)],
            p, bd, sub_x, sub_y,
        )
        _equal(got["cb"][i], ref[1], f"frame {i} cb vs grain_ref")
        _equal(got["cr"][i], ref[2], f"frame {i} cr vs grain_ref")
    # the inactive planes of the batch pass through; the active ones change
    assert not torch.equal(got["cb"], torch.from_numpy(cb))


@pytest.mark.parametrize("sub_x,sub_y,bd,h,w,jax_planes", CASES)
def test_chroma_plain_with_offsets_wider_than_the_plane_matches_pallas(
    sub_x, sub_y, bd, h, w, jax_planes
):
    """Offsets of more blocks than the plane has, as many as the Pallas
    kernel's 128-lane row holds: the stripes and blocks are the offsets',
    the plane only reads its own."""
    params, jb, (y, cb, cr), (_, cbp, crp), offs, avg = _setup(sub_x, sub_y, bd, h, w)
    wcpad = (cb.shape[2] + 127) // 128 * 128
    nb = wcpad // (32 >> sub_x)
    assert nb > offs.shape[2]
    wide = np.array(grain_jax.block_offsets(jb.seed, offs.shape[1], nb))
    pt = tg.from_jax_params(jb, "cpu")
    for plane, src, pat in (("cb", cb, cbp), ("cr", cr, crp)):
        out = gk.apply_plane_chroma(
            torch.from_numpy(src), torch.from_numpy(avg.astype(np.int16)),
            torch.from_numpy(pat.astype(np.int16)), torch.from_numpy(wide),
            gk.pack_plane_params(pt, plane, bd), bd, sub_x, sub_y,
        )
        want = grain_pallas.apply_plane_chroma(
            src.astype(np.int32), avg, pat, wide,
            grain_pallas.pack_plane_params(jb, plane, bd), bd, sub_x, sub_y,
        )
        _equal(out, want, f"{plane} vs pallas, {nb} blocks")


@pytest.mark.parametrize("sub_x,sub_y,bd,h,w,jax_planes", CASES)
def test_chroma_plain_with_offsets_taller_than_the_plane_matches_grain_ref(
    sub_x, sub_y, bd, h, w, jax_planes
):
    """Offsets of two stripes and five blocks more than the plane has give
    the plane's own grain: equal to grain_ref and to the Pallas kernel on
    the plane's own offsets. (The Pallas kernel itself, on such offsets,
    runs its stripes past the plane on the last block of rows, whose
    window its interpret mode clamps into the plane, and writes their
    grain over it: a fault of the reference that the port does not
    share.)"""
    params, jb, (y, cb, cr), (_, cbp, crp), offs, avg = _setup(sub_x, sub_y, bd, h, w)
    tall = np.array(grain_jax.block_offsets(jb.seed, offs.shape[1] + 2, offs.shape[2] + 5))
    pt = tg.from_jax_params(jb, "cpu")
    got = {}
    for plane, src, pat in (("cb", cb, cbp), ("cr", cr, crp)):
        got[plane] = gk.apply_plane_chroma(
            torch.from_numpy(src), torch.from_numpy(avg.astype(np.int16)),
            torch.from_numpy(pat.astype(np.int16)), torch.from_numpy(tall),
            gk.pack_plane_params(pt, plane, bd), bd, sub_x, sub_y,
        )
        want = grain_pallas.apply_plane_chroma(
            src.astype(np.int32), avg, pat, offs,
            grain_pallas.pack_plane_params(jb, plane, bd), bd, sub_x, sub_y,
        )
        _equal(got[plane], want, f"{plane} vs pallas on the plane's offsets")
    for i, p in enumerate(params):
        ref = grain_ref.apply_grain_frame(
            [y[i].astype(np.int32), cb[i].astype(np.int32), cr[i].astype(np.int32)],
            p, bd, sub_x, sub_y,
        )
        _equal(got["cb"][i], ref[1], f"frame {i} cb vs grain_ref")
        _equal(got["cr"][i], ref[2], f"frame {i} cr vs grain_ref")


def test_chroma_plain_equals_the_pair_per_plane():
    """Cb and Cr one at a time, with the pair's luma average, give the
    chroma-pair kernel's planes."""
    params = _params("dense")
    bd, h, w = 10, 66, 130
    y, cb, cr = (torch.from_numpy(a) for a in _frames(len(params), h, w, bd, 1, 1, False))
    lp, cbp, crp = (
        torch.from_numpy(a.astype(np.int16))
        for a in tg.generate_patterns_ref(params, bd, 1, 1)
    )
    pb = tg.pack_params(params, "cpu")
    offs = tg.block_offsets(pb.seed, (h + 31) // 32, (w + 31) // 32)
    p_cb, p_cr = (gk.pack_plane_params(pb, pl, bd) for pl in ("cb", "cr"))
    want_cb, want_cr = gk.apply_planes_pair(
        y, cb, cr, cbp, crp, offs, torch.cat([p_cb, p_cr]), bd, 1, 1
    )
    avg = tg._avg_luma(y.to(torch.int32), cb.shape[1], cb.shape[2], 1, 1).to(torch.int16)
    assert torch.equal(gk.apply_plane_chroma(cb, avg, cbp, offs, p_cb, bd, 1, 1), want_cb)
    assert torch.equal(gk.apply_plane_chroma(cr, avg, crp, offs, p_cr, bd, 1, 1), want_cr)


def test_chroma_wrapper_refuses_other_devices():
    meta = torch.empty((1, 16, 16), dtype=torch.int16, device="meta")
    with pytest.raises(ValueError, match="one CUDA device or on the CPU"):
        gk.apply_plane_chroma(
            meta, meta, torch.zeros((1, 38, 44), dtype=torch.int16),
            torch.zeros((1, 1, 1), dtype=torch.int32),
            torch.zeros((1, gk.P_LEN), dtype=torch.int32), 8, 1, 1,
        )
