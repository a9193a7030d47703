"""The port's grain kernels, one at a time.

On the CPU, each wrapper runs its plain PyTorch version; those are held
against the Pallas kernels they replace (interpret mode), fed the same
patterns, offsets and parameters through ``from_jax_params``, with
tolerance 0. The CUDA kernels themselves are held against the plain
versions by tests/test_torch_cuda.py (skipped without a GPU) and by
``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from grav1synth_tpu.container.ffshim import generate_patterns_native
from grav1synth_tpu.ops import grain_jax, grain_pallas
from grav1synth_tpu_torch.ops import grain as tg
from grav1synth_tpu_torch.ops import grain_kernels as gk

from test_torch_grain import _equal, _frames, _params


def _setup(variant, bd, h, w, sub_x, sub_y):
    params = _params(variant)
    y, cb, cr = _frames(len(params), h, w, bd, sub_x, sub_y, False)
    jb = grain_jax.pack_params(params)
    pats = generate_patterns_native(params, bd, sub_x, sub_y, False)
    offs = np.array(grain_jax.block_offsets(jb.seed, (h + 31) // 32, (w + 31) // 32))
    return params, jb, (y, cb, cr), pats, offs


@pytest.mark.parametrize(
    "bd,h,w,variant",
    [(8, 64, 64, "mixed"), (10, 70, 100, "dense"), (12, 40, 301, "mixed")],
)
def test_luma_plain_matches_pallas(bd, h, w, variant):
    _, jb, (y, _, _), (lp, _, _), offs = _setup(variant, bd, h, w, 1, 1)
    want = grain_pallas.apply_plane_luma(
        y, lp, offs, grain_pallas.pack_plane_params(jb, "y", bd), bd
    )
    got = gk.apply_plane_luma(
        torch.from_numpy(y), torch.from_numpy(lp.astype(np.int16)),
        torch.from_numpy(offs),
        gk.pack_plane_params(tg.from_jax_params(jb, "cpu"), "y", bd), bd,
    )
    assert got.dtype == torch.int16
    _equal(got, want, "luma")


PAIR_CASES = [
    (1, 1, 10, 70, 100, "mixed"),
    (1, 1, 8, 40, 99, "dense"),
    (1, 0, 12, 64, 64, "mixed"),
    (0, 0, 8, 40, 99, "mixed"),
]


@pytest.mark.parametrize("sub_x,sub_y,bd,h,w,variant", PAIR_CASES)
def test_pair_plain_matches_pallas_split(sub_x, sub_y, bd, h, w, variant):
    _, jb, (y, cb, cr), (lp, cbp, crp), offs = _setup(variant, bd, h, w, sub_x, sub_y)
    params3 = np.concatenate(
        [np.asarray(grain_pallas.pack_plane_params(jb, pl, bd)) for pl in ("y", "cb", "cr")]
    )
    _, want_cb, want_cr = grain_pallas.apply_planes_split(
        y, cb, cr, lp, cbp, crp, offs, params3, bd, sub_x, sub_y
    )
    pt = tg.from_jax_params(jb, "cpu")
    params2 = torch.cat([gk.pack_plane_params(pt, pl, bd) for pl in ("cb", "cr")])
    got_cb, got_cr = gk.apply_planes_pair(
        *(torch.from_numpy(a) for a in (y, cb, cr)),
        torch.from_numpy(cbp.astype(np.int16)), torch.from_numpy(crp.astype(np.int16)),
        torch.from_numpy(offs), params2, bd, sub_x, sub_y,
    )
    _equal(got_cb, want_cb, "cb")
    _equal(got_cr, want_cr, "cr")


@pytest.mark.parametrize("sub_x,sub_y,bd,h,w,variant", PAIR_CASES)
def test_fused_plain_matches_pallas_fused(sub_x, sub_y, bd, h, w, variant):
    """The fused kernel's plain version (the luma kernel's, then the
    chroma-pair kernel's) against the Pallas fused kernel, all three
    planes."""
    _, jb, (y, cb, cr), (lp, cbp, crp), offs = _setup(variant, bd, h, w, sub_x, sub_y)
    params3 = np.concatenate(
        [np.asarray(grain_pallas.pack_plane_params(jb, pl, bd)) for pl in ("y", "cb", "cr")]
    )
    want = grain_pallas.apply_planes_fused(
        y, cb, cr, lp, cbp, crp, offs, params3, bd, sub_x, sub_y
    )
    pt = tg.from_jax_params(jb, "cpu")
    params2 = torch.cat([gk.pack_plane_params(pt, pl, bd) for pl in ("cb", "cr")])
    got = gk.apply_planes_fused(
        *(torch.from_numpy(a) for a in (y, cb, cr)),
        *(torch.from_numpy(a.astype(np.int16)) for a in (lp, cbp, crp)),
        torch.from_numpy(offs), gk.pack_plane_params(pt, "y", bd), params2, bd, sub_x, sub_y,
    )
    for name, g, wnt in zip(("y", "cb", "cr"), got, want):
        assert g.dtype == torch.int16
        _equal(g, wnt, name)


def test_wrappers_refuse_other_devices():
    """A wrapper runs its plain version only for CPU tensors: tensors on
    any other device must launch the kernel or raise, never fall back."""
    meta = torch.empty((1, 32, 32), dtype=torch.int16, device="meta")
    with pytest.raises(ValueError, match="one CUDA device or on the CPU"):
        gk.apply_plane_luma(
            meta, torch.zeros((1, 73, 82), dtype=torch.int16),
            torch.zeros((1, 1, 1), dtype=torch.int32),
            torch.zeros((1, gk.P_LEN), dtype=torch.int32), 8,
        )

