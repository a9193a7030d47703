"""Entry points of the port (counterparts of ``__graft_entry__.py``).

``entry()`` returns the port's single-device grain step (patterns made on
the device, then the fused luma, Cb and Cr kernel) with example inputs.
``dryrun_multichip(n)`` runs one sharded application step with its
statistics, then the sharded diff statistics, over an n-entry mesh on
small shapes. Both run on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from .obu.types import FilmGrainParams


def _example_params(batch: int) -> List[FilmGrainParams]:
    return [
        FilmGrainParams(
            grain_seed=(777 + i * 10063) & 0xFFFF,
            scaling_points_y=[(0, 20), (128, 40), (255, 30)],
            scaling_points_cb=[(0, 10), (255, 12)],
            scaling_points_cr=[(0, 8), (255, 16)],
            scaling_shift=8,
            ar_coeff_lag=2,
            ar_coeffs_y=[3, -2, 5, 1, -7, 4, 2, -1, 6, 0, -3, 2],
            ar_coeffs_cb=[1, 0, -1, 2, 3, -2, 1, 0, -4, 2, 1, -1, 5],
            ar_coeffs_cr=[-2, 1, 0, -1, 2, 1, -3, 2, 0, 1, -2, 3, -6],
            ar_coeff_shift=6,
            cb_mult=128,
            cb_luma_mult=192,
            cb_offset=256,
            cr_mult=130,
            cr_luma_mult=190,
            cr_offset=250,
            overlap_flag=True,
        )
        for i in range(batch)
    ]


def _planes(rng, b: int, h: int, w: int, bit_depth: int, device) -> List[torch.Tensor]:
    """Random 4:2:0 planes as int16 on ``device``, drawn as
    ``__graft_entry__`` draws them (int32, then narrowed)."""
    shapes = ((b, h, w), (b, h // 2, w // 2), (b, h // 2, w // 2))
    return [
        torch.from_numpy(rng.integers(0, 1 << bit_depth, s, dtype=np.int32).astype(np.int16)).to(device)
        for s in shapes
    ]


def entry(device="cuda"):
    """(fn, example_args): the grain step on a 2 x 128 x 128 10-bit 4:2:0
    batch on ``device``."""
    from .ops.grain import apply_grain, pack_params
    from .pipelines import resolve_device

    device = resolve_device(device)
    bit_depth = 10
    b = 2
    y, cb, cr = _planes(np.random.default_rng(0), b, 128, 128, bit_depth, device)
    pb = pack_params(_example_params(b), device)

    def step(y, cb, cr, pb):
        return apply_grain(y, cb, cr, pb, bit_depth, 1, 1, False)

    return step, (y, cb, cr, pb)


def dryrun_multichip(n_devices: int, device="cuda") -> dict:
    """One sharded application step (frames over an ``n_devices`` mesh,
    energy and frame count summed) and the sharded per-frame diff
    statistics of its output against its input, on 64 x 64 8-bit 4:2:0
    frames, two per mesh entry. The mesh is ``make_mesh(n_devices)`` on
    CUDA, the CPU named ``n_devices`` times on the CPU. Returns the
    outputs."""
    from .ops.diff_estimate import mesh_pair_stats_per_frame
    from .ops.grain import pack_params
    from .parallel.mesh import DeviceMesh, make_mesh, sharded_apply_with_stats
    from .pipelines import resolve_device

    device = resolve_device(device)
    mesh = make_mesh(n_devices) if device.type == "cuda" else DeviceMesh([device] * n_devices)
    if len(mesh) != n_devices:
        raise RuntimeError(f"asked for {n_devices} devices, found {len(mesh)}")
    b = n_devices * 2
    bit_depth = 8
    y, cb, cr = _planes(np.random.default_rng(1), b, 64, 64, bit_depth, device)
    pb = pack_params(_example_params(b), device)

    y2, cb2, cr2, energy, frames = sharded_apply_with_stats(mesh, y, cb, cr, pb, bit_depth)
    assert y2.shape == y.shape
    assert int(frames) == b
    assert float(energy) > 0.0

    y_st, cb_st, cr_st = mesh_pair_stats_per_frame(
        mesh, y2, y, cb2, cb, cr2, cr,
        lag=2, bit_depth=bit_depth, sub_x=1, sub_y=1, has_chroma=True,
    )
    assert y_st["ata"].shape[0] == b
    n_ar = float(y_st["n_ar"].sum())
    assert n_ar > 0.0
    print(
        f"dryrun_multichip: {n_devices} devices OK "
        f"(frames={int(frames)}, noise_energy={float(energy):.1f}, diff_n_ar={n_ar:.0f})"
    )
    return dict(planes=(y2, cb2, cr2), energy=energy, frames=frames, stats=(y_st, cb_st, cr_st))
