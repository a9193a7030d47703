"""The benchmark's inputs, made from ``--seed``: film-like frames, grainy
copies of them, and film-grain tables.

Frames are made on the run's device with a ``torch.Generator`` seeded
from the seed, a frame at a time into one batch tensor per plane, and
copied to the host in one copy per plane where a cell starts from host
memory. Small scalar choices (gradients, periods, the disc's path, the
noise strength, the tables) come from a numpy generator on the same seed.
The same seed gives the same inputs on the same kind of device.

- ``film_frames``: gradients, a periodic texture, a smooth random field,
  a bright disc that moves from frame to frame, and an exposure wobble:
  the idea of the repository's ``chip_smoke.film_frames``, in torch.
- ``grainy``: a frame plus intensity-scaled, spatially correlated
  Gaussian noise (a 3x3 binomial blur of white noise), the benchmark's
  own grain and never the port's.
- ``draw_tables``: one table shape drawn within AV1's ranges
  (spec section 5.9.30), then a different 16-bit ``grain_seed`` a frame.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

SEED_MOD = 1 << 63


def numpy_rng(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator for one purpose (``stream``) of one seed."""
    return np.random.default_rng([seed % SEED_MOD, stream])


def torch_gen(seed: int, stream: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed((seed * 1000003 + stream) % SEED_MOD)
    return gen


def plane_shapes(config: dict) -> List[Tuple[int, int]]:
    h, w = config["height"], config["width"]
    if config["planes"] == 1:
        return [(h, w)]
    sx, sy = config["subsampling"]
    hc, wc = (h + sy) >> sy, (w + sx) >> sx
    return [(h, w), (hc, wc), (hc, wc)]


def _field(gen, n, h, w, cell, device):
    """(n, h, w) smooth random fields in about [-1, 1]: Gaussian samples on
    a grid of ``cell``-sample squares, interpolated bilinearly."""
    coarse = torch.randn((n, 1, h // cell + 2, w // cell + 2), generator=gen, device=device)
    return F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=False)[:, 0] * 0.5


def film_frames(seed: int, n: int, config: dict, device) -> List[torch.Tensor]:
    """``n`` clean frames: one int16 (n, H, W) tensor per plane on
    ``device``, samples at the configuration's bit depth."""
    bd = config["bit_depth"]
    scale = float(1 << (bd - 8))
    rng = numpy_rng(seed, 1)
    gen = torch_gen(seed, 1, device)
    shapes = plane_shapes(config)
    h, w = shapes[0]
    base, gx, gy = rng.uniform(30, 70), rng.uniform(80, 140), rng.uniform(-40, 40)
    tex, px, py = rng.uniform(4, 12), rng.uniform(5, 11), rng.uniform(6, 13)
    disc_amp, disc_r = rng.uniform(40, 90), rng.uniform(0.05, 0.12) * w
    disc_x0, disc_dx, disc_y = rng.uniform(0.1, 0.5) * w, rng.uniform(0.002, 0.01) * w, rng.uniform(0.3, 0.7) * h
    wobble, phase = rng.uniform(0.01, 0.05), rng.uniform(0, 2 * np.pi)
    xx = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    yy = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    still = base + gx * xx / w + gy * yy / h + tex * torch.sin(xx / px) * torch.cos(yy / py)
    out = [torch.empty((n,) + s, dtype=torch.int16, device=device) for s in shapes]
    for i in range(n):
        field = _field(gen, 1, h, w, 64, device)[0] * 10
        cx = disc_x0 + disc_dx * i
        disc = disc_amp * torch.exp(-((xx - cx) ** 2 + (yy - disc_y) ** 2) / (2 * disc_r**2))
        gain = 1 + wobble * np.sin(0.7 * i + phase)
        y = (still + field + disc) * gain * scale
        out[0][i] = torch.clamp(y, 16 * scale, 235 * scale).round().to(torch.int16)
    if len(shapes) == 3:
        hc, wc = shapes[1]
        cxx = torch.arange(wc, device=device, dtype=torch.float32)[None, :]
        cyy = torch.arange(hc, device=device, dtype=torch.float32)[:, None]
        u0, v0 = rng.uniform(100, 140), rng.uniform(110, 150)
        for i in range(n):
            fu, fv = _field(gen, 2, hc, wc, 32, device) * 6
            u = (u0 + 30 * cxx / wc + fu) * scale
            v = (v0 - 20 * cyy / hc + fv) * scale
            out[1][i] = torch.clamp(u, 16 * scale, 240 * scale).round().to(torch.int16)
            out[2][i] = torch.clamp(v, 16 * scale, 240 * scale).round().to(torch.int16)
    return out


def grainy(seed: int, clean: List[torch.Tensor], config: dict) -> List[torch.Tensor]:
    """``clean`` plus the benchmark's grain: per sample sigma(I) times
    unit-variance correlated noise, sigma rising with the sample's
    intensity, weaker on chroma; rounded and clipped to the bit depth."""
    bd = config["bit_depth"]
    scale = float(1 << (bd - 8))
    maxv = (1 << bd) - 1
    rng = numpy_rng(seed, 2)
    gen = torch_gen(seed, 2, clean[0].device)
    s0, s1 = rng.uniform(1.5, 3.0), rng.uniform(1.0, 4.0)
    k = torch.tensor([1.0, 2.0, 1.0], device=clean[0].device)
    k2 = (k[:, None] * k[None, :]) / 16
    k2 = (k2 / k2.square().sum().sqrt())[None, None]  # unit variance out
    out = []
    for p, plane in enumerate(clean):
        gain = 1.0 if p == 0 else 0.6
        dst = torch.empty_like(plane)
        for i in range(plane.shape[0]):
            white = torch.randn((1, 1) + tuple(plane.shape[1:]), generator=gen, device=plane.device)
            noise = F.conv2d(white, k2, padding=1)[0, 0]
            v = plane[i].to(torch.float32)
            sigma = gain * (s0 + s1 * v / maxv) * scale
            dst[i] = torch.clamp(v + sigma * noise, 0, maxv).round().to(torch.int16)
        out.append(dst)
    return out


def to_host(planes: List[torch.Tensor], bit_depth: int) -> List[List[np.ndarray]]:
    """Device plane batches -> per-frame plane lists as a decoder hands
    them: uint8 at 8 bits, uint16 above, one copy per plane."""
    if bit_depth == 8:
        host = [p.to(torch.uint8).cpu().numpy() for p in planes]
    else:
        host = [p.cpu().numpy().view(np.uint16) for p in planes]
    return [[h[i] for h in host] for i in range(planes[0].shape[0])]


def _points(rng, n: int) -> List[Tuple[int, int]]:
    """``n`` scaling points with strictly increasing x in [0, 255]."""
    if n == 0:
        return []
    xs = np.sort(rng.choice(256, size=n, replace=False))
    ys = rng.integers(16, 97, size=n)
    return [(int(x), int(y)) for x, y in zip(xs, ys)]


def draw_tables(seed: int, grain: dict, n: int) -> List[Dict]:
    """``n`` per-frame tables of one shape: the fields of AV1's
    ``film_grain_params`` (the names of ``FilmGrainParams``), drawn within
    the spec's ranges, ``grain_seed`` new each frame. ``grain`` gives the
    shape: y_points, cb_points, cr_points, ar_lag, overlap,
    chroma_scaling_from_luma, clip_to_restricted_range."""
    rng = numpy_rng(seed, 3)
    lag = grain["ar_lag"]
    n_pos = 2 * lag * (lag + 1)
    has_y = grain["y_points"] > 0

    def coeffs(extra: int) -> List[int]:
        return [int(c) for c in rng.integers(-24, 25, size=n_pos + extra)]

    base = dict(
        scaling_points_y=_points(rng, grain["y_points"]),
        scaling_points_cb=_points(rng, grain["cb_points"]),
        scaling_points_cr=_points(rng, grain["cr_points"]),
        scaling_shift=int(rng.integers(8, 12)),
        ar_coeff_lag=lag,
        ar_coeffs_y=coeffs(0) if has_y else [],
        ar_coeffs_cb=coeffs(int(has_y)),
        ar_coeffs_cr=coeffs(int(has_y)),
        ar_coeff_shift=int(rng.integers(6, 10)),
        cb_mult=int(rng.integers(96, 225)),
        cb_luma_mult=int(rng.integers(96, 225)),
        cb_offset=int(rng.integers(192, 321)),
        cr_mult=int(rng.integers(96, 225)),
        cr_luma_mult=int(rng.integers(96, 225)),
        cr_offset=int(rng.integers(192, 321)),
        chroma_scaling_from_luma=bool(grain["chroma_scaling_from_luma"]),
        grain_scale_shift=0,
        overlap_flag=bool(grain["overlap"]),
        clip_to_restricted_range=bool(grain["clip_to_restricted_range"]),
    )
    seeds = rng.integers(0, 1 << 16, size=n)
    return [dict(base, grain_seed=int(s)) for s in seeds]
