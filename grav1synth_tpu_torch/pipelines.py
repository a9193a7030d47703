"""The render, diff and estimate pipelines on the PyTorch port
(counterparts of grav1synth_tpu.pipelines.render, .diff and .estimate).

Decode (dav1d) and header parsing run on the host through the JAX
package's host classes, which contain no JAX. ``render`` sends each
batch of frames through ``ops.grain.apply_grain`` on ``device`` (or, with
``shards``, through ``parallel.sharded_apply`` over a device mesh); its
output is byte-identical to ``grav1synth_tpu render`` and to dav1d's own
grain synthesis. ``diff`` sends each batch of frame pairs through
``ops.diff_estimate.DiffEstimator`` on ``device``, and ``estimate`` each
batch of grainy frames through ``ops.estimate.NoiseEstimator``; their
grain tables are identical to ``grav1synth_tpu diff``'s and
``estimate``'s.
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional

import numpy as np
import torch

from grav1synth_tpu.obu import Av1Parser, GrainTableSegment
from grav1synth_tpu.pipelines import GrainFrameState, VideoFile, _decodable, _grain_visible
from grav1synth_tpu.utils.progress import Progress

from .ops import grain as grain_ops
from .parallel.mesh import DeviceMesh, make_mesh, pad_batch, sharded_apply

log = logging.getLogger("grav1synth")


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist (the port
    never falls back to the CPU behind the caller's back)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the plain "
            "PyTorch path explicitly"
        )
    return device


def device_mesh(device: torch.device, shards: int) -> Optional[DeviceMesh]:
    """The mesh ``--shards`` asks for, or None for one shard. On CUDA the
    first ``shards`` cards, clamped to the card count with the JAX
    package's warning; on the CPU, the CPU named ``shards`` times."""
    if shards <= 1:
        return None
    if device.type != "cuda":
        return DeviceMesh([device] * shards)
    n_dev = torch.cuda.device_count()
    if shards > n_dev:
        log.warning(
            "--shards %d exceeds %d available devices; using %d", shards, n_dev, n_dev
        )
        shards = n_dev
    return make_mesh(shards) if shards > 1 else None


def _pinned(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``host`` in pinned memory when it is bound for a CUDA device."""
    return host.pin_memory() if device.type == "cuda" else host


def _upload(planes: List[np.ndarray], device: torch.device) -> torch.Tensor:
    host = torch.from_numpy(np.stack(planes).astype(np.int16))
    return _pinned(host, device).to(device, non_blocking=True)


def _start_download(t: torch.Tensor, bit_depth: int) -> torch.Tensor:
    """Begin the device-to-host copy of a grained int16 plane batch in the
    mux dtype. 8-bit samples are cast to uint8 on the device first (half
    the bytes); above 8 bits the int16 samples (0..4095) are already the
    uint16 bytes, reinterpreted on the host."""
    if bit_depth == 8:
        t = t.to(torch.uint8)
    if t.device.type != "cuda":
        return t
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    return host


def _as_mux(t: torch.Tensor, bit_depth: int) -> np.ndarray:
    a = t.numpy()
    return a if bit_depth == 8 else a.view(np.uint16)


def render(
    input_path: str,
    output_path: str,
    batch: int = 16,
    grain: bool = True,
    progress: bool = True,
    shards: int = 1,
    stage_stats: Optional[dict] = None,
    device="cuda",
) -> int:
    """Decode an AV1 stream and write y4m with film grain synthesized on
    ``device``. Returns the frame count. ``shards`` > 1 spreads each
    batch's frames over a device mesh (``device_mesh``) through
    ``sharded_apply``, with patterns made on each device; the output is
    byte-identical to one shard's.

    Decode runs on a prefetch thread; each batch's kernels and its
    device-to-host copy are enqueued asynchronously, and the batch is
    muxed one batch later (a FIFO), so the host's mux of batch N overlaps
    the device's work on batch N+1.

    ``stage_stats``: optional dict filled with the wall seconds each
    stage spent on the driving thread: "decode", "dispatch" (param pack,
    pattern generation and upload, kernel launches), "download" (waiting
    for the device-to-host copies), "mux" (y4m writes)."""
    from grav1synth_tpu.container.ffshim import Decoder
    from grav1synth_tpu.container.y4m import Y4mWriter
    from grav1synth_tpu.utils.prefetch import maybe_prefetch

    device = resolve_device(device)
    mesh = device_mesh(device, shards)

    with VideoFile(input_path) as vf:
        parser = Av1Parser()
        state = GrainFrameState()
        params_q: List[Optional[object]] = []

        def packet_feed():
            for pkt in vf.packets():
                if not pkt.is_video:
                    continue
                for obu in parser.parse_packet(pkt.data, pkt.av1_ts, pkt.obu_extents):
                    if obu.frame is not None and not obu.is_redundant_frame_header:
                        shown, params = state.frame_params(obu.frame)
                        if shown:
                            params_q.append(params if grain else None)
                yield _decodable(pkt), pkt.pts

        dec = Decoder("libdav1d", apply_grain=False)
        writer: Optional[Y4mWriter] = None
        bar = Progress(total=vf.nb_frames or None, enabled=progress, unit="fr")
        pend: list = []  # [(Frame, params)]
        inflight: list = []  # dispatched batches awaiting download + mux
        frames_out = 0
        stats = stage_stats if stage_stats is not None else {}
        for k in ("decode", "dispatch", "download", "mux"):
            stats.setdefault(k, 0.0)

        def dispatch() -> None:
            if not pend:
                return
            t_disp = time.time()
            first = pend[0][0]
            bd, mono, sub = first.bit_depth, len(first.planes) == 1, first.subsampling
            todo = [i for i, (_, p) in enumerate(pend) if _grain_visible(p)]
            outs = [list(f.planes) for f, _ in pend]
            grained = None
            done = None
            if todo and mesh is not None:
                hp = [pend[i][1] for i in todo]
                stacked = [
                    np.stack([pend[i][0].planes[k] for i in todo]).astype(np.int16)
                    for k in range(1 if mono else 3)
                ]
                stacked, hp_p, nreal = pad_batch(stacked, hp, len(mesh))
                planes = [_pinned(torch.from_numpy(a), device) for a in stacked]
                y, cb, cr = planes if not mono else (planes[0], None, None)
                res = sharded_apply(
                    mesh, y, cb, cr, grain_ops.pack_params(hp_p, "cpu"), bd,
                    sub_x=sub[0], sub_y=sub[1], monochrome=mono,
                )
                res = [None if r is None else r[:nreal] for r in res]
            elif todo:
                hp = [pend[i][1] for i in todo]
                planes = [
                    _upload([pend[i][0].planes[k] for i in todo], device)
                    for k in range(1 if mono else 3)
                ]
                y, cb, cr = planes if not mono else (planes[0], None, None)
                res = grain_ops.apply_grain(
                    y, cb, cr, grain_ops.pack_params(hp, device), bd, sub[0], sub[1],
                    mono, host_params=hp,
                )
            if todo:
                # a luma-only batch returns cb/cr untouched: those planes
                # stay the decoder's own
                grained = [
                    None if r is None or r is src else _start_download(r, bd)
                    for r, src in zip(res, (y, cb, cr))
                ]
                if device.type == "cuda":
                    done = torch.cuda.Event()
                    done.record()
            inflight.append((todo, grained, done, outs, bd))
            pend.clear()
            stats["dispatch"] += time.time() - t_disp
            while len(inflight) > 1:
                drain()

        def drain() -> None:
            nonlocal frames_out
            if not inflight:
                return
            todo, grained, done, outs, bd = inflight.pop(0)
            if todo:
                t_dl = time.time()
                if done is not None:
                    done.synchronize()
                host = [None if g is None else _as_mux(g, bd) for g in grained]
                stats["download"] += time.time() - t_dl
                for k, i in enumerate(todo):
                    for pi, plane in enumerate(host):
                        if plane is not None:
                            outs[i][pi] = plane[k]
            t_mux = time.time()
            for planes in outs:
                writer.write_frame(planes)
                frames_out += 1
                bar.step()
            stats["mux"] += time.time() - t_mux

        def decoded_pairs():
            """Decode and pair each displayed frame with its parsed grain
            params; runs on the prefetch thread."""
            next_param = 0
            for frame in dec.decode_all(packet_feed()):
                if next_param >= len(params_q):
                    log.warning(
                        "decoder emitted frame %d with no parsed frame "
                        "header queued; treating it as grainless",
                        next_param,
                    )
                    params_q.append(None)
                params = params_q[next_param]
                next_param += 1
                yield frame, params

        def timed_source():
            it = iter(maybe_prefetch(decoded_pairs(), depth=batch))
            while True:
                t0 = time.time()
                try:
                    item = next(it)
                except StopIteration:
                    stats["decode"] += time.time() - t0
                    return
                stats["decode"] += time.time() - t0
                yield item

        def geometry(frame):
            return (
                frame.width, frame.height, frame.bit_depth, frame.subsampling,
                len(frame.planes),
            )

        for frame, params in timed_source():
            if writer is None:
                writer = Y4mWriter(
                    output_path, frame.width, frame.height, vf.fps,
                    frame.bit_depth, frame.subsampling,
                    monochrome=len(frame.planes) == 1,
                )
            if pend and geometry(frame) != geometry(pend[0][0]):
                dispatch()
            pend.append((frame, params))
            if len(pend) >= batch:
                dispatch()
        dispatch()
        while inflight:
            drain()
        dec.close()
        if writer is not None:
            writer.close()
        bar.done()
        log.info("Done, wrote %d frames to %s", frames_out, output_path)
        return frames_out


def diff(
    source_path: str,
    denoised_path: str,
    output_path: str,
    filters: Optional[str] = None,
    progress: bool = True,
    batch: int = 16,
    shards: int = 1,
    stage_stats: Optional[dict] = None,
    device="cuda",
) -> List[GrainTableSegment]:
    """Estimate a grain table from a grainy source and a denoised copy,
    both decoded to pixels by dav1d, and write it to ``output_path``.

    Both decoders run on prefetch threads; ``batch`` frame pairs at a
    time go through ``DiffEstimator.diff_batch`` on ``device`` (one
    upload per plane, one download of the batch's statistics). ``shards``
    > 1 spreads each batch over a device mesh (``device_mesh``). The table
    depends on neither ``batch`` nor ``shards``.

    ``stage_stats``: optional dict filled with the wall seconds the
    driving thread spent in "decode" (pulling both decoders) and
    "device" (diff_batch: upload, kernels, the statistics download and
    the host-side chunking)."""
    from grav1synth_tpu.container.ffshim import Decoder
    from grav1synth_tpu.tables import dump_table
    from grav1synth_tpu.utils.filters import FilterChain
    from grav1synth_tpu.utils.prefetch import maybe_prefetch

    from .ops.diff_estimate import DiffEstimator

    device = resolve_device(device)
    mesh = device_mesh(device, shards)
    chain = FilterChain.parse(filters) if filters else None

    with VideoFile(source_path) as vs, VideoFile(denoised_path) as vd:

        def frames_of(vf):
            dec = Decoder("libdav1d", apply_grain=False)
            return maybe_prefetch(
                dec.decode_all(
                    (_decodable(p), p.pts) for p in vf.packets() if p.is_video
                ),
                depth=batch,
            )

        src_it = frames_of(vs)
        den_it = frames_of(vd)
        est: Optional[DiffEstimator] = None
        bar = Progress(total=vs.nb_frames or None, enabled=progress, unit="fr")
        n = 0
        pend_src: list = []
        pend_den: list = []
        pend_geom = None
        stats = stage_stats if stage_stats is not None else {}
        stats.setdefault("decode", 0.0)
        stats.setdefault("device", 0.0)

        def flush():
            if pend_src:
                t0 = time.time()
                est.diff_batch(pend_src, pend_den, mesh=mesh)
                stats["device"] += time.time() - t0
                pend_src.clear()
                pend_den.clear()

        while True:
            t0 = time.time()
            sf = next(src_it, None)
            df = next(den_it, None)
            stats["decode"] += time.time() - t0
            if sf is None or df is None:
                if (sf is None) != (df is None):
                    log.warning(
                        "source and denoised have different frame counts; "
                        "stopping at the shorter stream"
                    )
                break
            src_planes = sf.planes
            if chain is not None:
                src_planes = chain.apply(src_planes, sf.bit_depth)
            if est is None:
                est = DiffEstimator(
                    vs.fps,
                    source_bit_depth=sf.bit_depth,
                    denoised_bit_depth=df.bit_depth,
                    device=device,
                )
            geom = tuple(p.shape for p in src_planes) + tuple(p.shape for p in df.planes)
            if pend_geom is not None and geom != pend_geom:
                flush()
            pend_geom = geom
            pend_src.append(list(src_planes))
            pend_den.append(list(df.planes))
            if len(pend_src) >= batch:
                flush()
            n += 1
            bar.step()
        flush()
        src_it.close()
        den_it.close()
        bar.done()
        segments = est.finish() if est is not None else []
        dump_table(segments, output_path)
        log.info("Done, wrote grain table to %s (%d frames)", output_path, n)
        return segments


ESTIMATE_BATCH = 16  # frames per NoiseEstimator.push_batch


def estimate(
    input_path: str,
    output_path: str,
    raw_output: Optional[str] = None,
    progress: bool = True,
    device="cuda",
) -> List[GrainTableSegment]:
    """Single-input noise estimation: decode the stream with its grain
    applied (dav1d, on a prefetch thread), feed batches of 16 frames
    through ``ops.estimate.NoiseEstimator`` on ``device`` (a batch also
    ends where the plane shapes change), and write the fitted grain table
    and, with ``raw_output``, one "index sigma" line per frame. Both files
    are byte-identical to ``grav1synth_tpu estimate``'s."""
    from grav1synth_tpu.container.ffshim import Decoder
    from grav1synth_tpu.tables import dump_table
    from grav1synth_tpu.utils.prefetch import maybe_prefetch

    from .ops.estimate import NoiseEstimator

    device = resolve_device(device)
    with VideoFile(input_path) as vf:
        dec = Decoder("libdav1d", apply_grain=True)
        est: Optional[NoiseEstimator] = None
        bar = Progress(total=vf.nb_frames or None, enabled=progress, unit="fr")
        pend: list = []
        frames = maybe_prefetch(
            dec.decode_all((_decodable(p), p.pts) for p in vf.packets() if p.is_video),
            depth=ESTIMATE_BATCH,
        )
        try:
            for frame in frames:
                if est is None:
                    est = NoiseEstimator(vf.fps, frame.bit_depth, device=device)
                if pend and [p.shape for p in pend[-1]] != [p.shape for p in frame.planes]:
                    est.push_batch(pend)
                    pend.clear()
                pend.append(list(frame.planes))
                if len(pend) >= ESTIMATE_BATCH:
                    est.push_batch(pend)
                    pend.clear()
                bar.step()
            if est is not None and pend:
                est.push_batch(pend)
        finally:
            frames.close()
        bar.done()
    segments = est.finish() if est is not None else []
    dump_table(segments, output_path)
    if raw_output and est is not None:
        with open(raw_output, "w") as fh:
            for i, s in enumerate(est.per_frame_sigma):
                fh.write(f"{i} {s:.4f}\n")
    log.info("Done, wrote grain table to %s", output_path)
    return segments
