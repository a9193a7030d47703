"""The pipelines of the PyTorch port.

The host pipelines (counterparts of grav1synth_tpu.pipelines, on this
package's own copy of the host layer: ``container``, ``obu``, ``tables``,
``ops.photon_noise``): ``inspect`` writes a grain table from a stream's
grain headers; ``apply_table``, ``generate`` and ``remove`` rewrite a
stream's grain headers; ``VideoFile`` reads IVF, raw AV1 and (through the
libav* shim) other containers; ``GrainFrameState`` resolves each displayed
frame's effective grain parameters. They run no device code, and their
output files are byte-identical to the JAX package's.

The device pipelines: ``render`` sends each batch of frames through
``ops.grain.apply_grain`` on ``device`` (or, with ``shards``, through
``parallel.sharded_apply`` over a device mesh); its output is
byte-identical to ``grav1synth_tpu render`` and to dav1d's own grain
synthesis. ``diff`` sends each batch of frame pairs through
``ops.diff_estimate.DiffEstimator`` on ``device``, and ``estimate`` each
batch of grainy frames through ``ops.estimate.NoiseEstimator``; their
grain tables are identical to ``grav1synth_tpu diff``'s and
``estimate``'s.
"""

from __future__ import annotations

import logging
import os
from dataclasses import dataclass
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from .container import annexb, ivf
from .obu import Av1Parser, GrainAction, GrainRewriter, GrainTableSegment
from .ops import grain as grain_ops
from .parallel.mesh import DeviceMesh, make_mesh, pad_frames, sharded_apply
from .tables import aggregate_grain_headers, dump_table, load_table
from .utils import spans
from .utils.progress import Progress

log = logging.getLogger("grav1synth")

TICKS = 10_000_000


def pts_to_av1_ts(pts: int, tb_num: int, tb_den: int) -> int:
    """FFmpeg pts -> AV1 1/10^7-s ticks, ceiling division (reference
    parser.rs:103-118)."""
    if pts < 0 or tb_den == 0:
        return 0
    return -(-pts * tb_num * TICKS // tb_den)


@dataclass
class VideoPacket:
    data: bytes
    pts: int
    dts: int
    duration: int
    flags: int
    av1_ts: int
    stream_index: int = 0
    is_video: bool = True
    # explicit per-OBU extents for framings whose OBU lengths live
    # outside the OBUs (Annex B); None = size-field/packet-end framing
    obu_extents: Optional[List[Tuple[int, int]]] = None


# raw elementary streams carry no timing; FFmpeg's AV1 demuxers assume
# 25 fps for them and the reference inherits that via libavformat
RAW_STREAM_FPS = 25


class VideoFile:
    """Unified video input: pure-IVF, raw AV1 (Annex B or bare
    Section 5), or shim-demuxed containers."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as fh:
            magic = fh.read(4)
        self.kind = "shim"
        self._demux = None
        self._tus = None
        if magic == ivf.IVF_MAGIC:
            self.kind = "ivf"
        else:
            with open(path, "rb") as fh:
                head = fh.read(1 << 16)
            if annexb.detect_annexb(head):
                self.kind = "annexb"
            elif annexb.detect_section5(head):
                self.kind = "section5"
        self.is_ivf = self.kind == "ivf"
        if self.kind == "ivf":
            self._header, self._packets = ivf.read_ivf(path)
            self.time_base = self._header.time_base
            self.fps = (self._header.timebase_den, self._header.timebase_num)
            self.width = self._header.width
            self.height = self._header.height
            self.nb_frames = len(self._packets)
            self.bit_depth = 0  # resolved from the sequence header
            self.transfer = 2
            self.full_range = False
        elif self.kind in ("annexb", "section5"):
            with open(path, "rb") as fh:
                data = fh.read()
            if self.kind == "annexb":
                self._tus = annexb.parse_annexb(data)
            else:
                self._tus = annexb.split_section5_tus(data)
            self.time_base = (1, RAW_STREAM_FPS)
            self.fps = (RAW_STREAM_FPS, 1)
            self.width = self.height = 0  # from the sequence header
            self.nb_frames = len(self._tus)
            self.bit_depth = 0
            self.transfer = 2
            self.full_range = False
        else:
            from .container.ffshim import Demuxer

            self._demux = Demuxer(path)
            self.video_stream = self._demux.best_video_stream()
            info = self._demux.stream_info(self.video_stream)
            self.time_base = info.time_base
            self.fps = info.frame_rate
            self.width = info.width
            self.height = info.height
            self.nb_frames = info.nb_frames
            self.bit_depth = info.bit_depth
            # AVCOL_TRC / AVCOL_RANGE numerics match AV1's code points
            self.transfer = info.color_trc
            self.full_range = info.color_range == 2

    def packets(self) -> Iterator[VideoPacket]:
        """All packets, with AV1 timestamps attached to video ones."""
        num, den = self.time_base
        if self.kind == "ivf":
            for p in self._packets:
                yield VideoPacket(
                    data=p.data,
                    pts=p.pts,
                    dts=p.pts,
                    duration=1,
                    flags=0,
                    av1_ts=pts_to_av1_ts(p.pts, num, den),
                )
        elif self.kind == "annexb":
            for i, tu in enumerate(self._tus):
                data, ext = annexb.obu_extents(tu)
                yield VideoPacket(
                    data=data,
                    pts=i,
                    dts=i,
                    duration=1,
                    flags=0,
                    av1_ts=pts_to_av1_ts(i, num, den),
                    obu_extents=ext,
                )
        elif self.kind == "section5":
            for i, data in enumerate(self._tus):
                yield VideoPacket(
                    data=data,
                    pts=i,
                    dts=i,
                    duration=1,
                    flags=0,
                    av1_ts=pts_to_av1_ts(i, num, den),
                )
        else:
            for p in self._demux.packets():
                is_video = p.stream_index == self.video_stream
                yield VideoPacket(
                    data=p.data,
                    pts=p.pts,
                    dts=p.dts,
                    duration=p.duration,
                    flags=p.flags,
                    av1_ts=pts_to_av1_ts(p.pts, num, den) if is_video else 0,
                    stream_index=p.stream_index,
                    is_video=is_video,
                )

    def close(self) -> None:
        if self._demux is not None:
            self._demux.close()
            self._demux = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


# ---------------------------------------------------------------------------


def _decodable(pkt: VideoPacket) -> bytes:
    """Packet bytes in the size-field framing decoders accept."""
    if pkt.obu_extents is None:
        return pkt.data
    return annexb.tu_to_section5(pkt.data, pkt.obu_extents)


def inspect(
    input_path: str, output_path: str, progress: bool = True
) -> Optional[List[GrainTableSegment]]:
    """Extract per-frame grain parameters into a filmgrn1 table.

    Returns the segments, or None when the stream carries no grain
    headers at all (reference main.rs:178-184 'no grain' case).

    Documented divergence (display-order grid): only SHOWN frames
    advance the table's time grid. The reference accumulates every
    parsed frame header including hidden alt-refs (parser.rs:156), so
    on alt-ref streams its segment timestamps drift ahead of display
    time by one grid step per hidden frame; ours stay aligned with the
    presentation timeline that ``apply`` selects against (packet pts).
    tests/test_pipelines.py::test_inspect_altref_display_order_grid
    pins this behavior."""
    from .utils.trace import trace_packet, tracing_enabled

    with VideoFile(input_path) as vf:
        parser = Av1Parser()
        headers = []
        bar = Progress(total=vf.nb_frames or None, enabled=progress, unit="fr")
        for pkt in vf.packets():
            if not pkt.is_video:
                continue
            if tracing_enabled():
                trace_packet(len(pkt.data), pkt.pts, pkt.dts)
            for obu in parser.parse_packet(pkt.data, pkt.av1_ts, pkt.obu_extents):
                if obu.frame is not None and obu.frame.show_frame:
                    headers.append(obu.frame.grain)
                    bar.step()
        bar.done()
        # grain exists only if some frame UPDATEs params: show_existing
        # frames always parse as COPY_REF, which alone synthesizes
        # nothing (reference main.rs:177-183 checks UpdateGrain)
        if not any(h.action == GrainAction.UPDATE for h in headers):
            log.info("No film grain headers found in input file")
            return None
        fps_num, fps_den = vf.fps
        segments = aggregate_grain_headers(headers, fps_num, fps_den)
        dump_table(segments, output_path)
        log.info("Done, wrote grain table to %s", output_path)
        return segments


def _rewrite(
    input_path: str,
    output_path: str,
    segments: Optional[List[GrainTableSegment]],
    progress: bool = True,
    verify: Optional[bool] = None,
    resume: bool = False,
) -> int:
    """Shared apply/generate/remove rewrite loop. Returns frame count.

    ``verify`` re-parses every rewritten packet with an independent
    parser and asserts the grain state round-trips (the reference's
    write-mode debug re-parse, parser.rs:364-409); defaults on when
    GRAV1_VERIFY=1 or field tracing is enabled."""
    from .utils.trace import trace_packet, trace_reparse, tracing_enabled

    if verify is None:
        verify = bool(os.environ.get("GRAV1_VERIFY")) or tracing_enabled()
    check_parser = Av1Parser() if verify else None

    def _check(new_data: bytes, ts: int, extents=None) -> None:
        if check_parser is None:
            return
        if tracing_enabled():
            # reference parser.rs:368-373: rewritten packets re-parse
            # under the tracer as a self-check
            trace_reparse(len(new_data), ts, ts)
        for obu in check_parser.parse_packet(new_data, ts, extents):
            if obu.seq is not None:
                want = segments is not None
                if obu.seq.film_grain_params_present != want:
                    raise AssertionError(
                        "rewrite self-check: sequence grain flag mismatch"
                    )
            if obu.frame is not None and segments is None:
                if obu.frame.grain.action != GrainAction.DISABLE:
                    raise AssertionError(
                        "rewrite self-check: grain present after remove"
                    )

    with VideoFile(input_path) as vf:
        parser = Av1Parser()
        rewriter = GrainRewriter(segments)
        frames = 0
        bar = Progress(total=vf.nb_frames or None, enabled=progress, unit="fr")
        if vf.kind in ("annexb", "section5"):
            # raw elementary streams: rewrite per temporal unit, then
            # re-emit the framing with re-encoded external lengths
            # (Annex B obu_length/frame_unit_size/temporal_unit_size);
            # untouched OBUs round-trip byte-identically
            with open(output_path, "wb") as out_fh:
                for pkt in vf.packets():
                    if tracing_enabled():
                        trace_packet(len(pkt.data), pkt.pts, pkt.dts)
                    parsed = parser.parse_packet(
                        pkt.data, pkt.av1_ts, pkt.obu_extents
                    )
                    if vf.kind == "annexb":
                        new_obus = rewriter.rewrite_obus(
                            pkt.data, parsed, pkt.av1_ts, parser.sequence_header
                        )
                        new_tu = vf._tus[pkt.pts].regroup(new_obus)
                        new_data, new_ext = annexb.obu_extents(new_tu)
                        _check(new_data, pkt.av1_ts, new_ext)
                        out_fh.write(annexb.serialize_annexb([new_tu]))
                    else:
                        new_data = rewriter.rewrite_packet(
                            pkt.data, parsed, pkt.av1_ts, parser.sequence_header
                        )
                        _check(new_data, pkt.av1_ts)
                        out_fh.write(new_data)
                    frames += 1
                    bar.step()
        elif vf.is_ivf:
            skip = 0
            if resume and os.path.exists(output_path):
                # restart after the last complete output packet; replay
                # the already-done inputs through the parser/rewriter to
                # rebuild state (seed counters, sequence header, refs).
                # NOTE: the replay makes single-process restart cost
                # O(total parsed) — only output WRITES are skipped; for
                # O(remaining) restart use --shards (per-GOP manifest,
                # parallel.host_shard.sharded_rewrite_ivf)
                _, skip, offset = ivf.scan_complete_packets(output_path)
                writer = ivf.IvfAppender(output_path, offset, skip)
                log.info(
                    "resuming after %d completed packets (replaying "
                    "their headers to rebuild rewriter state)", skip,
                )
            else:
                writer = ivf.IvfWriter.create(output_path, vf._header)
            for i, pkt in enumerate(vf.packets()):
                if tracing_enabled():
                    trace_packet(len(pkt.data), pkt.pts, pkt.dts)
                parsed = parser.parse_packet(pkt.data, pkt.av1_ts)
                new_data = rewriter.rewrite_packet(
                    pkt.data, parsed, pkt.av1_ts, parser.sequence_header
                )
                if i < skip:
                    continue
                _check(new_data, pkt.av1_ts)
                writer.write_packet(ivf.IvfPacket(pkt.pts, new_data))
                frames += 1
                bar.step()
            writer.finalize()
        else:
            from .container.ffshim import Packet, Remuxer

            mux = Remuxer(output_path, vf._demux)
            for pkt in vf.packets():
                raw = Packet(
                    pkt.stream_index, pkt.data, pkt.pts, pkt.dts, pkt.duration,
                    pkt.flags,
                )
                if not pkt.is_video:
                    mux.write(raw)
                    continue
                if tracing_enabled():
                    trace_packet(len(pkt.data), pkt.pts, pkt.dts)
                parsed = parser.parse_packet(pkt.data, pkt.av1_ts)
                new_data = rewriter.rewrite_packet(
                    pkt.data, parsed, pkt.av1_ts, parser.sequence_header
                )
                _check(new_data, pkt.av1_ts)
                mux.write(raw, data=new_data)
                frames += 1
                bar.step()
            mux.finish()
        bar.done()
        return frames


def apply_table(
    input_path: str,
    output_path: str,
    table_path: str,
    progress: bool = True,
    resume: bool = False,
) -> int:
    segments = load_table(table_path)
    n = _rewrite(input_path, output_path, segments, progress, resume=resume)
    log.info("Done, wrote output file to %s", output_path)
    return n


def remove(
    input_path: str, output_path: str, progress: bool = True, resume: bool = False
) -> int:
    n = _rewrite(input_path, output_path, None, progress, resume=resume)
    log.info("Done, wrote output file to %s", output_path)
    return n


def generate(
    input_path: str,
    output_path: str,
    iso: float,
    chroma: bool = False,
    progress: bool = True,
) -> int:
    """Photon-noise grain from stream properties (reference
    main.rs:245-311: width/height/transfer/range pulled from the input;
    SMPTE2084 -> PQ model, otherwise BT.1886; JPEG range -> full-range
    noise model, main.rs:296-304)."""
    from .ops.photon_noise import photon_noise_segment

    with VideoFile(input_path) as vf:
        width, height = vf.width, vf.height
        transfer = "smpte2084" if vf.transfer == 16 else "bt1886"
        full_range = vf.full_range
        if vf.kind != "shim":
            # raw framings carry no color metadata (and IVF headers may
            # even zero the dims); pull everything from the sequence
            # header instead
            parser = Av1Parser()
            found = False
            for pkt in vf.packets():
                if pkt.is_video:
                    for obu in parser.parse_packet(
                        pkt.data, pkt.av1_ts, pkt.obu_extents
                    ):
                        if obu.seq is not None:
                            if not width or not height:
                                width = obu.seq.max_frame_width
                                height = obu.seq.max_frame_height
                            cc = obu.seq.color_config
                            if cc.transfer_characteristics == 16:
                                transfer = "smpte2084"
                            full_range = cc.color_range_full
                            found = True
                            break
                if found:
                    break
    seg = photon_noise_segment(iso, width, height, transfer, chroma, full_range)
    n = _rewrite(input_path, output_path, [seg], progress)
    log.info("Done, wrote output file to %s", output_path)
    return n


class GrainFrameState:
    """Decoder-side film-grain state machine (spec 7.20 / 5.9.30): saved
    per-reference-slot grain parameters, COPY_REF seed substitution, and
    the show_existing-keyframe full-state reload. Resolves each DISPLAYED
    frame's effective FilmGrainParams — what dav1d itself computes before
    synthesis, which the render pipeline feeds to the TPU engine."""

    def __init__(self) -> None:
        self.saved: List[Optional["FilmGrainParams"]] = [None] * 8
        self.key: List[bool] = [False] * 8

    def frame_params(self, hdr) -> Tuple[bool, Optional["FilmGrainParams"]]:
        """Returns (is_displayed, effective_params_or_None) and updates
        the slot state for ``hdr``."""
        import dataclasses

        from .obu.types import FrameType

        if hdr.show_existing_frame:
            idx = hdr.frame_to_show_map_idx or 0
            params = self.saved[idx]
            if self.key[idx]:
                # re-showing a hidden keyframe reloads every slot from
                # it (spec decode_frame_wrapup: show_existing of a KEY
                # frame refreshes all references with its saved state)
                self.saved = [params] * 8
                self.key = [True] * 8
            return True, params
        g = hdr.grain
        if g.action == GrainAction.UPDATE:
            cur = g.params
        elif g.action == GrainAction.COPY_REF and g.ref_idx is not None:
            src = self.saved[g.ref_idx]
            # copied params keep everything but the freshly-read seed
            # (spec 5.9.30 tempGrainSeed)
            cur = (
                None
                if src is None
                else dataclasses.replace(src, grain_seed=g.seed or 0)
            )
        else:
            cur = None
        for i in range(8):
            if (hdr.refresh_frame_flags >> i) & 1:
                self.saved[i] = cur
                self.key[i] = hdr.frame_type == FrameType.KEY
        return hdr.show_frame, cur


def _grain_visible(p) -> bool:
    return p is not None and bool(
        p.scaling_points_y
        or p.scaling_points_cb
        or p.scaling_points_cr
        or p.chroma_scaling_from_luma
    )


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


def _stage(planes: List[np.ndarray], device: torch.device) -> torch.Tensor:
    """Stack one plane of each frame, bound for ``device``, in one host
    pass: the host buffer ``_upload`` copies up.

    On a CUDA device the buffer is pinned, from PyTorch's caching host
    allocator, which hands a block out again only once the non-blocking
    copy that read it has passed on its stream: a batch still uploading is
    never overwritten. Each frame is one torch ``copy_`` (spread over the
    host's cores; a strided plane goes in as it is), uint16 viewed as
    int16, which is value-preserving up to 12 bits. uint8 planes bound for
    a CUDA device stay uint8 (half the bytes up; the grain kernels widen
    them); on the CPU every plane is staged as int16. Spans:
    ``upload.pin`` (the buffer), ``upload.stack`` (the copies); the
    counter ``upload.frames`` adds the frames staged."""
    cuda = device.type == "cuda"
    narrow = cuda and planes[0].dtype == np.uint8
    with spans.span("upload.pin"):
        buf = torch.empty((len(planes),) + planes[0].shape,
                          dtype=torch.uint8 if narrow else torch.int16, pin_memory=cuda)
    with spans.span("upload.stack"):
        for dst, a in zip(buf, planes):
            dst.copy_(torch.from_numpy(a.view(np.int16) if a.dtype == np.uint16 else a))
    spans.count("upload.frames", len(planes))
    return buf


def _upload(planes: List[np.ndarray], device: torch.device) -> torch.Tensor:
    """Stack one plane of each frame on ``device`` as int16: ``_stage``,
    then one non-blocking copy (the span ``upload.copy``); uint8 planes
    are widened on the card."""
    buf = _stage(planes, device)
    with spans.span("upload.copy"):
        out = buf.to(device, non_blocking=True)
        return out.to(torch.int16) if buf.dtype == torch.uint8 else out


def _start_download(t: torch.Tensor, bit_depth: int) -> torch.Tensor:
    """Begin the device-to-host copy of a grained int16 plane batch in the
    mux dtype. 8-bit samples are cast to uint8 on the device first (half
    the bytes); above 8 bits the int16 samples (0..4095) are already the
    uint16 bytes, reinterpreted on the host."""
    with spans.span("download.start"):
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

    The driving thread's stages are the spans (``utils.spans``)
    "render.decode" (waiting for the decoder), "render.dispatch" (upload,
    parameters, the parameter program, kernel launches), "render.download"
    (waiting for the device-to-host copies) and "render.mux" (y4m
    writes)."""
    from .container.ffshim import Decoder
    from .container.y4m import Y4mWriter
    from .utils.prefetch import maybe_prefetch

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

        def dispatch() -> None:
            if not pend:
                return
            with spans.span("render.dispatch"):
                first = pend[0][0]
                bd, mono, sub = first.bit_depth, len(first.planes) == 1, first.subsampling
                todo = [i for i, (_, p) in enumerate(pend) if _grain_visible(p)]
                outs = [list(f.planes) for f, _ in pend]
                grained = None
                done = None
                if todo:
                    hp = [pend[i][1] for i in todo]
                    frames = [pend[i][0] for i in todo]
                    if mesh is not None:
                        frames, hp = pad_frames(frames, len(mesh)), pad_frames(hp, len(mesh))
                    stage = _upload if mesh is None else _stage
                    planes = [stage([f.planes[k] for f in frames], device)
                              for k in range(1 if mono else 3)]
                    y, cb, cr = planes if not mono else (planes[0], None, None)
                    if mesh is None:
                        res = grain_ops.apply_grain(
                            y, cb, cr, grain_ops.pack_params(hp, device), bd, sub[0], sub[1],
                            mono,
                        )
                    else:
                        # each shard is copied to its device from the host batch
                        res = sharded_apply(
                            mesh, y, cb, cr, grain_ops.pack_params(hp, "cpu"), bd,
                            sub_x=sub[0], sub_y=sub[1], monochrome=mono,
                        )
                        res = [None if r is None else r[: len(todo)] for r in res]
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
            while len(inflight) > 1:
                drain()

        def drain() -> None:
            nonlocal frames_out
            if not inflight:
                return
            todo, grained, done, outs, bd = inflight.pop(0)
            if todo:
                with spans.span("render.download"):
                    if done is not None:
                        done.synchronize()
                    host = [None if g is None else _as_mux(g, bd) for g in grained]
                for k, i in enumerate(todo):
                    for pi, plane in enumerate(host):
                        if plane is not None:
                            outs[i][pi] = plane[k]
            with spans.span("render.mux"):
                for planes in outs:
                    writer.write_frame(planes)
                    frames_out += 1
                    bar.step()

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
                with spans.span("render.decode"):
                    item = next(it, None)
                if item is None:
                    return
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
        spans.log_summary()
        return frames_out


def diff(
    source_path: str,
    denoised_path: str,
    output_path: str,
    filters: Optional[str] = None,
    progress: bool = True,
    batch: int = 16,
    shards: int = 1,
    device="cuda",
) -> List[GrainTableSegment]:
    """Estimate a grain table from a grainy source and a denoised copy,
    both decoded to pixels by dav1d, and write it to ``output_path``.

    Both decoders run on prefetch threads; ``batch`` frame pairs at a
    time go through ``DiffEstimator.diff_batch`` on ``device`` (one
    upload per plane, one download of the batch's statistics). ``shards``
    > 1 spreads each batch over a device mesh (``device_mesh``). The table
    depends on neither ``batch`` nor ``shards``.

    The driving thread's stages are the spans (``utils.spans``)
    "diff.decode" (pulling both decoders) and, inside ``diff_batch``,
    "stage.planes", "diff.launch", "diff.download", "diff.chunk" and
    "diff.fit"."""
    from .container.ffshim import Decoder
    from .utils.filters import FilterChain
    from .utils.prefetch import maybe_prefetch

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

        def flush():
            if pend_src:
                est.diff_batch(pend_src, pend_den, mesh=mesh)
                pend_src.clear()
                pend_den.clear()

        while True:
            with spans.span("diff.decode"):
                sf = next(src_it, None)
                df = next(den_it, None)
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
        spans.log_summary()
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
    from .container.ffshim import Decoder
    from .utils.prefetch import maybe_prefetch

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
    spans.log_summary()
    return segments
