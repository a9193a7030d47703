// gravnative: native container/codec shim for grav1synth-tpu.
//
// C++ layer over libavformat/libavcodec/libavutil providing the roles the
// reference fills with FFmpeg FFI (grav1synth src/reader.rs:37-212 demux +
// decode, src/parser.rs:189-422 remux) plus two roles the reference does
// not have: a libaom encoder for self-generated test fixtures and a
// dav1d decoder with film-grain toggling, which serves as the
// bit-exactness oracle for the TPU grain-synthesis kernels.
//
// Exposed as a flat C API loaded from Python via ctypes.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavcodec/bsf.h>
#include <libavformat/avformat.h>
#include <libavutil/dict.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libavutil/pixdesc.h>
}

namespace {

void set_err(char* err, int errlen, const std::string& msg) {
    if (err && errlen > 0) {
        std::snprintf(err, (size_t)errlen, "%s", msg.c_str());
    }
}

void set_averr(char* err, int errlen, const char* what, int code) {
    char buf[128];
    av_strerror(code, buf, sizeof(buf));
    set_err(err, errlen, std::string(what) + ": " + buf);
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Shared plain-C structs (mirrored in ctypes)

typedef struct GravStreamInfo {
    int32_t index;
    int32_t codec_type;   // AVMediaType
    int32_t codec_id;     // AVCodecID
    int32_t width, height;
    int32_t bit_depth;    // luma bit depth (video only)
    int32_t subsampling_x, subsampling_y;
    int32_t time_base_num, time_base_den;
    int32_t frame_rate_num, frame_rate_den;
    int32_t color_range;  // AVColorRange
    int32_t color_trc;    // AVColorTransferCharacteristic
    int64_t nb_frames;    // container-reported; 0 when unknown
} GravStreamInfo;

typedef struct GravPacketView {
    const uint8_t* data;
    int32_t size;
    int32_t stream_index;
    int64_t pts, dts, duration;
    int32_t flags;
} GravPacketView;

typedef struct GravFrameView {
    const uint8_t* data[3];
    int64_t stride[3];    // bytes
    int32_t width, height;
    int32_t bit_depth;
    int32_t subsampling_x, subsampling_y;
    int32_t num_planes;
    int64_t pts;
} GravFrameView;

// ---------------------------------------------------------------------------
// Demuxer

typedef struct GravDemux {
    AVFormatContext* fmt = nullptr;
    AVPacket* pkt = nullptr;
} GravDemux;

GravDemux* grav_demux_open(const char* path, char* err, int errlen) {
    auto* d = new GravDemux();
    int ret = avformat_open_input(&d->fmt, path, nullptr, nullptr);
    if (ret < 0) {
        set_averr(err, errlen, "avformat_open_input", ret);
        delete d;
        return nullptr;
    }
    ret = avformat_find_stream_info(d->fmt, nullptr);
    if (ret < 0) {
        set_averr(err, errlen, "avformat_find_stream_info", ret);
        avformat_close_input(&d->fmt);
        delete d;
        return nullptr;
    }
    d->pkt = av_packet_alloc();
    return d;
}

int grav_demux_stream_count(GravDemux* d) { return (int)d->fmt->nb_streams; }

int grav_demux_best_video_stream(GravDemux* d) {
    return av_find_best_stream(d->fmt, AVMEDIA_TYPE_VIDEO, -1, -1, nullptr, 0);
}

int grav_demux_stream_info(GravDemux* d, int idx, GravStreamInfo* out) {
    if (idx < 0 || idx >= (int)d->fmt->nb_streams) return -1;
    AVStream* st = d->fmt->streams[idx];
    AVCodecParameters* par = st->codecpar;
    std::memset(out, 0, sizeof(*out));
    out->index = idx;
    out->codec_type = par->codec_type;
    out->codec_id = par->codec_id;
    out->width = par->width;
    out->height = par->height;
    out->time_base_num = st->time_base.num;
    out->time_base_den = st->time_base.den;
    AVRational fr = st->avg_frame_rate.num ? st->avg_frame_rate : st->r_frame_rate;
    out->frame_rate_num = fr.num;
    out->frame_rate_den = fr.den;
    out->color_range = par->color_range;
    out->color_trc = par->color_trc;
    out->nb_frames = st->nb_frames;
    const AVPixFmtDescriptor* desc =
        av_pix_fmt_desc_get((AVPixelFormat)par->format);
    if (desc) {
        out->bit_depth = desc->comp[0].depth;
        out->subsampling_x = desc->log2_chroma_w;
        out->subsampling_y = desc->log2_chroma_h;
    }
    return 0;
}

// 1 = packet produced, 0 = EOF, <0 = error. View valid until next call.
int grav_demux_read(GravDemux* d, GravPacketView* out) {
    av_packet_unref(d->pkt);
    int ret = av_read_frame(d->fmt, d->pkt);
    if (ret == AVERROR_EOF) return 0;
    if (ret < 0) return ret;
    out->data = d->pkt->data;
    out->size = d->pkt->size;
    out->stream_index = d->pkt->stream_index;
    out->pts = d->pkt->pts;
    out->dts = d->pkt->dts;
    out->duration = d->pkt->duration;
    out->flags = d->pkt->flags;
    return 1;
}

void grav_demux_close(GravDemux* d) {
    if (!d) return;
    av_packet_free(&d->pkt);
    avformat_close_input(&d->fmt);
    delete d;
}

// ---------------------------------------------------------------------------
// Remuxer: copies the stream layout of an input (A/V/S streams), allowing
// per-packet data replacement on the video stream. Mirrors the reference's
// output mapping: codec_tag cleared, dispositions/metadata/chapters copied
// (grav1synth parser.rs:189-257).

typedef struct GravRemux {
    AVFormatContext* fmt = nullptr;
    AVPacket* pkt = nullptr;
    int* stream_map = nullptr;  // input idx -> output idx (-1 dropped)
    int n_in = 0;
    AVRational* in_tb = nullptr;
} GravRemux;

GravRemux* grav_remux_open(const char* path, GravDemux* in, char* err,
                           int errlen) {
    auto* m = new GravRemux();
    auto fail = [&]() -> GravRemux* {
        delete[] m->stream_map;
        delete[] m->in_tb;
        if (m->fmt) {
            if (m->fmt->pb && !(m->fmt->oformat->flags & AVFMT_NOFILE))
                avio_closep(&m->fmt->pb);
            avformat_free_context(m->fmt);
        }
        delete m;
        return nullptr;
    };
    int ret = avformat_alloc_output_context2(&m->fmt, nullptr, nullptr, path);
    if (ret < 0 || !m->fmt) {
        set_averr(err, errlen, "alloc_output_context", ret);
        return fail();
    }
    m->n_in = (int)in->fmt->nb_streams;
    m->stream_map = new int[m->n_in];
    m->in_tb = new AVRational[m->n_in];
    for (int i = 0; i < m->n_in; i++) {
        AVStream* ist = in->fmt->streams[i];
        m->in_tb[i] = ist->time_base;
        enum AVMediaType t = ist->codecpar->codec_type;
        if (t != AVMEDIA_TYPE_VIDEO && t != AVMEDIA_TYPE_AUDIO &&
            t != AVMEDIA_TYPE_SUBTITLE) {
            m->stream_map[i] = -1;
            continue;
        }
        AVStream* ost = avformat_new_stream(m->fmt, nullptr);
        if (!ost) {
            set_err(err, errlen, "avformat_new_stream failed");
            return fail();
        }
        avcodec_parameters_copy(ost->codecpar, ist->codecpar);
        ost->codecpar->codec_tag = 0;
        ost->disposition = ist->disposition;
        ost->time_base = ist->time_base;
        ost->avg_frame_rate = ist->avg_frame_rate;
        av_dict_copy(&ost->metadata, ist->metadata, 0);
        m->stream_map[i] = ost->index;
    }
    // chapters
    if (in->fmt->nb_chapters) {
        m->fmt->chapters = (AVChapter**)av_calloc(in->fmt->nb_chapters,
                                                  sizeof(AVChapter*));
        if (!m->fmt->chapters) {
            set_averr(err, errlen, "chapter alloc", AVERROR(ENOMEM));
            return fail();
        }
        for (unsigned i = 0; i < in->fmt->nb_chapters; i++) {
            AVChapter* ic = in->fmt->chapters[i];
            AVChapter* oc = (AVChapter*)av_mallocz(sizeof(AVChapter));
            if (!oc) {
                set_averr(err, errlen, "chapter alloc", AVERROR(ENOMEM));
                return fail();
            }
            *oc = *ic;
            oc->metadata = nullptr;
            av_dict_copy(&oc->metadata, ic->metadata, 0);
            m->fmt->chapters[i] = oc;
        }
        m->fmt->nb_chapters = in->fmt->nb_chapters;
    }
    av_dict_copy(&m->fmt->metadata, in->fmt->metadata, 0);
    if (!(m->fmt->oformat->flags & AVFMT_NOFILE)) {
        ret = avio_open(&m->fmt->pb, path, AVIO_FLAG_WRITE);
        if (ret < 0) {
            set_averr(err, errlen, "avio_open", ret);
            return fail();
        }
    }
    ret = avformat_write_header(m->fmt, nullptr);
    if (ret < 0) {
        set_averr(err, errlen, "avformat_write_header", ret);
        return fail();
    }
    m->pkt = av_packet_alloc();
    return m;
}

int grav_remux_write(GravRemux* m, int in_stream, const uint8_t* data,
                     int size, int64_t pts, int64_t dts, int64_t duration,
                     int flags) {
    if (in_stream < 0 || in_stream >= m->n_in) return -1;
    int out_idx = m->stream_map[in_stream];
    if (out_idx < 0) return 0;  // dropped stream
    av_packet_unref(m->pkt);
    if (av_new_packet(m->pkt, size) < 0) return -2;
    std::memcpy(m->pkt->data, data, (size_t)size);
    m->pkt->stream_index = out_idx;
    m->pkt->pts = pts;
    m->pkt->dts = dts;
    m->pkt->duration = duration;
    m->pkt->flags = flags;
    av_packet_rescale_ts(m->pkt, m->in_tb[in_stream],
                         m->fmt->streams[out_idx]->time_base);
    return av_interleaved_write_frame(m->fmt, m->pkt);
}

int grav_remux_finish(GravRemux* m) {
    int ret = av_write_trailer(m->fmt);
    if (m->fmt->pb && !(m->fmt->oformat->flags & AVFMT_NOFILE))
        avio_closep(&m->fmt->pb);
    av_packet_free(&m->pkt);
    delete[] m->stream_map;
    delete[] m->in_tb;
    avformat_free_context(m->fmt);
    delete m;
    return ret;
}

// ---------------------------------------------------------------------------
// Container introspection (dispositions / metadata / chapters) — lets tests
// prove the remux parity path (reference parser.rs:189-253) end-to-end.

int grav_demux_disposition(GravDemux* d, int idx) {
    if (idx < 0 || idx >= (int)d->fmt->nb_streams) return -1;
    return d->fmt->streams[idx]->disposition;
}

// Serializes a metadata dict as "key=value\n..." lines. stream = -1 for the
// container-level dict. Returns bytes written (excl. NUL), or -1.
int grav_demux_meta(GravDemux* d, int stream, char* out, int outlen) {
    if (outlen <= 0) return -1;
    AVDictionary* dict = nullptr;
    if (stream < 0) {
        dict = d->fmt->metadata;
    } else if (stream < (int)d->fmt->nb_streams) {
        dict = d->fmt->streams[stream]->metadata;
    } else {
        return -1;
    }
    std::string buf;
    const AVDictionaryEntry* e = nullptr;
    while ((e = av_dict_get(dict, "", e, AV_DICT_IGNORE_SUFFIX))) {
        buf += e->key;
        buf += '=';
        buf += e->value;
        buf += '\n';
    }
    int n = (int)buf.size();
    if (n >= outlen) n = outlen - 1;
    std::memcpy(out, buf.data(), (size_t)n);
    out[n] = '\0';
    return n;
}

int grav_demux_chapter_count(GravDemux* d) { return (int)d->fmt->nb_chapters; }

int grav_demux_chapter(GravDemux* d, int i, int64_t* start_ms, int64_t* end_ms,
                       char* title, int titlelen) {
    if (i < 0 || i >= (int)d->fmt->nb_chapters) return -1;
    AVChapter* c = d->fmt->chapters[i];
    AVRational ms = {1, 1000};
    *start_ms = av_rescale_q(c->start, c->time_base, ms);
    *end_ms = av_rescale_q(c->end, c->time_base, ms);
    const AVDictionaryEntry* t = av_dict_get(c->metadata, "title", nullptr, 0);
    const char* s = t ? t->value : "";
    int n = (int)std::strlen(s);
    if (n >= titlelen) n = titlelen - 1;
    std::memcpy(title, s, (size_t)n);
    title[n] = '\0';
    return 0;
}

// ---------------------------------------------------------------------------
// Multi-stream fixture builder: muxes the video stream of `video_in`
// together with a freshly-encoded AAC audio track, a text subtitle track,
// chapters and tag metadata into `out_path` (MKV or MP4 by extension).
// Exists so tests can prove the remux path preserves every non-video
// stream byte-for-byte (reference parity target parser.rs:189-253) —
// the image ships no ffmpeg binary to build such fixtures with.
// flags: bit0 = audio, bit1 = subtitles, bit2 = chapters+metadata.

int grav_make_multistream(const char* video_in, const char* out_path,
                          int flags, char* err, int errlen) {
    AVFormatContext* in = nullptr;
    AVFormatContext* out = nullptr;
    AVCodecContext* aenc = nullptr;
    AVPacket* pkt = av_packet_alloc();
    AVFrame* af = nullptr;
    int ret = 0;
    auto fail = [&](const char* what, int rc) {
        set_averr(err, errlen, what, rc);
        if (aenc) avcodec_free_context(&aenc);
        if (af) av_frame_free(&af);
        av_packet_free(&pkt);
        if (in) avformat_close_input(&in);
        if (out) {
            if (out->pb && !(out->oformat->flags & AVFMT_NOFILE))
                avio_closep(&out->pb);
            avformat_free_context(out);
        }
        return -1;
    };
    if ((ret = avformat_open_input(&in, video_in, nullptr, nullptr)) < 0)
        return fail("open_input", ret);
    if ((ret = avformat_find_stream_info(in, nullptr)) < 0)
        return fail("find_stream_info", ret);
    int vidx = av_find_best_stream(in, AVMEDIA_TYPE_VIDEO, -1, -1, nullptr, 0);
    if (vidx < 0) return fail("no video stream", vidx);
    AVStream* ivs = in->streams[vidx];
    double dur_s = 1.0;
    if (ivs->duration > 0)
        dur_s = ivs->duration * av_q2d(ivs->time_base);
    else if (in->duration > 0)
        dur_s = in->duration / (double)AV_TIME_BASE;
    if (dur_s < 0.25) dur_s = 0.25;

    if ((ret = avformat_alloc_output_context2(&out, nullptr, nullptr,
                                              out_path)) < 0 || !out)
        return fail("alloc_output", ret);
    bool is_mp4 = std::strcmp(out->oformat->name, "mp4") == 0 ||
                  std::strncmp(out->oformat->name, "mov", 3) == 0;

    // video: stream copy
    AVStream* ovs = avformat_new_stream(out, nullptr);
    if (!ovs) return fail("new_stream video", -1);
    avcodec_parameters_copy(ovs->codecpar, ivs->codecpar);
    ovs->codecpar->codec_tag = 0;
    ovs->time_base = ivs->time_base;
    ovs->avg_frame_rate = ivs->avg_frame_rate;
    if (flags & 4)
        av_dict_set(&ovs->metadata, "language", "und", 0);

    // audio: AAC mono 48 kHz (the native encoder every libavcodec has)
    AVStream* oas = nullptr;
    if (flags & 1) {
        const AVCodec* ac = avcodec_find_encoder(AV_CODEC_ID_AAC);
        if (!ac) return fail("no AAC encoder", -1);
        aenc = avcodec_alloc_context3(ac);
        aenc->sample_rate = 48000;
        av_channel_layout_default(&aenc->ch_layout, 1);
        aenc->sample_fmt = AV_SAMPLE_FMT_FLTP;
        aenc->bit_rate = 64000;
        aenc->time_base = {1, 48000};
        if (out->oformat->flags & AVFMT_GLOBALHEADER)
            aenc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
        if ((ret = avcodec_open2(aenc, ac, nullptr)) < 0)
            return fail("aac open", ret);
        oas = avformat_new_stream(out, nullptr);
        if (!oas) return fail("new_stream audio", -1);
        avcodec_parameters_from_context(oas->codecpar, aenc);
        oas->time_base = aenc->time_base;
        oas->disposition = AV_DISPOSITION_DEFAULT;
        if (flags & 4)
            av_dict_set(&oas->metadata, "language", "eng", 0);
    }

    // subtitles: SubRip for MKV, mov_text (tx3g) for MP4 — both carry
    // their cue payloads as raw packet bytes, no encoder needed
    AVStream* oss = nullptr;
    if (flags & 2) {
        oss = avformat_new_stream(out, nullptr);
        if (!oss) return fail("new_stream subs", -1);
        oss->codecpar->codec_type = AVMEDIA_TYPE_SUBTITLE;
        oss->codecpar->codec_id =
            is_mp4 ? AV_CODEC_ID_MOV_TEXT : AV_CODEC_ID_SUBRIP;
        oss->time_base = {1, 1000};
        oss->disposition = AV_DISPOSITION_FORCED;
        if (flags & 4)
            av_dict_set(&oss->metadata, "language", "deu", 0);
        if (is_mp4) {
            // minimal tx3g sample-description extradata the mov muxer
            // embeds: display flags, justification, bg color, default
            // text box, style record (per 3GPP TS 26.245)
            static const uint8_t tx3g[] = {
                0, 0, 0, 0,              // displayFlags
                1, 0xff,                 // justification h/v
                0, 0, 0, 0,              // background rgba
                0, 0, 0, 0, 0, 0, 0, 0,  // default text box
                0, 0,                    // start char
                0, 0,                    // end char
                0, 1,                    // font id
                0,                       // face style
                18,                      // font size
                255, 255, 255, 255,      // fg rgba
            };
            oss->codecpar->extradata =
                (uint8_t*)av_mallocz(sizeof(tx3g) + AV_INPUT_BUFFER_PADDING_SIZE);
            if (!oss->codecpar->extradata) return -1;
            std::memcpy(oss->codecpar->extradata, tx3g, sizeof(tx3g));
            oss->codecpar->extradata_size = sizeof(tx3g);
        }
    }

    if (flags & 4) {
        av_dict_set(&out->metadata, "title", "grav1synth multistream fixture", 0);
        av_dict_set(&out->metadata, "comment", "remux parity proof", 0);
        int64_t half_ms = (int64_t)(dur_s * 500);
        for (int i = 0; i < 2; i++) {
            AVChapter* ch = (AVChapter*)av_mallocz(sizeof(AVChapter));
            if (!ch) return -1;
            ch->id = i + 1;
            ch->time_base = {1, 1000};
            ch->start = i * half_ms;
            ch->end = (i + 1) * half_ms;
            av_dict_set(&ch->metadata, "title", i ? "part two" : "part one", 0);
            av_dynarray_add(&out->chapters, (int*)&out->nb_chapters, ch);
            if (!out->chapters) return -1;
        }
    }

    if (!(out->oformat->flags & AVFMT_NOFILE)) {
        if ((ret = avio_open(&out->pb, out_path, AVIO_FLAG_WRITE)) < 0)
            return fail("avio_open", ret);
    }
    if ((ret = avformat_write_header(out, nullptr)) < 0)
        return fail("write_header", ret);

    // video packets (stream copy)
    while (av_read_frame(in, pkt) >= 0) {
        if (pkt->stream_index != vidx) {
            av_packet_unref(pkt);
            continue;
        }
        pkt->stream_index = ovs->index;
        av_packet_rescale_ts(pkt, ivs->time_base, ovs->time_base);
        if ((ret = av_interleaved_write_frame(out, pkt)) < 0)
            return fail("write video", ret);
    }

    // audio: two-tone sine so the track has real content
    if (oas) {
        af = av_frame_alloc();
        af->format = AV_SAMPLE_FMT_FLTP;
        af->sample_rate = 48000;
        av_channel_layout_default(&af->ch_layout, 1);
        af->nb_samples = aenc->frame_size > 0 ? aenc->frame_size : 1024;
        if ((ret = av_frame_get_buffer(af, 0)) < 0)
            return fail("audio buffer", ret);
        int64_t total = (int64_t)(dur_s * 48000);
        int64_t done = 0;
        auto drain = [&]() -> int {
            int rc;
            while ((rc = avcodec_receive_packet(aenc, pkt)) >= 0) {
                pkt->stream_index = oas->index;
                av_packet_rescale_ts(pkt, aenc->time_base, oas->time_base);
                rc = av_interleaved_write_frame(out, pkt);
                if (rc < 0) return rc;
            }
            return (rc == AVERROR(EAGAIN) || rc == AVERROR_EOF) ? 0 : rc;
        };
        while (done < total) {
            av_frame_make_writable(af);
            float* s = (float*)af->data[0];
            for (int i = 0; i < af->nb_samples; i++) {
                double t = (done + i) / 48000.0;
                s[i] = (float)(0.25 * std::sin(2 * M_PI * 440 * t) +
                               0.1 * std::sin(2 * M_PI * 1000 * t));
            }
            af->pts = done;
            done += af->nb_samples;
            if ((ret = avcodec_send_frame(aenc, af)) < 0)
                return fail("aac send", ret);
            if ((ret = drain()) < 0) return fail("aac write", ret);
        }
        avcodec_send_frame(aenc, nullptr);
        if ((ret = drain()) < 0) return fail("aac flush", ret);
    }

    // subtitle cues (raw payloads)
    if (oss) {
        const char* cues[2] = {"Hello from cue one", "Second forced cue"};
        int64_t dur_ms = (int64_t)(dur_s * 1000);
        for (int i = 0; i < 2; i++) {
            std::string payload;
            if (is_mp4) {
                uint16_t len = (uint16_t)std::strlen(cues[i]);
                payload.push_back((char)(len >> 8));
                payload.push_back((char)(len & 0xff));
                payload += cues[i];
            } else {
                payload = cues[i];
            }
            av_packet_unref(pkt);
            if (av_new_packet(pkt, (int)payload.size()) < 0)
                return fail("sub packet", -1);
            std::memcpy(pkt->data, payload.data(), payload.size());
            pkt->stream_index = oss->index;
            pkt->pts = pkt->dts = i * (dur_ms / 2);
            pkt->duration = dur_ms / 4;
            pkt->flags = AV_PKT_FLAG_KEY;
            if ((ret = av_interleaved_write_frame(out, pkt)) < 0)
                return fail("write subs", ret);
        }
    }

    if ((ret = av_write_trailer(out)) < 0) return fail("write_trailer", ret);
    if (aenc) avcodec_free_context(&aenc);
    if (af) av_frame_free(&af);
    av_packet_free(&pkt);
    avformat_close_input(&in);
    if (out->pb && !(out->oformat->flags & AVFMT_NOFILE))
        avio_closep(&out->pb);
    avformat_free_context(out);
    return 0;
}

// ---------------------------------------------------------------------------
// Decoder (libdav1d by default; apply_grain toggleable -> grain oracle)

typedef struct GravDecoder {
    AVCodecContext* ctx = nullptr;
    AVFrame* frame = nullptr;
    AVPacket* pkt = nullptr;
} GravDecoder;

GravDecoder* grav_decoder_open(const char* codec_name, int apply_grain,
                               int threads, char* err, int errlen) {
    const AVCodec* codec = avcodec_find_decoder_by_name(codec_name);
    if (!codec) {
        set_err(err, errlen, std::string("decoder not found: ") + codec_name);
        return nullptr;
    }
    auto* d = new GravDecoder();
    d->ctx = avcodec_alloc_context3(codec);
    d->ctx->thread_count = threads;
    AVDictionary* opts = nullptr;
    if (std::strcmp(codec_name, "libdav1d") == 0) {
        av_dict_set_int(&opts, "filmgrain", apply_grain ? 1 : 0, 0);
    }
    int ret = avcodec_open2(d->ctx, codec, &opts);
    av_dict_free(&opts);
    if (ret < 0) {
        set_averr(err, errlen, "avcodec_open2", ret);
        avcodec_free_context(&d->ctx);
        delete d;
        return nullptr;
    }
    d->frame = av_frame_alloc();
    d->pkt = av_packet_alloc();
    return d;
}

// data==nullptr -> flush (send EOF)
int grav_decoder_send(GravDecoder* d, const uint8_t* data, int size,
                      int64_t pts) {
    if (!data) return avcodec_send_packet(d->ctx, nullptr);
    av_packet_unref(d->pkt);
    if (av_new_packet(d->pkt, size) < 0) return -1;
    std::memcpy(d->pkt->data, data, (size_t)size);
    d->pkt->pts = pts;
    return avcodec_send_packet(d->ctx, d->pkt);
}

// 1 frame, 0 needs-more-input (EAGAIN), -1 EOF, other negative = error.
int grav_decoder_receive(GravDecoder* d, GravFrameView* out) {
    av_frame_unref(d->frame);
    int ret = avcodec_receive_frame(d->ctx, d->frame);
    if (ret == AVERROR(EAGAIN)) return 0;
    if (ret == AVERROR_EOF) return -1;
    if (ret < 0) return ret;
    const AVPixFmtDescriptor* desc =
        av_pix_fmt_desc_get((AVPixelFormat)d->frame->format);
    std::memset(out, 0, sizeof(*out));
    out->width = d->frame->width;
    out->height = d->frame->height;
    out->bit_depth = desc ? desc->comp[0].depth : 8;
    out->subsampling_x = desc ? desc->log2_chroma_w : 1;
    out->subsampling_y = desc ? desc->log2_chroma_h : 1;
    out->num_planes = (desc && (desc->nb_components >= 3)) ? 3 : 1;
    out->pts = d->frame->pts;
    for (int p = 0; p < out->num_planes; p++) {
        out->data[p] = d->frame->data[p];
        out->stride[p] = d->frame->linesize[p];
    }
    return 1;
}

void grav_decoder_close(GravDecoder* d) {
    if (!d) return;
    av_frame_free(&d->frame);
    av_packet_free(&d->pkt);
    avcodec_free_context(&d->ctx);
    delete d;
}

// ---------------------------------------------------------------------------
// Encoder (libaom-av1) for self-generated fixtures

typedef struct GravEncoder {
    AVCodecContext* ctx = nullptr;
    AVFrame* frame = nullptr;
    AVPacket* pkt = nullptr;
} GravEncoder;

// sub_x/sub_y: chroma subsampling (1,1)=4:2:0, (1,0)=4:2:2, (0,0)=4:4:4
// (AV1 seq profiles 0/2/1 respectively).
GravEncoder* grav_encoder_open(int width, int height, int bit_depth,
                               int monochrome, int fps_num, int fps_den,
                               const char* extra_opts, int sub_x, int sub_y,
                               char* err, int errlen) {
    const AVCodec* codec = avcodec_find_encoder_by_name("libaom-av1");
    if (!codec) {
        set_err(err, errlen, "libaom-av1 encoder not found");
        return nullptr;
    }
    auto* e = new GravEncoder();
    e->ctx = avcodec_alloc_context3(codec);
    e->ctx->width = width;
    e->ctx->height = height;
    e->ctx->time_base = {fps_den, fps_num};
    e->ctx->framerate = {fps_num, fps_den};
    if (monochrome) {
        e->ctx->pix_fmt = bit_depth == 8    ? AV_PIX_FMT_GRAY8
                          : bit_depth == 10 ? AV_PIX_FMT_GRAY10
                                            : AV_PIX_FMT_GRAY12;
    } else {
        static const AVPixelFormat fmts[3][3] = {
            // [subsampling][depth index 8/10/12]
            {AV_PIX_FMT_YUV420P, AV_PIX_FMT_YUV420P10, AV_PIX_FMT_YUV420P12},
            {AV_PIX_FMT_YUV422P, AV_PIX_FMT_YUV422P10, AV_PIX_FMT_YUV422P12},
            {AV_PIX_FMT_YUV444P, AV_PIX_FMT_YUV444P10, AV_PIX_FMT_YUV444P12},
        };
        int ss = (sub_x && sub_y) ? 0 : (sub_x ? 1 : 2);
        if (!sub_x && sub_y) {
            set_err(err, errlen, "4:4:0 is not an AV1 subsampling");
            avcodec_free_context(&e->ctx);
            delete e;
            return nullptr;
        }
        int di = bit_depth == 8 ? 0 : bit_depth == 10 ? 1 : 2;
        e->ctx->pix_fmt = fmts[ss][di];
    }
    e->ctx->gop_size = 9999;
    AVDictionary* opts = nullptr;
    av_dict_set(&opts, "usage", "realtime", 0);
    av_dict_set(&opts, "cpu-used", "8", 0);
    av_dict_set(&opts, "crf", "40", 0);
    av_dict_set(&opts, "b", "0", 0);
    av_dict_set(&opts, "row-mt", "1", 0);
    if (extra_opts && extra_opts[0]) {
        // "key=val:key=val" pairs
        av_dict_parse_string(&opts, extra_opts, "=", ":", 0);
    }
    int ret = avcodec_open2(e->ctx, codec, &opts);
    av_dict_free(&opts);
    if (ret < 0) {
        set_averr(err, errlen, "avcodec_open2(libaom-av1)", ret);
        avcodec_free_context(&e->ctx);
        delete e;
        return nullptr;
    }
    e->frame = av_frame_alloc();
    e->pkt = av_packet_alloc();
    return e;
}

// planes: tightly packed caller buffers; strides in bytes.
int grav_encoder_send(GravEncoder* e, const uint8_t* y, int64_t stride_y,
                      const uint8_t* u, const uint8_t* v, int64_t stride_uv,
                      int64_t pts) {
    if (!y) return avcodec_send_frame(e->ctx, nullptr);
    av_frame_unref(e->frame);
    e->frame->format = e->ctx->pix_fmt;
    e->frame->width = e->ctx->width;
    e->frame->height = e->ctx->height;
    if (av_frame_get_buffer(e->frame, 0) < 0) return -1;
    const AVPixFmtDescriptor* desc = av_pix_fmt_desc_get(e->ctx->pix_fmt);
    int bytes = desc->comp[0].depth > 8 ? 2 : 1;
    int ch = e->ctx->height >> desc->log2_chroma_h;
    int cw_bytes = (e->ctx->width >> desc->log2_chroma_w) * bytes;
    for (int r = 0; r < e->ctx->height; r++)
        std::memcpy(e->frame->data[0] + (int64_t)r * e->frame->linesize[0],
                    y + r * stride_y, (size_t)(e->ctx->width * bytes));
    if (u && desc->nb_components >= 3) {
        for (int r = 0; r < ch; r++) {
            std::memcpy(e->frame->data[1] + (int64_t)r * e->frame->linesize[1],
                        u + r * stride_uv, (size_t)cw_bytes);
            std::memcpy(e->frame->data[2] + (int64_t)r * e->frame->linesize[2],
                        v + r * stride_uv, (size_t)cw_bytes);
        }
    }
    e->frame->pts = pts;
    return avcodec_send_frame(e->ctx, e->frame);
}

int grav_encoder_receive(GravEncoder* e, GravPacketView* out) {
    av_packet_unref(e->pkt);
    int ret = avcodec_receive_packet(e->ctx, e->pkt);
    if (ret == AVERROR(EAGAIN)) return 0;
    if (ret == AVERROR_EOF) return -1;
    if (ret < 0) return ret;
    out->data = e->pkt->data;
    out->size = e->pkt->size;
    out->pts = e->pkt->pts;
    out->dts = e->pkt->dts;
    out->duration = e->pkt->duration;
    out->flags = e->pkt->flags;
    out->stream_index = 0;
    return 1;
}

void grav_encoder_close(GravEncoder* e) {
    if (!e) return;
    av_frame_free(&e->frame);
    av_packet_free(&e->pkt);
    avcodec_free_context(&e->ctx);
    delete e;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Host-side grain pattern generation (AV1 spec 7.18.3.2-7.18.3.3).
//
// The pattern arrays are tiny (73x82 + 2x chroma) but the AR filter is a
// sequential recurrence; generating them on host in native code and
// uploading ~26KB/frame is the production split: per-pixel work stays on
// TPU, the scalar recurrence runs at native speed here. Bit-exact with
// ops/grain_ref.py (dav1d-validated).

extern "C" {

typedef struct GravGrainParams {
    int32_t seed;
    int32_t num_y_points, num_cb_points, num_cr_points;
    int32_t chroma_scaling_from_luma;
    int32_t ar_coeff_lag;       // 0..3
    int32_t ar_coeff_shift;     // 6..9
    int32_t grain_scale_shift;  // 0..3
    int32_t ar_coeffs_y[24];
    int32_t ar_coeffs_cb[25];
    int32_t ar_coeffs_cr[25];
} GravGrainParams;

}  // extern "C"

namespace {

struct Lfsr {
    uint16_t state;
    explicit Lfsr(uint16_t seed) : state(seed) {}
    int bits(int n) {
        uint16_t r = state;
        uint16_t bit = ((r >> 0) ^ (r >> 1) ^ (r >> 3) ^ (r >> 12)) & 1;
        r = (uint16_t)((r >> 1) | (bit << 15));
        state = r;
        return (r >> (16 - n)) & ((1 << n) - 1);
    }
};

inline int round2(int x, int shift) {
    if (shift == 0) return x;
    return (x + (1 << (shift - 1))) >> shift;
}

const int16_t* g_gaussian = nullptr;

void generate_plane(Lfsr lfsr, int h, int w, int shift, bool active,
                    int32_t* out) {
    if (!active) {
        std::memset(out, 0, sizeof(int32_t) * h * w);
        return;
    }
    for (int i = 0; i < h * w; i++) {
        out[i] = round2(g_gaussian[lfsr.bits(11)], shift);
    }
}

void ar_filter_luma(int32_t* g, int lag, const int32_t* coeffs, int ar_shift,
                    int gmin, int gmax) {
    if (lag == 0) return;
    const int w = 82, h = 73;
    for (int y = 3; y < h; y++) {
        for (int x = 3; x < w - 3; x++) {
            int64_t s = 0;
            int pos = 0;
            for (int dr = -lag; dr <= 0; dr++) {
                for (int dc = -lag; dc <= lag; dc++) {
                    if (dr == 0 && dc == 0) break;
                    s += (int64_t)coeffs[pos++] * g[(y + dr) * w + (x + dc)];
                }
            }
            int v = g[y * w + x] + round2((int)s, ar_shift);
            g[y * w + x] = v < gmin ? gmin : (v > gmax ? gmax : v);
        }
    }
}

void ar_filter_chroma(int32_t* g, const int32_t* luma, int cw, int ch, int lag,
                      const int32_t* coeffs, int ar_shift, int gmin, int gmax,
                      int subx, int suby, int num_y_points) {
    int n_spatial = 2 * lag * (lag + 1);
    for (int y = 3; y < ch; y++) {
        for (int x = 3; x < cw - 3; x++) {
            int64_t s = 0;
            int pos = 0;
            for (int dr = -lag; dr <= 0; dr++) {
                for (int dc = -lag; dc <= lag; dc++) {
                    if (dr == 0 && dc == 0) break;
                    s += (int64_t)coeffs[pos++] * g[(y + dr) * cw + (x + dc)];
                }
            }
            if (num_y_points > 0) {
                int lx = ((x - 3) << subx) + 3;
                int ly = ((y - 3) << suby) + 3;
                int acc = 0;
                for (int i = 0; i <= suby; i++)
                    for (int j = 0; j <= subx; j++)
                        acc += luma[(ly + i) * 82 + (lx + j)];
                acc = round2(acc, subx + suby);
                s += (int64_t)coeffs[n_spatial] * acc;
            }
            int v = g[y * cw + x] + round2((int)s, ar_shift);
            g[y * cw + x] = v < gmin ? gmin : (v > gmax ? gmax : v);
        }
    }
}

}  // namespace

extern "C" {

// The 2048-entry gaussian_sequence is passed in from Python once (the
// canonical copy lives with the spec tables in ops/tables_data.py).
void grav_set_gaussian_table(const int16_t* table) {
    static int16_t copy[2048];
    std::memcpy(copy, table, sizeof(copy));
    g_gaussian = copy;
}

static void grain_one_frame(const GravGrainParams& p, int bit_depth,
                            int subx, int suby, int monochrome,
                            int shift_base, int gmin, int gmax, int cw,
                            int ch, int32_t* luma, int32_t* cb,
                            int32_t* cr) {
    const int shift = shift_base + p.grain_scale_shift;
    generate_plane(Lfsr((uint16_t)p.seed), 73, 82, shift,
                   p.num_y_points > 0, luma);
    ar_filter_luma(luma, p.ar_coeff_lag, p.ar_coeffs_y, p.ar_coeff_shift,
                   gmin, gmax);
    if (monochrome || !cb) return;
    bool cb_active = p.num_cb_points > 0 || p.chroma_scaling_from_luma;
    bool cr_active = p.num_cr_points > 0 || p.chroma_scaling_from_luma;
    generate_plane(Lfsr((uint16_t)(p.seed ^ 0xb524)), ch, cw, shift,
                   cb_active, cb);
    generate_plane(Lfsr((uint16_t)(p.seed ^ 0x49d8)), ch, cw, shift,
                   cr_active, cr);
    if (cb_active)
        ar_filter_chroma(cb, luma, cw, ch, p.ar_coeff_lag, p.ar_coeffs_cb,
                         p.ar_coeff_shift, gmin, gmax, subx, suby,
                         p.num_y_points);
    if (cr_active)
        ar_filter_chroma(cr, luma, cw, ch, p.ar_coeff_lag, p.ar_coeffs_cr,
                         p.ar_coeff_shift, gmin, gmax, subx, suby,
                         p.num_y_points);
}

// Generates patterns for a batch of frames. Outputs int32, row-major:
// luma (n, 73, 82); cb/cr (n, ch, cw) where cw/ch follow subsampling
// (44/82, 38/73). cb/cr may be null when monochrome.
int grav_generate_grain_patterns(const GravGrainParams* params, int n,
                                 int bit_depth, int subx, int suby,
                                 int monochrome, int32_t* luma_out,
                                 int32_t* cb_out, int32_t* cr_out) {
    if (!g_gaussian) return -1;
    const int shift_base = 12 - bit_depth;
    const int grain_center = 128 << (bit_depth - 8);
    const int gmin = -grain_center, gmax = grain_center - 1;
    const int cw = subx ? 44 : 82;
    const int ch = suby ? 38 : 73;
    // frames are independent: split the batch across threads (the AR
    // recurrence is serial within a frame, ~0.2 ms each; a 32-64 frame
    // batch would otherwise serialize ahead of the device launch)
    int n_threads = (int)std::thread::hardware_concurrency();
    if (n_threads > n) n_threads = n;
    if (n_threads > 16) n_threads = 16;
    if (n_threads > 1) {
        std::vector<std::thread> workers;
        std::atomic<int> next(0);
        auto run = [&]() {
            for (;;) {
                int i = next.fetch_add(1);
                if (i >= n) return;
                grain_one_frame(params[i], bit_depth, subx, suby, monochrome,
                                shift_base, gmin, gmax, cw, ch,
                                luma_out + (int64_t)i * 73 * 82,
                                cb_out ? cb_out + (int64_t)i * ch * cw : nullptr,
                                cr_out ? cr_out + (int64_t)i * ch * cw : nullptr);
            }
        };
        for (int t = 0; t < n_threads; t++) workers.emplace_back(run);
        for (auto& w : workers) w.join();
        return 0;
    }
    for (int i = 0; i < n; i++)
        grain_one_frame(params[i], bit_depth, subx, suby, monochrome,
                        shift_base, gmin, gmax, cw, ch,
                        luma_out + (int64_t)i * 73 * 82,
                        cb_out ? cb_out + (int64_t)i * ch * cw : nullptr,
                        cr_out ? cr_out + (int64_t)i * ch * cw : nullptr);
    return 0;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// libavcodec trace_headers BSF capture: the external field-trace oracle.
// Runs FFmpeg's own AV1 syntax tracer over packets and returns its log
// text, so the Python tracer can be diffed field-for-field against the
// implementation the reference mimics (trace.rs docstring).

#include <cstdarg>

static std::string* g_trace_buf = nullptr;

static void trace_log_cb(void*, int level, const char* fmt, va_list args) {
    if (!g_trace_buf || level > AV_LOG_INFO) return;
    char line[4096];
    vsnprintf(line, sizeof(line), fmt, args);
    g_trace_buf->append(line);
}

extern "C" {

// Feeds `count` concatenated low-overhead temporal units (byte lengths
// in `sizes`) through ONE trace_headers BSF instance — parser state
// (sequence header) persists across packets, as in a real stream.
// Writes a US (0x1f) separator into `out` between packets so the
// caller can split per-packet traces. Returns captured length or <0.
int64_t grav_trace_headers(const uint8_t* data, const int64_t* sizes,
                           int64_t count, char* out, int64_t outlen,
                           char* err, int errlen) {
    const AVBitStreamFilter* f = av_bsf_get_by_name("trace_headers");
    if (!f) {
        set_err(err, errlen, "trace_headers bsf not found");
        return -1;
    }
    AVBSFContext* bsf = nullptr;
    int ret = av_bsf_alloc(f, &bsf);
    if (ret < 0) {
        set_averr(err, errlen, "av_bsf_alloc", ret);
        return -1;
    }
    bsf->par_in->codec_id = AV_CODEC_ID_AV1;
    ret = av_bsf_init(bsf);
    if (ret < 0) {
        set_averr(err, errlen, "av_bsf_init", ret);
        av_bsf_free(&bsf);
        return -1;
    }
    AVPacket* pkt = av_packet_alloc();

    std::string buf;
    g_trace_buf = &buf;
    int old_level = av_log_get_level();
    av_log_set_level(AV_LOG_INFO);
    av_log_set_callback(trace_log_cb);
    const uint8_t* cur = data;
    for (int64_t i = 0; i < count && ret >= 0; i++) {
        av_new_packet(pkt, (int)sizes[i]);
        std::memcpy(pkt->data, cur, (size_t)sizes[i]);
        cur += sizes[i];
        ret = av_bsf_send_packet(bsf, pkt);
        if (ret >= 0) {
            while (av_bsf_receive_packet(bsf, pkt) >= 0) av_packet_unref(pkt);
        }
        buf.push_back('\x1f');
    }
    av_log_set_callback(av_log_default_callback);
    av_log_set_level(old_level);
    g_trace_buf = nullptr;

    av_packet_free(&pkt);
    av_bsf_free(&bsf);
    if (ret < 0) {
        set_averr(err, errlen, "av_bsf_send_packet", ret);
        return -1;
    }
    int64_t n = (int64_t)buf.size();
    if (n >= outlen) n = outlen - 1;
    std::memcpy(out, buf.data(), (size_t)n);
    out[n] = '\0';
    return n;
}

}  // extern "C"
