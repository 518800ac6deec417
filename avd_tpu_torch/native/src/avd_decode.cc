// avd_decode — libav*-based media ingest of avd_tpu_torch, the PyTorch/CUDA
// port.
//
// The port's own copy of avd_tpu/native/src/avd_decode.cc: below this
// header the code is that file's byte for byte (three comments reworded).
// Three components, all exposed through a C ABI for ctypes:
//
//  1. Sampled-frame video feeder.  The reference walks EVERY frame with
//     cv2 grab() and retrieves each step-th one (reference
//     app/analyzers/video.py:19,27-33).  This feeder demuxes the packet
//     index first (no decode), groups the sampled display indices by
//     keyframe run, then seeks and decodes ONLY [keyframe .. last sample]
//     of each run.  Output pixels are identical to the cv2/ffmpeg walk
//     (same libavcodec decode, same swscale BGR24 conversion; held by
//     tests/test_torch_native_decode.py).
//
//  2. Audio extraction: first audio stream → decode → libswresample to
//     mono s16 @ 16 kHz, the byte-equivalent of the reference's
//     `ffmpeg -ac 1 -ar 16000` WAV intermediary (reference
//     app/analyzers/audio.py:7-20), without the subprocess.
//
//  3. Container probe, video encoder and audio mux (avd_probe,
//     avd_venc_write, avd_mux_audio, avd_remux_add_audio): the probe
//     route of ingest/probe.py and the test fixtures' encoders.
//
// Build: avd_tpu_torch/native/decode.py, through native/_build.py (g++ at
// first use, linked with -lavformat -lavcodec -lavutil -lswscale
// -lswresample).  Where the libav* headers are missing the build fails,
// decode.lib() returns None and the callers take their next route.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
#include <libswscale/swscale.h>
}

namespace {

struct PacketIndex {
  int64_t pts;       // presentation timestamp (or dts fallback)
  bool key;
};

// Per keyframe region (display range [key_displays[r], key_displays[r+1])):
// whether any sampled frame lives inside, and the last one's display index.
struct RegionPlan {
  bool needed;
  int64_t last_needed;
};

struct VDec {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* dec = nullptr;
  SwsContext* sws = nullptr;
  int vstream = -1;
  int width = 0, height = 0;
  std::vector<int64_t> pts_sorted;     // display order -> pts
  std::vector<int64_t> key_displays;   // keyframe display indices (asc)
  std::vector<RegionPlan> plans;       // one per keyframe region
  int64_t step = 0;
  bool tail_skip = false;              // demux order == display order
  bool needs_drain = false;            // decoder holds frames in flight
                                       // (frame threading or B-frame
                                       // reorder delay)
  // sequential decode state (single demux walk, no seeks)
  bool demux_eof = false;
  bool final_drained = false;
  bool pending_flush = false;          // packets were skipped since last send
  bool sent_since_flush = false;
  bool strict_ok = true;
  // sampled frames decoded past the caller's buffer (kept across calls)
  std::vector<uint8_t> carry_bgr;
  std::vector<int64_t> carry_idx;
  size_t carry_pos = 0;                // frames already handed out
  // aligned conversion target for odd-stride frames (swscale writes in
  // aligned chunks and overruns tightly-packed odd-width rows)
  std::vector<uint8_t> sws_scratch;
  int scratch_stride = 0;
};

int64_t display_index_of_pts(const VDec* v, int64_t pts) {
  auto it = std::lower_bound(v->pts_sorted.begin(), v->pts_sorted.end(), pts);
  if (it == v->pts_sorted.end() || *it != pts) return -1;
  return static_cast<int64_t>(it - v->pts_sorted.begin());
}

// Demux-only walk: collect (pts, keyflag) for every video packet.
// Returns false on unusable timestamps.
bool build_index(VDec* v, std::vector<PacketIndex>* out) {
  AVPacket* pkt = av_packet_alloc();
  if (!pkt) return false;
  bool ok = true;
  while (av_read_frame(v->fmt, pkt) >= 0) {
    if (pkt->stream_index == v->vstream) {
      int64_t ts = pkt->pts != AV_NOPTS_VALUE ? pkt->pts : pkt->dts;
      if (ts == AV_NOPTS_VALUE) { ok = false; av_packet_unref(pkt); break; }
      out->push_back({ts, (pkt->flags & AV_PKT_FLAG_KEY) != 0});
    }
    av_packet_unref(pkt);
    if (out->size() > (1u << 24)) { ok = false; break; }  // 16M frames cap
  }
  av_packet_free(&pkt);
  return ok && !out->empty();
}

}  // namespace

extern "C" {

struct AvdMediaInfo {
  int32_t width;
  int32_t height;
  double fps;
  int64_t n_frames;      // usable (indexed) frame count
  double duration;
  int32_t has_audio;
  int32_t reserved;
};

void* avd_vdec_open(const char* path, int64_t step, AvdMediaInfo* info) {
  av_log_set_level(AV_LOG_ERROR);
  VDec* v = new VDec();
  v->step = step > 0 ? step : 1;
  if (avformat_open_input(&v->fmt, path, nullptr, nullptr) < 0) {
    delete v;
    return nullptr;
  }
  if (avformat_find_stream_info(v->fmt, nullptr) < 0) goto fail;
  v->vstream = av_find_best_stream(v->fmt, AVMEDIA_TYPE_VIDEO, -1, -1,
                                   nullptr, 0);
  if (v->vstream < 0) goto fail;
  {
    AVStream* st = v->fmt->streams[v->vstream];
    const AVCodec* codec = avcodec_find_decoder(st->codecpar->codec_id);
    if (!codec) goto fail;
    v->dec = avcodec_alloc_context3(codec);
    if (!v->dec ||
        avcodec_parameters_to_context(v->dec, st->codecpar) < 0)
      goto fail;
    // Threaded decode: bit-exact by libav's threading contract; frame
    // threading only adds output delay, which the send/receive walk
    // below already absorbs (drain_receives + the EOF drain).  Default
    // 0 = auto (core count — a no-op on a 1-core host); pin with
    // AVD_DECODE_THREADS.
    {
      const char* te = getenv("AVD_DECODE_THREADS");
      int threads = te ? atoi(te) : 0;
      v->dec->thread_count = threads < 0 ? 0 : threads;
      v->dec->thread_type = FF_THREAD_FRAME | FF_THREAD_SLICE;
    }
    if (avcodec_open2(v->dec, codec, nullptr) < 0) goto fail;
    // Frame threading holds ~thread_count frames in flight, and B-frame
    // streams hold frames in the reorder buffer; in both cases the
    // walk's skip logic must DRAIN them at region boundaries — a plain
    // flush would discard pending sampled frames (display-late frames
    // of the last sent region), silently returning fewer samples than
    // the cv2 walk.
    v->needs_drain =
        ((v->dec->active_thread_type & FF_THREAD_FRAME) != 0 &&
         v->dec->thread_count > 1) ||
        v->dec->has_b_frames > 0 ||
        st->codecpar->video_delay > 0;

    // Pass 1: packet index (no decode).
    std::vector<PacketIndex> pkts;
    if (!build_index(v, &pkts)) goto fail;

    // Display order = pts order.  Keyframe display indices derive from
    // the same sort.
    std::vector<size_t> order(pkts.size());
    for (size_t i = 0; i < order.size(); i++) order[i] = i;
    std::stable_sort(order.begin(), order.end(),
                     [&](size_t a, size_t b) {
                       return pkts[a].pts < pkts[b].pts;
                     });
    v->pts_sorted.resize(pkts.size());
    for (size_t d = 0; d < order.size(); d++) {
      v->pts_sorted[d] = pkts[order[d]].pts;
      if (pkts[order[d]].key) v->key_displays.push_back(d);
    }
    if (v->key_displays.empty() || v->key_displays[0] != 0)
      v->key_displays.insert(v->key_displays.begin(), 0);

    // Mark which keyframe regions contain sampled frames.
    int64_t n = static_cast<int64_t>(pkts.size());
    v->plans.assign(v->key_displays.size(), {false, -1});
    size_t ki = 0;
    for (int64_t s = 0; s < n; s += v->step) {
      while (ki + 1 < v->key_displays.size() && v->key_displays[ki + 1] <= s)
        ki++;
      v->plans[ki].needed = true;
      v->plans[ki].last_needed = s;
    }

    // In-region tail skip (drop packets after the region's last sample)
    // is safe only when demux order == display order, i.e. no B-frames.
    v->tail_skip = st->codecpar->video_delay == 0 &&
                   v->dec->has_b_frames == 0;

    // Rewind the demuxer to the start for the decode walk.
    if (av_seek_frame(v->fmt, v->vstream, v->pts_sorted[0],
                      AVSEEK_FLAG_BACKWARD) < 0)
      goto fail;

    v->width = v->dec->width ? v->dec->width : st->codecpar->width;
    v->height = v->dec->height ? v->dec->height : st->codecpar->height;
    if (v->width <= 0 || v->height <= 0) goto fail;

    if (info) {
      info->width = v->width;
      info->height = v->height;
      AVRational fr = st->avg_frame_rate.num ? st->avg_frame_rate
                                             : st->r_frame_rate;
      info->fps = fr.den ? av_q2d(fr) : 0.0;
      info->n_frames = n;
      info->duration = v->fmt->duration > 0
                           ? v->fmt->duration / static_cast<double>(AV_TIME_BASE)
                           : (info->fps > 0 ? n / info->fps : 0.0);
      info->has_audio =
          av_find_best_stream(v->fmt, AVMEDIA_TYPE_AUDIO, -1, -1, nullptr,
                              0) >= 0;
    }
  }
  return v;
fail:
  if (v->dec) avcodec_free_context(&v->dec);
  if (v->fmt) avformat_close_input(&v->fmt);
  delete v;
  return nullptr;
}

void avd_vdec_close(void* handle) {
  VDec* v = static_cast<VDec*>(handle);
  if (!v) return;
  if (v->sws) sws_freeContext(v->sws);
  if (v->dec) avcodec_free_context(&v->dec);
  if (v->fmt) avformat_close_input(&v->fmt);
  delete v;
}

// Emit up to max_out sampled BGR24 frames.  Returns the count written,
// 0 at EOF, -1 on error (caller falls back to the cv2 walk).
int64_t avd_vdec_read_sampled(void* handle, int64_t max_out,
                              uint8_t* out_bgr, int64_t* out_indices) {
  VDec* v = static_cast<VDec*>(handle);
  if (!v || !v->strict_ok) return -1;
  const int64_t frame_bytes = static_cast<int64_t>(v->width) * v->height * 3;
  int64_t written = 0;

  AVPacket* pkt = av_packet_alloc();
  AVFrame* frm = av_frame_alloc();
  if (!pkt || !frm) {
    if (pkt) av_packet_free(&pkt);
    if (frm) av_frame_free(&frm);
    return -1;
  }

  // Hand out sampled frames stashed past a previous call's buffer first.
  while (written < max_out &&
         v->carry_pos < v->carry_idx.size()) {
    std::memcpy(out_bgr + written * frame_bytes,
                v->carry_bgr.data() + v->carry_pos * frame_bytes,
                frame_bytes);
    if (out_indices) out_indices[written] = v->carry_idx[v->carry_pos];
    written++;
    v->carry_pos++;
  }
  if (v->carry_pos >= v->carry_idx.size()) {
    v->carry_bgr.clear();
    v->carry_idx.clear();
    v->carry_pos = 0;
  }

  auto emit = [&](AVFrame* f, int64_t display) {
    v->sws = sws_getCachedContext(
        v->sws, f->width, f->height, static_cast<AVPixelFormat>(f->format),
        v->width, v->height, AV_PIX_FMT_BGR24, SWS_BICUBIC, nullptr,
        nullptr, nullptr);
    if (!v->sws) { v->strict_ok = false; return; }
    uint8_t* dst_base;
    if (written < max_out) {
      dst_base = out_bgr + written * frame_bytes;
    } else {  // buffer full: stash for the next call
      size_t base = v->carry_bgr.size();
      v->carry_bgr.resize(base + frame_bytes);
      v->carry_idx.push_back(display);
      dst_base = v->carry_bgr.data() + base;
    }
    const int row = v->width * 3;
    if (row % 64 == 0) {  // tightly packed rows are already aligned
      uint8_t* dst[1] = {dst_base};
      int dst_stride[1] = {row};
      sws_scale(v->sws, f->data, f->linesize, 0, f->height, dst,
                dst_stride);
    } else {
      // convert into an aligned scratch, then pack rows — swscale writes
      // aligned vector chunks and would overrun odd-width rows
      if (v->scratch_stride == 0) {
        v->scratch_stride = (row + 63) & ~63;
        v->sws_scratch.resize(static_cast<size_t>(v->scratch_stride) *
                              v->height + 64);
      }
      uint8_t* dst[1] = {v->sws_scratch.data()};
      int dst_stride[1] = {v->scratch_stride};
      sws_scale(v->sws, f->data, f->linesize, 0, f->height, dst,
                dst_stride);
      for (int y = 0; y < v->height; y++)
        std::memcpy(dst_base + static_cast<int64_t>(y) * row,
                    v->sws_scratch.data() +
                        static_cast<int64_t>(y) * v->scratch_stride,
                    row);
    }
    if (written < max_out) {
      if (out_indices) out_indices[written] = display;
      written++;
    }
  };

  // Receive all pending frames from the decoder; emit sampled ones
  // (receive order == display order, so emission stays ascending).
  auto drain_receives = [&]() {
    while (true) {
      int r = avcodec_receive_frame(v->dec, frm);
      if (r == AVERROR(EAGAIN) || r == AVERROR_EOF) break;
      if (r < 0) { v->strict_ok = false; break; }
      int64_t ts = frm->best_effort_timestamp != AV_NOPTS_VALUE
                       ? frm->best_effort_timestamp
                       : frm->pts;
      int64_t display = display_index_of_pts(v, ts);
      if (display < 0) { v->strict_ok = false; break; }
      if (display % v->step == 0) emit(frm, display);
      av_frame_unref(frm);
    }
  };

  // Single sequential demux walk.  Packets of keyframe regions without
  // sampled frames (and, for B-frame-free streams, region tails past the
  // last sample) are never sent to the decoder — demux costs ~2% of
  // decode.  The decoder is flushed once per skipped region.
  while (written < max_out && v->strict_ok && !v->final_drained) {
    if (v->demux_eof) {
      if (v->sent_since_flush) {
        avcodec_send_packet(v->dec, nullptr);  // drain decoder delay
        drain_receives();
      }
      v->final_drained = true;
      break;
    }
    int r = av_read_frame(v->fmt, pkt);
    if (r < 0) {
      v->demux_eof = true;
      continue;
    }
    if (pkt->stream_index != v->vstream) {
      av_packet_unref(pkt);
      continue;
    }
    int64_t ts = pkt->pts != AV_NOPTS_VALUE ? pkt->pts : pkt->dts;
    int64_t d = ts != AV_NOPTS_VALUE ? display_index_of_pts(v, ts) : -1;
    if (d < 0) {
      av_packet_unref(pkt);
      v->strict_ok = false;
      break;
    }
    auto it = std::upper_bound(v->key_displays.begin(),
                               v->key_displays.end(), d);
    size_t region = static_cast<size_t>(it - v->key_displays.begin()) - 1;
    const RegionPlan& plan = v->plans[region];
    bool skip = !plan.needed ||
                (v->tail_skip && d > plan.last_needed);
    if (skip) {
      av_packet_unref(pkt);
      if (v->sent_since_flush) {
        if (v->needs_drain) {
          // the decoder still holds frames in flight (threading pipeline
          // or B-frame reorder buffer); a plain flush would DISCARD them
          // (losing samples) and the tail-skip no-flush path would
          // strand them.  Enter drain mode, receive everything, then
          // reset for the next region.
          // A failed EOF-send means the flush below would drop in-flight
          // samples — mark strict failure so the cv2 walk takes over.
          if (avcodec_send_packet(v->dec, nullptr) < 0) {
            v->strict_ok = false;
            break;
          }
          drain_receives();
          avcodec_flush_buffers(v->dec);
          v->pending_flush = false;
        } else {
          v->pending_flush = true;
        }
        v->sent_since_flush = false;
      }
      continue;
    }
    if (v->pending_flush) {
      // A flush costs ~6 ms on this decoder (buffer pool teardown).  It
      // is only needed when reordered frames could pend across the skip;
      // B-frame-free streams resume cleanly at the region's keyframe.
      if (!v->tail_skip) avcodec_flush_buffers(v->dec);
      v->pending_flush = false;
    }
    // With threaded decode the pipeline fills and send_packet returns
    // EAGAIN — drain and RESEND the same packet (dropping it loses the
    // frame; single-threaded decode never hits this since every send is
    // followed by a full drain).
    while (true) {
      r = avcodec_send_packet(v->dec, pkt);
      if (r != AVERROR(EAGAIN)) break;
      drain_receives();
      if (!v->strict_ok) break;
    }
    av_packet_unref(pkt);
    if (r < 0 && r != AVERROR(EAGAIN)) {
      v->strict_ok = false;
      break;
    }
    v->sent_since_flush = true;
    drain_receives();
  }

  av_packet_free(&pkt);
  av_frame_free(&frm);
  if (!v->strict_ok) return -1;
  return written;
}

// ---------------------------------------------------------------------------
// audio extraction: first audio stream -> mono s16-equivalent float @ rate
// ---------------------------------------------------------------------------

struct ADec {
  AVFormatContext* fmt = nullptr;
  AVCodecContext* dec = nullptr;
  SwrContext* swr = nullptr;
  int astream = -1;
  int rate = 16000;
  bool demux_eof = false;
  bool drained = false;
  std::vector<int16_t> carry;   // converted samples not yet handed out
  size_t carry_pos = 0;
};

void* avd_adec_open(const char* path, int32_t rate, double* duration_out) {
  av_log_set_level(AV_LOG_ERROR);
  ADec* a = new ADec();
  a->rate = rate > 0 ? rate : 16000;
  if (avformat_open_input(&a->fmt, path, nullptr, nullptr) < 0) {
    delete a;
    return nullptr;
  }
  if (avformat_find_stream_info(a->fmt, nullptr) < 0) goto fail;
  a->astream = av_find_best_stream(a->fmt, AVMEDIA_TYPE_AUDIO, -1, -1,
                                   nullptr, 0);
  if (a->astream < 0) goto fail;
  {
    AVStream* st = a->fmt->streams[a->astream];
    const AVCodec* codec = avcodec_find_decoder(st->codecpar->codec_id);
    if (!codec) goto fail;
    a->dec = avcodec_alloc_context3(codec);
    if (!a->dec ||
        avcodec_parameters_to_context(a->dec, st->codecpar) < 0 ||
        avcodec_open2(a->dec, codec, nullptr) < 0)
      goto fail;

    AVChannelLayout mono = AV_CHANNEL_LAYOUT_MONO;
    AVChannelLayout in_layout;
    if (a->dec->ch_layout.nb_channels > 0)
      av_channel_layout_copy(&in_layout, &a->dec->ch_layout);
    else
      av_channel_layout_default(&in_layout, 2);
    // Same conversion the reference's `ffmpeg -ac 1 -ar 16000` performs:
    // libswresample with default matrix/resampler to mono s16 @ rate
    // (audio.py:10-13 produces the WAV this is byte-equivalent to).
    if (swr_alloc_set_opts2(&a->swr, &mono, AV_SAMPLE_FMT_S16, a->rate,
                            &in_layout, a->dec->sample_fmt,
                            a->dec->sample_rate, 0, nullptr) < 0)
      goto fail;
    av_channel_layout_uninit(&in_layout);
    if (swr_init(a->swr) < 0) goto fail;
    if (duration_out)
      *duration_out = a->fmt->duration > 0
                          ? a->fmt->duration / static_cast<double>(AV_TIME_BASE)
                          : 0.0;
  }
  return a;
fail:
  if (a->swr) swr_free(&a->swr);
  if (a->dec) avcodec_free_context(&a->dec);
  if (a->fmt) avformat_close_input(&a->fmt);
  delete a;
  return nullptr;
}

void avd_adec_close(void* handle) {
  ADec* a = static_cast<ADec*>(handle);
  if (!a) return;
  if (a->swr) swr_free(&a->swr);
  if (a->dec) avcodec_free_context(&a->dec);
  if (a->fmt) avformat_close_input(&a->fmt);
  delete a;
}

// Fill out[max_samples] with mono float32 in [-1, 1) (s16/32768 — matching
// soundfile's read of the reference's 16-bit WAV).  Returns samples
// written; 0 at EOF; -1 on error.
int64_t avd_adec_read(void* handle, float* out, int64_t max_samples) {
  ADec* a = static_cast<ADec*>(handle);
  if (!a) return -1;
  int64_t written = 0;

  auto take_carry = [&]() {
    while (written < max_samples && a->carry_pos < a->carry.size())
      out[written++] = a->carry[a->carry_pos++] / 32768.0f;
    if (a->carry_pos >= a->carry.size()) {
      a->carry.clear();
      a->carry_pos = 0;
    }
  };
  take_carry();

  AVPacket* pkt = av_packet_alloc();
  AVFrame* frm = av_frame_alloc();
  if (!pkt || !frm) {
    if (pkt) av_packet_free(&pkt);
    if (frm) av_frame_free(&frm);
    return -1;
  }

  auto convert_frame = [&](AVFrame* f) {
    int64_t max_out =
        av_rescale_rnd(swr_get_delay(a->swr, a->dec->sample_rate) +
                           (f ? f->nb_samples : 0),
                       a->rate, a->dec->sample_rate, AV_ROUND_UP) +
        64;
    size_t base = a->carry.size();
    a->carry.resize(base + max_out);
    uint8_t* dst[1] = {reinterpret_cast<uint8_t*>(a->carry.data() + base)};
    int got = swr_convert(a->swr, dst, static_cast<int>(max_out),
                          f ? const_cast<const uint8_t**>(f->data) : nullptr,
                          f ? f->nb_samples : 0);
    a->carry.resize(base + (got > 0 ? got : 0));
  };

  bool error = false;
  while (written < max_samples && !a->drained && !error) {
    if (!a->demux_eof) {
      int r = av_read_frame(a->fmt, pkt);
      if (r < 0) {
        a->demux_eof = true;
        avcodec_send_packet(a->dec, nullptr);
      } else {
        if (pkt->stream_index != a->astream) {
          av_packet_unref(pkt);
          continue;
        }
        r = avcodec_send_packet(a->dec, pkt);
        av_packet_unref(pkt);
        if (r < 0 && r != AVERROR(EAGAIN)) { error = true; break; }
      }
    }
    while (true) {
      int r = avcodec_receive_frame(a->dec, frm);
      if (r == AVERROR(EAGAIN)) break;
      if (r == AVERROR_EOF) {
        convert_frame(nullptr);  // flush the resampler
        a->drained = true;
        break;
      }
      if (r < 0) { error = true; break; }
      convert_frame(frm);
      av_frame_unref(frm);
    }
    take_carry();
  }
  take_carry();

  av_packet_free(&pkt);
  av_frame_free(&frm);
  if (error && written == 0) return -1;
  return written;
}

// ---------------------------------------------------------------------------
// test-fixture muxing: deterministic A/V files without an ffmpeg binary
// ---------------------------------------------------------------------------

// Write `path` with an AAC audio track encoding the given mono f32 samples
// (and no video).  Used by tests to exercise the mp4/AAC extraction path.
// Returns 0 on success.
int32_t avd_mux_audio(const char* path, const float* samples, int64_t n,
                      int32_t rate) {
  av_log_set_level(AV_LOG_ERROR);
  AVFormatContext* fmt = nullptr;
  if (avformat_alloc_output_context2(&fmt, nullptr, nullptr, path) < 0 ||
      !fmt)
    return -1;
  const AVCodec* codec = avcodec_find_encoder(AV_CODEC_ID_AAC);
  int rc = -1;
  AVCodecContext* enc = nullptr;
  AVStream* st = nullptr;
  SwrContext* swr = nullptr;
  AVFrame* frm = nullptr;
  AVPacket* pkt = nullptr;
  int64_t pos = 0, pts = 0;
  if (!codec) goto done;
  st = avformat_new_stream(fmt, nullptr);
  enc = avcodec_alloc_context3(codec);
  if (!st || !enc) goto done;
  enc->sample_rate = rate;
  av_channel_layout_default(&enc->ch_layout, 1);
  enc->sample_fmt = AV_SAMPLE_FMT_FLTP;
  enc->bit_rate = 96000;
  enc->time_base = {1, rate};
  if (fmt->oformat->flags & AVFMT_GLOBALHEADER)
    enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  if (avcodec_open2(enc, codec, nullptr) < 0) goto done;
  if (avcodec_parameters_from_context(st->codecpar, enc) < 0) goto done;
  st->time_base = enc->time_base;
  if (!(fmt->oformat->flags & AVFMT_NOFILE) &&
      avio_open(&fmt->pb, path, AVIO_FLAG_WRITE) < 0)
    goto done;
  if (avformat_write_header(fmt, nullptr) < 0) goto done;

  frm = av_frame_alloc();
  pkt = av_packet_alloc();
  if (!frm || !pkt) goto done;

  while (pos < n) {
    int64_t take = std::min<int64_t>(enc->frame_size, n - pos);
    frm->nb_samples = enc->frame_size;  // allocate a full frame
    frm->format = AV_SAMPLE_FMT_FLTP;
    av_channel_layout_default(&frm->ch_layout, 1);
    frm->sample_rate = rate;
    frm->pts = pts;
    if (av_frame_get_buffer(frm, 0) < 0) goto done;
    std::memcpy(frm->data[0], samples + pos, take * sizeof(float));
    if (take < enc->frame_size)
      std::memset(frm->data[0] + take * sizeof(float), 0,
                  (enc->frame_size - take) * sizeof(float));
    frm->nb_samples = static_cast<int>(take);
    pts += take;
    pos += take;
    if (avcodec_send_frame(enc, frm) < 0) goto done;
    av_frame_unref(frm);
    while (avcodec_receive_packet(enc, pkt) == 0) {
      av_packet_rescale_ts(pkt, enc->time_base, st->time_base);
      pkt->stream_index = st->index;
      av_interleaved_write_frame(fmt, pkt);
    }
  }
  avcodec_send_frame(enc, nullptr);
  while (avcodec_receive_packet(enc, pkt) == 0) {
    av_packet_rescale_ts(pkt, enc->time_base, st->time_base);
    pkt->stream_index = st->index;
    av_interleaved_write_frame(fmt, pkt);
  }
  av_write_trailer(fmt);
  rc = 0;
done:
  if (frm) av_frame_free(&frm);
  if (pkt) av_packet_free(&pkt);
  if (swr) swr_free(&swr);
  if (enc) avcodec_free_context(&enc);
  if (fmt) {
    if (!(fmt->oformat->flags & AVFMT_NOFILE) && fmt->pb)
      avio_closep(&fmt->pb);
    avformat_free_context(fmt);
  }
  return rc;
}

// ---------------------------------------------------------------------------
// container probe: the fields the reference's _probe_basic_meta extracts
// from `ffprobe -of json` (reference api.py:46-89), read through
// libavformat directly.
// ---------------------------------------------------------------------------

struct AvdProbeInfo {
  int32_t width;
  int32_t height;
  double fps;            // r_frame_rate of the first video stream
  double duration;       // format duration, seconds
  int64_t bit_rate;      // format bit rate
  char vcodec[32];
  char acodec[32];
  char format_name[64];
};

int32_t avd_probe(const char* path, AvdProbeInfo* out) {
  av_log_set_level(AV_LOG_ERROR);
  std::memset(out, 0, sizeof(*out));
  AVFormatContext* f = nullptr;
  if (avformat_open_input(&f, path, nullptr, nullptr) < 0) return -1;
  if (avformat_find_stream_info(f, nullptr) < 0) {
    avformat_close_input(&f);
    return -1;
  }
  for (unsigned i = 0; i < f->nb_streams; i++) {
    AVCodecParameters* par = f->streams[i]->codecpar;
    if (par->codec_type == AVMEDIA_TYPE_VIDEO && out->width == 0) {
      out->width = par->width;
      out->height = par->height;
      AVRational fr = f->streams[i]->r_frame_rate;
      out->fps = fr.den ? av_q2d(fr) : 0.0;
      snprintf(out->vcodec, sizeof(out->vcodec), "%s",
               avcodec_get_name(par->codec_id));
    } else if (par->codec_type == AVMEDIA_TYPE_AUDIO &&
               out->acodec[0] == '\0') {
      snprintf(out->acodec, sizeof(out->acodec), "%s",
               avcodec_get_name(par->codec_id));
    }
  }
  out->duration = f->duration > 0
                      ? f->duration / static_cast<double>(AV_TIME_BASE)
                      : 0.0;
  out->bit_rate = f->bit_rate > 0 ? f->bit_rate : 0;
  if (f->iformat && f->iformat->name)
    snprintf(out->format_name, sizeof(out->format_name), "%s",
             f->iformat->name);
  avformat_close_input(&f);
  return 0;
}

// ---------------------------------------------------------------------------
// video encoder: real H.264/H.265/MPEG-4 compression round-trips.
//
// The reference's whole domain is COMPRESSED uploads — its heuristics
// classify bits-per-pixel compression classes
// (reference app/analyzers/heuristics_v2.py:9-12) and fusion
// penalizes heavy compression (reference app/analyzers/fusion.py:44).
// Detector robustness therefore has to be measured (and trained) against
// real codec artifacts: temporally-correlated blocking/ringing/motion-
// compensation residue that JPEG quantization cannot model.  Where no ffmpeg
// binary is installed, libavcodec.so.59 still ships working libx264/libx265/
// mpeg4 encoders; this entry point drives them directly, the same way the
// decode side replaces the reference's ffmpeg subprocess.
// ---------------------------------------------------------------------------

// Encode n tightly-packed BGR24 frames as one video file at `path`
// (container from the extension, use .mp4).  crf >= 0 selects constant-
// rate-factor mode on x264/x265 (and maps to qscale on mpeg4); gop <= 0
// keeps the codec default keyframe interval.  Returns 0 on success.
int32_t avd_venc_write(const char* path, const uint8_t* bgr, int64_t n,
                       int32_t w, int32_t h, double fps,
                       const char* codec_name, int32_t crf, int32_t gop,
                       const char* preset) {
  av_log_set_level(AV_LOG_ERROR);
  if (n <= 0 || w <= 0 || h <= 0 || (w % 2) || (h % 2) || fps <= 0.0)
    return -1;  // yuv420p needs even dimensions
  AVFormatContext* fmt = nullptr;
  if (avformat_alloc_output_context2(&fmt, nullptr, nullptr, path) < 0 ||
      !fmt)
    return -1;
  const AVCodec* codec = avcodec_find_encoder_by_name(codec_name);
  int rc = -1;
  AVCodecContext* enc = nullptr;
  AVStream* st = nullptr;
  SwsContext* sws = nullptr;
  AVFrame* frm = nullptr;
  AVPacket* pkt = nullptr;
  AVRational tb;
  bool is_x26x = false;
  if (!codec) goto done;
  st = avformat_new_stream(fmt, nullptr);
  enc = avcodec_alloc_context3(codec);
  if (!st || !enc) goto done;
  tb = av_inv_q(av_d2q(fps, 1 << 24));
  enc->width = w;
  enc->height = h;
  enc->time_base = tb;
  enc->framerate = av_inv_q(tb);
  enc->pix_fmt = AV_PIX_FMT_YUV420P;
  if (gop > 0) enc->gop_size = gop;
  is_x26x = std::strcmp(codec_name, "libx264") == 0 ||
            std::strcmp(codec_name, "libx265") == 0;
  if (is_x26x) {
    if (crf >= 0) {
      char buf[16];
      snprintf(buf, sizeof(buf), "%d", crf);
      av_opt_set(enc->priv_data, "crf", buf, 0);
    }
    if (preset && preset[0]) av_opt_set(enc->priv_data, "preset", preset, 0);
    if (std::strcmp(codec_name, "libx265") == 0)
      av_opt_set(enc->priv_data, "x265-params", "log-level=error", 0);
  } else if (crf >= 0) {
    // qscale mode for the MPEG-4 part-2 family: map CRF-ish 0..51 onto
    // the 1..31 quantizer range.
    enc->flags |= AV_CODEC_FLAG_QSCALE;
    int q = 1 + crf * 30 / 51;
    enc->global_quality = FF_QP2LAMBDA * (q < 1 ? 1 : (q > 31 ? 31 : q));
  }
  if (fmt->oformat->flags & AVFMT_GLOBALHEADER)
    enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  if (avcodec_open2(enc, codec, nullptr) < 0) goto done;
  if (avcodec_parameters_from_context(st->codecpar, enc) < 0) goto done;
  st->time_base = enc->time_base;
  if (!(fmt->oformat->flags & AVFMT_NOFILE) &&
      avio_open(&fmt->pb, path, AVIO_FLAG_WRITE) < 0)
    goto done;
  if (avformat_write_header(fmt, nullptr) < 0) goto done;

  sws = sws_getContext(w, h, AV_PIX_FMT_BGR24, w, h, AV_PIX_FMT_YUV420P,
                       SWS_BICUBIC, nullptr, nullptr, nullptr);
  frm = av_frame_alloc();
  pkt = av_packet_alloc();
  if (!sws || !frm || !pkt) goto done;
  frm->format = AV_PIX_FMT_YUV420P;
  frm->width = w;
  frm->height = h;
  if (av_frame_get_buffer(frm, 0) < 0) goto done;

  for (int64_t i = 0; i < n; i++) {
    if (av_frame_make_writable(frm) < 0) goto done;
    const uint8_t* src[1] = {bgr + i * static_cast<int64_t>(w) * h * 3};
    const int stride[1] = {w * 3};
    sws_scale(sws, src, stride, 0, h, frm->data, frm->linesize);
    frm->pts = i;
    if (enc->flags & AV_CODEC_FLAG_QSCALE)
      frm->quality = enc->global_quality;
    if (avcodec_send_frame(enc, frm) < 0) goto done;
    while (avcodec_receive_packet(enc, pkt) == 0) {
      // a zero-duration final sample lands exactly on the track's edit-
      // list boundary and gets DISCARD-flagged on demux — every frame is
      // one tick of the 1/fps encoder time base
      if (pkt->duration <= 0) pkt->duration = 1;
      av_packet_rescale_ts(pkt, enc->time_base, st->time_base);
      pkt->stream_index = st->index;
      av_interleaved_write_frame(fmt, pkt);
    }
  }
  avcodec_send_frame(enc, nullptr);
  while (avcodec_receive_packet(enc, pkt) == 0) {
    if (pkt->duration <= 0) pkt->duration = 1;
    av_packet_rescale_ts(pkt, enc->time_base, st->time_base);
    pkt->stream_index = st->index;
    av_interleaved_write_frame(fmt, pkt);
  }
  av_write_trailer(fmt);
  rc = 0;
done:
  if (sws) sws_freeContext(sws);
  if (frm) av_frame_free(&frm);
  if (pkt) av_packet_free(&pkt);
  if (enc) avcodec_free_context(&enc);
  if (fmt) {
    if (!(fmt->oformat->flags & AVFMT_NOFILE) && fmt->pb)
      avio_closep(&fmt->pb);
    avformat_free_context(fmt);
  }
  return rc;
}

// Remux: copy the video stream of `video_path` and add an AAC track
// encoding the given mono f32 samples — produces the A/V fixtures the
// reference exercises through uploaded phone/social clips.  Returns 0 on
// success.
int32_t avd_remux_add_audio(const char* video_path, const char* out_path,
                            const float* samples, int64_t n, int32_t rate) {
  av_log_set_level(AV_LOG_ERROR);
  AVFormatContext* in = nullptr;
  AVFormatContext* out = nullptr;
  AVCodecContext* enc = nullptr;
  AVFrame* frm = nullptr;
  AVPacket* pkt = nullptr;
  int vin = -1;
  int rc = -1;
  int64_t pos = 0, pts = 0;
  const AVCodec* codec = nullptr;
  AVStream* vst = nullptr;
  AVStream* ast = nullptr;

  if (avformat_open_input(&in, video_path, nullptr, nullptr) < 0) return -1;
  if (avformat_find_stream_info(in, nullptr) < 0) goto done;
  vin = av_find_best_stream(in, AVMEDIA_TYPE_VIDEO, -1, -1, nullptr, 0);
  if (vin < 0) goto done;
  if (avformat_alloc_output_context2(&out, nullptr, nullptr, out_path) < 0)
    goto done;

  vst = avformat_new_stream(out, nullptr);
  if (!vst ||
      avcodec_parameters_copy(vst->codecpar, in->streams[vin]->codecpar) < 0)
    goto done;
  vst->codecpar->codec_tag = 0;
  vst->time_base = in->streams[vin]->time_base;

  codec = avcodec_find_encoder(AV_CODEC_ID_AAC);
  if (!codec) goto done;
  ast = avformat_new_stream(out, nullptr);
  enc = avcodec_alloc_context3(codec);
  if (!ast || !enc) goto done;
  enc->sample_rate = rate;
  av_channel_layout_default(&enc->ch_layout, 1);
  enc->sample_fmt = AV_SAMPLE_FMT_FLTP;
  enc->bit_rate = 96000;
  enc->time_base = {1, rate};
  if (out->oformat->flags & AVFMT_GLOBALHEADER)
    enc->flags |= AV_CODEC_FLAG_GLOBAL_HEADER;
  if (avcodec_open2(enc, codec, nullptr) < 0) goto done;
  if (avcodec_parameters_from_context(ast->codecpar, enc) < 0) goto done;
  ast->time_base = enc->time_base;

  if (!(out->oformat->flags & AVFMT_NOFILE) &&
      avio_open(&out->pb, out_path, AVIO_FLAG_WRITE) < 0)
    goto done;
  if (avformat_write_header(out, nullptr) < 0) goto done;

  frm = av_frame_alloc();
  pkt = av_packet_alloc();
  if (!frm || !pkt) goto done;

  // 1) copy video packets
  while (av_read_frame(in, pkt) >= 0) {
    if (pkt->stream_index == vin) {
      av_packet_rescale_ts(pkt, in->streams[vin]->time_base,
                           vst->time_base);
      pkt->stream_index = vst->index;
      av_interleaved_write_frame(out, pkt);
    }
    av_packet_unref(pkt);
  }
  // 2) encode the audio track
  while (pos < n) {
    int64_t take = std::min<int64_t>(enc->frame_size, n - pos);
    frm->nb_samples = enc->frame_size;
    frm->format = AV_SAMPLE_FMT_FLTP;
    av_channel_layout_default(&frm->ch_layout, 1);
    frm->sample_rate = rate;
    frm->pts = pts;
    if (av_frame_get_buffer(frm, 0) < 0) goto done;
    std::memcpy(frm->data[0], samples + pos, take * sizeof(float));
    if (take < enc->frame_size)
      std::memset(frm->data[0] + take * sizeof(float), 0,
                  (enc->frame_size - take) * sizeof(float));
    frm->nb_samples = static_cast<int>(take);
    pts += take;
    pos += take;
    if (avcodec_send_frame(enc, frm) < 0) goto done;
    av_frame_unref(frm);
    while (avcodec_receive_packet(enc, pkt) == 0) {
      av_packet_rescale_ts(pkt, enc->time_base, ast->time_base);
      pkt->stream_index = ast->index;
      av_interleaved_write_frame(out, pkt);
    }
  }
  avcodec_send_frame(enc, nullptr);
  while (avcodec_receive_packet(enc, pkt) == 0) {
    av_packet_rescale_ts(pkt, enc->time_base, ast->time_base);
    pkt->stream_index = ast->index;
    av_interleaved_write_frame(out, pkt);
  }
  av_write_trailer(out);
  rc = 0;
done:
  if (frm) av_frame_free(&frm);
  if (pkt) av_packet_free(&pkt);
  if (enc) avcodec_free_context(&enc);
  if (out) {
    if (!(out->oformat->flags & AVFMT_NOFILE) && out->pb)
      avio_closep(&out->pb);
    avformat_free_context(out);
  }
  if (in) avformat_close_input(&in);
  return rc;
}

}  // extern "C"
