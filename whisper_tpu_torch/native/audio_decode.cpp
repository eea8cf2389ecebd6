// Native audio file decoder: any container/codec -> float32 PCM @ target rate.
//
// The TPU-host analogue of the reference's Media Foundation audio layer
// (Whisper/MF/loadAudioFile.cpp:14-120): it decoded wav/wma/mp3 through the
// OS codec stack into mono float 16 kHz (+ optional stereo for diarization).
// Here the codec stack is FFmpeg's libavformat/libavcodec/libswresample,
// linked as a SEPARATE shared library so the base native runtime
// (whisper_native.cpp) keeps zero external dependencies.
//
// C ABI only — consumed via ctypes (whisper_tpu_torch/native/__init__.py, whisper_tpu_torch/audio/ffdecode.py).

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/opt.h>
#include <libswresample/swresample.h>
}

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Decoded {
    std::vector<float> pcm;  // interleaved
};

// Drain all frames currently available from the decoder into the resampler.
int drain_frames(AVCodecContext* dec, SwrContext* swr, AVFrame* frame,
                 int channels, std::vector<float>& out) {
    for (;;) {
        int ret = avcodec_receive_frame(dec, frame);
        if (ret == AVERROR(EAGAIN) || ret == AVERROR_EOF) return 0;
        if (ret < 0) return ret;
        // worst-case output count for this frame (+ swr internal backlog)
        int64_t max_out =
            swr_get_out_samples(swr, frame->nb_samples);
        if (max_out < frame->nb_samples) max_out = frame->nb_samples + 256;
        size_t base = out.size();
        out.resize(base + (size_t)max_out * channels);
        uint8_t* dst = (uint8_t*)(out.data() + base);
        int got = swr_convert(swr, &dst, (int)max_out,
                              (const uint8_t**)frame->extended_data,
                              frame->nb_samples);
        if (got < 0) return got;
        out.resize(base + (size_t)got * channels);
    }
}

}  // namespace

extern "C" {

int wta_version() { return 1; }

// Decode `path` to interleaved float32 PCM at `target_rate` with `channels`
// channels (1 = mono downmix, 2 = stereo). On success returns the number of
// FRAMES (samples per channel) and stores a malloc'd buffer in *out (caller
// frees with wta_free). Negative return = error.
int64_t wta_decode_file(const char* path, int target_rate, int channels,
                        float** out) {
    if (!path || !out || channels < 1 || channels > 2 || target_rate <= 0)
        return -1;
    *out = nullptr;
    av_log_set_level(AV_LOG_ERROR);

    AVFormatContext* fmt = nullptr;
    AVCodecContext* dec = nullptr;
    SwrContext* swr = nullptr;
    AVPacket* pkt = nullptr;
    AVFrame* frame = nullptr;
    int64_t result = -2;
    std::vector<float> pcm;

    do {
        if (avformat_open_input(&fmt, path, nullptr, nullptr) < 0) break;
        if (avformat_find_stream_info(fmt, nullptr) < 0) break;
        const AVCodec* codec = nullptr;
        int stream = av_find_best_stream(fmt, AVMEDIA_TYPE_AUDIO, -1, -1,
                                         &codec, 0);
        if (stream < 0 || !codec) break;
        AVStream* st = fmt->streams[stream];

        dec = avcodec_alloc_context3(codec);
        if (!dec) break;
        if (avcodec_parameters_to_context(dec, st->codecpar) < 0) break;
        if (avcodec_open2(dec, codec, nullptr) < 0) break;
        if (dec->ch_layout.nb_channels <= 0 || dec->sample_rate <= 0) break;

        AVChannelLayout out_layout;
        if (channels == 1)
            out_layout = AV_CHANNEL_LAYOUT_MONO;
        else
            out_layout = AV_CHANNEL_LAYOUT_STEREO;
        AVChannelLayout in_layout;
        if (dec->ch_layout.order == AV_CHANNEL_ORDER_UNSPEC)
            av_channel_layout_default(&in_layout, dec->ch_layout.nb_channels);
        else
            av_channel_layout_copy(&in_layout, &dec->ch_layout);

        if (swr_alloc_set_opts2(&swr, &out_layout, AV_SAMPLE_FMT_FLT,
                                target_rate, &in_layout, dec->sample_fmt,
                                dec->sample_rate, 0, nullptr) < 0)
            break;
        if (swr_init(swr) < 0) break;

        pkt = av_packet_alloc();
        frame = av_frame_alloc();
        if (!pkt || !frame) break;

        bool failed = false;
        while (av_read_frame(fmt, pkt) >= 0) {
            if (pkt->stream_index == stream) {
                int ret = avcodec_send_packet(dec, pkt);
                // tolerate corrupt packets (Media Foundation also skips them)
                if (ret >= 0 || ret == AVERROR(EAGAIN)) {
                    if (drain_frames(dec, swr, frame, channels, pcm) < 0) {
                        failed = true;
                    }
                }
            }
            av_packet_unref(pkt);
            if (failed) break;
        }
        if (failed) break;
        // flush decoder, then resampler backlog
        avcodec_send_packet(dec, nullptr);
        if (drain_frames(dec, swr, frame, channels, pcm) < 0) break;
        for (;;) {
            int64_t rem = swr_get_out_samples(swr, 0);
            if (rem <= 0) break;
            size_t base = pcm.size();
            pcm.resize(base + (size_t)rem * channels);
            uint8_t* dst = (uint8_t*)(pcm.data() + base);
            int got = swr_convert(swr, &dst, (int)rem, nullptr, 0);
            if (got <= 0) {
                pcm.resize(base);
                break;
            }
            pcm.resize(base + (size_t)got * channels);
        }

        int64_t frames = (int64_t)(pcm.size() / channels);
        float* buf = (float*)malloc(pcm.size() * sizeof(float));
        if (!buf && !pcm.empty()) {
            result = -3;
            break;
        }
        memcpy(buf, pcm.data(), pcm.size() * sizeof(float));
        *out = buf;
        result = frames;
    } while (false);

    if (frame) av_frame_free(&frame);
    if (pkt) av_packet_free(&pkt);
    if (swr) swr_free(&swr);
    if (dec) avcodec_free_context(&dec);
    if (fmt) avformat_close_input(&fmt);
    return result;
}

void wta_free(float* p) { free(p); }

}  // extern "C"
