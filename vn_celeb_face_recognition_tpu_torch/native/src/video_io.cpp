// Video demux and decode (libavformat, libavcodec, libswscale) to packed
// RGB24 frames, with a plain C interface for ctypes: open a file, read up
// to n frames into one contiguous buffer, close. The pixel format is
// converted with SWS_BILINEAR, as in the JAX package's native runtime, so
// both give the same frames.

#include <cstdint>
#include <cstring>

extern "C" {
#include <libavcodec/avcodec.h>
#include <libavformat/avformat.h>
#include <libavutil/imgutils.h>
#include <libswscale/swscale.h>
}

struct VnVideo {
    AVFormatContext* fmt = nullptr;
    AVCodecContext* codec = nullptr;
    SwsContext* sws = nullptr;
    AVFrame* frame = nullptr;
    AVPacket* pkt = nullptr;
    // aligned RGB staging buffer: swscale's SIMD paths can overrun
    // unaligned packed strides, so convert here, then copy rows out
    uint8_t* rgb_data[4] = {nullptr, nullptr, nullptr, nullptr};
    int rgb_linesize[4] = {0, 0, 0, 0};
    int stream_idx = -1;
    int width = 0;
    int height = 0;
    double fps = 0.0;
    int64_t nframes = 0;
    bool eof = false;
};

extern "C" {

void* vn_video_open(const char* path) {
    auto* v = new VnVideo();
    if (avformat_open_input(&v->fmt, path, nullptr, nullptr) < 0) {
        delete v;
        return nullptr;
    }
    if (avformat_find_stream_info(v->fmt, nullptr) < 0) {
        avformat_close_input(&v->fmt);
        delete v;
        return nullptr;
    }
    const AVCodec* dec = nullptr;
    v->stream_idx = av_find_best_stream(v->fmt, AVMEDIA_TYPE_VIDEO, -1,
                                        -1, &dec, 0);
    if (v->stream_idx < 0 || !dec) {
        avformat_close_input(&v->fmt);
        delete v;
        return nullptr;
    }
    AVStream* st = v->fmt->streams[v->stream_idx];
    v->codec = avcodec_alloc_context3(dec);
    avcodec_parameters_to_context(v->codec, st->codecpar);
    v->codec->thread_count = 0;  // auto
    if (avcodec_open2(v->codec, dec, nullptr) < 0) {
        avcodec_free_context(&v->codec);
        avformat_close_input(&v->fmt);
        delete v;
        return nullptr;
    }
    v->width = v->codec->width;
    v->height = v->codec->height;
    AVRational r = st->avg_frame_rate.num ? st->avg_frame_rate
                                          : st->r_frame_rate;
    v->fps = r.den ? static_cast<double>(r.num) / r.den : 25.0;
    v->nframes = st->nb_frames;
    v->frame = av_frame_alloc();
    v->pkt = av_packet_alloc();
    if (av_image_alloc(v->rgb_data, v->rgb_linesize, v->width,
                       v->height, AV_PIX_FMT_RGB24, 64) < 0) {
        av_packet_free(&v->pkt);
        av_frame_free(&v->frame);
        avcodec_free_context(&v->codec);
        avformat_close_input(&v->fmt);
        delete v;
        return nullptr;
    }
    return v;
}

int vn_video_width(void* h) { return static_cast<VnVideo*>(h)->width; }
int vn_video_height(void* h) { return static_cast<VnVideo*>(h)->height; }
double vn_video_fps(void* h) { return static_cast<VnVideo*>(h)->fps; }
int64_t vn_video_nframes(void* h) {
    return static_cast<VnVideo*>(h)->nframes;
}

// Decode up to n frames as packed RGB24 into dst (n*h*w*3 bytes).
// Returns the number of frames written (0 at the end of the stream).
int vn_video_read(void* handle, uint8_t* dst, int n) {
    auto* v = static_cast<VnVideo*>(handle);
    if (v->eof) return 0;
    const size_t frame_bytes =
        static_cast<size_t>(v->width) * v->height * 3;
    int got = 0;
    while (got < n) {
        int ret = avcodec_receive_frame(v->codec, v->frame);
        if (ret == 0) {
            if (!v->sws) {
                v->sws = sws_getContext(
                    v->width, v->height, v->codec->pix_fmt, v->width,
                    v->height, AV_PIX_FMT_RGB24, SWS_BILINEAR, nullptr,
                    nullptr, nullptr);
            }
            sws_scale(v->sws, v->frame->data, v->frame->linesize, 0,
                      v->height, v->rgb_data, v->rgb_linesize);
            uint8_t* out = dst + frame_bytes * got;
            const size_t row = static_cast<size_t>(v->width) * 3;
            for (int y = 0; y < v->height; ++y) {
                memcpy(out + row * y,
                       v->rgb_data[0] + v->rgb_linesize[0] * y, row);
            }
            av_frame_unref(v->frame);
            ++got;
            continue;
        }
        if (ret == AVERROR_EOF) {
            v->eof = true;
            break;
        }
        // the decoder needs more input
        ret = av_read_frame(v->fmt, v->pkt);
        if (ret < 0) {
            avcodec_send_packet(v->codec, nullptr);  // flush
            continue;
        }
        if (v->pkt->stream_index == v->stream_idx) {
            avcodec_send_packet(v->codec, v->pkt);
        }
        av_packet_unref(v->pkt);
    }
    return got;
}

void vn_video_close(void* handle) {
    auto* v = static_cast<VnVideo*>(handle);
    if (v->sws) sws_freeContext(v->sws);
    if (v->pkt) av_packet_free(&v->pkt);
    if (v->frame) av_frame_free(&v->frame);
    if (v->rgb_data[0]) av_freep(&v->rgb_data[0]);
    if (v->codec) avcodec_free_context(&v->codec);
    if (v->fmt) avformat_close_input(&v->fmt);
    delete v;
}

}  // extern "C"
