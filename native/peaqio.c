/* peaqio — native host-side audio I/O for gstpeaq_jax.
 *
 * Replaces the reference CLI's GStreamer front-end
 * (filesrc ! wavparse ! audioconvert ! audioresample, src/peaq.c:154-209)
 * with a small C library: WAV decode (PCM 8/16/24/32 + IEEE float, incl.
 * WAVE_FORMAT_EXTENSIBLE) and a Kaiser-windowed polyphase resampler to
 * 48 kHz.  Exposed to Python via ctypes (gstpeaq_jax/utils/native.py); used
 * by the codec-sweep loader where Python-side decoding of 10k pairs would
 * bottleneck the device.
 *
 * Build: make -C native   (produces libpeaqio.so)
 */

#include <math.h>
#include <stdint.h>

#ifndef M_PI
#define M_PI 3.14159265358979323846
#endif

#include <stdio.h>
#include <stdlib.h>
#include <string.h>

#define WAVE_FORMAT_PCM 1
#define WAVE_FORMAT_IEEE_FLOAT 3
#define WAVE_FORMAT_EXTENSIBLE 0xFFFE

typedef struct {
    int rate;
    int channels;
    int bits;
    int format;
    int64_t frames;
    int64_t data_offset;
} WavInfo;

static int read_u32le(const uint8_t *p) {
    return (int)(p[0] | (p[1] << 8) | ((uint32_t)p[2] << 16)
                 | ((uint32_t)p[3] << 24));
}

static int read_u16le(const uint8_t *p) { return p[0] | (p[1] << 8); }

static int parse_header(FILE *fh, WavInfo *info) {
    uint8_t hdr[12];
    if (fread(hdr, 1, 12, fh) != 12) return -1;
    if (memcmp(hdr, "RIFF", 4) || memcmp(hdr + 8, "WAVE", 4)) return -2;
    int have_fmt = 0, have_data = 0;
    int64_t pos = 12;
    while (!have_data) {
        uint8_t chdr[8];
        if (fseek(fh, (long)pos, SEEK_SET)) return -3;
        if (fread(chdr, 1, 8, fh) != 8) return -3;
        uint32_t size = (uint32_t)read_u32le(chdr + 4);
        if (!memcmp(chdr, "fmt ", 4)) {
            uint8_t fmt[40];
            size_t n = size < sizeof fmt ? size : sizeof fmt;
            if (fread(fmt, 1, n, fh) != n) return -4;
            info->format = read_u16le(fmt);
            info->channels = read_u16le(fmt + 2);
            info->rate = read_u32le(fmt + 4);
            info->bits = read_u16le(fmt + 14);
            if (info->format == WAVE_FORMAT_EXTENSIBLE && n >= 26)
                info->format = read_u16le(fmt + 24);
            have_fmt = 1;
        } else if (!memcmp(chdr, "data", 4)) {
            info->data_offset = pos + 8;
            int block = info->channels * (info->bits / 8);
            if (block <= 0) return -5;
            info->frames = (int64_t)size / block;
            have_data = 1;
        }
        pos += 8 + size + (size & 1);
    }
    return (have_fmt && have_data) ? 0 : -6;
}

/* Query a WAV file: returns 0 and fills rate/channels/frames. */
int peaq_wav_info(const char *path, int *rate, int *channels,
                  int64_t *frames) {
    FILE *fh = fopen(path, "rb");
    if (!fh) return -1;
    WavInfo info = {0};
    int rc = parse_header(fh, &info);
    fclose(fh);
    if (rc) return rc;
    *rate = info.rate;
    *channels = info.channels;
    *frames = info.frames;
    return 0;
}

/* Decode to interleaved float32 (audioconvert semantics: int / 2^(bits-1)).
 * out must hold frames*channels floats.  Returns frames decoded or <0. */
int64_t peaq_wav_read_f32(const char *path, float *out, int64_t max_frames) {
    FILE *fh = fopen(path, "rb");
    if (!fh) return -1;
    WavInfo info = {0};
    int rc = parse_header(fh, &info);
    if (rc) { fclose(fh); return rc; }
    int64_t frames = info.frames < max_frames ? info.frames : max_frames;
    int block = info.channels * (info.bits / 8);
    int64_t total = frames * info.channels;
    uint8_t *raw = (uint8_t *)malloc((size_t)(frames * block));
    if (!raw) { fclose(fh); return -7; }
    if (fseek(fh, (long)info.data_offset, SEEK_SET)
        || fread(raw, 1, (size_t)(frames * block), fh)
           != (size_t)(frames * block)) {
        free(raw); fclose(fh); return -8;
    }
    fclose(fh);
    if (info.format == WAVE_FORMAT_IEEE_FLOAT && info.bits == 32) {
        memcpy(out, raw, (size_t)total * 4);
    } else if (info.format == WAVE_FORMAT_IEEE_FLOAT && info.bits == 64) {
        const double *src = (const double *)raw;
        for (int64_t i = 0; i < total; i++) out[i] = (float)src[i];
    } else if (info.format == WAVE_FORMAT_PCM && info.bits == 16) {
        const int16_t *src = (const int16_t *)raw;
        const float s = 1.0f / 32768.0f;
        for (int64_t i = 0; i < total; i++) out[i] = src[i] * s;
    } else if (info.format == WAVE_FORMAT_PCM && info.bits == 24) {
        const float s = 1.0f / 8388608.0f;
        for (int64_t i = 0; i < total; i++) {
            const uint8_t *p = raw + 3 * i;
            int32_t v = p[0] | (p[1] << 8) | ((int32_t)(int8_t)p[2] << 16);
            out[i] = v * s;
        }
    } else if (info.format == WAVE_FORMAT_PCM && info.bits == 32) {
        const int32_t *src = (const int32_t *)raw;
        const float s = 1.0f / 2147483648.0f;
        for (int64_t i = 0; i < total; i++) out[i] = src[i] * s;
    } else if (info.format == WAVE_FORMAT_PCM && info.bits == 8) {
        const float s = 1.0f / 128.0f;
        for (int64_t i = 0; i < total; i++)
            out[i] = ((int)raw[i] - 128) * s;
    } else {
        free(raw); return -9;
    }
    free(raw);
    return frames;
}

static double sinc(double x) {
    if (fabs(x) < 1e-12) return 1.0;
    return sin(M_PI * x) / (M_PI * x);
}

static double bessel_i0(double x) {
    /* series expansion, converges quickly for the beta range used */
    double sum = 1.0, term = 1.0;
    for (int k = 1; k < 64; k++) {
        term *= (x / (2.0 * k)) * (x / (2.0 * k));
        sum += term;
        if (term < 1e-16 * sum) break;
    }
    return sum;
}

static int64_t gcd64(int64_t a, int64_t b) {
    while (b) { int64_t t = a % b; a = b; b = t; }
    return a;
}

/* Kaiser-windowed-sinc polyphase resampler, interleaved float32.
 * Returns number of output frames written, or <0 on error.
 * out_capacity is in frames; required ~ in_frames * 48000 / in_rate + 64. */
int64_t peaq_resample_48k(const float *in, int64_t in_frames, int channels,
                          int in_rate, float *out, int64_t out_capacity) {
    if (in_rate == 48000) {
        int64_t n = in_frames < out_capacity ? in_frames : out_capacity;
        memcpy(out, in, (size_t)(n * channels) * 4);
        return n;
    }
    const int64_t g = gcd64(48000, in_rate);
    const int64_t up = 48000 / g, down = in_rate / g;
    /* anti-alias cutoff at min(in, out) Nyquist; 32 taps per phase */
    const int taps_per_phase = 32;
    const double cutoff = (up > down ? 1.0 : (double)up / (double)down);
    const double beta = 9.0;
    const int64_t half = (int64_t)taps_per_phase * up / 2;
    const int64_t ntaps = 2 * half + 1;
    double *h = (double *)malloc(sizeof(double) * (size_t)ntaps);
    if (!h) return -1;
    const double i0b = bessel_i0(beta);
    for (int64_t i = 0; i < ntaps; i++) {
        double x = (double)(i - half);
        double w = bessel_i0(beta * sqrt(1.0 - (x / half) * (x / half))) / i0b;
        h[i] = cutoff * sinc(cutoff * x / (double)up) * w;
    }
    int64_t out_frames = (in_frames * up) / down;
    if (out_frames > out_capacity) out_frames = out_capacity;
    const int64_t kp2 = taps_per_phase / 2;   /* half = kp2 * up */
    for (int64_t m = 0; m < out_frames; m++) {
        /* output sample m at input phase position m*down/up */
        int64_t num = m * down;
        int64_t n0 = num / up;          /* integer input index */
        int64_t phase = num % up;       /* fractional position (in 1/up) */
        /* only taps h[k*up + phase] with |k*up + phase| <= half are
         * nonzero: k in [-kp2, kp2 - (phase != 0)] — step those ~32
         * directly instead of scanning all 2*half+1 positions */
        int64_t k_min = -kp2;
        int64_t k_max = phase ? kp2 - 1 : kp2;
        if (k_min < n0 - in_frames + 1) k_min = n0 - in_frames + 1;
        if (k_max > n0) k_max = n0;     /* input boundary clamps */
        const double *hp = h + half + phase;
        for (int c = 0; c < channels; c++) {
            double acc = 0.0;
            const float *xp = in + c;
            for (int64_t k = k_min; k <= k_max; k++)
                acc += hp[k * up] * xp[(n0 - k) * channels];
            out[m * channels + c] = (float)acc;
        }
    }
    free(h);
    return out_frames;
}
