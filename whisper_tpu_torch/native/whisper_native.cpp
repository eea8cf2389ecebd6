// Native host-side runtime for whisper_tpu.
//
// The reference keeps its entire host pipeline in C++ (threaded mel FFT
// front-end Whisper/Whisper/melSpectrogram.cpp, streaming loader
// WhisperModel.cpp); this library provides the same roles for the TPU
// framework where host CPU work sits on the latency path:
//
//   - log-mel spectrogram (Hann window + real-DFT power + mel filters +
//     log10), multithreaded across frames like the reference's parallelFor
//     (Spectrogram.cpp:76-88), used by the streaming/capture paths so they
//     never wait on a device round-trip
//   - bulk fp16 -> fp32 conversion for checkpoint loading
//   - signal-energy sliding window (token timestamps, Spectrogram.cpp:124-140)
//
// Build: python tools/build_native.py   (g++ -O3 -shared; ctypes loads it;
// every entry point has a NumPy fallback in whisper_tpu_torch/native/__init__.py)

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

constexpr int kNFft = 400;
constexpr int kHop = 160;
constexpr int kNBins = kNFft / 2 + 1;

struct DftTables {
    // [n][k] split-radix-free plain real DFT bases; 400x201 floats each.
    std::vector<float> cosb, sinb, hann;
    DftTables() {
        cosb.resize(kNFft * kNBins);
        sinb.resize(kNFft * kNBins);
        hann.resize(kNFft);
        for (int n = 0; n < kNFft; n++) {
            hann[n] = 0.5f * (1.0f - std::cos(2.0 * M_PI * n / kNFft));
            for (int k = 0; k < kNBins; k++) {
                double th = 2.0 * M_PI * n * k / kNFft;
                cosb[n * kNBins + k] = (float)std::cos(th);
                sinb[n * kNBins + k] = (float)-std::sin(th);
            }
        }
    }
};

const DftTables& tables() {
    static DftTables t;
    return t;
}

// One frame: windowed real DFT power spectrum + mel projection + log10.
// mode 0 = "openai" framing handled by caller (frame pointer pre-offset);
// fold=1 applies the reference's conjugate-symmetric fold (bins 1..199 x2).
void frame_mel(const float* frame, int avail, const float* filters, int n_mel,
               float* out, int fold) {
    const DftTables& t = tables();
    float win[kNFft];
    for (int i = 0; i < kNFft; i++)
        win[i] = (i < avail ? frame[i] : 0.0f) * t.hann[i];

    float re[kNBins] = {0}, im[kNBins] = {0};
    for (int n = 0; n < kNFft; n++) {
        const float x = win[n];
        if (x == 0.0f) continue;
        const float* cb = &t.cosb[n * kNBins];
        const float* sb = &t.sinb[n * kNBins];
        for (int k = 0; k < kNBins; k++) {
            re[k] += x * cb[k];
            im[k] += x * sb[k];
        }
    }
    float power[kNBins];
    for (int k = 0; k < kNBins; k++) power[k] = re[k] * re[k] + im[k] * im[k];
    if (fold)
        for (int k = 1; k < kNBins - 1; k++) power[k] *= 2.0f;

    for (int m = 0; m < n_mel; m++) {
        double sum = 0.0;
        const float* f = filters + (size_t)m * kNBins;
        for (int k = 0; k < kNBins; k++) sum += (double)power[k] * f[k];
        if (sum < 1e-10) sum = 1e-10;
        out[m] = (float)std::log10(sum);
    }
}

}  // namespace

extern "C" {

// Raw (unnormalized) log10-mel. mode: 0 = openai (reflect-centered),
// 1 = reference (causal, fold). out is [n_mel, n_frames] row-major.
void wtn_log_mel(const float* pcm, int64_t n_samples, const float* filters,
                 int n_mel, float* out, int64_t n_frames, int mode,
                 int n_threads) {
    if (n_frames <= 0) return;
    if (n_threads < 1) n_threads = 1;

    std::atomic<int64_t> next(0);
    auto worker = [&]() {
        std::vector<float> col(n_mel);
        std::vector<float> frame(kNFft);
        for (;;) {
            int64_t i = next.fetch_add(1);
            if (i >= n_frames) return;
            int avail;
            const float* src;
            if (mode == 0) {
                // centered: frame spans [i*hop - 200, i*hop + 200), reflect
                // padded at the clip edges
                int64_t start = i * kHop - kNFft / 2;
                for (int j = 0; j < kNFft; j++) {
                    int64_t s = start + j;
                    if (s < 0) s = -s;                       // reflect left
                    if (s >= n_samples) s = 2 * (n_samples - 1) - s;
                    frame[j] = (s >= 0 && s < n_samples) ? pcm[s] : 0.0f;
                }
                src = frame.data();
                avail = kNFft;
            } else {
                src = pcm + i * kHop;
                int64_t left = n_samples - i * kHop;
                avail = left >= kNFft ? kNFft : (int)(left > 0 ? left : 0);
            }
            frame_mel(src, avail, filters, n_mel, col.data(), mode == 1);
            for (int m = 0; m < n_mel; m++) out[(size_t)m * n_frames + i] = col[m];
        }
    };

    if (n_threads == 1) {
        worker();
    } else {
        std::vector<std::thread> pool;
        for (int t = 0; t < n_threads; t++) pool.emplace_back(worker);
        for (auto& th : pool) th.join();
    }
}

void wtn_fp16_to_f32(const uint16_t* src, float* dst, int64_t n) {
    for (int64_t i = 0; i < n; i++) {
        uint16_t h = src[i];
        uint32_t sign = (uint32_t)(h & 0x8000u) << 16;
        uint32_t exp = (h >> 10) & 0x1F;
        uint32_t man = h & 0x3FF;
        uint32_t bits;
        if (exp == 0) {
            if (man == 0) {
                bits = sign;
            } else {  // subnormal
                int e = -1;
                do {
                    e++;
                    man <<= 1;
                } while (!(man & 0x400));
                bits = sign | ((uint32_t)(127 - 15 - e) << 23) | ((man & 0x3FF) << 13);
            }
        } else if (exp == 31) {
            bits = sign | 0x7F800000u | (man << 13);
        } else {
            bits = sign | ((exp + 112) << 23) | (man << 13);
        }
        std::memcpy(&dst[i], &bits, 4);
    }
}

// Sliding mean |pcm| (compute_signal_energy, Spectrogram.cpp:124-140).
void wtn_signal_energy(const float* pcm, int64_t n, int hw, float* out) {
    // prefix sums of |x| for O(n)
    std::vector<double> pre((size_t)n + 1, 0.0);
    for (int64_t i = 0; i < n; i++) pre[i + 1] = pre[i] + std::fabs(pcm[i]);
    const double inv = 1.0 / (2 * hw + 1);
    for (int64_t i = 0; i < n; i++) {
        int64_t a = i - hw < 0 ? 0 : i - hw;
        int64_t b = i + hw + 1 > n ? n : i + hw + 1;
        out[i] = (float)((pre[b] - pre[a]) * inv);
    }
}

int wtn_version() { return 1; }

}  // extern "C"
