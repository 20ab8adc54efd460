// Native host-side frame preprocessing: the caller's uint8 (or float) frames
// to normalized float32 pixels in one pass. PIL-semantics separable resize
// with an optional fused rescale/normalize epilogue.
//
// Same math as preprocess.py's NumPy twin (resize_weights, then
// normalize_frames), and each output element takes the same float operations
// in the same order as the JAX package's native/prep.cpp, so the two agree bit
// for bit (tests/test_torch_vision.py holds them equal). That needs products
// and sums left apart: native.py builds with -ffp-contract=off, so no target
// fuses them into FMAs.
//
// One pass: a task is one frame and one band of output rows. For each output
// row the vertical taps accumulate into a per-thread row buffer (w*c floats,
// in L1), then the horizontal taps and the epilogue write that output row
// once. No video-sized intermediate; uint8 is widened in registers. The
// threads are started once a call and take tasks from an atomic counter, so
// a one-frame call still spreads over the cores.
//
// Build: g++ -O3 -ffp-contract=off -fPIC -shared -pthread -std=c++17 prep.cpp
// (done on demand by framefusion_tpu_torch/native.py).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <tuple>
#include <vector>

#if defined(__SSE2__)
#include <emmintrin.h>
#endif

namespace {

// Filter kernels, PIL convention: bilinear (triangle, support 1) and Keys
// bicubic with a = -0.5 (support 2).
double filt(double x, int resample) {
  x = std::fabs(x);
  if (resample == 0) {
    return x < 1.0 ? 1.0 - x : 0.0;
  }
  const double a = -0.5;
  if (x <= 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0;
  if (x < 2.0) return (((x - 5.0) * x + 8.0) * x - 4.0) * a;
  return 0.0;
}

struct Weights {
  // banded row-stochastic resize matrix: output index o reads the input
  // band [jmin[o], jmin[o] + taps), taps the same for every o (the widest
  // band; a narrower one is padded with zero weights and moved inside the
  // input at the edges)
  std::vector<int> jmin;
  std::vector<float> w;  // out_size rows of taps
  int taps = 0;
};

// Half-pixel centers, filter support scaled by the downscale factor
// (antialiasing on downscale), per-row normalization — identical math to
// preprocess.resize_weights (weights in double, stored as float). A zero
// weight, dropped or padded, adds +0 or -0 to a sum that starts at +0 and so
// never is -0: for finite inputs the sums are bit for bit those over the
// conservative bands of the JAX package's kernel.
Weights make_weights(int in_size, int out_size, int resample) {
  const double support0 = resample == 0 ? 1.0 : 2.0;
  const double scale = double(in_size) / out_size;
  const double fscale = std::max(scale, 1.0);
  const double support = support0 * fscale;
  std::vector<int> lo(out_size);
  std::vector<std::vector<double>> rows(out_size);
  Weights ws;
  for (int o = 0; o < out_size; ++o) {
    const double center = (o + 0.5) * scale;
    lo[o] = std::max(0, int(std::floor(center - support - 0.5)));
    int hi = std::min(in_size, int(std::ceil(center + support + 0.5)));
    std::vector<double>& row = rows[o];
    row.reserve(hi - lo[o]);
    double sum = 0.0;
    for (int j = lo[o]; j < hi; ++j) {
      double v = filt((j + 0.5 - center) / fscale, resample);
      row.push_back(v);
      sum += v;
    }
    if (sum < 1e-12) sum = 1e-12;
    for (auto& v : row) v /= sum;
    // the bound above is conservative: drop the exact zeros at its ends
    while (row.size() > 1 && row.back() == 0.0) row.pop_back();
    while (row.size() > 1 && row.front() == 0.0) {
      row.erase(row.begin());
      ++lo[o];
    }
    ws.taps = std::max(ws.taps, int(row.size()));
  }
  ws.jmin.resize(out_size);
  ws.w.assign((size_t)out_size * ws.taps, 0.f);
  for (int o = 0; o < out_size; ++o) {
    ws.jmin[o] = std::min(lo[o], in_size - ws.taps);
    float* wrow = ws.w.data() + (size_t)o * ws.taps + (lo[o] - ws.jmin[o]);
    for (size_t j = 0; j < rows[o].size(); ++j) wrow[j] = float(rows[o][j]);
  }
  return ws;
}

// The process's weight tables by (in, out, resample): a server's requests
// share a few geometries. Bounded, since Qwen2-VL's geometry follows each
// input's size.
constexpr size_t kMaxTables = 64;

std::shared_ptr<const Weights> weights(int in_size, int out_size, int resample) {
  static std::mutex mu;
  static std::map<std::tuple<int, int, int>, std::shared_ptr<const Weights>> tables;
  const auto key = std::make_tuple(in_size, out_size, resample);
  std::lock_guard<std::mutex> lock(mu);
  auto it = tables.find(key);
  if (it != tables.end()) return it->second;
  if (tables.size() >= kMaxTables) tables.clear();
  auto ws = std::make_shared<const Weights>(make_weights(in_size, out_size, resample));
  tables.emplace(key, ws);
  return ws;
}

// Runs worker() on min(hardware threads, n_tasks) threads, the caller's
// among them; the workers share the tasks through their own counter.
template <class Worker>
void on_threads(int n_tasks, const Worker& worker) {
  unsigned hw = std::thread::hardware_concurrency();
  int nt = std::max(1, std::min<int>(hw ? hw : 1, n_tasks));
  std::vector<std::thread> pool;
  pool.reserve(nt - 1);
  for (int i = 1; i < nt; ++i) pool.emplace_back([&] { worker(); });
  worker();
  for (auto& th : pool) th.join();
}

// Four floats: the unit of both passes. Vector loads of four channels let
// the horizontal taps read an interleaved row of any channel count.
typedef float v4f __attribute__((vector_size(16)));
constexpr int kLanes = 4;
constexpr int kBandRows = 16;  // output rows a task

inline v4f load4(const float* p) {
  v4f v;
  std::memcpy(&v, p, sizeof v);
  return v;
}

// Sixteen input values as four vectors: plain loads for float, widened in
// registers for uint8 (SSE2 unpacks on x86-64, which compilers do not emit
// for a generic vector conversion; lane by lane elsewhere).
inline void load16(const float* p, v4f v[4]) { std::memcpy(v, p, 4 * sizeof(v4f)); }

inline void load16(const uint8_t* p, v4f v[4]) {
#if defined(__SSE2__)
  const __m128i z = _mm_setzero_si128();
  const __m128i b = _mm_loadu_si128(reinterpret_cast<const __m128i*>(p));
  const __m128i lo = _mm_unpacklo_epi8(b, z), hi = _mm_unpackhi_epi8(b, z);
  v[0] = (v4f)_mm_cvtepi32_ps(_mm_unpacklo_epi16(lo, z));
  v[1] = (v4f)_mm_cvtepi32_ps(_mm_unpackhi_epi16(lo, z));
  v[2] = (v4f)_mm_cvtepi32_ps(_mm_unpacklo_epi16(hi, z));
  v[3] = (v4f)_mm_cvtepi32_ps(_mm_unpackhi_epi16(hi, z));
#else
  for (int q = 0; q < 4; ++q)
    v[q] = v4f{float(p[4 * q]), float(p[4 * q + 1]), float(p[4 * q + 2]), float(p[4 * q + 3])};
#endif
}

inline void store4(float* p, v4f v) { std::memcpy(p, &v, sizeof v); }

// Each output element below is 0 + w[0]*x[0] + w[1]*x[1] + ... in tap
// order, as in the JAX kernel's passes; the blocks of independent
// accumulators only hide the adds' latency.

// Vertical taps of output row oh: acc[x] = sum_j wy[j] * src[j][x].
template <class In>
void vertical(const In* frame, size_t row_in, const Weights& wy, int oh, float* acc) {
  const float* wrow = wy.w.data() + (size_t)oh * wy.taps;
  const In* src0 = frame + (size_t)wy.jmin[oh] * row_in;
  size_t x = 0;
  for (; x + 4 * kLanes <= row_in; x += 4 * kLanes) {
    v4f a[4] = {}, v[4];
    for (int j = 0; j < wy.taps; ++j) {
      load16(src0 + (size_t)j * row_in + x, v);
      for (int q = 0; q < 4; ++q) a[q] += wrow[j] * v[q];
    }
    for (int q = 0; q < 4; ++q) store4(acc + x + q * kLanes, a[q]);
  }
  for (; x < row_in; ++x) {
    float a = 0.f;
    for (int j = 0; j < wy.taps; ++j) a += wrow[j] * float(src0[(size_t)j * row_in + x]);
    acc[x] = a;
  }
}

// Horizontal taps and epilogue of output pixels [ow, ow + N), channels
// [ch0, ch0 + 4), into the output row orow. Each store writes four floats:
// past a partial chunk it runs into the next pixel's first channels, which
// resize() writes later (partial chunk first, pixels in order), or into the
// row's pad.
template <int N>
__attribute__((always_inline)) inline void pixels(const float* acc, int c, int ch0, const Weights& wx, int ow,
                                                  bool norm, float rescale, v4f m, v4f s, float* orow) {
  const float* xw = wx.w.data() + (size_t)ow * wx.taps;
  const float* src[N];
  v4f a[N];
  for (int q = 0; q < N; ++q) {
    src[q] = acc + (size_t)wx.jmin[ow + q] * c + ch0;
    a[q] = v4f{};
  }
  for (int j = 0; j < wx.taps; ++j)
    for (int q = 0; q < N; ++q) a[q] += xw[(size_t)q * wx.taps + j] * load4(src[q] + (size_t)j * c);
  for (int q = 0; q < N; ++q) {
    if (norm) a[q] = (a[q] * rescale - m) / s;
    store4(orow + (size_t)(ow + q) * c + ch0, a[q]);
  }
}

template <class In>
void resize(const In* in, int t, int h, int w, int c, int out_h, int out_w,
            int resample, const float* mean, const float* stdv, float rescale,
            float* out) {
  const auto wy = weights(h, out_h, resample);
  const auto wx = weights(w, out_w, resample);
  const size_t row_in = (size_t)w * c, row_out = (size_t)out_w * c;
  const bool norm = mean != nullptr && stdv != nullptr;
  // the epilogue's mean and std by chunk of four channels
  std::vector<v4f> mv((c + kLanes - 1) / kLanes, v4f{}), sv(mv.size(), v4f{} + 1.f);
  for (int ch = 0; ch < c && norm; ++ch) {
    mv[ch / kLanes][ch % kLanes] = mean[ch];
    sv[ch / kLanes][ch % kLanes] = stdv[ch];
  }
  const int bands = (out_h + kBandRows - 1) / kBandRows;
  const int n_tasks = t * bands;
  std::atomic<int> next{0};

  on_threads(n_tasks, [&] {
    // one output row's vertical result and the output row itself, each
    // padded for the last pixel's four-lane loads and stores
    std::vector<float> acc(row_in + kLanes, 0.f), orow(row_out + kLanes);
    for (int k; (k = next.fetch_add(1, std::memory_order_relaxed)) < n_tasks;) {
      const int ti = k / bands;
      const int oh0 = (k % bands) * kBandRows, oh1 = std::min(out_h, oh0 + kBandRows);
      for (int oh = oh0; oh < oh1; ++oh) {
        vertical(in + (size_t)ti * h * row_in, row_in, *wy, oh, acc.data());
        for (int ch0 = (c - 1) / kLanes * kLanes; ch0 >= 0; ch0 -= kLanes) {
          const v4f m = mv[ch0 / kLanes], s = sv[ch0 / kLanes];
          int ow = 0;
          for (; ow + 4 <= out_w; ow += 4)
            pixels<4>(acc.data(), c, ch0, *wx, ow, norm, rescale, m, s, orow.data());
          for (; ow < out_w; ++ow) pixels<1>(acc.data(), c, ch0, *wx, ow, norm, rescale, m, s, orow.data());
        }
        std::memcpy(out + ((size_t)ti * out_h + oh) * row_out, orow.data(), row_out * sizeof(float));
      }
    }
  });
}

}  // namespace

extern "C" {

// in:  (t, h, w, c) contiguous, float32 (ff_resize_frames) or uint8
//      (ff_resize_frames_u8)
// out: (t, out_h, out_w, c) float32 contiguous
// resample: 0 = bilinear, 1 = bicubic
// mean/stdv: per-channel (c) pointers or nullptr; epilogue computes
//            (v * rescale - mean[ch]) / stdv[ch] when both are given.
void ff_resize_frames(const float* in, int t, int h, int w, int c,
                      int out_h, int out_w, int resample,
                      const float* mean, const float* stdv, float rescale,
                      float* out) {
  resize(in, t, h, w, c, out_h, out_w, resample, mean, stdv, rescale, out);
}

void ff_resize_frames_u8(const uint8_t* in, int t, int h, int w, int c,
                         int out_h, int out_w, int resample,
                         const float* mean, const float* stdv, float rescale,
                         float* out) {
  resize(in, t, h, w, c, out_h, out_w, resample, mean, stdv, rescale, out);
}

// Standalone in-place normalize for pre-sized frames:
// x = (x*rescale - mean)/std over n_pixels rows of c channels.
void ff_normalize(float* data, int64_t n_pixels, int c,
                  const float* mean, const float* stdv, float rescale) {
  unsigned hw = std::thread::hardware_concurrency();
  int nt = std::max(1u, hw ? hw : 1u);
  std::vector<std::thread> pool;
  int64_t chunk = (n_pixels + nt - 1) / nt;
  for (int i = 0; i < nt; ++i) {
    int64_t lo = i * chunk, hi = std::min<int64_t>(n_pixels, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back([=] {
      for (int64_t p = lo; p < hi; ++p)
        for (int ch = 0; ch < c; ++ch) {
          float* v = data + p * c + ch;
          *v = (*v * rescale - mean[ch]) / stdv[ch];
        }
    });
  }
  for (auto& th : pool) th.join();
}

}  // extern "C"
