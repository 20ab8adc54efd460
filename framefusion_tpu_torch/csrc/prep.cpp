// Native host-side frame preprocessing: PIL-semantics separable resize with
// an optional fused rescale/normalize epilogue, threaded over output rows.
//
// This is the C++ twin of framefusion_tpu/preprocess.py (the NumPy reference
// implementation); bit-level parity within fp32 accumulation-order noise is
// pinned by tests/test_preprocess.py. The reference project does this work
// in PIL via each model's HF processor (e.g. invoked from
// /root/reference/script/playground/example_qwen2vl.py); a serving host
// needs it off the Python heap and parallel so preprocessing overlaps the
// TPU stream.
//
// Build: g++ -O3 -fPIC -shared -pthread prep.cpp -o libffprep.so
// (done on demand by framefusion_tpu/native/__init__.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <functional>
#include <thread>
#include <vector>

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
  // banded row-stochastic resize matrix: per output index, the input band
  // [jmin, jmin+len) and its normalized weights
  std::vector<int> jmin, len;
  std::vector<float> w;  // out_size rows, padded to max_len
  int max_len = 0;
};

// Half-pixel centers, filter support scaled by the downscale factor
// (antialiasing on downscale), per-row normalization — identical math to
// preprocess.resize_weights (weights in double, stored as float).
Weights make_weights(int in_size, int out_size, int resample) {
  const double support0 = resample == 0 ? 1.0 : 2.0;
  const double scale = double(in_size) / out_size;
  const double fscale = std::max(scale, 1.0);
  const double support = support0 * fscale;
  Weights ws;
  ws.jmin.resize(out_size);
  ws.len.resize(out_size);
  std::vector<std::vector<double>> rows(out_size);
  for (int o = 0; o < out_size; ++o) {
    const double center = (o + 0.5) * scale;
    int lo = std::max(0, int(std::floor(center - support - 0.5)));
    int hi = std::min(in_size, int(std::ceil(center + support + 0.5)));
    // trim exact zeros at the band edges so lengths match the math, not the
    // conservative bound
    std::vector<double> row;
    row.reserve(hi - lo);
    double sum = 0.0;
    for (int j = lo; j < hi; ++j) {
      double v = filt((j + 0.5 - center) / fscale, resample);
      row.push_back(v);
      sum += v;
    }
    if (sum < 1e-12) sum = 1e-12;
    for (auto& v : row) v /= sum;
    ws.jmin[o] = lo;
    ws.len[o] = int(row.size());
    ws.max_len = std::max(ws.max_len, ws.len[o]);
    rows[o] = std::move(row);
  }
  ws.w.assign((size_t)out_size * ws.max_len, 0.f);
  for (int o = 0; o < out_size; ++o)
    for (int j = 0; j < ws.len[o]; ++j)
      ws.w[(size_t)o * ws.max_len + j] = float(rows[o][j]);
  return ws;
}

void parallel_for(int n, const std::function<void(int, int)>& body) {
  unsigned hw = std::thread::hardware_concurrency();
  int nt = std::max(1, std::min<int>(hw ? hw : 1, n));
  if (nt == 1) {
    body(0, n);
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(nt);
  int chunk = (n + nt - 1) / nt;
  for (int i = 0; i < nt; ++i) {
    int lo = i * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    pool.emplace_back([&, lo, hi] { body(lo, hi); });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// in:  (t, h, w, c) float32 contiguous
// out: (t, out_h, out_w, c) float32 contiguous
// resample: 0 = bilinear, 1 = bicubic
// mean/stdv: per-channel (c) pointers or nullptr; epilogue computes
//            (v * rescale - mean[ch]) / stdv[ch] when both are given.
void ff_resize_frames(const float* in, int t, int h, int w, int c,
                      int out_h, int out_w, int resample,
                      const float* mean, const float* stdv, float rescale,
                      float* out) {
  const Weights wy = make_weights(h, out_h, resample);
  const Weights wx = make_weights(w, out_w, resample);
  const size_t row_in = (size_t)w * c;
  std::vector<float> tmp((size_t)t * out_h * row_in);

  // pass 1 (vertical): tmp[ti][oh][x][ch] = sum_j wy[oh][j] * in[ti][jmin+j][x][ch]
  parallel_for(t * out_h, [&](int lo, int hi) {
    for (int k = lo; k < hi; ++k) {
      const int ti = k / out_h, oh = k % out_h;
      float* dst = tmp.data() + (size_t)k * row_in;
      std::fill(dst, dst + row_in, 0.f);
      const float* wrow = wy.w.data() + (size_t)oh * wy.max_len;
      const float* src0 = in + (size_t)ti * h * row_in + (size_t)wy.jmin[oh] * row_in;
      for (int j = 0; j < wy.len[oh]; ++j) {
        const float wj = wrow[j];
        const float* src = src0 + (size_t)j * row_in;
        for (size_t x = 0; x < row_in; ++x) dst[x] += wj * src[x];
      }
    }
  });

  // pass 2 (horizontal) + optional normalize epilogue
  const size_t row_out = (size_t)out_w * c;
  const bool norm = mean != nullptr && stdv != nullptr;
  parallel_for(t * out_h, [&](int lo, int hi) {
    std::vector<float> acc(c);
    for (int k = lo; k < hi; ++k) {
      const float* src = tmp.data() + (size_t)k * row_in;
      float* dst = out + (size_t)k * row_out;
      for (int ow = 0; ow < out_w; ++ow) {
        std::fill(acc.begin(), acc.end(), 0.f);
        const float* wrow = wx.w.data() + (size_t)ow * wx.max_len;
        const float* s0 = src + (size_t)wx.jmin[ow] * c;
        for (int j = 0; j < wx.len[ow]; ++j) {
          const float wj = wrow[j];
          const float* s = s0 + (size_t)j * c;
          for (int ch = 0; ch < c; ++ch) acc[ch] += wj * s[ch];
        }
        float* d = dst + (size_t)ow * c;
        if (norm) {
          for (int ch = 0; ch < c; ++ch)
            d[ch] = (acc[ch] * rescale - mean[ch]) / stdv[ch];
        } else {
          for (int ch = 0; ch < c; ++ch) d[ch] = acc[ch];
        }
      }
    }
  });
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
