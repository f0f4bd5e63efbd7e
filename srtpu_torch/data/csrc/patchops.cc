// patchops — the training loader's native core for srtpu_torch.
//
// Host C++ (g++, not nvcc), driven from srtpu_torch/data/native.py through
// ctypes. It fuses each sample's aligned random crop + 8-way augment +
// batch-slot placement into one pass over the pixels, a whole batch in one
// call (threaded inside C++), and holds a bicubic downscale matched to
// Pillow's for synthesizing a missing LR. It computes the same functions as
// srtpu's native/patchops.cc, so a seed gives srtpu's batches bit for bit.
//
// Build: g++ -O3 -march=native -shared -fPIC -pthread patchops.cc -o ...
// (srtpu_torch/data/native.py builds it at first use into
// build/srtpu_torch/, the library's name keyed on a hash of this source,
// the flags and the host's CPU).

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Fused aligned patch extraction + augmentation + batch placement.
//
// lr:  (lr_h, lr_w, c) float32, hr: (lr_h*scale, lr_w*scale, c) float32.
// Writes the augmented LR patch into out_lr[batch_idx] with shape
// (lp, lp, c) and the aligned HR patch into out_hr[batch_idx] with shape
// (lp*scale, lp*scale, c).
//
// Augment encoding matches the numpy core (pipeline.py _make_batch):
// rot k in {0..3} (counter-clockwise 90s), then optional horizontal flip
// (w axis), then optional vertical flip (h axis).
// ---------------------------------------------------------------------------

// destination (y, x) <- source coordinate after the inverse transform:
// inverse of rot90(k) counter-clockwise applied k times
// (np.rot90 CCW: out[i][j] = in[j][p-1-i]), after undoing the flips.
static inline void map_coord(int y, int x, int p, int rot, int hflip,
                             int vflip, int* yy_out, int* xx_out) {
  int yy = y, xx = x;
  if (vflip) yy = p - 1 - yy;
  if (hflip) xx = p - 1 - xx;
  for (int r = 0; r < rot; ++r) {
    int t = yy;
    yy = xx;
    xx = p - 1 - t;
  }
  *yy_out = yy;
  *xx_out = xx;
}

static inline void copy_patch_augmented(
    const float* src, int src_w, int c,
    int y0, int x0, int p,          // crop origin and size (square)
    int rot, int hflip, int vflip,
    float* dst) {                   // (p, p, c)
  // All 16 transforms are affine in (y, x), so the source pointer walks
  // with constant strides — derive them from three mapped corners instead
  // of recomputing the inverse rotation per pixel (6x the loop cost).
  int yy0, xx0, yy1, xx1, yy2, xx2;
  map_coord(0, 0, p, rot, hflip, vflip, &yy0, &xx0);
  map_coord(1, 0, p, rot, hflip, vflip, &yy1, &xx1);
  map_coord(0, 1, p, rot, hflip, vflip, &yy2, &xx2);
  const ptrdiff_t sy = ((yy1 - yy0) * (ptrdiff_t)src_w + (xx1 - xx0)) * c;
  const ptrdiff_t sx = ((yy2 - yy0) * (ptrdiff_t)src_w + (xx2 - xx0)) * c;
  const float* s0 =
      src + ((y0 + yy0) * (size_t)src_w + (x0 + xx0)) * (size_t)c;
  const size_t row = (size_t)p * c;
  for (int y = 0; y < p; ++y) {
    const float* s = s0 + (ptrdiff_t)y * sy;
    float* d = dst + y * row;
    if (sx == c) {                  // source row contiguous: straight copy
      memcpy(d, s, row * sizeof(float));
    } else if (c == 3) {
      for (int x = 0; x < p; ++x, s += sx, d += 3) {
        d[0] = s[0];
        d[1] = s[1];
        d[2] = s[2];
      }
    } else {
      for (int x = 0; x < p; ++x, s += sx, d += c)
        for (int ch = 0; ch < c; ++ch) d[ch] = s[ch];
    }
  }
}

void extract_patch_pair(
    const float* lr, int lr_h, int lr_w,
    const float* hr, int hr_h, int hr_w,  // true HR dims (HR images are
                                          // not always exactly LR*scale,
                                          // e.g. scale-3 odd-sized HRs)
    int c, int scale, int lr_patch,
    int lr_y, int lr_x,             // crop origin in LR coords
    int rot, int hflip, int vflip,
    float* out_lr, float* out_hr) {
  (void)lr_h; (void)hr_h;
  copy_patch_augmented(lr, lr_w, c, lr_y, lr_x, lr_patch,
                       rot, hflip, vflip, out_lr);
  copy_patch_augmented(hr, hr_w, c, lr_y * scale, lr_x * scale,
                       lr_patch * scale, rot, hflip, vflip, out_hr);
}

// ---------------------------------------------------------------------------
// Whole-batch variant: ONE ctypes crossing per batch instead of one per
// item (each crossing costs tens of microseconds of argument marshalling).
// Items are striped across nthreads std::threads (<= 1 runs serial).
// ---------------------------------------------------------------------------

void extract_patch_batch(
    const float* const* lrs, const int* lr_ws,
    const float* const* hrs, const int* hr_ws,
    int n, int c, int scale, int lr_patch,
    const int* lr_ys, const int* lr_xs,
    const int* rots, const int* hflips, const int* vflips,
    float* out_lr, float* out_hr, int nthreads) {
  const size_t lr_item = (size_t)lr_patch * lr_patch * c;
  const int hp = lr_patch * scale;
  const size_t hr_item = (size_t)hp * hp * c;
  auto run = [&](int lo, int hi) {
    for (int i = lo; i < hi; ++i) {
      copy_patch_augmented(lrs[i], lr_ws[i], c, lr_ys[i], lr_xs[i],
                           lr_patch, rots[i], hflips[i], vflips[i],
                           out_lr + (size_t)i * lr_item);
      copy_patch_augmented(hrs[i], hr_ws[i], c, lr_ys[i] * scale,
                           lr_xs[i] * scale, hp, rots[i], hflips[i],
                           vflips[i], out_hr + (size_t)i * hr_item);
    }
  };
  if (nthreads <= 1 || n <= 1) {
    run(0, n);
    return;
  }
  const int t = nthreads < n ? nthreads : n;
  std::vector<std::thread> workers;
  workers.reserve(t);
  for (int j = 0; j < t; ++j) {
    const int lo = (int)((long)n * j / t);
    const int hi = (int)((long)n * (j + 1) / t);
    if (lo < hi) workers.emplace_back(run, lo, hi);
  }
  for (auto& w : workers) w.join();
}

// ---------------------------------------------------------------------------
// PIL-matched bicubic downscale (a = -0.5, antialias, border renormalize).
// src: (h, w, c) uint8; dst: (oh, ow, c) uint8. Two-pass separable.
// ---------------------------------------------------------------------------

static inline double cubic(double t, double a) {
  t = std::fabs(t);
  double t2 = t * t, t3 = t2 * t;
  if (t <= 1.0) return (a + 2.0) * t3 - (a + 3.0) * t2 + 1.0;
  if (t < 2.0) return a * t3 - 5.0 * a * t2 + 8.0 * a * t - 4.0 * a;
  return 0.0;
}

struct Taps {
  std::vector<int> left;      // first source index per output pixel
  std::vector<double> w;      // n_taps weights per output pixel
  int n_taps;
};

static Taps make_taps(int in_size, int out_size, double a) {
  double scale = (double)out_size / in_size;
  double support_scale = scale < 1.0 ? 1.0 / scale : 1.0;
  double support = 2.0 * support_scale;
  int n_taps = (int)std::ceil(support) * 2 + 2;

  Taps taps;
  taps.n_taps = n_taps;
  taps.left.resize(out_size);
  taps.w.resize((size_t)out_size * n_taps);
  for (int i = 0; i < out_size; ++i) {
    double center = (i + 0.5) / scale - 0.5;
    int left = (int)std::floor(center - support) + 1;
    taps.left[i] = left;
    double sum = 0.0;
    for (int t = 0; t < n_taps; ++t) {
      int idx = left + t;
      double wv = 0.0;
      if (idx >= 0 && idx < in_size)  // PIL drops out-of-range taps
        wv = cubic((center - idx) / support_scale, a);
      taps.w[(size_t)i * n_taps + t] = wv;
      sum += wv;
    }
    if (sum > 1e-12)
      for (int t = 0; t < n_taps; ++t)
        taps.w[(size_t)i * n_taps + t] /= sum;
  }
  return taps;
}

void bicubic_downscale_u8(
    const uint8_t* src, int h, int w, int c,
    int oh, int ow, uint8_t* dst) {
  const double a = -0.5;  // PIL bicubic
  Taps tx = make_taps(w, ow, a);
  Taps ty = make_taps(h, oh, a);

  // horizontal pass -> (h, ow, c) float
  std::vector<float> tmp((size_t)h * ow * c);
  for (int y = 0; y < h; ++y) {
    const uint8_t* row = src + (size_t)y * w * c;
    for (int x = 0; x < ow; ++x) {
      const double* wv = &tx.w[(size_t)x * tx.n_taps];
      int left = tx.left[x];
      for (int ch = 0; ch < c; ++ch) {
        double acc = 0.0;
        for (int t = 0; t < tx.n_taps; ++t) {
          int idx = left + t;
          if (idx < 0) idx = 0;
          if (idx >= w) idx = w - 1;  // weight already zeroed; idx safe
          acc += wv[t] * row[(size_t)idx * c + ch];
        }
        tmp[((size_t)y * ow + x) * c + ch] = (float)acc;
      }
    }
  }
  // vertical pass -> (oh, ow, c) u8
  for (int y = 0; y < oh; ++y) {
    const double* wv = &ty.w[(size_t)y * ty.n_taps];
    int left = ty.left[y];
    for (int x = 0; x < ow; ++x) {
      for (int ch = 0; ch < c; ++ch) {
        double acc = 0.0;
        for (int t = 0; t < ty.n_taps; ++t) {
          int idx = left + t;
          if (idx < 0) idx = 0;
          if (idx >= h) idx = h - 1;
          acc += wv[t] * tmp[((size_t)idx * ow + x) * c + ch];
        }
        double v = acc < 0.0 ? 0.0 : (acc > 255.0 ? 255.0 : acc);
        dst[((size_t)y * ow + x) * c + ch] = (uint8_t)(v + 0.5);
      }
    }
  }
}

// float32 [0,1] variant used when sources have already been normalized
void bicubic_downscale_f32(
    const float* src, int h, int w, int c,
    int oh, int ow, float* dst) {
  const double a = -0.5;
  Taps tx = make_taps(w, ow, a);
  Taps ty = make_taps(h, oh, a);
  std::vector<float> tmp((size_t)h * ow * c);
  for (int y = 0; y < h; ++y) {
    const float* row = src + (size_t)y * w * c;
    for (int x = 0; x < ow; ++x) {
      const double* wv = &tx.w[(size_t)x * tx.n_taps];
      int left = tx.left[x];
      for (int ch = 0; ch < c; ++ch) {
        double acc = 0.0;
        for (int t = 0; t < tx.n_taps; ++t) {
          int idx = left + t;
          if (idx < 0) idx = 0;
          if (idx >= w) idx = w - 1;
          acc += wv[t] * row[(size_t)idx * c + ch];
        }
        tmp[((size_t)y * ow + x) * c + ch] = (float)acc;
      }
    }
  }
  for (int y = 0; y < oh; ++y) {
    const double* wv = &ty.w[(size_t)y * ty.n_taps];
    int left = ty.left[y];
    for (int x = 0; x < ow; ++x) {
      for (int ch = 0; ch < c; ++ch) {
        double acc = 0.0;
        for (int t = 0; t < ty.n_taps; ++t) {
          int idx = left + t;
          if (idx < 0) idx = 0;
          if (idx >= h) idx = h - 1;
          acc += wv[t] * tmp[((size_t)idx * ow + x) * c + ch];
        }
        dst[((size_t)y * ow + x) * c + ch] = (float)acc;
      }
    }
  }
}

}  // extern "C"
