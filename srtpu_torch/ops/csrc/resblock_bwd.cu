// K9d: the backward of srtpu's fused NHWC EDSR resblock (K8a's forward,
// resblock.cu), at 64 channels, from the saved bf16 x and h1 and the bf16
// cotangent g, every intermediate in f32:
//   gs  = g * res_scale                      f32
//   dh1 = convT(gs, W2) * [h1 > 0]           f32, never rounded
//   dx  = bf16(convT(dh1, W1) + g)           one rounding
//   dW2 = corr(h1, gs), db2 = sum(gs)        f32
//   dW1 = corr(x, dh1), db1 = sum(dh1)       f32
//
// Replaces srtpu/ops/resblock.py:resblock_bwd_fused (body
// _resblock_bwd_kernel), behind resblock_fused_v3.
//
// f32 operands on bf16 tensor cores. x, h1, g and the weights hold bf16
// values (srtpu casts them), but gs does not unless res_scale is a power
// of two (EDSR's paper value is 0.1), and dh1 is an f32 sum. Each is
// carried as a pair hi = bf16(v), lo = bf16(v - hi), stored side by side
// as 128 channels [hi | lo] (v - hi - lo is below 2^-17 |v|), and every
// product against a bf16 operand is exact in f32, as K8a carries h1:
//  1. rb_split_kernel: gsp = [hi | lo] of g * res_scale;
//  2. the chunked conv (tile_conv.cuh) of gsp with W2's transposed
//     kernel stacked twice along its input channels (3, 3, 128, 64): one
//     f32 sum over both halves; the epilogue (Dh1Out) masks it with
//     h1 > 0 and stores dh1p = [hi | lo];
//  3. the chunked conv of dh1p with W1's transposed kernel stacked
//     twice; the epilogue (DxOut) adds g and rounds once into dx;
//  4. the weight-grad engine (wgrad.cu: a cluster's f32 sums added in
//     rank order, partial slots in order, no float atomics) on (h1, gsp)
//     and (x, dh1p): dW and
//     db over 128 output channels, then rb_fold_kernel adds the hi and lo
//     halves: dW2, db2, dW1, db1.
//
// What bounds it on the H100: the function's work is 4 products of 2 * 9
// * 64 * 64 = 73.7 kFLOP per pixel (4.83 GFLOP at the training shape, 16
// x 32 x 32: >= 4.9 us at 989 TFLOP/s) against 3 bf16 inputs and dx
// (8 MB: >= 2.5 us at 3.35 TB/s): operations. The lo halves double the
// tensor-core work, and gsp and dh1p (4 MB each) make a device-memory
// round trip between the launches. No wgmma/TMA yet.

#include "tile_conv.cuh"

// wgrad.cu's entry point (one library)
extern "C" int srt_conv_wgrad(const void* x, const void* g, void* ws_w,
                              void* ws_b, void* dw, void* db, int J,
                              long long x_stride, long long g_stride, int B,
                              int H, int W, int cin, int cout, int r,
                              float gscale, int cluster, int nclusters, int k,
                              int reflect, void* stream);

namespace {

using srt::bf16;

constexpr int kC = 64;        // the kernel's one width (K8a's)
constexpr int kC2 = 2 * kC;   // a [hi | lo] pixel

#define RB_TRY(...)                           \
  do {                                        \
    cudaError_t e_ = (__VA_ARGS__);           \
    if (e_ != cudaSuccess) return (int)e_;    \
  } while (0)

// hi = bf16(v), lo = bf16(v - hi) of 8 f32 values.
__device__ __forceinline__ void split8(const float (&v)[8], uint4& hi,
                                       uint4& lo) {
  hi = srt::pack8(v);
  float h[8], r[8];
  srt::unpack8(hi, h);
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = v[j] - h[j];
  lo = srt::pack8(r);
}

// gsp (P, 128) = [hi | lo] of scale * g, g (P, 64); 8 channels a thread.
__global__ void rb_split_kernel(const bf16* __restrict__ g, float scale,
                                bf16* __restrict__ gsp, long long n8) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n8; i += (long long)gridDim.x * blockDim.x) {
    const long long p = i / (kC / 8);
    const int c = (int)(i % (kC / 8)) * 8;
    float v[8];
    srt::unpack8(*reinterpret_cast<const uint4*>(g + i * 8), v);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] *= scale;
    uint4 hi, lo;
    split8(v, hi, lo);
    *reinterpret_cast<uint4*>(gsp + p * kC2 + c) = hi;
    *reinterpret_cast<uint4*>(gsp + p * kC2 + kC + c) = lo;
  }
}

// Epilogue of step 2: the f32 sums v of output channels co .. co + 7 of
// the pixel at (at - co) / 64 -> dh1 = v where h1 > 0, else 0, as [hi | lo].
struct Dh1Out {
  const bf16* h1;
  bf16* out;
  __device__ __forceinline__ void operator()(float (&v)[8], size_t at,
                                             int co) const {
    float h[8];
    srt::unpack8(*reinterpret_cast<const uint4*>(h1 + at), h);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = h[j] > 0.0f ? v[j] : 0.0f;
    uint4 hi, lo;
    split8(v, hi, lo);
    const size_t p = at / kC;
    *reinterpret_cast<uint4*>(out + p * kC2 + co) = hi;
    *reinterpret_cast<uint4*>(out + p * kC2 + kC + co) = lo;
  }
};

// Epilogue of step 3: dx = bf16(v + g).
struct DxOut {
  const bf16* g;
  bf16* dx;
  __device__ __forceinline__ void operator()(float (&v)[8], size_t at,
                                             int) const {
    float gv[8];
    srt::unpack8(*reinterpret_cast<const uint4*>(g + at), gv);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] += gv[j];
    *reinterpret_cast<uint4*>(dx + at) = srt::pack8(v);
  }
};

// dw (9 * 64, 64) and db (64) = the sums of the hi and lo halves of the
// 128-column dwx (9 * 64, 128) and dbx (128), for jobs 0 (dW1, db1) and
// 1 (dW2, db2).
__global__ void rb_fold_kernel(const float* __restrict__ dwx,
                               const float* __restrict__ dbx,
                               float* __restrict__ dw1,
                               float* __restrict__ db1,
                               float* __restrict__ dw2,
                               float* __restrict__ db2) {
  constexpr int kRows = 9 * kC, kN = kRows * kC + kC;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < 2 * kN;
       i += gridDim.x * blockDim.x) {
    const int job = i / kN, k = i % kN;
    const float* w = dwx + (size_t)job * kRows * kC2;
    const float* b = dbx + (size_t)job * kC2;
    if (k < kRows * kC) {
      const int row = k / kC, c = k % kC;
      (job ? dw2 : dw1)[k] = w[row * kC2 + c] + w[row * kC2 + kC + c];
    } else {
      const int c = k - kRows * kC;
      (job ? db2 : db1)[c] = b[c] + b[kC + c];
    }
  }
}

}  // namespace

// x, h1, g (B, H, W, 64) bf16; w1t2, w2t2 (3, 3, 128, 64) bf16: the
// transposed kernels of W1 and W2 (flipped taps, in and out swapped)
// stacked twice along their input channels. Scratch: gsp, dh1p (B, H, W,
// 128) bf16; ws_w (slots, 9 64 128) and ws_b (slots, 128) f32 (the
// weight grads' partial slots of the split (cluster, nclusters) that
// wgrad.py:wgrad_parts plans at (64, 128), as wgrad_workspace sizes them:
// nclusters where it is more than one, else none); dwx (2, 9 64 128) and
// dbx (2, 128) f32.
// Writes dx (B, H, W, 64)
// bf16, dw1, dw2 (3, 3, 64, 64) and db1, db2 (64) f32. Returns a
// cudaError_t.
extern "C" int srt_resblock_f32_bwd(
    const void* x, const void* h1, const void* g, const void* w1t2,
    const void* w2t2, float scale, void* gsp, void* dh1p, void* dx,
    void* ws_w, void* ws_b, void* dwx, void* dbx, void* dw1, void* db1,
    void* dw2, void* db2, int B, int H, int W, int C, int cluster,
    int nclusters, void* stream) {
  if (C != kC) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long P = (long long)B * H * W;
  const long long n8 = P * (kC / 8);
  const long long want = (n8 + 255) / 256;
  rb_split_kernel<<<(unsigned)(want < 4096 ? want : 4096), 256, 0, s>>>(
      static_cast<const bf16*>(g), scale, static_cast<bf16*>(gsp), n8);
  RB_TRY(cudaGetLastError());
  RB_TRY(srt::conv_chunked<3>(
      static_cast<const bf16*>(gsp), static_cast<const bf16*>(w2t2),
      Dh1Out{static_cast<const bf16*>(h1), static_cast<bf16*>(dh1p)}, 1.0f,
      B, H, W, kC2, kC, s));
  RB_TRY(srt::conv_chunked<3>(
      static_cast<const bf16*>(dh1p), static_cast<const bf16*>(w1t2),
      DxOut{static_cast<const bf16*>(g), static_cast<bf16*>(dx)}, 1.0f, B, H,
      W, kC2, kC, s));
  float* wx = static_cast<float*>(dwx);
  float* bx = static_cast<float*>(dbx);
  // job 0: dW1 = corr(x, dh1); job 1: dW2 = corr(h1, gs)
  int err = srt_conv_wgrad(x, dh1p, ws_w, ws_b, wx, bx, 1, 0, 0, B, H, W,
                           kC, kC2, 1, 1.0f, cluster, nclusters, 3, 0,
                           stream);
  if (err) return err;
  err = srt_conv_wgrad(h1, gsp, ws_w, ws_b, wx + 9 * kC * kC2, bx + kC2, 1,
                       0, 0, B, H, W, kC, kC2, 1, 1.0f, cluster, nclusters,
                       3, 0, stream);
  if (err) return err;
  rb_fold_kernel<<<144, 256, 0, s>>>(
      wx, bx, static_cast<float*>(dw1), static_cast<float*>(db1),
      static_cast<float*>(dw2), static_cast<float*>(db2));
  return (int)cudaGetLastError();
}
