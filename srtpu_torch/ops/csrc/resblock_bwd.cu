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
// product against a bf16 operand is exact in f32, as K8a carries h1.
//
// What bounds it on the H100: the function's work is 4 products of 2 * 9
// * 64 * 64 = 73.7 kFLOP per pixel (4.83 GFLOP at the training shape, 16
// x 32 x 32: >= 4.9 us at 989 TFLOP/s) against 3 bf16 inputs and dx
// (8 MB: >= 2.5 us at 3.35 TB/s): operations. The lo halves double the
// tensor-core work (>= 9.8 us), and gsp and dh1p (4 MB each) make a
// round trip through device memory (L2 at these sizes) between launches.
//
// The design: two launches of K2's wgmma engine (conv_sm90.cuh), at K2's
// plan for a transposed 3x3 128 -> 64 (8 x 16 pixel tiles, N = 64, two
// 64-channel slices, TMA-staged tile and weight rings, the halo from the
// staged tile), and two of W's (wgrad.cu), between a split pass and a
// fold:
//  1. rb_split_kernel: gsp = [hi | lo] of g * res_scale, (B, H, W, 128);
//     both the dh1 conv and W read it, so it lives in device memory.
//  2. dh1 at EPI 16 over gsp: the forward's HWIO W2 read K-major as it
//     lies, the taps reversed, once for each half of the pair (no stacked
//     or transposed copy); the epilogue masks the f32 sums with the saved
//     h1 > 0, splits them and stores dh1p = [hi | lo]. Only pixels inside
//     the image are stored, so step 3's TMA zero fill is dh1's SAME
//     padding.
//  3. dx at EPI 17 over dh1p with W1 as W2 in step 2: bf16(sums + f32(g)),
//     one rounding (EPI 5's dx form at cin 128).
//  4. W, 64 -> 128 at k = 3 in wgrad_parts' split (a cluster's f32 sums
//     added in rank order, partial slots in order, no float atomics): dW1
//     and db1 over 128 columns on (x, dh1p), then dW2 and db2 on (h1,
//     gsp). Two launches, not one of two stacked jobs: W's jobs sit one
//     uniform stride apart, and x and h1 are separate tensors (the
//     forward's input and its saved activation), so one launch would need
//     a copy of one of them.
//  5. rb_fold_kernel adds each grad's hi and lo halves: dW1, db1, dW2,
//     db2 (3, 3, 64, 64) and (64) f32.
//
// Measured (tools/k9d_plans.py, device time of a call alone, a CUDA
// graph; NVIDIA H100 80GB HBM3 at 700 W): at the training shape a call
// takes 0.077 ms at res_scale 1.0 and 0.1 (the wmma kernel this replaces,
// with its weight copies: 0.275-0.287), 16x the 4.9 us bound: W's two
// launches with their in-order reductions 0.042, dh1 0.0155, dx 0.013,
// the split and the fold 0.004 together. cuDNN's bf16 calls for the same
// convs (two convolution_backward, gs and dh1 rounded) take 0.080.

#include "conv_sm90.cuh"

// wgrad.cu's entry point (one library)
extern "C" int srt_conv_wgrad(const void* x, const void* g, void* ws_w,
                              void* ws_b, void* dw, void* db, int J,
                              long long x_stride, long long g_stride, int B,
                              int H, int W, int cin, int cout, int r,
                              float gscale, int cluster, int nclusters, int k,
                              int reflect, void* stream);

namespace {

using srt90::bf16;

constexpr int kC = 64;        // the kernel's one width (K8a's)
constexpr int kC2 = 2 * kC;   // a [hi | lo] pixel

#define RB_TRY(...)                           \
  do {                                        \
    cudaError_t e_ = (__VA_ARGS__);           \
    if (e_ != cudaSuccess) return (int)e_;    \
  } while (0)

// gsp (P, 128) = [hi | lo] of v = f32(scale * g), g (P, 64); 8 channels
// a thread: hi = bf16(v), lo = bf16(v - hi) (no contraction into an fma).
__global__ void rb_split_kernel(const bf16* __restrict__ g, float scale,
                                bf16* __restrict__ gsp, long long n8) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < n8; i += (long long)gridDim.x * blockDim.x) {
    const long long p = i / (kC / 8);
    const int c = (int)(i % (kC / 8)) * 8;
    float v[8], h[8];
    srt90::unpack8(*reinterpret_cast<const uint4*>(g + i * 8), v);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __fmul_rn(v[j], scale);  // gs in f32
    const uint4 hi = srt90::pack8(v);
    srt90::unpack8(hi, h);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = __fsub_rn(v[j], h[j]);
    *reinterpret_cast<uint4*>(gsp + p * kC2 + c) = hi;
    *reinterpret_cast<uint4*>(gsp + p * kC2 + kC + c) = srt90::pack8(v);
  }
}

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

// x, h1, g (B, H, W, 64) bf16; w1, w2 (3, 3, 64, 64) bf16: the forward's
// HWIO weights, as they lie. Scratch: gsp, dh1p (B, H, W, 128) bf16; ws_w
// (slots, 9 64 128) and ws_b (slots, 128) f32 (the weight grads' partial
// slots of the split (cluster, nclusters) that wgrad.py:wgrad_parts plans
// at (64, 128), as wgrad_workspace sizes them: nclusters where it is more
// than one, else none); dwx (2, 9 64 128) and dbx (2, 128) f32.
// Writes dx (B, H, W, 64) bf16, dw1, dw2 (3, 3, 64, 64) and db1, db2 (64)
// f32. Returns a cudaError_t.
extern "C" int srt_resblock_f32_bwd(
    const void* x, const void* h1, const void* g, const void* w1,
    const void* w2, float scale, void* gsp, void* dh1p, void* dx,
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
  srt90::ConvArgs a = srt90::args_3x3_64(
      static_cast<const bf16*>(gsp), static_cast<const bf16*>(w2), nullptr,
      static_cast<bf16*>(dh1p), B, H, W);
  a.xps = a.cin = kC2;
  a.k5.h = static_cast<const bf16*>(h1);
  RB_TRY(srt90::run_k9d<16>(a, s));
  a = srt90::args_3x3_64(static_cast<const bf16*>(dh1p),
                         static_cast<const bf16*>(w1), nullptr,
                         static_cast<bf16*>(dx), B, H, W);
  a.xps = a.cin = kC2;
  a.k5.res = static_cast<const bf16*>(g);
  RB_TRY(srt90::run_k9d<17>(a, s));
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
