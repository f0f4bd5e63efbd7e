// K3: one sub-pixel upscale stage, a 3x3 conv C -> r*r*C + bias with the
// pixel shuffle folded into the store.
//
// Replaces srtpu/ops/cs_conv.py:upsample_cs_fwd (kernel body
// _ups_fwd_kernel). The TPU kernel interleaves phases with selection
// matmuls because its lanes cannot be strided; here each block computes
// one phase (a, b) for a tile of coarse pixels and writes its 64 channels
// straight to fine pixel (r*y + a, r*x + b) of the (B, rH, rW, C) output,
// so the r*r*C intermediate never exists in device memory.
//
// What bounds it on the H100: per coarse pixel 2 * 9 * 64 * 256 = 295
// kFLOP against 128 bytes read and 512 bytes written (r = 2), ~460
// FLOP/byte: compute-bound, so the tensor cores (wmma bf16, f32
// accumulate) carry it. The input tile is re-read from L2 once per phase
// (r*r blocks per tile); each store is one 128-byte run of channels.

#include "tile_conv.cuh"

// Backward (srtpu's upsample_cs_bwd: _ups_deint_kernel, then
// _ups_conv_bwd_kernel): dx = sum over the r*r phases of the transposed
// conv of each phase's cotangent. That is ONE transposed conv r*r*C -> C
// over the phase-major coarse view of the fine cotangent, so the
// de-interleave becomes the load's address (load_tile_gather) and the
// f32 sum over all phases is rounded once, as on the TPU. dW and db come
// from the weight-grad engine (wgrad.cu), which reads the fine cotangent
// phase-major through a 5-D tensor map.

namespace {
constexpr int kTH = 7, kTW = 16;
}

// x (B, H, W, 64) bf16; w_pm (3, 3, 64, r*r*64) bf16 with phase-major
// output channels ((a*r + b)*64 + c); b_pm (r*r*64) f32, same order;
// out (B, r*H, r*W, 64) bf16. Returns a cudaError_t.
extern "C" int srt_upsample_fwd(const void* x, const void* w_pm,
                                const void* b_pm, void* out, int B, int H,
                                int W, int C, int r, void* stream) {
  if (C != 64 || r < 2) return (int)cudaErrorInvalidValue;
  typedef srt::ConvPlan<64, 64, kTH, kTW> P;
  auto kernel = srt::conv3x3_kernel<64, 64, kTH, kTW, true>;
  cudaError_t err = srt::allow_smem(kernel, P::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B * r * r);
  kernel<<<grid, srt::kThreads, P::SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const srt::bf16*>(x), static_cast<const srt::bf16*>(w_pm),
      static_cast<const float*>(b_pm), static_cast<srt::bf16*>(out), H, W,
      r * r * C, 0, r);
  return (int)cudaGetLastError();
}

// g (B, r*H, r*W, C) bf16 fine cotangent; wt (3, 3, r*r*C, C) bf16, the
// transposed phase-major weight wt[ky, kx, (a*r + b)*C + c, ci] =
// w_pm[2 - ky, 2 - kx, ci, (a*r + b)*C + c]; dx (B, H, W, C) bf16.
// Supported: C = 64, r = 2. Returns a cudaError_t.
extern "C" int srt_upsample_bwd_dx(const void* g, const void* wt, void* dx,
                                   int B, int H, int W, int C, int r,
                                   void* stream) {
  if (C != 64 || r != 2) return (int)cudaErrorInvalidValue;
  constexpr int kCin = 4 * 64, kNB = 16;
  typedef srt::ConvPlan<kCin, kNB, kTH, kTW> P;
  auto kernel = srt::conv3x3_kernel<kCin, kNB, kTH, kTW, false, true>;
  cudaError_t err = srt::allow_smem(kernel, P::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B * (C / kNB));
  kernel<<<grid, srt::kThreads, P::SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const srt::bf16*>(g), static_cast<const srt::bf16*>(wt),
      nullptr, static_cast<srt::bf16*>(dx), H, W, C, 0, r);
  return (int)cudaGetLastError();
}
