// K8b: srtpu's fused channel-attention gate (RCAN's CALayer on its
// use_pallas=True route), NHWC bf16 in and out, f32 inside:
//   pool = mean over H W of f32(x)                     per image, (C)
//   gate = sigmoid(relu(pool W1 + b1) W2 + b2)          W1 (C, C/r), W2
//                                                       (C/r, C), all f32
//   out  = bf16(f32(x) * gate)                          one rounding
//
// Replaces srtpu/ops/ca_layer.py:ca_layer_fused (body _ca_kernel), behind
// ca_layer_fused_trainable / CALayer(use_pallas=True).
//
// What bounds it on the H100: bytes. The function reads x once and writes
// out once (4.2 MB at RCAN's training shape, 16 x 32 x 32 x 64: 1.25 us at
// 3.35 TB/s); the MLP is C (C/r) 2 multiply-adds per image.
//
// Design. The TPU kernel holds one image in VMEM and reads it once. Here
// a block cannot see the whole image at the predict sizes (a 128 x 128 x
// 64 image is 2 MB), and Hopper's blocks run in no order, so there are
// three launches:
//   ca_pool_kernel: per block of kpix pixels of one image (the wrapper
//     takes 128, or more where an image would give over 256 blocks), the f32
//     channel sums of its pixels (each thread one 8-channel vector of a
//     fixed set of pixels, then a fixed-order sum over the threads in
//     shared memory) into its own slot of part (B, nsplit, C);
//   ca_mlp_kernel: per image, the pool from part (the slots added in
//     order, divided by H W), the MLP and the sigmoid on CUDA cores in
//     f32, into gate (B, C);
//   ca_apply_kernel: per block of kpix pixels, out = bf16(x * gate).
// x is read twice (1.5x the bytes of the bound). No float atomics: two
// calls give the same bits. Any C that is a multiple of 8 (one 16-byte
// vector per 8 channels), any C/r.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "tile_conv.cuh"

namespace {

using srt::bf16;

constexpr int kThreads = 256;
constexpr int kVecs = kThreads;  // vectors of a channel group (2048 ch)

// Per block (split s of image b): part[b, s, :] = sum over its pixels
// [s kpix, min((s + 1) kpix, HW)) of f32(x). Channels go in groups of up
// to kVecs vectors; in a group of nvb vectors thread t sums vector t % nvb
// over the pixels t / nvb, t / nvb + rows, ... (rows = kThreads / nvb),
// then the rows are added in order.
__global__ void __launch_bounds__(kThreads)
    ca_pool_kernel(const bf16* __restrict__ x, float* __restrict__ part,
                   int HW, int C, int kpix, int nsplit) {
  __shared__ float red[kThreads * 8];
  const int b = blockIdx.y, s = blockIdx.x, t = threadIdx.x;
  const int nv = C / 8;
  const long long p0 = (long long)s * kpix;
  const long long p1 = min(p0 + kpix, (long long)HW);
  const bf16* xb = x + (size_t)b * HW * C;
  float* out = part + ((size_t)b * nsplit + s) * C;
  for (int v0 = 0; v0 < nv; v0 += kVecs) {
    const int nvb = min(kVecs, nv - v0);
    const int rows = kThreads / nvb;
    float acc[8] = {};
    if (t < rows * nvb) {
      const int v = v0 + t % nvb;
      for (long long p = p0 + t / nvb; p < p1; p += rows) {
        float f[8];
        srt::unpack8(*reinterpret_cast<const uint4*>(xb + p * C + v * 8), f);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[j] += f[j];
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) red[t * 8 + j] = acc[j];
    __syncthreads();
    for (int ci = t; ci < nvb * 8; ci += kThreads) {
      float sum = 0.0f;
      for (int r = 0; r < rows; ++r)
        sum += red[(r * nvb + ci / 8) * 8 + ci % 8];
      out[v0 * 8 + ci] = sum;
    }
    __syncthreads();
  }
}

// Per image b: gate[b] = sigmoid(relu(pool W1 + b1) W2 + b2) with pool
// the sum of part[b, :, :] over its nsplit slots, in order, over HW.
// Dynamic shared memory: pool (C), hidden (cr) floats.
__global__ void __launch_bounds__(kThreads)
    ca_mlp_kernel(const float* __restrict__ part, const float* __restrict__ w1,
                  const float* __restrict__ b1, const float* __restrict__ w2,
                  const float* __restrict__ b2, float* __restrict__ gate,
                  int HW, int C, int cr, int nsplit) {
  extern __shared__ float sm[];
  float* pool = sm;
  float* hid = sm + C;
  const int b = blockIdx.x, t = threadIdx.x;
  const float* pb = part + (size_t)b * nsplit * C;
  for (int c = t; c < C; c += kThreads) {
    float sum = 0.0f;
    for (int k = 0; k < nsplit; ++k) sum += pb[(size_t)k * C + c];
    pool[c] = sum / (float)HW;
  }
  __syncthreads();
  for (int j = t; j < cr; j += kThreads) {
    float z = 0.0f;
    for (int c = 0; c < C; ++c) z += pool[c] * w1[(size_t)c * cr + j];
    hid[j] = fmaxf(z + b1[j], 0.0f);
  }
  __syncthreads();
  for (int c = t; c < C; c += kThreads) {
    float z = 0.0f;
    for (int j = 0; j < cr; ++j) z += hid[j] * w2[(size_t)j * C + c];
    gate[(size_t)b * C + c] = 1.0f / (1.0f + expf(-(z + b2[c])));
  }
}

// Per block (split s of image b): out = bf16(f32(x) * gate[b]) over its
// pixels [s kpix, min((s + 1) kpix, HW)).
__global__ void __launch_bounds__(kThreads)
    ca_apply_kernel(const bf16* __restrict__ x, const float* __restrict__ gate,
                    bf16* __restrict__ out, int HW, int C, int kpix) {
  const int b = blockIdx.y, s = blockIdx.x;
  const int nv = C / 8;
  const float* gb = gate + (size_t)b * C;
  const long long p0 = (long long)s * kpix;
  const long long n = (min(p0 + kpix, (long long)HW) - p0) * nv;
  const size_t base = ((size_t)b * HW + p0) * C;
  for (long long i = threadIdx.x; i < n; i += kThreads) {
    const int c = (int)(i % nv) * 8;
    const size_t at = base + (size_t)(i / nv) * C + c;
    float f[8];
    srt::unpack8(*reinterpret_cast<const uint4*>(x + at), f);
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] *= gb[c + j];
    *reinterpret_cast<uint4*>(out + at) = srt::pack8(f);
  }
}

}  // namespace

// x, out (B, H W, C) bf16 (C a multiple of 8); w1 (C, cr), b1 (cr), w2
// (cr, C), b2 (C) f32; scratch (B nsplit C + B C) f32 with nsplit =
// ceil(HW / kpix): the partial sums, then the gates. Returns a
// cudaError_t.
extern "C" int srt_ca_layer_fwd(const void* x, const void* w1, const void* b1,
                                const void* w2, const void* b2, void* scratch,
                                void* out, int B, int HW, int C, int cr,
                                int kpix, void* stream) {
  if (C <= 0 || C % 8 || cr <= 0 || kpix <= 0 || HW <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nsplit = (HW + kpix - 1) / kpix;
  float* part = static_cast<float*>(scratch);
  float* gate = part + (size_t)B * nsplit * C;
  const size_t smem = (size_t)(C + cr) * sizeof(float);
  cudaError_t err = srt::allow_smem(ca_mlp_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(nsplit, B);
  ca_pool_kernel<<<grid, kThreads, 0, s>>>(static_cast<const bf16*>(x), part,
                                           HW, C, kpix, nsplit);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ca_mlp_kernel<<<B, kThreads, smem, s>>>(
      part, static_cast<const float*>(w1), static_cast<const float*>(b1),
      static_cast<const float*>(w2), static_cast<const float*>(b2), gate, HW,
      C, cr, nsplit);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ca_apply_kernel<<<grid, kThreads, 0, s>>>(static_cast<const bf16*>(x), gate,
                                            static_cast<bf16*>(out), HW, C,
                                            kpix);
  return (int)cudaGetLastError();
}
