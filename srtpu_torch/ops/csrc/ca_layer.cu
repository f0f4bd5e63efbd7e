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
// two launches, at any size:
//   ca_pool_kernel, per block of kpix pixels the f32 channel sums into its
//     slot of part (B, nsplit, C);
//   ca_gate_apply_kernel, in which every block adds its image's slots in
//     order, computes the MLP and the sigmoid itself (the same f32
//     operations in the same order in every block, so every block's gate
//     has the same bits) and gates its own pixels. x's second read comes
//     from L2 (50 MB) where the batch's images fit there.
// A one-launch form that held each image in a thread-block cluster's
// shared memory (bulk copies, partials over distributed shared memory,
// x read once) was built and measured on the H100: it was slower than
// these two launches at every size measured (the training shape,
// 1 x 128 x 128, 2 x 67 x 45) and was removed.
// No float atomics: two calls give the same bits. Any C that is a
// multiple of 8 (one 16-byte vector per 8 channels), any C/r.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

using namespace srt90;

constexpr int kThreads = 256;
constexpr int kVecs = kThreads;  // vectors of a channel group (2048 ch)

// Channel sums of pixels [0, n) of an image slice at src (pixel stride C)
// into out[0, C): channels go in groups of up to kVecs vectors; in a group
// of nvb vectors thread t sums vector t % nvb over the pixels t / nvb,
// t / nvb + rows, ... (rows = kThreads / nvb), then the rows are added in
// order. red: kThreads * 8 floats of shared memory. Ends with a barrier.
__device__ __forceinline__ void channel_sums(const bf16* src, long long n,
                                             int C, float* out, float* red) {
  const int t = threadIdx.x, nv = C / 8;
  for (int v0 = 0; v0 < nv; v0 += kVecs) {
    const int nvb = min(kVecs, nv - v0);
    const int rows = kThreads / nvb;
    float acc[8] = {};
    if (t < rows * nvb) {
      const int v = v0 + t % nvb;
#pragma unroll 4
      for (long long p = t / nvb; p < n; p += rows) {
        float f[8];
        unpack8(*reinterpret_cast<const uint4*>(src + p * C + v * 8), f);
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

// gate (C) = sigmoid(relu(pool W1 + b1) W2 + b2), pool given (C) and hid
// (cr) scratch, all in shared memory. Hidden unit j is a warp's: lane l
// sums channels l, l + 32, ... in order, then the lanes in a fixed
// butterfly (the loads of a unit in flight together, not one a step).
// Ends with a barrier.
__device__ __forceinline__ void mlp_gate(const float* pool,
                                         const float* __restrict__ w1,
                                         const float* __restrict__ b1,
                                         const float* __restrict__ w2,
                                         const float* __restrict__ b2,
                                         float* hid, float* gate, int C,
                                         int cr) {
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  for (int j = warp; j < cr; j += kThreads / 32) {
    float z = 0.0f;
#pragma unroll 4
    for (int c = lane; c < C; c += 32)
      z += pool[c] * __ldg(w1 + (size_t)c * cr + j);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) z += __shfl_xor_sync(0xffffffffu, z, o);
    if (lane == 0) hid[j] = fmaxf(z + __ldg(b1 + j), 0.0f);
  }
  __syncthreads();
  for (int c = t; c < C; c += kThreads) {
    float z = 0.0f;
    for (int j = 0; j < cr; ++j) z += hid[j] * w2[(size_t)j * C + c];
    gate[c] = 1.0f / (1.0f + expf(-(z + b2[c])));
  }
  __syncthreads();
}

// out = bf16(f32(src) * gate) over n pixels (pixel stride C).
__device__ __forceinline__ void apply_gate(const bf16* __restrict__ src,
                                           bf16* __restrict__ out,
                                           long long n, int C,
                                           const float* gate) {
  const int nv = C / 8;
#pragma unroll 4
  for (long long i = threadIdx.x; i < n * nv; i += kThreads) {
    const int c = (int)(i % nv) * 8;
    const size_t at = (size_t)(i / nv) * C + c;
    float f[8];
    unpack8(*reinterpret_cast<const uint4*>(src + at), f);
#pragma unroll
    for (int j = 0; j < 8; ++j) f[j] *= gate[c + j];
    *reinterpret_cast<uint4*>(out + at) = pack8(f);
  }
}

// Per block (split s of image b): part[b, s, :] = sum over its pixels
// [s kpix, min((s + 1) kpix, HW)) of f32(x).
__global__ void __launch_bounds__(kThreads)
    ca_pool_kernel(const bf16* __restrict__ x, float* __restrict__ part,
                   int HW, int C, int kpix, int nsplit) {
  __shared__ float red[kThreads * 8];
  const int b = blockIdx.y, s = blockIdx.x;
  const long long p0 = (long long)s * kpix;
  const long long p1 = min(p0 + kpix, (long long)HW);
  channel_sums(x + ((size_t)b * HW + p0) * C, p1 - p0, C,
               part + ((size_t)b * nsplit + s) * C, red);
}

// Per block (split s of image b): the gate from part[b, :, :] (the slots
// added in a fixed order, over HW), then out = bf16(f32(x) * gate) over
// its pixels. Dynamic shared memory: pool, gate (C), hid (cr, rounded up
// to 4) and red (kThreads) floats.
__global__ void __launch_bounds__(kThreads)
    ca_gate_apply_kernel(const bf16* __restrict__ x,
                         const float* __restrict__ part,
                         const float* __restrict__ w1,
                         const float* __restrict__ b1,
                         const float* __restrict__ w2,
                         const float* __restrict__ b2, bf16* __restrict__ out,
                         int HW, int C, int cr, int kpix, int nsplit) {
  extern __shared__ float sm[];
  float* pool = sm;
  float* gate = sm + C;
  float* hid = gate + C;
  float* red = hid + ((cr + 3) & ~3);  // kThreads floats
  const int b = blockIdx.y, s = blockIdx.x, t = threadIdx.x;
  const float* pb = part + (size_t)b * nsplit * C;
  // the image's slots in order: with C <= kThreads, lane group g of
  // kThreads / C adds slots g, g + groups, ... (their loads in flight
  // together), then the groups are added in order
  const int groups = C <= kThreads ? kThreads / C : 1;
  for (int c0 = 0; c0 < C; c0 += kThreads / groups) {
    const int c = c0 + t % (kThreads / groups), g = t / (kThreads / groups);
    float sum = 0.0f;
    if (c < C && g < groups) {
#pragma unroll 8
      for (int k = g; k < nsplit; k += groups) sum += pb[(size_t)k * C + c];
    }
    red[t] = sum;
    __syncthreads();
    if (t < kThreads / groups && c0 + t < C) {
      float tot = 0.0f;
      for (int q = 0; q < groups; ++q) tot += red[q * (kThreads / groups) + t];
      pool[c0 + t] = tot / (float)HW;
    }
    __syncthreads();
  }
  mlp_gate(pool, w1, b1, w2, b2, hid, gate, C, cr);
  const long long p0 = (long long)s * kpix;
  const size_t at = ((size_t)b * HW + p0) * C;
  apply_gate(x + at, out + at, min(p0 + kpix, (long long)HW) - p0, C, gate);
}

}  // namespace

// x, out (B, H W, C) bf16 (C a multiple of 8); w1 (C, cr), b1 (cr), w2
// (cr, C), b2 (C) f32; blocks of kpix pixels, scratch (B ceil(HW / kpix)
// C) f32 for the partial sums. Returns a cudaError_t.
extern "C" int srt_ca_layer_fwd(const void* x, const void* w1, const void* b1,
                                const void* w2, const void* b2, void* scratch,
                                void* out, int B, int HW, int C, int cr,
                                int kpix, void* stream) {
  if (C <= 0 || C % 8 || cr <= 0 || HW <= 0 || B <= 0 || B > 65535 ||
      kpix <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const float *w1f = static_cast<const float*>(w1),
              *b1f = static_cast<const float*>(b1),
              *w2f = static_cast<const float*>(w2),
              *b2f = static_cast<const float*>(b2);
  bf16* ob = static_cast<bf16*>(out);
  const int nsplit = (HW + kpix - 1) / kpix;
  float* part = static_cast<float*>(scratch);
  const size_t smem =
      (size_t)(2 * C + ((cr + 3) & ~3) + kThreads) * sizeof(float);
  static const cudaError_t allowed = cudaFuncSetAttribute(
      ca_gate_apply_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kMaxSmem);
  if (allowed != cudaSuccess) return (int)allowed;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err;
  dim3 grid(nsplit, B);
  ca_pool_kernel<<<grid, kThreads, 0, s>>>(xb, part, HW, C, kpix, nsplit);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  ca_gate_apply_kernel<<<grid, kThreads, smem, s>>>(
      xb, part, w1f, b1f, w2f, b2f, ob, HW, C, cr, kpix, nsplit);
  return (int)cudaGetLastError();
}
