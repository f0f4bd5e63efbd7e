// K8a: srtpu's fused NHWC EDSR resblock (its use_pallas=True route), at 64
// channels, NHWC bf16 in and out, with the activation between the convs
// kept in f32:
//   h1  = relu(conv(x, W1) + b1)                        f32
//   out = bf16((conv(h1, W2) + b2) * res_scale + x)     one rounding
// and, when h1_out is given, bf16(h1) (the activation the backward reads).
// conv2 reads the f32 h1, not its bf16 rounding: K1 (trunk.cu) rounds h1
// first and so cannot serve this function.
//
// Replaces srtpu/ops/resblock.py:resblock_fused_h1 (body
// _resblock_kernel_h1), behind resblock_fused_v2 / FusedResBlock, and
// resblock_fused (_resblock_kernel: the same body without h1), called
// here with h1_out null.
//
// The f32 h1 on bf16 tensor cores. Each h1 value is carried as a pair
// hi = bf16(h1), lo = bf16(h1 - hi), and conv2 runs twice into the same
// f32 accumulators: conv(hi, W2) + conv(lo, W2). W2 holds bf16 values
// (srtpu casts the weights), so every product hi * w and lo * w is exact
// in f32, and h1 - hi - lo is below 2^-17 |h1|: the sum is the f32 conv
// to that error. TF32 (10-bit mantissa) would not be. conv1 reads bf16 x
// and W1 and needs no split.
//
// What bounds it on the H100: the function's work is 2 convs x 2 * 9 * 64
// * 64 = 147 kFLOP per pixel (2.42 GFLOP at the training shape, 16 x 32 x
// 32) against 256 bytes (x in, out out; 384 with h1): operations. The lo
// half adds conv2 once more (1.5x the function's tensor-core work), and
// the halo recompute of the tile plan 1.44x on conv1.
//
// Design: fused_block.cuh's tile plan (Plan): a block owns an 8 x 16
// output tile of one image, grid (ceil(W / 16), ceil(H / 8), B). The x
// tile with a 2-pixel halo, h1's hi and lo halves with a 1-pixel halo and
// one conv's weights at a time (W1, then W2 over it) sit in shared memory
// (188.5 KB: one block per SM); wmma bf16 tiles, f32 accumulators. h1
// never reaches device memory in f32. No wgmma/TMA yet.

#include "fused_block.cuh"

namespace {

using srt::AccFrag;
using srt::bf16;
using srt::fused::kC;
using srt::fused::kTH;
using srt::fused::kTW;
typedef srt::fused::Plan P;

// [x tile | h1 hi | h1 lo | weights | per-warp scratch]
constexpr size_t kLo = P::XS + P::HS;
constexpr size_t kW = kLo + P::HS;
constexpr size_t kScr = kW + P::WS;
constexpr size_t kSmem = kScr + P::SCR;

__global__ void __launch_bounds__(srt::kThreads)
    resblock_f32_kernel(const bf16* __restrict__ x,
                        const bf16* __restrict__ w1,
                        const float* __restrict__ b1,
                        const bf16* __restrict__ w2,
                        const float* __restrict__ b2, float scale,
                        bf16* __restrict__ out, bf16* __restrict__ h1_out,
                        int H, int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* his = reinterpret_cast<bf16*>(smem + P::XS);
  bf16* los = reinterpret_cast<bf16*>(smem + kLo);
  bf16* ws = reinterpret_cast<bf16*>(smem + kW);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* scr = reinterpret_cast<float*>(smem + kScr) + warp * 256;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTH, x0 = blockIdx.x * kTW;
  const int c0 = (lane & 1) * 8;

  srt::load_tile<kC>(xs, x, b, H, W, y0 - 2, x0 - 2, kTH + 4, P::WX, P::NX);
  srt::load_weights<kC, kC>(ws, w1, kC, 0);
  // the slack past the computed h1 positions is read only by discarded
  // outputs; zero it so no stale bits enter the tensor cores
  for (int i = P::MF1 * 16 * (P::PS / 8) + threadIdx.x;
       i < P::NH * (P::PS / 8); i += blockDim.x) {
    reinterpret_cast<uint4*>(his)[i] = make_uint4(0u, 0u, 0u, 0u);
    reinterpret_cast<uint4*>(los)[i] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  // conv1 over the tile and its 1-pixel halo: h1 = relu(acc + b1) in f32,
  // split into hi and lo; 0 outside the image (conv2's zero padding)
  for (int mf = warp; mf < P::MF1; mf += srt::kWarps) {
    AccFrag acc[kC / 16];
    srt::mma_3x3<kC, kC>(acc, xs, ws, mf * 16, P::WX);
    const int p = mf * 16 + (lane >> 1);
    const int hy = p / P::WX, hx = p % P::WX;
    const int gy = y0 - 1 + hy, gx = x0 - 1 + hx;
    const bool inside = hy < kTH + 2 && hx < kTW + 2 && gy >= 0 && gy < H &&
                        gx >= 0 && gx < W;
    const bool interior =
        inside && hy >= 1 && hy <= kTH && hx >= 1 && hx <= kTW;
    const size_t pix = ((size_t)b * H + gy) * W + gx;
#pragma unroll
    for (int n = 0; n < kC / 16; ++n) {
      float v[8], hi[8], lo[8];
      srt::lane_values(scr, acc[n], lane, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float h = inside ? fmaxf(v[j] + b1[n * 16 + c0 + j], 0.0f)
                               : 0.0f;
        hi[j] = __bfloat162float(__float2bfloat16_rn(h));
        lo[j] = h - hi[j];
      }
      const uint4 hv = srt::pack8(hi);
      *reinterpret_cast<uint4*>(his + (size_t)p * P::PS + n * 16 + c0) = hv;
      *reinterpret_cast<uint4*>(los + (size_t)p * P::PS + n * 16 + c0) =
          srt::pack8(lo);
      if (h1_out && interior)
        *reinterpret_cast<uint4*>(h1_out + pix * kC + n * 16 + c0) = hv;
    }
  }
  __syncthreads();
  srt::load_weights<kC, kC>(ws, w2, kC, 0);
  __syncthreads();

  // conv2 = conv(hi, W2) + conv(lo, W2) over the tile, then the bias,
  // res_scale and the skip (x from its staged tile), one rounding
  for (int mf = warp; mf < P::MF2; mf += srt::kWarps) {
    AccFrag acc[kC / 16];
    srt::mma_3x3<kC, kC>(acc, his, ws, mf * 16, P::WX);
    srt::mma_taps<kC, kC, 3, 3>(acc, los, ws, mf * 16, P::WX, 0);
    const int q = mf * 16 + (lane >> 1);
    const int oy = q / P::WX, ox = q % P::WX;
    const int gy = y0 + oy, gx = x0 + ox;
    const bool valid = oy < kTH && ox < kTW && gy < H && gx < W;
    const size_t pix = ((size_t)b * H + gy) * W + gx;
#pragma unroll
    for (int n = 0; n < kC / 16; ++n) {
      float v[8], xr[8];
      srt::lane_values(scr, acc[n], lane, v);
      if (!valid) continue;
      const int c = n * 16 + c0;
      srt::unpack8(*reinterpret_cast<const uint4*>(
                       xs + (size_t)((oy + 2) * P::WX + ox + 2) * P::PS + c),
                   xr);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = (v[j] + b2[c + j]) * scale + xr[j];
      *reinterpret_cast<uint4*>(out + pix * kC + c) = srt::pack8(v);
    }
  }
}

}  // namespace

// x, out (B, H, W, 64) bf16 (distinct buffers); w1, w2 (3, 3, 64, 64)
// bf16; b1, b2 (64) f32; h1_out (B, H, W, 64) bf16, or null for
// resblock_fused's form. Returns a cudaError_t.
extern "C" int srt_resblock_f32_fwd(const void* x, const void* w1,
                                    const void* b1, const void* w2,
                                    const void* b2, float scale, void* out,
                                    void* h1_out, int B, int H, int W, int C,
                                    void* stream) {
  if (C != kC) return (int)cudaErrorInvalidValue;
  cudaError_t err = srt::allow_smem(resblock_f32_kernel, kSmem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
  resblock_f32_kernel<<<grid, srt::kThreads, kSmem,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), scale, static_cast<bf16*>(out),
      static_cast<bf16*>(h1_out), H, W);
  return (int)cudaGetLastError();
}
