// K1 forward: one EDSR resblock per launch, at 64 channels, NHWC bf16,
// f32 accumulation:
//   h1  = bf16(relu(conv(x) + b1)),
//   out = bf16(x + res_scale * (conv(h1) + b2)).
//
// Replaces srtpu/ops/cs_conv.py:trunk_fwd_mega (kernel body
// _trunk_fwd_kernel_mega). On the TPU the grid's block axis runs in order
// on one core, so one kernel carries the activation through all L blocks
// in VMEM. Hopper runs a grid's blocks in no order, and block l + 1 needs
// every neighbouring tile of block l, so the loop over L moves to the
// host (srtpu_torch/ops/trunk.py): L launches on one stream, each reading
// the previous block's output. What stays fused is the block itself: h1
// for the output tile and its 1-pixel halo is computed into shared memory
// and never reaches device memory. Inference keeps no per-block inputs or
// h1; training passes h1_out, and each tile then also writes the interior
// of its h1 (the TPU kernel's h1s output, which the backward reads).
//
// What bounds it on the H100: 2 * 2 * 9 * 64 * 64 = 147 kFLOP per pixel
// against 256 bytes of device traffic (x in, out), ~576 FLOP/byte: compute
// bound, above the card's bf16 ridge (~295). The design feeds the tensor
// cores (wmma bf16 tiles, f32 sums) from shared memory: the x tile with a
// 2-pixel halo, h1 with a 1-pixel halo, and one conv's weights at a time
// (W1, then W2 loaded over it). The halo recompute costs 1.44x the ideal
// FLOPs at 8 x 16 tiles. No wgmma/TMA yet.

#include "tile_conv.cuh"

namespace {

constexpr int kC = 64, kTH = 8, kTW = 16;

struct TrunkPlan {
  static constexpr int PS = kC + 16;
  static constexpr int WX = kTW + 4;                 // tile + 2-pixel halo
  static constexpr int MF1 = ((kTH + 2) * WX + 15) / 16;  // h1 positions
  static constexpr int MF2 = (kTH * WX + 15) / 16;        // output positions
  static constexpr int NX = MF1 * 16 + 2 * WX + 2;   // x pixels read by conv1
  static constexpr int NH = srt::cmax(MF1 * 16, MF2 * 16 + 2 * WX + 2);
  static constexpr size_t XS = srt::align128((size_t)NX * PS * 2);
  static constexpr size_t HS = srt::align128((size_t)NH * PS * 2);
  static constexpr size_t WS = srt::align128((size_t)9 * kC * kC * 2);
  static constexpr size_t SCR = (size_t)srt::kWarps * 256 * 4;
  static constexpr size_t SMEM = XS + HS + WS + SCR;
};

__global__ void __launch_bounds__(srt::kThreads)
    resblock_kernel(const srt::bf16* __restrict__ x,
                    const srt::bf16* __restrict__ w1,
                    const float* __restrict__ b1,
                    const srt::bf16* __restrict__ w2,
                    const float* __restrict__ b2, float scale,
                    srt::bf16* __restrict__ out,
                    srt::bf16* __restrict__ h1_out, int H, int W) {
  typedef TrunkPlan P;
  using srt::bf16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* hs = reinterpret_cast<bf16*>(smem + P::XS);
  bf16* ws = reinterpret_cast<bf16*>(smem + P::XS + P::HS);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* scr =
      reinterpret_cast<float*>(smem + P::XS + P::HS + P::WS) + warp * 256;

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTH, x0 = blockIdx.x * kTW;
  const int c0 = (lane & 1) * 8;  // first of this lane's 8 channels (+16 n)

  srt::load_tile<kC>(xs, x, b, H, W, y0 - 2, x0 - 2, kTH + 4, P::WX, P::NX);
  srt::load_weights<kC, kC>(ws, w1, kC, 0);
  // h1 slack past the computed positions is read only by discarded outputs;
  // zero it so no stale bits enter the tensor cores
  for (int i = P::MF1 * 16 * (P::PS / 8) + threadIdx.x;
       i < P::NH * (P::PS / 8); i += blockDim.x)
    reinterpret_cast<uint4*>(hs)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  // conv1 over the (kTH + 2) x (kTW + 2) h1 window (origin y0 - 1, x0 - 1)
  for (int mf = warp; mf < P::MF1; mf += srt::kWarps) {
    srt::AccFrag acc[kC / 16];
    srt::mma_3x3<kC, kC>(acc, xs, ws, mf * 16, P::WX);
    const int p = mf * 16 + (lane >> 1);
    const int hy = p / P::WX, hx = p % P::WX;
    const int gy = y0 - 1 + hy, gx = x0 - 1 + hx;
    // h1 outside the image is conv2's zero padding, not conv1 of zeros
    const bool inside = hy < kTH + 2 && hx < kTW + 2 && gy >= 0 && gy < H &&
                        gx >= 0 && gx < W;
    const bool interior =
        inside && hy >= 1 && hy <= kTH && hx >= 1 && hx <= kTW;
#pragma unroll
    for (int n = 0; n < kC / 16; ++n) {
      float v[8];
      srt::lane_values(scr, acc[n], lane, v);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = inside ? fmaxf(v[j] + b1[n * 16 + c0 + j], 0.0f) : 0.0f;
      const uint4 h = srt::pack8(v);
      *reinterpret_cast<uint4*>(hs + (size_t)p * P::PS + n * 16 + c0) = h;
      if (h1_out && interior)
        *reinterpret_cast<uint4*>(
            h1_out + (((size_t)b * H + gy) * W + gx) * kC + n * 16 + c0) = h;
    }
  }
  __syncthreads();
  srt::load_weights<kC, kC>(ws, w2, kC, 0);
  __syncthreads();

  // conv2 over the kTH x kTW output tile, + res_scale and the skip
  for (int mf = warp; mf < P::MF2; mf += srt::kWarps) {
    srt::AccFrag acc[kC / 16];
    srt::mma_3x3<kC, kC>(acc, hs, ws, mf * 16, P::WX);
    const int q = mf * 16 + (lane >> 1);
    const int oy = q / P::WX, ox = q % P::WX;
    const int gy = y0 + oy, gx = x0 + ox;
    const bool valid = oy < kTH && ox < kTW && gy < H && gx < W;
#pragma unroll
    for (int n = 0; n < kC / 16; ++n) {
      float v[8];
      srt::lane_values(scr, acc[n], lane, v);
      if (!valid) continue;
      float xr[8];
      srt::unpack8(*reinterpret_cast<const uint4*>(
                       xs + (size_t)((oy + 2) * P::WX + ox + 2) * P::PS +
                       n * 16 + c0),
                   xr);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = (v[j] + b2[n * 16 + c0 + j]) * scale + xr[j];
      *reinterpret_cast<uint4*>(out + (((size_t)b * H + gy) * W + gx) * kC +
                                n * 16 + c0) = srt::pack8(v);
    }
  }
}

// K1 backward, one block per launch (srtpu _trunk_bwd_kernel_mega, per
// block; the host loops over the blocks in reverse). With g the
// cotangent of the block's output, h1 the saved post-ReLU activation and
// the transposed weights wt[ky, kx, co, ci] = w[2 - ky, 2 - kx, ci, co]:
//   gs  = bf16(scale * g),
//   dh1 = bf16(h1 > 0 ? convT(gs, W2) : 0),
//   dx  = bf16(convT(dh1, W1) + g).
// Replaces the dx chain of srtpu/ops/cs_conv.py:trunk_bwd_mega; its dW1,
// dW2, db1, db2 come from the weight-grad kernel (wgrad.cu), one launch
// per conv for all blocks at once. Bound as the forward: 147 kFLOP per
// pixel against 512 bytes (g, h1 in; dx, dh1 out), ~290 FLOP/byte, at
// the card's bf16 ridge. The same tile plan as the forward: gs with a
// 2-pixel halo, dh1 for the tile and its 1-pixel halo in shared memory
// (its interior also goes to dh1_out for the weight grads), one conv's
// weights at a time.
__global__ void __launch_bounds__(srt::kThreads)
    resblock_bwd_kernel(const srt::bf16* __restrict__ g,
                        const srt::bf16* __restrict__ h1,
                        const srt::bf16* __restrict__ w2t,
                        const srt::bf16* __restrict__ w1t, float scale,
                        srt::bf16* __restrict__ dx,
                        srt::bf16* __restrict__ dh1_out, int H, int W) {
  typedef TrunkPlan P;
  using srt::bf16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* gs = reinterpret_cast<bf16*>(smem);
  bf16* hs = reinterpret_cast<bf16*>(smem + P::XS);
  bf16* ws = reinterpret_cast<bf16*>(smem + P::XS + P::HS);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* scr =
      reinterpret_cast<float*>(smem + P::XS + P::HS + P::WS) + warp * 256;

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTH, x0 = blockIdx.x * kTW;
  const int c0 = (lane & 1) * 8;

  srt::load_tile<kC>(gs, g, b, H, W, y0 - 2, x0 - 2, kTH + 4, P::WX, P::NX,
                     scale);
  srt::load_weights<kC, kC>(ws, w2t, kC, 0);
  for (int i = P::MF1 * 16 * (P::PS / 8) + threadIdx.x;
       i < P::NH * (P::PS / 8); i += blockDim.x)
    reinterpret_cast<uint4*>(hs)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  // dh1 over the (kTH + 2) x (kTW + 2) window (origin y0 - 1, x0 - 1);
  // outside the image it is convT's zero padding
  for (int mf = warp; mf < P::MF1; mf += srt::kWarps) {
    srt::AccFrag acc[kC / 16];
    srt::mma_3x3<kC, kC>(acc, gs, ws, mf * 16, P::WX);
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
      float v[8], hv[8] = {};
      srt::lane_values(scr, acc[n], lane, v);
      if (inside)
        srt::unpack8(*reinterpret_cast<const uint4*>(h1 + pix * kC + n * 16 +
                                                     c0),
                     hv);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = inside && hv[j] > 0.0f ? v[j] : 0.0f;
      const uint4 d = srt::pack8(v);
      *reinterpret_cast<uint4*>(hs + (size_t)p * P::PS + n * 16 + c0) = d;
      if (interior)
        *reinterpret_cast<uint4*>(dh1_out + pix * kC + n * 16 + c0) = d;
    }
  }
  __syncthreads();
  srt::load_weights<kC, kC>(ws, w1t, kC, 0);
  __syncthreads();

  // dx over the kTH x kTW tile: convT(dh1, W1) + g, one rounding
  for (int mf = warp; mf < P::MF2; mf += srt::kWarps) {
    srt::AccFrag acc[kC / 16];
    srt::mma_3x3<kC, kC>(acc, hs, ws, mf * 16, P::WX);
    const int q = mf * 16 + (lane >> 1);
    const int oy = q / P::WX, ox = q % P::WX;
    const int gy = y0 + oy, gx = x0 + ox;
    const bool valid = oy < kTH && ox < kTW && gy < H && gx < W;
    const size_t pix = ((size_t)b * H + gy) * W + gx;
#pragma unroll
    for (int n = 0; n < kC / 16; ++n) {
      float v[8];
      srt::lane_values(scr, acc[n], lane, v);
      if (!valid) continue;
      float gr[8];
      srt::unpack8(
          *reinterpret_cast<const uint4*>(g + pix * kC + n * 16 + c0), gr);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] += gr[j];
      *reinterpret_cast<uint4*>(dx + pix * kC + n * 16 + c0) = srt::pack8(v);
    }
  }
}

}  // namespace

// x, out (B, H, W, 64) bf16 (distinct buffers); w1, w2 (3, 3, 64, 64)
// bf16; b1, b2 (64) f32; h1_out (B, H, W, 64) bf16 or null (inference).
// Returns a cudaError_t.
extern "C" int srt_resblock_fwd(const void* x, const void* w1, const void* b1,
                                const void* w2, const void* b2, float scale,
                                void* out, void* h1_out, int B, int H, int W,
                                int C, void* stream) {
  if (C != kC) return (int)cudaErrorInvalidValue;
  cudaError_t err = srt::allow_smem(resblock_kernel, TrunkPlan::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
  resblock_kernel<<<grid, srt::kThreads, TrunkPlan::SMEM,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const srt::bf16*>(x), static_cast<const srt::bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const srt::bf16*>(w2),
      static_cast<const float*>(b2), scale, static_cast<srt::bf16*>(out),
      static_cast<srt::bf16*>(h1_out), H, W);
  return (int)cudaGetLastError();
}

// g, h1, dx, dh1 (B, H, W, 64) bf16 (dx distinct from g); w2t, w1t
// (3, 3, 64, 64) bf16 transposed weights. Returns a cudaError_t.
extern "C" int srt_resblock_bwd(const void* g, const void* h1,
                                const void* w2t, const void* w1t, float scale,
                                void* dx, void* dh1, int B, int H, int W,
                                int C, void* stream) {
  if (C != kC) return (int)cudaErrorInvalidValue;
  cudaError_t err = srt::allow_smem(resblock_bwd_kernel, TrunkPlan::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
  resblock_bwd_kernel<<<grid, srt::kThreads, TrunkPlan::SMEM,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const srt::bf16*>(g), static_cast<const srt::bf16*>(h1),
      static_cast<const srt::bf16*>(w2t), static_cast<const srt::bf16*>(w1t),
      scale, static_cast<srt::bf16*>(dx), static_cast<srt::bf16*>(dh1), H, W);
  return (int)cudaGetLastError();
}
