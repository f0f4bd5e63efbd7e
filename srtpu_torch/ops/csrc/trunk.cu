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
// bound, above the card's bf16 ridge (~295). The design (the fused conv
// pair of fused_block.cuh) feeds the tensor cores
// (wmma bf16 tiles, f32 sums) from shared memory: the x tile with a
// 2-pixel halo, h1 with a 1-pixel halo, and one conv's weights at a time
// (W1, then W2 loaded over it). The halo recompute costs 1.44x the ideal
// FLOPs at 8 x 16 tiles. No wgmma/TMA yet.

#include "fused_block.cuh"

namespace {

using srt::fused::kC;
using srt::fused::kTH;
using srt::fused::kTW;
typedef srt::fused::Plan TrunkPlan;

__global__ void __launch_bounds__(srt::kThreads)
    resblock_kernel(const srt::bf16* __restrict__ x,
                    const srt::bf16* __restrict__ w1,
                    const float* __restrict__ b1,
                    const srt::bf16* __restrict__ w2,
                    const float* __restrict__ b2, float scale,
                    srt::bf16* __restrict__ out,
                    srt::bf16* __restrict__ h1_out, int H, int W) {
  typedef TrunkPlan P;
  extern __shared__ __align__(128) unsigned char smem[];
  const srt::bf16* xs = reinterpret_cast<const srt::bf16*>(smem);
  // conv2 over the tile, + res_scale and the skip (x from its staged tile)
  srt::fused::pair_forward(
      x, w1, b1, w2, h1_out, H, W, smem,
      [&](int oy, int ox, size_t pix, int c, float (&v)[8]) {
        float xr[8];
        srt::unpack8(*reinterpret_cast<const uint4*>(
                         xs + (size_t)((oy + 2) * P::WX + ox + 2) * P::PS +
                         c),
                     xr);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = (v[j] + b2[c + j]) * scale + xr[j];
        *reinterpret_cast<uint4*>(out + pix * kC + c) = srt::pack8(v);
      });
}

// K1 backward, one block per launch (srtpu _trunk_bwd_kernel_mega, per
// block; the host loops over the blocks in reverse). With g the
// cotangent of the block's output, h1 the saved post-ReLU activation and
// the transposed weights wt[ky, kx, co, ci] = w[2 - ky, 2 - kx, ci, co]:
//   gs  = bf16(scale * g),
//   dh1 = bf16(h1 > 0 ? convT(gs, W2) : 0),
//   dx  = bf16(convT(dh1, W1) + g).
// Replaces the dx chain of srtpu/ops/cs_conv.py:trunk_bwd_mega; its dW1,
// dW2, db1, db2 come from the weight-grad engine (wgrad.cu: the blocks as
// stacked jobs, gs read as bf16(scale * g)), one launch per conv for all
// blocks at once. Bound as the forward: 147 kFLOP per
// pixel against 512 bytes (g, h1 in; dx, dh1 out), ~290 FLOP/byte, at
// the card's bf16 ridge. The tile plan is the forward's
// (fused_block.cuh pair_backward).
__global__ void __launch_bounds__(srt::kThreads)
    resblock_bwd_kernel(const srt::bf16* __restrict__ g,
                        const srt::bf16* __restrict__ h1,
                        const srt::bf16* __restrict__ w2t,
                        const srt::bf16* __restrict__ w1t, float scale,
                        srt::bf16* __restrict__ dx,
                        srt::bf16* __restrict__ dh1_out, int H, int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  srt::fused::pair_backward(g, scale, g, h1, w2t, w1t, dx, dh1_out, H, W,
                            smem);
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
