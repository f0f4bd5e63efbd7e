// K8a: srtpu's fused NHWC EDSR resblock (its use_pallas=True route), at 64
// channels, NHWC bf16 in and out, with the activation between the convs
// kept in f32:
//   h1  = relu(conv(x, W1) + b1)                        f32
//   out = bf16((conv(h1, W2) + b2) * res_scale + x)     one rounding
// and, where the caller keeps it, bf16(h1) (the activation the backward
// reads). conv2 reads the f32 h1, not its bf16 rounding: K1 (trunk.cu)
// rounds h1 first and so cannot serve this function.
//
// Replaces srtpu/ops/resblock.py:resblock_fused_h1 (body
// _resblock_kernel_h1), behind resblock_fused_v2 / FusedResBlock, and
// resblock_fused (_resblock_kernel: the same body without h1), called
// here without h1.
//
// The f32 h1 on bf16 tensor cores. Each h1 value is carried as a pair
// hi = bf16(h1), lo = bf16(h1 - hi), and conv2 runs over both into the
// same f32 sums: conv([hi | lo], [W2; W2]). W2 holds bf16 values (srtpu
// casts the weights), so every product hi * w and lo * w is exact in
// f32, and h1 - hi - lo is below 2^-17 |h1|: the sum is the f32 conv to
// that error. TF32 (10-bit mantissa) would not be. conv1 reads bf16 x
// and W1 and needs no split.
//
// What bounds it on the H100: the function's work is 2 convs x 2 * 9 * 64
// * 64 = 147 kFLOP per pixel (2.42 GFLOP at the training shape, 16 x 32 x
// 32) against 256 bytes (x in, out out; 384 with h1): operations, 2.44 us
// a block. The lo half adds conv2 once more (1.5x the function's tensor-
// core work).
//
// The design: two launches of K2's wgmma engine (conv_sm90.cuh) a block,
// no other kernel, at K2's plan for 3x3 (8 x 16 pixel tiles, TMA-staged
// tile and weight rings, the halo from the staged tile, never recomputed):
//   conv1, 64 -> 64, at EPI 12: relu(sums + b1) split into hi and lo in
//   the epilogue, stored as one [hi | lo] pixel (B, H, W, 128) and, where
//   h1 is kept, hi alone. Only pixels inside the image are stored, so
//   conv2's TMA zero fill outside it is the SAME padding of h1.
//   conv2, 128 -> 64 over the pair with W2 stacked twice along its input
//   channels (the wrapper stacks it), at EPI 15: the bias, res_scale and
//   the skip x, out = bf16(fma(sums + b2, res_scale, x)), one rounding.
//   That is the kernel this replaces, whose (sums + b2) * scale + x nvcc
//   contracted into one fma; K7's EPI 8 (K8c's 3x3) rounds the product
//   first, and the two orders give other bits at a res_scale other than
//   1 (tools/k8a_k3_plans.py, skip order).
// h1 never reaches device memory in f32; hi and lo do, 256 bytes a pixel
// (L2 at these sizes). One host call runs L blocks (srt_resblock_f32_fwd;
// the per-block op is L = 1), the blocks in order on one stream.
//
// Measured (tools/k8a_k3_plans.py, device time of a call alone, a CUDA
// graph; NVIDIA H100 80GB HBM3 at 700 W): at the training shape a block
// saving h1 takes 0.033 ms (the wmma kernel this replaces: 0.121), 14x
// its 2.44 us bound; 16 blocks in one call 0.47-0.48 (16 calls of that
// kernel: 1.93). cuDNN's calls for a block's work (two bf16 convs, ReLU,
// the scaled skip, h1 rounded) take 0.031.

#include "conv_sm90.cuh"

namespace {

using srt90::bf16;
constexpr int kC = 64;
constexpr size_t kConvW = 9 * kC * kC;  // one 3x3 weight's elements

#define SRT_TRY(...)                       \
  do {                                     \
    cudaError_t e_ = (__VA_ARGS__);        \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)

}  // namespace

// The forward of L blocks. x (B, H, W, 64) bf16, the first block's input
// (distinct from every output); w1s (L, 3, 3, 64, 64) bf16; w2cats (L, 3,
// 3, 128, 64) bf16, each W2 stacked twice along its input channels; b1s,
// b2s (L, 64) f32; vcat (B, H, W, 128) bf16 scratch ([hi | lo]). save:
// h1s (L, B, H, W, 64) bf16 takes block i's bf16 h1 in slot i, xs (L - 1,
// B, H, W, 64) block i + 1's input in slot i (null when L = 1), out the
// last block's output. Else h1s is null, and blocks L - 1, L - 3, ...
// write out, the others xs (B, H, W, 64) (null when L = 1). Two launches a
// block. Returns a cudaError_t.
extern "C" int srt_resblock_f32_fwd(const void* x, const void* w1s,
                                    const void* b1s, const void* w2cats,
                                    const void* b2s, float scale, void* vcat,
                                    void* xs, void* h1s, void* out, int L,
                                    int save, int B, int H, int W, int C,
                                    void* stream) {
  if (C != kC || L < 1 || !vcat || (L > 1 && !xs) || (save && !h1s))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t act = (size_t)B * H * W * kC;
  bf16* const xsb = static_cast<bf16*>(xs);
  bf16* const pair = static_cast<bf16*>(vcat);
  const bf16* cur = static_cast<const bf16*>(x);
  for (int i = 0; i < L; ++i) {
    bf16* dst = save ? (i + 1 < L ? xsb + i * act : static_cast<bf16*>(out))
                     : ((L - 1 - i) % 2 ? xsb : static_cast<bf16*>(out));
    srt90::ConvArgs a = srt90::args_3x3_64(
        cur, static_cast<const bf16*>(w1s) + i * kConvW,
        static_cast<const float*>(b1s) + i * kC, pair, B, H, W);
    a.h1 = save ? static_cast<bf16*>(h1s) + i * act : nullptr;
    SRT_TRY(srt90::run_hilo(a, s));
    a = srt90::args_3x3_64(pair,
                           static_cast<const bf16*>(w2cats) + i * 2 * kConvW,
                           static_cast<const float*>(b2s) + i * kC, dst, B, H,
                           W);
    a.xps = a.cin = 2 * kC;
    a.k1.res = cur;
    a.k1.scale = scale;
    SRT_TRY(srt90::run_k8a_skip(a, s));
    cur = dst;
  }
  return 0;
}
