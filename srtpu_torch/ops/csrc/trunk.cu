// K1: EDSR's resblock trunk, L blocks each way, at 64 channels, NHWC
// bf16, f32 sums. Forward, per block:
//   h1  = bf16(relu(conv(x, W1) + b1)),
//   out = bf16(f32(x) + res_scale * (conv(h1, W2) + b2)).
// Backward dx chain, per block in reverse, with g the cotangent of the
// block's output, h1 the saved activation and convT the transposed conv
// of the forward weight:
//   gs  = bf16(res_scale * f32(g)),
//   dh1 = bf16(h1 > 0 ? convT(gs, W2) : 0),
//   dx  = bf16(convT(dh1, W1) + f32(g)).
//
// Replaces srtpu/ops/cs_conv.py:trunk_fwd_mega (body
// _trunk_fwd_kernel_mega) and the dx chain of trunk_bwd_mega (body
// _trunk_bwd_kernel_mega), and with them srtpu's per-block forms of the
// same block (_rb_fwd_call_stk / _rb_bwd_call_stk behind trunk_cs;
// resblock_cs_fwd_h1 / resblock_cs_bwd behind resblock_cs). dW1, db1,
// dW2, db2 come from wgrad.cu (srtpu_torch/ops/trunk.py: the blocks as
// stacked jobs, one launch per conv, gs read as bf16(res_scale * g)).
//
// What bounds it on the H100: a block is 2 * 2 * 9 * 64 * 64 = 147 kFLOP
// per pixel against 256 bytes of the function's own traffic forward (x
// in, out; 512 when saving h1 and the block inputs), ~576 FLOP/byte, so
// the tensor cores (989 TFLOP/s bf16; ridge ~295): at the training shape
// (16 x 32 x 32) a block's 2.42 GFLOP take >= 2.44 us. The chain does the
// same conv work against g, h1 in and dx, dh1 out (512 bytes a pixel).
// On the TPU the grid's block axis runs in order on one core, so one
// kernel carries the activation through all L blocks in VMEM; on Hopper
// block l + 1 needs every neighbouring tile of block l, so the blocks are
// launches on one stream.
//
// The design: each conv is one launch of K2's wgmma engine
// (conv_sm90.cuh) at its own plan for 3x3 64 -> 64 (8 x 16 pixel tiles,
// N = 64, TMA-staged tile and weight rings, the halo from the tile and
// not recomputed); trunk.cu is the glue.
//   Forward, per block (two launches): conv1 K2's own instance
//   (srt_conv3x3_fwd, bias + ReLU) writes h1; conv2 the engine with K1's
//   epilogue (EPI 6), the bias, res_scale and the skip from x, rounded
//   once. h1 makes a round trip through device memory (L2 at these
//   sizes) between the two.
//   Chain, per block (two launches): the two transposed convs at K5's
//   EPI 5 (the forward's HWIO weights read K-major, the taps reversed:
//   no transposed copy), dh1 with h1's mask in the epilogue, then dx with
//   the skip g. At res_scale 1 gs is g bit for bit and nothing more
//   runs; otherwise a pass makes gs before each block. The other way,
//   the dx launch writing the next block's gs beside dx, measured slower
//   (PERF.md §6): a conv launch is one wave of the card's SMs at the
//   training shape, so an epilogue's extra stores sit on the critical
//   path, where a pass streams at the memory's rate.
// One host call runs a trunk each way (srt_trunk_fwd, srt_trunk_chain):
// the wrapper checks and allocates once per trunk, the tensor maps are
// encoded here per launch, and the one stream orders block after block.
//
// Measured (tools/k1_plans.py, device time of a call alone, a CUDA graph;
// NVIDIA H100 80GB HBM3 at 700 W): at the training shape a block takes
// 0.019-0.021 ms forward and 0.019 in the chain (16 blocks: 0.31-0.32
// forward, 0.30 chain, against 1.39-1.53 and 1.55 for the wmma conv pair
// this replaces), 8x the 2.44 us bound a block: each conv is one wave of
// 128 tiles on 132 SMs, at K2's rate for 64 -> 64. cuDNN's calls for the
// same forward work take 0.50 ms for 16 blocks; its two dx convs a block
// alone 0.305 (chip_smoke phase 2m).

#include "conv_sm90.cuh"

// K2's forward (conv.cu), the block's first conv.
extern "C" int srt_conv3x3_fwd(const void* x, const void* w, const void* b,
                               void* out, int B, int H, int W, int cin,
                               int cout, int relu, void* stream);

namespace {

using srt90::bf16;
constexpr int kC = 64;
constexpr size_t kConvW = 9 * kC * kC;  // one 3x3 weight's elements

// gs = bf16(scale * f32(g)), 8 channels a thread.
__global__ void trunk_gs_kernel(const bf16* __restrict__ g, float scale,
                                bf16* __restrict__ gs, long long nvec) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < nvec; i += (long long)gridDim.x * blockDim.x) {
    float v[8];
    srt90::unpack8(reinterpret_cast<const uint4*>(g)[i], v);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] *= scale;
    reinterpret_cast<uint4*>(gs)[i] = srt90::pack8(v);
  }
}

cudaError_t gs_pass(const bf16* g, float scale, bf16* gs, long long nvec,
                    cudaStream_t s) {
  const long long want = (nvec + 255) / 256;
  trunk_gs_kernel<<<(int)(want < (1 << 20) ? want : (1 << 20)), 256, 0, s>>>(
      g, scale, gs, nvec);
  return cudaGetLastError();
}

#define SRT_TRY(...)                       \
  do {                                     \
    cudaError_t e_ = (__VA_ARGS__);        \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)

}  // namespace

// The forward of L blocks. x (B, H, W, 64) bf16, the trunk's input; w1,
// w2 (L, 3, 3, 64, 64) bf16; b1, b2 (L, 64) f32. save: xs, h1 (L, B, H,
// W, 64) bf16 take block i's input and h1 in slot i (xs[0] a copy of x),
// out the last block's output. Else h1 (B, H, W, 64) is scratch, and
// blocks L - 1, L - 3, ... write out, the others xs (B, H, W, 64) (null
// when L = 1). Two launches a block. Returns a cudaError_t.
extern "C" int srt_trunk_fwd(const void* x, const void* w1, const void* b1,
                             const void* w2, const void* b2, float scale,
                             void* xs, void* h1, void* out, int L, int save,
                             int B, int H, int W, int C, void* stream) {
  if (C != kC || L < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t act = (size_t)B * H * W * kC;
  bf16* const xsb = static_cast<bf16*>(xs);
  if (save)
    SRT_TRY(cudaMemcpyAsync(xsb, x, act * sizeof(bf16),
                            cudaMemcpyDeviceToDevice, s));
  const bf16* cur = static_cast<const bf16*>(x);
  for (int i = 0; i < L; ++i) {
    bf16* h1i = static_cast<bf16*>(h1) + (save ? i * act : 0);
    bf16* dst = save ? (i + 1 < L ? xsb + (i + 1) * act
                                  : static_cast<bf16*>(out))
                     : ((L - 1 - i) % 2 ? xsb : static_cast<bf16*>(out));
    SRT_TRY((cudaError_t)srt_conv3x3_fwd(
        cur, static_cast<const bf16*>(w1) + i * kConvW,
        static_cast<const float*>(b1) + i * kC, h1i, B, H, W, kC, kC, 1,
        stream));
    srt90::ConvArgs a = srt90::args_3x3_64(
        h1i, static_cast<const bf16*>(w2) + i * kConvW,
        static_cast<const float*>(b2) + i * kC, dst, B, H, W);
    a.k1.res = cur;
    a.k1.scale = scale;
    SRT_TRY((srt90::run_3x3_64<false, 6>(a, s)));
    cur = dst;
  }
  return 0;
}

// The dx chain of L blocks, the last first, without the weight grads.
// h1 (L, B, H, W, 64) bf16, the saved activations; g (B, H, W, 64) bf16,
// the cotangent of block L - 1's output; w1, w2 (L, 3, 3, 64, 64) bf16,
// the forward weights (the engine reads them transposed). Writes block
// i's output cotangent into gbuf (L, B, H, W, 64) bf16 slot i (slot L -
// 1 a copy of g; the weight grads read them all), dh1 (L, B, H, W, 64)
// bf16, and block 0's input cotangent into dx (B, H, W, 64). gs (B, H, W,
// 64) bf16 is scratch where scale is not 1, else null. Two launches a
// block, and a gs pass where scale is not 1. Returns a cudaError_t.
extern "C" int srt_trunk_chain(const void* h1, const void* g, const void* w1,
                               const void* w2, float scale, void* gbuf,
                               void* dh1, void* gs, void* dx, int L, int B,
                               int H, int W, int C, void* stream) {
  const bool scaled = scale != 1.0f;
  if (C != kC || L < 1 || (scaled && !gs)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t act = (size_t)B * H * W * kC;
  const long long nvec = (long long)act / 8;
  bf16* const gb = static_cast<bf16*>(gbuf);
  bf16* const gsb = static_cast<bf16*>(gs);
  SRT_TRY(cudaMemcpyAsync(gb + (L - 1) * act, g, act * sizeof(bf16),
                          cudaMemcpyDeviceToDevice, s));
  for (int i = L - 1; i >= 0; --i) {
    const bf16* gi = gb + i * act;
    bf16* dh1i = static_cast<bf16*>(dh1) + i * act;
    if (scaled) SRT_TRY(gs_pass(gi, scale, gsb, nvec, s));
    srt90::ConvArgs a = srt90::args_3x3_64(
        scaled ? gsb : gi, static_cast<const bf16*>(w2) + i * kConvW,
        nullptr, dh1i, B, H, W);
    a.k5.h = static_cast<const bf16*>(h1) + i * act;
    SRT_TRY((srt90::run_3x3_64<true, 5>(a, s)));
    bf16* gout = i ? gb + (i - 1) * act : static_cast<bf16*>(dx);
    a = srt90::args_3x3_64(dh1i, static_cast<const bf16*>(w1) + i * kConvW,
                           nullptr, gout, B, H, W);
    a.k5.res = gi;
    SRT_TRY((srt90::run_3x3_64<true, 5>(a, s)));
  }
  return 0;
}

// gs = bf16(scale * f32(g)) over n bf16 values (a multiple of 8): the
// chain's gs pass, which K7's backward (wdsr.cu) runs as well. Returns a
// cudaError_t.
extern "C" int srt_gs_pass(const void* g, float scale, void* gs, long long n,
                           void* stream) {
  return (int)gs_pass(static_cast<const bf16*>(g), scale,
                      static_cast<bf16*>(gs), n / 8,
                      static_cast<cudaStream_t>(stream));
}
