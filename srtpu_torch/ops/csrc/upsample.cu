// K3: one sub-pixel upscale stage, a 3x3 conv C -> r*r*C + bias with the
// pixel shuffle folded into the store, and its backward's dx.
//
// Replaces srtpu/ops/cs_conv.py:upsample_cs_fwd (kernel body
// _ups_fwd_kernel) and the dx of upsample_cs_bwd (_ups_deint_kernel, then
// _ups_conv_bwd_kernel). The TPU kernel interleaves phases with selection
// matmuls because its lanes cannot be strided; here the conv's output
// channels are phase-major ((a*r + b)*C + c for fine pixel (r*y + a, r*x
// + b)) and the store writes each phase straight to its fine pixel, so
// the r*r*C intermediate never exists in device memory.
//
// What bounds it on the H100: per coarse pixel 2 * 9 * 64 * 256 = 295
// kFLOP against 128 bytes read and 512 bytes written (r = 2), ~460
// FLOP/byte: the tensor cores, 4.9 us at LR 128x128. The dx does the same
// conv work against 512 bytes read and 128 written a coarse pixel.
//
// The design: K2's wgmma engine (conv_sm90.cuh) at epilogues of K3's own,
// one launch each way.
//   Forward (EPI 13): the engine at 64 -> r*r*64 on the phase-major HWIO
//   weight, a block's N = 64 d channels (d = 3, 2 or 1, whichever divides
//   r: 128 at r = 2), a run of d phases of one phase row a. Those d phases
//   of coarse pixel (y, x) are fine pixels (r*y + a, r*x + b0 .. b0 + d -
//   1), one contiguous run of d*64 channels of the (B, rH, rW, 64) output
//   (seen as (B, H, r, W, r*64)): the epilogue adds the phase-major bias,
//   rounds once and stores there. The input tile is read once per block,
//   r*r / d blocks a tile.
//   dx (EPI 14): dx = sum over the r*r phases of the transposed conv of
//   each phase's cotangent, which is ONE transposed conv r*r*64 -> 64
//   over the phase-major coarse view of the fine cotangent g. The engine
//   reads operand A through a 5-D tensor map of g, (r*64, W, r, H, B)
//   (wgrad.cu's encode_fine for K3's dW): a 64-channel K slice is one
//   phase (a, b) at the tile's coarse pixels, its halo zero-filled by TMA
//   outside H x W, the coarse SAME padding; so the de-interleave is the
//   load's address and no phase-major copy of g is made. The weight is
//   the forward's phase-major HWIO weight read K-major, the taps in
//   reverse (K2's dx): no transposed copy. The f32 sum over all phases is
//   rounded once, as _ups_conv_bwd_kernel rounds it. K2's plan for 256 ->
//   64 (N = 64, a 2-block cluster splitting the phases where the blocks
//   would not fill the card twice).
// dW and db come from the weight-grad engine (wgrad.cu), which reads the
// fine cotangent phase-major through the same kind of map. A separate
// de-interleave pass before K2's dx was not built: through the map the
// dx reads g once, as that pass would, and writes no phase-major copy.
//
// Measured (tools/k8a_k3_plans.py, device time of a call alone, a CUDA
// graph; NVIDIA H100 80GB HBM3 at 700 W): the forward 0.028 ms at LR
// 128x128 and at the training shape (the wmma kernel this replaces:
// 0.140), the dx 0.022 (0.130), the backward with W 0.053 (0.165);
// cuDNN's F.conv2d + pixel shuffle 0.044, its convolution_backward 0.073.

#include "conv_sm90.cuh"

namespace {

// The operands of a K3 launch at coarse H x W: x, w (the phase-major
// HWIO weight (3, 3, 64, r*r*64)), out, cin -> cout.
srt90::ConvArgs args(const void* x, const void* w, const void* bias,
                     void* out, int B, int H, int W, int cin, int cout,
                     int r) {
  srt90::ConvArgs a = {};
  a.x = static_cast<const srt90::bf16*>(x);
  a.xps = cin;
  a.w = static_cast<const srt90::bf16*>(w);
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  a.ops = cout;
  a.B = B;
  a.H = H;
  a.W = W;
  a.cin = cin;
  a.cout = cout;
  a.kk = 3;
  a.r = r;
  a.ch.mask_chunk = -1;
  return a;
}

}  // namespace

// x (B, H, W, 64) bf16; w_pm (3, 3, 64, r*r*64) bf16 with phase-major
// output channels ((a*r + b)*64 + c); b_pm (r*r*64) f32, same order;
// out (B, r*H, r*W, 64) bf16. Supported: C = 64, r >= 2. Returns a
// cudaError_t.
extern "C" int srt_upsample_fwd(const void* x, const void* w_pm,
                                const void* b_pm, void* out, int B, int H,
                                int W, int C, int r, void* stream) {
  if (C != 64 || r < 2) return (int)cudaErrorInvalidValue;
  return (int)srt90::run_k3_fwd(args(x, w_pm, b_pm, out, B, H, W, C,
                                     r * r * C, r),
                                static_cast<cudaStream_t>(stream));
}

// g (B, r*H, r*W, C) bf16 fine cotangent; w_pm (3, 3, C, r*r*C) bf16, the
// forward's phase-major weight as it lies; dx (B, H, W, C) bf16.
// Supported: C = 64, r >= 2. Returns a cudaError_t.
extern "C" int srt_upsample_bwd_dx(const void* g, const void* w_pm,
                                   void* dx, int B, int H, int W, int C,
                                   int r, void* stream) {
  if (C != 64 || r < 2) return (int)cudaErrorInvalidValue;
  return (int)srt90::run_k3_dx(args(g, w_pm, nullptr, dx, B, H, W,
                                    r * r * C, C, r),
                               static_cast<cudaStream_t>(stream));
}
