// K2: 3x3 (and 5x5) SAME convolution + bias (+ ReLU), NHWC bf16 in and
// out, f32 sums, at any cin and cout that are multiples of 16; and, on the
// same engine (conv_dx.cu), the dx half of its backward.
//
// Replaces, in srtpu/ops/cs_conv.py:
//   conv3x3_cs_fwd :538 (kernel body _conv_fwd_kernel :420), 3x3 and 5x5;
//   the dx of conv3x3_cs_bwd :581 (_conv_bwd_kernel :452): the transposed
//     conv of the cotangent, w[k-1-ky, k-1-kx, co, ci], summed in f32 and
//     rounded once (conv_dx.cu reads the forward weight in that order);
//   conv3x3_cs_fwd_stk :1623 and the dx of conv3x3_cs_bwd_stk :1648 (RDN's
//     dense layers, K9c: the same function per layer, with ReLU).
// The dW / db half of the backward is wgrad.cu.
//
// What bounds it on the H100 (989 TFLOP/s bf16, 3.35 TB/s; ridge ~295
// FLOP/byte). Per output pixel a conv does 2 k^2 cin cout FLOP and moves
// 2 (cin + cout) bytes, so FLOP/byte = k^2 cin cout / (cin + cout):
//   - square 64 -> 64 (EDSR, RCAN, RDN close convs; 3x3): 288, at the
//     ridge; 16 -> 256 / 256 -> 16 (3x3): 136, bytes; 5x5: 376, FLOPs;
//   - wide 64 -> 256 (phase-major), 32 -> 512 / 512 -> 32 (DDBPN), 64k ->
//     64 (K9c), 32 <-> 576 (x3 tails): 270-760, the tensor cores;
// so every class but the 3x3 16 <-> 256 pair is bound by the tensor cores,
// and the work is to keep them fed: operands staged asynchronously and
// reused from shared memory, the sums in registers.
//
// The design (conv_sm90.cuh): an implicit GEMM on wgmma (M = output
// pixels in 8 x 16 tiles, N = up to 256 output channels a block, K = taps
// x cin in 64-channel slices). Per slice one TMA load brings the tile with
// its halo, zero-filled outside the image; each tap is then a shifted
// ldmatrix of that tile straight into wgmma's register A operand (option
// (b): the shift cannot be written into a swizzled shared-memory
// descriptor, and TMA's im2col mode would reload the tile for each of the
// k^2 taps). The weights go by TMA, per (slice, tap), in their HWIO layout
// as wgmma's N-major B. One producer warp keeps both rings of stages full
// behind mbarriers while two consumer warpgroups run the wgmmas; the
// epilogue adds the bias, applies ReLU and stores bf16 from the
// accumulator registers. Where cout is small (16-64) N is small and so
// are the blocks: they run two to an SM. Where cin is also deep (256 or
// more) and the blocks would not fill the card twice (DDBPN's 512 -> 32
// and 512 -> 48, the x3 tails' 576 -> 32, RDN's dense layers at 16,384
// output pixels), a cluster of two blocks splits cin in halves and block
// 1 hands its f32 sums to block 0 through distributed shared memory: one
// launch, no workspace, and a fixed sum order, so two calls give the
// same bits.

#include "conv_sm90.cuh"

// x (B, H, W, cin) bf16; w (3, 3, cin, cout) bf16; b (cout) f32 or null;
// out (B, H, W, cout) bf16; cin and cout multiples of 16. Returns a
// cudaError_t.
extern "C" int srt_conv3x3_fwd(const void* x, const void* w, const void* b,
                               void* out, int B, int H, int W, int cin,
                               int cout, int relu, void* stream) {
  return (int)srt90::conv<false>(x, w, b, out, B, H, W, cin, cout, 3, relu,
                                 static_cast<cudaStream_t>(stream));
}

// As srt_conv3x3_fwd with w (5, 5, cin, cout): SRResNet's phase-dense
// 256 -> 16 and the x3 tail's 576 -> 32. Returns a cudaError_t.
extern "C" int srt_conv5x5_fwd(const void* x, const void* w, const void* b,
                               void* out, int B, int H, int W, int cin,
                               int cout, int relu, void* stream) {
  return (int)srt90::conv<false>(x, w, b, out, B, H, W, cin, cout, 5, relu,
                                 static_cast<cudaStream_t>(stream));
}
