// K2's backward dx: the transposed conv of the cotangent, on the engine of
// conv_sm90.cuh with its weight operand read from the forward's HWIO
// weight itself (K-major, the taps in reverse order), so no transposed
// copy of the weight is made. Replaces the dx half of
// srtpu/ops/cs_conv.py:conv3x3_cs_bwd :581 (_conv_bwd_kernel :452) and
// of conv3x3_cs_bwd_stk :1648; conv.cu's head note says what bounds it.
// Its own file so that nvcc builds these instances beside conv.cu's.

#include "conv_sm90.cuh"

// g (B, H, W, cin) bf16, the cotangent of a k x k SAME conv's output
// (k = 3 or 5) whose weight is w (k, k, cout, cin) bf16 HWIO; dx (B, H,
// W, cout) bf16 = the f32 sum over taps and cin of g (shifted) times
// w[k-1-ky, k-1-kx, co, ci], rounded once. cin and cout multiples of 16.
// Returns a cudaError_t.
extern "C" int srt_conv_dx(const void* g, const void* w, void* dx, int B,
                           int H, int W, int cin, int cout, int kk,
                           void* stream) {
  return (int)srt90::conv<true>(g, w, nullptr, dx, B, H, W, cin, cout, kk, 0,
                                static_cast<cudaStream_t>(stream));
}
