// K2: 3x3 SAME convolution + bias (+ ReLU), NHWC bf16 in and out, f32
// accumulation.
//
// Replaces srtpu/ops/cs_conv.py:conv3x3_cs_fwd (kernel body
// _conv_fwd_kernel). On the EDSR path it runs three shapes: the trunk's
// close conv (64 -> 64), the phase-major last upscale conv (64 -> r*r*64)
// and the phase-dense final conv (r*r*64 -> 16).
//
// What bounds it on the H100: at 64 channels each output pixel costs
// 2 * 9 * 64 * 64 = 73.7 kFLOP against 256 bytes of input and output
// traffic, ~290 FLOP/byte -- at the card's bf16 ridge, so tensor-core
// rate and on-chip reuse decide. The 256 -> 16 conv reads 512 bytes of
// input per pixel for 147 kFLOP and writes only 32 bytes: it is bound by
// the bytes it reads. The design (tile_conv.cuh) keeps one input tile
// with its halo in shared memory, reads every input byte from device
// memory once per tile (1.4x for the halo at 7 x 16 tiles), feeds the
// tensor cores through wmma bf16 tiles and keeps the sums in f32
// registers; only the bf16 result is written. No wgmma/TMA yet.
//
// The same entry point, with no bias and the transposed weight
// w[2 - ky, 2 - kx, co, ci], is the dx half of K2's backward
// (srtpu/ops/cs_conv.py:conv3x3_cs_bwd, _conv_bwd_kernel): dx is the
// transposed conv of the cotangent, summed in f32 and rounded once. Its
// shapes on the EDSR path are 64 -> 64, 256 -> 64 and 16 -> 256 (the
// phase-dense conv's cotangent has 16 channels: the Cin = 16 instance).

#include "tile_conv.cuh"

namespace {

constexpr int kTH = 7, kTW = 16;  // 7 x 18 flattened positions = 8 wmma tiles

template <int CIN, int NB>
cudaError_t launch(const void* x, const void* w, const void* b, void* out,
                   int B, int H, int W, int cout, int relu,
                   cudaStream_t stream) {
  typedef srt::ConvPlan<CIN, NB, kTH, kTW> P;
  auto kernel = srt::conv3x3_kernel<CIN, NB, kTH, kTW, false>;
  cudaError_t err = srt::allow_smem(kernel, P::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B * (cout / NB));
  kernel<<<grid, srt::kThreads, P::SMEM, stream>>>(
      static_cast<const srt::bf16*>(x), static_cast<const srt::bf16*>(w),
      static_cast<const float*>(b), static_cast<srt::bf16*>(out), H, W, cout,
      relu, 1);
  return cudaGetLastError();
}

}  // namespace

// x (B, H, W, cin) bf16; w (3, 3, cin, cout) bf16; b (cout) f32 or null;
// out (B, H, W, cout) bf16. Supported: cin = 16 or 64 with cout % 64 == 0,
// and cin = 256 with cout % 16 == 0. Returns a cudaError_t.
extern "C" int srt_conv3x3_fwd(const void* x, const void* w, const void* b,
                               void* out, int B, int H, int W, int cin,
                               int cout, int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cin == 16 && cout % 64 == 0)
    return (int)launch<16, 64>(x, w, b, out, B, H, W, cout, relu, s);
  if (cin == 64 && cout % 64 == 0)
    return (int)launch<64, 64>(x, w, b, out, B, H, W, cout, relu, s);
  if (cin == 256 && cout % 16 == 0)
    return (int)launch<256, 16>(x, w, b, out, B, H, W, cout, relu, s);
  return (int)cudaErrorInvalidValue;
}
