// K2: 3x3 (and 5x5) SAME convolution + bias (+ ReLU), NHWC bf16 in and
// out, f32 accumulation.
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
//
// 5x5 (srt_conv5x5_fwd), SRResNet's tail: its 9x9 HR output conv over
// the phase-major last stage is a 5x5 phase-dense coarse conv 256 -> 16
// (w_phase_dense, ck = 5), and its dx the 16 -> 256 transposed conv. The
// same engine with 25 taps and a 2-pixel halo on 6 x 16 tiles (6 x 20
// flattened positions = 8 wmma tiles). The 256 -> 16 weight (205 KB in
// bf16) does not fit in shared memory beside the input tile (115 KB), so
// it is staged one row of 5 taps (41 KB) at a time, with a barrier
// between rows; the 16 -> 256 instance stages its whole weight (51 KB per
// 64-channel chunk). Per output pixel the forward costs 2 * 25 * 256 * 16
// = 205 kFLOP against 512 bytes read and 32 written, ~380 FLOP/byte:
// above the ridge, so the tensor cores bound it.

#include "tile_conv.cuh"

namespace {

constexpr int kTH = 7, kTW = 16;  // 7 x 18 flattened positions = 8 wmma tiles
constexpr int kTH5 = 6;           // 5x5: 6 x 20 positions = 8 wmma tiles

template <int CIN, int NB, int KK = 3, int WROWS = KK>
cudaError_t launch(const void* x, const void* w, const void* b, void* out,
                   int B, int H, int W, int cout, int relu,
                   cudaStream_t stream) {
  constexpr int TH = KK == 3 ? kTH : kTH5;
  typedef srt::ConvPlan<CIN, NB, TH, kTW, KK, WROWS> P;
  auto kernel = srt::conv3x3_kernel<CIN, NB, TH, kTW, false, false, KK, WROWS>;
  cudaError_t err = srt::allow_smem(kernel, P::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((W + kTW - 1) / kTW, (H + TH - 1) / TH, B * (cout / NB));
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

// As srt_conv3x3_fwd with w (5, 5, cin, cout): SRResNet's phase-dense
// final conv (cin = 256, cout % 16 == 0) and its transposed conv (cin =
// 16, cout % 64 == 0). Returns a cudaError_t.
extern "C" int srt_conv5x5_fwd(const void* x, const void* w, const void* b,
                               void* out, int B, int H, int W, int cin,
                               int cout, int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cin == 256 && cout % 16 == 0)
    return (int)launch<256, 16, 5, 1>(x, w, b, out, B, H, W, cout, relu, s);
  if (cin == 16 && cout % 64 == 0)
    return (int)launch<16, 64, 5, 5>(x, w, b, out, B, H, W, cout, relu, s);
  return (int)cudaErrorInvalidValue;
}
