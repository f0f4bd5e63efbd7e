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
//
// The general path (srt_conv3x3_fwd / srt_conv5x5_fwd at any other cin
// and cout that are multiples of 16; conv_chunked_kernel) serves DDBPN's
// back-projections, which srtpu runs as K2 calls over phase-major
// channels (srtpu/models/ddbpn.py:185-192, :333-335): at nr = 32 and x4
// the up convs are 32 -> 512, the down convs 512 -> 32, the output conv
// 512 -> 48 per HR block, and their dx the reverse; at x2 32 <-> 128 and
// 128 -> 16. EDSR's and SRResNet's x3 tails add 576 -> 32 at 3x3 and 5x5
// (and 32 -> 576 for dx). At c_in 512 the 9 x 18-pixel input tile alone
// takes 162 KB and the 3x3 weights of 512 -> 48 432 KB, past the 227 KB a
// block can have, so the block walks c_in in chunks of CK (64, 32 or 16)
// channels: it stages one chunk's tile (load_tile with the pixel stride
// cin) and that chunk's weights (WROWS rows of taps at a time; 5x5 one row
// of 5 taps), adds them into the same f32 accumulators in registers, and
// rounds once after the last chunk, as K6 walks its concat buffer
// (rdn.cu). Per output pixel 32 -> 512 costs 295 kFLOP against 64 bytes
// read and 1 KB written (~290 FLOP/byte, at the ridge); 512 -> 32 reads
// 1 KB for the same FLOPs. The existing instances (c_in 16, 64, 256) keep
// their own code.

#include "tile_conv.cuh"

namespace {

constexpr int kTH = 7, kTW = 16;  // 7 x 18 flattened positions = 8 wmma tiles
constexpr int kTH5 = 6;           // 5x5: 6 x 20 positions = 8 wmma tiles

// Copy output columns [n0, n0 + NB) of the rows of one CK-channel chunk of
// TAPS taps of an HWIO weight with cin input channels (w points at the
// first tap's first row of the chunk) into dst as (TAPS * CK, NB)
// row-major: row tap * CK + k is w's row tap * cin + k.
template <int CK, int NB, int TAPS>
__device__ __forceinline__ void load_weights_chunk(
    srt::bf16* __restrict__ dst, const srt::bf16* __restrict__ w, int cin,
    int cout, int n0) {
  constexpr int VEC = NB / 8;
  constexpr int total = TAPS * CK * VEC;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int row = i / VEC, v = i % VEC;
    const int tap = row / CK, k = row % CK;
    *reinterpret_cast<uint4*>(dst + (size_t)row * NB + v * 8) =
        *reinterpret_cast<const uint4*>(w + ((size_t)tap * cin + k) * cout +
                                        n0 + v * 8);
  }
}

// One KK x KK SAME conv + bias (+ ReLU) over an NHWC batch with cin input
// channels, cin % CK == 0, walked CK channels at a time. grid and out as
// conv3x3_kernel (SHUFFLE = false); the plan is its ConvPlan at CK.
template <int CK, int NB, int TH, int TW, int KK, int WROWS>
__global__ void __launch_bounds__(srt::kThreads)
    conv_chunked_kernel(const srt::bf16* __restrict__ x,
                        const srt::bf16* __restrict__ w,
                        const float* __restrict__ bias,
                        srt::bf16* __restrict__ out, int H, int W, int cin,
                        int cout, int relu) {
  typedef srt::ConvPlan<CK, NB, TH, TW, KK, WROWS> P;
  using srt::bf16;
  constexpr int HALO = KK / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ws = reinterpret_cast<bf16*>(smem + P::XS);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* scr = reinterpret_cast<float*>(smem + P::XS + P::WS) + warp * 256;

  const int nchunks = cout / NB;
  const int b = blockIdx.z / nchunks, chunk = blockIdx.z % nchunks;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;

  srt::AccFrag acc[P::MT][NB / 16];
#pragma unroll
  for (int t = 0; t < P::MT; ++t)
#pragma unroll
    for (int n = 0; n < NB / 16; ++n)
      nvcuda::wmma::fill_fragment(acc[t][n], 0.0f);
  for (int c0 = 0; c0 < cin; c0 += CK) {
    if (c0) __syncthreads();  // every warp is done with the last chunk
    srt::load_tile<CK>(xs, x + c0, b, H, W, y0 - HALO, x0 - HALO,
                       TH + KK - 1, P::WX, P::NPIX, 1.0f, cin);
    for (int ky0 = 0; ky0 < KK; ky0 += WROWS) {
      if (ky0) __syncthreads();  // every warp is done with the last rows
      load_weights_chunk<CK, NB, WROWS * KK>(
          ws, w + ((size_t)ky0 * KK * cin + c0) * cout, cin, cout,
          chunk * NB);
      __syncthreads();
#pragma unroll
      for (int t = 0; t < P::MT; ++t) {
        const int mf = warp + t * srt::kWarps;
        if (mf < P::MF)
          srt::mma_taps<CK, NB, KK, WROWS>(acc[t], xs, ws, mf * 16, P::WX,
                                           ky0);
      }
    }
  }

#pragma unroll
  for (int t = 0; t < P::MT; ++t) {
    const int mf = warp + t * srt::kWarps;
    if (mf >= P::MF) continue;
    const int p = mf * 16 + (lane >> 1);
    const int oy = p / P::WX, ox = p % P::WX;
    const int gy = y0 + oy, gx = x0 + ox;
    const bool valid = oy < TH && ox < TW && gy < H && gx < W;
#pragma unroll
    for (int n = 0; n < NB / 16; ++n) {
      float v[8];
      srt::lane_values(scr, acc[t][n], lane, v);
      if (!valid) continue;
      const int c = chunk * NB + n * 16 + (lane & 1) * 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (bias) v[j] += bias[c + j];
        if (relu) v[j] = fmaxf(v[j], 0.0f);
      }
      *reinterpret_cast<uint4*>(out + (((size_t)b * H + gy) * W + gx) * cout +
                                c) = srt::pack8(v);
    }
  }
}

template <int CK, int NB, int KK, int WROWS>
cudaError_t launch_chunked(const void* x, const void* w, const void* b,
                           void* out, int B, int H, int W, int cin, int cout,
                           int relu, cudaStream_t stream) {
  constexpr int TH = KK == 3 ? kTH : kTH5;
  typedef srt::ConvPlan<CK, NB, TH, kTW, KK, WROWS> P;
  auto kernel = conv_chunked_kernel<CK, NB, TH, kTW, KK, WROWS>;
  cudaError_t err = srt::allow_smem(kernel, P::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((W + kTW - 1) / kTW, (H + TH - 1) / TH, B * (cout / NB));
  kernel<<<grid, srt::kThreads, P::SMEM, stream>>>(
      static_cast<const srt::bf16*>(x), static_cast<const srt::bf16*>(w),
      static_cast<const float*>(b), static_cast<srt::bf16*>(out), H, W, cin,
      cout, relu);
  return cudaGetLastError();
}

// The general path at CK: NB = 64, 32 or 16, the largest that divides cout.
template <int CK, int KK, int WROWS>
cudaError_t chunked_nb(const void* x, const void* w, const void* b, void* out,
                       int B, int H, int W, int cin, int cout, int relu,
                       cudaStream_t s) {
  if (cout % 64 == 0)
    return launch_chunked<CK, 64, KK, WROWS>(x, w, b, out, B, H, W, cin, cout,
                                             relu, s);
  if (cout % 32 == 0)
    return launch_chunked<CK, 32, KK, WROWS>(x, w, b, out, B, H, W, cin, cout,
                                             relu, s);
  return launch_chunked<CK, 16, KK, WROWS>(x, w, b, out, B, H, W, cin, cout,
                                           relu, s);
}

// The general path: cin and cout multiples of 16; CK = 64 (3x3 only), 32
// or 16, the largest that divides cin. 5x5 stages one row of taps at a
// time (25 taps of a 32 x 64 chunk would take 102 KB).
template <int KK>
cudaError_t chunked(const void* x, const void* w, const void* b, void* out,
                    int B, int H, int W, int cin, int cout, int relu,
                    cudaStream_t s) {
  constexpr int WROWS = KK == 3 ? 3 : 1;
  if (cin % 16 || cout % 16) return cudaErrorInvalidValue;
  if constexpr (KK == 3) {
    if (cin % 64 == 0)
      return chunked_nb<64, KK, WROWS>(x, w, b, out, B, H, W, cin, cout, relu,
                                       s);
  }
  if (cin % 32 == 0)
    return chunked_nb<32, KK, WROWS>(x, w, b, out, B, H, W, cin, cout, relu,
                                     s);
  return chunked_nb<16, KK, WROWS>(x, w, b, out, B, H, W, cin, cout, relu, s);
}

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
// out (B, H, W, cout) bf16. cin = 16 or 64 with cout % 64 == 0, and cin =
// 256 with cout % 16 == 0, run their own instances; any other cin and
// cout that are multiples of 16 the general path. Returns a cudaError_t.
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
  return (int)chunked<3>(x, w, b, out, B, H, W, cin, cout, relu, s);
}

// As srt_conv3x3_fwd with w (5, 5, cin, cout): SRResNet's phase-dense
// final conv (cin = 256, cout % 16 == 0) and its transposed conv (cin =
// 16, cout % 64 == 0) run their own instances; any other multiples of 16
// (576 -> 32 at x3 and its 32 -> 576 dx) the general path. Returns a
// cudaError_t.
extern "C" int srt_conv5x5_fwd(const void* x, const void* w, const void* b,
                               void* out, int B, int H, int W, int cin,
                               int cout, int relu, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cin == 256 && cout % 16 == 0)
    return (int)launch<256, 16, 5, 1>(x, w, b, out, B, H, W, cout, relu, s);
  if (cin == 16 && cout % 64 == 0)
    return (int)launch<16, 64, 5, 5>(x, w, b, out, B, H, W, cout, relu, s);
  return (int)chunked<5>(x, w, b, out, B, H, W, cin, cout, relu, s);
}
