// Shared building blocks of the port's 3x3 (and 5x5) convolution kernels
// (sm_90a).
//
// Layout: activations are NHWC bf16, weights HWIO bf16 (k, k, Cin, Cout),
// biases f32. A block computes one output tile of TH x TW pixels of one
// image as an implicit GEMM on the tensor cores (nvcuda::wmma, bf16 in,
// f32 accumulate):
//
//   out[p, n] = sum_{tap, k} X[p + tap_offset, k] * W[tap, k, n]
//
// The input tile (with its halo) is staged in shared memory as a
// flattened run of pixels whose row width WX is the tile width plus the
// halo. Output position p = oy * WX + ox then reads input pixel
// p + ty * WX + tx for tap (ty, tx): every tap is a constant pixel offset,
// so any 16 consecutive positions form one wmma A tile with a constant
// row stride. Positions with ox >= TW (the halo columns) are computed and
// discarded; the slack pixels past the tile are zero.
//
// Shared-memory pixel stride is Cin + 16 bf16: a multiple of 16 elements
// keeps every wmma pointer 32-byte aligned, and the extra 32 bytes spread
// consecutive pixels over the banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace srt {

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> AccFrag;
typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> AFrag;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> BFrag;

__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }
__host__ __device__ constexpr size_t align128(size_t n) {
  return (n + 127) / 128 * 128;
}

__device__ __forceinline__ uint4 pack8(const float (&v)[8]) {
  uint4 u;
  uint32_t* w = reinterpret_cast<uint32_t*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    __nv_bfloat162 t = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
    w[j] = *reinterpret_cast<uint32_t*>(&t);
  }
  return u;
}

__device__ __forceinline__ void unpack8(uint4 u, float (&v)[8]) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(&u);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    __nv_bfloat162 t = *reinterpret_cast<const __nv_bfloat162*>(&w[j]);
    float2 f = __bfloat1622float2(t);
    v[2 * j] = f.x;
    v[2 * j + 1] = f.y;
  }
}

// bf16(scale * v) for the 8 bf16 values of v.
__device__ __forceinline__ uint4 scale8(uint4 u, float scale) {
  float v[8];
  unpack8(u, v);
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] *= scale;
  return pack8(v);
}

// The source index of position i of a line of n >= 2 pixels under
// REFLECT boundaries (torch ReflectionPad2d(1)): -1 -> 1, n -> n - 2, the
// inside as it is; -1 (no pixel: zero) farther out, where a halo feeds
// only outputs past the image.
__device__ __forceinline__ int mirror1(int i, int n) {
  if (i == -1) return 1;
  if (i == n) return n - 2;
  return i >= 0 && i < n ? i : -1;
}

// Copy the (rows x wx) NHWC window of image b whose top-left pixel is
// (y0, x0) into dst as npix flattened pixels of stride CIN + 16. Pixels
// outside the image are zero (SAME padding), or with REFLECT the one-pixel
// ring around the image holds the mirrored pixel (mirror1; H, W >= 2);
// the slack past rows * wx is zero. scale != 1 stores bf16(scale * x)
// instead of x. ps is x's pixel stride in elements: CIN for a tensor of
// CIN channels, more for a CIN-channel slice of a wider one (RDN's concat
// buffer).
template <int CIN, bool REFLECT = false>
__device__ __forceinline__ void load_tile(bf16* __restrict__ dst,
                                          const bf16* __restrict__ x, int b,
                                          int H, int W, int y0, int x0,
                                          int rows, int wx, int npix,
                                          float scale = 1.0f, int ps = CIN) {
  constexpr int PS = CIN + 16;
  constexpr int VEC = CIN / 8;  // 16-byte vectors per pixel
  const int total = npix * VEC;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int p = i / VEC, v = i % VEC;
    const int ly = p / wx, lx = p % wx;
    int gy = y0 + ly, gx = x0 + lx;
    if (REFLECT) {
      gy = mirror1(gy, H);
      gx = mirror1(gx, W);
    }
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (ly < rows && gy >= 0 && gy < H && gx >= 0 && gx < W) {
      val = *reinterpret_cast<const uint4*>(
          x + (((size_t)b * H + gy) * W + gx) * ps + v * 8);
      if (scale != 1.0f) val = scale8(val, scale);
    }
    *reinterpret_cast<uint4*>(dst + (size_t)p * PS + v * 8) = val;
  }
}

// load_tile for the phase-major coarse view of a fine NHWC tensor xf
// (B, r*H, r*W, CIN / (r*r)): coarse pixel (gy, gx), channel
// (a*r + b)*c + k is fine pixel (r*gy + a, r*gx + b), channel k. This
// is the gather of srtpu's _ups_deint_kernel, done while loading.
template <int CIN>
__device__ __forceinline__ void load_tile_gather(bf16* __restrict__ dst,
                                                 const bf16* __restrict__ xf,
                                                 int b, int H, int W, int y0,
                                                 int x0, int rows, int wx,
                                                 int npix, int r) {
  constexpr int PS = CIN + 16;
  constexpr int VEC = CIN / 8;
  const int c = CIN / (r * r);
  const int total = npix * VEC;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int p = i / VEC, v = i % VEC;
    const int ly = p / wx, lx = p % wx;
    const int gy = y0 + ly, gx = x0 + lx;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (ly < rows && gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const int ab = v * 8 / c, k = v * 8 % c;
      val = *reinterpret_cast<const uint4*>(
          xf + (((size_t)b * H * r + (size_t)gy * r + ab / r) * W * r +
                (size_t)gx * r + ab % r) * c + k);
    }
    *reinterpret_cast<uint4*>(dst + (size_t)p * PS + v * 8) = val;
  }
}

// Copy output columns [n0, n0 + NB) of TAPS taps of an HWIO weight
// (TAPS * CIN rows of cout, from w) into dst as (TAPS * CIN, NB)
// row-major.
template <int CIN, int NB, int TAPS = 9>
__device__ __forceinline__ void load_weights(bf16* __restrict__ dst,
                                             const bf16* __restrict__ w,
                                             int cout, int n0) {
  constexpr int VEC = NB / 8;
  constexpr int total = TAPS * CIN * VEC;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int row = i / VEC, v = i % VEC;
    *reinterpret_cast<uint4*>(dst + (size_t)row * NB + v * 8) =
        *reinterpret_cast<const uint4*>(w + (size_t)row * cout + n0 + v * 8);
  }
}

// acc[n] += the taps of rows ky0 .. ky0 + ROWS - 1 of a KK x KK conv of
// the staged tile xs at the 16 flattened positions starting at p0, for
// output columns [16 n, 16 n + 16) of the staged weights ws (those rows'
// ROWS * KK taps). Taps in row-major order, then input channels.
template <int CIN, int NB, int KK, int ROWS>
__device__ __forceinline__ void mma_taps(AccFrag (&acc)[NB / 16],
                                         const bf16* __restrict__ xs,
                                         const bf16* __restrict__ ws, int p0,
                                         int wx, int ky0) {
  constexpr int PS = CIN + 16;
#pragma unroll 1
  for (int tap = 0; tap < ROWS * KK; ++tap) {
    const bf16* a_base =
        xs + (size_t)(p0 + (ky0 + tap / KK) * wx + tap % KK) * PS;
    const bf16* b_base = ws + (size_t)tap * CIN * NB;
#pragma unroll
    for (int k0 = 0; k0 < CIN; k0 += 16) {
      AFrag a;
      wmma::load_matrix_sync(a, a_base + k0, PS);
#pragma unroll
      for (int n = 0; n < NB / 16; ++n) {
        BFrag bw;
        wmma::load_matrix_sync(bw, b_base + (size_t)k0 * NB + n * 16, NB);
        wmma::mma_sync(acc[n], a, bw, acc[n]);
      }
    }
  }
}

// acc[n] = 3x3 conv of the staged tile xs at the 16 flattened positions
// starting at p0, for output columns [16 n, 16 n + 16) of the staged
// weights ws (all 9 taps).
template <int CIN, int NB>
__device__ __forceinline__ void mma_3x3(AccFrag (&acc)[NB / 16],
                                        const bf16* __restrict__ xs,
                                        const bf16* __restrict__ ws, int p0,
                                        int wx) {
#pragma unroll
  for (int n = 0; n < NB / 16; ++n) wmma::fill_fragment(acc[n], 0.0f);
  mma_taps<CIN, NB, 3, 3>(acc, xs, ws, p0, wx, 0);
}

// Stage one 16x16 accumulator in the warp's f32 scratch and hand back the
// 8 values this lane owns: row lane / 2, columns 8 * (lane % 2) .. +7.
__device__ __forceinline__ void lane_values(float* __restrict__ scr,
                                            const AccFrag& acc, int lane,
                                            float (&v)[8]) {
  wmma::store_matrix_sync(scr, acc, 16, wmma::mem_row_major);
  __syncwarp();
  const float* src = scr + (lane >> 1) * 16 + (lane & 1) * 8;
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = src[j];
  __syncwarp();
}

// Dynamic shared memory above 48 KB needs an opt-in per kernel.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Shared-memory plan of conv3x3_kernel: a KK x KK conv (KK = 3 or 5)
// whose weights are staged WROWS rows of taps at a time.
template <int CIN, int NB, int TH, int TW, int KK = 3, int WROWS = KK>
struct ConvPlan {
  static_assert(KK % 2 == 1 && KK % WROWS == 0, "odd taps, whole rows");
  static constexpr int PS = CIN + 16;
  static constexpr int WX = TW + KK - 1;           // tile + (KK / 2) halo
  static constexpr int MF = (TH * WX + 15) / 16;   // 16-row wmma tiles
  static constexpr int MT = (MF + kWarps - 1) / kWarps;  // tiles per warp
  // + the reads of the last tap (KK - 1, KK - 1)
  static constexpr int NPIX = MF * 16 + (KK - 1) * (WX + 1);
  static constexpr size_t XS = align128((size_t)NPIX * PS * 2);
  static constexpr size_t WS = align128((size_t)WROWS * KK * CIN * NB * 2);
  static constexpr size_t SCR = (size_t)kWarps * 256 * 4;
  static constexpr size_t SMEM = XS + WS + SCR;
};

// One KK x KK SAME conv + bias (+ ReLU) over an NHWC image batch (KK = 3
// unless given; 5 for SRResNet's phase-dense final conv). bias may be
// null (no bias: the transposed convs of the backward passes). The
// weights are staged WROWS rows of taps at a time (fewer than KK where
// the whole weight would not fit beside the tile), each warp keeping its
// tiles' sums in registers across the rows.
//
// grid = (ceil(W / TW), ceil(H / TH), B * cout / NB); block z covers image
// z / (cout / NB) and the NB output channels of chunk z % (cout / NB).
// SHUFFLE = false: out is NHWC (B, H, W, cout).
// SHUFFLE = true: the weight's output channels are phase-major
// ((a * r + b) * NB + c) and chunk j = a * r + b is stored straight to
// fine pixel (r * y + a, r * x + b) of out (B, r H, r W, NB): the pixel
// shuffle is the store's indexing.
// GATHER = true: x is a fine NHWC tensor (B, r H, r W, CIN / (r r)) read
// as its phase-major coarse view (load_tile_gather); H, W are coarse.
template <int CIN, int NB, int TH, int TW, bool SHUFFLE, bool GATHER = false,
          int KK = 3, int WROWS = KK>
__global__ void __launch_bounds__(kThreads)
    conv3x3_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                   const float* __restrict__ bias, bf16* __restrict__ out,
                   int H, int W, int cout, int relu, int r) {
  typedef ConvPlan<CIN, NB, TH, TW, KK, WROWS> P;
  constexpr int HALO = KK / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ws = reinterpret_cast<bf16*>(smem + P::XS);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* scr = reinterpret_cast<float*>(smem + P::XS + P::WS) + warp * 256;

  const int nchunks = cout / NB;
  const int b = blockIdx.z / nchunks, chunk = blockIdx.z % nchunks;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;

  if (GATHER)
    load_tile_gather<CIN>(xs, x, b, H, W, y0 - HALO, x0 - HALO, TH + KK - 1,
                          P::WX, P::NPIX, r);
  else
    load_tile<CIN>(xs, x, b, H, W, y0 - HALO, x0 - HALO, TH + KK - 1, P::WX,
                   P::NPIX);
  AccFrag acc[P::MT][NB / 16];
#pragma unroll
  for (int t = 0; t < P::MT; ++t)
#pragma unroll
    for (int n = 0; n < NB / 16; ++n) wmma::fill_fragment(acc[t][n], 0.0f);
  for (int ky0 = 0; ky0 < KK; ky0 += WROWS) {
    if (ky0) __syncthreads();  // every warp is done with the previous rows
    load_weights<CIN, NB, WROWS * KK>(ws, w + (size_t)ky0 * KK * CIN * cout,
                                      cout, chunk * NB);
    __syncthreads();
#pragma unroll
    for (int t = 0; t < P::MT; ++t) {
      const int mf = warp + t * kWarps;
      if (mf < P::MF)
        mma_taps<CIN, NB, KK, WROWS>(acc[t], xs, ws, mf * 16, P::WX, ky0);
    }
  }

#pragma unroll
  for (int t = 0; t < P::MT; ++t) {
    const int mf = warp + t * kWarps;
    if (mf >= P::MF) continue;
    const int p = mf * 16 + (lane >> 1);
    const int oy = p / P::WX, ox = p % P::WX;
    const int gy = y0 + oy, gx = x0 + ox;
    const bool valid = oy < TH && ox < TW && gy < H && gx < W;
#pragma unroll
    for (int n = 0; n < NB / 16; ++n) {
      float v[8];
      lane_values(scr, acc[t][n], lane, v);
      if (!valid) continue;
      const int c0 = n * 16 + (lane & 1) * 8;  // channel within the chunk
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (bias) v[j] += bias[chunk * NB + c0 + j];
        if (relu) v[j] = fmaxf(v[j], 0.0f);
      }
      bf16* dst;
      if (SHUFFLE) {
        const int a = chunk / r, bb = chunk % r;
        dst = out + (((size_t)b * H * r + gy * r + a) * ((size_t)W * r) +
                     (size_t)gx * r + bb) * NB + c0;
      } else {
        dst = out + (((size_t)b * H + gy) * W + gx) * cout + chunk * NB + c0;
      }
      *reinterpret_cast<uint4*>(dst) = pack8(v);
    }
  }
}

// Copy output columns [n0, n0 + NB) of the rows of one CK-channel chunk of
// TAPS taps of an HWIO weight with cin input channels (w points at the
// first tap's first row of the chunk) into dst as (TAPS * CK, NB)
// row-major: row tap * CK + k is w's row tap * cin + k.
template <int CK, int NB, int TAPS>
__device__ __forceinline__ void load_weights_chunk(bf16* __restrict__ dst,
                                                   const bf16* __restrict__ w,
                                                   int cin, int cout, int n0) {
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

// The chunked-input conv: one KK x KK SAME conv over an NHWC batch with
// any cin % CK == 0, walked CK channels at a time. Each chunk's tile
// (load_tile with the pixel stride cin; in_scale != 1 stages bf16(in_scale
// * x)) and that chunk's weights (WROWS rows of taps at a time) are added
// into the same f32 accumulators in registers, so the result is summed
// once over all of cin. K2's general path (conv.cu) and K7's 3x3 and dh2
// (wdsr.cu) share it; they differ only in the epilogue: epi(v, at, co)
// receives the 8 f32 sums v of output channels co .. co + 7 of the pixel
// whose first output element is at - co in the NHWC (B, H, W, cout)
// output, and stores them. grid and chunks as conv3x3_kernel (SHUFFLE =
// false); the plan is its ConvPlan at CK.
template <int CK, int NB, int TH, int TW, int KK, int WROWS, class Epi>
__global__ void __launch_bounds__(kThreads)
    conv_chunked_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                        Epi epi, float in_scale, int H, int W, int cin,
                        int cout) {
  typedef ConvPlan<CK, NB, TH, TW, KK, WROWS> P;
  constexpr int HALO = KK / 2;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ws = reinterpret_cast<bf16*>(smem + P::XS);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* scr = reinterpret_cast<float*>(smem + P::XS + P::WS) + warp * 256;

  const int nchunks = cout / NB;
  const int b = blockIdx.z / nchunks, chunk = blockIdx.z % nchunks;
  const int y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;

  AccFrag acc[P::MT][NB / 16];
#pragma unroll
  for (int t = 0; t < P::MT; ++t)
#pragma unroll
    for (int n = 0; n < NB / 16; ++n) wmma::fill_fragment(acc[t][n], 0.0f);
  for (int c0 = 0; c0 < cin; c0 += CK) {
    if (c0) __syncthreads();  // every warp is done with the last chunk
    load_tile<CK>(xs, x + c0, b, H, W, y0 - HALO, x0 - HALO, TH + KK - 1,
                  P::WX, P::NPIX, in_scale, cin);
    for (int ky0 = 0; ky0 < KK; ky0 += WROWS) {
      if (ky0) __syncthreads();  // every warp is done with the last rows
      load_weights_chunk<CK, NB, WROWS * KK>(
          ws, w + ((size_t)ky0 * KK * cin + c0) * cout, cin, cout,
          chunk * NB);
      __syncthreads();
#pragma unroll
      for (int t = 0; t < P::MT; ++t) {
        const int mf = warp + t * kWarps;
        if (mf < P::MF)
          mma_taps<CK, NB, KK, WROWS>(acc[t], xs, ws, mf * 16, P::WX, ky0);
      }
    }
  }

#pragma unroll
  for (int t = 0; t < P::MT; ++t) {
    const int mf = warp + t * kWarps;
    if (mf >= P::MF) continue;
    const int p = mf * 16 + (lane >> 1);
    const int oy = p / P::WX, ox = p % P::WX;
    const int gy = y0 + oy, gx = x0 + ox;
    const bool valid = oy < TH && ox < TW && gy < H && gx < W;
#pragma unroll
    for (int n = 0; n < NB / 16; ++n) {
      float v[8];
      lane_values(scr, acc[t][n], lane, v);
      if (!valid) continue;
      const int co = chunk * NB + n * 16 + (lane & 1) * 8;
      epi(v, (((size_t)b * H + gy) * W + gx) * cout + co, co);
    }
  }
}

template <int CK, int NB, int KK, int WROWS, class Epi>
cudaError_t launch_chunked(const bf16* x, const bf16* w, Epi epi,
                           float in_scale, int B, int H, int W, int cin,
                           int cout, cudaStream_t stream) {
  // 3x3: 7 x 18 flattened positions = 8 wmma tiles; 5x5: 6 x 20
  constexpr int TH = KK == 3 ? 7 : 6, TW = 16;
  typedef ConvPlan<CK, NB, TH, TW, KK, WROWS> P;
  auto kernel = conv_chunked_kernel<CK, NB, TH, TW, KK, WROWS, Epi>;
  cudaError_t err = allow_smem(kernel, P::SMEM);
  if (err != cudaSuccess) return err;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B * (cout / NB));
  kernel<<<grid, kThreads, P::SMEM, stream>>>(x, w, epi, in_scale, H, W, cin,
                                              cout);
  return cudaGetLastError();
}

// The chunked conv at CK: NB = 64, 32 or 16, the largest that divides cout.
template <int CK, int KK, int WROWS, class Epi>
cudaError_t chunked_nb(const bf16* x, const bf16* w, Epi epi, float in_scale,
                       int B, int H, int W, int cin, int cout,
                       cudaStream_t s) {
  if (cout % 64 == 0)
    return launch_chunked<CK, 64, KK, WROWS>(x, w, epi, in_scale, B, H, W,
                                             cin, cout, s);
  if (cout % 32 == 0)
    return launch_chunked<CK, 32, KK, WROWS>(x, w, epi, in_scale, B, H, W,
                                             cin, cout, s);
  return launch_chunked<CK, 16, KK, WROWS>(x, w, epi, in_scale, B, H, W, cin,
                                           cout, s);
}

// The chunked conv: cin and cout multiples of 16; CK = 64 (3x3 only), 32
// or 16, the largest that divides cin. 3x3 stages a chunk's 9 taps at
// once, 5x5 one row of 5 taps at a time (25 taps of a 32 x 64 chunk would
// take 102 KB).
template <int KK, class Epi>
cudaError_t conv_chunked(const bf16* x, const bf16* w, Epi epi,
                         float in_scale, int B, int H, int W, int cin,
                         int cout, cudaStream_t s) {
  constexpr int WROWS = KK == 3 ? 3 : 1;
  if (cin % 16 || cout % 16) return cudaErrorInvalidValue;
  if constexpr (KK == 3) {
    if (cin % 64 == 0)
      return chunked_nb<64, KK, WROWS>(x, w, epi, in_scale, B, H, W, cin,
                                       cout, s);
  }
  if (cin % 32 == 0)
    return chunked_nb<32, KK, WROWS>(x, w, epi, in_scale, B, H, W, cin, cout,
                                     s);
  return chunked_nb<16, KK, WROWS>(x, w, epi, in_scale, B, H, W, cin, cout,
                                   s);
}

}  // namespace srt
