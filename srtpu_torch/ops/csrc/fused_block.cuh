// The fused 3x3 conv pair of K1 (EDSR's resblock, trunk.cu), at 64
// channels, NHWC bf16, f32 sums. A block owns one 8 x 16 output tile of one image, grid (ceil(W / 16),
// ceil(H / 8), B):
//
//   pair_forward:  h1 = bf16(relu(conv(x, W1) + b1)) over the tile and its
//                  1-pixel halo into shared memory (conv2's zero padding
//                  outside the image; its interior also to h1_out when
//                  given), then conv(h1, W2) over the tile, handed per
//                  pixel and 8 channels to the caller's epilogue;
//   pair_backward: dh1 = bf16(h1 > 0 ? convT(bf16(scale * gin), W2) : 0)
//                  over the tile and its halo (interior to dh1_out), then
//                  dx = bf16(convT(dh1, W1) + skip). K1 passes gin = skip
//                  = g.
//
// The x (or gin) tile is staged with a 2-pixel halo, h1 (or dh1) with a
// 1-pixel halo, and one conv's weights at a time (W1, then W2 over it),
// all in shared memory; the halo recompute costs 1.44x the ideal FLOPs at
// 8 x 16 tiles. Tensor cores through wmma bf16 tiles, f32 sums.
#pragma once

#include "tile_conv.cuh"

namespace srt {
namespace fused {

constexpr int kC = 64, kTH = 8, kTW = 16;

struct Plan {
  static constexpr int PS = kC + 16;
  static constexpr int WX = kTW + 4;                 // tile + 2-pixel halo
  static constexpr int MF1 = ((kTH + 2) * WX + 15) / 16;  // h1 positions
  static constexpr int MF2 = (kTH * WX + 15) / 16;        // output positions
  static constexpr int NX = MF1 * 16 + 2 * WX + 2;   // x pixels read by conv1
  static constexpr int NH = cmax(MF1 * 16, MF2 * 16 + 2 * WX + 2);
  static constexpr size_t XS = align128((size_t)NX * PS * 2);
  static constexpr size_t HS = align128((size_t)NH * PS * 2);
  static constexpr size_t WS = align128((size_t)9 * kC * kC * 2);
  static constexpr size_t SCR = (size_t)kWarps * 256 * 4;
  static constexpr size_t SMEM = XS + HS + WS + SCR;
};

// Stage the (kTH + 4) x (kTW + 4) window of `in` (scaled), compute the
// first conv with `wa` over the (kTH + 2) x (kTW + 2) window (origin
// y0 - 1, x0 - 1) into hs, each value f(v, j, channel, pix, inside)
// rounded to bf16; the interior also goes to mid_out when given. Then
// load `wb` over the weights. Returns with every warp past a barrier.
template <class F>
__device__ __forceinline__ void first_conv(const bf16* __restrict__ in,
                                           float scale,
                                           const bf16* __restrict__ wa,
                                           const bf16* __restrict__ wb,
                                           bf16* __restrict__ mid_out, int H,
                                           int W, unsigned char* smem, F f) {
  typedef Plan P;
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* hs = reinterpret_cast<bf16*>(smem + P::XS);
  bf16* ws = reinterpret_cast<bf16*>(smem + P::XS + P::HS);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* scr =
      reinterpret_cast<float*>(smem + P::XS + P::HS + P::WS) + warp * 256;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTH, x0 = blockIdx.x * kTW;
  const int c0 = (lane & 1) * 8;  // first of this lane's 8 channels (+16 n)

  load_tile<kC>(xs, in, b, H, W, y0 - 2, x0 - 2, kTH + 4, P::WX, P::NX,
                scale);
  load_weights<kC, kC>(ws, wa, kC, 0);
  // slack past the computed positions is read only by discarded outputs;
  // zero it so no stale bits enter the tensor cores
  for (int i = P::MF1 * 16 * (P::PS / 8) + threadIdx.x;
       i < P::NH * (P::PS / 8); i += blockDim.x)
    reinterpret_cast<uint4*>(hs)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  for (int mf = warp; mf < P::MF1; mf += kWarps) {
    AccFrag acc[kC / 16];
    mma_3x3<kC, kC>(acc, xs, ws, mf * 16, P::WX);
    const int p = mf * 16 + (lane >> 1);
    const int hy = p / P::WX, hx = p % P::WX;
    const int gy = y0 - 1 + hy, gx = x0 - 1 + hx;
    // outside the image the value is the second conv's zero padding
    const bool inside = hy < kTH + 2 && hx < kTW + 2 && gy >= 0 && gy < H &&
                        gx >= 0 && gx < W;
    const bool interior =
        inside && hy >= 1 && hy <= kTH && hx >= 1 && hx <= kTW;
    const size_t pix = ((size_t)b * H + gy) * W + gx;
#pragma unroll
    for (int n = 0; n < kC / 16; ++n) {
      float v[8];
      lane_values(scr, acc[n], lane, v);
      f(v, n * 16 + c0, pix, inside);
      const uint4 h = pack8(v);
      *reinterpret_cast<uint4*>(hs + (size_t)p * P::PS + n * 16 + c0) = h;
      if (mid_out && interior)
        *reinterpret_cast<uint4*>(mid_out + pix * kC + n * 16 + c0) = h;
    }
  }
  __syncthreads();
  load_weights<kC, kC>(ws, wb, kC, 0);
  __syncthreads();
}

// The second conv over the kTH x kTW tile; epi(oy, ox, pix, c, v) for
// every output pixel inside the image and its 8 channels c .. c + 7.
template <class E>
__device__ __forceinline__ void second_conv(int H, int W,
                                            unsigned char* smem, E epi) {
  typedef Plan P;
  const bf16* hs = reinterpret_cast<const bf16*>(smem + P::XS);
  const bf16* ws = reinterpret_cast<const bf16*>(smem + P::XS + P::HS);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* scr =
      reinterpret_cast<float*>(smem + P::XS + P::HS + P::WS) + warp * 256;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * kTH, x0 = blockIdx.x * kTW;
  const int c0 = (lane & 1) * 8;
  for (int mf = warp; mf < P::MF2; mf += kWarps) {
    AccFrag acc[kC / 16];
    mma_3x3<kC, kC>(acc, hs, ws, mf * 16, P::WX);
    const int q = mf * 16 + (lane >> 1);
    const int oy = q / P::WX, ox = q % P::WX;
    const int gy = y0 + oy, gx = x0 + ox;
    const bool valid = oy < kTH && ox < kTW && gy < H && gx < W;
    const size_t pix = ((size_t)b * H + gy) * W + gx;
#pragma unroll
    for (int n = 0; n < kC / 16; ++n) {
      float v[8];
      lane_values(scr, acc[n], lane, v);
      if (valid) epi(oy, ox, pix, n * 16 + c0, v);
    }
  }
}

// Forward: h1 = bf16(relu(conv(x, W1) + b1)), then conv(h1, W2) to epi.
// x's staged tile stays in shared memory (at offset 0, pixel (oy, ox) of
// the tile at ((oy + 2) * WX + ox + 2) * PS) until second_conv ends.
template <class E>
__device__ __forceinline__ void pair_forward(const bf16* __restrict__ x,
                                             const bf16* __restrict__ w1,
                                             const float* __restrict__ b1,
                                             const bf16* __restrict__ w2,
                                             bf16* __restrict__ h1_out,
                                             int H, int W,
                                             unsigned char* smem, E epi) {
  first_conv(x, 1.0f, w1, w2, h1_out, H, W, smem,
             [&](float (&v)[8], int c, size_t, bool inside) {
#pragma unroll
               for (int j = 0; j < 8; ++j)
                 v[j] = inside ? fmaxf(v[j] + b1[c + j], 0.0f) : 0.0f;
             });
  second_conv(H, W, smem, epi);
}

// Backward dx chain, with the transposed weights
// wt[ky, kx, co, ci] = w[2 - ky, 2 - kx, ci, co].
__device__ __forceinline__ void pair_backward(
    const bf16* __restrict__ gin, float scale, const bf16* __restrict__ skip,
    const bf16* __restrict__ h1, const bf16* __restrict__ w2t,
    const bf16* __restrict__ w1t, bf16* __restrict__ dx,
    bf16* __restrict__ dh1_out, int H, int W, unsigned char* smem) {
  first_conv(gin, scale, w2t, w1t, dh1_out, H, W, smem,
             [&](float (&v)[8], int c, size_t pix, bool inside) {
               float hv[8] = {};
               if (inside)
                 unpack8(*reinterpret_cast<const uint4*>(h1 + pix * kC + c),
                         hv);
#pragma unroll
               for (int j = 0; j < 8; ++j)
                 v[j] = inside && hv[j] > 0.0f ? v[j] : 0.0f;
             });
  // dx = convT(dh1, W1) + skip, one rounding
  second_conv(H, W, smem, [&](int, int, size_t pix, int c, float (&v)[8]) {
    float gr[8];
    unpack8(*reinterpret_cast<const uint4*>(skip + pix * kC + c), gr);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] += gr[j];
    *reinterpret_cast<uint4*>(dx + pix * kC + c) = pack8(v);
  });
}

}  // namespace fused
}  // namespace srt
