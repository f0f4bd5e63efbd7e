// K7: WDSR-B's wide-activation block, NHWC bf16 activations, f32 sums:
//   h1  = bf16(relu(x W1 + b1))              1x1, C -> e = 6C
//   h2  = bf16(h1 W2 + b2)                   1x1, e -> Lp (L = 0.8C padded
//                                            to a 16-multiple, zero rows)
//   out = bf16((conv3x3(h2; W3) + b3) * res_scale + x)   one rounding
// and its backward, which stores nothing of the forward but x: it
// recomputes h1 and h2, then
//   gs = bf16(g * res_scale), dh2 = convT(gs; W3) (f32), db2 = sum dh2,
//   dh2b = bf16(dh2), dh1 = [h1 > 0] dh2b W2^T (f32), db1 = sum dh1,
//   dh1b = bf16(dh1), dW2 = h1^T dh2b, dW1 = x^T dh1b,
//   dx = bf16(g + dh1b W1^T)                 one rounding.
// dW3 and db3 are the weight-grad engine's (wgrad.cu) on (h2, g) with
// gscale = res_scale (g scaled in shared memory), launched by the Python
// wrapper after srt_wdsr_bwd.
//
// Replaces srtpu/ops/wdsr_cs.py:_fwd_call (body _fwd_kernel) and
// _bwd_call (_bwd_kernel), behind wdsr_block_cs.
//
// What bounds it on the H100. Per pixel the forward costs 2 (e C + L e +
// 9 L C) = 0.588 MFLOP at C = 128 (e = 768, L = 102): 9.64 GFLOP per
// block at the training shape (16 x 32 x 32), >= 9.7 us at 989 TFLOP/s,
// against ~8 MB that must move (x in, out out, the weights): >= 2.5 us at
// 3.35 TB/s. The backward does twice the work against ~13 MB. Operations
// bound both. The kernels run at Lp = 112 (zero rows), 6.5% more work
// than the function needs. The 768-wide h1 is what a stock route must store (25 MB per
// block at the training shape in bf16) and read back: the TPU kernel keeps
// it in VMEM, and so does this one in shared memory, one chunk at a time.
//
// Design (simple and right first; wmma bf16 tiles, f32 accumulators in
// registers, no wgmma/TMA yet):
//  Forward (srt_wdsr_fwd), two launches:
//   wdsr_pw_fwd_kernel: one block per 128 pixels (8 warps, 16 pixel rows
//     each; a pointwise op, so pixels are flat rows of (B H W, C)). It
//     walks e in chunks of 96: stages W1's 96 columns and W2's 96 rows in
//     shared memory, computes its rows' h1 chunk (x W1c + b1, ReLU, bf16)
//     into shared memory and adds h1c W2c into the h2 accumulators, which
//     stay in registers over all chunks. So h1 never exists whole, not
//     even in shared memory. Its epilogue adds b2 and stores bf16 h2
//     (Lp = 112 wide: 3.7 MB at the training shape).
//   the 3x3 Lp -> C conv of h2: tile_conv.cuh's chunked-input conv (the
//     loop of K2's general path, conv_chunked_kernel), whose epilogue here
//     (ScaleSkipOut) adds b3, scales, adds x and rounds once.
//  Backward (srt_wdsr_bwd), four launches:
//   wdsr_pw_fwd_kernel again (h2 recomputed);
//   the same conv for dh2 = convT(gs) in f32 (Dh2Out), gs formed while
//     the tile of g is staged (load_tile's scale);
//   wdsr_pw_bwd_kernel: one block per run of 128-pixel tiles. Per tile and
//     e-chunk it recomputes the h1 chunk (as the forward), forms the dh1
//     chunk (dh2b W2c^T, masked by h1 > 0; f32 column sums for db1 by warp
//     shuffles), adds dh1b W1c^T into the dx accumulators (registers, over
//     all chunks), and adds the chunk's dW1 (x^T dh1b) and dW2 (h1^T dh2b)
//     into the block's own f32 partial in device memory (read, add, write
//     back: only this block touches it). The epilogue adds g and rounds
//     dx once. db2 sums the f32 dh2 as the tile is staged.
//   wdsr_reduce: the blocks' partials (dW1, dW2, db1, db2) added in a fixed
//     order. No float atomics anywhere: the same bits on every call.
// The TPU kernel keeps its dW accumulators resident while its grid walks
// the images in order; Hopper's blocks run in no order, hence the
// per-block partials and the second pass.
//
// Widths: C a multiple of 16 up to 128 (the accumulators are at most 8
// 16-column tiles per warp), e = 6C a multiple of 96, Lp a multiple of 16
// up to 128. The wrapper (srtpu_torch/ops/wdsr.py) raises for others.
//
// K8c (srt_wdsr_block_fwd) is the forward of srtpu's fused NHWC WDSR-B
// block (its use_pallas=True route), which keeps the activations in f32:
//   a   = relu(x W1 + b1)                      f32 (not rounded)
//   v   = a W2 + b2                            f32 (not rounded)
//   out = bf16((conv3x3(v; W3) + b3) * res_scale + x)   one rounding.
// It replaces srtpu/ops/wdsr_block.py:wdsr_block_fused_fwd (body
// _wdsr_kernel), behind wdsr_block_fused / _BlockB._fused. K7 rounds h1
// and h2 to bf16 before the next product, so it cannot serve. Here every
// f32 activation t that a product reads is carried as hi = bf16(t), lo =
// bf16(t - hi), and the product runs twice into the same f32
// accumulators (hi W + lo W; the weights are bf16 values, as srtpu casts
// them, so each product is exact in f32 and t - hi - lo is below 2^-17
// |t|): the f32 product to that error on the bf16 tensor cores, where
// TF32 (10-bit mantissa) would not reach it. Two launches:
//   wdsr_pw_fwd_kernel<true>: the pointwise kernel above, with a chunk's a
//     split into hi and lo halves in shared memory and the W2 product run
//     on both; its epilogue adds b2 and stores v as [hi | lo] (B H W,
//     2 Lp) bf16, the f32 v in the bytes an f32 tensor would take;
//   the 3x3 of v: the chunked conv over those 2 Lp channels with W3
//     stacked twice along its input channels ([W3; W3], (3, 3, 2 Lp, C)):
//     conv(hi, W3) + conv(lo, W3) in one sum, ScaleSkipOut's epilogue.
// Bound as K7's forward (the function's work at L = 102: 9.64 GFLOP at
// the training shape, 9.7 us); the hi/lo halves double the W2 and 3x3
// products' tensor-core work. L pads to Lp with zero rows, as K7's.

#include "tile_conv.cuh"

namespace {

using srt::AccFrag;
using srt::AFrag;
using srt::BFrag;
using srt::bf16;
namespace wmma = nvcuda::wmma;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>
    AColFrag;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>
    BColFrag;

constexpr int kP = 128;         // pixels per tile: 8 warps x 16 rows
constexpr int kEC = 96;         // expanded channels per chunk
constexpr int kNE = kEC / 16;   // column tiles of a chunk
constexpr int kMaxN = 8;        // C / 16 and Lp / 16 at most

// Shared-memory plan of the pointwise kernels (byte offsets; leading
// dimensions in elements, each a 16-multiple so every wmma pointer is
// 32-byte aligned).
// hilo (K8c's forward) adds the lo half of the h1 chunk (h1lo).
struct PwPlan {
  int ldx, ldl, ldw1, ldw2, lde;
  size_t xs, dh2, w1, w2, h1, h1lo, dh1, scr, db1, total;
  __host__ __device__ PwPlan(int c, int lp, bool bwd, bool hilo = false) {
    ldx = c + 16;
    ldl = lp + 16;
    ldw1 = kEC + 16;
    ldw2 = lp + 16;
    lde = kEC + 16;
    size_t o = 0;
    xs = o;
    o += srt::align128((size_t)kP * ldx * 2);
    dh2 = o;
    if (bwd) o += srt::align128((size_t)kP * ldl * 2);
    w1 = o;
    o += srt::align128((size_t)c * ldw1 * 2);
    w2 = o;
    o += srt::align128((size_t)kEC * ldw2 * 2);
    h1 = o;
    o += srt::align128((size_t)kP * lde * 2);
    h1lo = o;
    if (hilo) o += srt::align128((size_t)kP * lde * 2);
    dh1 = o;
    if (bwd) o += srt::align128((size_t)kP * lde * 2);
    scr = o;
    o += (size_t)srt::kWarps * 256 * 4;
    db1 = o;
    if (bwd) o += srt::align128((size_t)srt::kWarps * kEC * 4);
    total = o;
  }
};

// rows [p0, p0 + kP) of a (S, n) bf16 matrix into dst (kP, ld); rows past
// S are zero.
__device__ __forceinline__ void load_rows(bf16* __restrict__ dst,
                                          const bf16* __restrict__ src,
                                          long long p0, long long S, int n,
                                          int ld) {
  const int vec = n / 8;
  for (int i = threadIdx.x; i < kP * vec; i += blockDim.x) {
    const int p = i / vec, v = i % vec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (p0 + p < S)
      val = *reinterpret_cast<const uint4*>(src + (p0 + p) * n + v * 8);
    *reinterpret_cast<uint4*>(dst + (size_t)p * ld + v * 8) = val;
  }
}

// Chunk ch of the weights: W1's columns [ch kEC, +kEC) (C rows of e) and
// W2's rows [ch kEC, +kEC) (of Lp columns).
__device__ __forceinline__ void load_chunk(const PwPlan& P, bf16* w1s,
                                           bf16* w2s,
                                           const bf16* __restrict__ w1,
                                           const bf16* __restrict__ w2,
                                           int c, int e, int lp, int ch) {
  constexpr int V1 = kEC / 8;
  for (int i = threadIdx.x; i < c * V1; i += blockDim.x) {
    const int r = i / V1, v = i % V1;
    *reinterpret_cast<uint4*>(w1s + (size_t)r * P.ldw1 + v * 8) =
        *reinterpret_cast<const uint4*>(w1 + (size_t)r * e + ch * kEC + v * 8);
  }
  const int v2 = lp / 8;
  for (int i = threadIdx.x; i < kEC * v2; i += blockDim.x) {
    const int r = i / v2, v = i % v2;
    *reinterpret_cast<uint4*>(w2s + (size_t)r * P.ldw2 + v * 8) =
        *reinterpret_cast<const uint4*>(w2 + ((size_t)ch * kEC + r) * lp +
                                        v * 8);
  }
}

// The warp's 16 rows of the h1 chunk ch: bf16(relu(x W1c + b1c)) into
// h1s (kP, lde); with h1lo (K8c), the f32 value's lo half, bf16(h1 -
// bf16(h1)), into h1lo.
__device__ __forceinline__ void h1_chunk(const PwPlan& P, const bf16* xs,
                                         const bf16* w1s, bf16* h1s,
                                         float* scr,
                                         const float* __restrict__ b1, int c,
                                         int ch, int warp, int lane,
                                         bf16* h1lo = nullptr) {
  AccFrag a[kNE];
#pragma unroll
  for (int n = 0; n < kNE; ++n) wmma::fill_fragment(a[n], 0.0f);
  for (int k = 0; k < c / 16; ++k) {
    AFrag fa;
    wmma::load_matrix_sync(fa, xs + (size_t)warp * 16 * P.ldx + k * 16, P.ldx);
#pragma unroll
    for (int n = 0; n < kNE; ++n) {
      BFrag fb;
      wmma::load_matrix_sync(fb, w1s + (size_t)k * 16 * P.ldw1 + n * 16,
                             P.ldw1);
      wmma::mma_sync(a[n], fa, fb, a[n]);
    }
  }
  const int row = warp * 16 + (lane >> 1), c0 = (lane & 1) * 8;
#pragma unroll
  for (int n = 0; n < kNE; ++n) {
    float v[8];
    srt::lane_values(scr, a[n], lane, v);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = fmaxf(v[j] + b1[ch * kEC + n * 16 + c0 + j], 0.0f);
    *reinterpret_cast<uint4*>(h1s + (size_t)row * P.lde + n * 16 + c0) =
        srt::pack8(v);
    if (h1lo) {
      float lo[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        lo[j] = v[j] - __bfloat162float(__float2bfloat16_rn(v[j]));
      *reinterpret_cast<uint4*>(h1lo + (size_t)row * P.lde + n * 16 + c0) =
          srt::pack8(lo);
    }
  }
  __syncwarp();
}

// h2 = bf16(relu(x W1 + b1) W2 + b2) for 128 pixels per block; h1 walked in
// chunks of kEC. x (S, c), w1 (c, e), w2 (e, lp) bf16; b1, b2 f32; h2 (S,
// lp) bf16. HILO (K8c): h1 stays f32 as hi + lo halves, both multiplied
// by W2, and h2 is the f32 v stored as [hi | lo] (S, 2 lp) bf16.
template <bool HILO>
__global__ void __launch_bounds__(srt::kThreads, 1)
    wdsr_pw_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                       const float* __restrict__ b1,
                       const bf16* __restrict__ w2,
                       const float* __restrict__ b2, bf16* __restrict__ h2,
                       long long S, int c, int e, int lp) {
  const PwPlan P(c, lp, false, HILO);
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem + P.xs);
  bf16* w1s = reinterpret_cast<bf16*>(smem + P.w1);
  bf16* w2s = reinterpret_cast<bf16*>(smem + P.w2);
  bf16* h1s = reinterpret_cast<bf16*>(smem + P.h1);
  bf16* h1lo = HILO ? reinterpret_cast<bf16*>(smem + P.h1lo) : nullptr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* scr = reinterpret_cast<float*>(smem + P.scr) + warp * 256;
  const long long p0 = (long long)blockIdx.x * kP;
  const int nl = lp / 16;

  load_rows(xs, x, p0, S, c, P.ldx);
  AccFrag acc[kMaxN];
#pragma unroll
  for (int n = 0; n < kMaxN; ++n) wmma::fill_fragment(acc[n], 0.0f);
  for (int ch = 0; ch < e / kEC; ++ch) {
    __syncthreads();  // every warp is done with the last chunk's weights
    load_chunk(P, w1s, w2s, w1, w2, c, e, lp, ch);
    __syncthreads();
    h1_chunk(P, xs, w1s, h1s, scr, b1, c, ch, warp, lane, h1lo);
#pragma unroll
    for (int half = 0; half < (HILO ? 2 : 1); ++half) {
      const bf16* as = half ? h1lo : h1s;
#pragma unroll
      for (int k = 0; k < kNE; ++k) {
        AFrag fa;
        wmma::load_matrix_sync(fa, as + (size_t)warp * 16 * P.lde + k * 16,
                               P.lde);
#pragma unroll
        for (int n = 0; n < kMaxN; ++n) {
          if (n < nl) {
            BFrag fb;
            wmma::load_matrix_sync(fb,
                                   w2s + (size_t)k * 16 * P.ldw2 + n * 16,
                                   P.ldw2);
            wmma::mma_sync(acc[n], fa, fb, acc[n]);
          }
        }
      }
    }
  }
  const long long p = p0 + warp * 16 + (lane >> 1);
  const int c0 = (lane & 1) * 8;
  const int ld = HILO ? 2 * lp : lp;
#pragma unroll
  for (int n = 0; n < kMaxN; ++n) {
    if (n >= nl) continue;
    float v[8];
    srt::lane_values(scr, acc[n], lane, v);
    if (p >= S) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] += b2[n * 16 + c0 + j];
    *reinterpret_cast<uint4*>(h2 + p * ld + n * 16 + c0) = srt::pack8(v);
    if (HILO) {
      float lo[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        lo[j] = v[j] - __bfloat162float(__float2bfloat16_rn(v[j]));
      *reinterpret_cast<uint4*>(h2 + p * ld + lp + n * 16 + c0) =
          srt::pack8(lo);
    }
  }
}

// Per tile and chunk: recompute h1c, dh1c = [h1c > 0] dh2b W2c^T (db1 by
// column sums), dx += dh1b W1c^T, and the chunk's dW1 / dW2 added into the
// block's partial. grid = nparts; block `part` takes tiles [part tpp,
// (part + 1) tpp). x, g (S, c) bf16; dh2 (S, lp) f32; ws (nparts, wsz)
// f32, each slot [dW1 (c, e) | dW2 (e, lp) | db1 (e) | db2 (lp)]; dx (S,
// c) bf16.
__global__ void __launch_bounds__(srt::kThreads, 1)
    wdsr_pw_bwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                       const float* __restrict__ dh2,
                       const bf16* __restrict__ w1,
                       const float* __restrict__ b1,
                       const bf16* __restrict__ w2, float* __restrict__ ws,
                       bf16* __restrict__ dx, long long S, int c, int e,
                       int lp, int tpp, long long wsz) {
  const PwPlan P(c, lp, true);
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem + P.xs);
  bf16* dh2s = reinterpret_cast<bf16*>(smem + P.dh2);
  bf16* w1s = reinterpret_cast<bf16*>(smem + P.w1);
  bf16* w2s = reinterpret_cast<bf16*>(smem + P.w2);
  bf16* h1s = reinterpret_cast<bf16*>(smem + P.h1);
  bf16* dh1s = reinterpret_cast<bf16*>(smem + P.dh1);
  float* db1w = reinterpret_cast<float*>(smem + P.db1);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* scr = reinterpret_cast<float*>(smem + P.scr) + warp * 256;
  const int nc = c / 16, nl = lp / 16;
  const long long ntiles = (S + kP - 1) / kP;
  const long long t0 = (long long)blockIdx.x * tpp;
  const long long t1 = min(t0 + tpp, ntiles);
  float* part = ws + (size_t)blockIdx.x * wsz;
  float* pw1 = part;                              // (c, e)
  float* pw2 = part + (size_t)c * e;              // (e, lp)
  float* pb1 = pw2 + (size_t)e * lp;              // (e)
  float* pb2 = pb1 + e;                           // (lp)
  const int row = warp * 16 + (lane >> 1), c0 = (lane & 1) * 8;
  float db2 = 0.0f;

  for (long long t = t0; t < t1; ++t) {
    const bool first = t == t0;
    const long long p0 = t * kP;
    __syncthreads();  // the last tile's reads of xs and dh2s are done
    load_rows(xs, x, p0, S, c, P.ldx);
    if (threadIdx.x < lp) {
      // dh2 rounded to bf16 for the products; db2 sums the f32 values
      for (int p = 0; p < kP; ++p) {
        const float v =
            p0 + p < S ? dh2[(p0 + p) * lp + threadIdx.x] : 0.0f;
        db2 += v;
        dh2s[(size_t)p * P.ldl + threadIdx.x] = __float2bfloat16(v);
      }
    }
    AccFrag dxa[kMaxN];
#pragma unroll
    for (int n = 0; n < kMaxN; ++n) wmma::fill_fragment(dxa[n], 0.0f);

    for (int ch = 0; ch < e / kEC; ++ch) {
      __syncthreads();  // every warp is done with the last chunk
      load_chunk(P, w1s, w2s, w1, w2, c, e, lp, ch);
      __syncthreads();
      h1_chunk(P, xs, w1s, h1s, scr, b1, c, ch, warp, lane);

      // dh1 for the warp's rows: dh2b (16, lp) x W2c^T (lp, kEC)
      AccFrag a[kNE];
#pragma unroll
      for (int n = 0; n < kNE; ++n) wmma::fill_fragment(a[n], 0.0f);
#pragma unroll
      for (int k = 0; k < kMaxN; ++k) {
        if (k >= nl) continue;
        AFrag fa;
        wmma::load_matrix_sync(fa, dh2s + (size_t)warp * 16 * P.ldl + k * 16,
                               P.ldl);
#pragma unroll
        for (int n = 0; n < kNE; ++n) {
          BColFrag fb;
          wmma::load_matrix_sync(fb, w2s + (size_t)n * 16 * P.ldw2 + k * 16,
                                 P.ldw2);
          wmma::mma_sync(a[n], fa, fb, a[n]);
        }
      }
#pragma unroll
      for (int n = 0; n < kNE; ++n) {
        float v[8], h[8];
        srt::lane_values(scr, a[n], lane, v);
        srt::unpack8(*reinterpret_cast<const uint4*>(
                         h1s + (size_t)row * P.lde + n * 16 + c0),
                     h);
        float s[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          v[j] = h[j] > 0.0f ? v[j] : 0.0f;
          s[j] = v[j];
        }
        // column sums over the warp's 16 rows (lanes of equal lane & 1)
#pragma unroll
        for (int off = 2; off < 32; off <<= 1)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);
        if (lane < 2)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            db1w[warp * kEC + n * 16 + lane * 8 + j] = s[j];
        *reinterpret_cast<uint4*>(dh1s + (size_t)row * P.lde + n * 16 + c0) =
            srt::pack8(v);
      }
      __syncwarp();
      // dx += dh1b (16, kEC) x W1c^T (kEC, c)
#pragma unroll
      for (int k = 0; k < kNE; ++k) {
        AFrag fa;
        wmma::load_matrix_sync(fa, dh1s + (size_t)warp * 16 * P.lde + k * 16,
                               P.lde);
#pragma unroll
        for (int n = 0; n < kMaxN; ++n) {
          if (n < nc) {
            BColFrag fb;
            wmma::load_matrix_sync(fb, w1s + (size_t)n * 16 * P.ldw1 + k * 16,
                                   P.ldw1);
            wmma::mma_sync(dxa[n], fa, fb, dxa[n]);
          }
        }
      }
      __syncthreads();  // h1s, dh1s and db1w are complete

      // dW2 rows [ch kEC, +kEC) += h1c^T dh2b: kNE x nl tiles over the warps
      for (int f = warp; f < kNE * nl; f += srt::kWarps) {
        const int m = f / nl, n = f % nl;
        float* dst = pw2 + ((size_t)ch * kEC + m * 16) * lp + n * 16;
        AccFrag acc;
        if (first)
          wmma::fill_fragment(acc, 0.0f);
        else
          wmma::load_matrix_sync(acc, dst, lp, wmma::mem_row_major);
#pragma unroll
        for (int k = 0; k < kP / 16; ++k) {
          AColFrag fa;
          BFrag fb;
          wmma::load_matrix_sync(fa, h1s + (size_t)k * 16 * P.lde + m * 16,
                                 P.lde);
          wmma::load_matrix_sync(fb, dh2s + (size_t)k * 16 * P.ldl + n * 16,
                                 P.ldl);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(dst, acc, lp, wmma::mem_row_major);
      }
      // dW1 columns [ch kEC, +kEC) += x^T dh1b: nc x kNE tiles
      for (int f = warp; f < nc * kNE; f += srt::kWarps) {
        const int m = f / kNE, n = f % kNE;
        float* dst = pw1 + (size_t)m * 16 * e + ch * kEC + n * 16;
        AccFrag acc;
        if (first)
          wmma::fill_fragment(acc, 0.0f);
        else
          wmma::load_matrix_sync(acc, dst, e, wmma::mem_row_major);
#pragma unroll
        for (int k = 0; k < kP / 16; ++k) {
          AColFrag fa;
          BFrag fb;
          wmma::load_matrix_sync(fa, xs + (size_t)k * 16 * P.ldx + m * 16,
                                 P.ldx);
          wmma::load_matrix_sync(fb, dh1s + (size_t)k * 16 * P.lde + n * 16,
                                 P.lde);
          wmma::mma_sync(acc, fa, fb, acc);
        }
        wmma::store_matrix_sync(dst, acc, e, wmma::mem_row_major);
      }
      if (threadIdx.x < kEC) {
        float s = first ? 0.0f : pb1[ch * kEC + threadIdx.x];
        for (int w = 0; w < srt::kWarps; ++w)
          s += db1w[w * kEC + threadIdx.x];
        pb1[ch * kEC + threadIdx.x] = s;
      }
    }

    // dx = bf16(g + dh1b W1^T), one rounding
    const long long p = p0 + row;
#pragma unroll
    for (int n = 0; n < kMaxN; ++n) {
      if (n >= nc) continue;
      float v[8], gv[8];
      srt::lane_values(scr, dxa[n], lane, v);
      if (p >= S) continue;
      srt::unpack8(*reinterpret_cast<const uint4*>(g + p * c + n * 16 + c0),
                   gv);
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] += gv[j];
      *reinterpret_cast<uint4*>(dx + p * c + n * 16 + c0) = srt::pack8(v);
    }
  }
  if (threadIdx.x < lp) pb2[threadIdx.x] = db2;
}

// out[i] = sum over p of ws[p, i], p in order.
__global__ void wdsr_reduce(const float* __restrict__ ws,
                            float* __restrict__ out, int nparts,
                            long long n) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int p = 0; p < nparts; ++p) s += ws[p * n + i];
    out[i] = s;
  }
}

// The 3x3's epilogue in the forward (srt::conv_chunked on h2 and W3):
// out = bf16((acc + b3) * scale + skip), one rounding.
struct ScaleSkipOut {
  const float* bias;
  const bf16* skip;
  float scale;
  bf16* out;
  __device__ __forceinline__ void operator()(float (&v)[8], size_t at,
                                             int co) const {
    float s[8];
    srt::unpack8(*reinterpret_cast<const uint4*>(skip + at), s);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[j] = (v[j] + bias[co + j]) * scale + s[j];
    *reinterpret_cast<uint4*>(out + at) = srt::pack8(v);
  }
};

// In the backward (srt::conv_chunked on g read as bf16(scale * g), and
// W3's transposed conv): dh2 = acc, stored in f32.
struct Dh2Out {
  float* out;
  __device__ __forceinline__ void operator()(float (&v)[8], size_t at,
                                             int) const {
    float4* dst = reinterpret_cast<float4*>(out + at);
    dst[0] = make_float4(v[0], v[1], v[2], v[3]);
    dst[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
};

bool widths_ok(int c, int e, int lp) {
  return c % 16 == 0 && c > 0 && c <= 16 * kMaxN && e % kEC == 0 && e > 0 &&
         lp % 16 == 0 && lp > 0 && lp <= 16 * kMaxN;
}

template <bool HILO = false>
cudaError_t pw_fwd(const void* x, const void* w1, const void* b1,
                   const void* w2, const void* b2, void* h2, long long S,
                   int c, int e, int lp, cudaStream_t s) {
  const PwPlan P(c, lp, false, HILO);
  cudaError_t err = srt::allow_smem(wdsr_pw_fwd_kernel<HILO>, P.total);
  if (err != cudaSuccess) return err;
  wdsr_pw_fwd_kernel<HILO><<<(unsigned)((S + kP - 1) / kP), srt::kThreads,
                             P.total, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<bf16*>(h2), S, c, e, lp);
  return cudaGetLastError();
}

}  // namespace

// x (B, H, W, c) bf16; w1 (c, e), w2 (e, lp), w3 (3, 3, lp, c) bf16; b1
// (e), b2 (lp), b3 (c) f32; h2 (B, H, W, lp) bf16 scratch; out (B, H, W,
// c) bf16. Returns a cudaError_t.
extern "C" int srt_wdsr_fwd(const void* x, const void* w1, const void* b1,
                            const void* w2, const void* b2, const void* w3,
                            const void* b3, float scale, void* h2, void* out,
                            int B, int H, int W, int c, int e, int lp,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!widths_ok(c, e, lp)) return (int)cudaErrorInvalidValue;
  cudaError_t err =
      pw_fwd(x, w1, b1, w2, b2, h2, (long long)B * H * W, c, e, lp, s);
  if (err != cudaSuccess) return (int)err;
  return (int)srt::conv_chunked<3>(
      static_cast<const bf16*>(h2), static_cast<const bf16*>(w3),
      ScaleSkipOut{static_cast<const float*>(b3), static_cast<const bf16*>(x),
                   scale, static_cast<bf16*>(out)},
      1.0f, B, H, W, lp, c, s);
}

// The backward from x and g (B, H, W, c) bf16; w1, b1, w2, b2 as the
// forward; w3t = W3's transposed conv (3, 3, c, lp) bf16. Scratch: h2
// (B, H, W, lp) bf16 (the recomputed h2, left for the caller's dW3 / db3),
// dh2 (B, H, W, lp) f32, ws (nparts, wsz) f32 with wsz = c e + e lp + e +
// lp; red (wsz) f32 receives [dW1 (c, e) | dW2 (e, lp) | db1 | db2]; dx
// (B, H, W, c) bf16. nparts <= the number of 128-pixel tiles. Returns a
// cudaError_t.
extern "C" int srt_wdsr_bwd(const void* x, const void* g, const void* w1,
                            const void* b1, const void* w2, const void* b2,
                            const void* w3t, float scale, void* h2, void* dh2,
                            void* ws, void* red, void* dx, int B, int H, int W,
                            int c, int e, int lp, int nparts, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!widths_ok(c, e, lp)) return (int)cudaErrorInvalidValue;
  const long long S = (long long)B * H * W;
  const long long ntiles = (S + kP - 1) / kP;
  if (nparts < 1 || nparts > ntiles) return (int)cudaErrorInvalidValue;
  cudaError_t err = pw_fwd(x, w1, b1, w2, b2, h2, S, c, e, lp, s);
  if (err != cudaSuccess) return (int)err;
  err = srt::conv_chunked<3>(static_cast<const bf16*>(g),
                             static_cast<const bf16*>(w3t),
                             Dh2Out{static_cast<float*>(dh2)}, scale, B, H, W,
                             c, lp, s);
  if (err != cudaSuccess) return (int)err;
  const PwPlan P(c, lp, true);
  err = srt::allow_smem(wdsr_pw_bwd_kernel, P.total);
  if (err != cudaSuccess) return (int)err;
  // every launched block takes at least one tile, so writes its partial
  const int tpp = (int)((ntiles + nparts - 1) / nparts);
  const int used = (int)((ntiles + tpp - 1) / tpp);
  const long long wsz = (long long)c * e + (long long)e * lp + e + lp;
  wdsr_pw_bwd_kernel<<<used, srt::kThreads, P.total, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(g),
      static_cast<const float*>(dh2), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<float*>(ws), static_cast<bf16*>(dx), S, c, e, lp, tpp, wsz);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long want = (wsz + 255) / 256;
  wdsr_reduce<<<(int)(want < 4096 ? want : 4096), 256, 0, s>>>(
      static_cast<const float*>(ws), static_cast<float*>(red), used, wsz);
  return (int)cudaGetLastError();
}

// K8c: x (B, H, W, c) bf16; w1 (c, e), w2 (e, lp) bf16; w3cat (3, 3, 2 lp,
// c) bf16, W3 stacked twice along its input channels; b1 (e), b2 (lp), b3
// (c) f32; vcat (B, H, W, 2 lp) bf16 scratch (v as [hi | lo]); out (B, H,
// W, c) bf16. Returns a cudaError_t.
extern "C" int srt_wdsr_block_fwd(const void* x, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* b2, const void* w3cat,
                                  const void* b3, float scale, void* vcat,
                                  void* out, int B, int H, int W, int c,
                                  int e, int lp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!widths_ok(c, e, lp)) return (int)cudaErrorInvalidValue;
  cudaError_t err = pw_fwd<true>(x, w1, b1, w2, b2, vcat,
                                 (long long)B * H * W, c, e, lp, s);
  if (err != cudaSuccess) return (int)err;
  return (int)srt::conv_chunked<3>(
      static_cast<const bf16*>(vcat), static_cast<const bf16*>(w3cat),
      ScaleSkipOut{static_cast<const float*>(b3), static_cast<const bf16*>(x),
                   scale, static_cast<bf16*>(out)},
      1.0f, B, H, W, 2 * lp, c, s);
}
