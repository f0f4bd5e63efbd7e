// The Hopper engine of K2 (sm_90a): one k x k SAME convolution (k = 3
// or 5) + bias (+ ReLU), NHWC bf16 in and out, f32 sums, as an implicit
// GEMM on wgmma. conv.cu's head note says what it replaces and what
// bounds each shape class; this header is how it runs.
//
//   out[b, y, x, co] = bf16(act(bias[co] + sum_{ty, tx, ci}
//                      X[b, y + ty - h, x + tx - h, ci] W[ty, tx, ci, co]))
//
// GEMM view: M = output pixels, N = output channels, K = taps x cin.
//
// A block owns an 8 x 16 pixel tile of one image (M = 128: two consumer
// warpgroups of 64 rows, one tile row per warp) and BN output channels
// (the widest of 192, 128, 64, 48, 32, 16 that divides cout: 192 holds 96
// f32 sums a thread, beside A's registers, within the 168 a thread of a
// 288-thread block gets), so it reads its input once for those BN
// channels. It walks cin in slices of KC = 64 channels (32 or 16 where
// cin is not a multiple of 64) and, per slice, the k * k taps.
//
// Operand A (activations): per slice, one TMA load of the tile and its
// halo, (8 + k - 1) x (16 + k - 1) pixels x KC channels, with the
// hardware's zero fill outside the image (SAME padding) and its swizzle
// (128, 64 or 32 bytes: a pixel's KC channels are one swizzle row). A tap
// is then a shift of that tile: each warp ldmatrix-es its 16 shifted
// pixels straight into the wgmma A fragment (registers; the RS form), so
// no halo column is computed and no copy is made per tap. A descriptor of
// A in shared memory could not express the shift: a tile row of 16 pixels
// sits 16 + k - 1 pixels from the next.
//
// Operand B (weights): per slice and row of k taps (or per tap, where two
// rows' stages would not fit beside A), TMA loads the KC x BN blocks of
// the HWIO weight as they lie in memory, output channels contiguous: the
// N-major (transposed) B layout of wgmma with its 128-, 64- or 32-byte
// swizzle, in atoms of 64, 32 or 16 channels. No weight is repacked. The
// backward's dx (TB, conv_dx.cu) is the transposed conv of the same
// weight: there the forward's HWIO weight is read as it lies, input
// channels contiguous, which is wgmma's K-major (untransposed) B, and the
// taps are walked from the last: no transposed copy of the weight either.
//
// Pipeline: one producer warp issues every TMA load into two rings in
// shared memory (A: 2 slices; B: 2-8 stages), each stage with
// a full and an empty mbarrier; the consumer warpgroups wait on the full
// barrier, run the stage's wgmmas, and free it. With two atoms or more
// A's registers are double buffered: the next tap's ldmatrix runs while
// this tap's wgmmas do, and a B stage is freed once wgmma.wait_group 1
// says the wgmmas reading it are done. With one atom (BN = 16, 32, 64)
// ptxas serializes such wgmmas behind the next ldmatrix, and waiting for
// each step's wgmmas measured faster (the other warpgroup overlaps). The
// sums stay in f32 registers; the epilogue adds the bias, applies ReLU
// and rounds once, storing straight from the accumulator layout. Each
// output is one thread's fixed sum order: two calls give the same bits.
// With SPLIT = 2 (cout at most 64, cin of 256 or more, fewer
// blocks than two an SM) a cluster of two blocks shares a tile, each
// summing half of the channel slices; block 1 writes its sums into block
// 0's idle rings (distributed shared memory) and block 0 adds them to its
// own before the epilogue.
//
// Tensor maps are encoded on the host per call (cuTensorMapEncodeTiled,
// taken through cudaGetDriverEntryPoint: no -lcuda) and passed as
// __grid_constant__ kernel parameters. The mbarrier rings, TMA, ldmatrix
// and wgmma helpers are sm90.cuh's, shared with the weight grads'
// engine (wgrad.cu).
//
// K6 (rdn.cu) runs its dense layers, its 1x1 fusion and its backward
// chain on this engine, through runtime strides (ConvArgs, ParamsK6): the
// activations' pixel stride (a layer reads a channel prefix of the
// block's concat buffer), the output's pixel stride (it writes a channel
// slice of it), and weights packed in 64-channel pairs along K or N (the
// B map then 5-D: (inner, outer, taps, K groups, N groups)); k = 1 as well
// as 3 and 5. The EPI template argument keeps them apart from K2's
// instances (EPI 0: K2's Params, one HWIO weight's 3-D map, its
// epilogue): 1, the dense layers', K2's bf16(act(sums + bias)) at an
// output pixel stride; 3, the fusion's residual, bf16(res + (sums +
// bias)) to two outputs; 2, the backward chain's f32 read-add-write of
// the sums into its dbuf (each atom's loads issued together), the mask of
// the layer below formed by the block that holds that layer's chunk, its
// bias grad's per-tile partials, and the last layer's dx.
//
// K5 (rcab.cu) runs its RCAB's second conv and its dx chain on the same
// engine at K2's own plan for 64 -> 64 (one HWIO weight, pixel stride
// cout), with epilogues of its own (ParamsK5): EPI 4, the second conv's
// r2f = sums + bias in f32, r2 = bf16(r2f) and each tile's per-channel
// f32 sum of r2f (the pool's partials, pixels in a fixed order, those
// outside the image left out); EPI 5 (TB), the chain's dh1 = bf16(h1 > 0
// ? sums : 0) with the mask read in the epilogue, or dx = bf16(sums +
// f32(g)).
//
// K1 (trunk.cu) runs EDSR's resblock on it the same way: conv1 K2's own
// instance, conv2 at EPI 6 (ParamsK1: out = bf16(f32(x) + res_scale *
// (sums + bias)), the scaled skip), the dx chain at K5's EPI 5 forms.
//
// K7 (wdsr.cu) runs WDSR-B's 3x3 at EPI 8 (K1's EPI 6 math) and its dh2
// at EPI 7 (TB; K5's EPI 4 partials, storing bf16 dh2 alone), at K2's
// plan for 128 -> 128 (two atoms of 64) or 64 -> 64: NAT atoms at pixel
// stride cout (ParamsK7).
//
// K4 (bn_block.cu) runs its BN block's four convs on it at K2's plan for
// 64 -> 64 (ParamsK4, BnEpi): EPI 9, F1 / F2's y = bf16(sums + bias) and
// each tile's f32 sum and sum of squares of the stored y per channel;
// with reflect, the staged tile's one-pixel ring outside the image is
// mirrored in shared memory after its TMA load (mirror_halo, one warp,
// then a barrier of the consumers) before any tap reads it. EPI 10 (TB),
// B2's PReLU backward on z = a1 y1 + c1: dz = bf16(...) and each tile's
// dalpha, sum dz and sum dz * xhat1 partials; EPI 11 (TB), B3's du =
// bf16(sums + f32(skip)) (and optionally bf16(du + f32(skip2))). With
// reflect, EPI 10 and 11 add the fold ring (bn_block.cu's ring launch)
// to the f32 sums at rows 1, H - 2 and columns 1, W - 2 first.
//
// K8a (resblock.cu) runs EDSR's True-route block on it: conv1 at EPI 12
// (ParamsK8a: h1 = relu(sums + b1) in f32, split into hi = bf16(h1) and
// lo = bf16(h1 - hi), stored as one [hi | lo] pixel of 128 channels, and
// hi alone where the caller keeps h1), conv2 over that pair at cin 128
// (W2 stacked twice) at EPI 15 (ParamsK1: EPI 6's skip with the product
// and the sum one fused rounding, out = bf16(fma(sums + b2, res_scale,
// f32(x))), as the kernel it replaces rounded it).
//
// K3 (upsample.cu) runs the sub-pixel stage on it (ParamsK3): EPI 13, the
// forward C -> r r C with its N a run of d phases of one phase row (d = 3,
// 2 or 1, whichever divides r) and the pixel shuffle in the store: those
// d phases of a coarse pixel are d consecutive fine pixels, one run of d
// C channels; EPI 14 (TB), the dx, EPI 0's epilogue with operand A read
// through a 5-D tensor map of the fine cotangent, (r C, W, r, H, B): a
// 64-channel slice is one phase (a, b) at coarse pixels, TMA's zero fill
// the coarse SAME padding.
//
// K9d (resblock_bwd.cu) runs K8a's fused backward's two transposed convs
// on it over [hi | lo] pairs at cin 128 (ParamsK5): the forward's HWIO
// (3, 3, 64, 64) weight read K-major as it lies, once for each half (its
// K coordinate taken modulo its 64 channels: no stacked or transposed
// copy). EPI 16, dh1: h1's mask (EPI 5's) on the f32 sums, then EPI 12's
// split, stored as one [hi | lo] pixel of 128 channels; EPI 17, dx: EPI
// 5's dx form, bf16(sums + f32(g)).
#pragma once

#include "sm90.cuh"

namespace srt90 {

constexpr int kConsumers = 2;                        // warpgroups
constexpr int kThreads = (4 * kConsumers + 1) * 32;  // + one producer warp
constexpr int kTH = 4 * kConsumers;                  // tile rows: one a warp
constexpr int kTW = 16;                              // a warp's wgmma rows

// EPI 2 (K6's chain): the sums go to the f32 buffer dbuf (pixel stride
// ops), added to what it holds (accum) or not. The block that holds its
// 64-channel chunk m = mask_chunk (final after this launch) also forms
// the layer below's cotangent from it, dout = bf16(h > 0 ? dbuf : 0) with
// h that layer's output, and each tile's f32 sum of it (pixels in a fixed
// order) into db_part. With dx, the last layer: dx = bf16(dbuf + (f32(g)
// + f32(ct))) in place of dbuf.
struct ChainEpi {
  float* dbuf;
  int accum;         // dbuf += sums (else dbuf = sums)
  int mask_chunk;    // chunk m of dbuf, or -1
  const bf16* h;     // h at chunk m's channels (pixel stride hps)
  bf16* dout;        // dout (pixel stride dps)
  float* db_part;    // (B * tiles, 64) f32
  int hps, dps;
  const bf16* g;     // dx's operands: g and dx pixel stride gps, ct ctps
  const bf16* ct;
  bf16* dx;
  int gps, ctps;
};

struct Params {
  const float* bias;  // cout f32, or null
  bf16* out;          // (B, H, W, cout)
  int H, W, cout, relu;
  int kk, taps, nslices;      // k, k * k, cin / the channel slice
  int wx;                     // halo tile width (kTW + kk - 1)
  int tiles_x, ntiles;        // tiles per image row; cout / BN
  int tg;                     // taps per B stage (1 or k: a row of taps)
  int sa, sb;                 // ring stages of A and B
  uint32_t a_stage, b_stage;  // stage strides (1024-aligned)
  uint32_t a_bytes, b_bytes;  // bytes a stage's TMA loads write
};

// K6's launches (EPI 1-3) add to K2's Params: the output's pixel stride,
// the weight's pairs and the epilogues' operands.
struct ParamsK6 : Params {
  int ops;       // out's (EPI 2: dbuf's) pixel stride, elements
  int wgroups;   // w in 64-channel pairs (the 5-D map)
  int wgk, wgn;  // K and N extent of one weight group
  // EPI 3: out = bf16(res + (sums + bias)), and the same to out2 unless
  // null (pixel strides rps, o2ps)
  const bf16* res;
  bf16* out2;
  int rps, o2ps;
  ChainEpi ch;  // EPI 2
};

// K5's epilogues (EPI 4, 5): what RcabEpi names, written at pixel stride
// cout (64). EPI 4: r2f (f32), r2 (bf16) unless null, and part (B *
// tiles, 64) f32, a tile's sum of r2f per channel. EPI 5: with h, out =
// bf16(h > 0 ? sums : 0); else out = bf16(sums + f32(res)).
struct RcabEpi {
  float* r2f;
  bf16* r2;
  float* part;
  const bf16* h;
  const bf16* res;
};

struct ParamsK5 : Params {
  RcabEpi k5;
};

// K1's epilogue (EPI 6), at pixel stride cout (64): out = bf16(f32(res) +
// scale * (sums + bias)), the product and the sum each rounded to f32 (no
// fused multiply-add: the plain version's rounding).
struct TrunkEpi {
  const bf16* res;
  float scale;
};

struct ParamsK1 : Params {
  TrunkEpi k1;
};

// K7's epilogues (EPI 7: dh2, r2 and part of k5; EPI 8: the skip, k1's).
struct ParamsK7 : Params {
  RcabEpi k5;
  TrunkEpi k1;
};

// K4's epilogues (EPI 9-11), at pixel stride cout (64). part: (B tiles,
// nq, 64) f32 per-tile partials (EPI 9: nq 2, sum y, sum y^2; EPI 10: nq
// 3, dalpha, sum dz, sum dz * xhat1). EPI 10 reads y1, st1 (5, 64: mean,
// var, inv, a, c) and alpha; EPI 11 adds skip (unless null), then skip2
// (unless null) after a rounding. ring: the REFLECT fold (B, 2 W + 2 H,
// 64) f32 of EPI 10 and 11, or null; reflect: EPI 9 mirrors the halo.
struct BnEpi {
  float* part;
  const bf16* y1;
  const float* st1;
  const float* alpha;
  const bf16* skip;
  const bf16* skip2;
  const float* ring;
  int reflect;
};

struct ParamsK4 : Params {
  BnEpi k4;
};

// K8a's conv1 (EPI 12): out is the [hi | lo] pair (pixel stride 128), h1
// (pixel stride 64) takes hi unless null.
struct ParamsK8a : Params {
  bf16* h1;
};

// K3's launches (EPI 13, 14): r, the upscale factor (out of EPI 13 is the
// fine (B, r H, r W, 64) image; x of EPI 14 the fine cotangent).
struct ParamsK3 : Params {
  int r;
};

template <int EPI>
struct ParamsFor {
  typedef ParamsK6 type;
};
template <>
struct ParamsFor<0> {
  typedef Params type;
};
template <>
struct ParamsFor<4> {
  typedef ParamsK5 type;
};
template <>
struct ParamsFor<5> {
  typedef ParamsK5 type;
};
template <>
struct ParamsFor<6> {
  typedef ParamsK1 type;
};
template <>
struct ParamsFor<7> {
  typedef ParamsK7 type;
};
template <>
struct ParamsFor<8> {
  typedef ParamsK7 type;
};
template <>
struct ParamsFor<9> {
  typedef ParamsK4 type;
};
template <>
struct ParamsFor<10> {
  typedef ParamsK4 type;
};
template <>
struct ParamsFor<11> {
  typedef ParamsK4 type;
};
template <>
struct ParamsFor<12> {
  typedef ParamsK8a type;
};
template <>
struct ParamsFor<13> {
  typedef ParamsK3 type;
};
template <>
struct ParamsFor<14> {
  typedef ParamsK3 type;
};
template <>
struct ParamsFor<15> {
  typedef ParamsK1 type;
};
template <>
struct ParamsFor<16> {
  typedef ParamsK5 type;
};
template <>
struct ParamsFor<17> {
  typedef ParamsK5 type;
};

// K6's epilogues: runtime pixel strides and weights in pairs.
__host__ __device__ constexpr bool k6_epi(int epi) {
  return epi >= 1 && epi <= 3;
}
// K9d's epilogues: x is a [hi | lo] pair whose halves both read the one
// weight, of half x's channels.
__host__ __device__ constexpr bool pair_k(int epi) {
  return epi == 16 || epi == 17;
}
// Shared memory an epilogue adds after the barriers: the warp sums of
// those that sum over a tile's pixels (EPI 2's db and EPI 4's pool, 64
// channels; EPI 7's db2, the block's bn; EPI 9's two and EPI 10's three
// quantities of 64 channels), 8 warps of them.
__host__ __device__ constexpr int red_bytes(int epi, int bn) {
  return epi == 2 || epi == 4 ? 2048
         : epi == 7           ? 32 * bn
         : epi == 9           ? 4096
         : epi == 10          ? 6144
                              : 0;
}

// K6's chain epilogue (EPI 2; ChainEpi says what it writes). acc: the
// block's sums, atom at's register 4 j + 2 h + e at pixel column lane / 4
// + 8 h of tile row `warp`, channel n0 + 64 at + 8 j + 2 (lane % 4) + e.
// red: 2 KB of shared memory for the bias grad's warp sums.
template <int NA, int NAT>
__device__ __forceinline__ void chain_epilogue(float (&acc)[NAT][NA / 2],
                                               const ParamsK6& p, float* red,
                                               int warp, int lane, int b,
                                               int y0, int x0, int n0,
                                               int gtile) {
  static_assert(NA == 64, "an atom is one 64-channel chunk");
  constexpr int J = NA / 8;
  const ChainEpi& e = p.ch;
  const int gy = y0 + warp, cl = 2 * (lane & 3);
  const int m0 = e.mask_chunk * 64 - n0;  // the masked chunk in the block
  const int mat = e.mask_chunk >= 0 && m0 >= 0 && m0 < NA * NAT ? m0 / NA
                                                                 : -1;
  bool ok[2];
  size_t pix[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gx = x0 + (lane >> 2) + 8 * h;
    ok[h] = gy < p.H && gx < p.W;
    pix[h] = ok[h] ? ((size_t)b * p.H + gy) * p.W + gx : 0;
  }
  float dsum[J][2];
#pragma unroll
  for (int j = 0; j < J; ++j) dsum[j][0] = dsum[j][1] = 0.0f;
  // A pixel and an atom at a time, each step's loads issued together
  // before its arithmetic and stores (a store may alias a later load, so
  // the compiler would keep them in order, one round trip each).
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (!ok[h]) continue;
    float* const d = e.dbuf + pix[h] * p.ops;
#pragma unroll
    for (int at = 0; at < NAT; ++at) {
      const int c = n0 + at * NA + cl;  // + 8 j: the channel in dbuf
      float2 v[J];
#pragma unroll
      for (int j = 0; j < J; ++j)
        v[j] = e.accum ? *reinterpret_cast<const float2*>(d + c + 8 * j)
                       : make_float2(0.0f, 0.0f);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const float s0 = acc[at][4 * j + 2 * h];
        const float s1 = acc[at][4 * j + 2 * h + 1];
        v[j] = e.accum ? make_float2(v[j].x + s0, v[j].y + s1)
                       : make_float2(s0, s1);
      }
      if (e.dx) {  // the last layer: dx = bf16(dbuf + gf)
        __nv_bfloat162 gg[J], cc[J];
#pragma unroll
        for (int j = 0; j < J; ++j) {
          gg[j] = *reinterpret_cast<const __nv_bfloat162*>(
              e.g + pix[h] * e.gps + c + 8 * j);
          cc[j] = *reinterpret_cast<const __nv_bfloat162*>(
              e.ct + pix[h] * e.ctps + c + 8 * j);
        }
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const float2 a = __bfloat1622float2(gg[j]);
          const float2 b2 = __bfloat1622float2(cc[j]);
          *reinterpret_cast<__nv_bfloat162*>(e.dx + pix[h] * e.gps + c +
                                             8 * j) =
              __floats2bfloat162_rn(v[j].x + (a.x + b2.x),
                                    v[j].y + (a.y + b2.y));
        }
        continue;
      }
#pragma unroll
      for (int j = 0; j < J; ++j)
        *reinterpret_cast<float2*>(d + c + 8 * j) = v[j];
      if (at != mat) continue;
      __nv_bfloat162 hv[J];
#pragma unroll
      for (int j = 0; j < J; ++j)
        hv[j] = *reinterpret_cast<const __nv_bfloat162*>(
            e.h + pix[h] * e.hps + cl + 8 * j);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const float2 hf = __bfloat1622float2(hv[j]);
        const float d0 = hf.x > 0.0f ? v[j].x : 0.0f;
        const float d1 = hf.y > 0.0f ? v[j].y : 0.0f;
        *reinterpret_cast<__nv_bfloat162*>(e.dout + pix[h] * e.dps + cl +
                                           8 * j) =
            __floats2bfloat162_rn(d0, d1);
        dsum[j][0] += d0;
        dsum[j][1] += d1;
      }
    }
  }
  if (mat < 0) return;  // uniform over the block
  // db: the 8 lanes of one lane % 4 (8 pixel columns) in a fixed order,
  // then the 8 warps (tile rows) in order
#pragma unroll
  for (int o = 4; o < 32; o <<= 1)
#pragma unroll
    for (int j = 0; j < J; ++j) {
      dsum[j][0] += __shfl_xor_sync(0xffffffffu, dsum[j][0], o);
      dsum[j][1] += __shfl_xor_sync(0xffffffffu, dsum[j][1], o);
    }
  if (lane < 4)
#pragma unroll
    for (int j = 0; j < J; ++j) {
      red[warp * 64 + 8 * j + 2 * lane] = dsum[j][0];
      red[warp * 64 + 8 * j + 2 * lane + 1] = dsum[j][1];
    }
  asm volatile("bar.sync 1, %0;" ::"n"(4 * kConsumers * 32) : "memory");
  if (threadIdx.x < 64) {
    float sum = red[threadIdx.x];
#pragma unroll
    for (int w = 1; w < 4 * kConsumers; ++w) sum += red[w * 64 + threadIdx.x];
    e.db_part[(size_t)gtile * 64 + threadIdx.x] = sum;
  }
}

// K5's epilogues (EPI 4, 5; RcabEpi says what they write), on K2's plan
// for 64 -> 64: one atom of 64 channels, register 4 j + 2 h + e of a
// thread at pixel column lane / 4 + 8 h of tile row `warp`, channel 8 j +
// 2 (lane % 4) + e. EPI 4's pool partial of a channel: each thread adds
// its two pixels (column lane / 4, then + 8), the 8 lanes of one lane % 4
// add theirs in a butterfly, then the 8 warps (tile rows) are added in
// order; pixels outside the image are left out. red: 2 KB of shared
// memory for the warp sums.
template <int EPI>
__device__ __forceinline__ void rcab_epilogue(float (&acc)[1][32],
                                              const ParamsK5& p, float* red,
                                              int warp, int lane, int b,
                                              int y0, int x0, int gtile) {
  constexpr int J = 8;
  const RcabEpi& e = p.k5;
  const int gy = y0 + warp, cl = 2 * (lane & 3);
  float psum[J][2];
#pragma unroll
  for (int j = 0; j < J; ++j) psum[j][0] = psum[j][1] = 0.0f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gx = x0 + (lane >> 2) + 8 * h;
    if (gy >= p.H || gx >= p.W) continue;
    const size_t o = (((size_t)b * p.H + gy) * p.W + gx) * 64 + cl;
    if constexpr (EPI == 4) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const float v0 = acc[0][4 * j + 2 * h] + __ldg(p.bias + cl + 8 * j);
        const float v1 =
            acc[0][4 * j + 2 * h + 1] + __ldg(p.bias + cl + 8 * j + 1);
        *reinterpret_cast<float2*>(e.r2f + o + 8 * j) = make_float2(v0, v1);
        if (e.r2)
          *reinterpret_cast<__nv_bfloat162*>(e.r2 + o + 8 * j) =
              __floats2bfloat162_rn(v0, v1);
        psum[j][0] += v0;
        psum[j][1] += v1;
      }
    } else {
      // the pixel's operand loads together, then its stores
      const bf16* src = e.h ? e.h : e.res;
      __nv_bfloat162 t[J];
#pragma unroll
      for (int j = 0; j < J; ++j)
        t[j] = *reinterpret_cast<const __nv_bfloat162*>(src + o + 8 * j);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const float2 f = __bfloat1622float2(t[j]);
        float v0 = acc[0][4 * j + 2 * h], v1 = acc[0][4 * j + 2 * h + 1];
        if (e.h) {
          v0 = f.x > 0.0f ? v0 : 0.0f;
          v1 = f.y > 0.0f ? v1 : 0.0f;
        } else {
          v0 += f.x;
          v1 += f.y;
        }
        *reinterpret_cast<__nv_bfloat162*>(p.out + o + 8 * j) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  }
  if constexpr (EPI == 4) {
#pragma unroll
    for (int o = 4; o < 32; o <<= 1)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        psum[j][0] += __shfl_xor_sync(0xffffffffu, psum[j][0], o);
        psum[j][1] += __shfl_xor_sync(0xffffffffu, psum[j][1], o);
      }
    if (lane < 4)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        red[warp * 64 + 8 * j + 2 * lane] = psum[j][0];
        red[warp * 64 + 8 * j + 2 * lane + 1] = psum[j][1];
      }
    asm volatile("bar.sync 1, %0;" ::"n"(4 * kConsumers * 32) : "memory");
    if (threadIdx.x < 64) {
      float sum = red[threadIdx.x];
#pragma unroll
      for (int w = 1; w < 4 * kConsumers; ++w) sum += red[w * 64 + threadIdx.x];
      e.part[(size_t)gtile * 64 + threadIdx.x] = sum;
    }
  }
}

// K1's epilogue (EPI 6; TrunkEpi says what it writes), on K2's plan for 64
// -> 64, registers as rcab_epilogue's; FMA (K8a's EPI 15): the product and
// the sum one fused rounding, fma(sums + bias, scale, f32(res)).
template <bool FMA>
__device__ __forceinline__ void trunk_epilogue(float (&acc)[1][32],
                                               const ParamsK1& p, int warp,
                                               int lane, int b, int y0,
                                               int x0) {
  constexpr int J = 8;
  const TrunkEpi& e = p.k1;
  const int gy = y0 + warp, cl = 2 * (lane & 3);
  if (gy >= p.H) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gx = x0 + (lane >> 2) + 8 * h;
    if (gx >= p.W) continue;
    const size_t o = (((size_t)b * p.H + gy) * p.W + gx) * 64 + cl;
    // the pixel's operand loads together, then its stores
    __nv_bfloat162 t[J];
#pragma unroll
    for (int j = 0; j < J; ++j)
      t[j] = *reinterpret_cast<const __nv_bfloat162*>(e.res + o + 8 * j);
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const float2 r = __bfloat1622float2(t[j]);
      const float v0 = acc[0][4 * j + 2 * h] + __ldg(p.bias + cl + 8 * j);
      const float v1 =
          acc[0][4 * j + 2 * h + 1] + __ldg(p.bias + cl + 8 * j + 1);
      *reinterpret_cast<__nv_bfloat162*>(p.out + o + 8 * j) =
          FMA ? __floats2bfloat162_rn(__fmaf_rn(v0, e.scale, r.x),
                                      __fmaf_rn(v1, e.scale, r.y))
              : __floats2bfloat162_rn(__fadd_rn(__fmul_rn(v0, e.scale), r.x),
                                      __fadd_rn(__fmul_rn(v1, e.scale), r.y));
    }
  }
}

// K7's epilogues (EPI 7, 8; wdsr.cu), K5's EPI 4 and K1's EPI 6 at any
// width: NAT atoms of 64 channels from n0 at pixel stride cout, registers
// as rcab_epilogue's. EPI 7 (TB, the backward's dh2): r2 = bf16(sums)
// and each tile's per-channel f32 sum of the sums (db2's partials, in
// rcab_epilogue's order; pixels outside the image left out), no bias;
// EPI 8: out = bf16(f32(res) + scale * (sums + bias)), mul then add, as
// K1's. red: red_bytes(7, BN) of shared memory for the warp sums.
template <int EPI, int NA, int NAT>
__device__ __forceinline__ void k7_epilogue(float (&acc)[NAT][NA / 2],
                                            const ParamsK7& p, float* red,
                                            int warp, int lane, int b,
                                            int y0, int x0, int n0,
                                            int gtile) {
  static_assert(NA == 64, "atoms of 64 channels");
  constexpr int J = 8, BN = NA * NAT;
  const int gy = y0 + warp, cl = 2 * (lane & 3);
  float psum[NAT][J][2];
#pragma unroll
  for (int at = 0; at < NAT; ++at)
#pragma unroll
    for (int j = 0; j < J; ++j) psum[at][j][0] = psum[at][j][1] = 0.0f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gx = x0 + (lane >> 2) + 8 * h;
    if (gy >= p.H || gx >= p.W) continue;
    const size_t pix = ((size_t)b * p.H + gy) * p.W + gx;
#pragma unroll
    for (int at = 0; at < NAT; ++at) {
      const int c0 = n0 + at * NA + cl;
      const size_t o = pix * p.cout + c0;
      if constexpr (EPI == 7) {
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const float v0 = acc[at][4 * j + 2 * h];
          const float v1 = acc[at][4 * j + 2 * h + 1];
          *reinterpret_cast<__nv_bfloat162*>(p.k5.r2 + o + 8 * j) =
              __floats2bfloat162_rn(v0, v1);
          psum[at][j][0] += v0;
          psum[at][j][1] += v1;
        }
      } else {
        // the pixel's operand loads together, then its stores
        __nv_bfloat162 t[J];
#pragma unroll
        for (int j = 0; j < J; ++j)
          t[j] = *reinterpret_cast<const __nv_bfloat162*>(p.k1.res + o +
                                                          8 * j);
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const float2 r = __bfloat1622float2(t[j]);
          const float v0 =
              acc[at][4 * j + 2 * h] + __ldg(p.bias + c0 + 8 * j);
          const float v1 =
              acc[at][4 * j + 2 * h + 1] + __ldg(p.bias + c0 + 8 * j + 1);
          *reinterpret_cast<__nv_bfloat162*>(p.out + o + 8 * j) =
              __floats2bfloat162_rn(
                  __fadd_rn(__fmul_rn(v0, p.k1.scale), r.x),
                  __fadd_rn(__fmul_rn(v1, p.k1.scale), r.y));
        }
      }
    }
  }
  if constexpr (EPI == 7) {
#pragma unroll
    for (int o = 4; o < 32; o <<= 1)
#pragma unroll
      for (int at = 0; at < NAT; ++at)
#pragma unroll
        for (int j = 0; j < J; ++j) {
          psum[at][j][0] += __shfl_xor_sync(0xffffffffu, psum[at][j][0], o);
          psum[at][j][1] += __shfl_xor_sync(0xffffffffu, psum[at][j][1], o);
        }
    if (lane < 4)
#pragma unroll
      for (int at = 0; at < NAT; ++at)
#pragma unroll
        for (int j = 0; j < J; ++j) {
          red[warp * BN + at * NA + 8 * j + 2 * lane] = psum[at][j][0];
          red[warp * BN + at * NA + 8 * j + 2 * lane + 1] = psum[at][j][1];
        }
    asm volatile("bar.sync 1, %0;" ::"n"(4 * kConsumers * 32) : "memory");
    if (threadIdx.x < BN) {
      float sum = red[threadIdx.x];
#pragma unroll
      for (int w = 1; w < 4 * kConsumers; ++w) sum += red[w * BN + threadIdx.x];
      p.k5.part[(size_t)gtile * p.cout + n0 + threadIdx.x] = sum;
    }
  }
}

// K4's epilogues (EPI 9-11; BnEpi says what they write), on K2's plan for
// 64 -> 64, registers as rcab_epilogue's. A tile's partial of a channel:
// each thread adds its two pixels (column lane / 4, then + 8), the 8
// lanes of one lane % 4 add theirs in a butterfly, then the 8 warps
// (tile rows) are added in order; pixels outside the image are left out.
// Products and sums that the plain version writes as separate f32
// operations use the _rn intrinsics (no contraction into an FMA). red:
// red_bytes(EPI, 64) of shared memory.
template <int EPI>
__device__ __forceinline__ void bn_epilogue(float (&acc)[1][32],
                                            const ParamsK4& p, float* red,
                                            int warp, int lane, int b,
                                            int y0, int x0, int gtile) {
  constexpr int J = 8, NQ = EPI == 9 ? 2 : EPI == 10 ? 3 : 0;
  const BnEpi& e = p.k4;
  const int gy = y0 + warp, cl = 2 * (lane & 3);
  float q[NQ > 0 ? NQ : 1][J][2];
#pragma unroll
  for (int k = 0; k < (NQ > 0 ? NQ : 1); ++k)
#pragma unroll
    for (int j = 0; j < J; ++j) q[k][j][0] = q[k][j][1] = 0.0f;
  const float al = EPI == 10 ? __ldg(e.alpha) : 0.0f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gx = x0 + (lane >> 2) + 8 * h;
    if (gy >= p.H || gx >= p.W) continue;
    const size_t pix = ((size_t)b * p.H + gy) * p.W + gx;
    const size_t o = pix * 64 + cl;
    float v[J][2];
#pragma unroll
    for (int j = 0; j < J; ++j) {
      v[j][0] = acc[0][4 * j + 2 * h];
      v[j][1] = acc[0][4 * j + 2 * h + 1];
    }
    if constexpr (EPI == 9) {
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const __nv_bfloat162 yb = __floats2bfloat162_rn(
            __fadd_rn(v[j][0], __ldg(p.bias + cl + 8 * j)),
            __fadd_rn(v[j][1], __ldg(p.bias + cl + 8 * j + 1)));
        *reinterpret_cast<__nv_bfloat162*>(p.out + o + 8 * j) = yb;
        const float2 y = __bfloat1622float2(yb);  // the stored y's stats
        q[0][j][0] = __fadd_rn(q[0][j][0], y.x);
        q[0][j][1] = __fadd_rn(q[0][j][1], y.y);
        q[1][j][0] = __fadd_rn(q[1][j][0], __fmul_rn(y.x, y.x));
        q[1][j][1] = __fadd_rn(q[1][j][1], __fmul_rn(y.y, y.y));
      }
      continue;
    }
    if (e.ring) {  // REFLECT's fold, in f32, before any rounding
      const float* rb = e.ring + (size_t)b * (2 * p.W + 2 * p.H) * 64 + cl;
      auto fold = [&](int at) {
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const float2 r =
              *reinterpret_cast<const float2*>(rb + (size_t)at * 64 + 8 * j);
          v[j][0] = __fadd_rn(v[j][0], r.x);
          v[j][1] = __fadd_rn(v[j][1], r.y);
        }
      };
      if (gy == 1) fold(gx);
      if (gy == p.H - 2) fold(p.W + gx);
      if (gx == 1) fold(2 * p.W + gy);
      if (gx == p.W - 2) fold(2 * p.W + p.H + gy);
    }
    if constexpr (EPI == 10) {
      __nv_bfloat162 yv[J];
#pragma unroll
      for (int j = 0; j < J; ++j)
        yv[j] = *reinterpret_cast<const __nv_bfloat162*>(e.y1 + o + 8 * j);
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const float2 y = __bfloat1622float2(yv[j]);
        float dz[2];
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int c = cl + 8 * j + k;
          const float z = __fadd_rn(__fmul_rn(__ldg(e.st1 + 3 * 64 + c),
                                              k ? y.y : y.x),
                                    __ldg(e.st1 + 4 * 64 + c));
          dz[k] = z >= 0.0f ? v[j][k] : __fmul_rn(al, v[j][k]);
          q[0][j][k] = __fadd_rn(q[0][j][k],
                                 z >= 0.0f ? 0.0f : __fmul_rn(v[j][k], z));
        }
        const __nv_bfloat162 db = __floats2bfloat162_rn(dz[0], dz[1]);
        *reinterpret_cast<__nv_bfloat162*>(p.out + o + 8 * j) = db;
        const float2 d = __bfloat1622float2(db);  // BN1's sums: stored dz
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int c = cl + 8 * j + k;
          const float xhat =
              __fmul_rn(__fsub_rn(k ? y.y : y.x, __ldg(e.st1 + c)),
                        __ldg(e.st1 + 2 * 64 + c));
          const float dk = k ? d.y : d.x;
          q[1][j][k] = __fadd_rn(q[1][j][k], dk);
          q[2][j][k] = __fadd_rn(q[2][j][k], __fmul_rn(dk, xhat));
        }
      }
    } else {  // EPI 11
      __nv_bfloat162 t[J], t2[J];
      if (e.skip) {
#pragma unroll
        for (int j = 0; j < J; ++j)
          t[j] = *reinterpret_cast<const __nv_bfloat162*>(e.skip + o + 8 * j);
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const float2 f = __bfloat1622float2(t[j]);
          v[j][0] = __fadd_rn(v[j][0], f.x);
          v[j][1] = __fadd_rn(v[j][1], f.y);
        }
      }
      if (e.skip2) {
#pragma unroll
        for (int j = 0; j < J; ++j)
          t2[j] = *reinterpret_cast<const __nv_bfloat162*>(e.skip2 + o + 8 * j);
      }
#pragma unroll
      for (int j = 0; j < J; ++j) {
        __nv_bfloat162 r = __floats2bfloat162_rn(v[j][0], v[j][1]);
        if (e.skip2) {
          const float2 a = __bfloat1622float2(r);
          const float2 c = __bfloat1622float2(t2[j]);
          r = __floats2bfloat162_rn(__fadd_rn(a.x, c.x), __fadd_rn(a.y, c.y));
        }
        *reinterpret_cast<__nv_bfloat162*>(p.out + o + 8 * j) = r;
      }
    }
  }
  if constexpr (NQ > 0) {
#pragma unroll
    for (int o = 4; o < 32; o <<= 1)
#pragma unroll
      for (int k = 0; k < NQ; ++k)
#pragma unroll
        for (int j = 0; j < J; ++j) {
          q[k][j][0] = __fadd_rn(q[k][j][0],
                                 __shfl_xor_sync(0xffffffffu, q[k][j][0], o));
          q[k][j][1] = __fadd_rn(q[k][j][1],
                                 __shfl_xor_sync(0xffffffffu, q[k][j][1], o));
        }
    if (lane < 4)
#pragma unroll
      for (int k = 0; k < NQ; ++k)
#pragma unroll
        for (int j = 0; j < J; ++j) {
          red[(k * 8 + warp) * 64 + 8 * j + 2 * lane] = q[k][j][0];
          red[(k * 8 + warp) * 64 + 8 * j + 2 * lane + 1] = q[k][j][1];
        }
    asm volatile("bar.sync 1, %0;" ::"n"(4 * kConsumers * 32) : "memory");
    if (threadIdx.x < NQ * 64) {
      const int k = threadIdx.x / 64, c = threadIdx.x % 64;
      float sum = red[(k * 8) * 64 + c];
#pragma unroll
      for (int w = 1; w < 4 * kConsumers; ++w)
        sum = __fadd_rn(sum, red[(k * 8 + w) * 64 + c]);
      e.part[((size_t)gtile * NQ + k) * 64 + c] = sum;
    }
  }
}

// K8a's conv1 (EPI 12; ParamsK8a says what it writes), on K2's plan for
// 64 -> 64, registers as rcab_epilogue's: h = relu(sums + bias) in f32, hi
// = bf16(h), lo = bf16(h - hi), the pair stored at channels c and 64 + c
// of the pixel's 128. Pixels outside the image are not stored: conv2's
// TMA zero fill is their h1, as SAME padding wants.
__device__ __forceinline__ void hilo_epilogue(float (&acc)[1][32],
                                              const ParamsK8a& p, int warp,
                                              int lane, int b, int y0,
                                              int x0) {
  constexpr int J = 8;
  const int gy = y0 + warp, cl = 2 * (lane & 3);
  if (gy >= p.H) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gx = x0 + (lane >> 2) + 8 * h;
    if (gx >= p.W) continue;
    const size_t pix = ((size_t)b * p.H + gy) * p.W + gx;
    bf16* const v = p.out + pix * 128 + cl;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const float h0 = fmaxf(
          __fadd_rn(acc[0][4 * j + 2 * h], __ldg(p.bias + cl + 8 * j)), 0.0f);
      const float h1 = fmaxf(__fadd_rn(acc[0][4 * j + 2 * h + 1],
                                       __ldg(p.bias + cl + 8 * j + 1)),
                             0.0f);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(h0, h1);
      const float2 f = __bfloat1622float2(hi);
      *reinterpret_cast<__nv_bfloat162*>(v + 8 * j) = hi;
      *reinterpret_cast<__nv_bfloat162*>(v + 64 + 8 * j) =
          __floats2bfloat162_rn(__fsub_rn(h0, f.x), __fsub_rn(h1, f.y));
      if (p.h1)
        *reinterpret_cast<__nv_bfloat162*>(p.h1 + pix * 64 + cl + 8 * j) = hi;
    }
  }
}

// K9d's dh1 (EPI 16, TB; ParamsK5), on K2's plan for 128 -> 64 over the
// [hi | lo] pair of gs, registers as rcab_epilogue's: dh1 = h1 > 0 ? sums
// : 0 in f32 (h1 = k5.h, pixel stride 64; EPI 5's mask), split into hi =
// bf16(dh1) and lo = bf16(dh1 - hi) and stored at channels c and 64 + c
// of the pixel's 128 (EPI 12's split). Pixels outside the image are not
// stored: the dx launch's TMA zero fill is their dh1, as SAME padding
// wants.
__device__ __forceinline__ void dh1_epilogue(float (&acc)[1][32],
                                             const ParamsK5& p, int warp,
                                             int lane, int b, int y0,
                                             int x0) {
  constexpr int J = 8;
  const int gy = y0 + warp, cl = 2 * (lane & 3);
  if (gy >= p.H) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gx = x0 + (lane >> 2) + 8 * h;
    if (gx >= p.W) continue;
    const size_t pix = ((size_t)b * p.H + gy) * p.W + gx;
    // the pixel's mask loads together, then its stores
    __nv_bfloat162 t[J];
#pragma unroll
    for (int j = 0; j < J; ++j)
      t[j] = *reinterpret_cast<const __nv_bfloat162*>(p.k5.h + pix * 64 +
                                                      cl + 8 * j);
    bf16* const v = p.out + pix * 128 + cl;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const float2 m = __bfloat1622float2(t[j]);
      const float d0 = m.x > 0.0f ? acc[0][4 * j + 2 * h] : 0.0f;
      const float d1 = m.y > 0.0f ? acc[0][4 * j + 2 * h + 1] : 0.0f;
      const __nv_bfloat162 hi = __floats2bfloat162_rn(d0, d1);
      const float2 f = __bfloat1622float2(hi);
      *reinterpret_cast<__nv_bfloat162*>(v + 8 * j) = hi;
      *reinterpret_cast<__nv_bfloat162*>(v + 64 + 8 * j) =
          __floats2bfloat162_rn(__fsub_rn(d0, f.x), __fsub_rn(d1, f.y));
    }
  }
}

// K3's forward (EPI 13; ParamsK3): the block's NAT atoms are phases p0 ..
// p0 + NAT - 1 (p0 = n0 / 64) of phase row a = p0 / r (NAT divides r), so
// a coarse pixel (gy, gx) puts them on fine pixels (r gy + a, r gx + b0 +
// at), b0 = p0 % r: one run of NAT * 64 channels of the fine image. out =
// bf16(sums + bias), the bias phase-major; registers as rcab_epilogue's.
template <int NAT>
__device__ __forceinline__ void shuffle_epilogue(float (&acc)[NAT][32],
                                                 const ParamsK3& p, int warp,
                                                 int lane, int b, int y0,
                                                 int x0, int n0) {
  constexpr int J = 8;
  const int gy = y0 + warp, cl = 2 * (lane & 3);
  if (gy >= p.H) return;
  const int p0 = n0 / 64, a = p0 / p.r, b0 = p0 - a * p.r;
  const size_t fw = (size_t)p.r * p.W;  // fine pixels a fine row
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gx = x0 + (lane >> 2) + 8 * h;
    if (gx >= p.W) continue;
    bf16* const dst =
        p.out +
        ((((size_t)b * p.H + gy) * p.r + a) * fw + (size_t)p.r * gx + b0) *
            64 +
        cl;
#pragma unroll
    for (int at = 0; at < NAT; ++at)
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int c = n0 + at * 64 + cl + 8 * j;
        *reinterpret_cast<__nv_bfloat162*>(dst + at * 64 + 8 * j) =
            __floats2bfloat162_rn(acc[at][4 * j + 2 * h] + __ldg(p.bias + c),
                                  acc[at][4 * j + 2 * h + 1] +
                                      __ldg(p.bias + c + 1));
      }
  }
}

// Blocks an SM is to hold: two where the f32 sums (BN / 2 a thread) and
// A's two register buffers (8 NKS) leave room for two blocks' registers.
__host__ __device__ constexpr int min_blocks(int bn, int nks) {
  return bn / 2 + 8 * nks <= 72 ? 2 : 1;
}

// One block: an 8 x 16 pixel tile of image blockIdx.y, output channels
// [n0, n0 + NA * NAT) with n0 = (c % ntiles) * NA * NAT, c = blockIdx.x /
// SPLIT; tile c / ntiles in row-major order over the image's tiles. B is
// NAT atoms of NA channels (NA = 64, 32 or 16: 128-, 64- or 32-byte
// swizzle), one m64nNAk16 wgmma per atom and k16 step; a channel slice
// is NKS = KC / 16 such steps. SPLIT = 2: a cluster of two blocks shares
// the tile, each summing half of the channel slices; block 1 adds its f32
// sums into block 0's shared memory, and block 0 adds them to its own
// (the first half's sum plus the second's, a fixed order) and stores.
// TB (the backward's dx): w is the forward's HWIO weight (k, k, cout, cin)
// of the conv whose input gradient this is, read K-major (wgmma's
// untransposed B) with its taps in reverse order: the transposed conv,
// with no transposed copy of the weight. EPI: 0, K2's (one HWIO weight,
// bf16(act(sums + bias)) stored at pixel stride cout); 1 and 2, K6's
// (ParamsK6): 1 the forward's dense layers (K2's epilogue at an output
// pixel stride), 2 the backward chain's, 3 the fusion's residual; 4 and
// 5, K5's (ParamsK5); 6, K1's (ParamsK1); 7 and 8, K7's; 9-11, K4's; 12,
// K8a's conv1 and 15 its conv2; 13 and 14, K3's (14 reads x through the
// fine map); 16 and 17, K9d's (x a [hi | lo] pair, TB).
template <int NA, int NAT, int NKS, int SPLIT, bool TB, int EPI>
__global__ void __launch_bounds__(kThreads, min_blocks(NA * NAT, NKS))
    conv_sm90_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap,
                     const typename ParamsFor<EPI>::type p) {
  static_assert(SPLIT == 1 || SPLIT == 2, "cin whole, or in two halves");
  static_assert(EPI != 2 || SPLIT == 1, "the chain's sums are whole");
  constexpr int BN = NA * NAT, KC = 16 * NKS;
  constexpr uint32_t BROW = NA * 2;   // bytes of one B row (one ci) of an atom
  constexpr uint32_t BTAP = KC * BROW;  // one tap of an atom
  constexpr uint32_t RB = KC * 2;       // A's pixel (swizzle row) bytes
  constexpr uint32_t AMASK = KC / 8 - 1;  // its swizzle: 7, 3 or 1
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t a_ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t b_ring = a_ring + p.sa * p.a_stage;
  // a_full[sa], a_empty[sa], b_full[sb], b_empty[sb]
  const Ring a_full{b_ring + p.sb * p.b_stage, p.sa};
  const Ring a_empty{a_full.bar + 8u * p.sa, p.sa};
  const Ring b_full{a_empty.bar + 8u * p.sa, p.sb};
  const Ring b_empty{b_full.bar + 8u * p.sb, p.sb};

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rank = blockIdx.x % SPLIT, cta = blockIdx.x / SPLIT;
  const int n_tile = cta % p.ntiles, tile = cta / p.ntiles;
  const int y0 = (tile / p.tiles_x) * kTH, x0 = (tile % p.tiles_x) * kTW;
  const int b = blockIdx.y, n0 = n_tile * BN, halo = p.kk / 2;
  const int rows = p.taps / p.tg;  // B stages per slice
  // this block's channel slices
  const int s0 = rank * p.nslices / SPLIT;
  const int s1 = (rank + 1) * p.nslices / SPLIT;
  float acc[NAT][NA / 2];

  if (threadIdx.x == 0) {
    a_full.init(1);
    a_empty.init(4 * kConsumers);
    b_full.init(1);
    b_empty.init(4 * kConsumers);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == 4 * kConsumers) {
    // The producer: every TMA load, in the order the consumers use them.
    if (lane == 0) {
      int g = 0;
      for (int s = s0; s < s1; ++s) {
        const int sa = (s - s0) % p.sa;
        a_empty.wait_free(s - s0);
        mbar_expect_tx(a_full.at(s - s0), p.a_bytes);
        if constexpr (EPI == 14) {
          // the fine cotangent: channel c of the phase-major view is
          // channel c % 64 of phase (a, b) = (c / 64 / r, c / 64 % r)
          const int c = s * KC, ph = c / 64;
          tma_load_5d(a_ring + sa * p.a_stage, &xmap, a_full.at(s - s0),
                      (ph % p.r) * 64 + c % 64, x0 - halo, ph / p.r,
                      y0 - halo, b);
        } else {
          tma_load_4d(a_ring + sa * p.a_stage, &xmap, a_full.at(s - s0),
                      s * KC, x0 - halo, y0 - halo, b);
        }
        for (int r = 0; r < rows; ++r, ++g) {
          const int sb = g % p.sb;
          b_empty.wait_free(g);
          mbar_expect_tx(b_full.at(g), p.b_bytes);
          // TB: the stage's taps come from the far end, in reverse
          const int tap0 = TB ? p.taps - (r + 1) * p.tg : r * p.tg;
#pragma unroll
          for (int at = 0; at < NAT; ++at) {
            const uint32_t dst = b_ring + sb * p.b_stage + at * p.tg * BTAP;
            // pair_k: both halves of the pair read the weight's K rows
            const int n = n0 + at * NA,
                      k = pair_k(EPI) ? s % (p.nslices / 2) * KC : s * KC;
            bool pairs = false;
            if constexpr (k6_epi(EPI)) pairs = p.wgroups;
            if (!pairs) {  // one HWIO tensor: the 3-D map
              if (TB)
                tma_load_3d(dst, &wmap, b_full.at(g), k, n, tap0);
              else
                tma_load_3d(dst, &wmap, b_full.at(g), n, k, tap0);
            } else if constexpr (k6_epi(EPI)) {
              // pairs: the atom's N and the slice's K as (group, offset)
              const int gn = n / p.wgn, gk = k / p.wgk;
              if (TB)
                tma_load_5d(dst, &wmap, b_full.at(g), k - gk * p.wgk,
                            n - gn * p.wgn, tap0, gk, gn);
              else
                tma_load_5d(dst, &wmap, b_full.at(g), n - gn * p.wgn,
                            k - gk * p.wgk, tap0, gk, gn);
            }
          }
        }
      }
    }
    __syncwarp();  // the warp meets the cluster barriers converged
  } else {
    // The consumers: warp w of warpgroup g holds tile row oy = 4 g + w, its
    // 16 pixels the warpgroup's wgmma rows 16 w .. 16 w + 15.
    const int oy = warp;
    const int frow = (lane & 7) + (lane & 8);  // ldmatrix row: column ox
    const int fchunk = lane >> 4;              // its 16-byte chunk of a k16
    // B descriptors, one atom an instruction (no LBO): N-major, rows of NA
    // output channels, the 8-row groups (SBO) 8 rows apart, swizzle 128 / 64
    // / 32 bytes (layout 1 / 2 / 3) as NA is 64 / 32 / 16; TB: K-major, rows
    // of KC input channels, swizzled as A's
    constexpr uint32_t BSWZ = TB ? RB : BROW;
    constexpr uint64_t desc_hi =
        ((uint64_t)1 << 16) | ((uint64_t)((8 * BSWZ) >> 4) << 32) |
        ((uint64_t)(BSWZ == 128 ? 1 : BSWZ == 64 ? 2 : 3) << 62);

  #pragma unroll
    for (int at = 0; at < NAT; ++at)
  #pragma unroll
      for (int j = 0; j < NA / 2; ++j) acc[at][j] = 0.0f;

    // One (slice, tap) step i with A's registers a.
    auto step = [&](int i, uint32_t(&a)[NKS][4]) {
      const int s = i / p.taps, t = i - s * p.taps;  // s counts from s0
      const int g = i / p.tg, tg = i - g * p.tg;  // B stage, its tap
      const int sa = s % p.sa, sb = g % p.sb;
      if (t == 0) {
        a_full.wait(s);
        if constexpr (EPI == 9) {
          // REFLECT: the ring outside the image takes the mirrored pixel
          // (one slice: K4 runs at cin 64, so no later TMA load reuses
          // the stage)
          if (p.k4.reflect && (y0 == 0 || x0 == 0 || y0 + kTH >= p.H ||
                               x0 + kTW >= p.W)) {
            if (warp == 0)
              mirror_halo<KC>(smem_raw + (a_ring + sa * p.a_stage -
                                          smem_u32(smem_raw)),
                              lane, y0, x0, p.H, p.W, p.wx, kTH + 2);
            asm volatile("bar.sync 2, %0;" ::"n"(4 * kConsumers * 32)
                         : "memory");
          }
        }
      }
      if (tg == 0) b_full.wait(g);
      const int ty = t / p.kk, tx = t - ty * p.kk;
      const uint32_t pix = (oy + ty) * p.wx + frow + tx;
      const uint32_t a_base = a_ring + sa * p.a_stage;
  #pragma unroll
      for (int ks = 0; ks < NKS; ++ks) {
        ldmatrix_x4(a[ks], a_base + swz(pix * RB + (2 * ks + fchunk) * 16,
                                        AMASK));
      }
      if (t == p.taps - 1) {  // the slice's A is in registers: free its stage
        __syncwarp();
        if (lane == 0) a_empty.arrive(s);
        __syncwarp();
      }
      const uint32_t b_base =
          b_ring + sb * p.b_stage + (TB ? p.tg - 1 - tg : tg) * BTAP;
      const uint32_t atom = p.tg * BTAP;
  #pragma unroll
      for (int at = 0; at < NAT; ++at) fence_acc(acc[at]);
      wgmma_fence();
  #pragma unroll
      for (int ks = 0; ks < NKS; ++ks) {
  #pragma unroll
        for (int at = 0; at < NAT; ++at) {
          // the next k16 step: 16 rows on (N-major), 32 bytes on (K-major)
          const uint32_t addr =
              b_base + at * atom + ks * (TB ? 32u : 16 * BROW);
          wgmma_rs<NA, TB>(acc[at], a[ks], desc_hi | ((addr & 0x3FFFFu) >> 4));
        }
      }
      wgmma_commit();
  #pragma unroll
      for (int at = 0; at < NAT; ++at) fence_acc(acc[at]);
      if constexpr (NAT == 1) {
        // One atom: ptxas would serialize these wgmmas behind the next
        // step's ldmatrix anyway, so wait here and free this step's stage.
        wgmma_wait<0>();
        if (tg == p.tg - 1) {
          __syncwarp();
          if (lane == 0) b_empty.arrive(g);
          __syncwarp();
        }
      } else {
        wgmma_wait<1>();  // step i - 1's wgmmas are done
        if (i > 0 && tg == 0) {  // and it was its B stage's last tap
          __syncwarp();
          if (lane == 0) b_empty.arrive(g - 1);
          __syncwarp();
        }
      }
    };

    uint32_t a0[NKS][4], a1[NKS][4];
    const int steps = (s1 - s0) * p.taps;
    for (int i = 0; i < steps; i += 2) {
      step(i, a0);
      if (i + 1 < steps) step(i + 1, a1);
    }
    wgmma_wait<0>();
  #pragma unroll
    for (int at = 0; at < NAT; ++at) fence_acc(acc[at]);
  }

  if constexpr (SPLIT > 1) {
    // Block 0's rings are idle once both blocks are past this point: block
    // 1's 256 x BN / 2 f32 sums land there, and block 0 adds them to its
    // own (the first half's sum plus the second's).
    namespace cg = cooperative_groups;
    cg::cluster_group cluster = cg::this_cluster();
    constexpr int R = NAT * (NA / 2), T = 4 * kConsumers * 32;
    float* red = reinterpret_cast<float*>(smem_raw + (a_ring -
                                                      smem_u32(smem_raw)));
    const bool consumer = warp < 4 * kConsumers;
    cluster.sync();
    if (consumer && rank > 0) {
      float* dst = cluster.map_shared_rank(red, 0) + (rank - 1) * R * T;
#pragma unroll
      for (int at = 0; at < NAT; ++at)
#pragma unroll
        for (int j = 0; j < NA / 2; ++j)
          dst[(at * (NA / 2) + j) * T + threadIdx.x] = acc[at][j];
    }
    cluster.sync();
    if (consumer && rank == 0) {
#pragma unroll
      for (int r = 0; r < SPLIT - 1; ++r)
#pragma unroll
        for (int at = 0; at < NAT; ++at)
#pragma unroll
          for (int j = 0; j < NA / 2; ++j)
            acc[at][j] += red[(r * R + at * (NA / 2) + j) * T + threadIdx.x];
    }
  }
  if (warp == 4 * kConsumers || rank > 0) return;
  if constexpr (EPI == 2) {
    // the 2 KB after the barriers; the tile's index over the images
    const uint32_t red = b_empty.bar + 8u * p.sb;
    chain_epilogue<NA, NAT>(
        acc, p,
        reinterpret_cast<float*>(smem_raw + (red - smem_u32(smem_raw))),
        warp, lane, b, y0, x0, n0,
        b * (int)(gridDim.x / (p.ntiles * SPLIT)) + tile);
    return;
  }
  if constexpr (EPI == 4 || EPI == 5) {
    static_assert(NA == 64 && NAT == 1 && SPLIT == 1, "K2's 64 -> 64 plan");
    const uint32_t red = b_empty.bar + 8u * p.sb;
    rcab_epilogue<EPI>(
        acc, p,
        reinterpret_cast<float*>(smem_raw + (red - smem_u32(smem_raw))),
        warp, lane, b, y0, x0, b * (int)(gridDim.x / p.ntiles) + tile);
    return;
  }
  if constexpr (EPI == 6 || EPI == 15) {
    static_assert(NA == 64 && NAT == 1 && SPLIT == 1, "N = 64");
    trunk_epilogue<EPI == 15>(acc, p, warp, lane, b, y0, x0);
    return;
  }
  if constexpr (EPI == 12) {
    static_assert(NA == 64 && NAT == 1 && SPLIT == 1, "K2's 64 -> 64 plan");
    hilo_epilogue(acc, p, warp, lane, b, y0, x0);
    return;
  }
  if constexpr (EPI == 16 || EPI == 17) {
    static_assert(NA == 64 && NAT == 1 && SPLIT == 1 && TB,
                  "K2's transposed plan for 128 -> 64");
    if constexpr (EPI == 16)
      dh1_epilogue(acc, p, warp, lane, b, y0, x0);
    else  // EPI 5's dx form: bf16(sums + f32(g)), g = k5.res
      rcab_epilogue<5>(acc, p, nullptr, warp, lane, b, y0, x0, 0);
    return;
  }
  if constexpr (EPI == 13) {
    static_assert(NA == 64 && SPLIT == 1, "phases of 64 channels");
    shuffle_epilogue<NAT>(acc, p, warp, lane, b, y0, x0, n0);
    return;
  }
  if constexpr (EPI >= 9 && EPI <= 11) {
    static_assert(NA == 64 && NAT == 1 && SPLIT == 1 && NKS == 4,
                  "K2's 64 -> 64 plan");
    const uint32_t red = b_empty.bar + 8u * p.sb;
    bn_epilogue<EPI>(
        acc, p,
        reinterpret_cast<float*>(smem_raw + (red - smem_u32(smem_raw))),
        warp, lane, b, y0, x0, b * (int)(gridDim.x / p.ntiles) + tile);
    return;
  }
  if constexpr (EPI == 7 || EPI == 8) {
    static_assert(SPLIT == 1, "K7's sums are whole");
    const uint32_t red = b_empty.bar + 8u * p.sb;
    k7_epilogue<EPI, NA, NAT>(
        acc, p,
        reinterpret_cast<float*>(smem_raw + (red - smem_u32(smem_raw))),
        warp, lane, b, y0, x0, n0, b * (int)(gridDim.x / p.ntiles) + tile);
    return;
  }

  // Epilogue: register d[4 j + 2 h + e] of an atom is pixel column
  // lane / 4 + 8 h, channel 8 j + 2 (lane % 4) + e.
  const int oy = warp;
  const int gy = y0 + oy;
  if (gy >= p.H) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int gx = x0 + (lane >> 2) + 8 * h;
    if (gx >= p.W) continue;
    const int c0 = n0 + 2 * (lane & 3);
    const size_t pix = ((size_t)b * p.H + gy) * p.W + gx;
    bf16* dst;
    if constexpr (!k6_epi(EPI))
      dst = p.out + pix * p.cout + c0;
    else
      dst = p.out + pix * p.ops + c0;
#pragma unroll
    for (int at = 0; at < NAT; ++at) {
#pragma unroll
      for (int j = 0; j < NA / 8; ++j) {
        const int c = at * NA + 8 * j;
        float v0 = acc[at][4 * j + 2 * h], v1 = acc[at][4 * j + 2 * h + 1];
        if (p.bias) {
          v0 += __ldg(p.bias + c0 + c);
          v1 += __ldg(p.bias + c0 + c + 1);
        }
        if (p.relu) {
          v0 = fmaxf(v0, 0.0f);
          v1 = fmaxf(v1, 0.0f);
        }
        if constexpr (EPI == 3) {  // the residual, added after the bias
          const float2 r = __bfloat1622float2(
              *reinterpret_cast<const __nv_bfloat162*>(p.res + pix * p.rps +
                                                       c0 + c));
          v0 = r.x + v0;
          v1 = r.y + v1;
        }
        const __nv_bfloat162 o = __floats2bfloat162_rn(v0, v1);
        *reinterpret_cast<__nv_bfloat162*>(dst + c) = o;
        if constexpr (EPI == 3) {
          if (p.out2)
            *reinterpret_cast<__nv_bfloat162*>(p.out2 + pix * p.o2ps + c0 +
                                               c) = o;
        }
      }
    }
  }
}

// Blocks of ``kernel`` an SM holds by its registers and threads.
template <class K>
int blocks_per_sm(K kernel) {
  int blocks = 1;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, 0);
  return blocks < 1 ? 1 : blocks > 3 ? 3 : blocks;
}

// One launch's operands. x: (B, H, W, xps) bf16, of which the conv reads
// channels [0, cin). w: the HWIO weight (k, k, cin, cout) (TB: the
// forward's (k, k, cout, cin)); with pack_k (pack_n) its K (N) in 64-
// channel groups, each group's (k, k, 64, cout) ((k, k, cin, 64)) block
// whole and the groups consecutive: K6's pairs (rdn.py:pack). out: (B, H,
// W, ops) bf16, channels [0, cout) written. res, out2: EPI 3's; ch: EPI
// 2's (its dbuf at pixel stride ops); k5: EPI 4's and 5's; k1: EPI 6's;
// k4: EPI 9-11's; h1: EPI 12's (out its [hi | lo] pair, ops = cout all
// the same); r: EPI 13's and 14's (x of EPI 14 the fine cotangent, xps =
// cin); EPI 16 and 17 (k5: h, res) read a (k, k, cout, cin / 2) w.
// EPI 0 (K2), 4, 5 (K5) and 6 (K1) take xps = cin, ops = cout and one
// HWIO weight.
struct ConvArgs {
  const bf16* x;
  int xps;
  const bf16* w;
  int pack_k, pack_n;
  const float* bias;
  void* out;
  int ops;
  int B, H, W, cin, cout, kk, relu;
  const bf16* res;
  int rps;
  bf16* out2;
  int o2ps;
  ChainEpi ch;
  RcabEpi k5;
  TrunkEpi k1;
  BnEpi k4;
  bf16* h1;
  int r;
};

// Launch the engine at BN = NA * NAT (a divisor of cout), KC = 16 NKS
// (the largest of 64, 32, 16 that divides cin), each tile's channel
// slices split over SPLIT blocks of a cluster.
template <int NA, int NAT, int NKS, int SPLIT, bool TB, int EPI>
cudaError_t launch(const ConvArgs& a, cudaStream_t stream) {
  constexpr int BN = NA * NAT, KC = 16 * NKS;
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  if (!k6_epi(EPI) &&
      (a.xps != a.cin || a.ops != a.cout || a.pack_k || a.pack_n))
    return cudaErrorInvalidValue;
  auto kernel = conv_sm90_kernel<NA, NAT, NKS, SPLIT, TB, EPI>;
  static const cudaError_t allowed = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (allowed != cudaSuccess) return allowed;
  const int B = a.B, H = a.H, W = a.W, cin = a.cin, cout = a.cout, kk = a.kk;
  const int wx = kTW + kk - 1, hx = kTH + kk - 1;
  const uint32_t a_bytes = (uint32_t)KC * 2 * wx * hx;
  const uint32_t b_tap = (uint32_t)KC * BN * 2;
  const int sa = cin / KC < 2 ? cin / KC : 2;
  // EPI 2, 4: the tile sums' warp sums after the barriers
  const int fixed = 1024 + sa * (int)align1024(a_bytes) + 16 * (sa + 8) +
                    red_bytes(EPI, BN);
  // B stages of a row of k taps, two of them beside A, in the shared
  // memory of as many blocks an SM as the registers allow (looked up once
  // for this instance) or as fewer blocks make room for (rows of taps
  // measured faster than more blocks); where no block count has room,
  // stages of one tap at the registers' count
  static const int per_sm = blocks_per_sm(kernel);
  const int rows2 = fixed + 2 * (int)align1024(kk * b_tap);
  int blocks = per_sm;
  while (blocks > 1 && rows2 > kSmPool / blocks - 1024) --blocks;
  int tg = kk;
  if (rows2 > kSmPool / blocks - 1024) {
    tg = 1;
    blocks = per_sm;
  }
  const int budget = kSmPool / blocks - 1024;
  const uint32_t b_bytes = tg * b_tap;
  int sb = (budget - fixed) / (int)align1024(b_bytes);
  sb = sb < 2 ? 2 : sb > 8 ? 8 : sb;

  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  CUtensorMap xmap, wmap;
  // x as (cin, W, H, B) at pixel stride xps; one box is the tile with its
  // halo, KC channels
  const cuuint64_t xps = (cuuint64_t)a.xps * 2;
  const cuuint64_t xdim[4] = {(cuuint64_t)cin, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t xstride[3] = {xps, W * xps, H * W * xps};
  const cuuint32_t xbox[4] = {(cuuint32_t)KC, (cuuint32_t)wx, (cuuint32_t)hx,
                              1};
  // EPI 14: the fine (B, r H, r W, 64) cotangent as (r 64, W, r, H, B) at
  // coarse H x W; one box is KC channels of one phase (a, b), the tile
  // with its halo (wgrad.cu's encode_fine, with the halo)
  const cuuint64_t frow = (cuuint64_t)a.r * W * 64 * 2;  // a fine row
  const cuuint64_t fdim[5] = {(cuuint64_t)a.r * 64, (cuuint64_t)W,
                              (cuuint64_t)a.r, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t fstride[4] = {(cuuint64_t)a.r * 64 * 2, frow, a.r * frow,
                                 H * a.r * frow};
  const cuuint32_t fbox[5] = {(cuuint32_t)KC, (cuuint32_t)wx, 1,
                              (cuuint32_t)hx, 1};
  if (EPI == 14 ? encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5,
                         const_cast<bf16*>(a.x), fdim, fstride, fbox, ones,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(KC * 2),
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS
                : encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                         const_cast<bf16*>(a.x), xdim, xstride, xbox, ones,
                         CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(KC * 2),
                         CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                         CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  // w as (cout, cin, k * k), or in pairs (cout, cin, k * k, K groups, N
  // groups) of groups wgk x wgn; one box an atom: NA channels of KC rows
  // of tg taps; TB: (cin, cout, ...), one box KC channels of NA rows
  const int wgroups = a.pack_k || a.pack_n;
  const int wgk = a.pack_k ? 64 : pair_k(EPI) ? cin / 2 : cin;
  const int wgn = a.pack_n ? 64 : cout;
  const int inner = TB ? wgk : wgn, outer = TB ? wgn : wgk;
  const cuuint64_t group = (cuuint64_t)kk * kk * wgk * wgn * 2;
  const cuuint64_t wdim[5] = {(cuuint64_t)inner, (cuuint64_t)outer,
                              (cuuint64_t)kk * kk, (cuuint64_t)(cin / wgk),
                              (cuuint64_t)(cout / wgn)};
  const cuuint64_t wstride[4] = {(cuuint64_t)inner * 2,
                                 (cuuint64_t)wgk * wgn * 2, group,
                                 group * (cin / wgk)};
  const cuuint32_t wbox[5] = {(cuuint32_t)(TB ? KC : NA),
                              (cuuint32_t)(TB ? NA : KC), (cuuint32_t)tg, 1,
                              1};
  if (encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, wgroups ? 5 : 3,
             const_cast<bf16*>(a.w), wdim, wstride, wbox, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(TB ? KC * 2 : NA * 2),
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;

  typename ParamsFor<EPI>::type p = {};
  p.bias = a.bias;
  p.out = static_cast<bf16*>(a.out);
  p.H = H;
  p.W = W;
  p.cout = cout;
  p.relu = a.relu;
  p.kk = kk;
  p.taps = kk * kk;
  p.nslices = cin / KC;
  p.wx = wx;
  p.tiles_x = (W + kTW - 1) / kTW;
  p.ntiles = cout / BN;
  p.tg = tg;
  p.sa = sa;
  p.sb = sb;
  p.a_bytes = a_bytes;
  p.b_bytes = b_bytes;
  p.a_stage = align1024(a_bytes);
  p.b_stage = align1024(b_bytes);
  if constexpr (k6_epi(EPI)) {
    p.ops = a.ops;
    p.wgroups = wgroups;
    p.wgk = wgk;
    p.wgn = wgn;
    p.res = a.res;
    p.out2 = a.out2;
    p.rps = a.rps;
    p.o2ps = a.o2ps;
    p.ch = a.ch;
  }
  if constexpr (EPI == 4 || EPI == 5 || EPI == 7 || EPI == 8 || pair_k(EPI))
    p.k5 = a.k5;
  if constexpr ((EPI >= 6 && EPI <= 8) || EPI == 15) p.k1 = a.k1;
  if constexpr (EPI >= 9 && EPI <= 11) p.k4 = a.k4;
  if constexpr (EPI == 12) p.h1 = a.h1;
  if constexpr (EPI == 13 || EPI == 14) p.r = a.r;
  const int smem = 1024 + sa * p.a_stage + sb * p.b_stage + 16 * (sa + sb) +
                   red_bytes(EPI, BN);
  if (smem > kMaxSmem) return cudaErrorInvalidConfiguration;
  // a split's partial sums land in block 0's rings: 256 threads x BN / 2
  // f32 from each other block
  if (SPLIT > 1 && sa * p.a_stage + sb * p.b_stage <
                       (uint32_t)(SPLIT - 1) * (4 * kConsumers * 32) *
                           (BN / 2) * 4)
    return cudaErrorInvalidConfiguration;

  const int tiles = p.tiles_x * ((H + kTH - 1) / kTH);
  dim3 grid(tiles * p.ntiles * SPLIT, B);
  if (SPLIT == 1) {
    kernel<<<grid, kThreads, smem, stream>>>(xmap, wmap, p);
    return cudaGetLastError();
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = SPLIT;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, xmap, wmap, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// Where cout is at most 64 (so a block's sums are few), cin has four
// 64-channel slices or more and the blocks would not fill the card twice
// over, two blocks share each tile, each summing half of cin.
inline bool split_cin(const ConvArgs& a, int bn) {
  const long blocks = (long)((a.W + kTW - 1) / kTW) *
                      ((a.H + kTH - 1) / kTH) * (a.cout / bn) * a.B;
  return bn <= 64 && a.cin % 64 == 0 && a.cin >= 256 &&
         blocks < 2L * sm_count();
}

// The channel slices and split for BN = NA * NAT (not under the chain's
// epilogue, whose sums are whole).
template <int NA, int NAT, bool TB, int EPI>
cudaError_t launch_kc(const ConvArgs& a, cudaStream_t s) {
  if constexpr (NA * NAT <= 64 && EPI != 2) {
    if (split_cin(a, NA * NAT)) return launch<NA, NAT, 4, 2, TB, EPI>(a, s);
  }
  if (a.cin % 64 == 0) return launch<NA, NAT, 4, 1, TB, EPI>(a, s);
  if (a.cin % 32 == 0) return launch<NA, NAT, 2, 1, TB, EPI>(a, s);
  return launch<NA, NAT, 1, 1, TB, EPI>(a, s);
}

// The operands' shapes the engine takes: k = 1, 3 or 5, channel counts
// multiples of 16, the strides at least the channels and 16-byte
// multiples, a pack of 64-channel groups where its extent is a multiple
// of 64.
inline bool takes(const ConvArgs& a) {
  return a.cin > 0 && a.cout > 0 && a.cin % 16 == 0 && a.cout % 16 == 0 &&
         (a.kk == 1 || a.kk == 3 || a.kk == 5) && a.B > 0 && a.B <= 65535 &&
         a.H > 0 && a.W > 0 && a.xps >= a.cin && a.xps % 8 == 0 &&
         a.ops >= a.cout && (!a.pack_k || a.cin % 64 == 0) &&
         (!a.pack_n || a.cout % 64 == 0);
}

// K6's launches (EPI 1-3), cin and cout multiples of 64: only the
// instances those reach, N and the split of cin picked as conv picks them
// (the fusion's, EPI 3, at cout 64 alone).
template <bool TB, int EPI>
cudaError_t run64(const ConvArgs& a, cudaStream_t s) {
  static_assert(k6_epi(EPI), "K6's epilogues");
  if (!takes(a) || a.cin % 64 || a.cout % 64) return cudaErrorInvalidValue;
  if constexpr (EPI != 3) {
    if (a.cout % 192 == 0) return launch<64, 3, 4, 1, TB, EPI>(a, s);
    if (a.cout % 128 == 0) return launch<64, 2, 4, 1, TB, EPI>(a, s);
  } else if (a.cout != 64) {
    return cudaErrorInvalidValue;
  }
  if constexpr (EPI != 2) {
    if (split_cin(a, 64)) return launch<64, 1, 4, 2, TB, EPI>(a, s);
  }
  return launch<64, 1, 4, 1, TB, EPI>(a, s);
}

// The operands of a 3x3 64 -> 64 launch over the (B, H, W) images, x, w
// and out at K2's strides (K5's and K1's convs); bias may be null.
inline ConvArgs args_3x3_64(const bf16* x, const bf16* w, const float* bias,
                            bf16* out, int B, int H, int W) {
  ConvArgs a = {};
  a.x = x;
  a.xps = 64;
  a.w = w;
  a.bias = bias;
  a.out = out;
  a.ops = 64;
  a.B = B;
  a.H = H;
  a.W = W;
  a.cin = 64;
  a.cout = 64;
  a.kk = 3;
  a.ch.mask_chunk = -1;
  return a;
}

// K5's launches (EPI 4; 5 with TB) and K1's (EPI 6), 3x3 64 -> 64 on one
// HWIO weight: K2's plan for that class (N = 64, 64-channel slices, no
// split).
template <bool TB, int EPI>
cudaError_t run_3x3_64(const ConvArgs& a, cudaStream_t s) {
  static_assert(EPI >= 4 && EPI <= 6, "K5's and K1's epilogues");
  if (!takes(a) || a.cin != 64 || a.cout != 64 || a.kk != 3)
    return cudaErrorInvalidValue;
  return launch<64, 1, 4, 1, TB, EPI>(a, s);
}

// K4's launches (bn_block.cu), 3x3 64 -> 64 on one HWIO weight: EPI 9
// (F1, F2) forward, EPI 10 and 11 (B2, B3) with TB; K2's plan for that
// class (N = 64, one 64-channel slice, no split).
template <bool TB, int EPI>
cudaError_t run_bn(const ConvArgs& a, cudaStream_t s) {
  static_assert(EPI >= 9 && EPI <= 11 && TB == (EPI != 9), "K4's epilogues");
  if (!takes(a) || a.cin != 64 || a.cout != 64 || a.kk != 3)
    return cudaErrorInvalidValue;
  return launch<64, 1, 4, 1, TB, EPI>(a, s);
}

// K7's and K8c's launches (wdsr.cu), 3x3 on one HWIO weight: EPI 8, the
// block's 3x3 to C with the bias, res_scale and the skip; EPI 7 with TB,
// dh2 = convT(gs; W3) stored as bf16 with its per-tile channel sums. cin
// a multiple of 64 (K8c's [hi | lo] reads 2 C), cout 64 or 128: K2's
// plan for those classes (N = cout in atoms of 64, 64-channel slices, no
// split).
template <bool TB, int EPI>
cudaError_t run_3x3_wide(const ConvArgs& a, cudaStream_t s) {
  static_assert(EPI == 7 || EPI == 8, "K7's epilogues");
  if (!takes(a) || a.cin % 64 || a.kk != 3) return cudaErrorInvalidValue;
  if (a.cout == 128) return launch<64, 2, 4, 1, TB, EPI>(a, s);
  if (a.cout == 64) return launch<64, 1, 4, 1, TB, EPI>(a, s);
  return cudaErrorInvalidValue;
}

// K8a's conv1 (EPI 12), 3x3 64 -> 64 on one HWIO weight: K2's plan for
// that class; out the [hi | lo] pair (B, H, W, 128), h1 (B, H, W, 64) or
// null.
inline cudaError_t run_hilo(const ConvArgs& a, cudaStream_t s) {
  if (!takes(a) || a.cin != 64 || a.cout != 64 || a.kk != 3)
    return cudaErrorInvalidValue;
  return launch<64, 1, 4, 1, false, 12>(a, s);
}

// K8a's conv2 (EPI 15), 3x3 128 -> 64 over the [hi | lo] pair on W2
// stacked twice: K2's plan for that class (N = 64, two 64-channel
// slices, no split).
inline cudaError_t run_k8a_skip(const ConvArgs& a, cudaStream_t s) {
  if (!takes(a) || a.cin != 128 || a.cout != 64 || a.kk != 3)
    return cudaErrorInvalidValue;
  return launch<64, 1, 4, 1, false, 15>(a, s);
}

// K9d's transposed convs over a [hi | lo] pair (EPI 16: dh1, stored as
// its own pair; EPI 17: dx), 3x3 128 -> 64 on the forward's HWIO (3, 3,
// 64, 64) weight, read K-major for each half: K2's plan for that class
// (N = 64, two 64-channel slices, no split).
template <int EPI>
cudaError_t run_k9d(const ConvArgs& a, cudaStream_t s) {
  static_assert(pair_k(EPI), "K9d's epilogues");
  if (!takes(a) || a.cin != 128 || a.cout != 64 || a.kk != 3)
    return cudaErrorInvalidValue;
  return launch<64, 1, 4, 1, true, EPI>(a, s);
}

// K3's phases a block: d = 3, 2 or 1, the widest that divides r (so a
// block's phases lie in one phase row).
inline int k3_phases(int r) { return r % 3 == 0 ? 3 : r % 2 == 0 ? 2 : 1; }

// K3's forward (EPI 13): x (B, H, W, 64), w the phase-major HWIO weight
// (3, 3, 64, r r 64), cout = r r 64, N = 64 d (no split: N past 64).
inline cudaError_t run_k3_fwd(const ConvArgs& a, cudaStream_t s) {
  if (!takes(a) || a.r < 2 || a.cin != 64 || a.cout != a.r * a.r * 64 ||
      a.kk != 3)
    return cudaErrorInvalidValue;
  const int d = k3_phases(a.r);
  if (d == 3) return launch<64, 3, 4, 1, false, 13>(a, s);
  if (d == 2) return launch<64, 2, 4, 1, false, 13>(a, s);
  return launch<64, 1, 4, 1, false, 13>(a, s);
}

// K3's dx (EPI 14, TB): x the fine cotangent (B, r H, r W, 64) read
// phase-major at cin = r r 64, w the forward's phase-major weight (3, 3,
// 64, r r 64) read K-major, cout 64; K2's plan for r r 64 -> 64 (N = 64,
// the 2-block split where split_cin picks it).
inline cudaError_t run_k3_dx(const ConvArgs& a, cudaStream_t s) {
  if (!takes(a) || a.r < 2 || a.cin != a.r * a.r * 64 || a.cout != 64 ||
      a.kk != 3)
    return cudaErrorInvalidValue;
  if (split_cin(a, 64)) return launch<64, 1, 4, 2, true, 14>(a, s);
  return launch<64, 1, 4, 1, true, 14>(a, s);
}

// K2: x (B, H, W, cin) and w (k, k, cin, cout) HWIO, k = 3 or 5, out (B,
// H, W, cout); TB: the transposed conv of the forward weight w (k, k,
// cout, cin). The engine's N: the widest of 192, 128, 64, 48, 32, 16 that
// divides cout (every multiple of 16 has one). 256 would hold 128 f32
// sums a thread beside A's registers, past the 168 registers a thread
// gets.
template <bool TB>
cudaError_t conv(const void* x, const void* w, const void* b, void* out,
                 int B, int H, int W, int cin, int cout, int kk, int relu,
                 cudaStream_t s) {
  ConvArgs a = {};
  a.x = static_cast<const bf16*>(x);
  a.xps = cin;
  a.w = static_cast<const bf16*>(w);
  a.bias = static_cast<const float*>(b);
  a.out = out;
  a.ops = cout;
  a.B = B;
  a.H = H;
  a.W = W;
  a.cin = cin;
  a.cout = cout;
  a.kk = kk;
  a.relu = relu;
  if ((kk != 3 && kk != 5) || !takes(a)) return cudaErrorInvalidValue;
  if (cout % 192 == 0) return launch_kc<64, 3, TB, 0>(a, s);
  if (cout % 128 == 0) return launch_kc<64, 2, TB, 0>(a, s);
  if (cout % 64 == 0) return launch_kc<64, 1, TB, 0>(a, s);
  if (cout % 48 == 0) return launch_kc<16, 3, TB, 0>(a, s);
  if (cout % 32 == 0) return launch_kc<32, 1, TB, 0>(a, s);
  return launch_kc<16, 1, TB, 0>(a, s);
}

}  // namespace srt90
