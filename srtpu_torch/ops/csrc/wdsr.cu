// K7: WDSR-B's wide-activation block, NHWC bf16 activations, f32 sums:
//   h1  = bf16(relu(x W1 + b1))              1x1, C -> e = 6C
//   h2  = bf16(h1 W2 + b2)                   1x1, e -> Lp
//   out = bf16((conv3x3(h2; W3) + b3) * res_scale + x)   one rounding
// and its backward, from x and h2 (saved by the forward) and g, the
// cotangent of the block's output:
//   gs = bf16(g * res_scale), dh2 = convT(gs; W3) (f32), db2 = sum dh2,
//   dh2b = bf16(dh2), dh1 = [h1 > 0] dh2b W2^T (f32), db1 = sum dh1,
//   dh1b = bf16(dh1), dW2 = h1^T dh2b, dW1 = x^T dh1b,
//   dW3, db3 = the 3x3's weight grads on (h2, gs),
//   dx = bf16(g + dh1b W1^T)                 one rounding.
// The bottleneck L = int(0.8 C) runs padded to Lp = C with zero columns
// of W2 and b2 and zero input rows of W3 (srtpu_torch/ops/wdsr.py pads):
// exact, as srtpu's own L -> Lp padding is, and every product then runs
// at N or K a multiple of 64 (C = 64 or 128). A narrower C (a multiple
// of 16) runs padded the same way to the next of the two, with zero
// channels of x, zero rows of W1, zero columns of W1 and b1 up to e =
// 6C, zero output channels of W3 and b3; the wrapper slices them off.
//
// Replaces srtpu/ops/wdsr_cs.py:_fwd_call (body _fwd_kernel) and
// _bwd_call (_bwd_kernel), behind wdsr_block_cs.
//
// What bounds it on the H100. Per pixel the forward costs 2 (e C + L e +
// 9 L C) = 0.588 MFLOP at C = 128 (e = 768, L = 102): 9.64 GFLOP per
// block at the training shape (16 x 32 x 32), >= 9.7 us at 989 TFLOP/s,
// against ~8 MB that must move (x in, out out, the weights): >= 2.5 us at
// 3.35 TB/s. The backward does twice the work. Operations bound both.
// The 768-wide h1 is what a stock route must store (25 MB per block at
// the training shape in bf16) and read back; the TPU kernel keeps it in
// VMEM, and this forward keeps it in registers, one chunk at a time.
//
// Design: every product on wgmma (sm_90a), with sm90.cuh's TMA, mbarrier
// rings and wgmma helpers.
//  Forward (srt_wdsr_trunk_fwd, two launches a block):
//   wdsr_chain_fwd_kernel, the 1x1 pair as one chained GEMM. A block owns
//     128 pixels (flat rows of (B H W, C): a pointwise op), two consumer
//     warpgroups of 64 rows. TMA brings the x tile once; a producer warp
//     keeps W1's and W2's 64-wide e-chunks in flight in a ring. Per chunk
//     a warpgroup forms x W1c (x read by the tensor cores from the TMA
//     tile: wgmma's SS form), adds b1, applies ReLU and rounds h1c to
//     bf16 in registers, repacks those accumulators as the bf16 A
//     operand of the next wgmma (the register reuse FlashAttention-3
//     makes between its two products), and adds h1c W2c into the h2
//     sums, which stay in registers over all chunks: h1 never leaves the
//     registers. The next chunk's x W1c is issued behind h1c W2c (one
//     wait a chunk; measured no faster than a wait after each product,
//     the other warpgroup's products filling that gap). The epilogue adds
//     b2 and stores bf16 h2 once;
//   the 3x3 Lp -> C on K2's engine (conv_sm90.cuh) at EPI 8: out =
//     bf16((sums + b3) * res_scale + x), K1's EPI 6 math at N = C.
//  Backward (srt_wdsr_trunk_bwd), per block, the last first:
//   a gs pass where res_scale is not 1 (trunk.cu's; at 1 gs is g);
//   dh2 on K2's transposed engine (TB: W3 read K-major as it lies) at
//     EPI 7: dh2b and each 8 x 16 tile's f32 channel sums (db2's
//     partials, K5's EPI 4 order; the f32 dh2 itself is never stored);
//   wdsr_chain_bwd_kernel, the forward's chain run backwards, per 128-
//     pixel tile and e-chunk: h1c recomputed (its sign is the mask) and
//     stored bf16; dh1c = [h1c > 0] dh2b W2c^T (dh2b's tile as the SS A,
//     W2's chunk read K-major) with each warpgroup's f32 channel sums (db1's
//     partials); dh1b stored bf16 (h1 and dh1b through each warp's
//     staging rows in shared memory, 16 contiguous bytes a lane); dx +=
//     dh1b W1c^T with dh1b's A operand repacked from the accumulators as
//     the forward's h1c is (the next chunk's x W1c issued behind it); the
//     epilogue rounds dx = bf16(g + sums) once;
//   dW1 = x^T dh1b and dW2 = h1^T dh2b on the weight-grad engine at k = 1
//     (K6's dwf mode: A in chunks of 192 or 128 channels, an M-tile a
//     consumer warpgroup), dW3 and db3 on it at k = 3 with g
//     scaled in shared memory (gscale = res_scale);
//   after the last block, db1 and db2 of every block: the partials added
//     in a fixed order (wdsr_colsum).
//  No float atomics anywhere: the same bits on every call. One host call
//  runs a trunk of L blocks each way on stacked weights; the forward
//  saves every block's input and h2 for the backward.
//
// K8c (srt_wdsr_block_fwd) is the forward of srtpu's fused NHWC WDSR-B
// block (its use_pallas=True route), which keeps the activations in f32:
//   a   = relu(x W1 + b1)                      f32 (not rounded)
//   v   = a W2 + b2                            f32 (not rounded)
//   out = bf16((conv3x3(v; W3) + b3) * res_scale + x)   one rounding.
// It replaces srtpu/ops/wdsr_block.py:wdsr_block_fused_fwd (body
// _wdsr_kernel), behind wdsr_block_fused / _BlockB._fused. Every f32
// activation t that a product reads is carried as hi = bf16(t), lo =
// bf16(t - hi), and the product runs on both into the same f32 sums (the
// weights are bf16 values, as srtpu casts them, so each product is exact
// in f32 and t - hi - lo is below 2^-17 |t|): the f32 product to that
// error on the bf16 tensor cores, where TF32 would not reach it. Two
// launches: wdsr_chain_fwd_kernel<C, true> splits each chunk's a into hi
// and lo in registers, runs the W2 product on both and stores v as [hi |
// lo] (B H W, 2 Lp) bf16; then the 3x3 at EPI 8 over those 2 Lp channels
// with W3 stacked twice along its input channels ([W3; W3], the wrapper's
// copy): the engine's weight map is one HWIO tensor, and the copy is 0.6
// MB at C = 128. Bound as K7's forward; the hi/lo halves double the W2
// and 3x3 products' tensor-core work.
//
// Widths: C = 64 or 128, e = 6 C, Lp = C. The wrappers
// (srtpu_torch/ops/wdsr.py, wdsr_block.py) zero-pad a C that is a
// multiple of 16 below 128 to the next of the two, and raise for others
// (ROADMAP F4).

#include "conv_sm90.cuh"
#include "wgrad.cuh"

// trunk.cu's gs pass: gs = bf16(scale * g) over n values.
extern "C" int srt_gs_pass(const void* g, float scale, void* gs, long long n,
                           void* stream);

namespace {

using namespace srt90;

constexpr int kP = 128;          // pixels a block: two warpgroups of 64 rows
constexpr int kEC = 64;          // expanded channels a chunk
constexpr int kStages = 4;       // W1 / W2 chunks in flight
constexpr int kChainThreads = 288;  // two consumer warpgroups + a producer
constexpr uint32_t kRows = 16384;   // 128 pixel rows x 64 channels, bf16
constexpr uint32_t kAtom = 8192;    // a W2 atom: 64 e rows x 64 Lp channels
// wgmma's shared-memory descriptor of a 128-byte swizzled tile with
// 128-byte rows (SBO = 8 rows): A (K-major) or B, N-major or K-major alike
constexpr uint64_t kDesc =
    (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);

__device__ __forceinline__ uint64_t desc_at(uint32_t addr) {
  return kDesc | ((addr & 0x3FFFFu) >> 4);
}

// Shared memory of the chain kernels (bytes from the 1024-aligned base):
// the x tile (C / 64 blocks of 128 rows x 64 channels, 128-byte swizzle),
// in the backward the dh2b tile (as x's), then the ring of W1's chunk (C
// rows x 64 e, 128-byte rows) and W2's (Lp / 64 atoms of 64 e x 64 Lp),
// the barriers (x, full, empty), and in the backward the warpgroups' db1
// sums (2 warpgroups x 2 chunk parities x 4 warps x 64 floats) and each
// warp's staging rows for its h1 and dh1b stores (kOut).
constexpr uint32_t kOutRow = 144;      // 64 bf16 + 8 of padding: no conflicts
constexpr uint32_t kOut = 16 * kOutRow;  // a warp's 16 rows

template <int C, bool BWD>
struct ChainPlan {
  static constexpr uint32_t kX = C / 64 * kRows;
  static constexpr uint32_t kD = BWD ? C / 64 * kRows : 0;
  static constexpr uint32_t kW1 = C * 128;
  static constexpr uint32_t kStage = kW1 + C / 64 * kAtom;
  static constexpr uint32_t kRing = kX + kD;
  static constexpr uint32_t kBars = kRing + kStages * kStage;
  static constexpr uint32_t kRed = (kBars + 8 * (1 + 2 * kStages) + 15) & ~15u;
  static constexpr uint32_t kOuts = kRed + 4096;
  static constexpr uint32_t kSmem = 1024 + (BWD ? kOuts + 8 * kOut : kRed);
};

// Two f32 as a bf16 pair in one register (round to nearest even).
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

// The chunk's 64 x 64 accumulators (register 4 j + 2 h + e: row lane / 4 +
// 8 h of the warp's 16, column 8 j + 2 (lane % 4) + e) as the bf16 A
// operand of a wgmma over those 64 columns: k16 step s is columns 16 s ..
// 16 s + 15, its registers (j = 2 s, h = 0), (2 s, 1), (2 s + 1, 0), (2 s
// + 1, 1) of bf16 pairs.
__device__ __forceinline__ void repack(const float (&v)[32],
                                       uint32_t (&a)[4][4]) {
#pragma unroll
  for (int s = 0; s < 4; ++s)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[s][r] = pack2(v[8 * s + 2 * r],
                                                v[8 * s + 2 * r + 1]);
}

// The warp's 16 rows x 64 channels of bf16 pairs, v[j][h] at row lane / 4
// + 8 h, channels 8 j + 2 (lane % 4), stored to dst (rows from prow, row
// stride ld, channels from c0) through the warp's staging rows: 16
// contiguous bytes a lane, rows past S left out.
__device__ __forceinline__ void store_rows(const uint32_t (&v)[8][2],
                                           unsigned char* buf, bf16* dst,
                                           long long prow, long long S,
                                           int ld, int c0, int lane) {
  uint32_t* const w = reinterpret_cast<uint32_t*>(buf);
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      w[(g + 8 * h) * (kOutRow / 4) + 4 * j + t] = v[j][h];
  __syncwarp();
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = lane + 32 * k, r = i >> 3, ch = i & 7;
    const uint4 val = *reinterpret_cast<const uint4*>(buf + r * kOutRow +
                                                      ch * 16);
    if (prow + r < S)
      *reinterpret_cast<uint4*>(dst + (prow + r) * ld + c0 + ch * 8) = val;
  }
  __syncwarp();
}

__device__ __forceinline__ void zero(float (&v)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) v[i] = 0.0f;
}

// The producer: the x (and dh2b) tile once, then every chunk of W1 and W2
// in order, each into the ring's next free stage.
template <int C, bool BWD>
__device__ __forceinline__ void produce(const CUtensorMap& xmap,
                                        const CUtensorMap* dmap,
                                        const CUtensorMap& w1map,
                                        const CUtensorMap& w2map,
                                        uint32_t base, int p0, int nch) {
  using P = ChainPlan<C, BWD>;
  const uint32_t xbar = base + P::kBars;
  const Ring full{xbar + 8, kStages}, empty{xbar + 8 + 8 * kStages, kStages};
  mbar_expect_tx(xbar, P::kX + P::kD);
#pragma unroll
  for (int a = 0; a < C / 64; ++a) {
    tma_load_2d(base + a * kRows, &xmap, xbar, a * 64, p0);
    if (BWD) tma_load_2d(base + P::kX + a * kRows, dmap, xbar, a * 64, p0);
  }
  for (int ch = 0; ch < nch; ++ch) {
    const uint32_t st = base + P::kRing + (ch % kStages) * P::kStage;
    empty.wait_free(ch);
    mbar_expect_tx(full.at(ch), P::kStage);
    tma_load_2d(st, &w1map, full.at(ch), ch * kEC, 0);
#pragma unroll
    for (int a = 0; a < C / 64; ++a)
      tma_load_2d(st + P::kW1 + a * kAtom, &w2map, full.at(ch), a * 64,
                  ch * kEC);
  }
}

// h2 = bf16(relu(x W1 + b1) W2 + b2) for 128 pixels a block (h1 in
// registers, one 64-wide e-chunk at a time). Maps: x (S, C), W1 (C, e),
// W2 (e, C) bf16 (boxes 64 x 128, 64 x C, 64 x 64); b1 (e), b2 (C) f32;
// h2 (S, C) bf16. HILO (K8c): h1 kept as hi + lo, both multiplied by W2;
// h2 is the f32 v stored as [hi | lo] (S, 2 C).
template <int C, bool HILO>
__global__ void __launch_bounds__(kChainThreads, 1)
    wdsr_chain_fwd_kernel(const __grid_constant__ CUtensorMap xmap,
                          const __grid_constant__ CUtensorMap w1map,
                          const __grid_constant__ CUtensorMap w2map,
                          const float* __restrict__ b1,
                          const float* __restrict__ b2, bf16* __restrict__ h2,
                          long long S, int e) {
  using P = ChainPlan<C, false>;
  constexpr int NA = C / 64, KX = C / 16;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t xbar = base + P::kBars;
  const Ring full{xbar + 8, kStages}, empty{xbar + 8 + 8 * kStages, kStages};
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nch = e / kEC, p0 = blockIdx.x * kP;
  if (threadIdx.x == 0) {
    mbar_init(xbar, 1);
    full.init(1);
    empty.init(8);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (warp == 8) {
    if (lane == 0)
      produce<C, false>(xmap, nullptr, w1map, w2map, base, p0, nch);
    return;
  }

  const int row = (warp >> 2) * 64 + (warp & 3) * 16;  // the warp's rows
  const int cl = 2 * (lane & 3);
  // the x tile's rows of this warpgroup, wgmma's A in shared memory
  const uint32_t xw = base + (warp >> 2) * 64 * 128;
  float acc[NA][32];
#pragma unroll
  for (int at = 0; at < NA; ++at) zero(acc[at]);
  float a1[32];
  // chunk ch's x W1c into a1: one wgmma group, not waited for here
  auto gemm1 = [&](int ch) {
    const uint32_t st = base + P::kRing + (ch % kStages) * P::kStage;
    full.wait(ch);
    zero(a1);
    fence_acc(a1);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KX; ++ks)
      wgmma_ss_n64<1>(a1, desc_at(xw + (ks >> 2) * kRows + (ks & 3) * 32),
                      desc_at(st + ks * 2048));
    wgmma_commit();
  };
  mbar_wait(xbar, 0);
  gemm1(0);

  // Per chunk: wait for x W1c (and the last chunk's W2 product), form
  // h1c, issue its W2 product, then the next chunk's x W1c behind it: one
  // wait a chunk.
  for (int ch = 0; ch < nch; ++ch) {
    const uint32_t st = base + P::kRing + (ch % kStages) * P::kStage;
    wgmma_wait<0>();
    fence_acc(a1);
#pragma unroll
    for (int at = 0; at < NA; ++at) fence_acc(acc[at]);
    if (ch > 0) {
      __syncwarp();
      if (lane == 0) empty.arrive(ch - 1);  // its W2 product is done
      __syncwarp();
    }
    // h1c = relu(sums + b1c): bf16 (K7), or hi + lo (K8c)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 bb =
          __ldg(reinterpret_cast<const float2*>(b1 + ch * kEC + 8 * j + cl));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        a1[4 * j + 2 * h] = fmaxf(a1[4 * j + 2 * h] + bb.x, 0.0f);
        a1[4 * j + 2 * h + 1] = fmaxf(a1[4 * j + 2 * h + 1] + bb.y, 0.0f);
      }
    }
    uint32_t hf[4][4];
    repack(a1, hf);
    uint32_t lf[HILO ? 4 : 1][4];
    if constexpr (HILO) {
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 hi = unpack2(hf[s][r]);
          lf[s][r] = pack2(a1[8 * s + 2 * r] - hi.x,
                           a1[8 * s + 2 * r + 1] - hi.y);
        }
    }
#pragma unroll
    for (int at = 0; at < NA; ++at) fence_acc(acc[at]);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int at = 0; at < NA; ++at)
        wgmma_rs<64, false>(acc[at], hf[s],
                            desc_at(st + P::kW1 + at * kAtom + s * 2048));
    if constexpr (HILO) {
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int at = 0; at < NA; ++at)
          wgmma_rs<64, false>(acc[at], lf[s],
                              desc_at(st + P::kW1 + at * kAtom + s * 2048));
    }
    wgmma_commit();
#pragma unroll
    for (int at = 0; at < NA; ++at) fence_acc(acc[at]);
    if (ch + 1 < nch) gemm1(ch + 1);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int at = 0; at < NA; ++at) fence_acc(acc[at]);

  // h2 = sums + b2, rounded once (K8c: v as hi, then lo Lp channels on)
  constexpr int LD = HILO ? 2 * C : C;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const long long p = (long long)p0 + row + (lane >> 2) + 8 * h;
    if (p >= S) continue;
#pragma unroll
    for (int at = 0; at < NA; ++at)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = at * 64 + 8 * j + cl;
        const float2 bb = __ldg(reinterpret_cast<const float2*>(b2 + c));
        const float v0 = acc[at][4 * j + 2 * h] + bb.x;
        const float v1 = acc[at][4 * j + 2 * h + 1] + bb.y;
        const uint32_t hi = pack2(v0, v1);
        *reinterpret_cast<uint32_t*>(h2 + p * LD + c) = hi;
        if constexpr (HILO) {
          const float2 f = unpack2(hi);
          *reinterpret_cast<uint32_t*>(h2 + p * LD + C + c) =
              pack2(v0 - f.x, v1 - f.y);
        }
      }
  }
}

// The pointwise backward for 128 pixels a block (see the head note).
// Maps: x (S, C), dh2b (S, C), W1 (C, e), W2 (e, C) bf16; b1 (e) f32; g
// (S, C) bf16, the block's output cotangent. Writes dx (S, C), h1 and
// dh1b (S, e) bf16 and part (2 ntiles, e) f32: warpgroup w of tile t's
// channel sums of dh1 in row 2 t + w (its 64 pixels: the warps' sums in
// order, a warp's by a fixed butterfly).
template <int C>
__global__ void __launch_bounds__(kChainThreads, 1)
    wdsr_chain_bwd_kernel(const __grid_constant__ CUtensorMap xmap,
                          const __grid_constant__ CUtensorMap dmap,
                          const __grid_constant__ CUtensorMap w1map,
                          const __grid_constant__ CUtensorMap w2map,
                          const float* __restrict__ b1,
                          const bf16* __restrict__ g, bf16* __restrict__ dx,
                          bf16* __restrict__ h1, bf16* __restrict__ dh1b,
                          float* __restrict__ part, long long S, int e) {
  using P = ChainPlan<C, true>;
  constexpr int NA = C / 64, KX = C / 16;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t xbar = base + P::kBars;
  const Ring full{xbar + 8, kStages}, empty{xbar + 8 + 8 * kStages, kStages};
  unsigned char* const sbase = smem_raw + (base - smem_u32(smem_raw));
  float* const red = reinterpret_cast<float*>(sbase + P::kRed);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nch = e / kEC, p0 = blockIdx.x * kP;
  if (threadIdx.x == 0) {
    mbar_init(xbar, 1);
    full.init(1);
    empty.init(8);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (warp == 8) {
    if (lane == 0) produce<C, true>(xmap, &dmap, w1map, w2map, base, p0, nch);
    return;
  }

  const int wg = warp >> 2, wq = warp & 3;
  const int row = wg * 64 + wq * 16;
  const int cl = 2 * (lane & 3);
  unsigned char* const obuf = sbase + P::kOuts + warp * kOut;
  // the x and dh2b tiles' rows of this warpgroup, wgmma's A in shared
  // memory
  const uint32_t xw = base + wg * 64 * 128, dw = xw + P::kX;
  long long pix[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    pix[h] = (long long)p0 + row + (lane >> 2) + 8 * h;
  float dxa[NA][32];
#pragma unroll
  for (int at = 0; at < NA; ++at) zero(dxa[at]);
  float a1[32];
  // chunk ch's pre-activation x W1c into a1: one wgmma group, not
  // waited for here
  auto gemm1 = [&](int ch) {
    const uint32_t st = base + P::kRing + (ch % kStages) * P::kStage;
    full.wait(ch);
    zero(a1);
    fence_acc(a1);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KX; ++ks)
      wgmma_ss_n64<1>(a1, desc_at(xw + (ks >> 2) * kRows + (ks & 3) * 32),
                      desc_at(st + ks * 2048));
    wgmma_commit();
  };
  mbar_wait(xbar, 0);
  gemm1(0);

  // Per chunk: wait for x W1c (and the last chunk's dx product), form
  // h1c and its mask, then dh2b W2c^T (W2's chunk read K-major) into the
  // same registers, dh1c and dh1b; issue dh1b W1c^T and the next chunk's
  // x W1c behind it.
  for (int ch = 0; ch < nch; ++ch) {
    const uint32_t st = base + P::kRing + (ch % kStages) * P::kStage;
    const int c0 = ch * kEC;
    wgmma_wait<0>();
    fence_acc(a1);
#pragma unroll
    for (int at = 0; at < NA; ++at) fence_acc(dxa[at]);
    if (ch > 0) {
      __syncwarp();
      if (lane == 0) empty.arrive(ch - 1);  // its dx product is done
      __syncwarp();
    }
    // h1c = bf16(relu(. + b1c)), stored; its sign is dh1's mask
    uint32_t mask = 0;
    {
      uint32_t hv[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 bb =
            __ldg(reinterpret_cast<const float2*>(b1 + c0 + 8 * j + cl));
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          hv[j][h] = pack2(fmaxf(a1[4 * j + 2 * h] + bb.x, 0.0f),
                           fmaxf(a1[4 * j + 2 * h + 1] + bb.y, 0.0f));
          const float2 f = unpack2(hv[j][h]);
          mask |= (f.x > 0.0f ? 1u : 0u) << (4 * j + 2 * h);
          mask |= (f.y > 0.0f ? 1u : 0u) << (4 * j + 2 * h + 1);
        }
      }
      store_rows(hv, obuf, h1, (long long)p0 + row, S, e, c0, lane);
    }
    // dh1c = [h1c > 0] dh2b W2c^T
    zero(a1);
    fence_acc(a1);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KX; ++ks)
      wgmma_ss_n64<0>(
          a1, desc_at(dw + (ks >> 2) * kRows + (ks & 3) * 32),
          desc_at(st + P::kW1 + (ks >> 2) * kAtom + (ks & 3) * 32));
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(a1);
#pragma unroll
    for (int i = 0; i < 32; ++i)
      if (!((mask >> i) & 1u)) a1[i] = 0.0f;
    // db1's partial: the warp's 16 rows by a butterfly over the lanes of
    // one lane % 4, then the warpgroup's 4 warps in order
    {
      float s[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[j][0] = a1[4 * j] + a1[4 * j + 2];
        s[j][1] = a1[4 * j + 1] + a1[4 * j + 3];
      }
#pragma unroll
      for (int o = 4; o < 32; o <<= 1)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[j][0] += __shfl_xor_sync(0xffffffffu, s[j][0], o);
          s[j][1] += __shfl_xor_sync(0xffffffffu, s[j][1], o);
        }
      float* const r = red + ((wg * 2 + (ch & 1)) * 4) * 64;
      if (lane < 4)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<float2*>(r + wq * 64 + 8 * j + 2 * lane) =
              make_float2(s[j][0], s[j][1]);
      asm volatile("bar.sync %0, 128;" ::"r"(1 + wg) : "memory");
      const int t = threadIdx.x & 127;
      if (t < 64)
        part[((size_t)blockIdx.x * 2 + wg) * e + c0 + t] =
            ((r[t] + r[64 + t]) + r[128 + t]) + r[192 + t];
    }
    // dh1b, stored and repacked as the A operand of dx's product
    uint32_t df[4][4];
    repack(a1, df);
    {
      uint32_t dv[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) dv[j][h] = df[j >> 1][(j & 1) * 2 + h];
      store_rows(dv, obuf, dh1b, (long long)p0 + row, S, e, c0, lane);
    }
    // dx += dh1b W1c^T: W1's chunk read K-major (its e channels)
#pragma unroll
    for (int at = 0; at < NA; ++at) fence_acc(dxa[at]);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int at = 0; at < NA; ++at)
        wgmma_rs<64, true>(dxa[at], df[s], desc_at(st + at * kAtom + s * 32));
    wgmma_commit();
#pragma unroll
    for (int at = 0; at < NA; ++at) fence_acc(dxa[at]);
    if (ch + 1 < nch) gemm1(ch + 1);
  }
  wgmma_wait<0>();
#pragma unroll
  for (int at = 0; at < NA; ++at) fence_acc(dxa[at]);

  // dx = bf16(g + sums), one rounding
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (pix[h] >= S) continue;
#pragma unroll
    for (int at = 0; at < NA; ++at)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const size_t o = pix[h] * C + at * 64 + 8 * j + cl;
        const float2 gv =
            unpack2(*reinterpret_cast<const uint32_t*>(g + o));
        *reinterpret_cast<uint32_t*>(dx + o) =
            pack2(gv.x + dxa[at][4 * j + 2 * h],
                  gv.y + dxa[at][4 * j + 2 * h + 1]);
      }
  }
}

// out[l, i] = sum over r of part[l, r, i] (n values a row, R rows a
// block, L blocks) in a fixed order: 16 slices of the rows (r = s, s + 16,
// ...) each summed in order, then the slices in order. A CTA takes 16
// columns, a thread one (column, slice).
constexpr int kSlices = 16;

__global__ void __launch_bounds__(256)
    wdsr_colsum(const float* __restrict__ part, float* __restrict__ out,
                int R, int n) {
  __shared__ float red[kSlices][16];
  const int col = threadIdx.x & 15, sl = threadIdx.x >> 4;
  const int nb = (n + 15) / 16;
  const int l = blockIdx.x / nb, i = (blockIdx.x - l * nb) * 16 + col;
  float a = 0.0f;
  if (i < n) {
    const float* p = part + (size_t)l * R * n + i;
    for (int r = sl; r < R; r += kSlices) a += p[(size_t)r * n];
  }
  red[sl][col] = a;
  __syncthreads();
  if (sl == 0 && i < n) {
    float t = red[0][col];
#pragma unroll
    for (int k = 1; k < kSlices; ++k) t += red[k][col];
    out[(size_t)l * n + i] = t;
  }
}

// A 2-D bf16 tensor map of a row-major (outer, inner) matrix, box
// (box_outer, box_inner) with the 128-byte swizzle (box_inner = 64).
cudaError_t encode2(CUtensorMap* map, const void* t, long long inner,
                    long long outer, int box_inner, int box_outer) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint64_t dim[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t stride[1] = {(cuuint64_t)inner * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t ones[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(t), dim, stride, box, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// The weight maps of one block: W1 (C, e) in boxes of C rows x 64 e, W2
// (e, C) in boxes of 64 x 64.
cudaError_t weight_maps(CUtensorMap* w1map, CUtensorMap* w2map,
                        const void* w1, const void* w2, int C, int e) {
  cudaError_t err = encode2(w1map, w1, e, C, 64, C);
  return err != cudaSuccess ? err : encode2(w2map, w2, C, e, 64, 64);
}

// Return the error of a call that fails: cudaError_t in the helpers
// (SRT_CHECK), int in the C entries (SRT_TRY).
#define SRT_CHECK(...)                     \
  do {                                     \
    cudaError_t e_ = (__VA_ARGS__);        \
    if (e_ != cudaSuccess) return e_;      \
  } while (0)
#define SRT_TRY(...)                       \
  do {                                     \
    cudaError_t e_ = (__VA_ARGS__);        \
    if (e_ != cudaSuccess) return (int)e_; \
  } while (0)

template <int C, bool HILO>
cudaError_t chain_fwd_c(const void* x, const void* w1, const void* b1,
                        const void* w2, const void* b2, void* h2, long long S,
                        int e, cudaStream_t s) {
  using P = ChainPlan<C, false>;
  auto kernel = wdsr_chain_fwd_kernel<C, HILO>;
  static const cudaError_t allowed = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::kSmem);
  SRT_CHECK(allowed);
  CUtensorMap xmap, w1map, w2map;
  SRT_CHECK(encode2(&xmap, x, C, S, 64, kP));
  SRT_CHECK(weight_maps(&w1map, &w2map, w1, w2, C, e));
  kernel<<<(unsigned)((S + kP - 1) / kP), kChainThreads, P::kSmem, s>>>(
      xmap, w1map, w2map, static_cast<const float*>(b1),
      static_cast<const float*>(b2), static_cast<bf16*>(h2), S, e);
  return cudaGetLastError();
}

template <bool HILO>
cudaError_t chain_fwd(const void* x, const void* w1, const void* b1,
                      const void* w2, const void* b2, void* h2, long long S,
                      int C, int e, cudaStream_t s) {
  return C == 128 ? chain_fwd_c<128, HILO>(x, w1, b1, w2, b2, h2, S, e, s)
                  : chain_fwd_c<64, HILO>(x, w1, b1, w2, b2, h2, S, e, s);
}

template <int C>
cudaError_t chain_bwd_c(const void* x, const void* dh2b, const void* w1,
                        const void* b1, const void* w2, const void* g,
                        void* dx, void* h1, void* dh1b, void* part,
                        long long S, int e, cudaStream_t s) {
  using P = ChainPlan<C, true>;
  auto kernel = wdsr_chain_bwd_kernel<C>;
  static const cudaError_t allowed = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P::kSmem);
  SRT_CHECK(allowed);
  CUtensorMap xmap, dmap, w1map, w2map;
  SRT_CHECK(encode2(&xmap, x, C, S, 64, kP));
  SRT_CHECK(encode2(&dmap, dh2b, C, S, 64, kP));
  SRT_CHECK(weight_maps(&w1map, &w2map, w1, w2, C, e));
  kernel<<<(unsigned)((S + kP - 1) / kP), kChainThreads, P::kSmem, s>>>(
      xmap, dmap, w1map, w2map, static_cast<const float*>(b1),
      static_cast<const bf16*>(g), static_cast<bf16*>(dx),
      static_cast<bf16*>(h1), static_cast<bf16*>(dh1b),
      static_cast<float*>(part), S, e);
  return cudaGetLastError();
}

cudaError_t chain_bwd(const void* x, const void* dh2b, const void* w1,
                      const void* b1, const void* w2, const void* g, void* dx,
                      void* h1, void* dh1b, void* part, long long S, int C,
                      int e, cudaStream_t s) {
  return C == 128
             ? chain_bwd_c<128>(x, dh2b, w1, b1, w2, g, dx, h1, dh1b, part,
                                S, e, s)
             : chain_bwd_c<64>(x, dh2b, w1, b1, w2, g, dx, h1, dh1b, part, S,
                               e, s);
}

// The 3x3 of K2's engine for K7: x (B, H, W, cin), w (3, 3, cin, cout).
ConvArgs args3(const void* x, const void* w, const float* bias, void* out,
               int B, int H, int W, int cin, int cout) {
  ConvArgs a = {};
  a.x = static_cast<const bf16*>(x);
  a.xps = cin;
  a.w = static_cast<const bf16*>(w);
  a.bias = bias;
  a.out = out;
  a.ops = cout;
  a.B = B;
  a.H = H;
  a.W = W;
  a.cin = cin;
  a.cout = cout;
  a.kk = 3;
  a.ch.mask_chunk = -1;
  return a;
}

// out = bf16((conv3x3(h; w3) + b3) * scale + res), h (B, H, W, cin).
cudaError_t conv_skip(const void* h, const void* w3, const void* b3,
                      const void* res, float scale, void* out, int B, int H,
                      int W, int cin, int C, cudaStream_t s) {
  ConvArgs a = args3(h, w3, static_cast<const float*>(b3), out, B, H, W, cin,
                     C);
  a.k1.res = static_cast<const bf16*>(res);
  a.k1.scale = scale;
  return run_3x3_wide<false, 8>(a, s);
}

// One weight grad on W's engine: x (B, H, W, cin) against g (B, H, W,
// cout), k x k; db null at k = 1 (the engine's K6 mode).
cudaError_t wgrad1(const void* x, const void* g, void* dw, void* db,
                   void* ws_w, void* ws_b, int B, int H, int W, int cin,
                   int cout, int k, float gscale, int cluster, int nclusters,
                   cudaStream_t s) {
  WgradArgs a = {};
  a.x = x;
  a.g = g;
  a.ws_w = ws_w;
  a.ws_b = ws_b;
  a.dw = dw;
  a.db = db;
  a.J = 1;
  a.B = B;
  a.H = H;
  a.W = W;
  a.cin = cin;
  a.cout = cout;
  a.r = 1;
  a.gscale = gscale;
  a.cluster = cluster;
  a.nclusters = nclusters;
  a.k = k;
  return wgrad(a, s);
}

bool widths_ok(int C, int e, int lp) {
  return (C == 64 || C == 128) && e == 6 * C && lp == C;
}


}  // namespace

// The forward of L blocks. x (B, H, W, C) bf16, the trunk's input; w1s
// (L, C, e), w2s (L, e, C), w3s (L, 3, 3, C, C) bf16 (Lp = C); b1s (L,
// e), b2s, b3s (L, C) f32. save: xs (L, B, H, W, C) takes block i's input
// in slot i (xs[0] a copy of x), h2s (L, B, H, W, C) its h2, out the last
// block's output. Else h2s (B, H, W, C) is scratch, and blocks L - 1, L -
// 3, ... write out, the others xs (B, H, W, C) (null when L = 1). Two
// launches a block. Returns a cudaError_t.
extern "C" int srt_wdsr_trunk_fwd(const void* x, const void* w1s,
                                  const void* b1s, const void* w2s,
                                  const void* b2s, const void* w3s,
                                  const void* b3s, float scale, void* xs,
                                  void* h2s, void* out, int L, int save,
                                  int B, int H, int W, int C, int e, int lp,
                                  void* stream) {
  if (!widths_ok(C, e, lp) || L < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long S = (long long)B * H * W;
  const size_t act = (size_t)S * C;
  bf16* const xsb = static_cast<bf16*>(xs);
  if (save)
    SRT_TRY(cudaMemcpyAsync(xsb, x, act * sizeof(bf16),
                            cudaMemcpyDeviceToDevice, s));
  const bf16* cur = static_cast<const bf16*>(x);
  for (int i = 0; i < L; ++i) {
    bf16* h2 = static_cast<bf16*>(h2s) + (save ? i * act : 0);
    bf16* dst = save ? (i + 1 < L ? xsb + (i + 1) * act
                                  : static_cast<bf16*>(out))
                     : ((L - 1 - i) % 2 ? xsb : static_cast<bf16*>(out));
    SRT_TRY(chain_fwd<false>(
        cur, static_cast<const bf16*>(w1s) + (size_t)i * C * e,
        static_cast<const float*>(b1s) + (size_t)i * e,
        static_cast<const bf16*>(w2s) + (size_t)i * e * C,
        static_cast<const float*>(b2s) + (size_t)i * C, h2, S, C, e, s));
    SRT_TRY(conv_skip(h2,
                      static_cast<const bf16*>(w3s) + (size_t)i * 9 * C * C,
                      static_cast<const float*>(b3s) + (size_t)i * C, cur,
                      scale, dst, B, H, W, C, C, s));
    cur = dst;
  }
  return 0;
}

// The backward of L blocks, the last first. xs (L, B, H, W, C) and h2s
// (L, B, H, W, C) bf16, the blocks' inputs and h2 as the forward saved
// them; g (B, H, W, C) bf16, the cotangent of the last block's output;
// w1s, b1s, w2s, w3s as the forward's. Scratch, reused block after block:
// gs (B, H, W, C) bf16 where scale is not 1, else null; dh2b (B, H, W, C)
// and h1, dh1b (B, H, W, e) bf16; gbuf (2, B, H, W, C) bf16, the
// cotangents between blocks (null when L = 1); the weight grads' partial
// slots ws_w, ws_b (null unless a split has more than one cluster). part2
// (L, B tiles, C) and part1 (L, 2 ceil(S / 128), e) f32, the bias grads'
// partials. Writes dw1s (L, C, e), dw2s (L, e, C), dw3s (L, 3, 3, C, C),
// db1s (L, e), db2s, db3s (L, C) f32 and dx (B, H, W, C) bf16. cl1, n1,
// cl2, n2, cl3, n3: the (cluster, clusters) of dW1, dW2 and dW3
// (srtpu_torch/ops/wgrad.py:wgrad_parts). Returns a cudaError_t.
extern "C" int srt_wdsr_trunk_bwd(
    const void* xs, const void* h2s, const void* g, const void* w1s,
    const void* b1s, const void* w2s, const void* w3s, float scale,
    void* gs, void* dh2b, void* h1, void* dh1b, void* gbuf, void* ws_w,
    void* ws_b, void* part1, void* part2, void* dw1s, void* dw2s, void* dw3s, void* db1s, void* db2s, void* db3s, void* dx,
    int L, int B, int H, int W, int C, int e, int lp, int cl1, int n1,
    int cl2, int n2, int cl3, int n3, void* stream) {
  const bool scaled = scale != 1.0f;
  if (!widths_ok(C, e, lp) || L < 1 || !h2s || (scaled && !gs) ||
      (L > 1 && !gbuf))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long S = (long long)B * H * W;
  const size_t act = (size_t)S * C;
  const int tiles = ((W + kTW - 1) / kTW) * ((H + kTH - 1) / kTH);
  const int r2 = B * tiles, r1 = 2 * (int)((S + kP - 1) / kP);
  const bf16* gcur = static_cast<const bf16*>(g);
  for (int i = L - 1; i >= 0; --i) {
    const bf16* x = static_cast<const bf16*>(xs) + i * act;
    const bf16* w1 = static_cast<const bf16*>(w1s) + (size_t)i * C * e;
    const float* b1 = static_cast<const float*>(b1s) + (size_t)i * e;
    const bf16* w2 = static_cast<const bf16*>(w2s) + (size_t)i * e * C;
    const bf16* h2i = static_cast<const bf16*>(h2s) + i * act;
    if (scaled) SRT_TRY((cudaError_t)srt_gs_pass(gcur, scale, gs, act, s));
    ConvArgs a = args3(scaled ? gs : gcur,
                       static_cast<const bf16*>(w3s) + (size_t)i * 9 * C * C,
                       nullptr, dh2b, B, H, W, C, C);
    a.k5.r2 = static_cast<bf16*>(dh2b);
    a.k5.part = static_cast<float*>(part2) + (size_t)i * r2 * C;
    SRT_TRY((run_3x3_wide<true, 7>(a, s)));
    bf16* gout = i ? static_cast<bf16*>(gbuf) + ((L - 1 - i) % 2) * act
                   : static_cast<bf16*>(dx);
    SRT_TRY(chain_bwd(x, dh2b, w1, b1, w2, gcur, gout, h1, dh1b,
                      static_cast<float*>(part1) + (size_t)i * r1 * e, S, C,
                      e, s));
    SRT_TRY(wgrad1(x, dh1b, static_cast<float*>(dw1s) + (size_t)i * C * e,
                   nullptr, ws_w, ws_b, B, H, W, C, e, 1, 1.0f, cl1, n1, s));
    SRT_TRY(wgrad1(h1, dh2b, static_cast<float*>(dw2s) + (size_t)i * e * C,
                   nullptr, ws_w, ws_b, B, H, W, e, C, 1, 1.0f, cl2, n2, s));
    SRT_TRY(wgrad1(h2i, gcur,
                   static_cast<float*>(dw3s) + (size_t)i * 9 * C * C,
                   static_cast<float*>(db3s) + (size_t)i * C, ws_w, ws_b, B,
                   H, W, C, C, 3, scale, cl3, n3, s));
    gcur = gout;
  }
  wdsr_colsum<<<L * ((e + 15) / 16), 256, 0, s>>>(
      static_cast<const float*>(part1), static_cast<float*>(db1s), r1, e);
  SRT_TRY(cudaGetLastError());
  wdsr_colsum<<<L * ((C + 15) / 16), 256, 0, s>>>(
      static_cast<const float*>(part2), static_cast<float*>(db2s), r2, C);
  return (int)cudaGetLastError();
}

// K8c: x (B, H, W, C) bf16; w1 (C, e), w2 (e, C) bf16; w3cat (3, 3, 2 C,
// C) bf16, W3 stacked twice along its input channels; b1 (e), b2, b3 (C)
// f32; vcat (B, H, W, 2 C) bf16 scratch (v as [hi | lo]); out (B, H, W,
// C) bf16 (Lp = C). Returns a cudaError_t.
extern "C" int srt_wdsr_block_fwd(const void* x, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* b2, const void* w3cat,
                                  const void* b3, float scale, void* vcat,
                                  void* out, int B, int H, int W, int C,
                                  int e, int lp, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!widths_ok(C, e, lp)) return (int)cudaErrorInvalidValue;
  SRT_TRY(chain_fwd<true>(x, w1, b1, w2, b2, vcat, (long long)B * H * W, C, e,
                          s));
  return (int)conv_skip(vcat, w3cat, b3, x, scale, out, B, H, W, 2 * C, C, s);
}
