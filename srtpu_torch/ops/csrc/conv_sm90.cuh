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
#pragma once

#include "sm90.cuh"

namespace srt90 {

constexpr int kConsumers = 2;                        // warpgroups
constexpr int kThreads = (4 * kConsumers + 1) * 32;  // + one producer warp
constexpr int kTH = 4 * kConsumers;                  // tile rows: one a warp
constexpr int kTW = 16;                              // a warp's wgmma rows

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
// with no transposed copy of the weight.
template <int NA, int NAT, int NKS, int SPLIT, bool TB>
__global__ void __launch_bounds__(kThreads, min_blocks(NA * NAT, NKS))
    conv_sm90_kernel(const __grid_constant__ CUtensorMap xmap,
                     const __grid_constant__ CUtensorMap wmap,
                     const Params p) {
  static_assert(SPLIT == 1 || SPLIT == 2, "cin whole, or in two halves");
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
        tma_load_4d(a_ring + sa * p.a_stage, &xmap, a_full.at(s - s0),
                    s * KC, x0 - halo, y0 - halo, b);
        for (int r = 0; r < rows; ++r, ++g) {
          const int sb = g % p.sb;
          b_empty.wait_free(g);
          mbar_expect_tx(b_full.at(g), p.b_bytes);
          // TB: the stage's taps come from the far end, in reverse
          const int tap0 = TB ? p.taps - (r + 1) * p.tg : r * p.tg;
#pragma unroll
          for (int at = 0; at < NAT; ++at) {
            const uint32_t dst = b_ring + sb * p.b_stage + at * p.tg * BTAP;
            if (TB)
              tma_load_3d(dst, &wmap, b_full.at(g), s * KC, n0 + at * NA,
                          tap0);
            else
              tma_load_3d(dst, &wmap, b_full.at(g), n0 + at * NA, s * KC,
                          tap0);
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
      if (t == 0) a_full.wait(s);
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
    bf16* dst = p.out + (((size_t)b * p.H + gy) * p.W + gx) * p.cout + c0;
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
        *reinterpret_cast<__nv_bfloat162*>(dst + c) =
            __floats2bfloat162_rn(v0, v1);
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

// Launch the engine at BN = NA * NAT (a divisor of cout), KC = 16 NKS
// (the largest of 64, 32, 16 that divides cin), each tile's channel
// slices split over SPLIT blocks of a cluster; TB: w is the forward HWIO
// weight (k, k, cout, cin) of which this is the transposed conv.
template <int NA, int NAT, int NKS, int SPLIT, bool TB>
cudaError_t launch(const bf16* x, const bf16* w, const float* bias, bf16* out,
                   int B, int H, int W, int cin, int cout, int kk, int relu,
                   cudaStream_t stream) {
  constexpr int BN = NA * NAT, KC = 16 * NKS;
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  auto kernel = conv_sm90_kernel<NA, NAT, NKS, SPLIT, TB>;
  static const cudaError_t allowed = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (allowed != cudaSuccess) return allowed;
  const int wx = kTW + kk - 1, hx = kTH + kk - 1;
  const uint32_t a_bytes = (uint32_t)KC * 2 * wx * hx;
  const uint32_t b_tap = (uint32_t)KC * BN * 2;
  const int sa = cin / KC < 2 ? cin / KC : 2;
  const int fixed = 1024 + sa * (int)align1024(a_bytes) + 16 * (sa + 8);
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

  const cuuint32_t ones[4] = {1, 1, 1, 1};
  CUtensorMap xmap, wmap;
  // x as (cin, W, H, B); one box is the tile with its halo, KC channels
  const cuuint64_t xdim[4] = {(cuuint64_t)cin, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t xstride[3] = {(cuuint64_t)cin * 2, (cuuint64_t)W * cin * 2,
                                 (cuuint64_t)H * W * cin * 2};
  const cuuint32_t xbox[4] = {(cuuint32_t)KC, (cuuint32_t)wx, (cuuint32_t)hx,
                              1};
  if (encode(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
             const_cast<bf16*>(x), xdim, xstride, xbox, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(KC * 2),
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  // w as (cout, cin, k * k), one box an atom: NA channels of KC rows of
  // tg taps; TB: as (cin, cout, k * k), one box KC channels of NA rows
  const int inner = TB ? cin : cout, outer = TB ? cout : cin;
  const cuuint64_t wdim[3] = {(cuuint64_t)inner, (cuuint64_t)outer,
                              (cuuint64_t)kk * kk};
  const cuuint64_t wstride[2] = {(cuuint64_t)inner * 2,
                                 (cuuint64_t)cin * cout * 2};
  const cuuint32_t wbox[3] = {(cuuint32_t)(TB ? KC : NA),
                              (cuuint32_t)(TB ? NA : KC), (cuuint32_t)tg};
  if (encode(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
             const_cast<bf16*>(w), wdim, wstride, wbox, ones,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(TB ? KC * 2 : NA * 2),
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;

  Params p;
  p.bias = bias;
  p.out = out;
  p.H = H;
  p.W = W;
  p.cout = cout;
  p.relu = relu;
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
  const int smem = 1024 + sa * p.a_stage + sb * p.b_stage + 16 * (sa + sb);
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
template <int NA, int NAT, bool TB>
cudaError_t launch_kc(const bf16* x, const bf16* w, const float* b,
                      bf16* out, int B, int H, int W, int cin, int cout,
                      int kk, int relu, cudaStream_t s) {
  if constexpr (NA * NAT <= 64) {
    const long blocks = (long)((W + kTW - 1) / kTW) * ((H + kTH - 1) / kTH) *
                        (cout / (NA * NAT)) * B;
    if (cin % 64 == 0 && cin >= 256 && blocks < 2L * sm_count())
      return launch<NA, NAT, 4, 2, TB>(x, w, b, out, B, H, W, cin, cout, kk,
                                       relu, s);
  }
  if (cin % 64 == 0)
    return launch<NA, NAT, 4, 1, TB>(x, w, b, out, B, H, W, cin, cout, kk,
                                     relu, s);
  if (cin % 32 == 0)
    return launch<NA, NAT, 2, 1, TB>(x, w, b, out, B, H, W, cin, cout, kk,
                                     relu, s);
  return launch<NA, NAT, 1, 1, TB>(x, w, b, out, B, H, W, cin, cout, kk,
                                   relu, s);
}

// The engine's N: the widest of 192, 128, 64, 48, 32, 16 that divides
// cout (every multiple of 16 has one). 256 would hold 128 f32 sums a
// thread beside A's registers, past the 168 registers a thread gets.
// TB: the transposed conv of the forward weight w (k, k, cout, cin).
template <bool TB>
cudaError_t conv(const void* x, const void* w, const void* b, void* out,
                 int B, int H, int W, int cin, int cout, int kk, int relu,
                 cudaStream_t s) {
  if (cin % 16 || cout % 16 || cin <= 0 || cout <= 0 || (kk != 3 && kk != 5) ||
      B <= 0 || B > 65535 || H <= 0 || W <= 0)
    return cudaErrorInvalidValue;
  const bf16* xx = static_cast<const bf16*>(x);
  const bf16* ww = static_cast<const bf16*>(w);
  const float* bb = static_cast<const float*>(b);
  bf16* oo = static_cast<bf16*>(out);
  if (cout % 192 == 0)
    return launch_kc<64, 3, TB>(xx, ww, bb, oo, B, H, W, cin, cout, kk,
                                relu, s);
  if (cout % 128 == 0)
    return launch_kc<64, 2, TB>(xx, ww, bb, oo, B, H, W, cin, cout, kk,
                                relu, s);
  if (cout % 64 == 0)
    return launch_kc<64, 1, TB>(xx, ww, bb, oo, B, H, W, cin, cout, kk,
                                relu, s);
  if (cout % 48 == 0)
    return launch_kc<16, 3, TB>(xx, ww, bb, oo, B, H, W, cin, cout, kk,
                                relu, s);
  if (cout % 32 == 0)
    return launch_kc<32, 1, TB>(xx, ww, bb, oo, B, H, W, cin, cout, kk,
                                relu, s);
  return launch_kc<16, 1, TB>(xx, ww, bb, oo, B, H, W, cin, cout, kk, relu,
                              s);
}

}  // namespace srt90
