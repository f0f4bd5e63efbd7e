// K4: SRResNet's BatchNorm resblock (conv - BN - PReLU - conv - BN +
// skip) and the trunk's closing conv + BN, forward and backward in
// training mode, at 64 channels, NHWC bf16 activations, HWIO bf16
// weights, f32 biases, statistics and sums; and K4r, the same with
// REFLECT conv boundaries (SRGAN's generator, torch ReflectionPad2d(1) +
// a valid conv) instead of SAME zero padding.
//
// Replaces srtpu/ops/bn_resblock_cs.py: _conv_stats_call (f1_conv_stats,
// f2_norm_act_conv_stats), f3_norm_skip, b1_sums, b2_call and b3_call,
// behind bn_resblock_cs and bn_close_cs, with reflect=False (K4) and
// reflect=True (K4r: srtpu/ops/cs_conv.py's _build_x3_reflect,
// _dy_reduce_reflect, _gs_roll_reflect, _build_g3_reflect_T and
// _dy_reduce_reflect_T). Per block the forward is
//   F1 conv(u, W1) + b1 -> y1 (bf16) and the f32 sum / sum of squares of
//      the STORED y1 per channel -> finalize: mean, biased var,
//      inv = 1 / sqrt(var + 1e-5), a = gamma * inv, c = beta - mean * a;
//      its padding applies to u;
//   F2 h1 = bf16(prelu(a1 * y1 + c1)), saved for dW2, then F1's conv on
//      h1 -> y2 + stats. Its padding applies to h1, not to y1: SAME reads
//      zero outside the image, REFLECT the h1 of the mirrored pixel;
//   F3 out = bf16(a2 * y2 + c2 + u), one rounding, no padding;
// and the backward
//   B1 S_g = sum g, S_gx = sum g * xhat2 (xhat recomputed from y2), no
//      padding;
//   B2 dy2 = coef2 * (g - S_g / m - xhat2 * S_gx / m) (coef2 = gamma2 *
//      inv2) in f32: bf16(dy2) is stored (the conv's operand and dW2's),
//      its f32 value summed into db2; then the transposed conv with W2
//      gives dh1, and the epilogue does the PReLU backward on z = a1 * y1
//      + c1 (recomputed): dz = bf16(z >= 0 ? dh1 : alpha * dh1) stored,
//      dalpha += (z < 0 ? dh1 * z : 0), and BN1's sums of the STORED dz:
//      S_dz, S_dz * xhat1;
//   B3 the same prologue for BN1 from dz, the transposed conv with W1,
//      and du = bf16(dh + g) (the block skip; the trunk's close conv has
//      none); db1 from the f32 dy1.
// The transposed conv of a SAME conv is a SAME conv: its operand dy is
// zero outside the image under both paddings. dW1 = corr(u, bf16 dy1) and
// dW2 = corr(h1, bf16 dy2) come from W (wgrad.cu), which reads u and h1
// with the padding of the forward (REFLECT: the halo mirrored in shared
// memory after its TMA load).
//
// Design. The four convs (F1, F2; B2, B3) run on K2's Hopper engine
// (conv_sm90.cuh: TMA tile and weight rings, wgmma with A from ldmatrix)
// at K2's plan for 64 -> 64, with K4's epilogues: EPI 9 (F1, F2: y =
// bf16(sums + bias) and each 8 x 16 tile's f32 sum and sum of squares
// of the stored y), EPI 10 (B2, transposed: the PReLU backward, dz and
// its BN1 sums, dalpha) and EPI 11 (B3, transposed: du, one rounding).
// The engine reads its operand by TMA exactly as it lies in memory, so
// the load transforms of F2 and B2 / B3 are passes of their own (option
// (a)): bn_act_kernel writes h1, which F2 saves for dW2 anyway, and
// bn_dy_kernel writes bf16 dy, which B2 / B3 store for dW anyway, with
// db's per-chunk partials of the f32 dy. Each costs one launch and one
// more read of a 2 MB activation at the training shape; rewriting the
// staged tile in the consumers instead (option (b)) would put the BN
// arithmetic, the halo's SAME zeros (prelu(c1) is not 0) and the saved
// copies' stores inside every conv tile, on the warps that feed the
// tensor cores. TMA's zero fill outside the image is then right for
// SAME: h1 and dy are zero there.
//
// The batch statistics sit between each conv and its normalisation and
// cover the whole batch, so the passes cannot fuse into one block; and
// blocks run in no order, so every
// cross-block sum is written as per-tile (per-chunk) partials and added
// by bn_reduce_kernel in a fixed order, which also finalizes the
// statistics. No float atomics: two calls give the same bits. NHWC has no
// dead lanes, so the statistics cover all B * H * W pixels (srtpu's
// s_valid) and no re-zeroing is needed.
//
// REFLECT (template-free: a flag of the same instances, H, W >= 2;
// mirror m(-1) = 1, m(H) = H - 2, the same for columns):
//   forward: TMA fills the tile's one-pixel ring outside the image with
//      zero; the engine's consumers overwrite it with the mirrored pixel
//      in shared memory before any tap reads it (mirror_halo, shared with
//      W's reflect mode). F2's ring is then the h1 of the mirrored pixel.
//      The statistics still cover the B * H * W pixels of the image only;
//   backward: the adjoint of a mirrored read is an add at the mirrored
//      source. dx is the zero-padded transposed conv plus a fold: row 1
//      collects the transposed conv's value at row -1 (tap row 2 of dy's
//      row 0), row H - 2 its value at row H (tap row 0 of dy's row H - 1),
//      columns 1 and W - 2 likewise, the corners both. The fold is not a
//      halo substitution (one staged dy row feeds an output row through
//      one tap directly and through another via the mirror), so a small
//      launch before B2 / B3 (bn_fold_ring_kernel) computes those ring
//      values in f32 from the stored bf16 dy of the image's edge pixels,
//      about 2 (H + W) 64 values per image, and B2's / B3's epilogue adds
//      them at the fold rows and columns to its f32 sums BEFORE the PReLU
//      backward, the bf16 rounding of dz and BN1's sums (B2), and before
//      the skip add and its single rounding (B3): a fix-up after the bf16
//      store would round twice and give BN1 the sums of the wrong dz.
//
// One host call per trunk each way (srt_bn_trunk_fwd, srt_bn_trunk_bwd):
// the L blocks and the close conv + BN, the per-block loop in C++. The
// forward keeps every conv's input (u, h1 of each block, the close's u)
// in one stacked buffer and every y beside; the backward stores every
// conv's bf16 dy in a stacked buffer of the same shape, so all 2 L + 1
// weight grads are one launch of W's stacked jobs (REFLECT mode for
// K4r), and all db's one fixed-order reduction, after the last block.
//
// What bounds it on the H100: F1 / F2 do 2 * 9 * 64 * 64 = 73.7 kFLOP per
// pixel against 256 bytes in and out (F2 also writes h1: 384 B), ~290
// FLOP/byte, at the bf16 ridge; at the training shape (16 x 32 x 32,
// 1.21 GFLOP, 4.2 MB) either bound is about 1.25 us. B2 / B3 are the same
// conv plus three bf16 reads and two writes per pixel. F3, B1 and the
// act / dy passes do no matrix work: 256-384 bytes per pixel,
// bytes-bound.
//
// Rounding follows srtpu's kernels: y and dz are summed as stored (bf16);
// dy is rounded to bf16 for the conv and dW but db sums its f32 value.
// Products and sums that srtpu writes as separate f32 operations use the
// _rn intrinsics, so the compiler does not contract them into an FMA.
// (srtpu's REFLECT column fold adds two bf16 dy values in bf16 before its
// matrix product; the port folds in f32, the exact adjoint.)

#include "conv_sm90.cuh"
#include "wgrad.cuh"

namespace {

using namespace srt90;

constexpr int kC = 64;
constexpr int kVec = kC / 8;       // 16-byte vectors per pixel
constexpr int kSlices = 16;        // partial-sum lanes per channel (reduce)
constexpr int kChunk = 128;        // pixels per block of B1 and the dy pass
constexpr float kEps = 1e-5f;
constexpr size_t kConvW = 9 * kC * kC;

#define SRT_TRY(...)                       \
  do {                                     \
    cudaError_t e_ = (__VA_ARGS__);        \
    if (e_ != cudaSuccess) return e_;      \
  } while (0)

// The BN backward's per-channel constants cf (5, kC): mean, inv, coef =
// gamma * inv, t1 = S_g / m, t2 = S_gx / m (st rows 0, 2; sums (2, kC)).
// Threads 0 .. kC - 1 write them; the caller synchronises.
__device__ __forceinline__ void bn_bwd_coefs(float (*cf)[kC],
                                             const float* __restrict__ st,
                                             const float* __restrict__ gamma,
                                             const float* __restrict__ sums,
                                             float m) {
  if (threadIdx.x < kC) {
    const int c = threadIdx.x;
    cf[0][c] = st[c];
    cf[1][c] = st[2 * kC + c];
    cf[2][c] = __fmul_rn(gamma[c], st[2 * kC + c]);
    cf[3][c] = __fdiv_rn(sums[c], m);
    cf[4][c] = __fdiv_rn(sums[kC + c], m);
  }
}

// dy = coef * (g - t1 - xhat * t2), xhat = (y - mean) * inv, f32, for
// channels c0 .. c0 + 7: g holds g on entry and dy on return.
__device__ __forceinline__ void bn_dy8(const float (*cf)[kC], int c0,
                                       float (&g)[8], const float (&y)[8]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = c0 + j;
    const float xhat = __fmul_rn(__fsub_rn(y[j], cf[0][c]), cf[1][c]);
    g[j] = __fmul_rn(cf[2][c], __fsub_rn(__fsub_rn(g[j], cf[3][c]),
                                         __fmul_rn(xhat, cf[4][c])));
  }
}

// F2's operand: h = bf16(prelu(a * y + c)), (a, c) rows 3, 4 of st, the
// slope *alpha; 8 channels per thread.
__global__ void bn_act_kernel(const bf16* __restrict__ y,
                              const float* __restrict__ st,
                              const float* __restrict__ alpha,
                              bf16* __restrict__ h, long long nvec) {
  const float al = *alpha;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < nvec; i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % kVec) * 8;
    float f[8];
    unpack8(reinterpret_cast<const uint4*>(y)[i], f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float z =
          __fadd_rn(__fmul_rn(st[3 * kC + c + j], f[j]), st[4 * kC + c + j]);
      f[j] = z >= 0.0f ? z : __fmul_rn(al, z);
    }
    reinterpret_cast<uint4*>(h)[i] = pack8(f);
  }
}

// F3. out = bf16(a * y + c + u), 8 channels per thread.
__global__ void bn_norm_skip_kernel(const bf16* __restrict__ y,
                                    const float* __restrict__ st,
                                    const bf16* __restrict__ u,
                                    bf16* __restrict__ out, long long nvec) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < nvec; i += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(i % kVec) * 8;
    float yv[8], uv[8];
    unpack8(reinterpret_cast<const uint4*>(y)[i], yv);
    unpack8(reinterpret_cast<const uint4*>(u)[i], uv);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      yv[j] = __fadd_rn(
          __fadd_rn(__fmul_rn(st[3 * kC + c + j], yv[j]), st[4 * kC + c + j]),
          uv[j]);
    reinterpret_cast<uint4*>(out)[i] = pack8(yv);
  }
}

// Per-channel sums of a 256-thread block over its chunk of pixels:
// thread (pixel lane l = t / 8, channels 8 (t % 8) ..) has summed pixels
// l, l + 32, ...; a warp's four pixel lanes by a butterfly, then the warps
// in order, into part[q * kC + c] for the nq quantities.
template <int NQ>
__device__ __forceinline__ void chunk_sums(float (&v)[NQ][8],
                                           float* __restrict__ part) {
  __shared__ float red[NQ][8][kC];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int off = 8; off <= 16; off <<= 1)
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[q][j] = __fadd_rn(v[q][j], __shfl_xor_sync(0xffffffffu, v[q][j], off));
  if (lane < kVec)
#pragma unroll
    for (int q = 0; q < NQ; ++q)
#pragma unroll
      for (int j = 0; j < 8; ++j) red[q][warp][lane * 8 + j] = v[q][j];
  __syncthreads();
  if (threadIdx.x < NQ * kC) {
    const int q = threadIdx.x / kC, c = threadIdx.x % kC;
    float s = 0.0f;
    for (int w = 0; w < 8; ++w) s = __fadd_rn(s, red[q][w][c]);
    part[q * kC + c] = s;
  }
}

// B1. grid ceil(npix / kChunk), 256 threads. part[(chunk * 2 + q) * kC +
// c]: q = 0 sum g, q = 1 sum g * xhat.
__global__ void __launch_bounds__(256)
    bn_sums_kernel(const bf16* __restrict__ g, const bf16* __restrict__ y,
                   const float* __restrict__ st, float* __restrict__ part,
                   long long npix) {
  const int v = threadIdx.x % kVec, pl = threadIdx.x / kVec;
  float mean[8], inv[8], s[2][8] = {};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mean[j] = st[v * 8 + j];
    inv[j] = st[2 * kC + v * 8 + j];
  }
  const long long p0 = (long long)blockIdx.x * kChunk;
  const long long p1 = p0 + kChunk < npix ? p0 + kChunk : npix;
  for (long long p = p0 + pl; p < p1; p += 256 / kVec) {
    float gv[8], yv[8];
    unpack8(*reinterpret_cast<const uint4*>(g + p * kC + v * 8), gv);
    unpack8(*reinterpret_cast<const uint4*>(y + p * kC + v * 8), yv);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float xhat = __fmul_rn(__fsub_rn(yv[j], mean[j]), inv[j]);
      s[0][j] = __fadd_rn(s[0][j], gv[j]);
      s[1][j] = __fadd_rn(s[1][j], __fmul_rn(gv[j], xhat));
    }
  }
  chunk_sums<2>(s, part + (size_t)blockIdx.x * 2 * kC);
}

// B2's / B3's operand. grid ceil(npix / kChunk), 256 threads: dy = bf16
// of coef * (g - sums[0] / m - xhat * sums[1] / m), xhat = (y - mean) *
// inv, coef = gamma * inv (mean, inv rows 0, 2 of st), and part[chunk *
// kC + c] the chunk's sum of the f32 dy (db's partials).
__global__ void __launch_bounds__(256)
    bn_dy_kernel(const bf16* __restrict__ g, const bf16* __restrict__ y,
                 const float* __restrict__ st, const float* __restrict__ gamma,
                 const float* __restrict__ sums, float m,
                 bf16* __restrict__ dy, float* __restrict__ part,
                 long long npix) {
  __shared__ float cf[5][kC];
  bn_bwd_coefs(cf, st, gamma, sums, m);
  __syncthreads();
  const int v = threadIdx.x % kVec, pl = threadIdx.x / kVec;
  float s[1][8] = {};
  const long long p0 = (long long)blockIdx.x * kChunk;
  const long long p1 = p0 + kChunk < npix ? p0 + kChunk : npix;
  for (long long p = p0 + pl; p < p1; p += 256 / kVec) {
    const size_t at = p * kC + v * 8;
    float gv[8], yv[8];
    unpack8(*reinterpret_cast<const uint4*>(g + at), gv);
    unpack8(*reinterpret_cast<const uint4*>(y + at), yv);
    bn_dy8(cf, v * 8, gv, yv);
    *reinterpret_cast<uint4*>(dy + at) = pack8(gv);
#pragma unroll
    for (int j = 0; j < 8; ++j) s[0][j] = __fadd_rn(s[0][j], gv[j]);
  }
  chunk_sums<1>(s, part + (size_t)blockIdx.x * kC);
}

// REFLECT B2 / B3, launched before them: the f32 transposed-conv values
// that reflect folds onto the rows and columns next to the image's edge.
// With P the zero-padded transposed conv of bf16(dy) over the padded grid
// (rows -1 .. H, columns -1 .. W) and R(i) = {i} + {-1 if i == 1} + {H if
// i == H - 2} (S(j) the same for columns), dx(i, j) is the sum of P over
// R(i) x S(j). Beyond P(i, j), B2's and B3's own conv, that is, per image
// b of ring (B, 2 W + 2 H, kC):
//   entry x          = P(-1, x), added at row 1 (x < W);
//   entry W + x      = P(H, x), added at row H - 2;
//   entry 2 W + y    = the sum over r in R(y) of P(r, -1), added at
//                      column 1 (y < H; the corners folded in);
//   entry 2 W + H + y = the same of P(r, W), added at column W - 2.
// P(-1, .) reads dy's row 0 through tap row 2 only, P(H, .) row H - 1
// through tap row 0, the columns likewise: three taps a side; tap (ty, tx)
// of the transposed conv is the forward weight's tap (2 - ty, 2 - tx) with
// its channels swapped, w[2 - ty, 2 - tx, co, ci]. grid (ceil(max(W, H) /
// kRingSeg), 4, B): side y = top, bottom, left, right; block x takes
// entries x * kRingSeg .. + kRingSeg - 1 of its side. It stages its
// side's three taps in shared memory (ci-major, so a warp's lanes read
// consecutive co) and the stored bf16 dy of the edge pixels they read;
// thread t sums output channel t % 64 of every fourth entry, each in f32
// over the taps in order, a tap's 64 products in four interleaved chains
// added in a fixed order. Its time is the shared-memory reads, one
// weight element a product (about 10 us a launch at the training shape
// on the H100; on the tensor cores the ring is a [entries x 64] x [64 x
// 64] product per tap, untried).
constexpr int kRingSeg = 8;

__global__ void __launch_bounds__(256)
    bn_fold_ring_kernel(const bf16* __restrict__ dy,
                        const bf16* __restrict__ w, float* __restrict__ ring,
                        int H, int W) {
  __shared__ float line[kRingSeg + 2][kC];  // dy at positions e0 - 1 ..
  __shared__ bf16 wsm[3][kC][kC];           // tap k's [ci][co]
  const int side = blockIdx.y, b = blockIdx.z;
  const bool row = side < 2;  // a ring row (top, bottom) or column
  const int len = row ? W : H, e0 = blockIdx.x * kRingSeg;
  if (e0 >= len) return;  // the whole block
  // the tap row (ring rows) or column (ring columns) that reads the ring
  const int tfix = side == 0 || side == 2 ? 2 : 0;
  for (int i = threadIdx.x; i < 3 * kC * kVec; i += blockDim.x) {
    // a warp's lanes take consecutive co: conflict-free stores
    const int k = i / (kC * kVec), v = (i / kC) % kVec, co = i % kC;
    const int ty = row ? tfix : k, tx = row ? k : tfix;
    float f[8];
    unpack8(__ldg(reinterpret_cast<const uint4*>(
                w + ((size_t)((2 - ty) * 3 + (2 - tx)) * kC + co) * kC) +
                  v),
            f);
#pragma unroll
    for (int j = 0; j < 8; ++j) wsm[k][v * 8 + j][co] = __float2bfloat16(f[j]);
  }
  // the edge line of dy: row 0 / H - 1 or column 0 / W - 1
  const int edge = side == 1 ? H - 1 : side == 3 ? W - 1 : 0;
  for (int i = threadIdx.x; i < (kRingSeg + 2) * kVec; i += blockDim.x) {
    const int l = i / kVec, v = i % kVec, j = e0 - 1 + l;
    float d[8] = {};
    if (j >= 0 && j < len)
      unpack8(*reinterpret_cast<const uint4*>(
                  dy + (((size_t)b * H + (row ? edge : j)) * W +
                        (row ? j : edge)) * kC + v * 8),
              d);
#pragma unroll
    for (int k = 0; k < 8; ++k) line[l][v * 8 + k] = d[k];
  }
  __syncthreads();
  const int co = threadIdx.x % kC;
  // the sum over ci of dy at line position j times tap k, for co: four
  // interleaved f32 chains (ci mod 4), then added in order
  auto tap = [&](int j, int k) {
    const float* d = line[j - e0 + 1];
    float s[4] = {};
#pragma unroll 4
    for (int ci = 0; ci < kC; ci += 4)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        s[q] = fmaf(d[ci + q], __bfloat162float(wsm[k][ci + q][co]), s[q]);
    return (s[0] + s[1]) + (s[2] + s[3]);
  };
  const int base = side == 0 ? 0 : side == 1 ? W : side == 2 ? 2 * W
                                                            : 2 * W + H;
  for (int e = e0 + threadIdx.x / kC; e < e0 + kRingSeg && e < len;
       e += blockDim.x / kC) {
    float acc = 0.0f;
    if (row) {  // P(-1 or H, e): dy's columns e - 1 .. e + 1
      for (int tx = 0; tx < 3; ++tx) {
        const int j = e + tx - 1;
        if (j >= 0 && j < W) acc += tap(j, tx);
      }
    } else {  // the sum over r in R(e) of P(r, -1 or W)
      const int rs[3] = {e, e == 1 ? -1 : -3, e == H - 2 ? H : -3};
      for (int k = 0; k < 3; ++k) {
        if (rs[k] == -3) continue;
        for (int ty = 0; ty < 3; ++ty) {
          const int i = rs[k] + ty - 1;
          if (i >= 0 && i < H) acc += tap(i, ty);
        }
      }
    }
    ring[((size_t)b * (2 * W + 2 * H) + base + e) * kC + co] = acc;
  }
}

// The partials part (nparts, nq, kC) summed over the parts in a fixed
// order (lane (c, s) takes parts s, s + kSlices, ..., then lane (c, 0)
// adds the slices in order). With gamma (nq = 2: sum, sum of squares over
// m pixels): out = the statistics (5, kC): mean, biased var, inv, a, c
// (srtpu's _finalize). Else out = the sums of q = q0 .. nq - 1 as (nq -
// q0, kC), and total (when given) = the sum of q = tq over the channels,
// in order. Block z does reduction z: part + z pstride, out + z ostride,
// total + z.
__global__ void __launch_bounds__(kSlices * kC)
    bn_reduce_kernel(const float* __restrict__ part, int nparts, int nq,
                     int q0, float m, const float* __restrict__ gamma,
                     const float* __restrict__ beta, float* __restrict__ out,
                     float* __restrict__ total, int tq, long long pstride,
                     long long ostride) {
  __shared__ float red[kSlices * kC], tot[4][kC];
  part += blockIdx.x * pstride;
  out += blockIdx.x * ostride;
  const int c = threadIdx.x % kC, s = threadIdx.x / kC;
  for (int q = 0; q < nq; ++q) {
    float a = 0.0f;
    for (int t = s; t < nparts; t += kSlices)
      a = __fadd_rn(a, part[((size_t)t * nq + q) * kC + c]);
    red[s * kC + c] = a;
    __syncthreads();
    if (threadIdx.x < kC) {
      float sum = 0.0f;
      for (int k = 0; k < kSlices; ++k) sum = __fadd_rn(sum, red[k * kC + c]);
      tot[q][c] = sum;
    }
    __syncthreads();
  }
  if (threadIdx.x < kC) {
    if (gamma) {
      const float mean = __fdiv_rn(tot[0][c], m);
      const float var = fmaxf(
          __fsub_rn(__fdiv_rn(tot[1][c], m), __fmul_rn(mean, mean)), 0.0f);
      const float inv = __fdiv_rn(1.0f, __fsqrt_rn(__fadd_rn(var, kEps)));
      const float a = __fmul_rn(gamma[c], inv);
      out[c] = mean;
      out[kC + c] = var;
      out[2 * kC + c] = inv;
      out[3 * kC + c] = a;
      out[4 * kC + c] = __fsub_rn(beta[c], __fmul_rn(mean, a));
    } else {
      for (int q = q0; q < nq; ++q) out[(q - q0) * kC + c] = tot[q][c];
    }
  }
  if (total && threadIdx.x == 0) {
    float sum = 0.0f;
    for (int k = 0; k < kC; ++k) sum = __fadd_rn(sum, tot[tq][k]);
    total[blockIdx.x] = sum;
  }
}

cudaError_t reduce(const float* part, int nparts, int nq, float m,
                   const float* gamma, const float* beta, float* out,
                   cudaStream_t s, int q0 = 0, float* total = nullptr,
                   int tq = 0, int n = 1, long long pstride = 0,
                   long long ostride = 0) {
  bn_reduce_kernel<<<n, kSlices * kC, 0, s>>>(part, nparts, nq, q0, m, gamma,
                                              beta, out, total, tq, pstride,
                                              ostride);
  return cudaGetLastError();
}

int tiles(int B, int H, int W) {
  return B * ((W + kTW - 1) / kTW) * ((H + kTH - 1) / kTH);
}

int chunks(long long npix) { return (int)((npix + kChunk - 1) / kChunk); }

int elementwise_grid(long long nvec) {
  const long long want = (nvec + 255) / 256;
  return (int)(want < (1 << 20) ? want : (1 << 20));
}

// The engine's operands for K4: x (B, H, W, 64), w (3, 3, 64, 64) HWIO.
ConvArgs args_k4(const void* x, const void* w, const void* bias, void* out,
                 float* part, int B, int H, int W) {
  ConvArgs a = args_3x3_64(static_cast<const bf16*>(x),
                           static_cast<const bf16*>(w),
                           static_cast<const float*>(bias),
                           static_cast<bf16*>(out), B, H, W);
  a.k4.part = part;
  return a;
}

// F1's conv and statistics: y = bf16(conv(x, w) + bias), st (5, 64) of
// the stored y. Two launches.
cudaError_t conv_stats(const void* x, const void* w, const void* bias,
                       const void* gamma, const void* beta, void* y,
                       float* part, float* st, int B, int H, int W,
                       int reflect, cudaStream_t s) {
  ConvArgs a = args_k4(x, w, bias, y, part, B, H, W);
  a.k4.reflect = reflect;
  SRT_TRY((run_bn<false, 9>(a, s)));
  return reduce(part, tiles(B, H, W), 2, (float)B * (float)H * (float)W,
                static_cast<const float*>(gamma),
                static_cast<const float*>(beta), st, s);
}

cudaError_t act(const void* y, const float* st, const float* alpha, void* h,
                long long npix, cudaStream_t s) {
  const long long nvec = npix * kVec;
  bn_act_kernel<<<elementwise_grid(nvec), 256, 0, s>>>(
      static_cast<const bf16*>(y), st, alpha, static_cast<bf16*>(h), nvec);
  return cudaGetLastError();
}

cudaError_t norm_skip(const void* y, const float* st, const void* u,
                      void* out, long long npix, cudaStream_t s) {
  const long long nvec = npix * kVec;
  bn_norm_skip_kernel<<<elementwise_grid(nvec), 256, 0, s>>>(
      static_cast<const bf16*>(y), st, static_cast<const bf16*>(u),
      static_cast<bf16*>(out), nvec);
  return cudaGetLastError();
}

// B1: sums (2, 64). Two launches.
cudaError_t bn_sums(const void* g, const void* y, const float* st,
                    float* part, float* sums, long long npix, cudaStream_t s) {
  bn_sums_kernel<<<chunks(npix), 256, 0, s>>>(static_cast<const bf16*>(g),
                                              static_cast<const bf16*>(y), st,
                                              part, npix);
  SRT_TRY(cudaGetLastError());
  return reduce(part, chunks(npix), 2, 1.0f, nullptr, nullptr, sums, s);
}

// The dy pass and, with reflect, the fold ring from that dy and w.
cudaError_t dy_ring(const void* g, const void* y, const float* st,
                    const float* gamma, const float* sums, void* dy,
                    float* dbpart, const void* w, float* ring, int B, int H,
                    int W, int reflect, cudaStream_t s) {
  const long long npix = (long long)B * H * W;
  bn_dy_kernel<<<chunks(npix), 256, 0, s>>>(
      static_cast<const bf16*>(g), static_cast<const bf16*>(y), st, gamma,
      sums, (float)npix, static_cast<bf16*>(dy), dbpart, npix);
  SRT_TRY(cudaGetLastError());
  if (!reflect) return cudaSuccess;
  const int longest = H > W ? H : W;
  bn_fold_ring_kernel<<<dim3((longest + kRingSeg - 1) / kRingSeg, 4, B), 256,
                        0, s>>>(static_cast<const bf16*>(dy),
                                static_cast<const bf16*>(w), ring, H, W);
  return cudaGetLastError();
}

// B2's conv: dz (B, H, W, 64) and part (tiles, 3, 64): dalpha, sum dz,
// sum dz * xhat1 per tile and channel.
cudaError_t b2_conv(const void* dy, const void* w, const void* y1,
                    const float* st1, const float* alpha, const float* ring,
                    void* dz, float* part, int B, int H, int W,
                    cudaStream_t s) {
  ConvArgs a = args_k4(dy, w, nullptr, dz, part, B, H, W);
  a.k4.y1 = static_cast<const bf16*>(y1);
  a.k4.st1 = st1;
  a.k4.alpha = alpha;
  a.k4.ring = ring;
  return run_bn<true, 10>(a, s);
}

// B3's conv: du = bf16(convT(dy; w) + fold + f32(skip)), then bf16(du +
// f32(skip2)) where skip2 is given.
cudaError_t b3_conv(const void* dy, const void* w, const void* skip,
                    const void* skip2, const float* ring, void* du, int B,
                    int H, int W, cudaStream_t s) {
  ConvArgs a = args_k4(dy, w, nullptr, du, nullptr, B, H, W);
  a.k4.skip = static_cast<const bf16*>(skip);
  a.k4.skip2 = static_cast<const bf16*>(skip2);
  a.k4.ring = ring;
  return run_bn<true, 11>(a, s);
}

bool shape_ok(int B, int H, int W, int reflect) {
  return B > 0 && H > 0 && W > 0 && (!reflect || (H >= 2 && W >= 2));
}

}  // namespace

// F1 (st_in null) or F2 (st_in the (5, 64) statistics of y1, alpha its
// PReLU slope, h_out (B, H, W, 64) bf16 gets h1 = bf16(prelu(a1 x + c1))
// and the conv reads it): x (B, H, W, 64) bf16, w (3, 3, 64, 64) bf16,
// bias, gamma, beta (64) f32 -> y (B, H, W, 64) bf16 and st_out (5, 64)
// f32. reflect != 0: REFLECT boundaries (H, W >= 2), else SAME. part: (B
// * ceil(H / 8) * ceil(W / 16), 2, 64) f32 scratch. Two launches (F2:
// three). Returns a cudaError_t.
extern "C" int srt_bn_conv_stats(const void* x, const void* st_in,
                                 const void* alpha, const void* w,
                                 const void* bias, const void* gamma,
                                 const void* beta, void* y, void* h_out,
                                 void* part, void* st_out, int B, int H,
                                 int W, int reflect, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!shape_ok(B, H, W, reflect)) return (int)cudaErrorInvalidValue;
  const void* in = x;
  if (st_in) {
    SRT_TRY(act(x, static_cast<const float*>(st_in),
                static_cast<const float*>(alpha), h_out, (long long)B * H * W,
                s));
    in = h_out;
  }
  return (int)conv_stats(in, w, bias, gamma, beta, y,
                         static_cast<float*>(part),
                         static_cast<float*>(st_out), B, H, W, reflect, s);
}

// F3: out = bf16(a * y + c + u), (a, c) rows 3, 4 of st; y, u, out
// (npix, 64) bf16. One launch. Returns a cudaError_t.
extern "C" int srt_bn_norm_skip(const void* y, const void* st, const void* u,
                                void* out, long long npix, void* stream) {
  return (int)norm_skip(y, static_cast<const float*>(st), u, out, npix,
                        static_cast<cudaStream_t>(stream));
}

// B1: sums (2, 64) f32 = sum g, sum g * xhat over npix pixels, xhat from
// y and rows 0, 2 (mean, inv) of st; g, y (npix, 64) bf16. part:
// (ceil(npix / 128), 2, 64) f32 scratch. Two launches. Returns a
// cudaError_t.
extern "C" int srt_bn_sums(const void* g, const void* y, const void* st,
                           void* part, void* sums, long long npix,
                           void* stream) {
  return (int)bn_sums(g, y, static_cast<const float*>(st),
                      static_cast<float*>(part), static_cast<float*>(sums),
                      npix, static_cast<cudaStream_t>(stream));
}

// B2 (y1, st1, alpha given: out = dz, red (4, 64) = db, dalpha per
// channel, sum dz, sum dz * xhat1; dal (1) = dalpha) or B3 (y1 null: out
// = du with skip added unless skip is null, red (1, 64) = db). g, y, out,
// dy_out (B, H, W, 64) bf16; st, st1 (5, 64), gamma (64), sums (2, 64)
// f32; w (3, 3, 64, 64) bf16, the forward weight (the transposed conv
// reads it as it lies). reflect != 0: REFLECT boundaries (H, W >= 2; ring
// (B, 2 W + 2 H, 64) f32 scratch for the fold, one launch more), else
// SAME (ring unused). part: (B * ceil(H / 8) * ceil(W / 16), 3, 64) f32
// scratch (B2), dbpart (ceil(B H W / 128), 64) f32 scratch. Three
// launches (B2: four; one more with reflect). Returns a cudaError_t.
extern "C" int srt_bn_bwd_conv(const void* g, const void* y, const void* st,
                               const void* gamma, const void* sums,
                               const void* w, void* dy_out, void* out,
                               const void* y1, const void* st1,
                               const void* alpha, const void* skip,
                               void* part, void* dbpart, void* red,
                               void* dal, void* ring, int B, int H, int W,
                               int reflect, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!shape_ok(B, H, W, reflect)) return (int)cudaErrorInvalidValue;
  const long long npix = (long long)B * H * W;
  float* ringf = reflect ? static_cast<float*>(ring) : nullptr;
  float* redf = static_cast<float*>(red);
  SRT_TRY(dy_ring(g, y, static_cast<const float*>(st),
                  static_cast<const float*>(gamma),
                  static_cast<const float*>(sums), dy_out,
                  static_cast<float*>(dbpart), w, ringf, B, H, W, reflect, s));
  if (y1) {
    SRT_TRY(b2_conv(dy_out, w, y1, static_cast<const float*>(st1),
                    static_cast<const float*>(alpha), ringf, out,
                    static_cast<float*>(part), B, H, W, s));
    SRT_TRY(reduce(static_cast<const float*>(part), tiles(B, H, W), 3, 1.0f,
                   nullptr, nullptr, redf + kC, s, 0,
                   static_cast<float*>(dal), 0));
  } else {
    SRT_TRY(b3_conv(dy_out, w, skip, nullptr, ringf, out, B, H, W, s));
  }
  return (int)reduce(static_cast<const float*>(dbpart), chunks(npix), 1,
                     1.0f, nullptr, nullptr, redf, s);
}

// The training-mode forward of L >= 1 BN blocks and the close conv + BN
// + global skip. x (B, H, W, 64) bf16; per block (stacked L deep) w1s,
// w2s (L, 3, 3, 64, 64) bf16, b1s, g1s, be1s, b2s, g2s, be2s (L, 64) and
// alphas (L) f32; the close's wc (3, 3, 64, 64) bf16, bc, gc, bec (64)
// f32. Writes acts (2 L + 1, B, H, W, 64) bf16, every conv's input: slot
// 2 i block i's u (slot 0 a copy of x), 2 i + 1 its h1, 2 L the close's
// u; ys (2 L + 1, B, H, W, 64) bf16, the convs' y in the same order; sts
// (2 L + 1, 5, 64) f32, their batch statistics (mean, var, inv, a, c);
// out (B, H, W, 64) bf16. part: (B * ceil(H / 8) * ceil(W / 16), 2, 64)
// f32 scratch. reflect as srt_bn_conv_stats. Returns a cudaError_t.
extern "C" int srt_bn_trunk_fwd(
    const void* x, const void* w1s, const void* b1s, const void* g1s,
    const void* be1s, const void* alphas, const void* w2s, const void* b2s,
    const void* g2s, const void* be2s, const void* wc, const void* bc,
    const void* gc, const void* bec, void* acts, void* ys, void* sts,
    void* part, void* out, int L, int B, int H, int W, int reflect,
    void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L < 1 || !shape_ok(B, H, W, reflect)) return (int)cudaErrorInvalidValue;
  const long long npix = (long long)B * H * W;
  const size_t act_n = (size_t)npix * kC;
  bf16* const A = static_cast<bf16*>(acts);
  bf16* const Y = static_cast<bf16*>(ys);
  float* const S = static_cast<float*>(sts);
  float* const pf = static_cast<float*>(part);
  auto v = [](const void* p, int i) {
    return static_cast<const float*>(p) + (size_t)i * kC;
  };
  SRT_TRY(cudaMemcpyAsync(A, x, act_n * sizeof(bf16),
                          cudaMemcpyDeviceToDevice, s));
  for (int i = 0; i < L; ++i) {
    bf16* u = A + 2 * i * act_n;
    const bf16* w1 = static_cast<const bf16*>(w1s) + i * kConvW;
    const bf16* w2 = static_cast<const bf16*>(w2s) + i * kConvW;
    float* st1 = S + (size_t)(2 * i) * 5 * kC;
    float* st2 = st1 + 5 * kC;
    SRT_TRY(conv_stats(u, w1, v(b1s, i), v(g1s, i), v(be1s, i),
                       Y + 2 * i * act_n, pf, st1, B, H, W, reflect, s));
    SRT_TRY(act(Y + 2 * i * act_n, st1,
                static_cast<const float*>(alphas) + i, u + act_n, npix, s));
    SRT_TRY(conv_stats(u + act_n, w2, v(b2s, i), v(g2s, i), v(be2s, i),
                       Y + (2 * i + 1) * act_n, pf, st2, B, H, W, reflect,
                       s));
    SRT_TRY(norm_skip(Y + (2 * i + 1) * act_n, st2, u, u + 2 * act_n, npix,
                      s));
  }
  float* stc = S + (size_t)(2 * L) * 5 * kC;
  SRT_TRY(conv_stats(A + 2 * L * act_n, wc, bc, gc, bec, Y + 2 * L * act_n,
                     pf, stc, B, H, W, reflect, s));
  return (int)norm_skip(Y + 2 * L * act_n, stc, x, out, npix, s);
}

// The backward of srt_bn_trunk_fwd, the close first, then blocks L - 1 ..
// 0. acts, ys, sts as the forward wrote them; g (B, H, W, 64) bf16, the
// cotangent of out; the weights and gammas as the forward's. Scratch:
// gbuf (2, B, H, W, 64) and dzb (B, H, W, 64) bf16; ring (B, 2 W + 2 H,
// 64) f32 (reflect; else null); part (B * ceil(H / 8) * ceil(W / 16), 3,
// 64) and sp (ceil(B H W / 128), 2, 64) f32; dbpart (2 L + 1, ceil(B H W
// / 128), 64) f32; ws_w, ws_b the weight grads' partial slots (null
// unless nclusters > 1; srtpu_torch/ops/wgrad.py:wgrad_parts for 2 L + 1
// jobs); dbw (2 L + 1, 64) f32, the weight-grad launch's db, unused.
// Writes dys (2 L + 1, B, H, W, 64) bf16, every conv's bf16 dy in acts'
// order (dy1 of block i in slot 2 i, dy2 in 2 i + 1, the close's in 2 L);
// dws (2 L + 1, 3, 3, 64, 64) f32 the weight grads; dbs (2 L + 1, 64) f32
// the conv biases' grads (sums of the f32 dy); sums (2 L + 1, 2, 64) f32
// each BN's S_g, S_gx (its beta's and gamma's grads); dal (L) f32; dx (B,
// H, W, 64) bf16 = bf16(block 0's du + g). Returns a cudaError_t.
extern "C" int srt_bn_trunk_bwd(
    const void* acts, const void* ys, const void* sts, const void* g,
    const void* w1s, const void* w2s, const void* wc, const void* g1s,
    const void* g2s, const void* gc, const void* alphas, void* dys,
    void* gbuf, void* dzb, void* ring, void* part, void* sp, void* dbpart,
    void* ws_w, void* ws_b, void* dbw, void* dws, void* dbs, void* sums,
    void* dal, void* dx, int L, int B, int H, int W, int reflect,
    int cluster, int nclusters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (L < 1 || !shape_ok(B, H, W, reflect) || (reflect && !ring))
    return (int)cudaErrorInvalidValue;
  const long long npix = (long long)B * H * W;
  const size_t act_n = (size_t)npix * kC;
  const int nch = chunks(npix);
  const bf16* const A = static_cast<const bf16*>(acts);
  const bf16* const Y = static_cast<const bf16*>(ys);
  const float* const S = static_cast<const float*>(sts);
  bf16* const D = static_cast<bf16*>(dys);
  bf16* const G = static_cast<bf16*>(gbuf);
  float* const SU = static_cast<float*>(sums);
  float* const DP = static_cast<float*>(dbpart);
  float* const ringf = reflect ? static_cast<float*>(ring) : nullptr;
  float* const pf = static_cast<float*>(part);
  float* const spf = static_cast<float*>(sp);
  auto st = [&](int k) { return S + (size_t)k * 5 * kC; };
  auto gm = [](const void* p, int i) {
    return static_cast<const float*>(p) + (size_t)i * kC;
  };
  // the close: B1, its dy, B3 with no skip
  const int c = 2 * L;
  SRT_TRY(bn_sums(g, Y + c * act_n, st(c), spf, SU + c * 2 * kC, npix, s));
  SRT_TRY(dy_ring(g, Y + c * act_n, st(c), static_cast<const float*>(gc),
                  SU + c * 2 * kC, D + c * act_n, DP + (size_t)c * nch * kC,
                  wc, ringf, B, H, W, reflect, s));
  SRT_TRY(b3_conv(D + c * act_n, wc, nullptr, nullptr, ringf, G, B, H, W, s));
  const bf16* gcur = G;
  for (int i = L - 1; i >= 0; --i) {
    const int k1 = 2 * i, k2 = 2 * i + 1;
    const bf16* w1 = static_cast<const bf16*>(w1s) + i * kConvW;
    const bf16* w2 = static_cast<const bf16*>(w2s) + i * kConvW;
    // BN2 backward and B2
    SRT_TRY(bn_sums(gcur, Y + k2 * act_n, st(k2), spf, SU + k2 * 2 * kC,
                    npix, s));
    SRT_TRY(dy_ring(gcur, Y + k2 * act_n, st(k2), gm(g2s, i),
                    SU + k2 * 2 * kC, D + k2 * act_n,
                    DP + (size_t)k2 * nch * kC, w2, ringf, B, H, W, reflect,
                    s));
    SRT_TRY(b2_conv(D + k2 * act_n, w2, Y + k1 * act_n, st(k1),
                    static_cast<const float*>(alphas) + i, ringf, dzb, pf, B,
                    H, W, s));
    SRT_TRY(reduce(pf, tiles(B, H, W), 3, 1.0f, nullptr, nullptr,
                   SU + k1 * 2 * kC, s, 1, static_cast<float*>(dal) + i, 0));
    // BN1 backward and B3, the block skip (and at block 0 the trunk's)
    SRT_TRY(dy_ring(dzb, Y + k1 * act_n, st(k1), gm(g1s, i),
                    SU + k1 * 2 * kC, D + k1 * act_n,
                    DP + (size_t)k1 * nch * kC, w1, ringf, B, H, W, reflect,
                    s));
    bf16* gout = i ? G + (gcur == G ? act_n : 0) : static_cast<bf16*>(dx);
    SRT_TRY(b3_conv(D + k1 * act_n, w1, gcur, i ? nullptr : g, ringf, gout,
                    B, H, W, s));
    gcur = gout;
  }
  // every conv's weight grads in one launch of stacked jobs, every db in
  // one fixed-order reduction
  WgradArgs a = {};
  a.x = A;
  a.g = D;
  a.ws_w = ws_w;
  a.ws_b = ws_b;
  a.dw = dws;
  a.db = dbw;
  a.J = 2 * L + 1;
  a.x_stride = (long long)act_n;
  a.g_stride = (long long)act_n;
  a.B = B;
  a.H = H;
  a.W = W;
  a.cin = kC;
  a.cout = kC;
  a.r = 1;
  a.gscale = 1.0f;
  a.cluster = cluster;
  a.nclusters = nclusters;
  a.k = 3;
  a.reflect = reflect;
  SRT_TRY(wgrad(a, s));
  return (int)reduce(DP, nch, 1, 1.0f, nullptr, nullptr,
                     static_cast<float*>(dbs), s, 0, nullptr, 0, 2 * L + 1,
                     (long long)nch * kC, kC);
}
