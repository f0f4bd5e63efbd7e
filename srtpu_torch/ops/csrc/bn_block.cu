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
//   F2 the same conv with a load transform: the staged tile is
//      h1 = bf16(prelu(a1 * y1 + c1)), saved for dW2; -> y2 + stats. Its
//      padding applies to h1, not to y1: SAME stages zero outside the
//      image, REFLECT the h1 of the mirrored pixel;
//   F3 out = bf16(a2 * y2 + c2 + u), one rounding, no padding;
// and the backward
//   B1 S_g = sum g, S_gx = sum g * xhat2 (xhat recomputed from y2), no
//      padding;
//   B2 a load transform builds dy2 = coef2 * (g - S_g / m - xhat2 *
//      S_gx / m) (coef2 = gamma2 * inv2) in f32: bf16(dy2) is staged and
//      stored for dW2, its f32 value summed into db2; then the transposed
//      conv with W2 gives dh1, and the epilogue does the PReLU backward on
//      z = a1 * y1 + c1 (recomputed): dz = bf16(z >= 0 ? dh1 : alpha *
//      dh1) stored, dalpha += (z < 0 ? dh1 * z : 0), and BN1's sums of the
//      STORED dz: S_dz, S_dz * xhat1;
//   B3 the same prologue for BN1 from dz, the transposed conv with W1,
//      and du = bf16(dh + g) (the block skip; the trunk's close conv has
//      none); db1 from the f32 dy1.
// B2's and B3's staged dy is zero outside the image under both paddings:
// the transposed conv of a SAME conv is a SAME conv. dW1 = corr(u, bf16
// dy1) and dW2 = corr(h1, bf16 dy2) come from wgrad.cu, which reads u and
// h1 with the padding of the forward (REFLECT: the halo mirrored in shared
// memory after its TMA load); h1 is
// the one F2 saved (2 MB per block at the training shape, as K1's saving
// forward keeps its h1) instead of a load transform in wgrad.cu.
//
// What REFLECT changes (template instances of the same kernels, H, W >= 2;
// mirror m(-1) = 1, m(H) = H - 2, the same for columns):
//   forward: the staged tile's one-pixel ring outside the image holds the
//      mirrored pixel (srt::load_tile's REFLECT mode; F2's load reads
//      y1[m(.)] and stages its h1). The statistics still cover the B * H
//      * W pixels of the image only;
//   backward: the adjoint of a mirrored read is an add at the mirrored
//      source. dx is the zero-padded transposed conv plus a fold: row 1
//      collects the transposed conv's value at row -1 (tap row 2 of dy's
//      row 0), row H - 2 its value at row H (tap row 0 of dy's row H - 1),
//      columns 1 and W - 2 likewise, the corners both. The fold is not a
//      halo substitution (one staged dy row feeds an output row through
//      one tap directly and through another via the mirror), so a small
//      launch before B2 / B3 (bn_fold_ring_kernel) computes those ring
//      values in f32 from bf16(dy) of the image's edge pixels, about
//      2 (H + W) 64 values per image, and B2's / B3's epilogue adds them
//      at the fold rows and columns to its f32 sums BEFORE the PReLU
//      backward, the bf16 rounding of dz and BN1's sums (B2), and before
//      the skip add and its single rounding (B3): a fix-up after the bf16
//      store would round twice and give BN1 the sums of the wrong dz.
//   Reflect adds no matrix work and no bytes to the main kernels beyond
//   the ring: 2 (H + W) 64 f32 written and read per image (0.53 MB at the
//   training shape against the conv's 4.2 MB), and the ring launch's
//   3 x 64 x 64 multiply-adds per ring value (about 26 MFLOP at the
//   training shape, on the CUDA cores).
//
// Hopper against the TPU. The batch statistics sit between each conv and
// its normalisation and cover the whole batch, so the passes cannot fuse
// into one block as K8a's pair does (fused_block.cuh): each pass is a
// launch, and on a TPU the sequential grid carries the sums in resident
// accumulators, while here blocks run in no order. Every cross-block sum
// is therefore written as per-block partials (per tile and channel; a
// warp sums its rows with a fixed shuffle butterfly, the block its warps
// in order) and added by bn_reduce_kernel in a fixed order, which also
// finalizes the statistics. No float atomics: two calls give the same
// bits. NHWC has no dead lanes, so the statistics cover all B * H * W
// pixels (srtpu's s_valid) and no re-zeroing is needed.
//
// What bounds it on the H100: F1 / F2 do 2 * 9 * 64 * 64 = 73.7 kFLOP per
// pixel against 256 bytes in and out (F2 also writes h1: 384 B), ~290
// FLOP/byte, at the bf16 ridge; at the training shape (16 x 32 x 32,
// 1.21 GFLOP, 4.2 MB) either bound is about 1.25 us. B2 / B3 are the same
// conv plus three bf16 reads and two writes per pixel. F3 and B1 do no
// matrix work: 384 and 256 bytes per pixel, bytes-bound. The convs run
// the tile engine of tile_conv.cuh (wmma bf16, f32 sums) on 7 x 16 tiles,
// one 16-position wmma tile per warp; no wgmma/TMA yet.
//
// Rounding follows srtpu's kernels: y and dz are summed as stored (bf16);
// dy is rounded to bf16 for the conv and dW but db sums its f32 value.
// Products and sums that srtpu writes as separate f32 operations use the
// _rn intrinsics, so the compiler does not contract them into an FMA.
// (srtpu's REFLECT column fold adds two bf16 dy values in bf16 before its
// matrix product; the port folds in f32, the exact adjoint.)

#include "tile_conv.cuh"

namespace {

using srt::bf16;
constexpr int kC = 64;
constexpr int kTH = 7, kTW = 16;
constexpr int kVec = kC / 8;       // 16-byte vectors per pixel
constexpr int kSlices = 16;        // partial-sum lanes per channel (reduce)
constexpr int kChunk = 256;        // pixels per B1 block
constexpr float kEps = 1e-5f;
typedef srt::ConvPlan<kC, kC, kTH, kTW> P;
static_assert(P::MF == srt::kWarps, "one 16-position tile per warp");
static_assert(srt::kThreads % kVec == 0, "a thread loads fixed channels");
// per-warp sums of up to 4 quantities, over the staged tile once the
// conv has read it
static_assert((size_t)4 * srt::kWarps * kC * 4 <= P::XS, "sums over xs");

// Sum v over the 16 pixels (rows) of a warp's wmma tile: afterwards lanes
// 0 and 1 hold the sums of their 8 channels. A fixed butterfly order.
__device__ __forceinline__ void warp_rows_sum(float (&v)[8]) {
#pragma unroll
  for (int off = 16; off >= 2; off >>= 1)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      v[j] = __fadd_rn(v[j], __shfl_xor_sync(0xffffffffu, v[j], off));
}

// Lanes 0 and 1 of a warp put their 8 channels' sums into
// red[(q * kWarps + warp) * kC + c].
__device__ __forceinline__ void put_warp_sums(float* red, int q, int warp,
                                              int lane, int c,
                                              const float (&v)[8]) {
  if (lane < 2)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      red[(q * srt::kWarps + warp) * kC + c + j] = v[j];
}

// After a barrier: part[(tile * nq + q) * kC + c] = the warps' sums in
// order, for q < nq.
__device__ __forceinline__ void put_tile_sums(const float* red, float* part,
                                              int nq) {
  const size_t tile =
      ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
  if (threadIdx.x < nq * kC) {
    const int q = threadIdx.x / kC, c = threadIdx.x % kC;
    float s = 0.0f;
    for (int w = 0; w < srt::kWarps; ++w)
      s = __fadd_rn(s, red[(q * srt::kWarps + w) * kC + c]);
    part[(tile * nq + q) * kC + c] = s;
  }
}

// The position of element i of the staged tile: pixel p, its vector v,
// the image pixel (gy, gx) it stands for and the pixel (sy, sx) it reads
// (the same, or with reflect the mirrored one on the ring around the
// image); inside: in the tile window with a pixel to read; interior: one
// of the block's own output pixels.
struct Staged {
  int p, v, gy, gx, sy, sx;
  bool inside, interior;
  __device__ __forceinline__ Staged(int i, int H, int W, int y0, int x0,
                                    bool reflect) {
    p = i / kVec;
    v = i % kVec;
    const int ly = p / P::WX, lx = p % P::WX;
    gy = y0 - 1 + ly;
    gx = x0 - 1 + lx;
    sy = reflect ? srt::mirror1(gy, H) : gy;
    sx = reflect ? srt::mirror1(gx, W) : gx;
    inside = ly < kTH + 2 && sy >= 0 && sy < H && sx >= 0 && sx < W;
    interior = ly >= 1 && ly <= kTH && lx >= 1 && lx <= kTW && gy < H &&
               gx < W;
  }
};

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

// F1 / F2. grid (ceil(W / kTW), ceil(H / kTH), B). PRE = false: y =
// bf16(conv(x, w) + bias). PRE = true (F2): x is y1, staged as h1 =
// bf16(prelu(a1 * y1 + c1)) with (a1, c1) rows 3, 4 of st_in and the
// slope *alpha; h1's interior pixels go to h_out. REFLECT: the staged
// tile's ring outside the image mirrors x (F1) or h1 (F2). part gets the
// tile's per-channel sum and sum of squares of the stored y (nq = 2).
template <bool PRE, bool REFLECT>
__global__ void __launch_bounds__(srt::kThreads)
    bn_conv_stats_kernel(const bf16* __restrict__ x,
                         const float* __restrict__ st_in,
                         const float* __restrict__ alpha,
                         const bf16* __restrict__ w,
                         const float* __restrict__ bias, bf16* __restrict__ y,
                         bf16* __restrict__ h_out, float* __restrict__ part,
                         int H, int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ws = reinterpret_cast<bf16*>(smem + P::XS);
  float* red = reinterpret_cast<float*>(smem);  // after the conv's reads
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* scr = reinterpret_cast<float*>(smem + P::XS + P::WS) + warp * 256;
  const int b = blockIdx.z, y0 = blockIdx.y * kTH, x0 = blockIdx.x * kTW;

  if (PRE) {
    const float al = *alpha;
    for (int i = threadIdx.x; i < P::NPIX * kVec; i += blockDim.x) {
      const Staged s(i, H, W, y0, x0, REFLECT);
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (s.inside) {
        const size_t at = (((size_t)b * H + s.sy) * W + s.sx) * kC + s.v * 8;
        float f[8];
        srt::unpack8(*reinterpret_cast<const uint4*>(x + at), f);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = s.v * 8 + j;
          const float z =
              __fadd_rn(__fmul_rn(st_in[3 * kC + c], f[j]), st_in[4 * kC + c]);
          f[j] = z >= 0.0f ? z : __fmul_rn(al, z);
        }
        val = srt::pack8(f);
        if (s.interior) *reinterpret_cast<uint4*>(h_out + at) = val;
      }
      *reinterpret_cast<uint4*>(xs + (size_t)s.p * P::PS + s.v * 8) = val;
    }
  } else {
    srt::load_tile<kC, REFLECT>(xs, x, b, H, W, y0 - 1, x0 - 1, kTH + 2,
                                P::WX, P::NPIX);
  }
  srt::load_weights<kC, kC>(ws, w, kC, 0);
  __syncthreads();

  srt::AccFrag acc[kC / 16];
  srt::mma_3x3<kC, kC>(acc, xs, ws, warp * 16, P::WX);
  __syncthreads();  // every warp is done reading xs: red may overwrite it

  const int p = warp * 16 + (lane >> 1);
  const int oy = p / P::WX, ox = p % P::WX;
  const int gy = y0 + oy, gx = x0 + ox;
  const bool valid = oy < kTH && ox < kTW && gy < H && gx < W;
  const size_t pix = ((size_t)b * H + gy) * W + gx;
#pragma unroll
  for (int n = 0; n < kC / 16; ++n) {
    float v[8], sq[8];
    srt::lane_values(scr, acc[n], lane, v);
    const int c = n * 16 + (lane & 1) * 8;
    if (valid) {
#pragma unroll
      for (int j = 0; j < 8; ++j) v[j] = __fadd_rn(v[j], bias[c + j]);
      const uint4 pk = srt::pack8(v);
      *reinterpret_cast<uint4*>(y + pix * kC + c) = pk;
      srt::unpack8(pk, v);  // the statistics are of the stored values
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (!valid) v[j] = 0.0f;
      sq[j] = __fmul_rn(v[j], v[j]);
    }
    warp_rows_sum(v);
    warp_rows_sum(sq);
    put_warp_sums(red, 0, warp, lane, c, v);
    put_warp_sums(red, 1, warp, lane, c, sq);
  }
  __syncthreads();
  put_tile_sums(red, part, 2);
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
    srt::unpack8(reinterpret_cast<const uint4*>(y)[i], yv);
    srt::unpack8(reinterpret_cast<const uint4*>(u)[i], uv);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      yv[j] = __fadd_rn(
          __fadd_rn(__fmul_rn(st[3 * kC + c + j], yv[j]), st[4 * kC + c + j]),
          uv[j]);
    reinterpret_cast<uint4*>(out)[i] = srt::pack8(yv);
  }
}

// B1. grid ceil(npix / kChunk), 256 threads: thread (pixel lane l =
// t / 8, channels 8 (t % 8) ..) sums pixels l, l + 32, ... of the chunk;
// a warp's four pixel lanes by a butterfly, then the warps in order.
// part[(chunk * 2 + q) * kC + c]: q = 0 sum g, q = 1 sum g * xhat.
__global__ void __launch_bounds__(256)
    bn_sums_kernel(const bf16* __restrict__ g, const bf16* __restrict__ y,
                   const float* __restrict__ st, float* __restrict__ part,
                   long long npix) {
  __shared__ float red[2][8][kC];
  const int v = threadIdx.x % kVec, pl = threadIdx.x / kVec;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float mean[8], inv[8], sg[8] = {}, sgx[8] = {};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    mean[j] = st[v * 8 + j];
    inv[j] = st[2 * kC + v * 8 + j];
  }
  const long long p0 = (long long)blockIdx.x * kChunk;
  const long long p1 = p0 + kChunk < npix ? p0 + kChunk : npix;
  for (long long p = p0 + pl; p < p1; p += 256 / kVec) {
    float gv[8], yv[8];
    srt::unpack8(*reinterpret_cast<const uint4*>(g + p * kC + v * 8), gv);
    srt::unpack8(*reinterpret_cast<const uint4*>(y + p * kC + v * 8), yv);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float xhat = __fmul_rn(__fsub_rn(yv[j], mean[j]), inv[j]);
      sg[j] = __fadd_rn(sg[j], gv[j]);
      sgx[j] = __fadd_rn(sgx[j], __fmul_rn(gv[j], xhat));
    }
  }
#pragma unroll
  for (int off = 8; off <= 16; off <<= 1)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      sg[j] = __fadd_rn(sg[j], __shfl_xor_sync(0xffffffffu, sg[j], off));
      sgx[j] = __fadd_rn(sgx[j], __shfl_xor_sync(0xffffffffu, sgx[j], off));
    }
  if (lane < kVec)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      red[0][warp][lane * 8 + j] = sg[j];
      red[1][warp][lane * 8 + j] = sgx[j];
    }
  __syncthreads();
  if (threadIdx.x < 2 * kC) {
    const int q = threadIdx.x / kC, c = threadIdx.x % kC;
    float s = 0.0f;
    for (int w = 0; w < 8; ++w) s = __fadd_rn(s, red[q][w][c]);
    part[((size_t)blockIdx.x * 2 + q) * kC + c] = s;
  }
}

// REFLECT B2 / B3, launched before them: the f32 transposed-conv values
// that reflect folds onto the rows and columns next to the image's edge.
// With P the zero-padded transposed conv of bf16(dy) with wt over the
// padded grid (rows -1 .. H, columns -1 .. W) and R(i) = {i} + {-1 if
// i == 1} + {H if i == H - 2} (S(j) the same for columns), dx(i, j) is the
// sum of P over R(i) x S(j). Beyond P(i, j), B2's and B3's own conv, that
// is, per image b of ring (B, 2 W + 2 H, kC):
//   entry x          = P(-1, x), added at row 1 (x < W);
//   entry W + x      = P(H, x), added at row H - 2;
//   entry 2 W + y    = the sum over r in R(y) of P(r, -1), added at
//                      column 1 (y < H; the corners folded in);
//   entry 2 W + H + y = the same of P(r, W), added at column W - 2.
// P(-1, .) reads dy's row 0 through tap row 2 only, P(H, .) row H - 1
// through tap row 0, the columns likewise. grid (ceil(max(W, H) /
// kRingSeg), 4, B): side y = top, bottom, left, right; block x takes
// entries x * kRingSeg .. + kRingSeg - 1 of its side, staging bf16(dy) of
// the edge pixels they read (recomputed from g and y as B2 / B3 stage
// it), and each thread sums one entry and output channel in f32.
// Four entries of 64 channels: one output per thread, and 512 blocks at
// the training shape (a block's serial 64-term sums are its latency).
constexpr int kRingSeg = 4;

__global__ void __launch_bounds__(256)
    bn_fold_ring_kernel(const bf16* __restrict__ g, const bf16* __restrict__ y,
                        const float* __restrict__ st,
                        const float* __restrict__ gamma,
                        const float* __restrict__ sums, float m,
                        const bf16* __restrict__ wt, float* __restrict__ ring,
                        int H, int W) {
  __shared__ float cf[5][kC];
  __shared__ float line[kRingSeg + 2][kC];  // dy at positions e0 - 1 ..
  const int side = blockIdx.y, b = blockIdx.z;
  const bool row = side < 2;  // a ring row (top, bottom) or column
  const int len = row ? W : H, e0 = blockIdx.x * kRingSeg;
  if (e0 >= len) return;  // the whole block
  bn_bwd_coefs(cf, st, gamma, sums, m);
  __syncthreads();
  // the edge line of dy: row 0 / H - 1 or column 0 / W - 1
  const int edge = side == 1 ? H - 1 : side == 3 ? W - 1 : 0;
  for (int i = threadIdx.x; i < (kRingSeg + 2) * kVec; i += blockDim.x) {
    const int l = i / kVec, v = i % kVec, j = e0 - 1 + l;
    float d[8] = {};
    if (j >= 0 && j < len) {
      const size_t at =
          (((size_t)b * H + (row ? edge : j)) * W + (row ? j : edge)) * kC +
          v * 8;
      float yv[8];
      srt::unpack8(*reinterpret_cast<const uint4*>(g + at), d);
      srt::unpack8(*reinterpret_cast<const uint4*>(y + at), yv);
      bn_dy8(cf, v * 8, d, yv);
      srt::unpack8(srt::pack8(d), d);  // bf16(dy), as B2 / B3 stage it
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) line[l][v * 8 + k] = d[k];
  }
  __syncthreads();
  // the tap row (ring rows) or column (ring columns) that reads the ring
  const int tfix = side == 0 || side == 2 ? 2 : 0;
  // sum over ci of dy at line position j times tap (ty, tx), for co
  auto tap = [&](int j, int ty, int tx, int co) {
    const float* d = line[j - e0 + 1];
    const bf16* w = wt + (size_t)(ty * 3 + tx) * kC * kC + co;
    float s = 0.0f;
    for (int ci = 0; ci < kC; ++ci)
      s = fmaf(d[ci], __bfloat162float(w[(size_t)ci * kC]), s);
    return s;
  };
  for (int t = threadIdx.x; t < kRingSeg * kC; t += blockDim.x) {
    const int e = e0 + t / kC, co = t % kC;
    if (e >= len) break;
    float acc = 0.0f;
    if (row) {  // P(-1 or H, e): dy's columns e - 1 .. e + 1
      for (int tx = 0; tx < 3; ++tx) {
        const int j = e + tx - 1;
        if (j >= 0 && j < W) acc += tap(j, tfix, tx, co);
      }
    } else {  // the sum over r in R(e) of P(r, -1 or W)
      const int rs[3] = {e, e == 1 ? -1 : -3, e == H - 2 ? H : -3};
      for (int k = 0; k < 3; ++k) {
        if (rs[k] == -3) continue;
        for (int ty = 0; ty < 3; ++ty) {
          const int i = rs[k] + ty - 1;
          if (i >= 0 && i < H) acc += tap(i, ty, tfix, co);
        }
      }
    }
    const int base = side == 0 ? 0 : side == 1 ? W : side == 2 ? 2 * W
                                                              : 2 * W + H;
    ring[((size_t)b * (2 * W + 2 * H) + base + e) * kC + co] = acc;
  }
}

// B2 / B3. grid as F1. The prologue stages bf16(dy), dy = coef * (g -
// sums[0] / m - xhat * sums[1] / m) with xhat = (y - mean) * inv and
// coef = gamma * inv (mean, inv rows 0, 2 of st), zero outside the image;
// the interior goes to dy_out and its f32 value into the db sums. Then
// dh = conv(bf16 dy, wt) (wt the transposed weight); REFLECT adds ring's
// fold (bn_fold_ring_kernel) to dh at rows 1, H - 2 and columns 1, W - 2.
//  B2: y1, st1, alpha give z = a1 * y1 + c1; out = dz = bf16(z >= 0 ? dh :
//      alpha * dh); part q = 0 db, 1 dalpha (per channel), 2 sum dz,
//      3 sum dz * xhat1 (dz as stored).
//  B3: out = du = bf16(dh + skip) (skip null: no add); part q = 0 db.
template <bool B2, bool REFLECT>
__global__ void __launch_bounds__(srt::kThreads)
    bn_bwd_conv_kernel(const bf16* __restrict__ g, const bf16* __restrict__ y,
                       const float* __restrict__ st,
                       const float* __restrict__ gamma,
                       const float* __restrict__ sums, float m,
                       const bf16* __restrict__ wt, bf16* __restrict__ dy_out,
                       bf16* __restrict__ out, const bf16* __restrict__ y1,
                       const float* __restrict__ st1,
                       const float* __restrict__ alpha,
                       const bf16* __restrict__ skip,
                       const float* __restrict__ ring,
                       float* __restrict__ part, int H, int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float cf[5][kC];  // mean, inv, coef, t1, t2
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ws = reinterpret_cast<bf16*>(smem + P::XS);
  float* red = reinterpret_cast<float*>(smem);  // after the conv's reads
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* scr = reinterpret_cast<float*>(smem + P::XS + P::WS) + warp * 256;
  const int b = blockIdx.z, y0 = blockIdx.y * kTH, x0 = blockIdx.x * kTW;

  bn_bwd_coefs(cf, st, gamma, sums, m);
  __syncthreads();

  float db[8] = {};
  for (int i = threadIdx.x; i < P::NPIX * kVec; i += blockDim.x) {
    const Staged s(i, H, W, y0, x0, false);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (s.inside) {
      const size_t at = (((size_t)b * H + s.gy) * W + s.gx) * kC + s.v * 8;
      float gv[8], yv[8];
      srt::unpack8(*reinterpret_cast<const uint4*>(g + at), gv);
      srt::unpack8(*reinterpret_cast<const uint4*>(y + at), yv);
      bn_dy8(cf, s.v * 8, gv, yv);
      val = srt::pack8(gv);
      if (s.interior) {
        *reinterpret_cast<uint4*>(dy_out + at) = val;
#pragma unroll
        for (int j = 0; j < 8; ++j) db[j] = __fadd_rn(db[j], gv[j]);
      }
    }
    *reinterpret_cast<uint4*>(xs + (size_t)s.p * P::PS + s.v * 8) = val;
  }
  // the warp's four pixel lanes per channel group (lanes l, l ^ 8, ...)
#pragma unroll
  for (int off = 8; off <= 16; off <<= 1)
#pragma unroll
    for (int j = 0; j < 8; ++j)
      db[j] = __fadd_rn(db[j], __shfl_xor_sync(0xffffffffu, db[j], off));
  srt::load_weights<kC, kC>(ws, wt, kC, 0);
  __syncthreads();

  srt::AccFrag acc[kC / 16];
  srt::mma_3x3<kC, kC>(acc, xs, ws, warp * 16, P::WX);
  __syncthreads();  // every warp is done reading xs: red may overwrite it
  if (lane < kVec)
#pragma unroll
    for (int j = 0; j < 8; ++j) red[warp * kC + lane * 8 + j] = db[j];

  const int p = warp * 16 + (lane >> 1);
  const int oy = p / P::WX, ox = p % P::WX;
  const int gy = y0 + oy, gx = x0 + ox;
  const bool valid = oy < kTH && ox < kTW && gy < H && gx < W;
  const size_t pix = ((size_t)b * H + gy) * W + gx;
  const float al = B2 ? *alpha : 0.0f;
#pragma unroll
  for (int n = 0; n < kC / 16; ++n) {
    float v[8];
    srt::lane_values(scr, acc[n], lane, v);
    const int c = n * 16 + (lane & 1) * 8;
    if (REFLECT && valid) {  // the fold, in f32, before any rounding
      const float* rb = ring + (size_t)b * (2 * W + 2 * H) * kC + c;
      auto fold = [&](int e) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[j] = __fadd_rn(v[j], rb[(size_t)e * kC + j]);
      };
      if (gy == 1) fold(gx);
      if (gy == H - 2) fold(W + gx);
      if (gx == 1) fold(2 * W + gy);
      if (gx == W - 2) fold(2 * W + H + gy);
    }
    if (B2) {
      float dal[8] = {}, sdz[8] = {}, sdzx[8] = {};
      if (valid) {
        float yv[8], dz[8];
        srt::unpack8(*reinterpret_cast<const uint4*>(y1 + pix * kC + c), yv);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float z = __fadd_rn(__fmul_rn(st1[3 * kC + c + j], yv[j]),
                                    st1[4 * kC + c + j]);
          dz[j] = z >= 0.0f ? v[j] : __fmul_rn(al, v[j]);
          dal[j] = z >= 0.0f ? 0.0f : __fmul_rn(v[j], z);
        }
        const uint4 pk = srt::pack8(dz);
        *reinterpret_cast<uint4*>(out + pix * kC + c) = pk;
        srt::unpack8(pk, dz);  // BN1's sums read the stored dz
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float xhat = __fmul_rn(__fsub_rn(yv[j], st1[c + j]),
                                       st1[2 * kC + c + j]);
          sdz[j] = dz[j];
          sdzx[j] = __fmul_rn(dz[j], xhat);
        }
      }
      warp_rows_sum(dal);
      warp_rows_sum(sdz);
      warp_rows_sum(sdzx);
      put_warp_sums(red, 1, warp, lane, c, dal);
      put_warp_sums(red, 2, warp, lane, c, sdz);
      put_warp_sums(red, 3, warp, lane, c, sdzx);
    } else if (valid) {
      if (skip) {
        float sv[8];
        srt::unpack8(*reinterpret_cast<const uint4*>(skip + pix * kC + c), sv);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = __fadd_rn(v[j], sv[j]);
      }
      *reinterpret_cast<uint4*>(out + pix * kC + c) = srt::pack8(v);
    }
  }
  __syncthreads();
  put_tile_sums(red, part, B2 ? 4 : 1);
}

// The partials part (nparts, nq, kC) summed over the parts in a fixed
// order (lane (c, s) takes parts s, s + kSlices, ..., then lane (c, 0)
// adds the slices in order). With gamma (nq = 2: sum, sum of squares over
// m pixels): out = the statistics (5, kC): mean, biased var, inv, a, c
// (srtpu's _finalize). Else out = the sums (nq, kC), and total (when
// given) = the sum of out[tq] over the channels, in order.
__global__ void __launch_bounds__(kSlices * kC)
    bn_reduce_kernel(const float* __restrict__ part, int nparts, int nq,
                     float m, const float* __restrict__ gamma,
                     const float* __restrict__ beta, float* __restrict__ out,
                     float* __restrict__ total, int tq) {
  __shared__ float red[kSlices * kC], tot[4][kC];
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
      for (int q = 0; q < nq; ++q) out[q * kC + c] = tot[q][c];
    }
  }
  if (total && threadIdx.x == 0) {
    float sum = 0.0f;
    for (int k = 0; k < kC; ++k) sum = __fadd_rn(sum, tot[tq][k]);
    *total = sum;
  }
}

cudaError_t reduce(const float* part, int nparts, int nq, float m,
                   const float* gamma, const float* beta, float* out,
                   cudaStream_t s, float* total = nullptr, int tq = 0) {
  bn_reduce_kernel<<<1, kSlices * kC, 0, s>>>(part, nparts, nq, m, gamma,
                                              beta, out, total, tq);
  return cudaGetLastError();
}

dim3 conv_grid(int B, int H, int W) {
  return dim3((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
}

}  // namespace

// F1 (st_in null) or F2 (st_in the (5, 64) statistics of y1, alpha its
// PReLU slope, h_out (B, H, W, 64) bf16 gets h1): x (B, H, W, 64) bf16,
// w (3, 3, 64, 64) bf16, bias, gamma, beta (64) f32 -> y (B, H, W, 64)
// bf16 and st_out (5, 64) f32. reflect != 0: REFLECT boundaries (H, W >=
// 2), else SAME. part: (B * ceil(H / 7) * ceil(W / 16), 2, 64) f32
// scratch. Two launches. Returns a cudaError_t.
extern "C" int srt_bn_conv_stats(const void* x, const void* st_in,
                                 const void* alpha, const void* w,
                                 const void* bias, const void* gamma,
                                 const void* beta, void* y, void* h_out,
                                 void* part, void* st_out, int B, int H,
                                 int W, int reflect, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool pre = st_in != nullptr;
  if (reflect && (H < 2 || W < 2)) return (int)cudaErrorInvalidValue;
  auto kernel = pre ? (reflect ? bn_conv_stats_kernel<true, true>
                               : bn_conv_stats_kernel<true, false>)
                    : (reflect ? bn_conv_stats_kernel<false, true>
                               : bn_conv_stats_kernel<false, false>);
  cudaError_t err = srt::allow_smem(kernel, P::SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = conv_grid(B, H, W);
  kernel<<<grid, srt::kThreads, P::SMEM, s>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(st_in),
      static_cast<const float*>(alpha), static_cast<const bf16*>(w),
      static_cast<const float*>(bias), static_cast<bf16*>(y),
      static_cast<bf16*>(h_out), static_cast<float*>(part), H, W);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)reduce(static_cast<const float*>(part),
                     (int)(grid.x * grid.y * grid.z), 2,
                     (float)B * (float)H * (float)W,
                     static_cast<const float*>(gamma),
                     static_cast<const float*>(beta),
                     static_cast<float*>(st_out), s);
}

// F3: out = bf16(a * y + c + u), (a, c) rows 3, 4 of st; y, u, out
// (npix, 64) bf16. One launch. Returns a cudaError_t.
extern "C" int srt_bn_norm_skip(const void* y, const void* st, const void* u,
                                void* out, long long npix, void* stream) {
  const long long nvec = npix * kVec;
  const long long want = (nvec + 255) / 256;
  bn_norm_skip_kernel<<<(int)(want < (1 << 20) ? want : (1 << 20)), 256, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(y), static_cast<const float*>(st),
      static_cast<const bf16*>(u), static_cast<bf16*>(out), nvec);
  return (int)cudaGetLastError();
}

// B1: sums (2, 64) f32 = sum g, sum g * xhat over npix pixels, xhat from
// y and rows 0, 2 (mean, inv) of st; g, y (npix, 64) bf16. part:
// (ceil(npix / 256), 2, 64) f32 scratch. Two launches. Returns a
// cudaError_t.
extern "C" int srt_bn_sums(const void* g, const void* y, const void* st,
                           void* part, void* sums, long long npix,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nchunks = (int)((npix + kChunk - 1) / kChunk);
  bn_sums_kernel<<<nchunks, 256, 0, s>>>(
      static_cast<const bf16*>(g), static_cast<const bf16*>(y),
      static_cast<const float*>(st), static_cast<float*>(part), npix);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)reduce(static_cast<const float*>(part), nchunks, 2, 1.0f,
                     nullptr, nullptr, static_cast<float*>(sums), s);
}

// B2 (y1, st1, alpha given: out = dz, red (4, 64) = db, dalpha per
// channel, sum dz, sum dz * xhat1; dal (1) = dalpha) or B3 (y1 null: out
// = du with skip added unless skip is null, red (1, 64) = db). g, y, out,
// dy_out (B, H, W, 64) bf16; st, st1 (5, 64), gamma (64), sums (2, 64)
// f32; wt (3, 3, 64, 64) bf16, the transposed weight. reflect != 0:
// REFLECT boundaries (H, W >= 2; ring (B, 2 W + 2 H, 64) f32 scratch for
// the fold, one launch more), else SAME (ring unused). part: (B *
// ceil(H / 7) * ceil(W / 16), 4 or 1, 64) f32 scratch. Two launches (three
// with reflect). Returns a cudaError_t.
extern "C" int srt_bn_bwd_conv(const void* g, const void* y, const void* st,
                               const void* gamma, const void* sums,
                               const void* wt, void* dy_out, void* out,
                               const void* y1, const void* st1,
                               const void* alpha, const void* skip,
                               void* part, void* red, void* dal, void* ring,
                               int B, int H, int W, int reflect,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool b2 = y1 != nullptr;
  if (reflect && (H < 2 || W < 2)) return (int)cudaErrorInvalidValue;
  auto kernel = b2 ? (reflect ? bn_bwd_conv_kernel<true, true>
                              : bn_bwd_conv_kernel<true, false>)
                   : (reflect ? bn_bwd_conv_kernel<false, true>
                              : bn_bwd_conv_kernel<false, false>);
  cudaError_t err = srt::allow_smem(kernel, P::SMEM);
  if (err != cudaSuccess) return (int)err;
  const float m = (float)B * (float)H * (float)W;
  if (reflect) {
    const int longest = H > W ? H : W;
    bn_fold_ring_kernel<<<dim3((longest + kRingSeg - 1) / kRingSeg, 4, B),
                          256, 0, s>>>(
        static_cast<const bf16*>(g), static_cast<const bf16*>(y),
        static_cast<const float*>(st), static_cast<const float*>(gamma),
        static_cast<const float*>(sums), m, static_cast<const bf16*>(wt),
        static_cast<float*>(ring), H, W);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  const dim3 grid = conv_grid(B, H, W);
  kernel<<<grid, srt::kThreads, P::SMEM, s>>>(
      static_cast<const bf16*>(g), static_cast<const bf16*>(y),
      static_cast<const float*>(st), static_cast<const float*>(gamma),
      static_cast<const float*>(sums), m, static_cast<const bf16*>(wt),
      static_cast<bf16*>(dy_out), static_cast<bf16*>(out),
      static_cast<const bf16*>(y1), static_cast<const float*>(st1),
      static_cast<const float*>(alpha), static_cast<const bf16*>(skip),
      static_cast<const float*>(ring), static_cast<float*>(part), H, W);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)reduce(static_cast<const float*>(part),
                     (int)(grid.x * grid.y * grid.z), b2 ? 4 : 1, 1.0f,
                     nullptr, nullptr, static_cast<float*>(red), s,
                     b2 ? static_cast<float*>(dal) : nullptr, 1);
}
