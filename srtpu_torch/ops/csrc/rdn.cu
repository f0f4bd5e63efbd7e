// K6: RDN's residual dense block trunk at G = G0 = 64, NHWC bf16
// activations, f32 sums. A block's concat buffer buf (B, H, W, c_tot),
// c_tot = 64 (C + 1), holds the block input in chunk 0 and dense layer
// i's output h_i = bf16(relu(conv3x3(chunks 0..i) + b_i)) in chunk i + 1;
// the block output is bf16(x + wf^T buf + bf) (a 1x1 local fusion).
//
// Replaces srtpu/ops/cs_conv.py:rdn_all_fwd (body _rdn_all_fwd_kernel),
// rdb_bwd_chain_all (_rdb_bwd_chain_kernel_sp) and rdb_bwd_dw_all
// (_rdb_bwd_dw_kernel_sp), behind rdn_trunk_cat_cs.
//
// What the TPU kernels do that Hopper cannot. They keep a whole block's
// (c_tot, S) concat buffer in VMEM, run their grid in order and carry
// the running block output and the dW / db accumulators from step to
// step. A Hopper block has 227 KB of shared memory and runs in no order
// beside the others, and a dense layer reads its inputs at 3x3 halos
// that other blocks compute. So the buffer lives in device memory, each
// layer is one launch over the image (its halos then complete), and
// every cross-block sum is a per-block partial added in a fixed order by
// a second kernel (no float atomics: the same bits on every call).
//
//  Forward (srt_rdn_fwd), per block: C launches of rdn_dense_kernel and
//  one of rdn_lff_kernel.
//   rdn_dense_kernel: layer i for one 7 x 16 pixel tile. It stages one
//     64-channel chunk of the buffer (pixel stride c_tot, tile_conv.cuh's
//     load_tile) and that chunk's 3x3 weights (73.7 KB: all i + 1 chunks'
//     would not fit beside the tile) at a time, and adds each chunk into
//     one set of f32 wmma accumulators; the epilogue adds the bias,
//     applies ReLU and stores bf16 h_i into chunk i + 1.
//   rdn_lff_kernel: the 576 -> 64 fusion for 64 pixels, a GEMM staged
//     64 channels at a time; its epilogue adds bf and the block input
//     (chunk 0), rounds once and writes the block's slice of cat and the
//     next block's chunk 0. Training saves every block's buffer (D of
//     them); predict reuses one, the fusion writing the next input over
//     chunk 0 in place (each element read and written by one thread).
//  Backward, per block (srt_rdb_bwd_chain):
//   rdn_lff_bwd_kernel: gf = f32(g_run) + f32(ct's block slice), gc =
//     bf16(gf) (stored: the weight grad's operand), dbuf = gc wf^T in f32
//     over all c_tot channels, per-block partials of dbf = sum gf;
//   rdn_dw_kernel<1>: dwf = buf^T gc as 9 jobs of 64 x 64, partials;
//   rdn_chain_kernel, one launch per layer from C - 1 down to 0: layer
//     i's dout = (h_i > 0 ? dbuf chunk i + 1 : 0) on the stored bf16 h,
//     computed at the tile and its halo (that chunk is complete once the
//     layers above have run), staged as bf16 doutb (stored for the weight
//     grads), per-block f32 partials of db_i; then for each chunk j <= i
//     the transposed 3x3 conv of doutb with the pair's flipped kernel,
//     added into dbuf chunk j at the block's own pixels (no atomics). The
//     last step (i = 0) writes dx = bf16(dbuf_0 + gf) instead.
//   rdn_reduce: the partials in a fixed order (dwf, dbf, db).
//  Weight grads (srt_rdb_bwd_dw): rdn_dw_kernel<3> over the block's
//   C (C + 1) / 2 (layer, chunk) pairs, each a 3x3 weight grad of chunk j
//   against doutb_i (the wmma plan wgrad.cu had before its wgmma engine,
//   with the buffer's channel stride), per-block partials, then
//   rdn_reduce; K6's own, to be redesigned with K6.
//
// What bounds it on the H100. A dense layer's 3x3 conv costs 2 * 9 * 64
// * 64 = 73.7 kFLOP per pixel and input chunk; a block (C = 8) does 36
// such pairs plus the 1x1 fusion (2 * 576 * 64 = 73.7 kFLOP per pixel):
// 2.73 MFLOP per pixel, 44.7 GFLOP per block at the training shape (16 x
// 32 x 32), >= 45 us at 989 TFLOP/s, against ~25 MB the block must move
// (x, the 576-channel buffer, out and its cat slice): >= 7.5 us at 3.35
// TB/s. Operations bound it, and the backward does twice the work. The
// design feeds the tensor cores with wmma bf16 tiles from shared memory,
// but re-reads each pair's weights per pixel tile and stages without
// overlap (no cp.async, TMA or wgmma yet), so expect a few % of peak, as
// K1's conv pair. The chain's f32 dbuf (576 channels) round trip costs
// bytes the TPU kernel keeps in VMEM.

#include "tile_conv.cuh"

namespace {

using srt::bf16;
using namespace nvcuda;

constexpr int kG = 64;                 // growth: one 64-channel chunk
constexpr int kTH = 7, kTW = 16;       // dense / chain tile (K2's)
typedef srt::ConvPlan<kG, kG, kTH, kTW> CP;
static_assert(CP::MF == srt::kWarps && CP::MT == 1, "one tile per warp");
constexpr int kPairW = 9 * kG * kG;    // elements of one pair's weights
constexpr int kFP = 64;                // pixels per fusion block
constexpr int kFS = kG + 16;           // fusion smem pixel stride
constexpr size_t kFuseSmem = srt::align128((size_t)kFP * kFS * 2) +
                             srt::align128((size_t)kG * kG * 2) +
                             (size_t)srt::kWarps * 256 * 4;
constexpr size_t kChainSmem = CP::SMEM + 4 * kG * 4;  // + db: 4 x 64 f32

// layer i's pair (i, 0) in a block's pair list
__host__ __device__ constexpr int pair0(int i) { return i * (i + 1) / 2; }

// Copy x (P pixels x 64) into chunk 0 of buf (pixel stride ctot).
__global__ void rdn_copy_in_kernel(const bf16* __restrict__ x,
                                   bf16* __restrict__ buf, long long nvec,
                                   int ctot) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < nvec; i += (long long)gridDim.x * blockDim.x) {
    const long long p = i / (kG / 8), v = i % (kG / 8);
    *reinterpret_cast<uint4*>(buf + p * ctot + v * 8) =
        *reinterpret_cast<const uint4*>(x + p * kG + v * 8);
  }
}

// Dense layer `layer` of one block for the 7 x 16 tile (blockIdx.x,
// blockIdx.y) of image blockIdx.z: h = bf16(relu(sum_j conv(chunk j,
// W_{layer, j}) + bias)) into chunk layer + 1. w holds the layer's
// layer + 1 pairs (3, 3, 64, 64) HWIO, consecutive.
__global__ void __launch_bounds__(srt::kThreads)
    rdn_dense_kernel(bf16* buf, const bf16* __restrict__ w,
                     const float* __restrict__ bias, int layer, int ctot,
                     int H, int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ws = reinterpret_cast<bf16*>(smem + CP::XS);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* scr = reinterpret_cast<float*>(smem + CP::XS + CP::WS) + warp * 256;
  const int b = blockIdx.z, y0 = blockIdx.y * kTH, x0 = blockIdx.x * kTW;

  srt::AccFrag acc[kG / 16];
#pragma unroll
  for (int n = 0; n < kG / 16; ++n) wmma::fill_fragment(acc[n], 0.0f);
  for (int j = 0; j <= layer; ++j) {
    if (j) __syncthreads();  // every warp is done with the last chunk
    srt::load_tile<kG>(xs, buf + j * kG, b, H, W, y0 - 1, x0 - 1, kTH + 2,
                       CP::WX, CP::NPIX, 1.0f, ctot);
    srt::load_weights<kG, kG>(ws, w + (size_t)j * kPairW, kG, 0);
    __syncthreads();
    srt::mma_taps<kG, kG, 3, 3>(acc, xs, ws, warp * 16, CP::WX, 0);
  }

  const int p = warp * 16 + (lane >> 1);
  const int oy = p / CP::WX, ox = p % CP::WX;
  const int gy = y0 + oy, gx = x0 + ox;
  const bool valid = oy < kTH && ox < kTW && gy < H && gx < W;
  bf16* dst = buf + (((size_t)b * H + gy) * W + gx) * ctot + (layer + 1) * kG;
#pragma unroll
  for (int n = 0; n < kG / 16; ++n) {
    float v[8];
    srt::lane_values(scr, acc[n], lane, v);
    if (!valid) continue;
    const int c0 = n * 16 + (lane & 1) * 8;
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = fmaxf(v[k] + bias[c0 + k], 0.0f);
    *reinterpret_cast<uint4*>(dst + c0) = srt::pack8(v);
  }
}

// Stage rows [k0, k0 + 64) of a (K, 64) row-major bf16 matrix m as
// (64, 64) row-major in dst.
__device__ __forceinline__ void load_rows64(bf16* __restrict__ dst,
                                            const bf16* __restrict__ m,
                                            int k0) {
  for (int i = threadIdx.x; i < kG * (kG / 8); i += blockDim.x) {
    const int r = i / (kG / 8), v = i % (kG / 8);
    *reinterpret_cast<uint4*>(dst + r * kG + v * 8) =
        *reinterpret_cast<const uint4*>(m + (size_t)(k0 + r) * kG + v * 8);
  }
}

// The 1x1 local fusion of one block for pixels [64 blockIdx.x, + 64) of
// the P pixels: out = bf16(x + (buf wf + bf)), x = chunk 0 of buf; out to
// cat (pixel stride cat_ps, the block's slice) and, unless null, to xnext
// (the next block's chunk 0, pixel stride ctot; may be chunk 0 of buf).
// wf (ctot, 64) bf16. Warp w: rows 16 (w / 2), columns 32 (w % 2).
__global__ void __launch_bounds__(srt::kThreads)
    rdn_lff_kernel(const bf16* buf, const bf16* __restrict__ wf,
                   const float* __restrict__ bf, bf16* __restrict__ cat,
                   int cat_ps, bf16* xnext, long long P, int ctot) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* as = reinterpret_cast<bf16*>(smem);
  bf16* wsm = reinterpret_cast<bf16*>(
      smem + srt::align128((size_t)kFP * kFS * 2));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* scr = reinterpret_cast<float*>(
                   smem + srt::align128((size_t)kFP * kFS * 2) +
                   srt::align128((size_t)kG * kG * 2)) + warp * 256;
  const long long p0 = (long long)blockIdx.x * kFP;
  const int mt = warp >> 1, nt0 = (warp & 1) * 2;

  srt::AccFrag acc[2];
  wmma::fill_fragment(acc[0], 0.0f);
  wmma::fill_fragment(acc[1], 0.0f);
  for (int k0 = 0; k0 < ctot; k0 += kG) {
    if (k0) __syncthreads();
    for (int i = threadIdx.x; i < kFP * (kG / 8); i += blockDim.x) {
      const int p = i / (kG / 8), v = i % (kG / 8);
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (p0 + p < P)
        val = *reinterpret_cast<const uint4*>(buf + (p0 + p) * ctot + k0 +
                                              v * 8);
      *reinterpret_cast<uint4*>(as + p * kFS + v * 8) = val;
    }
    load_rows64(wsm, wf, k0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kG; kk += 16) {
      srt::AFrag a;
      wmma::load_matrix_sync(a, as + mt * 16 * kFS + kk, kFS);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        srt::BFrag bw;
        wmma::load_matrix_sync(bw, wsm + kk * kG + (nt0 + t) * 16, kG);
        wmma::mma_sync(acc[t], a, bw, acc[t]);
      }
    }
  }

  const long long gp = p0 + mt * 16 + (lane >> 1);
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    float v[8], xv[8];
    srt::lane_values(scr, acc[t], lane, v);
    if (gp >= P) continue;
    const int c0 = (nt0 + t) * 16 + (lane & 1) * 8;
    srt::unpack8(*reinterpret_cast<const uint4*>(buf + gp * ctot + c0), xv);
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = xv[k] + (v[k] + bf[c0 + k]);
    const uint4 out = srt::pack8(v);
    *reinterpret_cast<uint4*>(cat + gp * cat_ps + c0) = out;
    if (xnext) *reinterpret_cast<uint4*>(xnext + gp * ctot + c0) = out;
  }
}

// The fusion's backward for pixels [64 blockIdx.x, + 64): gf =
// f32(g_run) + f32(ct) (ct: the block's slice, pixel stride ct_ps), gc =
// bf16(gf) to gc_out (P, 64); dbuf (P, ctot) f32 = gc wft (wft (64,
// ctot)); dbf_part[blockIdx.x] = the block's sum of gf, pixels in order.
__global__ void __launch_bounds__(srt::kThreads)
    rdn_lff_bwd_kernel(const bf16* __restrict__ g_run,
                       const bf16* __restrict__ ct, int ct_ps,
                       const bf16* __restrict__ wft,
                       bf16* __restrict__ gc_out, float* __restrict__ dbuf,
                       float* __restrict__ dbf_part, long long P, int ctot) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* gs = reinterpret_cast<bf16*>(smem);
  bf16* wsm = reinterpret_cast<bf16*>(
      smem + srt::align128((size_t)kFP * kFS * 2));
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* scr = reinterpret_cast<float*>(
                   smem + srt::align128((size_t)kFP * kFS * 2) +
                   srt::align128((size_t)kG * kG * 2)) + warp * 256;
  const long long p0 = (long long)blockIdx.x * kFP;
  const int mt = warp >> 1, nt0 = (warp & 1) * 2;

  for (int i = threadIdx.x; i < kFP * (kG / 8); i += blockDim.x) {
    const int p = i / (kG / 8), v = i % (kG / 8);
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (p0 + p < P) {
      float a[8], c[8];
      srt::unpack8(*reinterpret_cast<const uint4*>(g_run + (p0 + p) * kG +
                                                    v * 8), a);
      srt::unpack8(*reinterpret_cast<const uint4*>(ct + (p0 + p) * ct_ps +
                                                    v * 8), c);
#pragma unroll
      for (int k = 0; k < 8; ++k) a[k] += c[k];
      val = srt::pack8(a);
      *reinterpret_cast<uint4*>(gc_out + (p0 + p) * kG + v * 8) = val;
    }
    *reinterpret_cast<uint4*>(gs + p * kFS + v * 8) = val;
  }
  if (threadIdx.x < kG) {
    const int c = threadIdx.x;
    float s = 0.0f;
    for (int p = 0; p < kFP && p0 + p < P; ++p)
      s += __bfloat162float(g_run[(p0 + p) * kG + c]) +
           __bfloat162float(ct[(p0 + p) * ct_ps + c]);
    dbf_part[(size_t)blockIdx.x * kG + c] = s;
  }

  const long long gp = p0 + mt * 16 + (lane >> 1);
  for (int n0 = 0; n0 < ctot; n0 += kG) {
    __syncthreads();  // gs staged; the last chunk's wsm reads are done
    for (int i = threadIdx.x; i < kG * (kG / 8); i += blockDim.x) {
      const int r = i / (kG / 8), v = i % (kG / 8);
      *reinterpret_cast<uint4*>(wsm + r * kG + v * 8) =
          *reinterpret_cast<const uint4*>(wft + (size_t)r * ctot + n0 +
                                          v * 8);
    }
    __syncthreads();
    srt::AccFrag acc[2];
    wmma::fill_fragment(acc[0], 0.0f);
    wmma::fill_fragment(acc[1], 0.0f);
#pragma unroll
    for (int kk = 0; kk < kG; kk += 16) {
      srt::AFrag a;
      wmma::load_matrix_sync(a, gs + mt * 16 * kFS + kk, kFS);
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        srt::BFrag bw;
        wmma::load_matrix_sync(bw, wsm + kk * kG + (nt0 + t) * 16, kG);
        wmma::mma_sync(acc[t], a, bw, acc[t]);
      }
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      float v[8];
      srt::lane_values(scr, acc[t], lane, v);
      if (gp >= P) continue;
      float4* d = reinterpret_cast<float4*>(
          dbuf + gp * ctot + n0 + (nt0 + t) * 16 + (lane & 1) * 8);
      d[0] = make_float4(v[0], v[1], v[2], v[3]);
      d[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
  }
}

// One step of the backward chain: layer `layer` of the block for the
// 7 x 16 tile (blockIdx.x, blockIdx.y) of image blockIdx.z. dout = (h > 0
// ? dbuf chunk layer + 1 : 0), h that layer's stored output (chunk
// layer + 1 of buf), staged as bf16 at the tile and its halo (zero
// outside the image) and stored at the tile into dout_out (pixel stride
// dout_ps, channel 64 layer); db_part[tile] = the tile's f32 sum of dout,
// pixels in order. Then for each chunk j <= layer, dbuf chunk j += the
// transposed conv of doutb with wt's pair j ((3, 3, 64, 64), consecutive
// pairs); at layer 0 dx = bf16(dbuf_0 + gf) with gf = f32(g_run) +
// f32(ct) (ct: the block's slice, pixel stride ct_ps) instead.
__global__ void __launch_bounds__(srt::kThreads)
    rdn_chain_kernel(const bf16* __restrict__ buf, float* dbuf,
                     const bf16* __restrict__ wt, bf16* __restrict__ dout_out,
                     int dout_ps, float* __restrict__ db_part, int layer,
                     int ctot, int H, int W, const bf16* __restrict__ g_run,
                     const bf16* __restrict__ ct, int ct_ps,
                     bf16* __restrict__ dx) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* ws = reinterpret_cast<bf16*>(smem + CP::XS);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* scr = reinterpret_cast<float*>(smem + CP::XS + CP::WS) + warp * 256;
  float* red = reinterpret_cast<float*>(smem + CP::SMEM);
  const int b = blockIdx.z, y0 = blockIdx.y * kTH, x0 = blockIdx.x * kTW;
  const int lo = (layer + 1) * kG;

  for (int i = threadIdx.x; i < CP::NPIX * (kG / 8); i += blockDim.x) {
    const int p = i / (kG / 8), v = i % (kG / 8);
    const int ly = p / CP::WX, lx = p % CP::WX;
    const int gy = y0 - 1 + ly, gx = x0 - 1 + lx;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (ly < kTH + 2 && gy >= 0 && gy < H && gx >= 0 && gx < W) {
      const size_t pix = ((size_t)b * H + gy) * W + gx;
      float h[8], d[8];
      srt::unpack8(*reinterpret_cast<const uint4*>(buf + pix * ctot + lo +
                                                    v * 8), h);
      const float4* dp =
          reinterpret_cast<const float4*>(dbuf + pix * ctot + lo + v * 8);
      const float4 d0 = dp[0], d1 = dp[1];
      d[0] = d0.x; d[1] = d0.y; d[2] = d0.z; d[3] = d0.w;
      d[4] = d1.x; d[5] = d1.y; d[6] = d1.z; d[7] = d1.w;
#pragma unroll
      for (int k = 0; k < 8; ++k) d[k] = h[k] > 0.0f ? d[k] : 0.0f;
      val = srt::pack8(d);
      if (ly >= 1 && ly <= kTH && lx >= 1 && lx <= kTW)
        *reinterpret_cast<uint4*>(dout_out + pix * dout_ps + layer * kG +
                                  v * 8) = val;
    }
    *reinterpret_cast<uint4*>(xs + (size_t)p * CP::PS + v * 8) = val;
  }
  {  // db: 4 groups of 64 threads over the tile's pixels, then in order
    const int grp = threadIdx.x / kG, c = threadIdx.x % kG;
    float s = 0.0f;
    for (int q = grp; q < kTH * kTW; q += srt::kThreads / kG) {
      const int gy = y0 + q / kTW, gx = x0 + q % kTW;
      if (gy >= H || gx >= W) continue;
      const size_t e = (((size_t)b * H + gy) * W + gx) * ctot + lo + c;
      s += __bfloat162float(buf[e]) > 0.0f ? dbuf[e] : 0.0f;
    }
    red[grp * kG + c] = s;
    __syncthreads();
    if (threadIdx.x < kG) {
      const size_t tile =
          ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
          blockIdx.x;
      db_part[tile * kG + c] =
          ((red[c] + red[kG + c]) + red[2 * kG + c]) + red[3 * kG + c];
    }
  }

  const int p = warp * 16 + (lane >> 1);
  const int oy = p / CP::WX, ox = p % CP::WX;
  const int gy = y0 + oy, gx = x0 + ox;
  const bool valid = oy < kTH && ox < kTW && gy < H && gx < W;
  const size_t pix = ((size_t)b * H + gy) * W + gx;
  for (int j = 0; j <= layer; ++j) {
    __syncthreads();  // xs staged; the last pair's weights are done with
    srt::load_weights<kG, kG>(ws, wt + (size_t)j * kPairW, kG, 0);
    __syncthreads();
    srt::AccFrag acc[kG / 16];
    srt::mma_3x3<kG, kG>(acc, xs, ws, warp * 16, CP::WX);
#pragma unroll
    for (int n = 0; n < kG / 16; ++n) {
      float v[8];
      srt::lane_values(scr, acc[n], lane, v);
      if (!valid) continue;
      const int c0 = n * 16 + (lane & 1) * 8;
      float4* d = reinterpret_cast<float4*>(dbuf + pix * ctot + j * kG + c0);
      const float4 d0 = d[0], d1 = d[1];
      v[0] += d0.x; v[1] += d0.y; v[2] += d0.z; v[3] += d0.w;
      v[4] += d1.x; v[5] += d1.y; v[6] += d1.z; v[7] += d1.w;
      if (layer == 0) {
        float a[8], c[8];
        srt::unpack8(*reinterpret_cast<const uint4*>(g_run + pix * kG + c0),
                     a);
        srt::unpack8(*reinterpret_cast<const uint4*>(ct + pix * ct_ps + c0),
                     c);
#pragma unroll
        for (int k = 0; k < 8; ++k) v[k] += a[k] + c[k];
        *reinterpret_cast<uint4*>(dx + pix * kG + c0) = srt::pack8(v);
      } else {
        d[0] = make_float4(v[0], v[1], v[2], v[3]);
        d[1] = make_float4(v[4], v[5], v[6], v[7]);
      }
    }
  }
}

// Weight grads over pixel tiles of 8 x 16 (wgrad.cu's former wmma plan,
// kept here for K6 alone): a KK x KK
// (3, or 1 for the fusion) weight grad of a 64-channel chunk X of buf
// against a 64-channel chunk G, as WARPS warps each keeping RT row tiles
// (16 rows of dW: one tap, 16 input channels) of all 4 column tiles.
template <int KK, int WARPS>
struct DwPlan {
  static constexpr int PS = kG + 16;
  static constexpr int WX = 16 + KK - 1;
  static constexpr int MF = (8 * WX + 15) / 16;
  static constexpr int NPIX = MF * 16 + (KK - 1) * (WX + 1);
  static constexpr int ROWS = KK * KK * kG / 16;
  static constexpr int RT = ROWS / WARPS;
  static constexpr size_t XS = srt::align128((size_t)NPIX * PS * 2);
  static constexpr size_t SMEM = XS + srt::align128((size_t)MF * 16 * PS * 2);
  static_assert(ROWS % WARPS == 0, "row tiles per warp");
};

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>
    AColFrag;

// grid (nparts, 1, jobs). pairs != 0: job = layer i's pair with chunk j
// (X = buf chunk j, G = g's chunk i); else job j: X = buf chunk j, G = g's
// chunk 0. g has pixel stride g_ps. Block (part, 0, job) sums tiles
// [part tpp, (part + 1) tpp) and writes its partial (KK KK 64 x 64) to
// slot (job, part) of ws.
template <int KK, int WARPS>
__global__ void __launch_bounds__(WARPS * 32, 1)
    rdn_dw_kernel(const bf16* __restrict__ buf, int ctot,
                  const bf16* __restrict__ g, int g_ps,
                  float* __restrict__ ws, int B, int H, int W, int pairs,
                  int tpp) {
  typedef DwPlan<KK, WARPS> P;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* gsm = reinterpret_cast<bf16*>(smem + P::XS);
  const int warp = threadIdx.x >> 5;
  const int part = blockIdx.x, job = blockIdx.z;
  int i = 0, j = job;
  if (pairs)
    while (j > i) j -= ++i;
  const bf16* x = buf + j * kG;
  const bf16* gg = g + (pairs ? i * kG : 0);
  const int row0 = warp * P::RT;

  const int tiles_x = (W + 15) / 16, tiles_y = (H + 7) / 8;
  const int ntiles = B * tiles_y * tiles_x;
  const int t0 = part * tpp, t1 = min(t0 + tpp, ntiles);

  srt::AccFrag acc[P::RT][kG / 16];
#pragma unroll
  for (int r = 0; r < P::RT; ++r)
#pragma unroll
    for (int c = 0; c < kG / 16; ++c) wmma::fill_fragment(acc[r][c], 0.0f);

  for (int t = t0; t < t1; ++t) {
    const int b = t / (tiles_y * tiles_x), rem = t % (tiles_y * tiles_x);
    const int y0 = rem / tiles_x * 8, x0 = rem % tiles_x * 16;
    __syncthreads();  // the previous tile's reads are done
    srt::load_tile<kG>(xs, x, b, H, W, y0 - KK / 2, x0 - KK / 2, 8 + KK - 1,
                       P::WX, P::NPIX, 1.0f, ctot);
    for (int e = threadIdx.x; e < P::MF * 16 * (kG / 8); e += blockDim.x) {
      const int p = e / (kG / 8), v = e % (kG / 8);
      const int oy = p / P::WX, ox = p % P::WX;
      const int gy = y0 + oy, gx = x0 + ox;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (oy < 8 && ox < 16 && gy < H && gx < W)
        val = *reinterpret_cast<const uint4*>(
            gg + (((size_t)b * H + gy) * W + gx) * g_ps + v * 8);
      *reinterpret_cast<uint4*>(gsm + (size_t)p * P::PS + v * 8) = val;
    }
    __syncthreads();
    for (int mf = 0; mf < P::MF; ++mf) {
      srt::BFrag bg[kG / 16];
#pragma unroll
      for (int c = 0; c < kG / 16; ++c)
        wmma::load_matrix_sync(bg[c], gsm + (size_t)mf * 16 * P::PS + c * 16,
                               P::PS);
#pragma unroll
      for (int r = 0; r < P::RT; ++r) {
        const int row = row0 + r;  // (tap, 16-channel group of ci)
        const int tap = row / (kG / 16), ci0 = row % (kG / 16) * 16;
        AColFrag a;
        wmma::load_matrix_sync(
            a, xs + (size_t)(mf * 16 + tap / KK * P::WX + tap % KK) * P::PS +
                   ci0,
            P::PS);
#pragma unroll
        for (int c = 0; c < kG / 16; ++c)
          wmma::mma_sync(acc[r][c], a, bg[c], acc[r][c]);
      }
    }
  }

  float* wout = ws + ((size_t)job * gridDim.x + part) * KK * KK * kG * kG;
#pragma unroll
  for (int r = 0; r < P::RT; ++r)
#pragma unroll
    for (int c = 0; c < kG / 16; ++c)
      wmma::store_matrix_sync(wout + (size_t)(row0 + r) * 16 * kG + c * 16,
                              acc[r][c], kG, wmma::mem_row_major);
}

// out[j, e] = sum over p of ws[j, p, e], p in order (n values per slot).
__global__ void rdn_reduce(const float* __restrict__ ws,
                           float* __restrict__ out, int nparts, long long n,
                           long long total) {
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const long long j = idx / n, e = idx % n;
    const float* src = ws + j * nparts * n + e;
    float s = 0.0f;
    for (int p = 0; p < nparts; ++p) s += src[p * n];
    out[idx] = s;
  }
}

int grid1d(long long n) {
  const long long want = (n + 255) / 256;
  return (int)(want < 4096 ? want : 4096);
}

cudaError_t reduce(const float* ws, void* out, int nparts, long long n,
                   int jobs, cudaStream_t s) {
  rdn_reduce<<<grid1d(n * jobs), 256, 0, s>>>(ws, static_cast<float*>(out),
                                               nparts, n, n * jobs);
  return cudaGetLastError();
}

template <int KK, int WARPS>
cudaError_t dw(const bf16* buf, int ctot, const bf16* g, int g_ps, float* ws,
               int jobs, int B, int H, int W, int pairs, int nparts,
               cudaStream_t s) {
  typedef DwPlan<KK, WARPS> P;
  auto kernel = rdn_dw_kernel<KK, WARPS>;
  cudaError_t err = srt::allow_smem(kernel, P::SMEM);
  if (err != cudaSuccess) return err;
  const int ntiles = B * ((H + 7) / 8) * ((W + 15) / 16);
  const int tpp = (ntiles + nparts - 1) / nparts;
  kernel<<<dim3(nparts, 1, jobs), WARPS * 32, P::SMEM, s>>>(
      buf, ctot, g, g_ps, ws, B, H, W, pairs, tpp);
  return cudaGetLastError();
}

dim3 conv_grid(int B, int H, int W) {
  return dim3((W + kTW - 1) / kTW, (H + kTH - 1) / kTH, B);
}

#define SRT_TRY(...)                            \
  do {                                          \
    cudaError_t e_ = (__VA_ARGS__);             \
    if (e_ != cudaSuccess) return (int)e_;      \
  } while (0)

}  // namespace

// The forward of D blocks of C dense layers at G = G0 = 64. x (B, H, W,
// 64) bf16; wpk (D, C (C + 1) / 2, 3, 3, 64, 64) bf16 (pack's pairs); b
// (D, C, 64) f32; wf (D, c_tot, 64) bf16; bf (D, 64) f32; bufs (D, B, H,
// W, c_tot) bf16 with save, else (1, B, H, W, c_tot), one buffer for
// every block; cat (B, H, W, 64 D) bf16. Returns a cudaError_t.
extern "C" int srt_rdn_fwd(const void* x, const void* wpk, const void* b,
                           const void* wf, const void* bf, void* bufs,
                           void* cat, int save, int B, int H, int W, int D,
                           int C, void* stream) {
  if (C < 1 || D < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ctot = kG * (C + 1), np = pair0(C);
  const long long P = (long long)B * H * W;
  SRT_TRY(srt::allow_smem(rdn_dense_kernel, CP::SMEM));
  SRT_TRY(srt::allow_smem(rdn_lff_kernel, kFuseSmem));
  bf16* bb = static_cast<bf16*>(bufs);
  const bf16* w = static_cast<const bf16*>(wpk);
  rdn_copy_in_kernel<<<grid1d(P * (kG / 8)), 256, 0, s>>>(
      static_cast<const bf16*>(x), bb, P * (kG / 8), ctot);
  SRT_TRY(cudaGetLastError());
  const dim3 grid = conv_grid(B, H, W);
  for (int l = 0; l < D; ++l) {
    bf16* buf = bb + (save ? (size_t)l * P * ctot : 0);
    for (int i = 0; i < C; ++i) {
      rdn_dense_kernel<<<grid, srt::kThreads, CP::SMEM, s>>>(
          buf, w + ((size_t)l * np + pair0(i)) * kPairW,
          static_cast<const float*>(b) + ((size_t)l * C + i) * kG, i, ctot,
          H, W);
      SRT_TRY(cudaGetLastError());
    }
    bf16* xnext = l + 1 == D ? nullptr : save ? buf + P * ctot : buf;
    rdn_lff_kernel<<<(unsigned)((P + kFP - 1) / kFP), srt::kThreads,
                     kFuseSmem, s>>>(
        buf, static_cast<const bf16*>(wf) + (size_t)l * ctot * kG,
        static_cast<const float*>(bf) + (size_t)l * kG,
        static_cast<bf16*>(cat) + l * kG, D * kG, xnext, P, ctot);
    SRT_TRY(cudaGetLastError());
  }
  return 0;
}

// The backward chain of block l of D: buf (B, H, W, c_tot) the block's
// saved buffer; g_run (B, H, W, 64) and ct (B, H, W, 64 D) bf16; wt (C (C
// + 1) / 2, 3, 3, 64, 64) the block's transposed pairs, wft (64, c_tot)
// its transposed fusion weight, bf16. Scratch: dbuf (B, H, W, c_tot) f32,
// gc (B, H, W, 64) bf16, part f32 of ceil(P / 64) 64 + C ntc 64 + (c_tot
// / 64) nparts 4096 floats (ntc = B ceil(H / 7) ceil(W / 16)). Writes
// dout (B, H, W, 64 C) and dx (B, H, W, 64) bf16, dwf (c_tot, 64), dbf
// (64), db (C, 64) f32. Returns a cudaError_t.
extern "C" int srt_rdb_bwd_chain(const void* buf, const void* g_run,
                                 const void* ct, int l, int D, const void* wt,
                                 const void* wft, void* dbuf, void* gc,
                                 void* part, void* dout, void* dx, void* dwf,
                                 void* dbf, void* db, int B, int H, int W,
                                 int C, int nparts, void* stream) {
  if (C < 1 || l < 0 || l >= D || nparts < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ctot = kG * (C + 1), jobs = C + 1;
  const long long P = (long long)B * H * W;
  const int ntl = (int)((P + kFP - 1) / kFP);
  const dim3 grid = conv_grid(B, H, W);
  const int ntc = (int)(grid.x * grid.y * grid.z);
  float* part_dbf = static_cast<float*>(part);
  float* part_db = part_dbf + (size_t)ntl * kG;
  float* part_dwf = part_db + (size_t)C * ntc * kG;
  const bf16* bufp = static_cast<const bf16*>(buf);
  const bf16* ctl = static_cast<const bf16*>(ct) + l * kG;
  const bf16* gr = static_cast<const bf16*>(g_run);
  float* dbf32 = static_cast<float*>(dbuf);
  SRT_TRY(srt::allow_smem(rdn_lff_bwd_kernel, kFuseSmem));
  SRT_TRY(srt::allow_smem(rdn_chain_kernel, kChainSmem));
  rdn_lff_bwd_kernel<<<ntl, srt::kThreads, kFuseSmem, s>>>(
      gr, ctl, D * kG, static_cast<const bf16*>(wft), static_cast<bf16*>(gc),
      dbf32, part_dbf, P, ctot);
  SRT_TRY(cudaGetLastError());
  SRT_TRY(dw<1, 4>(bufp, ctot, static_cast<const bf16*>(gc), kG, part_dwf,
                   jobs, B, H, W, 0, nparts, s));
  SRT_TRY(reduce(part_dwf, dwf, nparts, (long long)kG * kG, jobs, s));
  for (int i = C - 1; i >= 0; --i) {
    rdn_chain_kernel<<<grid, srt::kThreads, kChainSmem, s>>>(
        bufp, dbf32, static_cast<const bf16*>(wt) + (size_t)pair0(i) * kPairW,
        static_cast<bf16*>(dout), kG * C, part_db + (size_t)i * ntc * kG, i,
        ctot, H, W, gr, ctl, D * kG, static_cast<bf16*>(dx));
    SRT_TRY(cudaGetLastError());
  }
  SRT_TRY(reduce(part_dbf, dbf, ntl, kG, 1, s));
  return (int)reduce(part_db, db, ntc, kG, C, s);
}

// The (layer, chunk) 3x3 weight grads of one block: buf (B, H, W, c_tot)
// its saved buffer, dout (B, H, W, 64 C) bf16 (the chain's). Scratch ws
// (C (C + 1) / 2, nparts, 9 64 64) f32, nparts <= the 8 x 16 tiles.
// Writes dw (C (C + 1) / 2, 3, 3, 64, 64) f32 in pack's pair order.
// Returns a cudaError_t.
extern "C" int srt_rdb_bwd_dw(const void* buf, const void* dout, void* ws,
                              void* dw_out, int B, int H, int W, int C,
                              int nparts, void* stream) {
  if (C < 1 || nparts < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int jobs = pair0(C);
  float* w = static_cast<float*>(ws);
  SRT_TRY(dw<3, 12>(static_cast<const bf16*>(buf), kG * (C + 1),
                    static_cast<const bf16*>(dout), kG * C, w, jobs, B, H, W,
                    1, nparts, s));
  return (int)reduce(w, dw_out, nparts, (long long)kPairW, jobs, s);
}
