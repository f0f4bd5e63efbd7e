// Weight gradient of a k x k SAME conv (k = 3, or 5 for SRResNet's
// phase-dense final conv), shared by the backward passes of K1-K5:
//   dW[ky, kx, ci, co] = sum over pixels p of
//                        X[p + (ky - k/2, kx - k/2), ci] * G[p, co]
//                                                        (f32 sums),
//   db[co]             = sum over pixels p of G[p, co]   (f32 sums),
// with X and G NHWC bf16 and dW HWIO f32.
//
// Replaces the dW/db halves of srtpu/ops/cs_conv.py: _conv_bwd_kernel
// (conv3x3_cs_bwd), _ups_conv_bwd_kernel (upsample_cs_bwd) and
// _trunk_bwd_kernel_mega (trunk_bwd_mega). The TPU kernels keep the f32
// dW accumulators resident while their grid walks the images in order;
// Hopper's blocks run in no order, so each block sums a fixed run of
// pixel tiles into registers, writes its f32 partial to a workspace, and
// a second kernel adds the partials in a fixed order. No float atomics:
// the result is the same bits on every run.
//
// It is a GEMM whose K dimension is the pixels: (9 * Cin) x Cout outputs.
// The tile plan is tile_conv.cuh's: X with a 1-pixel halo is staged as a
// flattened run of pixels of row width TW + 2, so for 16 consecutive
// positions and one tap the 16 x 16 block of X^T is a wmma col_major A
// tile (pixel stride = leading dimension); G is staged on the same
// positions (zero at the halo columns and outside the image) as the
// row_major B tile. Per pixel it reads (Cin + Cout) * 2 bytes for
// 2 * 9 * Cin * Cout FLOP (64 x 64: ~290 FLOP/byte), at the bf16 ridge.
//
// Modes: scale != 1 reads G as bf16(scale * G) (the trunk's gs); r > 1
// reads G through the phase gather of srtpu's _ups_deint_kernel from a
// fine tensor (B, r H, r W, Cout / (r r)), giving the phase-major dW of
// the upscale stage. J stacked jobs (the trunk's L blocks) share one
// launch.
//
// 5x5 (256 -> 16): 25 * 256 / 16 = 400 row tiles of dW per output chunk,
// too many accumulators for one block; the rows are split over NRG = 5
// row groups (one per tap row ky, a grid dimension), each block of 10
// warps keeping 8 row tiles. X is staged with a 2-pixel halo; the order
// of every sum is fixed as for 3x3.
//
// The general path (wgrad_chunk_kernel: any other cin and cout that are
// multiples of 16, r = 1, k = 3 or 5) serves K2's general path: DDBPN's
// (32, 512), (512, 32), (512, 48) at x4 and (32, 128), (128, 32),
// (128, 16) at x2, and the x3 tails' (576, 32) at 3x3 and 5x5. At cin 512
// X's tile would take 192 KB and 3x3 (576, 32) has 288 row tiles of dW,
// so the rows are split by input channel: row group rg is the CK-channel
// chunk rg of X (CK = 64, 32 or 16; 5x5 at most 32), which is all a block
// stages of X; its k * k * CK / 16 row tiles go to WARPS warps, and the
// output channels to NB-wide chunks (32 or 16). Partials and their
// fixed-order reduction as above.

#include "tile_conv.cuh"

namespace {

constexpr int kTH = 8, kTW = 16;

typedef nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16, srt::bf16,
                            nvcuda::wmma::col_major>
    AColFrag;

// KK x KK taps; WARPS warps per block, each keeping RT row tiles (16
// rows of dW: one tap, 16 input channels) of one of NRG row groups.
template <int CIN, int NB, int KK, int WARPS, int NRG>
struct WgradPlan {
  static constexpr int PS = CIN + 16;               // X pixel stride
  static constexpr int PG = NB + 16;                // G pixel stride
  static constexpr int WX = kTW + KK - 1;
  static constexpr int MF = (kTH * WX + 15) / 16;   // 16-position chunks
  static constexpr int NPIX = MF * 16 + (KK - 1) * (WX + 1);
  static constexpr int ROWS = KK * KK * CIN / 16;   // row tiles of dW
  static constexpr int RT = ROWS / NRG / WARPS;     // row tiles per warp
  static constexpr int CT = NB / 16;                 // column tiles
  static constexpr int THREADS = WARPS * 32;
  static constexpr size_t XS = srt::align128((size_t)NPIX * PS * 2);
  static constexpr size_t GS = srt::align128((size_t)MF * 16 * PG * 2);
  static constexpr size_t SMEM = XS + GS;
  static_assert(ROWS % (NRG * WARPS) == 0, "row tiles per warp");
};

// grid = (nparts, NRG * cout / NB, J). Block (part, rg * nchunks + chunk,
// job) sums tiles [part * tpp, (part + 1) * tpp) of job's images into the
// NB output channels of chunk, for the dW rows of row group rg, and
// writes its partial (its rows of the KK * KK * CIN x cout slice; db from
// row group 0) at slot (job, part) of the workspaces.
template <int CIN, int NB, bool GATHER, int KK = 3, int WARPS = 12,
          int NRG = 1>
__global__ void __launch_bounds__(WARPS * 32, 1)
    wgrad_kernel(const srt::bf16* __restrict__ x,
                 const srt::bf16* __restrict__ g, float* __restrict__ ws_w,
                 float* __restrict__ ws_b, int B, int H, int W, int cout,
                 int r, float gscale, long long x_stride, long long g_stride,
                 int tpp) {
  typedef WgradPlan<CIN, NB, KK, WARPS, NRG> P;
  using srt::bf16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* gsm = reinterpret_cast<bf16*>(smem + P::XS);
  const int warp = threadIdx.x >> 5;
  const int nchunks = cout / NB;
  const int part = blockIdx.x, job = blockIdx.z;
  const int chunk = blockIdx.y % nchunks, rg = blockIdx.y / nchunks;
  const int row0 = rg * (P::ROWS / NRG) + warp * P::RT;  // first row tile
  x += job * x_stride;
  g += job * g_stride;

  const int tiles_x = (W + kTW - 1) / kTW, tiles_y = (H + kTH - 1) / kTH;
  const int ntiles = B * tiles_y * tiles_x;
  const int t0 = part * tpp, t1 = min(t0 + tpp, ntiles);

  srt::AccFrag acc[P::RT][P::CT];
#pragma unroll
  for (int i = 0; i < P::RT; ++i)
#pragma unroll
    for (int j = 0; j < P::CT; ++j) nvcuda::wmma::fill_fragment(acc[i][j], 0.0f);
  float bsum = 0.0f;
  const int cg = GATHER ? cout / (r * r) : cout;  // channels of g's pixels

  for (int t = t0; t < t1; ++t) {
    const int b = t / (tiles_y * tiles_x), rem = t % (tiles_y * tiles_x);
    const int y0 = rem / tiles_x * kTH, x0 = rem % tiles_x * kTW;
    __syncthreads();  // the previous tile's reads are done
    srt::load_tile<CIN>(xs, x, b, H, W, y0 - KK / 2, x0 - KK / 2,
                        kTH + KK - 1, P::WX, P::NPIX);
    constexpr int VG = NB / 8;
    for (int i = threadIdx.x; i < P::MF * 16 * VG; i += blockDim.x) {
      const int p = i / VG, v = i % VG;
      const int oy = p / P::WX, ox = p % P::WX;
      const int gy = y0 + oy, gx = x0 + ox;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (oy < kTH && ox < kTW && gy < H && gx < W) {
        const int co = chunk * NB + v * 8;
        const bf16* src;
        if (GATHER) {
          const int ab = co / cg, k = co % cg;
          src = g + (((size_t)b * H * r + (size_t)gy * r + ab / r) * W * r +
                     (size_t)gx * r + ab % r) * cg + k;
        } else {
          src = g + (((size_t)b * H + gy) * W + gx) * cg + co;
        }
        val = *reinterpret_cast<const uint4*>(src);
        if (gscale != 1.0f) val = srt::scale8(val, gscale);
      }
      *reinterpret_cast<uint4*>(gsm + (size_t)p * P::PG + v * 8) = val;
    }
    __syncthreads();

    if (threadIdx.x < NB)
      for (int p = 0; p < P::MF * 16; ++p)
        bsum += __bfloat162float(gsm[(size_t)p * P::PG + threadIdx.x]);

    for (int mf = 0; mf < P::MF; ++mf) {
      srt::BFrag bg[P::CT];
#pragma unroll
      for (int j = 0; j < P::CT; ++j)
        nvcuda::wmma::load_matrix_sync(bg[j], gsm + (size_t)mf * 16 * P::PG +
                                               j * 16,
                                    P::PG);
#pragma unroll
      for (int i = 0; i < P::RT; ++i) {
        const int row = row0 + i;  // (tap, 16-channel group of ci)
        const int tap = row / (CIN / 16), ci0 = row % (CIN / 16) * 16;
        AColFrag a;
        nvcuda::wmma::load_matrix_sync(
            a, xs + (size_t)(mf * 16 + tap / KK * P::WX + tap % KK) * P::PS +
                   ci0,
            P::PS);
#pragma unroll
        for (int j = 0; j < P::CT; ++j)
          nvcuda::wmma::mma_sync(acc[i][j], a, bg[j], acc[i][j]);
      }
    }
  }

  const size_t slot = (size_t)job * gridDim.x + part;
  float* wout = ws_w + slot * KK * KK * CIN * cout;
#pragma unroll
  for (int i = 0; i < P::RT; ++i)
#pragma unroll
    for (int j = 0; j < P::CT; ++j)
      nvcuda::wmma::store_matrix_sync(
          wout + (size_t)(row0 + i) * 16 * cout + chunk * NB + j * 16,
          acc[i][j], cout, nvcuda::wmma::mem_row_major);
  if (rg == 0 && threadIdx.x < NB)
    ws_b[slot * cout + chunk * NB + threadIdx.x] = bsum;
}

// The general path's plan: the block's X chunk of CK channels, its G chunk
// of NB channels, and the chunk's KK * KK * CK / 16 row tiles of dW over
// WARPS warps.
template <int CK, int NB, int KK, int WARPS>
struct WgradChunkPlan {
  static constexpr int PS = CK + 16;
  static constexpr int PG = NB + 16;
  static constexpr int WX = kTW + KK - 1;
  static constexpr int MF = (kTH * WX + 15) / 16;
  static constexpr int NPIX = MF * 16 + (KK - 1) * (WX + 1);
  static constexpr int ROWS = KK * KK * CK / 16;
  static constexpr int RT = ROWS / WARPS;
  static constexpr int CT = NB / 16;
  static constexpr int THREADS = WARPS * 32;
  static constexpr size_t XS = srt::align128((size_t)NPIX * PS * 2);
  static constexpr size_t GS = srt::align128((size_t)MF * 16 * PG * 2);
  static constexpr size_t SMEM = XS + GS;
  static_assert(ROWS % WARPS == 0, "row tiles per warp");
};

// grid = (nparts, (cin / CK) * (cout / NB), J). Block (part, rg * nchunks
// + chunk, job) sums tiles [part * tpp, (part + 1) * tpp) of job's images
// into dW rows (tap, rg * CK .. rg * CK + CK - 1), columns chunk * NB ..
// + NB - 1, and (row group 0) db, as wgrad_kernel's partial at slot (job,
// part).
template <int CK, int NB, int KK, int WARPS>
__global__ void __launch_bounds__(WARPS * 32, 1)
    wgrad_chunk_kernel(const srt::bf16* __restrict__ x,
                       const srt::bf16* __restrict__ g,
                       float* __restrict__ ws_w, float* __restrict__ ws_b,
                       int B, int H, int W, int cin, int cout, float gscale,
                       long long x_stride, long long g_stride, int tpp) {
  typedef WgradChunkPlan<CK, NB, KK, WARPS> P;
  using srt::bf16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* xs = reinterpret_cast<bf16*>(smem);
  bf16* gsm = reinterpret_cast<bf16*>(smem + P::XS);
  const int warp = threadIdx.x >> 5;
  const int nchunks = cout / NB;
  const int part = blockIdx.x, job = blockIdx.z;
  const int chunk = blockIdx.y % nchunks, rg = blockIdx.y / nchunks;
  x += job * x_stride;
  g += job * g_stride;

  const int tiles_x = (W + kTW - 1) / kTW, tiles_y = (H + kTH - 1) / kTH;
  const int ntiles = B * tiles_y * tiles_x;
  const int t0 = part * tpp, t1 = min(t0 + tpp, ntiles);

  srt::AccFrag acc[P::RT][P::CT];
#pragma unroll
  for (int i = 0; i < P::RT; ++i)
#pragma unroll
    for (int j = 0; j < P::CT; ++j)
      nvcuda::wmma::fill_fragment(acc[i][j], 0.0f);
  float bsum = 0.0f;

  for (int t = t0; t < t1; ++t) {
    const int b = t / (tiles_y * tiles_x), rem = t % (tiles_y * tiles_x);
    const int y0 = rem / tiles_x * kTH, x0 = rem % tiles_x * kTW;
    __syncthreads();  // the previous tile's reads are done
    srt::load_tile<CK>(xs, x + rg * CK, b, H, W, y0 - KK / 2, x0 - KK / 2,
                       kTH + KK - 1, P::WX, P::NPIX, 1.0f, cin);
    constexpr int VG = NB / 8;
    for (int i = threadIdx.x; i < P::MF * 16 * VG; i += blockDim.x) {
      const int p = i / VG, v = i % VG;
      const int oy = p / P::WX, ox = p % P::WX;
      const int gy = y0 + oy, gx = x0 + ox;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (oy < kTH && ox < kTW && gy < H && gx < W) {
        val = *reinterpret_cast<const uint4*>(
            g + (((size_t)b * H + gy) * W + gx) * cout + chunk * NB + v * 8);
        if (gscale != 1.0f) val = srt::scale8(val, gscale);
      }
      *reinterpret_cast<uint4*>(gsm + (size_t)p * P::PG + v * 8) = val;
    }
    __syncthreads();

    if (rg == 0 && threadIdx.x < NB)
      for (int p = 0; p < P::MF * 16; ++p)
        bsum += __bfloat162float(gsm[(size_t)p * P::PG + threadIdx.x]);

    for (int mf = 0; mf < P::MF; ++mf) {
      srt::BFrag bg[P::CT];
#pragma unroll
      for (int j = 0; j < P::CT; ++j)
        nvcuda::wmma::load_matrix_sync(bg[j], gsm + (size_t)mf * 16 * P::PG +
                                               j * 16,
                                    P::PG);
#pragma unroll
      for (int i = 0; i < P::RT; ++i) {
        const int row = warp * P::RT + i;  // (tap, 16-channel group)
        const int tap = row / (CK / 16), ci0 = row % (CK / 16) * 16;
        AColFrag a;
        nvcuda::wmma::load_matrix_sync(
            a, xs + (size_t)(mf * 16 + tap / KK * P::WX + tap % KK) * P::PS +
                   ci0,
            P::PS);
#pragma unroll
        for (int j = 0; j < P::CT; ++j)
          nvcuda::wmma::mma_sync(acc[i][j], a, bg[j], acc[i][j]);
      }
    }
  }

  const size_t slot = (size_t)job * gridDim.x + part;
  float* wout = ws_w + slot * KK * KK * (size_t)cin * cout;
#pragma unroll
  for (int i = 0; i < P::RT; ++i) {
    const int row = warp * P::RT + i;
    const int tap = row / (CK / 16), ci0 = row % (CK / 16) * 16;
#pragma unroll
    for (int j = 0; j < P::CT; ++j)
      nvcuda::wmma::store_matrix_sync(
          wout + ((size_t)tap * cin + rg * CK + ci0) * cout + chunk * NB +
              j * 16,
          acc[i][j], cout, nvcuda::wmma::mem_row_major);
  }
  if (rg == 0 && threadIdx.x < NB)
    ws_b[slot * cout + chunk * NB + threadIdx.x] = bsum;
}

// out[j, i] = sum over p of ws[j, p, i], p in order (n values per slot).
__global__ void wgrad_reduce(const float* __restrict__ ws,
                             float* __restrict__ out, int nparts, long long n,
                             long long total) {
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const long long j = idx / n, i = idx % n;
    const float* src = ws + j * nparts * n + i;
    float s = 0.0f;
    for (int p = 0; p < nparts; ++p) s += src[p * n];
    out[idx] = s;
  }
}

cudaError_t reduce(const float* ws, float* out, int nparts, long long n,
                   int J, cudaStream_t stream) {
  const long long total = n * J;
  const long long want = (total + 255) / 256;
  const int blocks = (int)(want < 4096 ? want : 4096);
  wgrad_reduce<<<blocks, 256, 0, stream>>>(ws, out, nparts, n, total);
  return cudaGetLastError();
}

template <int CIN, int NB, bool GATHER, int KK = 3, int WARPS = 12,
          int NRG = 1>
cudaError_t launch(const void* x, const void* g, float* ws_w, float* ws_b,
                   int J, long long x_stride, long long g_stride, int B,
                   int H, int W, int cout, int r, float gscale, int nparts,
                   cudaStream_t stream) {
  typedef WgradPlan<CIN, NB, KK, WARPS, NRG> P;
  auto kernel = wgrad_kernel<CIN, NB, GATHER, KK, WARPS, NRG>;
  cudaError_t err = srt::allow_smem(kernel, P::SMEM);
  if (err != cudaSuccess) return err;
  const int ntiles = B * ((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW);
  const int tpp = (ntiles + nparts - 1) / nparts;
  dim3 grid(nparts, NRG * (cout / NB), J);
  kernel<<<grid, P::THREADS, P::SMEM, stream>>>(
      static_cast<const srt::bf16*>(x), static_cast<const srt::bf16*>(g),
      ws_w, ws_b, B, H, W, cout, r, gscale, x_stride, g_stride, tpp);
  return cudaGetLastError();
}

template <int CK, int NB, int KK, int WARPS>
cudaError_t launch_chunk(const void* x, const void* g, float* ws_w,
                         float* ws_b, int J, long long x_stride,
                         long long g_stride, int B, int H, int W, int cin,
                         int cout, float gscale, int nparts,
                         cudaStream_t stream) {
  typedef WgradChunkPlan<CK, NB, KK, WARPS> P;
  auto kernel = wgrad_chunk_kernel<CK, NB, KK, WARPS>;
  cudaError_t err = srt::allow_smem(kernel, P::SMEM);
  if (err != cudaSuccess) return err;
  const int ntiles = B * ((H + kTH - 1) / kTH) * ((W + kTW - 1) / kTW);
  const int tpp = (ntiles + nparts - 1) / nparts;
  dim3 grid(nparts, (cin / CK) * (cout / NB), J);
  kernel<<<grid, P::THREADS, P::SMEM, stream>>>(
      static_cast<const srt::bf16*>(x), static_cast<const srt::bf16*>(g),
      ws_w, ws_b, B, H, W, cin, cout, gscale, x_stride, g_stride, tpp);
  return cudaGetLastError();
}

// The general path at CK: NB = 32 or 16, the larger that divides cout.
// Warps: 3x3 nine (CK 16, 32) or twelve (CK 64), each keeping CK / 16
// (3 at CK 64) row tiles; 5x5 CK / 16 * 5 warps of 5 row tiles (one tap
// row of a 16-channel group).
template <int CK, int KK>
cudaError_t chunk_nb(const void* x, const void* g, float* ws_w, float* ws_b,
                     int J, long long x_stride, long long g_stride, int B,
                     int H, int W, int cin, int cout, float gscale,
                     int nparts, cudaStream_t s) {
  constexpr int WARPS = KK == 5 ? CK / 16 * 5 : CK == 64 ? 12 : 9;
  if (cout % 32 == 0)
    return launch_chunk<CK, 32, KK, WARPS>(x, g, ws_w, ws_b, J, x_stride,
                                           g_stride, B, H, W, cin, cout,
                                           gscale, nparts, s);
  return launch_chunk<CK, 16, KK, WARPS>(x, g, ws_w, ws_b, J, x_stride,
                                         g_stride, B, H, W, cin, cout, gscale,
                                         nparts, s);
}

// The general path: CK = 64 (3x3 only), 32 or 16, the largest that
// divides cin (srtpu_torch/ops/wgrad.py:_plan mirrors this choice).
template <int KK>
cudaError_t chunked(const void* x, const void* g, float* ws_w, float* ws_b,
                    int J, long long x_stride, long long g_stride, int B,
                    int H, int W, int cin, int cout, float gscale, int nparts,
                    cudaStream_t s) {
  if constexpr (KK == 3) {
    if (cin % 64 == 0)
      return chunk_nb<64, KK>(x, g, ws_w, ws_b, J, x_stride, g_stride, B, H,
                              W, cin, cout, gscale, nparts, s);
  }
  if (cin % 32 == 0)
    return chunk_nb<32, KK>(x, g, ws_w, ws_b, J, x_stride, g_stride, B, H, W,
                            cin, cout, gscale, nparts, s);
  return chunk_nb<16, KK>(x, g, ws_w, ws_b, J, x_stride, g_stride, B, H, W,
                          cin, cout, gscale, nparts, s);
}

}  // namespace

// J jobs; job j reads x + j * x_stride (B, H, W, cin) bf16 and
// g + j * g_stride: (B, H, W, cout) bf16, or with r > 1 the fine
// (B, r*H, r*W, cout / (r*r)) bf16 read phase-major. Writes dw
// (J, k, k, cin, cout) f32 and db (J, cout) f32. ws_w (J, nparts, k * k *
// cin * cout) and ws_b (J, nparts, cout) f32 are scratch; nparts <= the
// number of 8 x 16 tiles. Own instances with k = 3: cin = 64 with cout %
// 64 == 0 (cout = r*r*64 when gathering), cin = 256 with cout % 16 == 0;
// with k = 5: cin = 256 with cout % 16 == 0, r = 1. Any other cin and
// cout that are multiples of 16, with r = 1, take the general path.
// Returns a cudaError_t.
extern "C" int srt_conv_wgrad(const void* x, const void* g, void* ws_w,
                              void* ws_b, void* dw, void* db, int J,
                              long long x_stride, long long g_stride, int B,
                              int H, int W, int cin, int cout, int r,
                              float gscale, int nparts, int k,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* w = static_cast<float*>(ws_w);
  float* bws = static_cast<float*>(ws_b);
  cudaError_t err;
  if (k == 5 && cin == 256 && cout % 16 == 0 && r <= 1)
    err = launch<256, 16, false, 5, 10, 5>(x, g, w, bws, J, x_stride,
                                           g_stride, B, H, W, cout, 1,
                                           gscale, nparts, s);
  else if (k == 5 && cin % 16 == 0 && cout % 16 == 0 && r <= 1)
    err = chunked<5>(x, g, w, bws, J, x_stride, g_stride, B, H, W, cin, cout,
                     gscale, nparts, s);
  else if (k != 3)
    return (int)cudaErrorInvalidValue;
  else if (cin == 64 && cout % 64 == 0 && r > 1 && cout / (r * r) % 8 == 0)
    err = launch<64, 64, true>(x, g, w, bws, J, x_stride, g_stride, B, H, W,
                               cout, r, gscale, nparts, s);
  else if (cin == 64 && cout % 64 == 0 && r <= 1)
    err = launch<64, 64, false>(x, g, w, bws, J, x_stride, g_stride, B, H,
                                W, cout, 1, gscale, nparts, s);
  else if (cin == 256 && cout % 16 == 0 && r <= 1)
    err = launch<256, 16, false>(x, g, w, bws, J, x_stride, g_stride, B, H,
                                 W, cout, 1, gscale, nparts, s);
  else if (cin % 16 == 0 && cout % 16 == 0 && r <= 1)
    err = chunked<3>(x, g, w, bws, J, x_stride, g_stride, B, H, W, cin, cout,
                     gscale, nparts, s);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  err = reduce(w, static_cast<float*>(dw), nparts,
               (long long)k * k * cin * cout, J, s);
  if (err != cudaSuccess) return (int)err;
  return (int)reduce(bws, static_cast<float*>(db), nparts, cout, J, s);
}
