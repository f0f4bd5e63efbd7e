// K6: RDN's residual dense block trunk at G = G0 = 64, NHWC bf16
// activations, f32 sums. A block's concat buffer buf (B, H, W, c_tot),
// c_tot = 64 (C + 1), holds the block input in chunk 0 and dense layer
// i's output h_i = bf16(relu(conv3x3(chunks 0..i) + b_i)) in chunk i + 1;
// the block output is bf16(x + (wf^T buf + bf)) (a 1x1 local fusion).
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
// every cross-block sum is fixed-order: per-tile partials added in order
// by a second kernel, or a cluster's ranks in order (no float atomics:
// the same bits on every call).
//
// The design: every product runs on the port's two wgmma engines, K2's
// implicit GEMM (conv_sm90.cuh) and W's (wgrad.cu), through runtime
// strides and epilogues of K6's own; rdn.cu holds the glue, a copy, the
// chain's first elementwise step and its fixed-order reductions.
//  Forward (srt_rdn_fwd), per block: C + 1 launches of K2's engine.
//   Dense layer i: the 3x3 conv of the buffer's channel prefix [0, 64 (i
//     + 1)) (the activation map's pixel stride is c_tot, its channel
//     extent the prefix, so TMA's zero fill stops there), its weight the
//     layer's i + 1 pairs of wpk read in place (5-D map, K in 64-channel
//     groups), K2's epilogue (EPI 1: bias, ReLU, one rounding) storing
//     h_i into chunk i + 1 at pixel stride c_tot. Layers 3-7 (cin >= 256) at
//     16,384 pixels split cin over 2-block clusters as K2 does.
//   The fusion: a k = 1 launch over all c_tot channels, its epilogue
//     (EPI 3) the residual, bf16(x + (sums + bf)) with x = chunk 0, written to the
//     block's slice of cat and the next block's chunk 0. Training saves
//     every block's buffer (D of them); predict reuses one, the fusion
//     writing the next input over chunk 0 in place: a 1x1 reads only its
//     own pixels, each pixel tile is read by one block (or one cluster,
//     whose block 0 stores after both have read) and each element is
//     read and then written by one thread, so no block reads a pixel
//     another has written.
//  Backward, per block (srt_rdb_bwd_chain), K6's f32 dbuf (B, H, W,
//  c_tot) kept and its order:
//   rdn_gc_kernel: gc = bf16(gf), gf = f32(g_run) + f32(ct's block
//     slice); per-64-pixel partials of dbf = sum gf.
//   W's engine at k = 1: dwf = buf^T gc.
//   K2's engine, k = 1, EPI 2: dbuf = gc wf^T (N = c_tot), its block that
//     holds chunk C forming dout_{C-1} = bf16(h_{C-1} > 0 ? dbuf_C : 0)
//     and each tile's f32 sum of it (db's partials).
//   K2's engine per layer i from C - 1 down to 0, k = 3, EPI 2: the conv
//     of doutb_i (chunk i of dout, pixel stride 64 C) with the layer's
//     transposed pairs (wtpk, N in 64-channel groups), N = 64 (i + 1),
//     added in f32 into dbuf chunks 0..i at pixel stride c_tot (each
//     element one block's, the layers in sequence: no atomics); the block
//     that holds chunk i forms dout_{i-1} from it once its sum has landed
//     there (chunk i is final after layer i), as the fusion's did; layer
//     0 writes dx = bf16(dbuf_0 + gf) in place of dbuf.
//   rdn_reduce: dbf's and db's partials in a fixed order (a warp each).
//   Forming each mask in the epilogue of the block that holds its chunk
//   measured faster on the H100 than an elementwise pass after each
//   launch (0.32 against 0.40 device-ms a block at the training shape).
//  Weight grads (srt_rdb_bwd_dw): W's engine in its pairs mode, the C (C
//   + 1) / 2 (layer i, chunk j) 3x3 grads as jobs of 64 -> 64 in one
//   launch: X = buf's chunk j at pixel stride c_tot, G = dout's chunk i,
//   each job's slot pack's pair order (0.085 device-ms a block at the
//   training shape on the H100; a launch a layer, 0.210).
//  srt_rdn_conv: K2's engine as the forward runs it, for the card tests.
//
// What bounds it on the H100. A dense layer's 3x3 conv costs 2 * 9 * 64
// * 64 = 73.7 kFLOP per pixel and input chunk; a block (C = 8) does 36
// such pairs plus the 1x1 fusion (2 * 576 * 64 = 73.7 kFLOP per pixel):
// 2.73 MFLOP per pixel, 44.7 GFLOP per block at the training shape (16 x
// 32 x 32), >= 45 us at 989 TFLOP/s, against ~25 MB the block must move
// (x, the 576-channel buffer, out and its cat slice): >= 7.5 us at 3.35
// TB/s. Operations bound it, and the backward does twice the work: the
// engines' wgmma rates bound each launch (K2's 64k -> 64 layers, W's
// 64 -> 64 class). Beyond them: the chain's f32 dbuf round trip (chunk j
// read and written by the 8 - j layers above it, 302 MB a block at the
// training shape, in the 50 MB L2 where the 37.7 MB dbuf stays), the
// layers' small grids (128 pixel tiles at 16,384 pixels, N tiles of
// 64-192) and a launch per layer.

#include "conv_sm90.cuh"
#include "wgrad.cuh"

namespace {

using srt90::bf16;
using srt90::pack8;
using srt90::unpack8;

constexpr int kG = 64;               // growth: one 64-channel chunk
constexpr int kPairW = 9 * kG * kG;  // elements of one pair's weights
constexpr int kFP = 64;              // pixels per block of the small kernels

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

// gc = bf16(gf), gf = f32(g_run) + f32(ct) (ct: the block's slice, pixel
// stride ct_ps), to gc (P, 64); dbf_part[blockIdx.x] = the 64 pixels' sum
// of gf in a fixed order. 256 threads: thread t, channel t % 64, pixels
// 16 (t / 64) .. + 15.
__global__ void __launch_bounds__(256)
    rdn_gc_kernel(const bf16* __restrict__ g_run, const bf16* __restrict__ ct,
                  int ct_ps, bf16* __restrict__ gc,
                  float* __restrict__ dbf_part, long long P) {
  __shared__ float red[4 * kG];
  const long long p0 = (long long)blockIdx.x * kFP;
  for (int i = threadIdx.x; i < kFP * (kG / 8); i += blockDim.x) {
    const long long p = p0 + i / (kG / 8);
    const int v = i % (kG / 8);
    if (p >= P) continue;
    float a[8], c[8];
    unpack8(*reinterpret_cast<const uint4*>(g_run + p * kG + v * 8), a);
    unpack8(*reinterpret_cast<const uint4*>(ct + p * ct_ps + v * 8), c);
#pragma unroll
    for (int k = 0; k < 8; ++k) a[k] += c[k];
    *reinterpret_cast<uint4*>(gc + p * kG + v * 8) = pack8(a);
  }
  // 4 groups of 64 threads over 16 pixels each, the groups added in order
  const int grp = threadIdx.x / kG, c = threadIdx.x % kG;
  float s = 0.0f;
  for (int q = 0; q < kFP / 4; ++q) {
    const long long p = p0 + grp * (kFP / 4) + q;
    if (p < P)
      s += __bfloat162float(g_run[p * kG + c]) +
           __bfloat162float(ct[p * ct_ps + c]);
  }
  red[grp * kG + c] = s;
  __syncthreads();
  if (threadIdx.x < kG)
    dbf_part[(size_t)blockIdx.x * kG + c] =
        ((red[c] + red[kG + c]) + red[2 * kG + c]) + red[3 * kG + c];
}

// out[j, e] = sum over p of ws[j, p, e] (n values per slot), one warp an
// output: lane l adds parts l, l + 32, ... in order, then the lanes in a
// fixed tree.
__global__ void rdn_reduce(const float* __restrict__ ws,
                           float* __restrict__ out, int nparts, long long n,
                           long long total) {
  const int lane = threadIdx.x & 31;
  for (long long idx = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
       idx < total; idx += (long long)gridDim.x * blockDim.x / 32) {
    const long long j = idx / n, e = idx % n;
    const float* src = ws + j * nparts * n + e;
    float s = 0.0f;
    for (int p = lane; p < nparts; p += 32) s += src[p * n];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) out[idx] = s;
  }
}

int grid1d(long long n) {
  const long long want = (n + 255) / 256;
  return (int)(want < 4096 ? want : 4096);
}

cudaError_t reduce(const float* ws, void* out, int nparts, long long n,
                   int jobs, cudaStream_t s) {
  rdn_reduce<<<grid1d(32 * n * jobs), 256, 0, s>>>(
      ws, static_cast<float*>(out), nparts, n, n * jobs);
  return cudaGetLastError();
}

// K2's engine tiles (8 x 16 pixels) over the B images.
int engine_tiles(int B, int H, int W) {
  return B * ((H + srt90::kTH - 1) / srt90::kTH) *
         ((W + srt90::kTW - 1) / srt90::kTW);
}

// A k x k conv of the (B, H, W) images: the common part of the launches.
srt90::ConvArgs conv_args(int B, int H, int W, int cin, int cout, int kk) {
  srt90::ConvArgs a = {};
  a.B = B;
  a.H = H;
  a.W = W;
  a.cin = cin;
  a.cout = cout;
  a.kk = kk;
  a.ch.mask_chunk = -1;
  return a;
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
  bf16* bb = static_cast<bf16*>(bufs);
  const bf16* w = static_cast<const bf16*>(wpk);
  rdn_copy_in_kernel<<<grid1d(P * (kG / 8)), 256, 0, s>>>(
      static_cast<const bf16*>(x), bb, P * (kG / 8), ctot);
  SRT_TRY(cudaGetLastError());
  for (int l = 0; l < D; ++l) {
    bf16* buf = bb + (save ? (size_t)l * P * ctot : 0);
    for (int i = 0; i < C; ++i) {
      srt90::ConvArgs a = conv_args(B, H, W, kG * (i + 1), kG, 3);
      a.x = buf;
      a.xps = ctot;
      a.w = w + ((size_t)l * np + pair0(i)) * kPairW;
      a.pack_k = 1;
      a.bias = static_cast<const float*>(b) + ((size_t)l * C + i) * kG;
      a.relu = 1;
      a.out = buf + kG * (i + 1);
      a.ops = ctot;
      SRT_TRY((srt90::run64<false, 1>(a, s)));
    }
    srt90::ConvArgs a = conv_args(B, H, W, ctot, kG, 1);
    a.x = buf;
    a.xps = ctot;
    a.w = static_cast<const bf16*>(wf) + (size_t)l * ctot * kG;
    a.bias = static_cast<const float*>(bf) + (size_t)l * kG;
    a.out = static_cast<bf16*>(cat) + l * kG;
    a.ops = D * kG;
    a.res = buf;
    a.rps = ctot;
    a.out2 = l + 1 == D ? nullptr : save ? buf + P * ctot : buf;
    a.o2ps = ctot;
    SRT_TRY((srt90::run64<false, 3>(a, s)));
  }
  return 0;
}

// K2's engine as K6's forward runs it (EPI 1), for the card tests: the
// 3x3 conv of x's channels [0, cin) (x: (B, H, W, xps) bf16) with w, one
// HWIO weight (pack 0: (3, 3, cin, cout)) or pairs (pack 1: K in 64-
// channel groups, a layer's pairs of pack; 2: N in groups, its transposed
// pairs), plus bias (f32), ReLU if relu, stored bf16 into out's channels
// [0, cout) (out: (B, H, W, ops)). Returns a cudaError_t.
extern "C" int srt_rdn_conv(const void* x, int xps, const void* w, int pack,
                            const void* bias, void* out, int ops, int B,
                            int H, int W, int cin, int cout, int relu,
                            void* stream) {
  if (pack < 0 || pack > 2) return (int)cudaErrorInvalidValue;
  srt90::ConvArgs a = conv_args(B, H, W, cin, cout, 3);
  a.x = static_cast<const bf16*>(x);
  a.xps = xps;
  a.w = static_cast<const bf16*>(w);
  a.pack_k = pack == 1;
  a.pack_n = pack == 2;
  a.bias = static_cast<const float*>(bias);
  a.relu = relu;
  a.out = out;
  a.ops = ops;
  return (int)srt90::run64<false, 1>(a, static_cast<cudaStream_t>(stream));
}

// The backward chain of block l of D: buf (B, H, W, c_tot) the block's
// saved buffer; g_run (B, H, W, 64) and ct (B, H, W, 64 D) bf16; wt (C (C
// + 1) / 2, 3, 3, 64, 64) the block's transposed pairs, wft (64, c_tot)
// its transposed fusion weight, bf16. Scratch: dbuf (B, H, W, c_tot) f32,
// gc (B, H, W, 64) bf16, part f32 of (ceil(P / 64) + C nt) 64 floats (nt
// = B ceil(H / 8) ceil(W / 16), the engine's pixel tiles); dwf's weight-grad
// split (cluster, nclusters) and, with nclusters > 1, its slots ws_w
// (nclusters, c_tot 64) and ws_b (nclusters, 64) f32. Writes dout (B, H, W, 64 C) and dx (B, H, W, 64) bf16, dwf (c_tot, 64),
// dbf (64), db (C, 64) f32. Returns a cudaError_t.
extern "C" int srt_rdb_bwd_chain(const void* buf, const void* g_run,
                                 const void* ct, int l, int D, const void* wt,
                                 const void* wft, void* dbuf, void* gc,
                                 void* part, void* dout, void* dx, void* dwf,
                                 void* dbf, void* db, void* ws_w, void* ws_b,
                                 int B, int H, int W, int C, int cluster,
                                 int nclusters, void* stream) {
  if (C < 1 || l < 0 || l >= D) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ctot = kG * (C + 1);
  const long long P = (long long)B * H * W;
  const int ntl = (int)((P + kFP - 1) / kFP), nt = engine_tiles(B, H, W);
  float* part_dbf = static_cast<float*>(part);
  float* part_db = part_dbf + (size_t)ntl * kG;
  const bf16* bufp = static_cast<const bf16*>(buf);
  const bf16* ctl = static_cast<const bf16*>(ct) + l * kG;
  const bf16* gr = static_cast<const bf16*>(g_run);
  bf16* gcp = static_cast<bf16*>(gc);
  bf16* doutp = static_cast<bf16*>(dout);
  float* dbf32 = static_cast<float*>(dbuf);
  rdn_gc_kernel<<<ntl, 256, 0, s>>>(gr, ctl, D * kG, gcp, part_dbf, P);
  SRT_TRY(cudaGetLastError());
  srt90::WgradArgs wa = {};
  wa.x = bufp;
  wa.g = gcp;
  wa.ws_w = ws_w;
  wa.ws_b = ws_b;
  wa.dw = dwf;
  wa.J = 1;
  wa.B = B;
  wa.H = H;
  wa.W = W;
  wa.cin = ctot;
  wa.cout = kG;
  wa.gscale = 1.0f;
  wa.cluster = cluster;
  wa.nclusters = nclusters;
  wa.k = 1;
  SRT_TRY(srt90::wgrad(wa, s));
  // layer m's launch (m = C: the fusion's) leaves dbuf's chunk m final:
  // the block that holds it forms dout_{m-1} and db_{m-1}'s partials
  auto mask = [&](srt90::ConvArgs& a, int m) {
    if (m < 1) return;
    a.ch.mask_chunk = m;
    a.ch.h = bufp + kG * m;
    a.ch.hps = ctot;
    a.ch.dout = doutp + kG * (m - 1);
    a.ch.dps = kG * C;
    a.ch.db_part = part_db + (size_t)(m - 1) * nt * kG;
  };
  {
    srt90::ConvArgs a = conv_args(B, H, W, kG, ctot, 1);
    a.x = gcp;
    a.xps = kG;
    a.w = static_cast<const bf16*>(wft);
    a.ch.dbuf = dbf32;
    a.ops = ctot;
    mask(a, C);
    SRT_TRY((srt90::run64<false, 2>(a, s)));
  }
  for (int i = C - 1; i >= 0; --i) {
    srt90::ConvArgs a = conv_args(B, H, W, kG, kG * (i + 1), 3);
    a.x = doutp + kG * i;
    a.xps = kG * C;
    a.w = static_cast<const bf16*>(wt) + (size_t)pair0(i) * kPairW;
    a.pack_n = 1;
    a.ch.dbuf = dbf32;
    a.ops = ctot;
    a.ch.accum = 1;
    if (i == 0) {
      a.ch.g = gr;
      a.ch.gps = kG;
      a.ch.ct = ctl;
      a.ch.ctps = D * kG;
      a.ch.dx = static_cast<bf16*>(dx);
    }
    mask(a, i);
    SRT_TRY((srt90::run64<false, 2>(a, s)));
  }
  SRT_TRY(reduce(part_dbf, dbf, ntl, kG, 1, s));
  return (int)reduce(part_db, db, nt, kG, C, s);
}

// The (layer, chunk) 3x3 weight grads of one block on W's engine (pairs
// mode): buf (B, H, W, c_tot) its saved buffer, dout (B, H, W, 64 C)
// bf16 (the chain's). The split (cluster, nclusters) as wgrad_parts gives
// it for C (C + 1) / 2 jobs of 64 -> 64; with nclusters > 1, ws (C (C +
// 1) / 2, nclusters, 9 64 64) f32 its slots. Writes dw (C (C + 1) / 2, 3,
// 3, 64, 64) f32 in pack's pair order. Returns a cudaError_t.
extern "C" int srt_rdb_bwd_dw(const void* buf, const void* dout, void* ws,
                              void* dw_out, int B, int H, int W, int C,
                              int cluster, int nclusters, void* stream) {
  if (C < 1) return (int)cudaErrorInvalidValue;
  srt90::WgradArgs a = {};
  a.x = buf;
  a.g = dout;
  a.ws_w = ws;
  a.dw = dw_out;
  a.J = pair0(C);
  a.B = B;
  a.H = H;
  a.W = W;
  a.cin = kG;
  a.cout = kG;
  a.gscale = 1.0f;
  a.cluster = cluster;
  a.nclusters = nclusters;
  a.k = 3;
  a.xps = kG * (C + 1);
  a.xch = kG * C;
  a.gch = kG * C;
  a.pairs = 1;
  return (int)srt90::wgrad(a, static_cast<cudaStream_t>(stream));
}
