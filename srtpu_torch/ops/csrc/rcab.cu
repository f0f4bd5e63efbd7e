// K5: RCAN's residual channel-attention block (RCAB), forward and
// backward, at 64 channels, NHWC bf16 activations, f32 sums, f32
// attention MLP (C -> Cr -> C):
//   h1  = bf16(relu(conv(x, W1) + b1)),   r2f = conv(h1, W2) + b2 (f32),
//   p   = mean of r2f over the image,     z = relu(p Wd + bd),
//   q   = sigmoid(z Wu + bu),             out = bf16(x + r2f * q),
// saving h1 and r2 = bf16(r2f) for training.
//
// Replaces srtpu/ops/cs_conv.py:_rcab_fwd_call (body _rcab_fwd_kernel)
// and _rcab_bwd_call (body _rcab_bwd_kernel), behind resgroup_ca_cs.
//
// The whole-image pool. On the TPU one grid step holds whole images in
// VMEM, so one kernel body pools r2 over the image and gates it. On
// Hopper a block holds one 8 x 16 tile, the blocks run in no order, and
// the gate of every pixel needs the mean over all pixels of its image. So
// each direction runs as launches on one stream, and every cross-block
// sum goes through per-tile partials added in a fixed order (no float
// atomics: the same bits on every call).
//
// The convs run on K2's wgmma engine (conv_sm90.cuh) at its own plan for
// 3x3 64 -> 64 (8 x 16 pixel tiles, N = 64, TMA-staged tile and weight
// rings); rcab.cu is the glue and the passes that do no matrix work.
//  Forward, per RCAB (five launches):
//   conv1: K2's own instance (srt_conv3x3_fwd, bias + ReLU): h1;
//   conv2: the engine with K5's epilogue (EPI 4): r2f = sums + b2 in f32
//      (the gate multiplies the unrounded value, as srtpu does), r2 when
//      saving, and each tile's per-channel f32 sum of r2f (pixels in a
//      fixed order, those outside the image left out) to its slot;
//   F2 rcab_pool_mlp_kernel: one block per image adds its tiles' partials
//      in a fixed order, divides by H * W and runs the MLP (as the TPU
//      kernel does in its body: no library matmul);
//   F3 rcab_gate_kernel: out = bf16(x + r2f * q[b, c]), elementwise.
//  Backward, per RCAB (p, z, q recomputed from the saved bf16 r2, as
//  srtpu does; six launches):
//   B1 rcab_ca_sums_kernel: per 128-pixel chunk of an image, f32
//      partials of sum(r2) and sum(g * r2);
//   B2 rcab_ca_bwd_kernel: one block per image: p, z, q, dq,
//      dzq = dq q (1 - q), dz = (Wu dzq)[z > 0], dp / (H * W); then
//      rcab_mlp_grads_kernel sums dWu, dbu, dWd, dbd over the images in
//      order;
//   B3 rcab_dr2_kernel: dr2 = bf16(g * q + dp / (H * W)), materialised
//      (the weight grads read it);
//   the dx chain, two transposed-conv launches of the engine (TB: the
//      forward's HWIO weight read K-major, the taps reversed, no
//      transposed copy) with K5's epilogue (EPI 5): dh1 = bf16(h1 > 0 ?
//      convT(dr2, W2) : 0), the mask read from h1 in the epilogue; dx =
//      bf16(convT(dh1, W1) + f32(g)).
//  dW1/db1 and dW2/db2 come from wgrad.cu (srtpu_torch/ops/rcab.py
//  batches all blocks of a residual group into one launch per conv).
//  One host call runs a residual group's L RCABs each way
//  (srt_rcab_group_fwd, srt_rcab_group_chain): the wrapper checks and
//  allocates once per group, and the scratch (r2f, the partials, q) is
//  reused RCAB after RCAB, which the one stream orders.
//
// What bounds it on the H100: the conv pair is 2 * 2 * 9 * 64 * 64 = 147
// kFLOP per pixel; the function's own bytes are x in and out, h1, r2 out
// (512 B per pixel when saving): ~290 FLOP/B, at the bf16 ridge (~295),
// so at the training shape (16 x 32 x 32) 2.42 GFLOP take >= 2.44 us of
// tensor-core time and 8.4 MB >= 2.50 us of memory time; at predict
// (one 512 x 352 image, no saving) it is compute bound, 26.6 GFLOP
// >= 26.9 us. The backward does twice the conv work (dx chain; the
// weight grads in wgrad.cu). The split costs bytes the TPU kernel never
// moves: h1's round trip between the two convs, r2f's f32 round trip
// (512 B per pixel) between conv2 and F3 and the pooled partials; F2,
// B1, B2 and B3 do no matrix work. At 16,384 pixels each conv is 128
// tiles, one wave of the card's 132 SMs.

#include "conv_sm90.cuh"

// K2's forward (conv.cu), the RCAB's first conv.
extern "C" int srt_conv3x3_fwd(const void* x, const void* w, const void* b,
                               void* out, int B, int H, int W, int cin,
                               int cout, int relu, void* stream);

namespace {

using srt90::bf16;
using srt90::pack8;
using srt90::unpack8;
constexpr int kC = 64;
constexpr int kChunk = 128;                  // pixels per backward-sum block
constexpr int kSlices = 16;                  // partial-sum lanes per channel
constexpr size_t kConvW = 9 * kC * kC;       // one 3x3 weight's elements

__device__ __forceinline__ float sigmoid_f32(float a) {
  return 1.0f / (1.0f + expf(-a));
}

// Sum of part[(b * n + t) * kC + c] over t, in a fixed order: lane
// (c, s) of kSlices * kC threads takes t = s, s + kSlices, ...; lane
// (c, 0) then adds the slices in order. Valid in threads < kC.
__device__ __forceinline__ float ordered_sum(const float* __restrict__ part,
                                             int b, int n, float* red) {
  const int c = threadIdx.x % kC, s = threadIdx.x / kC;
  float a = 0.0f;
  for (int t = s; t < n; t += kSlices) a += part[((size_t)b * n + t) * kC + c];
  red[s * kC + c] = a;
  __syncthreads();
  float total = 0.0f;
  if (threadIdx.x < kC)
    for (int k = 0; k < kSlices; ++k) total += red[k * kC + c];
  __syncthreads();
  return total;
}

// F2. grid B, kSlices * kC threads.
__global__ void __launch_bounds__(kSlices * kC)
    rcab_pool_mlp_kernel(const float* __restrict__ part, int ntiles,
                         float npix, const float* __restrict__ wd,
                         const float* __restrict__ bd,
                         const float* __restrict__ wu,
                         const float* __restrict__ bu, int cr,
                         float* __restrict__ q) {
  __shared__ float red[kSlices * kC], p[kC], z[kC];
  const int b = blockIdx.x, c = threadIdx.x;
  const float s = ordered_sum(part, b, ntiles, red);
  if (c < kC) p[c] = s / npix;
  __syncthreads();
  if (c < cr) {
    float a = 0.0f;
    for (int k = 0; k < kC; ++k) a += p[k] * wd[k * cr + c];
    z[c] = fmaxf(a + bd[c], 0.0f);
  }
  __syncthreads();
  if (c < kC) {
    float a = 0.0f;
    for (int j = 0; j < cr; ++j) a += z[j] * wu[j * kC + c];
    q[b * kC + c] = sigmoid_f32(a + bu[c]);
  }
}

// F3. out = bf16(x + r2f * q), 8 channels per thread (mul, then add: no
// fused multiply-add, the rounding of srtpu's f32 expression).
__global__ void rcab_gate_kernel(const bf16* __restrict__ x,
                                 const float* __restrict__ r2f,
                                 const float* __restrict__ q,
                                 bf16* __restrict__ out, long long nvec,
                                 long long hw) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < nvec; i += (long long)gridDim.x * blockDim.x) {
    const long long pix = i / (kC / 8);
    const int c = (int)(i % (kC / 8)) * 8;
    const float* qb = q + (pix / hw) * kC + c;
    float xv[8];
    unpack8(reinterpret_cast<const uint4*>(x)[i], xv);
    const float4 r0 = reinterpret_cast<const float4*>(r2f)[2 * i];
    const float4 r1 = reinterpret_cast<const float4*>(r2f)[2 * i + 1];
    const float rv[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) xv[j] = __fadd_rn(xv[j], __fmul_rn(rv[j], qb[j]));
    reinterpret_cast<uint4*>(out)[i] = pack8(xv);
  }
}

// B1. grid (nchunks, B), 4 * kC threads: lane (c, s) sums pixels s,
// s + 4, ... of the chunk, then lane (c, 0) adds the four in order.
__global__ void __launch_bounds__(4 * kC)
    rcab_ca_sums_kernel(const bf16* __restrict__ g,
                        const bf16* __restrict__ r2, float* __restrict__ part_r2,
                        float* __restrict__ part_gr2, int hw) {
  __shared__ float ra[4 * kC], ga[4 * kC];
  const int c = threadIdx.x % kC, s = threadIdx.x / kC;
  const int chunk = blockIdx.x, b = blockIdx.y;
  const int p1 = min(hw, (chunk + 1) * kChunk);
  float a = 0.0f, ag = 0.0f;
  for (int p = chunk * kChunk + s; p < p1; p += 4) {
    const size_t i = ((size_t)b * hw + p) * kC + c;
    const float rv = __bfloat162float(r2[i]);
    a += rv;
    ag += __bfloat162float(g[i]) * rv;
  }
  ra[threadIdx.x] = a;
  ga[threadIdx.x] = ag;
  __syncthreads();
  if (threadIdx.x < kC) {
    float sr = 0.0f, sg = 0.0f;
    for (int k = 0; k < 4; ++k) {
      sr += ra[k * kC + c];
      sg += ga[k * kC + c];
    }
    const size_t slot = ((size_t)b * gridDim.x + chunk) * kC + c;
    part_r2[slot] = sr;
    part_gr2[slot] = sg;
  }
}

// B2a. grid B, kSlices * kC threads: one image's gate recomputed from
// its sum(r2), then q, dzq, dz and dp / (H * W). Writes q and dpn for B3,
// and p, z, dzq, dz (vec: (B, 2 * kC + 2 * cr)) for B2b.
__global__ void __launch_bounds__(kSlices * kC)
    rcab_ca_bwd_kernel(const float* __restrict__ part_r2,
                       const float* __restrict__ part_gr2, int nchunks,
                       float npix, const float* __restrict__ wd,
                       const float* __restrict__ bd,
                       const float* __restrict__ wu,
                       const float* __restrict__ bu, int cr,
                       float* __restrict__ q, float* __restrict__ dpn,
                       float* __restrict__ vec) {
  __shared__ float red[kSlices * kC], p[kC], z[kC], dzq[kC], dz[kC];
  const int b = blockIdx.x, c = threadIdx.x;
  const float sr = ordered_sum(part_r2, b, nchunks, red);
  const float dq = ordered_sum(part_gr2, b, nchunks, red);
  float* out = vec + (size_t)b * (2 * kC + 2 * cr);  // p, dzq, z, dz
  if (c < kC) out[c] = p[c] = sr / npix;
  __syncthreads();
  if (c < cr) {
    float a = 0.0f;
    for (int k = 0; k < kC; ++k) a += p[k] * wd[k * cr + c];
    out[2 * kC + c] = z[c] = fmaxf(a + bd[c], 0.0f);
  }
  __syncthreads();
  if (c < kC) {
    float a = 0.0f;
    for (int j = 0; j < cr; ++j) a += z[j] * wu[j * kC + c];
    const float qc = sigmoid_f32(a + bu[c]);
    q[b * kC + c] = qc;
    out[kC + c] = dzq[c] = dq * qc * (1.0f - qc);
  }
  __syncthreads();
  if (c < cr) {
    float a = 0.0f;
    for (int k = 0; k < kC; ++k) a += wu[c * kC + k] * dzq[k];
    out[2 * kC + cr + c] = dz[c] = z[c] > 0.0f ? a : 0.0f;
  }
  __syncthreads();
  if (c < kC) {
    float a = 0.0f;
    for (int j = 0; j < cr; ++j) a += wd[c * cr + j] * dz[j];
    dpn[b * kC + c] = a / npix;
  }
}

// B2b. One block of kC threads: the MLP's weight grads, summed over the
// images in order: dWu = sum z (x) dzq, dbu = sum dzq, dWd = sum p (x)
// dz, dbd = sum dz.
__global__ void __launch_bounds__(kC)
    rcab_mlp_grads_kernel(const float* __restrict__ vec, int B, int cr,
                          float* __restrict__ dwd, float* __restrict__ dbd,
                          float* __restrict__ dwu, float* __restrict__ dbu) {
  const int c = threadIdx.x, n = 2 * kC + 2 * cr;
  float su = 0.0f;
  for (int b = 0; b < B; ++b) su += vec[(size_t)b * n + kC + c];
  dbu[c] = su;
  for (int j = 0; j < cr; ++j) {
    float u = 0.0f, d = 0.0f;
    for (int b = 0; b < B; ++b) {
      const float* v = vec + (size_t)b * n;
      u += v[2 * kC + j] * v[kC + c];        // z_j dzq_c
      d += v[c] * v[2 * kC + cr + j];        // p_c dz_j
    }
    dwu[j * kC + c] = u;
    dwd[c * cr + j] = d;
  }
  if (c < cr) {
    float s = 0.0f;
    for (int b = 0; b < B; ++b) s += vec[(size_t)b * n + 2 * kC + cr + c];
    dbd[c] = s;
  }
}

// B3. dr2 = bf16(g * q + dp / (H * W)) (mul, then add, as srtpu's f32).
__global__ void rcab_dr2_kernel(const bf16* __restrict__ g,
                                const float* __restrict__ q,
                                const float* __restrict__ dpn,
                                bf16* __restrict__ dr2, long long nvec,
                                long long hw) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < nvec; i += (long long)gridDim.x * blockDim.x) {
    const long long pix = i / (kC / 8);
    const int c = (int)(i % (kC / 8)) * 8;
    const long long o = (pix / hw) * kC + c;
    float gv[8];
    unpack8(reinterpret_cast<const uint4*>(g)[i], gv);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      gv[j] = __fadd_rn(__fmul_rn(gv[j], q[o + j]), dpn[o + j]);
    reinterpret_cast<uint4*>(dr2)[i] = pack8(gv);
  }
}

int elementwise_blocks(long long nvec) {
  const long long want = (nvec + 255) / 256;
  return (int)(want < (1 << 20) ? want : (1 << 20));
}


#define SRT_TRY(...)                            \
  do {                                          \
    cudaError_t e_ = (__VA_ARGS__);             \
    if (e_ != cudaSuccess) return (int)e_;      \
  } while (0)

}  // namespace

// The forward of one residual group's L RCABs (L = 1: one RCAB). x (B, H,
// W, 64) bf16, the group's input; w1, w2 (L, 3, 3, 64, 64) bf16; b1, b2,
// bu (L, 64), wd (L, 64, cr), bd (L, cr), wu (L, cr, 64) f32, 1 <= cr <=
// 64. save: ys, h1, r2 (L, B, H, W, 64) bf16 take RCAB i's output, h1 and
// r2 in slot i. Else ys (2, B, H, W, 64) (one slot when L = 1) takes RCAB
// i's output in slot i % 2, h1 (B, H, W, 64) is scratch and r2 null.
// Scratch, reused RCAB after RCAB: r2f (B, H, W, 64) f32, part (B, tiles,
// 64) f32 (tiles = ceil(H / 8) ceil(W / 16), the engine's), q (B, 64)
// f32. Five launches an RCAB. Returns a cudaError_t.
extern "C" int srt_rcab_group_fwd(const void* x, const void* w1,
                                  const void* b1, const void* w2,
                                  const void* b2, const void* wd,
                                  const void* bd, const void* wu,
                                  const void* bu, void* ys, void* h1,
                                  void* r2, void* r2f, void* part, void* q,
                                  int L, int save, int B, int H, int W,
                                  int C, int cr, void* stream) {
  if (C != kC || cr < 1 || cr > kC || L < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t act = (size_t)B * H * W * kC;
  const int ntiles = ((H + srt90::kTH - 1) / srt90::kTH) *
                     ((W + srt90::kTW - 1) / srt90::kTW);
  const long long nvec = (long long)B * H * W * (kC / 8);
  bf16* y = static_cast<bf16*>(ys);
  const bf16* cur = static_cast<const bf16*>(x);
  for (int i = 0; i < L; ++i) {
    bf16* out = y + (save ? i : i % 2) * act;
    bf16* h1i = static_cast<bf16*>(h1) + (save ? i * act : 0);
    const bf16* w1i = static_cast<const bf16*>(w1) + i * kConvW;
    const bf16* w2i = static_cast<const bf16*>(w2) + i * kConvW;
    const float* b1i = static_cast<const float*>(b1) + i * kC;
    const float* b2i = static_cast<const float*>(b2) + i * kC;
    SRT_TRY((cudaError_t)srt_conv3x3_fwd(cur, w1i, b1i, h1i, B, H, W, kC, kC,
                                         1, stream));
    srt90::ConvArgs a = srt90::args_3x3_64(h1i, w2i, b2i, nullptr, B, H, W);
    a.k5.r2f = static_cast<float*>(r2f);
    a.k5.r2 = save ? static_cast<bf16*>(r2) + i * act : nullptr;
    a.k5.part = static_cast<float*>(part);
    SRT_TRY((srt90::run_3x3_64<false, 4>(a, s)));
    rcab_pool_mlp_kernel<<<B, kSlices * kC, 0, s>>>(
        static_cast<const float*>(part), ntiles, (float)H * (float)W,
        static_cast<const float*>(wd) + (size_t)i * kC * cr,
        static_cast<const float*>(bd) + (size_t)i * cr,
        static_cast<const float*>(wu) + (size_t)i * cr * kC,
        static_cast<const float*>(bu) + i * kC, cr, static_cast<float*>(q));
    SRT_TRY(cudaGetLastError());
    rcab_gate_kernel<<<elementwise_blocks(nvec), 256, 0, s>>>(
        cur, static_cast<const float*>(r2f), static_cast<const float*>(q),
        out, nvec, (long long)H * W);
    SRT_TRY(cudaGetLastError());
    cur = out;
  }
  return 0;
}

// The dx chain of one residual group's L RCABs, the last first (L = 1: one
// RCAB), without the conv weight grads. h1, r2 (L, B, H, W, 64) bf16, the
// saved activations; g (B, H, W, 64) bf16, the cotangent of RCAB L - 1's
// output; w1, w2 (L, 3, 3, 64, 64) bf16, the forward weights (the engine
// reads them transposed); wd, bd, wu, bu as the forward. Writes dr2, dh1
// (L, B, H, W, 64) bf16 (the weight grads read them), the MLP grads dwd
// (L, 64, cr), dbd (L, cr), dwu (L, cr, 64), dbu (L, 64) f32, and RCAB i's
// input cotangent into slot i % 2 of gs (2, B, H, W, 64) bf16 (one slot
// when L = 1): slot 0 ends with dx. Scratch, reused RCAB after RCAB: part
// (2 B ceil(H W / 128) 64 + B (128 + 2 cr)) f32, q, dpn (B, 64) f32. Six
// launches an RCAB. Returns a cudaError_t.
extern "C" int srt_rcab_group_chain(
    const void* h1, const void* r2, const void* g, const void* w1,
    const void* w2, const void* wd, const void* bd, const void* wu,
    const void* bu, void* part, void* q, void* dpn, void* dr2, void* dh1,
    void* gs, void* dwd, void* dbd, void* dwu, void* dbu, int L, int B,
    int H, int W, int C, int cr, void* stream) {
  if (C != kC || cr < 1 || cr > kC || L < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t act = (size_t)B * H * W * kC;
  const int hw = H * W, nchunks = (hw + kChunk - 1) / kChunk;
  const long long nvec = (long long)B * hw * (kC / 8);
  float* part_r2 = static_cast<float*>(part);
  float* part_gr2 = part_r2 + (size_t)B * nchunks * kC;
  float* vec = part_gr2 + (size_t)B * nchunks * kC;
  const bf16* gin = static_cast<const bf16*>(g);
  for (int i = L - 1; i >= 0; --i) {
    const bf16* h1i = static_cast<const bf16*>(h1) + i * act;
    const bf16* r2i = static_cast<const bf16*>(r2) + i * act;
    bf16* dr2i = static_cast<bf16*>(dr2) + i * act;
    bf16* dh1i = static_cast<bf16*>(dh1) + i * act;
    bf16* gout = static_cast<bf16*>(gs) + (i % 2) * act;
    const float* wdi = static_cast<const float*>(wd) + (size_t)i * kC * cr;
    const float* bdi = static_cast<const float*>(bd) + (size_t)i * cr;
    const float* wui = static_cast<const float*>(wu) + (size_t)i * cr * kC;
    const float* bui = static_cast<const float*>(bu) + i * kC;
    rcab_ca_sums_kernel<<<dim3(nchunks, B), 4 * kC, 0, s>>>(
        gin, r2i, part_r2, part_gr2, hw);
    SRT_TRY(cudaGetLastError());
    rcab_ca_bwd_kernel<<<B, kSlices * kC, 0, s>>>(
        part_r2, part_gr2, nchunks, (float)H * (float)W, wdi, bdi, wui, bui,
        cr, static_cast<float*>(q), static_cast<float*>(dpn), vec);
    SRT_TRY(cudaGetLastError());
    rcab_mlp_grads_kernel<<<1, kC, 0, s>>>(
        vec, B, cr, static_cast<float*>(dwd) + (size_t)i * kC * cr,
        static_cast<float*>(dbd) + (size_t)i * cr,
        static_cast<float*>(dwu) + (size_t)i * cr * kC,
        static_cast<float*>(dbu) + i * kC);
    SRT_TRY(cudaGetLastError());
    rcab_dr2_kernel<<<elementwise_blocks(nvec), 256, 0, s>>>(
        gin, static_cast<const float*>(q), static_cast<const float*>(dpn),
        dr2i, nvec, hw);
    SRT_TRY(cudaGetLastError());
    srt90::ConvArgs a = srt90::args_3x3_64(
        dr2i, static_cast<const bf16*>(w2) + i * kConvW, nullptr, dh1i, B, H,
        W);
    a.k5.h = h1i;
    SRT_TRY((srt90::run_3x3_64<true, 5>(a, s)));
    a = srt90::args_3x3_64(dh1i,
                           static_cast<const bf16*>(w1) + i * kConvW,
                           nullptr, gout, B, H, W);
    a.k5.res = gin;
    SRT_TRY((srt90::run_3x3_64<true, 5>(a, s)));
    gin = gout;
  }
  return 0;
}
