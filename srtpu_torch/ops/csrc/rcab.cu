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
// each direction runs as passes on one stream, and every cross-block sum
// goes through per-block partials added in a fixed order (no float
// atomics: the same bits on every call, as wgrad.cu).
//  Forward:
//   F1 rcab_pair_kernel: the fused conv pair of K1 (fused_block.cuh) per
//      tile. Its epilogue writes r2f in f32 (the gate multiplies the
//      unrounded value, as srtpu does), r2 and h1 when saving, and the
//      tile's per-channel f32 sum of r2f, added in pixel order in shared
//      memory, to the tile's own workspace slot;
//   F2 rcab_pool_mlp_kernel: one block per image adds its tiles' partials
//      in a fixed order, divides by H * W and runs the MLP (as the TPU
//      kernel does in its body: no library matmul);
//   F3 rcab_gate_kernel: out = bf16(x + r2f * q[b, c]), elementwise.
//  Backward (p, z, q recomputed from the saved bf16 r2, as srtpu does):
//   B1 rcab_ca_sums_kernel: per 128-pixel chunk of an image, f32
//      partials of sum(r2) and sum(g * r2);
//   B2 rcab_ca_bwd_kernel: one block per image: p, z, q, dq,
//      dzq = dq q (1 - q), dz = (Wu dzq)[z > 0], dp / (H * W); then
//      rcab_mlp_grads_kernel sums dWu, dbu, dWd, dbd over the images in
//      order;
//   B3 rcab_dr2_kernel: dr2 = bf16(g * q + dp / (H * W)), materialised
//      (the weight-grad kernel reads it);
//   B4 rcab_chain_kernel: K1's dx chain (fused_block.cuh pair_backward)
//      with conv input dr2 and skip g: dh1 = bf16(h1 > 0 ?
//      convT(dr2, W2) : 0), dx = bf16(convT(dh1, W1) + g).
//  dW1/db1 and dW2/db2 come from wgrad.cu (srtpu_torch/ops/rcab.py
//  batches all blocks of a residual group into one launch per conv).
//
// What bounds it on the H100: the conv pair is 2 * 2 * 9 * 64 * 64 = 147
// kFLOP per pixel; the function's own bytes are x in and out, h1, r2 out
// (512 B per pixel when saving): ~290 FLOP/B, at the bf16 ridge (~295),
// so at the training shape (16 x 32 x 32) 2.42 GFLOP take >= 2.44 us of
// tensor-core time and 8.4 MB >= 2.50 us of memory time; at predict
// (one 512 x 352 image, no saving) it is compute bound, 26.6 GFLOP
// >= 26.9 us. The backward does twice the conv work (dx chain; the
// weight grads in wgrad.cu). The split costs bytes the TPU kernel never
// moves: r2f's f32 round trip (512 B per pixel) between F1 and F3 and
// the pooled partials; F2, B1, B2 and B3 do no matrix work. Fusing F3
// into the next RCAB's tile load is later work. No wgmma/TMA yet.

#include "fused_block.cuh"

namespace {

using srt::bf16;
namespace fb = srt::fused;
constexpr int kC = fb::kC;
constexpr int kTilePix = fb::kTH * fb::kTW;  // 128 pixels per forward tile
constexpr int kChunk = 128;                  // pixels per backward-sum block
constexpr int kSlices = 16;                  // partial-sum lanes per channel

__device__ __forceinline__ float sigmoid_f32(float a) {
  return 1.0f / (1.0f + expf(-a));
}

// F1. grid (ceil(W / 16), ceil(H / 8), B).
__global__ void __launch_bounds__(srt::kThreads)
    rcab_pair_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                     const float* __restrict__ b1,
                     const bf16* __restrict__ w2,
                     const float* __restrict__ b2, float* __restrict__ r2f,
                     bf16* __restrict__ h1_out, bf16* __restrict__ r2_out,
                     float* __restrict__ part, int H, int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  // The tile's r2f, (128 pixels, 64) f32, over x's staging area: the
  // second conv reads only h1 and W2, and this epilogue never reads x.
  float* rs = reinterpret_cast<float*>(smem);
  static_assert((size_t)kTilePix * kC * 4 <= fb::Plan::XS, "tile sums");
  fb::pair_forward(
      x, w1, b1, w2, h1_out, H, W, smem,
      [&](int oy, int ox, size_t pix, int c, float (&v)[8]) {
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] += b2[c + j];
        float4* d = reinterpret_cast<float4*>(r2f + pix * kC + c);
        d[0] = make_float4(v[0], v[1], v[2], v[3]);
        d[1] = make_float4(v[4], v[5], v[6], v[7]);
        if (r2_out)
          *reinterpret_cast<uint4*>(r2_out + pix * kC + c) = srt::pack8(v);
        float* t = rs + (oy * fb::kTW + ox) * kC + c;
#pragma unroll
        for (int j = 0; j < 8; ++j) t[j] = v[j];
      });
  __syncthreads();
  if (threadIdx.x < kC) {
    const int y0 = blockIdx.y * fb::kTH, x0 = blockIdx.x * fb::kTW;
    float s = 0.0f;
    for (int p = 0; p < kTilePix; ++p) {
      const int gy = y0 + p / fb::kTW, gx = x0 + p % fb::kTW;
      if (gy < H && gx < W) s += rs[p * kC + threadIdx.x];
    }
    const size_t tile =
        ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    part[tile * kC + threadIdx.x] = s;
  }
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
    srt::unpack8(reinterpret_cast<const uint4*>(x)[i], xv);
    const float4 r0 = reinterpret_cast<const float4*>(r2f)[2 * i];
    const float4 r1 = reinterpret_cast<const float4*>(r2f)[2 * i + 1];
    const float rv[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) xv[j] = __fadd_rn(xv[j], __fmul_rn(rv[j], qb[j]));
    reinterpret_cast<uint4*>(out)[i] = srt::pack8(xv);
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
    srt::unpack8(reinterpret_cast<const uint4*>(g)[i], gv);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      gv[j] = __fadd_rn(__fmul_rn(gv[j], q[o + j]), dpn[o + j]);
    reinterpret_cast<uint4*>(dr2)[i] = srt::pack8(gv);
  }
}

// B4. grid (ceil(W / 16), ceil(H / 8), B).
__global__ void __launch_bounds__(srt::kThreads)
    rcab_chain_kernel(const bf16* __restrict__ dr2,
                      const bf16* __restrict__ g,
                      const bf16* __restrict__ h1,
                      const bf16* __restrict__ w2t,
                      const bf16* __restrict__ w1t, bf16* __restrict__ dx,
                      bf16* __restrict__ dh1, int H, int W) {
  extern __shared__ __align__(128) unsigned char smem[];
  fb::pair_backward(dr2, 1.0f, g, h1, w2t, w1t, dx, dh1, H, W, smem);
}

int elementwise_blocks(long long nvec) {
  const long long want = (nvec + 255) / 256;
  return (int)(want < (1 << 20) ? want : (1 << 20));
}

}  // namespace

// x, out (B, H, W, 64) bf16 (distinct); w1, w2 (3, 3, 64, 64) bf16; b1,
// b2, bu (64) f32; wd (64, cr), bd (cr), wu (cr, 64) f32, 1 <= cr <= 64.
// Scratch: r2f (B, H, W, 64) f32, part (B, ceil(H / 8) * ceil(W / 16), 64)
// f32, q (B, 64) f32. h1, r2 (B, H, W, 64) bf16, or both null (no
// saving). Three launches (F1, F2, F3). Returns a cudaError_t.
extern "C" int srt_rcab_fwd(const void* x, const void* w1, const void* b1,
                            const void* w2, const void* b2, const void* wd,
                            const void* bd, const void* wu, const void* bu,
                            void* r2f, void* part, void* q, void* out,
                            void* h1, void* r2, int B, int H, int W, int C,
                            int cr, void* stream) {
  if (C != kC || cr < 1 || cr > kC) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = srt::allow_smem(rcab_pair_kernel, fb::Plan::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + fb::kTW - 1) / fb::kTW, (H + fb::kTH - 1) / fb::kTH, B);
  rcab_pair_kernel<<<grid, srt::kThreads, fb::Plan::SMEM, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w1),
      static_cast<const float*>(b1), static_cast<const bf16*>(w2),
      static_cast<const float*>(b2), static_cast<float*>(r2f),
      static_cast<bf16*>(h1), static_cast<bf16*>(r2),
      static_cast<float*>(part), H, W);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  rcab_pool_mlp_kernel<<<B, kSlices * kC, 0, s>>>(
      static_cast<const float*>(part), (int)(grid.x * grid.y),
      (float)H * (float)W, static_cast<const float*>(wd),
      static_cast<const float*>(bd), static_cast<const float*>(wu),
      static_cast<const float*>(bu), cr, static_cast<float*>(q));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long nvec = (long long)B * H * W * (kC / 8);
  rcab_gate_kernel<<<elementwise_blocks(nvec), 256, 0, s>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(r2f),
      static_cast<const float*>(q), static_cast<bf16*>(out), nvec,
      (long long)H * W);
  return (int)cudaGetLastError();
}

// h1, r2, g, dr2, dh1, dx (B, H, W, 64) bf16 (dx distinct from g); w2t,
// w1t (3, 3, 64, 64) bf16 transposed weights; wd, bd, wu, bu as the
// forward. Scratch: part (2 * B * ceil(H * W / 128) * 64 + B * (128 +
// 2 * cr)) f32, q, dpn (B, 64) f32. Writes dr2, dh1 (for the weight
// grads), dx and the f32 MLP grads dwd (64, cr), dbd (cr), dwu (cr, 64),
// dbu (64). Five launches (B1, B2a, B2b, B3, B4).
// Returns a cudaError_t.
extern "C" int srt_rcab_bwd(const void* h1, const void* r2, const void* g,
                            const void* w2t, const void* w1t, const void* wd,
                            const void* bd, const void* wu, const void* bu,
                            void* part, void* q, void* dpn, void* dr2,
                            void* dh1, void* dx, void* dwd, void* dbd,
                            void* dwu, void* dbu, int B, int H, int W, int C,
                            int cr, void* stream) {
  if (C != kC || cr < 1 || cr > kC) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int hw = H * W, nchunks = (hw + kChunk - 1) / kChunk;
  float* part_r2 = static_cast<float*>(part);
  float* part_gr2 = part_r2 + (size_t)B * nchunks * kC;
  rcab_ca_sums_kernel<<<dim3(nchunks, B), 4 * kC, 0, s>>>(
      static_cast<const bf16*>(g), static_cast<const bf16*>(r2), part_r2,
      part_gr2, hw);
  cudaError_t err;
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  float* vec = part_gr2 + (size_t)B * nchunks * kC;
  rcab_ca_bwd_kernel<<<B, kSlices * kC, 0, s>>>(
      part_r2, part_gr2, nchunks, (float)H * (float)W,
      static_cast<const float*>(wd), static_cast<const float*>(bd),
      static_cast<const float*>(wu), static_cast<const float*>(bu), cr,
      static_cast<float*>(q), static_cast<float*>(dpn), vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  rcab_mlp_grads_kernel<<<1, kC, 0, s>>>(
      vec, B, cr, static_cast<float*>(dwd), static_cast<float*>(dbd),
      static_cast<float*>(dwu), static_cast<float*>(dbu));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const long long nvec = (long long)B * hw * (kC / 8);
  rcab_dr2_kernel<<<elementwise_blocks(nvec), 256, 0, s>>>(
      static_cast<const bf16*>(g), static_cast<const float*>(q),
      static_cast<const float*>(dpn), static_cast<bf16*>(dr2), nvec, hw);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = srt::allow_smem(rcab_chain_kernel, fb::Plan::SMEM)) !=
      cudaSuccess)
    return (int)err;
  dim3 grid((W + fb::kTW - 1) / fb::kTW, (H + fb::kTH - 1) / fb::kTH, B);
  rcab_chain_kernel<<<grid, srt::kThreads, fb::Plan::SMEM, s>>>(
      static_cast<const bf16*>(dr2), static_cast<const bf16*>(g),
      static_cast<const bf16*>(h1), static_cast<const bf16*>(w2t),
      static_cast<const bf16*>(w1t), static_cast<bf16*>(dx),
      static_cast<bf16*>(dh1), H, W);
  return (int)cudaGetLastError();
}
