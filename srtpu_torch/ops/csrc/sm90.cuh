// Hopper (sm_90a) building blocks shared by the port's wgmma engines:
// K2's convolution (conv_sm90.cuh) and the weight grads (wgrad.cu).
//
//  - mbarriers and a ring of them (Ring): a stage's use i waits for the
//    phase (i / n) & 1 of its barrier; a producer waits on the other
//    parity of the stage's "empty" barrier for the previous use to be
//    released;
//  - TMA tile loads (cp.async.bulk.tensor, 2-5 dims) completing on an
//    mbarrier, and the host's tensor-map encoder, taken through
//    cudaGetDriverEntryPoint (no -lcuda);
//  - ldmatrix (plain and transposed) into wgmma's register A operand at
//    the swizzled offsets TMA leaves, and wgmma m64nNk16 (N = 16, 32, 64)
//    bf16 -> f32 with B read from shared memory through a descriptor,
//    N-major or K-major (and at N = 64 A through one too, K-major);
//  - 16-byte packs of 8 bf16 to f32 and back, for elementwise passes.
#pragma once

#include <cooperative_groups.h>
#include <cuda.h>  // CUtensorMap and its enums only: no driver call linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace srt90 {

typedef __nv_bfloat16 bf16;

constexpr int kMaxSmem = 232448;                     // a block's most
constexpr int kSmPool = 233472;                      // an SM's, 1 KB a block

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity ``parity`` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// wgmma fences and waits (it cannot see the asynchronous writes).
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x 16] += A (registers) * B (shared memory; TRANSB 1: N-major, 0:
// K-major)
template <int TRANSB>
__device__ __forceinline__ void wgmma_n16(float (&d)[8],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1, %14;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1),
        "n"(TRANSB));
}

// D[64 x 32] += A (registers) * B (shared memory; TRANSB 1: N-major, 0:
// K-major)
template <int TRANSB>
__device__ __forceinline__ void wgmma_n32(float (&d)[16],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1),
        "n"(TRANSB));
}

// D[64 x 64] += A (registers) * B (shared memory; TRANSB 1: N-major, 0:
// K-major)
template <int TRANSB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1),
        "n"(TRANSB));
}

// D[64 x 64] += A (shared memory, K-major, through a descriptor) * B
// (shared memory; TRANSB 1: N-major, 0: K-major): the SS form, A read by
// the tensor cores straight from the tile TMA left (K7's chained
// kernels, wdsr.cu).
template <int TRANSB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t adesc,
                                             uint64_t bdesc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(adesc), "l"(bdesc), "r"(1), "n"(TRANSB));
}

template <int NA, bool TB>
__device__ __forceinline__ void wgmma_rs(float (&d)[NA / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc) {
  constexpr int TRANSB = TB ? 0 : 1;
  if constexpr (NA == 64) wgmma_n64<TRANSB>(d, a, desc);
  else if constexpr (NA == 32) wgmma_n32<TRANSB>(d, a, desc);
  else wgmma_n16<TRANSB>(d, a, desc);
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// Four 8 x 8 b16 matrices, each transposed: lane i gives the address of
// row i % 8 of matrix i / 8.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The byte offset `off` of a tile TMA wrote with a 128-, 64- or 32-byte
// swizzle (mask 7, 3 or 1): its 16-byte chunk XOR the 128-byte row's
// phase, as the hardware's address bits give it (the tile 1024-aligned).
__device__ __forceinline__ uint32_t swz(uint32_t off, uint32_t mask) {
  return off ^ (((off >> 7) & mask) << 4);
}

// Order this thread's generic-proxy writes to shared memory before later
// async-proxy accesses (a wgmma operand read, a TMA write).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// REFLECT (3x3), one warp: the halo rows, then columns, of a staged
// tile (origin (y0 - 1, x0 - 1), wx x hx pixels of AWP channels, 16-byte
// chunks swizzled as TMA left them) at image row
// or column -1 and H or W take the mirrored pixel (1, H - 2). Both lie
// inside the tile when H, W >= 2.
template <int AWP>
__device__ void mirror_halo(unsigned char* a, int lane, int y0, int x0,
                            int H, int W, int wx, int hx) {
  constexpr int CH = AWP / 8;
  constexpr uint32_t ROW = AWP * 2, MASK = CH - 1;
  const int rows[2] = {y0 == 0 ? 0 : -1, H - y0 + 1 < hx ? H - y0 + 1 : -1};
  const int cols[2] = {x0 == 0 ? 0 : -1, W - x0 + 1 < wx ? W - x0 + 1 : -1};
  auto copy = [&](int dst, int src, int c) {
    *reinterpret_cast<uint4*>(a + swz(dst * ROW + c * 16, MASK)) =
        *reinterpret_cast<const uint4*>(a + swz(src * ROW + c * 16, MASK));
  };
  for (int side = 0; side < 2; ++side) {
    const int y = rows[side], from = side ? y - 2 : y + 2;
    if (y < 0) continue;
    for (int q = lane; q < wx * CH; q += 32)
      copy(y * wx + q / CH, from * wx + q / CH, q % CH);
  }
  __syncwarp();
  for (int side = 0; side < 2; ++side) {
    const int x = cols[side], from = side ? x - 2 : x + 2;
    if (x < 0) continue;
    for (int q = lane; q < hx * CH; q += 32)
      copy(q / CH * wx + x, q / CH * wx + from, q % CH);
  }
}

// n mbarriers, 8 bytes apart from ``bar``, used in turn: use i of the
// ring is stage i % n in its (i / n)-th round.
struct Ring {
  uint32_t bar;
  int n;
  __device__ __forceinline__ uint32_t at(int i) const {
    return bar + 8u * (uint32_t)(i % n);
  }
  __device__ __forceinline__ void init(uint32_t count) const {
    for (int s = 0; s < n; ++s) mbar_init(bar + 8u * s, count);
  }
  // use i's phase has completed (a full or ready barrier)
  __device__ __forceinline__ void wait(int i) const {
    mbar_wait(at(i), (uint32_t)(i / n) & 1u);
  }
  // the previous round's use of i's stage was released (an empty
  // barrier; the first round passes at once)
  __device__ __forceinline__ void wait_free(int i) const {
    mbar_wait(at(i), ((uint32_t)(i / n) & 1u) ^ 1u);
  }
  __device__ __forceinline__ void arrive(int i) const { mbar_arrive(at(i)); }
};

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The driver's tensor-map encoder, looked up once.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

inline CUtensorMapSwizzle swizzle_of(int row_bytes) {
  return row_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
         : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
}

// 8 bf16 (16 bytes) as f32, and back (round to nearest even).
__device__ __forceinline__ void unpack8(uint4 u, float (&f)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(h[i]);
    f[2 * i] = v.x;
    f[2 * i + 1] = v.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[8]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(f[2 * i], f[2 * i + 1]);
  return u;
}

inline uint32_t align1024(uint32_t n) { return (n + 1023u) & ~1023u; }

// The card's SMs, looked up once.
inline int sm_count() {
  static const int n = [] {
    int dev = 0, count = 132;
    if (cudaGetDevice(&dev) == cudaSuccess)
      cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    return count;
  }();
  return n;
}

}  // namespace srt90
