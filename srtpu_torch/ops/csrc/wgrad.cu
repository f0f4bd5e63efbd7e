// W: the weight gradient of a k x k conv (k = 3 or 5), shared by the
// backward passes of K1-K5, K7 and K9d:
//   dW[ky, kx, ci, co] = sum over pixels p of
//                        X[p + (ky - k/2, kx - k/2), ci] * G[p, co],
//   db[co]             = sum over pixels p of G[p, co],
// both f32 sums of bf16 products, X and G NHWC bf16, dW HWIO f32.
//
// Replaces the dW/db halves of srtpu/ops/cs_conv.py: _conv_bwd_kernel
// :452 (the dW part :480-529), _ups_conv_bwd_kernel :917 and
// _trunk_bwd_kernel_mega :1429, and of srtpu/ops/bn_resblock_cs.py:
// _b2_kernel :186 and _b3_kernel :250. The TPU kernels keep dW resident
// in f32 scratch while their grid walks the images in order.
//
// What bounds it on the H100: per pixel it reads (cin + cout) * 2 bytes
// for 2 k^2 cin cout FLOP: 64 -> 64 at 3x3 is 288 FLOP/byte, at the bf16
// ridge (~295); the EDSR trunk's 16 stacked jobs (16 x 16,384 pixels) are
// bound by their 69.5 MB of bytes, the wide and 5x5 shapes by the tensor
// cores. Inside a block the bound is shared memory: at N = 64 each
// m64n64k16 wgmma reads 2 KB of B and its A is 2 KB of ldmatrix, 128 B a
// cycle at the tensor cores' rate.
//
// The engine (sm90.cuh's rings, TMA, ldmatrix and wgmma, as K2's
// conv_sm90.cuh). Per job dW is a GEMM: M x N = (k^2 ci or k^2 co) x (co
// or ci), K = pixels, walked in 8 x 16 pixel tiles (8 k16 steps of one
// tile row each). One operand is shifted by the tap. A shifted tile
// cannot be a wgmma shared-memory descriptor (a tile row of 16 pixels sits
// 16 + k - 1 pixels from the next; a descriptor started at the shifted row
// with its base-offset field set reads wrong values on the card),
// so the shifted operand is wgmma's A, in registers: each warp ldmatrix-es
// (.trans: pixels are rows in shared memory, M is the channels) its 16
// rows of the shifted tile; the unshifted one is B, read from shared
// memory as TMA left it (channels contiguous: the N-major B, 128-, 64- or
// 32-byte swizzle).
//   - cout of 64 and up (and the r = 2 gather, REFLECT): A = X^T, shifted
//     by +tap, M = (tap, ci), N = co. A deep X is walked in 64-channel
//     chunks, one chunk a block.
//   - cout 16, 32, 48 (256 -> 16 at 3x3 and 5x5, 512 -> 32, 512 -> 48,
//     576 -> 32, 128 -> 32, 128 -> 16): A = G^T, shifted by -tap (the taps
//     walked from the far end), with the taps stacked along M: (tap, co),
//     k^2 co rows (144-800); B = X, N = ci. So 256 -> 16 at 5x5 is M = 400
//     rows over N = 256, not N = 16 over K = 65,536 pixels. srtpu's TPU
//     kernel stacks its dy-rolled G blocks the same way where k * c_out <=
//     128 (cs_conv.py:489-496).
// M is cut in 64-row tiles, 3 MT a block (three consumer warpgroups of MT
// = 1-3 each: 96 f32 sums a thread at N = 64), so 64 -> 64 at 3x3 is one
// block's nine taps and X and G are each read once per block; N is 64, 32
// or 16 channels a block. A tile past M is summed from any address and
// not stored: a branch around a wgmma makes ptxas serialize them all, as
// does loading the next step's A while this step's wgmmas run, so each
// k16 step waits for its own wgmmas and the other warpgroups keep the
// tensor cores busy.
//
// A block sums a fixed run of pixel tiles of one job. One producer warp
// keeps a ring of stages (the A tile with its halo, the B tile) full by
// TMA behind mbarriers (full / ready / empty), SAME's zero halo and the
// image edges being the hardware's out-of-bounds fill. Three G warps wait
// for each stage to land, each taking a third of its G pixels: G's scale
// (bf16(gscale * G): the trunk's res_scale and K7's, rounded before the
// product), db (fixed lane and warp order) and, on the border tiles,
// REFLECT's mirrored halo, all in shared memory; then they release the
// stage to the consumers. The control warpgroup (producer, G warps) hands
// its registers to the consumers (setmaxnreg).
//
// The pixel parts of a job are a cluster of up to 8 blocks: each writes
// its f32 sums into its own shared memory, and each rank adds one slice of
// them over the ranks in rank order through distributed shared memory,
// writing dW and db itself. Where a job is split over more than one
// cluster, each writes a partial slot and wgrad_reduce adds the slots in
// order. No float atomics: each dW element is one fixed-order sum, the
// same bits on every call. The split (cluster, clusters) is
// srtpu_torch/ops/wgrad.py:wgrad_parts (its wgrad_workspace sizes every
// caller's slots), a model of the card: the waves the clusters take (it
// holds 15 clusters of 8 blocks at once, not 16), a block's tiles and the
// slots' traffic.
//
// r = 2 gather (K3's dW): G is the fine (B, 2H, 2W, cg) tensor read
// phase-major as cout = 4 cg channels, through a 5-D tensor map (r cg,
// W, r, H, B): a tile's N chunk is one phase (a, b) at coarse pixels.
//
// K6's weight grads (rdn.cu) run here too: X may be a channel prefix of a
// wider tensor (its pixel stride apart from its channels); k = 1 (the
// fusion's dwf); and the pairs mode,
// the C (C + 1) / 2 (layer i, chunk j) 3x3 grads of a dense block as
// jobs of 64 -> 64 in one launch, job i (i + 1) / 2 + j reading X's chunk
// j (the block's buffer) against G's chunk i (the chain's dout) and
// writing its own slot: rdn.py:pack's pair order.
//
// K7's dW1 and dW2 (wdsr.cu) run here at k = 1 too. At k = 1 a chunk of
// A is 192 or 128 channels where they divide its channels (staged as
// sub-tiles of 64), so the three consumer warpgroups each sum an M-tile
// of their own, where a chunk of 64 (one M-tile) would leave two of them
// summing tiles past M (K6's dwf and K7's).

#include "wgrad.cuh"

namespace {

using namespace srt90;

constexpr int kWG = 3;                        // consumer warpgroups
constexpr int kCWarps = 4 * kWG;              // consumer warps
constexpr int kGWarps = 3;                    // G warps
constexpr int kThreads = (kCWarps + 1 + kGWarps) * 32;  // + the producer
// Registers a thread: the launch gives each of the 512 threads 128; the
// control warpgroup (the producer and the G warps) hands back all but 56,
// and the consumers take 152 (3 x 128 x 152 + 128 x 56 = 65,536): 96 f32
// sums at NA = 64 and three M-tiles, A's 12 and the addresses, without
// spilling.
constexpr uint32_t kControlRegs = 56, kConsumerRegs = 152;
constexpr int kTH = 8, kTW = 16;              // a tile: 8 k16 steps of 16
constexpr int kMaxCluster = 8;

struct WParams {
  float* dw;  // (J, nclusters, taps, cin, cout) f32: dW, or partial slots
  float* db;  // (J, nclusters, cout) f32
  int H, W, kk, taps, wx;           // wx = kTW + kk - 1
  int tiles_x, tiles_img, ntiles;   // tiles per image row, image, job
  int cin, cout;
  int ca, aw;           // A's channels; a chunk of them (one a block)
  int nsub;             // a chunk's sub-tiles of AWP channels (k = 1: 1-3)
  uint32_t a_sub;       // bytes: one sub-tile of a stage's A
  int mtiles, mgroups;  // M-tiles of a chunk; blocks of 3 MT over them
  int nchunks;          // N chunks
  int form_g;           // A = G (shifted by -tap), B = X
  int gather, r, cg;    // B from the fine tensor, phase-major
  int reflect;
  float gscale;
  int parts, cluster, nclusters;  // parts = cluster * nclusters a job
  int stages;
  uint32_t a_region, stage;   // bytes: A's part of a stage; a stage
  uint32_t a_bytes, b_bytes;  // bytes a stage's TMA loads write
  uint32_t body;              // the rings, or the sums after them
  int pairs;  // K6: job = (layer i, chunk j), X's chunk j, G's chunk i
};

// bf16(s * v) for 8 bf16 values, rounded to nearest even
__device__ __forceinline__ uint4 scale8(uint4 v, float s) {
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    h[i] = __floats2bfloat162_rn(f.x * s, f.y * s);
  }
  return v;
}

__device__ __forceinline__ void add8(float (&d)[8], uint4 v) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    d[2 * i] += f.x;
    d[2 * i + 1] += f.y;
  }
}

template <uint32_t N>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <uint32_t N>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Named barriers (apart from __syncthreads' 0): 1, every thread of the
// block; 2, the G warps.
__device__ __forceinline__ void block_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kThreads) : "memory");
}

__device__ __forceinline__ void gwarps_sync() {
  asm volatile("bar.sync 2, %0;" ::"n"(kGWarps * 32) : "memory");
}

__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Bytes of the block's f32 sums in shared memory: 3 MT M-tiles of 64 rows
// of NA + 8 floats.
__host__ __device__ constexpr uint32_t red_bytes(int na, int mt) {
  return (uint32_t)kWG * mt * 64 * (na + 8) * 4;
}

// grid = (parts, A chunks * mgroups * nchunks, J); clusters of p.cluster
// blocks along x. Block (part, (chunk * mgroups + mg) * nchunks + nch,
// job) sums tiles [part * T / parts, (part + 1) * T / parts) of the job
// into M-tiles mg * 3 MT .. + 3 MT - 1 of A chunk `chunk` (warpgroup w
// keeps w, w + 3, ..., w + 3 (MT - 1); a tile past the chunk's M is summed
// from any address and not stored: no branch around a wgmma), N channels
// nch * NA .. + NA - 1. NA: 64, 32 or 16 (B's swizzle 128, 64 or 32
// bytes); AWP: A's staged channels (the same three). Warpgroups 0-2 are
// the consumers (kConsumerRegs registers a thread); warpgroup 3 the
// producer warp and the G warps (kControlRegs). K6: K6's launches (no db;
// the pairs mode), kept out of the other instances' code.
template <int NA, int AWP, int MT, bool K6>
__global__ void __launch_bounds__(kThreads, 1)
    wgrad_sm90_kernel(const __grid_constant__ CUtensorMap amap,
                      const __grid_constant__ CUtensorMap bmap,
                      const __grid_constant__ WParams p) {
  constexpr uint32_t AROW = AWP * 2, AMASK = AWP / 8 - 1;
  constexpr uint32_t BROW = NA * 2;
  constexpr int PITCH = NA + 8;  // a row of the block's sums, floats
  constexpr int SLOTS = kWG * MT;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t ring = (smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* const sm = smem_raw + (ring - smem_u32(smem_raw));
  const Ring full{ring + p.body, p.stages};
  const Ring ready{full.bar + 8u * p.stages, p.stages};
  const Ring empty{ready.bar + 8u * p.stages, p.stages};
  float* const red = reinterpret_cast<float*>(sm);  // over the idle rings
  // db: each G warp's 64 sums, then the block's
  float* const dbs = reinterpret_cast<float*>(sm + p.body + 24u * p.stages);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int part = blockIdx.x;
  const int rank = part % p.cluster, cl = part / p.cluster;
  const int nch = blockIdx.y % p.nchunks, mga = blockIdx.y / p.nchunks;
  const int cc = mga / p.mgroups, mg = mga % p.mgroups;
  const int job = blockIdx.z, n0 = nch * NA, h = p.kk / 2;
  const int t0 = (int)((long long)part * p.ntiles / p.parts);
  const int ntl = (int)((long long)(part + 1) * p.ntiles / p.parts) - t0;
  // db comes from the blocks of the first M-group (A = X: G is B) or of
  // the first N chunk (A = G)
  bool db_block = mga == 0 && (!p.form_g || nch == 0);
  if constexpr (K6) db_block = false;
  auto tile_at = [&](int t, int& b, int& y0, int& x0) {
    b = t / p.tiles_img;
    const int rem = t - b * p.tiles_img;
    y0 = rem / p.tiles_x * kTH;
    x0 = rem % p.tiles_x * kTW;
  };

  if (threadIdx.x == 0) {
    full.init(1);
    ready.init(kGWarps);
    empty.init(kCWarps);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kCWarps) {
    regs_dec<kControlRegs>();
    if (warp == kCWarps) {
      // The producer: the stages' TMA loads, in tile order. Pairs: X's and
      // G's channel offsets, and one job in the tensor maps.
      if (lane == 0) {
        int xoff = 0, goff = 0, tjob = job;
        if constexpr (K6) {
          if (p.pairs) {
            int i = 0, j = job;
            while (j > i) j -= ++i;
            xoff = 64 * j;
            goff = 64 * i;
            tjob = 0;
          }
        }
        for (int i = 0; i < ntl; ++i) {
          int b, y0, x0;
          tile_at(t0 + i, b, y0, x0);
          empty.wait_free(i);
          const uint32_t st = ring + (uint32_t)(i % p.stages) * p.stage;
          mbar_expect_tx(full.at(i), p.a_bytes + p.b_bytes);
          if constexpr (K6) {  // k = 1: a chunk of A may be sub-tiles
            for (int q = 0; q < p.nsub; ++q)
              tma_load_5d(st + q * p.a_sub, &amap, full.at(i),
                          xoff + cc * p.aw + q * AWP, x0 - h, y0 - h, b,
                          tjob);
          } else {
            tma_load_5d(st, &amap, full.at(i), xoff + cc * p.aw, x0 - h,
                        y0 - h, b, tjob);
          }
          if (p.gather) {
            const int ab = n0 / p.cg;  // the chunk's phase (a, b)
            tma_load_5d(st + p.a_region, &bmap, full.at(i),
                        ab % p.r * p.cg + n0 % p.cg, x0, ab / p.r, y0, b);
          } else {
            tma_load_5d(st + p.a_region, &bmap, full.at(i), goff + n0, x0,
                        y0, b, tjob);
          }
        }
      }
      __syncwarp();
    } else {
      // The G warps: scale, mirror, db (each a third of the stage's
      // pixels), then hand the stage on. G's pixels: the B tile (A = X),
      // or the A tile with its halo, db summing its interior (A = G).
      const int gw = warp - kCWarps - 1;
      const uint32_t g_off = p.form_g ? 0u : p.a_region;
      const int gpix = p.form_g ? (kTH + p.kk - 1) * p.wx : kTH * kTW;
      const int gch = p.form_g ? AWP / 8 : NA / 8;  // 16-byte chunks a pixel
      const uint32_t gmask = gch - 1, grow = gch * 16;
      // the lane's chunk stays the same as it steps: 96 is a multiple of
      // gch (2, 4 or 8)
      const int chunk = lane % gch, q0 = (gw * 32 + lane) / gch;
      const int step = kGWarps * 32 / gch;
      const bool scale = p.gscale != 1.0f;
      float dsum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int i = 0; i < ntl; ++i) {
        full.wait(i);
        unsigned char* const gst =
            sm + (uint32_t)(i % p.stages) * p.stage + g_off;
        if (scale || db_block) {
#pragma unroll 4
          for (int q = q0; q < gpix; q += step) {
            uint4* v = reinterpret_cast<uint4*>(
                gst + swz(q * grow + chunk * 16, gmask));
            uint4 val = *v;
            if (scale) {
              val = scale8(val, p.gscale);
              *v = val;
            }
            const int oy = q / p.wx - h, ox = q % p.wx - h;
            if (db_block && (!p.form_g || ((unsigned)oy < (unsigned)kTH &&
                                           (unsigned)ox < (unsigned)kTW)))
              add8(dsum, val);
          }
          if (scale) fence_proxy_async();  // before the wgmmas read it
        }
        if (p.reflect && gw == 0) {
          int b, y0, x0;
          tile_at(t0 + i, b, y0, x0);
          mirror_halo<AWP>(sm + (uint32_t)(i % p.stages) * p.stage, lane, y0,
                           x0, p.H, p.W, p.wx, kTH + p.kk - 1);
        }
        __syncwarp();
        if (lane == 0) ready.arrive(i);
      }
      if (db_block) {
        // the lanes of one chunk, then the G warps, added in a fixed order
        for (int o = 16; o >= gch; o >>= 1)
#pragma unroll
          for (int e = 0; e < 8; ++e)
            dsum[e] += __shfl_xor_sync(0xffffffffu, dsum[e], o);
        if (lane < gch)
#pragma unroll
          for (int e = 0; e < 8; ++e) dbs[(gw + 1) * 64 + lane * 8 + e] = dsum[e];
        gwarps_sync();
        if (gw == 0)
          for (int c = lane; c < 64; c += 32)
            dbs[c] = (dbs[64 + c] + dbs[128 + c]) + dbs[192 + c];
      }
    }
    block_sync();    // the consumers write their sums over the rings
    cluster_sync();  // every rank's sums are in place
    cluster_sync();  // and have been read
    return;
  }

  // The consumers: warpgroup wg keeps M-tiles wg, wg + 3, ... of the
  // block; warp wq of it rows 16 wq .. 16 wq + 15 of each.
  regs_inc<kConsumerRegs>();
  const int wg = warp >> 2, wq = warp & 3;
  // B descriptors, one atom an instruction: N-major, rows of NA channels,
  // 8-row groups 8 rows apart (SBO), swizzle 128 / 64 / 32 bytes (layout
  // 1 / 2 / 3) as NA is 64 / 32 / 16
  constexpr uint64_t desc_hi =
      ((uint64_t)1 << 16) | ((uint64_t)((8 * BROW) >> 4) << 32) |
      ((uint64_t)(BROW == 128 ? 1 : BROW == 64 ? 2 : 3) << 62);
  // The lane's ldmatrix row: matrix lane / 8 is (M rows 0-7 or 8-15 of the
  // warp's 16) x (pixels 0-7 or 8-15 of the tile row).
  const int mhalf = (lane >> 3) & 1, ox = (lane >> 4) * 8 + (lane & 7);
  float acc[MT][NA / 2];
  uint32_t aoff[MT];  // the lane's A offset at tile row 0
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int mt = mg * SLOTS + wg + kWG * i;
    const int m = mt * 64 + 16 * wq + 8 * mhalf;
    int tap = m / p.aw;
    const int c = m - tap * p.aw;
    if (tap >= p.taps) tap = p.taps - 1;  // rows past M: any address
    int ty = tap / p.kk, tx = tap - ty * p.kk;
    if (p.form_g) {  // A = G[q - tap]: the tile's taps from the far end
      ty = p.kk - 1 - ty;
      tx = p.kk - 1 - tx;
    }
    if constexpr (K6)  // the row's sub-tile of A's chunk
      aoff[i] = (uint32_t)(c / AWP) * p.a_sub +
                (uint32_t)(ty * p.wx + ox + tx) * AROW +
                (uint32_t)((c % AWP) >> 3) * 16;
    else
      aoff[i] =
          (uint32_t)(ty * p.wx + ox + tx) * AROW + (uint32_t)(c >> 3) * 16;
#pragma unroll
    for (int j = 0; j < NA / 2; ++j) acc[i][j] = 0.0f;
  }
  const uint32_t row_step = (uint32_t)p.wx * AROW;  // one tile row
  // A's registers for one k16 step. Loading the next step's while this
  // step's wgmmas run would redefine a wgmma's input registers inside its
  // pipeline stage, which ptxas answers by serializing every wgmma: each
  // step waits for its own instead, and the other two warpgroups keep the
  // tensor cores busy meanwhile.
  uint32_t a[MT][4];
  for (int it = 0; it < ntl; ++it) {
    ready.wait(it);
    const uint32_t a_base = ring + (uint32_t)(it % p.stages) * p.stage;
    const uint32_t b_base = a_base + p.a_region;
#pragma unroll
    for (int ks = 0; ks < kTH; ++ks) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
        ldmatrix_x4_trans(a[i], a_base + swz(aoff[i] + ks * row_step, AMASK));
#pragma unroll
      for (int i = 0; i < MT; ++i) fence_acc(acc[i]);
      wgmma_fence();
      const uint32_t baddr = b_base + ks * 16 * BROW;
      const uint64_t desc = desc_hi | ((baddr & 0x3FFFFu) >> 4);
#pragma unroll
      for (int i = 0; i < MT; ++i) wgmma_rs<NA, false>(acc[i], a[i], desc);
      wgmma_commit();
#pragma unroll
      for (int i = 0; i < MT; ++i) fence_acc(acc[i]);
      wgmma_wait<0>();
    }
    __syncwarp();
    if (lane == 0) empty.arrive(it);  // the stage is read
    __syncwarp();
  }

  // Every load was consumed: once the block meets, the rings are idle.
  // The sums go to the block's (3 MT * 64) x NA f32 tile in shared memory;
  // register d[4 q + 2 hh + e] of an M-tile is row 16 wq + lane / 4 + 8 hh,
  // column 8 q + 2 (lane % 4) + e.
  block_sync();
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int row0 = (wg + kWG * i) * 64 + 16 * wq + (lane >> 2);
#pragma unroll
    for (int q = 0; q < NA / 8; ++q)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(red + (row0 + 8 * hh) * PITCH + 8 * q +
                                   2 * (lane & 3)) =
            make_float2(acc[i][4 * q + 2 * hh], acc[i][4 * q + 2 * hh + 1]);
  }

  // Rank r adds slice r of the cluster's rows over ranks 0, 1, ... in
  // order (four columns a thread, every rank's load in flight at once) and
  // writes it: to dW, or to the cluster's partial slot.
  cluster_sync();
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const float* src[kMaxCluster];
#pragma unroll
  for (int q = 0; q < kMaxCluster; ++q)
    src[q] = cluster.map_shared_rank(red, q < p.cluster ? q : 0);
  const size_t slot = (size_t)job * p.nclusters + cl;
  float* const out_w = p.dw + slot * p.taps * p.cin * p.cout;
  constexpr int kC = kCWarps * 32, Q = NA / 4;  // float4s a row
  const int total = SLOTS * 64 * Q;
  const int e1 = (rank + 1) * total / p.cluster;
  for (int e = rank * total / p.cluster + threadIdx.x; e < e1; e += kC) {
    const int row = e / Q, col = (e - row * Q) * 4;
    const int mt = mg * SLOTS + (row >> 6);
    const int m = mt * 64 + (row & 63);
    const int tap = m / p.aw, c = m - tap * p.aw;
    if (mt >= p.mtiles || tap >= p.taps || cc * p.aw + c >= p.ca) continue;
    float4 v[kMaxCluster];
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q)
      if (q < p.cluster)
        v[q] = *reinterpret_cast<const float4*>(src[q] + row * PITCH + col);
    float4 s = v[0];
#pragma unroll
    for (int q = 1; q < kMaxCluster; ++q)
      if (q < p.cluster) {
        s.x += v[q].x;
        s.y += v[q].y;
        s.z += v[q].z;
        s.w += v[q].w;
      }
    if (p.form_g) {  // columns are input channels
      float* o = out_w + ((size_t)tap * p.cin + n0 + col) * p.cout + c;
      o[0] = s.x;
      o[p.cout] = s.y;
      o[2 * p.cout] = s.z;
      o[3 * p.cout] = s.w;
    } else {
      *reinterpret_cast<float4*>(
          out_w + ((size_t)tap * p.cin + cc * p.aw + c) * p.cout + n0 + col) =
          s;
    }
  }
  if (db_block && rank == 0) {
    const int n = p.form_g ? p.aw : NA;
    const int c0 = p.form_g ? 0 : n0;
    for (int c = threadIdx.x; c < n; c += kC) {
      float s = 0.0f;
      for (int q = 0; q < p.cluster; ++q)
        s += cluster.map_shared_rank(dbs, q)[c];
      p.db[slot * p.cout + c0 + c] = s;
    }
  }
  cluster_sync();  // no block leaves while its sums are being read
}

// out[j, i] = sum over c of ws[j, c, i], c in order (n values a slot),
// for dW (n = nw) and db (n = nb) in one launch.
__global__ void wgrad_reduce(const float* __restrict__ ws_w,
                             const float* __restrict__ ws_b,
                             float* __restrict__ dw, float* __restrict__ db,
                             int nslots, long long nw, long long nb, int J) {
  const long long tw = nw * J, total = tw + nb * J;
  for (long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += (long long)gridDim.x * blockDim.x) {
    const bool w = idx < tw;
    const long long n = w ? nw : nb, k = w ? idx : idx - tw;
    const long long j = k / n, i = k % n;
    const float* s = (w ? ws_w : ws_b) + j * nslots * n + i;
    float v = 0.0f;
    for (int c = 0; c < nslots; ++c) v += s[c * n];
    (w ? dw : db)[k] = v;
  }
}

// A 5-D bf16 tensor map, box `box`, swizzle the box's inner bytes.
cudaError_t encode5(CUtensorMap* map, const void* base, const cuuint64_t* dim,
                    const cuuint64_t* stride_bytes, const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  if (!encode) return cudaErrorNotSupported;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5,
                const_cast<void*>(base), dim, stride_bytes, box, ones,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(box[0] * 2),
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// An NHWC tensor of J jobs (job_stride elements apart) at pixel stride ps
// as (C, W, H, B, J), a box of bc channels x bw x bh pixels.
cudaError_t encode_nhwc(CUtensorMap* map, const void* t, int C, int ps, int W,
                        int H, int B, int J, long long job_stride, int bc,
                        int bw, int bh) {
  const cuuint64_t dim[5] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                             (cuuint64_t)B, (cuuint64_t)J};
  const cuuint64_t str[4] = {(cuuint64_t)ps * 2, (cuuint64_t)W * ps * 2,
                             (cuuint64_t)H * W * ps * 2,
                             (cuuint64_t)job_stride * 2};
  const cuuint32_t box[5] = {(cuuint32_t)bc, (cuuint32_t)bw, (cuuint32_t)bh,
                             1, 1};
  return encode5(map, t, dim, str, box);
}

// The fine (B, r H, r W, cg) tensor as (r cg, W, r, H, B): a box is bc
// channels of one phase (a, b) at a tile's coarse pixels.
cudaError_t encode_fine(CUtensorMap* map, const void* g, int r, int cg, int W,
                        int H, int B, int bc) {
  const cuuint64_t row = (cuuint64_t)r * W * cg * 2;  // one fine row
  const cuuint64_t dim[5] = {(cuuint64_t)r * cg, (cuuint64_t)W,
                             (cuuint64_t)r, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t str[4] = {(cuuint64_t)r * cg * 2, row, r * row,
                             (cuuint64_t)H * r * row};
  const cuuint32_t box[5] = {(cuuint32_t)bc, kTW, 1, kTH, 1};
  return encode5(map, g, dim, str, box);
}

template <int NA, int AWP, int MT, bool K6 = false>
cudaError_t launch(const CUtensorMap& amap, const CUtensorMap& bmap,
                   WParams p, int J, int ychunks, cudaStream_t s) {
  auto kernel = wgrad_sm90_kernel<NA, AWP, MT, K6>;
  static const cudaError_t allowed = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (allowed != cudaSuccess) return allowed;
  const uint32_t red = red_bytes(NA, MT);
  const uint32_t tail = 24 * 8 + 1024;  // barriers (at most 8 stages), db
  p.stages = (int)((kMaxSmem - 1024 - tail) / p.stage);
  if (p.stages > 6) p.stages = 6;
  if (p.stages < 2) return cudaErrorInvalidConfiguration;
  p.body = p.stages * p.stage > red ? p.stages * p.stage : red;
  const int smem = 1024 + p.body + tail;
  if (smem > kMaxSmem) return cudaErrorInvalidConfiguration;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.parts, ychunks, J);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = p.cluster;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, amap, bmap, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// The instances a chunk width can reach: aw 48 or 64 has 7 or more
// M-tiles (AWP 64, MT 3); aw 32, 5 (3x3: MT 2) or 13 (5x5: MT 3); aw 16,
// 3 (MT 1) or 7 (MT 3). K6's (NA = AWP = 64): its pairs (MT 3) and its
// dwf at 1x1 (one M-tile: MT 1).
template <int NA>
cudaError_t launch_awp(int awp, int mt, const CUtensorMap& amap,
                       const CUtensorMap& bmap, const WParams& p, int J,
                       int ychunks, cudaStream_t s) {
  if (awp == 64) return launch<NA, 64, 3>(amap, bmap, p, J, ychunks, s);
  if (awp == 32)
    return mt == 2 ? launch<NA, 32, 2>(amap, bmap, p, J, ychunks, s)
                   : launch<NA, 32, 3>(amap, bmap, p, J, ychunks, s);
  return mt == 1 ? launch<NA, 16, 1>(amap, bmap, p, J, ychunks, s)
                 : launch<NA, 16, 3>(amap, bmap, p, J, ychunks, s);
}

}  // namespace

namespace srt90 {

cudaError_t wgrad(const WgradArgs& a, cudaStream_t s) {
  const int k = a.k, cin = a.cin, cout = a.cout, B = a.B, H = a.H, W = a.W;
  const int J = a.J;
  const int r = a.r < 1 ? 1 : a.r;
  const int cg = cout / (r * r);
  const int xps = a.xps ? a.xps : cin, xch = a.xch ? a.xch : cin;
  const bool k6 = !a.db;  // K6's launches: no bias grad
  const int gch = a.gch ? a.gch : cout;
  int pairs_c = 0;  // pairs: the block's C, J = C (C + 1) / 2
  while (a.pairs && pairs_c * (pairs_c + 1) / 2 < J) ++pairs_c;
  if ((k != 1 && k != 3 && k != 5) || cin <= 0 || cout <= 0 || cin % 16 ||
      cout % 16 || B <= 0 || H <= 0 || W <= 0 || J <= 0 || J > 65535 ||
      a.cluster < 1 || a.cluster > kMaxCluster || a.nclusters < 1 ||
      xch < cin || xps < xch || xps % 8 || gch < cout || gch % 8 ||
      (r > 1 && (cout % (r * r) || cg % 16 || J != 1 || gch != cout)) ||
      (a.reflect && (k != 3 || cin != 64 || cout % 64 || r > 1 || H < 2 ||
                     W < 2)) ||
      (k == 1 && (r > 1 || a.reflect || cin % 64 || cout % 64 || !k6)) ||
      (a.pairs && !k6) ||
      (a.pairs && (cin != 64 || cout != 64 || r > 1 || a.reflect ||
                   pairs_c * (pairs_c + 1) / 2 != J ||
                   xch < 64 * pairs_c || gch < 64 * pairs_c)))
    return cudaErrorInvalidValue;
  WParams p = {};
  p.H = H;
  p.W = W;
  p.kk = k;
  p.taps = k * k;
  p.wx = kTW + k - 1;
  p.tiles_x = (W + kTW - 1) / kTW;
  p.tiles_img = p.tiles_x * ((H + kTH - 1) / kTH);
  p.ntiles = B * p.tiles_img;
  p.cin = cin;
  p.cout = cout;
  p.form_g = cout <= 48 && r == 1;
  p.gather = r > 1;
  p.r = r;
  p.cg = cg;
  p.reflect = a.reflect;
  p.pairs = a.pairs;
  p.gscale = a.gscale;
  p.cluster = a.cluster;
  p.nclusters = a.nclusters;
  p.parts = a.cluster * a.nclusters;
  const int hx = kTH + k - 1;
  const bool direct = a.nclusters == 1;
  p.dw = static_cast<float*>(direct ? a.dw : a.ws_w);
  p.db = k6 ? nullptr : static_cast<float*>(direct ? a.db : a.ws_b);
  // the tensor maps' jobs: J, or one (pairs: the jobs are channel offsets)
  const int mj = a.pairs ? 1 : J;
  const long long xj = mj > 1 ? a.x_stride : (long long)B * H * W * xps;
  const long long gj = mj > 1 ? a.g_stride : (long long)B * H * W * gch;
  // A: the shifted tensor's tile and halo, aw channels a block; B: the
  // other's tile, NA channels
  p.ca = p.form_g ? cout : cin;
  // A in chunks of 64 channels; at k = 1 (one tap: a 64-channel chunk
  // is one M-tile) of 192 or 128 where they divide it, so that the three
  // consumer warpgroups each sum an M-tile of their own
  p.aw = k == 1 ? (p.ca % 192 == 0 ? 192 : p.ca % 128 == 0 ? 128 : 64)
                : (p.ca <= 64 ? p.ca : 64);
  const int awp = p.aw <= 16 ? 16 : p.aw <= 32 ? 32 : 64;
  p.nsub = (p.aw + awp - 1) / awp;
  p.mtiles = (p.taps * p.aw + 63) / 64;
  // M-tiles a warpgroup keeps: as few as hold the chunk's, at most 3
  const int mt = p.mtiles >= 7 ? 3 : (p.mtiles + kWG - 1) / kWG;
  p.mgroups = (p.mtiles + kWG * mt - 1) / (kWG * mt);
  const int nb = p.form_g ? cin : cout;
  const int fit = p.gather ? cg : nb;  // NA divides both
  const int na = nb % 64 == 0 && fit % 64 == 0   ? 64
                 : nb % 32 == 0 && fit % 32 == 0 ? 32
                                                 : 16;
  p.nchunks = nb / na;
  const int ychunks = (p.ca + p.aw - 1) / p.aw * p.mgroups * p.nchunks;
  p.a_sub = align1024((uint32_t)awp * 2 * p.wx * hx);
  p.a_bytes = (uint32_t)p.nsub * awp * 2 * p.wx * hx;
  p.b_bytes = (uint32_t)na * 2 * kTH * kTW;
  CUtensorMap amap, bmap;
  cudaError_t err =
      p.form_g
          ? encode_nhwc(&amap, a.g, cout, gch, W, H, B, mj, gj, awp, p.wx, hx)
          : encode_nhwc(&amap, a.x, xch, xps, W, H, B, mj, xj, awp, p.wx, hx);
  if (err == cudaSuccess)
    err = p.gather ? encode_fine(&bmap, a.g, r, cg, W, H, B, na)
          : p.form_g
              ? encode_nhwc(&bmap, a.x, xch, xps, W, H, B, mj, xj, na, kTW,
                            kTH)
              : encode_nhwc(&bmap, a.g, gch, gch, W, H, B, mj, gj, na, kTW,
                            kTH);
  if (err != cudaSuccess) return err;
  p.a_region = p.nsub * p.a_sub;
  p.stage = p.a_region + align1024(p.b_bytes);
  if (ychunks > 65535 || (p.nsub > 1 && (p.ca % p.aw || !k6)))
    return cudaErrorInvalidValue;
  if (k6 && (na != 64 || awp != 64)) return cudaErrorInvalidValue;
  err = k6 ? (mt == 1 ? launch<64, 64, 1, true>(amap, bmap, p, J, ychunks, s)
                      : launch<64, 64, 3, true>(amap, bmap, p, J, ychunks, s))
        : na == 64 ? launch_awp<64>(awp, mt, amap, bmap, p, J, ychunks, s)
        : na == 32 ? launch_awp<32>(awp, mt, amap, bmap, p, J, ychunks, s)
                   : launch_awp<16>(awp, mt, amap, bmap, p, J, ychunks, s);
  if (err != cudaSuccess || direct) return err;
  const long long nw = (long long)k * k * cin * cout, nb_ = p.db ? cout : 0;
  const long long want = ((nw + nb_) * J + 255) / 256;
  wgrad_reduce<<<(int)(want < 4096 ? want : 4096), 256, 0, s>>>(
      static_cast<const float*>(a.ws_w), static_cast<const float*>(a.ws_b),
      static_cast<float*>(a.dw), static_cast<float*>(a.db), a.nclusters, nw,
      nb_, J);
  return cudaGetLastError();
}

}  // namespace srt90

// J jobs; job j reads x + j * x_stride (B, H, W, cin) bf16 and
// g + j * g_stride: (B, H, W, cout) bf16, or with r > 1 (J = 1) the fine
// (B, r H, r W, cout / r^2) bf16 read phase-major. Writes dw (J, k, k,
// cin, cout) f32 and db (J, cout) f32. k = 3 or 5; cin and cout multiples
// of 16; r > 1 needs cout / r^2 a multiple of 16; reflect != 0 (REFLECT
// boundaries) k = 3, cin = 64, cout a multiple of 64, r = 1, H, W >= 2.
// The pixel tiles of a job are summed by cluster * nclusters blocks
// (srtpu_torch/ops/wgrad.py:wgrad_parts; cluster <= 8): with nclusters > 1,
// ws_w (J, nclusters, k k cin cout) and ws_b (J, nclusters, cout) f32 hold
// the clusters' partials, else they are not read. Returns a cudaError_t.
extern "C" int srt_conv_wgrad(const void* x, const void* g, void* ws_w,
                              void* ws_b, void* dw, void* db, int J,
                              long long x_stride, long long g_stride, int B,
                              int H, int W, int cin, int cout, int r,
                              float gscale, int cluster, int nclusters, int k,
                              int reflect, void* stream) {
  if (k != 3 && k != 5) return (int)cudaErrorInvalidValue;
  srt90::WgradArgs a = {};
  a.x = x;
  a.g = g;
  a.ws_w = ws_w;
  a.ws_b = ws_b;
  a.dw = dw;
  a.db = db;
  a.J = J;
  a.x_stride = x_stride;
  a.g_stride = g_stride;
  a.B = B;
  a.H = H;
  a.W = W;
  a.cin = cin;
  a.cout = cout;
  a.r = r;
  a.gscale = gscale;
  a.cluster = cluster;
  a.nclusters = nclusters;
  a.k = k;
  a.reflect = reflect;
  return (int)srt90::wgrad(a, static_cast<cudaStream_t>(stream));
}
