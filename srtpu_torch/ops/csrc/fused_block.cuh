// The tile plan of K8a (srtpu's fused NHWC EDSR resblock, resblock.cu), at
// 64 channels, NHWC bf16, f32 sums: a block owns one 8 x 16 output tile of
// one image, grid (ceil(W / 16), ceil(H / 8), B). The x tile is staged
// with a 2-pixel halo, h1 with a 1-pixel halo, and one conv's weights at a
// time (W1, then W2 over it), all in shared memory; the halo recompute
// costs 1.44x the ideal FLOPs at 8 x 16 tiles. Tensor cores through
// tile_conv.cuh's wmma bf16 tiles, f32 sums.
#pragma once

#include "tile_conv.cuh"

namespace srt {
namespace fused {

constexpr int kC = 64, kTH = 8, kTW = 16;

struct Plan {
  static constexpr int PS = kC + 16;
  static constexpr int WX = kTW + 4;                 // tile + 2-pixel halo
  static constexpr int MF1 = ((kTH + 2) * WX + 15) / 16;  // h1 positions
  static constexpr int MF2 = (kTH * WX + 15) / 16;        // output positions
  static constexpr int NX = MF1 * 16 + 2 * WX + 2;   // x pixels read by conv1
  static constexpr int NH = cmax(MF1 * 16, MF2 * 16 + 2 * WX + 2);
  static constexpr size_t XS = align128((size_t)NX * PS * 2);
  static constexpr size_t HS = align128((size_t)NH * PS * 2);
  static constexpr size_t WS = align128((size_t)9 * kC * kC * 2);
  static constexpr size_t SCR = (size_t)kWarps * 256 * 4;
  static constexpr size_t SMEM = XS + HS + WS + SCR;
};

}  // namespace fused
}  // namespace srt
