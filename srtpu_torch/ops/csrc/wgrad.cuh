// The weight-grad engine's host entry (wgrad.cu), for the kernels that
// launch it from C++: srt_conv_wgrad (every model's weight grads) and
// K6's (rdn.cu: the fusion's dwf at k = 1, the dense layers' pairs).
#pragma once

#include "sm90.cuh"

namespace srt90 {

// J jobs; job j reads x + j x_stride, (B, H, W, xps) bf16 of which its
// first xch >= cin channels are mapped (0: cin for both), and g + j
// g_stride, (B, H, W, gch) bf16 (0: cout), or with r > 1 (J = 1) the fine
// (B, r H, r W, cout / r^2) read phase-major. Writes dw (J, k, k, cin,
// cout) f32 and, unless db is null, db (J, cout) f32. k = 1, 3 or 5 (1:
// cin and cout multiples of 64). pairs: J = C (C + 1) / 2 jobs of cin =
// cout = 64, job i (i + 1) / 2 + j on x's channels [64 j, + 64) and g's
// [64 i, + 64) (xch and gch at least 64 C). The rest as srt_conv_wgrad.
struct WgradArgs {
  const void* x;
  const void* g;
  void* ws_w;
  void* ws_b;
  void* dw;
  void* db;
  int J;
  long long x_stride, g_stride;
  int B, H, W, cin, cout, r;
  float gscale;
  int cluster, nclusters, k, reflect;
  int xps, xch, gch;
  int pairs;
};

cudaError_t wgrad(const WgradArgs& a, cudaStream_t s);

}  // namespace srt90
