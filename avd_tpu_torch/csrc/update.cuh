// The pointwise half of a Farnebäck round at one pixel: the bilinear warp
// of R1's five polynomial planes by the flow, and the normal-equation
// entries M = (g11, g12, g22, h1, h2) of OpenCV's FarnebackUpdateMatrices
// formed from it with the border taper.  warp.cu's update instance writes
// M to device memory; flow_iter.cu forms it straight into its blur tile.
//
// Every product and sum keeps the order of the plain PyTorch composition
// (ops/kernels/warp.py:warp_bilinear_plain, then
// ops/flow.py:update_from_warped).  Compiled with --fmad=false, nothing is
// contracted, so both kernels equal it bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace avd {

constexpr int kPoly = 5;    // polynomial coefficient planes; M has as many
constexpr int kBorder = 5;  // taper band at each edge, in pixels

struct Border {
  float s[kBorder];  // the taper within 5 px of an edge, outermost first
};

// A field's tap, widened to float32 on load (bf16 under AVD_FLOW_BF16).
__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// The taper of one axis at p: the factor of each edge whose band holds p.
// Below 10 px the bands of opposite edges meet and both factors apply, as
// in the plain version's table (ops/flow.py:_border_taper).
__device__ __forceinline__ float edge_scale(int p, int size,
                                            const Border& border) {
  float s = 1.f;
  if (p < kBorder) s = s * border.s[p];
  if (size - 1 - p < kBorder) s = s * border.s[size - 1 - p];
  return s;
}

// The five planes of one image, [5][H][W] at `src` (`plane` = H·W), sampled
// at (fx, fy) → w.  Returns the OpenCV in-bounds rule 0 <= floor(coord) <=
// size-2 on both axes; where it fails, w is exactly 0.  NaN flow fails
// every comparison and lands out of bounds, like the plain version's mask.
template <typename T>
__device__ __forceinline__ bool warp_sample(const T* __restrict__ src,
                                            int64_t plane, int H, int W,
                                            float fx, float fy,
                                            float (&w)[kPoly]) {
  const float x1 = floorf(fx);
  const float y1 = floorf(fy);
  const bool inb = x1 >= 0.f && x1 <= static_cast<float>(W - 2) &&
                   y1 >= 0.f && y1 <= static_cast<float>(H - 2);
  if (!inb) {
#pragma unroll
    for (int c = 0; c < kPoly; ++c) w[c] = 0.f;
    return false;
  }
  const float a = fx - x1;
  const float b = fy - y1;
  const float w00 = (1.f - b) * (1.f - a);
  const float w01 = (1.f - b) * a;
  const float w10 = b * (1.f - a);
  const float w11 = b * a;
  const T* t = src + static_cast<int64_t>(y1) * W + static_cast<int64_t>(x1);
#pragma unroll
  for (int c = 0; c < kPoly; ++c) {
    const T* tc = t + c * plane;
    w[c] = w00 * load(tc) + w01 * load(tc + 1) + w10 * load(tc + W) +
           w11 * load(tc + W + 1);
  }
  return true;
}

// M at one pixel from R0's five values `a`, the warped R1 `w` (0 out of
// bounds), the in-bounds verdict, the flow (dx, dy) and the taper.  The
// averaged quadratic terms fall back to R0's alone out of bounds; the
// cross term carries an extra 1/2 because the stored plane is the full
// cross coefficient.
__device__ __forceinline__ void update_entries(const float (&a)[kPoly],
                                               const float (&w)[kPoly],
                                               bool inb, float dx, float dy,
                                               float taper,
                                               float (&m)[kPoly]) {
  float r4 = inb ? (a[2] + w[2]) * 0.5f : a[2];
  float r5 = inb ? (a[3] + w[3]) * 0.5f : a[3];
  float r6 = inb ? (a[4] + w[4]) * 0.25f : a[4] * 0.5f;
  float r2 = (a[0] - w[0]) * 0.5f + r4 * dx + r6 * dy;
  float r3 = (a[1] - w[1]) * 0.5f + r6 * dx + r5 * dy;
  r2 = r2 * taper;
  r3 = r3 * taper;
  r4 = r4 * taper;
  r5 = r5 * taper;
  r6 = r6 * taper;
  m[0] = r4 * r4 + r6 * r6;  // g11
  m[1] = (r4 + r5) * r6;     // g12
  m[2] = r5 * r5 + r6 * r6;  // g22
  m[3] = r4 * r2 + r6 * r3;  // h1
  m[4] = r6 * r2 + r5 * r3;  // h2
}

}  // namespace avd
