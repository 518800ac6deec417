// Bilinear warp of the 5-plane Farnebäck polynomial field — Hopper kernel,
// and the same warp with a solver round's update as its epilogue.
//
// Replaces the TPU kernel avd_tpu/ops/pallas/warp.py:warp_bilinear
// (body _warp_kernel).  Contract kept exactly: sample src [B,5,H,W] at
// (y + dy, x + dx) with the flow planes [B,2,H,W]; the OpenCV in-bounds
// rule 0 <= floor(coord) <= size-2 holds for both axes, and every pixel
// outside it is written as exactly 0 (the caller masks on the same rule).
//
// The update instance (kUpdate) goes on from the warped R1 to the
// pointwise normal equations of the round, in the order of the plain
// PyTorch composition update_from_warped(R0, warp(R1, flow), flow)
// (update.cuh, shared with flow_iter.cu): it also reads R0 [B,5,H,W] and
// writes M [B,5,H,W] = (g11, g12, g22, h1, h2) in place of the warped
// field, which never reaches device memory.  On the default path each
// solver round is this launch and then blur+solve.
//
// What bounds it on an H100: bytes.  Per output pixel the warp reads the
// flow (8 B) and five 2×2 corner sets of the source (20 B once each, the
// neighbours come from L1/L2) and writes 20 B: about 48 B/px against ~50
// flops/px, far below the card's 20 flop/B balance point.  The update
// instance adds R0's five planes (20 B) and about 30 flops: 68 B/px.
//
// Design: the TPU kernel's select-shift scan over a displacement bounding
// box existed because XLA's gathers were slow on the TPU.  A GPU gathers
// natively, so this is a direct gather: one thread per (b, y, x), 256 a
// block, threads numbered along W so the flow and R0 reads, the output
// writes and (for smooth flow) the corner reads are coalesced.
// Out-of-bounds threads gather nothing.  Compiled with --fmad=false so the
// weights, the sums and the update round as in the plain PyTorch version:
// both instances equal it bit for bit.
//
// Field type: float32, or bfloat16 under AVD_FLOW_BF16 (the TPU kernel
// takes both, warp.py:114-122) for src and, in the update instance, R0
// too.  The flow and the output stay float32; a bf16 tap is widened on
// load, so the arithmetic is the float32 kernel's on the widened field.
// bf16 moves 38 B/px instead of 48 (update: 48 instead of 68).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "update.cuh"

namespace {

using namespace avd;

template <typename T, bool kUpdate>
__global__ void warp_bilinear_kernel(const T* __restrict__ src,
                                     const float* __restrict__ flow,
                                     const T* __restrict__ r0,
                                     float* __restrict__ out,
                                     int64_t total, int H, int W,
                                     Border border) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= total) return;
  const int64_t plane = static_cast<int64_t>(H) * W;
  const int64_t b = i / plane;
  const int64_t p = i - b * plane;
  const int y = static_cast<int>(p / W);
  const int x = static_cast<int>(p - static_cast<int64_t>(y) * W);

  const float* fl = flow + b * 2 * plane;
  const float dx = fl[p];
  const float dy = fl[plane + p];
  float w[kPoly];
  const bool inb = warp_sample(src + b * kPoly * plane, plane, H, W,
                               static_cast<float>(x) + dx,
                               static_cast<float>(y) + dy, w);
  float* o = out + b * kPoly * plane + p;
  if constexpr (kUpdate) {
    const T* a0 = r0 + b * kPoly * plane + p;
    float a[kPoly];
#pragma unroll
    for (int c = 0; c < kPoly; ++c) a[c] = load(a0 + c * plane);
    float m[kPoly];
    update_entries(a, w, inb, dx, dy,
                   edge_scale(y, H, border) * edge_scale(x, W, border), m);
#pragma unroll
    for (int c = 0; c < kPoly; ++c) o[c * plane] = m[c];
  } else {
#pragma unroll
    for (int c = 0; c < kPoly; ++c) o[c * plane] = w[c];
  }
}

template <typename T, bool kUpdate>
int launch(const T* src, const float* flow, const T* r0, float* out, int B,
           int H, int W, const Border& border, void* stream) {
  const int64_t total = static_cast<int64_t>(B) * H * W;
  if (total == 0) return 0;
  constexpr int kThreads = 256;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  warp_bilinear_kernel<T, kUpdate><<<static_cast<unsigned>(blocks), kThreads,
                                     0, static_cast<cudaStream_t>(stream)>>>(
      src, flow, r0, out, total, H, W, border);
  return static_cast<int>(cudaGetLastError());
}

Border border_of(const float* s) {
  Border bd;
  for (int i = 0; i < kBorder; ++i) bd.s[i] = s[i];
  return bd;
}

}  // namespace

// src [B,5,H,W] f32, flow [B,2,H,W] f32, out [B,5,H,W] f32, all contiguous
// on the current device; launched on `stream`.  Returns the launch's
// cudaGetLastError() (0 on success).
extern "C" int avd_warp_bilinear(const float* src, const float* flow,
                                 float* out, int B, int H, int W,
                                 void* stream) {
  return launch<float, false>(src, flow, nullptr, out, B, H, W, Border{},
                              stream);
}

// The same with a bf16 src [B,5,H,W]; flow and out as above.
extern "C" int avd_warp_bilinear_bf16(const __nv_bfloat16* src,
                                      const float* flow, float* out, int B,
                                      int H, int W, void* stream) {
  return launch<__nv_bfloat16, false>(src, flow, nullptr, out, B, H, W,
                                      Border{}, stream);
}

// The warp with the update epilogue: r0, r1 [B,5,H,W] f32 and flow
// [B,2,H,W] f32 → M [B,5,H,W] f32, all contiguous on the current device,
// H and W at least 2; `border` holds the five taper factors, outermost
// pixel first.  Launched on `stream`; returns cudaGetLastError().
extern "C" int avd_warp_update(const float* r0, const float* r1,
                               const float* flow, float* out, int B, int H,
                               int W, const float* border, void* stream) {
  return launch<float, true>(r1, flow, r0, out, B, H, W, border_of(border),
                             stream);
}

// The same with bf16 r0 and r1; flow and out as above.
extern "C" int avd_warp_update_bf16(const __nv_bfloat16* r0,
                                    const __nv_bfloat16* r1,
                                    const float* flow, float* out, int B,
                                    int H, int W, const float* border,
                                    void* stream) {
  return launch<__nv_bfloat16, true>(r1, flow, r0, out, B, H, W,
                                     border_of(border), stream);
}
