// Bilinear warp of the 5-plane Farnebäck polynomial field — Hopper kernel.
//
// Replaces the TPU kernel avd_tpu/ops/pallas/warp.py:warp_bilinear
// (body _warp_kernel).  Contract kept exactly: sample src [B,5,H,W] at
// (y + dy, x + dx) with the flow planes [B,2,H,W]; the OpenCV in-bounds
// rule 0 <= floor(coord) <= size-2 holds for both axes, and every pixel
// outside it is written as exactly 0 (the caller masks on the same rule).
//
// What bounds it on an H100: bytes.  Per output pixel it reads the flow
// (8 B) and five 2×2 corner sets of the source (20 B once each, the
// neighbours come from L1/L2) and writes 20 B: about 48 B/px against
// ~50 flops/px, far below the card's 20 flop/B balance point.
//
// Design: the TPU kernel's select-shift scan over a displacement bounding
// box existed because XLA's gathers were slow on the TPU.  A GPU gathers
// natively, so this is a direct gather: one thread per (b, y, x), threads
// numbered along W so the flow reads, the output writes and (for smooth
// flow) the corner reads are coalesced.  Out-of-bounds threads only write
// zeros.  Compiled with --fmad=false so the weights and the sum round as
// in the plain PyTorch version.
//
// Source type: float32, or bfloat16 under AVD_FLOW_BF16 (the TPU kernel
// takes both, warp.py:114-122).  The flow and the output stay float32; a
// bf16 tap is widened on load, so the arithmetic is the float32 kernel's
// on the widened field.  bf16 moves 38 B/px instead of 48.  The float32
// instance is the kernel as it was (load() is the identity there).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 5;  // polynomial coefficient planes

__device__ __forceinline__ float load(const float* p) { return *p; }
__device__ __forceinline__ float load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

template <typename T>
__global__ void warp_bilinear_kernel(const T* __restrict__ src,
                                     const float* __restrict__ flow,
                                     float* __restrict__ out,
                                     int64_t total, int H, int W) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (i >= total) return;
  const int64_t plane = static_cast<int64_t>(H) * W;
  const int64_t b = i / plane;
  const int64_t p = i - b * plane;
  const int y = static_cast<int>(p / W);
  const int x = static_cast<int>(p - static_cast<int64_t>(y) * W);

  const float* fl = flow + b * 2 * plane;
  const float fx = static_cast<float>(x) + fl[p];
  const float fy = static_cast<float>(y) + fl[plane + p];
  const float x1 = floorf(fx);
  const float y1 = floorf(fy);
  float* o = out + b * kC * plane + p;
  // NaN flow fails every comparison and lands out of bounds, like the
  // plain version's mask.
  const bool inb = x1 >= 0.f && x1 <= static_cast<float>(W - 2) &&
                   y1 >= 0.f && y1 <= static_cast<float>(H - 2);
  if (!inb) {
#pragma unroll
    for (int c = 0; c < kC; ++c) o[c * plane] = 0.f;
    return;
  }
  const float a = fx - x1;
  const float bb = fy - y1;
  const float w00 = (1.f - bb) * (1.f - a);
  const float w01 = (1.f - bb) * a;
  const float w10 = bb * (1.f - a);
  const float w11 = bb * a;
  const T* s = src + b * kC * plane +
               static_cast<int64_t>(y1) * W + static_cast<int64_t>(x1);
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const T* sc = s + c * plane;
    o[c * plane] = w00 * load(sc) + w01 * load(sc + 1) + w10 * load(sc + W) +
                   w11 * load(sc + W + 1);
  }
}

template <typename T>
int launch(const T* src, const float* flow, float* out, int B, int H, int W,
           void* stream) {
  const int64_t total = static_cast<int64_t>(B) * H * W;
  if (total == 0) return 0;
  constexpr int kThreads = 256;
  const int64_t blocks = (total + kThreads - 1) / kThreads;
  warp_bilinear_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      src, flow, out, total, H, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// src [B,5,H,W] f32, flow [B,2,H,W] f32, out [B,5,H,W] f32, all contiguous
// on the current device; launched on `stream`.  Returns the launch's
// cudaGetLastError() (0 on success).
extern "C" int avd_warp_bilinear(const float* src, const float* flow,
                                 float* out, int B, int H, int W,
                                 void* stream) {
  return launch(src, flow, out, B, H, W, stream);
}

// The same with a bf16 src [B,5,H,W]; flow and out as above.
extern "C" int avd_warp_bilinear_bf16(const __nv_bfloat16* src,
                                      const float* flow, float* out, int B,
                                      int H, int W, void* stream) {
  return launch(src, flow, out, B, H, W, stream);
}
