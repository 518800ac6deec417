// One whole Farnebäck refinement round in one kernel — Hopper kernel.
//
// Replaces the TPU kernel avd_tpu/ops/pallas/flow_iter.py:
// solve_iteration_prepared (body _kernel; prepare_fields and
// solve_iteration are its padding helpers).  For the polynomial fields
// R0, R1 [B,5,H,W] and the flow [B,2,H,W] it computes
//
//   R1w  = bilinear warp of R1 by the flow, 0 outside the in-bounds rule
//          0 <= floor(x + dx) <= W-2, 0 <= floor(y + dy) <= H-2
//   M    = the pointwise normal-equation entries (g11, g12, g22, h1, h2)
//          of OpenCV's FarnebackUpdateMatrices, with the 5-px border taper
//   flow = solve(replicate-edge 15×15 box mean of M), det + 1e-3
//
// and writes only the new flow [B,2,H,W].  The warped field and M never
// reach device memory.  The TPU kernel's 8 replicate rows, its lane padding
// to 128 and its select-shift warp served VMEM tiling and a machine
// without a gather; this kernel takes the unpadded fields and gathers.
//
// What bounds it on an H100: bytes.  Per pixel it must read the flow (8 B),
// R0 (20 B) and R1 (20 B) and write 8 B: 56 B against about 250
// operations, below the float32 balance point of 20 flop/B.
//
// Design: one block per (b, 32×32 output tile), 32×8 threads.  Phase 1:
// the threads walk the 46×46 positions of the tile and its 7-px halo.  A
// position outside the image is clamped into it and evaluated there (flow,
// R0, taper and warp at the clamped pixel), which is the replicate edge of
// the blur.  Each position gathers the four bilinear taps of the five R1
// planes straight from device memory (L1/L2 serve the overlap), forms M in
// the order of the plain PyTorch version and stores its five planes in
// shared memory (5·46·46·4 B = 42.3 KB).  Phase 2, per plane: 15-tap
// horizontal sums into a 46×32 buffer, 15-tap vertical sums into
// registers (four outputs per thread), × 1/225, then the solve in
// registers.  The halo makes a block redo (46/32)² ≈ 2.07× of the warp and
// update work of its tile.  Compiled with --fmad=false so every product
// and sum rounds as in the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kC = 5;
constexpr int kWin = 15;
constexpr int kHalf = kWin / 2;
constexpr int kTile = 32;
constexpr int kIn = kTile + 2 * kHalf;  // 46
constexpr int kRowsPerPass = 8;         // blockDim.y
constexpr int kThreads = kTile * kRowsPerPass;
constexpr int kOutPerThread = kTile / kRowsPerPass;
constexpr int kBorder = 5;

struct Border {
  float s[kBorder];  // taper within 5 px of each edge, outermost first
};

__device__ __forceinline__ float edge_scale(int p, int size,
                                            const Border& border) {
  const int d = min(p, size - 1 - p);  // distance to the nearer edge
  return d < kBorder ? border.s[d] : 1.f;
}

__global__ void __launch_bounds__(kThreads)
flow_iter_kernel(const float* __restrict__ r0, const float* __restrict__ r1,
                 const float* __restrict__ flow, float* __restrict__ out,
                 int H, int W, Border border) {
  __shared__ float s_m[kC][kIn][kIn];
  __shared__ float s_h[kIn][kTile];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTile + tx;
  const int x0 = blockIdx.x * kTile;
  const int y0 = blockIdx.y * kTile;
  const int64_t plane = static_cast<int64_t>(H) * W;
  const float* r0b = r0 + static_cast<int64_t>(blockIdx.z) * kC * plane;
  const float* r1b = r1 + static_cast<int64_t>(blockIdx.z) * kC * plane;
  const float* flb = flow + static_cast<int64_t>(blockIdx.z) * 2 * plane;

  // ---- phase 1: warp + update at every halo'd position -----------------
  for (int i = tid; i < kIn * kIn; i += kThreads) {
    const int r = i / kIn;
    const int col = i - r * kIn;
    const int gy = min(max(y0 - kHalf + r, 0), H - 1);
    const int gx = min(max(x0 - kHalf + col, 0), W - 1);
    const int64_t p = static_cast<int64_t>(gy) * W + gx;

    const float dx = flb[p];
    const float dy = flb[plane + p];
    const float fx = static_cast<float>(gx) + dx;
    const float fy = static_cast<float>(gy) + dy;
    const float x1 = floorf(fx);
    const float y1 = floorf(fy);
    // NaN flow fails every comparison and lands out of bounds
    const bool inb = x1 >= 0.f && x1 <= static_cast<float>(W - 2) &&
                     y1 >= 0.f && y1 <= static_cast<float>(H - 2);
    float w[kC];  // warped R1, 0 out of bounds
    if (inb) {
      const float a = fx - x1;
      const float b = fy - y1;
      const float w00 = (1.f - b) * (1.f - a);
      const float w01 = (1.f - b) * a;
      const float w10 = b * (1.f - a);
      const float w11 = b * a;
      const float* s = r1b + static_cast<int64_t>(y1) * W +
                       static_cast<int64_t>(x1);
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float* sc = s + c * plane;
        w[c] = w00 * sc[0] + w01 * sc[1] + w10 * sc[W] + w11 * sc[W + 1];
      }
    } else {
#pragma unroll
      for (int c = 0; c < kC; ++c) w[c] = 0.f;
    }

    const float a0 = r0b[p];
    const float a1 = r0b[plane + p];
    const float a2 = r0b[2 * plane + p];
    const float a3 = r0b[3 * plane + p];
    const float a4 = r0b[4 * plane + p];
    float r4 = inb ? (a2 + w[2]) * 0.5f : a2;
    float r5 = inb ? (a3 + w[3]) * 0.5f : a3;
    float r6 = inb ? (a4 + w[4]) * 0.25f : a4 * 0.5f;
    float r2 = (a0 - w[0]) * 0.5f + r4 * dx + r6 * dy;
    float r3 = (a1 - w[1]) * 0.5f + r6 * dx + r5 * dy;

    const float taper = edge_scale(gy, H, border) * edge_scale(gx, W, border);
    r2 = r2 * taper;
    r3 = r3 * taper;
    r4 = r4 * taper;
    r5 = r5 * taper;
    r6 = r6 * taper;

    s_m[0][r][col] = r4 * r4 + r6 * r6;  // g11
    s_m[1][r][col] = (r4 + r5) * r6;     // g12
    s_m[2][r][col] = r5 * r5 + r6 * r6;  // g22
    s_m[3][r][col] = r4 * r2 + r6 * r3;  // h1
    s_m[4][r][col] = r6 * r2 + r5 * r3;  // h2
  }
  __syncthreads();

  // ---- phase 2: 15×15 box mean per plane, then the solve ---------------
  const float inv_area = 1.f / static_cast<float>(kWin * kWin);
  float acc[kC][kOutPerThread];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    for (int i = tid; i < kIn * kTile; i += kThreads) {
      const int r = i / kTile;
      const int col = i - r * kTile;
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < kWin; ++k) s += s_m[c][r][col + k];
      s_h[r][col] = s;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kOutPerThread; ++k) {
      const int r = ty + kRowsPerPass * k;
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < kWin; ++j) s += s_h[r + j][tx];
      acc[c][k] = s * inv_area;
    }
    __syncthreads();  // s_h is refilled by the next plane
  }

  const int x = x0 + tx;
  if (x >= W) return;
  float* u = out + static_cast<int64_t>(blockIdx.z) * 2 * plane;
#pragma unroll
  for (int k = 0; k < kOutPerThread; ++k) {
    const int y = y0 + ty + kRowsPerPass * k;
    if (y >= H) break;
    const float g11 = acc[0][k], g12 = acc[1][k], g22 = acc[2][k];
    const float h1 = acc[3][k], h2 = acc[4][k];
    const float idet = 1.f / (g11 * g22 - g12 * g12 + 1e-3f);
    const int64_t q = static_cast<int64_t>(y) * W + x;
    u[q] = (g22 * h1 - g12 * h2) * idet;
    u[plane + q] = (g11 * h2 - g12 * h1) * idet;
  }
}

}  // namespace

// r0, r1 [B,5,H,W] f32, flow [B,2,H,W] f32 → out [B,2,H,W] f32, all
// contiguous on the current device, H and W at least 2·5 so that the taper
// bands of opposite edges do not meet; `border` holds the five taper
// factors, outermost pixel first.  Launched on `stream`; returns the
// launch's cudaGetLastError().
extern "C" int avd_flow_iter(const float* r0, const float* r1,
                             const float* flow, float* out, int B, int H,
                             int W, const float* border, void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  Border bd;
  for (int i = 0; i < kBorder; ++i) bd.s[i] = border[i];
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  const dim3 block(kTile, kRowsPerPass);
  flow_iter_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      r0, r1, flow, out, H, W, bd);
  return static_cast<int>(cudaGetLastError());
}
