// Fused 15×15 box blur + regularized 2×2 solve — Hopper kernel.
//
// Replaces the TPU kernel avd_tpu/ops/pallas/blur_solve.py:box_blur_solve
// (body _kernel / blur_solve_rows).  For the normal-equation field
// M = (g11, g12, g22, h1, h2) [B,5,H,W] it takes the replicate-edge box
// mean over a winsize×winsize window (winsize 15, Farnebäck's default),
// then idet = 1/(g11·g22 − g12² + 1e-3) and
// flow = ((g22·h1 − g12·h2)·idet, (g11·h2 − g12·h1)·idet) → [B,2,H,W].
//
// What bounds it on an H100: bytes.  M is read once (20 B/px) and only the
// flow is written (8 B/px): about 28 B/px against ~160 adds/px, below the
// card's float32 balance point.
//
// Design: one block per (b, 32×32 output tile), 32×8 threads.  For each
// channel in turn the block stages the tile plus a 7-pixel halo (46×46)
// in shared memory with clamped indices — the replicate edge — then takes
// 15-tap horizontal sums into a 46×32 buffer and 15-tap vertical sums
// into registers (four outputs per thread), scaled by 1/225.  The solve
// runs in registers and only the two flow planes reach device memory.
// The halo re-reads (2116 loads per 1024 outputs) hit L2, not HBM.
// Accumulation is float32; compiled with --fmad=false so the solve rounds
// as the plain PyTorch version does.

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

__global__ void __launch_bounds__(kThreads)
blur_solve_kernel(const float* __restrict__ m, float* __restrict__ out,
                  int H, int W) {
  __shared__ float s_in[kIn][kIn + 1];
  __shared__ float s_h[kIn][kTile + 1];

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * kTile + tx;
  const int x0 = blockIdx.x * kTile;
  const int y0 = blockIdx.y * kTile;
  const int64_t plane = static_cast<int64_t>(H) * W;
  const float* mb = m + static_cast<int64_t>(blockIdx.z) * kC * plane;
  const float inv_area = 1.f / static_cast<float>(kWin * kWin);

  float acc[kC][kOutPerThread];
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const float* mc = mb + c * plane;
    for (int i = tid; i < kIn * kIn; i += kThreads) {
      const int r = i / kIn;
      const int col = i - r * kIn;
      const int gy = min(max(y0 - kHalf + r, 0), H - 1);
      const int gx = min(max(x0 - kHalf + col, 0), W - 1);
      s_in[r][col] = mc[static_cast<int64_t>(gy) * W + gx];
    }
    __syncthreads();
    for (int i = tid; i < kIn * kTile; i += kThreads) {
      const int r = i / kTile;
      const int col = i - r * kTile;
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < kWin; ++k) s += s_in[r][col + k];
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
    __syncthreads();  // s_in / s_h are refilled by the next channel
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
    const int64_t p = static_cast<int64_t>(y) * W + x;
    u[p] = (g22 * h1 - g12 * h2) * idet;
    u[plane + p] = (g11 * h2 - g12 * h1) * idet;
  }
}

}  // namespace

// m [B,5,H,W] f32 → out [B,2,H,W] f32, both contiguous on the current
// device; launched on `stream`.  Returns the launch's cudaGetLastError().
extern "C" int avd_blur_solve(const float* m, float* out, int B, int H, int W,
                              void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  const dim3 grid((W + kTile - 1) / kTile, (H + kTile - 1) / kTile, B);
  const dim3 block(kTile, kRowsPerPass);
  blur_solve_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      m, out, H, W);
  return static_cast<int>(cudaGetLastError());
}
