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
// What bounds it on an H100: bytes, by the count of the work.  Per pixel it
// must read the flow (8 B), R0 (20 B) and R1 (20 B) and write 8 B: 56 B
// against about 250 operations, below the float32 balance point of
// 20 flop/B.  What holds it at about twice that bound, as far as timed
// variants show, is the load/store pipe that L1 and shared memory share:
// each evaluation of the warp and update issues 27 loads through L1 (2 of
// the flow, 5 of R0, 20 bilinear taps of R1, whose 32 lanes touch two or
// three 128-byte lines), the halo makes a block evaluate 1.69 positions
// per output, and the blur's register windows read shared memory on the
// same pipe.
//
// Design: one block per (b, 32×TH output tile), one warp per KV output
// rows, M formed straight into blur.cuh's shared tile, two barriers a tile.
//   1. warp + update: the threads walk the staged positions of the tile,
//      row r = image row y0 − 7 + r and column sc = image column x0 − 8 +
//      sc, both clamped into the image (the replicate edge of the blur:
//      flow, R0, taper and warp are those of the clamped pixel), 32
//      neighbouring positions a warp.  Only the columns 1 … 46 that enter a
//      sum are evaluated.  Each position gathers the four bilinear taps of
//      the five R1 planes straight from device memory (L1 serves the
//      overlap), forms M in the order of the plain PyTorch version and
//      stores its five planes at s[c][r][sc].  One __syncthreads(); M never
//      leaves the chip, so there is no copy to wait for.
//   2. blur.cuh's row sums from register windows, a barrier, its column
//      means of all five planes in registers, and the solve; only the two
//      flow planes are written.
// Tiles: 32×80 with KV = 5 (16 warps, 64 registers, 5·94·52·4 = 97,760 B;
// 2 blocks = 32 warps an SM, leaving 60 KB of L1 to the gathers; 46·94/2560
// = 1.69 evaluations per output), and 32×8 with KV = 2 (4 warps, 22,880 B;
// 3.95) where the large tile would give fewer than 100 blocks, most of the
// 132 SMs holding one or none (blur.cuh's use_small_tile: the tail
// window's 80² and 40² levels and the full window's 40²).  A 32×40 tile,
// whose 4 blocks an SM leave 28 KB of L1 beside shared memory, is much
// slower; the other tiles, an L1-bypassing load of R0 and the flow, 2 or 4
// positions a thread with 8- or 16-byte loads, R0 and an R1 window staged
// in shared memory, and a walk of one staged row a warp were timed and
// lost (PERF.md).  Compiled with --fmad=false so every
// product and sum rounds as in the plain version: the kernel equals it bit
// for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "blur.cuh"

namespace {

using namespace avd;

constexpr int kBorder = 5;
constexpr int kCols = kInW - 2;  // staged columns 1 … 46 enter a sum

struct Border {
  float s[kBorder];  // taper within 5 px of each edge, outermost first
};

__device__ __forceinline__ float edge_scale(int p, int size,
                                            const Border& border) {
  const int d = min(p, size - 1 - p);  // distance to the nearer edge
  return d < kBorder ? border.s[d] : 1.f;
}

// Phase 1: M at every staged position of the tile whose first output is
// (y0, x0) → s[c][r][sc] for r = 0 … TH + 13, sc = 1 … 46 (image row
// y0 − 7 + r, column x0 − 8 + sc, clamped), 32 neighbouring positions a
// warp.
template <int TH>
__device__ __forceinline__ void update_stage(
    float* s, const float* __restrict__ r0b, const float* __restrict__ r1b,
    const float* __restrict__ flb, int H, int W, int y0, int x0,
    const Border& border, int tid, int n_threads) {
  constexpr int kInH = BlurTile<TH>::kInH;
  const int64_t plane = static_cast<int64_t>(H) * W;
  for (int i = tid; i < kInH * kCols; i += n_threads) {
    const int r = i / kCols;
    const int sc = 1 + i - r * kCols;
    const int gy = min(max(y0 - kHalf + r, 0), H - 1);
    const int gx = min(max(x0 - kLeft + sc, 0), W - 1);
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
      const float* t = r1b + static_cast<int64_t>(y1) * W +
                       static_cast<int64_t>(x1);
#pragma unroll
      for (int c = 0; c < kC; ++c) {
        const float* tc = t + c * plane;
        w[c] = w00 * tc[0] + w01 * tc[1] + w10 * tc[W] + w11 * tc[W + 1];
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

    float* d = s + r * kPitch + sc;
    d[0] = r4 * r4 + r6 * r6;                  // g11
    d[kInH * kPitch] = (r4 + r5) * r6;         // g12
    d[2 * kInH * kPitch] = r5 * r5 + r6 * r6;  // g22
    d[3 * kInH * kPitch] = r4 * r2 + r6 * r3;  // h1
    d[4 * kInH * kPitch] = r6 * r2 + r5 * r3;  // h2
  }
}

template <int TH, int KV>
__global__ void __launch_bounds__(32 * TH / KV, 1024 / (32 * TH / KV))
flow_iter_kernel(const float* __restrict__ r0, const float* __restrict__ r1,
                 const float* __restrict__ flow, float* __restrict__ out,
                 int H, int W, Border border) {
  constexpr int kWarps = TH / KV;
  extern __shared__ __align__(16) float smem[];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * TH;
  const int64_t plane = static_cast<int64_t>(H) * W;
  const int64_t b = blockIdx.z;

  update_stage<TH>(smem, r0 + b * kC * plane, r1 + b * kC * plane,
                   flow + b * 2 * plane, H, W, y0, x0, border, threadIdx.x,
                   32 * kWarps);
  __syncthreads();
  blur_row_sums<TH>(smem, warp, lane, kWarps);
  __syncthreads();
  float mean[kC][KV];
  blur_col_means<TH, KV>(smem, warp * KV, lane, mean);
  solve_store<KV>(mean, out + b * 2 * plane, plane, H, W, y0 + warp * KV,
                  x0 + lane);
}

template <int TH, int KV>
int launch(const float* r0, const float* r1, const float* flow, float* out,
           int B, int H, int W, const Border& border, cudaStream_t stream) {
  constexpr size_t smem = BlurTile<TH>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      flow_iter_kernel<TH, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  flow_iter_kernel<TH, KV><<<tile_grid(B, H, W, TH), 32 * TH / KV, smem,
                             stream>>>(r0, r1, flow, out, H, W, border);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kLargeTH = 80, kLargeKV = 5;  // the small tile is blur.cuh's
// Timed on the path's shapes: the small tile is faster at 24, 36 and 96
// large-tile blocks ([12,·,40,40], [12,·,80,80], [48,·,40,40]), the large
// one at 120 and more ([12,·,160,160] first).
constexpr int64_t kSmallTileBelow = 100;

}  // namespace

// r0, r1 [B,5,H,W] f32, flow [B,2,H,W] f32 → out [B,2,H,W] f32, all
// contiguous on the current device, H and W at least 2·5 so that the taper
// bands of opposite edges do not meet; `border` holds the five taper
// factors, outermost pixel first.  Launched on `stream`; returns the first
// CUDA error.
extern "C" int avd_flow_iter(const float* r0, const float* r1,
                             const float* flow, float* out, int B, int H,
                             int W, const float* border, void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  Border bd;
  for (int i = 0; i < kBorder; ++i) bd.s[i] = border[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_small_tile(B, H, W, kLargeTH, kSmallTileBelow))
    return launch<kSmallTH, kSmallKV>(r0, r1, flow, out, B, H, W, bd, s);
  return launch<kLargeTH, kLargeKV>(r0, r1, flow, out, B, H, W, bd, s);
}
