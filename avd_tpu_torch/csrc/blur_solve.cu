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
// flow is written (8 B/px): about 28 B/px against ~165 adds/px, below the
// card's float32 balance point.  The sums are kept in the plain version's
// order (each 15-tap sum left to right from tap 0, rows before columns), so
// no partial sum is shared between outputs and the adds are the kernel's
// real work: 14·(TH + 14)/TH + 14 per output and channel.
//
// Design: one block per (b, 32×TH output tile), one warp per KV output rows
// (TH / KV warps).  Three phases, two barriers a tile:
//   1. stage: all five planes of the tile plus its halo go to shared memory
//      at once with cp.async, none through a register, so every load of the
//      five channels is in flight together.  A staged row holds image
//      columns x0 − 8 … x0 + 39 (one more than the 7-pixel halo on the
//      left): its 12 chunks of 4 words then start on 16-byte boundaries in
//      both memories and go as 16-byte copies wherever W % 4 == 0 and the
//      chunk lies inside the image; chunks on the replicate edge (and every
//      chunk of an unaligned W) go as four 4-byte copies with clamped
//      indices — the clamp is the replicate edge.  With 4-byte copies
//      alone the copy instructions, not the bytes, are the kernel's limit.
//   2. row sums from register windows, in place: a thread reads 24
//      neighbouring words of one staged row once (6 × 16 bytes) and forms 8
//      horizontal 15-tap sums from them (3 shared words per sum, not 15),
//      then the warp synchronises and the sums overwrite the first 32 words
//      of the row.  The 32 lanes take 8 rows × 4 column groups and a warp
//      owns whole rows, so no other warp reads what it overwrites.  With a
//      pitch of 52 words the 8 rows of a quarter-warp start in 8 different
//      16-byte bank groups: every 16-byte read and write is conflict-free.
//   3. column sums the same way: a thread owns one column and KV output
//      rows, reads KV + 14 row sums per channel once (lanes on consecutive
//      words) and forms the KV means of all five channels in registers
//      (5·KV accumulators), then solves in the plain version's order and
//      writes only the two flow planes.
// Tiles: 32×40 with KV = 5 (8 warps, 40 registers; 5·54·52·4 = 56,160 B, 4
// blocks = 32 warps on an SM; 40 divides every pyramid level; halo re-reads
// 2.03× from L2; 14·54/40 + 14 = 33 adds per output and channel).  Of the
// heights 32 to 80 with 2 to 8 rows a warp this one is the fastest, or
// close to it, at every shape of the main path that was timed on the card
// (PERF.md says what was tried).  A 64-wide tile was
// not tried: two lanes' windows would share a row and the bank pattern
// above breaks.  A small tile does not help the small levels: at
// [48,5,40,40] 96 blocks of 32×40 are faster than 288 blocks of 32×16,
// whose halo rows are 1.9× their output rows; those levels are bound by
// one block's latency and the launch.  Only where the large tile would
// leave more than half of the 132 SMs without a block (a few small planes)
// the 32×8 tile with KV = 2 runs instead (4 warps, 22,880 B).
// Accumulation is float32; compiled with --fmad=false so the solve rounds
// as the plain PyTorch version does.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"

namespace {

constexpr int kC = 5;
constexpr int kWin = 15;
constexpr int kHalf = kWin / 2;
constexpr int kTileW = 32;               // one lane per output column
constexpr int kLeft = 8;                 // staged columns left of the tile
constexpr int kInW = 48;                 // staged columns: x0 − 8 … x0 + 39
constexpr int kChunks = kInW / 4;        // 16-byte chunks per staged row
constexpr int kPitch = kInW + 4;         // 52 words: see phase 2
constexpr int kGroup = 8;                // row sums per register window
constexpr int kWindow = 24;              // words a thread reads for them

template <int TH>
struct BlurTile {
  static constexpr int kInH = TH + 2 * kHalf;  // staged rows per channel
  static constexpr size_t kSmemBytes = kC * kInH * kPitch * sizeof(float);
};

// Phase 1: planes [kC][H][W] at `mb` → s[kC][TH+14][kPitch] for the tile
// whose first output is (y0, x0); staged column sc holds image column
// x0 − 8 + sc, indices clamped into the image.  `vec`: rows of M start on
// 16-byte boundaries (W % 4 == 0 and an aligned base).
template <int TH>
__device__ __forceinline__ void blur_stage(float* s, const float* mb, int H,
                                           int W, int y0, int x0, bool vec,
                                           int tid, int n_threads) {
  constexpr int kInH = BlurTile<TH>::kInH;
  // a thread keeps one chunk column and walks down the staged rows of all
  // channels, rows_per_pass at a time: no division inside the loop
  const int rows_per_pass = n_threads / kChunks;
  if (tid >= rows_per_pass * kChunks) return;
  const int64_t plane = static_cast<int64_t>(H) * W;
  const int ch = tid % kChunks;
  int c = (tid / kChunks) / kInH;
  int r = tid / kChunks - c * kInH;
  const int gx = x0 - kLeft + 4 * ch;
  const bool whole = vec && gx >= 0 && gx + 3 < W;
  int gxe[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) gxe[e] = min(max(gx + e, 0), W - 1);
  while (c < kC) {
    const int gy = min(max(y0 - kHalf + r, 0), H - 1);
    const float* src = mb + c * plane + static_cast<int64_t>(gy) * W;
    float* dst = s + (c * kInH + r) * kPitch + 4 * ch;
    if (whole) {
      avd::cp_async_16(dst, src + gx);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) avd::cp_async_4(dst + e, src + gxe[e]);
    }
    r += rows_per_pass;
    while (r >= kInH) r -= kInH, ++c;
  }
}

// Phase 2, in place: s[c][r][x] ← s[c][r][x + 1] + … + s[c][r][x + 15] for
// x = 0 … 31, summed left to right, for every staged row.  A warp takes 8
// rows of one channel at a time; lane = row + 8·group of 8 sums.
template <int TH>
__device__ __forceinline__ void blur_row_sums(float* s, int warp, int lane,
                                              int n_warps) {
  constexpr int kInH = BlurTile<TH>::kInH;
  constexpr int kRowBlocks = (kInH + 7) / 8;
  const int lr = lane & 7;
  const int grp = lane >> 3;
  for (int i = warp; i < kC * kRowBlocks; i += n_warps) {
    const int c = i / kRowBlocks;
    const int rr = (i - c * kRowBlocks) * 8 + lr;
    const bool live = rr < kInH;
    float4* row = reinterpret_cast<float4*>(
        s + (c * kInH + min(rr, kInH - 1)) * kPitch + grp * kGroup);
    float w[kWindow];
#pragma unroll
    for (int j = 0; j < kWindow / 4; ++j) {
      const float4 q = row[j];
      w[4 * j] = q.x, w[4 * j + 1] = q.y, w[4 * j + 2] = q.z,
            w[4 * j + 3] = q.w;
    }
    __syncwarp();  // the sums overwrite words the warp's other lanes read
    float sum[kGroup];
#pragma unroll
    for (int o = 0; o < kGroup; ++o) {
      float a = w[o + 1];
#pragma unroll
      for (int j = 2; j <= kWin; ++j) a += w[o + j];
      sum[o] = a;
    }
    if (live) {
      row[0] = make_float4(sum[0], sum[1], sum[2], sum[3]);
      row[1] = make_float4(sum[4], sum[5], sum[6], sum[7]);
    }
  }
}

// Phase 3: mean[c][o] = (s[c][r0+o][x] + … + s[c][r0+o+14][x]) / 225 for the
// thread's column x and its KV output rows from r0, top to bottom.
template <int TH, int KV>
__device__ __forceinline__ void blur_col_means(const float* s, int r0, int x,
                                               float (&mean)[kC][KV]) {
  constexpr int kInH = BlurTile<TH>::kInH;
  const float inv_area = 1.f / static_cast<float>(kWin * kWin);
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const float* src = s + (c * kInH + r0) * kPitch + x;
    float w[KV + kWin - 1];
#pragma unroll
    for (int j = 0; j < KV + kWin - 1; ++j) w[j] = src[j * kPitch];
#pragma unroll
    for (int o = 0; o < KV; ++o) {
      float a = w[o];
#pragma unroll
      for (int j = 1; j < kWin; ++j) a += w[o + j];
      mean[c][o] = a * inv_area;
    }
  }
}

template <int TH, int KV>
__global__ void __launch_bounds__(32 * TH / KV)
blur_solve_kernel(const float* __restrict__ m, float* __restrict__ out, int H,
                  int W, bool vec) {
  constexpr int kWarps = TH / KV;
  extern __shared__ __align__(16) float smem[];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * TH;
  const int64_t plane = static_cast<int64_t>(H) * W;

  blur_stage<TH>(smem, m + static_cast<int64_t>(blockIdx.z) * kC * plane, H,
                 W, y0, x0, vec, threadIdx.x, 32 * kWarps);
  avd::cp_async_wait_all();
  __syncthreads();
  blur_row_sums<TH>(smem, warp, lane, kWarps);
  __syncthreads();
  float mean[kC][KV];
  blur_col_means<TH, KV>(smem, warp * KV, lane, mean);

  const int x = x0 + lane;
  if (x >= W) return;
  float* u = out + static_cast<int64_t>(blockIdx.z) * 2 * plane;
#pragma unroll
  for (int o = 0; o < KV; ++o) {
    const int y = y0 + warp * KV + o;
    if (y >= H) break;
    const float g11 = mean[0][o], g12 = mean[1][o], g22 = mean[2][o];
    const float h1 = mean[3][o], h2 = mean[4][o];
    const float idet = 1.f / (g11 * g22 - g12 * g12 + 1e-3f);
    const int64_t p = static_cast<int64_t>(y) * W + x;
    u[p] = (g22 * h1 - g12 * h2) * idet;
    u[plane + p] = (g11 * h2 - g12 * h1) * idet;
  }
}

template <int TH, int KV>
int launch(const float* m, float* out, int B, int H, int W,
           cudaStream_t stream) {
  constexpr size_t smem = BlurTile<TH>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      blur_solve_kernel<TH, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(m) % 16 == 0;
  const dim3 grid((W + kTileW - 1) / kTileW, (H + TH - 1) / TH, B);
  blur_solve_kernel<TH, KV><<<grid, 32 * TH / KV, smem, stream>>>(m, out, H,
                                                                  W, vec);
  return static_cast<int>(cudaGetLastError());
}

// The tiles, and the number of large-tile blocks below which the small tile
// runs (half of the card's 132 SMs).
constexpr int kLargeTH = 40, kLargeKV = 5;
constexpr int kSmallTH = 8, kSmallKV = 2;
constexpr int64_t kSmallTileBelow = 66;

}  // namespace

// m [B,5,H,W] f32 → out [B,2,H,W] f32, both contiguous on the current
// device; launched on `stream`.  Returns the first CUDA error.
extern "C" int avd_blur_solve(const float* m, float* out, int B, int H, int W,
                              void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  const int64_t big_blocks = static_cast<int64_t>((W + kTileW - 1) / kTileW) *
                             ((H + kLargeTH - 1) / kLargeTH) * B;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (big_blocks < kSmallTileBelow)
    return launch<kSmallTH, kSmallKV>(m, out, B, H, W, s);
  return launch<kLargeTH, kLargeKV>(m, out, B, H, W, s);
}
