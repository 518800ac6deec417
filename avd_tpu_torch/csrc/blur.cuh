// The replicate-edge 15×15 box mean and the regularized 2×2 solve of
// Farnebäck's update, from a tile of M = (g11, g12, g22, h1, h2) held in
// shared memory.  blur_solve.cu stages M from device memory into the tile;
// flow_iter.cu forms M there itself.  Both then run the same three steps.
//
// The tile: s[c][r][sc] = M[c] at image row y0 − 7 + r and image column
// x0 − 8 + sc (indices clamped into the image: the replicate edge), for
// r = 0 … TH + 13 and sc = 0 … 47, at a pitch of kPitch = 52 words.  The
// outputs are the 32×TH pixels from (y0, x0).  Staged column 0 (one more
// than the 7-pixel halo on the left, so that a staged row starts on 16
// bytes wherever the image row does) and column 47 are read into the
// register windows but never added: only columns 1 … 46 enter a sum.
//
// The sums keep the plain version's order (each 15-tap sum left to right
// from tap 0, rows before columns), so no partial sum is shared between
// outputs: 14·(TH + 14)/TH + 14 adds per output and channel.
//   blur_row_sums, in place: a thread reads 24 neighbouring words of one
//     staged row once (6 × 16 bytes) and forms 8 horizontal sums from them
//     (3 shared words per sum, not 15); after a __syncwarp the sums
//     overwrite the first 32 words of the row.  The 32 lanes take 8 rows ×
//     4 column groups and a warp owns whole rows, so no other warp reads
//     what it overwrites.  With a pitch of 52 words the 8 rows of a
//     quarter-warp start in 8 different 16-byte bank groups: every 16-byte
//     read and write is conflict-free.
//   blur_col_means: a thread owns one column and KV output rows, reads
//     KV + 14 row sums per channel once (lanes on consecutive words) and
//     forms the KV means of all five channels in registers (5·KV
//     accumulators).
//   solve_store: idet = 1/(g11·g22 − g12² + 1e-3) and the two flow planes,
//     in the plain version's order.
// A block runs them with one __syncthreads() between the row and the column
// sums.  Both kernels share the small tile and the rule that picks it
// (use_small_tile), each with its own threshold.  Compiled with
// --fmad=false, every product and sum rounds as in the plain PyTorch
// version.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace avd {

constexpr int kC = 5;           // planes of M
constexpr int kWin = 15;        // box width (Farnebäck's default winsize)
constexpr int kHalf = kWin / 2;
constexpr int kTileW = 32;      // one lane per output column
constexpr int kLeft = 8;        // staged columns left of the tile
constexpr int kInW = 48;        // staged columns: x0 − 8 … x0 + 39
constexpr int kPitch = kInW + 4;  // 52 words: see blur_row_sums
constexpr int kGroup = 8;       // row sums per register window
constexpr int kWindow = 24;     // words a thread reads for them

template <int TH>
struct BlurTile {
  static constexpr int kInH = TH + 2 * kHalf;  // staged rows per channel
  static constexpr size_t kSmemBytes = kC * kInH * kPitch * sizeof(float);
};

// The small tile, 32×8 with 2 rows a warp, runs where the large tile of
// height large_th would give fewer than `below` blocks: a few small planes
// would leave most of the card's 132 SMs without one.  Each kernel takes
// `below` from its own timings.
constexpr int kSmallTH = 8, kSmallKV = 2;

inline dim3 tile_grid(int B, int H, int W, int th) {
  return dim3((W + kTileW - 1) / kTileW, (H + th - 1) / th, B);
}

inline bool use_small_tile(int B, int H, int W, int large_th,
                           int64_t below) {
  const dim3 g = tile_grid(B, H, W, large_th);
  return static_cast<int64_t>(g.x) * g.y * g.z < below;
}

// In place: s[c][r][x] ← s[c][r][x + 1] + … + s[c][r][x + 15] for
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

// mean[c][o] = (s[c][r0+o][x] + … + s[c][r0+o+14][x]) / 225 for the
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

// The solve for the thread's KV outputs (y … y + KV − 1, x) of one image:
// `u` is its flow [2][H][W], `plane` = H·W.
template <int KV>
__device__ __forceinline__ void solve_store(const float (&mean)[kC][KV],
                                            float* u, int64_t plane, int H,
                                            int W, int y, int x) {
  if (x >= W) return;
#pragma unroll
  for (int o = 0; o < KV; ++o) {
    if (y + o >= H) break;
    const float g11 = mean[0][o], g12 = mean[1][o], g22 = mean[2][o];
    const float h1 = mean[3][o], h2 = mean[4][o];
    const float idet = 1.f / (g11 * g22 - g12 * g12 + 1e-3f);
    const int64_t p = static_cast<int64_t>(y + o) * W + x;
    u[p] = (g22 * h1 - g12 * h2) * idet;
    u[plane + p] = (g11 * h2 - g12 * h1) * idet;
  }
}

}  // namespace avd
