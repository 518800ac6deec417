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
// (TH / KV warps), two barriers a tile.  This file stages the tile; the
// row sums, column means and solve are blur.cuh's (it says how they read
// shared memory):
//   stage: all five planes of the tile plus its halo go to shared memory
//   at once with cp.async, none through a register, so every load of the
//   five channels is in flight together.  Staged from x0 − 8, a row's 12
//   chunks of 4 words start on 16-byte boundaries in both memories and go
//   as 16-byte copies wherever W % 4 == 0 and the chunk lies inside the
//   image; chunks on the replicate edge (and every chunk of an unaligned W)
//   go as four 4-byte copies with clamped indices — the clamp is the
//   replicate edge.  With 4-byte copies alone the copy instructions, not
//   the bytes, are the kernel's limit.
// Tiles: 32×40 with KV = 5 (8 warps, 40 registers; 5·54·52·4 = 56,160 B, 4
// blocks = 32 warps on an SM; 40 divides every pyramid level; halo re-reads
// 2.03× from L2; 14·54/40 + 14 = 33 adds per output and channel).  Of the
// heights 32 to 80 with 2 to 8 rows a warp this one is the fastest, or
// close to it, at every shape of the main path that was timed on the card
// (PERF.md says what was tried).  A 64-wide tile was not tried: two lanes'
// windows would share a row and blur.cuh's bank pattern breaks.  A small
// tile does not help the small levels: at [48,5,40,40] 96 blocks of 32×40
// are faster than 288 blocks of 32×16, whose halo rows are 1.9× their
// output rows; those levels are bound by one block's latency and the
// launch.  Only where the large tile would leave more than half of the 132
// SMs without a block (a few small planes) the 32×8 tile with KV = 2 runs
// instead (4 warps, 22,880 B; blur.cuh's use_small_tile).
//
// M in bfloat16 (AVD_FLOW_BF16; the TPU kernel takes both, blur_solve.py
// :86-89) has a kernel of its own, blur_solve_bf16_kernel, for 18 B/px
// instead of 28.  Widened into the float32 tile, as it first was, it ran
// at the float32 kernel's pace (0.0883 ms at [48,5,320²] against 0.0837):
// the float32 tile (4 blocks an SM), its loads through registers and the
// ~170 in-order adds a pixel set that pace, not the bytes.  So:
//   stage: the tile stays bf16 in shared memory, s[c][r][sc] as above at
//   a pitch of kPitchB = 72 bf16 (144 bytes: 8 consecutive rows start in
//   8 different 16-byte bank groups, so ldmatrix is conflict-free, and a
//   row can take its 32 float32 row sums in place).  Where W % 8 == 0 a
//   16-byte chunk of 8 bf16 (staged from x0 − 8) lies wholly inside the
//   image or wholly outside it: the chunks inside go with cp.async, those
//   outside (the replicate edge) are filled after the tile has landed,
//   from the tile's own column 0 or W − 1 (bf16_fill_edges; cp.async has
//   no 2-byte size and TMA fills zeros).  Loaded through registers, the
//   edge chunks held each block of the first and last tile columns to
//   their loads' latency.  An unaligned W takes every chunk through
//   registers, 8 clamped 2-byte loads and one 16-byte store.
//   5·54·144 = 38,880 bytes a 32×40 tile: 5 blocks an SM, and the kernel
//   is held to 48 registers so that its registers allow as many
//   (blocks_per_sm).
//   row sums on the tensor cores (bf16_row_sums): per channel and 16
//   staged rows, the rows [16 × 48] times a constant 0/1 band B[48 × 32],
//   B[k][n] = 1 for n + 1 <= k <= n + 15: exactly the columns blur.cuh's
//   row sums add.  mma.sync.m16n8k16, bf16 in, float32 out; each 8-wide
//   output group spans two of the three 16-deep k-steps, so 8 mma and 3
//   ldmatrix.x4 a 16-row block.  Every product is exact (bf16 × 1); the
//   sums are the tensor cores' float32 sums, in their order.  B depends
//   on the lane alone and is built in registers.  The warp overwrites its
//   own rows with the float32 sums (__syncwarp between), so the tile
//   needs no second buffer.  A non-finite value of M spreads further
//   than the window that holds it (where the plain version and the TPU
//   kernel keep it): along its row sum to the 8-wide output groups whose
//   k-steps hold it (0 · Inf is NaN; up to 23 columns away), and by the
//   running column sums below to the rest of a warp's KV output rows (up
//   to 7 + KV − 1 rows below it).  The flow's M is finite.
//   column means and solve: on the float32 cores, a thread's first 15-tap
//   column sum top to bottom as blur.cuh's blur_col_means, each of its
//   next KV − 1 the previous one plus the entering row minus the leaving
//   one (14 + 2·(KV − 1) adds for KV outputs, not 14·KV), then
//   solve_store.
// So the bf16 instance is no longer bit-equal to the plain version: it
// holds the TPU kernel's own contract, "semantically identical (up to f32
// accumulation order)", at the tolerances of the reference's tests.
// What bounds it now is the staging: a tile's halo and its rows' 32-byte
// sectors make the copies from L2 about 2.7 times M's bytes, and a block
// computes only once its whole tile has landed.  Tried on the card and
// not kept (PERF.md has their times): 32×80 and 32×64 tiles (1-2 %
// faster at [48,5,320²], slower at the smaller levels and over a
// window), 32×32 tiles, 8 rows a thread; and, no faster at 320²: 64-wide
// tiles (3 blocks an SM), tiles shifted so that their rows start on
// 32-byte sectors, one bulk copy (cp.async.bulk) a row, persistent blocks
// that copy the next tile under the sums (2 blocks an SM), the tile
// copied in three groups of channels, each summed as it lands (spills,
// six barriers), a balanced first column sum.
// The 32×8 tile runs below kSmallTileBelow blocks of the large one.
// The float32 instance is the kernel as it was.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "blur.cuh"
#include "mma.cuh"

namespace {

using namespace avd;

constexpr int kChunks = kInW / 4;  // 16-byte chunks per staged row

// Staging: planes [kC][H][W] at `mb` → s[kC][TH+14][kPitch] for the tile
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
  solve_store<KV>(mean, out + static_cast<int64_t>(blockIdx.z) * 2 * plane,
                  plane, H, W, y0 + warp * KV, x0 + lane);
}

// ---------------------------------------------------------------------------
// bf16 M
// ---------------------------------------------------------------------------

constexpr int kPitchB = 72;           // bf16 a staged row: 144 bytes
constexpr int kPitchF = kPitchB / 2;  // the same row as float32 row sums
constexpr int kChunksB = kInW / 8;    // 16-byte chunks of a staged row

template <int TH>
struct Bf16Tile {
  static constexpr int kInH = TH + 2 * kHalf;       // staged rows a channel
  static constexpr int kRowBlocks = (kInH + 15) / 16;  // of 16 rows (mma)
  static constexpr size_t kSmemBytes =
      static_cast<size_t>(kC) * kInH * kPitchB * sizeof(__nv_bfloat16);
};

// Blocks of `threads` whose tiles of `smem` bytes fit in an H100 SM at
// once (228 KB, 1 KB kept for each block), but no more than leave each
// thread 40 of the SM's 65,536 registers: 5 of the 32×40 tile, whose
// registers the kernel is then held to (48), 12 of the 32×8 one.
constexpr int blocks_per_sm(size_t smem, int threads) {
  return 233472 / static_cast<int>(smem + 1024) < 65536 / (40 * threads)
             ? 233472 / static_cast<int>(smem + 1024)
             : 65536 / (40 * threads);
}

// Staging: bf16 planes [kC][H][W] at `mb` → s[kC][TH+14][kPitchB], the
// float32 tile's layout at the bf16 pitch.  `vec`: rows of M start on 16
// bytes (W % 8 == 0 and an aligned base); then a chunk lies wholly inside
// the image or wholly outside it, and the chunks outside are left for
// bf16_fill_edges.  Otherwise every chunk goes through registers.  The
// caller commits and waits for the cp.async, then waits for the block.
template <int TH>
__device__ __forceinline__ void bf16_stage(__nv_bfloat16* s,
                                           const __nv_bfloat16* mb, int H,
                                           int W, int y0, int x0, bool vec,
                                           int tid, int n_threads) {
  constexpr int kInH = Bf16Tile<TH>::kInH;
  const int rows_per_pass = n_threads / kChunksB;
  if (tid >= rows_per_pass * kChunksB) return;
  const int ch = tid % kChunksB;
  const int gx = x0 - kLeft + 8 * ch;
  const bool inside = gx >= 0 && gx + 7 < W;
  if (vec && !inside) return;
  const int64_t plane = static_cast<int64_t>(H) * W;
  int c = (tid / kChunksB) / kInH;
  int r = tid / kChunksB - c * kInH;
  const uint16_t* bits = reinterpret_cast<const uint16_t*>(mb);
  while (c < kC) {
    const int gy = min(max(y0 - kHalf + r, 0), H - 1);
    const int64_t row = c * plane + static_cast<int64_t>(gy) * W;
    __nv_bfloat16* dst = s + (c * kInH + r) * kPitchB + 8 * ch;
    if (vec) {
      avd::cp_async_16(dst, mb + row + gx);
    } else {
      // the lower address holds the lower half of each 32-bit word
      uint32_t w[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const uint32_t lo = bits[row + min(max(gx + 2 * j, 0), W - 1)];
        const uint32_t hi = bits[row + min(max(gx + 2 * j + 1, 0), W - 1)];
        w[j] = lo | (hi << 16);
      }
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    }
    r += rows_per_pass;
    while (r >= kInH) r -= kInH, ++c;
  }
}

// The replicate edge of an aligned W, once the tile has landed: each chunk
// bf16_stage left out (the one left of column 0 where x0 = 0, those right
// of column W − 1 in the last column of tiles) takes its row's column 0 or
// W − 1 eight times, from the tile itself.
template <int TH>
__device__ __forceinline__ void bf16_fill_edges(__nv_bfloat16* s, int W,
                                                int x0, int tid,
                                                int n_threads) {
  constexpr int kInH = Bf16Tile<TH>::kInH;
  const int rows_per_pass = n_threads / kChunksB;
  if (tid >= rows_per_pass * kChunksB) return;
  const int ch = tid % kChunksB;
  const int gx = x0 - kLeft + 8 * ch;
  if (gx >= 0 && gx + 7 < W) return;
  const int from = (gx < 0 ? 0 : W - 1) - (x0 - kLeft);  // staged column
  uint16_t* bits = reinterpret_cast<uint16_t*>(s);
  int c = (tid / kChunksB) / kInH;
  int r = tid / kChunksB - c * kInH;
  while (c < kC) {
    const int at = (c * kInH + r) * kPitchB;
    const uint32_t v = bits[at + from];
    const uint32_t w = v | (v << 16);
    *reinterpret_cast<uint4*>(bits + at + 8 * ch) = make_uint4(w, w, w, w);
    r += rows_per_pass;
    while (r >= kInH) r -= kInH, ++c;
  }
}

// Two bf16 of the band B as one mma register: B[k][n] and B[k+1][n] with
// d = k − n; B[k][n] = 1 (0x3f80) where 1 <= d <= 15.
__device__ __forceinline__ uint32_t band_pair(int d) {
  return (d >= 1 && d <= kWin ? 0x3f80u : 0u) |
         (d + 1 >= 1 && d + 1 <= kWin ? 0x3f800000u : 0u);
}

// In place: the float32 row sums of every staged row, row r's 32 sums in
// the first 128 bytes of its 144, s32[c][r][x] = s[c][r][x + 1] + … +
// s[c][r][x + 15] (on the tensor cores, in their order).  A warp takes
// 16 rows of one channel at a time: A = the rows [16 × 48] in three
// k-steps (ldmatrix.x4 each), output group j (x = 8j … 8j + 7) = A's
// k-steps j/2 and j/2 + 1 times the band.  The band's fragment for
// k-step j/2 + e depends only on e and j % 2 (k − n = 16e − 8(j % 2) +
// kk − g): four fragments, built once.  Rows past the channel's last (the
// 16-row blocks overrun TH + 14) read the last row and are not written.
template <int TH>
__device__ __forceinline__ void bf16_row_sums(__nv_bfloat16* s, int warp,
                                              int lane, int n_warps) {
  constexpr int kInH = Bf16Tile<TH>::kInH;
  constexpr int kRowBlocks = Bf16Tile<TH>::kRowBlocks;
  const int g = lane >> 2, t = lane & 3;
  uint32_t band[2][2][2];
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int p = 0; p < 2; ++p) {
      const int d = 16 * e - 8 * p + 2 * t - g;
      band[e][p][0] = band_pair(d);
      band[e][p][1] = band_pair(d + 8);
    }
  // the lane's row within a 16-row block and its 8-column half of a k-step
  // (ldmatrix.x4: lanes 8i … 8i + 7 address matrix i = A's quarter
  // (rows 8·(i % 2), columns 8·(i / 2)))
  const int lrow = (lane & 7) + (lane & 8);
  const int lcol = (lane >> 4) * 8;
  for (int i = warp; i < kC * kRowBlocks; i += n_warps) {
    const int c = i / kRowBlocks;
    const int rb = (i - c * kRowBlocks) * 16;
    __nv_bfloat16* rows = s + c * kInH * kPitchB;
    const __nv_bfloat16* src =
        rows + min(rb + lrow, kInH - 1) * kPitchB + lcol;
    uint32_t a[3][4];
#pragma unroll
    for (int ks = 0; ks < 3; ++ks) avd::ldmatrix_x4(a[ks], src + 16 * ks);
    float acc[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      avd::mma_bf16_16816(acc[j], a[j / 2], band[0][j % 2][0],
                          band[0][j % 2][1]);
      avd::mma_bf16_16816(acc[j], a[j / 2 + 1], band[1][j % 2][0],
                          band[1][j % 2][1]);
    }
    __syncwarp();  // the sums overwrite rows the warp's other lanes read
    float* sums = reinterpret_cast<float*>(rows);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rb + g + 8 * h;
      if (r < kInH) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          *reinterpret_cast<float2*>(sums + r * kPitchF + 8 * j + 2 * t) =
              make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
      }
    }
  }
}

// The column means of the thread's column x and its KV output rows from
// r0, from the row sums at the bf16 tile's pitch: the first a 15-tap sum
// top to bottom (blur_col_means' order), each next one the previous sum
// plus the row that enters minus the row that leaves, in registers:
// 14 + 2·(KV − 1) adds for KV outputs instead of 14·KV.
template <int TH, int KV>
__device__ __forceinline__ void bf16_col_means(const float* s, int r0, int x,
                                               float (&mean)[kC][KV]) {
  constexpr int kInH = Bf16Tile<TH>::kInH;
  const float inv_area = 1.f / static_cast<float>(kWin * kWin);
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const float* src = s + (c * kInH + r0) * kPitchF + x;
    float w[KV + kWin - 1];
#pragma unroll
    for (int j = 0; j < KV + kWin - 1; ++j) w[j] = src[j * kPitchF];
    float a = w[0];
#pragma unroll
    for (int j = 1; j < kWin; ++j) a += w[j];
    mean[c][0] = a * inv_area;
#pragma unroll
    for (int o = 1; o < KV; ++o) {
      a += w[o + kWin - 1] - w[o - 1];
      mean[c][o] = a * inv_area;
    }
  }
}

template <int TH, int KV>
__global__ void __launch_bounds__(
    32 * TH / KV, blocks_per_sm(Bf16Tile<TH>::kSmemBytes, 32 * TH / KV))
blur_solve_bf16_kernel(const __nv_bfloat16* __restrict__ m,
                       float* __restrict__ out, int H, int W, bool vec) {
  constexpr int kWarps = TH / KV;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* const s = reinterpret_cast<__nv_bfloat16*>(smem_raw);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * TH;
  const int64_t plane = static_cast<int64_t>(H) * W;

  bf16_stage<TH>(s, m + static_cast<int64_t>(blockIdx.z) * kC * plane, H, W,
                 y0, x0, vec, threadIdx.x, 32 * kWarps);
  avd::cp_async_wait_all();
  __syncthreads();
  if (vec && (x0 < kLeft || x0 - kLeft + kInW > W)) {  // block-uniform
    bf16_fill_edges<TH>(s, W, x0, threadIdx.x, 32 * kWarps);
    __syncthreads();
  }
  bf16_row_sums<TH>(s, warp, lane, kWarps);
  __syncthreads();
  float mean[kC][KV];
  bf16_col_means<TH, KV>(reinterpret_cast<const float*>(s), warp * KV, lane,
                         mean);
  solve_store<KV>(mean, out + static_cast<int64_t>(blockIdx.z) * 2 * plane,
                  plane, H, W, y0 + warp * KV, x0 + lane);
}

// Both instances: timed apart, the bf16 one wins at the same tile and the
// same threshold
constexpr int kLargeTH = 40, kLargeKV = 5;  // the small tile is blur.cuh's
constexpr int64_t kSmallTileBelow = 66;     // half of the 132 SMs

template <int TH, int KV>
int launch(const float* m, float* out, int B, int H, int W,
           cudaStream_t stream) {
  constexpr size_t smem = BlurTile<TH>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      blur_solve_kernel<TH, KV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // a staged row starts on 16 bytes
  const bool vec = W % 4 == 0 && reinterpret_cast<uintptr_t>(m) % 16 == 0;
  blur_solve_kernel<TH, KV><<<tile_grid(B, H, W, TH), 32 * TH / KV, smem,
                              stream>>>(m, out, H, W, vec);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const float* m, float* out, int B, int H, int W, void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_small_tile(B, H, W, kLargeTH, kSmallTileBelow))
    return launch<kSmallTH, kSmallKV>(m, out, B, H, W, s);
  return launch<kLargeTH, kLargeKV>(m, out, B, H, W, s);
}

// The bf16 kernel asks for the SM's largest shared-memory carveout, so that
// the blocks its registers allow (5 of 38,880 bytes) fit on an SM at once.
template <int TH, int KV>
int launch_bf16(const __nv_bfloat16* m, float* out, int B, int H, int W,
                cudaStream_t stream) {
  auto* kernel = blur_solve_bf16_kernel<TH, KV>;
  constexpr size_t smem = Bf16Tile<TH>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = W % 8 == 0 && reinterpret_cast<uintptr_t>(m) % 16 == 0;
  kernel<<<tile_grid(B, H, W, TH), 32 * TH / KV, smem, stream>>>(m, out, H,
                                                                 W, vec);
  return static_cast<int>(cudaGetLastError());
}

int dispatch(const __nv_bfloat16* m, float* out, int B, int H, int W,
             void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_small_tile(B, H, W, kLargeTH, kSmallTileBelow))
    return launch_bf16<kSmallTH, kSmallKV>(m, out, B, H, W, s);
  return launch_bf16<kLargeTH, kLargeKV>(m, out, B, H, W, s);
}

}  // namespace

// m [B,5,H,W] f32 → out [B,2,H,W] f32, both contiguous on the current
// device; launched on `stream`.  Returns the first CUDA error.
extern "C" int avd_blur_solve(const float* m, float* out, int B, int H, int W,
                              void* stream) {
  return dispatch(m, out, B, H, W, stream);
}

// The same with a bf16 m [B,5,H,W].
extern "C" int avd_blur_solve_bf16(const __nv_bfloat16* m, float* out, int B,
                                   int H, int W, void* stream) {
  return dispatch(m, out, B, H, W, stream);
}
