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
// :86-89): only the staging changes.  blur_stage_bf16 reads 16 bytes (8
// bf16) at a time through a register, widens them and writes 8 floats to
// the same float32 tile, so blur.cuh's sums, their order and the solve
// are the float32 kernel's, on the widened field; 18 B/px instead of 28.
// The chunks start on 16-byte boundaries wherever W % 8 == 0; elsewhere,
// and on the replicate edge, 8 clamped 2-byte loads.  Simple, not tuned:
// the loads are not asynchronous as the float32 path's are.  The float32
// instance is the kernel as it was.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// The same tile from bf16 planes, widened to float32 on the way.
constexpr int kChunks8 = kInW / 8;  // 16-byte chunks of bf16 per row

template <int TH>
__device__ __forceinline__ void blur_stage_bf16(float* s,
                                                const __nv_bfloat16* mb,
                                                int H, int W, int y0, int x0,
                                                bool vec, int tid,
                                                int n_threads) {
  constexpr int kInH = BlurTile<TH>::kInH;
  const int rows_per_pass = n_threads / kChunks8;
  if (tid >= rows_per_pass * kChunks8) return;
  const int64_t plane = static_cast<int64_t>(H) * W;
  const int ch = tid % kChunks8;
  int c = (tid / kChunks8) / kInH;
  int r = tid / kChunks8 - c * kInH;
  const int gx = x0 - kLeft + 8 * ch;
  const bool whole = vec && gx >= 0 && gx + 7 < W;
  int gxe[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) gxe[e] = min(max(gx + e, 0), W - 1);
  while (c < kC) {
    const int gy = min(max(y0 - kHalf + r, 0), H - 1);
    const __nv_bfloat16* src = mb + c * plane + static_cast<int64_t>(gy) * W;
    float v[8];
    if (whole) {
      // a bf16 is the high half of its float32; the lower address holds
      // the lower half of each 32-bit word
      const uint4 q = *reinterpret_cast<const uint4*>(src + gx);
      const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[2 * j] = __uint_as_float(w[j] << 16);
        v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
      }
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = __bfloat162float(src[gxe[e]]);
    }
    float4* dst = reinterpret_cast<float4*>(
        s + (c * kInH + r) * kPitch + 8 * ch);
    dst[0] = make_float4(v[0], v[1], v[2], v[3]);
    dst[1] = make_float4(v[4], v[5], v[6], v[7]);
    r += rows_per_pass;
    while (r >= kInH) r -= kInH, ++c;
  }
}

template <int TH, int KV, typename T>
__global__ void __launch_bounds__(32 * TH / KV)
blur_solve_kernel(const T* __restrict__ m, float* __restrict__ out, int H,
                  int W, bool vec) {
  constexpr int kWarps = TH / KV;
  extern __shared__ __align__(16) float smem[];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int x0 = blockIdx.x * kTileW;
  const int y0 = blockIdx.y * TH;
  const int64_t plane = static_cast<int64_t>(H) * W;

  if constexpr (std::is_same<T, float>::value) {
    blur_stage<TH>(smem, m + static_cast<int64_t>(blockIdx.z) * kC * plane,
                   H, W, y0, x0, vec, threadIdx.x, 32 * kWarps);
    avd::cp_async_wait_all();
  } else {
    blur_stage_bf16<TH>(smem,
                        m + static_cast<int64_t>(blockIdx.z) * kC * plane, H,
                        W, y0, x0, vec, threadIdx.x, 32 * kWarps);
  }
  __syncthreads();
  blur_row_sums<TH>(smem, warp, lane, kWarps);
  __syncthreads();
  float mean[kC][KV];
  blur_col_means<TH, KV>(smem, warp * KV, lane, mean);
  solve_store<KV>(mean, out + static_cast<int64_t>(blockIdx.z) * 2 * plane,
                  plane, H, W, y0 + warp * KV, x0 + lane);
}

constexpr int kLargeTH = 40, kLargeKV = 5;  // the small tile is blur.cuh's
constexpr int64_t kSmallTileBelow = 66;     // half of the 132 SMs

template <int TH, int KV, typename T>
int launch(const T* m, float* out, int B, int H, int W,
           cudaStream_t stream) {
  constexpr size_t smem = BlurTile<TH>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      blur_solve_kernel<TH, KV, T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  // a staged row starts on 16 bytes: 4 floats or 8 bf16 a chunk
  constexpr int kPerChunk = 16 / sizeof(T);
  const bool vec = W % kPerChunk == 0 &&
                   reinterpret_cast<uintptr_t>(m) % 16 == 0;
  blur_solve_kernel<TH, KV, T><<<tile_grid(B, H, W, TH), 32 * TH / KV, smem,
                                 stream>>>(m, out, H, W, vec);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const T* m, float* out, int B, int H, int W, void* stream) {
  if (B == 0 || H == 0 || W == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (use_small_tile(B, H, W, kLargeTH, kSmallTileBelow))
    return launch<kSmallTH, kSmallKV>(m, out, B, H, W, s);
  return launch<kLargeTH, kLargeKV>(m, out, B, H, W, s);
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
