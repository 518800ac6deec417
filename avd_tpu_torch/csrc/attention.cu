// Multi-head self-attention, softmax(Q·Kᵀ·D^-½)·V per (batch, head) — Hopper
// kernels.
//
// Replaces the TPU kernel avd_tpu/ops/pallas/attention.py:mha (body
// _mha_kernel).  Numerics kept: bf16 q, k, v; the products of bf16 values
// are summed in float32; scores are scaled by `scale` (1/√D) in float32;
// the row softmax is exact (every P from the whole row's max and sum: no
// rescaling of P or of O); P is rounded to bf16 after the normalisation
// and before P·V; P·V is summed in float32 and the output is rounded to
// bf16.  Both kernels take exp(scale·(s − max)) as
// 2^((s − max)·scale·log2 e) on the special-function unit (relative error
// about 1e-6) and normalises with one reciprocal per row and a multiply per
// score (one float32 ulp from the quotient); both lie far inside P's bf16
// rounding (4e-3), and scaling, expf and a true division per score
// together took as long as everything else in the kernel.
//
// What bounds it on an H100: at the ViT's shape (T = 197, D = 64) the
// function moves 4·B·H·T·D·2 bytes and does 4·B·H·T²·D operations, about
// 98 operations per byte: below the tensor cores' balance point (295), so
// with both products on the tensor cores the least time is the bytes'.
//
// Two kernels; the wrapper chooses by (T, D) alone.
//
// 1. mha_mma_kernel<NT, DK>, the tensor-core kernel, for T <= 16·NT keys
//    (instances NT = 2, 5, 13: T <= 32, 80, 208) and D <= DK (16, 64, 128).
//    Route: mma.sync.m16n8k16 (bf16 in, f32 out), not wgmma.  A wgmma tile
//    has 64 query rows, so T = 197 pads to 256 rows (23 % idle) against 208
//    with 16-row tiles (5 %), and the function is bound by bytes either
//    way.  A wgmma version (one warpgroup a block, Q, K and V in the
//    128-byte-swizzled layout, P from registers, the same softmax) was
//    written, agreed with the plain version and was slower than this
//    kernel on the card: the time goes to the softmax's instructions and to
//    the loads, which wgmma does not touch, not to the products.
//    Grid: one block per (batch, head), as the TPU kernel's grid (b, h);
//    up to 4 warps.
//    - K and V of the head are copied to shared memory as bf16 with 16-byte
//      cp.async straight from the caller's strided views (rows are D·2
//      dense bytes at a fixed element stride).  A row takes DK + 8 elements
//      (144 bytes at DK = 64): eight consecutive rows then start in eight
//      different 16-byte bank groups and every ldmatrix is free of bank
//      conflicts.  Rows T … 16·NT − 1 and columns D … DK − 1 are zero-filled
//      in shared memory and never read from device memory.  2 × 208 × 144 B
//      = 59,904 B, plus 2,304 B per warp to stage Q: 69,120 B a block, 3
//      blocks (12 warps) on an SM; registers (168 a thread at that
//      occupancy, all used) are the other limit.  K and V are two copy
//      groups: the scores start when Q and K have landed, V is awaited
//      before the first P·V.
//    - A warp owns 16 query rows at a time (tiles warp, warp + 4, …; at
//      T = 197 the 13 tiles make 4 passes and three warps idle in the
//      last).  It stages its Q rows with cp.async, loads the A fragments
//      once with ldmatrix, asks for the next tile's Q rows at once, and
//      forms S = Q·Kᵀ over all key tiles with K fragments from ldmatrix.
//      The whole score row stays in registers (16 × 208 f32 = 104
//      registers a thread at NT = 13).
//    - Softmax in registers: key columns >= T set to −∞, row max and row
//      sum by shuffles across the 4 lanes that share a row, the
//      exponential, normalise, round to bf16: seven instructions a score.
//      The accumulator layout of two adjacent n8 tiles is the A layout of
//      one k16 step, so P feeds the second product as it lies; V fragments
//      come by ldmatrix.trans.
//    - O (16 × DK f32) is rounded to bf16 and written from the accumulator
//      layout through the output strides (4 bytes a lane, 16 contiguous
//      bytes per row and n8 tile); rows >= T are not written.
//    What holds it at twice its bound: every block loads its K and V
//    before it computes and three blocks an SM overlap one block's loads
//    with the others' work only in part; a warp reads every K and V
//    fragment for only 16 query rows (108 ldmatrix.x4 and 208 mma a tile);
//    the last of the 4 passes over 13 tiles keeps one warp of four busy.
//    PERF.md has the measurements.
//
// 2. mha_tiled_kernel<DK, MR>, the tensor-core kernel for T > 208 keys
//    (the TimeSformer's spatial attention: T = 785, D = 64), for every D
//    the wrapper takes, zero-padded to DK = 64 or 128.  It replaces the
//    same TPU kernel at the lengths where the score row no longer fits a
//    warp's registers, and has no shared-memory ceiling on T.
//    Bound: at the TimeSformer's largest call [B=128, T=785, H=12, D=64]
//    the function does 4·B·H·T²·D = 2.42e11 operations (0.245 ms at 989
//    TFLOP/s) and moves 617 MB (0.184 ms at 3.35 TB/s), 392 operations a
//    byte: bound by the tensor cores.
//    Route: mma.sync.m16n8k16 from mma.cuh, as kernel 1.
//    Grid: one block per (batch·head, query tile), the query tiles of one
//    head in consecutive blocks so that its K and V stay in L2.  A warp
//    owns 16·MR query rows (MR = 2 at DK = 64: every K and V fragment
//    feeds two m16 tiles, which halves the ldmatrix traffic a product; 1
//    at DK = 128, for registers); a block takes 5 warps (T = 785: 160
//    rows, 800 padded rows against 832 at 64-row tiles; at other lengths
//    the last block's padding costs only idle warps).  Q is staged once
//    and held as A fragments; K
//    and V tiles of 64 keys stream through a ring of 2 shared-memory
//    stages by cp.async, the next tile in flight behind the one in use.
//    Three blocks an SM (15 warps; 128 registers, 60 KB at DK = 64):
//    the kernel waits on its own latencies (products → exponentials →
//    products within a warp), and the third block hid more of them than a
//    third ring stage or fewer registers a warp did (PERF.md).
//    Numerics as kernel 1, in two passes over the key tiles:
//    - pass 1 forms S = Q·Kᵀ tile by tile and keeps, per lane and row,
//      the running f32 max of its columns and the sum of 2^((s − max)·
//      scale·log2 e), rescaled when the max grows; the four lanes of a row
//      then agree on the row's max and sum;
//    - pass 2 forms S again, chunk of 16 keys by chunk, P = 2^((s − max)·
//      scale·log2 e) · (1/sum) rounded to bf16 (normalised before the
//      rounding, as the plain version), and accumulates P·V in f32 with P
//      as the A operand as it lies.
//    Keys past T read −∞ (their chunks are skipped, their columns in the
//    chunk that crosses T masked); query rows past T are zeros and are not
//    written.  The second Q·Kᵀ costs half as many products again: the
//    price of the exact softmax, which an online form (P rounded before
//    its normalisation) would not pay.
//    What holds it above the bound (1.57 ms at the call above, 6.4 times;
//    PERF.md has the measurements): the second Q·Kᵀ (1.5× the products,
//    with the padding 1.56×); two exponentials a score on the
//    special-function unit (16 a clock an SM: 2.0e9 of them, about 0.5 ms
//    alone) beside the softmax's float32 instructions; mma.sync's issue
//    rate below wgmma's; and each warp's chain from products to
//    exponentials to products, which 15 warps an SM hide only in part.
//
// q, k, v and o are addressed through element strides (batch, token, head;
// the last axis is dense), so the caller's [B,T,H,D] views of one qkv
// tensor and the [B,T,H·D] output need no copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

#include "mma.cuh"

namespace {

struct Strides {
  int64_t b, t, h;  // in elements; the last axis has stride 1
};

// ---------------------------------------------------------------------------
// 1. the tensor-core kernel
// ---------------------------------------------------------------------------

// 2^x by the special-function unit; relative error about 2^-22, results
// below 2^-126 flushed to zero, 2^-∞ = 0.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr int kMmaWarps = 4;
constexpr int kMmaMaxTokens = 208;  // 16 · the largest NT instantiated

// Copy rows [first_row, first_row + n_rows) of a strided [T, D] bf16 matrix
// into dst[n_rows][DK + 8]: live 16-byte chunks by cp.async, rows >= T and
// columns >= D as zeros.  Work item `idx0`, `idx0 + step`, … of the caller.
template <int DK>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src,
                                           int64_t row_stride, int first_row,
                                           int n_rows, int T, int D, int idx0,
                                           int step) {
  constexpr int kChunks = DK / 8;  // 16-byte chunks per padded row
  constexpr int kPitch = DK + 8;
  const int live = D / 8;
  for (int i = idx0; i < n_rows * kChunks; i += step) {
    const int r = i / kChunks;
    const int c = i - r * kChunks;
    __nv_bfloat16* d = dst + r * kPitch + c * 8;
    const int row = first_row + r;
    if (row < T && c < live) {
      avd::cp_async_16(d, src + row * row_stride + c * 8);
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int NT, int DK>
__global__ void __launch_bounds__(kMmaWarps * 32, DK <= 64 ? 3 : 1)
mha_mma_kernel(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ o, int H, int T, int D, Strides sq,
               Strides sk, Strides sv, Strides so, float scale) {
  constexpr int kKeys = 16 * NT;   // padded key count
  constexpr int kPitch = DK + 8;   // bf16 elements per staged row
  constexpr int kSteps = DK / 16;  // k16 steps of Q·Kᵀ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* s_k = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* s_v = s_k + kKeys * kPitch;
  __nv_bfloat16* s_q = s_v + kKeys * kPitch;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_warps = blockDim.x >> 5;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;
  const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
  __nv_bfloat16* ob = o + b * so.b + h * so.h;
  __nv_bfloat16* wq = s_q + warp * 16 * kPitch;  // this warp's Q rows

  // the warp's first Q tile, then K and V of the head, all in flight at once
  stage_rows<DK>(wq, qb, sq.t, warp * 16, 16, T, D, lane, 32);
  stage_rows<DK>(s_k, k + b * sk.b + h * sk.h, sk.t, 0, kKeys, T, D, tid,
                 blockDim.x);
  avd::cp_async_commit();
  stage_rows<DK>(s_v, v + b * sv.b + h * sv.h, sv.t, 0, kKeys, T, D, tid,
                 blockDim.x);
  avd::cp_async_commit();
  avd::cp_async_wait_group<1>();  // Q and K; V lands behind the first scores
  __syncthreads();

  const float scale_log2e = scale * 1.4426950408889634f;
  const int g = lane >> 2;  // the fragment row this lane holds (and g + 8)
  const int t4 = lane & 3;
  // ldmatrix row addresses: Q (A operand) and V (B, transposed) take rows
  // l%8 + 8·(l/8 %2) at column 8·(l/16); K (B operand) takes rows
  // l%8 + 8·(l/16) at column 8·(l/8 %2).
  const int a_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * kPitch +
                    (lane >> 4) * 8;
  const int k_off = ((lane & 7) + (lane >> 4) * 8) * kPitch +
                    ((lane >> 3) & 1) * 8;

  for (int row0 = warp * 16; row0 < T; row0 += n_warps * 16) {
    if (row0 != warp * 16) {  // the tile's Q was prefetched a tile ago
      avd::cp_async_wait_all();
      __syncwarp();
    }
    uint32_t qa[kSteps][4];
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks)
      avd::ldmatrix_x4(qa[ks], wq + a_off + ks * 16);
    __syncwarp();
    if (row0 + n_warps * 16 < T)  // the next tile's Q, behind this tile's work
      stage_rows<DK>(wq, qb, sq.t, row0 + n_warps * 16, 16, T, D, lane, 32);

    // S = Q·Kᵀ: n8 tile 2j holds keys 16j … 16j+7, tile 2j+1 the next 8
    float s[2 * NT][4];
#pragma unroll
    for (int n = 0; n < 2 * NT; ++n)
      s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t kf[4];
        avd::ldmatrix_x4(kf, s_k + k_off + j * 16 * kPitch + ks * 16);
        avd::mma_bf16_16816(s[2 * j], qa[ks], kf[0], kf[1]);
        avd::mma_bf16_16816(s[2 * j + 1], qa[ks], kf[2], kf[3]);
      }
    }

    // exact softmax of rows g (elements 0, 1) and g + 8 (elements 2, 3).
    // exp(scale·s − scale·max) is taken as 2^((s − max)·scale·log2 e): the
    // row max of the raw scores is the max of the scaled ones (scale > 0),
    // and the exponent differs from the plain version's by a few float32
    // roundings (relative error of e about 1e-6, P's bf16 rounding 4e-3).
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 2 * NT; ++n) {
      if (n * 8 + 8 > T) {  // the tile crosses T: mask the padded keys
        const int col = n * 8 + 2 * t4;
        if (col >= T) s[n][0] = s[n][2] = -INFINITY;
        if (col + 1 >= T) s[n][1] = s[n][3] = -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int n = 0; n < 2 * NT; ++n) {
      s[n][0] = exp2_approx((s[n][0] - mx0) * scale_log2e);
      s[n][1] = exp2_approx((s[n][1] - mx0) * scale_log2e);
      s[n][2] = exp2_approx((s[n][2] - mx1) * scale_log2e);
      s[n][3] = exp2_approx((s[n][3] - mx1) * scale_log2e);
      sum0 += s[n][0] + s[n][1];
      sum1 += s[n][2] + s[n][3];
    }
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);

    if (row0 == warp * 16) {  // V has landed; every warp has a first tile
      avd::cp_async_wait_all();
      __syncthreads();
    }
    // P = e · (1 / sum) as bf16; k16 step j of P is score tiles 2j and 2j+1
    // as they lie
    uint32_t pa[NT][4];
    const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
    float acc[DK / 8][4];
#pragma unroll
    for (int n = 0; n < DK / 8; ++n)
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      pa[j][0] = pack_bf16(s[2 * j][0] * inv0, s[2 * j][1] * inv0);
      pa[j][1] = pack_bf16(s[2 * j][2] * inv1, s[2 * j][3] * inv1);
      pa[j][2] = pack_bf16(s[2 * j + 1][0] * inv0, s[2 * j + 1][1] * inv0);
      pa[j][3] = pack_bf16(s[2 * j + 1][2] * inv1, s[2 * j + 1][3] * inv1);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int i = 0; i < kSteps; ++i) {
        uint32_t vf[4];
        avd::ldmatrix_x4_trans(vf, s_v + a_off + j * 16 * kPitch + i * 16);
        avd::mma_bf16_16816(acc[2 * i], pa[j], vf[0], vf[1]);
        avd::mma_bf16_16816(acc[2 * i + 1], pa[j], vf[2], vf[3]);
      }
    }

    // O as bf16 through the output strides: a lane holds two neighbouring
    // columns of rows g and g + 8 in each n8 tile
#pragma unroll
    for (int n = 0; n < DK / 8; ++n) {
      const int col = n * 8 + 2 * t4;
      if (col < D) {
        if (row0 + g < T)
          *reinterpret_cast<uint32_t*>(ob + (row0 + g) * so.t + col) =
              pack_bf16(acc[n][0], acc[n][1]);
        if (row0 + g + 8 < T)
          *reinterpret_cast<uint32_t*>(ob + (row0 + g + 8) * so.t + col) =
              pack_bf16(acc[n][2], acc[n][3]);
      }
    }
  }
}

template <int NT, int DK>
int launch_mma(const __nv_bfloat16* q, const __nv_bfloat16* k,
               const __nv_bfloat16* v, __nv_bfloat16* o, int B, int H, int T,
               int D, Strides sq, Strides sk, Strides sv, Strides so,
               float scale, cudaStream_t stream) {
  constexpr size_t kRow = (DK + 8) * sizeof(__nv_bfloat16);
  constexpr size_t kMaxSmem = (2 * 16 * NT + kMmaWarps * 16) * kRow;
  const int tiles = (T + 15) / 16;
  const int warps = tiles < kMmaWarps ? tiles : kMmaWarps;
  const size_t smem = (2 * 16 * NT + warps * 16) * kRow;
  cudaError_t err = cudaFuncSetAttribute(
      mha_mma_kernel<NT, DK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kMaxSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  mha_mma_kernel<NT, DK><<<B * H, warps * 32, smem, stream>>>(
      q, k, v, o, H, T, D, sq, sk, sv, so, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// 2. the tiled tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kTileKeys = 64;    // keys per streamed K/V tile
constexpr int kTileStages = 2;   // ring slots: one tile in flight
constexpr int kTiledWarps = 5;    // warps a block

template <int DK, int MR>
__global__ void __launch_bounds__(kTiledWarps * 32, 3)
mha_tiled_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, int H, int T, int D,
                 Strides sq, Strides sk, Strides sv, Strides so, float scale,
                 int q_tiles) {
  constexpr int kPitch = DK + 8;             // bf16 elements per staged row
  constexpr int kSteps = DK / 16;            // k16 steps of Q·Kᵀ
  constexpr int kTile = kTileKeys * kPitch;  // elements of a staged K or V
  constexpr int kChunks = kTileKeys / 16;    // 16-key chunks of a tile
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // ring slot i: K tile at s_ring + 2·i·kTile, V tile right after it
  __nv_bfloat16* s_ring = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* s_q = s_ring + kTileStages * 2 * kTile;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n_threads = blockDim.x;
  const int block_rows = (n_threads >> 5) * 16 * MR;
  const int bh = blockIdx.x / q_tiles;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (blockIdx.x - bh * q_tiles) * block_rows;
  const __nv_bfloat16* kb = k + b * sk.b + h * sk.h;
  const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;
  const int n_kt = (T + kTileKeys - 1) / kTileKeys;  // key tiles a pass

  // Step i of the 2·n_kt steps stages key tile i mod n_kt (K alone in
  // pass 1, K and V in pass 2) into ring slot i mod kTileStages: one
  // commit group a step, empty past the last.
  auto stage = [&](int i) {
    if (i < 2 * n_kt) {
      __nv_bfloat16* slot = s_ring + (i % kTileStages) * 2 * kTile;
      const int key0 = (i < n_kt ? i : i - n_kt) * kTileKeys;
      stage_rows<DK>(slot, kb, sk.t, key0, kTileKeys, T, D, tid, n_threads);
      if (i >= n_kt)
        stage_rows<DK>(slot + kTile, vb, sv.t, key0, kTileKeys, T, D, tid,
                       n_threads);
    }
    avd::cp_async_commit();
  };
  // Wait for step i's tile (the later steps' may stay in flight), make it
  // visible to every warp, and refill the slot that step i − 1 used,
  // which every warp has left by the barrier.
  auto arrive = [&](int i) {
    avd::cp_async_wait_group<kTileStages - 2>();
    __syncthreads();
    stage(i + kTileStages - 1);
    return s_ring + (i % kTileStages) * 2 * kTile;
  };

  // the block's Q rows travel with the first K tile
  stage_rows<DK>(s_q, q + b * sq.b + h * sq.h, sq.t, q0, block_rows, T, D,
                 tid, n_threads);
  for (int i = 0; i < kTileStages - 1; ++i) stage(i);

  const float c = scale * 1.4426950408889634f;  // scale · log2 e
  const int g = lane >> 2;  // the fragment row this lane holds (and g + 8)
  const int t4 = lane & 3;
  // ldmatrix row addresses, as kernel 1's
  const int a_off = ((lane & 7) + ((lane >> 3) & 1) * 8) * kPitch +
                    (lane >> 4) * 8;
  const int k_off = ((lane & 7) + (lane >> 4) * 8) * kPitch +
                    ((lane >> 3) & 1) * 8;
  const int row0 = q0 + warp * 16 * MR;  // the warp's first query row
  const bool live = row0 < T;            // a warp wholly past T only stages

  // pass 1: per lane, the running max and sum of rows g (r = 0) and g + 8
  // (r = 1) of each m16 tile over this lane's columns
  uint32_t qa[MR][kSteps][4];
  float mx[MR][2], sm[MR][2];
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    mx[m][0] = mx[m][1] = -INFINITY;
    sm[m][0] = sm[m][1] = 0.f;
  }
  for (int i = 0; i < n_kt; ++i) {
    const __nv_bfloat16* s_k = arrive(i);
    if (i == 0) {
#pragma unroll
      for (int m = 0; m < MR; ++m)
#pragma unroll
        for (int ks = 0; ks < kSteps; ++ks)
          avd::ldmatrix_x4(qa[m][ks],
                           s_q + (warp * MR + m) * 16 * kPitch + a_off +
                               ks * 16);
    }
    if (!live) continue;
    const int key0 = i * kTileKeys;
    // S over the tile: n8 tile n holds keys key0 + 8n … key0 + 8n + 7;
    // chunks wholly past T are left at 0 and masked below
    float s[MR][2 * kChunks][4];
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int n = 0; n < 2 * kChunks; ++n)
        s[m][n][0] = s[m][n][1] = s[m][n][2] = s[m][n][3] = 0.f;
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
      if (key0 + 16 * ch < T) {
#pragma unroll
        for (int ks = 0; ks < kSteps; ++ks) {
          uint32_t kf[4];
          avd::ldmatrix_x4(kf, s_k + k_off + ch * 16 * kPitch + ks * 16);
#pragma unroll
          for (int m = 0; m < MR; ++m) {
            avd::mma_bf16_16816(s[m][2 * ch], qa[m][ks], kf[0], kf[1]);
            avd::mma_bf16_16816(s[m][2 * ch + 1], qa[m][ks], kf[2], kf[3]);
          }
        }
      }
    }
    if (key0 + kTileKeys > T) {  // the tile crosses T: mask the padded keys
#pragma unroll
      for (int n = 0; n < 2 * kChunks; ++n) {
        const int col = key0 + n * 8 + 2 * t4;
#pragma unroll
        for (int m = 0; m < MR; ++m) {
          if (col >= T) s[m][n][0] = s[m][n][2] = -INFINITY;
          if (col + 1 >= T) s[m][n][1] = s[m][n][3] = -INFINITY;
        }
      }
    }
    // the first tile holds 64 live keys (T > 208), so every lane's max is
    // finite from it on and no exponent below is ∞ − ∞
#pragma unroll
    for (int m = 0; m < MR; ++m) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float tmax = -INFINITY;
#pragma unroll
        for (int n = 0; n < 2 * kChunks; ++n)
          tmax = fmaxf(tmax, fmaxf(s[m][n][2 * r], s[m][n][2 * r + 1]));
        const float mnew = fmaxf(mx[m][r], tmax);
        const float mc = mnew * c;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < 2 * kChunks; ++n)
          sum += exp2_approx(fmaf(s[m][n][2 * r], c, -mc)) +
                 exp2_approx(fmaf(s[m][n][2 * r + 1], c, -mc));
        sm[m][r] = sm[m][r] * exp2_approx((mx[m][r] - mnew) * c) + sum;
        mx[m][r] = mnew;
      }
    }
  }

  // the row's max and sum over its four lanes; then exp2(s·c − mc)·inv
  float mcs[MR][2], inv[MR][2];
#pragma unroll
  for (int m = 0; m < MR; ++m) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mrow = fmaxf(mx[m][r], __shfl_xor_sync(0xffffffffu, mx[m][r], 1));
      mrow = fmaxf(mrow, __shfl_xor_sync(0xffffffffu, mrow, 2));
      float l = sm[m][r] * exp2_approx((mx[m][r] - mrow) * c);
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      mcs[m][r] = mrow * c;
      inv[m][r] = 1.f / l;
    }
  }

  // pass 2: S again, 16 keys at a time, P normalised and rounded, P·V
  float acc[MR][DK / 8][4];
#pragma unroll
  for (int m = 0; m < MR; ++m)
#pragma unroll
    for (int n = 0; n < DK / 8; ++n)
      acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.f;
  for (int j = 0; j < n_kt; ++j) {
    const __nv_bfloat16* s_k = arrive(n_kt + j);
    const __nv_bfloat16* s_v = s_k + kTile;
    if (!live) continue;
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
      const int key0 = j * kTileKeys + 16 * ch;
      if (key0 >= T) break;
      float s[MR][2][4];
#pragma unroll
      for (int m = 0; m < MR; ++m)
#pragma unroll
        for (int n = 0; n < 2; ++n)
          s[m][n][0] = s[m][n][1] = s[m][n][2] = s[m][n][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
        uint32_t kf[4];
        avd::ldmatrix_x4(kf, s_k + k_off + ch * 16 * kPitch + ks * 16);
#pragma unroll
        for (int m = 0; m < MR; ++m) {
          avd::mma_bf16_16816(s[m][0], qa[m][ks], kf[0], kf[1]);
          avd::mma_bf16_16816(s[m][1], qa[m][ks], kf[2], kf[3]);
        }
      }
      if (key0 + 16 > T) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const int col = key0 + n * 8 + 2 * t4;
#pragma unroll
          for (int m = 0; m < MR; ++m) {
            if (col >= T) s[m][n][0] = s[m][n][2] = -INFINITY;
            if (col + 1 >= T) s[m][n][1] = s[m][n][3] = -INFINITY;
          }
        }
      }
      // P as the A operand of one k16 step: score tiles 0 and 1 as they lie
      uint32_t pa[MR][4];
#pragma unroll
      for (int m = 0; m < MR; ++m) {
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const float p0 = exp2_approx(fmaf(s[m][n][2 * r], c,
                                              -mcs[m][r])) * inv[m][r];
            const float p1 = exp2_approx(fmaf(s[m][n][2 * r + 1], c,
                                              -mcs[m][r])) * inv[m][r];
            pa[m][2 * n + r] = pack_bf16(p0, p1);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kSteps; ++i) {
        uint32_t vf[4];
        avd::ldmatrix_x4_trans(vf, s_v + a_off + ch * 16 * kPitch + i * 16);
#pragma unroll
        for (int m = 0; m < MR; ++m) {
          avd::mma_bf16_16816(acc[m][2 * i], pa[m], vf[0], vf[1]);
          avd::mma_bf16_16816(acc[m][2 * i + 1], pa[m], vf[2], vf[3]);
        }
      }
    }
  }
  if (!live) return;

  // O as bf16 through the output strides, as kernel 1
  __nv_bfloat16* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    const int r0 = row0 + m * 16;
#pragma unroll
    for (int n = 0; n < DK / 8; ++n) {
      const int col = n * 8 + 2 * t4;
      if (col < D) {
        if (r0 + g < T)
          *reinterpret_cast<uint32_t*>(ob + (r0 + g) * so.t + col) =
              pack_bf16(acc[m][n][0], acc[m][n][1]);
        if (r0 + g + 8 < T)
          *reinterpret_cast<uint32_t*>(ob + (r0 + g + 8) * so.t + col) =
              pack_bf16(acc[m][n][2], acc[m][n][3]);
      }
    }
  }
}

template <int DK, int MR>
int launch_tiled(const __nv_bfloat16* q, const __nv_bfloat16* k,
                 const __nv_bfloat16* v, __nv_bfloat16* o, int B, int H,
                 int T, int D, Strides sq, Strides sk, Strides sv,
                 Strides so, float scale, cudaStream_t stream) {
  constexpr int kWarpRows = 16 * MR;
  constexpr size_t kRow = (DK + 8) * sizeof(__nv_bfloat16);
  constexpr size_t kRing = kTileStages * 2 * kTileKeys * kRow;
  constexpr int rows = kTiledWarps * kWarpRows;
  const int q_tiles = (T + rows - 1) / rows;
  const int64_t blocks = static_cast<int64_t>(B) * H * q_tiles;
  if (blocks > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      mha_tiled_kernel<DK, MR>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kRing + rows * kRow));
  if (err != cudaSuccess) return static_cast<int>(err);
  mha_tiled_kernel<DK, MR><<<static_cast<int>(blocks), kTiledWarps * 32,
                             kRing + rows * kRow, stream>>>(
      q, k, v, o, H, T, D, sq, sk, sv, so, scale, q_tiles);
  return static_cast<int>(cudaGetLastError());
}

Strides strides(const int64_t* s) { return Strides{s[0], s[1], s[2]}; }

}  // namespace

// q, k, v, o of both entry points: bf16 on the current device, addressed as
// base + b·s[0] + t·s[1] + h·s[2] + d with the strides in elements (every
// stride a multiple of 8, every base 16-byte aligned, D a multiple of 8 up
// to 128).  Launched on `stream`; they return the first CUDA error.

// The largest T the tensor-core kernel is instantiated for.
extern "C" int avd_mha_mma_max_tokens() { return kMmaMaxTokens; }

// Kernel 1: T <= avd_mha_mma_max_tokens().  A shape outside
// its instances is refused (cudaErrorInvalidValue), never rerouted.
extern "C" int avd_mha_mma(const void* q, const void* k, const void* v,
                           void* o, int B, int H, int T, int D,
                           const int64_t* sq, const int64_t* sk,
                           const int64_t* sv, const int64_t* so, float scale,
                           void* stream) {
  if (B == 0 || H == 0 || T == 0) return 0;
  if (T > kMmaMaxTokens || D < 8 || D > 128 || D % 8)
    return static_cast<int>(cudaErrorInvalidValue);
#define AVD_MHA_LAUNCH(NT, DK)                                              \
  return launch_mma<NT, DK>(                                                \
      static_cast<const __nv_bfloat16*>(q),                                 \
      static_cast<const __nv_bfloat16*>(k),                                 \
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), \
      B, H, T, D, strides(sq), strides(sk), strides(sv), strides(so),       \
      scale, static_cast<cudaStream_t>(stream))
#define AVD_MHA_BY_DK(NT)                 \
  if (D <= 16) AVD_MHA_LAUNCH(NT, 16);    \
  if (D <= 64) AVD_MHA_LAUNCH(NT, 64);    \
  AVD_MHA_LAUNCH(NT, 128)
  if (T <= 32) { AVD_MHA_BY_DK(2); }
  if (T <= 80) { AVD_MHA_BY_DK(5); }
  AVD_MHA_BY_DK(13);
#undef AVD_MHA_BY_DK
#undef AVD_MHA_LAUNCH
}

// Kernel 2: T > avd_mha_mma_max_tokens(), any length.  A shorter
// T is refused (cudaErrorInvalidValue), never rerouted: its first key
// tile must hold 64 live keys.
extern "C" int avd_mha_tiled(const void* q, const void* k, const void* v,
                             void* o, int B, int H, int T, int D,
                             const int64_t* sq, const int64_t* sk,
                             const int64_t* sv, const int64_t* so,
                             float scale, void* stream) {
  if (B == 0 || H == 0 || T == 0) return 0;
  if (T <= kMmaMaxTokens || D < 8 || D > 128 || D % 8)
    return static_cast<int>(cudaErrorInvalidValue);
#define AVD_TILED_LAUNCH(DK, MR)                                            \
  return launch_tiled<DK, MR>(                                              \
      static_cast<const __nv_bfloat16*>(q),                                 \
      static_cast<const __nv_bfloat16*>(k),                                 \
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), \
      B, H, T, D, strides(sq), strides(sk), strides(sv), strides(so),       \
      scale, static_cast<cudaStream_t>(stream))
  if (D <= 64) AVD_TILED_LAUNCH(64, 2);
  AVD_TILED_LAUNCH(128, 1);
#undef AVD_TILED_LAUNCH
}
