// Multi-head self-attention, softmax(Q·Kᵀ·D^-½)·V per (batch, head) — Hopper
// kernels.
//
// Replaces the TPU kernel avd_tpu/ops/pallas/attention.py:mha (body
// _mha_kernel).  Numerics kept: bf16 q, k, v; the products of bf16 values
// are summed in float32; scores are scaled by `scale` (1/√D) in float32;
// the row softmax is exact (row max, exponential, sum, normalise over the
// whole row: no running max, no rescaling); P is rounded to bf16 after the
// normalisation and before P·V; P·V is summed in float32 and the output is
// rounded to bf16.  The tensor-core kernel takes exp(scale·(s − max)) as
// 2^((s − max)·scale·log2 e) on the special-function unit (relative error
// about 1e-6) and normalises with one reciprocal per row and a multiply per
// score (one float32 ulp from the quotient); both lie far inside P's bf16
// rounding (4e-3), and scaling, expf and a true division per score
// together took as long as everything else in the kernel.
//
// What bounds it on an H100: at the detector's shape (T = 197, D = 64) the
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
// 2. mha_general_kernel, for any T whose K and V fit shared memory: the
//    products run on the float32 cores.  Grid (b·h, query-row tile of 64),
//    8 warps; K and V staged as bf16 (rows padded by one 32-bit word), each
//    warp takes 4 query rows at a time, lanes take keys lane, lane+32, …,
//    scores go through a per-warp shared buffer, then each lane owns output
//    column pairs and walks the keys in order.
//
// q, k, v and o are addressed through element strides (batch, token, head;
// the last axis is dense), so the caller's [B,T,H,D] views of one qkv
// tensor and the [B,T,H·D] output need no copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
// 2. the general kernel (float32 cores)
// ---------------------------------------------------------------------------

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;             // query rows a warp holds at once
constexpr int kTileRows = 64;        // query rows per block
constexpr int kMaxPairs = 2;         // output column pairs per lane: D <= 128

__device__ __forceinline__ float2 bf2_to_f2(uint32_t w) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&w);
  return __bfloat1622float2(v);
}

__global__ void __launch_bounds__(kThreads)
mha_general_kernel(const __nv_bfloat16* __restrict__ q,
           const __nv_bfloat16* __restrict__ k,
           const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
           int H, int T, int D, Strides sq, Strides sk, Strides sv,
           Strides so, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int half_d = D / 2;
  const int kv_pitch = half_d + 1;  // 32-bit words per staged K/V row
  uint32_t* s_k = reinterpret_cast<uint32_t*>(smem_raw);
  uint32_t* s_v = s_k + static_cast<size_t>(T) * kv_pitch;
  float* s_q = reinterpret_cast<float*>(s_v + static_cast<size_t>(T) *
                                                  kv_pitch);
  float* s_p = s_q + kWarps * kRows * D;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x - b * H;

  // stage K and V of this (b, h): 16-byte reads, 4-byte shared writes
  {
    const __nv_bfloat16* kb = k + b * sk.b + h * sk.h;
    const __nv_bfloat16* vb = v + b * sv.b + h * sv.h;
    const int vec_per_row = D / 8;
    for (int i = tid; i < T * vec_per_row; i += kThreads) {
      const int row = i / vec_per_row;
      const int c = i - row * vec_per_row;
      const uint4 kk = *reinterpret_cast<const uint4*>(kb + row * sk.t +
                                                       c * 8);
      const uint4 vv = *reinterpret_cast<const uint4*>(vb + row * sv.t +
                                                       c * 8);
      uint32_t* dk = s_k + row * kv_pitch + c * 4;
      uint32_t* dv = s_v + row * kv_pitch + c * 4;
      dk[0] = kk.x; dk[1] = kk.y; dk[2] = kk.z; dk[3] = kk.w;
      dv[0] = vv.x; dv[1] = vv.y; dv[2] = vv.z; dv[3] = vv.w;
    }
  }
  __syncthreads();

  float* wq = s_q + warp * kRows * D;              // [kRows][D] float32
  float* wp = s_p + static_cast<size_t>(warp) * kRows * T;  // [kRows][T]
  const __nv_bfloat16* qb = q + b * sq.b + h * sq.h;
  __nv_bfloat16* ob = o + b * so.b + h * so.h;
  const int tile0 = blockIdx.y * kTileRows;

  for (int pass = 0; pass < kTileRows / (kWarps * kRows); ++pass) {
    const int row0 = tile0 + (pass * kWarps + warp) * kRows;
    if (row0 >= T) break;  // whole warp leaves together

    // the warp's query rows as float32; rows past T are zeros
    for (int i = lane; i < kRows * D; i += 32) {
      const int r = i / D;
      const int d = i - r * D;
      const int row = row0 + r;
      wq[i] = row < T ? __bfloat162float(qb[row * sq.t + d]) : 0.f;
    }
    __syncwarp();

    // scores: lane takes keys lane, lane+32, …
    float mx[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) mx[r] = -INFINITY;
    for (int j = lane; j < T; j += 32) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      const uint32_t* kr = s_k + j * kv_pitch;
      for (int dp = 0; dp < half_d; ++dp) {
        const float2 kk = bf2_to_f2(kr[dp]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float2 qq = *reinterpret_cast<const float2*>(wq + r * D +
                                                              2 * dp);
          acc[r] += qq.x * kk.x;
          acc[r] += qq.y * kk.y;
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float s = acc[r] * scale;
        wp[r * T + j] = s;
        mx[r] = fmaxf(mx[r], s);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
    }

    // e = exp(s - max), the row sums, then P = e / sum rounded to bf16
    float sum[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) sum[r] = 0.f;
    for (int j = lane; j < T; j += 32) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float e = expf(wp[r * T + j] - mx[r]);
        wp[r * T + j] = e;
        sum[r] += e;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], off);
    }
    for (int j = lane; j < T; j += 32) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = wp[r * T + j] / sum[r];
        wp[r * T + j] = __bfloat162float(__float2bfloat16_rn(p));
      }
    }
    __syncwarp();

    // P·V: lane owns column pairs lane, lane+32 (D <= 128)
    float2 out[kRows][kMaxPairs];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int c = 0; c < kMaxPairs; ++c) out[r][c] = make_float2(0.f, 0.f);
    for (int j = 0; j < T; ++j) {
      const uint32_t* vr = s_v + j * kv_pitch;
      float p[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) p[r] = wp[r * T + j];
#pragma unroll
      for (int c = 0; c < kMaxPairs; ++c) {
        const int dp = lane + 32 * c;
        if (dp < half_d) {
          const float2 vv = bf2_to_f2(vr[dp]);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            out[r][c].x += p[r] * vv.x;
            out[r][c].y += p[r] * vv.y;
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int row = row0 + r;
      if (row >= T) break;
#pragma unroll
      for (int c = 0; c < kMaxPairs; ++c) {
        const int dp = lane + 32 * c;
        if (dp < half_d) {
          *reinterpret_cast<__nv_bfloat162*>(ob + row * so.t + 2 * dp) =
              __floats2bfloat162_rn(out[r][c].x, out[r][c].y);
        }
      }
    }
    __syncwarp();  // wq / wp are rewritten by the next pass
  }
}

size_t general_smem_bytes(int T, int D) {
  const size_t kv = 2 * static_cast<size_t>(T) * (D / 2 + 1) * 4;
  const size_t qs = static_cast<size_t>(kWarps) * kRows * D * 4;
  const size_t ps = static_cast<size_t>(kWarps) * kRows * T * 4;
  return kv + qs + ps;
}

Strides strides(const int64_t* s) { return Strides{s[0], s[1], s[2]}; }

}  // namespace

// q, k, v, o of both entry points: bf16 on the current device, addressed as
// base + b·s[0] + t·s[1] + h·s[2] + d with the strides in elements (every
// stride a multiple of 8, every base 16-byte aligned, D a multiple of 8 up
// to 128).  Launched on `stream`; they return the first CUDA error.

// The largest T the tensor-core kernel is instantiated for.
extern "C" int avd_mha_mma_max_tokens() { return kMmaMaxTokens; }

// The tensor-core kernel: T <= avd_mha_mma_max_tokens().  A shape outside
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

// Dynamic shared memory the general kernel needs for (T, D), in bytes; the
// wrapper refuses shapes over the card's 227 KB per block.
extern "C" int64_t avd_mha_smem_bytes(int T, int D) {
  return static_cast<int64_t>(general_smem_bytes(T, D));
}

// The general kernel: any T whose K and V fit shared memory.
extern "C" int avd_mha_general(const void* q, const void* k, const void* v,
                               void* o, int B, int H, int T, int D,
                               const int64_t* sq, const int64_t* sk,
                               const int64_t* sv, const int64_t* so,
                               float scale, void* stream) {
  if (B == 0 || H == 0 || T == 0) return 0;
  const size_t smem = general_smem_bytes(T, D);
  cudaError_t err = cudaFuncSetAttribute(
      mha_general_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (T + kTileRows - 1) / kTileRows);
  mha_general_kernel<<<grid, kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      H, T, D, strides(sq), strides(sk), strides(sv), strides(so), scale);
  return static_cast<int>(cudaGetLastError());
}
