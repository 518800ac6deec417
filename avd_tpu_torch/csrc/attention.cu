// Multi-head self-attention, softmax(Q·Kᵀ·D^-½)·V per (batch, head) — Hopper
// kernel.
//
// Replaces the TPU kernel avd_tpu/ops/pallas/attention.py:mha (body
// _mha_kernel).  Numerics kept: bf16 q, k, v; the products of bf16 values
// are summed in float32; scores are scaled by `scale` (1/√D) in float32;
// the row softmax is exact (row max, expf, sum, divide: no running max);
// P is rounded to bf16 after the division and before P·V; P·V is summed in
// float32 and the output is rounded to bf16.
//
// What bounds it on an H100: at the detector's shape (T = 197, D = 64) the
// function moves 4·B·H·T·D·2 bytes and does 4·B·H·T²·D operations, about
// 98 operations per byte: below the tensor cores' balance point (295), so
// the least time is the bytes'.  This kernel does its products on the
// float32 cores, not the tensor cores, so it is bound by their rate and by
// shared-memory reads, far above that bound; it is the simple version.
//
// Design: grid (b·h, query-row tile of 64), 8 warps.  The block stages the
// head's K and V as bf16 in dynamic shared memory (rows padded by one
// 32-bit word so that 32 lanes reading 32 different rows hit 32 banks).
// Each warp takes 4 query rows at a time: it stages them as float32, each
// lane takes the keys lane, lane+32, … and forms the 4 dot products of a
// key at once (one K read feeds 4 rows), writes the scaled scores to the
// warp's shared buffer, reduces max and sum with shuffles, writes the
// bf16-rounded probabilities back, and then each lane owns output columns
// (pairs 2·lane, 2·lane+1, +64, …) and walks the keys in order.  Tails
// (T, rows) are masked; nothing is padded in device memory.  q, k, v and o
// are addressed through element strides (batch, token, head; the last
// axis is dense), so the caller's [B,T,H,D] views of one qkv tensor and
// the [B,T,H·D] output need no copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRows = 4;             // query rows a warp holds at once
constexpr int kTileRows = 64;        // query rows per block
constexpr int kMaxPairs = 2;         // output column pairs per lane: D <= 128

struct Strides {
  int64_t b, t, h;  // in elements; the last axis has stride 1
};

__device__ __forceinline__ float2 bf2_to_f2(uint32_t w) {
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&w);
  return __bfloat1622float2(v);
}

__global__ void __launch_bounds__(kThreads)
mha_kernel(const __nv_bfloat16* __restrict__ q,
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

size_t smem_bytes(int T, int D) {
  const size_t kv = 2 * static_cast<size_t>(T) * (D / 2 + 1) * 4;
  const size_t qs = static_cast<size_t>(kWarps) * kRows * D * 4;
  const size_t ps = static_cast<size_t>(kWarps) * kRows * T * 4;
  return kv + qs + ps;
}

}  // namespace

// Dynamic shared memory the kernel needs for (T, D), in bytes; the wrapper
// refuses shapes over the card's 227 KB per block.
extern "C" int64_t avd_mha_smem_bytes(int T, int D) {
  return static_cast<int64_t>(smem_bytes(T, D));
}

// q, k, v, o: bf16 on the current device, addressed as
// base + b·s[0] + t·s[1] + h·s[2] + d with the strides in elements
// (every stride a multiple of 8, every base 16-byte aligned, D a multiple
// of 8 up to 128).  Launched on `stream`; returns the first CUDA error.
extern "C" int avd_mha(const void* q, const void* k, const void* v, void* o,
                       int B, int H, int T, int D, const int64_t* sq,
                       const int64_t* sk, const int64_t* sv,
                       const int64_t* so, float scale, void* stream) {
  if (B == 0 || H == 0 || T == 0) return 0;
  const size_t smem = smem_bytes(T, D);
  cudaError_t err = cudaFuncSetAttribute(
      mha_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B * H, (T + kTileRows - 1) / kTileRows);
  mha_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      H, T, D, Strides{sq[0], sq[1], sq[2]}, Strides{sk[0], sk[1], sk[2]},
      Strides{sv[0], sv[1], sv[2]}, Strides{so[0], so[1], so[2]}, scale);
  return static_cast<int>(cudaGetLastError());
}
