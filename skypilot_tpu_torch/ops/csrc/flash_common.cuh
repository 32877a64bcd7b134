// CUDA-core tiles and products of the flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu): the f32 route of K4, K5a and K5b. The
// bf16 tensor-core route's tile layer is flash_tc.cuh.
//
// Layout: q/k/v/o and their gradients are [B, S, H, D], lse and the
// row sums delta are [B, H, S] f32. A block of kThreads = 256 threads is
// a 16 x 16 grid: ty picks rows ty + 16 i, tx columns tx + 16 j, so the
// 16 lanes of one row group are one half of a warp and a row reduction
// is four xor-shuffles. Tiles live in shared memory as f32 with rows
// padded by 4 words (row stride D + 4): float4 reads along a row stay
// 16-byte aligned, and 8 neighbouring threads reading 8 different rows
// at one column fall in distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace flash {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

__device__ __forceinline__ size_t row_index(int b, int s, int S, int H,
                                            int h, int D) {
  return (((size_t)b * S + s) * H + h) * D;
}

// Rows [row0, row0 + R) of head h of a [B, S, H, D] tensor into `dst`
// (row stride D + 4) as f32; rows at or past S stage zeros.
template <typename T, int D, int R>
__device__ __forceinline__ void stage(float* dst, const T* src, int b,
                                      int row0, int S, int H, int h) {
  constexpr int ld = D + 4;
  for (int i = threadIdx.x; i < R * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    const int s = row0 + r;
    dst[r * ld + d] = s < S ? to_f(src[row_index(b, s, S, H, h, D) + d]) : 0.f;
  }
}

// Stage rows [row0, row0 + R) of dO into `do_sm` and their
// delta = rowsum(dO * O) into `delta_sm`, and the rows' lse into
// `lse_sm`; rows at or past S stage zeros. One warp per row, the lanes
// over head_dim.
template <typename T, int D, int R>
__device__ __forceinline__ void stage_do_delta(float* do_sm, float* delta_sm,
                                               float* lse_sm, const T* dO,
                                               const T* O, const float* lse,
                                               int b, int row0, int S, int H,
                                               int h) {
  constexpr int ld = D + 4;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < R; r += kThreads / 32) {
    const int s = row0 + r;
    float dot = 0.f;
#pragma unroll
    for (int d = lane; d < D; d += 32) {
      float g = 0.f;
      if (s < S) {
        const size_t idx = row_index(b, s, S, H, h, D) + d;
        g = to_f(dO[idx]);
        dot = fmaf(g, to_f(O[idx]), dot);
      }
      do_sm[r * ld + d] = g;
    }
#pragma unroll
    for (int w = 16; w > 0; w >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, w);
    if (lane == 0) {
      delta_sm[r] = dot;
      lse_sm[r] = s < S ? lse[((size_t)b * H + h) * S + s] : 0.f;
    }
  }
}

// out[i][j] = sum_d A[ty + 16 i][d] * Bm[tx + 16 j][d] (both row stride
// D + 4).
template <int D, int RM, int RN>
__device__ __forceinline__ void dot_nt(const float* A, const float* Bm,
                                       int ty, int tx, float (&out)[RM][RN]) {
  constexpr int ld = D + 4;
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) out[i][j] = 0.f;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 a[RM], bv[RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * ld + d);
#pragma unroll
    for (int j = 0; j < RN; ++j)
      bv[j] = *reinterpret_cast<const float4*>(Bm + (tx + 16 * j) * ld + d);
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        float acc = out[i][j];
        acc = fmaf(a[i].x, bv[j].x, acc);
        acc = fmaf(a[i].y, bv[j].y, acc);
        acc = fmaf(a[i].z, bv[j].z, acc);
        acc = fmaf(a[i].w, bv[j].w, acc);
        out[i][j] = acc;
      }
  }
}

__device__ __forceinline__ float lane_of(const float4& v, int kk) {
  return kk == 0 ? v.x : kk == 1 ? v.y : kk == 2 ? v.z : v.w;
}

// acc[i][j] += sum_k P[ty + 16 i][k] * V[k][tx + 16 j] for k < K;
// P has row stride ldp (a multiple of 4), V row stride D + 4.
template <int D, int RM, int K>
__device__ __forceinline__ void acc_nn(const float* P, int ldp,
                                       const float* V, int ty, int tx,
                                       float (&acc)[RM][D / 16]) {
  constexpr int ld = D + 4;
#pragma unroll 2
  for (int k = 0; k < K; k += 4) {
    float4 p4[RM];
#pragma unroll
    for (int i = 0; i < RM; ++i)
      p4[i] = *reinterpret_cast<const float4*>(P + (ty + 16 * i) * ldp + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float vj[D / 16];
#pragma unroll
      for (int j = 0; j < D / 16; ++j) vj[j] = V[(k + kk) * ld + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i) {
        const float p = lane_of(p4[i], kk);
#pragma unroll
        for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(p, vj[j], acc[i][j]);
      }
    }
  }
}

// acc[i][j] += sum_q P[q][ty + 16 i] * X[q][tx + 16 j] for q < Q;
// P has row stride ldp, X row stride D + 4.
template <int D, int RM, int Q>
__device__ __forceinline__ void acc_tn(const float* P, int ldp,
                                       const float* X, int ty, int tx,
                                       float (&acc)[RM][D / 16]) {
  constexpr int ld = D + 4;
#pragma unroll 4
  for (int q = 0; q < Q; ++q) {
    float p[RM], x[D / 16];
#pragma unroll
    for (int i = 0; i < RM; ++i) p[i] = P[q * ldp + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < D / 16; ++j) x[j] = X[q * ld + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] = fmaf(p[i], x[j], acc[i][j]);
  }
}

// Causal and bounds rule shared by all three kernels: query row `row`
// may attend key `col` (offset = Sk - Sq, bottom-right alignment).
__device__ __forceinline__ bool allowed(int row, int col, int Sq, int Sk,
                                        int offset, int causal) {
  return row < Sq && col < Sk && (!causal || col <= row + offset);
}

// Launch a kernel that takes `smem` bytes of dynamic shared memory;
// returns the CUDA error code of the attribute call or the launch.
template <typename Kernel, typename... Args>
int launch(Kernel kernel, dim3 grid, size_t smem, cudaStream_t stream,
           Args... args) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// f(std::integral_constant<int, D>{}) for a head_dim D that is a
// multiple of 16 up to 128 (each thread owns D / 16 output columns);
// any other D returns cudaErrorInvalidValue.
template <typename F>
int with_head_dim(int D, F&& f) {
  switch (D) {
    case 16: return f(std::integral_constant<int, 16>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 48: return f(std::integral_constant<int, 48>{});
    case 64: return f(std::integral_constant<int, 64>{});
    case 80: return f(std::integral_constant<int, 80>{});
    case 96: return f(std::integral_constant<int, 96>{});
    case 112: return f(std::integral_constant<int, 112>{});
    case 128: return f(std::integral_constant<int, 128>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace flash
