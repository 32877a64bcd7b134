// Chunked-prefill attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel skypilot_tpu/ops/flash_attention.py::
// _chunk_fwd_kernel (driven by _chunk_fwd_pallas). Row g of a chunk
// batch holds C prompt tokens at global positions q_offset[g] + i; its
// prompt-region K/V [S, n_kv, D] already hold the chunk. Query i may
// attend to kv_pos <= q_offset[g] + i (earlier chunks plus causal within
// the chunk); GQA query head h reads kv head h / (H / n_kv), with no
// repeat. The cache is bf16/f32 like q, or int8 with per-vector bf16
// scales [G, S, n_kv] (the TPU version sent int8 caches to its einsum
// reference; here the kernel takes them).
//
// What bounds it on an H100: at the engine's shapes (2 rows of C=128
// queries, 32 heads, D=128, offsets 0..384) the card's least time is
// about 2 us either way — ~7 MB of q, live K/V and output over the
// memory rate, ~1 GFLOP over the bf16 tensor-core rate — and the
// operations take over as offsets grow (each K/V tile feeds 64 query
// rows). The type of q picks one of two kernels:
//
// bf16 (chunk_prefill_tc_kernel, bf16 or int8 cache) runs both products
// on the tensor cores (flash_tc.cuh), as K4's bf16 forward does with
// K2's mask and cache layout: one block (one warpgroup) per 64 queries of
// one head, so the engine's shape gives 2 x 32 x 2 = 128 blocks; 64-key
// tiles of K and V double-buffered, S = Q K^T and O += P V on wgmma (P
// from registers as bf16, V through the transpose bit), the online
// softmax in f32 on the fragments in log2 units. A bf16 cache loads with
// cp.async; an int8 one through registers, converted to bf16 exactly,
// its loads started before the current tile's products and stored after
// them. Its scales stay out of the tiles, as the reference applies them:
// the K scale multiplies the f32 scores, l sums the unscaled P, and P V
// takes bf16(P * v_scale). Rows g run in descending offset order, and
// within a row the query tiles with the most keys first.
//
// f32 (chunk_prefill_kernel) keeps full-f32 math on the CUDA cores, so
// the f32 route holds its 1e-4 bar (TF32 products would not): one block
// per (32-query tile, head, row), K then V staged as f32 in one buffer,
// int8 dequantized while staging.
//
// Both kernels stop the key loop at the block's causal frontier
// min(S, offset + last query + 1), so K/V past it are never read; rows
// past the frontier stage as zeros (with zero scales for int8), so NaN
// garbage past offset + C never reaches the accumulator; masked
// probabilities are zeroed explicitly; query rows past C are zero-filled
// and never written, so C needs no multiple of the tile.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "flash_tc.cuh"

namespace {

constexpr int kThreads = 128;  // 16 row groups x 8 column lanes
constexpr int kBq = 32;        // query rows per block
constexpr int kBk = 32;        // cache positions per tile
constexpr int kMaxD = 128;
constexpr int kLd = kMaxD + 1;  // padded row: conflict-free column reads
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

// Stage rows [pos0, pos0 + kBk) of one kv head into `dst` as f32, times
// the row's scale for an int8 cache; rows at or past `end` stage zeros.
template <typename KV>
__device__ __forceinline__ void stage_rows(float* dst, const KV* src,
                                           const __nv_bfloat16* scale,
                                           int g, int pos0, int end, int S,
                                           int n_kv, int kh, int D) {
  for (int i = threadIdx.x; i < kBk * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    const int pos = pos0 + r;
    float x = 0.f;
    if (pos < end) {
      const size_t row = ((size_t)g * S + pos) * n_kv + kh;
      x = to_f(src[row * D + d]);
      if (scale != nullptr) x *= __bfloat162float(scale[row]);
    }
    dst[r * kLd + d] = x;
  }
}

// T: query/output type (float; a bf16 q takes chunk_prefill_tc_kernel).
// KV: cache type (T or int8).
template <typename T, typename KV>
__global__ void __launch_bounds__(kThreads) chunk_prefill_kernel(
    const T* __restrict__ q,                    // [G, C, H, D]
    const KV* __restrict__ k,                   // [G, S, n_kv, D]
    const KV* __restrict__ v,                   // [G, S, n_kv, D]
    const __nv_bfloat16* __restrict__ k_scale,  // [G, S, n_kv] or null
    const __nv_bfloat16* __restrict__ v_scale,  // [G, S, n_kv] or null
    const int* __restrict__ q_offset,           // [G]
    T* __restrict__ out,                        // [G, C, H, D]
    int C, int S, int H, int n_kv, int D, float scale) {
  __shared__ float q_sm[kBq * kLd];
  __shared__ float kv_sm[kBk * kLd];   // K tile, then V tile
  __shared__ float p_sm[kBq * (kBk + 1)];

  const int q0 = blockIdx.x * kBq;
  const int h = blockIdx.y;
  const int g = blockIdx.z;
  const int kh = h / (H / n_kv);
  const int tid = threadIdx.x;
  const int ty = tid >> 3;  // rows ty and ty + 16
  const int tx = tid & 7;   // columns tx + 8c
  const int off = q_offset[g];
  const int q_hi = min(C, q0 + kBq);
  // One past the last position any query of this tile may attend.
  const int kv_end = min(S, off + q_hi);

  for (int i = tid; i < kBq * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    const int qi = q0 + r;
    q_sm[r * kLd + d] =
        qi < C ? to_f(q[(((size_t)g * C + qi) * H + h) * D + d]) : 0.f;
  }

  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  float acc[2][kMaxD / 8];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int i = 0; i < kMaxD / 8; ++i) acc[a][i] = 0.f;

  for (int kt = 0; kt < kv_end; kt += kBk) {
    __syncthreads();  // the previous tile's V reads are done
    stage_rows(kv_sm, k, k_scale, g, kt, kv_end, S, n_kv, kh, D);
    __syncthreads();

    float s[2][4];
    bool allow[2][4];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const int row = ty + 16 * a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = tx + 8 * c;
        float dot = 0.f;
        for (int d = 0; d < D; ++d)
          dot += q_sm[row * kLd + d] * kv_sm[col * kLd + d];
        const int kpos = kt + col;
        allow[a][c] = (q0 + row < C) && (kpos < kv_end) &&
                      (kpos <= off + q0 + row);
        s[a][c] = allow[a][c] ? dot * scale : kNegInf;
      }
    }
    // Online softmax; the 8 lanes of a row group are adjacent in a warp.
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      float mx = fmaxf(fmaxf(s[a][0], s[a][1]), fmaxf(s[a][2], s[a][3]));
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[a], mx);
      const float corr = expf(m[a] - m_new);
      float sum = 0.f;
      const int row = ty + 16 * a;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = allow[a][c] ? expf(s[a][c] - m_new) : 0.f;
        sum += p;
        p_sm[row * (kBk + 1) + tx + 8 * c] = p;
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      l[a] = l[a] * corr + sum;
      m[a] = m_new;
#pragma unroll
      for (int i = 0; i < kMaxD / 8; ++i) acc[a][i] *= corr;
    }
    __syncthreads();  // K reads done, P visible
    stage_rows(kv_sm, v, v_scale, g, kt, kv_end, S, n_kv, kh, D);
    __syncthreads();

    for (int j = 0; j < kBk; ++j) {
      const float p0 = p_sm[ty * (kBk + 1) + j];
      const float p1 = p_sm[(ty + 16) * (kBk + 1) + j];
#pragma unroll
      for (int i = 0; i < kMaxD / 8; ++i) {
        const int d = tx + 8 * i;
        if (d < D) {
          const float vj = kv_sm[j * kLd + d];
          acc[0][i] += p0 * vj;
          acc[1][i] += p1 * vj;
        }
      }
    }
  }

#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int qi = q0 + ty + 16 * a;
    if (qi >= C) continue;
    const float l_safe = fmaxf(l[a], 1e-30f);
    T* o = out + (((size_t)g * C + qi) * H + h) * D;
#pragma unroll
    for (int i = 0; i < kMaxD / 8; ++i) {
      const int d = tx + 8 * i;
      if (d < D) o[d] = from_f<T>(acc[a][i] / l_safe);
    }
  }
}

// ---------------------------------------------------------- bf16 route

constexpr int kTcThreads = 128;  // one warpgroup
constexpr int kTcBq = 64;        // query rows per block
constexpr int kTcBk = 64;        // keys per tile

// kInt8: the cache is int8 with per-vector scales; else bf16 like q.
template <int D, bool kInt8>
__global__ void __launch_bounds__(kTcThreads) chunk_prefill_tc_kernel(
    const __nv_bfloat16* __restrict__ q,        // [G, C, H, D]
    const void* __restrict__ k_cache,           // [G, S, n_kv, D]
    const void* __restrict__ v_cache,           // [G, S, n_kv, D]
    const __nv_bfloat16* __restrict__ k_scale,  // [G, S, n_kv] (int8)
    const __nv_bfloat16* __restrict__ v_scale,  // [G, S, n_kv] (int8)
    const int* __restrict__ q_offset,           // [G]
    __nv_bfloat16* __restrict__ out,            // [G, C, H, D]
    int G, int C, int S, int H, int n_kv, float scale) {
  using namespace flash_tc;
  using KV = typename std::conditional<kInt8, int8_t, __nv_bfloat16>::type;
  constexpr int Dp = padded(D);
  constexpr int kTile = kTcBq * Dp * 2;  // bytes of a Q, K or V tile
  static_assert(kTcBq == kTcBk, "Q, K and V tiles share one size");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // Q, K[0], K[1], V[0], V[1], then (int8) f32 scales: K[0], K[1], V[0],
  // V[1], kTcBk each.
  const uint32_t q_s = smem_u32(smem);
  float* scales = reinterpret_cast<float*>(smem + 5 * kTile);
  __shared__ int row_g;

  const int tid = threadIdx.x;
  // Row g of rank blockIdx.z by descending offset (ties by index): the
  // rows with the most keys start first.
  for (int c = tid; c < G; c += kTcThreads) {
    const int oc = q_offset[c];
    int rank = 0;
    for (int o = 0; o < G; ++o) {
      const int oo = q_offset[o];
      rank += oo > oc || (oo == oc && o < c);
    }
    if (rank == static_cast<int>(blockIdx.z)) row_g = c;
  }
  __syncthreads();
  const int g = row_g;
  const int h = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kTcBq;
  const int kh = h / (H / n_kv);
  // This thread's first accumulator row in the block; the second is +8.
  const int row_in = ((tid >> 5) & 3) * 16 + ((tid & 31) >> 2);
  const int cq = 2 * (tid & 3);
  const int off = q_offset[g];
  const int q_hi = min(C, q0 + kTcBq);
  // One past the last position any query of this block may attend.
  const int kv_end = min(S, off + q_hi);
  const int n_tiles = (kv_end + kTcBk - 1) / kTcBk;
  const float scale2 = scale * kLog2e;  // scores in log2 units
  const size_t kv_stride = (size_t)n_kv * D;  // elements between positions
  const size_t kv_base = (size_t)g * S * n_kv + kh;  // (g, 0, kh) / D
  const KV* k = static_cast<const KV*>(k_cache) + kv_base * D;
  const KV* v = static_cast<const KV*>(v_cache) + kv_base * D;

  for (int t = 0; t < 5; ++t)
    zero_padding<D, kTcBq, kTcThreads>(smem + t * kTile);
  load_rows<D, kTcBq, kTcThreads>(q_s, q + ((size_t)g * C * H + h) * D, q0,
                                  C, (size_t)H * D);

  // Tile t's K and V (and scales) into buffer t & 1: cp.async for bf16;
  // for int8, fetch() starts the loads and put() stores them.
  Int8Rows<D, kTcBk, kTcThreads> k8, v8;
  float sc = 0.f;  // this thread's scale of the tile being fetched
  auto fetch = [&](int t) {
    const int k0 = t * kTcBk;
    if constexpr (kInt8) {
      k8.load(k, k0, kv_end, kv_stride);
      v8.load(v, k0, kv_end, kv_stride);
      // Threads 0..63 hold K's scales, 64..127 V's; 0 past the frontier.
      const int pos = k0 + (tid & (kTcBk - 1));
      const __nv_bfloat16* src = tid < kTcBk ? k_scale : v_scale;
      sc = pos < kv_end ? __bfloat162float(src[kv_base + (size_t)pos * n_kv])
                        : 0.f;
    } else {
      const int buf = t & 1;
      load_rows<D, kTcBk, kTcThreads>(q_s + (1 + buf) * kTile, k, k0,
                                      kv_end, kv_stride);
      load_rows<D, kTcBk, kTcThreads>(q_s + (3 + buf) * kTile, v, k0,
                                      kv_end, kv_stride);
    }
  };
  auto put = [&](int t) {
    if constexpr (kInt8) {
      const int buf = t & 1;
      k8.store(smem + (1 + buf) * kTile);
      v8.store(smem + (3 + buf) * kTile);
      scales[(tid < kTcBk ? buf : 2 + buf) * kTcBk + (tid & (kTcBk - 1))] =
          sc;
    }
  };
  fetch(0);
  put(0);
  cp_async_commit();

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  float acc[Dp / 2];
#pragma unroll
  for (int i = 0; i < Dp / 2; ++i) acc[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTcBk;
    const int buf = t & 1;
    const bool more = t + 1 < n_tiles;
    if (more) fetch(t + 1);
    if (!kInt8 && more) {
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and Q) landed
    const uint32_t k_s = q_s + (1 + buf) * kTile;
    const uint32_t v_s = q_s + (3 + buf) * kTile;
    const float* ks = scales + buf * kTcBk;
    const float* vs = scales + (2 + buf) * kTcBk;

    float s[kTcBk / 2];
#pragma unroll
    for (int i = 0; i < kTcBk / 2; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int ks_ = 0; ks_ < D / 16; ++ks_)
      wgmma_ss(s, desc_kmajor<kTcBq>(q_s, ks_), desc_kmajor<kTcBk>(k_s, ks_),
               ks_ > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // Tiles that cross the first query's frontier or the cache end are
    // masked.
    const bool edge = k0 + kTcBk > S || k0 + kTcBk - 1 > off + q0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // The last column of this tile the row may see.
      const int lim = min(S - 1, off + q0 + row_in + 8 * i) - k0;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kTcBk / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + cq + e;
          float x = s[4 * j + 2 * i + e] * scale2;
          if constexpr (kInt8) x *= ks[c];
          if (edge && c > lim) x = -INFINITY;
          s[4 * j + 2 * i + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = exp2f(m[i] - m_use);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kTcBk / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + cq + e;
          const float p = edge && c > lim
                              ? 0.f
                              : exp2f(s[4 * j + 2 * i + e] - m_use);
          sum += p;
          // l sums the f32 P; P V takes P * v_scale for int8.
          if constexpr (kInt8)
            s[4 * j + 2 * i + e] = p * vs[c];
          else
            s[4 * j + 2 * i + e] = p;
        }
      l[i] = l[i] * corr + sum;
#pragma unroll
      for (int j = 0; j < Dp / 8; ++j) {
        acc[4 * j + 2 * i] *= corr;
        acc[4 * j + 2 * i + 1] *= corr;
      }
    }

    uint32_t pa[kTcBk / 16][4];
#pragma unroll
    for (int kk = 0; kk < kTcBk / 16; ++kk) a_frag(s, kk, pa[kk]);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcBk / 16; ++kk)
      wgmma_rs(acc, pa[kk], desc_mnmajor<kTcBk>(v_s, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    // int8: tile t + 1 into the buffer tile t - 1 left (its reads ended
    // at the last barrier).
    if (more) put(t + 1);
    __syncthreads();  // tile t's reads are done before its buffers take
                      // tile t + 2
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int qi = q0 + row_in + 8 * i;
    if (qi >= C) continue;
    const float inv = 1.f / fmaxf(li, 1e-30f);
    __nv_bfloat16* orow = out + (((size_t)g * C + qi) * H + h) * D;
#pragma unroll
    for (int j = 0; j < Dp / 8; ++j)
      if (8 * j < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + cq) =
            __floats2bfloat162_rn(acc[4 * j + 2 * i] * inv,
                                  acc[4 * j + 2 * i + 1] * inv);
  }
}

template <bool kInt8>
int launch_tc(const void* q, const void* k, const void* v,
              const void* k_scale, const void* v_scale, const void* q_offset,
              void* out, int G, int C, int S, int H, int n_kv, int D,
              float scale, cudaStream_t stream) {
  return flash::with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    const size_t smem = 5 * (size_t)kTcBq * flash_tc::padded(kD) * 2 +
                        4 * kTcBk * sizeof(float) + 1024;
    auto kernel = chunk_prefill_tc_kernel<kD, kInt8>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3(H, (C + kTcBq - 1) / kTcBq, G), kTcThreads, smem,
             stream>>>(static_cast<const __nv_bfloat16*>(q), k, v,
                       static_cast<const __nv_bfloat16*>(k_scale),
                       static_cast<const __nv_bfloat16*>(v_scale),
                       static_cast<const int*>(q_offset),
                       static_cast<__nv_bfloat16*>(out), G, C, S, H, n_kv,
                       scale);
    return static_cast<int>(cudaGetLastError());
  });
}

template <typename T, typename KV>
int launch(const void* q, const void* k, const void* v, const void* k_scale,
           const void* v_scale, const void* q_offset, void* out, int G,
           int C, int S, int H, int n_kv, int D, float scale,
           cudaStream_t stream) {
  dim3 grid((C + kBq - 1) / kBq, H, G);
  chunk_prefill_kernel<T, KV><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v),
      static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale),
      static_cast<const int*>(q_offset), static_cast<T*>(out), C, S, H,
      n_kv, D, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32 (CUDA-core kernel; head_dim up to 128), 1 =
// bfloat16 (tensor-core kernel; head_dim a multiple of 16 up to 128) for
// q and out, and the cache unless kv_int8, when it is int8 and
// k_scale/v_scale must be given. Returns cudaGetLastError() after the
// launch.
extern "C" int chunk_prefill(const void* q, const void* k, const void* v,
                             const void* k_scale, const void* v_scale,
                             const void* q_offset, void* out, int G, int C,
                             int S, int H, int n_kv, int D, float scale,
                             int dtype, int kv_int8, void* stream) {
  if (G < 1 || C < 1 || S < 1 || D < 1 || D > kMaxD || n_kv < 1 ||
      H % n_kv != 0 || (kv_int8 && (k_scale == nullptr || v_scale == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && !kv_int8)
    return launch<float, float>(q, k, v, k_scale, v_scale, q_offset, out, G,
                                C, S, H, n_kv, D, scale, st);
  if (dtype == 0 && kv_int8)
    return launch<float, int8_t>(q, k, v, k_scale, v_scale, q_offset, out,
                                 G, C, S, H, n_kv, D, scale, st);
  if (dtype == 1 && !kv_int8)
    return launch_tc<false>(q, k, v, k_scale, v_scale, q_offset, out, G, C,
                            S, H, n_kv, D, scale, st);
  if (dtype == 1 && kv_int8)
    return launch_tc<true>(q, k, v, k_scale, v_scale, q_offset, out, G, C, S,
                           H, n_kv, D, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
