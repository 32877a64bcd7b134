// Paged GQA decode attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel skypilot_tpu/ops/decode_attention.py::
// _paged_kernel (driven by _paged_softmax_pages). One query token per
// row attends to that row's KV cache [B, S, n_kv, hd] (bf16/f32, or int8
// with per-vector bf16 scales [B, S, n_kv]) plus, optionally, its own
// K/V (the "self" term), which the TPU version merged outside the
// kernel and this one fuses.
//
// What bounds it on an H100: bytes. Per call it must read each live K/V
// slot once (2 * n_kv * hd elements per slot) and does 2 * rep
// operations per element read (8 at Llama-3.1-8B's rep 4), far below
// the ~295 per byte the card needs to be compute-bound. Only what must
// be read is read: the column loop of a row stops at
// end = min(num_pages, ceil(row_bound / page)) * page, and a slot that
// dmask marks dead is never loaded (zeros stand in, so NaN garbage there
// cannot reach the accumulator, and its probability is zeroed
// explicitly). The type of q picks one of two kernels:
//
// bf16 (paged_decode_tc_kernel, bf16 or int8 cache; split_kv.cuh) fills
// the card and keeps the loads in flight: the grid is (n_split, n_kv,
// B), each block taking `split_tiles` 64-key tiles of its row's live
// keys in column order (split_kv's live map), so the reduction order
// follows the row's own key sequence wherever the schedule put it; the
// caller fixes `split_tiles` from the cache's shape (the blocks cover
// the SMs a few times over a full cache, in runs of at most 16 tiles:
// at B 8 x n_kv 8 one block per (kv head, row) left half of the 132 SMs
// idle, and a serving batch's few live rows would leave most of them
// idle) and launches enough splits to cover the dispatched columns. The rep query heads of a GQA group are
// padded to one 64-row warpgroup tile, so each K/V tile is read from
// device memory once and both products run on wgmma (the padding is
// free: 64 operations per byte is still under the ridge), the query
// fragments held in registers; tiles t + 1 and t + 2 are in flight
// (cp.async; int8: t + 1, through registers) while tile t's products
// run. Each block writes its partial (m, l, acc) in f32; the last block
// of a (kv head, row) to arrive merges the partials in split order,
// with the self term as one more online-softmax step, in the same
// launch (its arrival counter is reset by the merging block, so nothing
// is cleared per call).
//
// f32 (paged_decode_kernel) keeps full-f32 math on the CUDA cores, so
// the greedy-exact parity route holds its 1e-4 bar: one block per
// (kv head, row), all rep heads of the group sharing each staged tile.
// Its tiles are cut from the row's live keys too (the same live map), so
// its bits do not follow the schedule either.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "split_kv.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxRep = 16;
constexpr int kMaxHd = 128;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(int8_t x) {
  return static_cast<float>(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// T: query/output/self type (float: a bf16 q takes
// paged_decode_tc_kernel). KV: cache type (T or int8).
template <typename T, typename KV>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const T* __restrict__ q,                    // [B, n_kv * rep, hd]
    const KV* __restrict__ kc,                  // [B, S, n_kv, hd]
    const KV* __restrict__ vc,                  // [B, S, n_kv, hd]
    const bool* __restrict__ valid,             // [B, S]
    const int* __restrict__ row_bound,          // [B]
    const __nv_bfloat16* __restrict__ k_scale,  // [B, S, n_kv] or null
    const __nv_bfloat16* __restrict__ v_scale,  // [B, S, n_kv] or null
    const T* __restrict__ k_self,               // [B, n_kv, hd] or null
    const T* __restrict__ v_self,               // [B, n_kv, hd] or null
    T* __restrict__ out,                        // [B, n_kv * rep * hd]
    int S, int n_kv, int rep, int hd, int page, int num_pages,
    float scale) {
  extern __shared__ uint64_t map_sm[];  // map_bytes(S): the live map
  // Cache positions staged per iteration: keeps K + V tiles under the
  // 48 KB of static shared memory for every supported type.
  constexpr int kTile = sizeof(KV) == 4 ? 32 : 64;
  // Staged rows are padded by one 32-bit word so that threads reading
  // the same column of consecutive rows hit distinct banks.
  constexpr int kMaxRowWords = kMaxHd * (int)sizeof(KV) / 4 + 1;
  __shared__ uint32_t k_sm[kTile * kMaxRowWords];
  __shared__ uint32_t v_sm[kTile * kMaxRowWords];
  __shared__ float q_sm[kMaxRep * kMaxHd];
  __shared__ float p_sm[kMaxRep * kTile];
  __shared__ float ks_sm[kTile];
  __shared__ float vs_sm[kTile];
  __shared__ int ok_sm[kTile];
  __shared__ int col_sm[kTile];  // the cache column of each tile row, -1
  __shared__ float m_sm[kMaxRep];
  __shared__ float l_sm[kMaxRep];
  __shared__ float corr_sm[kMaxRep];
  __shared__ float self_sm[kMaxRep];

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int n_heads = n_kv * rep;
  const int row_words = hd * (int)sizeof(KV) / 4 + 1;
  const int vecs_per_row = hd * (int)sizeof(KV) / 16;
  const bool quant = k_scale != nullptr;

  // The group's rep query heads are consecutive: heads h*rep .. h*rep+rep-1.
  const T* qb = q + ((size_t)b * n_heads + (size_t)h * rep) * hd;
  for (int i = tid; i < rep * hd; i += kThreads) q_sm[i] = to_f(qb[i]);
  if (tid < kMaxRep) {
    m_sm[tid] = kNegInf;
    l_sm[tid] = 0.f;
    self_sm[tid] = kNegInf;
  }
  __syncthreads();
  if (k_self != nullptr) {
    const T* ks = k_self + ((size_t)b * n_kv + h) * hd;
    for (int r = warp; r < rep; r += kThreads / 32) {
      float s = 0.f;
      for (int d = lane; d < hd; d += 32) s += q_sm[r * hd + d] * to_f(ks[d]);
      s = warp_sum(s);
      if (lane == 0) self_sm[r] = s * scale;
    }
  }
  __syncthreads();

  int row_pages = (row_bound[b] + page - 1) / page;
  row_pages = max(0, min(row_pages, num_pages));
  const int end = min(row_pages * page, S);

  // The row's live keys below `end`, in column order (split_kv's live
  // map, in dynamic shared memory): tile t holds live keys kTile t ..
  // kTile t + kTile - 1 wherever they sit, so the sums' order follows
  // the row's own key sequence, not the cache columns the schedule
  // wrote it at.
  const int n_pt = (end + split_kv::kBk - 1) / split_kv::kBk;
  uint64_t* masks = map_sm;
  int* first = reinterpret_cast<int*>(masks + 2 * n_pt);
  const bool* vrow = valid + (size_t)b * S;
  const int n_live = split_kv::live_map(
      [&](int c) { return int(vrow[c]); }, end, n_pt, masks, masks + n_pt,
      first);

  float acc[kMaxRep];
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) acc[r] = 0.f;

  for (int g0 = 0; g0 < n_live; g0 += kTile) {
    for (int row = tid; row < kTile; row += kThreads) {
      const int g = g0 + row;
      const int pos =
          g < n_live ? split_kv::live_column(g, n_pt, masks, first) : -1;
      col_sm[row] = pos;
      ok_sm[row] = pos >= 0;
      if (quant) {
        const size_t so = ((size_t)b * S + max(pos, 0)) * n_kv + h;
        ks_sm[row] = pos >= 0 ? to_f(k_scale[so]) : 0.f;
        vs_sm[row] = pos >= 0 ? to_f(v_scale[so]) : 0.f;
      }
    }
    __syncthreads();
    // Stage the tile's K/V rows (16-byte loads); rows past the live
    // count stage zeros and are never read from memory.
    for (int i = tid; i < kTile * vecs_per_row; i += kThreads) {
      const int row = i / vecs_per_row;
      const int vec = i - row * vecs_per_row;
      const int pos = col_sm[row];
      uint4 kk = make_uint4(0u, 0u, 0u, 0u);
      uint4 vv = make_uint4(0u, 0u, 0u, 0u);
      if (pos >= 0) {
        const size_t off = (((size_t)b * S + pos) * n_kv + h) * hd;
        kk = reinterpret_cast<const uint4*>(kc + off)[vec];
        vv = reinterpret_cast<const uint4*>(vc + off)[vec];
      }
      uint32_t* kd = k_sm + row * row_words + vec * 4;
      uint32_t* vd = v_sm + row * row_words + vec * 4;
      kd[0] = kk.x; kd[1] = kk.y; kd[2] = kk.z; kd[3] = kk.w;
      vd[0] = vv.x; vd[1] = vv.y; vd[2] = vv.z; vd[3] = vv.w;
    }
    __syncthreads();

    // Scores: thread -> one tile position, every (kThreads/kTile)-th head.
    {
      const int j = tid % kTile;
      const KV* krow = reinterpret_cast<const KV*>(k_sm + j * row_words);
      for (int r = tid / kTile; r < rep; r += kThreads / kTile) {
        float s = 0.f;
        for (int d = 0; d < hd; ++d) s += q_sm[r * hd + d] * to_f(krow[d]);
        s *= scale;
        // int8 K: the per-vector scale is constant over hd, so it
        // factors out of the dot product onto the score.
        if (quant) s *= ks_sm[j];
        p_sm[r * kTile + j] = ok_sm[j] ? s : kNegInf;
      }
    }
    __syncthreads();

    // Online softmax across tiles: one warp per head.
    for (int r = warp; r < rep; r += kThreads / 32) {
      float mx = kNegInf;
      for (int j = lane; j < kTile; j += 32) mx = fmaxf(mx, p_sm[r * kTile + j]);
      mx = warp_max(mx);
      const float m_prev = m_sm[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = lane; j < kTile; j += 32) {
        float p = ok_sm[j] ? expf(p_sm[r * kTile + j] - m_new) : 0.f;
        sum += p;
        // int8 V: fold the per-slot scale into the probability.
        if (quant) p *= vs_sm[j];
        p_sm[r * kTile + j] = p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        corr_sm[r] = corr;
        l_sm[r] = l_sm[r] * corr + sum;
        m_sm[r] = m_new;
      }
    }
    __syncthreads();

    // P @ V: thread -> one head_dim column for every head of the group.
    if (tid < hd) {
#pragma unroll
      for (int r = 0; r < kMaxRep; ++r)
        if (r < rep) acc[r] *= corr_sm[r];
      for (int j = 0; j < kTile; ++j) {
        const float vj =
            to_f(reinterpret_cast<const KV*>(v_sm + j * row_words)[tid]);
#pragma unroll
        for (int r = 0; r < kMaxRep; ++r)
          if (r < rep) acc[r] += p_sm[r * kTile + j] * vj;
      }
    }
    __syncthreads();
  }

  if (tid < hd) {
    const bool has_self = k_self != nullptr;
    const float vs = has_self
        ? to_f(v_self[((size_t)b * n_kv + h) * hd + tid]) : 0.f;
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      if (r >= rep) break;
      const float m1 = m_sm[r];
      const float l1 = l_sm[r];
      float o;
      if (has_self) {
        // One more online-softmax step merges the token's own K/V.
        const float ss = self_sm[r];
        const float m2 = fmaxf(m1, ss);
        const float c1 = expf(m1 - m2);
        const float c2 = expf(ss - m2);
        const float l2 = fmaxf(l1 * c1 + c2, 1e-30f);
        o = (acc[r] * c1 + c2 * vs) / l2;
      } else {
        o = acc[r] / fmaxf(l1, 1e-30f);
      }
      out[((size_t)b * n_heads + (size_t)h * rep + r) * hd + tid] =
          from_f<T>(o);
    }
  }
}

// ---------------------------------------------------------- bf16 route

// kInt8: the cache is int8 with per-vector scales; else bf16 like q.
// Grid (n_split, n_kv, B), one warpgroup per block. part_ml
// [B * n_kv, n_split, rep, 2] and part_acc [B * n_kv, n_split, rep, hd]
// (f32) take the partials; counters [B * n_kv] are 0 at launch and
// left 0.
template <int D, bool kInt8>
__global__ void __launch_bounds__(split_kv::kWg) paged_decode_tc_kernel(
    const __nv_bfloat16* __restrict__ q,        // [B, n_kv * rep, D]
    const void* __restrict__ kc,                // [B, S, n_kv, D]
    const void* __restrict__ vc,                // [B, S, n_kv, D]
    const bool* __restrict__ valid,             // [B, S]
    const int* __restrict__ row_bound,          // [B]
    const __nv_bfloat16* __restrict__ k_scale,  // [B, S, n_kv] (int8)
    const __nv_bfloat16* __restrict__ v_scale,  // [B, S, n_kv] (int8)
    const __nv_bfloat16* __restrict__ k_self,   // [B, n_kv, D] or null
    const __nv_bfloat16* __restrict__ v_self,   // [B, n_kv, D] or null
    __nv_bfloat16* __restrict__ out,            // [B, n_kv * rep * D]
    float* __restrict__ part_ml, float* __restrict__ part_acc,
    int* __restrict__ counters, int S, int n_kv, int rep, int page,
    int num_pages, int split_tiles, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw +
      ((1024 - (flash_tc::smem_u32(smem_raw) & 1023)) & 1023);
  const int split = blockIdx.x;
  const int n_split = gridDim.x;
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int slot = b * n_kv + kh;
  int row_pages = (row_bound[b] + page - 1) / page;
  row_pages = max(0, min(row_pages, num_pages));
  const int end = min(row_pages * page, S);
  const float scale2 = scale * flash_tc::kLog2e;  // scores in log2 units
  const __nv_bfloat16* qg = q + ((size_t)b * n_kv + kh) * rep * D;
  const bool* vrow = valid + (size_t)b * S;
  const auto q_row = [&](int r) { return qg + (size_t)r * D; };
  // Every row (query head) attends every live column: flag 1.
  const auto flag = [&](int c) { return int(c < end && vrow[c]); };
  const auto row_lim = [](int) { return 0; };
  float* ml = part_ml + (size_t)slot * n_split * rep * 2;
  float* acc = part_acc + (size_t)slot * n_split * rep * D;
  split_kv::attend<D, kInt8>(
      smem, q_row, rep, kc, vc, k_scale, v_scale,
      ((size_t)b * S * n_kv + kh) * D, (size_t)n_kv * D,
      (size_t)b * S * n_kv + kh, (size_t)n_kv, end, split, split_tiles,
      scale2, flag, row_lim, ml + (size_t)split * rep * 2,
      acc + (size_t)split * rep * D);
  if (!split_kv::arrive_last(counters + slot, n_split)) return;

  // The merging block: the self term's scores, one warp per head.
  __shared__ float self_s[kMaxRep];
  const bool has_self = k_self != nullptr;
  if (has_self) {
    const int lane = threadIdx.x & 31;
    const __nv_bfloat16* ks = k_self + (size_t)slot * D;
    for (int r = threadIdx.x >> 5; r < rep; r += blockDim.x >> 5) {
      float dot = 0.f;
      for (int d = lane; d < D; d += 32)
        dot += __bfloat162float(q_row(r)[d]) * __bfloat162float(ks[d]);
      dot = warp_sum(dot);
      if (lane == 0) self_s[r] = dot * scale2;
    }
    __syncthreads();
  }
  __nv_bfloat16* og = out + ((size_t)b * n_kv + kh) * rep * D;
  split_kv::merge<D>(smem, ml, acc, n_split, rep, rep,
                     has_self ? self_s : nullptr,
                     has_self ? v_self + (size_t)slot * D : nullptr,
                     [&](int r) { return og + (size_t)r * D; });
}

template <bool kInt8>
int launch_tc(const void* q, const void* kc, const void* vc,
              const void* valid, const void* row_bound, const void* k_scale,
              const void* v_scale, const void* k_self, const void* v_self,
              void* out, void* part_ml, void* part_acc, void* counters,
              int B, int S, int n_kv, int rep, int hd, int page,
              int num_pages, int n_split, int split_tiles, float scale,
              cudaStream_t stream) {
  return flash::with_head_dim(hd, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    const size_t smem = split_kv::smem_bytes(kD, kInt8, S);
    auto kernel = paged_decode_tc_kernel<kD, kInt8>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3(n_split, n_kv, B), split_kv::kWg, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), kc, vc,
        static_cast<const bool*>(valid), static_cast<const int*>(row_bound),
        static_cast<const __nv_bfloat16*>(k_scale),
        static_cast<const __nv_bfloat16*>(v_scale),
        static_cast<const __nv_bfloat16*>(k_self),
        static_cast<const __nv_bfloat16*>(v_self),
        static_cast<__nv_bfloat16*>(out), static_cast<float*>(part_ml),
        static_cast<float*>(part_acc), static_cast<int*>(counters), S,
        n_kv, rep, page, num_pages, split_tiles, scale);
    return static_cast<int>(cudaGetLastError());
  });
}

// Dynamic shared memory of the f32 kernel: the live map of a row of S
// columns (two 64-bit masks and an int count per 64 columns).
size_t map_bytes(int S) {
  return (size_t)20 * ((S + split_kv::kBk - 1) / split_kv::kBk) + 8;
}

template <typename KV>
int launch_f32(const void* q, const void* kc, const void* vc,
               const void* valid, const void* row_bound, const void* k_scale,
               const void* v_scale, const void* k_self, const void* v_self,
               void* out, int B, int S, int n_kv, int rep, int hd, int page,
               int num_pages, float scale, cudaStream_t stream) {
  dim3 grid(n_kv, B);
  auto kernel = paged_decode_kernel<float, KV>;
  const size_t smem = map_bytes(S);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const KV*>(kc),
      static_cast<const KV*>(vc), static_cast<const bool*>(valid),
      static_cast<const int*>(row_bound),
      static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale),
      static_cast<const float*>(k_self), static_cast<const float*>(v_self),
      static_cast<float*>(out), S, n_kv, rep, hd, page, num_pages, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32 (CUDA-core kernel; head_dim up to 128), 1 =
// bfloat16 (tensor-core split kernel; head_dim a multiple of 16 up to
// 128, n_split >= 1 blocks per (kv head, row) of `split_tiles` >= 1
// 64-key tiles each, n_split * split_tiles * 64 covering the dispatched
// columns, part_ml/part_acc/counters
// its f32 partials [B * n_kv * n_split * rep * 2] and
// [B * n_kv * n_split * rep * hd] and int32 counters [B * n_kv], zero at
// launch) for q, self and out, and the cache unless kv_int8. Returns
// cudaGetLastError() after the launch.
extern "C" int paged_decode(const void* q, const void* kc, const void* vc,
                            const void* valid, const void* row_bound,
                            const void* k_scale, const void* v_scale,
                            const void* k_self, const void* v_self,
                            void* out, void* part_ml, void* part_acc,
                            void* counters, int B, int S, int n_kv, int rep,
                            int hd, int page, int num_pages, int n_split,
                            int split_tiles, float scale, int dtype,
                            int kv_int8, void* stream) {
  if (rep < 1 || rep > kMaxRep || hd < 1 || hd > kMaxHd || page < 1 ||
      (kv_int8 && (k_scale == nullptr || v_scale == nullptr)) ||
      (dtype == 1 && (n_split < 1 || split_tiles < 1 ||
                      part_ml == nullptr || part_acc == nullptr ||
                      counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && !kv_int8)
    return launch_f32<float>(q, kc, vc, valid, row_bound, k_scale, v_scale,
                             k_self, v_self, out, B, S, n_kv, rep, hd, page,
                             num_pages, scale, st);
  if (dtype == 0 && kv_int8)
    return launch_f32<int8_t>(q, kc, vc, valid, row_bound, k_scale, v_scale,
                              k_self, v_self, out, B, S, n_kv, rep, hd, page,
                              num_pages, scale, st);
  if (dtype == 1 && !kv_int8)
    return launch_tc<false>(q, kc, vc, valid, row_bound, k_scale, v_scale,
                            k_self, v_self, out, part_ml, part_acc, counters,
                            B, S, n_kv, rep, hd, page, num_pages, n_split,
                            split_tiles, scale, st);
  if (dtype == 1 && kv_int8)
    return launch_tc<true>(q, kc, vc, valid, row_bound, k_scale, v_scale,
                           k_self, v_self, out, part_ml, part_acc, counters,
                           B, S, n_kv, rep, hd, page, num_pages, n_split,
                           split_tiles, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
