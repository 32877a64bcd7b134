// Spec-decode verify attention for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel skypilot_tpu/ops/flash_attention.py::
// _verify_fwd_kernel (driven by _verify_fwd_pallas). Each row b of a
// decode batch feeds a V-token verify segment (its current token plus
// up to V-1 drafted candidates) whose K/V are already written at the
// row's own frontier columns [seg[b], seg[b] + V) of its cache
// [B, S, n_kv, D] (bf16/f32 like q, or int8 with per-vector bf16
// scales [B, S, n_kv]). Query i of the segment attends column col when
//     valid[b, col]  or  seg[b] <= col <= seg[b] + i
// (the live cache, which continuous batching leaves with holes, plus
// the segment causally, self-inclusive). The TPU version sent int8
// caches to its einsum reference; here the kernels take them, so a CUDA
// tensor always launches. Any number of query rows (rep * V) is taken.
//
// What bounds it on an H100: bytes. At Llama-3.1-8B serving shapes
// (B 8, V 5, 32/8 heads, D 128, ~700 live columns) a call must read
// each live K/V column once (~13 MB in bf16, ~4 us at 3.35 TB/s) and
// does 4 * rep * V = 80 operations per K/V element read, far below the
// ~295 per byte the card needs to be compute-bound. Only what must be
// read is read: the column loop stops at `end` = min(n_cols, seg[b] + V)
// (columns past the segment, and past the region the caller dispatched,
// are never read), and a column no query of the row may attend
// (dmask-false below the segment) is never loaded: zeros stand in, so
// NaN garbage left by recycled rows and rejected candidates cannot
// reach the accumulator, and masked probabilities are zeroed
// explicitly. A row whose dmask is all false still sees its own
// segment. The segment starts `seg` [B] are read from device memory
// (each row's own write frontier base + steps[b]), never passed by the
// host, so a launch captured in a CUDA graph follows them from replay to
// replay; the launch geometry depends only on the static n_cols, and
// each block works out its row's `end` itself. Block row r is segment position r / rep
// of query head kh * rep + r % rep. The type of q picks one of two
// kernels:
//
// bf16 (verify_attention_tc_kernel, bf16 or int8 cache; split_kv.cuh)
// fills the card and keeps the loads in flight: the grid is (n_split,
// n_kv x row chunks, B), each block taking `split_tiles` 64-key tiles of
// the live keys below `end` in column order (split_kv's live map: the
// reduction order follows the row's own keys, wherever the schedule put
// them); the caller fixes `split_tiles` from the cache's shape (the blocks
// cover the SMs a few times over a full cache, in runs of at most 16
// tiles: one block per (kv head, row) left half of the 132 SMs idle)
// and launches enough splits to cover n_cols. The rep * V rows of a GQA
// group are padded to 64-row warpgroup tiles, one or two warpgroups per
// block sharing each K/V tile (128 rows; a wider segment takes more row
// chunks, each reading the tiles again), and both products run on
// wgmma, the rows' query fragments held in registers; tiles t + 1 and
// t + 2 are in flight (cp.async; int8: t + 1, through registers) while
// tile t's products run. Each block writes its partial (m, l,
// acc) in f32, and the last block of a (kv head, row chunk, row) to
// arrive merges them in split order in the same launch.
//
// f32 (verify_attention_kernel) keeps full-f32 math on the CUDA cores,
// so the greedy-exact parity route holds its 1e-4 bar: one block per
// (kv head, row, group of up to 64 query rows), the group's rows
// sharing each staged tile (a second group reads the tiles again); a
// tile is staged with 16-byte loads, all issued before any is used,
// and converted to f32 in shared memory (rows padded by 4 words); in
// the scores a warp takes a query row and a lane a column; in P @ V a
// thread takes one head_dim column and every other 4-row chunk. Its
// tiles are cut from the row's live keys too (the same live map as the
// bf16 route), so its bits do not follow the schedule either.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_common.cuh"
#include "split_kv.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 32;      // cache columns per staged tile (a warp)
constexpr int kMaxRows = 64;   // query rows an f32 block holds
constexpr int kMaxD = 128;
// 4-row chunks one thread accumulates in P @ V: kThreads / D >= 2
// thread groups share the kMaxRows / 4 chunks.
constexpr int kMaxChunks = kMaxRows / 4 / (kThreads / kMaxD);
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

// Stage the tile's cache columns col_sm[0 .. kTile) of kv head kh into
// `dst` (row stride D + 4) as f32, times the column's scale in
// `scale_sm` for an int8 cache; a tile row whose column is -1 stages
// zeros and reads no memory. D * sizeof(KV) is a multiple of 16.
template <typename KV>
__device__ __forceinline__ void stage_tile(float* dst, const KV* src,
                                           const float* scale_sm,
                                           const int* col_sm, int b, int S,
                                           int n_kv, int kh, int D) {
  constexpr int kElems = 16 / (int)sizeof(KV);      // per 16-byte load
  constexpr int kLoads = kTile * (kMaxD / kElems) / kThreads;
  const int vecs = D / kElems;                      // loads per column
  const int ld = D + 4;
  uint4 buf[kLoads];
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const int i = threadIdx.x + u * kThreads;
    buf[u] = make_uint4(0u, 0u, 0u, 0u);
    if (i < kTile * vecs) {
      const int j = i / vecs;
      if (col_sm[j] >= 0) {
        const size_t row = ((size_t)b * S + col_sm[j]) * n_kv + kh;
        buf[u] = reinterpret_cast<const uint4*>(src + row * D)[i - j * vecs];
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kLoads; ++u) {
    const int i = threadIdx.x + u * kThreads;
    if (i < kTile * vecs) {
      const int j = i / vecs;
      const float s = scale_sm != nullptr ? scale_sm[j] : 1.f;
      const KV* e = reinterpret_cast<const KV*>(&buf[u]);
      float4* d = reinterpret_cast<float4*>(dst + j * ld +
                                            (i - j * vecs) * kElems);
#pragma unroll
      for (int t = 0; t < kElems / 4; ++t)
        d[t] = make_float4(to_f(e[4 * t]) * s, to_f(e[4 * t + 1]) * s,
                           to_f(e[4 * t + 2]) * s, to_f(e[4 * t + 3]) * s);
    }
  }
}

// T: query/output type (float: a bf16 q takes
// verify_attention_tc_kernel). KV: cache type (T or int8). The block
// holds query rows [r0, r0 + rows) of its kv head's rep * V, r0 =
// blockIdx.z * kMaxRows. Dynamic shared memory, all f32: q [rows, D],
// one K-or-V tile [kTile, D + 4], and the tile's scores/probabilities
// column-major [kTile, rp] (rp = rows rounded up to 4, so P @ V reads
// float4s), then the row's live map (map_bytes).
template <typename T, typename KV>
__global__ void __launch_bounds__(kThreads) verify_attention_kernel(
    const T* __restrict__ q,                    // [B, V, H, D]
    const KV* __restrict__ k,                   // [B, S, n_kv, D]
    const KV* __restrict__ v,                   // [B, S, n_kv, D]
    const __nv_bfloat16* __restrict__ k_scale,  // [B, S, n_kv] or null
    const __nv_bfloat16* __restrict__ v_scale,  // [B, S, n_kv] or null
    const bool* __restrict__ valid,             // [B, S]
    const int* __restrict__ seg_ptr,            // [B] segment starts
    T* __restrict__ out,                        // [B, V, H, D]
    int V, int S, int H, int n_kv, int D, int n_cols, float scale) {
  extern __shared__ float4 smem4[];
  __shared__ float m_sm[kMaxRows];
  __shared__ float l_sm[kMaxRows];
  __shared__ float corr_sm[kMaxRows];
  __shared__ int col_sm[kTile];     // the cache column of each tile row
  __shared__ int dmask_sm[kTile];   // valid[b, col]
  __shared__ float ks_sm[kTile];
  __shared__ float vs_sm[kTile];

  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int seg = seg_ptr[b];
  const int end = min(n_cols, seg + V);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int rep = H / n_kv;
  const int r0 = blockIdx.z * kMaxRows;
  const int rows = min(rep * V - r0, kMaxRows);
  const int rp = (rows + 3) & ~3;
  const int ld = D + 4;
  const bool quant = k_scale != nullptr;
  float* q_sm = reinterpret_cast<float*>(smem4);   // [rows, D]
  float* kv_sm = q_sm + rows * D;                  // [kTile, ld]
  float* p_sm = kv_sm + kTile * ld;                // [kTile, rp]
  uint64_t* masks = reinterpret_cast<uint64_t*>(p_sm + kTile * rp);

  // Block row r is segment position (r0 + r) / rep of query head
  // kh * rep + (r0 + r) % rep: the group's heads are consecutive in q.
  for (int i = tid; i < rows * D; i += kThreads) {
    const int r = i / D;
    const int d = i - r * D;
    const int h = kh * rep + (r0 + r) % rep;
    q_sm[i] = to_f(q[(((size_t)b * V + (r0 + r) / rep) * H + h) * D + d]);
  }
  for (int r = tid; r < rows; r += kThreads) {
    m_sm[r] = kNegInf;
    l_sm[r] = 0.f;
  }

  // P @ V: thread -> head_dim column tid % D and the 4-row chunks
  // grp, grp + groups, ... of the block's rows (acc holds up to 8).
  const int groups = kThreads / D;
  const int grp = tid / D;
  const int col_d = tid - grp * D;
  const bool pv = grp < groups;
  float acc[kMaxChunks * 4];
#pragma unroll
  for (int i = 0; i < kMaxChunks * 4; ++i) acc[i] = 0.f;

  // The keys any query of the row may attend below `end` (dmask, or
  // the segment [seg, end), flag 2), in column order (split_kv's live
  // map): tile t holds live keys kTile t .. kTile t + kTile - 1 wherever
  // they sit, so the sums' order follows the row's own key sequence,
  // not the cache columns the schedule wrote it at.
  const int n_pt = (end + split_kv::kBk - 1) / split_kv::kBk;
  int* first = reinterpret_cast<int*>(masks + 2 * n_pt);
  const bool* vrow = valid + (size_t)b * S;
  const int n_live = split_kv::live_map(
      [&](int c) { return vrow[c] ? 1 : (c >= seg ? 2 : 0); }, end, n_pt,
      masks, masks + n_pt, first);

  for (int g0 = 0; g0 < n_live; g0 += kTile) {
    __syncthreads();  // the previous tile's reads are done
    if (tid < kTile) {
      const int g = g0 + tid;
      const int col =
          g < n_live ? split_kv::live_column(g, n_pt, masks, first) : -1;
      col_sm[tid] = col;
      dmask_sm[tid] = col >= 0 && vrow[col];
      if (quant) {
        // A dead column's scale (NaN garbage, maybe) is never read.
        const size_t so = ((size_t)b * S + max(col, 0)) * n_kv + kh;
        ks_sm[tid] = col >= 0 ? __bfloat162float(k_scale[so]) : 0.f;
        vs_sm[tid] = col >= 0 ? __bfloat162float(v_scale[so]) : 0.f;
      }
    }
    __syncthreads();
    stage_tile(kv_sm, k, quant ? ks_sm : nullptr, col_sm, b, S, n_kv, kh,
               D);
    __syncthreads();

    // Scores: a warp takes one query row, lane j one tile column.
    for (int idx = tid; idx < rows * kTile; idx += kThreads) {
      const int r = idx / kTile;
      const int j = idx - r * kTile;
      const bool allow = dmask_sm[j] ||
                         (col_sm[j] >= 0 && col_sm[j] <= seg + (r0 + r) / rep);
      float s = kNegInf;
      if (allow) {
        const float4* qr = reinterpret_cast<const float4*>(q_sm + r * D);
        const float4* kr = reinterpret_cast<const float4*>(kv_sm + j * ld);
        // Four independent partial sums keep the FMA pipe busy.
        float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
#pragma unroll 4
        for (int c = 0; c < D / 4; ++c) {
          const float4 a = qr[c];
          const float4 x = kr[c];
          d0 = fmaf(a.x, x.x, d0);
          d1 = fmaf(a.y, x.y, d1);
          d2 = fmaf(a.z, x.z, d2);
          d3 = fmaf(a.w, x.w, d3);
        }
        s = ((d0 + d1) + (d2 + d3)) * scale;
      }
      p_sm[j * rp + r] = s;
    }
    __syncthreads();

    // Online softmax across tiles, one warp per row (lane = column);
    // the V tile is staged into the K tile's place meanwhile.
    for (int r = warp; r < rows; r += kThreads / 32) {
      const float s = p_sm[lane * rp + r];
      const float m_prev = m_sm[r];
      const float m_new = fmaxf(m_prev, warp_max(s));
      const float p = s > 0.5f * kNegInf ? expf(s - m_new) : 0.f;
      const float sum = warp_sum(p);
      p_sm[lane * rp + r] = p;
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        corr_sm[r] = corr;
        l_sm[r] = l_sm[r] * corr + sum;
        m_sm[r] = m_new;
      }
    }
    stage_tile(kv_sm, v, quant ? vs_sm : nullptr, col_sm, b, S, n_kv, kh,
               D);
    __syncthreads();

    // P @ V over the thread's column and row chunks (padding rows of a
    // chunk past `rows` accumulate garbage that is never written).
    if (pv) {
#pragma unroll
      for (int u = 0; u < kMaxChunks; ++u) {
        const int r = 4 * (grp + u * groups);
        if (r < rows) {
          acc[4 * u] *= corr_sm[r];
          acc[4 * u + 1] *= corr_sm[r + 1];
          acc[4 * u + 2] *= corr_sm[r + 2];
          acc[4 * u + 3] *= corr_sm[r + 3];
        }
      }
      for (int j = 0; j < kTile; ++j) {
        const float vj = kv_sm[j * ld + col_d];
        const float* pj = p_sm + j * rp;
#pragma unroll
        for (int u = 0; u < kMaxChunks; ++u) {
          const int r = 4 * (grp + u * groups);
          if (r < rows) {
            const float4 p = *reinterpret_cast<const float4*>(pj + r);
            acc[4 * u] = fmaf(p.x, vj, acc[4 * u]);
            acc[4 * u + 1] = fmaf(p.y, vj, acc[4 * u + 1]);
            acc[4 * u + 2] = fmaf(p.z, vj, acc[4 * u + 2]);
            acc[4 * u + 3] = fmaf(p.w, vj, acc[4 * u + 3]);
          }
        }
      }
    }
  }
  __syncthreads();

  if (pv) {
#pragma unroll
    for (int u = 0; u < kMaxChunks; ++u) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int r = 4 * (grp + u * groups) + x;
        if (r < rows) {
          const int h = kh * rep + (r0 + r) % rep;
          out[(((size_t)b * V + (r0 + r) / rep) * H + h) * D + col_d] =
              from_f<T>(acc[4 * u + x] / fmaxf(l_sm[r], 1e-30f));
        }
      }
    }
  }
}

// Dynamic shared memory of the f32 kernel: q, a tile, its scores, and
// the live map of a row of S columns (two 64-bit masks and an int count
// per 64 columns).
size_t smem_bytes(int rows, int D, int S) {
  const int rp = (rows + 3) & ~3;
  return sizeof(float) * ((size_t)rows * D + (size_t)kTile * (D + 4) +
                          (size_t)kTile * rp) +
         (size_t)20 * ((S + split_kv::kBk - 1) / split_kv::kBk) + 8;
}

template <typename KV>
int launch_f32(const void* q, const void* k, const void* v,
               const void* k_scale, const void* v_scale, const void* valid,
               const void* seg, void* out, int B, int V, int S, int H,
               int n_kv, int D, int n_cols, float scale,
               cudaStream_t stream) {
  const int rows = H / n_kv * V;
  const size_t smem = smem_bytes(rows < kMaxRows ? rows : kMaxRows, D, S);
  auto kernel = verify_attention_kernel<float, KV>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(n_kv, B, (rows + kMaxRows - 1) / kMaxRows);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const KV*>(k),
      static_cast<const KV*>(v),
      static_cast<const __nv_bfloat16*>(k_scale),
      static_cast<const __nv_bfloat16*>(v_scale),
      static_cast<const bool*>(valid), static_cast<const int*>(seg),
      static_cast<float*>(out), V, S, H, n_kv, D, n_cols, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------- bf16 route

// kInt8: the cache is int8 with per-vector scales; else bf16 like q.
// Grid (n_split, n_kv * chunks, B) of blocks of rows_per_block / 64
// warpgroups; block (split, kh * chunks + chunk, b) attends query rows
// [chunk * rows_per_block, ..) of kv head kh. part_ml
// [B * n_kv * chunks, n_split, rows_per_block, 2] and part_acc
// [.., rows_per_block, D] (f32) take the partials; counters
// [B * n_kv * chunks] are 0 at launch and left 0.
template <int D, bool kInt8>
__global__ void __launch_bounds__(split_kv::kMaxWg * split_kv::kWg)
    verify_attention_tc_kernel(
        const __nv_bfloat16* __restrict__ q,        // [B, V, H, D]
        const void* __restrict__ k,                 // [B, S, n_kv, D]
        const void* __restrict__ v,                 // [B, S, n_kv, D]
        const __nv_bfloat16* __restrict__ k_scale,  // [B, S, n_kv] (int8)
        const __nv_bfloat16* __restrict__ v_scale,  // [B, S, n_kv] (int8)
        const bool* __restrict__ valid,             // [B, S]
        const int* __restrict__ seg_ptr,            // [B] segment starts
        __nv_bfloat16* __restrict__ out,            // [B, V, H, D]
        float* __restrict__ part_ml, float* __restrict__ part_acc,
        int* __restrict__ counters, int V, int S, int H, int n_kv,
        int n_cols, int chunks, int split_tiles, float scale) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw +
      ((1024 - (flash_tc::smem_u32(smem_raw) & 1023)) & 1023);
  const int split = blockIdx.x;
  const int n_split = gridDim.x;
  const int kh = blockIdx.y / chunks;
  const int chunk = blockIdx.y - kh * chunks;
  const int b = blockIdx.z;
  const int slot = (b * n_kv + kh) * chunks + chunk;
  const int rep = H / n_kv;
  const int rb = blockDim.x / split_kv::kWg * 64;  // rows per block
  const int r0 = chunk * rb;
  const int n_rows = min(rb, rep * V - r0);
  // The split count comes from the static n_cols; the splits take the
  // live keys below `end` (columns past the segment hold nothing any
  // query sees), so a split past them writes an empty partial.
  const int seg = seg_ptr[b];
  const int end = min(n_cols, seg + V);
  const float scale2 = scale * flash_tc::kLog2e;  // scores in log2 units
  const bool* vrow = valid + (size_t)b * S;
  // Block row r: segment position (r0 + r) / rep, head kh * rep +
  // (r0 + r) % rep, at the same offset in q and out.
  const auto offset = [&](int r) {
    const int g = r0 + r;
    return (((size_t)b * V + g / rep) * H + kh * rep + g % rep) * D;
  };
  const auto q_row = [&](int r) { return q + offset(r); };
  // 1: dmask-true (every query attends it); 2: a segment column (the
  // queries at or after it attend it); 0: never read.
  const auto flag = [&](int c) {
    return c >= end ? 0 : vrow[c] ? 1 : c >= seg ? 2 : 0;
  };
  const auto row_lim = [&](int r) { return seg + (r0 + r) / rep; };
  float* ml = part_ml + (size_t)slot * n_split * rb * 2;
  float* acc = part_acc + (size_t)slot * n_split * rb * D;
  split_kv::attend<D, kInt8>(
      smem, q_row, n_rows, k, v, k_scale, v_scale,
      ((size_t)b * S * n_kv + kh) * D, (size_t)n_kv * D,
      (size_t)b * S * n_kv + kh, (size_t)n_kv,
      end, split, split_tiles, scale2, flag, row_lim,
      ml + (size_t)split * rb * 2, acc + (size_t)split * rb * D);
  if (!split_kv::arrive_last(counters + slot, n_split)) return;
  split_kv::merge<D>(smem, ml, acc, n_split, rb, n_rows, nullptr,
                     nullptr, [&](int r) { return out + offset(r); });
}

template <bool kInt8>
int launch_tc(const void* q, const void* k, const void* v,
              const void* k_scale, const void* v_scale, const void* valid,
              const void* seg, void* out, void* part_ml, void* part_acc,
              void* counters, int B, int V, int S, int H, int n_kv, int D,
              int n_cols, int n_split, int split_tiles, int rows_per_block,
              float scale, cudaStream_t stream) {
  const int chunks = (H / n_kv * V + rows_per_block - 1) / rows_per_block;
  const int warpgroups = rows_per_block / 64;
  return flash::with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    const size_t smem = split_kv::smem_bytes(kD, kInt8, S);
    auto kernel = verify_attention_tc_kernel<kD, kInt8>;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    kernel<<<dim3(n_split, n_kv * chunks, B), warpgroups * split_kv::kWg,
             smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), k, v,
        static_cast<const __nv_bfloat16*>(k_scale),
        static_cast<const __nv_bfloat16*>(v_scale),
        static_cast<const bool*>(valid), static_cast<const int*>(seg),
        static_cast<__nv_bfloat16*>(out), static_cast<float*>(part_ml),
        static_cast<float*>(part_acc), static_cast<int*>(counters), V, S, H,
        n_kv, n_cols, chunks, split_tiles, scale);
    return static_cast<int>(cudaGetLastError());
  });
}

}  // namespace

// dtype: 0 = float32 (CUDA-core kernel), 1 = bfloat16 (tensor-core
// split kernel: n_split >= 1 blocks per (kv head, row chunk, row) of
// split_tiles >= 1 64-key tiles each, n_split * split_tiles * 64
// covering n_cols, rows_per_block 64 or 128 query rows per block,
// part_ml/part_acc its f32 partials [B * n_kv * chunks * n_split *
// rows_per_block * 2] and [.. * rows_per_block * D] and counters int32
// [B * n_kv * chunks], zero at launch, chunks = ceil(rep * V / rows_per_block)) for q and
// out, and the cache unless kv_int8, when k_scale/v_scale must be
// given. Row b's segment occupies columns [seg[b], seg[b] + V), seg
// [B] int32 in device memory that the caller keeps within
// [0, n_cols - V];
// n_cols (<= S) bounds the columns read, and sets the launch geometry.
// head_dim must be a multiple of 16 up to 128. Returns
// cudaGetLastError() after the launch.
extern "C" int verify_attention(const void* q, const void* k, const void* v,
                                const void* k_scale, const void* v_scale,
                                const void* valid, const void* seg,
                                void* out, void* part_ml, void* part_acc,
                                void* counters, int B, int V, int S, int H,
                                int n_kv, int D, int n_cols, int n_split,
                                int split_tiles, int rows_per_block,
                                float scale, int dtype,
                                int kv_int8, void* stream) {
  if (D < 16 || D > kMaxD || D % 16 != 0 || n_kv < 1 || H % n_kv != 0 ||
      V < 1 || seg == nullptr || n_cols < V || n_cols > S ||
      (kv_int8 && (k_scale == nullptr || v_scale == nullptr)) ||
      (dtype == 1 &&
       (n_split < 1 || split_tiles < 1 || part_ml == nullptr ||
        part_acc == nullptr || counters == nullptr ||
        (rows_per_block != 64 &&
         rows_per_block != split_kv::kMaxRows))))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && !kv_int8)
    return launch_f32<float>(q, k, v, k_scale, v_scale, valid, seg, out, B,
                             V, S, H, n_kv, D, n_cols, scale, st);
  if (dtype == 0 && kv_int8)
    return launch_f32<int8_t>(q, k, v, k_scale, v_scale, valid, seg, out, B,
                              V, S, H, n_kv, D, n_cols, scale, st);
  if (dtype == 1 && !kv_int8)
    return launch_tc<false>(q, k, v, k_scale, v_scale, valid, seg, out,
                            part_ml, part_acc, counters, B, V, S, H, n_kv, D,
                            n_cols, n_split, split_tiles, rows_per_block,
                            scale, st);
  if (dtype == 1 && kv_int8)
    return launch_tc<true>(q, k, v, k_scale, v_scale, valid, seg, out,
                           part_ml, part_acc, counters, B, V, S, H, n_kv, D,
                           n_cols, n_split, split_tiles, rows_per_block,
                           scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
