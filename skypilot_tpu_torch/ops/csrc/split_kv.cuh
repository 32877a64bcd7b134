// Split-KV (flash-decoding) attention on the tensor cores: the bf16
// route of paged_decode.cu's K1 and verify_attention.cu's K3.
//
// Both kernels attend a few query rows per kv head (K1: the rep query
// heads of one GQA group; K3: rep heads x V segment tokens) over a long
// run of cache columns, so they are bound by the bytes of K and V, and
// one block per (row, kv head) leaves most of the card idle. Here the
// columns of each (row, kv head) are split into n_split contiguous
// ranges of 64-column tiles (split_begin), one block per range:
//
//   * attend() runs one block's range: the block's query rows, padded
//     to 64-row warpgroup tiles (W warpgroups, rows of warpgroup w at
//     64 w ..), stay in registers as wgmma A fragments, so shared
//     memory holds K/V tiles only; the tiles of the range stream
//     through a ring filled by cp.async (a bf16 cache: three stages,
//     tiles t + 1 and t + 2 in flight while tile t's products run) or
//     by registers (an int8 cache, Int8Rows: two stages, tile t + 1 in
//     flight); S = Q K^T and O += P V run on wgmma (m64n64k16,
//     m64nDpk16, Q and P from registers as bf16), the online
//     softmax in f32 on the fragments in log2 units. A column that no
//     row may read (flag 0) is never loaded: it fills with zeros, so NaN
//     there cannot reach the accumulator, and its probability is zeroed
//     explicitly. int8 scales are applied as the reference applies
//     them: K's on the f32 scores, V's folded into bf16(P * v_scale),
//     l summing the unscaled P. The block writes its unnormalised
//     partial (m, l, acc) in f32.
//   * arrive_last() counts the blocks of one (row, kv head) in an
//     int32 counter: the block that arrives last merges, and resets the
//     counter to 0 for the next launch, so nothing is cleared per call.
//   * merge() combines the partials in split order (deterministic:
//     the same inputs give the same bits at any timing), with K1's own
//     token as one more term: the splits' weights 2^(m_i - M) go to
//     shared memory first, then the partial outputs are summed four
//     columns at a time.
//
// A column costs 2 x 64 x head_dim x 2 operations for 4 x head_dim
// bytes of bf16 K and V (64 operations per byte with the row padding),
// under the ~295 per byte where the H100's tensor cores become the
// limit: the padded rows cost no time.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_tc.cuh"

namespace split_kv {

constexpr int kWg = 128;   // threads per warpgroup
constexpr int kBk = 64;    // cache columns per tile
constexpr int kMaxWg = 2;  // warpgroups (64-row query tiles) per block
constexpr int kMaxRows = kMaxWg * 64;
constexpr int kMaxSplit = 64;  // merge weights fit the tile ring

// K/V stages of the ring: a bf16 cache keeps two tiles in flight
// (cp.async), an int8 one a tile in registers.
__host__ __device__ constexpr int stages(bool int8) { return int8 ? 2 : 3; }

// First tile of split i of n over T tiles: contiguous ranges in order,
// their sizes differing by at most one (empty where T < n).
__host__ __device__ __forceinline__ int split_begin(int T, int i, int n) {
  return static_cast<int>(static_cast<long long>(T) * i / n);
}

// Dynamic shared memory of a block: the ring's K and V tiles, plus the
// 1024-byte alignment slack. The merge reuses it for kMaxSplit x
// kMaxRows f32 weights (32 KB, within the smallest ring).
__host__ __device__ constexpr size_t smem_bytes(int D, bool int8) {
  return (size_t)2 * stages(int8) * 64 * flash_tc::padded(D) * 2 + 1024;
}

// Attend the block's rows [0, n_rows) — row r's D bf16 query values at
// q_row(r) — over the tiles [t0, t1) of one kv head of a cache whose
// column c starts at element kv_base + c * kv_stride (k_cache, v_cache;
// the int8 scales at scale_base + c * scale_stride). flag(c) is 0 for a
// column no row may attend (never read), 1 for one every row attends,
// and 2 for one row r attends only if c <= row_lim(r) (K3's segment
// columns). Writes row r's partial to ml[2 r] (m, log2 units),
// ml[2 r + 1] (l) and acc[r * D ..] (the unnormalised output).
template <int D, bool kInt8, typename QRow, typename Flag, typename Lim>
__device__ __forceinline__ void attend(
    uint8_t* smem, const QRow& q_row, int n_rows, const void* k_cache,
    const void* v_cache, const __nv_bfloat16* k_scale,
    const __nv_bfloat16* v_scale, size_t kv_base, size_t kv_stride,
    size_t scale_base, size_t scale_stride, int t0, int t1, float scale2,
    const Flag& flag, const Lim& row_lim, float* ml, float* acc_out) {
  using namespace flash_tc;
  using KV = typename std::conditional<kInt8, int8_t, __nv_bfloat16>::type;
  constexpr int Dp = padded(D);
  constexpr int kTile = 64 * Dp * 2;  // bytes of a K or V tile
  constexpr int kStages = stages(kInt8);
  // Flags of tiles t .. t + kStages: tile t0 + i in slot i % (kStages
  // + 1), written a loop iteration before the tile's loads read them,
  // so no load waits on a flag from device memory.
  __shared__ int flags[kStages + 1][kBk];
  __shared__ float scales[4][kBk];    // K[0], K[1], V[0], V[1] (int8)

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int wg = tid / kWg;
  const int lt = tid % kWg;
  const uint32_t base = smem_u32(smem);
  // Stage b's K tile at base + b * kTile, its V tile kStages tiles on.
  const auto k_tile = [&](int b) { return base + b * kTile; };
  const auto v_tile = [&](int b) { return base + (kStages + b) * kTile; };
  // This thread's first accumulator row in its warpgroup; the second
  // is + 8.
  const int row_in = ((lt >> 5) & 3) * 16 + ((lt & 31) >> 2);
  const int cq = 2 * (lt & 3);
  const int lim[2] = {row_lim(wg * 64 + row_in),
                      row_lim(wg * 64 + row_in + 8)};
  const KV* k = static_cast<const KV*>(k_cache) + kv_base;
  const KV* v = static_cast<const KV*>(v_cache) + kv_base;
  const auto slot = [](int i) { return i % (kStages + 1); };

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  float acc[Dp / 2];
#pragma unroll
  for (int i = 0; i < Dp / 2; ++i) acc[i] = 0.f;

  if (t0 < t1) {
    if (wg == 0)
      for (int t = 0; t < 2 * kStages; ++t)
        zero_padding<D, 64, kWg>(smem + t * kTile);
    // The rows' A fragments (a_frag's layout): k-step ks holds columns
    // 16 ks + cq (+1) and 16 ks + 8 + cq (+1) of rows row_in and
    // row_in + 8; rows past n_rows are zeros.
    uint32_t qa[D / 16][4];
    {
      const int r_lo = wg * 64 + row_in;
      const bool lo = r_lo < n_rows, hi = r_lo + 8 < n_rows;
      const __nv_bfloat16* q_lo = q_row(lo ? r_lo : 0);
      const __nv_bfloat16* q_hi = q_row(hi ? r_lo + 8 : 0);
      const auto ld = [](const __nv_bfloat16* p, bool ok) {
        return ok ? *reinterpret_cast<const uint32_t*>(p) : 0u;
      };
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const int c = 16 * ks + cq;
        qa[ks][0] = ld(q_lo + c, lo);
        qa[ks][1] = ld(q_hi + c, hi);
        qa[ks][2] = ld(q_lo + c + 8, lo);
        qa[ks][3] = ld(q_hi + c + 8, hi);
      }
    }

    // The flags of tile t0 + i into its slot (none past t1).
    auto put_flags = [&](int i) {
      if (tid < kBk && t0 + i < t1)
        flags[slot(i)][tid] = flag((t0 + i) * kBk + tid);
    };
    // Tile t0 + i's K and V (and scales) into stage `buf`: cp.async for
    // bf16; for int8, warpgroup 0's fetch() starts the loads and put()
    // stores them. Its flags are in shared memory already.
    Int8Rows<D, kBk, kWg> k8, v8;
    float sc = 0.f;  // this thread's scale of the tile being fetched
    auto fetch = [&](int i, int buf) {
      const int c0 = (t0 + i) * kBk;
      const int* f = flags[slot(i)];
      const auto live = [&](int c) { return f[c - c0] != 0; };
      if constexpr (kInt8) {
        if (wg == 0) {
          k8.load_if(k, c0, kv_stride, live);
          v8.load_if(v, c0, kv_stride, live);
          // Threads 0..63 hold K's scales, 64..127 V's; 0 where dead.
          const int c = c0 + (lt & (kBk - 1));
          const __nv_bfloat16* src = lt < kBk ? k_scale : v_scale;
          sc = live(c) ? __bfloat162float(src[scale_base + c * scale_stride])
                       : 0.f;
        }
      } else {
        load_kv_rows_if<D, kBk>(k_tile(buf), v_tile(buf), k, v, c0,
                                kv_stride, tid, nthreads, live);
      }
    };
    auto put = [&](int buf) {
      if constexpr (kInt8) {
        if (wg == 0) {
          k8.store(smem + buf * kTile);
          v8.store(smem + (kStages + buf) * kTile);
          scales[lt < kBk ? buf : 2 + buf][lt & (kBk - 1)] = sc;
        }
      }
    };
    for (int p = 0; p < kStages; ++p) put_flags(p);
    __syncthreads();
    // bf16: tiles t0 .. t0 + kStages - 2 in flight before the loop, one
    // commit group each (empty past t1, so the group count stays fixed).
    if constexpr (kInt8) {
      fetch(0, 0);
      put(0);
    } else {
      for (int p = 0; p < kStages - 1; ++p) {
        if (t0 + p < t1) fetch(p, p);
        cp_async_commit();
      }
    }

    for (int t = t0; t < t1; ++t) {
      const int c0 = t * kBk;
      const int i = t - t0;
      const int buf = i % kStages;
      const bool more = t + 1 < t1;
      const int* f = flags[slot(i)];
      // Into the slot tile t - 1 left (read before the last barrier).
      put_flags(i + kStages);
      if constexpr (kInt8) {
        if (more) fetch(i + 1, buf ^ 1);
        cp_async_wait<0>();  // fences put()'s stores for wgmma
      } else {
        // Into the stage tile t - 1 left (its reads ended at the last
        // barrier).
        if (t + kStages - 1 < t1)
          fetch(i + kStages - 1, (i + kStages - 1) % kStages);
        cp_async_commit();
        cp_async_wait<kStages - 1>();
      }
      // Tile t landed. A tile with no live column (a hole, an inactive
      // row's cache) holds only zeros: nothing to add.
      if (!__syncthreads_or(tid < kBk && f[tid] != 0)) {
        if constexpr (kInt8) {
          if (more) put(buf ^ 1);
        }
        continue;
      }
      const uint32_t k_s = k_tile(buf);
      const uint32_t v_s = v_tile(buf);

      float s[kBk / 2];
#pragma unroll
      for (int j = 0; j < kBk / 2; ++j) s[j] = 0.f;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_rs_kmajor(s, qa[ks], desc_kmajor<kBk>(k_s, ks), ks > 0);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);

#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kBk / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + cq + e;
            const int fc = f[c];
            float x = s[4 * j + 2 * h + e] * scale2;
            if constexpr (kInt8) x *= scales[buf][c];
            if (fc == 0 || (fc == 2 && c0 + c > lim[h])) x = -INFINITY;
            s[4 * j + 2 * h + e] = x;
            mx = fmaxf(mx, x);
          }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[h], mx);
        const float m_use = m_new == -INFINITY ? 0.f : m_new;
        const float corr = exp2f(m[h] - m_use);
        m[h] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kBk / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + cq + e;
            const float x = s[4 * j + 2 * h + e];
            const float p = x == -INFINITY ? 0.f : exp2f(x - m_use);
            sum += p;
            if constexpr (kInt8)
              s[4 * j + 2 * h + e] = p * scales[2 + buf][c];
            else
              s[4 * j + 2 * h + e] = p;
          }
        l[h] = l[h] * corr + sum;
#pragma unroll
        for (int j = 0; j < Dp / 8; ++j) {
          acc[4 * j + 2 * h] *= corr;
          acc[4 * j + 2 * h + 1] *= corr;
        }
      }

      uint32_t pa[kBk / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBk / 16; ++kk) a_frag(s, kk, pa[kk]);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBk / 16; ++kk)
        wgmma_rs(acc, pa[kk], desc_mnmajor<kBk>(v_s, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      // int8: tile t + 1 into the stage tile t - 1 left.
      if constexpr (kInt8) {
        if (more) put(buf ^ 1);
      }
      __syncthreads();  // tile t's reads are done before its stage is
                        // refilled
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int r = wg * 64 + row_in + 8 * i;
    if (r >= n_rows) continue;
    if ((lt & 3) == 0) {
      ml[2 * r] = m[i];
      ml[2 * r + 1] = li;
    }
    float* o = acc_out + (size_t)r * D;
#pragma unroll
    for (int j = 0; j < Dp / 8; ++j)
      if (8 * j < D)
        *reinterpret_cast<float2*>(o + 8 * j + cq) =
            make_float2(acc[4 * j + 2 * i], acc[4 * j + 2 * i + 1]);
  }
}

// Called by every thread of a block once its partial is written: true
// in the block that arrives last of the n_split blocks sharing
// `counter`, which then merges (every partial is visible to it) and has
// reset the counter to 0 for the next launch.
__device__ __forceinline__ bool arrive_last(int* counter, int n_split) {
  __shared__ int last;
  __threadfence();  // this thread's partial is visible device-wide
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(counter, 1) == n_split - 1;
    if (last) *counter = 0;
  }
  __syncthreads();
  if (last) __threadfence();
  return last != 0;
}

// Merge the n_split partials of rows [0, n_rows) (split i's row r at
// ml[2 (i * rows_max + r)] and acc[(i * rows_max + r) * D]) in split
// order: M = max(m_i, self), L = sum l_i 2^(m_i - M) (+ 2^(self - M)),
// o = (sum acc_i 2^(m_i - M) (+ 2^(self - M) v_self)) / L, written as
// bf16 to out_row(r). self_s (per row, log2 units, scaled) and v_self
// (D values) add the token's own K/V as one more term; null: none. A
// row with nothing to attend writes zeros. `smem` (the block's tile
// ring, free by now) takes the weights, n_split x n_rows f32
// (n_split <= kMaxSplit).
template <int D, typename OutRow>
__device__ __forceinline__ void merge(uint8_t* smem, const float* ml,
                                      const float* acc, int n_split,
                                      int rows_max, int n_rows,
                                      const float* self_s,
                                      const __nv_bfloat16* v_self,
                                      const OutRow& out_row) {
  __shared__ float inv_sm[kMaxRows];
  __shared__ float self_w[kMaxRows];
  float* w = reinterpret_cast<float*>(smem);  // [n_split][n_rows]
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  for (int r = tid; r < n_rows; r += nthreads) {
    float mx = self_s != nullptr ? self_s[r] : -INFINITY;
    for (int i = 0; i < n_split; ++i)
      mx = fmaxf(mx, __ldcg(ml + 2 * ((size_t)i * rows_max + r)));
    const float mu = mx == -INFINITY ? 0.f : mx;
    const float ws = self_s != nullptr ? exp2f(self_s[r] - mu) : 0.f;
    float sum = ws;
    for (int i = 0; i < n_split; ++i) {
      const float* p = ml + 2 * ((size_t)i * rows_max + r);
      const float wi = exp2f(__ldcg(p) - mu);
      w[i * n_rows + r] = wi;
      sum += __ldcg(p + 1) * wi;
    }
    self_w[r] = ws;
    inv_sm[r] = 1.f / fmaxf(sum, 1e-30f);
  }
  __syncthreads();
  constexpr int kQuads = D / 4;
  for (int idx = tid; idx < n_rows * kQuads; idx += nthreads) {
    const int r = idx / kQuads;
    const int d = 4 * (idx - r * kQuads);
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    if (self_s != nullptr) {
      const float ws = self_w[r];
      const float2 a = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(v_self + d));
      const float2 b = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(v_self + d + 2));
      o = make_float4(ws * a.x, ws * a.y, ws * b.x, ws * b.y);
    }
#pragma unroll 4
    for (int i = 0; i < n_split; ++i) {
      const float wi = w[i * n_rows + r];
      const float4 a = __ldcg(reinterpret_cast<const float4*>(
          acc + ((size_t)i * rows_max + r) * D + d));
      o.x += wi * a.x;
      o.y += wi * a.y;
      o.z += wi * a.z;
      o.w += wi * a.w;
    }
    const float inv = inv_sm[r];
    const __nv_bfloat162 lo = __floats2bfloat162_rn(o.x * inv, o.y * inv);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(o.z * inv, o.w * inv);
    *reinterpret_cast<uint2*>(out_row(r) + d) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&lo),
                   *reinterpret_cast<const uint32_t*>(&hi));
  }
}

}  // namespace split_kv
