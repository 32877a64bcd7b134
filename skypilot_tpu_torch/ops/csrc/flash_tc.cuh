// Tensor-core tile layer of the bf16 attention kernels: flash_fwd.cu's
// K4, flash_bwd.cu's K5a and K5b, chunk_prefill.cu's K2, and (through
// split_kv.cuh) paged_decode.cu's K1 and verify_attention.cu's K3, each
// on its bf16 route.
//
// Tiles: R rows x D head_dim columns of one head of a [B, S, H, D] bf16
// tensor (load_tile), or of any bf16 matrix with a row stride and a
// live-row bound, such as a kv head of a [G, S, n_kv, D] cache
// (load_rows), or of an int8 cache converted on the way (Int8Rows); kept
// in shared memory as bf16 in wgmma's 128-byte-swizzle layout. Columns
// are padded to Dp = D rounded up to 64 and split into Dp / 64 chunks of
// [R][64] (128-byte rows), one chunk after the other; within a chunk the
// 16-byte unit u of row r sits at unit u ^ (r % 8) — the XOR of address
// bits [4, 7) with bits [7, 10) that wgmma and the tensor-memory copy
// engine apply for SWIZZLE_128B. Tiles start 1024-byte aligned.
//
// The same tile feeds wgmma two ways, by descriptor:
//   * K-major (head_dim is the contraction: S = Q K^T, dP^T = V dO^T):
//     a 16-column k-step starts 32 bytes further in a chunk's rows, the
//     next chunk R * 128 bytes further; 8-row groups are 1024 bytes apart.
//   * MN-major (the rows are the contraction: O += P V, dV += P^T dO,
//     dK += dS^T Q — the B operand is [k][n] with n contiguous, which
//     bf16 wgmma reads through its transpose bit): a 16-row k-step starts
//     16 * 128 bytes further; the 64-column chunks along n are R * 128
//     bytes apart (the leading byte offset), 8-row groups 1024.
// Loads are cp.async 16-byte copies (zero-filled past the sequence end),
// issued by every thread and committed as a group, so the next tile's
// copy is in flight while the current tile's products run. A thread
// fences its landed copies into the async proxy before the barrier that
// hands them to wgmma.
//
// Products are wgmma.mma_async m64nNk16, bf16 in, f32 accumulate, one
// warpgroup (128 threads) per 64 rows. The f32 accumulator fragment of
// thread t in warp w of its warpgroup holds, for j < N / 8,
//   d[4j + e]     at row 16w + t/4,     column 8j + 2(t%4) + e   (e < 2)
//   d[4j + 2 + e] at row 16w + t/4 + 8, column 8j + 2(t%4) + e,
// which is also the A-from-registers fragment of the next product once
// packed to bf16 pairs (a_frag): P and dS never pass through shared
// memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash_tc {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// head_dim padded to the 64-column swizzle chunk.
__host__ __device__ constexpr int padded(int d) { return (d + 63) / 64 * 64; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Byte offset of the 16-byte unit u (columns 8u .. 8u + 7) of row r in a
// tile of R rows.
template <int R>
__device__ __forceinline__ uint32_t unit_offset(int r, int u) {
  return (u >> 3) * (R * 128) + r * 128 + (((u & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups are in flight, then make this
// thread's landed copies visible to wgmma (the async proxy). A
// __syncthreads() must follow before any warpgroup reads the tiles.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Rows [row0, row0 + R) of head h of a [B, S, H, D] bf16 tensor into the
// tile at `dst`, one cp.async per 16 bytes; rows at or past S fill with
// zeros. The columns D .. Dp of the tile are not written.
template <int D, int R, int kThreads>
__device__ __forceinline__ void load_tile(uint32_t dst,
                                          const __nv_bfloat16* src, int b,
                                          int row0, int S, int H, int h) {
  constexpr int kUnits = D / 8;  // 16-byte units per row
  for (int i = threadIdx.x; i < R * kUnits; i += kThreads) {
    const int r = i / kUnits;
    const int u = i - r * kUnits;
    const int s = row0 + r;
    const bool ok = s < S;
    const __nv_bfloat16* p =
        src + ((((size_t)b * S + (ok ? s : 0)) * H + h) * D + u * 8);
    cp_async16(dst + unit_offset<R>(r, u), p, ok);
  }
}

// Rows [row0, row0 + R) of a bf16 matrix whose row s starts at
// src + s * stride (elements) into the tile at `dst`, one cp.async per
// 16 bytes. Rows at or past `end` fill with zeros and are never read, so
// they may hold anything (NaN past a KV cache's causal frontier); `end`
// is the live-row bound, independent of the stride. The columns D .. Dp
// of the tile are not written.
template <int D, int R, int kThreads>
__device__ __forceinline__ void load_rows(uint32_t dst,
                                          const __nv_bfloat16* src, int row0,
                                          int end, size_t stride) {
  constexpr int kUnits = D / 8;
  for (int i = threadIdx.x; i < R * kUnits; i += kThreads) {
    const int r = i / kUnits;
    const int u = i - r * kUnits;
    const int s = row0 + r;
    const bool ok = s < end;
    cp_async16(dst + unit_offset<R>(r, u), src + (ok ? s : 0) * stride + u * 8,
               ok);
  }
}

// Rows [row0, row0 + R) of two bf16 matrices with one row stride (a
// kv head's K and V: row s at k + s * stride and v + s * stride) into
// the tiles at `dst_k` and `dst_v`, as load_rows does, but row s loads
// only where live(s) holds (evaluated once per row and thread for
// both): the other rows fill with zeros and are never read, so a dead
// slot anywhere in the tile may hold anything. Thread `tid` of
// `nthreads` takes units tid, tid + nthreads, ... (any block size).
template <int D, int R, typename Live>
__device__ __forceinline__ void load_kv_rows_if(
    uint32_t dst_k, uint32_t dst_v, const __nv_bfloat16* k,
    const __nv_bfloat16* v, int row0, size_t stride, int tid, int nthreads,
    const Live& live) {
  constexpr int kUnits = D / 8;
  for (int i = tid; i < R * kUnits; i += nthreads) {
    const int r = i / kUnits;
    const int u = i - r * kUnits;
    const int s = row0 + r;
    const bool ok = live(s);
    const size_t off = (ok ? (size_t)s : 0) * stride + u * 8;
    cp_async16(dst_k + unit_offset<R>(r, u), k + off, ok);
    cp_async16(dst_v + unit_offset<R>(r, u), v + off, ok);
  }
}

// int8 rows into a bf16 tile. cp.async cannot convert, so the rows come
// through registers in two steps: load() starts 16-byte global loads of
// rows [row0, row0 + R) (zeros at or past `end`, which are never read),
// and store() — called later, so the loads are in flight meanwhile —
// converts them to bf16 and writes them into the same swizzled layout as
// load_rows. The conversion is exact: |x| <= 128 fits bf16's 8-bit
// significand. store() writes through the generic proxy: a
// fence.proxy.async (cp_async_wait does one) and a barrier must follow
// before wgmma reads the tile.
template <int D, int R, int kThreads>
struct Int8Rows {
  static constexpr int kUnits = D / 16;  // 16-byte int8 units per row
  static constexpr int kPer = (R * kUnits + kThreads - 1) / kThreads;
  uint4 v[kPer];

  __device__ __forceinline__ void load(const int8_t* src, int row0, int end,
                                       size_t stride) {
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int i = threadIdx.x + p * kThreads;
      const int r = i / kUnits;
      const int s = row0 + r;
      v[p] = make_uint4(0, 0, 0, 0);
      if (i < R * kUnits && s < end)
        v[p] = *reinterpret_cast<const uint4*>(src + s * stride +
                                               (i - r * kUnits) * 16);
    }
  }

  // As load(), but row s loads only where live(s) holds (zeros
  // elsewhere, never read).
  template <typename Live>
  __device__ __forceinline__ void load_if(const int8_t* src, int row0,
                                          size_t stride, const Live& live) {
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int i = threadIdx.x + p * kThreads;
      const int r = i / kUnits;
      const int s = row0 + r;
      v[p] = make_uint4(0, 0, 0, 0);
      if (i < R * kUnits && live(s))
        v[p] = *reinterpret_cast<const uint4*>(src + s * stride +
                                               (i - r * kUnits) * 16);
    }
  }

  __device__ __forceinline__ void store(uint8_t* tile) const {
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int i = threadIdx.x + p * kThreads;
      if (i >= R * kUnits) continue;
      const int r = i / kUnits;
      const int u = i - r * kUnits;
      const uint32_t w[4] = {v[p].x, v[p].y, v[p].z, v[p].w};
      uint32_t b[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // Bytes 0..3 of word j are columns 4j .. 4j + 3.
        const auto col = [&](int k) {
          return static_cast<float>(static_cast<int8_t>(w[j] >> (8 * k)));
        };
        b[2 * j] = pack_bf16(col(0), col(1));
        b[2 * j + 1] = pack_bf16(col(2), col(3));
      }
      *reinterpret_cast<uint4*>(tile + unit_offset<R>(r, 2 * u)) =
          make_uint4(b[0], b[1], b[2], b[3]);
      *reinterpret_cast<uint4*>(tile + unit_offset<R>(r, 2 * u + 1)) =
          make_uint4(b[4], b[5], b[6], b[7]);
    }
  }
};

// Zero the padding columns D .. Dp of an R-row tile (none when D is a
// multiple of 64): products whose n is head_dim run over all Dp columns,
// and the padding's outputs are dropped, but zeros keep them finite.
template <int D, int R, int kThreads>
__device__ __forceinline__ void zero_padding(uint8_t* tile) {
  constexpr int kUnits = D / 8, kPadUnits = padded(D) / 8 - D / 8;
  if constexpr (kPadUnits > 0) {
    for (int i = threadIdx.x; i < R * kPadUnits; i += kThreads) {
      const int r = i / kPadUnits;
      const int u = kUnits + (i - r * kPadUnits);
      *reinterpret_cast<uint4*>(tile + unit_offset<R>(r, u)) =
          make_uint4(0, 0, 0, 0);
    }
  }
}

__device__ __forceinline__ uint64_t descriptor(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) |
         (1ull << 62);  // SWIZZLE_128B
}

// K-major operand: k-step ks (columns 16 ks .. 16 ks + 15) of the rows
// that start at `rows` (a tile base plus 128 bytes per skipped row) of
// an R-row tile.
template <int R>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t rows, int ks) {
  return descriptor(rows + (ks & 3) * 32 + (ks >> 2) * (R * 128), 16, 1024);
}

// MN-major operand: k-step ks (rows 16 ks .. 16 ks + 15) of an R-row
// tile, n running over the head_dim columns.
template <int R>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t tile, int ks) {
  return descriptor(tile + ks * 16 * 128, R * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of products are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int M>
__device__ __forceinline__ void fence_regs(float (&d)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Columns 16 kk .. 16 kk + 15 of an accumulator fragment as the bf16 A
// fragment of an m64k16 product.
template <int M>
__device__ __forceinline__ void a_frag(const float (&d)[M], int kk,
                                       uint32_t (&a)[4]) {
  a[0] = pack_bf16(d[8 * kk + 0], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// d (+)= A B for one m64nNk16 step, N = 64 or 128 (the size of d
// picks it). wgmma_ss: A and B from shared memory, both K-major.
// wgmma_rs: A from registers, B MN-major (transposed). scale_d 0
// overwrites d.
__device__ __forceinline__ void wgmma_ss(
    float (&d)[32], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_ss(
    float (&d)[64], uint64_t a, uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(
    float (&d)[32], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// As wgmma_rs (A from registers) for N = 64, but B K-major (not
// transposed): S = Q K^T with Q held as register fragments.
__device__ __forceinline__ void wgmma_rs_kmajor(
    float (&d)[32], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

__device__ __forceinline__ void wgmma_rs(
    float (&d)[64], const uint32_t (&a)[4], uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

}  // namespace flash_tc
