// Q1: the product of activations with an int8 weight, for Hopper
// (sm_90a), plain C interface.
//
// y[M, N] = (x[M, K] @ q[K, N]) * s[N]: x bf16 or f32, q int8 in the
// reference's [in, out] layout, s the f32 per-output-channel scale.
// Replaces no Pallas kernel: the reference's qdot
// (skypilot_tpu/models/quantization.py::qdot) leaves it to XLA, which
// fuses the int8 -> bf16 convert into the dot's operand read, so no
// dequantized copy of a weight is ever written. This kernel is that
// fusion by hand: it reads the int8 tile, converts it on chip and
// applies the scale in its epilogue.
//
// What bounds it on an H100: at decode (M 8, a verify tick's 40, a
// batch-128 step) bytes -- the weight is read once, K * N bytes, and each
// byte takes 2 * M operations, under the ~295 per byte of the tensor
// cores' ridge; at a prefill chunk (M 256) the operations.
//
// bf16 x, the wgmma route (int8_matmul_wgmma_kernel), for N % 16 == 0
// and a 16-byte-aligned q (what a tensor map takes). The product is
// computed transposed, y^T[N, M] = q^T[N, K] x^T[K, M], so the tokens are
// wgmma's N side: one shape, m64nMTk16 with MT in {8, .., 128} the token
// tile (M rounded up; more row blocks past 128), serves decode, verify
// and prefill without padding rows to 64. A block owns 128 output
// columns and MT tokens: two consumer warpgroups of 64 columns each and
// one producer warp. The producer's one thread keeps a ring of STAGES
// stages full with TMA (cp.async.bulk.tensor, mbarrier-completed): per
// 64-deep K slab the raw int8 q tile [64][128] and the bf16 x tile
// [MT][64], both in the 128-byte swizzle (the hardware zero-fills past
// M, K and N). The weight stays int8 in shared memory (half the bytes of
// bf16) and is converted once per block, by the warp that owns its
// columns: ldmatrix .trans reads the int8 tile as b16 (two columns an
// element), and int8_pairs_to_bf16 turns each register exactly into the
// (k, k + 1) pairs of columns n and n + 1 -- an m16k16 A fragment of q^T
// whose rows are the warp's 16 columns interleaved even, odd. x feeds
// wgmma as B straight from the TMA tile (K-major). A warp converts a
// whole slab's fragments, issues the slab's four wgmmas as one group and
// retires it before converting the next (so ptxas need not serialize
// the wgmmas): the two warpgroups of a block overlap each other's
// conversion; a stage goes back to the producer on its "empty" mbarrier
// once the group reading it has retired.
//
// Measured against the mma.sync design below in one call: PERF.md, Q1
// table. Not taken, each slower in trial runs on the card: overlapping
// a warp's own conversion with its wgmmas in flight (two fragment sets
// alternating, per k-step or per slab), for which ptxas serializes every
// wgmma of the kernel; clusters of two column blocks sharing the x tile
// by TMA multicast (the x tile's L2 traffic is not what holds the kernel
// back); a 256-token tile, whose 128 accumulators a thread leave ptxas
// too few registers to pipeline the wgmmas.
//
// Split-K inside the kernel: where the output tiles alone leave the SMs
// idle (decode at N 1024-4096), K is split over gridDim.z; each split
// writes its f32 partial in accumulator-fragment order (coalesced 16-byte
// stores), and the last block to arrive on the tile -- an int32 counter
// per tile, zeroed once per device (split_kv.reserve) and reset by that
// block -- sums the partials in split order 0 .. S - 1 and writes the
// output. No float atomics: the same inputs give the same bits on every
// launch and every graph replay. The wrapper plans the tile and the
// splits (ops/int8_matmul.py::plan) so that the partials never exceed
// the weight's bytes. Epilogue: each thread holds columns n, n + 1 of
// its tokens, so every store instruction of a warp fills whole 32-byte
// sectors (four token rows x 16 columns) with no staging pass.
//
// bf16 x, the mma.sync route (int8_matmul_mma_kernel), the first design:
// for an N % 16 != 0 or a q that a tensor map cannot take (the wgmma
// route measured faster at every M, decode's 8 rows and the lm_head
// included), so no main-path shape reaches it and it keeps one row block,
// kMmaBm. Eight warps own 128 columns and the block's rows; cp.async
// fills a ring of raw int8 q and bf16 x slabs; each warp converts its
// own B fragments as above and mma.sync m16n8k16 accumulates in f32;
// split-K folds into the kernel the same way, planned by the same rule.
//
// Both bf16 routes round the same way: a bf16 output is the f32 sum
// rounded to bf16, times the scale rounded to bf16, rounded again (the
// reference's matmul in bf16, then * s.astype(bf16)); an f32 output (the
// lm_head's preferred f32) is the f32 sum times the f32 scale.
//
// f32 x (int8_matmul_f32_kernel) stays on the CUDA cores in full f32 so
// the greedy-exact parity runs keep their 1e-4 bar: a 32 x 64 output tile
// per block of 256 threads, each thread 2 x 4 outputs, k ascending.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "flash_tc.cuh"

namespace {

using flash_tc::smem_u32;

constexpr int kBk = 64;        // K slab
constexpr int kBn = 128;       // output columns of a block
constexpr int kThreads = 256;  // eight warps (the mma.sync route)

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One ldmatrix .trans register of the raw int8 tile, read as b16, holds
// bytes (k, n), (k, n + 1), (k + 1, n), (k + 1, n + 1). They become two
// bf16 pairs, exactly: `even` = (k, k + 1) of column n, `odd` = of
// column n + 1 -- the B-fragment halves of mma.sync for those columns,
// or the rows n and n + 1 of an A fragment of q^T. Byte b of
// w ^ 0x80808080 is q + 128 in [1, 255]; __byte_perm puts it in the low
// mantissa byte of 2^23 (0x4B000000), so the f32 is 2^23 + 128 + q, and
// 2^23 + 128 subtracted leaves q; an integer of magnitude < 256 has no
// mantissa bits below bf16's, so the upper half of the f32 is its bf16.
__device__ __forceinline__ void int8_pairs_to_bf16(uint32_t w,
                                                   uint32_t& even,
                                                   uint32_t& odd) {
  const uint32_t u = w ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int b = 0; b < 4; ++b)
    f[b] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + b)) -
           8388736.f;
  even = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[2]), 0x7632);
  odd = __byte_perm(__float_as_uint(f[1]), __float_as_uint(f[3]), 0x7632);
}

// The stored value of one output: a bf16 output is the f32 sum rounded
// to bf16, times the scale rounded to bf16, rounded again; an f32 one
// the f32 sum times the f32 scale.
__device__ __forceinline__ __nv_bfloat16 round_out(float v, float sc) {
  const float vb = __bfloat162float(__float2bfloat16(v));
  const float sb = __bfloat162float(__float2bfloat16(sc));
  return __float2bfloat16(vb * sb);
}

__device__ __forceinline__ void store_out(void* out, size_t i, float v,
                                          float sc, int out_f32) {
  if (out_f32)
    static_cast<float*>(out)[i] = v * sc;
  else
    static_cast<__nv_bfloat16*>(out)[i] = round_out(v, sc);
}

// Split-K in the kernel, shared by both bf16 routes. `acc` (R floats a
// thread, R % 4 == 0) is this block's partial of output tile `tile`;
// `partial` holds, per tile, S splits x R / 4 x `nthreads` float4 in
// fragment order. Every split writes its partial; the last of the S
// blocks of the tile to arrive (its int32 counter) reloads all of them
// and sums them in split order into `acc`, and resets the counter.
// Returns false in every other block, which then stores nothing. Called
// by `nthreads` threads (thread index `ctid`) that `sync()` joins.
template <int R, typename Sync>
__device__ __forceinline__ bool fold_splits(float (&acc)[R],
                                            float* __restrict__ partial,
                                            int* __restrict__ counters,
                                            int tile, int ctid, int nthreads,
                                            const Sync& sync) {
  __shared__ int last;
  const int n_split = gridDim.z;
  float4* p = reinterpret_cast<float4*>(partial) +
              (size_t)tile * n_split * (R / 4) * nthreads;
  float4* mine = p + (size_t)blockIdx.z * (R / 4) * nthreads;
#pragma unroll
  for (int j = 0; j < R / 4; ++j)
    mine[j * nthreads + ctid] =
        make_float4(acc[4 * j], acc[4 * j + 1], acc[4 * j + 2],
                    acc[4 * j + 3]);
  __threadfence();  // this thread's partial is visible device-wide
  sync();
  if (ctid == 0) {
    last = atomicAdd(counters + tile, 1) == n_split - 1;
    if (last) counters[tile] = 0;
  }
  sync();
  if (!last) return false;
  __threadfence();
  // Split by split, every accumulator's loads issued together (they are
  // independent): the order of the sum is 0, 1, .., S - 1 for each one.
#pragma unroll
  for (int j = 0; j < R / 4; ++j) {
    const float4 v = __ldcg(p + j * nthreads + ctid);
    acc[4 * j] = v.x;
    acc[4 * j + 1] = v.y;
    acc[4 * j + 2] = v.z;
    acc[4 * j + 3] = v.w;
  }
  for (int z = 1; z < n_split; ++z) {
    const float4* pz = p + (size_t)z * (R / 4) * nthreads + ctid;
#pragma unroll
    for (int j = 0; j < R / 4; ++j) {
      const float4 v = __ldcg(pz + j * nthreads);
      acc[4 * j] += v.x;
      acc[4 * j + 1] += v.y;
      acc[4 * j + 2] += v.z;
      acc[4 * j + 3] += v.w;
    }
  }
  return true;
}

// ------------------------------------------------------ the wgmma route

constexpr int kWgThreads = 288;           // two consumer warpgroups + a
constexpr int kConsumers = 256;           // producer warp
constexpr int kQTile = kBk * kBn;         // 8192 bytes: [64 k][128 n] int8

// The stages of the token tile MT: a ring of (q tile, x tile) pairs,
// then the full and empty mbarriers; 1024 bytes of slack align the
// tiles to the 128-byte swizzle's 1024-byte period.
template <int MT, int STAGES>
struct WgSmem {
  static constexpr int kXTile = MT * kBk * 2;
  static constexpr int kStage = kQTile + kXTile;
  static constexpr size_t kBytes =
      1024 + (size_t)STAGES * kStage + 2 * STAGES * sizeof(uint64_t);
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// A 2-D tile of the tensor map at coordinates (c0 innermost, c1) into
// shared memory at `dst`, completing on the mbarrier `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// d (+)= A B for one m64nNk16 step, N = 2 x the size of d (the token
// tile): A (64 rows of q^T by 16 k) from registers, B (the x tile, N
// tokens by 16 k) K-major from shared memory through descriptor b.
__device__ __forceinline__ void wgmma_tokens(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_tokens(float (&d)[8],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_tokens(float (&d)[16],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_tokens(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}
__device__ __forceinline__ void wgmma_tokens(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t b) {
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
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Grid (column blocks of 128, token blocks of MT, splits). Warps 0-3 and
// 4-7 are the consumer warpgroups of columns n0 .. n0 + 63 and
// n0 + 64 .. n0 + 127; warp 8 is the producer. Split z takes slabs
// [z * slabs, (z + 1) * slabs) of K.
//
// A consumer warp converts a whole slab's A fragments (four k-steps, two
// ldmatrix.x4 .trans), issues the slab's four wgmmas as one group and
// waits for it before it converts the next slab: a register that a wgmma
// in flight reads is never written (ptxas serializes every wgmma of a
// kernel that does), so the overlap of conversion and products comes
// from the other warpgroup (and, at token tiles up to 64, the other
// block) on the SM. The slab's stage then goes back to the producer.
//
// Accumulator fragment of consumer thread (warp w of warpgroup c, lane
// 4 g + t), j < MT / 8, e < 2: acc[4 j + e] is y[m][n] and
// acc[4 j + 2 + e] is y[m][n + 1] for m = m0 + 8 j + 2 t + e and
// n = n0 + 64 c + 16 w + 2 g (A row g is column 2 g, row g + 8 column
// 2 g + 1).
template <int MT, int STAGES, int MIN_BLOCKS>
__global__ void __launch_bounds__(kWgThreads, MIN_BLOCKS)
    int8_matmul_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tx,
                             const float* __restrict__ s, void* out,
                             float* __restrict__ partial,
                             int* __restrict__ counters, int M, int K, int N,
                             int out_f32, int slabs) {
  using L = WgSmem<MT, STAGES>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t full = base + STAGES * L::kStage;
  const uint32_t empty = full + STAGES * sizeof(uint64_t);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * kBn, m0 = blockIdx.y * MT;
  const int n_tiles = (K + kBk - 1) / kBk;
  const int t0 = blockIdx.z * slabs;
  const int n_local = min(n_tiles, t0 + slabs) - t0;  // >= 1 (the plan)

  if (tid == 0) {
#pragma unroll 1
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full + st * 8, 1);
      mbar_init(empty + st * 8, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumers / 32) {  // the producer
    if (lane == 0) {
#pragma unroll 1
      for (int i = 0; i < n_local; ++i) {
        const int st = i % STAGES;
        if (i >= STAGES) mbar_wait(empty + st * 8, ((i / STAGES) - 1) & 1);
        const uint32_t dst = base + st * L::kStage;
        const int k0 = (t0 + i) * kBk;
        mbar_expect_tx(full + st * 8, L::kStage);
        tma_load(dst, &tq, n0, k0, full + st * 8);
        tma_load(dst + kQTile, &tx, k0, m0, full + st * 8);
      }
    }
    return;
  }

  const int wg = warp >> 2, w = warp & 3;
  const int unit = wg * 4 + w;  // the warp's 16 columns: unit of a q row
  float acc[MT / 2];
#pragma unroll
  for (int i = 0; i < MT / 2; ++i) acc[i] = 0.f;
  uint32_t a[4][4];  // [k-step][fragment]

#pragma unroll 1
  for (int i = 0; i < n_local; ++i) {
    const int st = i % STAGES;
    mbar_wait(full + st * 8, (i / STAGES) & 1);
    const uint32_t qs = base + st * L::kStage;
    const uint32_t xs = qs + kQTile;
#pragma unroll
    for (int kp = 0; kp < 2; ++kp) {
      // Lane l addresses q row 32 kp + l: matrices 0-3 are k rows
      // 0-7, 8-15 (step 2 kp) and 16-23, 24-31 (step 2 kp + 1).
      const int row = kp * 32 + lane;
      uint32_t r[4];
      ldmatrix_x4_trans(r, qs + row * 128 + ((unit ^ (row & 7)) << 4));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int8_pairs_to_bf16(r[2 * h], a[2 * kp + h][0], a[2 * kp + h][1]);
        int8_pairs_to_bf16(r[2 * h + 1], a[2 * kp + h][2],
                           a[2 * kp + h][3]);
      }
    }
    flash_tc::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_tokens(acc, a[ks], flash_tc::desc_kmajor<MT>(xs, ks));
    flash_tc::wgmma_commit();
    flash_tc::wgmma_wait<0>();
    if (lane == 0) mbar_arrive(empty + st * 8);
  }
  flash_tc::fence_regs(acc);

  if (gridDim.z > 1 &&
      !fold_splits(acc, partial, counters, blockIdx.y * gridDim.x + blockIdx.x,
                   tid, kConsumers, [] { consumers_sync(); }))
    return;

  const int g = lane >> 2, t = lane & 3;
  const int n = n0 + wg * 64 + w * 16 + 2 * g;
  if (n >= N) return;  // N % 16 == 0: n + 1 < N with n
  const float s0 = s[n], s1 = s[n + 1];
#pragma unroll
  for (int j = 0; j < MT / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int m = m0 + 8 * j + 2 * t + e;
      if (m >= M) continue;
      const float v0 = acc[4 * j + e], v1 = acc[4 * j + 2 + e];
      const size_t o = (size_t)m * N + n;
      if (out_f32) {
        *reinterpret_cast<float2*>(static_cast<float*>(out) + o) =
            make_float2(v0 * s0, v1 * s1);
      } else {
        __nv_bfloat162 v;
        v.x = round_out(v0, s0);
        v.y = round_out(v1, s1);
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) +
                                           o) = v;
      }
    }
  }
}

// ---------------------------------------------------- the mma.sync route

constexpr int kQStride = kBn + 16;  // bytes a raw q row takes (16 B pad)
constexpr int kXStride = kBk + 8;   // bf16 an x row takes (16 B pad)
constexpr int kMmaBm = 64, kMmaStages = 4;  // the one row block, its ring

// One stage of the ring: the raw int8 q slab [64][kQStride] and the
// bf16 x slab [BM][kXStride]. The pads put the 8 rows one ldmatrix reads
// in 8 different bank groups.
template <int BM, int STAGES>
struct MmaSmem {
  static constexpr int kQTile = kBk * kQStride;
  static constexpr int kXTile = BM * kXStride * 2;
  static constexpr int kStage = kQTile + kXTile;
  static constexpr size_t kBytes = (size_t)STAGES * kStage;
};

// Grid (column blocks, row blocks, splits); eight warps, WARPS_M x
// (8 / WARPS_M), each owning (BM / WARPS_M) rows and (128 * WARPS_M / 8)
// columns. Split z takes slabs [z * slabs, (z + 1) * slabs).
//
// The int8 slab stays int8 in shared memory: ldmatrix .trans reads it
// as b16 (two columns an element), and int8_pairs_to_bf16 turns each
// register into the B fragments of two 8-column mma tiles, one of the
// group's even columns and one of its odd ones, so the epilogue's
// column of virtual column j of a 16-column group at c is c + 2 j (+ 1).
template <int BM, int WARPS_M, int STAGES>
__global__ void __launch_bounds__(kThreads)
    int8_matmul_mma_kernel(const __nv_bfloat16* __restrict__ x,
                           const int8_t* __restrict__ q,
                           const float* __restrict__ s, void* out,
                           float* __restrict__ partial,
                           int* __restrict__ counters, int M, int K, int N,
                           int out_f32, int vec_q, int slabs) {
  using L = MmaSmem<BM, STAGES>;
  constexpr int kWarpsN = 8 / WARPS_M;
  constexpr int kWarpRows = BM / WARPS_M;
  constexpr int kMt = kWarpRows / 16;         // m16 tiles per warp
  constexpr int kGroups = kBn / kWarpsN / 16;  // 16-column groups per warp
  constexpr int kQVecs = kBk * kBn / 16;      // 16-byte q units per slab
  constexpr int kXVecs = BM * kBk / 8;        // 16-byte x units per slab
  constexpr int kAcc = kMt * kGroups * 8;     // accumulator floats a thread
  extern __shared__ __align__(128) unsigned char smem[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / kWarpsN, wn = warp % kWarpsN;
  const int n0 = blockIdx.x * kBn, m0 = blockIdx.y * BM;
  const int n_tiles = (K + kBk - 1) / kBk;
  const int t0 = blockIdx.z * slabs;
  const int n_local = max(0, min(n_tiles, t0 + slabs) - t0);

  // Slab t into stage st: cp.async for every 16-byte unit (zero-filled
  // past M, K or N); a q whose rows are not 16-byte units (N % 16 != 0)
  // is copied byte by byte instead.
  auto load = [&](int t, int st) {
    const int k0 = t * kBk;
    int8_t* qd = reinterpret_cast<int8_t*>(smem + st * L::kStage);
    for (int v = tid; v < kQVecs; v += kThreads) {
      const int r = v / (kBn / 16), c = (v % (kBn / 16)) * 16;
      const int k = k0 + r, n = n0 + c;
      if (vec_q) {
        const bool ok = k < K && n < N;  // N % 16 == 0: whole unit in
        cp_async16(smem_u32(qd + r * kQStride + c),
                   ok ? q + (size_t)k * N + n : q, ok);
      } else {
#pragma unroll
        for (int j = 0; j < 16; ++j)
          qd[r * kQStride + c + j] =
              (k < K && n + j < N) ? q[(size_t)k * N + n + j] : int8_t(0);
      }
    }
    __nv_bfloat16* xd = reinterpret_cast<__nv_bfloat16*>(
        smem + st * L::kStage + L::kQTile);
    for (int v = tid; v < kXVecs; v += kThreads) {
      const int r = v / (kBk / 8), c = (v % (kBk / 8)) * 8;
      const int m = m0 + r, k = k0 + c;
      const bool ok = m < M && k < K;  // K % 8 == 0: whole unit in
      cp_async16(smem_u32(xd + r * kXStride + c),
                 ok ? x + (size_t)m * K + k : x, ok);
    }
  };

  // acc[mi][g][0] holds the group's even columns, [1] its odd ones.
  float acc[kMt][kGroups][2][4];
#pragma unroll
  for (int i = 0; i < kMt; ++i)
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][g][p][e] = 0.f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_local) load(t0 + st, st);
    cp_async_commit();
  }

  for (int i = 0; i < n_local; ++i) {
    const int st = i % STAGES;
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slab i landed; slab i - 1's products are done
    const int ahead = i + STAGES - 1;
    if (ahead < n_local) load(t0 + ahead, ahead % STAGES);
    cp_async_commit();

    const unsigned char* qs = smem + st * L::kStage;
    const __nv_bfloat16* xs =
        reinterpret_cast<const __nv_bfloat16*>(qs + L::kQTile);
#pragma unroll
    for (int kk = 0; kk < kBk; kk += 16) {
      uint32_t a[kMt][4];
#pragma unroll
      for (int mi = 0; mi < kMt; ++mi) {
        const int row = wm * kWarpRows + mi * 16 + ((lane >> 3) & 1) * 8 +
                        (lane & 7);
        const int col = kk + (lane >> 4) * 8;
        ldmatrix_x4(a[mi], smem_u32(xs + row * kXStride + col));
      }
#pragma unroll
      for (int g = 0; g < kGroups; ++g) {
        // Matrices (k 0-7) and (k 8-15) of the group's 16 columns.
        const int row = kk + ((lane >> 3) & 1) * 8 + (lane & 7);
        const int col = (wn * kGroups + g) * 16;
        uint32_t r[2], b_even[2], b_odd[2];
        ldmatrix_x2_trans(r, smem_u32(qs + row * kQStride + col));
        int8_pairs_to_bf16(r[0], b_even[0], b_odd[0]);
        int8_pairs_to_bf16(r[1], b_even[1], b_odd[1]);
#pragma unroll
        for (int mi = 0; mi < kMt; ++mi) {
          mma_bf16(acc[mi][g][0], a[mi], b_even);
          mma_bf16(acc[mi][g][1], a[mi], b_odd);
        }
      }
    }
  }
  cp_async_wait<0>();

  if (gridDim.z > 1 &&
      !fold_splits(reinterpret_cast<float(&)[kAcc]>(acc), partial, counters,
                   blockIdx.y * gridDim.x + blockIdx.x, tid, kThreads,
                   [] { __syncthreads(); }))
    return;

  // Thread (row g8, t4) holds rows g8 and g8 + 8 of each m16 tile and,
  // of each 16-column group at c, columns c + 4 t4 + {0, 1, 2, 3}: even
  // [0], odd [0], even [1], odd [1].
  const int g8 = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int g = 0; g < kGroups; ++g) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + (wn * kGroups + g) * 16 + 4 * t4 + j;
      if (n >= N) continue;
      const float sc = s[n];
#pragma unroll
      for (int mi = 0; mi < kMt; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + wm * kWarpRows + mi * 16 + g8 + 8 * h;
          if (m < M)
            store_out(out, (size_t)m * N + n,
                      acc[mi][g][j & 1][2 * h + (j >> 1)], sc, out_f32);
        }
      }
    }
  }
}

// ------------------------------------------------------- the f32 route

constexpr int kF32Bm = 32, kF32Bn = 64, kF32Bk = 32, kF32Threads = 256;

__global__ void __launch_bounds__(kF32Threads)
    int8_matmul_f32_kernel(const float* __restrict__ x,
                           const int8_t* __restrict__ q,
                           const float* __restrict__ s,
                           float* __restrict__ out, int M, int K, int N) {
  __shared__ float xs[kF32Bk][kF32Bm + 1];
  __shared__ float qs[kF32Bk][kF32Bn];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int n0 = blockIdx.x * kF32Bn, m0 = blockIdx.y * kF32Bm;
  float acc[2][4] = {};
  for (int k0 = 0; k0 < K; k0 += kF32Bk) {
    for (int v = tid; v < kF32Bm * kF32Bk; v += kF32Threads) {
      const int r = v / kF32Bk, c = v % kF32Bk;
      const int m = m0 + r, k = k0 + c;
      xs[c][r] = (m < M && k < K) ? x[(size_t)m * K + k] : 0.f;
    }
    for (int v = tid; v < kF32Bk * kF32Bn; v += kF32Threads) {
      const int r = v / kF32Bn, c = v % kF32Bn;
      const int k = k0 + r, n = n0 + c;
      qs[r][c] = (k < K && n < N) ? static_cast<float>(q[(size_t)k * N + n])
                                  : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < kF32Bk; ++k) {
      const float a0 = xs[k][ty * 2], a1 = xs[k][ty * 2 + 1];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float b = qs[k][tx * 4 + j];
        acc[0][j] = fmaf(a0, b, acc[0][j]);
        acc[1][j] = fmaf(a1, b, acc[1][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + ty * 2 + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx * 4 + j;
      if (n < N) out[(size_t)m * N + n] = acc[i][j] * s[n];
    }
  }
}

// ------------------------------------------------------------ launches

int launch_mma(const void* x, const void* q, const void* s, void* out,
               void* partial, void* counters, int M, int K, int N,
               int out_f32, int n_split, cudaStream_t stream) {
  using L = MmaSmem<kMmaBm, kMmaStages>;
  auto kernel = int8_matmul_mma_kernel<kMmaBm, 1, kMmaStages>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::kBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec_q =
      N % 16 == 0 && (reinterpret_cast<uintptr_t>(q) & 15) == 0;
  const int n_tiles = (K + kBk - 1) / kBk;
  const int slabs = (n_tiles + n_split - 1) / n_split;
  dim3 grid((N + kBn - 1) / kBn, (M + kMmaBm - 1) / kMmaBm, n_split);
  kernel<<<grid, kThreads, L::kBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int8_t*>(q),
      static_cast<const float*>(s), out, static_cast<float*>(partial),
      static_cast<int*>(counters), M, K, N, out_f32, vec_q, slabs);
  return static_cast<int>(cudaGetLastError());
}

// cuTensorMapEncodeTiled, taken from the driver through the runtime (no
// -lcuda); a pure host-side encode: no device call, so it is free to run
// during a CUDA graph capture, and the map travels by value as a
// __grid_constant__ parameter (captured with the launch).
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major [rows][cols] matrix of `elem` bytes an element as a 2-D
// tensor map with boxes of box_cols x box_rows (box_cols * elem == 128:
// one swizzle row), 128-byte swizzle, zeros past the edges.
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, int elem,
                const void* ptr, int rows, int cols, int box_cols,
                int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int MT, int STAGES, int MIN_BLOCKS>
int launch_wgmma(const void* x, const void* q, const void* s, void* out,
                 void* partial, void* counters, int M, int K, int N,
                 int out_f32, int n_split, cudaStream_t stream) {
  using L = WgSmem<MT, STAGES>;
  auto kernel = int8_matmul_wgmma_kernel<MT, STAGES, MIN_BLOCKS>;
  CUtensorMap tq, tx;
  if (!tensor_map(&tq, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, q, K, N, kBn, kBk) ||
      !tensor_map(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, M, K, kBk, MT))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::kBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (K + kBk - 1) / kBk;
  const int slabs = (n_tiles + n_split - 1) / n_split;
  dim3 grid((N + kBn - 1) / kBn, (M + MT - 1) / MT, n_split);
  kernel<<<grid, kWgThreads, L::kBytes, stream>>>(
      tq, tx, static_cast<const float*>(s), out, static_cast<float*>(partial),
      static_cast<int*>(counters), M, K, N, out_f32, slabs);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = f32 x (f32 output), 1 = bf16 x (bf16 output, or f32 with
// out_f32). route (bf16 x): 1 = mma.sync with row block m_tile (64),
// 2 = wgmma with token tile m_tile (8, 16, 32, 64 or 128;
// N % 16 == 0 and q 16-byte aligned). x must be 16-byte aligned with
// K % 8 == 0. K is cut into n_split splits (the wrapper's plan, every
// split non-empty); with n_split > 1, `partial` holds n_split * M-tiles *
// column blocks * m_tile * 128 floats and `counters` one zeroed int32 per
// output tile, which the kernel leaves zeroed. q and s may have any
// alignment on route 1.
extern "C" int int8_matmul(const void* x, const void* q, const void* s,
                           void* out, void* partial, void* counters, int M,
                           int K, int N, int dtype, int out_f32, int route,
                           int m_tile, int n_split, void* stream) {
  if (M < 1 || K < 1 || N < 1 || x == nullptr || q == nullptr ||
      s == nullptr || out == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    dim3 grid((N + kF32Bn - 1) / kF32Bn, (M + kF32Bm - 1) / kF32Bm);
    int8_matmul_f32_kernel<<<grid, kF32Threads, 0, st>>>(
        static_cast<const float*>(x), static_cast<const int8_t*>(q),
        static_cast<const float*>(s), static_cast<float*>(out), M, K, N);
    return static_cast<int>(cudaGetLastError());
  }
  const int n_tiles = (K + kBk - 1) / kBk;
  if (dtype != 1 || K % 8 != 0 ||
      (reinterpret_cast<uintptr_t>(x) & 15) != 0 || n_split < 1 ||
      n_split > n_tiles ||
      (n_split > 1 && (partial == nullptr || counters == nullptr)) ||
      (n_split - 1) * ((n_tiles + n_split - 1) / n_split) >= n_tiles)
    return static_cast<int>(cudaErrorInvalidValue);
  if (route == 1) {
    if (m_tile != kMmaBm) return static_cast<int>(cudaErrorInvalidValue);
    return launch_mma(x, q, s, out, partial, counters, M, K, N, out_f32,
                      n_split, st);
  }
  if (route != 2 || N % 16 != 0 || (reinterpret_cast<uintptr_t>(q) & 15) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (m_tile) {
    case 8:
      return launch_wgmma<8, 8, 2>(
          x, q, s, out, partial, counters, M, K, N, out_f32, n_split, st);
    case 16:
      return launch_wgmma<16, 8, 2>(
          x, q, s, out, partial, counters, M, K, N, out_f32, n_split, st);
    case 32:
      return launch_wgmma<32, 8, 2>(
          x, q, s, out, partial, counters, M, K, N, out_f32, n_split, st);
    case 64:
      return launch_wgmma<64, 6, 2>(
          x, q, s, out, partial, counters, M, K, N, out_f32, n_split, st);
    case 128:
      return launch_wgmma<128, 8, 1>(
          x, q, s, out, partial, counters, M, K, N, out_f32, n_split, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
