// Flash-attention backward for Hopper (sm_90a), plain C interface: two
// kernels, as in the TPU split.
//
// Replaces the TPU kernels skypilot_tpu/ops/flash_attention.py::
// _dq_kernel (flash_dq here) and ::_dkv_kernel (flash_dkv), both driven
// by _flash_bwd_pallas. Inputs are the forward's q/k/v/o [B, S, H, D]
// (f32 or bf16, GQA repeated out), its lse [B, H, Sq] f32 and the
// output gradient dO [B, Sq, H, D] in the same type. Both recompute
// P = exp(q.k * scale - lse) tile by tile (no S x S matrix ever touches
// device memory) and form dS = P * (dP - delta) * scale with
// dP = dO . V^T and delta = rowsum(dO * O). Then
//   flash_dq:  dQ = sum over key tiles of dS . K           (3 products)
//   flash_dkv: dV = sum over query tiles of P^T . dO,
//              dK = sum over query tiles of dS^T . Q        (4 products)
// flash_dq runs first: it computes delta from its query tile's O and dO
// and also writes it to a [B, H, Sq] f32 output, which the bf16
// flash_dkv reads instead of re-reading O for every key tile. Each block
// owns its output tile and loops over the other axis, so there are no
// atomics and runs are deterministic. Causal masking is bottom-right
// aligned (query i sees key j when i + Sk - Sq >= j), and both loops skip
// the tiles past the diagonal.
//
// What bounds them on an H100: at the training shapes (B 4, H 16,
// S 2048, D 128, bf16, causal) the products are 103 GFLOP (dq) and
// 137 GFLOP (dkv) per call, against ~60 MB of inputs — the bf16
// tensor-core rate bounds both (~0.1 ms). The input type picks the
// kernels:
//
// bf16 runs every product on the tensor cores (flash_tc.cuh), in
// FlashAttention-2's two loops. flash_dq (flash_dq_tc_kernel) is
// query-stationary: one block of two warpgroups owns 128 query rows of
// dQ (64 per warpgroup; Q and dO loaded once, delta summed from O and dO
// in a prologue while the first key tile loads) and walks 64-key tiles of
// K and V up to the causal frontier, double-buffered with cp.async, the
// heaviest query tiles first. Per tile: S = Q K^T and dP = dO V^T (wgmma,
// both operands from shared memory, K-major), P and dS / scale on the
// fragments in registers, then dQ += dS K (wgmma, dS as a bf16 register A
// operand, K through the transpose bit). flash_dkv (flash_dkv_tc_kernel)
// is key-stationary: one block of two warpgroups owns 128 keys of dK and
// dV (64 per warpgroup, K and V loaded once) and walks 64-query tiles
// from the causal start, Q, dO, lse and delta double-buffered with
// cp.async. Per tile: S^T = K Q^T and dP^T = V dO^T, P^T and dS^T /
// scale on the fragments, then dV += P^T dO and dK += dS^T Q (P^T and
// dS^T as bf16 register A operands, dO and Q through the transpose bit).
// dQ and dK take the scale once at the end. P and dS are rounded to bf16
// for the products that take them, as flash kernels on tensor cores do.
//
// f32 runs its products in f32 on the CUDA cores — the f32 route holds a
// 1e-4 bar that TF32 products would not. The same 16 x 16 thread grid
// and float4 tiles as the forward (flash_common.cuh) keep several FMAs
// per shared-memory load. flash_dq stages Q and dO once per 64-query
// tile and 32-key tiles of K and V (111 KB, two blocks per SM); the f32
// flash_dkv stages K and V once per 64-key tile and 32-query tiles of Q
// and dO, recomputes delta from O, and keeps P and dS in shared memory
// for the two transposed products (119 KB, one block per SM).

#include "flash_common.cuh"
#include "flash_tc.cuh"

namespace {

using namespace flash;

// flash_dq: query rows per block, keys per tile.
constexpr int kDqBq = 64;
constexpr int kDqBk = 32;
// flash_dkv: keys per block, query rows per tile.
constexpr int kKvBk = 64;
constexpr int kKvBq = 32;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ o,
    const float* __restrict__ lse, const T* __restrict__ dO,
    T* __restrict__ dq, float* __restrict__ delta, int Sq, int Sk, int H,
    float scale, int causal) {
  constexpr int ld = D + 4;
  constexpr int ldp = kDqBk + 4;
  constexpr int RM = kDqBq / 16;
  constexpr int RN = kDqBk / 16;
  extern __shared__ float4 smem4[];
  float* q_sm = reinterpret_cast<float*>(smem4);  // [kDqBq][ld]
  float* do_sm = q_sm + kDqBq * ld;               // [kDqBq][ld]
  float* k_sm = do_sm + kDqBq * ld;               // [kDqBk][ld]
  float* v_sm = k_sm + kDqBk * ld;                // [kDqBk][ld]
  float* ds_sm = v_sm + kDqBk * ld;               // [kDqBq][ldp]
  float* delta_sm = ds_sm + kDqBq * ldp;          // [kDqBq]
  float* lse_sm = delta_sm + kDqBq;               // [kDqBq]

  const int q0 = blockIdx.x * kDqBq;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const int offset = Sk - Sq;
  const int q_last = min(Sq, q0 + kDqBq) - 1;
  const int kv_end = causal ? min(Sk, q_last + offset + 1) : Sk;

  stage<T, D, kDqBq>(q_sm, q, b, q0, Sq, H, h);
  stage_do_delta<T, D, kDqBq>(do_sm, delta_sm, lse_sm, dO, o, lse, b, q0,
                              Sq, H, h);

  float acc[RM][D / 16];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < kv_end; k0 += kDqBk) {
    __syncthreads();  // the previous tile's K and dS reads are done
    stage<T, D, kDqBk>(k_sm, k, b, k0, Sk, H, h);
    stage<T, D, kDqBk>(v_sm, v, b, k0, Sk, H, h);
    __syncthreads();
    float s[RM][RN], dp[RM][RN];
    dot_nt<D, RM, RN>(q_sm, k_sm, ty, tx, s);
    dot_nt<D, RM, RN>(do_sm, v_sm, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const int c = tx + 16 * j;
        const float p = allowed(q0 + r, k0 + c, Sq, Sk, offset, causal)
                            ? expf(s[i][j] * scale - lse_sm[r])
                            : 0.f;
        ds_sm[r * ldp + c] = p * (dp[i][j] - delta_sm[r]) * scale;
      }
    }
    __syncthreads();  // dS visible
    acc_nn<D, RM, kDqBk>(ds_sm, ldp, k_sm, ty, tx, acc);
  }

  // delta for flash_dkv, written after the loop so that the loop's code
  // stays as it was (visible: the loop ran at least once, through its
  // barriers, since kv_end >= 1).
  if (threadIdx.x < kDqBq && q0 + threadIdx.x < Sq)
    delta[((size_t)b * H + h) * Sq + q0 + threadIdx.x] =
        delta_sm[threadIdx.x];

#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    T* out = dq + row_index(b, row, Sq, H, h, D);
#pragma unroll
    for (int j = 0; j < D / 16; ++j) out[tx + 16 * j] = from_f<T>(acc[i][j]);
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k,
    const T* __restrict__ v, const T* __restrict__ o,
    const float* __restrict__ lse, const T* __restrict__ dO,
    T* __restrict__ dk, T* __restrict__ dv, int Sq, int Sk, int H,
    float scale, int causal) {
  constexpr int ld = D + 4;
  constexpr int ldp = kKvBk + 4;
  constexpr int RQ = kKvBq / 16;  // score rows (queries) per thread
  constexpr int RK = kKvBk / 16;  // score columns (keys) per thread
  extern __shared__ float4 smem4[];
  float* k_sm = reinterpret_cast<float*>(smem4);  // [kKvBk][ld]
  float* v_sm = k_sm + kKvBk * ld;                // [kKvBk][ld]
  float* q_sm = v_sm + kKvBk * ld;                // [kKvBq][ld]
  float* do_sm = q_sm + kKvBq * ld;               // [kKvBq][ld]
  float* p_sm = do_sm + kKvBq * ld;               // [kKvBq][ldp]
  float* ds_sm = p_sm + kKvBq * ldp;              // [kKvBq][ldp]
  float* delta_sm = ds_sm + kKvBq * ldp;          // [kKvBq]
  float* lse_sm = delta_sm + kKvBq;               // [kKvBq]

  const int k0 = blockIdx.x * kKvBk;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const int offset = Sk - Sq;
  // The first query row that may see key k0 (row + offset >= k0), down
  // to its tile.
  const int q_begin = causal ? max(0, k0 - offset) / kKvBq * kKvBq : 0;

  stage<T, D, kKvBk>(k_sm, k, b, k0, Sk, H, h);
  stage<T, D, kKvBk>(v_sm, v, b, k0, Sk, H, h);

  float acc_dk[RK][D / 16], acc_dv[RK][D / 16];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc_dk[i][j] = acc_dv[i][j] = 0.f;

  for (int q0 = q_begin; q0 < Sq; q0 += kKvBq) {
    __syncthreads();  // the previous tile's Q, dO, P and dS reads are done
    stage<T, D, kKvBq>(q_sm, q, b, q0, Sq, H, h);
    stage_do_delta<T, D, kKvBq>(do_sm, delta_sm, lse_sm, dO, o, lse, b, q0,
                                Sq, H, h);
    __syncthreads();
    float s[RQ][RK], dp[RQ][RK];
    dot_nt<D, RQ, RK>(q_sm, k_sm, ty, tx, s);
    dot_nt<D, RQ, RK>(do_sm, v_sm, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int c = tx + 16 * j;
        const float p = allowed(q0 + r, k0 + c, Sq, Sk, offset, causal)
                            ? expf(s[i][j] * scale - lse_sm[r])
                            : 0.f;
        p_sm[r * ldp + c] = p;
        ds_sm[r * ldp + c] = p * (dp[i][j] - delta_sm[r]) * scale;
      }
    }
    __syncthreads();  // P and dS visible
    acc_tn<D, RK, kKvBq>(p_sm, ldp, do_sm, ty, tx, acc_dv);
    acc_tn<D, RK, kKvBq>(ds_sm, ldp, q_sm, ty, tx, acc_dk);
  }

#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= Sk) continue;
    const size_t base = row_index(b, row, Sk, H, h, D);
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      dk[base + tx + 16 * j] = from_f<T>(acc_dk[i][j]);
      dv[base + tx + 16 * j] = from_f<T>(acc_dv[i][j]);
    }
  }
}

// ---------------------------------------------------------- bf16 route

constexpr int kTcKvBk = 128;  // keys per block: two warpgroups of 64
constexpr int kTcKvBq = 64;   // query rows per tile

template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_dkv_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const float* __restrict__ lse,
    const float* __restrict__ delta, const __nv_bfloat16* __restrict__ dO,
    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq,
    int Sk, int H, float scale, int causal) {
  using namespace flash_tc;
  constexpr int Dp = padded(D);
  constexpr int kKvTile = kTcKvBk * Dp * 2;  // bytes of the K or V tile
  constexpr int kQTile = kTcKvBq * Dp * 2;   // bytes of a Q or dO tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // K, V, Q[0], Q[1], dO[0], dO[1], then f32 lse[2][64], delta[2][64].
  const uint32_t k_s = smem_u32(smem);
  const uint32_t v_s = k_s + kKvTile;
  const uint32_t q_s = k_s + 2 * kKvTile;  // Q[i] at +i, dO[i] at +2 + i
  float* stats = reinterpret_cast<float*>(smem + 2 * kKvTile + 4 * kQTile);
  const uint32_t stats_s = smem_u32(stats);

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  // Low key tiles see the most queries under the causal mask: they come
  // first in the grid's slowest index.
  const int k0 = blockIdx.z * kTcKvBk;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  // This thread's first accumulator row (a key) in the block; the
  // second is +8.
  const int row_in = wg * 64 + ((tid >> 5) & 3) * 16 + ((tid & 31) >> 2);
  const int cq = 2 * (tid & 3);
  const int offset = Sk - Sq;
  // The first query row that may see key k0 (row + offset >= k0), down
  // to its tile; below Sq, since k0 < Sk = Sq + offset.
  const int q_begin = causal ? max(0, k0 - offset) / kTcKvBq * kTcKvBq : 0;
  const int n_tiles = (Sq - q_begin + kTcKvBq - 1) / kTcKvBq;
  const float scale2 = scale * kLog2e;

  // Query tile starting at row q0 (Q, dO, lse, delta) into buffer buf.
  auto load_queries = [&](int buf, int q0) {
    load_tile<D, kTcKvBq, kThreads>(q_s + buf * kQTile, q, b, q0, Sq, H, h);
    load_tile<D, kTcKvBq, kThreads>(q_s + (2 + buf) * kQTile, dO, b, q0, Sq,
                                    H, h);
    if (tid < 2 * kTcKvBq) {
      const int r = tid & (kTcKvBq - 1);
      const bool is_delta = tid >= kTcKvBq;
      const bool ok = q0 + r < Sq;
      const float* src = (is_delta ? delta : lse) +
                         ((size_t)b * H + h) * Sq + (ok ? q0 + r : 0);
      cp_async4(stats_s + 4 * ((is_delta ? 2 : 0) * kTcKvBq +
                               buf * kTcKvBq + r),
                src, ok);
    }
  };

  zero_padding<D, kTcKvBk, kThreads>(smem);
  zero_padding<D, kTcKvBk, kThreads>(smem + kKvTile);
  for (int t = 0; t < 4; ++t)
    zero_padding<D, kTcKvBq, kThreads>(smem + 2 * kKvTile + t * kQTile);
  load_tile<D, kTcKvBk, kThreads>(k_s, k, b, k0, Sk, H, h);
  load_tile<D, kTcKvBk, kThreads>(v_s, v, b, k0, Sk, H, h);
  load_queries(0, q_begin);
  cp_async_commit();

  float acc_dk[Dp / 2], acc_dv[Dp / 2];
#pragma unroll
  for (int i = 0; i < Dp / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = q_begin + t * kTcKvBq;
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      load_queries(buf ^ 1, q0 + kTcKvBq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and K, V) landed for every warpgroup
    const uint32_t qt = q_s + buf * kQTile;
    const uint32_t dot = q_s + (2 + buf) * kQTile;

    float s[kTcKvBq / 2], dp[kTcKvBq / 2];
#pragma unroll
    for (int i = 0; i < kTcKvBq / 2; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss(s, desc_kmajor<kTcKvBk>(k_s + wg * 64 * 128, ks),
               desc_kmajor<kTcKvBq>(qt, ks), ks > 0);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss(dp, desc_kmajor<kTcKvBk>(v_s + wg * 64 * 128, ks),
               desc_kmajor<kTcKvBq>(dot, ks), ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P^T = exp(S^T * scale - lse) and dS^T / scale = P^T * (dP^T -
    // delta), a query per column; tiles that cross the causal diagonal or
    // the query end are masked.
    const float* lse_t = stats + buf * kTcKvBq;
    const float* delta_t = stats + (2 + buf) * kTcKvBq;
    const bool edge = q0 + kTcKvBq > Sq ||
                      (causal && q0 + offset < k0 + kTcKvBk - 1);
#pragma unroll
    for (int j = 0; j < kTcKvBq / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + cq + e;
        const float lse2 = lse_t[c] * kLog2e;
        const float dl = delta_t[c];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int idx = 4 * j + 2 * i + e;
          float p = exp2f(fmaf(s[idx], scale2, -lse2));
          if (edge) {
            const int key = k0 + row_in + 8 * i;
            const int row = q0 + c;
            if (row >= Sq || (causal && key > row + offset)) p = 0.f;
          }
          dp[idx] = p * (dp[idx] - dl);
          s[idx] = p;
        }
      }

    uint32_t pa[kTcKvBq / 16][4], da[kTcKvBq / 16][4];
#pragma unroll
    for (int kk = 0; kk < kTcKvBq / 16; ++kk) {
      a_frag(s, kk, pa[kk]);
      a_frag(dp, kk, da[kk]);
    }
    fence_regs(acc_dv);
    fence_regs(acc_dk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcKvBq / 16; ++kk)
      wgmma_rs(acc_dv, pa[kk], desc_mnmajor<kTcKvBq>(dot, kk), 1);
#pragma unroll
    for (int kk = 0; kk < kTcKvBq / 16; ++kk)
      wgmma_rs(acc_dk, da[kk], desc_mnmajor<kTcKvBq>(qt, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc_dv);
    fence_regs(acc_dk);
    __syncthreads();  // tile t's reads are done before its buffers take
                      // tile t + 2
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + row_in + 8 * i;
    if (key >= Sk) continue;
    const size_t base = row_index(b, key, Sk, H, h, D);
#pragma unroll
    for (int j = 0; j < Dp / 8; ++j)
      if (8 * j < D) {
        *reinterpret_cast<__nv_bfloat162*>(dk + base + 8 * j + cq) =
            __floats2bfloat162_rn(acc_dk[4 * j + 2 * i] * scale,
                                  acc_dk[4 * j + 2 * i + 1] * scale);
        *reinterpret_cast<__nv_bfloat162*>(dv + base + 8 * j + cq) =
            __floats2bfloat162_rn(acc_dv[4 * j + 2 * i],
                                  acc_dv[4 * j + 2 * i + 1]);
      }
  }
}

constexpr int kTcDqBq = 128;  // query rows per block: two warpgroups of 64
constexpr int kTcDqBk = 64;   // keys per tile

template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_dq_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ o,
    const float* __restrict__ lse, const __nv_bfloat16* __restrict__ dO,
    __nv_bfloat16* __restrict__ dq, float* __restrict__ delta, int Sq,
    int Sk, int H, float scale, int causal) {
  using namespace flash_tc;
  constexpr int Dp = padded(D);
  constexpr int kQTile = kTcDqBq * Dp * 2;  // bytes of the Q or dO tile
  constexpr int kKTile = kTcDqBk * Dp * 2;  // bytes of a K or V tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // Q, dO, K[0], K[1], V[0], V[1], then f32 lse (log2 units) and delta
  // of the block's rows.
  const uint32_t q_s = smem_u32(smem);
  const uint32_t do_s = q_s + kQTile;
  const uint32_t kv_s = q_s + 2 * kQTile;  // K[i] at +i, V[i] at +2 + i
  float* stats = reinterpret_cast<float*>(smem + 2 * kQTile + 4 * kKTile);

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  // High query tiles see the most keys under the causal mask: they come
  // first in the grid's slowest index.
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTcDqBq;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  // This thread's first accumulator row in the block; the second is +8.
  const int row_in = wg * 64 + ((tid >> 5) & 3) * 16 + ((tid & 31) >> 2);
  const int cq = 2 * (tid & 3);
  const int offset = Sk - Sq;
  const int q_last = min(Sq, q0 + kTcDqBq) - 1;
  const int kv_end = causal ? min(Sk, q_last + offset + 1) : Sk;
  const int n_tiles = (kv_end + kTcDqBk - 1) / kTcDqBk;
  const float scale2 = scale * kLog2e;

  zero_padding<D, kTcDqBq, kThreads>(smem);
  zero_padding<D, kTcDqBq, kThreads>(smem + kQTile);
  for (int t = 0; t < 4; ++t)
    zero_padding<D, kTcDqBk, kThreads>(smem + 2 * kQTile + t * kKTile);
  load_tile<D, kTcDqBq, kThreads>(q_s, q, b, q0, Sq, H, h);
  load_tile<D, kTcDqBq, kThreads>(do_s, dO, b, q0, Sq, H, h);
  load_tile<D, kTcDqBk, kThreads>(kv_s, k, b, 0, Sk, H, h);
  load_tile<D, kTcDqBk, kThreads>(kv_s + 2 * kKTile, v, b, 0, Sk, H, h);
  cp_async_commit();

  // delta = rowsum(dO * O) in f32 while the first tiles load: two
  // threads per row, 16-byte loads; written for K5b and kept, with lse,
  // for the loop.
  {
    const int r = tid >> 1;
    const int row = q0 + r;
    float dot = 0.f;
    if (row < Sq) {
      const size_t base = row_index(b, row, Sq, H, h, D);
      for (int u = tid & 1; u < D / 8; u += 2) {
        const uint4 a = *reinterpret_cast<const uint4*>(o + base + 8 * u);
        const uint4 g = *reinterpret_cast<const uint4*>(dO + base + 8 * u);
        const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* g2 = reinterpret_cast<const __nv_bfloat162*>(&g);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 af = __bfloat1622float2(a2[e]);
          const float2 gf = __bfloat1622float2(g2[e]);
          dot = fmaf(af.x, gf.x, dot);
          dot = fmaf(af.y, gf.y, dot);
        }
      }
    }
    dot += __shfl_xor_sync(0xffffffffu, dot, 1);
    if ((tid & 1) == 0) {
      const size_t idx = ((size_t)b * H + h) * Sq + row;
      stats[r] = row < Sq ? lse[idx] * kLog2e : 0.f;
      stats[kTcDqBq + r] = dot;
      if (row < Sq) delta[idx] = dot;
    }
  }
  __syncthreads();
  const float lse2[2] = {stats[row_in], stats[row_in + 8]};
  const float dl[2] = {stats[kTcDqBq + row_in], stats[kTcDqBq + row_in + 8]};

  float acc[Dp / 2];
#pragma unroll
  for (int i = 0; i < Dp / 2; ++i) acc[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTcDqBk;
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      load_tile<D, kTcDqBk, kThreads>(kv_s + (buf ^ 1) * kKTile, k, b,
                                      k0 + kTcDqBk, Sk, H, h);
      load_tile<D, kTcDqBk, kThreads>(kv_s + (2 + (buf ^ 1)) * kKTile, v, b,
                                      k0 + kTcDqBk, Sk, H, h);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and Q, dO) landed for every warpgroup
    const uint32_t k_s = kv_s + buf * kKTile;
    const uint32_t v_s = kv_s + (2 + buf) * kKTile;

    float s[kTcDqBk / 2], dp[kTcDqBk / 2];
#pragma unroll
    for (int i = 0; i < kTcDqBk / 2; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss(s, desc_kmajor<kTcDqBq>(q_s + wg * 64 * 128, ks),
               desc_kmajor<kTcDqBk>(k_s, ks), ks > 0);
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss(dp, desc_kmajor<kTcDqBq>(do_s + wg * 64 * 128, ks),
               desc_kmajor<kTcDqBk>(v_s, ks), ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P = exp(S * scale - lse) and dS / scale = P * (dP - delta); tiles
    // that cross the causal diagonal or the key end are masked.
    const bool edge =
        k0 + kTcDqBk > Sk || (causal && k0 + kTcDqBk - 1 > q0 + offset);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + row_in + 8 * i;
#pragma unroll
      for (int j = 0; j < kTcDqBk / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = 4 * j + 2 * i + e;
          float p = exp2f(fmaf(s[idx], scale2, -lse2[i]));
          if (edge) {
            const int key = k0 + 8 * j + cq + e;
            if (key >= Sk || (causal && key > row + offset)) p = 0.f;
          }
          dp[idx] = p * (dp[idx] - dl[i]);
        }
    }

    uint32_t da[kTcDqBk / 16][4];
#pragma unroll
    for (int kk = 0; kk < kTcDqBk / 16; ++kk) a_frag(dp, kk, da[kk]);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTcDqBk / 16; ++kk)
      wgmma_rs(acc, da[kk], desc_mnmajor<kTcDqBk>(k_s, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    __syncthreads();  // tile t's reads are done before its buffers take
                      // tile t + 2
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + row_in + 8 * i;
    if (row >= Sq) continue;
    const size_t base = row_index(b, row, Sq, H, h, D);
#pragma unroll
    for (int j = 0; j < Dp / 8; ++j)
      if (8 * j < D)
        *reinterpret_cast<__nv_bfloat162*>(dq + base + 8 * j + cq) =
            __floats2bfloat162_rn(acc[4 * j + 2 * i] * scale,
                                  acc[4 * j + 2 * i + 1] * scale);
  }
}

struct Args {
  const void *q, *k, *v, *o, *lse, *dO;
  void *dq, *delta, *dk, *dv;  // delta: flash_dq's output, flash_dkv's input
  int B, Sq, Sk, H;
  float scale;
  int causal;
};

template <typename T, int D>
int launch_dq(const Args& a, cudaStream_t st) {
  constexpr int ld = D + 4;
  const size_t smem =
      sizeof(float) * ((size_t)2 * (kDqBq + kDqBk) * ld +
                       (size_t)kDqBq * (kDqBk + 4) + 2 * kDqBq);
  return launch(flash_dq_kernel<T, D>,
                dim3((a.Sq + kDqBq - 1) / kDqBq, a.H, a.B), smem, st,
                static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                static_cast<const T*>(a.v), static_cast<const T*>(a.o),
                static_cast<const float*>(a.lse),
                static_cast<const T*>(a.dO), static_cast<T*>(a.dq),
                static_cast<float*>(a.delta), a.Sq, a.Sk, a.H, a.scale,
                a.causal);
}

template <typename T, int D>
int launch_dkv(const Args& a, cudaStream_t st) {
  constexpr int ld = D + 4;
  const size_t smem =
      sizeof(float) * ((size_t)2 * (kKvBk + kKvBq) * ld +
                       (size_t)2 * kKvBq * (kKvBk + 4) + 2 * kKvBq);
  return launch(flash_dkv_kernel<T, D>,
                dim3((a.Sk + kKvBk - 1) / kKvBk, a.H, a.B), smem, st,
                static_cast<const T*>(a.q), static_cast<const T*>(a.k),
                static_cast<const T*>(a.v), static_cast<const T*>(a.o),
                static_cast<const float*>(a.lse),
                static_cast<const T*>(a.dO), static_cast<T*>(a.dk),
                static_cast<T*>(a.dv), a.Sq, a.Sk, a.H, a.scale, a.causal);
}

template <int D>
int launch_dq_tc(const Args& a, cudaStream_t st) {
  constexpr int Dp = flash_tc::padded(D);
  const size_t smem = (size_t)2 * kTcDqBq * Dp * 2 +
                      (size_t)4 * kTcDqBk * Dp * 2 +
                      2 * kTcDqBq * sizeof(float) + 1024;
  using bf16 = __nv_bfloat16;
  return launch(flash_dq_tc_kernel<D>,
                dim3(a.H, a.B, (a.Sq + kTcDqBq - 1) / kTcDqBq), smem, st,
                static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
                static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.o),
                static_cast<const float*>(a.lse),
                static_cast<const bf16*>(a.dO), static_cast<bf16*>(a.dq),
                static_cast<float*>(a.delta), a.Sq, a.Sk, a.H, a.scale,
                a.causal);
}

template <int D>
int launch_dkv_tc(const Args& a, cudaStream_t st) {
  constexpr int Dp = flash_tc::padded(D);
  const size_t smem = (size_t)2 * kTcKvBk * Dp * 2 +
                      (size_t)4 * kTcKvBq * Dp * 2 +
                      4 * kTcKvBq * sizeof(float) + 1024;
  using bf16 = __nv_bfloat16;
  return launch(flash_dkv_tc_kernel<D>,
                dim3(a.H, a.B, (a.Sk + kTcKvBk - 1) / kTcKvBk), smem, st,
                static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
                static_cast<const bf16*>(a.v),
                static_cast<const float*>(a.lse),
                static_cast<const float*>(a.delta),
                static_cast<const bf16*>(a.dO), static_cast<bf16*>(a.dk),
                static_cast<bf16*>(a.dv), a.Sq, a.Sk, a.H, a.scale, a.causal);
}

// which: 0 = flash_dq, 1 = flash_dkv. bf16 takes the tensor-core
// kernels, f32 the CUDA-core ones.
template <typename T>
int dispatch_d(int which, int D, const Args& a, cudaStream_t st) {
  return with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    if constexpr (std::is_same<T, __nv_bfloat16>::value)
      return which == 0 ? launch_dq_tc<kD>(a, st) : launch_dkv_tc<kD>(a, st);
    else
      return which == 0 ? launch_dq<T, kD>(a, st) : launch_dkv<T, kD>(a, st);
  });
}

int dispatch(int which, const Args& a, int D, int dtype, void* stream) {
  if (a.B < 1 || a.Sq < 1 || a.Sk < 1 || a.H < 1 ||
      (a.causal && a.Sq > a.Sk))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_d<float>(which, D, a, st);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(which, D, a, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v, o, dO and the gradients).
// head_dim D must be a multiple of 16 up to 128. flash_dq also writes
// delta = rowsum(dO * O) [B, H, Sq] f32; flash_dkv reads it on bf16 (the
// f32 kernel recomputes it from O). Each returns cudaGetLastError()
// after its launch.
extern "C" int flash_dq(const void* q, const void* k, const void* v,
                        const void* o, const void* lse, const void* dO,
                        void* dq, void* delta, int B, int Sq, int Sk, int H,
                        int D, float scale, int causal, int dtype,
                        void* stream) {
  Args a{q, k, v, o, lse, dO, dq, delta, nullptr, nullptr, B, Sq, Sk, H,
         scale, causal};
  return dispatch(0, a, D, dtype, stream);
}

extern "C" int flash_dkv(const void* q, const void* k, const void* v,
                         const void* o, const void* lse, const void* dO,
                         const void* delta, void* dk, void* dv, int B,
                         int Sq, int Sk, int H, int D, float scale,
                         int causal, int dtype, void* stream) {
  Args a{q, k, v, o, lse, dO, nullptr, const_cast<void*>(delta), dk, dv, B,
         Sq, Sk, H, scale, causal};
  return dispatch(1, a, D, dtype, stream);
}
