// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernel skypilot_tpu/ops/flash_attention.py::_fwd_kernel
// (driven by _flash_fwd_pallas). q [B, Sq, H, D], k/v [B, Sk, H, D] (GQA
// is repeated out before the call), f32 or bf16. Returns o [B, Sq, H, D]
// in the input type and the log-sum-exp lse [B, H, Sq] in f32, saved for
// the backward kernels (flash_bwd.cu). The causal mask is bottom-right
// aligned as in the reference: query i sees key j when i + Sk - Sq >= j.
// Causal Sq > Sk, where some queries would see no key, is refused.
//
// What bounds it on an H100: at the training shapes (B 4, H 16, S 2048,
// D 128, bf16, causal) the two products are 69 GFLOP per call against
// 34 MB of q/k/v/o — about 70 us at the bf16 tensor-core rate, far above
// the 10 us the bytes need. The input type picks one of two kernels:
//
// bf16 (flash_fwd_tc_kernel) runs both products on the tensor cores
// (flash_tc.cuh): one block of two warpgroups per 128-query tile, each
// warpgroup owning 64 rows. Q is loaded once; 128-key tiles of K and V
// are double-buffered with cp.async, so tile t + 1 is in flight while
// S = Q K^T (wgmma, both operands from shared memory) and O += P V
// (wgmma, P from registers as bf16, V through the transpose bit) run on
// tile t. The online softmax (m, l in f32) and the causal mask stay on
// the accumulator fragments in registers; only tiles that cross the
// diagonal or the sequence end are masked. The query tile is the grid's
// slowest index, reversed, so the causal tiles with the most keys start
// first. P is rounded to bf16 for P V, as flash kernels on tensor cores
// do; the row sums l use the f32 P.
//
// f32 (flash_fwd_kernel) keeps full-f32 products on the CUDA cores, so
// the f32 route holds its 1e-4 bar against the plain version (TF32
// products would not): one block per (64-query tile, head, batch row);
// Q and each K (then V, in the same buffer) tile staged in shared memory
// as f32 (85 KB, two blocks per SM); each thread owns a 4 x 4 tile of
// scores and a 4 x D/16 tile of the output and reads its operands as
// float4s (flash_common.cuh). Both kernels keep f32 scores, softmax
// state and accumulators, stop the key loop at the tile's causal
// frontier, stage rows past the sequence ends as zeros and never write
// them, so S needs no multiple of the tile.

#include "flash_common.cuh"
#include "flash_tc.cuh"

namespace {

using namespace flash;

constexpr int kBq = 64;        // query rows per block
constexpr int kBk = 64;        // keys per tile
constexpr int kRm = kBq / 16;  // score rows per thread
constexpr int kRn = kBk / 16;  // score columns per thread

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(
    const T* __restrict__ q,   // [B, Sq, H, D]
    const T* __restrict__ k,   // [B, Sk, H, D]
    const T* __restrict__ v,   // [B, Sk, H, D]
    T* __restrict__ o,         // [B, Sq, H, D]
    float* __restrict__ lse,   // [B, H, Sq]
    int Sq, int Sk, int H, float scale, int causal) {
  constexpr int ld = D + 4;
  constexpr int ldp = kBk + 4;
  extern __shared__ float4 smem4[];
  float* q_sm = reinterpret_cast<float*>(smem4);  // [kBq][ld]
  float* kv_sm = q_sm + kBq * ld;                 // [kBk][ld]: K, then V
  float* p_sm = kv_sm + kBk * ld;                 // [kBq][ldp]

  const int q0 = blockIdx.x * kBq;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const int offset = Sk - Sq;
  const int q_last = min(Sq, q0 + kBq) - 1;
  const int kv_end = causal ? min(Sk, q_last + offset + 1) : Sk;

  stage<T, D, kBq>(q_sm, q, b, q0, Sq, H, h);

  float m[kRm], l[kRm], acc[kRm][D / 16];
#pragma unroll
  for (int i = 0; i < kRm; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < D / 16; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < kv_end; k0 += kBk) {
    __syncthreads();  // the previous tile's V and P reads are done
    stage<T, D, kBk>(kv_sm, k, b, k0, Sk, H, h);
    __syncthreads();
    float s[kRm][kRn];
    dot_nt<D, kRm, kRn>(q_sm, kv_sm, ty, tx, s);
#pragma unroll
    for (int i = 0; i < kRm; ++i) {
      const int row = q0 + ty + 16 * i;
      bool ok[kRn];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kRn; ++j) {
        ok[j] = allowed(row, k0 + tx + 16 * j, Sq, Sk, offset, causal);
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 1; w < 16; w <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kRn; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        p_sm[(ty + 16 * i) * ldp + tx + 16 * j] = p;
      }
#pragma unroll
      for (int w = 1; w < 16; w <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, w);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < D / 16; ++j) acc[i][j] *= corr;
    }
    __syncthreads();  // K reads done, P visible
    stage<T, D, kBk>(kv_sm, v, b, k0, Sk, H, h);
    __syncthreads();
    acc_nn<D, kRm, kBk>(p_sm, ldp, kv_sm, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < kRm; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
    const float l_safe = fmaxf(l[i], 1e-30f);
    T* orow = o + row_index(b, row, Sq, H, h, D);
#pragma unroll
    for (int j = 0; j < D / 16; ++j)
      orow[tx + 16 * j] = from_f<T>(acc[i][j] / l_safe);
    if (tx == 0) lse[((size_t)b * H + h) * Sq + row] = m[i] + logf(l_safe);
  }
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int Sq, int Sk, int H, float scale,
               int causal, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)(kBq + kBk) * (D + 4) +
                                       (size_t)kBq * (kBk + 4));
  return launch(flash_fwd_kernel<T, D>, dim3((Sq + kBq - 1) / kBq, H, B),
                smem, stream, static_cast<const T*>(q),
                static_cast<const T*>(k), static_cast<const T*>(v),
                static_cast<T*>(o), static_cast<float*>(lse), Sq, Sk, H,
                scale, causal);
}

// ---------------------------------------------------------- bf16 route

constexpr int kTcBq = 128;  // query rows per block: two warpgroups of 64
constexpr int kTcBk = 128;  // keys per tile

template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_tc_kernel(
    const __nv_bfloat16* __restrict__ q,  // [B, Sq, H, D]
    const __nv_bfloat16* __restrict__ k,  // [B, Sk, H, D]
    const __nv_bfloat16* __restrict__ v,  // [B, Sk, H, D]
    __nv_bfloat16* __restrict__ o,        // [B, Sq, H, D]
    float* __restrict__ lse,              // [B, H, Sq]
    int Sq, int Sk, int H, float scale, int causal) {
  using namespace flash_tc;
  constexpr int Dp = padded(D);
  constexpr int kTile = kTcBq * Dp * 2;  // bytes of one Q, K or V tile
  static_assert(kTcBq == kTcBk, "Q, K and V tiles share one size");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  // Q, K[0], K[1], V[0], V[1].
  const uint32_t q_s = smem_u32(smem);

  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kTcBq;
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  // This thread's first accumulator row in the block; the second is +8.
  const int row_in = wg * 64 + ((tid >> 5) & 3) * 16 + ((tid & 31) >> 2);
  const int cq = 2 * (tid & 3);
  const int offset = Sk - Sq;
  const int q_last = min(Sq, q0 + kTcBq) - 1;
  const int kv_end = causal ? min(Sk, q_last + offset + 1) : Sk;
  const int n_tiles = (kv_end + kTcBk - 1) / kTcBk;
  const float scale2 = scale * kLog2e;  // scores in log2 units

  for (int t = 0; t < 5; ++t)
    zero_padding<D, kTcBq, kThreads>(smem + t * kTile);
  load_tile<D, kTcBq, kThreads>(q_s, q, b, q0, Sq, H, h);
  load_tile<D, kTcBk, kThreads>(q_s + kTile, k, b, 0, Sk, H, h);
  load_tile<D, kTcBk, kThreads>(q_s + 3 * kTile, v, b, 0, Sk, H, h);
  cp_async_commit();

  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // this thread's share of the row sums
  float acc[Dp / 2];
#pragma unroll
  for (int i = 0; i < Dp / 2; ++i) acc[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTcBk;
    const uint32_t k_s = q_s + (1 + (t & 1)) * kTile;
    const uint32_t v_s = q_s + (3 + (t & 1)) * kTile;
    if (t + 1 < n_tiles) {
      const int nxt = (t + 1) & 1;
      load_tile<D, kTcBk, kThreads>(q_s + (1 + nxt) * kTile, k, b,
                                    k0 + kTcBk, Sk, H, h);
      load_tile<D, kTcBk, kThreads>(q_s + (3 + nxt) * kTile, v, b,
                                    k0 + kTcBk, Sk, H, h);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile t (and Q) landed for every warpgroup

    float s[kTcBk / 2];
#pragma unroll
    for (int i = 0; i < kTcBk / 2; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks)
      wgmma_ss(s, desc_kmajor<kTcBq>(q_s + wg * 64 * 128, ks),
               desc_kmajor<kTcBk>(k_s, ks), ks > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    // Tiles that cross the causal diagonal or the key end are masked.
    const bool edge =
        k0 + kTcBk > Sk || (causal && k0 + kTcBk - 1 > q0 + offset);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + row_in + 8 * i;
      // The last column of this tile the row may see.
      const int lim = (causal ? min(Sk - 1, row + offset) : Sk - 1) - k0;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kTcBk / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[4 * j + 2 * i + e] * scale2;
          if (edge && 8 * j + cq + e > lim) x = -INFINITY;
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
          const float p = exp2f(s[4 * j + 2 * i + e] - m_use);
          s[4 * j + 2 * i + e] = p;
          sum += p;
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
    __syncthreads();  // tile t's K and V reads are done before its
                      // buffers take tile t + 2
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const int row = q0 + row_in + 8 * i;
    if (row >= Sq) continue;
    const float l_safe = fmaxf(li, 1e-30f);
    const float inv = 1.f / l_safe;
    __nv_bfloat16* orow = o + row_index(b, row, Sq, H, h, D);
#pragma unroll
    for (int j = 0; j < Dp / 8; ++j)
      if (8 * j < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j + cq) =
            __floats2bfloat162_rn(acc[4 * j + 2 * i] * inv,
                                  acc[4 * j + 2 * i + 1] * inv);
    if ((tid & 3) == 0)
      lse[((size_t)b * H + h) * Sq + row] = m[i] * kLn2 + logf(l_safe);
  }
}

template <int D>
int launch_fwd_tc(const void* q, const void* k, const void* v, void* o,
                  void* lse, int B, int Sq, int Sk, int H, float scale,
                  int causal, cudaStream_t stream) {
  const size_t smem = 5 * (size_t)kTcBq * flash_tc::padded(D) * 2 + 1024;
  return launch(flash_fwd_tc_kernel<D>,
                dim3(H, B, (Sq + kTcBq - 1) / kTcBq), smem, stream,
                static_cast<const __nv_bfloat16*>(q),
                static_cast<const __nv_bfloat16*>(k),
                static_cast<const __nv_bfloat16*>(v),
                static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), Sq,
                Sk, H, scale, causal);
}

int dispatch_d(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int Sq, int Sk, int H, int D, float scale,
               int causal, int dtype, cudaStream_t st) {
  return with_head_dim(D, [&](auto d) {
    constexpr int kD = decltype(d)::value;
    return dtype == 1 ? launch_fwd_tc<kD>(q, k, v, o, lse, B, Sq, Sk, H,
                                          scale, causal, st)
                      : launch_fwd<float, kD>(q, k, v, o, lse, B, Sq, Sk, H,
                                              scale, causal, st);
  });
}

}  // namespace

// dtype: 0 = float32 (CUDA-core kernel), 1 = bfloat16 (tensor-core
// kernel) for q, k, v, o. head_dim D must be a multiple of 16 up to 128.
// Returns cudaGetLastError() after the launch.
extern "C" int flash_fwd(const void* q, const void* k, const void* v,
                         void* o, void* lse, int B, int Sq, int Sk, int H,
                         int D, float scale, int causal, int dtype,
                         void* stream) {
  if (B < 1 || Sq < 1 || Sk < 1 || H < 1 || (causal && Sq > Sk) ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_d(q, k, v, o, lse, B, Sq, Sk, H, D, scale, causal, dtype,
                    static_cast<cudaStream_t>(stream));
}
