"""Flash attention (training and the monolithic prefill), chunked
prefill and spec-decode verify.

Port of ``skypilot_tpu/ops/flash_attention.py``. The TPU kernels become
hand-written CUDA kernels:

- the flash forward ``_fwd_kernel`` (K4) -> ``csrc/flash_fwd.cu``;
- the flash backward ``_dq_kernel`` (K5a) and ``_dkv_kernel`` (K5b) ->
  ``csrc/flash_bwd.cu`` (``flash_dq``, ``flash_dkv``);
- the chunked-prefill ``_chunk_fwd_kernel`` (K2) ->
  ``csrc/chunk_prefill.cu``;
- the spec-decode verify ``_verify_fwd_kernel`` (K3) ->
  ``csrc/verify_attention.cu``.

``flash_attention`` is differentiable through ``_Flash``, the
counterpart of the reference's ``custom_vjp``: it saves q, k, v, o and
the log-sum-exp, and its backward recomputes the probabilities from
them. K5a runs first and also writes delta = rowsum(dO * O), which K5b
reads. The flash kernels and the chunk kernel take one of two routes
by the dtype of q, never by failure: bf16 runs K4, K5a, K5b and K2 on
the tensor cores (``wgmma``, ``csrc/flash_tc.cuh``; P and dS rounded to
bf16 for the second products; K2's bf16 route takes bf16 and int8
caches, head_dim in ``FLASH_HEAD_DIMS``), f32 keeps full-f32 products
on the CUDA cores. K3 takes its route the same way: bf16 runs the
split-KV tensor-core kernel (``split_kv``), f32 the CUDA-core one; both
take any number of query rows. A f32 launch also counts under
``<kernel>.f32`` in ``_build.LAUNCHES``.

``_plain_fwd``/``_plain_bwd`` (mirroring the reference's
``_xla_fwd``/``_xla_bwd``) are the kernels' plain versions;
``chunk_attention_reference`` is K2's, ``verify_attention_reference``
K3's, and ``reference_attention`` is plain causal attention. Every
wrapper runs its plain version for a CPU tensor and launches its kernel
for a CUDA tensor, or raises.

Layout at every public function: [batch, seq, heads, head_dim]; the
log-sum-exp is [batch, heads, seq] f32 (the TPU kernel's 128-lane
broadcast is a TPU layout and is not kept).
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from skypilot_tpu_torch.ops import _build, split_kv

_NEG_INF = -1e30
KERNEL = 'chunk_prefill'
FWD_KERNEL = 'flash_fwd'
DQ_KERNEL = 'flash_dq'
DKV_KERNEL = 'flash_dkv'
VERIFY_KERNEL = 'verify_attention'
# head_dim values the flash kernels (and the bf16 chunk kernel) are built
# for: multiples of 16 up to 128 (a wgmma k-step is 16 columns; the
# CUDA-core flash kernels give each thread head_dim / 16 output columns).
FLASH_HEAD_DIMS = tuple(range(16, 129, 16))


def _repeat_kv(q, k, v):
    h_q, h_kv = q.shape[2], k.shape[2]
    if h_q != h_kv:
        if h_q % h_kv:
            raise ValueError(f'{h_q} query heads do not group over '
                             f'{h_kv} kv heads')
        rep = h_q // h_kv
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    return q, k, v


def _scores(q, k, causal, scale):
    """f32 scores [B, H, Sq, Sk] of q [B, Sq, H, D] and k [B, Sk, H, D],
    -1e30 where the bottom-right-aligned causal mask forbids (query i
    sees key j when i + Sk - Sq >= j)."""
    s = torch.einsum('bqhd,bkhd->bhqk', q.float(), k.float()) * scale
    if causal:
        sq, sk = q.shape[1], k.shape[1]
        q_pos = torch.arange(sq, device=q.device)[:, None]
        k_pos = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(q_pos + (sk - sq) >= k_pos, s, _NEG_INF)
    return s


def reference_attention(q, k, v, *, causal=True, scale=None):
    """O(S^2)-memory attention; q [B, Sq, H, D], k/v [B, Sk, H_kv, D]
    (GQA: H_kv divides H). The causal mask is bottom-right aligned:
    query i sees key j when i + Sk - Sq >= j."""
    q, k, v = _repeat_kv(q, k, v)
    if scale is None:
        scale = q.shape[-1]**-0.5
    p = torch.softmax(_scores(q, k, causal, scale), dim=-1)
    o = torch.einsum('bhqk,bkhd->bqhd', p, v.float())
    return o.to(q.dtype)


# ---------------------------------------------------- flash (K4, K5a/b)


def _plain_fwd(q, k, v, *, causal, scale):
    """Plain version of K4 (the reference's ``_xla_fwd``): q [B, Sq, H,
    D], k/v [B, Sk, H, D] -> (o [B, Sq, H, D] in q's dtype, lse [B, H,
    Sq] f32). A causal row that sees no key (Sq > Sk) gets every key
    at probability 1, as in ``_xla_fwd`` (its log-sum-exp -1e30 +
    log(Sk) rounds back to -1e30 in f32); ``flash_attention`` refuses
    that case."""
    s = _scores(q, k, causal, scale)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    o = torch.einsum('bhqk,bkhd->bqhd', p, v.float())
    return o.to(q.dtype), lse


def _plain_bwd(q, k, v, o, lse, do, *, causal, scale):
    """Plain version of K5a and K5b (the reference's ``_xla_bwd``):
    (dq, dk, dv) in the dtypes of q, k and v, all f32 inside."""
    qf, kf, vf = q.float(), k.float(), v.float()
    of, dof = o.float(), do.float()
    p = torch.exp(_scores(q, k, causal, scale) - lse[..., None])
    dv = torch.einsum('bhqk,bqhd->bkhd', p, dof)
    dp = torch.einsum('bqhd,bkhd->bhqk', dof, vf)
    delta = torch.sum(dof * of, dim=-1).transpose(1, 2)      # [B, H, Sq]
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum('bhqk,bkhd->bqhd', ds, kf)
    dk = torch.einsum('bhqk,bqhd->bkhd', ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_flash_args(q, k, v, *rest):
    """What the flash kernels take: q [B, Sq, H, D], k/v [B, Sk, H, D],
    one dtype (f32 or bf16), head_dim in FLASH_HEAD_DIMS, contiguous,
    one device. ``rest`` is (o, lse, do) for the backward."""
    b, sq, h, d = q.shape
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'q must be float32 or bfloat16, got {q.dtype}')
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f'q/k/v dtypes differ: {q.dtype}/{k.dtype}/'
                        f'{v.dtype}')
    if d not in FLASH_HEAD_DIMS or k.dim() != 4 or \
            k.shape[0] != b or k.shape[2:] != (h, d) or v.shape != k.shape:
        raise ValueError(f'unsupported shapes q {tuple(q.shape)} k '
                         f'{tuple(k.shape)} v {tuple(v.shape)} (head_dim '
                         f'in {FLASH_HEAD_DIMS}, k/v with q\'s heads)')
    tensors = [q, k, v]
    if rest:
        o, lse, do = rest
        if o.shape != q.shape or do.shape != q.shape or \
                o.dtype != q.dtype or do.dtype != q.dtype or \
                lse.shape != (b, h, sq) or lse.dtype != torch.float32:
            raise ValueError('o/do must match q; lse must be f32 [B, H, Sq]')
        tensors += [o, lse, do]
    for t in tensors:
        if t.device != q.device:
            raise ValueError('all inputs must be on one CUDA device')
        if not t.is_contiguous():
            raise ValueError('all inputs must be contiguous')


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _count(name, dtype):
    _build.LAUNCHES[name] += 1
    if dtype == torch.float32:
        _build.LAUNCHES[name + '.f32'] += 1


def _flash_fwd_cuda(q, k, v, causal, scale):
    _check_flash_args(q, k, v)
    b, sq, h, d = q.shape
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _build.function(FWD_KERNEL, 'flash_fwd',
                         [P] * 5 + [I] * 5 + [ctypes.c_float, I, I, P])
    o = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                lse.data_ptr(), b, sq, k.shape[1], h, d, scale,
                int(causal), 1 if q.dtype == torch.bfloat16 else 0,
                _stream(q))
    _build.check(status, FWD_KERNEL)
    _count(FWD_KERNEL, q.dtype)
    return o, lse


def _bwd_call(name, q, k, v, o, lse, do, rest, causal, scale):
    """Launch ``name`` (flash_dq or flash_dkv) of csrc/flash_bwd.cu;
    ``rest`` are the tensors after dO in its C signature (flash_dq: dq,
    delta; flash_dkv: delta, dk, dv)."""
    _check_flash_args(q, k, v, o, lse, do)
    b, sq, h, d = q.shape
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _build.function('flash_bwd', name, [P] * (6 + len(rest)) +
                         [I] * 5 + [ctypes.c_float, I, I, P])
    status = fn(*(x.data_ptr() for x in (q, k, v, o, lse, do, *rest)), b, sq,
                k.shape[1], h, d, scale, int(causal),
                1 if q.dtype == torch.bfloat16 else 0, _stream(q))
    _build.check(status, name)
    _count(name, q.dtype)


def _flash_dq_cuda(q, k, v, o, lse, do, causal, scale):
    """K5a: (dq, delta [B, H, Sq] f32 = rowsum(dO * O))."""
    dq = torch.empty_like(q)
    delta = torch.empty(lse.shape, dtype=torch.float32, device=q.device)
    _bwd_call(DQ_KERNEL, q, k, v, o, lse, do, (dq, delta), causal, scale)
    return dq, delta


def _flash_dkv_cuda(q, k, v, o, lse, do, delta, causal, scale):
    """K5b: (dk, dv). The bf16 kernel reads K5a's ``delta``; the f32 one
    recomputes it from o."""
    if delta.shape != lse.shape or delta.dtype != torch.float32 or \
            delta.device != q.device or not delta.is_contiguous():
        raise ValueError('delta must be contiguous f32 [B, H, Sq] on q\'s '
                         'device')
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _bwd_call(DKV_KERNEL, q, k, v, o, lse, do, (delta, dk, dv), causal,
              scale)
    return dk, dv


def _flash_bwd_cuda(q, k, v, o, lse, do, causal, scale):
    dq, delta = _flash_dq_cuda(q, k, v, o, lse, do, causal, scale)
    return (dq,) + _flash_dkv_cuda(q, k, v, o, lse, do, delta, causal,
                                   scale)


def flash_forward(q, k, v, *, causal, scale):
    """(o, lse) of K4 for CUDA tensors, of ``_plain_fwd`` for CPU ones."""
    if q.is_cuda:
        return _flash_fwd_cuda(q, k, v, causal, scale)
    return _plain_fwd(q, k, v, causal=causal, scale=scale)


def flash_backward(q, k, v, o, lse, do, *, causal, scale):
    """(dq, dk, dv) of K5a + K5b for CUDA tensors, of ``_plain_bwd`` for
    CPU ones."""
    if q.is_cuda:
        return _flash_bwd_cuda(q, k, v, o, lse, do, causal, scale)
    return _plain_bwd(q, k, v, o, lse, do, causal=causal, scale=scale)


class _Flash(torch.autograd.Function):
    """Flash attention with its own backward (the reference's
    ``custom_vjp`` ``_flash``): saves q, k, v, o and lse; the backward
    recomputes the probabilities from lse and never holds an S x S
    matrix on the card."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_forward(q, k, v, causal=causal, scale=scale)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal, ctx.scale = causal, scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_backward(q, k, v, o, lse, do.contiguous(),
                                    causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Differentiable flash attention, [batch, seq, heads, head_dim]
    layout, GQA-aware: K/V heads are repeated to the query heads before
    the kernels, and autograd sums the repeated heads' gradients. CUDA
    tensors run K4 forward and K5a/K5b backward (head_dim a multiple of
    16 up to 128, f32 or bf16, contiguous; anything else raises); CPU
    tensors run the plain versions. Causal attention with more queries
    than keys is refused: its first rows would see no key
    (``_plain_fwd`` and the reference's ``_xla_fwd`` sum V there, the
    TPU kernel writes zeros), and neither training nor prefill asks for
    it."""
    q, k, v = _repeat_kv(q, k, v)
    if causal and q.shape[1] > k.shape[1]:
        raise ValueError(f'causal attention needs Sq <= Sk, got Sq '
                         f'{q.shape[1]} > Sk {k.shape[1]}')
    if scale is None:
        scale = q.shape[-1]**-0.5
    return _Flash.apply(q, k, v, causal, float(scale))


def _masked_attention_reference(q, k, v, allow, k_scale=None,
                                v_scale=None):
    """Masked attention for the chunk-shaped paths, GQA-native (K/V
    stay at n_kv heads): q [B, C, H, D], k/v [B, S, n_kv, D],
    ``allow`` [B, C, S] bool. int8 per-vector scales apply on the
    scores for K and fold into the probabilities for V. Cache columns
    (and scales) no query may attend are zeroed before the products,
    so NaN garbage there never reaches the output (for finite inputs
    this changes no bit: their probabilities are exactly zero)."""
    b, c, h, d = q.shape
    n_kv = k.shape[2]
    rep = h // n_kv
    col_live = allow.any(dim=1)[:, :, None]                  # [B, S, 1]
    k = torch.where(col_live[..., None], k.to(q.dtype), 0)
    v = torch.where(col_live[..., None], v.to(q.dtype), 0)
    if k_scale is not None:
        k_scale = torch.where(col_live, k_scale, 0)
        v_scale = torch.where(col_live, v_scale, 0)
    qf = q.reshape(b, c, n_kv, rep, d)
    scores = torch.einsum('gcnrd,gsnd->gcnrs', qf.float(),
                          k.float()) * d**-0.5
    if k_scale is not None:
        scores = scores * k_scale.float().permute(
            0, 2, 1)[:, None, :, None, :]
    scores = torch.where(allow[:, :, None, None, :], scores, _NEG_INF)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    probs = e / e.sum(dim=-1, keepdim=True)
    if v_scale is not None:
        probs = probs * v_scale.float().permute(
            0, 2, 1)[:, None, :, None, :]
    out = torch.einsum('gcnrs,gsnd->gcnrd', probs.to(q.dtype).float(),
                       v.float())
    return out.reshape(b, c, h, d).to(q.dtype)


def chunk_attention_reference(q, k, v, q_offset, k_scale=None,
                              v_scale=None):
    """Plain version of the chunk kernel, and the path for int8
    caches: query i of row g attends columns <= q_offset[g] + i."""
    c, s = q.shape[1], k.shape[1]
    q_pos = (q_offset.to(torch.int64)[:, None] +
             torch.arange(c, device=q.device)[None, :])
    allow = (torch.arange(s, device=q.device)[None, None, :] <=
             q_pos[:, :, None])                               # [G, C, S]
    return _masked_attention_reference(q, k, v, allow, k_scale, v_scale)


def _check_cache_args(q, k, v, k_scale, v_scale, *others):
    """Checks the chunk and verify kernels share: q f32 or bf16 [rows,
    C, H, D]; k/v [rows, S, n_kv, D] of q's dtype, or int8 with bf16
    scales [rows, S, n_kv]; n_kv divides H; head_dim up to 128; q,
    k, v, the scales and ``others`` contiguous on q's device."""
    g, _, h, d = q.shape
    s, n_kv = k.shape[1], k.shape[2]
    quant = k_scale is not None
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'q must be float32 or bfloat16, got {q.dtype}')
    if (v_scale is not None) != quant:
        raise ValueError('k_scale and v_scale go together')
    want_kv = torch.int8 if quant else q.dtype
    if k.dtype != want_kv or v.dtype != want_kv:
        raise TypeError(f'k/v must be {want_kv}, got {k.dtype}/{v.dtype}')
    if k.shape != (g, s, n_kv, d) or v.shape != k.shape or h % n_kv or \
            d > 128:
        raise ValueError(f'unsupported shapes q {tuple(q.shape)} k '
                         f'{tuple(k.shape)} (head_dim <= 128)')
    tensors = [q, k, v, *others]
    if quant:
        if k_scale.shape != (g, s, n_kv) or v_scale.shape != k_scale.shape \
                or k_scale.dtype != torch.bfloat16 or \
                v_scale.dtype != torch.bfloat16:
            raise ValueError('scales must be bfloat16 [rows, S, n_kv]')
        tensors += [k_scale, v_scale]
    for t in tensors:
        if t.device != q.device:
            raise ValueError('all inputs must be on one CUDA device')
        if not t.is_contiguous():
            raise ValueError('all inputs must be contiguous')


def _chunk_prefill_cuda(q, k, v, q_offset, k_scale, v_scale):
    g, c, h, d = q.shape
    s, n_kv = k.shape[1], k.shape[2]
    quant = k_scale is not None
    _check_cache_args(q, k, v, k_scale, v_scale, q_offset)
    if q_offset.shape != (g,) or q_offset.dtype != torch.int32:
        raise ValueError(f'q_offset must be int32 [{g}], got '
                         f'{q_offset.dtype} {tuple(q_offset.shape)}')
    if q.dtype == torch.bfloat16 and d not in FLASH_HEAD_DIMS:
        raise ValueError(f'the bf16 chunk kernel takes head_dim in '
                         f'{FLASH_HEAD_DIMS} (16-column wgmma steps), got {d}')
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _build.function(KERNEL, 'chunk_prefill',
                         [P] * 7 + [I] * 6 + [ctypes.c_float, I, I, P])
    out = torch.empty_like(q)
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                k_scale.data_ptr() if quant else None,
                v_scale.data_ptr() if quant else None,
                q_offset.data_ptr(), out.data_ptr(), g, c, s, h, n_kv, d,
                d**-0.5, 1 if q.dtype == torch.bfloat16 else 0,
                1 if quant else 0, _stream(q))
    _build.check(status, KERNEL)
    _count(KERNEL, q.dtype)
    if quant:
        _build.LAUNCHES[KERNEL + '.int8'] += 1
    return out


def chunk_prefill_attention(q, k, v, q_offset, k_scale=None, v_scale=None
                            ) -> torch.Tensor:
    """Query-offset causal attention for one prefill chunk.

    q [G, C, H, D] — row g's queries sit at global positions
    q_offset[g] + i; k/v [G, S, H_kv, D] — each row's prompt-region KV
    with the chunk already written at [offset, offset + C) (bf16/f32,
    or int8 with k_scale/v_scale [G, S, H_kv]); q_offset [G] int32.
    Returns [G, C, H, D]. CUDA tensors run the hand-written kernel,
    int8 caches included: a bf16 q takes the tensor-core kernel
    (head_dim in ``FLASH_HEAD_DIMS``, else ValueError), a f32 q the
    CUDA-core one (head_dim up to 128). CPU tensors run
    ``chunk_attention_reference``."""
    if q.is_cuda:
        return _chunk_prefill_cuda(q, k, v, q_offset, k_scale, v_scale)
    return chunk_attention_reference(q, k, v, q_offset, k_scale, v_scale)


# ------------------------------------------------ spec-decode verify (K3)


def verify_attention_reference(q, k, v, valid, seg_start, k_scale=None,
                               v_scale=None):
    """Plain version of the verify kernel: query i of the V-token
    segment attends every dmask-true column plus the segment columns
    seg_start .. seg_start + i (self-inclusive). int8 caches take
    their per-vector scales as ``chunk_attention_reference`` does."""
    vq, s = q.shape[1], k.shape[1]
    col = torch.arange(s, device=q.device)[None, None, :]
    qi = torch.arange(vq, device=q.device)[None, :, None]
    seg = (col >= seg_start) & (col <= seg_start + qi)
    allow = valid[:, None, :] | seg                          # [B, V, S]
    return _masked_attention_reference(q, k, v, allow, k_scale, v_scale)


def _verify_attention_cuda(q, k, v, valid, seg, k_scale, v_scale, n_cols):
    b, vq, h, d = q.shape
    s, n_kv = k.shape[1], k.shape[2]
    quant = k_scale is not None
    bf16 = q.dtype == torch.bfloat16
    _check_cache_args(q, k, v, k_scale, v_scale, valid)
    if d % 16 or valid.shape != (b, s) or valid.dtype != torch.bool:
        raise ValueError(f'unsupported shapes q {tuple(q.shape)} valid '
                         f'{tuple(valid.shape)} (head_dim a multiple of 16, '
                         'bool valid [B, S])')
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _build.function(VERIFY_KERNEL, 'verify_attention',
                         [P] * 10 + [I] * 10 + [ctypes.c_float, I, I, P])
    out = torch.empty_like(q)
    stream = _stream(q)
    # Columns past the segment hold nothing any query sees.
    end = min(n_cols, seg + vq)
    rows = h // n_kv * vq
    rb = split_kv.rows_per_block(rows)
    n_split, ml, acc, counters = 1, None, None, None
    if bf16:
        slots = b * n_kv * -(-rows // rb)
        n_split = split_kv.split_count(slots, -(-end // split_kv.TILE),
                                       split_kv.sm_count(q.device))
        ml, acc, counters = split_kv.workspace(q.device, stream, slots,
                                               n_split, rb, d)
    ptr = (lambda t: None if t is None else t.data_ptr())
    status = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(k_scale),
                ptr(v_scale), valid.data_ptr(), out.data_ptr(), ptr(ml),
                ptr(acc), ptr(counters), b, vq, s, h, n_kv, d, seg, end,
                n_split, rb, d**-0.5, int(bf16), int(quant), stream)
    _build.check(status, VERIFY_KERNEL)
    _count(VERIFY_KERNEL, q.dtype)
    if quant:
        _build.LAUNCHES[VERIFY_KERNEL + '.int8'] += 1
    return out


def verify_attention(q, k, v, valid, seg_start, k_scale=None, v_scale=None,
                     *, n_cols: Optional[int] = None) -> torch.Tensor:
    """dmask-valid + segment-causal attention for one verify pass.

    q [B, V, H, D] — the segment's queries (current token + drafted
    candidates); k/v [B, S, H_kv, D] — each row's cache with the
    segment's K/V already written at columns [seg_start, seg_start + V)
    (bf16/f32, or int8 with k_scale/v_scale [B, S, H_kv]); valid [B, S]
    bool — the cache dmask, False at and past seg_start; seg_start — a
    host integer, the shared write frontier. Only the first ``n_cols``
    columns (default S) are read: they must hold the whole segment.
    Returns [B, V, H, D]. CUDA tensors run the hand-written kernel
    (int8 caches included, any H / H_kv x V query rows): a bf16 q the
    split-KV tensor-core one (head_dim in ``FLASH_HEAD_DIMS``, else
    ValueError), a f32 q the CUDA-core one (head_dim a multiple of 16 up
    to 128). CPU tensors run ``verify_attention_reference`` on the
    first n_cols columns."""
    s = k.shape[1]
    n_cols = s if n_cols is None else min(int(n_cols), s)
    seg = int(seg_start)
    if seg < 0 or seg + q.shape[1] > n_cols:
        raise ValueError(f'the segment [{seg}, {seg + q.shape[1]}) does not '
                         f'lie in the {n_cols} columns read')
    if q.is_cuda:
        return _verify_attention_cuda(q, k, v, valid, seg, k_scale, v_scale,
                                      n_cols)
    if k_scale is not None:
        k_scale, v_scale = k_scale[:, :n_cols], v_scale[:, :n_cols]
    return verify_attention_reference(q, k[:, :n_cols], v[:, :n_cols],
                                      valid[:, :n_cols], seg, k_scale,
                                      v_scale)
