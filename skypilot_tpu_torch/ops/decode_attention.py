"""Paged GQA decode attention: one query token per row against a
page-tiled KV cache, plus the token's own K/V.

Port of ``skypilot_tpu/ops/decode_attention.py``. The TPU kernel
(``_paged_kernel`` driven by ``_paged_softmax_pages``) becomes the
hand-written CUDA kernel ``csrc/paged_decode.cu``; ``paged_decode_reference``
is its plain PyTorch version. ``paged_gqa_decode_attention`` launches
the kernel for CUDA tensors and runs the plain version for CPU tensors
— no other switch, no fallback. The dtype of q picks the kernel's
route: bf16 runs the split-KV tensor-core kernel (``split_kv``, head_dim
in ``FLASH_HEAD_DIMS``), f32 the CUDA-core one, counted under
``paged_decode.f32`` as well.

Semantics (shared by both versions): q [B, n_heads, hd]; kc/vc
[B, S, n_kv, hd] (bf16/f32, or int8 with per-vector bf16 scales
k_scale/v_scale [B, S, n_kv]); valid [B, S] bool is the authority on
which slots are readable; row_bound [B] int32 is a per-row upper bound
on live slots — pages at or past ceil(row_bound / page) are never
read, nor are slots at or past num_pages * page. int8 K scales apply to
the scores, int8 V scales fold into the probabilities. The self term
(k_self/v_self [B, n_kv, hd]) is merged with one more online-softmax
step; an empty row attends to itself alone.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from skypilot_tpu_torch.ops import _build, split_kv
from skypilot_tpu_torch.ops.flash_attention import FLASH_HEAD_DIMS
from skypilot_tpu_torch.utils import env_registry

DEFAULT_PAGE = 128
_NEG_INF = -1e30
KERNEL = 'paged_decode'


def default_page() -> int:
    """Page size (cache slots per block); SKYTPU_DECODE_PAGE overrides."""
    return int(env_registry.get(env_registry.SKYTPU_DECODE_PAGE,
                                str(DEFAULT_PAGE)))


def num_pages_for(live: int, page: int, total_pages: int,
                  base_pages: int = 0) -> int:
    """Pages to dispatch for a live region of ``live`` slots:
    page-granular, with the pages beyond ``base_pages`` (the
    always-live prompt region) rounded up to a power of two, clamped
    to [1, total_pages]. Same policy as the reference's."""
    need = max(1, -(-live // page))
    if base_pages and need > base_pages:
        extra = need - base_pages
        p2 = 1
        while p2 < extra:
            p2 *= 2
        need = base_pages + p2
    return max(1, min(need, total_pages))


def paged_decode_reference(q, kc, vc, valid, row_bound, k_self=None,
                           v_self=None, k_scale=None, v_scale=None, *,
                           page: int, num_pages: int) -> torch.Tensor:
    """Plain PyTorch version of the paged decode kernel (same math:
    f32 scores and probabilities, masked probabilities exactly zero,
    dead slots never contributing even when they hold NaN)."""
    b, s, n_kv, hd = kc.shape
    rep = q.shape[1] // n_kv
    n = min(num_pages * page, s)
    pos = torch.arange(n, device=kc.device)
    row_end = torch.clamp(
        (row_bound.to(torch.int64) + page - 1) // page * page, max=n)
    live = valid[:, :n] & (pos[None, :] < row_end[:, None])   # [B, n]
    lv = live[:, :, None, None]
    k = torch.where(lv, kc[:, :n].float(), 0.0)
    v = torch.where(lv, vc[:, :n].float(), 0.0)
    q4 = q.float().reshape(b, n_kv, rep, hd)
    scores = torch.einsum('bkrh,bskh->bkrs', q4, k) * hd**-0.5
    if k_scale is not None:
        ks = torch.where(live[:, :, None], k_scale[:, :n].float(), 0.0)
        scores = scores * ks.permute(0, 2, 1)[:, :, None, :]
    lm = live[:, None, None, :]
    scores = torch.where(lm, scores, _NEG_INF)
    m = scores.amax(dim=-1)                                   # [B, kv, rep]
    if k_self is not None:
        s_self = torch.einsum('bkrh,bkh->bkr', q4,
                              k_self.float()) * hd**-0.5
        m = torch.maximum(m, s_self)
    p = torch.where(lm, torch.exp(scores - m[..., None]), 0.0)
    denom = p.sum(dim=-1)
    if v_scale is not None:
        vs = torch.where(live[:, :, None], v_scale[:, :n].float(), 0.0)
        p = p * vs.permute(0, 2, 1)[:, :, None, :]
    out = torch.einsum('bkrs,bskh->bkrh', p, v)
    if k_self is not None:
        c2 = torch.exp(s_self - m)
        denom = denom + c2
        out = out + c2[..., None] * v_self.float()[:, :, None]
    out = out / torch.clamp(denom, min=1e-30)[..., None]
    return out.reshape(b, n_kv * rep * hd).to(q.dtype)


def _check_cuda_args(q, kc, vc, valid, row_bound, k_self, v_self, k_scale,
                     v_scale, page):
    b, s, n_kv, hd = kc.shape
    dev = q.device
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'q must be float32 or bfloat16, got {q.dtype}')
    quant = k_scale is not None
    if (v_scale is not None) != quant:
        raise ValueError('k_scale and v_scale go together')
    want_kv = torch.int8 if quant else q.dtype
    if kc.dtype != want_kv or vc.dtype != want_kv:
        raise TypeError(f'cache must be {want_kv}, got {kc.dtype}/'
                        f'{vc.dtype}')
    if q.dim() != 3 or q.shape[0] != b or q.shape[2] != hd or \
            q.shape[1] % n_kv:
        raise ValueError(f'q {tuple(q.shape)} does not fit cache '
                         f'{tuple(kc.shape)}')
    rep = q.shape[1] // n_kv
    if not 1 <= rep <= 16 or hd > 128 or (hd * kc.element_size()) % 16:
        raise ValueError(f'unsupported shape: rep={rep}, head_dim={hd} '
                         '(kernel takes rep <= 16, head_dim <= 128 and '
                         'rows of a multiple of 16 bytes)')
    if q.dtype == torch.bfloat16 and hd not in FLASH_HEAD_DIMS:
        raise ValueError(f'the bf16 decode kernel takes head_dim in '
                         f'{FLASH_HEAD_DIMS} (16-column wgmma steps), got '
                         f'{hd}')
    if s % page:
        raise ValueError(f'cache length {s} is not a multiple of the '
                         f'page size {page}')
    if vc.shape != kc.shape or valid.shape != (b, s) or \
            valid.dtype != torch.bool or row_bound.shape != (b,) or \
            row_bound.dtype != torch.int32:
        raise ValueError('vc/valid/row_bound shapes or dtypes do not fit '
                         'the cache')
    tensors = [q, kc, vc, valid, row_bound]
    if (k_self is None) != (v_self is None):
        raise ValueError('k_self and v_self go together')
    if k_self is not None:
        if k_self.shape != (b, n_kv, hd) or v_self.shape != (b, n_kv, hd) \
                or k_self.dtype != q.dtype or v_self.dtype != q.dtype:
            raise ValueError('k_self/v_self must be [B, n_kv, hd] of q.dtype')
        tensors += [k_self, v_self]
    if quant:
        if k_scale.shape != (b, s, n_kv) or v_scale.shape != (b, s, n_kv) \
                or k_scale.dtype != torch.bfloat16 or \
                v_scale.dtype != torch.bfloat16:
            raise ValueError('scales must be bfloat16 [B, S, n_kv]')
        tensors += [k_scale, v_scale]
    for t in tensors:
        if t.device != dev:
            raise ValueError('all inputs must be on one CUDA device')
        if not t.is_contiguous():
            raise ValueError('all inputs must be contiguous')


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _paged_decode_cuda(q, kc, vc, valid, row_bound, k_self, v_self,
                       k_scale, v_scale, page, num_pages):
    _check_cuda_args(q, kc, vc, valid, row_bound, k_self, v_self, k_scale,
                     v_scale, page)
    b, s, n_kv, hd = kc.shape
    rep = q.shape[1] // n_kv
    bf16 = q.dtype == torch.bfloat16
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _build.function(KERNEL, 'paged_decode',
                         [P] * 13 + [I] * 8 + [ctypes.c_float, I, I, P])
    out = torch.empty((b, q.shape[1] * hd), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    n_split, ml, acc, counters = 1, None, None, None
    if bf16:
        # Tiles up to the dispatched pages; a row's own bound cuts its
        # share further inside the kernel.
        n_tiles = -(-min(num_pages * page, s) // split_kv.TILE)
        n_split = split_kv.split_count(b * n_kv, n_tiles,
                                       split_kv.sm_count(q.device))
        ml, acc, counters = split_kv.workspace(q.device, stream, b * n_kv,
                                               n_split, rep, hd)
    status = fn(_ptr(q), _ptr(kc), _ptr(vc), _ptr(valid), _ptr(row_bound),
                _ptr(k_scale), _ptr(v_scale), _ptr(k_self), _ptr(v_self),
                _ptr(out), _ptr(ml), _ptr(acc), _ptr(counters), b, s, n_kv,
                rep, hd, page, num_pages, n_split, hd**-0.5, int(bf16),
                1 if k_scale is not None else 0, stream)
    _build.check(status, KERNEL)
    _build.LAUNCHES[KERNEL] += 1
    if not bf16:
        _build.LAUNCHES[KERNEL + '.f32'] += 1
    if k_scale is not None:
        _build.LAUNCHES[KERNEL + '.int8'] += 1
    return out


def paged_gqa_decode_attention(q, kc, vc, valid, row_bound,
                               k_self=None, v_self=None,
                               k_scale=None, v_scale=None, *,
                               page: Optional[int] = None,
                               num_pages: Optional[int] = None
                               ) -> torch.Tensor:
    """One-position GQA attention against a paged cache (+ self);
    returns [B, n_heads * hd] in q's dtype. CUDA tensors run the
    hand-written kernel (a page-misaligned cache raises): a bf16 q the
    split-KV tensor-core one (head_dim in ``FLASH_HEAD_DIMS``, else
    ValueError), a f32 q the CUDA-core one. CPU tensors run
    ``paged_decode_reference``."""
    s = kc.shape[1]
    page = page or default_page()
    total_pages = -(-s // page)
    num_pages = total_pages if num_pages is None else min(
        max(1, num_pages), total_pages)
    if q.is_cuda:
        return _paged_decode_cuda(q, kc, vc, valid, row_bound, k_self,
                                  v_self, k_scale, v_scale, page, num_pages)
    return paged_decode_reference(q, kc, vc, valid, row_bound, k_self,
                                  v_self, k_scale, v_scale, page=page,
                                  num_pages=num_pages)
