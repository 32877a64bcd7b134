"""KV-cache inference primitives for the Llama decoder.

Port of the serving half of ``skypilot_tpu/models/inference.py``:
the cache constructor, ``decode_step``, ``prefill_chunk``, the
speculative ``verify_step``, ``_sample``, the monolithic
``prefill``/``generate`` and the cache-free oracle
``reference_generate``.

Cache layout and slot rules are the reference's: K/V
[n_layers, B, max_seq, n_kv, head_dim] (int8 with per-vector bf16
scales [n_layers, B, max_seq, n_kv] when quantized); prompts occupy
slots [0, base); decode step i writes slot base + i for every row;
``dmask`` [B, max_seq] says which slots each row may read; ``length``
[B] is each row's logical position. ``base`` is a host integer;
``steps`` is a device int32 scalar, as the reference's is, so the write
frontier ``base + steps`` never leaves the device.

JAX donates the cache to its jitted programs so XLA updates it in
place; here every cache tensor is written in place (index copies, never
a new tensor), and each function returns the same dict it was given.
The tensors therefore keep their addresses for the cache's lifetime,
which is what lets the engine capture its ticks as CUDA graphs; and no
function that a tick runs (``decode_step``, ``prefill_chunk`` on device
metadata, ``verify_step``, ``_sample`` on device temperatures) reads a
device value on the host.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from skypilot_tpu_torch.models.llama import (LlamaConfig, _attention,
                                             _rmsnorm, apply_rope,
                                             forward_hidden, layer_params,
                                             mlp_delta, rope_tables)
from skypilot_tpu_torch.models.quantization import (qdot, qembed,
                                                    quantize_kv)
from skypilot_tpu_torch.ops import decode_attention as decode_attn
from skypilot_tpu_torch.ops.flash_attention import (chunk_prefill_attention,
                                                    verify_attention)
from skypilot_tpu_torch.utils.device import resolve_device


def make_cache(cfg: LlamaConfig, batch_size: int, max_seq: int, *,
               base: int, kv_quant: bool = False,
               device: Optional[Union[str, torch.device]] = None) -> Dict:
    """A fresh empty cache: zero K/V (int8 when ``kv_quant``, else the
    compute dtype), unit bf16 scales, zero lengths, an all-false dmask,
    prompt region ``base`` and no decode steps (``steps`` a device int32
    scalar). ``device=None`` means CUDA."""
    dev = resolve_device(device)
    kv_dtype = torch.int8 if kv_quant else cfg.compute_dtype
    shape = (cfg.n_layers, batch_size, max_seq, cfg.n_kv_heads,
             cfg.head_dim)
    cache = {
        'k': torch.zeros(shape, dtype=kv_dtype, device=dev),
        'v': torch.zeros(shape, dtype=kv_dtype, device=dev),
        'length': torch.zeros((batch_size,), dtype=torch.int32,
                              device=dev),
        'dmask': torch.zeros((batch_size, max_seq), dtype=torch.bool,
                             device=dev),
        'base': int(base),
        'steps': torch.zeros((), dtype=torch.int32, device=dev),
    }
    if kv_quant:
        cache['k_scale'] = torch.ones(shape[:4], dtype=torch.bfloat16,
                                      device=dev)
        cache['v_scale'] = torch.ones(shape[:4], dtype=torch.bfloat16,
                                      device=dev)
    return cache


def reset_cache(cache: Dict) -> Dict:
    """Restore ``cache`` in place to ``make_cache``'s values (zero K/V,
    lengths, dmask and steps; unit scales): every tensor keeps its
    address, so programs captured over it stay valid."""
    for f in ('k', 'v', 'length', 'dmask', 'steps'):
        cache[f].zero_()
    for f in ('k_scale', 'v_scale'):
        if f in cache:
            cache[f].fill_(1)
    return cache


def _device_meta(x, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    """A [G] chunk-metadata argument as a device tensor of ``dtype``: a
    tensor already there passes through (no copy, no sync); a host
    sequence is copied once."""
    if isinstance(x, torch.Tensor):
        return x.to(device=dev, dtype=dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)


def _gqa_decode_attention(q, kc, vc, valid, k_self=None, v_self=None,
                          k_scale=None, v_scale=None):
    """One-position GQA attention against the whole cache (+ self), the
    unpaged form of ``paged_decode_reference``: q [B, n_heads, hd];
    kc/vc [B, S, n_kv, hd] (int8 with k_scale/v_scale [B, S, n_kv]);
    valid [B, S] bool. Returns [B, n_heads * hd]."""
    b, s = valid.shape
    every_slot = torch.full((b,), s, dtype=torch.int32, device=kc.device)
    return decode_attn.paged_decode_reference(
        q, kc, vc, valid, every_slot, k_self, v_self, k_scale, v_scale,
        page=s, num_pages=1)


def _host_ints(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x).astype(np.int64)


def decode_step(params: Dict, cache: Dict, tokens: torch.Tensor,
                cfg: LlamaConfig, active: Optional[torch.Tensor] = None,
                *, num_pages: Optional[int] = None,
                page: Optional[int] = None):
    """Advance every row by one token; returns (logits [B, vocab] f32
    for the next token, cache updated in place).

    tokens [B] are fed at each row's ``length``; their K/V are written
    at slot base + steps for every row, but only ``active`` rows
    ([B] bool, default all) get the slot marked readable and their
    length advanced — an idle engine slot never contaminates a later
    occupant. Attention reads the cache (plus each token's own K/V)
    through ``paged_gqa_decode_attention``; ``num_pages`` (with
    ``page``) bounds the region read to the first num_pages * page
    slots, and every readable slot must lie below that bound. The write
    slot comes from the device ``steps`` scalar: nothing is read on the
    host.
    """
    cdt = cfg.compute_dtype
    b = tokens.shape[0]
    quant = 'k_scale' in cache
    pos = cache['length']
    steps = cache['steps']
    frontier = cache['base'] + steps                       # int32 scalar
    slot = frontier.reshape(1).long()                      # [1] index
    valid = cache['dmask']
    if active is None:
        active = torch.ones((b,), dtype=torch.bool, device=tokens.device)
    page = page or decode_attn.default_page()
    # Per-row live bound for page skipping: before any decode write the
    # live slots are the ragged prompt lengths; afterwards every row
    # extends to the shared write frontier base + steps.
    row_bound = torch.where(steps > 0, frontier, pos).to(torch.int32)
    cos, sin = rope_tables(pos[:, None], cfg.head_dim, cfg.rope_theta)

    x = qembed(params['tok_emb'], tokens, cdt)             # [B, D]
    for li in range(cfg.n_layers):
        lp = layer_params(params, li)
        h = _rmsnorm(x, lp['attn_norm'], cfg.norm_eps)
        q = qdot(h, lp['wq'], cdt).reshape(b, 1, cfg.n_heads, cfg.head_dim)
        k = qdot(h, lp['wk'], cdt).reshape(b, 1, cfg.n_kv_heads,
                                          cfg.head_dim)
        v = qdot(h, lp['wv'], cdt).reshape(b, cfg.n_kv_heads, cfg.head_dim)
        q = apply_rope(q, cos, sin)[:, 0]
        k = apply_rope(k, cos, sin)[:, 0]
        o = decode_attn.paged_gqa_decode_attention(
            q, cache['k'][li], cache['v'][li], valid, row_bound,
            k_self=k, v_self=v,
            k_scale=cache['k_scale'][li] if quant else None,
            v_scale=cache['v_scale'][li] if quant else None,
            page=page, num_pages=num_pages)
        x = x + qdot(o, lp['wo'], cdt)
        h = _rmsnorm(x, lp['mlp_norm'], cfg.norm_eps)
        x = x + mlp_delta(h, lp, cdt)
        # In-place sliver write at (layer, slot) for every row.
        if quant:
            k, sk = quantize_kv(k)
            v, sv = quantize_kv(v)
            cache['k_scale'][li].index_copy_(1, slot, sk[:, None])
            cache['v_scale'][li].index_copy_(1, slot, sv[:, None])
        cache['k'][li].index_copy_(1, slot, k[:, None].to(cache['k'].dtype))
        cache['v'][li].index_copy_(1, slot, v[:, None].to(cache['v'].dtype))
    x = _rmsnorm(x, params['final_norm'], cfg.norm_eps)
    logits = qdot(x, params['lm_head'], cdt, preferred=torch.float32)
    cache['dmask'].index_copy_(1, slot, active[:, None])
    cache['length'].copy_(torch.where(active, pos + 1, pos))
    cache['steps'].add_(1)
    return logits, cache


def prefill_chunk(params: Dict, cache: Dict, tokens: torch.Tensor,
                  starts, lens, live, slots, cfg: LlamaConfig, *,
                  prompt_base: int):
    """Process one prompt chunk per row straight into the batch cache
    (chunked prefill); returns (logits [G, vocab] f32 at each row's
    last valid chunk position, cache updated in place).

    tokens [G, C]: row j holds prompt positions [starts[j], starts[j]
    + lens[j]) of slot ``slots[j]``'s prompt, right-padded to C.
    ``starts``/``lens``/``slots`` (int) and ``live`` (bool) are [G]
    device tensors, as the reference takes them, or host sequences,
    copied to the device once here; nothing is read back. Rows with
    ``live`` False are inert: their cache rows, dmask and length keep
    their bits, even when they repeat a live row's slot (their logits
    are unspecified). ``prompt_base`` is the prompt region size; all
    chunk writes land below it.

    Per layer the slot rows' prompt regions are gathered and padded by
    C slots of headroom (so a C-wide write at start <= base - 1 never
    clamps), the live rows' chunk K/V is written at ``starts``
    (quantized for int8 caches), attention runs over the region under
    the query-offset causal rule, and the rows are scattered back at
    fixed shape G. A scatter with repeated slots has no defined winner,
    so each row writes the bits of the live row that owns its slot,
    when one does (its own bits otherwise): every write to one slot
    carries the same bits, and a dead row with no live twin writes back
    what it read.
    """
    cdt = cfg.compute_dtype
    g, c = tokens.shape
    dev = tokens.device
    quant = 'k_scale' in cache
    s_max = cache['k'].shape[2]
    base = prompt_base
    if not 0 < base <= s_max:
        raise ValueError(f'prompt_base {base} outside (0, {s_max}]')
    n_kv, hd = cfg.n_kv_heads, cfg.head_dim
    starts_d = _device_meta(starts, torch.int32, dev)
    lens_d = _device_meta(lens, torch.int32, dev)
    live_d = _device_meta(live, torch.bool, dev)
    slots_d = _device_meta(slots, torch.int64, dev)
    positions = starts_d.long()[:, None] + torch.arange(c, device=dev)
    cos, sin = rope_tables(positions, hd, cfg.rope_theta)
    rows_idx = torch.arange(g, device=dev)
    # owner[j]: the live row whose slot row j names (the first, where
    # live rows repeat one), else j itself.
    same = (slots_d[:, None] == slots_d[None, :]) & live_d[None, :]
    owner = torch.where(same.any(dim=1), same.to(torch.int32).argmax(dim=1),
                        rows_idx)

    def gather_rows(layer_cache):
        rows = layer_cache[:, :base].index_select(0, slots_d)
        pad = torch.zeros((g, c) + rows.shape[2:], dtype=rows.dtype,
                          device=dev)
        return torch.cat([rows, pad], dim=1)

    def write_chunk(rows, chunk):
        # Live rows only: a dead row keeps what it read.
        at = (rows_idx[:, None], positions)
        mask = live_d.view((g,) + (1,) * (chunk.dim() - 1))
        rows[at] = torch.where(mask, chunk.to(rows.dtype), rows[at])

    def scatter_rows(layer_cache, rows):
        layer_cache[:, :base].index_copy_(
            0, slots_d, rows[:, :base].index_select(0, owner))

    x = qembed(params['tok_emb'], tokens, cdt)             # [G, C, D]
    for li in range(cfg.n_layers):
        lp = layer_params(params, li)
        h = _rmsnorm(x, lp['attn_norm'], cfg.norm_eps)
        q = qdot(h, lp['wq'], cdt).reshape(g, c, cfg.n_heads, hd)
        k = qdot(h, lp['wk'], cdt).reshape(g, c, n_kv, hd)
        v = qdot(h, lp['wv'], cdt).reshape(g, c, n_kv, hd)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        rows_k = gather_rows(cache['k'][li])
        rows_v = gather_rows(cache['v'][li])
        rows_ks = rows_vs = None
        if quant:
            rows_ks = gather_rows(cache['k_scale'][li])
            rows_vs = gather_rows(cache['v_scale'][li])
            k, sk = quantize_kv(k)
            v, sv = quantize_kv(v)
            write_chunk(rows_ks, sk)
            write_chunk(rows_vs, sv)
        # A partial chunk leaves garbage in its tail: causally
        # invisible to every valid query, and dmask-false.
        write_chunk(rows_k, k)
        write_chunk(rows_v, v)
        o = chunk_prefill_attention(q, rows_k, rows_v, starts_d, rows_ks,
                                    rows_vs)
        x = x + qdot(o.reshape(g, c, -1), lp['wo'], cdt)
        h = _rmsnorm(x, lp['mlp_norm'], cfg.norm_eps)
        x = x + mlp_delta(h, lp, cdt)
        scatter_rows(cache['k'][li], rows_k)
        scatter_rows(cache['v'][li], rows_v)
        if quant:
            scatter_rows(cache['k_scale'][li], rows_ks)
            scatter_rows(cache['v_scale'][li], rows_vs)

    x = _rmsnorm(x, params['final_norm'], cfg.norm_eps)
    last_idx = torch.clamp(lens_d - 1, min=0).long()
    last = x[rows_idx, last_idx]
    logits = qdot(last, params['lm_head'], cdt, preferred=torch.float32)

    # dmask/length: a prompt's first chunk (start == 0) clears the
    # whole row before setting its own positions, so every slot of the
    # previous occupant becomes unreadable without a cache rewrite.
    # Dead rows keep the values they read; the owner rule above makes
    # the scatter's repeated slots agree.
    col = torch.arange(s_max, device=dev)[None, :]
    ends = starts_d + lens_d
    cur = cache['dmask'].index_select(0, slots_d)
    newly = (col >= starts_d[:, None]) & (col < ends[:, None])
    fresh = cur & (starts_d != 0)[:, None] | newly
    dmask = torch.where(live_d[:, None], fresh, cur)
    cache['dmask'].index_copy_(0, slots_d, dmask.index_select(0, owner))
    length = torch.where(live_d, ends,
                         cache['length'].index_select(0, slots_d))
    cache['length'].index_copy_(0, slots_d, length.index_select(0, owner))
    return logits, cache


def _sample(logits: torch.Tensor, temperature, top_k: int = 0,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Next tokens [B] int32 from logits [B, vocab].

    ``temperature`` (<= 0 means greedy for that row) is a float, a
    per-row host array or a [B] device tensor, as in a captured tick.
    Every row draws and ``torch.where`` picks greedy or sampled per row,
    as the reference's traced temperature does, so nothing is read on
    the host (the cost is one [B, vocab] draw per call). ``top_k`` (<= 0
    or >= vocab disables) keeps every logit >= the top_k-th largest,
    ties at the threshold kept. The Gumbel noise comes from
    ``generator``; its draws differ from ``jax.random``'s, so only
    greedy tokens compare across the two packages."""
    vocab = logits.shape[-1]
    if 0 < top_k < vocab:
        thresh = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < thresh, float('-inf'), logits)
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    temp = torch.as_tensor(temperature, dtype=torch.float32,
                           device=logits.device).expand(logits.shape[0])
    u = torch.rand(logits.shape, generator=generator,
                   device=logits.device).clamp_(min=1e-20)
    gumbel = -torch.log(-torch.log(u))
    sampled = torch.argmax(
        logits.float() / torch.clamp(temp, min=1e-6)[:, None] + gumbel,
        dim=-1).to(torch.int32)
    return torch.where(temp > 0, sampled, greedy)


def _verify_logits(params: Dict, cache: Dict, fed: torch.Tensor,
                   cfg: LlamaConfig, num_pages: Optional[int],
                   page: Optional[int]) -> torch.Tensor:
    """The forward of ``verify_step``: feed ``fed`` [B, V] at positions
    length .. length + V - 1, write its K/V (quantized for int8 caches)
    at the frontier columns [base + steps, base + steps + V) of every
    row BEFORE attending, and attend through ``verify_attention`` over
    the first ``num_pages * page`` columns (default all). Returns the
    f32 logits [B, V, vocab]; the cache's K/V (and scales) change in
    place, its dmask, length and steps do not. The segment start stays
    on the device; the caller keeps the segment inside the cache (the
    engine checks it against its host mirror of ``steps``)."""
    cdt = cfg.compute_dtype
    b, v_len = fed.shape
    dev = fed.device
    quant = 'k_scale' in cache
    n_kv, hd = cfg.n_kv_heads, cfg.head_dim
    frontier = cache['base'] + cache['steps']              # int32 scalar
    s_max = cache['k'].shape[2]
    page = page or decode_attn.default_page()
    n_cols = s_max if num_pages is None else min(num_pages * page, s_max)
    seg = frontier.long() + torch.arange(v_len, device=dev)  # [V]
    valid = cache['dmask']
    positions = (cache['length'].long()[:, None] +
                 torch.arange(v_len, device=dev)[None, :])
    cos, sin = rope_tables(positions, hd, cfg.rope_theta)
    x = qembed(params['tok_emb'], fed, cdt)                 # [B, V, D]
    for li in range(cfg.n_layers):
        lp = layer_params(params, li)
        h = _rmsnorm(x, lp['attn_norm'], cfg.norm_eps)
        q = qdot(h, lp['wq'], cdt).reshape(b, v_len, cfg.n_heads, hd)
        k = qdot(h, lp['wk'], cdt).reshape(b, v_len, n_kv, hd)
        v = qdot(h, lp['wv'], cdt).reshape(b, v_len, n_kv, hd)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        if quant:
            k, sk = quantize_kv(k)
            v, sv = quantize_kv(v)
            cache['k_scale'][li].index_copy_(1, seg, sk)
            cache['v_scale'][li].index_copy_(1, seg, sv)
        cache['k'][li].index_copy_(1, seg, k.to(cache['k'].dtype))
        cache['v'][li].index_copy_(1, seg, v.to(cache['v'].dtype))
        o = verify_attention(
            q, cache['k'][li], cache['v'][li], valid, frontier,
            cache['k_scale'][li] if quant else None,
            cache['v_scale'][li] if quant else None, n_cols=n_cols)
        x = x + qdot(o.reshape(b, v_len, -1), lp['wo'], cdt)
        h = _rmsnorm(x, lp['mlp_norm'], cfg.norm_eps)
        x = x + mlp_delta(h, lp, cdt)
    x = _rmsnorm(x, params['final_norm'], cfg.norm_eps)
    return qdot(x, params['lm_head'], cdt, preferred=torch.float32)


def verify_step(params: Dict, cache: Dict, tokens: torch.Tensor,
                drafts: torch.Tensor, spec_len: torch.Tensor,
                cfg: LlamaConfig, temperature=0.0, top_k: int = 0,
                generator: Optional[torch.Generator] = None,
                active: Optional[torch.Tensor] = None, *,
                num_pages: Optional[int] = None,
                page: Optional[int] = None):
    """One draft-and-verify speculative step: score every drafted
    candidate in one forward and accept the longest prefix the model
    itself would have produced (the reference's ``verify_step``).

    tokens [B] — each row's current (sampled, not yet fed) token;
    drafts [B, K] — up to K proposed continuations per row; spec_len
    [B] in [0, K] — how many of them are real (0: the row takes a
    plain one-token step). The segment [token, d_1 .. d_K] (V = K + 1)
    goes through ``_verify_logits``; position i's token m_i is sampled
    from its logits with ``_sample`` (``temperature`` a float, a per-row
    host array or a [B] device tensor, ``top_k``, ``generator`` as
    there). Accepted:
    the longest prefix with d_{i+1} == m_i for i < spec_len (a = its
    length); the row emits d_1 .. d_a and then m_a, the model's own
    token for the first rejected position (the bonus token when all
    accept), so greedy output equals the one-token path's.

    Rollback: of the segment columns only f_0 .. f_a become readable,
    and only for ``active`` rows ([B] bool, default all); the rejected
    candidates' K/V stay dmask-false for good. Active rows' length
    advances by a + 1; ``steps`` (the device scalar) by V for every row.
    No host sync: every result stays on the device, the cache's
    tensors are updated in place.

    Returns (emit [B, V] int32 — valid up to counts; counts [B] int32 —
    a + 1 for active rows, 0 otherwise; next_tok [B] int32 — m_a, or
    the unchanged token of an inactive row; the cache, updated in
    place)."""
    b, k_max = drafts.shape
    v_len = k_max + 1
    dev = tokens.device
    tokens = tokens.to(torch.int32)
    drafts = drafts.to(device=dev, dtype=torch.int32)
    if active is None:
        active = torch.ones((b,), dtype=torch.bool, device=dev)
    logits = _verify_logits(params, cache, torch.cat(
        [tokens[:, None], drafts], dim=1), cfg, num_pages, page)
    m = torch.stack([_sample(logits[:, i], temperature, top_k, generator)
                     for i in range(v_len)], dim=1)             # [B, V]

    cmp = drafts == m[:, :-1]                                    # [B, K]
    within = (torch.arange(k_max, device=dev)[None, :] <
              spec_len.to(dev)[:, None])
    a = torch.cumprod((cmp & within).to(torch.int32), dim=1).sum(
        dim=1).to(torch.int32)                                   # [B]
    jidx = torch.arange(v_len, device=dev)[None, :]
    drafts_pad = torch.cat(
        [drafts, torch.zeros((b, 1), dtype=torch.int32, device=dev)], dim=1)
    emit = torch.where(jidx < a[:, None], drafts_pad, m)
    counts = torch.where(active, a + 1, 0).to(torch.int32)
    next_tok = torch.gather(m, 1, a[:, None].long())[:, 0]
    # Inactive rows freeze their token (a slot whose prefill finished
    # this tick holds its first token until it joins the active mask).
    next_tok = torch.where(active, next_tok, tokens)

    seg = (cache['base'] + cache['steps']).long() + jidx[0]
    cache['dmask'].index_copy_(1, seg, active[:, None] & (jidx <=
                                                          a[:, None]))
    pos = cache['length']
    cache['length'].copy_(torch.where(active, pos + a + 1, pos))
    cache['steps'].add_(v_len)
    return emit, counts, next_tok, cache


@torch.no_grad()
def prefill(params: Dict, tokens: torch.Tensor, lengths, cfg: LlamaConfig,
            max_seq: Optional[int] = None, kv_quant: bool = False):
    """Process right-padded prompts in one pass and build the cache.

    tokens [B, S]; lengths [B] true lengths (host sequence or tensor).
    Returns (next-token logits [B, vocab] f32 at each prompt's last
    position, cache). Attention is ``llama._attention`` (K4 on CUDA
    tensors). Every layer's K/V are written at [0, S) and the cache is
    zero past S up to ``max_seq`` (default ``cfg.max_seq``); padded
    positions hold garbage K/V that the dmask (slots < length) never
    lets a read reach. ``kv_quant`` stores K/V as int8 with per-vector
    bf16 scales (zero scales past S, as the reference pads them).
    The cache has prompt region ``base`` = S and no decode steps."""
    cdt = cfg.compute_dtype
    b, s = tokens.shape
    dev = tokens.device
    s_max = max_seq or cfg.max_seq
    if s > s_max:
        raise ValueError(f'prompt width {s} exceeds the cache ({s_max})')
    lengths = torch.as_tensor(_host_ints(lengths), dtype=torch.int32,
                              device=dev)
    n_kv, hd = cfg.n_kv_heads, cfg.head_dim
    shape = (cfg.n_layers, b, s_max, n_kv, hd)
    kv_dtype = torch.int8 if kv_quant else cdt
    cache = {'k': torch.zeros(shape, dtype=kv_dtype, device=dev),
             'v': torch.zeros(shape, dtype=kv_dtype, device=dev)}
    if kv_quant:
        cache['k_scale'] = torch.zeros(shape[:4], dtype=torch.bfloat16,
                                       device=dev)
        cache['v_scale'] = torch.zeros(shape[:4], dtype=torch.bfloat16,
                                       device=dev)
    positions = torch.arange(s, device=dev).expand(b, s)
    cos, sin = rope_tables(positions, hd, cfg.rope_theta)

    x = qembed(params['tok_emb'], tokens, cdt)
    for li in range(cfg.n_layers):
        lp = layer_params(params, li)
        h = _rmsnorm(x, lp['attn_norm'], cfg.norm_eps)
        q = qdot(h, lp['wq'], cdt).reshape(b, s, cfg.n_heads, hd)
        k = qdot(h, lp['wk'], cdt).reshape(b, s, n_kv, hd)
        v = qdot(h, lp['wv'], cdt).reshape(b, s, n_kv, hd)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        o = _attention(q, k, v, cfg)
        x = x + qdot(o.reshape(b, s, -1), lp['wo'], cdt)
        h = _rmsnorm(x, lp['mlp_norm'], cfg.norm_eps)
        x = x + mlp_delta(h, lp, cdt)
        if kv_quant:
            k, sk = quantize_kv(k)
            v, sv = quantize_kv(v)
            cache['k_scale'][li, :, :s] = sk
            cache['v_scale'][li, :, :s] = sv
        cache['k'][li, :, :s] = k
        cache['v'][li, :, :s] = v
    x = _rmsnorm(x, params['final_norm'], cfg.norm_eps)
    last = x[torch.arange(b, device=dev), lengths.long() - 1]
    logits = qdot(last, params['lm_head'], cdt, preferred=torch.float32)
    cache.update(
        length=lengths,
        dmask=torch.arange(s_max, device=dev)[None, :] < lengths[:, None],
        base=s, steps=torch.zeros((), dtype=torch.int32, device=dev))
    return logits, cache


@torch.no_grad()
def generate(params: Dict, tokens: torch.Tensor, lengths, cfg: LlamaConfig,
             max_new: int, temperature=0.0, top_k: int = 0,
             generator: Optional[torch.Generator] = None,
             max_seq: Optional[int] = None, kv_quant: bool = False,
             page: Optional[int] = None) -> torch.Tensor:
    """``prefill`` then ``max_new - 1`` calls of ``decode_step``,
    sampling each next token with ``_sample``. tokens [B, S]
    right-padded prompts, lengths [B]; returns [B, max_new] int32
    (greedy where temperature <= 0; sampled rows draw from
    ``generator``, whose numbers differ from ``jax.random``'s). The
    decode steps read through paged decode (K1), whose kernel needs
    ``max_seq`` to be a multiple of ``page``."""
    s_max = max_seq or cfg.max_seq
    if tokens.shape[1] + max_new > s_max:
        # Decode slots are prompt_pad + step; past the cache end the
        # write would land outside it.
        raise ValueError(
            f'prompt ({tokens.shape[1]}) + max_new ({max_new}) '
            f'exceeds the cache ({s_max} slots); raise max_seq or '
            'trim the prompt.')
    logits, cache = prefill(params, tokens, lengths, cfg, max_seq=s_max,
                            kv_quant=kv_quant)
    tok = _sample(logits, temperature, top_k, generator)
    out = [tok]
    for _ in range(max_new - 1):
        logits, cache = decode_step(params, cache, tok, cfg, page=page)
        tok = _sample(logits, temperature, top_k, generator)
        out.append(tok)
    return torch.stack(out, dim=1)


@torch.no_grad()
def reference_generate(params: Dict, tokens: torch.Tensor,
                       lengths, cfg: LlamaConfig,
                       max_new: int) -> torch.Tensor:
    """Cache-free greedy generation (a full forward per token) — the
    correctness oracle for the cache path. tokens [B, S] right-padded
    prompts, lengths [B]; returns [B, max_new] int32. Its attention is
    ``forward_hidden``'s (``cfg.attn_impl``: K4 on CUDA tensors, which
    shares no code with the cache path's K1/K2)."""
    b, s = tokens.shape
    dev = tokens.device
    buf = torch.cat([tokens.to(torch.int64),
                     torch.zeros((b, max_new), dtype=torch.int64,
                                 device=dev)], dim=1)
    cur = torch.as_tensor(_host_ints(lengths), device=dev)
    rows = torch.arange(b, device=dev)
    out = []
    for _ in range(max_new):
        x = forward_hidden(params, buf, cfg)
        last = x[rows, cur - 1]
        logits = qdot(last, params['lm_head'], cfg.compute_dtype)
        nxt = torch.argmax(logits, dim=-1)
        buf[rows, cur] = nxt
        cur = cur + 1
        out.append(nxt.to(torch.int32))
    return torch.stack(out, dim=1)
