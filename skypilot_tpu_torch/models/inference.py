"""KV-cache inference primitives for the Llama and MoE decoders.

Port of the serving half of ``skypilot_tpu/models/inference.py``:
the cache constructor, ``decode_step``, ``prefill_chunk``, the
speculative ``verify_step``, ``_sample``, the monolithic
``prefill``/``generate`` and the cache-free oracle
``reference_generate``.

A ``MoEConfig`` takes the same paths: each layer's MLP is
``llama.mlp_delta``'s family dispatch (the reference's ``_mlp_delta``),
dropless or capacity by ``cfg.infer_dispatch``, its expert products on
``qdot`` even under ``cfg.prefill_a8``.

Weights may be dense or int8 leaves (``quantization.quantize_params``):
every product goes through ``qdot`` (Q1 on CUDA tensors); with
``cfg.prefill_a8`` the prompt paths (``prefill``, ``prefill_chunk``)
run their layer products through ``qdot_a8`` (W8A8) and keep ``qdot``
for the lm_head, as the reference does.

Cache layout: K/V [n_layers, B, max_seq, n_kv, head_dim] (int8 with
per-vector bf16 scales [n_layers, B, max_seq, n_kv] when quantized);
prompts occupy slots [0, base); ``dmask`` [B, max_seq] says which slots
each row may read; ``length`` [B] is each row's logical position.
``base`` is a host integer. ``steps`` [B] int32 counts each row's own
decode columns: a row writes its next decode K/V at its own frontier
``base + steps[b]``, so rows of unrelated lengths share no column and
no row's answer uses up another's. Only active rows advance their
count; a new occupant's first prefill chunk (start 0) sets it back to
0. Rows that move in lockstep (``prefill``/``generate``, every row
active) keep equal counts, each the reference's scalar ``steps``, and
write the reference's columns. The frontier never leaves the device.
A write column is held below the cache's end (``_write_columns``): a
row past its own need, or an idle row at capacity, writes the last
column, which no kept token of it reads.

JAX donates the cache to its jitted programs so XLA updates it in
place; here every cache tensor is written in place (index copies, never
a new tensor), and each function returns the same dict it was given.
The tensors therefore keep their addresses for the cache's lifetime,
which is what lets the engine capture its ticks as CUDA graphs; and no
function that a tick runs (``decode_step``, ``prefill_chunk`` on device
metadata, ``verify_step``, ``_sample`` on device temperatures) reads a
device value on the host.

Tensor parallelism (``mesh=``, ``parallel/mesh.py``): every rank runs
these same functions on its shard (``param_specs``): its n_heads/tp
query heads, n_kv_heads/tp cache heads, ffn/tp columns and vocab/tp
rows. Four hooks make the shards one model, each an ``all_reduce`` over
'tp': the vocab-parallel embedding (a masked lookup, exact: one rank
owns each row); the products after ``wo`` and after the MLP or MoE
delta, row-parallel partial sums that go out in f32 where tp > 1 and
are rounded to the compute dtype once, after the sum; and the lm_head's
local logits placed in a zero f32 [.., vocab] buffer, so ``_sample``
sees the full logits, identical on every rank. Under W8A8 prefill a
row-parallel product scales each token by the max over every rank's
features (``quantization.row_dot``). Attention needs no
collective: each rank's heads are contiguous kv groups, so its local
outputs, concatenated over the ranks, are the unsharded layout.
"""
from __future__ import annotations

from typing import Dict, Optional, Union

import numpy as np
import torch

from skypilot_tpu_torch.models.llama import (LlamaConfig, _attention,
                                             _rmsnorm, apply_rope,
                                             forward_hidden, layer_params,
                                             mlp_delta, rope_tables)
from skypilot_tpu_torch.models.quantization import (qdot, qdot_a8, qembed,
                                                    quantize_kv, row_dot)
from skypilot_tpu_torch.ops import decode_attention as decode_attn
from skypilot_tpu_torch.ops.flash_attention import (chunk_prefill_attention,
                                                    verify_attention)
from skypilot_tpu_torch.utils.device import resolve_device


def kv_heads(cfg: LlamaConfig, mesh=None) -> int:
    """The kv heads one rank's cache holds: n_kv_heads over 'tp' (a
    count tp does not divide raises, as the reference's sharded decode
    does)."""
    if mesh is None:
        return cfg.n_kv_heads
    return mesh.local(cfg.n_kv_heads, 'n_kv_heads')


def make_cache(cfg: LlamaConfig, batch_size: int, max_seq: int, *,
               base: int, kv_quant: bool = False,
               device: Optional[Union[str, torch.device]] = None,
               mesh=None) -> Dict:
    """A fresh empty cache: zero K/V (int8 when ``kv_quant``, else the
    compute dtype), unit bf16 scales, zero lengths, an all-false dmask,
    prompt region ``base`` and no decode columns (``steps`` [B] device
    int32 zeros). ``device=None`` means CUDA. With a ``mesh`` the cache holds
    this rank's kv heads (``kv_heads``), the reference's ``CACHE_SPEC``
    shard."""
    dev = resolve_device(device)
    kv_dtype = torch.int8 if kv_quant else cfg.compute_dtype
    shape = (cfg.n_layers, batch_size, max_seq, kv_heads(cfg, mesh),
             cfg.head_dim)
    cache = {
        'k': torch.zeros(shape, dtype=kv_dtype, device=dev),
        'v': torch.zeros(shape, dtype=kv_dtype, device=dev),
        'length': torch.zeros((batch_size,), dtype=torch.int32,
                              device=dev),
        'dmask': torch.zeros((batch_size, max_seq), dtype=torch.bool,
                             device=dev),
        'base': int(base),
        'steps': torch.zeros((batch_size,), dtype=torch.int32, device=dev),
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


def _partial(mesh) -> Optional[torch.dtype]:
    """The output dtype of a row-parallel product: f32 partial sums
    where tp > 1 (None: the compute dtype, the one term's own
    rounding)."""
    return torch.float32 if mesh is not None and mesh.tp > 1 else None


def _tp_sum(y: torch.Tensor, cdt, mesh) -> torch.Tensor:
    """The row-parallel products' sum over 'tp', in f32, rounded to
    ``cdt`` once (``y`` itself without a mesh)."""
    if mesh is None:
        return y
    return mesh.all_reduce(y.float()).to(cdt)


def _embed(params: Dict, tokens: torch.Tensor, cdt, mesh) -> torch.Tensor:
    """The token embedding; vocab-parallel under a mesh: this rank's
    rows answer the tokens they hold, the others give zeros, and the f32
    sum over 'tp' is exact (one rank contributes each row)."""
    emb = params['tok_emb']
    if mesh is None:
        return qembed(emb, tokens, cdt)
    rows = (emb['q'] if isinstance(emb, dict) else emb).shape[0]
    local = tokens.long() - mesh.tp_rank * rows
    mine = (local >= 0) & (local < rows)
    x = qembed(emb, torch.where(mine, local, 0), cdt)
    x = torch.where(mine[..., None], x.float(), 0.0)
    return mesh.all_reduce(x).to(cdt)


def _logits(x: torch.Tensor, lm_head, cdt, mesh) -> torch.Tensor:
    """f32 logits [.., vocab]; vocab-parallel under a mesh: this rank's
    columns placed in a zero f32 buffer of the full vocab and summed
    over 'tp', so every rank holds the same full logits."""
    local = qdot(x, lm_head, cdt, preferred=torch.float32)
    if mesh is None:
        return local
    n = local.shape[-1]
    full = local.new_zeros(local.shape[:-1] + (n * mesh.tp,))
    full.narrow(-1, mesh.tp_rank * n, n).copy_(local)
    return mesh.all_reduce(full)


def _write_columns(cache: Dict, width: int) -> torch.Tensor:
    """Each row's first write column for a segment of ``width``
    columns: its own frontier ``base + steps[b]``, held so that the
    segment ends inside the cache ([B] int64). Only a row with no kept
    token at stake is held back: a row past its own need, or an idle
    row whose count sits at capacity."""
    base = cache['base']
    cap = cache['k'].shape[2] - base
    if width > cap:
        raise ValueError(f'a {width}-column segment does not fit the '
                         f'{cap} decode columns of the cache')
    return base + torch.clamp(cache['steps'], max=cap - width).long()


def _advance(cache: Dict, active: torch.Tensor, width: int) -> None:
    """Active rows' counts move on by ``width`` columns, never past the
    cache's end; idle rows keep theirs."""
    steps = cache['steps']
    cap = cache['k'].shape[2] - cache['base']
    steps.copy_(torch.where(active, torch.clamp(steps + width, max=cap),
                            steps))


def _row_cells(t: torch.Tensor) -> torch.Tensor:
    """A [B, S, ...] cache layer viewed as [B * S, ...] (no copy), for
    writes at per-row columns."""
    return t.view((-1,) + tuple(t.shape[2:]))


def _host_ints(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.cpu().numpy()
    return np.asarray(x).astype(np.int64)


def decode_step(params: Dict, cache: Dict, tokens: torch.Tensor,
                cfg: LlamaConfig, active: Optional[torch.Tensor] = None,
                *, attn_impl: Optional[str] = None,
                num_pages: Optional[int] = None,
                page: Optional[int] = None, mesh=None):
    """Advance every row by one token; returns (logits [B, vocab] f32
    for the next token, cache updated in place).

    tokens [B] are fed at each row's ``length``; each row's K/V are
    written at its own frontier base + steps[b], but only ``active``
    rows ([B] bool, default all) get the slot marked readable and their
    length and count advanced — an idle engine slot never contaminates
    a later occupant, and writes where its own next step will. An idle
    row reads no cache column: its logits, which no caller keeps,
    attend to its own K/V alone, so its stale or half-written columns
    cost the attention nothing. Attention reads the cache (plus each token's own K/V)
    by ``attn_impl`` (``decode_attention.resolve_impl``: None reads
    ``SKYTPU_DECODE_ATTN``, 'auto' is 'paged' on CUDA and 'lax' on the
    CPU): 'paged' runs ``paged_gqa_decode_attention`` (K1 on CUDA
    tensors), 'lax' the reference's cache-wide ``_gqa_decode_attention``.
    ``num_pages`` (with ``page``) bounds the region read to the first
    num_pages * page slots, and every slot an active row may read must
    lie below that bound. The write columns come from the device
    ``steps`` vector: nothing is read on the host. ``mesh``: this rank's shard of a
    tensor-parallel model (the module's four hooks).
    """
    cdt = cfg.compute_dtype
    b = tokens.shape[0]
    quant = 'k_scale' in cache
    pos = cache['length']
    steps = cache['steps']
    valid = cache['dmask']
    if active is None:
        active = torch.ones((b,), dtype=torch.bool, device=tokens.device)
    page = page or decode_attn.default_page()
    impl = decode_attn.resolve_impl(attn_impl, tokens.device)
    s_max = cache['k'].shape[2]
    n_slots = s_max if num_pages is None else min(num_pages * page, s_max)
    # Each row's write cell in the [B * S] view of a layer.
    cell = (torch.arange(b, device=tokens.device) * s_max +
            _write_columns(cache, 1))
    # Per-row live bound for page skipping: before its first decode
    # write a row's live slots are its prompt; afterwards it extends to
    # its own frontier base + steps[b]. An idle row reads nothing.
    row_bound = torch.where(
        active, torch.where(steps > 0, cache['base'] + steps, pos),
        0).to(torch.int32)
    if impl != 'paged':
        readable = valid[:, :n_slots] & active[:, None]
    cos, sin = rope_tables(pos[:, None], cfg.head_dim, cfg.rope_theta)

    row = _partial(mesh)
    x = _embed(params, tokens, cdt, mesh)                  # [B, D]
    for li in range(cfg.n_layers):
        lp = layer_params(params, li)
        h = _rmsnorm(x, lp['attn_norm'], cfg.norm_eps)
        # Heads from the weights' widths: this rank's, under a mesh.
        q = qdot(h, lp['wq'], cdt).reshape(b, 1, -1, cfg.head_dim)
        k = qdot(h, lp['wk'], cdt).reshape(b, 1, -1, cfg.head_dim)
        v = qdot(h, lp['wv'], cdt).reshape(b, -1, cfg.head_dim)
        q = apply_rope(q, cos, sin)[:, 0]
        k = apply_rope(k, cos, sin)[:, 0]
        ks = cache['k_scale'][li] if quant else None
        vs = cache['v_scale'][li] if quant else None
        if impl == 'paged':
            o = decode_attn.paged_gqa_decode_attention(
                q, cache['k'][li], cache['v'][li], valid, row_bound,
                k_self=k, v_self=v, k_scale=ks, v_scale=vs, page=page,
                num_pages=num_pages)
        else:
            # The length-aware slice: only the first n_slots columns.
            o = _gqa_decode_attention(
                q, cache['k'][li][:, :n_slots], cache['v'][li][:, :n_slots],
                readable, k_self=k, v_self=v,
                k_scale=None if ks is None else ks[:, :n_slots],
                v_scale=None if vs is None else vs[:, :n_slots])
        x = x + _tp_sum(qdot(o, lp['wo'], cdt, row), cdt, mesh)
        h = _rmsnorm(x, lp['mlp_norm'], cfg.norm_eps)
        x = x + _tp_sum(mlp_delta(h, lp, cfg, mesh=mesh), cdt, mesh)
        # In-place sliver write at (layer, row, own column) per row.
        if quant:
            k, sk = quantize_kv(k)
            v, sv = quantize_kv(v)
            _row_cells(cache['k_scale'][li]).index_copy_(0, cell, sk)
            _row_cells(cache['v_scale'][li]).index_copy_(0, cell, sv)
        _row_cells(cache['k'][li]).index_copy_(0, cell,
                                               k.to(cache['k'].dtype))
        _row_cells(cache['v'][li]).index_copy_(0, cell,
                                               v.to(cache['v'].dtype))
    x = _rmsnorm(x, params['final_norm'], cfg.norm_eps)
    logits = _logits(x, params['lm_head'], cdt, mesh)
    cache['dmask'].view(-1).index_copy_(0, cell, active)
    cache['length'].copy_(torch.where(active, pos + 1, pos))
    _advance(cache, active, 1)
    return logits, cache


def prefill_chunk(params: Dict, cache: Dict, tokens: torch.Tensor,
                  starts, lens, live, slots, cfg: LlamaConfig, *,
                  prompt_base: int, mesh=None):
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
    chunk writes land below it. A live row's first chunk (start 0) is a
    new occupant: its slot's decode column count returns to 0.

    Per layer the slot rows' prompt regions are gathered and padded by
    C slots of headroom (so a C-wide write at start <= base - 1 never
    clamps), the live rows' chunk K/V is written at ``starts``
    (quantized for int8 caches), attention runs over the region under
    the query-offset causal rule, and the rows are scattered back at
    fixed shape G. A scatter with repeated slots has no defined winner,
    so each row writes the bits of the live row that owns its slot,
    when one does (its own bits otherwise): every write to one slot
    carries the same bits, and a dead row with no live twin writes back
    what it read. ``mesh``: as ``decode_step``'s.
    """
    cdt = cfg.compute_dtype
    g, c = tokens.shape
    dev = tokens.device
    quant = 'k_scale' in cache
    s_max = cache['k'].shape[2]
    base = prompt_base
    if not 0 < base <= s_max:
        raise ValueError(f'prompt_base {base} outside (0, {s_max}]')
    hd = cfg.head_dim
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

    # W8A8 layer products with cfg.prefill_a8 (the lm_head stays qdot).
    dot = qdot_a8 if cfg.prefill_a8 else qdot
    row = _partial(mesh)
    x = _embed(params, tokens, cdt, mesh)                  # [G, C, D]
    for li in range(cfg.n_layers):
        lp = layer_params(params, li)
        h = _rmsnorm(x, lp['attn_norm'], cfg.norm_eps)
        q = dot(h, lp['wq'], cdt).reshape(g, c, -1, hd)
        k = dot(h, lp['wk'], cdt).reshape(g, c, -1, hd)
        v = dot(h, lp['wv'], cdt).reshape(g, c, -1, hd)
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
        x = x + _tp_sum(row_dot(dot, mesh)(o.reshape(g, c, -1), lp['wo'],
                                           cdt, row), cdt, mesh)
        h = _rmsnorm(x, lp['mlp_norm'], cfg.norm_eps)
        x = x + _tp_sum(mlp_delta(h, lp, cfg, dot, mesh), cdt, mesh)
        scatter_rows(cache['k'][li], rows_k)
        scatter_rows(cache['v'][li], rows_v)
        if quant:
            scatter_rows(cache['k_scale'][li], rows_ks)
            scatter_rows(cache['v_scale'][li], rows_vs)

    x = _rmsnorm(x, params['final_norm'], cfg.norm_eps)
    last_idx = torch.clamp(lens_d - 1, min=0).long()
    last = x[rows_idx, last_idx]
    logits = _logits(last, params['lm_head'], cdt, mesh)

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
    steps = torch.where(live_d & (starts_d == 0), 0,
                        cache['steps'].index_select(0, slots_d))
    cache['steps'].index_copy_(0, slots_d, steps.index_select(0, owner))
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
                   page: Optional[int], mesh=None,
                   active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The forward of ``verify_step``: feed ``fed`` [B, V] at positions
    length .. length + V - 1, write its K/V (quantized for int8 caches)
    at each row's own frontier columns [base + steps[b], .. + V)
    (``_write_columns``) BEFORE attending, and attend through
    ``verify_attention`` over the first ``num_pages * page`` columns
    (default all). Returns the f32 logits [B, V, vocab]; the cache's K/V
    (and scales) change in place, its dmask, length and steps do not.
    The segment starts stay on the device; the caller keeps every
    active row's segment inside the columns read (the engine checks it
    against its host mirror of ``steps``). Rows outside ``active`` ([B]
    bool, default all) read no cache column but their own segment."""
    cdt = cfg.compute_dtype
    b, v_len = fed.shape
    dev = fed.device
    quant = 'k_scale' in cache
    hd = cfg.head_dim
    s_max = cache['k'].shape[2]
    page = page or decode_attn.default_page()
    n_cols = s_max if num_pages is None else min(num_pages * page, s_max)
    start = _write_columns(cache, v_len)                    # [B]
    # The segment's cells in the [B * S] view of a layer, row-major.
    cell = ((torch.arange(b, device=dev) * s_max + start)[:, None] +
            torch.arange(v_len, device=dev)).reshape(-1)
    seg_start = start.to(torch.int32)
    valid = cache['dmask']
    if active is not None:
        valid = valid & active[:, None]
    positions = (cache['length'].long()[:, None] +
                 torch.arange(v_len, device=dev)[None, :])
    cos, sin = rope_tables(positions, hd, cfg.rope_theta)
    row = _partial(mesh)
    x = _embed(params, fed, cdt, mesh)                      # [B, V, D]
    for li in range(cfg.n_layers):
        lp = layer_params(params, li)
        h = _rmsnorm(x, lp['attn_norm'], cfg.norm_eps)
        q = qdot(h, lp['wq'], cdt).reshape(b, v_len, -1, hd)
        k = qdot(h, lp['wk'], cdt).reshape(b, v_len, -1, hd)
        v = qdot(h, lp['wv'], cdt).reshape(b, v_len, -1, hd)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        if quant:
            k, sk = quantize_kv(k)
            v, sv = quantize_kv(v)
            _row_cells(cache['k_scale'][li]).index_copy_(0, cell,
                                                         sk.flatten(0, 1))
            _row_cells(cache['v_scale'][li]).index_copy_(0, cell,
                                                         sv.flatten(0, 1))
        _row_cells(cache['k'][li]).index_copy_(
            0, cell, k.flatten(0, 1).to(cache['k'].dtype))
        _row_cells(cache['v'][li]).index_copy_(
            0, cell, v.flatten(0, 1).to(cache['v'].dtype))
        o = verify_attention(
            q, cache['k'][li], cache['v'][li], valid, seg_start,
            cache['k_scale'][li] if quant else None,
            cache['v_scale'][li] if quant else None, n_cols=n_cols)
        x = x + _tp_sum(qdot(o.reshape(b, v_len, -1), lp['wo'], cdt, row),
                        cdt, mesh)
        h = _rmsnorm(x, lp['mlp_norm'], cfg.norm_eps)
        x = x + _tp_sum(mlp_delta(h, lp, cfg, mesh=mesh), cdt, mesh)
    x = _rmsnorm(x, params['final_norm'], cfg.norm_eps)
    return _logits(x, params['lm_head'], cdt, mesh)


def verify_step(params: Dict, cache: Dict, tokens: torch.Tensor,
                drafts: torch.Tensor, spec_len: torch.Tensor,
                cfg: LlamaConfig, temperature=0.0, top_k: int = 0,
                generator: Optional[torch.Generator] = None,
                active: Optional[torch.Tensor] = None, *,
                num_pages: Optional[int] = None,
                page: Optional[int] = None, mesh=None):
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
    advances by a + 1 and their own column count by V; idle rows keep
    both.
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
        [tokens[:, None], drafts], dim=1), cfg, num_pages, page, mesh,
        active)
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

    cell = ((torch.arange(b, device=dev) * cache['k'].shape[2] +
             _write_columns(cache, v_len))[:, None] + jidx).reshape(-1)
    cache['dmask'].view(-1).index_copy_(
        0, cell, (active[:, None] & (jidx <= a[:, None])).reshape(-1))
    pos = cache['length']
    cache['length'].copy_(torch.where(active, pos + a + 1, pos))
    _advance(cache, active, v_len)
    return emit, counts, next_tok, cache


@torch.no_grad()
def prefill(params: Dict, tokens: torch.Tensor, lengths, cfg: LlamaConfig,
            max_seq: Optional[int] = None, kv_quant: bool = False,
            mesh=None):
    """Process right-padded prompts in one pass and build the cache.

    tokens [B, S]; lengths [B] true lengths (host sequence or tensor).
    Returns (next-token logits [B, vocab] f32 at each prompt's last
    position, cache). Attention is ``llama._attention`` (K4 on CUDA
    tensors). Every layer's K/V are written at [0, S) and the cache is
    zero past S up to ``max_seq`` (default ``cfg.max_seq``); padded
    positions hold garbage K/V that the dmask (slots < length) never
    lets a read reach. ``kv_quant`` stores K/V as int8 with per-vector
    bf16 scales (zero scales past S, as the reference pads them).
    The cache has prompt region ``base`` = S and no decode columns.
    ``mesh``: as ``decode_step``'s (the cache holds this rank's heads).
    """
    cdt = cfg.compute_dtype
    b, s = tokens.shape
    dev = tokens.device
    s_max = max_seq or cfg.max_seq
    if s > s_max:
        raise ValueError(f'prompt width {s} exceeds the cache ({s_max})')
    lengths = torch.as_tensor(_host_ints(lengths), dtype=torch.int32,
                              device=dev)
    hd = cfg.head_dim
    shape = (cfg.n_layers, b, s_max, kv_heads(cfg, mesh), hd)
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
    # W8A8 layer products with cfg.prefill_a8 (the lm_head stays qdot).
    dot = qdot_a8 if cfg.prefill_a8 else qdot
    row = _partial(mesh)

    x = _embed(params, tokens, cdt, mesh)
    for li in range(cfg.n_layers):
        lp = layer_params(params, li)
        h = _rmsnorm(x, lp['attn_norm'], cfg.norm_eps)
        q = dot(h, lp['wq'], cdt).reshape(b, s, -1, hd)
        k = dot(h, lp['wk'], cdt).reshape(b, s, -1, hd)
        v = dot(h, lp['wv'], cdt).reshape(b, s, -1, hd)
        q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
        o = _attention(q, k, v, cfg)
        x = x + _tp_sum(row_dot(dot, mesh)(o.reshape(b, s, -1), lp['wo'],
                                           cdt, row), cdt, mesh)
        h = _rmsnorm(x, lp['mlp_norm'], cfg.norm_eps)
        x = x + _tp_sum(mlp_delta(h, lp, cfg, dot, mesh), cdt, mesh)
        if kv_quant:
            k, sk = quantize_kv(k)
            v, sv = quantize_kv(v)
            cache['k_scale'][li, :, :s] = sk
            cache['v_scale'][li, :, :s] = sv
        cache['k'][li, :, :s] = k
        cache['v'][li, :, :s] = v
    x = _rmsnorm(x, params['final_norm'], cfg.norm_eps)
    last = x[torch.arange(b, device=dev), lengths.long() - 1]
    logits = _logits(last, params['lm_head'], cdt, mesh)
    cache.update(
        length=lengths,
        dmask=torch.arange(s_max, device=dev)[None, :] < lengths[:, None],
        base=s, steps=torch.zeros((b,), dtype=torch.int32, device=dev))
    return logits, cache


@torch.no_grad()
def generate(params: Dict, tokens: torch.Tensor, lengths, cfg: LlamaConfig,
             max_new: int, temperature=0.0, top_k: int = 0,
             generator: Optional[torch.Generator] = None,
             max_seq: Optional[int] = None, kv_quant: bool = False,
             attn_impl: Optional[str] = None,
             page: Optional[int] = None, mesh=None) -> torch.Tensor:
    """``prefill`` then ``max_new - 1`` calls of ``decode_step``,
    sampling each next token with ``_sample``. tokens [B, S]
    right-padded prompts, lengths [B]; returns [B, max_new] int32
    (greedy where temperature <= 0; sampled rows draw from
    ``generator``, whose numbers differ from ``jax.random``'s). The
    decode attention is ``attn_impl``, resolved once before the first
    step (``decode_attention.resolve_impl``; 'paged' is K1 on CUDA,
    whose kernel needs ``max_seq`` to be a multiple of ``page``).
    ``mesh``: as ``decode_step``'s."""
    s_max = max_seq or cfg.max_seq
    if tokens.shape[1] + max_new > s_max:
        # Decode slots are prompt_pad + step; past the cache end the
        # write would land outside it.
        raise ValueError(
            f'prompt ({tokens.shape[1]}) + max_new ({max_new}) '
            f'exceeds the cache ({s_max} slots); raise max_seq or '
            'trim the prompt.')
    impl = decode_attn.resolve_impl(attn_impl, tokens.device)
    logits, cache = prefill(params, tokens, lengths, cfg, max_seq=s_max,
                            kv_quant=kv_quant, mesh=mesh)
    tok = _sample(logits, temperature, top_k, generator)
    out = [tok]
    for _ in range(max_new - 1):
        logits, cache = decode_step(params, cache, tok, cfg,
                                    attn_impl=impl, page=page, mesh=mesh)
        tok = _sample(logits, temperature, top_k, generator)
        out.append(tok)
    return torch.stack(out, dim=1)


@torch.no_grad()
def reference_generate(params: Dict, tokens: torch.Tensor,
                       lengths, cfg: LlamaConfig,
                       max_new: int) -> torch.Tensor:
    """Cache-free greedy generation (a full forward per token) — the
    correctness oracle for the cache path (dense weights only: for int8
    weights, re-prefill the growing sequence with ``prefill``). tokens
    [B, S] right-padded prompts, lengths [B]; returns [B, max_new]
    int32. Its attention is
    ``forward_hidden``'s (``cfg.attn_impl``: K4 on CUDA tensors, which
    shares no code with the cache path's K1/K2). A ``MoEConfig`` runs
    ``moe.forward_hidden(dropless=True)`` and f32 logits, as the
    reference's ``moe.forward`` does; a Llama model's logits are in the
    compute dtype, as the reference's oracle takes them."""
    from skypilot_tpu_torch.models import moe
    b, s = tokens.shape
    dev = tokens.device
    buf = torch.cat([tokens.to(torch.int64),
                     torch.zeros((b, max_new), dtype=torch.int64,
                                 device=dev)], dim=1)
    cur = torch.as_tensor(_host_ints(lengths), device=dev)
    rows = torch.arange(b, device=dev)
    out = []
    is_moe = isinstance(cfg, moe.MoEConfig)
    for _ in range(max_new):
        if is_moe:
            x, _ = moe.forward_hidden(params, buf, cfg, dropless=True)
        else:
            x = forward_hidden(params, buf, cfg)
        last = x[rows, cur - 1]
        logits = qdot(last, params['lm_head'], cfg.compute_dtype,
                      preferred=torch.float32 if is_moe else None)
        nxt = torch.argmax(logits, dim=-1)
        buf[rows, cur] = nxt
        cur = cur + 1
        out.append(nxt.to(torch.int32))
    return torch.stack(out, dim=1)
