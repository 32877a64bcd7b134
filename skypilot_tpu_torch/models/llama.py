"""Llama-family decoder in PyTorch: config, parameters, the cache-free
forward and the training loss.

Port of ``skypilot_tpu/models/llama.py``. Parameters are a plain dict
of tensors in the reference's layout — per-layer weights stacked on a
leading ``[n_layers]`` axis, matmul weights stored [in, out] — so
``convert.params_from_numpy`` maps the JAX tree one to one and every
function here is a plain function over that dict. RMSNorm, split-half
rotary embeddings, grouped-query attention (through the flash kernels,
``_attention``), SwiGLU MLP, untied head; per-layer rematerialization
and the sequence-chunked cross entropy of the reference's training
path.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Union

import torch
from torch.utils.checkpoint import checkpoint

from skypilot_tpu_torch.models.quantization import qdot, qembed
from skypilot_tpu_torch.ops.flash_attention import (flash_attention,
                                                     reference_attention)
from skypilot_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Same fields and presets as the reference's ``LlamaConfig``;
    dtypes are torch dtypes. ``pp_microbatches`` and ``prefill_a8``
    are not read yet (pipeline parallelism and int8 activations are
    not ported); they are kept so a config converts field for field."""
    vocab_size: int = 32000
    dim: int = 2048
    n_layers: int = 16
    n_heads: int = 16
    n_kv_heads: int = 8
    ffn_dim: int = 5632
    max_seq: int = 2048
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    param_dtype: Any = torch.float32
    compute_dtype: Any = torch.bfloat16
    attn_impl: str = 'auto'
    pp_microbatches: int = 0
    remat: Any = True
    loss_chunk: int = 512
    prefill_a8: bool = False

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @classmethod
    def tiny(cls, **kw) -> 'LlamaConfig':
        """CPU-test scale."""
        d = dict(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                 n_kv_heads=2, ffn_dim=128, max_seq=128,
                 param_dtype=torch.float32, compute_dtype=torch.float32)
        d.update(kw)
        return cls(**d)

    @classmethod
    def llama3_1b(cls, **kw) -> 'LlamaConfig':
        """Llama-3.2-1B shape (public)."""
        d = dict(vocab_size=128256, dim=2048, n_layers=16, n_heads=32,
                 n_kv_heads=8, ffn_dim=8192, max_seq=2048)
        d.update(kw)
        return cls(**d)

    @classmethod
    def tpu_1b(cls, **kw) -> 'LlamaConfig':
        """1B-class config with head_dim 128 and 2:1 GQA."""
        d = dict(vocab_size=128256, dim=2048, n_layers=16, n_heads=16,
                 n_kv_heads=8, ffn_dim=8192, max_seq=8192)
        d.update(kw)
        return cls(**d)

    @classmethod
    def llama3_8b(cls, **kw) -> 'LlamaConfig':
        """Llama-3.1-8B shape (public)."""
        d = dict(vocab_size=128256, dim=4096, n_layers=32, n_heads=32,
                 n_kv_heads=8, ffn_dim=14336, max_seq=8192)
        d.update(kw)
        return cls(**d)


def init_params(cfg: LlamaConfig,
                generator: Union[int, torch.Generator] = 0,
                device: Optional[Union[str, torch.device]] = None
                ) -> Dict:
    """Stacked-layer param dict with the reference's shapes and its
    ``normal * fan_in**-0.5`` scale (norms are ones), drawn in f32 from
    ``generator`` (a ``torch.Generator`` on ``device``, or an int
    seed) and cast to ``cfg.param_dtype``. ``device=None`` means CUDA.
    The numbers differ from ``jax.random``'s; tests that need the JAX
    weights convert them with ``convert.params_from_numpy``."""
    dev = resolve_device(device)
    if isinstance(generator, int):
        generator = torch.Generator(device=dev).manual_seed(generator)
    hd, nl, dt = cfg.head_dim, cfg.n_layers, cfg.param_dtype

    def norm_init(*shape):
        return torch.ones(shape, dtype=dt, device=dev)

    def draw(shape, fan_in):
        return (torch.randn(shape, generator=generator, device=dev,
                            dtype=torch.float32) * fan_in**-0.5).to(dt)

    def dense_init(*shape, fan_in):
        if len(shape) == 2:
            return draw(shape, fan_in)
        # Stacked leaves draw one layer at a time, so the f32 draw's
        # peak memory is one layer's slice, not the whole leaf.
        out = torch.empty(shape, dtype=dt, device=dev)
        for i in range(shape[0]):
            out[i] = draw(shape[1:], fan_in)
        return out

    return {
        'tok_emb': dense_init(cfg.vocab_size, cfg.dim, fan_in=cfg.dim),
        'layers': {
            'attn_norm': norm_init(nl, cfg.dim),
            'wq': dense_init(nl, cfg.dim, cfg.n_heads * hd, fan_in=cfg.dim),
            'wk': dense_init(nl, cfg.dim, cfg.n_kv_heads * hd,
                             fan_in=cfg.dim),
            'wv': dense_init(nl, cfg.dim, cfg.n_kv_heads * hd,
                             fan_in=cfg.dim),
            'wo': dense_init(nl, cfg.n_heads * hd, cfg.dim,
                             fan_in=cfg.n_heads * hd),
            'mlp_norm': norm_init(nl, cfg.dim),
            'w_gate': dense_init(nl, cfg.dim, cfg.ffn_dim, fan_in=cfg.dim),
            'w_up': dense_init(nl, cfg.dim, cfg.ffn_dim, fan_in=cfg.dim),
            'w_down': dense_init(nl, cfg.ffn_dim, cfg.dim,
                                 fan_in=cfg.ffn_dim),
        },
        'final_norm': norm_init(cfg.dim),
        'lm_head': dense_init(cfg.dim, cfg.vocab_size, fan_in=cfg.dim),
    }


def layer_params(params: Dict, li: int) -> Dict[str, torch.Tensor]:
    """Layer ``li``'s weights (views into the stacked leaves)."""
    return {k: v[li] for k, v in params['layers'].items()}


def _rmsnorm(x, w, eps):
    xf = x.float()
    rms = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    return (xf * rms).to(x.dtype) * w.to(x.dtype)


def rope_tables(positions: torch.Tensor, d: int, theta: float):
    """(cos, sin) [..., d/2] in f32 for integer ``positions``."""
    exps = -torch.arange(0, d, 2, dtype=torch.float32,
                         device=positions.device) / d
    # A fill, not a copy from the host: this runs inside captured ticks.
    freqs = torch.pow(torch.full((), theta, dtype=torch.float32,
                                 device=positions.device), exps)
    angles = positions[..., None].float() * freqs
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, cos, sin):
    """Split-half (not interleaved) rotation of x [B, S, H, D] with
    tables [B, S, D/2], computed in f32."""
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    c, s = cos[:, :, None, :], sin[:, :, None, :]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1).to(x.dtype)


def _rope(x, positions, theta):
    """Rotary embedding; x [B, S, H, D], positions [B, S]."""
    cos, sin = rope_tables(positions, x.shape[-1], theta)
    return apply_rope(x, cos, sin)


def mlp_delta(h, lp, cdt):
    """SwiGLU residual branch."""
    gate = torch.nn.functional.silu(qdot(h, lp['w_gate'], cdt))
    return qdot(gate * qdot(h, lp['w_up'], cdt), lp['w_down'], cdt)


# Stacked per-layer leaves, in the order ``_decoder_layer`` takes them.
_LAYER_KEYS = ('attn_norm', 'wq', 'wk', 'wv', 'wo', 'mlp_norm', 'w_gate',
               'w_up', 'w_down')
# Selective remat policies of the reference (``remat_layer_fn``).
_SELECTIVE_REMAT = ('dots', 'qkvo', 'kvo')


def _attention(q, k, v, cfg: LlamaConfig):
    """Causal attention by ``cfg.attn_impl`` (the reference's
    ``_attention`` without a mesh or an override): 'auto' and 'flash' run
    ``flash_attention`` — K4 forward and K5a/K5b backward for CUDA
    tensors, their plain versions for CPU tensors; 'xla' runs plain
    attention differentiated by autograd; 'ring' belongs to the
    multi-GPU layer and raises."""
    impl = cfg.attn_impl
    if impl in ('auto', 'flash'):
        return flash_attention(q, k, v, causal=True)
    if impl == 'xla':
        return reference_attention(q, k, v, causal=True)
    if impl == 'ring':
        raise NotImplementedError(
            "attn_impl='ring' (sequence-parallel ring attention) needs the "
            'multi-GPU layer, which is not ported yet (ROADMAP queue 1, '
            'item 7, multi-GPU)')
    raise ValueError(f'unknown attn_impl {impl!r}')


def _remat(remat) -> bool:
    """True for full per-layer remat (the reference's ``remat=True``),
    False for none. The selective policies raise: they must not
    quietly run as full remat."""
    if remat in _SELECTIVE_REMAT:
        raise NotImplementedError(
            f'remat={remat!r} (selective rematerialization) is not ported '
            'yet (ROADMAP queue 1, training follow-ups); use remat=True '
            '(every layer recomputed in the backward) or False')
    if isinstance(remat, str):
        raise ValueError(f'unknown remat policy {remat!r}')
    return bool(remat)


def _decoder_layer(cfg: LlamaConfig, x, cos, sin, *weights):
    """One decoder block on x [B, S, dim]; ``weights`` are the layer's
    slices of the stacked leaves, in ``_LAYER_KEYS`` order."""
    lp = dict(zip(_LAYER_KEYS, weights))
    cdt = cfg.compute_dtype
    b, s = x.shape[0], x.shape[1]
    h = _rmsnorm(x, lp['attn_norm'], cfg.norm_eps)
    q = qdot(h, lp['wq'], cdt).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = qdot(h, lp['wk'], cdt).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = qdot(h, lp['wv'], cdt).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    q, k = apply_rope(q, cos, sin), apply_rope(k, cos, sin)
    o = _attention(q, k, v, cfg)
    x = x + qdot(o.reshape(b, s, -1), lp['wo'], cdt)
    h = _rmsnorm(x, lp['mlp_norm'], cfg.norm_eps)
    return x + mlp_delta(h, lp, cdt)


def forward_hidden(params: Dict, tokens: torch.Tensor, cfg: LlamaConfig,
                   positions: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """tokens [B, S] -> final hidden states [B, S, dim].

    Attention follows ``cfg.attn_impl`` (``_attention``). With
    ``cfg.remat`` True and autograd recording, each layer runs under a
    non-reentrant ``torch.utils.checkpoint``: only its input is kept,
    and the backward reruns the layer (the flash forward included)
    before its gradient, as ``jax.checkpoint`` does."""
    remat = _remat(cfg.remat) and torch.is_grad_enabled()
    cdt = cfg.compute_dtype
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, device=tokens.device).expand(b, s)
    cos, sin = rope_tables(positions, cfg.head_dim, cfg.rope_theta)
    x = qembed(params['tok_emb'], tokens, cdt)
    # Per-layer views of the stacked leaves through one unbind each: its
    # backward stacks all layers' gradients once, where a select per
    # layer would add a full-size zero tensor per layer.
    stacked = [params['layers'][k].unbind(0) for k in _LAYER_KEYS]
    for li in range(cfg.n_layers):
        weights = [w[li] for w in stacked]
        if remat:
            x = checkpoint(_decoder_layer, cfg, x, cos, sin, *weights,
                           use_reentrant=False)
        else:
            x = _decoder_layer(cfg, x, cos, sin, *weights)
    return _rmsnorm(x, params['final_norm'], cfg.norm_eps)


def forward(params: Dict, tokens: torch.Tensor, cfg: LlamaConfig,
            positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """tokens [B, S] -> logits [B, S, vocab] f32."""
    x = forward_hidden(params, tokens, cfg, positions)
    return qdot(x, params['lm_head'], cfg.compute_dtype,
                preferred=torch.float32)


def _chunk_nll(xi, lm_head, ti, mi):
    """Summed masked NLL of one sequence chunk: xi [B, C, dim] against
    the unembedding [dim, vocab], f32 logits."""
    logits = qdot(xi, lm_head, lm_head.dtype, preferred=torch.float32)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, ti[..., None])[..., 0]
    return torch.sum(nll * mi)


def _chunked_ce(x, lm_head, targets, mask, n_chunks):
    """Cross entropy without materializing [B, S, vocab] logits: each
    chunk's logits are recomputed in the backward (a non-reentrant
    checkpoint per chunk, the reference's ``jax.checkpoint`` over its
    scan body), so peak memory is one chunk's."""
    c = x.shape[1] // n_chunks
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_chunks):
        sl = slice(i * c, (i + 1) * c)
        args = (x[:, sl], lm_head, targets[:, sl], mask[:, sl])
        if torch.is_grad_enabled():
            total = total + checkpoint(_chunk_nll, *args, use_reentrant=False)
        else:
            total = total + _chunk_nll(*args)
    return total


def split_lm_batch(batch: Dict[str, torch.Tensor]):
    """(inputs, targets) from {'tokens': [B, S+1]} or
    {'inputs'/'targets': [B, S]} (targets may use -100 = ignore)."""
    if 'inputs' in batch:
        return batch['inputs'], batch['targets']
    return batch['tokens'][:, :-1], batch['tokens'][:, 1:]


def chunked_lm_loss(x: torch.Tensor, head: torch.Tensor,
                    targets: torch.Tensor, cfg) -> torch.Tensor:
    """Masked-mean next-token cross entropy over hidden states ``x``
    with the unembedding ``head`` [dim, vocab], in ``cfg.loss_chunk``
    sequence chunks (the largest count <= S / loss_chunk that divides
    S). Negative targets (-100) are ignored."""
    mask = (targets >= 0).to(torch.float32)
    targets = torch.clamp(targets, min=0).to(torch.int64)
    s = x.shape[1]
    n_chunks = max(1, s // max(1, cfg.loss_chunk))
    while s % n_chunks:
        n_chunks -= 1
    total = _chunked_ce(x, head, targets, mask, n_chunks)
    return total / torch.clamp(torch.sum(mask), min=1.0)


def loss_fn(params: Dict, batch: Dict[str, torch.Tensor],
            cfg: LlamaConfig) -> torch.Tensor:
    """Next-token cross entropy (see ``split_lm_batch`` for the batch
    forms); a scalar f32 tensor."""
    inputs, targets = split_lm_batch(batch)
    x = forward_hidden(params, inputs, cfg)
    return chunked_lm_loss(x, params['lm_head'].to(cfg.compute_dtype),
                           targets, cfg)


def num_params(cfg: LlamaConfig) -> int:
    """Parameter count of ``init_params(cfg)``, from the shapes."""
    hd, nl = cfg.head_dim, cfg.n_layers
    per_layer = (2 * cfg.dim + cfg.dim * cfg.n_heads * hd +
                 2 * cfg.dim * cfg.n_kv_heads * hd +
                 cfg.n_heads * hd * cfg.dim + 3 * cfg.dim * cfg.ffn_dim)
    return 2 * cfg.vocab_size * cfg.dim + cfg.dim + nl * per_layer
