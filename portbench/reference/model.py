"""The published Mistral / Mixtral decoder in plain PyTorch, float32.

Pre-norm decoder layers: RMSNorm; grouped-query causal attention with
split-half rotary embeddings (theta from the configuration) at positions
0..S-1; SwiGLU MLP, or for Mixtral a router whose softmax's top-k
experts (ties to the lower index) are mixed with their renormalised
weights; final RMSNorm and an untied head. Sequences run one at a time
through one layer at a time, so only one layer's float32 weights exist at
once; attention runs in blocks of query rows.

``precision`` selects the control, the same model one step below the
configuration's precision: 'int4' requantizes the int8 weights per
channel to 4 bits; 'fp8' rounds every matmul weight (per output channel)
and every matmul input (per row) to float8 e4m3. 'bf16' (a witness, not
a control) rounds every matmul input to bfloat16, the configurations'
compute precision. Float32 products run without TF32.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

NORMS = ('attn_norm', 'mlp_norm', 'final_norm')
EXPERT_KEYS = ('w_gate', 'w_up', 'w_down')
FP8_MAX = 448.0
ATTN_ROWS = 512


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale per slice along ``dim``
    (the amax maps to the format's largest finite value)."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def int_round(x: torch.Tensor, dim: int, levels: int) -> torch.Tensor:
    """x on a symmetric grid of ``levels`` steps either side of zero,
    one scale per slice along ``dim`` (per output channel)."""
    scale = (x.abs().amax(dim=dim, keepdim=True) / levels).clamp(min=1e-12)
    return torch.round(x / scale).clamp(-levels, levels) * scale


def dense(w: Any, axis: int = -2) -> torch.Tensor:
    """A leaf as float32: an int8 {'q', 's'} leaf dequantized (its
    scales are per slice along ``axis``' complement)."""
    if isinstance(w, dict):
        return w['q'].to(torch.float32) * w['s'].unsqueeze(axis).to(
            torch.float32)
    return w.to(torch.float32)


class Weights:
    """Float32 views of the benchmark's weight tree, one layer at a time,
    rounded to the control's precision where one is asked for."""

    def __init__(self, tree: Dict[str, Any], precision: str = 'f32'):
        if precision not in ('f32', 'int4', 'fp8', 'bf16'):
            raise ValueError(f'unknown precision {precision!r}')
        self.tree = tree
        self.precision = precision

    def _round(self, key: str, w: torch.Tensor, raw: Any) -> torch.Tensor:
        if self.precision == 'int4' and isinstance(raw, dict):
            return int_round(w, -1 if key == 'tok_emb' else -2, 7)
        if self.precision == 'fp8' and key not in NORMS + (
                'router', 'tok_emb'):
            return fp8_round(w, -2)
        return w

    def leaf(self, key: str, raw: Any) -> torch.Tensor:
        axis = -1 if key == 'tok_emb' else -2
        return self._round(key, dense(raw, axis), raw)

    def _raw(self, key: str, li: int, e: Optional[int] = None) -> Any:
        v = self.tree['layers'][key]
        if isinstance(v, dict):
            if e is None:
                return {'q': v['q'][li], 's': v['s'][li]}
            return {'q': v['q'][li, e], 's': v['s'][li, e]}
        return v[li] if e is None else v[li, e]

    def layer(self, li: int) -> Dict[str, torch.Tensor]:
        """Layer ``li``'s weights but the expert banks."""
        return {k: self.leaf(k, self._raw(k, li))
                for k in self.tree['layers'] if k not in EXPERT_KEYS or
                'router' not in self.tree['layers']}

    def expert(self, li: int, e: int) -> Tuple[torch.Tensor, ...]:
        """Expert ``e`` of layer ``li``: (w_gate, w_up, w_down)."""
        return tuple(self.leaf(k, self._raw(k, li, e)) for k in EXPERT_KEYS)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        emb = self.tree['tok_emb']
        if isinstance(emb, dict):
            raw = {'q': emb['q'][tokens], 's': emb['s'][tokens]}
            return self._round('tok_emb', dense(raw, -1), raw)
        return emb[tokens].to(torch.float32)


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x [S, H, D] rotated by split halves at ``positions`` [S]."""
    d = x.shape[-1]
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float64,
                                  device=x.device) / d)
    ang = positions.to(torch.float64)[:, None] * inv
    cos = torch.cos(ang).to(torch.float32)[:, None, :]
    sin = torch.sin(ang).to(torch.float32)[:, None, :]
    x1, x2 = x[..., :d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


class Model:
    """The decoder of a configuration file over a weight tree."""

    def __init__(self, config: Dict[str, Any], tree: Dict[str, Any],
                 precision: str = 'f32'):
        d = config['hidden_size']
        self.heads = config['num_attention_heads']
        self.kv_heads = config['num_key_value_heads']
        self.head_dim = config.get('head_dim') or d // self.heads
        self.theta = float(config['rope_theta'])
        self.eps = float(config['rms_norm_eps'])
        self.layers = config['num_hidden_layers']
        self.top_k = config.get('num_experts_per_tok', 0)
        self.w = Weights(tree, precision)
        self.precision = precision

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.precision == 'fp8':
            x = fp8_round(x, -1)
        elif self.precision == 'bf16':
            x = x.to(torch.bfloat16).to(torch.float32)
        return x @ w

    def attention(self, h: torch.Tensor, lw: Dict[str, torch.Tensor],
                  positions: torch.Tensor) -> torch.Tensor:
        s, hd = h.shape[0], self.head_dim
        q = rope(self.mm(h, lw['wq']).view(s, self.heads, hd), positions,
                 self.theta)
        k = rope(self.mm(h, lw['wk']).view(s, self.kv_heads, hd), positions,
                 self.theta)
        v = self.mm(h, lw['wv']).view(s, self.kv_heads, hd)
        rep = self.heads // self.kv_heads
        k = k.repeat_interleave(rep, dim=1).transpose(0, 1)   # [H, S, D]
        v = v.repeat_interleave(rep, dim=1).transpose(0, 1)
        q = q.transpose(0, 1)
        out = torch.empty_like(q)
        cols = torch.arange(s, device=h.device)
        for r0 in range(0, s, ATTN_ROWS):
            r1 = min(s, r0 + ATTN_ROWS)
            scores = q[:, r0:r1] @ k[:, :r1].transpose(1, 2) * hd**-0.5
            mask = cols[None, :r1] > cols[r0:r1, None]
            scores = scores.masked_fill(mask, float('-inf'))
            out[:, r0:r1] = torch.softmax(scores, dim=-1) @ v[:, :r1]
        return self.mm(out.transpose(0, 1).reshape(s, -1), lw['wo'])

    def swiglu(self, h, gate, up, down):
        return self.mm(torch.nn.functional.silu(self.mm(h, gate)) *
                       self.mm(h, up), down)

    def mlp(self, h: torch.Tensor, lw: Dict[str, torch.Tensor], li: int
            ) -> torch.Tensor:
        if 'router' not in lw:
            return self.swiglu(h, lw['w_gate'], lw['w_up'], lw['w_down'])
        probs = torch.softmax(self.mm(h, lw['router']), dim=-1)
        vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        vals, idx = vals[:, :self.top_k], idx[:, :self.top_k]
        vals = vals / vals.sum(-1, keepdim=True)
        out = torch.zeros_like(h)
        for e in range(lw['router'].shape[-1]):
            rows, slot = torch.nonzero(idx == e, as_tuple=True)
            if rows.numel():
                y = self.swiglu(h[rows], *self.w.expert(li, e))
                out.index_add_(0, rows, vals[rows, slot, None] * y)
        return out

    def layer(self, xs: List[torch.Tensor], li: int,
              positions: List[torch.Tensor]) -> List[torch.Tensor]:
        """Layer ``li`` over every sequence: attention one sequence at a
        time, the MLP over all their rows at once."""
        lw = self.w.layer(li)
        xs = [x + self.attention(rms_norm(x, lw['attn_norm'], self.eps), lw,
                                 p) for x, p in zip(xs, positions)]
        cat = torch.cat(xs)
        cat = cat + self.mlp(rms_norm(cat, lw['mlp_norm'], self.eps), lw, li)
        return list(torch.split(cat, [x.shape[0] for x in xs]))

    @torch.no_grad()
    def logits(self, seqs: Sequence[Sequence[int]],
               want: Sequence[Sequence[int]], device
               ) -> List[torch.Tensor]:
        """For each token sequence, the float32 logits [len(want[i]),
        vocab] at the positions ``want[i]`` (each predicting the token
        after it)."""
        xs = [self.w.embed(torch.as_tensor(list(s), device=device))
              for s in seqs]
        pos = [torch.arange(len(s), device=device) for s in seqs]
        for li in range(self.layers):
            xs = self.layer(xs, li, pos)
        final = self.w.leaf('final_norm', self.w.tree['final_norm'])
        head = self.w.leaf('lm_head', self.w.tree['lm_head'])
        out = []
        for x, rows in zip(xs, want):
            h = rms_norm(x[torch.as_tensor(list(rows), device=device)],
                         final, self.eps)
            out.append(self.mm(h, head))
        return out


def gaps(model: Model, seqs: Sequence[Sequence[int]],
         starts: Sequence[int], device, control: Optional[Model] = None
         ) -> torch.Tensor:
    """For every served token, the gap by which its reference logit lies
    below the reference's best at its position (a flat float32 tensor).
    ``seqs[i]`` is prompt + served tokens, the served ones from
    ``starts[i]`` on. With ``control``, the token judged at each position
    is the one the control puts first, not the served one."""
    want = [range(st - 1, len(s) - 1) for s, st in zip(seqs, starts)]
    ref = model.logits(seqs, want, device)
    picks = None
    if control is not None:
        picks = [z.argmax(-1) for z in control.logits(seqs, want, device)]
    out = []
    for i, (z, s, st) in enumerate(zip(ref, seqs, starts)):
        tok = (picks[i] if picks is not None else
               torch.as_tensor(list(s[st:]), device=device))
        out.append(z.max(-1).values - z.gather(1, tok[:, None])[:, 0])
    return torch.cat(out)
