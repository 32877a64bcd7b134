"""Plain PyTorch training steps of the dense Mistral decoder: next-token
cross entropy, gradients by autograd, and optax's ``adafactor(lr)`` at
its defaults, written out.

The configuration trains in bfloat16: parameters are stored in bf16,
each update is computed in float32 and the parameter rounded to bf16
once. Here the forward and backward run in float32 (each bf16 weight
upcast inside its layer, TF32 off), every layer under activation
checkpointing so the float32 activations fit, and the gradient reaches
each bf16 leaf rounded once. ``precision='fp8'`` is the control: every
matmul weight (per output channel) and input (per row) rounded to
float8 e4m3 in the forward, straight through in the backward.
"""
from __future__ import annotations

from typing import Any, Dict, List

import torch
from torch.utils.checkpoint import checkpoint

from portbench.reference.model import fp8_round, rms_norm, rope

DECAY = 0.8
EPS = 1e-30
CLIP = 1.0
MIN_SCALE = 1e-3
ROWS = 512
LOSS_ROWS = 1024


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x + (fp8_round(x.detach(), dim) - x.detach())


class Decoder:
    def __init__(self, config: Dict[str, Any], precision: str = 'f32'):
        if 'num_local_experts' in config:
            raise NotImplementedError('the training reference is dense')
        d = config['hidden_size']
        self.heads = config['num_attention_heads']
        self.kv_heads = config['num_key_value_heads']
        self.head_dim = config.get('head_dim') or d // self.heads
        self.theta = float(config['rope_theta'])
        self.eps = float(config['rms_norm_eps'])
        self.fp8 = precision == 'fp8'
        if precision not in ('f32', 'fp8'):
            raise ValueError(f'unknown precision {precision!r}')

    def mm(self, x, w):
        w = w.float()
        if self.fp8:
            x, w = _fp8(x, -1), _fp8(w, -2)
        return x @ w

    def attention(self, q, k, v):
        """Causal attention of q [B, H, S, D] over k, v [B, H, S, D] in
        blocks of query rows."""
        s = q.shape[2]
        cols = torch.arange(s, device=q.device)
        outs = []
        for r0 in range(0, s, ROWS):
            r1 = min(s, r0 + ROWS)
            scores = q[:, :, r0:r1] @ k[:, :, :r1].transpose(-1, -2)
            scores = scores * self.head_dim**-0.5
            mask = cols[None, :r1] > cols[r0:r1, None]
            scores = scores.masked_fill(mask, float('-inf'))
            outs.append(torch.softmax(scores, dim=-1) @ v[:, :, :r1])
        return torch.cat(outs, dim=2)

    def layer(self, x, positions, attn_norm, wq, wk, wv, wo, mlp_norm,
              w_gate, w_up, w_down):
        b, s, _ = x.shape
        hd = self.head_dim
        h = rms_norm(x, attn_norm.float(), self.eps)
        q = self.mm(h, wq).view(b * s, self.heads, hd)
        k = self.mm(h, wk).view(b * s, self.kv_heads, hd)
        v = self.mm(h, wv).view(b, s, self.kv_heads, hd)
        pos = positions.repeat(b)
        q = rope(q, pos, self.theta).view(b, s, self.heads, hd)
        k = rope(k, pos, self.theta).view(b, s, self.kv_heads, hd)
        rep = self.heads // self.kv_heads
        q, k, v = (t.transpose(1, 2) for t in (q, k, v))
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
        o = self.attention(q, k, v).transpose(1, 2).reshape(b, s, -1)
        x = x + self.mm(o, wo)
        h = rms_norm(x, mlp_norm.float(), self.eps)
        gate = torch.nn.functional.silu(self.mm(h, w_gate))
        return x + self.mm(gate * self.mm(h, w_up), w_down)

    def loss(self, params: Dict[str, Any], tokens: torch.Tensor
             ) -> torch.Tensor:
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        b, s = inputs.shape
        positions = torch.arange(s, device=tokens.device)
        x = params['tok_emb'].float()[inputs]
        lp = params['layers']
        keys = ('attn_norm', 'wq', 'wk', 'wv', 'wo', 'mlp_norm', 'w_gate',
                'w_up', 'w_down')
        for li in range(lp['wq'].shape[0]):
            x = checkpoint(self.layer, x, positions,
                           *(lp[k][li] for k in keys), use_reentrant=False)
        x = rms_norm(x, params['final_norm'].float(), self.eps)
        total = torch.zeros((), device=tokens.device)
        flat_x, flat_t = x.reshape(b * s, -1), targets.reshape(-1)
        for r0 in range(0, b * s, LOSS_ROWS):
            total = total + checkpoint(
                self._nll, flat_x[r0:r0 + LOSS_ROWS], params['lm_head'],
                flat_t[r0:r0 + LOSS_ROWS], use_reentrant=False)
        return total / (b * s)

    def _nll(self, x, head, t):
        logits = self.mm(x, head)
        return torch.nn.functional.cross_entropy(logits, t, reduction='sum')


def flat(tree: Dict[str, Any]) -> List[tuple]:
    out = []
    for k, v in tree.items():
        if isinstance(v, dict):
            out += [((k,) + p, t) for p, t in flat(v)]
        else:
            out.append(((k,), v))
    return out


def factored_dims(shape):
    """optax's rule: the axes of the second-largest and largest sizes,
    when a tensor has two axes or more and the second-largest is 128 or
    more; else None."""
    if len(shape) < 2:
        return None
    order = sorted(range(len(shape)), key=lambda i: shape[i])
    if shape[order[-2]] < 128:
        return None
    return order[-2], order[-1]


class Adafactor:
    """optax.adafactor(lr): factored second moments (decay exponent 0.8,
    eps 1e-30), the update clipped to block rms 1, times lr and the
    parameter's block rms (floor 1e-3), subtracted. Float32 state."""

    def __init__(self, lr: float):
        self.lr = lr
        self.count = 0
        self.state: Dict[tuple, Dict[str, torch.Tensor]] = {}

    @torch.no_grad()
    def update(self, path, p: torch.Tensor, g: torch.Tensor) -> None:
        """One leaf's update. A stacked leaf whose factored axes leave
        out its layer axis is worked one layer slice at a time (its
        statistics are per slice; the two block rms are summed over all
        slices first), so the float32 transients are one slice's."""
        beta = 1.0 - (self.count + 1) ** -DECAY
        dims = factored_dims(p.shape)
        st = self.state.setdefault(path, {})
        sliced = p.dim() == 3 and dims is not None and 0 not in dims
        parts = range(p.shape[0]) if sliced else [None]
        sub = (None if dims is None else
               (dims[0] - 1, dims[1] - 1) if sliced else dims)

        def view(t, i):
            return t if i is None else t[i]

        def direction(i):
            gi = view(g, i).float()
            g_sq = gi * gi + EPS
            if sub is None:
                v = beta * st.get('v', 0.0) + (1 - beta) * g_sq
                return gi * v.rsqrt(), {'v': v}
            d1, d0 = sub
            key = 'all' if i is None else i
            old = st.get(key, {'row': 0.0, 'col': 0.0})
            row = beta * old['row'] + (1 - beta) * g_sq.mean(d0)
            col = beta * old['col'] + (1 - beta) * g_sq.mean(d1)
            red = d1 - 1 if d1 > d0 else d1
            row_f = (row / row.mean(red, keepdim=True)).rsqrt()
            u = gi * row_f.unsqueeze(d0) * col.rsqrt().unsqueeze(d1)
            return u, {key: {'row': row, 'col': col}}

        u_sq = p_sq = 0.0
        new_state = {}
        for i in parts:
            u, upd = direction(i)
            new_state.update(upd)
            u_sq += float(u.double().pow(2).sum())
            p_sq += float(view(p, i).double().pow(2).sum())
        n = p.numel()
        clip = max(1.0, (u_sq / n) ** 0.5 / CLIP)
        scale = max((p_sq / n) ** 0.5, MIN_SCALE)
        for i in parts:
            u, _ = direction(i)
            pi = view(p, i)
            pi.copy_(pi.float() - (self.lr * scale / clip) * u)
        st.update(new_state)

    def step(self, params, grads) -> None:
        for (path, p), g in zip(flat(params), grads):
            self.update(path, p, g)
        self.count += 1


def train(config: Dict[str, Any], params: Dict[str, Any], batches,
          lr: float, precision: str = 'f32') -> Dict[str, Any]:
    """Run ``len(batches)`` steps on ``params`` (bf16 leaves, updated in
    place). Returns each step's loss and, from the first step, each
    leaf's gradient norm by key path."""
    model = Decoder(config, precision)
    opt = Adafactor(lr)
    leaves = [t for _, t in flat(params)]
    losses, grad_norms = [], {}
    for i, batch in enumerate(batches):
        for t in leaves:
            t.requires_grad_(True)
        loss = model.loss(params, batch)
        grads = torch.autograd.grad(loss, leaves)
        for t in leaves:
            t.requires_grad_(False)
        grads = [g.to(t.dtype) for g, t in zip(grads, leaves)]
        losses.append(float(loss.detach()))
        if i == 0:
            grad_norms = {p: float(g.float().norm())
                          for (p, _), g in zip(flat(params), grads)}
        opt.step(params, grads)
        del grads, loss
    return {'losses': losses, 'grad_norms': grad_norms}
