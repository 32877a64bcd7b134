"""K4, K5a and K5b, causal flash attention forward and backward
(``ops/flash_attention.py``): what one training step's attention needs.

Forward: 4 head_dim operations a query-key pair over every query head,
S (S + 1) / 2 pairs a sequence under the causal mask. Backward: 2.5
times the forward (dV, dP, dS -> dQ and dK, and the recompute of the
scores that the flash backward needs by design). The forward that remat
runs again is not counted: these inputs do not need it. Bytes: q, k, v,
o and the log-sum-exp written and read once forward; q, k, v, o, dO and
the log-sum-exp read and dQ, dK, dV written once backward (bf16)."""
from portbench.core.model import dims
from portbench.core.peaks import BF16_FLOPS, HBM_BYTES_PER_S


def step_bound_s(config, batch: int, seq: int) -> float:
    c = dims(config)
    hd, h, kv = c['head_dim'], c['heads'], c['kv_heads']
    pairs = batch * seq * (seq + 1) // 2
    fwd_ops = 4 * h * hd * pairs
    q = o = batch * seq * h * hd * 2
    k = v = batch * seq * kv * hd * 2
    lse = batch * seq * h * 4
    fwd_bytes = q + k + v + o + lse
    bwd_bytes = q + k + v + o + o + lse + q + k + v
    per_layer = max((fwd_bytes + bwd_bytes) / HBM_BYTES_PER_S,
                    3.5 * fwd_ops / BF16_FLOPS)
    return c['layers'] * per_layer
