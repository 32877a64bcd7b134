"""Q1, the int8 weight-only product (``ops/int8_matmul.py``): bytes and
operations of each call a served forward makes, and its least time.

A call x [M, K] (bf16) by q [K, N] (int8) with per-channel scales [N]
(f32) reads K N + 4 N + 2 M K bytes and writes 2 M N (4 M N for the f32
head) once each, and needs 2 M K N operations. A forward makes, in every
layer, the four attention products at M rows and the expert products:
every expert's three matrices are read, the operations are those of the
rows routed to each (M times top_k rows in all); and the head at its
own rows. The least time of a call is the larger of its bytes over the
HBM rate and its operations over the bf16 peak; the experts of a layer
are taken as one group."""
from portbench.core.model import dims
from portbench.core.peaks import BF16_FLOPS, HBM_BYTES_PER_S


def call_s(m: int, k: int, n: int, out_bytes: int = 2) -> float:
    nbytes = k * n + 4 * n + 2 * m * k + out_bytes * m * n
    return max(nbytes / HBM_BYTES_PER_S, 2 * m * k * n / BF16_FLOPS)


def forward_s(config, m: int, head_rows: int) -> float:
    """The least Q1 time of one forward over ``m`` rows whose head runs
    on ``head_rows`` rows."""
    c = dims(config)
    d, hd, f = c['d'], c['head_dim'], c['ffn']
    attn = (call_s(m, d, c['heads'] * hd) + 2 * call_s(m, d, c['kv_heads'] * hd)
            + call_s(m, c['heads'] * hd, d))
    e, k = max(c['experts'], 1), max(c['top_k'], 1)
    w_bytes = e * 3 * (d * f + 4 * f)
    x_bytes = 2 * m * d * 2 + 2 * m * k * f * 3 + 2 * m * k * d
    ops = 2 * m * k * 3 * d * f
    mlp = max((w_bytes + x_bytes) / HBM_BYTES_PER_S, ops / BF16_FLOPS)
    head = call_s(head_rows, d, c['vocab'], 4) if head_rows else 0.0
    return c['layers'] * (attn + mlp) + head


def bound_s(config, tick_log) -> float:
    """The least Q1 time of the ticks of ``tick_log``: each decode step a
    forward over its live rows, each prefill a forward over its prompt
    tokens with the head on its chunks."""
    total = 0.0
    for n, rows, _, tokens, chunks, _ in tick_log:
        if n and rows:
            total += n * forward_s(config, rows, rows)
        if tokens:
            total += forward_s(config, tokens, chunks)
    return total
