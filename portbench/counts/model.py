"""Model operations: what a served token and a trained token need.

Products count 2 operations a multiply-add; attention counts QK^T and PV
(4 head_dim operations a query-key pair over every query head); an
embedding lookup counts none."""
from portbench.core.model import dims


def body_params(config) -> int:
    """Matmul parameters one token passes through below the head: the
    attention projections, and the MLP (for MoE the router and top_k
    experts)."""
    m = dims(config)
    d, hd = m['d'], m['head_dim']
    attn = d * hd * (2 * m['heads'] + 2 * m['kv_heads'])
    mlp = 3 * d * m['ffn']
    if m['experts']:
        mlp = m['top_k'] * mlp + d * m['experts']
    return m['layers'] * (attn + mlp)


def head_params(config) -> int:
    m = dims(config)
    return m['d'] * m['vocab']


def attention_ops(config, pairs: int) -> int:
    """Operations of ``pairs`` query-key pairs (summed over positions)
    in every layer."""
    m = dims(config)
    return 4 * m['layers'] * m['heads'] * m['head_dim'] * pairs


def serve_ops(config, tick_log) -> int:
    """Operations the ticks of ``tick_log`` need (the serving driver's
    records: (steps, rows, keys, prompt tokens, chunks, prompt keys)):
    every live row of every decode step and every prompt token through
    the body, the head for each decode row and each chunk's sampled
    position, attention over the keys each attends."""
    rows = sum(t[0] * t[1] for t in tick_log)
    tokens = sum(t[3] for t in tick_log)
    chunks = sum(t[4] for t in tick_log)
    pairs = sum(t[2] + t[5] for t in tick_log)
    return (2 * body_params(config) * (rows + tokens) +
            2 * head_params(config) * (rows + chunks) +
            attention_ops(config, pairs))


def train_ops_per_token(config, seq: int) -> int:
    """Training operations a token needs, remat not counted: 6 N (the
    products forward and backward; N the matmul parameters a token
    passes, embedding table left out) plus causal attention's 6 L S d."""
    m = dims(config)
    n = body_params(config) + head_params(config)
    return 6 * n + 6 * m['layers'] * seq * m['d']
