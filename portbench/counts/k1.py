"""K1, paged decode attention (``ops/decode_attention.py``,
``csrc/paged_decode.cu``): bytes a decode step's attention needs.

Each live row reads the keys and values it attends (its prompt and the
tokens decoded so far, its own included) once, in the cache's dtype, and
reads its queries and writes its output once (bf16), in every layer.
Operations (4 head_dim a query-key pair) are far below the byte bound's
time at these shapes and are counted too."""
from portbench.core.model import dims
from portbench.core.peaks import BF16_FLOPS, HBM_BYTES_PER_S


def bound_s(config, tick_log, kv_bytes: int = 2) -> float:
    c = dims(config)
    per_key = 2 * c['kv_heads'] * c['head_dim'] * kv_bytes
    per_row = 2 * c['heads'] * c['head_dim'] * 2
    keys = sum(t[2] for t in tick_log)
    rows = sum(t[0] * t[1] for t in tick_log)
    nbytes = c['layers'] * (keys * per_key + rows * per_row)
    ops = 4 * c['layers'] * c['heads'] * c['head_dim'] * keys
    return max(nbytes / HBM_BYTES_PER_S, ops / BF16_FLOPS)
