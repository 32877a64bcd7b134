"""The operations the profiled slice's training tokens need (6 N + 6 L S
d a token, ``counts/model.py``) over the slice's time at the bf16 peak,
in %."""
from portbench.core import spec
from portbench.core.peaks import BF16_FLOPS


def read(rec):
    s = rec.get('slice')
    if rec.get('kind') != 'train' or not s:
        return None
    cell = rec['cell']
    per_token = spec.count(rec['root'], 'model').train_ops_per_token(
        cell.config, int(cell.traffic['seq']))
    return 100.0 * per_token * s['steps'] * s['tokens'] / (
        s['window_s'] * BF16_FLOPS)
