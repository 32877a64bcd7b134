"""The model operations the window's ticks need (``counts/model.py``,
from the traced run's tick log) over the window's time at the bf16 peak,
in %. Taken over the whole window, not the profiled slice: the engine's
occupancy swings as its shared decode region fills and drains."""
from portbench.core import spec
from portbench.core.peaks import BF16_FLOPS


def read(rec):
    log = rec.get('tick_log')
    if rec.get('kind') != 'serve' or not log:
        return None
    ops = spec.count(rec['root'], 'model').serve_ops(rec['cell'].config, log)
    return 100.0 * ops / (rec['window_s'] * BF16_FLOPS)
