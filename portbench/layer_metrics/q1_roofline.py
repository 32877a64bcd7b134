"""Q1's share (%) of its roofline in the profiled slice: the least time
of every Q1 call the slice's ticks make (``counts/q1.py``) over the
device time of the kernels named int8_matmul."""
from portbench.core import spec


def read(rec):
    s = rec.get('slice')
    if rec.get('kind') != 'serve' or not s:
        return None
    busy = sum(v[0] for k, v in s['kernels'].items() if 'int8_matmul' in k)
    if not busy:
        return None
    bound = spec.count(rec['root'], 'q1').bound_s(rec['cell'].config,
                                                  s['tick_log'])
    return 100.0 * bound / busy
