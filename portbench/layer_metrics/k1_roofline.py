"""K1's share (%) of its roofline in the profiled slice: the live K/V
bytes every decode step's rows attend (``counts/k1.py``) over the HBM
rate, over the device time of the kernels named paged_decode."""
from portbench.core import spec


def read(rec):
    s = rec.get('slice')
    if rec.get('kind') != 'serve' or not s:
        return None
    busy = sum(v[0] for k, v in s['kernels'].items() if 'paged_decode' in k)
    if not busy:
        return None
    kv = 1 if rec['engine']['kv_dtype'] == 'int8' else 2
    bound = spec.count(rec['root'], 'k1').bound_s(rec['cell'].config,
                                                  s['tick_log'], kv)
    return 100.0 * bound / busy
