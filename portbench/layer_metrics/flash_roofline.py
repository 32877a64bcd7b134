"""K4, K5a and K5b's share (%) of their roofline in the profiled slice:
the least time of each step's causal attention forward and backward
(``counts/flash.py``) over the device time of the kernels named
flash_fwd, flash_dq and flash_dkv."""
from portbench.core import spec


def read(rec):
    s = rec.get('slice')
    if rec.get('kind') != 'train' or not s:
        return None
    busy = sum(v[0] for k, v in s['kernels'].items()
               if 'flash_fwd' in k or 'flash_dq' in k or 'flash_dkv' in k)
    if not busy:
        return None
    t = rec['cell'].traffic
    bound = spec.count(rec['root'], 'flash').step_bound_s(
        rec['cell'].config, int(t['batch']), int(t['seq']))
    return 100.0 * bound * s['steps'] / busy
