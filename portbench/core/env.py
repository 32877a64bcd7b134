"""Process environment: where caches live, the set-up clock's origin,
the import guard and the device line of a result."""
from __future__ import annotations

import os
import sys
import time
from typing import Dict, List

# Top-level module names a run may not hold once its window has closed:
# the JAX stack and the JAX package the port was made from. Compared as
# whole names, so 'skypilot_tpu_torch' is not 'skypilot_tpu'.
FORBIDDEN_MODULES = ('jax', 'jaxlib', 'flax', 'skypilot_tpu')

# Cache directories, relative to the checkout: fixed paths, so a second
# run of a cell in the same checkout finds what the first one built.
CACHE_DIRS = {
    'TORCH_EXTENSIONS_DIR': '.portbench_cache/torch_extensions',
    'TRITON_CACHE_DIR': '.portbench_cache/triton',
}


def checkout_root() -> str:
    """The directory that holds ``BENCHMARK.json`` and ``portbench/``."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def process_start_time() -> float:
    """The wall-clock time (``time.time()``) at which this process
    started, from ``/proc``; where that cannot be read, now."""
    try:
        with open('/proc/self/stat', encoding='ascii') as f:
            fields = f.read().rsplit(')', 1)[1].split()
        start_ticks = int(fields[19])
        with open('/proc/stat', encoding='ascii') as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith('btime'))
        return btime + start_ticks / os.sysconf('SC_CLK_TCK')
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def set_cache_dirs(root: str) -> None:
    """Point every build and kernel cache the program may use into the
    checkout, and keep ``transformers`` (if anything loads it) off JAX.
    The port's own kernels build into ``skypilot_tpu_torch/ops/
    _kernels_build`` inside the checkout already."""
    for var, rel in CACHE_DIRS.items():
        path = os.path.join(root, rel)
        os.makedirs(path, exist_ok=True)
        os.environ[var] = path
    os.environ['USE_FLAX'] = '0'
    os.environ['USE_JAX'] = '0'


def forbidden_loaded(modules=None) -> List[str]:
    """The forbidden top-level names present in ``sys.modules``."""
    names = {m.split('.', 1)[0] for m in (modules or sys.modules)}
    return sorted(n for n in names if n in FORBIDDEN_MODULES)


def device_line(torch, count: int) -> Dict:
    """The result's ``device`` entry: the card's name, the cards used and
    the peak of the fullest one."""
    peak = max(torch.cuda.max_memory_allocated(i) for i in range(count))
    return {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
            'count': count, 'memory_peak_bytes': int(peak)}
