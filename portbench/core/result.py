"""A run's result line: its ``device`` entry and its metrics."""
from __future__ import annotations

import sys
from typing import Any, Dict

from portbench.core import env, spec


def readings(torch, cell, device, rec, trace: bool) -> Dict[str, Any]:
    """The result's ``device``, ``metrics`` (end-to-end untraced,
    per-layer traced) and, traced, ``breakdown``."""
    out = {'device': _device(torch, cell, device, rec if trace else None),
           'metrics': spec.read_metrics(
               cell, cell.per_layer if trace else cell.end_to_end,
               'layer_metrics' if trace else 'end_to_end', rec)}
    if trace and 'slice' in rec:
        out['breakdown'] = {k: rec['slice'][k]
                            for k in ('device_ops', 'idle_gaps')}
    return out


def _device(torch, cell, device, rec) -> Dict[str, Any]:
    if device.type == 'cuda':
        line = env.device_line(torch, cell.chips)
    else:
        line = {'platform': 'cpu', 'kind': 'cpu', 'count': 1,
                'memory_peak_bytes': 0}
    if rec is not None and 'slice' in rec:
        line['busy_s'] = rec['slice']['busy_s']
        line['window_s'] = rec['slice']['window_s']
    return line


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)
