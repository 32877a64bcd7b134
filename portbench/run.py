"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Exits 2 with no result where PyTorch sees no CUDA card, or fewer than
the cell asks for; exits 3 with no result where ``jax``, ``jaxlib``,
``flax`` or the JAX package is loaded once the window has closed. The
last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``compared``: each number ``correct`` compared,
beside its limit); the last lines of standard error repeat the
compared numbers."""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict

from portbench.core import env
from portbench.core.result import log as _log

_T_START = env.process_start_time()


def _parse(argv):
    p = argparse.ArgumentParser(prog='python3 -m portbench.run')
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def execute(root: str, workload: str, seed: int, seconds: float,
            trace: bool, device, t_start: float) -> Dict[str, Any]:
    """Build, warm up, measure and check one cell on ``device``; returns
    the result line as a dict, ``compared`` last."""
    import torch

    from portbench.core import spec
    cell = spec.load_cell(root, workload)
    torch.manual_seed(seed % (1 << 63))
    out = cell.kind.run(torch, cell, seed, seconds, trace, device, t_start)
    compared = out.pop('compared')
    out = {'correct': out['correct'], 'attempted': out['attempted'],
           'failed': out['failed'], 'metrics': out['metrics'],
           'device': out['device'], **({'breakdown': out['breakdown']}
                                       if 'breakdown' in out else {}),
           'compared': compared}
    return out


def main(argv=None) -> int:
    args = _parse(argv)
    root = env.checkout_root()
    env.set_cache_dirs(root)
    from portbench.core import spec
    cell = spec.load_cell(root, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        _log(f'no result: the cell needs {cell.chips} CUDA card(s); torch '
             f'sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}')
        return 2
    device = torch.device('cuda', 0)
    out = execute(root, args.workload, args.seed, args.seconds,
                  bool(args.trace), device, _T_START)
    found = env.forbidden_loaded()
    if found:
        _log('no result: the process holds ' + ', '.join(found))
        return 3
    for name, c in out['compared'].items():
        _log(f"compared {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
