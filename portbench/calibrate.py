"""Readings the limits of ``correct`` are set from, many seeds in one
process (a run's set-up is long; these readings need no measured rate).

    python3 -m portbench.calibrate --workload <name> --seeds a,b,... \
        [--control-seeds c,...] [--fault-seeds f,...] [--seconds <s>]

The cell's traffic kind does the work (``calibrate`` in
``portbench/traffic_kinds/<kind>.py``): serving kinds serve a window of
``--seconds`` at the cell's own load for each seed and print the
program's gaps, a control seed also the control's (the reference one
step below the configuration's precision, on the same sample) and a
witness's (the reference with every matmul input rounded to bf16), each
with its verdict under the cell's limits; training kinds print the
program's numbers against the reference, with the control's and a
half-batch fault's on their seeds. One JSON line per seed on standard
output."""
from __future__ import annotations

import argparse
import sys

from portbench.core import env


def _seeds(text):
    return [int(s) for s in text.split(',') if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog='python3 -m portbench.calibrate')
    p.add_argument('--workload', required=True)
    p.add_argument('--seeds', type=_seeds, required=True)
    p.add_argument('--control-seeds', type=_seeds, default=[])
    p.add_argument('--fault-seeds', type=_seeds, default=[])
    p.add_argument('--seconds', type=float, default=30.0)
    args = p.parse_args(argv)
    root = env.checkout_root()
    env.set_cache_dirs(root)
    from portbench.core import spec
    cell = spec.load_cell(root, args.workload)
    import torch
    if not torch.cuda.is_available():
        print('no CUDA card', file=sys.stderr)
        return 2
    device = torch.device('cuda', 0)
    cell.kind.calibrate(torch, cell, args, device)
    return 0


if __name__ == '__main__':
    sys.exit(main())
