"""Find a cell and everything it names, by name, under a checkout.

``BENCHMARK.json`` lists configurations, cells and metrics. Each piece
they name is a file of its own under ``portbench/``:

- ``configs/<config>.json``: the model, its weights' precision and the
  engine or training settings (the path is the config entry's ``file``);
- ``traffic/<traffic>.json``: a mix's parameters; its ``kind`` names
  ``traffic_kinds/<kind>.py``, which holds that kind's generator, its
  driver (``run``) and its calibration (``calibrate``);
- ``limits/<cell>.json``: the limits of the numbers that decide
  ``correct``, with the readings each was set from;
- ``end_to_end/<metric>.py`` and ``layer_metrics/<metric>.py``: each a
  ``read(rec)`` that takes the metric from a run's record, or returns
  None where it finds nothing to read;
- ``counts/<kernel>.py``: a kernel's operations and bytes.

A later cell, mix, configuration or metric is added by adding files and
entries; nothing here changes.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Any, Callable, Dict, List, Optional


@dataclasses.dataclass
class Cell:
    root: str
    name: str
    chips: int
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    kind: Any
    limits: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]


def _read_json(path: str) -> Dict[str, Any]:
    with open(path, encoding='utf-8') as f:
        return json.load(f)


def load_module(path: str):
    """Import the Python file ``path`` under a private name (metric names
    carry dots, so these files are loaded by path, never by import)."""
    name = 'portbench_piece_' + os.path.relpath(path).replace(
        os.sep, '_').replace('.', '_').replace('-', '_')
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def piece(root: str, kind: str, name: str) -> str:
    return os.path.join(root, 'portbench', kind, name)


def _applies(metric: Dict[str, Any], cell: str,
             reported: Optional[set] = None) -> bool:
    """A metric is reported in the cells its ``workloads`` lists; without
    the key, an end-to-end metric in every cell and a per-layer one in
    every cell that reports the metric it ``moves``."""
    if 'workloads' in metric:
        return cell in metric['workloads']
    return reported is None or metric.get('moves') in reported


def load_cell(root: str, workload: str) -> Cell:
    bench = _read_json(os.path.join(root, 'BENCHMARK.json'))
    cells = {w['name']: w for w in bench['workloads']}
    if workload not in cells:
        raise KeyError(f'no workload named {workload!r} in BENCHMARK.json')
    w = cells[workload]
    cfg_entry = next(c for c in bench['configs'] if c['name'] == w['config'])
    config = _read_json(os.path.join(root, cfg_entry['file']))
    traffic = _read_json(piece(root, 'traffic', w['traffic'] + '.json'))
    limits = _read_json(piece(root, 'limits', workload + '.json'))
    e2e = [m for m in bench['end_to_end'] if _applies(m, workload)]
    names = {m['name'] for m in e2e}
    layer = [m for m in bench['per_layer'] if _applies(m, workload, names)]
    return Cell(root=root, name=workload, chips=int(w['chips']),
                config=config, traffic=traffic,
                kind=load_module(piece(root, 'traffic_kinds',
                                       traffic['kind'] + '.py')),
                limits=limits,
                end_to_end=e2e, per_layer=layer)


def reader(root: str, kind: str, name: str) -> Callable[[Dict], Any]:
    """The ``read`` of ``portbench/<kind>/<name>.py``."""
    return load_module(piece(root, kind, name + '.py')).read


def count(root: str, kernel: str):
    """The module ``portbench/counts/<kernel>.py``."""
    return load_module(piece(root, 'counts', kernel + '.py'))


def read_metrics(cell: Cell, metrics: List[Dict[str, Any]], kind: str,
                 rec: Dict[str, Any]) -> Dict[str, Dict[str, Any]]:
    """{name: {'value', 'unit'}} of every metric whose reader finds
    something to read in ``rec``."""
    out = {}
    for m in metrics:
        value = reader(cell.root, kind, m['name'])(rec)
        if value is not None:
            out[m['name']] = {'value': value, 'unit': m['unit']}
    return out
