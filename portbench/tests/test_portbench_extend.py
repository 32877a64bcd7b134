"""A later PR adds a cell by adding files and entries only: a new
configuration, mix, limits file and per-layer metric, written into a
temporary checkout beside the existing ones, are found by name and
run, and no existing file changes."""
import hashlib
import json
import os

import torch

from portbench import run
from portbench.tests import tiny


def _digest(root):
    h = {}
    for d, _, files in os.walk(os.path.join(root, 'portbench')):
        for f in files:
            p = os.path.join(d, f)
            with open(p, 'rb') as fh:
                h[os.path.relpath(p, root)] = hashlib.sha256(
                    fh.read()).hexdigest()
    return h


def test_new_cell_from_new_files_alone(tmp_path):
    torch.set_num_threads(2)
    root = tiny.make_root(tmp_path)
    before = _digest(root)
    pb = os.path.join(root, 'portbench')
    with open(os.path.join(pb, 'configs', 'mistral-7b.json')) as f:
        cfg = json.load(f)
    cfg['num_hidden_layers'] = 3
    cfg['reduced'] = ['num_hidden_layers']
    with open(os.path.join(pb, 'configs', 'deep-tiny.json'), 'w') as f:
        json.dump(cfg, f)
    with open(os.path.join(pb, 'traffic', 'chat.json')) as f:
        mix = json.load(f)
    mix['output'].update(median=4, min=2, max=6)
    with open(os.path.join(pb, 'traffic', 'short-answers.json'), 'w') as f:
        json.dump(mix, f)
    with open(os.path.join(pb, 'limits', 'mistral-7b.chat.json')) as f:
        limits = json.load(f)
    with open(os.path.join(pb, 'limits', 'deep-tiny.short.json'), 'w') as f:
        json.dump(limits, f)
    with open(os.path.join(pb, 'layer_metrics', 'engine.finished.py'),
              'w') as f:
        f.write('def read(rec):\n'
                '    return float(len(rec["finished"]))\n')
    with open(os.path.join(root, 'BENCHMARK.json')) as f:
        bench = json.load(f)
    bench['configs'].append({'name': 'deep-tiny', 'source': 'test',
                             'file': 'portbench/configs/deep-tiny.json',
                             'reduced': ['num_hidden_layers'], 'why': 'test'})
    bench['workloads'].append({'name': 'deep-tiny.short',
                               'config': 'deep-tiny',
                               'traffic': 'short-answers', 'chips': 1,
                               'why': 'test'})
    for m in bench['end_to_end']:
        if 'output_tokens_per_s' == m['name']:
            m['workloads'].append('deep-tiny.short')
    bench['per_layer'].append({'name': 'engine.finished', 'unit': 'requests',
                               'better': 'higher', 'source': 'host_clock',
                               'layer': 'engine (models/serving_engine.py)',
                               'moves': 'output_tokens_per_s',
                               'workloads': ['deep-tiny.short']})
    with open(os.path.join(root, 'BENCHMARK.json'), 'w') as f:
        json.dump(bench, f)

    out = run.execute(root, 'deep-tiny.short', 11, 1.0, False,
                      torch.device('cpu'), 0.0)
    assert out['correct'] is True
    assert set(out['metrics']) == {'output_tokens_per_s', 'setup_s'}
    traced = run.execute(root, 'deep-tiny.short', 12, 1.0, True,
                         torch.device('cpu'), 0.0)
    assert traced['metrics']['engine.finished']['value'] > 0
    after = _digest(root)
    assert {k: v for k, v in after.items() if k in before} == before
