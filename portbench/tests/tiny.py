"""A checkout of tiny cells for the CPU tests: the repository's
``portbench/`` copied into a temporary root, every configuration cut to
CPU widths and every mix to CPU lengths (files only: the harness is the
repository's)."""
from __future__ import annotations

import json
import os
import shutil

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
TINY = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, num_key_value_heads=2, vocab_size=256)
TINY_ENGINE = dict(batch=4, max_prompt=48, max_seq=112, prefill_chunk=16,
                   prefill_budget=32, decode_chunk=4, prefix_pool_pages=8)


def _edit(path, fn):
    with open(path, encoding='utf-8') as f:
        data = json.load(f)
    fn(data)
    with open(path, 'w', encoding='utf-8') as f:
        json.dump(data, f)


def tiny_config(c, dtype='float32'):
    experts = 'num_local_experts' in c
    c.update(TINY)
    if experts:
        c['num_local_experts'] = 4
    c['weights']['param_dtype'] = dtype
    c['compute_dtype'] = dtype
    if 'engine' in c:
        c['engine'].update(TINY_ENGINE)


def tiny_traffic(t):
    if t['kind'] == 'closed_chat':
        t['prompt'].update(median=20, min=4, max=48)
        t['output'].update(median=8, min=2, max=40)
    elif t['kind'] == 'train_job':
        t.update(batch=2, seq=32)


def make_root(tmp) -> str:
    """A checkout under ``tmp`` holding ``BENCHMARK.json`` and a tiny
    ``portbench/``; returns its path."""
    root = os.path.join(str(tmp), 'checkout')
    shutil.copytree(os.path.join(REPO, 'portbench'),
                    os.path.join(root, 'portbench'),
                    ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    shutil.copy(os.path.join(REPO, 'BENCHMARK.json'), root)
    for name in os.listdir(os.path.join(root, 'portbench', 'configs')):
        _edit(os.path.join(root, 'portbench', 'configs', name), tiny_config)
    for name in os.listdir(os.path.join(root, 'portbench', 'traffic')):
        _edit(os.path.join(root, 'portbench', 'traffic', name), tiny_traffic)
    return root


def cells(root):
    with open(os.path.join(root, 'BENCHMARK.json'), encoding='utf-8') as f:
        return [w['name'] for w in json.load(f)['workloads']]
