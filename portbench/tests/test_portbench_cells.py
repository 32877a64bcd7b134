"""Every cell of BENCHMARK.json, rehearsed on the CPU at tiny widths
through the harness's whole path (generator, engine or train step,
window, metric readers, the reference and the judgment), untraced and
traced; and, on a card only, one real run of the command."""
import json
import os
import subprocess
import sys

import pytest
import torch

from portbench import run
from portbench.tests import tiny

CELLS = tiny.cells(tiny.REPO)
SEED = 2**31 + 977


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny.make_root(tmp_path_factory.mktemp('cells'))


def _bench():
    with open(os.path.join(tiny.REPO, 'BENCHMARK.json'), encoding='utf-8') as f:
        return json.load(f)


@pytest.mark.parametrize('trace', [False, True])
@pytest.mark.parametrize('cell', CELLS)
def test_cell_runs_and_is_correct_on_the_cpu(root, cell, trace):
    out = run.execute(root, cell, SEED, 1.5, trace, torch.device('cpu'),
                      0.0)
    assert list(out)[:5] == ['correct', 'attempted', 'failed', 'metrics',
                             'device']
    assert list(out)[-1] == 'compared'
    assert out['correct'] is True, out['compared']
    assert out['attempted'] > 0 and out['failed'] == 0
    bench = _bench()
    if trace:
        want = {m['name'] for m in bench['per_layer']
                if cell in m['workloads'] and 'roofline' not in m['name']}
        assert 'breakdown' in out
        assert out['device']['window_s'] > 0
    else:
        want = {m['name'] for m in bench['end_to_end']
                if cell in m.get('workloads', [cell])}
    assert want <= set(out['metrics']), (want, out['metrics'])
    for m in out['metrics'].values():
        assert m['value'] == m['value']          # not NaN
    json.dumps(out, allow_nan=False)


def test_same_seed_same_inputs(root):
    from portbench.core import spec
    cell = spec.load_cell(root, 'mistral-7b.chat')
    a = cell.kind.Generator(cell.traffic, 256, SEED)
    b = cell.kind.Generator(cell.traffic, 256, SEED)
    c = cell.kind.Generator(cell.traffic, 256, SEED + 1)
    ta = [a.next(0) for _ in range(70)]
    tb = [b.next(0) for _ in range(70)]
    tc = [c.next(0) for _ in range(70)]
    assert [t.prompt for t in ta] == [t.prompt for t in tb]
    # Another seed: the same sizes in the same order, other token ids.
    assert [(len(t.prompt), t.max_new) for t in ta] == \
        [(len(t.prompt), t.max_new) for t in tc]
    assert [t.prompt for t in ta] != [t.prompt for t in tc]


def test_every_mix_runs_on_the_cpu(root):
    """Every mix under traffic/, a cell or not yet, drives a tiny run
    of the dense configuration to a correct result."""
    import shutil
    mixes = sorted(f[:-5] for f in os.listdir(
        os.path.join(root, 'portbench', 'traffic')))
    with open(os.path.join(root, 'BENCHMARK.json'), encoding='utf-8') as f:
        bench = json.load(f)
    names = {w['name'] for w in bench['workloads']}
    for mix in mixes:
        name = 'mistral-7b.' + mix
        if name in names:
            continue
        bench['workloads'].append({'name': name, 'config': 'mistral-7b',
                                   'traffic': mix, 'chips': 1, 'why': 'test'})
        for m in bench['end_to_end']:
            if 'workloads' in m and 'mistral-7b.chat' in m['workloads']:
                m['workloads'].append(name)
        shutil.copy(os.path.join(root, 'portbench', 'limits',
                                 'mistral-7b.chat.json'),
                    os.path.join(root, 'portbench', 'limits', name + '.json'))
    with open(os.path.join(root, 'BENCHMARK.json'), 'w',
              encoding='utf-8') as f:
        json.dump(bench, f)
    for mix in mixes:
        out = run.execute(root, 'mistral-7b.' + mix, SEED, 1.5, False,
                          torch.device('cpu'), 0.0)
        assert out['correct'] is True and out['attempted'] > 0, mix


@pytest.mark.gpu
def test_command_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the cells run the CUDA kernels')
    proc = subprocess.run(
        [sys.executable, '-m', 'portbench.run', '--workload', CELLS[-1],
         '--seed', str(SEED), '--seconds', '5', '--trace', '0'],
        cwd=tiny.REPO, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1])['correct']
