"""The import guard: no module the harness runs has the top-level name
``jax``, ``jaxlib``, ``flax`` or ``skypilot_tpu`` (compared whole, so
the port, ``skypilot_tpu_torch``, passes), and the reference imports
nothing of the port either."""
import ast
import os
import subprocess
import sys

import pytest

from portbench.core import env
from portbench.tests import tiny

PKG = os.path.join(tiny.REPO, 'portbench')


def _sources():
    for d, _, files in os.walk(PKG):
        if os.sep + 'tests' in d or '__pycache__' in d:
            continue
        for f in files:
            if f.endswith('.py'):
                yield os.path.join(d, f)


def _imports(path):
    with open(path, encoding='utf-8') as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module


@pytest.mark.parametrize('names,want', [
    (['skypilot_tpu_torch', 'skypilot_tpu_torch.models.llama', 'numpy'], []),
    (['skypilot_tpu.models.llama'], ['skypilot_tpu']),
    (['jaxlib.xla_client', 'torch'], ['jaxlib']),
    (['jax', 'flax.linen'], ['flax', 'jax']),
    (['jax_fake', 'skypilot_tpu_x'], []),
])
def test_guard_compares_whole_top_level_names(names, want):
    assert env.forbidden_loaded(names) == want


def test_no_harness_source_imports_jax_or_the_jax_package():
    for path in _sources():
        tops = {m.split('.')[0] for m in _imports(path)}
        assert not tops & set(env.FORBIDDEN_MODULES), (path, tops)


def test_reference_imports_nothing_of_the_port():
    ref = os.path.join(PKG, 'reference')
    for f in os.listdir(ref):
        if f.endswith('.py'):
            tops = {m.split('.')[0] for m in _imports(os.path.join(ref, f))}
            assert 'skypilot_tpu_torch' not in tops, (f, tops)
            assert tops <= {'torch', 'typing', '__future__', 'portbench',
                            'math'}, (f, tops)


def test_a_run_loads_no_forbidden_module(tmp_path):
    """A tiny cell driven in a fresh interpreter, with every reader and
    count loaded: sys.modules holds none of the forbidden names after."""
    root = tiny.make_root(tmp_path)
    code = (
        'import sys, time, torch\n'
        'torch.set_num_threads(2)\n'
        'from portbench import run, calibrate\n'
        'from portbench.core import env\n'
        f'run.execute({root!r}, "mixtral-8x7b-w8.chat", 7, 1.0, True, '
        'torch.device("cpu"), time.time())\n'
        'print(env.forbidden_loaded())\n')
    proc = subprocess.run([sys.executable, '-c', code], cwd=tiny.REPO,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().splitlines()[-1] == '[]'


def test_no_card_no_result(tmp_path):
    """Without a CUDA card the command exits non-zero and prints no
    result line; so does a checkout holding only the benchmark."""
    bare = tmp_path / 'bare'
    bare.mkdir()
    import shutil
    shutil.copytree(PKG, bare / 'portbench',
                    ignore=shutil.ignore_patterns('__pycache__', 'tests'))
    shutil.copy(os.path.join(tiny.REPO, 'BENCHMARK.json'), bare)
    for cwd in (tiny.REPO, str(bare)):
        proc = subprocess.run(
            [sys.executable, '-m', 'portbench.run', '--workload',
             'mistral-7b.chat', '--seed', '1', '--seconds', '1'],
            cwd=cwd, capture_output=True, text=True, timeout=300,
            env=dict(os.environ, CUDA_VISIBLE_DEVICES=''))
        assert proc.returncode != 0
        assert proc.stdout.strip() == ''
