"""``correct`` comes out false when the timed path is broken underneath,
once for each fault a cell can have, on the CPU at tiny widths with the
cells' own limits: a served token altered where the tick produces it; a
train step that returns its state unchanged; a train step that leaves
out half of its batch (the mean over the rest). The cells run on one
card, so no exchange between cards can be left out. And the control,
the reference one step below the configuration's precision put in the
program's place, fails its cell's serving limits."""
import json
import subprocess
import sys

import pytest
import torch

from portbench import run
from portbench.core import check, serve, spec
from portbench.tests import tiny

SERVE = ['mixtral-8x7b-w8.chat', 'mistral-7b.chat']
TRAIN = ['mistral-7b.finetune']


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    torch.set_num_threads(2)
    return tiny.make_root(tmp_path_factory.mktemp('faults'))


@pytest.mark.parametrize('cell', SERVE)
def test_altered_token_is_not_correct(root, cell, monkeypatch):
    from skypilot_tpu_torch.models import serving_engine
    vocab = spec.load_cell(root, cell).config['vocab_size']
    inner = serving_engine.ServingEngine._process_tick

    def altered(self, entry):
        if entry is not None and entry['n']:
            k = self.batch_size * entry['n']
            entry['out'][:k] = (entry['out'][:k] + 1) % vocab
        return inner(self, entry)
    monkeypatch.setattr(serving_engine.ServingEngine, '_process_tick',
                        altered)
    out = run.execute(root, cell, 5, 1.0, False, torch.device('cpu'), 0.0)
    assert out['correct'] is False, out['compared']


@pytest.mark.parametrize('fault', ['unchanged', 'half_batch'])
@pytest.mark.parametrize('cell', TRAIN)
def test_broken_train_step_is_not_correct(root, cell, fault, monkeypatch):
    from skypilot_tpu_torch.models import train as port_train
    if fault == 'unchanged':
        monkeypatch.setattr(
            port_train.Adafactor, 'update',
            lambda self, grads, norm, opt_state, params: dict(
                opt_state, count=opt_state['count'] + 1))
    else:
        inner = port_train.make_train_step

        def half(cfg, opt, mesh=None):
            step = inner(cfg, opt, mesh)

            def stepped(state, batch):
                rows = batch['tokens'].shape[0] // 2
                return step(state, {'tokens': batch['tokens'][:rows]})
            return stepped
        monkeypatch.setattr(port_train, 'make_train_step', half)
    out = run.execute(root, cell, 5, 1.0, False, torch.device('cpu'), 0.0)
    assert out['correct'] is False, out['compared']


def test_control_is_not_correct(root):
    """The served tokens replaced by those the control puts first, on
    the prompts and served tokens of a tiny run, judged under the cell's
    own limits. Only the dense cell: at the widths and depths a CPU run
    holds (up to 32 layers at width 64, 8 at width 128) the int4
    control of the MoE cell reads mean gaps of 0.24-0.49, around its
    limit of 0.4, where at the cell's own size it reads 1.09-1.16; that
    cell's control is held on the card, below."""
    cell = 'mistral-7b.chat'
    c = spec.load_cell(root, cell)
    dev = torch.device('cpu')
    weights, eng, _ = serve.build(torch, c, 21, dev)
    rec = serve.window(torch, eng, c, 21, 1.0, False)
    reqs = rec['requests']
    sample = check.serve_sample(reqs, rec['finished'], 21,
                                int(c.limits['sample_tokens']),
                                int(c.limits['sample_requests']))
    gap = check.serve_gap(torch, c.config, weights, reqs, sample, dev,
                          c.limits['control'])
    ok, compared = check.judged(check.serve_numbers(gap), c.limits)
    assert all(v['value'] is not None for v in compared.values())
    assert not ok, (gap, compared)


@pytest.mark.gpu
@pytest.mark.parametrize('cell', SERVE)
def test_control_is_not_correct_on_the_card(cell):
    """At the cell's own size and load: one seed's program is correct
    and its control, on the same sample, is not."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the cells run the CUDA kernels')
    seed = 2**31 + 4099
    proc = subprocess.run(
        [sys.executable, '-m', 'portbench.calibrate', '--workload', cell,
         '--seeds', str(seed), '--control-seeds', str(seed),
         '--seconds', '20'],
        cwd=tiny.REPO, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line['program_correct'] is True, line
    assert line['control_correct'] is False, line
