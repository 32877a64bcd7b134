"""The training driver: the port's ``make_train_step`` on one card.

Set-up draws the weights from the seed on the card, builds one
``TrainState`` with the configuration's optimizer and the step, and
drives that same step through its first ``steps_before_window`` steps
with the window's own feed (a new batch of ids drawn on the card for
every step). It reads what ``correct`` compares from them: each step's
loss, the first gradient's norm per leaf from the optimizer's state
after step one, and the change of every leaf after the last of them.
The window then runs further steps back to back, each synchronised,
for ``--seconds``; the rate is every token of every step it ran over
the time they took. With ``--trace 1`` one slice of whole steps is
profiled."""
from __future__ import annotations

import gc
import time
from typing import Any, Dict

from portbench.core import check, result
from portbench.core import model as model_lib
from portbench.core.profile import Slice, span

SLICE_AT = 0.5
SLICE_STEPS = 3


def optimizer(cell):
    from skypilot_tpu_torch.models import train as port_train
    t = cell.config['train']
    if t['optimizer'] != 'adafactor':
        raise ValueError(f"unknown optimizer {t['optimizer']!r}")
    return port_train.Adafactor(float(t['lr']))


def build(torch, cell, seed: int, device):
    """(state, step function, feed) on ``device``."""
    from skypilot_tpu_torch.models import train as port_train
    seq = int(cell.traffic['seq'])
    pcfg = model_lib.port_config(torch, cell.config, seq,
                                 remat=cell.config['train']['remat'])
    params = model_lib.make_weights(torch, cell.config, seed, device)
    opt = optimizer(cell)
    state = port_train.TrainState(params=params, opt_state=opt.init(params),
                                  step=0)
    step_fn = port_train.make_train_step(pcfg, opt)
    vocab = cell.config['vocab_size']

    def feed(i: int):
        return cell.kind.batch(torch, cell.traffic, vocab, seed, i, device)
    return state, step_fn, feed


def sync(torch, device) -> None:
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def first_steps(torch, cell, seed: int, device, state, step_fn, feed):
    """Run the steps before the window; returns (state, readings, seconds
    spent reading them)."""
    n = int(cell.traffic['steps_before_window'])
    losses, grad_norms, reading = [], {}, 0.0
    for i in range(n):
        state, m = step_fn(state, feed(i))
        losses.append(float(m['loss']))
        if i == 0:
            t = time.perf_counter()
            grad_norms = check.grad_norms_from_state(state.opt_state,
                                                     state.params)
            reading += time.perf_counter() - t
    t = time.perf_counter()
    changes = check.change_norms(torch, cell.config, state.params, seed,
                                 device)
    reading += time.perf_counter() - t
    return state, {'losses': losses, 'grad_norms': grad_norms,
                   'change_norms': changes}, reading


def window(torch, cell, device, state, step_fn, feed, seconds: float,
           trace: bool) -> Dict[str, Any]:
    first = int(cell.traffic['steps_before_window'])
    tokens = int(cell.traffic['batch']) * int(cell.traffic['seq'])
    slicer = Slice(torch, device) if trace else None
    sliced = None
    i = first
    t0 = time.perf_counter()
    end = t0 + seconds
    while True:
        now = time.perf_counter()
        if now >= end and i > first:
            break
        if slicer is not None and sliced is None and \
                now >= t0 + SLICE_AT * seconds:
            slicer.start()
            for _ in range(SLICE_STEPS):
                with span(torch, 'portbench.train_step', True):
                    state, _ = step_fn(state, feed(i))
                    sync(torch, device)
                i += 1
            sliced = dict(slicer.stop(), steps=SLICE_STEPS, tokens=tokens)
            continue
        with span(torch, 'portbench.train_step', trace):
            state, _ = step_fn(state, feed(i))
            sync(torch, device)
        i += 1
    t1 = time.perf_counter()
    rec = {'window_s': t1 - t0, 'steps': i - first,
           'train_tokens': (i - first) * tokens, 'state': state}
    if sliced is not None:
        rec['slice'] = sliced
    return rec


def reference(torch, cell, seed: int, device, feed, precision: str = 'f32'
              ) -> Dict[str, Any]:
    """The reference's readings from the same weights and batches."""
    from portbench.reference import model as ref_model
    from portbench.reference import train as ref_train
    ref_model.no_tf32()
    n = int(cell.traffic['steps_before_window'])
    params = model_lib.make_weights(torch, cell.config, seed, device)
    out = ref_train.train(cell.config, params, [feed(i)['tokens']
                                                for i in range(n)],
                          float(cell.config['train']['lr']), precision)
    out['change_norms'] = check.change_norms(torch, cell.config, params,
                                             seed, device)
    del params
    gc.collect()
    return out


def run_cell(torch, cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> Dict[str, Any]:
    """One run of a training cell: set-up (the first steps, whose
    readings are the check's), the window, then the reference's steps."""
    state, step_fn, feed = build(torch, cell, seed, device)
    state, prog, reading = first_steps(torch, cell, seed, device, state,
                                       step_fn, feed)
    sync(torch, device)
    # The readings are the check's, not set-up's.
    setup_s = time.time() - t_start - reading
    rec = window(torch, cell, device, state, step_fn, feed, seconds, trace)
    rec.update(setup_s=setup_s, root=cell.root, cell=cell, kind='train')
    result.log(f"samples: {rec['steps']} steps, {rec['train_tokens']} "
               f"tokens in {rec['window_s']:.3f} s")
    out = {'attempted': rec['steps'], 'failed': 0,
           **result.readings(torch, cell, device, rec, trace)}
    state = rec.pop('state')
    del state, step_fn
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.empty_cache()
    t = time.perf_counter()
    ref = reference(torch, cell, seed, device, feed)
    result.log(f'reference: {len(ref["losses"])} steps, '
               f'{time.perf_counter() - t:.1f} s; losses program '
               f'{prog["losses"]} reference {ref["losses"]}')
    out['correct'], out['compared'] = check.judged(
        check.train_numbers(prog, ref), cell.limits)
    return out


def calibrate(torch, cell, args, device) -> None:
    """The readings the limits are set from: each seed builds the
    program's state afresh and runs the steps before the window, then
    the reference; a control seed adds the control's readings against
    the reference, a fault seed the reference with half of each batch
    left out (the mean over the rest). One JSON line per seed."""
    import json
    for seed in args.seeds:
        state, step_fn, feed = build(torch, cell, seed, device)
        state, prog, _ = first_steps(torch, cell, seed, device, state,
                                     step_fn, feed)
        del state, step_fn
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        ref = reference(torch, cell, seed, device, feed)
        line = {'seed': seed, 'reference_s': time.perf_counter() - t,
                'losses': prog['losses'], 'ref_losses': ref['losses'],
                **check.train_numbers(prog, ref)}
        if seed in args.control_seeds:
            ctl = reference(torch, cell, seed, device, feed, 'fp8')
            line['control'] = check.train_numbers(ctl, ref)
        if seed in args.fault_seeds:
            rows = max(1, int(cell.traffic['batch']) // 2)
            half = reference(torch, cell, seed, device,
                             lambda i: {'tokens': feed(i)['tokens'][:rows]})
            line['half_batch'] = check.train_numbers(half, ref)
        print(json.dumps(line), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
