"""The serving driver: closed-loop clients on the port's ``ServingEngine``.

Set-up makes the weights on the card from the seed, builds the engine
with the configuration's settings and runs its ``warmup()`` (the kernel
build and every tick program's capture). The window then drives
``submit``/``step`` for ``--seconds``: each client holds one request in
the engine and submits its next the moment the last one finishes. Set-up
ends with the ramp: all clients submit at once and the loop runs until
each of those first requests has its first token, so the window opens on
the loop's steady state. Every token reaches the harness through
``on_token``, which timestamps it. After the close the loop steps on,
submitting nothing, until every request submitted in the window has its
first token (the drain), so the TTFT tail is that of all of them.

With ``--trace 1`` the window is the same, with a profiled slice of it
(whole ticks, from ``SLICE_AT`` of the window for ``SLICE_S`` seconds)
and a wrapper around the engine's tick dispatch that records what each
tick computes: its decode steps with every live row's context length,
and its prefill chunks. The per-layer metrics read those records.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, Dict, List, Optional

from portbench.core import check, result
from portbench.core import model as model_lib
from portbench.core.profile import Slice, span

SLICE_AT = 0.5
SLICE_S = 5.0
# Set-up ends, at the latest, this long after the first submissions.
RAMP_LIMIT_S = 300.0
# The drain ends, at the latest, this long after the close; a request
# still without its first token then has failed.
DRAIN_LIMIT_S = 120.0


@dataclasses.dataclass
class Req:
    client: int
    turn: Any
    submit: float
    first: Optional[float] = None
    last: Optional[float] = None
    n: int = 0
    reused: int = 0
    result: Any = None


class TickLog:
    """What each dispatched tick computes, recorded at dispatch: its
    decode forwards (steps, live rows, keys those rows attend over the
    steps) and its prefill forward (prompt tokens, chunks, keys those
    tokens attend). A slice of the window is a range of ``ticks``."""

    def __init__(self, eng):
        self.eng = eng
        self.steps_of: Dict[tuple, int] = {}
        self.on = False
        # One entry per tick: (decode steps n, live rows, keys attended
        # over the n steps, prefill tokens, prefill chunks, keys those
        # prompt tokens attend).
        self.ticks: List[tuple] = []
        inner = eng._dispatch_tick

        def dispatch():
            entry = inner()
            if entry is not None:
                self.record(entry)
            return entry
        eng._dispatch_tick = dispatch

    def record(self, entry: Dict[str, Any]) -> None:
        n = entry['n'] or entry['spec']
        ctx = 0
        for slot, epoch in entry['snapshot']:
            st = self.eng.slots[slot]
            done = self.steps_of.get((slot, epoch), 0)
            self.steps_of[(slot, epoch)] = done + n
            # Step j of a row with c keys before it attends c + j + 1.
            c = st.prompt_len + done
            ctx += n * c + n * (n + 1) // 2
        tokens = pctx = 0
        for m in entry['chunks']:
            s0, s1 = m['start'], m['start'] + m['n']
            tokens += m['n']
            pctx += (s1 * (s1 + 1) - s0 * (s0 + 1)) // 2
        if self.on:
            self.ticks.append((n, len(entry['snapshot']) if n else 0, ctx,
                               tokens, len(entry['chunks']), pctx))


def build(torch, cell, seed: int, device):
    """The weights and the warmed-up engine. Returns (weights, engine,
    port config)."""
    from skypilot_tpu_torch.models.serving_engine import ServingEngine
    e = cell.config['engine']
    weights = model_lib.make_weights(torch, cell.config, seed, device)
    pcfg = model_lib.port_config(torch, cell.config, e['max_seq'])
    eng = ServingEngine(
        weights, pcfg, batch_size=e['batch'], max_prompt=e['max_prompt'],
        max_seq=e['max_seq'], prefill_chunk=e['prefill_chunk'],
        prefill_budget=e['prefill_budget'], decode_chunk=e['decode_chunk'],
        kv_quant=e['kv_dtype'] == 'int8', weight_quant=False,
        prefix_cache=e['prefix_cache'],
        prefix_pool_pages=e.get('prefix_pool_pages'),
        spec_decode=e.get('spec_decode', False), temperature=0.0,
        device=device)
    if eng.params is not weights:
        raise RuntimeError('the engine copied the weight tree')
    eng.warmup()
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
    return weights, eng, pcfg


def window(torch, eng, cell, seed: int, seconds: float, trace: bool
           ) -> Dict[str, Any]:
    """Drive the closed loop for ``seconds``. Returns the run's record."""
    gen = cell.kind.Generator(cell.traffic, cell.config['vocab_size'], seed)
    clients = int(cell.traffic['clients_per_slot']) * eng.batch_size
    reqs: Dict[int, Req] = {}
    ids = iter(range(1 << 62))
    log = TickLog(eng) if trace else None
    slicer = Slice(torch, eng.device) if trace else None
    state = {'tokens': 0, 'counting': False, 'end': 0.0}

    def on_token(rid, toks):
        now = time.perf_counter()
        r = reqs[rid]
        if r.first is None:
            r.first = now
            st = next((s for s in eng.slots
                       if s is not None and s.request_id == rid), None)
            r.reused = st.reused if st is not None else 0
        r.last = now
        r.n += len(toks)
        if state['counting']:
            state['tokens'] += len(toks)

    from skypilot_tpu_torch.models.serving_engine import Request

    def submit(client: int) -> None:
        turn = gen.next(client)
        rid = next(ids)
        reqs[rid] = Req(client=client, turn=turn, submit=time.perf_counter())
        eng.submit(Request(rid, turn.prompt, max_new=turn.max_new))

    eng.on_token = on_token
    # The ramp (set-up): every client submits at once, and the closed
    # loop runs until each of those first requests has its first token,
    # so the window opens on the loop's steady state.
    state['end'] = float('inf')
    for c in range(clients):
        submit(c)
    first_wave = list(reqs)
    limit = time.perf_counter() + RAMP_LIMIT_S
    while (any(reqs[r].first is None for r in first_wave) and
           time.perf_counter() < limit):
        eng.step()
        for rid, res in eng.drain_results().items():
            r = reqs[rid]
            r.result = res
            gen.answered(r.client, r.turn, res.tokens)
            submit(r.client)
    ramp = set(reqs)
    ticks = 0
    slice_at = slice_ticks = None
    t0 = time.perf_counter()
    opened = time.time()
    state['counting'], state['end'] = True, t0 + seconds
    if log is not None:
        log.on = True
    while True:
        now = time.perf_counter()
        if now >= state['end']:
            break
        if slicer is not None:
            if slice_at is None and now >= t0 + SLICE_AT * seconds:
                slicer.start()
                slice_at = (ticks, len(log.ticks))
            elif (slice_at is not None and slice_ticks is None and
                  now >= slicer.t0 + SLICE_S):
                slicer.stop()
                slice_ticks = (ticks - slice_at[0],
                               log.ticks[slice_at[1]:])
        with span(torch, 'portbench.step', trace):
            eng.step()
        ticks += 1
        with span(torch, 'portbench.clients', trace):
            for rid, res in eng.drain_results().items():
                r = reqs[rid]
                r.result = res
                gen.answered(r.client, r.turn, res.tokens)
                if time.perf_counter() < state['end']:
                    submit(r.client)
    # The window is the loop's whole ticks: from its start to the end of
    # the first step() that ran past ``seconds`` (a rate over whole ticks
    # does not jump by a tick's tokens with where the close falls).
    t_end = time.perf_counter()
    state['counting'], state['end'] = False, t_end
    if slicer is not None and slice_at is not None and slice_ticks is None:
        slicer.stop()
        slice_ticks = (ticks - slice_at[0], log.ticks[slice_at[1]:])
    if log is not None:
        log.on = False
    # The drain: every request submitted in the window gets its first
    # token; nothing new is submitted, and nothing after the close
    # counts towards the rate or the finished requests.
    waiting = [rid for rid, r in reqs.items()
               if rid not in ramp and r.first is None]
    limit = t_end + DRAIN_LIMIT_S
    while (any(reqs[r].first is None for r in waiting) and
           time.perf_counter() < limit):
        eng.step()
        for rid, res in eng.drain_results().items():
            reqs[rid].result = res
    drained = time.perf_counter()
    eng.on_token = None
    rec = summarize(reqs, ramp, state, t0, t_end, drained, ticks)
    rec['waiting_at_close'] = len(waiting)
    rec['drain_s'] = drained - t_end
    rec['opened'] = opened
    if log is not None:
        rec['tick_log'] = list(log.ticks)
    if slicer is not None and slice_ticks is not None:
        rec['slice'] = dict(slicer.result, ticks=slice_ticks[0],
                            tick_log=slice_ticks[1])
        rec['unsliced'] = {'seconds': rec['window_s'] -
                           slicer.result['window_s'],
                           'ticks': ticks - slice_ticks[0]}
    return rec


def summarize(reqs: Dict[int, Req], ramp, state, t0: float, t_end: float,
              drained: float, ticks: int) -> Dict[str, Any]:
    """The end-to-end samples of a window [t0, t_end]. TTFT: every
    request submitted in the window, to its first token, which the drain
    waits for; one that has none when the drain ends has failed and
    counts with its wait until then. TPOT: every request that finished
    in the window (the ramp's too) with two tokens or more."""
    ttft, tpot, finished, failed, reused, admitted = [], [], [], 0, 0, 0
    attempted = 0
    for rid, r in reqs.items():
        if rid not in ramp:
            attempted += 1
            if r.first is not None:
                ttft.append(r.first - r.submit)
                reused += r.reused
                admitted += len(r.turn.prompt)
            else:
                ttft.append(drained - r.submit)
                failed += 1
        res = r.result
        if res is None or r.last is None or not t0 <= r.last < t_end:
            continue
        if res.status != 'finished':
            failed += 1
            continue
        finished.append(rid)
        if r.n >= 2:
            tpot.append((r.last - r.first) / (r.n - 1))
    return {'window_s': t_end - t0, 'ticks': ticks,
            'output_tokens': state['tokens'], 'ttft_s': ttft,
            'tpot_s': tpot, 'attempted': attempted, 'failed': failed,
            'finished': finished, 'prompt_tokens_admitted': admitted,
            'prompt_tokens_reused': reused, 'requests': reqs}


def release(torch, device) -> None:
    """Free what the dropped engine held (its cache, pool and graphs);
    the weights stay, as the benchmark's inputs the reference reads."""
    gc.collect()
    if device.type == 'cuda':
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def run_cell(torch, cell, seed: int, seconds: float, trace: bool, device,
             t_start: float) -> Dict[str, Any]:
    """One run of a serving cell: set-up, the window, the drain, then the
    check of a sample of the finished requests against the reference."""
    weights, eng, _ = build(torch, cell, seed, device)
    rec = window(torch, eng, cell, seed, seconds, trace)
    rec.update(setup_s=rec['opened'] - t_start, root=cell.root, cell=cell,
               engine=cell.config['engine'], kind='serve')
    result.log(f"samples: {rec['attempted']} requests submitted, "
               f"{len(rec['finished'])} finished in the window, "
               f"{len(rec['ttft_s'])} TTFT ({rec['waiting_at_close']} "
               f"waiting at the close, drained in {rec['drain_s']:.3f} s), "
               f"{len(rec['tpot_s'])} TPOT, {rec['output_tokens']} output "
               f"tokens, {rec['ticks']} ticks")
    out = {'attempted': rec['attempted'], 'failed': rec['failed'],
           **result.readings(torch, cell, device, rec, trace)}
    reqs = rec['requests']
    lim = cell.limits
    sample = check.serve_sample(reqs, rec['finished'], seed,
                                int(lim['sample_tokens']),
                                int(lim['sample_requests']))
    eng = None
    release(torch, device)
    t = time.perf_counter()
    gaps = check.serve_gap(torch, cell.config, weights, reqs, sample,
                           device) if sample else {}
    result.log(f'reference: {len(sample)} requests, '
               f'{sum(len(reqs[r].result.tokens) for r in sample)} served '
               f'tokens, {time.perf_counter() - t:.1f} s; gaps {gaps}')
    out['correct'], out['compared'] = check.judged(check.serve_numbers(gaps),
                                                   lim)
    return out


def calibrate(torch, cell, args, device) -> None:
    """The readings the limits are set from, many seeds in one process:
    the engine is built and warmed up once; for each seed the weights
    are drawn again in place (the captured ticks keep pointing at them;
    prompts share no prefix, so the pool holds nothing of the last
    seed's), the engine is emptied, and a window of ``args.seconds`` at
    the cell's own load is served and checked as a run checks it. Each
    seed prints the program's gaps; a control seed also the control's on
    the same sample and a bf16 witness's, each with its verdict under
    the cell's limits. One JSON line per seed on standard output."""
    import json
    weights, eng, _ = build(torch, cell, args.seeds[0], device)
    lim = cell.limits
    for i, seed in enumerate(args.seeds):
        if i:
            eng.cancel_all('calibration')
            while eng.queue or eng.num_active() or eng.has_pending:
                eng.step()
            eng.drain_results()
            eng.reset()
            model_lib.make_weights(torch, cell.config, seed, device,
                                   into=weights)
            torch.cuda.synchronize(device)
        rec = window(torch, eng, cell, seed, args.seconds, False)
        reqs = rec['requests']
        sample = check.serve_sample(reqs, rec['finished'], seed,
                                    int(lim['sample_tokens']),
                                    int(lim['sample_requests']))
        t = time.perf_counter()
        line = {'seed': seed, 'sample': len(sample),
                'served': sum(len(reqs[r].result.tokens) for r in sample),
                'longest': max(len(reqs[r].result.tokens) for r in sample),
                'output_tokens_per_s': rec['output_tokens'] / rec['window_s']}
        line['program'] = check.serve_gap(torch, cell.config, weights,
                                          reqs, sample, device)
        line['program_correct'] = check.judged(
            check.serve_numbers(line['program']), lim)[0]
        line['reference_s'] = time.perf_counter() - t
        if seed in args.control_seeds:
            for name, precision in (('control', lim['control']),
                                    ('bf16_witness', 'bf16')):
                line[name] = check.serve_gap(torch, cell.config, weights,
                                             reqs, sample, device, precision)
                line[name + '_correct'] = check.judged(
                    check.serve_numbers(line[name]), lim)[0]
        print(json.dumps(line), flush=True)
