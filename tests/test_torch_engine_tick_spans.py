"""The port's engine tick spans on the CPU (docs/tracing.md, "Engine
ticks"): under ``SKYTPU_TRACE_DIR`` every working ``step()`` is one
``engine.tick`` trace with its phases in order, every dispatched tick
one ``engine.tick.device`` span whose counts equal what the benchmark's
tick log records for the same run, admission says why it stopped and
counts the admissions a shared decode region would have refused, and
the phases are ``torch.profiler`` ranges while a profiler records. With
tracing off the engine spools nothing and opens no range."""
import json

import numpy as np
import pytest

from portbench.core.serve import TickLog
from skypilot_tpu_torch import trace as trace_lib
from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.models import serving_engine as se
from skypilot_tpu_torch.trace import export

PHASES = ('engine.tick.admit', 'engine.tick.dispatch', 'engine.tick.sync',
          'engine.tick.process')


@pytest.fixture(scope='module')
def model():
    cfg = llama.LlamaConfig.tiny()
    return cfg, llama.init_params(cfg, 0, device='cpu')


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for name in ('SKYTPU_TRACE_DIR', 'SKYTPU_TRACE_CONTEXT',
                 'SKYTPU_FAULT_PLAN', 'SKYTPU_SPEC_DECODE'):
        monkeypatch.delenv(name, raising=False)


def _engine(model, **kw):
    cfg, params = model
    eng = se.ServingEngine(params, cfg, **{
        **dict(batch_size=2, max_prompt=16, max_seq=48, decode_chunk=4,
               prefill_chunk=8, prefill_budget=16, page=8, device='cpu'),
        **kw})
    eng.warmup()
    return eng


def _requests(cfg, lens_and_new, seed=0):
    rng = np.random.default_rng(seed)
    return [se.Request(i, rng.integers(0, cfg.vocab_size, p).tolist(),
                       max_new=m) for i, (p, m) in enumerate(lens_and_new)]


def _drive(eng, reqs):
    """Submit ``reqs`` and step to the end. Returns how many step()s
    found work and how many ticks were dispatched."""
    for r in reqs:
        eng.submit(r)
    inner = eng._dispatch_tick
    dispatched = []

    def dispatch():
        entry = inner()
        if entry is not None:
            dispatched.append(entry)
        return entry
    eng._dispatch_tick = dispatch
    working = 0
    while eng.queue or eng.num_active() or eng.has_pending:
        working += 1
        eng.step()
        eng.drain_results()
    del eng._dispatch_tick
    return working, len(dispatched)


def _children(spans, parent):
    return sorted((s for s in spans if s['parent_id'] == parent['span_id']),
                  key=lambda s: s['start'])


MIX = [(5, 12), (9, 20), (3, 6), (14, 9), (7, 16)]


def test_each_working_step_is_one_tick_with_its_phases(model, monkeypatch,
                                                        tmp_path):
    cfg = model[0]
    eng = _engine(model)
    monkeypatch.setenv('SKYTPU_TRACE_DIR', str(tmp_path))
    working, dispatched = _drive(eng, _requests(cfg, MIX))
    spans = export.read_spans(str(tmp_path))
    ticks = [s for s in spans if s['name'] == 'engine.tick']
    assert len(ticks) == working
    assert len({t['trace_id'] for t in ticks}) == len(ticks)
    for tick in ticks:
        assert tick['parent_id'] is None
        phases = [s for s in _children(spans, tick) if s['name'] in PHASES]
        assert tuple(s['name'] for s in phases) == PHASES
        for s in phases:
            assert tick['start'] <= s['start'] <= s['end'] <= tick['end']
    devices = [s for s in spans if s['name'] == 'engine.tick.device']
    assert len(devices) == dispatched
    by_id = {s['span_id']: s for s in spans}
    assert all(by_id[d['parent_id']]['name'] == 'engine.tick'
               for d in devices)
    assert all(d['attrs']['device_ms'] >= 0 for d in devices)
    # The request trees stay apart from the ticks.
    tick_traces = {t['trace_id'] for t in ticks}
    assert not tick_traces & {s['trace_id'] for s in spans
                              if s['name'] == 'engine.request'}


def test_device_counts_equal_the_tick_log(model, monkeypatch, tmp_path):
    """Tick by tick: decode steps, live rows, keys attended, prefill
    tokens, chunks and query-key pairs, in dispatch order."""
    cfg = model[0]
    eng = _engine(model, batch_size=3)
    log = TickLog(eng)
    log.on = True
    monkeypatch.setenv('SKYTPU_TRACE_DIR', str(tmp_path))
    _drive(eng, _requests(cfg, MIX + [(11, 7), (4, 22), (16, 3)], seed=1))
    devices = sorted((s for s in export.read_spans(str(tmp_path))
                      if s['name'] == 'engine.tick.device'),
                     key=lambda s: s['start'])
    got = [tuple(d['attrs'][k] for k in ('n', 'rows', 'keys',
                                         'prefill_tokens', 'chunks',
                                         'prefill_pairs'))
           for d in devices]
    assert got == log.ticks
    assert any(t[0] and t[3] for t in got), 'no mixed tick with decode'
    kinds = {d['attrs']['kind'] for d in devices}
    assert kinds == {'decode', 'mixed'}


def _admits(spans):
    return [s['attrs'] for s in spans if s['name'] == 'engine.tick.admit']


def test_admission_past_a_long_answer(model, monkeypatch, tmp_path):
    """A long answer no longer holds the others back: the third request
    takes the slot the short one frees while the long one still runs
    (each slot owns its decode columns), and past_frontier counts it,
    since a region shared by both slots would have refused it (its 28
    tick-tokens against the 32 columns less the long row's)."""
    cfg = model[0]
    eng = _engine(model)
    monkeypatch.setenv('SKYTPU_TRACE_DIR', str(tmp_path))
    _drive(eng, _requests(cfg, [(6, 28), (4, 4), (5, 24)]))
    spans = export.read_spans(str(tmp_path))
    admits = _admits(spans)
    assert all(a['admit_stop'] in ('queue_empty', 'no_slot',
                                   'prefill_rows') for a in admits)
    assert all('resets' not in a for a in admits)
    assert sum(a['admitted'] for a in admits) == 3
    assert admits[-1]['admit_stop'] == 'queue_empty'
    past = sum(a['past_frontier'] for a in admits)
    assert past == eng.admits_past_frontier == 1
    # Request 2's prefill starts before request 0 has finished.
    req = {s['span_id']: s['attrs']['request_id'] for s in spans
           if s['name'] == 'engine.request'}
    done0 = next(s['end'] for s in spans if s['name'] == 'engine.request'
                 and s['attrs']['request_id'] == '0')
    start2 = next(s['start'] for s in spans if s['name'] == 'engine.prefill'
                  and req[s['parent_id']] == '2')
    assert start2 < done0


def test_admission_names_no_slot(model, monkeypatch, tmp_path):
    cfg = model[0]
    eng = _engine(model)
    monkeypatch.setenv('SKYTPU_TRACE_DIR', str(tmp_path))
    _drive(eng, _requests(cfg, [(5, 6), (5, 6), (5, 6)]))
    first = _admits(export.read_spans(str(tmp_path)))[0]
    assert first == {'admitted': 2, 'admit_stop': 'no_slot',
                     'past_frontier': 0, 'queued': 1, 'free_slots': 0}


def test_prefill_rows_stop(model, monkeypatch, tmp_path):
    """One prefill row (budget = one chunk): the second request waits
    for the first one's prefill with a slot free."""
    cfg = model[0]
    eng = _engine(model, prefill_budget=8)
    monkeypatch.setenv('SKYTPU_TRACE_DIR', str(tmp_path))
    _drive(eng, _requests(cfg, [(12, 4), (12, 4)]))
    first = _admits(export.read_spans(str(tmp_path)))[0]
    assert (first['admitted'], first['admit_stop']) == (1, 'prefill_rows')


def test_first_replay_once_per_key(model, monkeypatch, tmp_path):
    cfg = model[0]
    eng = _engine(model, batch_size=3)
    warm = set(eng._dispatched_keys)
    assert warm
    monkeypatch.setenv('SKYTPU_TRACE_DIR', str(tmp_path))
    _drive(eng, _requests(cfg, MIX, seed=2))
    seen = {}
    for s in export.read_spans(str(tmp_path)):
        if s['name'] == 'engine.tick.dispatch' and s['attrs']['key']:
            seen.setdefault(s['attrs']['key'], []).append(
                s['attrs']['first_replay'])
    assert seen
    for key, flags in seen.items():
        want = [False] * len(flags) if key in {repr(k) for k in warm} \
            else [True] + [False] * (len(flags) - 1)
        assert flags == want, key


def test_phases_are_profiler_ranges(model, monkeypatch, tmp_path):
    from torch.profiler import ProfilerActivity, profile
    cfg = model[0]
    eng = _engine(model)
    monkeypatch.setenv('SKYTPU_TRACE_DIR', str(tmp_path / 'spool'))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _drive(eng, _requests(cfg, MIX[:3]))
    path = str(tmp_path / 'trace.json')
    prof.export_chrome_trace(path)
    with open(path, encoding='utf-8') as f:
        events = [e for e in json.load(f)['traceEvents']
                  if e.get('ph') == 'X' and
                  str(e.get('name', '')).startswith('engine.tick')]
    assert all(e['cat'] == 'user_annotation' for e in events)
    ticks = [e for e in events if e['name'] == 'engine.tick']
    n_ticks = sum(s['name'] == 'engine.tick' for s in
                  export.read_spans(str(tmp_path / 'spool')))
    assert len(ticks) == n_ticks
    for name in PHASES:
        phase = [e for e in events if e['name'] == name]
        assert len(phase) == len(ticks), name
        for e in phase:
            assert any(t['ts'] <= e['ts'] and
                       e['ts'] + e['dur'] <= t['ts'] + t['dur']
                       for t in ticks), name
    # The device span crosses steps: a spool record, never a range.
    assert not [e for e in events if e['name'] == 'engine.tick.device']


def test_tracing_off_spools_nothing_and_opens_no_range(model, monkeypatch,
                                                       tmp_path):
    from torch.profiler import ProfilerActivity, profile
    cfg = model[0]
    eng = _engine(model)
    monkeypatch.chdir(tmp_path)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _drive(eng, _requests(cfg, MIX[:3]))
    assert not [e for e in prof.events() if e.name.startswith('engine.')]
    assert list(tmp_path.iterdir()) == []


def test_warmup_spools_no_tick(model, monkeypatch, tmp_path):
    monkeypatch.setenv('SKYTPU_TRACE_DIR', str(tmp_path))
    _engine(model)
    assert export.read_spans(str(tmp_path)) == []


def test_root_span_ignores_the_ambient_one(monkeypatch, tmp_path):
    monkeypatch.setenv('SKYTPU_TRACE_DIR', str(tmp_path))
    with trace_lib.span('outer') as outer:
        with trace_lib.span('own', root=True) as own:
            inner = trace_lib.start_span('inner')
            inner.finish()
    assert own.parent_id is None and own.trace_id != outer.trace_id
    assert (inner.trace_id, inner.parent_id) == (own.trace_id, own.span_id)


def test_burst_requests_are_not_children_of_the_tick(model, monkeypatch,
                                                     tmp_path):
    eng = _engine(model)
    monkeypatch.setenv('SKYTPU_TRACE_DIR', str(tmp_path))
    with trace_lib.span('engine.tick', root=True) as tick:
        eng._inject_tenant_burst({'n': 2, 'prompt_len': 4, 'max_new': 3})
    _drive(eng, [])
    reqs = [s for s in export.read_spans(str(tmp_path))
            if s['name'] == 'engine.request']
    assert len(reqs) == 2
    assert all(r['parent_id'] is None and r['trace_id'] != tick.trace_id
               for r in reqs)
