"""The port engine's request lifecycle and telemetry against the JAX
engine (params through convert.py), each engine module on a fake clock
of its own that starts at the same time, so deadlines, the tick EWMA
and the watchdog are deterministic.

- The two gates of the port's roadmap: a prefix-cache hit followed by
  speculative decoding gives the reference's tokens and releases every
  pin; a deadline expiring mid-verify with the cache on releases them
  too.
- Counterparts of tests/unit_tests/test_request_lifecycle.py: expiry of
  a queued and of a mid-decode request; a cancel racing natural
  completion gives one Result; ``estimate_wait_s`` is monotone in load
  and equal to the JAX engine's for the same state and tick EWMA;
  warmup seeds no wait estimate, polls no fault site, observes no
  latency, trips no watchdog and bumps no counter; an injected
  ``engine.tick.hang`` trips the watchdog.
- ``limits()`` equal to the JAX engine's, ``mesh_info()`` None as its
  single-chip value, the decode-attention info gauge, and the engine's
  span tree under ``SKYTPU_TRACE_DIR`` equal to the JAX engine's.
"""
import logging
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu import metrics as jmetrics
from skypilot_tpu import models as jmodels
from skypilot_tpu import trace as jtrace
from skypilot_tpu.models import inference as jinf
from skypilot_tpu.models import serving_engine as jse
from skypilot_tpu.trace import export as jexport
from skypilot_tpu.utils import fault_injection as jfi
from skypilot_tpu_torch import convert
from skypilot_tpu_torch import metrics as tmetrics
from skypilot_tpu_torch import trace as ttrace
from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.models import serving_engine as tse
from skypilot_tpu_torch.trace import export as texport
from skypilot_tpu_torch.utils import fault_injection as tfi
from skypilot_tpu_torch.utils import lifecycle

torch.set_num_threads(2)

_ENV = ('SKYTPU_QOS_WEIGHTS', 'SKYTPU_QOS_TENANT_RATE',
        'SKYTPU_QOS_TENANT_BURST', 'SKYTPU_QOS_MAX_QUEUE',
        'SKYTPU_QOS_PREEMPT_AFTER_S', 'SKYTPU_QOS_DISABLE',
        'SKYTPU_FAULT_PLAN', 'SKYTPU_TRACE_DIR', 'SKYTPU_TRACE_SEED',
        'SKYTPU_TRACE_CONTEXT', 'SKYTPU_TIMELINE_FILE_PATH',
        'SKYTPU_TICK_HANG_SECONDS', 'SKYTPU_SLO_TTFT_S', 'SKYTPU_SLO_ITL_S')


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    """The port's registry is its own (tests/conftest.py resets the JAX
    one); no lifecycle knob leaks in from the environment."""
    tmetrics.REGISTRY.reset()
    for name in _ENV:
        monkeypatch.delenv(name, raising=False)
    yield
    for mod in (jtrace, ttrace):
        mod.seed_ids(None)
        mod.set_clock(None)


class FakeClock:
    """Stands in for one engine module's ``time``: every clock reads
    ``t``; ``sleep`` advances it."""

    def __init__(self, t=1_000_000.0):
        self.t = t

    def time(self):
        return self.t

    monotonic = perf_counter = time

    def sleep(self, s):
        self.t += s


@pytest.fixture(scope='module')
def models():
    jcfg = jmodels.LlamaConfig.tiny()
    jparams = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(
        jax.tree.map(np.asarray, jparams), device='cpu')
    return jcfg, jparams, tllama.LlamaConfig.tiny(), tparams


def _engines(models, monkeypatch, **kw):
    """(JAX engine, port engine), each module on its own fake clock;
    returns the clocks too."""
    jcfg, jparams, tcfg, tparams = models
    base = dict(batch_size=2, max_prompt=16, max_seq=64, decode_chunk=4,
                prefill_chunk=8, prefill_budget=16, page=8)
    base.update(kw)
    out = []
    for mod, params, cfg, extra in ((jse, jparams, jcfg, {}),
                                    (tse, tparams, tcfg, {'device': 'cpu'})):
        clock = FakeClock()
        monkeypatch.setattr(mod, 'time', clock)
        out.append((mod.ServingEngine(params, cfg, **base, **extra), clock))
    return out


def _prompt(n, seed, vocab=256):
    rng = np.random.default_rng(seed)
    return [int(t) for t in rng.integers(0, vocab, n)]


def _solo(models, prompt, max_new):
    jcfg, jparams = models[0], models[1]
    out = jinf.generate(jparams, jnp.asarray([prompt], jnp.int32),
                        jnp.asarray([len(prompt)], jnp.int32), jcfg,
                        max_new=max_new)
    return [int(t) for t in np.asarray(out[0])]


def _oracle(oracles):
    def lookup(chain, k):
        chain = [int(t) for t in chain]
        for p, w in oracles.values():
            if chain[:len(p)] == list(p):
                g = len(chain) - len(p)
                return w[g:g + k]
        return []
    return lookup


_TIMED = ('skytpu_engine_ttft_p99_seconds', 'skytpu_engine_itl_p99_seconds',
          'skytpu_engine_est_wait_seconds',
          'skytpu_engine_class_ttft_p99_seconds')


def _counters(mod):
    return {k: v for k, v in mod.summary().items()
            if k.startswith(('skytpu_engine_', 'skytpu_faults_'))
            and not k.endswith('_sum') and not k.startswith(_TIMED)}


def _view(results):
    return {rid: (r.status, r.reason, list(r.tokens))
            for rid, r in results.items()}


def _drain(eng):
    out = {}
    while eng.queue or eng.num_active() or eng.has_pending:
        eng.step()
        out.update(eng.drain_results())
    return out


# ============================================================ the gates
def test_spec_with_prefix_cache_hit_parity_and_pins(models, monkeypatch):
    """A prefix-cache hit admission followed by speculative decode: the
    solo oracle's tokens (and the JAX engine's), pins released at the
    natural finish, drafts accepted, the same prefix and spec series."""
    kw = dict(batch_size=3, max_prompt=32, max_seq=160, prefix_cache=True,
              prefix_pool_pages=16, spec_decode=True, spec_k=3)
    shared = _prompt(16, 81)
    pub = shared + _prompt(3, 82)
    hit = shared + _prompt(5, 83)
    want = _solo(models, hit, 9)
    views = []
    for eng, _ in _engines(models, monkeypatch, **kw):
        mod = jse if isinstance(eng, jse.ServingEngine) else tse
        assert eng.run([mod.Request('pub', pub, max_new=4)])[
            'pub'].tokens == _solo(models, pub, 4)
        eng._lookup = _oracle({'hit': (hit, want)})
        res = eng.run([mod.Request('hit', hit, max_new=9)])
        assert eng.prefix.hits == 1
        assert res['hit'].tokens == want
        assert eng.prefix.pinned_pages() == 0
        assert eng.spec_stats()['accepted'] > 0
        views.append((_view(res), eng.spec_stats(), eng.prefix.stats()))
    assert views[1] == views[0]
    got = _counters(tmetrics)
    assert got == _counters(jmetrics)
    assert got['skytpu_engine_prefix_hits_total'] == 1
    assert got['skytpu_engine_prefix_tokens_saved_total'] == 16
    assert got['skytpu_engine_spec_accepted_tokens_total'] > 0


def test_expire_mid_verify_releases_prefix_pins(models, monkeypatch):
    """A deadline expiring mid-speculation with the prefix cache on: the
    terminal path publishes and releases as a natural finish does."""
    kw = dict(batch_size=1, max_prompt=32, max_seq=96, prefix_cache=True,
              prefix_pool_pages=16, spec_decode=True, spec_k=2)
    shared = _prompt(8, 21)
    views = []
    for eng, clock in _engines(models, monkeypatch, **kw):
        mod = jse if isinstance(eng, jse.ServingEngine) else tse
        eng.run([mod.Request('pub', shared + _prompt(2, 22), max_new=2)])
        long = shared + _prompt(24, 23)
        eng.submit(mod.Request('late', long, max_new=20,
                               deadline=clock.time() + 0.35))
        eng.step()
        assert eng.prefix.pinned_pages() == 1
        clock.sleep(0.45)
        eng.step()
        eng.step()
        res = eng.drain_results()
        assert (res['late'].status, res['late'].reason) == (
            lifecycle.EXPIRED, 'deadline')
        assert eng.prefix.pinned_pages() == 0
        views.append((_view(res), eng.prefix.stats()))
    assert views[1] == views[0]
    assert _counters(tmetrics) == _counters(jmetrics)


# ============================================================ lifecycle
def test_deadline_expiry_mid_decode_and_queued(models, monkeypatch):
    views = []
    for eng, clock in _engines(models, monkeypatch, batch_size=1):
        mod = jse if isinstance(eng, jse.ServingEngine) else tse
        eng.submit(mod.Request('slow', [1, 2], max_new=40,
                               deadline=clock.time() + 0.15))
        results = {}
        while 'slow' not in results:
            eng.step()
            clock.sleep(0.02)
            results.update(eng.drain_results())
        assert (results['slow'].status, results['slow'].reason) == (
            lifecycle.EXPIRED, 'deadline')
        assert 0 < len(results['slow'].tokens) < 40
        eng.submit(mod.Request('hold', [1], max_new=30))
        eng.step()
        eng.submit(mod.Request('late', [2], max_new=4,
                               deadline=clock.time() - 1.0))
        eng.step()
        results.update(eng.drain_results())
        assert results['late'].status == lifecycle.EXPIRED
        assert results['late'].tokens == []
        eng.cancel('hold')
        results.update(_drain(eng))
        views.append(_view(results))
    assert views[1] == views[0]
    got, want = _counters(tmetrics), _counters(jmetrics)
    # The JAX engine rebuilds its shared decode region once ('slow' and
    # 'hold' use it up); the port's slots own their decode columns, so
    # it never rebuilds.
    assert want.pop('skytpu_engine_cache_resets_total') == 1
    assert got == want
    assert got['skytpu_engine_cancels_total{reason="deadline"}'] == 2
    assert got['skytpu_engine_cancels_total{reason="api"}'] == 1
    assert lifecycle.TERMINAL_STATES == ('finished', 'cancelled', 'expired')


def test_cancel_racing_natural_completion_single_terminal(models,
                                                          monkeypatch):
    views = []
    for eng, _ in _engines(models, monkeypatch, batch_size=1,
                           decode_chunk=2):
        mod = jse if isinstance(eng, jse.ServingEngine) else tse
        eng.submit(mod.Request('r', [1, 2], max_new=2))
        for _ in range(2):
            eng.step()
        assert eng.has_pending
        assert eng.cancel('r', reason='api')
        terminals = []
        for _ in range(4):
            eng.step()
            terminals += list(eng.drain_results().values())
        mine = [t for t in terminals if t.request_id == 'r']
        assert len(mine) == 1
        res = eng.run([mod.Request('r2', [3], max_new=2)])
        assert res['r2'].status == lifecycle.FINISHED
        assert not eng.cancel('r2')
        eng.step()
        assert eng.drain_results() == {}
        views.append((_view({t.request_id: t for t in terminals}),
                      _view(res)))
    assert views[1] == views[0]
    assert _counters(tmetrics) == _counters(jmetrics)


def test_estimate_wait_monotone_and_equal_to_jax(models, monkeypatch):
    (jeng, _), (teng, _) = _engines(models, monkeypatch, batch_size=2,
                                    max_prompt=16, max_seq=128)
    assert teng.estimate_wait_s(8, 8) == 0.0       # no tick signal yet
    estimates = []
    for eng in (jeng, teng):
        mod = jse if eng is jeng else tse
        eng._tick_ewma = 0.1
        seq = [eng.estimate_wait_s(8, 8)]
        for i in range(10):
            eng.submit(mod.Request(('q', i), [1] * (3 + i), max_new=8))
            seq.append(eng.estimate_wait_s(8, 8))
        # Slot state too: admit two and move their cursors.
        eng.step()
        seq.append(eng.estimate_wait_s(5, 17, tokens=[1] * 5))
        estimates.append(seq)
    assert estimates[1] == estimates[0]
    seq = estimates[1][:11]
    assert seq[0] > 0 and seq == sorted(seq) and seq[-1] > 2 * seq[0]


def test_warmup_counts_in_nothing(models, monkeypatch):
    """Warmup's ticks never seed the tick EWMA, reach a fault site,
    observe TTFT, ITL or per-token latency, trip the watchdog or bump a
    counter: after warmup() every series reads as on a fresh engine."""
    monkeypatch.setenv('SKYTPU_TICK_HANG_SECONDS', '1e-9')
    plan = [{'site': 'engine.tick.hang', 'kind': 'hang', 'times': None,
             'params': {'seconds': 0.5}},
            {'site': 'engine.tenant.burst', 'kind': 'tenant_burst',
             'times': None, 'params': {'n': 2}}]
    fresh = {}
    for (eng, clock), fi in zip(_engines(models, monkeypatch, batch_size=1),
                                (jfi, tfi)):
        key = 'jax' if fi is jfi else 'port'
        fresh[key] = _counters(tmetrics if fi is tfi else jmetrics)
        with fi.fault_plan(faults=plan) as active:
            t0 = clock.time()
            eng.warmup()
            assert [s.seen for s in active.specs] == [0, 0]
        assert clock.time() == t0            # no hang acted out
        assert eng._tick_ewma is None
        assert eng.estimate_wait_s(8, 8) == 0.0
        assert len(eng.queue) == 0 and eng.num_active() == 0
    after = _counters(tmetrics)
    assert after == _counters(jmetrics)
    assert after == fresh['port']
    assert after['skytpu_engine_attn_impl{impl="lax"}'] == 1
    assert not any(k.endswith('_total') or k.endswith('_count')
                   for k in after), after


def test_tick_watchdog_fires_on_injected_hang(models, monkeypatch):
    monkeypatch.setenv('SKYTPU_TICK_HANG_SECONDS', '0.01')
    plan = [{'site': 'engine.tick.hang', 'kind': 'hang', 'times': 1,
             'params': {'seconds': 0.05}}]
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    tse.logger.addHandler(handler)
    views = []
    try:
        for (eng, _), fi in zip(_engines(models, monkeypatch, batch_size=1),
                                (jfi, tfi)):
            mod = jse if fi is jfi else tse
            with fi.fault_plan(faults=plan):
                res = eng.run([mod.Request('ok', [1, 2], max_new=4)])
            assert res['ok'].status == lifecycle.FINISHED
            views.append((_view(res), eng._tick_ewma))
    finally:
        tse.logger.removeHandler(handler)
    assert views[1] == views[0]
    got = _counters(tmetrics)
    assert got == _counters(jmetrics)
    assert got['skytpu_engine_tick_hangs_total'] == 1
    assert got['skytpu_faults_injected_total{kind="hang",'
               'site="engine.tick.hang"}'] == 1
    assert any('Engine tick took' in r.getMessage() for r in records)


def test_limits_mesh_info_and_thread_safe_estimates(models, monkeypatch):
    (jeng, _), (teng, _) = _engines(models, monkeypatch, batch_size=3,
                                    max_prompt=16, max_seq=80)
    assert teng.limits() == jeng.limits() == {
        'max_prompt': 16, 'max_seq': 80, 'decode_capacity': 64,
        'batch_size': 3}
    assert teng.mesh_info() is None is jeng.mesh_info()
    # estimate_wait_s and cancel from another thread while the driver
    # steps: no error, one terminal Result each.
    teng._tick_ewma = 0.01
    errors, stop = [], threading.Event()

    def poke():
        try:
            while not stop.wait(0.001):
                teng.estimate_wait_s(4, 4)
                teng.cancel(('r', 3), reason='api')
        except Exception as e:  # surfaced by the assert below
            errors.append(e)

    th = threading.Thread(target=poke)
    th.start()
    try:
        res = teng.run([tse.Request(('r', i), [1 + i, 2], max_new=6)
                        for i in range(6)])
    finally:
        stop.set()
        th.join()
    assert not errors
    assert len(res) == 6 and res[('r', 3)].status == lifecycle.CANCELLED


def _span_shape(spans):
    by_id = {s['span_id']: s for s in spans}
    return sorted(
        (s['name'],
         by_id[s['parent_id']]['name'] if s['parent_id'] in by_id else None,
         tuple(sorted(s['attrs'].items())))
        for s in spans)


def _request_traces(spans):
    """The spans of the traces rooted at an engine.request."""
    ids = {s['trace_id'] for s in spans if s['name'] == 'engine.request'}
    return [s for s in spans if s['trace_id'] in ids]


def test_span_tree_equals_jax(models, monkeypatch, tmp_path):
    """Under SKYTPU_TRACE_DIR the port spools the reference's request
    span trees — engine.request, queue_wait, prefill (with its chunks),
    prefix_lookup, decode.first_chunk, cancel — with the same parents
    and attributes, and the TTFT histogram carries the request's trace
    id as its exemplar. Only the request traces are compared: the
    port's tick spans (engine.tick and what it parents, spec_verify
    included) have no counterpart in the reference."""
    kw = dict(batch_size=2, max_prompt=32, max_seq=160, prefix_cache=True,
              prefix_pool_pages=16, spec_decode=True, spec_k=2)
    shared = _prompt(16, 5)
    prompts = {'a': shared + _prompt(4, 6), 'b': shared + _prompt(9, 7),
               'c': _prompt(12, 8)}
    shapes = []
    for (eng, clock), (mod, trace, export, reg) in zip(
            _engines(models, monkeypatch, **kw),
            ((jse, jtrace, jexport, jmetrics),
             (tse, ttrace, texport, tmetrics))):
        spool = str(tmp_path / mod.__name__)
        monkeypatch.setenv('SKYTPU_TRACE_DIR', spool)
        trace.seed_ids(3)
        trace.set_clock(clock.time)
        eng._lookup = _oracle({})
        eng.run([mod.Request('a', prompts['a'], max_new=5)])
        eng.submit(mod.Request('b', prompts['b'], max_new=30))
        eng.submit(mod.Request('c', prompts['c'], max_new=6))
        for _ in range(4):
            eng.step()
        eng.cancel('b', reason='client_disconnect')
        _drain(eng)
        spans = export.read_spans(spool)
        shapes.append(_span_shape(_request_traces(spans)))
        ttft = reg.REGISTRY.get('skytpu_engine_ttft_seconds')
        ex = ttft.series()[0][1]['exemplar']['trace_id']
        assert ex in {s['trace_id'] for s in spans
                      if s['name'] == 'engine.request'}
    assert shapes[1] == shapes[0]
    names = {n for n, _, _ in shapes[1]}
    assert {'engine.request', 'engine.queue_wait', 'engine.prefill',
            'engine.prefill.chunk', 'engine.prefix_lookup',
            'engine.decode.first_chunk', 'engine.cancel'} <= names
