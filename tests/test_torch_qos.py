"""Multi-tenant QoS in the port (skypilot_tpu_torch/utils/qos.py and the
engine's QoS admission, shedding and preemption) against the JAX
package.

- The primitives on seeded random inputs: ``TokenBucket`` and
  ``DeficitRoundRobin`` step for step, ``parse_weights``, the
  validators and ``qos_config_from_env`` give the reference's values or
  raise where it raises.
- Engine counterparts of tests/unit_tests/test_qos.py (untagged traffic
  equals legacy FIFO bitwise and the kill switch; interactive jumps
  earlier bulk; a broke tenant is skipped; queue-pressure shedding;
  sustained-overload preemption; the class-aware wait estimate and
  deadline shedding; the engine.tenant.burst site; the seeded burst
  isolation A/B). Each runs the JAX engine and the port engine (params
  through convert.py) on the same traffic under one fake clock per
  engine, and holds equal the per-tick queue and slot contents (the
  admission order), the Results (status, reason, tokens) and the
  wall-clock-free series of ``metrics.summary()``.
"""

import jax
import numpy as np
import pytest
import torch

from skypilot_tpu import loadgen
from skypilot_tpu import metrics as jmetrics
from skypilot_tpu import models as jmodels
from skypilot_tpu.models import serving_engine as jse
from skypilot_tpu.utils import fault_injection as jfi
from skypilot_tpu.utils import qos as jqos
from skypilot_tpu_torch import convert
from skypilot_tpu_torch import metrics as tmetrics
from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.models import serving_engine as tse
from skypilot_tpu_torch.utils import fault_injection as tfi
from skypilot_tpu_torch.utils import qos as tqos

torch.set_num_threads(2)

_QOS_ENV = ('SKYTPU_QOS_WEIGHTS', 'SKYTPU_QOS_TENANT_RATE',
            'SKYTPU_QOS_TENANT_BURST', 'SKYTPU_QOS_MAX_QUEUE',
            'SKYTPU_QOS_PREEMPT_AFTER_S', 'SKYTPU_QOS_DISABLE')


@pytest.fixture(autouse=True)
def clean(monkeypatch):
    """The port's registry is its own (tests/conftest.py resets the JAX
    one); no QoS knob leaks in from the environment."""
    tmetrics.REGISTRY.reset()
    for name in _QOS_ENV + ('SKYTPU_FAULT_PLAN', 'SKYTPU_TRACE_DIR'):
        monkeypatch.delenv(name, raising=False)
    yield


# ======================================================= primitives
def test_token_bucket_matches_jax_on_random_sequences():
    rng = np.random.default_rng(0)
    for _ in range(20):
        rate, burst = float(rng.uniform(0.1, 50)), float(rng.uniform(1, 200))
        t, j = tqos.TokenBucket(rate, burst), jqos.TokenBucket(rate, burst)
        now = 0.0
        for _ in range(60):
            now += float(rng.uniform(-0.2, 1.0))   # clock may step back
            charge = float(rng.uniform(0, burst * 0.7))
            op = 'peek' if rng.uniform() < 0.4 else 'spend'
            assert getattr(t, op)(charge, now) == getattr(j, op)(charge, now)
            assert (t.tokens, t.updated) == (j.tokens, j.updated)


def test_drr_matches_jax_on_random_rounds():
    rng = np.random.default_rng(1)
    streams = [(tenant, cls) for tenant in (None, 'a', 'b', 'c')
               for cls in tqos.PRIORITY_CLASSES]
    weights = {'interactive': 5, 'standard': 2, 'bulk': 1}
    t = tqos.DeficitRoundRobin(weights, quantum=4.0)
    j = jqos.DeficitRoundRobin(weights, quantum=4.0)
    for _ in range(200):
        live = [s for s in streams if rng.uniform() < 0.4]
        t.earn(list(live))
        j.earn(list(live))
        assert t.order() == j.order()
        for key in t.order():
            charge = float(rng.uniform(0, 30))
            assert t.can_spend(key, charge) == j.can_spend(key, charge)
            if t.can_spend(key, charge) and rng.uniform() < 0.6:
                t.spend(key, charge)
                j.spend(key, charge)
        assert t._deficit == j._deficit and t._ring == j._ring
        if rng.uniform() < 0.05:
            t.prune()
            j.prune()


def _outcome(fn, *a):
    try:
        return ('ok', fn(*a))
    except ValueError:
        return ('raises',)


def test_parse_weights_and_validators_match_jax():
    rng = np.random.default_rng(2)
    parts = ['interactive=16', 'standard=3', 'bulk=0', 'Bulk=2', 'gold=3',
             'interactive', ' standard = 7 ', '', 'bulk=-4']
    for _ in range(100):
        spec = ','.join(rng.choice(parts, int(rng.integers(0, 4))))
        assert _outcome(tqos.parse_weights, spec) == \
            _outcome(jqos.parse_weights, spec)
    chars = list('abcXYZ019._- \n;"')
    for _ in range(300):
        value = ''.join(rng.choice(chars, int(rng.integers(0, 70))))
        for name in ('validate_tenant', 'validate_class'):
            assert _outcome(getattr(tqos, name), value) == \
                _outcome(getattr(jqos, name), value)
    for value in (None, '', 'Interactive', 'BULK', 'standard', 'gold'):
        assert _outcome(tqos.validate_class, value) == \
            _outcome(jqos.validate_class, value)
        assert tqos.class_rank(value) == jqos.class_rank(value)
    assert (tqos.PRIORITY_CLASSES, tqos.DEFAULT_CLASS, tqos.DEFAULT_WEIGHTS,
            tqos.TENANT_HEADER, tqos.CLASS_HEADER) == (
                jqos.PRIORITY_CLASSES, jqos.DEFAULT_CLASS,
                jqos.DEFAULT_WEIGHTS, jqos.TENANT_HEADER, jqos.CLASS_HEADER)


def test_qos_config_from_env_matches_jax(monkeypatch):
    rng = np.random.default_rng(3)
    for _ in range(30):
        for name in _QOS_ENV:
            monkeypatch.delenv(name, raising=False)
        if rng.uniform() < 0.7:
            monkeypatch.setenv('SKYTPU_QOS_TENANT_RATE',
                               str(round(float(rng.uniform(0, 100)), 2)))
        if rng.uniform() < 0.5:
            monkeypatch.setenv('SKYTPU_QOS_TENANT_BURST',
                               str(int(rng.integers(1, 500))))
        monkeypatch.setenv('SKYTPU_QOS_MAX_QUEUE',
                           str(int(rng.integers(0, 9))))
        monkeypatch.setenv('SKYTPU_QOS_PREEMPT_AFTER_S',
                           str(round(float(rng.uniform(0, 2)), 3)))
        monkeypatch.setenv('SKYTPU_QOS_DISABLE', str(int(rng.integers(0, 2))))
        monkeypatch.setenv('SKYTPU_QOS_WEIGHTS',
                           f'interactive={int(rng.integers(1, 20))}')
        assert tqos.qos_config_from_env() == jqos.qos_config_from_env()
        assert tqos.parse_weights() == jqos.parse_weights()


# ====================================================== engine setup
class FakeClock:
    """Stands in for the ``time`` module of one engine module: every
    clock reads ``t``, and ``sleep`` advances it."""

    def __init__(self, t=1_000_000.0):
        self.t = t

    def time(self):
        return self.t

    monotonic = perf_counter = time

    def sleep(self, s):
        self.t += s


@pytest.fixture(scope='module')
def models():
    jcfg = jmodels.LlamaConfig.tiny(max_seq=256)
    jparams = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(
        jax.tree.map(np.asarray, jparams), device='cpu')
    return jcfg, jparams, tllama.LlamaConfig.tiny(max_seq=256), tparams


class Side:
    """One engine package under test: its module, engine and clock."""

    def __init__(self, name, mod, engine, clock):
        self.name, self.mod, self.eng, self.clock = name, mod, engine, clock
        self.log = []

    def request(self, rid, tokens, max_new, **kw):
        return self.mod.Request(rid, tokens, max_new=max_new, **kw)

    def submit(self, *a, **kw):
        self.eng.submit(self.request(*a, **kw))

    def step(self):
        self.eng.step()
        self.log.append((tuple(r.request_id for r in list(self.eng.queue)),
                         tuple(None if s is None else s.request_id
                               for s in self.eng.slots)))

    def drain(self):
        out = {}
        while self.eng.queue or self.eng.num_active() or \
                self.eng.has_pending:
            self.step()
            out.update(self.eng.drain_results())
        out.update(self.eng.drain_results())
        return out


def _sides(models, monkeypatch, warm=False, jax_max_seq=None, **kw):
    """The JAX and the port engine on the same settings. ``jax_max_seq``
    gives the JAX engine a longer cache: a decode region its slots share
    that never binds, which is what the port's admission (each slot owns
    its decode columns) equals."""
    jcfg, jparams, tcfg, tparams = models
    base = dict(batch_size=1, max_prompt=32, max_seq=96, decode_chunk=4,
                prefill_chunk=16, page=8)
    base.update(kw)
    out = []
    for name, mod, params, cfg, extra in (
            ('jax', jse, jparams, jcfg,
             {} if jax_max_seq is None else {'max_seq': jax_max_seq}),
            ('port', tse, tparams, tcfg, {'device': 'cpu'})):
        clock = FakeClock()
        monkeypatch.setattr(mod, 'time', clock)
        eng = mod.ServingEngine(params, cfg, **{**base, **extra})
        if warm:
            eng.warmup()
        out.append(Side(name, mod, eng, clock))
    return out


def _prompt(n, seed, vocab=256):
    rng = np.random.default_rng(seed)
    return [int(t) for t in rng.integers(1, vocab, n)]


_TIMED = ('skytpu_engine_ttft_p99_seconds', 'skytpu_engine_itl_p99_seconds',
          'skytpu_engine_est_wait_seconds',
          'skytpu_engine_class_ttft_p99_seconds')


def _counters(mod):
    """The wall-clock-free engine series of ``metrics.summary()``:
    counters, gauges of state and histogram counts (no sums, no
    latency-derived gauges)."""
    return {k: v for k, v in mod.summary().items()
            if k.startswith(('skytpu_engine_', 'skytpu_faults_'))
            and not k.endswith('_sum') and not k.startswith(_TIMED)}


def _view(results):
    return {rid: (r.status, r.reason, list(r.tokens))
            for rid, r in results.items()}


def _assert_same(j, t, jres, tres):
    assert t.log == j.log                     # admission order, per tick
    assert _view(tres) == _view(jres)
    assert _counters(tmetrics) == _counters(jmetrics)


# ================================================== FIFO equivalence
def test_untagged_traffic_bitwise_equals_legacy_fifo(models, monkeypatch):
    """Untagged traffic never engages the scheduler, and the
    SKYTPU_QOS_DISABLE kill switch keeps tagged traffic (with buckets
    configured) on the same FIFO path: the four runs agree."""
    prompts = [_prompt(6 + 2 * i, 100 + i) for i in range(4)]
    runs = []
    for tagged in (False, True):
        if tagged:
            monkeypatch.setenv('SKYTPU_QOS_DISABLE', '1')
            monkeypatch.setenv('SKYTPU_QOS_TENANT_RATE', '100')
        j, t = _sides(models, monkeypatch, batch_size=2)
        for side in (j, t):
            for i, p in enumerate(prompts):
                kw = dict(tenant=f'tenant-{i % 2}',
                          priority_class=('interactive', 'bulk')[i % 2]
                          ) if tagged else {}
                side.submit(i, p, 6, **kw)
        jres, tres = j.drain(), t.drain()
        assert j.eng._qos_active is t.eng._qos_active is False
        _assert_same(j, t, jres, tres)
        runs.append((t.log, _view(tres)))
        jmetrics.REGISTRY.reset()
        tmetrics.REGISTRY.reset()
    assert runs[0] == runs[1]
    assert all(s == 'finished' for s, _, _ in runs[0][1].values())


# =============================================== weighted admission
def test_interactive_jumps_earlier_queued_bulk(models, monkeypatch):
    j, t = _sides(models, monkeypatch)
    for side in (j, t):
        side.submit('b', _prompt(8, 1), 8, tenant='noisy',
                    priority_class='bulk')
        side.submit('i', _prompt(8, 2), 4, tenant='victim',
                    priority_class='interactive')
        assert side.eng._qos_active is True
        side.step()
        assert {s.request_id for s in side.eng.slots if s} == {'i'}
    jres, tres = j.drain(), t.drain()
    _assert_same(j, t, jres, tres)
    assert tres['i'].status == tres['b'].status == 'finished'


def test_broke_tenant_bucket_skipped_not_head_blocking(models, monkeypatch):
    monkeypatch.setenv('SKYTPU_QOS_TENANT_RATE', '0.001')
    monkeypatch.setenv('SKYTPU_QOS_TENANT_BURST', '100')
    picks = []
    for side in _sides(models, monkeypatch):
        side.submit('a1', _prompt(8, 3), 8, tenant='a',
                    priority_class='interactive')
        side.submit('a2', _prompt(8, 4), 8, tenant='a',
                    priority_class='interactive')
        side.submit('b1', _prompt(8, 5), 8, tenant='b',
                    priority_class='interactive')
        bkt = side.eng._bucket_for('a')
        assert bkt.spend(95.0, side.clock.monotonic())
        idx = side.eng._qos_select()
        picks.append((side.eng.queue[idx].request_id, bkt.tokens,
                      dict(side.eng._drr._deficit)))
    assert picks[1] == picks[0]
    assert picks[1][0] == 'b1'


# ================================================= shedding/preempt
def test_queue_pressure_sheds_bulk_first_newest_first(models, monkeypatch):
    monkeypatch.setenv('SKYTPU_QOS_MAX_QUEUE', '2')
    j, t = _sides(models, monkeypatch, warm=True)
    for side in (j, t):
        side.submit('i1', _prompt(8, 6), 4, tenant='v',
                    priority_class='interactive')
        side.submit('s1', _prompt(8, 7), 4, tenant='w',
                    priority_class='standard')
        side.submit('b1', _prompt(8, 8), 4, tenant='n',
                    priority_class='bulk')
        side.submit('b2', _prompt(8, 9), 4, tenant='n',
                    priority_class='bulk')
        side.step()
        shed = side.eng.drain_results()
        assert set(shed) == {'b1', 'b2'}
        assert {(r.status, r.reason) for r in shed.values()} == {
            ('cancelled', 'shed_by_priority')}
    jres, tres = j.drain(), t.drain()
    _assert_same(j, t, jres, tres)
    assert tmetrics.REGISTRY.get('skytpu_engine_sheds_total').value(
        **{'class': 'bulk'}) == 2
    assert tres['i1'].status == tres['s1'].status == 'finished'


def test_sustained_overload_preempts_bulk_slot(models, monkeypatch):
    monkeypatch.setenv('SKYTPU_QOS_PREEMPT_AFTER_S', '0.01')
    j, t = _sides(models, monkeypatch, warm=True)
    res = []
    for side in (j, t):
        side.submit('b', _prompt(8, 10), 24, tenant='noisy',
                    priority_class='bulk')
        for _ in range(20):
            side.step()
            if {s.request_id for s in side.eng.slots if s} == {'b'}:
                break
        side.submit('i', _prompt(8, 11), 4, tenant='victim',
                    priority_class='interactive')
        side.step()                  # arms the blocked timer
        side.clock.sleep(0.03)
        got = side.eng.drain_results()
        got.update(side.drain())
        res.append(got)
    _assert_same(j, t, *res)
    tres = res[1]
    assert (tres['b'].status, tres['b'].reason) == (
        'cancelled', 'preempted_by_priority')
    assert tres['i'].status == 'finished' and len(tres['i'].tokens) == 4
    assert 0 < len(tres['b'].tokens) < 24
    assert tmetrics.REGISTRY.get('skytpu_engine_preempted_total').value(
        **{'class': 'bulk'}) == 1


# ======================================== class-aware deadline estimate
def _queued(models, monkeypatch, priority_class, n=8):
    sides = _sides(models, monkeypatch, batch_size=4, decode_chunk=8)
    for side in sides:
        side.eng._tick_ewma = 0.05
        for k in range(n):
            side.submit(f'q{k}', _prompt(16, 20 + k), 8, tenant='bg',
                        priority_class=priority_class)
        assert side.eng._qos_active is True
    return sides


def test_estimate_wait_excludes_lower_class_backlog(models, monkeypatch):
    j, t = _queued(models, monkeypatch, 'bulk')
    for cls in ('interactive', 'standard', 'bulk', None):
        assert t.eng.estimate_wait_s(8, 4, priority_class=cls) == \
            j.eng.estimate_wait_s(8, 4, priority_class=cls)
    assert t.eng.estimate_wait_s(8, 4, priority_class='interactive') == \
        pytest.approx(0.1)
    assert t.eng.estimate_wait_s(8, 4, priority_class='bulk') == \
        pytest.approx(0.3)


def test_deadline_shed_admits_interactive_sheds_bulk(models, monkeypatch):
    """The front end's deadline-shed test (estimated wait over the
    remaining budget) on the port's estimate: at the same queue depth
    the interactive request is admitted and the bulk one shed, as the
    JAX engine decides."""
    j, t = _queued(models, monkeypatch, 'bulk')
    toks = _prompt(8, 40)
    left = 0.2
    for side in (j, t):
        admit = {cls: side.eng.estimate_wait_s(
            len(toks), 4, tokens=toks, priority_class=cls) <= left
            for cls in ('interactive', 'bulk')}
        assert admit == {'interactive': True, 'bulk': False}


# ================================================= chaos burst site
def test_tenant_burst_fault_site_injects_tagged_requests(models,
                                                         monkeypatch):
    assert 'engine.tenant.burst' in tfi.KNOWN_SITES
    plan = [{'site': 'engine.tenant.burst', 'kind': 'tenant_burst',
             'times': 1,
             'params': {'tenant': 'mal', 'n': 3, 'prompt_len': 8,
                        'max_new': 2, 'priority_class': 'bulk', 'seed': 7}}]
    j, t = _sides(models, monkeypatch, batch_size=2)
    res = []
    for side, fi in ((j, jfi), (t, tfi)):
        with fi.fault_plan(faults=plan):
            side.step()
            live = ({r.request_id: (r.tenant, list(r.tokens))
                     for r in list(side.eng.queue)} |
                    {s.request_id: (s.tenant, s.prompt)
                     for s in side.eng.slots if s})
            assert sorted(live) == [f'burst-mal-{k}' for k in (1, 2, 3)]
            assert side.eng._qos_active is True
            res.append((live, side.drain()))
    assert res[1][0] == res[0][0]
    _assert_same(j, t, res[0][1], res[1][1])
    assert tmetrics.REGISTRY.get('skytpu_faults_injected_total').value(
        site='engine.tenant.burst', kind='tenant_burst') == 1


# ========================================== seeded burst isolation
def _replay(side, trace, tick=0.02):
    """Open-loop replay on the side's fake clock: arrivals at their
    trace times, each engine tick taking ``tick`` fake seconds. Returns
    {request id: (status, ttft in fake seconds)}."""
    ordered = sorted(trace, key=lambda r: (r.arrival_s, r.request_id))
    clock, eng = side.clock, side.eng
    start, i = clock.t, 0
    submitted, first, results = {}, {}, {}
    eng.on_token = lambda rid, toks: first.setdefault(rid, clock.t - start)
    while i < len(ordered) or eng.queue or eng.num_active() or \
            eng.has_pending:
        while i < len(ordered) and ordered[i].arrival_s <= clock.t - start:
            r = ordered[i]
            i += 1
            submitted[r.request_id] = clock.t - start
            side.submit(r.request_id, list(r.tokens), r.max_new,
                        tenant=r.tenant, priority_class=r.priority_class)
        if eng.queue or eng.num_active() or eng.has_pending:
            side.step()
            clock.sleep(tick)
        else:
            clock.t = start + ordered[i].arrival_s
        results.update(eng.drain_results())
    return results, {rid: first[rid] - submitted[rid] for rid in first}


def test_burst_isolation_ab_engine_level(models, monkeypatch):
    """The seeded victim trace under a 10x bulk flood, QoS on and under
    the SKYTPU_QOS_DISABLE FIFO control, on both engines: each arm's
    admission order, Results and counters equal the JAX engine's with a
    decode region that never binds (the port's slots own their decode
    columns; a shared 96-column region would hold admissions back that
    the port makes), and QoS keeps the victim's mean TTFT a multiple
    below the FIFO arm's."""
    spec = loadgen.WorkloadSpec(
        seed=13, arrival='uniform', vocab_size=256,
        prompt_median=16, prompt_sigma=0.0, prompt_min=4,
        prompt_max=48, output_median=4, output_sigma=0.0,
        output_min=1, output_max=8,
        tenants=[
            loadgen.TenantSpec('victim', 'interactive',
                               n_requests=6, qps=40.0),
            loadgen.TenantSpec('noisy', 'bulk', n_requests=18,
                               qps=60.0, prompt_median=32,
                               output_median=6),
        ])
    trace = loadgen.generate(spec)
    victims = {r.request_id for r in trace if r.tenant == 'victim'}
    means = {}
    for arm, env in (('qos', {'SKYTPU_QOS_TENANT_RATE': '400',
                              'SKYTPU_QOS_TENANT_BURST': '400',
                              'SKYTPU_QOS_PREEMPT_AFTER_S': '0.01'}),
                     ('fifo', {'SKYTPU_QOS_DISABLE': '1'})):
        for name in _QOS_ENV:
            monkeypatch.delenv(name, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        j, t = _sides(models, monkeypatch, batch_size=2, max_prompt=64,
                      max_seq=160, jax_max_seq=64 + 2048)
        (jres, jttft), (tres, tttft) = _replay(j, trace), _replay(t, trace)
        _assert_same(j, t, jres, tres)
        assert tttft == jttft
        assert all(tres[v].status == 'finished' for v in victims)
        means[arm] = float(np.mean([tttft[v] for v in victims]))
        jmetrics.REGISTRY.reset()
        tmetrics.REGISTRY.reset()
    assert means['qos'] * 2 < means['fifo'], means
