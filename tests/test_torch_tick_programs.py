"""The engine tick as one program, on the CPU (the eager path) against
the JAX package at ``tiny()`` in f32.

- The tick primitives on the cache's device ``steps`` scalar:
  ``prefill_chunk`` on device metadata (dead rows repeating a live
  row's slot) leaves JAX's cache — int8 payloads and scales bitwise,
  f32 K/V within 1e-5, dmask and lengths equal — and its live rows'
  logits within 1e-4; the dead rows are inert bit for bit (the same
  cache as without them); ``decode_step`` and ``verify_step`` follow on
  the same cache as JAX's (tokens exact).
- No host read in a tick body: the decode, mixed (with decode, prefill
  only, with verify) and verify bodies run with ``Tensor.item``,
  ``tolist``, ``numpy``, ``__bool__``, ``__int__`` and ``__index__``
  patched to raise.
- The key set: the port enumerates as many tick programs of each kind
  as the JAX engine compiles in ``warmup()`` (``_decode``, ``_mixed``,
  ``_spec`` cache sizes), spec off and on, and every key a ragged eager
  run dispatches lies in that set (the counterparts of
  ``tests/unit_tests/test_chunked_prefill.py:300-330`` and
  ``tests/unit_tests/test_spec_decode.py:428-456``).
- ``reset()`` and the capacity reset restore the cache in place: every
  tensor keeps its ``data_ptr()`` and equals a fresh ``make_cache``.
"""
import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu import models as jmodels
from skypilot_tpu.models import inference as jinf
from skypilot_tpu.models import serving_engine as jse
from skypilot_tpu_torch import convert
from skypilot_tpu_torch.models import inference as tinf
from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.models import serving_engine as tse
from skypilot_tpu_torch.utils import lifecycle

ATOL_CACHE = 1e-5
ATOL_LOGITS = 1e-4
B, MAX_PROMPT, MAX_SEQ, PAGE, C = 3, 32, 64, 8, 8
# The JAX key-set tests' engine (tests/unit_tests/test_spec_decode.py).
ENGINE_KW = dict(batch_size=4, max_prompt=16, max_seq=64, decode_chunk=4,
                 prefill_chunk=8, prefill_budget=16, page=PAGE)


@pytest.fixture(scope='module')
def models():
    jcfg = jmodels.LlamaConfig.tiny()
    jparams = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(
        jax.tree.map(np.asarray, jparams), device='cpu')
    return jcfg, jparams, tllama.LlamaConfig.tiny(), tparams


def _jax_cache(cfg, quant):
    kv_dtype = jnp.int8 if quant else cfg.compute_dtype
    shp = (cfg.n_layers, B, MAX_SEQ, cfg.n_kv_heads, cfg.head_dim)
    cache = {'k': jnp.zeros(shp, kv_dtype), 'v': jnp.zeros(shp, kv_dtype),
             'length': jnp.zeros((B,), jnp.int32),
             'dmask': jnp.zeros((B, MAX_SEQ), bool),
             'base': jnp.asarray(MAX_PROMPT, jnp.int32),
             'steps': jnp.zeros((), jnp.int32)}
    if quant:
        cache['k_scale'] = jnp.ones(shp[:4], jnp.bfloat16)
        cache['v_scale'] = jnp.ones(shp[:4], jnp.bfloat16)
    return cache


def _assert_like_jax(jc, tc):
    for f in ('k', 'v', 'k_scale', 'v_scale'):
        if f not in jc:
            continue
        j, t = np.asarray(jc[f]), tc[f]
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          j.view(np.int16), err_msg=f)
        elif t.dtype == torch.int8:
            np.testing.assert_array_equal(t.numpy(), j, err_msg=f)
        else:
            np.testing.assert_allclose(t.numpy(), j, atol=ATOL_CACHE,
                                       rtol=0, err_msg=f)
    np.testing.assert_array_equal(tc['dmask'].numpy(),
                                  np.asarray(jc['dmask']))
    np.testing.assert_array_equal(tc['length'].numpy(),
                                  np.asarray(jc['length']))
    assert tc['steps'].dim() == 0 and tc['steps'].dtype == torch.int32
    assert int(tc['steps']) == int(jc['steps'])


def _assert_bitwise(a, b):
    assert set(a) == set(b)
    for f in a:
        if isinstance(a[f], torch.Tensor):
            assert torch.equal(a[f], b[f]), f
        else:
            assert a[f] == b[f], f


def _chunk(rows, vocab, seed):
    """rows: [(slot, start, len, live)] -> tokens [G, C] and the [G]
    metadata as numpy."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (len(rows), C)).astype(np.int32)
    slots, starts, lens, live = (np.asarray([r[i] for r in rows])
                                 for i in range(4))
    return (toks, starts.astype(np.int32), lens.astype(np.int32),
            live.astype(bool), slots.astype(np.int32))


def _port_chunk(models, tc, toks, starts, lens, live, slots):
    """prefill_chunk on device (here: CPU tensor) metadata."""
    _, _, tcfg, tparams = models
    t = torch.from_numpy
    return tinf.prefill_chunk(tparams, tc, t(toks), t(starts), t(lens),
                              t(live), t(slots), tcfg,
                              prompt_base=MAX_PROMPT)


@pytest.mark.parametrize('quant', [False, True], ids=['f32kv', 'int8kv'])
def test_device_metadata_dead_rows_and_device_steps_match_jax(models,
                                                              quant):
    jcfg, jparams, tcfg, tparams = models
    jc = _jax_cache(jcfg, quant)
    tc = tinf.make_cache(tcfg, B, MAX_SEQ, base=MAX_PROMPT, kv_quant=quant,
                         device='cpu')
    ptrs = {f: t.data_ptr() for f, t in tc.items()
            if isinstance(t, torch.Tensor)}
    # Slot 2 at its second chunk, slot 0 and 1 starting; dead rows
    # aimed at live slots 0 and 2 (one before, one after the live row)
    # and at slot 1 with another start.
    tinf.prefill_chunk(tparams, tc, torch.zeros((1, C), dtype=torch.int32),
                       [0], [8], [True], [2], tcfg, prompt_base=MAX_PROMPT)
    jc = jinf.prefill_chunk(jparams, jc, jnp.zeros((1, C), jnp.int32),
                            jnp.asarray([0]), jnp.asarray([8]),
                            jnp.asarray([True]), jnp.asarray([2]), jcfg,
                            prompt_base=MAX_PROMPT)[1]
    live_rows = [(0, 0, 8, True), (2, 8, 5, True), (1, 0, 3, True)]
    dead_rows = [(0, 4, 2, False), (2, 0, 1, False), (1, 5, 1, False)]
    rows = [dead_rows[0], live_rows[0], live_rows[1], dead_rows[1],
            live_rows[2], dead_rows[2]]
    args = _chunk(rows, jcfg.vocab_size, seed=11)
    live_idx = [1, 2, 4]
    # Within the port: the dead rows are inert bit for bit — the same
    # call with every dead row replaced by the engine's padding row
    # (slot 0, start 0, len 1, zero tokens) leaves the same cache.
    padded = [a.copy() for a in args]
    for j in (0, 3, 5):
        padded[0][j] = 0
        padded[1][j], padded[2][j], padded[4][j] = 0, 1, 0
    other = {f: (t.clone() if isinstance(t, torch.Tensor) else t)
             for f, t in tc.items()}
    _port_chunk(models, other, *padded)
    tl, tc = _port_chunk(models, tc, *args)
    _assert_bitwise(tc, other)
    jl, jc = jax.jit(functools.partial(
        jinf.prefill_chunk, cfg=jcfg, prompt_base=MAX_PROMPT))(
            jparams, jc, *(jnp.asarray(a) for a in args))
    for j in live_idx:
        np.testing.assert_allclose(tl[j].numpy(), np.asarray(jl[j]),
                                   atol=ATOL_LOGITS, rtol=0)
    _assert_like_jax(jc, tc)
    # Decode steps and a verify step on the device steps scalar.
    active = np.asarray([True, True, False])
    tok = np.asarray([5, 9, 17], np.int32)
    for _ in range(2):
        jlg, jc = jinf.decode_step(jparams, jc, jnp.asarray(tok), jcfg,
                                   active=jnp.asarray(active),
                                   attn_impl='paged', num_pages=5,
                                   page=PAGE)
        tlg, tc = tinf.decode_step(tparams, tc, torch.from_numpy(tok), tcfg,
                                   active=torch.from_numpy(active),
                                   num_pages=5, page=PAGE)
        np.testing.assert_allclose(tlg.numpy(), np.asarray(jlg),
                                   atol=ATOL_LOGITS, rtol=0)
        tok = np.asarray(jnp.argmax(jlg, -1)).astype(np.int32)
        assert (tlg.argmax(-1).numpy() == tok).all()
    _assert_like_jax(jc, tc)
    drafts = np.asarray([[3, 4], [tok[1], 7], [1, 1]], np.int32)
    slen = np.asarray([2, 1, 2], np.int32)
    je, jn, jt, jc = jinf.verify_step(
        jparams, jc, jnp.asarray(tok), jnp.asarray(drafts),
        jnp.asarray(slen), jcfg, jax.random.PRNGKey(2),
        jnp.zeros((B,), jnp.float32), 0, active=jnp.asarray(active),
        num_pages=5, page=PAGE)
    te, tn, tt, tc = tinf.verify_step(
        tparams, tc, torch.from_numpy(tok), torch.from_numpy(drafts),
        torch.from_numpy(slen), tcfg, torch.zeros((B,)),
        active=torch.from_numpy(active), num_pages=5, page=PAGE)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    for row in range(B):
        n = int(jn[row])
        np.testing.assert_array_equal(te.numpy()[row, :n],
                                      np.asarray(je)[row, :n])
    _assert_like_jax(jc, tc)
    assert {f: t.data_ptr() for f, t in tc.items()
            if isinstance(t, torch.Tensor)} == ptrs


# ------------------------------------------------------------ engines


def _engine(models, **kw):
    return tse.ServingEngine(models[3], models[2], device='cpu',
                             **{**ENGINE_KW, **kw})


@contextlib.contextmanager
def _no_host_reads():
    """Every way a tensor's value reaches the host raises."""
    def refuse(name):
        def raiser(self, *a, **k):
            raise AssertionError(f'host read in a tick body: Tensor.{name}')
        return raiser
    names = ('item', 'tolist', 'numpy', '__bool__', '__int__', '__index__')
    saved = {n: torch.Tensor.__dict__.get(n) for n in names}
    try:
        for n in names:
            setattr(torch.Tensor, n, refuse(n))
        yield
    finally:
        for n in names:
            if saved[n] is None:
                delattr(torch.Tensor, n)
            else:
                setattr(torch.Tensor, n, saved[n])


@pytest.mark.parametrize('kv_quant', [False, True], ids=['f32kv', 'int8kv'])
def test_tick_bodies_read_nothing_on_the_host(models, kv_quant):
    eng = _engine(models, spec_decode=True, spec_k=3, kv_quant=kv_quant)
    keys = eng._tick_keys()
    # Meaningful inputs: two live chunk rows (one completing its
    # prompt), active rows, a sampling row, drafts.
    inp = eng._in
    inp['active'][:] = torch.tensor([1, 0, 1, 0], dtype=torch.int32)
    inp['temps'][:] = torch.tensor([0.0, 0.0, 0.7, 0.0])
    inp['ctoks'][:] = torch.arange(16, dtype=torch.int32).reshape(2, 8)
    inp['clens'][:] = torch.tensor([8, 3], dtype=torch.int32)
    inp['clive'][:] = 1
    inp['clast'][:] = torch.tensor([0, 1], dtype=torch.int32)
    inp['cslots'][:] = torch.tensor([1, 3], dtype=torch.int32)
    inp['drafts'][:] = 7
    inp['spec_len'][:] = torch.tensor([3, 0, 1, 0], dtype=torch.int32)
    picks = [next(k for k in keys if k[0] == 'decode'),
             ('mixed', 0, None, 0),
             next(k for k in keys if k[0] == 'mixed' and k[1]),
             next(k for k in keys if k[0] == 'mixed' and k[3]),
             next(k for k in keys if k[0] == 'verify')]
    for key in picks:
        with _no_host_reads():
            out = eng._tick_body(key)
        assert out.dtype == torch.int32 and out.dim() == 1, key
    # The patch is gone again.
    assert int(eng.cache['steps']) > 0


def _jax_engine(models, **kw):
    return jse.ServingEngine(models[1], models[0], **{**ENGINE_KW, **kw})


def _recording(eng):
    seen = set()
    launch = eng._launch

    def record(key):
        seen.add(key)
        return launch(key)
    eng._launch = record
    return seen


def _ragged(models, n, seed):
    rng = np.random.default_rng(seed)
    return [tse.Request(i, rng.integers(0, models[2].vocab_size,
                                        3 + (5 * i) % 14).tolist(),
                        max_new=3 + i % 4) for i in range(n)]


@pytest.mark.parametrize('spec', [False, True], ids=['spec-off', 'spec-on'])
def test_key_set_equals_the_reference_compiles(models, spec):
    kw = dict(spec_decode=True, spec_k=3) if spec else {}
    jeng = _jax_engine(models, **kw)
    jeng.warmup()
    want = {'decode': jeng._decode._cache_size(),
            'mixed': jeng._mixed._cache_size(),
            'verify': jeng._spec._cache_size() if spec else 0}
    eng = _engine(models, **kw)
    keys = eng._tick_keys()
    got = {kind: sum(k[0] == kind for k in keys) for kind in want}
    assert got == want
    assert len(set(keys)) == len(keys)
    # A ragged eager run dispatches only keys of the set.
    seen = _recording(eng)
    if spec:
        calls = {'n': 0}

        def lookup(chain, k):
            calls['n'] += 1
            return [] if calls['n'] % 3 == 0 else [int(chain[-1])] * k
        eng._lookup = lookup
    res = eng.run(_ragged(models, 10, seed=3 + spec))
    assert all(r.status == lifecycle.FINISHED for r in res.values())
    assert seen and seen <= set(keys), seen - set(keys)
    assert ('mixed', 0, None, 0) in seen
    if spec:
        assert any(k[0] == 'verify' or (k[0] == 'mixed' and k[3])
                   for k in seen)
    # The eager engine captures nothing.
    assert eng._graphs is None and eng.graph_captures == 0


@pytest.mark.parametrize('kv_quant', [False, True], ids=['f32kv', 'int8kv'])
def test_resets_restore_the_cache_in_place(models, kv_quant, monkeypatch):
    eng = _engine(models, kv_quant=kv_quant, max_seq=32)
    ptrs = {f: t.data_ptr() for f, t in eng.cache.items()
            if isinstance(t, torch.Tensor)}
    restored = []
    reset_cache = tinf.reset_cache

    def checked(cache):
        out = reset_cache(cache)
        assert cache is eng.cache
        assert {f: t.data_ptr() for f, t in cache.items()
                if isinstance(t, torch.Tensor)} == ptrs
        _assert_bitwise(tinf.make_cache(
            models[2], ENGINE_KW['batch_size'], 32, base=eng.max_prompt,
            kv_quant=kv_quant, device='cpu'), cache)
        restored.append(1)
        return out
    monkeypatch.setattr(tinf, 'reset_cache', checked)
    # 16 decode slots for 6 requests of 6 tokens: capacity resets.
    rng = np.random.default_rng(5)
    res = eng.run([tse.Request(i, rng.integers(0, 256, 6).tolist(),
                               max_new=6) for i in range(6)])
    assert all(len(r.tokens) == 6 for r in res.values())
    assert restored, 'no capacity reset ran'
    n_capacity = len(restored)
    eng.reset()
    assert len(restored) == n_capacity + 1
