"""The engine tick as one program, on the CPU (the eager path) against
the JAX package at ``tiny()`` in f32.

- The tick primitives on the cache's device ``steps`` (each row's own
  decode column count):
  ``prefill_chunk`` on device metadata (dead rows repeating a live
  row's slot) leaves JAX's cache — int8 payloads and scales bitwise,
  f32 K/V within 1e-5, dmask and lengths equal — and its live rows'
  logits within 1e-4; the dead rows are inert bit for bit (the same
  cache as without them); ``decode_step`` and ``verify_step`` follow on
  the same cache as JAX's (the active rows' logits and tokens; an idle
  row keeps its count, reads no cache column, and is compared on the
  columns it may read).
- No host read in a tick body: the decode, mixed (with decode, prefill
  only, with verify) and verify bodies run with ``Tensor.item``,
  ``tolist``, ``numpy``, ``__bool__``, ``__int__`` and ``__index__``
  patched to raise; a ``tiny_moe`` model's too (dropless and capacity
  dispatch, dense and int8 expert banks).
- The key set: the JAX engine's ``warmup()`` compiles (``_decode``,
  ``_mixed``, ``_spec`` cache sizes) less its tail chunks, which only a
  shared decode region needs: the port's decode ticks all run the main
  chunk, over every page count a row's own columns reach; its verify
  programs are JAX's, spec off and on; every key a ragged eager run
  dispatches lies in that set (the counterparts of
  ``tests/unit_tests/test_chunked_prefill.py:300-330`` and
  ``tests/unit_tests/test_spec_decode.py:428-456``).
- ``reset()`` restores the cache in place (every tensor keeps its
  ``data_ptr()`` and equals a fresh ``make_cache``); a run that
  recycles every slot rebuilds nothing.
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
from skypilot_tpu.ops import decode_attention as jdec
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


def _assert_like_jax(jc, tc, counts=None):
    """The port's cache equals JAX's; ``counts`` is each row's expected
    own decode column count (default: JAX's shared ``steps`` for every
    row). A row that sat out steps wrote its idle K/V at its own
    frontier, where JAX wrote them at the shared column: it is compared
    on its prompt region and the columns it may read."""
    steps = int(jc['steps'])
    counts = np.full((B,), steps) if counts is None else np.asarray(counts)
    dmask = np.asarray(jc['dmask'])
    cols = np.arange(MAX_SEQ)[None, :]
    keep = (counts == steps)[:, None] | dmask | (cols < MAX_PROMPT)
    for f in ('k', 'v', 'k_scale', 'v_scale'):
        if f not in jc:
            continue
        j, t = np.asarray(jc[f])[:, keep], tc[f]
        if t.dtype == torch.bfloat16:
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy()[:, keep], j.view(np.int16),
                err_msg=f)
        elif t.dtype == torch.int8:
            np.testing.assert_array_equal(t.numpy()[:, keep], j, err_msg=f)
        else:
            np.testing.assert_allclose(t.numpy()[:, keep], j,
                                       atol=ATOL_CACHE, rtol=0, err_msg=f)
    np.testing.assert_array_equal(tc['dmask'].numpy(), dmask)
    np.testing.assert_array_equal(tc['length'].numpy(),
                                  np.asarray(jc['length']))
    assert tc['steps'].shape == (B,) and tc['steps'].dtype == torch.int32
    np.testing.assert_array_equal(tc['steps'].numpy(), counts)


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
        # An idle row's logits (which no caller keeps) attend to its
        # own K/V alone in the port: the active rows' are compared.
        np.testing.assert_allclose(tlg.numpy()[active],
                                   np.asarray(jlg)[active],
                                   atol=ATOL_LOGITS, rtol=0)
        tok = np.asarray(jnp.argmax(jlg, -1)).astype(np.int32)
        assert (tlg.argmax(-1).numpy()[active] == tok[active]).all()
    _assert_like_jax(jc, tc, np.where(active, 2, 0))
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
    _assert_like_jax(jc, tc, np.where(active, 2 + drafts.shape[1] + 1, 0))
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
    # The patch is gone again; the active rows moved their counts.
    assert int(eng.cache['steps'].max()) > 0


@pytest.mark.parametrize('dispatch', ['dropless', 'capacity'])
@pytest.mark.parametrize('bank', ['dense', 'int8'])
def test_moe_tick_bodies_read_nothing_on_the_host(dispatch, bank):
    """A MoE layer's routing (expert counts, top-k, sorted dispatch) and
    its expert products, on dense or int8 banks, read nothing on the
    host either: its ticks capture as a Llama model's do."""
    from skypilot_tpu.models import moe as jmoe
    from skypilot_tpu_torch.models import moe as tmoe
    jparams = jmoe.init_params(jmoe.MoEConfig.tiny_moe(),
                               jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(
        jax.tree.map(np.asarray, jparams), device='cpu')
    tcfg = tmoe.MoEConfig.tiny_moe(infer_dispatch=dispatch,
                                   infer_capacity_factor=1.0)
    eng = tse.ServingEngine(tparams, tcfg, device='cpu', spec_decode=True,
                            spec_k=3, weight_quant=bank == 'int8',
                            **dict(ENGINE_KW, batch_size=2))
    inp = eng._in
    inp['active'][:] = 1
    inp['ctoks'][:] = torch.arange(16, dtype=torch.int32).reshape(2, 8)
    inp['clens'][:] = torch.tensor([8, 3], dtype=torch.int32)
    inp['clive'][:] = 1
    inp['cslots'][:] = torch.tensor([0, 1], dtype=torch.int32)
    inp['drafts'][:] = 7
    inp['spec_len'][:] = torch.tensor([3, 1], dtype=torch.int32)
    keys = eng._tick_keys()
    for key in (next(k for k in keys if k[0] == 'decode'),
                ('mixed', 0, None, 0),
                next(k for k in keys if k[0] == 'verify')):
        with _no_host_reads():
            out = eng._tick_body(key)
        assert out.dtype == torch.int32 and out.dim() == 1, key


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
    _check_key_set(models, spec)


@pytest.mark.parametrize('spec', [False, True], ids=['spec-off', 'spec-on'])
def test_lax_key_set_equals_the_reference_compiles(models, spec):
    """decode_attn='lax' (the cache-wide einsum): the same keys, one
    program per (chunk, page count), as the reference compiles them for
    its lax decode."""
    keys = _check_key_set(models, spec, decode_attn='lax')
    assert all(isinstance(k[2], int) for k in keys
               if k[0] == 'decode')


def _check_key_set(models, spec, **extra):
    kw = dict(spec_decode=True, spec_k=3) if spec else {}
    kw.update(extra)
    jeng = _jax_engine(models, **kw)
    jeng.warmup()
    want = {'decode': jeng._decode._cache_size(),
            'mixed': jeng._mixed._cache_size(),
            'verify': jeng._spec._cache_size() if spec else 0}
    eng = _engine(models, **kw)
    keys = eng._tick_keys()
    got = {kind: sum(k[0] == kind for k in keys) for kind in want}
    # The main chunk over every count a row's own columns reach, in the
    # reference's page policy; JAX adds its tail chunks to these.
    chunk = ENGINE_KW['decode_chunk']
    main = {jdec.num_pages_for(eng.max_prompt + c + chunk, PAGE,
                               eng._total_pages, base_pages=eng._base_pages)
            for c in range(eng.decode_capacity() + 1)}
    assert {k[1:] for k in keys if k[0] == 'decode'} == {
        (chunk, p) for p in main}
    assert got['decode'] == len(main) < want['decode']
    assert got['mixed'] - got['decode'] == want['mixed'] - want['decode']
    assert got['verify'] == want['verify']
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
    return keys


def test_chat_geometry_captures_nine_tick_programs():
    """At the benchmark's chat engines' geometry (max_prompt 3072,
    max_seq 4096, page 128, decode chunk 8, no speculation) the key set
    is the main chunk over four page counts (25, 26, 28 and 32 pages),
    as a decode and as a mixed tick, plus the prefill-only tick: 9
    programs to capture, where a shared region's tail chunks (4, 2 and
    1 steps near its end) made 15."""
    cfg = tllama.LlamaConfig.tiny()
    params = tllama.init_params(cfg, 0, device='cpu')
    eng = tse.ServingEngine(params, cfg, batch_size=1, max_prompt=3072,
                            max_seq=4096, decode_chunk=8, page=128,
                            prefill_chunk=512, prefill_budget=1024,
                            device='cpu')
    keys = eng._tick_keys()
    pages = [25, 26, 28, 32]
    assert keys == ([('decode', 8, p) for p in pages] +
                    [('mixed', 0, None, 0)] +
                    [('mixed', 8, p, 0) for p in pages])
    assert len(keys) == 9 < 15


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
    # 16 decode columns a slot for 6 requests of 6 tokens: each slot is
    # recycled in place (its occupant's count starts at 0), so a run
    # rebuilds nothing; reset() restores the cache in place.
    rng = np.random.default_rng(5)
    res = eng.run([tse.Request(i, rng.integers(0, 256, 6).tolist(),
                               max_new=6) for i in range(6)])
    assert all(len(r.tokens) == 6 for r in res.values())
    assert not restored, 'a run rebuilt the cache'
    assert 0 < int(eng.cache['steps'].max()) <= 32 - eng.max_prompt
    eng.reset()
    assert len(restored) == 1
