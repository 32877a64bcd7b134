"""The PyTorch port's automatic prefix cache
(skypilot_tpu_torch/models/prefix_cache.py, utils/chain_hash.py,
serve/kv_transfer.py and its wiring in models/serving_engine.py)
against the JAX package, on the same numpy-seeded inputs and converted
params, at ``tiny()`` with page 8 and prefill chunk 8 so that short
prompts span several pages:

- chain hashes bitwise equal to JAX's;
- one sequence of pool calls (publish, acquire, eviction, all pinned,
  release) leaves the directory, the stats, the /health digest and the
  pool bits equal to a JAX pool's after every step;
- ``copy_into`` marks exactly [0, cached) readable, in place (every
  ``data_ptr()`` kept), as JAX's does, and sets the slot's own decode
  column count back to 0 (the other rows keep theirs);
- the engine with the cache on gives the JAX engine's greedy tokens and
  the cache-off engine's, with the reference's reuse (24/0/8/16/16),
  hits and tokens saved; COW isolation, slot recycling, a cancel
  mid-prefill, suffix-only admission charging, int8 KV and speculation
  with the cache on;
- SKKV1: bf16, int8 and f32 pages encode to the JAX pool's bytes, each
  side decodes the other's, imports round-trip bitwise, and a JAX
  engine's pages served through ``queue_kv_import`` give hits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu import models as jmodels
from skypilot_tpu.models import prefix_cache as jprefix
from skypilot_tpu.models import serving_engine as jse
from skypilot_tpu.serve import kv_transfer as jwire
from skypilot_tpu.utils import chain_hash as jhash
from skypilot_tpu_torch import convert
from skypilot_tpu_torch.models import inference as tinf
from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.models import prefix_cache as tprefix
from skypilot_tpu_torch.models import serving_engine as tse
from skypilot_tpu_torch.serve import kv_transfer as twire
from skypilot_tpu_torch.utils import chain_hash as thash
from skypilot_tpu_torch.utils import lifecycle

PAGE = 8


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope='module')
def models():
    jcfg = jmodels.LlamaConfig.tiny()
    jparams = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(
        jax.tree.map(np.asarray, jparams), device='cpu')
    return jcfg, jparams, tllama.LlamaConfig.tiny(), tparams


def _prompt(n, seed, vocab=256):
    return [int(t) for t in np.random.default_rng(seed).integers(0, vocab,
                                                                n)]


def _engine(models, **kw):
    """A port engine with the reference tests' defaults, cache on."""
    _, _, tcfg, tparams = models
    kw = {**dict(batch_size=2, max_prompt=32, max_seq=160, decode_chunk=4,
                 prefill_chunk=8, prefill_budget=16, page=PAGE,
                 prefix_cache=True, prefix_pool_pages=16), **kw}
    return tse.ServingEngine(tparams, tcfg, device='cpu', **kw)


def _oracle(models, prompt, max_new):
    """The port's cache-free greedy reference for one prompt."""
    _, _, tcfg, tparams = models
    toks = torch.tensor([prompt], dtype=torch.int64)
    return tinf.reference_generate(tparams, toks, [len(prompt)], tcfg,
                                   max_new)[0].tolist()


def _run(eng, rid, prompt, max_new):
    res = eng.run([tse.Request(rid, list(prompt), max_new=max_new)])[rid]
    assert res.status == lifecycle.FINISHED
    return res.tokens


# ------------------------------------------------------ chain hashes


@pytest.mark.parametrize('page', [1, 3, 8, 16])
def test_page_hashes_equal_jax_bitwise(page):
    tokens = _prompt(5 * page + 3, seed=page, vocab=1 << 20)
    for n in (0, page - 1, page, 5 * page + 3):
        got = thash.page_hashes(tokens[:n], page)
        assert got == jhash.page_hashes(tokens[:n], page)
        assert len(got) == n // page
        assert all(len(h) == thash.DIGEST_SIZE == jhash.DIGEST_SIZE
                   for h in got)
    # Digests commit to the whole prefix: one early token changes all.
    other = [tokens[0] + 1] + tokens[1:]
    assert not set(thash.page_hashes(other, page)) & set(
        thash.page_hashes(tokens, page))
    hexes = [h.hex() for h in thash.page_hashes(tokens, page)]
    adv = frozenset(hexes[:2] + hexes[3:])
    assert thash.match_len(hexes, adv) == jhash.match_len(hexes, adv) == 2
    assert thash.SUMMARY_SCHEMA_VERSION == jhash.SUMMARY_SCHEMA_VERSION


# -------------------------------------------------- the pool directory


def _directory(pc):
    return (dict(pc._by_hash), list(pc._hash_of), list(pc._refs),
            list(pc._stamp), list(pc._free), pc.version, pc.stats(),
            pc.prefix_summary(), pc.prefix_summary(sample=1))


def _pool_bits(pool):
    out = {}
    for f, a in pool.items():
        if isinstance(a, torch.Tensor):
            a = (a.view(torch.int16).numpy().view(np.uint16)
                 if a.dtype == torch.bfloat16 else a.numpy())
        else:
            a = np.asarray(a)
            a = a.view(np.uint16) if a.dtype.name == 'bfloat16' else a
        out[f] = a
    return out


def _assert_same_pool(jpc, tpc):
    assert _directory(tpc) == _directory(jpc)
    jb, tb = _pool_bits(jpc.pool), _pool_bits(tpc.pool)
    assert set(jb) == set(tb)
    for f in jb:
        np.testing.assert_array_equal(tb[f], jb[f], err_msg=f)


def test_pool_sequence_matches_jax_directory_and_bits(models):
    """The counterpart of the reference's
    test_eviction_lru_and_pinned_pages_never_evicted, driven on a JAX
    pool and a port pool at once: after every call the directory,
    refs, LRU stamps, free list, version, stats, /health digest and the
    pool bits are equal."""
    jcfg, _, tcfg, _ = models
    jpc = jprefix.PrefixCache(jcfg, page=PAGE, pool_pages=2)
    tpc = tprefix.PrefixCache(tcfg, page=PAGE, pool_pages=2, device='cpu')
    shp = (tcfg.n_layers, 1, 64, tcfg.n_kv_heads, tcfg.head_dim)
    rng = np.random.default_rng(0)

    def publish(tokens):
        k, v = (rng.standard_normal(shp).astype(np.float32)
                for _ in range(2))
        jpc.publish(tokens, len(tokens), {'k': jnp.asarray(k),
                                          'v': jnp.asarray(v)}, 0)
        tpc.publish(tokens, len(tokens), {'k': torch.from_numpy(k),
                                          'v': torch.from_numpy(v)}, 0)
        _assert_same_pool(jpc, tpc)

    def acquire(rid, tokens):
        got = tpc.acquire(rid, tokens, chunk=PAGE)
        assert got == jpc.acquire(rid, tokens, chunk=PAGE)
        _assert_same_pool(jpc, tpc)
        return got

    tok = {c: list(range(100 * c, 100 * c + 8)) for c in range(1, 5)}
    _assert_same_pool(jpc, tpc)
    publish(tok[1])
    publish(tok[2])
    reuse, pages, hashes = acquire('r1', tok[1] + [1])
    assert reuse == 8 and pages == [0] and len(hashes) == 1
    assert tpc.pinned_pages() == 1
    publish(tok[3])                         # evicts page 2 (unpinned)
    assert tpc.evictions == 1
    assert tpc.match_pages(tok[1] + [1]) and not tpc.match_pages(
        tok[2] + [1])
    acquire('r2', tok[3] + [2])
    publish(tok[4])                         # all pinned: a no-op
    assert tpc.evictions == 1 and tpc.stats()['occupied'] == 2
    tpc.release('r1')
    jpc.release('r1')
    _assert_same_pool(jpc, tpc)
    publish(tok[4])                         # LRU: evicts page 1
    assert tpc.evictions == 2 and tpc.match_pages(tok[4] + [1])
    assert tpc.would_reuse(tok[1] + [1], PAGE,
                           thash.page_hashes(tok[1], PAGE)) == 8
    assert (tpc.reusable_tokens(tok[4] + [9], PAGE) ==
            jpc.reusable_tokens(tok[4] + [9], PAGE) == 8)
    tpc.release('r2')
    jpc.release('r2')
    tpc.release('r2')                       # idempotent
    _assert_same_pool(jpc, tpc)
    assert tpc.pinned_pages() == 0


@pytest.mark.parametrize('kv_quant', [False, True], ids=['f32', 'int8'])
def test_copy_into_fixes_the_mask_in_place_like_jax(models, kv_quant):
    """The counterpart of test_copy_into_mask_fix_clears_previous_
    occupant: the row reads exactly [0, cached), its pages hold the
    pool's bits, the other row is untouched — equal to JAX's copy_into
    — and every cache tensor keeps its address; the new occupant's own
    decode column count starts at 0, the other row keeps its count."""
    jcfg, _, tcfg, _ = models
    s_max, batch = 64, 2
    cache = tinf.make_cache(tcfg, batch, s_max, base=32, kv_quant=kv_quant,
                            device='cpu')
    rng = np.random.default_rng(1)
    for f in ('k', 'v', 'k_scale', 'v_scale'):
        if f in cache:
            x = np.clip(rng.standard_normal(tuple(cache[f].shape)) * 50,
                        -127, 127)
            cache[f].copy_(torch.from_numpy(x).to(cache[f].dtype))
    cache['dmask'].fill_(True)
    cache['length'].fill_(50)
    cache['steps'].fill_(7)
    jpc = jprefix.PrefixCache(jcfg, page=PAGE, pool_pages=4,
                              kv_quant=kv_quant)
    tpc = tprefix.PrefixCache(tcfg, page=PAGE, pool_pages=4,
                              kv_quant=kv_quant, device='cpu')
    jcache = {f: jnp.asarray(_pool_bits({f: t})[f].view(
        jnp.bfloat16) if t.dtype == torch.bfloat16 else t.numpy())
        for f, t in cache.items() if isinstance(t, torch.Tensor)}
    # Publish row 1's first three pages, then copy two into row 0.
    toks = _prompt(24, seed=3)
    tpc.publish(toks, 24, cache, 1)
    jpc.publish(toks, 24, jcache, 1)
    before = {f: t.clone() for f, t in cache.items()
              if isinstance(t, torch.Tensor)}
    ptrs = {f: t.data_ptr() for f, t in cache.items()
            if isinstance(t, torch.Tensor)}
    out = tpc.copy_into(cache, 0, [0, 1], 16)
    jout = jpc.copy_into(jcache, 0, [0, 1], 16)
    assert out is cache
    assert {f: t.data_ptr() for f, t in cache.items()
            if isinstance(t, torch.Tensor)} == ptrs
    assert cache['steps'].tolist() == [0, 7]
    assert (cache['dmask'][0].numpy() == (np.arange(s_max) < 16)).all()
    assert int(cache['length'][0]) == 16
    assert torch.equal(cache['dmask'][1], before['dmask'][1])
    assert int(cache['length'][1]) == 50
    got, want = _pool_bits(cache), _pool_bits(jout)
    for f in ('k', 'v', 'k_scale', 'v_scale', 'dmask', 'length'):
        if f in cache:
            np.testing.assert_array_equal(got[f], np.asarray(want[f]),
                                          err_msg=f)
    for f in tpc._fields:
        assert torch.equal(cache[f][:, 0, :16], before[f][:, 1, :16])
        assert torch.equal(cache[f][:, 0, 16:], before[f][:, 0, 16:])
        assert torch.equal(cache[f][:, 1], before[f][:, 1])


def test_prefix_cache_defaults_to_cuda_and_raises_without_a_gpu(models):
    if torch.cuda.is_available():
        pytest.skip('this box has a GPU: the CPU-only rule cannot show')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tprefix.PrefixCache(models[2], page=PAGE, pool_pages=2)
    with pytest.raises(ValueError, match='positive'):
        tprefix.PrefixCache(models[2], page=0, pool_pages=2, device='cpu')


def test_export_page_rereads_when_the_page_moves_under_it(models):
    """The directory is checked around the host copy: a page evicted
    and rewritten under a read is retried (and a page that is gone
    reads as a miss), never returned torn."""
    tcfg = models[2]
    pc = tprefix.PrefixCache(tcfg, page=PAGE, pool_pages=1, device='cpu')
    shp = (tcfg.n_layers, 1, 16, tcfg.n_kv_heads, tcfg.head_dim)
    a = {'k': torch.ones(shp), 'v': torch.ones(shp)}
    b = {'k': torch.full(shp, 2.0), 'v': torch.full(shp, 2.0)}
    ta, tb = list(range(8)), list(range(50, 58))
    ha = thash.page_hashes(ta, PAGE)[0]
    pc.publish(ta, 8, a, 0)
    read = pc._read_page
    events = []

    def racing(idx, swap):
        blk = read(idx)
        if not events:
            events.append(idx)
            pc.publish(tb, 8, b, 0)        # evicts A, page 0 now holds B
            if swap:
                pc.publish(ta, 8, a, 0)    # ... and A again (ABA)
        return blk

    pc._read_page = lambda idx: racing(idx, swap=False)
    assert pc.export_page(ha) is None
    events.clear()
    pc.publish(ta, 8, a, 0)                # A back (evicts B)
    pc._read_page = lambda idx: racing(idx, swap=True)
    blk = pc.export_page(ha)
    assert len(events) == 1 and (blk['k'] == 1).all()


# ------------------------------------------------------- the engine


def test_hit_miss_and_divergence_match_jax_and_cache_off(models):
    """The counterpart of test_hit_miss_partial_and_divergence_parity:
    a publisher, then a full hit, a miss and divergences at page-1,
    page and page+1 (page 8): tokens equal the JAX engine's (cache on)
    and the port's cache-off engine's, reuse is 24/0/8/16/16 on both
    sides, and hits and tokens saved agree."""
    jcfg, jparams = models[0], models[1]
    kw = dict(batch_size=2, max_prompt=32, max_seq=160, decode_chunk=4,
              prefill_chunk=8, prefill_budget=16, page=PAGE,
              prefix_pool_pages=16)
    jeng = jse.ServingEngine(jparams, jcfg, prefix_cache=True, **kw)
    on = _engine(models)
    off = _engine(models, prefix_cache=False)
    assert off.prefix is None
    base = _prompt(32, seed=1)
    cases = [('pub', base, 0), ('full_hit', base, 24),
             ('miss', _prompt(20, 99), 0),
             ('div_15', base[:15] + _prompt(12, 50), 8),
             ('div_16', base[:16] + _prompt(12, 51), 16),
             ('div_17', base[:17] + _prompt(12, 52), 16)]
    for rid, toks, reuse in cases:
        saved = (on.prefix.tokens_saved, jeng.prefix.tokens_saved)
        want = jeng.run([jse.Request(rid, list(toks), max_new=5)])[
            rid].tokens
        got = _run(on, rid, toks, 5)
        assert got == want == _run(off, rid, toks, 5), rid
        assert (on.prefix.tokens_saved - saved[0] ==
                jeng.prefix.tokens_saved - saved[1] == reuse), rid
    assert on.prefix.stats() == jeng.prefix.stats()
    assert on.prefix.hits == 4 and on.prefix.tokens_saved == 64
    assert on.prefix.pinned_pages() == 0


def test_cow_isolation_writers_never_corrupt_sharers(models):
    """Two concurrent hits on the same pinned pages each write their
    own suffix and decode tokens: both equal their oracle, the pins are
    released, and a third request still hits the same pages."""
    eng = _engine(models)
    shared = _prompt(16, 3)
    _run(eng, 'pub', shared + _prompt(3, 4), 3)
    a, b = shared + _prompt(9, 5), shared + _prompt(6, 6)
    res = eng.run([tse.Request('a', a, max_new=8),
                   tse.Request('b', b, max_new=8)])
    assert res['a'].tokens == _oracle(models, a, 8)
    assert res['b'].tokens == _oracle(models, b, 8)
    assert eng.prefix.hits == 2 and eng.prefix.pinned_pages() == 0
    c = shared + _prompt(4, 9)
    assert _run(eng, 'c', c, 5) == _oracle(models, c, 5)
    assert eng.prefix.hits == 3


def test_slot_recycling_dmask_interplay(models):
    """A hit admitted into a recycled slot starts its first chunk at
    the cached boundary, where prefill keeps the row's mask: the
    copy-in must make the previous occupant's longer prompt tail and
    its decode columns unreadable."""
    eng = _engine(models, batch_size=1, max_seq=96)
    shared = _prompt(16, 11)
    _run(eng, 'prev', shared + _prompt(15, 12), 12)
    nxt = shared + _prompt(3, 13)
    assert _run(eng, 'next', nxt, 6) == _oracle(models, nxt, 6)
    assert eng.prefix.hits == 1


def test_cancel_mid_prefill_publishes_finished_pages_and_unpins(models):
    eng = _engine(models, batch_size=1, max_seq=96)
    shared = _prompt(8, 21)
    _run(eng, 'pub', shared + _prompt(2, 22), 2)
    occupied = eng.prefix.stats()['occupied']
    # 8 cached + 24 uncached tokens: three more prefill ticks, so the
    # cancel lands mid-prefill with the pin held.
    long = shared + _prompt(24, 23)
    eng.submit(tse.Request('victim', long, max_new=4))
    eng.step()
    assert eng.prefix.pinned_pages() == 1
    cursor = eng.slots[0].prefill_pos
    assert 8 < cursor < len(long)
    assert eng.cancel('victim', reason='api')
    eng.step()
    assert eng.drain_results()['victim'].status == lifecycle.CANCELLED
    assert eng.prefix.pinned_pages() == 0
    # Exactly the pages the cursor passed were published.
    hashes = thash.page_hashes(long, PAGE)
    done = cursor // PAGE
    assert all(h in eng.prefix._by_hash for h in hashes[:done])
    assert not any(h in eng.prefix._by_hash for h in hashes[done:])
    assert eng.prefix.stats()['occupied'] == occupied + done - 1
    # The published page is right: a request sharing it hits and still
    # equals its oracle, in the recycled slot.
    after = long[:done * PAGE] + _prompt(3, 24)
    saved = eng.prefix.tokens_saved
    assert _run(eng, 'after', after, 3) == _oracle(models, after, 3)
    assert eng.prefix.tokens_saved - saved == done * PAGE


def test_admission_charges_the_uncached_suffix(models):
    """The counterpart of test_admission_charges_uncached_suffix_only:
    with the cache on, the admission charge (the QoS currency, and the
    worst case ``past_frontier`` weighs) counts only the uncached
    suffix, and a lookup follows the prompt, not the request id. Each
    slot owns its decode columns, so next to a running decode both
    engines admit the request whose full charge (24 tick-tokens) a
    shared 16-column region could not hold, and serve it the oracle's
    tokens."""
    kw = dict(batch_size=2, max_prompt=32, max_seq=48, decode_chunk=4,
              prefill_chunk=8, prefill_budget=16)
    on, off = _engine(models, **kw), _engine(models, prefix_cache=False,
                                             **kw)
    big = _prompt(32, 41)
    _run(on, 'pub', big, 2)
    on.reset()                     # every count back at 0, pool kept
    assert on.prefix.stats()['occupied'] == 4
    for eng in (on, off):
        eng.submit(tse.Request('occ', _prompt(4, 42), max_new=6))
        eng.step()
    req = tse.Request('tight', list(big), max_new=8)
    # Full charge: 8 + ceil(32/8)*4 = 24. Suffix charge after the
    # 24-token reuse: 8 + ceil(8/8)*4 = 12.
    assert on._suffix_len(32, big) == 8 and off._suffix_len(32, big) == 32
    assert on._admission_charge(req) == 12
    assert off._admission_charge(req) == 24
    # Same id, an uncached prompt: the full charge.
    assert on._admission_charge(
        tse.Request('tight', _prompt(32, 47), max_new=8)) == 24
    got = {}
    for eng in (on, off):
        eng.submit(tse.Request('tight', list(big), max_new=8))
        eng.step()
        assert any(st is not None and st.request_id == 'tight'
                   for st in eng.slots)
        while eng.queue or eng.num_active() or eng.has_pending:
            eng.step()
        got[eng is on] = eng.drain_results()['tight'].tokens
    assert got[True] == got[False] == _oracle(models, big, 8)


def test_cache_off_by_default_and_unchanged(models, monkeypatch):
    """Off unless asked for: the default engine has no pool, and its
    tokens and tick schedule (every tick program dispatched, in order)
    equal an explicitly cache-off engine's and the JAX engine's tokens;
    a cache-on engine whose lookups all miss runs the same schedule.
    SKYTPU_PREFIX_CACHE=1 turns it on, SKYTPU_PREFIX_POOL_PAGES sizes
    the pool."""
    jcfg, jparams = models[0], models[1]
    monkeypatch.delenv('SKYTPU_PREFIX_CACHE', raising=False)
    prompts = {i: _prompt(n, 60 + i) for i, n in
               enumerate([5, 13, 21, 30, 9])}
    kw = dict(batch_size=2, max_prompt=32, max_seq=96, decode_chunk=4,
              prefill_chunk=8, prefill_budget=16, page=PAGE)
    runs = {}
    for name, flag in (('default', None), ('off', False), ('miss', True)):
        eng = _engine(models, prefix_cache=flag, **kw)
        assert (eng.prefix is None) == (flag is not True)
        keys = []
        eng._launch = (lambda k, launch=eng._launch:
                       keys.append(k) or launch(k))
        res = eng.run([tse.Request(i, p, max_new=6)
                       for i, p in prompts.items()])
        runs[name] = ({i: r.tokens for i, r in res.items()}, keys,
                      eng.prefill_ticks, eng.decode_steps_total)
    assert runs['default'] == runs['off'] == runs['miss']
    jeng = jse.ServingEngine(jparams, jcfg, **kw)
    jres = jeng.run([jse.Request(i, p, max_new=6)
                     for i, p in prompts.items()])
    assert {i: r.tokens for i, r in jres.items()} == runs['off'][0]
    monkeypatch.setenv('SKYTPU_PREFIX_CACHE', '1')
    monkeypatch.setenv('SKYTPU_PREFIX_POOL_PAGES', '3')
    eng = _engine(models, prefix_cache=None, prefix_pool_pages=None)
    assert eng.prefix is not None and eng.prefix.pool_pages == 3
    assert tuple(eng.prefix.pool['k'].shape) == (
        models[2].n_layers, 3, PAGE, models[2].n_kv_heads,
        models[2].head_dim)


def test_int8_kv_with_the_cache_equals_int8_without(models):
    shared = _prompt(16, 71)
    prompts = [shared + _prompt(3 + 4 * i, 72 + i) for i in range(4)]
    got = {}
    for flag in (True, False):
        eng = _engine(models, kv_quant=True, prefix_cache=flag)
        _run(eng, 'pub', shared + _prompt(5, 70), 4)
        res = eng.run([tse.Request(i, p, max_new=6)
                       for i, p in enumerate(prompts)])
        got[flag] = [res[i].tokens for i in range(len(prompts))]
        if flag:
            assert set(eng.prefix.pool) == {'k', 'v', 'k_scale', 'v_scale'}
            assert eng.prefix.pool['k'].dtype == torch.int8
            assert eng.prefix.hits == 4
    assert got[True] == got[False]


def test_spec_with_the_cache_equals_spec_off(models):
    """Speculation (prompt lookup on prompts that repeat a segment) with
    the cache on gives the tokens of the cache-on spec-off engine, with
    hits and verify ticks both happening."""
    shared = (_prompt(6, 80) * 3)[:16]
    prompts = [shared + (_prompt(5, 81 + i) * 3)[:8 + i] for i in range(4)]
    got = {}
    for spec in (False, True):
        eng = _engine(models, spec_decode=spec, spec_k=3, max_seq=128)
        _run(eng, 'pub', shared + _prompt(3, 79), 3)
        res = eng.run([tse.Request(i, p, max_new=12)
                       for i, p in enumerate(prompts)])
        got[spec] = [res[i].tokens for i in range(len(prompts))]
        assert eng.prefix.hits == 4
        assert (eng.spec_ticks > 0) == spec
    assert got[True] == got[False]
    assert got[False][0] == _oracle(models, prompts[0], 12)


# ----------------------------------------------------------- SKKV1


def _pools(kind):
    """A JAX pool and a port pool of the same tiny model, bf16 or f32
    caches, or int8 with scale planes."""
    dt = {'bf16': (jnp.bfloat16, torch.bfloat16),
          'f32': (jnp.float32, torch.float32),
          'int8': (jnp.float32, torch.float32)}[kind]
    jcfg = jmodels.LlamaConfig.tiny(compute_dtype=dt[0])
    tcfg = tllama.LlamaConfig.tiny(compute_dtype=dt[1])
    quant = kind == 'int8'
    return (jprefix.PrefixCache(jcfg, page=PAGE, pool_pages=4,
                                kv_quant=quant),
            tprefix.PrefixCache(tcfg, page=PAGE, pool_pages=4,
                                kv_quant=quant, device='cpu'))


def _random_pages(sig, n, seed):
    """``n`` pages of random bits under ``sig``: bf16 as uint16 bits of
    finite values, int8 anywhere, f32 normal."""
    rng = np.random.default_rng(seed)
    pages = []
    for i in range(n):
        blk = {}
        for f, spec in sig['fields'].items():
            shape = spec['shape']
            if spec['dtype'] == 'bfloat16':
                x = rng.standard_normal(shape).astype(np.float32)
                blk[f] = (x.view(np.uint32) >> 16).astype(np.uint16)
            elif spec['dtype'] == 'int8':
                blk[f] = rng.integers(-128, 128, shape).astype(np.int8)
            else:
                blk[f] = rng.standard_normal(shape).astype(np.float32)
        h = thash.page_hashes(_prompt(PAGE * (i + 1), seed), PAGE)[-1]
        pages.append((h, blk))
    return pages


def _as_jax(blk):
    return {f: a.view(jnp.bfloat16) if a.dtype == np.uint16 else a
            for f, a in blk.items()}


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == 'bfloat16' else a


@pytest.mark.parametrize('kind', ['bf16', 'int8', 'f32'])
def test_skkv1_bytes_equal_jax_and_cross_decode(kind):
    jpc, tpc = _pools(kind)
    sig = tpc.page_signature()
    assert sig == jpc.page_signature()
    assert twire.page_nbytes(sig) == jwire.page_nbytes(sig)
    pages = _random_pages(sig, 3, seed={'bf16': 1, 'int8': 2, 'f32': 3}[
        kind])
    assert jpc.import_pages([(h, _as_jax(b)) for h, b in pages]) == 3
    assert tpc.import_pages(pages) == 3
    _assert_same_pool(jpc, tpc)
    hashes = [h for h, _ in pages]
    tbytes = twire.encode(sig, [(h, tpc.export_page(h)) for h in hashes])
    jbytes = jwire.encode(sig, [(h, jpc.export_page(h)) for h in hashes])
    assert tbytes == jbytes
    hexes = [h.hex() for h in hashes]
    assert twire.pack_pages(tpc, hexes) == jwire.pack_pages(jpc, hexes)
    one = twire.page_nbytes(sig)
    assert twire.pack_pages(tpc, ['zz'] + hexes, max_bytes=2 * one) == \
        jwire.encode(sig, [(h, jpc.export_page(h)) for h in hashes[:2]])
    # Each side reads the other's bytes back to the same bits.
    tsig, tdec = twire.decode(jbytes)
    jsig, jdec = jwire.decode(tbytes)
    assert tsig == jsig == sig
    for (h, blk), (th, tblk), (jh, jblk) in zip(pages, tdec, jdec):
        assert h == th == jh
        for f in blk:
            np.testing.assert_array_equal(tblk[f], blk[f])
            np.testing.assert_array_equal(_bits(jblk[f]), blk[f])
    # A fresh port pool imports the JAX side's decoded pages (ml_dtypes
    # bfloat16 arrays) and re-exports the same bytes.
    _, fresh = _pools(kind)
    assert fresh.import_pages(jdec) == 3
    assert fresh.import_pages(jdec) == 0            # dedup by hash
    assert twire.encode(sig, [(h, fresh.export_page(h))
                              for h in hashes]) == jbytes


def test_skkv1_rejects_malformed_payloads():
    _, tpc = _pools('bf16')
    sig = tpc.page_signature()
    pages = _random_pages(sig, 2, seed=4)
    data = twire.encode(sig, pages)
    with pytest.raises(twire.WireError, match='magic'):
        twire.decode(b'XXKV1\n' + data[6:])
    with pytest.raises(twire.WireError, match='truncated'):
        twire.decode(data[:-5])
    with pytest.raises(twire.WireError, match='trailing'):
        twire.decode(data + b'\0')
    flipped = bytearray(data)
    flipped[-1] ^= 1
    with pytest.raises(twire.WireError, match='checksum'):
        twire.decode(bytes(flipped))
    # A bfloat16 field given by value (float32) is not a bit pattern.
    bad = {f: a.astype(np.float32) for f, a in pages[0][1].items()}
    with pytest.raises(twire.WireError, match='bfloat16'):
        twire.encode(sig, [(pages[0][0], bad)])
    with pytest.raises(twire.WireError, match='unsupported'):
        twire.page_nbytes({'fields': {'k': {'dtype': 'complex64',
                                            'shape': [1]}}})
    # A block of the wrong shape is refused before the pool changes.
    short = {f: a[:, :, :4] for f, a in pages[0][1].items()}
    with pytest.raises(ValueError, match='shape'):
        tpc.import_pages([(pages[0][0], short)])
    assert tpc.stats()['occupied'] == 0 and tpc.version == 0


def test_jax_engine_pages_served_through_queue_kv_import(models):
    """A JAX engine publishes a prompt's pages; its ``pack_pages``
    bytes, decoded by the port's codec and queued on a port engine,
    land in the pool at the next tick boundary, and the port engine
    then serves the prompt as a hit with the JAX engine's tokens."""
    jcfg, jparams = models[0], models[1]
    kw = dict(batch_size=2, max_prompt=32, max_seq=96, decode_chunk=4,
              prefill_chunk=8, prefill_budget=16, page=PAGE,
              prefix_pool_pages=16)
    jeng = jse.ServingEngine(jparams, jcfg, prefix_cache=True, **kw)
    base = _prompt(30, 90)
    jeng.run([jse.Request('pub', list(base), max_new=2)])
    hexes = [h.hex() for h in thash.page_hashes(base, PAGE)]
    sig, pages = twire.decode(jwire.pack_pages(jeng.prefix, hexes))
    eng = _engine(models, **{k: v for k, v in kw.items()
                             if k != 'prefix_pool_pages'})
    assert sig == eng.prefix.page_signature()
    assert eng.queue_kv_import(pages) and len(eng._kv_imports) == 1
    assert not _engine(models, prefix_cache=False).queue_kv_import(pages)
    prompt = base[:24] + _prompt(5, 91)
    want = jeng.run([jse.Request('hit', prompt, max_new=5)])['hit'].tokens
    assert _run(eng, 'hit', prompt, 5) == want
    assert not eng._kv_imports
    assert eng.prefix.stats()['occupied'] >= 3
    assert eng.prefix.hits == 1 and eng.prefix.tokens_saved == 24
