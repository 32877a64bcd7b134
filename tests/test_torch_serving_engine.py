"""The PyTorch port's continuous-batching engine
(skypilot_tpu_torch/models/serving_engine.py) against the JAX package
at ``tiny()`` in f32: on the same requests its greedy tokens EQUAL the
JAX ``ServingEngine``'s and JAX ``reference_generate``'s — through slot
recycling, more requests than slots, mixed prompt lengths across chunk
edges, int8 KV, a long answer beside short ones (each slot owns its
decode columns, so the port admits where the JAX engine's shared region
waits, and writes nothing past max_seq at max_new = the capacity) and
EOS. Plus the engine's own rules: request validation and duplicate ids,
cancellation, per-request temperature, run scoping and the streaming
hook."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu import models as jmodels
from skypilot_tpu.models import inference as jinf
from skypilot_tpu.models import serving_engine as jse
from skypilot_tpu_torch import convert
from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.models import serving_engine as tse
from skypilot_tpu_torch.utils import lifecycle

torch.set_num_threads(2)

PAGE = 8


@pytest.fixture(scope='module')
def models():
    jcfg = jmodels.LlamaConfig.tiny()
    jparams = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    tparams = convert.params_from_numpy(
        jax.tree.map(np.asarray, jparams), device='cpu')
    return jcfg, jparams, tllama.LlamaConfig.tiny(), tparams


def _prompts(n, lengths, seed, vocab=256):
    rng = np.random.default_rng(seed)
    return {i: [int(t) for t in rng.integers(0, vocab, lengths[i % len(
        lengths)])] for i in range(n)}


def _reference(models, prompts, max_new):
    """JAX reference_generate over all prompts at once (right-padded)."""
    jcfg, jparams = models[0], models[1]
    ids = sorted(prompts)
    width = max(len(p) for p in prompts.values())
    toks = np.zeros((len(ids), width), np.int32)
    for row, i in enumerate(ids):
        toks[row, :len(prompts[i])] = prompts[i]
    lengths = np.asarray([len(prompts[i]) for i in ids], np.int32)
    out = np.asarray(jinf.reference_generate(
        jparams, jnp.asarray(toks), jnp.asarray(lengths), jcfg, max_new))
    return {i: out[row].tolist() for row, i in enumerate(ids)}


def _serve_both(models, prompts, max_new, **kw):
    """Run the same requests through the JAX and the port engine."""
    jcfg, jparams, tcfg, tparams = models
    new = (lambda i: max_new(i)) if callable(max_new) else (
        lambda i: max_new)
    jeng = jse.ServingEngine(jparams, jcfg, page=PAGE, **kw)
    teng = tse.ServingEngine(tparams, tcfg, page=PAGE, device='cpu', **kw)
    jres = jeng.run([jse.Request(i, p, max_new=new(i))
                     for i, p in prompts.items()])
    tres = teng.run([tse.Request(i, p, max_new=new(i))
                     for i, p in prompts.items()])
    assert set(jres) == set(tres) == set(prompts)
    for i in prompts:
        assert tres[i].status == lifecycle.FINISHED
        assert tres[i].prompt_len == len(prompts[i])
        assert tres[i].tokens == jres[i].tokens, (i, tres[i].tokens,
                                                  jres[i].tokens)
    return {i: r.tokens for i, r in tres.items()}, teng


def test_engine_matches_jax_engine_and_reference(models):
    prompts = _prompts(2, [11, 7], seed=1)
    got, _ = _serve_both(models, prompts, 6, batch_size=2, max_prompt=32,
                         max_seq=128)
    assert got == _reference(models, prompts, 6)


@pytest.mark.parametrize('decode_chunk', [8, 3], ids=['chunk8', 'chunk3'])
def test_recycling_more_requests_than_slots_mixed_lengths(models,
                                                          decode_chunk):
    """7 requests through 2 slots, prompts on both sides of the 8-token
    chunk edge (chunked prefill under a 16-token budget), max_new 3..9:
    every recycled slot must forget its previous occupant."""
    prompts = _prompts(7, [5, 7, 8, 9, 15, 16, 17], seed=2)
    got, eng = _serve_both(models, prompts, lambda i: 3 + i, batch_size=2,
                           max_prompt=32, max_seq=128, prefill_chunk=8,
                           prefill_budget=16, decode_chunk=decode_chunk)
    want = _reference(models, prompts, 9)
    for i, toks in got.items():
        assert toks == want[i][:3 + i], i
    assert eng.max_tick_prefill_tokens <= eng.prefill_budget == 16


def test_int8_kv_engine_matches_jax(models):
    prompts = _prompts(3, [8, 13, 20], seed=3)
    got, _ = _serve_both(models, prompts, 5, batch_size=2, max_prompt=32,
                         max_seq=128, kv_quant=True)
    assert all(len(t) == 5 for t in got.values())


def test_capacity_reset(models):
    """16 decode columns a slot for 6 requests of 8 tokens (the JAX
    engine drains its shared region and starts a fresh cache): every
    slot is recycled at its own columns, and everything is served
    exactly."""
    prompts = _prompts(6, [6], seed=4)
    got, _ = _serve_both(models, prompts, 8, batch_size=2, max_prompt=32,
                         max_seq=48)
    assert got == _reference(models, prompts, 8)


def test_long_answer_beside_short_ones_matches_jax(models):
    """One request takes all 16 decode columns (max_new = the capacity)
    while four short ones pass through the other two slots: the port
    admits each short one as a slot frees, so all finish before the
    long one (a shared region would have held them), every request's
    greedy tokens equal the JAX engine's and reference_generate's, and
    no count passes the cache's decode columns."""
    prompts = _prompts(5, [7, 5, 9, 6, 4], seed=9)
    new = (lambda i: 16 if i == 0 else 3)
    jcfg, jparams, tcfg, tparams = models
    kw = dict(batch_size=3, max_prompt=32, max_seq=48, decode_chunk=2)
    jres = jse.ServingEngine(jparams, jcfg, page=PAGE, **kw).run(
        [jse.Request(i, p, max_new=new(i)) for i, p in prompts.items()])
    teng = tse.ServingEngine(tparams, tcfg, page=PAGE, device='cpu', **kw)
    assert teng.decode_capacity() == 16
    done = []
    tres = teng.run([tse.Request(i, p, max_new=new(i))
                     for i, p in prompts.items()],
                    on_result=lambda r: done.append(r.request_id))
    want = _reference(models, prompts, 16)
    for i in prompts:
        assert tres[i].tokens == jres[i].tokens == want[i][:new(i)], i
    assert done[-1] == 0, done
    assert 0 < int(teng.cache['steps'].max()) <= 16


def test_eos_finishes_early_like_jax(models):
    prompts = _prompts(3, [9, 12, 6], seed=5)
    want = _reference(models, prompts, 8)
    eos = want[0][3]
    got, _ = _serve_both(models, prompts, 8, batch_size=2, max_prompt=32,
                         max_seq=128, eos_id=eos)
    for i, toks in got.items():
        cut = want[i].index(eos) + 1 if eos in want[i] else 8
        assert toks == want[i][:cut], i
    assert len(got[0]) < 8


@pytest.mark.parametrize('decode_attn', ['paged', 'lax'],
                         ids=['paged', 'lax'])
def test_decode_attn_and_paged_dispatch_match_jax(models, decode_attn):
    """The reference's decode_attn option: either impl serves the JAX
    engine's tokens (its einsum decode) and reports its impl, with
    length-aware dispatch on (a page count in every decode key), as the
    reference's default paged_dispatch=True has it."""
    prompts = _prompts(5, [9, 14, 21, 4], seed=11)
    jcfg, jparams, tcfg, tparams = models
    kw = dict(batch_size=2, max_prompt=32, max_seq=96, decode_chunk=4,
              paged_dispatch=True)
    jeng = jse.ServingEngine(jparams, jcfg, page=PAGE, **kw)
    teng = tse.ServingEngine(tparams, tcfg, page=PAGE, device='cpu',
                             decode_attn=decode_attn, **kw)
    assert teng.attn_impl == decode_attn
    seen = []
    launch = teng._launch
    teng._launch = lambda key: (seen.append(key), launch(key))[1]
    jres = jeng.run([jse.Request(i, p, max_new=7)
                     for i, p in prompts.items()])
    tres = teng.run([tse.Request(i, p, max_new=7)
                     for i, p in prompts.items()])
    for i in prompts:
        assert tres[i].tokens == jres[i].tokens, i
    decode_pages = {k[2] for k in seen if k[0] != 'verify' and k[1]}
    assert decode_pages and None not in decode_pages


def test_full_cache_dispatch_is_refused(models):
    """paged_dispatch=False (the reference's full-cache decode reads)
    is not ported: the engine refuses it by name rather than serving a
    dispatch it does not have."""
    _, _, tcfg, tparams = models
    with pytest.raises(ValueError, match='paged_dispatch=False'):
        tse.ServingEngine(tparams, tcfg, batch_size=2, max_prompt=32,
                          max_seq=96, page=PAGE, device='cpu',
                          paged_dispatch=False)


def test_page_misaligned_max_seq_downgrades_once(models, caplog):
    """A page-misaligned max_seq serves the JAX tokens through the
    einsum decode: 'paged' is downgraded to 'lax' with one warning per
    process, and skytpu_engine_attn_impl reports 'lax'."""
    from skypilot_tpu_torch import metrics
    prompts = _prompts(3, [9, 17, 5], seed=12)
    jcfg, jparams, tcfg, tparams = models
    kw = dict(batch_size=2, max_prompt=32, max_seq=100, decode_chunk=4)
    tse._ATTN_DOWNGRADE_WARNED.clear()
    with caplog.at_level('WARNING', logger=tse.__name__):
        engines = [tse.ServingEngine(tparams, tcfg, page=PAGE, device='cpu',
                                     decode_attn='paged', **kw)
                   for _ in range(2)]
    warned = [r for r in caplog.records if 'downgraded' in r.getMessage()]
    assert len(warned) == 1
    assert all(e.attn_impl == 'lax' for e in engines)
    text = metrics.render_exposition()
    assert 'skytpu_engine_attn_impl{impl="lax"} 1' in text
    jeng = jse.ServingEngine(jparams, jcfg, page=PAGE, decode_attn='paged',
                             **kw)
    jres = jeng.run([jse.Request(i, p, max_new=9)
                     for i, p in prompts.items()])
    tres = engines[0].run([tse.Request(i, p, max_new=9)
                           for i, p in prompts.items()])
    for i in prompts:
        assert tres[i].tokens == jres[i].tokens, i


def test_submit_validation_and_duplicate_ids(models):
    _, _, tcfg, tparams = models
    eng = tse.ServingEngine(tparams, tcfg, batch_size=1, max_prompt=32,
                            max_seq=64, page=PAGE, device='cpu')
    with pytest.raises(ValueError, match='empty prompt'):
        eng.submit(tse.Request(0, [], max_new=4))
    for bad in (0, -5):
        with pytest.raises(ValueError, match='must be positive'):
            eng.submit(tse.Request(1, [1, 2, 3], max_new=bad))
    with pytest.raises(ValueError, match='exceeds max_prompt'):
        eng.submit(tse.Request(2, list(range(100)), max_new=4))
    with pytest.raises(ValueError, match='decode capacity'):
        eng.submit(tse.Request(3, [1, 2], max_new=1000))
    with pytest.raises(ValueError, match='must exceed max_prompt'):
        tse.ServingEngine(tparams, tcfg, batch_size=1, max_prompt=64,
                          max_seq=64, device='cpu')
    assert len(eng.queue) == 0
    eng.submit(tse.Request('dup', [1, 2, 3], max_new=3))
    with pytest.raises(tse.DuplicateRequestError, match='duplicate'):
        eng.submit(tse.Request('dup', [4, 5], max_new=3))
    assert issubclass(tse.DuplicateRequestError, ValueError)
    assert len(eng.queue) == 1
    while eng.queue or eng.num_active() or eng.has_pending:
        eng.step()
    assert len(eng.drain_results()['dup'].tokens) == 3
    with pytest.raises(ValueError, match='duplicate request_id'):
        eng.run([tse.Request('x', [1], max_new=1),
                 tse.Request('x', [2], max_new=1)])


def test_cancel_queued_inflight_and_all(models):
    _, _, tcfg, tparams = models
    eng = tse.ServingEngine(tparams, tcfg, batch_size=1, max_prompt=32,
                            max_seq=128, decode_chunk=2, page=PAGE,
                            device='cpu')
    prompts = _prompts(4, [6], seed=6)
    for i, p in prompts.items():
        eng.submit(tse.Request(i, p, max_new=20))
    for _ in range(4):
        eng.step()
    assert eng.cancel(1, reason='client_disconnect')       # queued
    assert eng.cancel(0)                                    # in its slot
    assert not eng.cancel('unknown')
    eng.step()
    res = eng.drain_results()
    assert res[1].status == lifecycle.CANCELLED and res[1].tokens == []
    assert res[1].reason == 'client_disconnect'
    assert res[0].status == lifecycle.CANCELLED
    assert 0 < len(res[0].tokens) < 20
    # The freed slot serves the next request; cancel_all ends the rest.
    eng.step()
    assert sorted(eng.cancel_all()) == [2, 3]
    eng.flush()
    res = eng.drain_results()
    assert {res[2].status, res[3].status} == {lifecycle.CANCELLED}
    assert not eng.queue and eng.num_active() == 0


def test_temperature_run_scoping_and_streaming(models):
    _, _, tcfg, tparams = models
    eng = tse.ServingEngine(tparams, tcfg, batch_size=2, max_prompt=32,
                            max_seq=128, page=PAGE, device='cpu')
    p1, p2 = _prompts(2, [8], seed=7).values()
    want = _reference(models, {0: p1}, 5)[0]
    streamed = {}
    eng.on_token = lambda rid, toks: streamed.setdefault(rid, []).extend(
        toks)
    res = eng.run([tse.Request('greedy', p1, max_new=5),
                   tse.Request('hot', p2, max_new=5, temperature=5.0)])
    assert res['greedy'].tokens == want
    assert len(res['hot'].tokens) == 5
    assert streamed['greedy'] == want
    delivered = []
    res2 = eng.run([tse.Request('next', p1, max_new=3)],
                   on_result=lambda r: delivered.append(r.request_id))
    assert set(res2) == {'next'} and delivered == ['next']
    assert res2['next'].tokens == want[:3]
