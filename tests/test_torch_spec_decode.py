"""Speculative decoding in the PyTorch port (``inference.verify_step``
and the engine's proposer, latch and capacity guard) against the JAX
package at ``tiny()`` in f32.

- ``_prompt_lookup``: the JAX cases, and equal to JAX's on random
  chains.
- ``verify_step`` from the same prefilled cache as JAX ``verify_step``:
  all-accept plus the bonus token, all-reject, accept k-1, a bounded
  read region and an inactive row. emit, counts and next_tok equal
  exactly, the dmask rollback bitwise, the written K/V within 1e-5
  (int8 payloads and scales bitwise); the verify logits within 1e-5 of
  JAX's one-token ``decode_step`` logits at each position; bf16 and
  int8 caches too (bf16 K/V within 4e-2, see ATOL_BF16_KV).
- The engine: greedy spec-on tokens equal spec-off tokens, the JAX spec
  engine's and ``reference_generate``'s, with the oracle, garbage and
  organic proposers, k in {1, 4}, two GQA ratios, and int8 KV against
  the JAX spec engine. Then the engine's rules: sampling slots bypass
  speculation, spec_k=0 disables it, the capacity guard near
  exhaustion, the dry latch with re-arm and cooldown, cancel
  mid-verify, EOS mid-burst under the documented rule (only drafts
  that surfaced count as accepted).
- ROADMAP R3: with an int8 cache the port's decode and verify feed a
  token's own K/V at different precision, as JAX's do; in f32 they
  agree.
"""
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
from skypilot_tpu_torch.ops import _build
from skypilot_tpu_torch.ops import flash_attention as tfa
from skypilot_tpu_torch.utils import lifecycle

torch.set_num_threads(2)

ATOL = 1e-5
# A bf16 forward rounds at other places in the two packages (the port's
# qdot rounds each product to bf16 before any f32 cast, JAX accumulates
# into f32), so after two layers the K/V a verify step writes differ by
# a few bf16 steps (at most 0.0234 here); tokens still agree exactly.
ATOL_BF16_KV = 4e-2
PAGE = 8


def _models(**cfg_kw):
    jcfg = jmodels.LlamaConfig.tiny(**cfg_kw)
    jparams = jmodels.init_params(jcfg, jax.random.PRNGKey(0))
    tcfg_kw = dict(cfg_kw)
    for f in ('param_dtype', 'compute_dtype'):
        if f in tcfg_kw:
            tcfg_kw[f] = {jnp.bfloat16: torch.bfloat16,
                          jnp.float32: torch.float32}[tcfg_kw[f]]
    tparams = convert.params_from_numpy(
        jax.tree.map(np.asarray, jparams), device='cpu')
    return jcfg, jparams, tllama.LlamaConfig.tiny(**tcfg_kw), tparams


@pytest.fixture(scope='module')
def models():
    return _models()


def _prompt(vocab, n, seed):
    return [int(t) for t in np.random.default_rng(seed).integers(0, vocab,
                                                                 n)]


def _reference(models, prompts, max_new):
    """JAX reference_generate, prompt by prompt."""
    jcfg, jparams = models[0], models[1]
    out = {}
    for rid, p in prompts.items():
        toks = jinf.reference_generate(
            jparams, jnp.asarray([p], jnp.int32),
            jnp.asarray([len(p)], jnp.int32), jcfg, max_new)
        out[rid] = np.asarray(toks)[0].tolist()
    return out


def _kw(**kw):
    d = dict(batch_size=3, max_prompt=32, max_seq=160, decode_chunk=4,
             prefill_chunk=8, prefill_budget=16, page=PAGE)
    d.update(kw)
    return d


def _port_engine(models, **kw):
    return tse.ServingEngine(models[3], models[2], device='cpu', **_kw(**kw))


def _oracle(oracles):
    """Proposer stub: the known greedy continuation of whichever request
    owns the chain (the all-accept pattern). oracles: {rid: (prompt,
    want)}."""
    def lookup(chain, k):
        chain = [int(t) for t in chain]
        for p, w in oracles.values():
            if chain[:len(p)] == list(p):
                g = len(chain) - len(p)
                return w[g:g + k]
        return []
    return lookup


def _garbage(vocab):
    return lambda chain, k: [(int(chain[-1]) + 7) % vocab] * k


def _run(eng, prompts, max_new):
    res = eng.run([tse.Request(r, p, max_new=max_new)
                   for r, p in prompts.items()])
    assert all(r.status == lifecycle.FINISHED for r in res.values())
    return {r: res[r].tokens for r in prompts}


# ------------------------------------------------------------ proposer


def test_prompt_lookup_cases_and_jax_equality():
    pl = tse._prompt_lookup
    chain = [5, 6, 7, 8, 1, 5, 6, 9, 9, 2, 5, 6]
    assert pl(chain, 2, max_ngram=3) == [9, 9]
    assert pl(chain, 4, max_ngram=3) == [9, 9, 2, 5]
    assert pl(chain, 1, max_ngram=3) == [9]
    assert pl([1, 2, 3, 4], 4, max_ngram=3) == []
    assert pl([7], 4, max_ngram=3) == []
    assert pl([], 4, max_ngram=3) == []
    assert pl([3, 3], 4, max_ngram=3) == [3]
    assert pl([4, 9, 1, 4], 2, max_ngram=3) == [9, 1]
    rng = np.random.default_rng(0)
    for _ in range(200):
        c = rng.integers(0, 6, rng.integers(0, 40)).tolist()
        k, n = int(rng.integers(0, 6)), int(rng.integers(1, 5))
        assert pl(c, k, n) == jse._prompt_lookup(c, k, n)
        assert pl(np.asarray(c, np.int64), k, n) == jse._prompt_lookup(c, k,
                                                                      n)


# --------------------------------------------------------- verify_step


def _prefilled(models, quant, seed=1, b=2, s=8):
    """The same prefilled cache in both packages (prefill parity is
    test_torch_inference.py's) and the first greedy tokens."""
    jcfg, jparams, tcfg, tparams = models
    toks = np.random.default_rng(seed).integers(0, jcfg.vocab_size,
                                                (b, s)).astype(np.int32)
    lengths = np.full((b,), s, np.int32)
    jl, jc = jinf.prefill(jparams, jnp.asarray(toks), jnp.asarray(lengths),
                          jcfg, kv_quant=quant)
    _, tc = tinf.prefill(tparams, torch.from_numpy(toks), lengths, tcfg,
                         kv_quant=quant)
    first = np.asarray(jnp.argmax(jl, -1)).astype(np.int32)
    return jc, tc, first


def _sequential(models, jc, first, n):
    """JAX one-token decode steps from ``first``: the greedy tokens
    [B, n + 1] and each step's logits [B, n, vocab]."""
    jcfg, jparams = models[0], models[1]
    cur, seq, logits = jnp.asarray(first), [first], []
    for _ in range(n):
        lg, jc = jinf.decode_step(jparams, jc, cur, jcfg)
        logits.append(np.asarray(lg))
        cur = jnp.argmax(lg, -1).astype(jnp.int32)
        seq.append(np.asarray(cur))
    return np.stack(seq, 1), np.stack(logits, 1)


def _copy_cache(tc):
    return {f: (t.clone() if isinstance(t, torch.Tensor) else t)
            for f, t in tc.items()}


def _both_verify(models, jc, tc, first, drafts, slen, active=None,
                 num_pages=None):
    jcfg, jparams, tcfg, tparams = models
    b = drafts.shape[0]
    jact = None if active is None else jnp.asarray(active)
    je, jn, jt, jc = jinf.verify_step(
        jparams, jc, jnp.asarray(first), jnp.asarray(drafts),
        jnp.asarray(slen), jcfg, jax.random.PRNGKey(2),
        jnp.zeros((b,), jnp.float32), 0, active=jact, num_pages=num_pages,
        page=PAGE)
    te, tn, tt, tc = tinf.verify_step(
        tparams, tc, torch.from_numpy(first), torch.from_numpy(drafts),
        torch.from_numpy(slen), tcfg,
        active=None if active is None else torch.from_numpy(active),
        num_pages=num_pages, page=PAGE)
    tn_np = tn.numpy()
    assert tn.dtype == torch.int32 and te.dtype == torch.int32
    np.testing.assert_array_equal(tn_np, np.asarray(jn))
    np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
    for row in range(b):           # emit is valid up to counts
        np.testing.assert_array_equal(te.numpy()[row, :tn_np[row]],
                                      np.asarray(je)[row, :tn_np[row]])
    np.testing.assert_array_equal(tc['dmask'].numpy(),
                                  np.asarray(jc['dmask']))
    np.testing.assert_array_equal(tc['length'].numpy(),
                                  np.asarray(jc['length']))
    assert tc['steps'] == int(jc['steps'])
    for f in ('k', 'v', 'k_scale', 'v_scale'):
        if f not in tc:
            continue
        t, j = tc[f], np.asarray(jc[f])
        if t.dtype == torch.int8:
            np.testing.assert_array_equal(t.numpy(), j, err_msg=f)
        elif t.dtype == torch.bfloat16 and f.endswith('scale'):
            np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                          j.view(np.int16), err_msg=f)
        else:
            atol = ATOL_BF16_KV if t.dtype == torch.bfloat16 else ATOL
            np.testing.assert_allclose(t.float().numpy(),
                                       j.astype(np.float32), atol=atol,
                                       rtol=0, err_msg=f)
    return tn_np, tt.numpy(), te.numpy(), tc


@pytest.mark.parametrize('quant', [False, True], ids=['f32kv', 'int8kv'])
def test_verify_step_matches_jax_accept_reject_partial(models, quant):
    k = 3
    jc0, tc0, first = _prefilled(models, quant)
    seq, _ = _sequential(models, jc0, first, k + 1)        # [B, k + 2]
    slen = np.full((2,), k, np.int32)
    drafts = seq[:, 1:1 + k].astype(np.int32)
    cases = {
        'all-accept': drafts,
        'all-reject': (drafts + 1) % models[0].vocab_size,
        'accept-k-1': np.concatenate(
            [drafts[:, :-1], (drafts[:, -1:] + 1) % models[0].vocab_size],
            1),
    }
    want_counts = {'all-accept': k + 1, 'all-reject': 1, 'accept-k-1': k}
    for name, d in cases.items():
        counts, nxt, emit, tc = _both_verify(models, jc0, _copy_cache(tc0),
                                             first, d.astype(np.int32),
                                             slen)
        assert (counts == want_counts[name]).all(), name
        assert (nxt == seq[:, want_counts[name]]).all(), name
        assert (emit[:, :counts[0]] == seq[:, 1:1 + counts[0]]).all(), name
        dm = tc['dmask'].numpy()
        assert dm[:, 8:8 + counts[0]].all(), name
        assert not dm[:, 8 + counts[0]:8 + k + 1].any(), name
    # A bounded read region (2 pages of 8 cover the segment at 8..12)
    # and an inactive row: its dmask, length and token stay put.
    active = np.asarray([True, False])
    counts, nxt, _, tc = _both_verify(models, jc0, _copy_cache(tc0), first,
                                      drafts, slen, active=active,
                                      num_pages=2)
    assert counts.tolist() == [k + 1, 0]
    assert nxt[1] == first[1] and not tc['dmask'][1, 8:].any()
    assert int(tc['length'][1]) == 8


def test_verify_logits_equal_jax_one_token_decode_logits(models):
    """Position i of the segment [f_0 .. f_k] sees what a one-token
    decode step of f_i sees: its logits equal JAX decode_step's."""
    k = 4
    jc0, tc0, first = _prefilled(models, False)
    seq, want = _sequential(models, jc0, first, k + 1)
    fed = torch.from_numpy(seq[:, :k + 1].astype(np.int32))
    got = tinf._verify_logits(models[3], _copy_cache(tc0), fed, models[2],
                              None, PAGE)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_verify_step_bf16_cache_matches_jax():
    models = _models(param_dtype=jnp.bfloat16, compute_dtype=jnp.bfloat16)
    jc0, tc0, first = _prefilled(models, False, seed=3)
    seq, _ = _sequential(models, jc0, first, 3)
    drafts = seq[:, 1:3].astype(np.int32)
    for d in (drafts, (drafts + 5) % models[0].vocab_size):
        counts, _, _, _ = _both_verify(models, jc0, _copy_cache(tc0), first,
                                       d.astype(np.int32),
                                       np.full((2,), 2, np.int32))
        assert counts.min() >= 1


def test_int8_self_term_decode_and_verify_differ_f32_agree(models):
    """ROADMAP R3 in the port: position 0 of a verify segment and a
    one-token decode step of the same token agree in f32 (1e-5) and
    differ with an int8 cache, where decode attends the token's own K/V
    unquantized and verify reads it back quantized — as in JAX."""
    _, _, tcfg, tparams = models
    for quant in (False, True):
        _, tc0, first = _prefilled(models, quant)
        dec, _ = tinf.decode_step(tparams, _copy_cache(tc0),
                                  torch.from_numpy(first), tcfg)
        ver = tinf._verify_logits(tparams, _copy_cache(tc0),
                                  torch.from_numpy(first)[:, None], tcfg,
                                  None, None)[:, 0]
        diff = (dec - ver).abs().max().item()
        if quant:
            assert diff > 1e-4, diff
        else:
            assert diff <= ATOL, diff


# -------------------------------------------------------------- engine


@pytest.mark.parametrize('gqa', [(4, 2), (8, 1)], ids=['gqa2to1', 'gqa8to1'])
def test_engine_spec_equals_spec_off_jax_and_reference(gqa):
    """Oracle, garbage and organic proposers, k in {1, 4}: every
    spec-on run equals spec-off, the JAX spec engine (oracle, k 4) and
    reference_generate."""
    models = _models(n_heads=gqa[0], n_kv_heads=gqa[1])
    vocab = models[0].vocab_size
    pat = _prompt(vocab, 6, 9)
    prompts = {'a': _prompt(vocab, 9, 1), 'b': _prompt(vocab, 17, 2),
               'rep': (pat * 5)[:30]}
    want = _reference(models, prompts, 12)
    assert _run(_port_engine(models), prompts, 12) == want
    oracle = _oracle({r: (p, want[r]) for r, p in prompts.items()})
    jeng = jse.ServingEngine(models[1], models[0], spec_decode=True,
                             spec_k=4, **_kw())
    jeng._lookup = oracle
    jres = jeng.run([jse.Request(r, p, max_new=12)
                     for r, p in prompts.items()])
    assert {r: jres[r].tokens for r in prompts} == want
    for k in (1, 4):
        for name, lookup in (('oracle', oracle), ('garbage', _garbage(vocab)),
                             ('organic', None)):
            eng = _port_engine(models, spec_decode=True, spec_k=k)
            if lookup is not None:
                eng._lookup = lookup
            assert _run(eng, prompts, 12) == want, (k, name)
            st = eng.spec_stats()
            assert st['proposed'] > 0 and st['spec_ticks'] > 0, (k, name)
            if name == 'oracle':
                assert st['accepted'] == st['proposed'], st
                assert st['tokens_per_step'] > (1.5 if k > 1 else 1.0)
            if name == 'garbage':
                assert st['accepted'] == 0 and st['tokens_per_step'] == 1.0
    assert jeng.spec_stats()['accepted'] == jeng.spec_stats()['proposed']


def test_wide_verify_segment_engine_equals_spec_off_and_reference():
    """A verify segment wider than one 64-row tile: 8 query heads on one
    kv head and spec_k 8 give 8 x 9 = 72 rows per kv head. The engine
    serves it (the kernel takes any width), and its greedy tokens equal
    spec-off's and reference_generate's with the oracle and the
    prompt-lookup proposers."""
    models = _models(n_heads=8, n_kv_heads=1)
    vocab = models[0].vocab_size
    pat = _prompt(vocab, 5, 19)
    prompts = {'a': _prompt(vocab, 11, 3), 'rep': (pat * 6)[:28]}
    want = _reference(models, prompts, 14)
    assert _run(_port_engine(models), prompts, 14) == want
    oracle = _oracle({r: (p, want[r]) for r, p in prompts.items()})
    for lookup in (oracle, None):
        eng = _port_engine(models, spec_decode=True, spec_k=8)
        assert eng.spec_decode and eng._spec_v == 9
        if lookup is not None:
            eng._lookup = lookup
        assert _run(eng, prompts, 14) == want
        assert eng.spec_stats()['spec_ticks'] > 0


def test_int8_kv_spec_engine_matches_jax_spec_engine(models):
    """int8 KV: the port's spec engine gives the JAX spec engine's
    tokens (both verify through the same quantized segment), with the
    oracle of the port's own spec-off run."""
    prompts = {'r': _prompt(256, 13, 6), 's': _prompt(256, 20, 7)}
    off = _run(_port_engine(models, kv_quant=True), prompts, 10)
    lookup = _oracle({r: (p, off[r]) for r, p in prompts.items()})
    eng = _port_engine(models, kv_quant=True, spec_decode=True, spec_k=3)
    eng._lookup = lookup
    got = _run(eng, prompts, 10)
    jeng = jse.ServingEngine(models[1], models[0], kv_quant=True,
                             spec_decode=True, spec_k=3, **_kw())
    jeng._lookup = lookup
    jres = jeng.run([jse.Request(r, p, max_new=10)
                     for r, p in prompts.items()])
    assert got == {r: jres[r].tokens for r in prompts}
    assert eng.spec_stats()['accepted'] > 0


def test_sampling_slots_bypass_speculation(models):
    p = _prompt(256, 9, 1)
    want = _reference(models, {'a': p}, 12)['a']
    eng = _port_engine(models, spec_decode=True, spec_k=2)
    calls = []
    oracle = _oracle({'a': (p, want)})

    def lookup(chain, k):
        calls.append([int(t) for t in chain[:len(p)]])
        return oracle(chain, k)
    eng._lookup = lookup
    res = eng.run([tse.Request('a', p, max_new=12),
                   tse.Request('s', _prompt(256, 7, 30), max_new=6,
                               temperature=0.9)])
    assert res['a'].tokens == want
    assert len(res['s'].tokens) == 6
    assert all(0 <= t < 256 for t in res['s'].tokens)
    assert calls and all(c == p for c in calls), 'a sampling slot drafted'
    assert eng.spec_stats()['accepted'] > 0


def test_spec_k_zero_and_a_too_wide_segment_disable(models, monkeypatch):
    assert _port_engine(models, spec_decode=True, spec_k=0).spec_decode \
        is False
    monkeypatch.setenv('SKYTPU_SPEC_DECODE', '1')
    monkeypatch.setenv('SKYTPU_SPEC_K', '0')
    assert _port_engine(models).spec_decode is False
    monkeypatch.delenv('SKYTPU_SPEC_K')
    eng = _port_engine(models)
    assert eng.spec_decode is True and eng.spec_k == 4
    monkeypatch.delenv('SKYTPU_SPEC_DECODE')
    assert _port_engine(models).spec_decode is False
    # A verify segment of 9 columns in a decode region of 8.
    assert _port_engine(models, max_seq=40, spec_decode=True,
                        spec_k=8).spec_decode is False


def test_capacity_guard_falls_back_near_exhaustion(models):
    """max_new takes the whole decode region: the guard refuses every
    verify segment and the proposer is never asked."""
    p = _prompt(256, 8, 41)
    want = _reference(models, {'r': p}, 16)['r']
    eng = _port_engine(models, batch_size=1, max_seq=48, prefill_budget=8,
                       spec_decode=True, spec_k=3)
    calls = []
    oracle = _oracle({'r': (p, want)})
    eng._lookup = lambda chain, k: calls.append(1) or oracle(chain, k)
    assert _run(eng, {'r': p}, 16)['r'] == want
    assert eng.spec_stats()['spec_ticks'] == 0 and not calls


def test_dry_spell_keeps_pipelining_and_rearms(models):
    p = _prompt(256, 9, 55)
    want = _reference(models, {'r': p}, 60)['r']
    eng = _port_engine(models, batch_size=1, max_seq=256, spec_decode=True,
                       spec_k=3)
    oracle = _oracle({'r': (p, want)})
    mode = {'match': False}
    eng._lookup = lambda chain, k: oracle(chain, k) if mode['match'] else []
    eng.submit(tse.Request('r', p, max_new=60))
    for _ in range(10):
        eng.step()
    assert eng._spec_dry is True
    assert eng.spec_stats()['spec_ticks'] == 0
    mode['match'] = True
    done = {}
    while eng.queue or eng.num_active() or eng.has_pending:
        eng.step()
        done.update(eng.drain_results())
    assert eng._spec_dry is False
    st = eng.spec_stats()
    assert st['spec_ticks'] > 0 and st['accepted'] > 0, st
    assert done['r'].tokens == want


def test_reject_streak_latches_dry_with_backoff(models):
    """Drafts the model never confirms latch dry like no drafts at all,
    and the doubling cooldown keeps verify ticks rare."""
    p = _prompt(256, 9, 7)
    want = _reference(models, {'r': p}, 48)['r']
    eng = _port_engine(models, batch_size=1, max_seq=256, spec_decode=True,
                       spec_k=3)
    eng._lookup = _garbage(256)
    assert _run(eng, {'r': p}, 48)['r'] == want
    st = eng.spec_stats()
    assert st['accepted'] == 0
    assert 0 < st['spec_ticks'] <= 24, st
    assert eng._spec_cooldown > 1


def test_cancel_mid_verify_rolls_back_and_recycles(models):
    p = _prompt(256, 9, 77)
    want = _reference(models, {'v': p}, 24)['v']
    eng = _port_engine(models, batch_size=2, max_prompt=16, max_seq=96,
                       spec_decode=True, spec_k=3)
    eng._lookup = _oracle({'v': (p, want)})
    eng.submit(tse.Request('v', p, max_new=24))
    for _ in range(4):
        eng.step()
    assert eng.spec_stats()['spec_ticks'] > 0 and eng.has_pending
    assert eng.cancel('v')
    eng.step()
    eng.step()
    res = eng.drain_results()
    assert res['v'].status == lifecycle.CANCELLED
    got = res['v'].tokens
    assert 0 < len(got) < 24 and got == want[:len(got)]
    p2 = _prompt(256, 11, 78)
    eng._lookup = lambda chain, k: []
    assert _run(eng, {'n': p2}, 8)['n'] == _reference(models, {'n': p2},
                                                       8)['n']


def test_eos_mid_burst_counts_only_surfaced_drafts(models):
    """An EOS inside an accepted burst truncates the emission, and only
    drafts that surfaced count as accepted (ROADMAP R2's rule)."""
    p = _prompt(256, 9, 1)
    want = _reference(models, {'r': p}, 10)['r']
    assert len(set(want[:3])) == 3              # EOS only at index 2
    eng = _port_engine(models, batch_size=1, eos_id=want[2],
                       spec_decode=True, spec_k=4)
    eng._lookup = _oracle({'r': (p, want)})
    res = eng.run([tse.Request('r', p, max_new=10)])
    assert res['r'].tokens == want[:3]
    assert res['r'].status == lifecycle.FINISHED
    st = eng.spec_stats()
    # The burst drafts want[1:5] and the device accepts all four; the
    # host surfaces want[1] and then want[2], the EOS.
    assert st['proposed'] == 4 and st['accepted'] == 2, st


def test_spec_off_engine_never_launches_or_counts(models):
    _build.reset_launches()
    eng = _port_engine(models)
    assert not eng.spec_decode
    _run(eng, {'r': _prompt(256, 11, 91)}, 4)
    st = eng.spec_stats()
    assert st['proposed'] == 0 and st['spec_ticks'] == 0
    assert _build.LAUNCHES[tfa.VERIFY_KERNEL] == 0
