"""KV-cache inference primitives of the PyTorch port
(skypilot_tpu_torch/models/inference.py) against the JAX package at
``tiny()`` in f32: ``prefill_chunk`` (live rows, a partial chunk, a
dead row repeating a live row's slot) and ``decode_step`` (inactive
rows, page-bounded reads) leave the same cache — float fields within
atol 1e-5, int8 payloads and scales bitwise, dmask and lengths equal —
and the same logits within atol 1e-4; each row's own decode column
count equals JAX's shared ``steps`` while it moves in lockstep, and an
idle row keeps its count (its idle K/V land at its own frontier, so it
is compared on the columns it may read). Within the port: rows at
different own frontiers equal each row decoded alone, a row past the
cache's decode columns writes nothing past ``max_seq`` and nothing of
another row, chunked prefill equals one whole-prompt chunk at plen =
k*chunk +/- 1, a recycled slot forgets its previous occupant (its
count back at 0), an idle row reads no cache column, ``_sample``
keeps top_k ties, and the cache-free
``reference_generate`` gives JAX's tokens.
The monolithic ``prefill`` (right-padded prompts through the flash
path, f32 and int8 caches) leaves JAX's cache — int8 payloads and
scales bitwise — and logits within 1e-4, and ``generate`` gives JAX's
greedy tokens."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu import models as jmodels
from skypilot_tpu.models import inference as jinf
from skypilot_tpu_torch import convert
from skypilot_tpu_torch.models import inference as tinf
from skypilot_tpu_torch.models import llama as tllama

torch.set_num_threads(2)

ATOL_CACHE = 1e-5
ATOL_LOGITS = 1e-4
B, MAX_PROMPT, MAX_SEQ, PAGE = 3, 32, 64, 8


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


def _assert_caches_equal(jc, tc, counts=None):
    """The port's cache equals JAX's. ``counts``: each row's expected
    own decode column count (default: JAX's shared ``steps``, every
    row in lockstep). A row whose count is not JAX's ``steps`` sat out
    decode steps: it wrote its idle K/V at its own frontier where JAX
    wrote them at the shared column, so it is compared on its prompt
    region and the columns it may read."""
    assert set(jc) == set(tc)
    steps = int(jc['steps'])
    counts = np.full(tc['length'].shape, steps) if counts is None else \
        np.asarray(counts)
    dmask = np.asarray(jc['dmask'])
    cols = np.arange(dmask.shape[1])[None, :]
    keep = (counts == steps)[:, None] | dmask | (cols < tc['base'])
    for f in ('k', 'v', 'k_scale', 'v_scale'):
        if f not in jc:
            continue
        j = np.asarray(jc[f])[:, keep]
        t = tc[f]
        if t.dtype == torch.bfloat16:        # scales: bitwise
            np.testing.assert_array_equal(
                t.view(torch.int16).numpy()[:, keep], j.view(np.int16),
                err_msg=f)
        elif t.dtype == torch.int8:          # payloads: bitwise
            np.testing.assert_array_equal(t.numpy()[:, keep], j, err_msg=f)
        else:
            np.testing.assert_allclose(t.numpy()[:, keep], j,
                                       atol=ATOL_CACHE, rtol=0, err_msg=f)
    np.testing.assert_array_equal(tc['dmask'].numpy(), dmask)
    np.testing.assert_array_equal(tc['length'].numpy(),
                                  np.asarray(jc['length']))
    assert tc['base'] == int(jc['base'])
    assert tc['steps'].dtype == torch.int32
    np.testing.assert_array_equal(tc['steps'].numpy(), counts)


def _chunk_args(rows, c, vocab, seed):
    """rows: [(slot, start, len, live)] -> numpy prefill_chunk args."""
    rng = np.random.default_rng(seed)
    g = len(rows)
    toks = rng.integers(0, vocab, (g, c)).astype(np.int32)
    slots, starts, lens, live = (np.asarray([r[i] for r in rows])
                                 for i in range(4))
    return (toks, starts.astype(np.int32), lens.astype(np.int32),
            live.astype(bool), slots.astype(np.int32))


def _both_prefill(models, jc, tc, rows, seed, c=8):
    jcfg, jparams, tcfg, tparams = models
    toks, starts, lens, live, slots = _chunk_args(rows, c, jcfg.vocab_size,
                                                  seed)
    jl, jc = jax.jit(functools.partial(
        jinf.prefill_chunk, cfg=jcfg, prompt_base=MAX_PROMPT))(
            jparams, jc, jnp.asarray(toks), jnp.asarray(starts),
            jnp.asarray(lens), jnp.asarray(live), jnp.asarray(slots))
    tl, tc = tinf.prefill_chunk(tparams, tc, torch.from_numpy(toks),
                                starts, lens, live, slots, tcfg,
                                prompt_base=MAX_PROMPT)
    for j in np.nonzero(live)[0]:
        np.testing.assert_allclose(tl[j].numpy(), np.asarray(jl[j]),
                                   atol=ATOL_LOGITS, rtol=0)
    return jc, tc


def _both_decode(models, jc, tc, tokens, active, num_pages):
    jcfg, jparams, tcfg, tparams = models
    jl, jc = jinf.decode_step(jparams, jc, jnp.asarray(tokens), jcfg,
                              active=jnp.asarray(active),
                              attn_impl='paged', num_pages=num_pages,
                              page=PAGE)
    tl, tc = tinf.decode_step(tparams, tc, torch.from_numpy(tokens), tcfg,
                              active=torch.from_numpy(active),
                              num_pages=num_pages, page=PAGE)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                               atol=ATOL_LOGITS, rtol=0)
    return jc, tc


@pytest.mark.parametrize('quant', [False, True], ids=['f32kv', 'int8kv'])
def test_prefill_chunk_and_decode_step_match_jax(models, quant):
    jcfg, _, tcfg, _ = models
    jc = _jax_cache(jcfg, quant)
    tc = tinf.make_cache(tcfg, B, MAX_SEQ, base=MAX_PROMPT, kv_quant=quant,
                         device='cpu')
    _assert_caches_equal(jc, tc)
    # Slot 0 full chunk, slot 2 partial chunk, a dead row aimed at
    # slot 0 (it must not revert slot 0's write).
    jc, tc = _both_prefill(models, jc, tc,
                           [(0, 0, 8, True), (2, 0, 5, True),
                            (0, 0, 1, False)], seed=1)
    _assert_caches_equal(jc, tc)
    # Slot 0's second (partial) chunk; slot 1 stays empty.
    jc, tc = _both_prefill(models, jc, tc,
                           [(0, 8, 3, True), (1, 0, 1, False),
                            (1, 0, 1, False)], seed=2)
    _assert_caches_equal(jc, tc)
    active = np.asarray([True, False, True])
    for step, toks in enumerate(([5, 9, 17], [33, 2, 250])):
        jc, tc = _both_decode(models, jc, tc, np.asarray(toks, np.int32),
                              active, num_pages=MAX_PROMPT // PAGE + 1)
        _assert_caches_equal(jc, tc, np.where(active, step + 1, 0))


@pytest.mark.parametrize('plen', [7, 8, 9, 15, 16, 17, 31], ids=str)
def test_chunked_prefill_equals_one_whole_prompt_chunk(models, plen):
    _, _, tcfg, tparams = models
    rng = np.random.default_rng(plen)
    prompt = rng.integers(0, tcfg.vocab_size, plen).astype(np.int32)
    caches, logits = [], []
    for c in (8, MAX_PROMPT):
        cache = tinf.make_cache(tcfg, B, MAX_SEQ, base=MAX_PROMPT,
                                device='cpu')
        pos = 0
        while pos < plen:
            ln = min(c, plen - pos)
            buf = np.zeros((1, c), np.int32)
            buf[0, :ln] = prompt[pos:pos + ln]
            lg, cache = tinf.prefill_chunk(
                tparams, cache, torch.from_numpy(buf), [pos], [ln], [True],
                [1], tcfg, prompt_base=MAX_PROMPT)
            pos += ln
        caches.append(cache)
        logits.append(lg[0])
    np.testing.assert_allclose(logits[0].numpy(), logits[1].numpy(),
                               atol=ATOL_CACHE, rtol=0)
    for f in ('k', 'v'):
        np.testing.assert_allclose(caches[0][f][:, 1, :plen].numpy(),
                                   caches[1][f][:, 1, :plen].numpy(),
                                   atol=ATOL_CACHE, rtol=0)
    assert torch.equal(caches[0]['dmask'], caches[1]['dmask'])
    assert int(caches[0]['length'][1]) == plen


def test_recycled_slot_forgets_its_previous_occupant(models):
    """A new prompt's first chunk (start 0) clears the row: decoding
    the new occupant gives the logits of a fresh cache."""
    _, _, tcfg, tparams = models
    rng = np.random.default_rng(7)
    old = rng.integers(0, tcfg.vocab_size, (1, 8)).astype(np.int32)
    new = rng.integers(0, tcfg.vocab_size, (1, 8)).astype(np.int32)

    def run(prefills, n_old_steps):
        cache = tinf.make_cache(tcfg, 1, MAX_SEQ, base=MAX_PROMPT,
                                device='cpu')
        for toks, ln in prefills:
            _, cache = tinf.prefill_chunk(
                tparams, cache, torch.from_numpy(toks), [0], [ln], [True],
                [0], tcfg, prompt_base=MAX_PROMPT)
            for _ in range(n_old_steps):
                _, cache = tinf.decode_step(tparams, cache,
                                            torch.tensor([3]), tcfg,
                                            page=PAGE)
            n_old_steps = 0
        return tinf.decode_step(tparams, cache, torch.tensor([11]), tcfg,
                                page=PAGE)

    recycled_logits, cache = run([(old, 8), (new, 5)], n_old_steps=3)
    fresh_logits, _ = run([(new, 5)], n_old_steps=0)
    np.testing.assert_allclose(recycled_logits.numpy(),
                               fresh_logits.numpy(), atol=ATOL_CACHE, rtol=0)
    # Only the new prompt and the decode slot just written are readable:
    # the new occupant's count started again at 0.
    readable = np.nonzero(cache['dmask'][0].numpy())[0].tolist()
    assert readable == [0, 1, 2, 3, 4, MAX_PROMPT]
    assert cache['steps'].tolist() == [1]


def _prefill_rows(tparams, tcfg, cache, prompts):
    """Each row's whole prompt as one chunk (one row per call)."""
    for row, p in enumerate(prompts):
        toks = np.zeros((1, MAX_PROMPT), np.int32)
        toks[0, :len(p)] = p
        tinf.prefill_chunk(tparams, cache, torch.from_numpy(toks), [0],
                           [len(p)], [True], [row], tcfg,
                           prompt_base=MAX_PROMPT)


@pytest.mark.parametrize('quant', [False, True], ids=['f32kv', 'int8kv'])
def test_rows_at_their_own_frontiers_equal_each_row_alone(models, quant):
    """Rows that sat out different decode steps write at their own
    frontiers: each row's logits, live K/V columns and count equal the
    same row decoded alone in a one-row cache (the plain per-row
    reference), and no row reads or writes another's columns."""
    _, _, tcfg, tparams = models
    rng = np.random.default_rng(21)
    prompts = [rng.integers(0, tcfg.vocab_size, n).tolist()
               for n in (12, 5, 9)]
    # Row 0 decodes alone for 3 steps, row 2 joins for 2 more, then all.
    schedule = [[1, 0, 0]] * 3 + [[1, 0, 1]] * 2 + [[1, 1, 1]] * 4
    feeds = rng.integers(0, tcfg.vocab_size, (len(schedule), B))
    cache = tinf.make_cache(tcfg, B, MAX_SEQ, base=MAX_PROMPT,
                            kv_quant=quant, device='cpu')
    _prefill_rows(tparams, tcfg, cache, prompts)
    got = [[] for _ in range(B)]
    for act, toks in zip(schedule, feeds):
        logits, _ = tinf.decode_step(
            tparams, cache, torch.from_numpy(toks.astype(np.int32)), tcfg,
            active=torch.tensor(act, dtype=torch.bool), page=PAGE,
            num_pages=MAX_SEQ // PAGE)
        for row in range(B):
            if act[row]:
                got[row].append(logits[row].numpy())
    assert cache['steps'].tolist() == [9, 4, 6]
    for row in range(B):
        alone = tinf.make_cache(tcfg, 1, MAX_SEQ, base=MAX_PROMPT,
                                kv_quant=quant, device='cpu')
        _prefill_rows(tparams, tcfg, alone, [prompts[row]])
        want = []
        for act, toks in zip(schedule, feeds):
            if act[row]:
                lg, _ = tinf.decode_step(
                    tparams, alone, torch.tensor([int(toks[row])],
                                                 dtype=torch.int32),
                    tcfg, page=PAGE)
                want.append(lg[0].numpy())
        np.testing.assert_allclose(np.stack(got[row]), np.stack(want),
                                   atol=ATOL_LOGITS, rtol=0)
        assert int(alone['steps'][0]) == int(cache['steps'][row])
        np.testing.assert_array_equal(cache['dmask'][row].numpy(),
                                      alone['dmask'][0].numpy())
        live = alone['dmask'][0].numpy()
        for f in ('k', 'v', 'k_scale', 'v_scale'):
            if f not in cache:
                continue
            a = cache[f][:, row].float().numpy()[:, live]
            b = alone[f][:, 0].float().numpy()[:, live]
            np.testing.assert_allclose(a, b, atol=ATOL_CACHE, rtol=0,
                                       err_msg=f)


@pytest.mark.parametrize('impl', ['paged', 'lax'])
def test_an_idle_row_reads_no_cache_column(models, impl):
    """An idle row's logits attend to its own K/V alone, whatever its
    cache holds (NaN planted in its live columns here): the same logits
    as the row with an empty cache; the active rows' are untouched by
    it."""
    _, _, tcfg, tparams = models
    rng = np.random.default_rng(23)
    prompts = [rng.integers(0, tcfg.vocab_size, n).tolist()
               for n in (6, 11, 4)]
    toks = torch.tensor([5, 9, 17], dtype=torch.int32)
    act = torch.tensor([True, False, True])
    runs = []
    for poison in (False, True):
        cache = tinf.make_cache(tcfg, B, MAX_SEQ, base=MAX_PROMPT,
                                device='cpu')
        _prefill_rows(tparams, tcfg, cache, prompts)
        if poison:
            for f in ('k', 'v'):
                cache[f][:, 1, :11] = float('nan')
        runs.append(tinf.decode_step(tparams, cache, toks, tcfg, active=act,
                                     attn_impl=impl, page=PAGE,
                                     num_pages=MAX_SEQ // PAGE)[0])
    empty = tinf.make_cache(tcfg, 1, MAX_SEQ, base=MAX_PROMPT, device='cpu')
    alone, _ = tinf.decode_step(tparams, empty, toks[1:2], tcfg,
                                attn_impl=impl, page=PAGE)
    assert torch.isfinite(runs[1]).all()
    assert torch.equal(runs[0], runs[1])
    np.testing.assert_allclose(runs[1][1].numpy(), alone[0].numpy(),
                               atol=ATOL_LOGITS, rtol=0)


def test_a_row_past_its_decode_columns_stays_in_its_own_row(models):
    """A row that decodes past every decode column (a chunk that runs
    beyond its max_new) is held at the cache's last column: its count
    stops at the capacity, nothing lands past ``max_seq``, the columns
    its kept tokens read keep their K/V, and the other row (idle, its
    count at 0) is untouched but for its own frontier column."""
    _, _, tcfg, tparams = models
    cap = MAX_SEQ - MAX_PROMPT
    cache = tinf.make_cache(tcfg, 2, MAX_SEQ, base=MAX_PROMPT, device='cpu')
    _prefill_rows(tparams, tcfg, cache, [[1, 2, 3], [4, 5]])
    act = torch.tensor([True, False])
    tok = torch.tensor([7, 8], dtype=torch.int32)
    for _ in range(cap - 1):
        tinf.decode_step(tparams, cache, tok, tcfg, active=act, page=PAGE)
    kept = cache['k'][:, 0, :MAX_SEQ - 1].clone()
    other = cache['k'][:, 1].clone()
    for _ in range(5):
        tinf.decode_step(tparams, cache, tok, tcfg, active=act, page=PAGE)
    assert cache['steps'].tolist() == [cap, 0]
    assert torch.equal(cache['k'][:, 0, :MAX_SEQ - 1], kept)
    assert cache['dmask'][0, MAX_PROMPT:].all()
    changed = (cache['k'][:, 1] != other).any(dim=(0, 2, 3))
    assert changed.nonzero().flatten().tolist() in ([], [MAX_PROMPT])
    assert not cache['dmask'][1, MAX_PROMPT:].any()


def test_sample_greedy_top_k_ties_and_temperature():
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.0, -2.0],
                           [0.5, 0.1, 4.0, 4.0, 2.0]])
    assert tinf._sample(logits, 0.0).tolist() == [1, 2]
    gen = torch.Generator().manual_seed(0)
    seen = set()
    for _ in range(200):
        t = tinf._sample(logits, np.asarray([1.0, 0.0], np.float32),
                         top_k=1, generator=gen)
        assert t.dtype == torch.int32
        assert int(t[1]) == 2                # greedy row stays argmax
        seen.add(int(t[0]))
    assert seen == {1, 2}                    # both tied maxima survive
    # JAX agrees on the greedy and the filtered-greedy tokens.
    j = jinf._sample(jnp.asarray(logits.numpy()), jax.random.PRNGKey(0),
                     0.0, 2)
    assert np.asarray(j).tolist() == tinf._sample(logits, 0.0,
                                                  top_k=2).tolist()


def test_reference_generate_matches_jax(models):
    jcfg, jparams, tcfg, tparams = models
    rng = np.random.default_rng(9)
    toks = rng.integers(0, jcfg.vocab_size, (2, 10)).astype(np.int32)
    lengths = np.asarray([10, 6], np.int32)
    want = jinf.reference_generate(jparams, jnp.asarray(toks),
                                   jnp.asarray(lengths), jcfg, 5)
    got = tinf.reference_generate(tparams, torch.from_numpy(toks), lengths,
                                  tcfg, 5)
    assert got.tolist() == np.asarray(want).tolist()


def test_unpaged_reference_matches_jax(models):
    rng = np.random.default_rng(10)
    q = rng.standard_normal((2, 4, 16)).astype(np.float32)
    kc = rng.standard_normal((2, 16, 2, 16)).astype(np.float32)
    vc = rng.standard_normal((2, 16, 2, 16)).astype(np.float32)
    ks = rng.standard_normal((2, 2, 16)).astype(np.float32)
    vs = rng.standard_normal((2, 2, 16)).astype(np.float32)
    valid = rng.uniform(size=(2, 16)) < 0.6
    want = jinf._gqa_decode_attention(*map(jnp.asarray,
                                           (q, kc, vc, valid, ks, vs)))
    got = tinf._gqa_decode_attention(*map(torch.from_numpy,
                                          (q, kc, vc, valid, ks, vs)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=ATOL_CACHE, rtol=0)


def _prompts(vocab, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, (B, 12)).astype(np.int32)
    lengths = np.asarray([12, 5, 9], np.int32)
    return toks, lengths


@pytest.mark.parametrize('quant', [False, True], ids=['f32kv', 'int8kv'])
def test_prefill_matches_jax(models, quant):
    jcfg, jparams, tcfg, tparams = models
    toks, lengths = _prompts(jcfg.vocab_size, 11)
    jl, jc = jinf.prefill(jparams, jnp.asarray(toks), jnp.asarray(lengths),
                          jcfg, max_seq=MAX_SEQ, kv_quant=quant)
    tl, tc = tinf.prefill(tparams, torch.from_numpy(toks), lengths, tcfg,
                          max_seq=MAX_SEQ, kv_quant=quant)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                               atol=ATOL_LOGITS, rtol=0)
    _assert_caches_equal(jc, tc)
    assert tc['base'] == 12 and tc['steps'].tolist() == [0] * B


def test_generate_matches_jax(models):
    jcfg, jparams, tcfg, tparams = models
    toks, lengths = _prompts(jcfg.vocab_size, 12)
    want = jinf.generate(jparams, jnp.asarray(toks), jnp.asarray(lengths),
                         jcfg, 8, max_seq=MAX_SEQ, page=PAGE)
    got = tinf.generate(tparams, torch.from_numpy(toks), lengths, tcfg, 8,
                        max_seq=MAX_SEQ, page=PAGE)
    assert got.dtype == torch.int32
    assert got.tolist() == np.asarray(want).tolist()
    # top_k=1 sampling keeps only the argmax: the same tokens.
    gen = torch.Generator().manual_seed(0)
    sampled = tinf.generate(tparams, torch.from_numpy(toks), lengths, tcfg,
                            8, temperature=1.0, top_k=1, generator=gen,
                            max_seq=MAX_SEQ, page=PAGE)
    assert sampled.tolist() == got.tolist()
    # The cache-free oracle agrees too.
    ref = tinf.reference_generate(tparams, torch.from_numpy(toks), lengths,
                                  tcfg, 8)
    assert ref.tolist() == got.tolist()
    with pytest.raises(ValueError, match='exceeds the cache'):
        tinf.generate(tparams, torch.from_numpy(toks), lengths, tcfg,
                      MAX_SEQ - 11, max_seq=MAX_SEQ)
