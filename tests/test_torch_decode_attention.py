"""Paged GQA decode attention in the PyTorch port
(skypilot_tpu_torch/ops/decode_attention.py) against the JAX package:
the port's plain version of the kernel — what a CPU tensor runs — is
held to JAX ``paged_gqa_decode_attention`` (the Pallas kernel in
interpret mode) and to the einsum reference
``inference._gqa_decode_attention``, across GQA ratios, int8 caches,
page-boundary lengths, dmask holes, empty rows and page bounds with
NaN planted where nothing may be read. f32 inputs, atol 1e-5: the two
frameworks sum in different orders, so bits may differ in the last
place. The hand-written CUDA kernel is held to the same plain version
on the card by ``test_torch_kernels_gpu.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import inference as jinf
from skypilot_tpu.ops import decode_attention as jda
from skypilot_tpu_torch.ops import _build
from skypilot_tpu_torch.ops import decode_attention as tda
from skypilot_tpu_torch.ops import split_kv

torch.set_num_threads(2)

HD = 16
ATOL = 1e-5


def _inputs(b, s, n_kv, rep, *, quant=False, seed=0):
    """numpy inputs: (q, kc, vc, k_scale, v_scale, k_self, v_self)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, n_kv * rep, HD)).astype(np.float32)
    if quant:
        kc = rng.integers(-127, 128, (b, s, n_kv, HD)).astype(np.int8)
        vc = rng.integers(-127, 128, (b, s, n_kv, HD)).astype(np.int8)
        ksc = (rng.uniform(size=(b, s, n_kv)) * 0.02 + 0.001).astype(
            np.float32)
        vsc = (rng.uniform(size=(b, s, n_kv)) * 0.02 + 0.001).astype(
            np.float32)
    else:
        kc = rng.standard_normal((b, s, n_kv, HD)).astype(np.float32)
        vc = rng.standard_normal((b, s, n_kv, HD)).astype(np.float32)
        ksc = vsc = None
    k_self = rng.standard_normal((b, n_kv, HD)).astype(np.float32)
    v_self = rng.standard_normal((b, n_kv, HD)).astype(np.float32)
    return q, kc, vc, ksc, vsc, k_self, v_self


def _jax(x, scale=False):
    if x is None:
        return None
    return jnp.asarray(x, jnp.bfloat16) if scale else jnp.asarray(x)


def _torch(x, scale=False):
    if x is None:
        return None
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.to(torch.bfloat16) if scale else t


def _run_both(q, kc, vc, valid, bound, ksc, vsc, k_self, v_self, *,
              page, num_pages=None, jax_paged=True):
    """(port plain, JAX reference) outputs as f32 numpy."""
    t_args = (_torch(q), _torch(kc), _torch(vc), _torch(valid),
              _torch(bound.astype(np.int32)))
    got = tda.paged_gqa_decode_attention(
        *t_args, k_self=_torch(k_self), v_self=_torch(v_self),
        k_scale=_torch(ksc, True), v_scale=_torch(vsc, True), page=page,
        num_pages=num_pages)
    j_kw = dict(k_self=_jax(k_self), v_self=_jax(v_self),
                k_scale=_jax(ksc, True), v_scale=_jax(vsc, True))
    if jax_paged:
        want = jda.paged_gqa_decode_attention(
            _jax(q), _jax(kc), _jax(vc), _jax(valid), _jax(bound), **j_kw,
            page=page, num_pages=num_pages, interpret=True)
    else:
        want = jinf._gqa_decode_attention(_jax(q), _jax(kc), _jax(vc),
                                          _jax(valid), **j_kw)
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize('n_kv,rep', [(4, 1), (2, 2), (2, 4)],
                         ids=['gqa1to1', 'gqa2to1', 'gqa4to1'])
@pytest.mark.parametrize('quant', [False, True], ids=['f32', 'int8kv'])
def test_plain_matches_jax_kernel_gqa_ratios(n_kv, rep, quant):
    b, s, page = 3, 32, 8
    q, kc, vc, ksc, vsc, k_self, v_self = _inputs(b, s, n_kv, rep,
                                                  quant=quant)
    lengths = np.asarray([3, 17, 32], np.int32)
    valid = np.arange(s)[None, :] < lengths[:, None]
    got, want = _run_both(q, kc, vc, valid, lengths, ksc, vsc, k_self,
                          v_self, page=page)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    got, want = _run_both(q, kc, vc, valid, lengths, ksc, vsc, k_self,
                          v_self, page=page, jax_paged=False)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize('length', [7, 8, 9, 15, 16, 17, 0, 32], ids=str)
def test_plain_matches_jax_at_page_boundaries(length):
    """length == k*page +/- 1, both sides of every page edge."""
    b, s, page = 2, 32, 8
    q, kc, vc, ksc, vsc, k_self, v_self = _inputs(b, s, 2, 2, seed=1)
    lengths = np.asarray([length, max(1, length // 2)], np.int32)
    valid = np.arange(s)[None, :] < lengths[:, None]
    got, want = _run_both(q, kc, vc, valid, lengths, ksc, vsc, k_self,
                          v_self, page=page)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize('quant', [False, True], ids=['f32', 'int8kv'])
def test_plain_matches_jax_with_holes_in_live_region(quant):
    """Prompt prefix plus a decode region behind ``base`` with a dead
    gap between: row_bound only skips whole pages, dmask decides."""
    b, s, page, base, steps = 2, 32, 8, 16, 5
    q, kc, vc, ksc, vsc, k_self, v_self = _inputs(b, s, 2, 4, quant=quant,
                                                  seed=2)
    plens = np.asarray([3, 12])
    pos = np.arange(s)[None, :]
    valid = (pos < plens[:, None]) | ((pos >= base) & (pos < base + steps))
    bound = np.full((b,), base + steps, np.int32)
    got, want = _run_both(q, kc, vc, valid, bound, ksc, vsc, k_self,
                          v_self, page=page)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_plain_without_self_term_matches_jax():
    b, s, page = 2, 16, 8
    q, kc, vc, ksc, vsc, _, _ = _inputs(b, s, 2, 2, seed=3)
    lengths = np.asarray([5, 16], np.int32)
    valid = np.arange(s)[None, :] < lengths[:, None]
    got, want = _run_both(q, kc, vc, valid, lengths, ksc, vsc, None, None,
                          page=page)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_empty_row_gives_the_self_value():
    """An all-dead row (a recycled, not yet refilled slot) attends to
    itself alone: the result is v_self, finite, as in JAX."""
    b, s, page = 2, 16, 8
    q, kc, vc, _, _, k_self, v_self = _inputs(b, s, 2, 2, seed=4)
    valid = np.zeros((b, s), bool)
    bound = np.zeros((b,), np.int32)
    got, want = _run_both(q, kc, vc, valid, bound, None, None, k_self,
                          v_self, page=page)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    self_only = np.broadcast_to(v_self[:, :, None],
                                (b, 2, 2, HD)).reshape(b, -1)
    np.testing.assert_allclose(got, self_only, atol=ATOL, rtol=0)


@pytest.mark.parametrize('quant', [False, True], ids=['f32', 'int8kv'])
def test_num_pages_and_row_bound_are_never_read_past(quant):
    """NaN in every slot at or past num_pages * page, in each row's
    pages at or past its bound, and in a masked slot inside the live
    region: the result equals JAX's reference on the clean cache. (The
    JAX kernel itself is only NaN-safe past the bounds: it multiplies
    zeroed probabilities by a masked slot's V.)"""
    b, s, page, num_pages = 3, 32, 8, 3
    q, kc, vc, ksc, vsc, k_self, v_self = _inputs(b, s, 2, 2, quant=quant,
                                                  seed=5)
    lengths = np.asarray([num_pages * page, 10, 0], np.int32)
    valid = np.arange(s)[None, :] < lengths[:, None]
    valid[0, 4] = False                       # a hole inside row 0
    clean = _run_both(q, kc, vc, valid, lengths, ksc, vsc, k_self, v_self,
                      page=page, jax_paged=False)[1]
    # int8 caches cannot hold NaN: poison their scales instead.
    pk, pv = ((ksc.copy(), vsc.copy()) if quant else (kc.copy(), vc.copy()))
    pk[:, num_pages * page:] = np.nan
    pv[:, num_pages * page:] = np.nan
    for row, length in enumerate(lengths):
        dead = -(-int(length) // page) * page
        pk[row, dead:] = np.nan
        pv[row, dead:] = np.nan
    pk[0, 4] = np.nan
    pv[0, 4] = np.nan
    if quant:
        ksc, vsc = pk, pv
    else:
        kc, vc = pk, pv
    got = _run_both(q, kc, vc, valid, lengths, ksc, vsc, k_self, v_self,
                    page=page, num_pages=num_pages, jax_paged=False)[0]
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, clean, atol=ATOL, rtol=0)


def test_num_pages_for_matches_jax_policy():
    for live in range(1, 1400, 37):
        for base_pages in (0, 4, 8):
            assert tda.num_pages_for(live, 128, 10, base_pages) == \
                jda.num_pages_for(live, 128, 10, base_pages)


def test_default_page_reads_the_same_knob(monkeypatch):
    assert tda.default_page() == jda.default_page() == 128
    monkeypatch.setenv('SKYTPU_DECODE_PAGE', '32')
    assert tda.default_page() == jda.default_page() == 32


def test_cpu_tensors_take_the_plain_version():
    """A CPU tensor never reaches the kernel: no launch is counted."""
    b, s, page = 2, 16, 8
    q, kc, vc, _, _, k_self, v_self = _inputs(b, s, 2, 2, seed=6)
    _build.reset_launches()
    valid = torch.ones((b, s), dtype=torch.bool)
    tda.paged_gqa_decode_attention(
        _torch(q), _torch(kc), _torch(vc), valid,
        torch.full((b,), s, dtype=torch.int32), _torch(k_self),
        _torch(v_self), page=page)
    assert _build.LAUNCHES[tda.KERNEL] == 0


LOG2E = 1.4426950408889634


def _split_merge(q, k, v, live, n_split, tile, k_self, v_self):
    """The bf16 K1 kernel's arithmetic in f32 torch for one (row, kv
    head): q [rep, hd], k/v [end, hd] (the row's columns up to its live
    end), live [end]. The columns cut into ``tile``-column tiles, the
    tiles into split_kv.split_ranges; each split runs the online softmax
    tile by tile in log2 units (dead columns zeroed before the products,
    their probabilities exactly 0) into an unnormalised (m, l, acc); the
    partials merge in split order with the self term as one more
    step."""
    rep, hd = q.shape
    end = k.shape[0]
    k = torch.where(live[:, None], k, 0.0)
    v = torch.where(live[:, None], v, 0.0)
    scale2 = hd**-0.5 * LOG2E
    parts = []
    for t0, t1 in split_kv.split_ranges(-(-end // tile), n_split):
        m = torch.full((rep,), -np.inf)
        l = torch.zeros(rep)
        acc = torch.zeros(rep, hd)
        for t in range(t0, t1):
            c = slice(t * tile, min(end, (t + 1) * tile))
            x = torch.where(live[c], q @ k[c].T * scale2, -np.inf)
            m_new = torch.maximum(m, x.amax(1))
            m_use = torch.where(m_new == -np.inf, 0.0, m_new)
            corr = torch.exp2(m - m_use)
            p = torch.where(live[c], torch.exp2(x - m_use[:, None]), 0.0)
            l = l * corr + p.sum(1)
            acc = acc * corr[:, None] + p @ v[c]
            m = m_new
        parts.append((m, l, acc))
    s_self = q @ k_self * scale2
    mx = torch.stack([s_self] + [m for m, _, _ in parts]).amax(0)
    mu = torch.where(mx == -np.inf, 0.0, mx)
    w_self = torch.exp2(s_self - mu)
    l = w_self + sum(li * torch.exp2(m - mu) for m, li, _ in parts)
    o = w_self[:, None] * v_self + sum(a * torch.exp2(m - mu)[:, None]
                                       for m, _, a in parts)
    return o / torch.clamp(l, min=1e-30)[:, None]


@pytest.mark.parametrize('n_split', [1, 2, 3, 7])
def test_split_and_merge_arithmetic_matches_the_reference(n_split):
    """The split kernel's partial-and-merge arithmetic (``_split_merge``),
    with the self term, over every (row, kv head), in f32, equals
    ``paged_decode_reference`` within 1e-6: a row with bound 0 (every
    split empty), a row of one tile (empty splits past it), a hole that
    covers whole tiles (all-dead splits), a split boundary inside a
    hole, num_pages below the cache's pages; NaN wherever nothing may be
    read."""
    b, s, n_kv, rep, page, num_pages, tile = 4, 64, 2, 4, 16, 3, 8
    q, kc, vc, _, _, k_self, v_self = (
        None if x is None else torch.from_numpy(x)
        for x in _inputs(b, s, n_kv, rep, seed=10 + n_split))
    bound = torch.tensor([0, 5, 48, 40], dtype=torch.int32)
    pos = torch.arange(s)
    valid = pos[None, :] < bound[:, None]
    valid[2, 8:30] = False                    # tiles 1-2 dead, 3 partly
    valid[3, 3] = False
    row_end = torch.clamp((bound + page - 1) // page * page,
                          max=num_pages * page)
    readable = valid & (pos[None, :] < row_end[:, None])
    kc[~readable], vc[~readable] = float('nan'), float('nan')
    want = tda.paged_decode_reference(q, kc, vc, valid, bound, k_self,
                                      v_self, page=page,
                                      num_pages=num_pages)
    got = torch.empty((b, n_kv, rep, HD))
    for row in range(b):
        end = int(row_end[row])
        for kh in range(n_kv):
            got[row, kh] = _split_merge(
                q[row, kh * rep:(kh + 1) * rep], kc[row, :end, kh],
                vc[row, :end, kh], readable[row, :end], n_split, tile,
                k_self[row, kh], v_self[row, kh])
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got.reshape(b, -1), want, atol=1e-6, rtol=0)
