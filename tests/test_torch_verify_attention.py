"""Spec-decode verify attention in the PyTorch port
(skypilot_tpu_torch/ops/flash_attention.py) against the JAX package:
the port's plain version of the verify kernel — what a CPU tensor runs
— is held to JAX ``verify_attention`` (the Pallas kernel in interpret
mode, block_k 8) and ``verify_attention_reference`` across GQA ratios
1:1, 4:1 and 8:2, ragged dmask holes, an all-false row and a read
region ``n_cols`` below S; to the int8 reference with per-vector
scales; and to the kernel's NaN discipline (NaN past the segment and
in dmask holes never reaches the output). f32, atol 1e-5. The int8
self-term difference between decode and verify (ROADMAP R3) is shown
on the reference's own functions. The CUDA kernel is held to the plain
version on the card by ``test_torch_kernels_gpu.py``."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu.models import inference as jinf
from skypilot_tpu.models import quantization as jquant
from skypilot_tpu_torch.ops import _build
from skypilot_tpu_torch.ops import flash_attention as tfa
from skypilot_tpu_torch.ops import split_kv

# The JAX ops package re-exports a ``flash_attention`` function under
# the module's name; go through importlib for the module itself.
jfa = importlib.import_module('skypilot_tpu.ops.flash_attention')

torch.set_num_threads(2)

ATOL = 1e-5
B, V, D, S, SEG = 3, 4, 16, 32, 20


def _valid():
    """Row 0: a prompt of 9 plus decode columns with rejected-candidate
    holes; row 1: inactive (all false); row 2: a recycled row whose
    new prompt is 5 long. False at and past the segment start."""
    valid = np.zeros((B, S), bool)
    valid[0, :9] = True
    valid[0, 12:SEG] = True
    valid[0, [14, 15, 18]] = False
    valid[2, :5] = True
    return valid


def _qkv(h, n_kv, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, V, h, D)).astype(np.float32),
            rng.standard_normal((B, S, n_kv, D)).astype(np.float32),
            rng.standard_normal((B, S, n_kv, D)).astype(np.float32))


def _port(q, k, v, valid, seg, ks=None, vs=None, n_cols=None):
    bf = (lambda x: None if x is None else
          torch.from_numpy(x).to(torch.bfloat16))
    return tfa.verify_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(valid), seg, bf(ks), bf(vs),
        n_cols=n_cols).float().numpy()


@pytest.mark.parametrize('n_cols', [None, 24], ids=['all-cols', 'n_cols24'])
@pytest.mark.parametrize('gqa', [(4, 4), (4, 1), (8, 2)],
                         ids=['gqa1to1', 'gqa4to1', 'gqa4to1x2'])
def test_plain_matches_jax_kernel_and_reference(gqa, n_cols):
    h, n_kv = gqa
    q, k, v = _qkv(h, n_kv, seed=0)
    valid = _valid()
    got = _port(q, k, v, valid, SEG, n_cols=n_cols)
    # JAX's caller slices the region it reads (verify_step's n_slots).
    n = n_cols or S
    jargs = (jnp.asarray(q), jnp.asarray(k[:, :n]), jnp.asarray(v[:, :n]),
             jnp.asarray(valid[:, :n]), SEG)
    pal = jfa.verify_attention(*jargs, impl='pallas', block_k=8,
                               interpret=True)
    ref = jfa.verify_attention_reference(*jargs)
    np.testing.assert_allclose(got, np.asarray(pal), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL, rtol=0)


def test_an_all_false_row_sees_its_own_segment():
    """The inactive row attends only the segment, causally: query 0 is
    its own value exactly."""
    q, k, v = _qkv(4, 2, seed=1)
    got = _port(q, k, v, _valid(), SEG)
    np.testing.assert_allclose(
        got[1, 0], np.repeat(v[1, SEG], 2, axis=0), atol=ATOL, rtol=0)


def test_nan_past_the_segment_and_in_holes_never_reaches_the_output():
    """NaN in every column no query may attend (dmask holes below the
    segment, everything past it): the output equals the clean one
    bitwise, with and without an n_cols bound."""
    q, k, v = _qkv(4, 2, seed=2)
    valid = _valid()
    dead = ~valid
    dead[:, SEG:SEG + V] = False
    pk, pv = k.copy(), v.copy()
    pk[dead] = np.nan
    pv[dead] = np.nan
    for n_cols in (None, 24):
        clean = _port(q, k, v, valid, SEG, n_cols=n_cols)
        got = _port(q, pk, pv, valid, SEG, n_cols=n_cols)
        assert np.isfinite(got).all()
        np.testing.assert_array_equal(got, clean)


@pytest.mark.parametrize('gqa', [(4, 2), (4, 4)], ids=['gqa2to1', 'mha'])
def test_int8_scales_match_jax_reference(gqa):
    """int8 cache: K scale on the scores, V scale folded into the
    probabilities, as JAX's reference (its only int8 path)."""
    h, n_kv = gqa
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, V, h, D)).astype(np.float32)
    k = rng.integers(-127, 128, (B, S, n_kv, D)).astype(np.int8)
    v = rng.integers(-127, 128, (B, S, n_kv, D)).astype(np.int8)
    ks = (rng.uniform(size=(B, S, n_kv)) * 0.02 + 0.001).astype(np.float32)
    vs = (rng.uniform(size=(B, S, n_kv)) * 0.02 + 0.001).astype(np.float32)
    valid = _valid()
    got = _port(q, k, v, valid, SEG, ks, vs)
    want = jfa.verify_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(valid),
        SEG, jnp.asarray(ks, jnp.bfloat16), jnp.asarray(vs, jnp.bfloat16))
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)
    got24 = _port(q, k, v, valid, SEG, ks, vs, n_cols=24)
    np.testing.assert_allclose(got24, got, atol=ATOL, rtol=0)


def test_cpu_tensors_take_the_plain_version_and_bad_segments_raise():
    q, k, v = _qkv(4, 2, seed=4)
    _build.reset_launches()
    _port(q, k, v, _valid(), SEG)
    assert _build.LAUNCHES[tfa.VERIFY_KERNEL] == 0
    with pytest.raises(ValueError, match='does not lie'):
        _port(q, k, v, _valid(), SEG, n_cols=SEG + 2)
    with pytest.raises(ValueError, match='does not lie'):
        _port(q, k, v, _valid(), S - 1)


def test_int8_self_term_differs_between_decode_and_verify_in_the_reference():
    """ROADMAP R3, shown on JAX's own functions: decode attends a
    token's own K/V unquantized (the self term), verify writes it
    quantized first. For one token, verify_attention_reference over
    the quantized cache equals the decode attention whose self term is
    the DEquantized K/V, and differs from the one whose self term is
    the raw K/V — so with an int8 cache spec-on and spec-off feed a
    token's own K/V at different precision, by construction."""
    rng = np.random.default_rng(5)
    h, n_kv, s, seg = 4, 2, 16, 9
    q = rng.standard_normal((B, 1, h, D)).astype(np.float32)
    kf = rng.standard_normal((B, s, n_kv, D)).astype(np.float32)
    vf = rng.standard_normal((B, s, n_kv, D)).astype(np.float32)
    kq, ks = jquant.quantize_kv(jnp.asarray(kf))
    vq, vs = jquant.quantize_kv(jnp.asarray(vf))
    valid = np.zeros((B, s), bool)
    valid[:, :seg] = True
    verify = np.asarray(jfa.verify_attention_reference(
        jnp.asarray(q), kq, vq, jnp.asarray(valid), seg, ks, vs))[:, 0]

    def decode(k_self, v_self):
        out = jinf._gqa_decode_attention(
            jnp.asarray(q[:, 0]), kq, vq, jnp.asarray(valid),
            k_self=k_self, v_self=v_self, k_scale=ks, v_scale=vs)
        return np.asarray(out).reshape(B, h, D)

    deq = (jquant.dequantize_kv(kq, ks, jnp.float32)[:, seg],
           jquant.dequantize_kv(vq, vs, jnp.float32)[:, seg])
    np.testing.assert_allclose(decode(*deq), verify, atol=ATOL, rtol=0)
    raw = decode(jnp.asarray(kf[:, seg]), jnp.asarray(vf[:, seg]))
    assert np.abs(raw - verify).max() > 1e-4
    # The port's plain version takes the same (quantized) view.
    got = _port(q, np.array(kq), np.array(vq), valid, seg,
                np.array(ks.astype(jnp.float32)),
                np.array(vs.astype(jnp.float32)))
    np.testing.assert_allclose(got[:, 0], verify, atol=ATOL, rtol=0)


def test_the_kernel_wrapper_refuses_what_the_kernel_does_not_take():
    """The CUDA wrapper's checks run before any build or launch, so they
    show here: a head_dim off the 16-byte load grid, an unsupported
    dtype, scales without their pair, a non-bool dmask. (Any number of
    query rows is taken: ``test_plain_matches_jax_kernel_wide_segments``
    and the card's tests hold segments of more than 64 rows.)"""
    def call(q, k, valid=None, ks=None, vs=None):
        valid = torch.zeros(k.shape[:2], dtype=torch.bool) if valid is None \
            else valid
        return tfa._verify_attention_cuda(q, k, k, valid, 4, ks, vs,
                                          k.shape[1])
    k = torch.zeros((1, 16, 2, 64))
    with pytest.raises(ValueError, match='multiple of 16'):
        call(torch.zeros((1, 2, 4, 24)), torch.zeros((1, 16, 2, 24)))
    with pytest.raises(TypeError, match='float32 or bfloat16'):
        call(torch.zeros((1, 2, 4, 64), dtype=torch.float16),
             k.to(torch.float16))
    with pytest.raises(ValueError, match='go together'):
        call(torch.zeros((1, 2, 4, 64)), k.to(torch.int8),
             ks=torch.ones((1, 16, 2), dtype=torch.bfloat16))
    with pytest.raises(ValueError, match='bool valid'):
        call(torch.zeros((1, 2, 4, 64)), k,
             valid=torch.zeros((1, 16), dtype=torch.int8))


@pytest.mark.parametrize('gqa,vq', [((8, 1), 9), ((4, 1), 17)],
                         ids=['72rows', '68rows'])
def test_plain_matches_jax_kernel_wide_segments(gqa, vq):
    """More query rows per kv head than one 64-row tile (rep x V of
    8 x 9 and 4 x 17, spec_k 8 and 16): the port's plain version — the
    semantics K3 now holds at any width — equals JAX's Pallas kernel in
    interpret mode and its reference."""
    h, n_kv = gqa
    b, s, seg = 2, 48, 24
    rng = np.random.default_rng(vq)
    q = rng.standard_normal((b, vq, h, D)).astype(np.float32)
    k = rng.standard_normal((b, s, n_kv, D)).astype(np.float32)
    v = rng.standard_normal((b, s, n_kv, D)).astype(np.float32)
    valid = np.zeros((b, s), bool)
    valid[0, :11] = True
    valid[0, 16:seg] = True
    valid[0, 19] = False
    got = _port(q, k, v, valid, seg)
    jargs = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
             jnp.asarray(valid), seg)
    pal = jfa.verify_attention(*jargs, impl='pallas', block_k=8,
                               interpret=True)
    ref = jfa.verify_attention_reference(*jargs)
    np.testing.assert_allclose(got, np.asarray(pal), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL, rtol=0)


LOG2E = 1.4426950408889634


def _split_merge(q, k, v, allow, split_tiles, n_split, tile):
    """The bf16 K3 kernel's arithmetic in f32 torch: q [R, D] (one
    block's rows), k/v [S, D], allow [R, S]. The live keys (columns some
    row may attend), in column order, cut into ``tile``-key tiles, the
    tiles into split_kv.split_ranges (runs of ``split_tiles``,
    ``n_split`` of them); each split runs the online softmax tile by
    tile in log2 units (a row's masked keys have probability exactly 0)
    into an unnormalised (m, l, acc); the partials merge in split
    order."""
    rows = allow.shape[0]
    live = allow.any(0)
    k, v, allow = k[live], v[live], allow[:, live]
    n = k.shape[0]
    scale2 = q.shape[-1]**-0.5 * LOG2E
    parts = []
    for t0, t1 in split_kv.split_ranges(-(-n // tile), split_tiles,
                                        n_split):
        m = torch.full((rows,), -np.inf)
        l = torch.zeros(rows)
        acc = torch.zeros(rows, q.shape[-1])
        for t in range(t0, t1):
            c = slice(t * tile, min(n, (t + 1) * tile))
            x = torch.where(allow[:, c], q @ k[c].T * scale2, -np.inf)
            m_new = torch.maximum(m, x.amax(1))
            m_use = torch.where(m_new == -np.inf, 0.0, m_new)
            corr = torch.exp2(m - m_use)
            p = torch.where(allow[:, c], torch.exp2(x - m_use[:, None]), 0.0)
            l = l * corr + p.sum(1)
            acc = acc * corr[:, None] + p @ v[c]
            m = m_new
        parts.append((m, l, acc))
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    mu = torch.where(mx == -np.inf, 0.0, mx)
    l = sum(li * torch.exp2(m - mu) for m, li, _ in parts)
    o = sum(a * torch.exp2(m - mu)[:, None] for m, _, a in parts)
    return o / torch.clamp(l, min=1e-30)[:, None]


@pytest.mark.parametrize('split_tiles', [1, 2, 3, 7])
def test_split_and_merge_arithmetic_matches_the_reference(split_tiles):
    """The split kernel's partial-and-merge arithmetic (``_split_merge``)
    over every (row, kv head) of a 72-row segment, in f32, equals
    ``verify_attention_reference`` within 1e-6, with as many splits as
    the wrapper launches for the columns: at 7 tiles a run some splits
    are empty, and the inactive row's splits hold only its segment. NaN
    in every dead column."""
    b, vq, h, n_kv, s, seg, tile = 3, 9, 16, 2, 48, 38, 8
    rep = h // n_kv
    rng = np.random.default_rng(split_tiles)
    q = torch.from_numpy(rng.standard_normal((b, vq, h, D)).astype(
        np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((b, s, n_kv, D)).astype(
        np.float32)) for _ in range(2))
    valid = torch.zeros((b, s), dtype=torch.bool)
    valid[0, :13] = True
    valid[0, 20:seg] = True
    valid[0, [22, 31]] = False                # rejected candidates
    valid[2, :3] = True                       # a recycled row; row 1 idle
    col = torch.arange(s)
    qi = torch.arange(vq)
    allow = valid[:, None, :] | ((col >= seg) & (col <= seg + qi[:, None]))
    dead = ~allow.any(1)                                     # [B, S]
    k[dead], v[dead] = float('nan'), float('nan')
    want = tfa.verify_attention_reference(q, k, v, valid, seg)
    n_split = split_kv.split_count(-(-s // tile), split_tiles)
    got = torch.empty_like(want)
    for row in range(b):
        for kh in range(n_kv):
            # Block row r: segment position r / rep, head kh rep + r % rep.
            qr = q[row, :, kh * rep:(kh + 1) * rep].reshape(vq * rep, D)
            ar = allow[row].repeat_interleave(rep, 0)
            o = _split_merge(qr, k[row, :, kh], v[row, :, kh], ar,
                             split_tiles, n_split, tile)
            got[row, :, kh * rep:(kh + 1) * rep] = o.reshape(vq, rep, D)
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0)


def test_split_geometry():
    """A block's run of live-key tiles comes from the launch's fixed
    shape (slots, the cache's tiles, the SMs): a full cache's grid within
    four blocks per SM, runs of at most 16 tiles, at most one split per
    tile and 64 in all; the wrapper launches enough runs to cover the
    dispatched tiles; the ranges are the runs in order, cut at the live
    tiles, empty past them; K3's blocks hold one or two 64-row tiles."""
    assert split_kv.tiles_per_split(64, 16, 132) == 2
    assert split_kv.tiles_per_split(64, 12, 132) == 2
    assert split_kv.tiles_per_split(64, 2, 132) == 1
    assert split_kv.tiles_per_split(512, 100, 132) == 15
    # The chat engines' K1 (Mistral 64 x 8, Mixtral 32 x 8 slots, 4,096
    # columns): four runs of 16 tiles a row.
    assert split_kv.tiles_per_split(512, 64, 132) == 16
    assert split_kv.tiles_per_split(256, 64, 132) == 16
    assert split_kv.tiles_per_split(8, 0, 132) == 1
    assert split_kv.tiles_per_split(2, 1000, 132) == 16
    assert split_kv.split_count(10, 4) == 3
    assert split_kv.split_count(0, 4) == 1
    assert split_kv.split_ranges(6, 1, 7) == [(0, 1), (1, 2), (2, 3),
                                              (3, 4), (4, 5), (5, 6),
                                              (6, 6)]
    assert split_kv.split_ranges(10, 4, 3) == [(0, 4), (4, 8), (8, 10)]
    assert split_kv.split_ranges(3, 2, 4) == [(0, 2), (2, 3), (3, 3),
                                              (3, 3)]
    assert [split_kv.rows_per_block(r) for r in (1, 20, 64, 65, 136)] == \
        [64, 64, 64, 128, 128]