"""Chunked-prefill attention in the PyTorch port
(skypilot_tpu_torch/ops/flash_attention.py) against the JAX package:
the port's plain version of the chunk kernel — what a CPU tensor runs
— is held to JAX ``chunk_prefill_attention`` (the Pallas kernel in
interpret mode, block_k 8) and ``chunk_attention_reference`` across
GQA ratios and ragged per-row offsets, to the int8 reference with
per-vector scales, and to the kernel's NaN discipline past each row's
causal frontier. ``reference_attention`` (the cache-free oracle's
attention) is held to JAX's too. f32, atol 1e-5. The CUDA kernels are
held to the plain version on the card by ``test_torch_kernels_gpu.py``;
the bf16 tensor-core kernel's rounding (online softmax over 64-key
tiles, P * v_scale rounded to bf16 before P V) is rehearsed here in f32
arithmetic against the bf16 bar."""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu_torch.ops import _build
from skypilot_tpu_torch.ops import flash_attention as tfa

# The JAX ops package re-exports a ``flash_attention`` function under
# the module's name; go through importlib for the module itself.
jfa = importlib.import_module('skypilot_tpu.ops.flash_attention')

torch.set_num_threads(2)

ATOL = 1e-5
LOG2E = 1.4426950408889634


def _qkv(g, c, h, n_kv, d, s, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((g, c, h, d)).astype(np.float32),
            rng.standard_normal((g, s, n_kv, d)).astype(np.float32),
            rng.standard_normal((g, s, n_kv, d)).astype(np.float32))


def _port(q, k, v, off, ks=None, vs=None):
    bf = (lambda x: None if x is None else
          torch.from_numpy(x).to(torch.bfloat16))
    return tfa.chunk_prefill_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(off), bf(ks), bf(vs)).float().numpy()


@pytest.mark.parametrize('gqa', [(4, 4), (4, 1), (8, 2)],
                         ids=['gqa1to1', 'gqa4to1', 'gqa4to1x2'])
def test_plain_matches_jax_kernel_and_reference(gqa):
    h, n_kv = gqa
    g, c, d, s = 3, 8, 16, 32
    q, k, v = _qkv(g, c, h, n_kv, d, s, seed=0)
    off = np.asarray([0, 5, 17], np.int32)
    got = _port(q, k, v, off)
    pal = jfa.chunk_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(off),
        impl='pallas', block_k=8, interpret=True)
    ref = jfa.chunk_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(off))
    np.testing.assert_allclose(got, np.asarray(pal), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(ref), atol=ATOL, rtol=0)


def test_nan_past_the_causal_frontier_never_reaches_the_output():
    """Row g's frontier is offset + C: NaN planted from there on (the
    prompt headroom a gathered row is padded with) must not reach any
    output. The JAX kernel only skips whole blocks past the frontier,
    so it gets its poison from the next block edge on (its own test's
    discipline); both equal the clean result."""
    g, c, h, n_kv, d, s, block = 2, 8, 4, 2, 16, 32, 8
    q, k, v = _qkv(g, c, h, n_kv, d, s, seed=1)
    off = np.asarray([0, 5], np.int32)
    clean = _port(q, k, v, off)
    pk, pv, bk, bv = k.copy(), v.copy(), k.copy(), v.copy()
    for row, o in enumerate(off):
        edge = -(-(o + c) // block) * block
        pk[row, o + c:] = pv[row, o + c:] = np.nan
        bk[row, edge:] = bv[row, edge:] = np.nan
    got = _port(q, pk, pv, off)
    pal = jfa.chunk_prefill_attention(
        jnp.asarray(q), jnp.asarray(bk), jnp.asarray(bv), jnp.asarray(off),
        impl='pallas', block_k=block, interpret=True)
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got, clean)
    np.testing.assert_allclose(np.asarray(pal), clean, atol=ATOL, rtol=0)


@pytest.mark.parametrize('gqa', [(4, 2), (4, 4)], ids=['gqa2to1', 'mha'])
def test_int8_scales_match_jax_reference(gqa):
    """int8 cache: K scale on the scores, V scale folded into the
    probabilities, as JAX's reference path (its only int8 path)."""
    h, n_kv = gqa
    rng = np.random.default_rng(2)
    g, c, d, s = 2, 4, 16, 16
    q = rng.standard_normal((g, c, h, d)).astype(np.float32)
    k = rng.integers(-127, 128, (g, s, n_kv, d)).astype(np.int8)
    v = rng.integers(-127, 128, (g, s, n_kv, d)).astype(np.int8)
    ks = (rng.uniform(size=(g, s, n_kv)) * 0.02 + 0.001).astype(np.float32)
    vs = (rng.uniform(size=(g, s, n_kv)) * 0.02 + 0.001).astype(np.float32)
    off = np.asarray([3, 11], np.int32)
    got = _port(q, k, v, off, ks, vs)
    want = jfa.chunk_prefill_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(off),
        jnp.asarray(ks, jnp.bfloat16), jnp.asarray(vs, jnp.bfloat16))
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize('gqa', [(4, 4), (4, 2)], ids=['mha', 'gqa2to1'])
def test_reference_attention_matches_jax(gqa):
    """The cache-free oracle's attention, with the bottom-right causal
    rule (Sq < Sk)."""
    h, n_kv = gqa
    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 5, h, 16)).astype(np.float32)
    k = rng.standard_normal((2, 9, n_kv, 16)).astype(np.float32)
    v = rng.standard_normal((2, 9, n_kv, 16)).astype(np.float32)
    for causal in (True, False):
        got = tfa.reference_attention(torch.from_numpy(q),
                                      torch.from_numpy(k),
                                      torch.from_numpy(v), causal=causal)
        want = jfa.reference_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=ATOL, rtol=0)


def test_cpu_tensors_take_the_plain_version():
    q, k, v = _qkv(1, 4, 2, 2, 16, 8, seed=4)
    _build.reset_launches()
    _port(q, k, v, np.asarray([2], np.int32))
    assert _build.LAUNCHES[tfa.KERNEL] == 0


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _tensor_core_route(q, k, v, off, ks=None, vs=None, block=64):
    """The bf16 chunk kernel (csrc/chunk_prefill.cu, its tensor-core
    route) in f32 arithmetic: q bf16, k/v bf16 or int8 (entering the
    products unscaled); scores (q . k) * d^-0.5 * k_scale in log2 units,
    the online softmax over 64-key tiles, l summing the f32 P, and P V
    taking bf16(P * v_scale); out = acc / l in bf16."""
    g, c, h, d = q.shape
    s, n_kv = k.shape[1], k.shape[2]
    rep = h // n_kv
    qf = q.float().reshape(g, c, n_kv, rep, d)
    kf, vf = k.float(), v.float()
    allow = (torch.arange(s)[None, None, :] <=
             (off.long()[:, None] + torch.arange(c)[None, :])[:, :, None])
    sc = torch.einsum('gcnrd,gsnd->gcnrs', qf, kf) * (d**-0.5 * LOG2E)
    if ks is not None:
        sc = sc * ks.float().permute(0, 2, 1)[:, None, :, None, :]
    sc = torch.where(allow[:, :, None, None, :], sc, -torch.inf)
    m = torch.full(sc.shape[:-1], -torch.inf)
    l = torch.zeros(sc.shape[:-1])
    acc = torch.zeros(sc.shape[:-1] + (d,))
    for k0 in range(0, s, block):
        t = sc[..., k0:k0 + block]
        m_new = torch.maximum(m, t.amax(-1))
        m_use = torch.where(m_new == -torch.inf, 0.0, m_new)
        corr = torch.exp2(m - m_use)
        p = torch.exp2(t - m_use[..., None])
        l = l * corr + p.sum(-1)
        if vs is not None:
            p = p * vs[:, k0:k0 + block].float().permute(
                0, 2, 1)[:, None, :, None, :]
        acc = acc * corr[..., None] + torch.einsum(
            'gcnrs,gsnd->gcnrd', _bf16(p), vf[:, k0:k0 + block])
        m = m_new
    return (acc / l[..., None]).reshape(g, c, h, d).to(torch.bfloat16)


@pytest.mark.parametrize('c', [40, 128])
@pytest.mark.parametrize('rep', [1, 4])
@pytest.mark.parametrize('cache', ['bf16', 'int8'])
def test_tensor_core_rounding_within_the_bf16_bar(cache, rep, c):
    """The bf16 route's rounding stays within the bar the kernel is held
    to on the card, 1e-2 + 2^-7 |plain| element-wise against
    ``chunk_attention_reference``, on inputs made from a seed: offsets 0,
    63 and S - C; for int8 caches, against JAX's reference as well."""
    g, n_kv, d, s = 3, 2, 64, 256
    h = n_kv * rep
    rng = np.random.default_rng(100 * rep + c)
    q = rng.standard_normal((g, c, h, d)).astype(np.float32)
    off = np.asarray([0, 63, s - c], np.int32)
    ks = vs = None
    if cache == 'int8':
        k = rng.integers(-127, 128, (g, s, n_kv, d)).astype(np.int8)
        v = rng.integers(-127, 128, (g, s, n_kv, d)).astype(np.int8)
        ks = (rng.uniform(size=(g, s, n_kv)) * 0.007 + 0.001).astype(
            np.float32)
        vs = (rng.uniform(size=(g, s, n_kv)) * 0.007 + 0.001).astype(
            np.float32)
    else:
        k = rng.standard_normal((g, s, n_kv, d)).astype(np.float32)
        v = rng.standard_normal((g, s, n_kv, d)).astype(np.float32)
    bf = (lambda x: None if x is None else
          torch.from_numpy(x).to(torch.bfloat16))
    tq = bf(q)
    tk, tv = ((torch.from_numpy(x) for x in (k, v)) if cache == 'int8'
              else (bf(k), bf(v)))
    args = (tq, tk, tv, torch.from_numpy(off), bf(ks), bf(vs))
    got = _tensor_core_route(*args).float()
    wants = [tfa.chunk_attention_reference(*args).float()]
    if cache == 'int8':
        jbf = (lambda x: jnp.asarray(x.float().numpy(), jnp.bfloat16))
        wants.append(torch.from_numpy(np.asarray(
            jfa.chunk_attention_reference(
                jbf(tq), jnp.asarray(k), jnp.asarray(v), jnp.asarray(off),
                jbf(args[4]), jbf(args[5]))).astype(np.float32)))
    for want in wants:
        err = (got - want).abs()
        bar = 1e-2 + 2**-7 * want.abs()
        assert bool((err <= bar).all()), (err - bar).max().item()
