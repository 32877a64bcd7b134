"""Flash attention of the PyTorch port (skypilot_tpu_torch/ops/
flash_attention.py) against the JAX package on the same numpy inputs.

The port's plain versions of K4 (``_plain_fwd``) and K5a/K5b
(``_plain_bwd``) are held against the TPU kernels themselves, run in
interpret mode as the JAX package's own tests run them
(``_flash_fwd_pallas`` / ``_flash_bwd_pallas``, block 128): o and lse
within 2e-5, causal and not, and with 128 queries against 256 keys;
dQ/dK/dV within 2e-4 on the same o and lse. ``flash_attention``'s
autograd (GQA repeated at the API) is held against ``jax.grad`` of the
JAX ``flash_attention`` within 2e-4. The kernels themselves run on the
card only (tests/test_torch_kernels_gpu.py); the bf16 tensor-core
route's rounding (P and dS to bf16 before the second products of K4,
K5a and K5b) is rehearsed here in f32 arithmetic against the bf16
bar."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from skypilot_tpu_torch.models import llama as tllama
from skypilot_tpu_torch.ops import flash_attention as tfa

jfa = importlib.import_module('skypilot_tpu.ops.flash_attention')

torch.set_num_threads(2)

ATOL_FWD = 2e-5
ATOL_BWD = 2e-4
LOG2E = 1.4426950408889634


def _qkv(b, sq, sk, h, hkv, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, d)).astype(np.float32),
            rng.standard_normal((b, sk, hkv, d)).astype(np.float32))


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """The parity tests below hold f32 sums to 2e-5. With two intra-op
    threads, the same ``_plain_fwd`` call on the same inputs in one
    process was seen to change its log-sum-exp by up to 4.5e-5 partway
    through a run (after a JAX interpret-mode call): the threaded f32
    reduction is not stable from call to call. One thread is. Set here,
    not at import: every test file sets the count when it is collected,
    and the last one collected would win."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _bhsd(x):
    """[B, S, H, D] numpy -> the TPU kernels' [B, H, S, D] jax array."""
    return jnp.asarray(x.transpose(0, 2, 1, 3))


def _bshd(x):
    """A [B, H, S, D] jax array -> [B, S, H, D] numpy (a copy)."""
    return np.array(x).transpose(0, 2, 1, 3)


@pytest.mark.parametrize('sq,sk,causal', [(256, 256, True),
                                          (256, 256, False),
                                          (128, 256, True)],
                         ids=['causal', 'full', 'sq128-sk256'])
def test_plain_fwd_matches_pallas_kernel(sq, sk, causal):
    q, k, v = _qkv(1, sq, sk, 2, 2, 32, seed=sq + sk)
    scale = 32**-0.5
    o, lse = jfa._flash_fwd_pallas(_bhsd(q), _bhsd(k), _bhsd(v),
                                   causal=causal, scale=scale, block_q=128,
                                   block_k=128, interpret=True)
    got_o, got_lse = tfa._plain_fwd(*map(torch.from_numpy, (q, k, v)),
                                    causal=causal, scale=scale)
    np.testing.assert_allclose(got_o.numpy(), _bshd(o), atol=ATOL_FWD,
                               rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(lse[..., 0]),
                               atol=ATOL_FWD, rtol=0)


def test_plain_fwd_is_bitwise_stable_across_repeats():
    """After one JAX interpret-mode call, as the parity test makes, 30
    calls of ``_plain_fwd`` on identical inputs give the same bits."""
    q, k, v = _qkv(1, 256, 256, 2, 2, 32, seed=512)
    scale = 32**-0.5
    jfa._flash_fwd_pallas(_bhsd(q), _bhsd(k), _bhsd(v), causal=True,
                          scale=scale, block_q=128, block_k=128,
                          interpret=True)
    args = [torch.from_numpy(x) for x in (q, k, v)]
    first_o, first_lse = tfa._plain_fwd(*args, causal=True, scale=scale)
    for i in range(29):
        o, lse = tfa._plain_fwd(*args, causal=True, scale=scale)
        assert torch.equal(o, first_o) and torch.equal(lse, first_lse), i


@pytest.mark.parametrize('causal', [True, False])
def test_plain_bwd_matches_pallas_kernels(causal):
    q, k, v = _qkv(1, 256, 256, 2, 2, 32, seed=3)
    do = np.random.default_rng(9).standard_normal(q.shape).astype(
        np.float32)
    scale = 32**-0.5
    kw = dict(causal=causal, scale=scale, block_q=128, block_k=128,
              interpret=True)
    o, lse = jfa._flash_fwd_pallas(_bhsd(q), _bhsd(k), _bhsd(v), **kw)
    dq, dk, dv = jfa._flash_bwd_pallas(_bhsd(q), _bhsd(k), _bhsd(v), o, lse,
                                       _bhsd(do), **kw)
    got = tfa._plain_bwd(*map(torch.from_numpy, (q, k, v, _bshd(o))),
                         torch.from_numpy(np.array(lse[..., 0])),
                         torch.from_numpy(do), causal=causal, scale=scale)
    for g, want in zip(got, (dq, dk, dv)):
        np.testing.assert_allclose(g.numpy(), _bshd(want), atol=ATOL_BWD,
                                   rtol=0)


def test_flash_attention_grads_gqa_match_jax():
    q, k, v = _qkv(2, 64, 64, 4, 2, 32, seed=5)

    def jloss(q, k, v):
        return (jfa.flash_attention(q, k, v) ** 2).sum()

    want = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    xs = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    o = tfa.flash_attention(*xs)
    got = torch.autograd.grad((o**2).sum(), xs)
    np.testing.assert_allclose(
        o.detach().numpy(),
        np.asarray(jfa.flash_attention(*map(jnp.asarray, (q, k, v)))),
        atol=ATOL_FWD, rtol=0)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL_BWD,
                                   rtol=0)


def test_causal_rows_that_see_no_key():
    """Causal Sq > Sk: the plain version follows the reference's
    ``_xla_fwd``, and ``flash_attention`` refuses the case rather than
    pick one of the reference's two answers (the TPU kernel writes
    zeros there). In ``_xla_fwd`` every score of such a row is -1e30,
    and in f32 the log-sum-exp -1e30 + log(Sk) rounds back to -1e30, so
    each key gets probability 1 and the row is the sum of V."""
    q, k, v = _qkv(1, 8, 4, 2, 2, 32, seed=7)
    want_o, want_lse = jfa._xla_fwd(_bhsd(q), _bhsd(k), _bhsd(v),
                                    causal=True, scale=0.5)
    got_o, got_lse = tfa._plain_fwd(*map(torch.from_numpy, (q, k, v)),
                                    causal=True, scale=0.5)
    np.testing.assert_allclose(got_o.numpy(), _bshd(want_o), atol=ATOL_FWD,
                               rtol=0)
    np.testing.assert_allclose(got_o[0, :4].numpy(),
                               np.broadcast_to(v[0].sum(0), (4, 2, 32)),
                               atol=ATOL_FWD, rtol=0)
    np.testing.assert_allclose(got_lse.numpy(), np.asarray(want_lse[..., 0]),
                               rtol=1e-6)
    with pytest.raises(ValueError, match='Sq <= Sk'):
        tfa.flash_attention(*map(torch.from_numpy, (q, k, v)))


def test_attention_dispatch():
    """'auto'/'flash' and 'xla' agree on the CPU (the flash plain
    versions against plain attention through autograd); 'ring' needs
    the multi-GPU layer and raises."""
    q, k, v = map(torch.from_numpy, _qkv(1, 32, 32, 4, 2, 32, seed=11))
    outs = {impl: tllama._attention(
        q, k, v, tllama.LlamaConfig.tiny(attn_impl=impl))
        for impl in ('auto', 'flash', 'xla')}
    for impl in ('flash', 'xla'):
        np.testing.assert_allclose(outs[impl].numpy(), outs['auto'].numpy(),
                                   atol=ATOL_FWD, rtol=0)
    with pytest.raises(NotImplementedError, match='multi-GPU'):
        tllama._attention(q, k, v, tllama.LlamaConfig.tiny(attn_impl='ring'))


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _tensor_core_route(q, k, v, do, causal, scale, block=128,
                       dq_block=64):
    """The bf16 K4, K5a and K5b (csrc/flash_fwd.cu, flash_bwd.cu) in f32
    arithmetic on bf16 inputs: K4's online softmax over 128-key tiles in
    log2 units, P rounded to bf16 before P V while l sums the f32 P;
    K5a's dS / scale rounded to bf16 before dQ += dS K over 64-key
    tiles; K5b's P and dS / scale rounded to bf16 before dV and dK; delta
    from K4's (bf16) o. Returns (o, lse, dq, dk, dv) as the kernels
    do."""
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    sq, sk = q.shape[1], k.shape[1]
    s = torch.einsum('bqhd,bkhd->bhqk', qf, kf)
    allowed = torch.ones((sq, sk), dtype=torch.bool)
    if causal:
        allowed = (torch.arange(sq)[:, None] + sk - sq >=
                   torch.arange(sk)[None, :])
    s2 = torch.where(allowed, s * (scale * LOG2E), -torch.inf)
    m = torch.full(s.shape[:-1], -torch.inf)
    l = torch.zeros(s.shape[:-1])
    acc = torch.zeros(s.shape[:-1] + (q.shape[-1],))
    for k0 in range(0, sk, block):
        t = s2[..., k0:k0 + block]
        m_new = torch.maximum(m, t.amax(-1))
        m_use = torch.where(m_new == -torch.inf, 0.0, m_new)
        corr = torch.exp2(m - m_use)
        p = torch.exp2(t - m_use[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum(
            'bhqk,bkhd->bhqd', _bf16(p), vf[:, k0:k0 + block])
        m = m_new
    o = (acc / l[..., None]).transpose(1, 2).to(q.dtype)
    lse = m * np.log(2.0) + torch.log(l)
    p = torch.where(allowed, torch.exp(s * scale - lse[..., None]), 0.0)
    dp = torch.einsum('bqhd,bkhd->bhqk', dof, vf)
    delta = (dof * o.float()).sum(-1).transpose(1, 2)
    ds = p * (dp - delta[..., None])
    dq = torch.zeros(qf.shape)
    for k0 in range(0, sk, dq_block):
        dq += torch.einsum('bhqk,bkhd->bqhd', _bf16(ds[..., k0:k0 + dq_block]),
                           kf[:, k0:k0 + dq_block])
    dv = torch.einsum('bhqk,bqhd->bkhd', _bf16(p), dof)
    dk = torch.einsum('bhqk,bqhd->bkhd', _bf16(ds), qf) * scale
    return (o, lse, (dq * scale).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


@pytest.mark.parametrize('b,sq,sk,h,d,causal', [
    (2, 200, 200, 2, 64, True),
    (1, 256, 256, 2, 128, False),
    (1, 128, 256, 2, 128, True),
    (1, 2048, 2048, 1, 128, True),
], ids=['ragged-d64', 'full', 'sq128-sk256', 's2048'])
def test_tensor_core_rounding_within_the_bf16_bar(b, sq, sk, h, d, causal):
    """The bf16 route's extra rounding stays within the bar its kernels
    are held to on the card, 1e-2 + 2^-7 |plain| element-wise against
    ``_plain_fwd``/``_plain_bwd`` (lse within 1e-4), on bf16 inputs
    made from a seed; the backward's plain version runs on the route's
    own o and lse, as chip_smoke.py's phase 7 does."""
    q, k, v = _qkv(b, sq, sk, h, h, d, seed=sq + d)
    do = np.random.default_rng(sk).standard_normal(q.shape).astype(
        np.float32)
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16)
                   for x in (q, k, v, do))
    scale = d**-0.5
    o, lse, dq, dk, dv = _tensor_core_route(q, k, v, do, causal, scale)
    want_o, want_lse = tfa._plain_fwd(q, k, v, causal=causal, scale=scale)
    want_dq, want_dk, want_dv = tfa._plain_bwd(q, k, v, o, lse, do,
                                               causal=causal, scale=scale)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), atol=1e-4,
                               rtol=0)
    for got, want in ((o, want_o), (dq, want_dq), (dk, want_dk),
                      (dv, want_dv)):
        err = (got.float() - want.float()).abs()
        bar = 1e-2 + 2**-7 * want.float().abs()
        assert bool((err <= bar).all()), (err - bar).max().item()
