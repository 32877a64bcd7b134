"""The engine's captured tick programs on an NVIDIA GPU (``gpu`` marker;
every test skips without one). The file imports only torch and the
port, so it also runs where JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_tick_graphs_gpu.py -q

- Graphed and eager engines (``_graphs = None`` before ``warmup()``)
  give equal greedy tokens in f32: speculation off and on (oracle-free
  prompt lookup and garbage drafts), an int8 KV cache, and 16 decode
  columns a slot, which rows run past and recycle on the card (the
  graphs stay valid throughout); warmup
  captures exactly the enumerated keys and a ragged run captures
  nothing more.
- One captured K3 launch, replayed at two segment starts written into
  its device scalar, matches the plain version at both (f32 within
  1e-4; bf16 and int8 within 1e-2 + 2^-7 |plain|).
- Launches count per replay: a capture adds none, each replay adds the
  capture's count.
"""
import numpy as np
import pytest
import torch

from skypilot_tpu_torch.ops import _build
from skypilot_tpu_torch.ops import decode_attention as tda
from skypilot_tpu_torch.ops import flash_attention as tfa
from skypilot_tpu_torch.ops import split_kv


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the CUDA kernels have no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _assert_within_bar(got, want, f32=False):
    err = (got.float() - want.float()).abs()
    bar = 1e-4 if f32 else 1e-2 + 2**-7 * want.float().abs()
    assert bool((err <= bar).all()), err.max().item()


def _model(dev):
    from skypilot_tpu_torch.models import llama
    cfg = llama.LlamaConfig.tiny(dim=128, n_heads=8, n_kv_heads=2)
    return cfg, llama.init_params(cfg, 0, device=dev)


def _requests(cfg, n, seed):
    from skypilot_tpu_torch.models import serving_engine as se
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n):
        part = rng.integers(0, cfg.vocab_size, 5).tolist()
        plen = 3 + (7 * i) % 27
        prompt = (part * 8)[:plen] if i % 2 else \
            rng.integers(0, cfg.vocab_size, plen).tolist()
        reqs.append(se.Request(i, prompt, max_new=4 + i % 9))
    return reqs


def _serve(cfg, params, dev, graphs, lookup=None, **kw):
    from skypilot_tpu_torch.models import serving_engine as se
    eng = se.ServingEngine(params, cfg, **{
        **dict(batch_size=3, max_prompt=32, max_seq=96, decode_chunk=4,
               prefill_chunk=8, prefill_budget=16, page=8, device=dev),
        **kw})
    if not graphs:
        eng._graphs = None
    eng.warmup()
    if lookup is not None:
        eng._lookup = lookup
    captured = eng.graph_captures
    res = eng.run(_requests(cfg, 9, seed=1))
    torch.cuda.synchronize()
    assert all(r.status == 'finished' for r in res.values())
    assert eng.graph_captures == captured
    return eng, {i: res[i].tokens for i in res}


@pytest.mark.gpu
@pytest.mark.parametrize('mode', ['plain', 'spec', 'spec-garbage', 'int8',
                                  'capacity'])
def test_graphed_engine_equals_eager(cuda, mode):
    cfg, params = _model(cuda)
    kw, lookup = {}, None
    if mode.startswith('spec'):
        kw = dict(spec_decode=True, spec_k=3)
        if mode == 'spec-garbage':
            lookup = (lambda chain, k:
                      [(int(chain[-1]) + 7) % cfg.vocab_size] * k)
    elif mode == 'int8':
        kw = dict(kv_quant=True)
    elif mode == 'capacity':
        kw = dict(max_seq=48)   # 16 decode columns a slot: rows past them
    eager, want = _serve(cfg, params, cuda, False, lookup, **kw)
    assert eager.graph_captures == 0
    _build.reset_launches()
    eng, got = _serve(cfg, params, cuda, True, lookup, **kw)
    assert got == want
    assert eng.graph_captures == len(eng._tick_keys()) == len(eng._graphs)
    assert _build.LAUNCHES['paged_decode'] > 0
    if mode.startswith('spec'):
        assert eng.spec_ticks > 0 and _build.LAUNCHES['verify_attention'] > 0
    if mode == 'capacity':
        assert eng.decode_steps_total > eng.decode_capacity()


def _verify_case(dev, dtype, seed):
    """B 3, V 4, 8/2 heads, D 64, S 256, n_cols 192: dmask true on the
    first 60 columns (a hole at 20-27), never at or past column 100."""
    b, vq, h, n_kv, d, s = 3, 4, 8, 2, 64, 256
    gen = torch.Generator(device=dev).manual_seed(seed)
    qdt = torch.float32 if dtype == 'f32' else torch.bfloat16
    q = torch.randn((b, vq, h, d), generator=gen, device=dev).to(qdt)
    valid = torch.zeros((b, s), dtype=torch.bool, device=dev)
    valid[:, :60] = True
    valid[:, 20:28] = False
    valid[1] = False
    ks = vs = None
    if dtype == 'int8':
        k = torch.randint(-127, 128, (b, s, n_kv, d), generator=gen,
                          device=dev, dtype=torch.int8)
        v = torch.randint(-127, 128, (b, s, n_kv, d), generator=gen,
                          device=dev, dtype=torch.int8)
        ks = (torch.rand((b, s, n_kv), generator=gen, device=dev) * 0.007 +
              0.001).to(torch.bfloat16)
        vs = (torch.rand((b, s, n_kv), generator=gen, device=dev) * 0.007 +
              0.001).to(torch.bfloat16)
    else:
        k = torch.randn((b, s, n_kv, d), generator=gen, device=dev).to(qdt)
        v = torch.randn((b, s, n_kv, d), generator=gen, device=dev).to(qdt)
    return q, k, v, valid, ks, vs


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', ['f32', 'bf16', 'int8'])
def test_captured_verify_launch_follows_its_segment_start(cuda, dtype):
    q, k, v, valid, ks, vs = _verify_case(cuda, dtype, seed=3)
    seg = torch.full((), 100, dtype=torch.int32, device=cuda)
    # One launch before the capture loads the kernel (a first launch
    # inside a capture would load its module there, which a capture
    # refuses) and allocates the split counters; the engine's warmup
    # does the same.
    eager = tfa.verify_attention(q, k, v, valid, seg, ks, vs, n_cols=192)
    _build.reset_launches()
    graph = _build.capture(lambda: tfa.verify_attention(
        q, k, v, valid, seg, ks, vs, n_cols=192))
    assert sum(_build.LAUNCHES.values()) == 0
    cut = (lambda t: None if t is None else t[:, :192])
    for start in (100, 150, 188):
        seg.fill_(start)
        got = graph.replay()
        if start == 100:               # the merge order is fixed
            torch.cuda.synchronize()
            assert torch.equal(got, eager)
        want = tfa.verify_attention_reference(
            q, k[:, :192], v[:, :192], valid[:, :192], start, cut(ks),
            cut(vs))
        torch.cuda.synchronize()
        assert torch.isfinite(got.float()).all()
        _assert_within_bar(got, want, f32=dtype == 'f32')
    assert _build.LAUNCHES[tfa.VERIFY_KERNEL] == 3
    assert _build.LAUNCHES[tfa.VERIFY_KERNEL + '.int8'] == 3 * (
        dtype == 'int8')


@pytest.mark.gpu
def test_launches_count_per_replay(cuda):
    b, s, n_kv, rep, hd, page = 4, 256, 2, 4, 64, 64
    gen = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn((b, n_kv * rep, hd), generator=gen,
                    device=cuda).to(torch.bfloat16)
    kc = torch.randn((b, s, n_kv, hd), generator=gen,
                     device=cuda).to(torch.bfloat16)
    valid = torch.ones((b, s), dtype=torch.bool, device=cuda)
    bound = torch.full((b,), s, dtype=torch.int32, device=cuda)
    _build.reset_launches()
    want = tda.paged_gqa_decode_attention(q, kc, kc, valid, bound, page=page)
    assert _build.LAUNCHES['paged_decode'] == 1
    split_kv.reserve(cuda)
    _build.reset_launches()
    graph = _build.capture(lambda: tda.paged_gqa_decode_attention(
        q, kc, kc, valid, bound, page=page))
    assert sum(_build.LAUNCHES.values()) == 0
    assert graph.launches == {'paged_decode': 1}
    for i in range(3):
        got = graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        assert _build.LAUNCHES['paged_decode'] == i + 1


@pytest.mark.gpu
def test_an_uncaptured_key_raises(cuda):
    from skypilot_tpu_torch.models import serving_engine as se
    cfg, params = _model(cuda)
    eng = se.ServingEngine(params, cfg, batch_size=2, max_prompt=16,
                           max_seq=48, decode_chunk=4, prefill_chunk=8,
                           prefill_budget=16, page=8, device=cuda)
    with pytest.raises(RuntimeError, match='not captured'):
        eng.run([se.Request(0, [1, 2, 3], max_new=2)])
