"""Q1, the int8-weight product (``ops/int8_matmul.py``,
``ops/csrc/int8_matmul.cu``), and int8 weights through the engine, on an
NVIDIA GPU (``gpu`` marker; every test skips without one). The file
imports only torch and the port, so it also runs where JAX is not
installed:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_int8_gpu.py -q

- Q1 against its plain version at M 1, 8, 40, 256 and 300, at the
  edges of the planned tiles (M 16, 17, 64, 65, 128, 129, 257 and 512;
  K 72; N 1000, which takes the mma.sync route), on every route: f32 x
  (CUDA cores): |kernel - plain| <= 1e-4; bf16 x (the planned tensor-core
  route, and both tensor-core routes forced at M <= 16): the product,
  read as f32 (``out_dtype=float32``), within 1e-2 + 2^-7 |plain|; the
  bf16 output equal, bit for bit, to the reference's rounding of the
  kernel's own f32 sum (the sum rounded to bf16, times the scale rounded
  to bf16, rounded again). The bf16 output is not held element-wise to
  the plain version's: two sums in different orders round to
  neighbouring bf16 values now and then, and the second rounding can
  widen that to two steps (seen on the card at 2 of 1,048,576 outputs),
  past the one-step bar.
- Determinism: at split and unsplit shapes on both tensor-core routes,
  two launches and a captured CUDA graph replayed twice give the bits
  of one eager launch (split-K sums in split order, no float atomics).
- Q1 raises, before any launch, on a non-contiguous or wrong-dtype
  operand, and counts each launch under ``int8_matmul`` and its route.
- One Q1 call at the lm_head's shape stays below one bf16 copy of the
  weight in peak memory (no dequantized copy is ever written).
- A depth-2 f32 engine on int8 weights (``weight_quant=True``) gives the
  re-prefill oracle's greedy tokens.
"""
import numpy as np
import pytest
import torch

from skypilot_tpu_torch.ops import _build, split_kv
from skypilot_tpu_torch.ops import int8_matmul as tim


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the CUDA kernels have no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _inputs(dev, m, k, n, dtype, seed):
    """x ~ N(0, 1); q uniform int8; scales around the born-int8 init's
    fan_in**-0.5 / 73.6, so outputs are O(1) as in the model."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
    q = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                      dtype=torch.int8)
    s = (0.5 + torch.rand((n,), generator=gen, device=dev)) * (
        k**-0.5 / 73.6116)
    return x, q, s


def check_q1(x, q, s, route=None):
    """Q1 against its plain version (see the module docstring), on the
    bf16 route ``route`` forces (None: the planned one); returns the
    launches the checked calls counted."""
    _build.reset_launches()
    if x.dtype == torch.float32:
        got = tim.int8_matmul(x, q, s)
        want = tim.int8_matmul_reference(x, q, s)
        torch.cuda.synchronize()
        assert got.dtype == torch.float32
        err = (got - want).abs()
        assert bool((err <= 1e-4).all()), err.max().item()
        return dict(_build.LAUNCHES)

    def q1(scale, out_dtype=None):
        if route is None:
            return tim.int8_matmul(x, q, scale, out_dtype)
        return tim._int8_matmul_cuda(x, q, scale, out_dtype, route)

    got = q1(s)
    got_f32 = q1(s, torch.float32)
    raw = q1(torch.ones_like(s), torch.float32)
    want = tim.int8_matmul_reference(x, q, s, torch.float32)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got_f32.dtype == torch.float32
    err = (got_f32 - want).abs()
    assert bool((err <= 1e-2 + 2**-7 * want.abs()).all()), err.max().item()
    rounded = raw.to(torch.bfloat16) * s.to(torch.bfloat16)
    assert torch.equal(got.view(torch.int16), rounded.view(torch.int16))
    return dict(_build.LAUNCHES)


def planned_route(x, q):
    m, k = x.shape
    return tim.plan(m, k, q.shape[1], split_kv.sm_count(x.device),
                    tim.takes_tensor_map(q)).route


SHAPES = ((1, 4096, 4096), (8, 4096, 1024), (8, 14336, 4096),
          (40, 4096, 14336), (256, 4096, 4096), (256, 14336, 4096),
          (300, 4096, 1000), (17, 64, 48), (3, 72, 40),
          (16, 4096, 4096), (17, 4096, 1024), (64, 4096, 4096),
          (65, 4096, 1024), (128, 2048, 8192), (129, 4096, 4096),
          (257, 4096, 1024), (512, 4096, 4096), (40, 72, 256),
          (128, 4096, 1000))


@pytest.mark.gpu
@pytest.mark.parametrize('route', ['f32', 'bf16'])
@pytest.mark.parametrize('shape', SHAPES, ids=lambda s: 'x'.join(map(str, s)))
def test_q1_matches_its_plain_version(cuda, route, shape):
    dtype = torch.float32 if route == 'f32' else torch.bfloat16
    x, q, s = _inputs(cuda, *shape, dtype, seed=sum(shape))
    launches = check_q1(x, q, s)
    if route == 'f32':
        assert launches == {'int8_matmul': 1, 'int8_matmul.f32': 1}
    else:
        bf16_route = planned_route(x, q)
        assert launches == {'int8_matmul': 3, f'int8_matmul.{bf16_route}': 3}


@pytest.mark.gpu
@pytest.mark.parametrize('route', ['wgmma', 'mma'])
@pytest.mark.parametrize('shape', ((1, 4096, 4096), (8, 4096, 1024),
                                   (16, 14336, 4096), (8, 4096, 128256)),
                         ids=lambda s: 'x'.join(map(str, s)))
def test_q1_both_tensor_core_routes_at_small_m(cuda, route, shape):
    x, q, s = _inputs(cuda, *shape, torch.bfloat16, seed=sum(shape))
    assert check_q1(x, q, s, route) == {'int8_matmul': 3,
                                        f'int8_matmul.{route}': 3}


@pytest.mark.gpu
@pytest.mark.parametrize('route', ['wgmma', 'mma'])
@pytest.mark.parametrize('shape', ((8, 4096, 1024), (40, 4096, 4096),
                                   (256, 4096, 4096), (256, 4096, 14336)),
                         ids=lambda s: 'x'.join(map(str, s)))
def test_q1_launches_and_graph_replays_are_bitwise_equal(cuda, route,
                                                         shape):
    m, k, n = shape
    x, q, s = _inputs(cuda, m, k, n, torch.bfloat16, seed=7)
    launch = tim.plan(m, k, n, split_kv.sm_count(cuda), True, route)

    def q1():
        return (tim._int8_matmul_cuda(x, q, s, None, route),
                tim._int8_matmul_cuda(x, q, s, torch.float32, route))

    eager = q1()                      # also reserves the split counters
    again = q1()
    graph = _build.capture(q1)
    replays = []
    for _ in range(2):
        out = graph.replay()
        torch.cuda.synchronize()
        replays.append(tuple(o.clone() for o in out))
    for got in [again] + replays:
        for a, b in zip(got, eager):
            assert torch.equal(a.view(torch.int16) if a.dtype ==
                               torch.bfloat16 else a.view(torch.int32),
                               b.view(torch.int16) if b.dtype ==
                               torch.bfloat16 else b.view(torch.int32))
    # Split and unsplit: the mma.sync route's row block of 64 gives M 256
    # enough tiles to fill the SMs at N 4096 too.
    assert (launch.splits > 1) == (n != 14336 and not (
        route == 'mma' and m == 256))


@pytest.mark.gpu
def test_q1_lm_head_preferred_f32(cuda):
    x, q, s = _inputs(cuda, 8, 4096, 128256, torch.bfloat16, seed=3)
    got = tim.int8_matmul(x, q, s, torch.float32)
    want = tim.int8_matmul_reference(x, q, s, torch.float32)
    err = (got - want).abs()
    assert bool((err <= 1e-2 + 2**-7 * want.abs()).all()), err.max().item()


@pytest.mark.gpu
def test_q1_refuses_operands_it_does_not_take(cuda):
    x, q, s = _inputs(cuda, 8, 256, 128, torch.bfloat16, seed=4)
    _build.reset_launches()
    with pytest.raises(ValueError, match='contiguous'):
        tim.int8_matmul(x, q.t().contiguous().t(), s)
    with pytest.raises(ValueError, match='contiguous'):
        tim.int8_matmul(x[:, ::2], q[::2], s)
    with pytest.raises(TypeError, match='q must be int8'):
        tim.int8_matmul(x, q.to(torch.int16), s)
    with pytest.raises(TypeError, match='s must be float32'):
        tim.int8_matmul(x, q, s.to(torch.bfloat16))
    with pytest.raises(TypeError, match='x must be'):
        tim.int8_matmul(x.half(), q, s)
    with pytest.raises(ValueError, match='shapes'):
        tim.int8_matmul(x, q[:128], s)
    with pytest.raises(ValueError, match='multiple of 8'):
        tim.int8_matmul(x[:, :252].contiguous(), q[:252].contiguous(), s)
    assert not _build.LAUNCHES


@pytest.mark.gpu
def test_q1_never_writes_a_dequantized_weight(cuda):
    x, q, s = _inputs(cuda, 8, 4096, 128256, torch.bfloat16, seed=5)
    tim.int8_matmul(x, q, s)                   # built and loaded
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tim.int8_matmul(x, q, s, torch.float32)
    torch.cuda.synchronize()
    transient = torch.cuda.max_memory_allocated() - before
    assert transient < q.numel() * 2, transient
    assert transient <= 8 * 128256 * 4 + 2**20       # the output, about


def _reprefill(params, cfg, prompt, max_new, dev):
    from skypilot_tpu_torch.models import inference
    seq, out = list(prompt), []
    for _ in range(max_new):
        toks = torch.tensor([seq + [0]], dtype=torch.int32, device=dev)
        logits, _ = inference.prefill(params, toks, [len(seq)], cfg,
                                      max_seq=len(seq) + 1)
        nxt = int(torch.argmax(logits, -1)[0])
        out.append(nxt)
        seq.append(nxt)
    return out


@pytest.mark.gpu
def test_f32_engine_on_int8_weights_equals_the_reprefill_oracle(cuda):
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.models import quantization as tq
    from skypilot_tpu_torch.models import serving_engine as se
    cfg = llama.LlamaConfig.tiny(dim=128, n_heads=8, n_kv_heads=2)
    params = llama.init_params(cfg, 0, device=cuda)
    eng = se.ServingEngine(params, cfg, batch_size=3, max_prompt=32,
                           max_seq=96, decode_chunk=4, prefill_chunk=8,
                           prefill_budget=16, page=8, weight_quant=True,
                           device=cuda)
    eng.warmup()
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (5, 13, 27, 9)]
    _build.reset_launches()
    res = eng.run([se.Request(i, p, max_new=8)
                   for i, p in enumerate(prompts)])
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    assert launches.get('int8_matmul', 0) > 0
    assert launches['int8_matmul'] == launches.get('int8_matmul.f32', 0)
    qp = eng.params
    assert tq.is_quantized(qp) and not tq.is_quantized(params)
    for i, p in enumerate(prompts):
        assert res[i].tokens == _reprefill(qp, cfg, p, 8, cuda), i
