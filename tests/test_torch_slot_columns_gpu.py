"""Each slot's own decode columns, on an NVIDIA GPU (``gpu`` marker;
every test skips without one). The file imports only torch and the
port:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_slot_columns_gpu.py -q

A bf16 engine at Mistral-7B's widths (two layers: d 4096, 32/8 heads of
128, ffn 14336, vocab 32768, theta 1e6) serves nine requests of
unrelated answer lengths, one of them the whole decode capacity,
through four slots; then each request is served alone on the same
engine. Together, a request's rows sit at other cache columns, beside
other rows and under other page counts than alone; its greedy tokens
are the same all the same, since K1's and K2's bits follow a row's live
keys alone and every product sees the same batch width. The short
requests pass the long one (each slot owns its columns), and no count
passes the cache's decode columns.
"""
import numpy as np
import pytest
import torch

from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.models import serving_engine as se


@pytest.fixture(scope='module')
def engine():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the CUDA kernels have no CPU mode')
    cfg = llama.LlamaConfig(vocab_size=32768, dim=4096, n_layers=2,
                            n_heads=32, n_kv_heads=8, ffn_dim=14336,
                            max_seq=1024, rope_theta=1e6,
                            param_dtype=torch.bfloat16)
    params = llama.init_params(cfg, 0, device='cuda')
    eng = se.ServingEngine(params, cfg, batch_size=4, max_prompt=384,
                           max_seq=1024, decode_chunk=8, prefill_chunk=128,
                           prefill_budget=256, device='cuda')
    eng.warmup()
    return cfg, eng


@pytest.mark.gpu
def test_each_request_gets_its_tokens_served_alone(engine):
    cfg, eng = engine
    rng = np.random.default_rng(3)
    cap = eng.decode_capacity()
    lengths = [(300, cap), (40, 24), (200, 90), (384, 16), (70, 200),
               (128, 33), (5, 64), (250, 140), (90, 8)]
    reqs = [se.Request(i, rng.integers(0, cfg.vocab_size, p).tolist(),
                       max_new=m) for i, (p, m) in enumerate(lengths)]
    captured = eng.graph_captures
    done = []
    together = eng.run(reqs, on_result=lambda r: done.append(r.request_id))
    torch.cuda.synchronize()
    assert all(r.status == 'finished' for r in together.values())
    assert done[-1] == 0, done
    assert 0 < int(eng.cache['steps'].max()) <= cap
    for r in reqs:
        eng.reset()
        alone = eng.run([se.Request(r.request_id, list(r.tokens),
                                    max_new=r.max_new)])
        assert alone[r.request_id].tokens == together[r.request_id].tokens, (
            r.request_id)
    assert eng.graph_captures == captured
