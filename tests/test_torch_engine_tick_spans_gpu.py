"""The engine's tick spans on an NVIDIA GPU (``gpu`` marker; every test
skips without one). The file imports only torch and the port:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_engine_tick_spans_gpu.py -q

One traced run of a bf16 engine at 7B widths (six layers, 16-step decode
chunks, so a tick lasts well over 5 ms) serves a dozen requests; then:

- ``engine.tick.device``'s ``device_ms`` of the commonest decode key is
  within 10% of the wall time of a synchronised replay of that key;
- the engine's TTFT ends (``_emit_first_token``'s stamp) no later than
  the token reaches ``on_token``, and within 5 ms of it: the stamp is
  taken after the wait on the tick's output event.
"""
import gc
import os
import statistics
import time

import numpy as np
import pytest
import torch

from skypilot_tpu_torch.models import llama
from skypilot_tpu_torch.models import serving_engine as se
from skypilot_tpu_torch.trace import export


@pytest.fixture(scope='module')
def traced(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the CUDA kernels have no CPU mode')
    cfg = llama.LlamaConfig(vocab_size=32000, dim=4096, n_layers=6,
                            n_heads=32, n_kv_heads=8, ffn_dim=14336,
                            max_seq=320, param_dtype=torch.bfloat16)
    params = llama.init_params(cfg, 0, device='cuda')
    eng = se.ServingEngine(params, cfg, batch_size=8, max_prompt=64,
                           max_seq=320, decode_chunk=16, prefill_chunk=64,
                           prefill_budget=128, device='cuda')
    eng.warmup()
    rng = np.random.default_rng(0)
    reqs = [se.Request(i, rng.integers(0, cfg.vocab_size,
                                       int(rng.integers(8, 64))).tolist(),
                       max_new=int(rng.integers(24, 120)))
            for i in range(12)]
    engine_first, host_first = {}, {}
    emit = eng._emit_first_token

    def first_token(state, tok, now):
        engine_first[state.request_id] = now
        return emit(state, tok, now)

    def on_token(rid, toks):
        host_first.setdefault(rid, time.time())

    eng._emit_first_token = first_token
    eng.on_token = on_token
    spool = str(tmp_path_factory.mktemp('spool'))
    os.environ['SKYTPU_TRACE_DIR'] = spool
    # No collector pause between the two stamps: where the engine takes
    # its stamp is what is measured, not the interpreter's collections.
    gc.collect()
    gc.disable()
    try:
        res = eng.run(reqs)
        torch.cuda.synchronize()
    finally:
        gc.enable()
        del os.environ['SKYTPU_TRACE_DIR']
    assert all(r.status == 'finished' for r in res.values())
    return eng, export.read_spans(spool), engine_first, host_first


@pytest.mark.gpu
def test_device_ms_is_a_synchronised_replay(traced):
    eng, spans, _, _ = traced
    by_id = {s['span_id']: s for s in spans}
    dispatch_of = {s['parent_id']: s for s in spans
                   if s['name'] == 'engine.tick.dispatch'}
    times = {}
    for s in spans:
        if s['name'] == 'engine.tick.device' and \
                s['attrs']['kind'] == 'decode':
            key = dispatch_of[by_id[s['parent_id']]['span_id']]['attrs'][
                'key']
            times.setdefault(key, []).append(s['attrs']['device_ms'])
    key_s = max(times, key=lambda k: len(times[k]))
    key = next(k for k in eng._graphs if repr(k) == key_s)
    device_ms = statistics.median(times[key_s])
    # Every row's count back at 0, as the run found them.
    eng.reset()
    walls = []
    for _ in range(eng.decode_capacity() // key[1]):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng._in_dev.copy_(eng._stage[0], non_blocking=True)
        eng._launch(key)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = statistics.median(walls[2:])
    assert device_ms > 5.0, (key_s, device_ms)
    assert abs(device_ms - wall_ms) <= 0.1 * wall_ms, (key_s, device_ms,
                                                       wall_ms)


@pytest.mark.gpu
def test_ttft_ends_when_the_token_is_on_the_host(traced):
    _, _, engine_first, host_first = traced
    assert set(engine_first) == set(host_first) and len(host_first) == 12
    for rid, stamp in engine_first.items():
        lag = host_first[rid] - stamp
        assert 0.0 <= lag <= 5e-3, (rid, lag)
