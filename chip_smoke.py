#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``skypilot_tpu_torch``) on one
NVIDIA GPU: the quickest proof that the port builds, is right, serves
and trains on the card.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It needs one CUDA card and ``nvcc`` (``$CUDA_HOME`` or /usr/local/cuda);
the port builds its kernels from ``skypilot_tpu_torch/ops/csrc`` on
first use. It imports nothing of JAX. TF32 is switched off for matmuls
and cuDNN, so every f32 product runs in full f32.

Phases (any failure exits 1 and prints no result line):

1. The card's name and power limit (nvidia-smi); build every kernel
   (one nvcc per source, all started together) and count each kernel
   function's tensor-core instructions in its SASS (``cuobjdump -sass``
   split at its ``Function :`` headers; HGMMA is wgmma, HMMA mma.sync),
   one line per function; every instantiation of the bf16 kernels of
   K1, K2, K3, K4, K5a and K5b and of Q1's wgmma route must hold HGMMA,
   Q1's mma.sync route (shapes a tensor map cannot take) HMMA.
2. K1, paged GQA decode, against its plain PyTorch version at
   Llama-3.1-8B decode shapes (B 8, S 1024, 8 kv heads, 4 query heads
   each, head_dim 128, page 128): ragged row bounds, dmask holes, an
   empty row, num_pages below the cache's pages, NaN wherever nothing
   may be read; f32 (the CUDA-core route), bf16 and int8 caches (the
   split-KV tensor-core route), each launch counting its route; then
   the published max_seq 8192 (rows live up to about 8,000 columns),
   bf16.
3. K2, chunked-prefill attention, against its plain version: first
   the bf16 q route (tensor cores) on bf16 and int8 caches at its edges
   (head_dim 16, 64 and 128; C 40 and 200; GQA 1, 4 and 8; rows at
   offsets 0, 63, 64 and S - C), then G 2, C 128, S 640, 32/8 heads,
   head_dim 128, offsets 0 and 384 in f32 (the CUDA-core route), int8
   and bf16; NaN past each row's frontier everywhere, and each launch
   must count its route (``chunk_prefill.f32`` for a f32 q only).
   Bars, element-wise: |kernel - plain| <= 1e-4 in f32; in bf16 and
   int8, <= 1e-2 + 2^-7 |plain| — the TPU kernel's 1e-2 (PERFORMANCE.md,
   paged decode) plus one bf16 step of the value itself, since a kernel
   rounds at other places than its plain version (the plain version
   rounds the normalized probabilities to bf16 before P @ V, as the JAX
   reference does; the bf16 K2 rounds the unnormalized ones), so
   outputs above 1 may differ by a step (2^-6 = 0.0156 at magnitude
   2-4).
3b. K3, spec-decode verify attention, against its plain version at
   Llama-3.1-8B serving shapes with spec_k 4 (B 8, V 5, 32/8 heads,
   head_dim 128, S 1024, the segment at column 700, n_cols 768): an
   inactive row, a recycled row, rejected-candidate holes, NaN in every
   column no query may attend; f32, bf16 and int8 under the same bars,
   each launch counting its route; segments wider than one 64-row tile
   (4 x 17 = 68 and 8 x 17 = 136 query rows per kv head) in f32 and
   bf16; the published max_seq 8192 (segment at column 8000), bf16. The
   segment start is a device int32, as the engine's write frontier is.
4. Times on the card: each kernel, its plain version, one PyTorch
   call computing the same function (scaled_dot_product_attention
   with an explicit mask; the port never calls it) and the least time
   the card could take (bytes over 3.35 TB/s or operations over the
   peak rate of the input type).
5. The main path at full width: ``LlamaConfig.llama3_8b(max_seq=1024)``
   in bf16 (all 32 layers, random weights from ``--seed``) behind
   ``ServingEngine(batch_size=8, max_prompt=512, prefill_chunk=128,
   prefill_budget=256, decode_chunk=8)``, serving 12 greedy requests
   (prompts of 100-512 tokens, 32 new tokens each). Every serving run
   of phases 5, 6 and 6b runs on captured tick programs (one CUDA graph
   per key, captured in ``warmup()``): the capture count must equal the
   enumerated key count, and no run may capture more. Every request
   must finish with 32 tokens, and the launch counts (counted per
   replay) must equal decode steps x 32 (K1) and prefill ticks x 32
   (K2, all on the bf16 route: no ``chunk_prefill.f32``). The graphed
   run's TTFT, ITL and per-token latency come from the port's own
   histograms (count, exact mean, bucket-interpolated p50/p99), its
   device idle share and host ms per tick from a profiled repeat; then
   the same requests run once more on the same engine with
   ``SKYTPU_TRACE_DIR`` set (a temporary spool): the same tokens, and
   its tokens/s, idle share and host ms per tick beside the untraced
   run's, with the spans it spooled. The same
   requests are then served with eager ticks in the same call (graphs
   off through the engine's private attribute) under the same gates,
   and the two output tokens/s are printed side by side. Then the spec
   path on the same weights (``phase_spec_path``): 12 requests on
   prompts that repeat a random segment, served spec off, spec on
   (``spec_k=4``) with the prompt-lookup proposer, and spec on with the
   spec-off tokens as drafts; each run's launches must equal its decode
   steps, prefill ticks and verify ticks x 32, K3's above 0 in both
   spec runs, and no K2 launch on the f32 route; the prompt-lookup run
   is served once more with eager ticks. Output tokens/s and
   ``spec_stats()`` of each run, each warmup's capture count, capture
   seconds and graph pool memory, peak memory.
5c. The prefix path on phase 5's weights and engine geometry with
   ``page=128`` and the prefix cache on (the default pool of 512 pages):
   24 greedy requests of 32 new tokens on ``bench.py``'s serve_prefix
   traffic scaled to max_prompt 512 (8 shared prefixes of 384 random
   tokens, Zipf 1.1 popularity, a fresh suffix of 1-127 tokens each),
   served concurrently on captured ticks with the cache on and then off
   in the same call. There must be hits, tokens saved must equal the
   per-request reuse summed (each 0 or 384), prefill ticks must be fewer
   with the cache on, and each run's launches must equal decode steps
   and prefill ticks x 32 on the bf16 route. Bit-identity: every
   request's cache-on tokens must equal its cache-off tokens (24/24),
   and so must a control's (the cache off again, arrival order
   reversed: another schedule, untimed), whose finishing slots also
   hand over each request's own prefill K/V of its prefix, which the
   pool's pages must equal bitwise (24/24). Prints output tokens/s,
   ticks, ``prefix.stats()``, captures, the pool's size, peak memory,
   and where tokens part if they do.
5d. Request lifecycle and multi-tenant QoS at the same width and
   geometry (``phase_lifecycle``), two legs (cache and speculation off;
   both on, repeated prompts, so K3 runs): an untagged FIFO control,
   then 24 requests over tenants a, b, c and untagged, 8 per class, in
   two bursts (batch, then chat onto the busy replica) with
   ``SKYTPU_QOS_MAX_QUEUE`` and ``SKYTPU_QOS_PREEMPT_AFTER_S`` set: two
   deadlines pass mid-decode, three in the queue, two requests are
   cancelled from a second thread, the newest queued bulk requests are
   shed, bulk slots preempted. Gates: one Result each, the statuses,
   no capture after warmup, pins 0, the counters in the parsed
   exposition equal to the Results, and (cache and speculation off)
   finished tokens equal to the control's, partials its prefixes.
6. Parity: the same width at depth 2 in f32; the engine's greedy
   tokens must equal the port's cache-free ``reference_generate``.
   A second pass with an int8 KV cache must finish every request
   through both kernels' int8 branches. The oracle's attention is
   ``forward_hidden``'s, which on the card runs K4: a kernel that
   shares no code with K1/K2/K3, held against its own plain version in
   phase 7. 6b: speculation on the same model and prompts — oracle,
   garbage and prompt-lookup drafts — must give the oracle's tokens and
   the spec-off engine's; an int8-KV spec pass must run K3's int8
   branch; spec_k 16 (4 x 17 = 68 query rows per kv head, wider than
   one 64-row tile) must give the same tokens. Every K1, K2 and K3
   launch of phases 6 and 6b (f32) counts under its ``.f32`` entry.
   6c: the prefix cache on the same model with page 8 and prefill chunk
   8: a publisher, a full hit, a miss and divergences at page - 1, page
   and page + 1, one at a time, each equal to ``reference_generate``
   with the reference's reuse (24/0/8/16/16); int8 KV with the cache on
   equal to int8 KV with it off; speculation with the cache on (prompt
   lookup, then oracle drafts through K3) equal to spec off; and the
   f32 routes of K1 and K3 over the cache-on engine's own cache give
   the same bits with each row's decode keys moved to other columns and
   other page or column counts dispatched (``p4_live_key_check``: their
   tiles follow the row's live keys, as the bf16 routes' do).
7. K4 (flash forward), K5a (flash dQ) and K5b (flash dK/dV) against
   their plain versions (the backward on the kernel's own o and lse),
   on both routes: f32 (CUDA-core kernels) at S 256 causal and not,
   Sq 128 < Sk 256 and a ragged S 200 (bar 1e-4); bf16 (K4, K5a and
   K5b on the tensor cores) at the same four shapes, a head_dim-64 case
   and the training shapes B 4 x S 2048 x H 16 x D 128 causal (the bf16
   bar above, for o and the gradients alike; lse, f32 either way, 1e-4;
   K5a's delta within 1e-4 of max |delta| of rowsum(dO * o)).
   Every launch must count its route (``.f32`` entries on f32 only).
   Times at the training shapes: each kernel, its plain version
   (``_plain_bwd`` computes dQ, dK and dV together), SDPA forward, SDPA
   backward alone (torch.autograd.grad on a graph kept from one
   forward) and SDPA forward + backward, and the bound (operations over
   the bf16 peak: 2, 3 and 4 products of 2 * head_dim operations per
   attended pair).
8. The training path at full width: ``LlamaConfig.tpu_1b(max_seq=2048,
   param_dtype=bfloat16, remat=True, loss_chunk=1024)``, all 16 layers,
   random weights from ``--seed``, through ``init_train_state`` and
   ``make_train_step(cfg, make_optimizer())`` (clip + AdamW) on one
   fixed batch of 4 x 2048 tokens: a warm-up step, then 4 timed steps.
   Loss and grad_norm must be finite (grad_norm > 0), the last loss
   below the first, ``state.step`` 5, and every step must launch K4
   32 times (remat reruns each layer's forward) and K5a/K5b 16 times,
   all on the bf16 route (no ``.f32`` launch).
   Prints step time, tokens/s, MFU (``bench.py``'s flops per token
   against the bf16 dense peak) and peak memory.
9. Training parity: tpu_1b width at depth 2 in f32, 3 steps, the
   kernels (attn_impl 'auto', every launch on the f32 route) against
   plain attention ('xla') from the same weights (bars in
   ``phase_train_parity``).
10. Monolithic ``inference.generate`` on phase 6's model and prompts:
   greedy tokens equal to ``reference_generate``'s and the engine's,
   K4 launched once per layer (the prefill, on the f32 route), K1 per
   decode step.
11. int8 weights (``--only 11`` runs it alone after phase 1): 11a Q1,
   the int8-weight product, against its plain version at every shape
   the 8B and tpu_1b paths below give it, on every route, with device
   times of a decoder layer's seven products at every M the main path
   gives Q1 (the 8B layer at M 8, 40, 128 and 256, tpu_1b's at 128)
   beside their bound, the library call and a dense bf16 matmul, and
   each leaf's plan (``phase_q1``); 11b ``qdot_a8``'s ``torch._int_mm`` product exact
   (``phase_int_mm``); 11c depth-2 f32 parity on int8 weights: engine,
   int8 KV, speculation, the prefix cache, ``prefill_a8`` and
   ``attn_impl`` (``phase_int8_parity``); 11d the main path on born-int8
   8B weights, beside phase 5's bf16 run (``phase_int8_main_path``);
   11e ``bench.py``'s decode_w8 shape, with the captured step's device
   time by kernel group (Q1, cuBLAS, K1, the other PyTorch kernels) and
   idle share from profiled replays, and 11f its serve_a8 shape
   (``phase_decode_w8``, ``phase_serve_a8``).
12. The replica's HTTP front end (run after 5d, on phase 5's weights;
   ``phase_http``): a fresh engine of phase 5's geometry behind the
   port's ``EngineServer`` on localhost serves phase 5's 12 requests,
   sent at once from standard-library clients, half SSE and half JSON:
   tokens equal to phase 5's (12/12), captures equal to the keys with
   none after warmup, K1/K2 launches decode steps and prefill ticks x
   32, /health ok, /metrics parsed; output tokens/s and TTFT beside
   phase 5's. A drain with a request in flight finishes it and ends
   clean. A prefill and a decode replica (prefix cache on, phase 5's
   weight tensors) hand four prompts over ``kv_prefill`` and
   /kv/fetch: the decode replica's tokens equal phase 5's bitwise.

``--tree DIR`` imports the port from another checkout (the parent
commit unpacked with ``git archive``), so one call can time two trees
with the same phases, in turns; such a run prints no result lines.

The graphed main path (untraced and traced) is always repeated under
torch.profiler for its idle share; ``--profile-dir DIR`` adds that pass
after the eager serving run, the organic spec runs (graphed and
eager), the prefix runs (cache on and off) and phase 8 (device idle
share, host ms per tick = (wall - device busy) / ticks, device time by
kernel group), and writes the tables in DIR.

The lines before the last print the card line and one JSON object
``{"kernels": [...]}`` (launches: K1/K2 from phase 5's run, K3 from the
organic spec run, K4/K5 from phase 8's timed steps, Q1 from 11d's run);
the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
"""
import argparse
import gc
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12           # H100 SXM data sheet
PEAK_OPS_PER_S = {'bfloat16': 989e12, 'float32': 67e12, 'int8': 1979e12}
L2_BYTES = 50 * 2**20


class Failed(Exception):
    pass


def log(*args):
    print(*args, flush=True)


def check(cond, msg):
    if not cond:
        raise Failed(msg)


def card_line():
    out = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, arg_sets, iters=30, warmup=3):
    """Mean ms per call over ``iters`` calls, CUDA events around the
    run; the calls cycle through ``arg_sets`` (copies of the inputs
    that together exceed the L2 cache, so each call finds its inputs
    cold, as a layer of the real model does)."""
    import torch
    for i in range(warmup):
        fn(*arg_sets[i % len(arg_sets)])
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(*arg_sets[i % len(arg_sets)])
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def copies_of(args, nbytes):
    """Enough copies of ``args`` to overflow the L2 cache three times."""
    import torch
    n = max(2, min(32, math.ceil(3 * L2_BYTES / max(nbytes, 1))))
    return [args] + [tuple(a.clone() if isinstance(a, torch.Tensor) else a
                           for a in args) for _ in range(n - 1)]


def bound(nbytes, ops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype_name]
    return (max(t_bytes, t_ops) * 1e3,
            'bytes' if t_bytes >= t_ops else 'operations')


def compare(got, want, bf16_bar=True):
    """(max abs error, within the bar) — see the module docstring."""
    err = (got.float() - want.float()).abs()
    if bf16_bar:
        ok = err <= 1e-2 + 2**-7 * want.float().abs()
    else:
        ok = err <= 1e-4
    return err.max().item(), bool(ok.all())


# ------------------------------------------------------------------ K1


def decode_inputs(torch, dev, kind, seed, long=False):
    """Phase-2 inputs: ragged bounds, holes, an empty row, NaN wherever
    the kernel may not read (past num_pages, past each row's bound, in
    masked slots). ``long``: the published max_seq 8192, every row live
    up to about 8,000 columns."""
    b, s, n_kv, rep, hd, page, num_pages = 8, 1024, 8, 4, 128, 128, 6
    bounds = [0, 1, 127, 128, 129, 515, 700, 768]
    holes = ((5, 200, 260), (7, 513, 530))  # a hole; the prompt/decode gap
    if long:
        s, num_pages = 8192, 64
        bounds = [8000, 7937, 7990, 7801, 8100, 7700, 7999, 8064]
        holes = ((1, 3000, 3050), (5, 4000, 4200))
    g = torch.Generator(device=dev).manual_seed(seed)
    qdt = torch.float32 if kind == 'f32' else torch.bfloat16
    q = torch.randn((b, n_kv * rep, hd), generator=g, device=dev).to(qdt)
    bounds = torch.tensor(bounds, dtype=torch.int32, device=dev)
    pos = torch.arange(s, device=dev)[None, :]
    valid = pos < bounds[:, None]
    for row, start, stop in holes:
        valid[row, start:stop] = False
    live_end = torch.clamp((bounds + page - 1) // page * page,
                           max=num_pages * page)
    readable = valid & (pos < live_end[:, None])
    ks = vs = None
    if kind == 'int8':
        kc = torch.randint(-127, 128, (b, s, n_kv, hd), generator=g,
                           device=dev, dtype=torch.int8)
        vc = torch.randint(-127, 128, (b, s, n_kv, hd), generator=g,
                           device=dev, dtype=torch.int8)
        ks = (torch.rand((b, s, n_kv), generator=g, device=dev) * 0.007 +
              0.001).to(torch.bfloat16)
        vs = (torch.rand((b, s, n_kv), generator=g, device=dev) * 0.007 +
              0.001).to(torch.bfloat16)
        ks[~readable] = float('nan')     # int8 holds no NaN: poison scales
        vs[~readable] = float('nan')
    else:
        kc = torch.randn((b, s, n_kv, hd), generator=g, device=dev).to(qdt)
        vc = torch.randn((b, s, n_kv, hd), generator=g, device=dev).to(qdt)
        kc[~readable] = float('nan')
        vc[~readable] = float('nan')
    k_self = torch.randn((b, n_kv, hd), generator=g, device=dev).to(qdt)
    v_self = torch.randn((b, n_kv, hd), generator=g, device=dev).to(qdt)
    args = (q, kc, vc, valid, bounds, k_self, v_self, ks, vs)
    return args, dict(page=page, num_pages=num_pages), readable


def route_launches(name, kind):
    """The launch counts one call of kernel ``name`` must leave: a f32 q
    counts under ``<name>.f32`` as well, an int8 cache ``<name>.int8``."""
    want = {name: 1}
    if kind != 'bf16':
        want[f'{name}.{kind}'] = 1
    return want


def decode_cost(args, kw, readable):
    """(bytes, operations) this data needs: q, the self K/V, the row
    bounds and each row's mask up to its last live page read once; K,
    V (and scales) of the readable slots only; the output written
    once. 4 * rep * head_dim operations per readable slot and kv head
    (scores and P @ V)."""
    q, kc, _, _, bounds, k_self, _, ks, _ = args
    b, _, n_kv, hd = kc.shape
    rep = q.shape[1] // n_kv
    page, n = kw['page'], kw['page'] * kw['num_pages']
    mask_bytes = sum(min(-(-int(x) // page) * page, n) for x in bounds)
    slots = int(readable.sum())
    nbytes = (2 * q.numel() * q.element_size() +
              2 * k_self.numel() * k_self.element_size() + b * 4 +
              mask_bytes + 2 * slots * n_kv * hd * kc.element_size() +
              (2 * slots * n_kv * ks.element_size() if ks is not None
               else 0))
    return nbytes, 4 * rep * hd * slots * n_kv


def phase_decode(torch, dev, seed, report):
    from skypilot_tpu_torch.ops import _build
    from skypilot_tpu_torch.ops import decode_attention as da
    entry = {'name': 'paged_decode', 'route': 'cuda',
             'source': 'skypilot_tpu_torch/ops/csrc/paged_decode.cu',
             'replaces': 'skypilot_tpu/ops/decode_attention.py:116',
             'products': 'bf16 wgmma, split-KV, bf16 and int8 caches (f32 '
             'route: f32 CUDA cores)'}
    for kind in ('f32', 'int8', 'bf16', 'long'):
        args, kw, readable = decode_inputs(
            torch, dev, 'bf16' if kind == 'long' else kind, seed,
            long=kind == 'long')
        _build.reset_launches()
        got = da.paged_gqa_decode_attention(*args, **kw)
        launches = dict(_build.LAUNCHES)
        want = da.paged_decode_reference(*args, **kw)
        torch.cuda.synchronize()
        err, ok = compare(got, want, bf16_bar=kind != 'f32')
        finite = bool(torch.isfinite(got.float()).all())
        # The empty row (bound 0) attends to itself alone.
        self_ok = True
        if kind != 'long':
            self_err, self_ok = compare(
                got[0].view(8, -1, 128),
                args[6][0][:, None, :].expand(8, 4, 128),
                bf16_bar=kind != 'f32')
        log(f'K1 {kind}: max_abs_err {err:.3g} (within bar: {ok}), '
            f'empty row equals its own value: {self_ok}, finite {finite}, '
            f'launches {launches}')
        route = route_launches('paged_decode',
                               'bf16' if kind == 'long' else kind)
        check(launches == route, f'K1 {kind}: launches {launches}, want '
              f'{route}')
        check(finite and ok and self_ok,
              f'K1 {kind} disagrees with its plain version')
        if kind == 'f32':
            entry['f32_max_abs_err'] = err
            continue
        nbytes, ops = decode_cost(args, kw, readable)
        sets = copies_of(args, nbytes)
        ms = time_ms(lambda *a: da.paged_gqa_decode_attention(*a, **kw),
                     sets)
        plain_ms = time_ms(lambda *a: da.paged_decode_reference(*a, **kw),
                           sets, iters=5 if kind == 'long' else 10)
        bound_ms, bound_by = bound(nbytes, ops,
                                   'int8' if kind == 'int8' else 'bfloat16')
        if kind == 'int8':
            entry.update(int8_max_abs_err=err, int8_ms=ms,
                         int8_plain_ms=plain_ms, int8_bound_ms=bound_ms)
        elif kind == 'long':
            entry.update(long_max_abs_err=err, long_ms=ms,
                         long_plain_ms=plain_ms, long_bound_ms=bound_ms,
                         long_library_ms=decode_library_ms(torch, args, kw),
                         long_shape='B 8, S 8192, rows live to 7700-8100, '
                         '32/8 heads, D 128, bf16')
        else:
            entry.update(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=decode_library_ms(torch, args, kw))
        del sets
    log(f'K1 times (ms): kernel {entry["ms"]:.4f}, plain '
        f'{entry["plain_ms"]:.4f}, library {entry["library_ms"]:.4f}, '
        f'bound {entry["bound_ms"]:.4f} ({entry["bound_by"]}); int8 '
        f'kernel {entry["int8_ms"]:.4f}, bound '
        f'{entry["int8_bound_ms"]:.4f}; S 8192: kernel '
        f'{entry["long_ms"]:.4f}, plain {entry["long_plain_ms"]:.4f}, '
        f'library {entry["long_library_ms"]:.4f}, bound '
        f'{entry["long_bound_ms"]:.4f}')
    report.append(entry)


def decode_library_ms(torch, args, kw):
    """One scaled_dot_product_attention call over the same live region
    (+ self slot) with an explicit mask; inputs are laid out before the
    timing, NaN cleared (the library masks by adding -inf, which NaN
    survives)."""
    q, kc, vc, valid, bounds, k_self, v_self, _, _ = args
    b, _, n_kv, hd = kc.shape
    n = kw['page'] * kw['num_pages']
    live_end = torch.clamp((bounds + kw['page'] - 1) // kw['page'] *
                           kw['page'], max=n)
    mask = valid[:, :n] & (torch.arange(n, device=kc.device)[None, :] <
                           live_end[:, None])
    mask = torch.cat([mask, mask.new_ones((b, 1))], 1)[:, None, None, :]
    k = torch.cat([kc[:, :n], k_self[:, None]], 1).nan_to_num(0.0)
    v = torch.cat([vc[:, :n], v_self[:, None]], 1).nan_to_num(0.0)
    k = k.transpose(1, 2).contiguous()
    v = v.transpose(1, 2).contiguous()
    return sdpa_ms(torch, q[:, :, None, :], k, v, mask)


def sdpa_ms(torch, q, k, v, mask):
    """Time F.scaled_dot_product_attention(q [B,H,L,D], k/v [B,Hkv,S,D],
    bool mask). Older torch lacks enable_gqa: K/V are then repeated to
    H heads before the timing."""
    import torch.nn.functional as F
    try:
        F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                       enable_gqa=True)
        kw = {'enable_gqa': True}
    except TypeError:
        rep = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(rep, 1)
        v = v.repeat_interleave(rep, 1)
        kw = {}
    sets = copies_of((q, k, v, mask), 2 * k.numel() * k.element_size())
    return time_ms(lambda a, b, c, m: F.scaled_dot_product_attention(
        a, b, c, attn_mask=m, **kw), sets)


# ------------------------------------------------------------------ K2


def chunk_inputs(torch, dev, kind, seed):
    g_, c, s, h, n_kv, d = 2, 128, 640, 32, 8, 128
    gen = torch.Generator(device=dev).manual_seed(seed)
    qdt = torch.float32 if kind == 'f32' else torch.bfloat16
    q = torch.randn((g_, c, h, d), generator=gen, device=dev).to(qdt)
    off = torch.tensor([0, 384], dtype=torch.int32, device=dev)
    frontier = (off + c)[:, None] <= torch.arange(s, device=dev)[None, :]
    ks = vs = None
    if kind == 'int8':
        k = torch.randint(-127, 128, (g_, s, n_kv, d), generator=gen,
                          device=dev, dtype=torch.int8)
        v = torch.randint(-127, 128, (g_, s, n_kv, d), generator=gen,
                          device=dev, dtype=torch.int8)
        ks = (torch.rand((g_, s, n_kv), generator=gen, device=dev) * 0.007
              + 0.001).to(torch.bfloat16)
        vs = (torch.rand((g_, s, n_kv), generator=gen, device=dev) * 0.007
              + 0.001).to(torch.bfloat16)
        ks[frontier] = float('nan')
        vs[frontier] = float('nan')
    else:
        k = torch.randn((g_, s, n_kv, d), generator=gen, device=dev).to(qdt)
        v = torch.randn((g_, s, n_kv, d), generator=gen, device=dev).to(qdt)
        k[frontier] = float('nan')
        v[frontier] = float('nan')
    return (q, k, v, off, ks, vs)


def chunk_cost(args):
    q, k, _, off, ks, _ = args
    g_, c, h, d = q.shape
    s, n_kv = k.shape[1], k.shape[2]
    rows = [min(s, int(o) + c) for o in off]        # K/V rows needed
    nbytes = (2 * q.numel() * q.element_size() + 4 * g_ +
              2 * sum(rows) * n_kv * d * k.element_size() +
              (2 * sum(rows) * n_kv * ks.element_size() if ks is not None
               else 0))
    attended = sum(min(int(o) + i + 1, s) for o in off for i in range(c))
    ops = 4 * d * h * attended
    return nbytes, ops


# K2 edge cases (C, H, n_kv, head_dim, S): C off the 64-row tile,
# head_dim 16, 64 and 128, GQA 1, 4 and 8; each with rows at offsets 0,
# 63, 64 and S - C.
CHUNK_EDGES = ((40, 4, 4, 16, 300), (200, 16, 4, 64, 400),
               (40, 32, 4, 128, 256), (200, 16, 2, 128, 512))


def chunk_edge_inputs(torch, dev, c, h, n_kv, d, s, kind, seed):
    """Four chunk rows at offsets 0, 63, 64 and S - C, bf16 q; NaN in
    the cache from each row's frontier offset + C on (in the scales for
    int8)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    g_ = 4
    off = torch.tensor([0, 63, 64, s - c], dtype=torch.int32, device=dev)
    dead = (off + c)[:, None] <= torch.arange(s, device=dev)[None, :]
    q = torch.randn((g_, c, h, d), generator=gen,
                    device=dev).to(torch.bfloat16)
    ks = vs = None
    if kind == 'int8':
        k, v = (torch.randint(-127, 128, (g_, s, n_kv, d), generator=gen,
                              device=dev, dtype=torch.int8)
                for _ in range(2))
        ks, vs = ((torch.rand((g_, s, n_kv), generator=gen, device=dev) *
                   0.007 + 0.001).to(torch.bfloat16) for _ in range(2))
        ks[dead] = float('nan')
        vs[dead] = float('nan')
    else:
        k, v = (torch.randn((g_, s, n_kv, d), generator=gen,
                            device=dev).to(torch.bfloat16) for _ in range(2))
        k[dead] = float('nan')
        v[dead] = float('nan')
    return (q, k, v, off, ks, vs)


def chunk_check(torch, fa, args, kind, tag):
    """K2 against its plain version; the launch must count its route
    (.f32 for a f32 q only, .int8 for an int8 cache). Returns the max
    abs error."""
    from skypilot_tpu_torch.ops import _build
    _build.reset_launches()
    got = fa.chunk_prefill_attention(*args)
    launches = dict(_build.LAUNCHES)
    want = fa.chunk_attention_reference(*args)
    torch.cuda.synchronize()
    err, ok = compare(got, want, bf16_bar=kind != 'f32')
    finite = bool(torch.isfinite(got.float()).all())
    log(f'K2 {kind} {tag}: max_abs_err {err:.3g} (within bar: {ok}), '
        f'finite {finite}')
    route = route_launches('chunk_prefill', kind)
    check(launches == route, f'K2 {kind} {tag}: launches {launches}, want '
          f'{route}')
    check(finite and ok, f'K2 {kind} {tag} disagrees with its plain version')
    return err


def phase_chunk(torch, dev, seed, report):
    from skypilot_tpu_torch.ops import flash_attention as fa
    entry = {'name': 'chunk_prefill', 'route': 'cuda',
             'source': 'skypilot_tpu_torch/ops/csrc/chunk_prefill.cu',
             'replaces': 'skypilot_tpu/ops/flash_attention.py:459',
             'products': 'bf16 wgmma, bf16 and int8 caches (f32 route: '
             'f32 CUDA cores)'}
    edge_err = 0.0
    for kind in ('bf16', 'int8'):
        for c, h, n_kv, d, s in CHUNK_EDGES:
            edge_err = max(edge_err, chunk_check(
                torch, fa, chunk_edge_inputs(torch, dev, c, h, n_kv, d, s,
                                             kind, seed),
                kind, f'C {c} H {h}/{n_kv} D {d} S {s}'))
    entry['bf16_edge_max_abs_err'] = edge_err
    for kind in ('f32', 'int8', 'bf16'):
        args = chunk_inputs(torch, dev, kind, seed)
        err = chunk_check(torch, fa, args, kind, 'G 2 x C 128 x S 640')
        if kind == 'f32':
            entry['f32_max_abs_err'] = err
            continue
        nbytes, ops = chunk_cost(args)
        sets = copies_of(args, nbytes)
        ms = time_ms(fa.chunk_prefill_attention, sets)
        plain_ms = time_ms(fa.chunk_attention_reference, sets, iters=10)
        bound_ms, bound_by = bound(nbytes, ops,
                                   'int8' if kind == 'int8' else 'bfloat16')
        if kind == 'int8':
            entry.update(int8_max_abs_err=err, int8_ms=ms,
                         int8_plain_ms=plain_ms, int8_bound_ms=bound_ms)
            continue
        entry.update(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                     bound_ms=bound_ms, bound_by=bound_by,
                     library_ms=chunk_library_ms(torch, args))
    log(f'K2 times (ms): kernel {entry["ms"]:.4f}, plain '
        f'{entry["plain_ms"]:.4f}, library {entry["library_ms"]:.4f}, '
        f'bound {entry["bound_ms"]:.4f} ({entry["bound_by"]}); int8 '
        f'kernel {entry["int8_ms"]:.4f}')
    report.append(entry)


def chunk_library_ms(torch, args):
    q, k, v, off, _, _ = args
    c, s = q.shape[1], k.shape[1]
    mask = (torch.arange(s, device=q.device)[None, None, :] <=
            off[:, None, None] + torch.arange(c, device=q.device)[None, :,
                                                                  None])
    mask = mask[:, None]                                 # [G, 1, C, S]
    return sdpa_ms(torch, q.transpose(1, 2).contiguous(),
                   k.nan_to_num(0.0).transpose(1, 2).contiguous(),
                   v.nan_to_num(0.0).transpose(1, 2).contiguous(), mask)


# ------------------------------------------------------------------ K3


def verify_inputs(torch, dev, kind, seed, shape=None):
    """Phase-3b inputs at Llama-3.1-8B serving shapes with spec_k 4 (B 8,
    V 5, 32/8 heads, head_dim 128, S 1024, page 128): the segment at
    column 700 (188 decode steps past a 512-token prompt region), n_cols
    768 (6 pages). Row 0 is inactive (dmask all false), row 1 a recycled
    row with only a 40-token prefix live; the others have prompts of
    100-512 tokens and decode columns with rejected-candidate holes
    (each earlier V-column verify tick kept its first 1-V columns). NaN
    sits in every column no query may attend (in the scales for int8).
    The segment start is a device int32, as the engine passes it.
    ``shape`` (V, H, n_kv, S, seg, n_cols) replaces the defaults."""
    b, vq, h, n_kv, d, s, seg, n_cols = 8, 5, 32, 8, 128, 1024, 700, 768
    if shape is not None:
        vq, h, n_kv, s, seg, n_cols = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    qdt = torch.float32 if kind == 'f32' else torch.bfloat16
    q = torch.randn((b, vq, h, d), generator=gen, device=dev).to(qdt)
    cols = torch.arange(s, device=dev)[None, :]
    prompt = torch.tensor([0, 40, 100, 250, 333, 480, 511, 512],
                          device=dev)[:, None]
    tick, pos = (cols - 512) // vq, (cols - 512) % vq
    kept = (cols >= 512) & (cols < seg) & (pos <= tick % vq)
    valid = (cols < prompt) | kept
    valid[0] = False
    valid[1] = cols[0] < 40
    live = valid | ((cols >= seg) & (cols < seg + vq))
    ks = vs = None
    if kind == 'int8':
        k = torch.randint(-127, 128, (b, s, n_kv, d), generator=gen,
                          device=dev, dtype=torch.int8)
        v = torch.randint(-127, 128, (b, s, n_kv, d), generator=gen,
                          device=dev, dtype=torch.int8)
        ks = (torch.rand((b, s, n_kv), generator=gen, device=dev) * 0.007 +
              0.001).to(torch.bfloat16)
        vs = (torch.rand((b, s, n_kv), generator=gen, device=dev) * 0.007 +
              0.001).to(torch.bfloat16)
        ks[~live] = float('nan')
        vs[~live] = float('nan')
    else:
        k = torch.randn((b, s, n_kv, d), generator=gen, device=dev).to(qdt)
        v = torch.randn((b, s, n_kv, d), generator=gen, device=dev).to(qdt)
        k[~live] = float('nan')
        v[~live] = float('nan')
    seg_t = torch.tensor(seg, dtype=torch.int32, device=dev)
    return (q, k, v, valid, seg_t, ks, vs), n_cols


# K3 segments wider than one 64-row tile (V, H, n_kv, S, seg, n_cols):
# Llama-3.1-8B's 32/8 heads with spec_k 16 (4 x 17 = 68 rows), and 32/4
# heads with spec_k 16 (8 x 17 = 136 rows: two bf16 row chunks, three
# f32 row groups).
VERIFY_WIDE = ((17, 32, 8, 1024, 700, 768), (17, 32, 4, 1024, 700, 768))
# The published max_seq 8192: the segment at column 8000, every column
# up to 63 pages readable.
VERIFY_LONG = (5, 32, 8, 8192, 8000, 8064)


def verify_plain(fa, args, n_cols):
    """K3's plain version over the region the kernel is given."""
    q, k, v, valid, seg, ks, vs = args
    cut = (lambda t: None if t is None else t[:, :n_cols])
    return fa.verify_attention_reference(q, cut(k), cut(v), cut(valid), seg,
                                         cut(ks), cut(vs))


def verify_cost(args, n_cols):
    """(bytes, operations) this data needs, as decode_cost counts K1's:
    q read and the output written once, each row's mask up to the end of
    its segment, K and V (and scales) of the columns some query attends
    (dmask-true plus the segment); 4 * head_dim operations per attended
    (query row, column, head)."""
    q, k, _, valid, seg, ks, _ = args
    b, vq, h, d = q.shape
    n_kv = k.shape[2]
    seg = int(seg)
    end = min(n_cols, seg + vq)
    dmask = int(valid[:, :end].sum())
    cols = dmask + b * vq
    nbytes = (2 * q.numel() * q.element_size() + b * end +
              2 * cols * n_kv * d * k.element_size() +
              (2 * cols * n_kv * ks.element_size() if ks is not None else 0))
    attended = vq * dmask + b * vq * (vq + 1) // 2
    return nbytes, 4 * d * h * attended


def verify_check(torch, fa, args, n_cols, kind, tag):
    """K3 against its plain version; the launch must count its route.
    Returns the max abs error."""
    from skypilot_tpu_torch.ops import _build
    _build.reset_launches()
    got = fa.verify_attention(*args, n_cols=n_cols)
    launches = dict(_build.LAUNCHES)
    want = verify_plain(fa, args, n_cols)
    torch.cuda.synchronize()
    err, ok = compare(got, want, bf16_bar=kind != 'f32')
    finite = bool(torch.isfinite(got.float()).all())
    # The inactive row's first query attends its own column alone.
    q, k, v, valid, seg, ks, vs = args
    rep = q.shape[2] // k.shape[2]
    seg = int(seg)
    own = v[0, seg].float()
    if vs is not None:
        own = own * vs[0, seg].float()[:, None]
    self_err, self_ok = compare(got[0, 0], own.repeat_interleave(rep, 0),
                                bf16_bar=kind != 'f32')
    log(f'K3 {kind} {tag}: max_abs_err {err:.3g} (within bar: {ok}), '
        f'inactive-row self err {self_err:.3g}, finite {finite}, launches '
        f'{launches}')
    route = route_launches('verify_attention', kind)
    check(launches == route, f'K3 {kind} {tag}: launches {launches}, want '
          f'{route}')
    check(finite and ok and self_ok,
          f'K3 {kind} {tag} disagrees with its plain version')
    return err


def phase_verify(torch, dev, seed, report):
    from skypilot_tpu_torch.ops import flash_attention as fa
    entry = {'name': 'verify_attention', 'route': 'cuda',
             'source': 'skypilot_tpu_torch/ops/csrc/verify_attention.cu',
             'replaces': 'skypilot_tpu/ops/flash_attention.py:750',
             'products': 'bf16 wgmma, split-KV, any rep x V rows, bf16 and '
             'int8 caches (f32 route: f32 CUDA cores)'}
    wide_err = 0.0
    for shape in VERIFY_WIDE:
        for kind in ('f32', 'bf16'):
            args, n_cols = verify_inputs(torch, dev, kind, seed, shape)
            rows = shape[1] // shape[2] * shape[0]
            wide_err = max(wide_err, verify_check(
                torch, fa, args, n_cols, kind, f'{rows} rows'))
    entry['wide_max_abs_err'] = wide_err
    for kind in ('f32', 'int8', 'bf16', 'long'):
        args, n_cols = verify_inputs(
            torch, dev, 'bf16' if kind == 'long' else kind, seed,
            VERIFY_LONG if kind == 'long' else None)
        err = verify_check(torch, fa, args, n_cols,
                           'bf16' if kind == 'long' else kind,
                           'S 8192' if kind == 'long' else '8B shapes')
        if kind == 'f32':
            entry['f32_max_abs_err'] = err
            continue
        nbytes, ops = verify_cost(args, n_cols)
        sets = copies_of(args, nbytes)
        ms = time_ms(lambda *a: fa.verify_attention(*a, n_cols=n_cols), sets)
        plain_ms = time_ms(lambda *a: verify_plain(fa, a, n_cols), sets,
                           iters=5 if kind == 'long' else 10)
        bound_ms, bound_by = bound(nbytes, ops,
                                   'int8' if kind == 'int8' else 'bfloat16')
        if kind == 'int8':
            entry.update(int8_max_abs_err=err, int8_ms=ms,
                         int8_plain_ms=plain_ms, int8_bound_ms=bound_ms)
        elif kind == 'long':
            entry.update(long_max_abs_err=err, long_ms=ms,
                         long_plain_ms=plain_ms, long_bound_ms=bound_ms,
                         long_library_ms=verify_library_ms(torch, args,
                                                           n_cols),
                         long_shape='B 8, V 5, S 8192, segment at 8000, '
                         'n_cols 8064, 32/8 heads, D 128, bf16')
        else:
            entry.update(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=verify_library_ms(torch, args, n_cols))
        del sets
    log(f'K3 times (ms): kernel {entry["ms"]:.4f}, plain '
        f'{entry["plain_ms"]:.4f}, library {entry["library_ms"]:.4f}, '
        f'bound {entry["bound_ms"]:.4f} ({entry["bound_by"]}); int8 '
        f'kernel {entry["int8_ms"]:.4f}, bound '
        f'{entry["int8_bound_ms"]:.4f}; S 8192: kernel '
        f'{entry["long_ms"]:.4f}, plain {entry["long_plain_ms"]:.4f}, '
        f'library {entry["long_library_ms"]:.4f}, bound '
        f'{entry["long_bound_ms"]:.4f}')
    report.append(entry)


def verify_library_ms(torch, args, n_cols):
    """One scaled_dot_product_attention call with an explicit [B, 1, V,
    end] mask (dmask | segment-causal) and GQA over the columns the
    kernel reads; inputs laid out before the timing, NaN cleared."""
    q, k, v, valid, seg, _, _ = args
    vq = q.shape[1]
    seg = int(seg)
    end = min(n_cols, seg + vq)
    col = torch.arange(end, device=q.device)[None, None, :]
    qi = torch.arange(vq, device=q.device)[None, :, None]
    mask = valid[:, None, :end] | ((col >= seg) & (col <= seg + qi))
    return sdpa_ms(torch, q.transpose(1, 2).contiguous(),
                   k[:, :end].nan_to_num(0.0).transpose(1, 2).contiguous(),
                   v[:, :end].nan_to_num(0.0).transpose(1, 2).contiguous(),
                   mask[:, None])


# ------------------------------------------------------- engine phases


def random_prompts(lengths, vocab, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, n).tolist() for n in lengths]


def repeated_prompts(lengths, vocab, seed):
    """Prompts that repeat a random 24-64-token segment, so that the
    prompt-lookup proposer finds earlier occurrences to draft from."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = []
    for n in lengths:
        part = rng.integers(0, vocab, int(rng.integers(24, 65))).tolist()
        out.append((part * (n // len(part) + 1))[:n])
    return out


def oracle_lookup(prompts, outputs):
    """A proposer that drafts each request's known continuation (the
    all-accept pattern of the JAX spec tests): ``outputs[i]`` continues
    ``prompts[i]``."""
    import numpy as np
    keyed = [(np.asarray(p), o) for p, o in zip(prompts, outputs)]

    def lookup(chain, k):
        for p, out in keyed:
            if len(chain) >= len(p) and np.array_equal(chain[:len(p)], p):
                g = len(chain) - len(p)
                return list(out[g:g + k])
        return []
    return lookup


def pool_bytes(torch, pool):
    """Bytes of the device memory segments that belong to the graphs'
    shared pool (None where the allocator's snapshot does not say)."""
    if pool is None:
        return None
    total, found = 0, False
    for seg in torch.cuda.memory_snapshot():
        pid = seg.get('segment_pool_id')
        if pid is not None and tuple(pid) == tuple(pool):
            total += seg['total_size']
            found = True
    return total if found else None


def warm(torch, eng, tag, graphs=True):
    """``eng.warmup()``: with graphs, the capture count must equal the
    enumerated key count (one graph per key); eager (graphs off through
    the engine's private attribute), nothing is captured. Logs the
    capture count and seconds and the graph pool's memory; returns the
    warmup seconds."""
    if not graphs:
        eng._graphs = None
    t0 = time.perf_counter()
    eng.warmup()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    keys = eng._tick_keys()
    if graphs:
        pool = pool_bytes(torch, eng._graph_pool)
        log(f'{tag}: warmup {secs:.2f} s, {eng.graph_captures} tick '
            f'programs captured of {len(keys)} enumerated in '
            f'{eng.graph_capture_s:.2f} s; graph pool '
            + (f'{pool / 2**20:.1f} MiB' if pool is not None else
               'not reported by the allocator')
            + f'; memory allocated {torch.cuda.memory_allocated() / 2**30:.2f}'
            ' GiB')
        check(eng.graph_captures == len(keys) == len(eng._graphs),
              f'{tag}: {eng.graph_captures} captures for {len(keys)} keys')
    else:
        log(f'{tag}: warmup {secs:.2f} s, eager ticks (graphs off)')
        check(eng.graph_captures == 0, f'{tag}: eager engine captured')
    return secs


def serve(torch, eng, reqs, tag):
    """Serve ``reqs`` with launch counts from 0; no capture may happen.
    Returns (results, wall seconds, launches, ticks dispatched)."""
    from skypilot_tpu_torch.ops import _build
    ticks = [0]

    def counted(key, launch=eng._launch):
        ticks[0] += 1
        return launch(key)
    eng._launch = counted
    captures = eng.graph_captures
    _build.reset_launches()              # counts start here ...
    t0 = time.perf_counter()
    try:
        res = eng.run(reqs)
        torch.cuda.synchronize()
    finally:
        del eng._launch
    wall = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)     # ... and are read here
    check(eng.graph_captures == captures,
          f'{tag}: {eng.graph_captures - captures} tick programs captured '
          'after warmup')
    return res, wall, launches, ticks[0]


def host_per_tick(busy, wall, ticks):
    """(idle share, host ms per tick): wall minus device busy, over the
    ticks dispatched."""
    return 1 - busy / wall, (wall - busy) / max(ticks, 1) * 1e3


def profile_serve(torch, eng, prompts, profile_dir, tag, wall, n_ticks):
    """Serve ``prompts`` once more under torch.profiler (after the
    measured run, so it does not slow that one). Logs the device idle
    share and host ms per tick twice: of the measured run (its wall and
    ticks, the busy time from the repeat) and of the profiled repeat
    itself (its own wall and ticks, which the profiler's host tracing
    inflates); and the device kernels per tick. Returns the measured
    run's (idle share, host ms per tick)."""
    from skypilot_tpu_torch.models.serving_engine import Request
    again = [Request(('profiled', i), p, max_new=32)
             for i, p in enumerate(prompts)]
    # A fresh decode region, as the measured run had: a region used up
    # mid-run would add the ticks of a drain and a reset.
    eng.reset()
    ticks = [0]

    def counted(key, launch=eng._launch):
        ticks[0] += 1
        return launch(key)
    eng._launch = counted
    try:
        busy, p_wall, kernels = profile_run(
            torch, lambda: eng.run(again), profile_dir,
            tag.replace(' ', '_').replace('(', '').replace(')', ''))
    finally:
        del eng._launch
    idle, host_ms = host_per_tick(busy, wall, n_ticks)
    p_idle, p_host_ms = host_per_tick(busy, p_wall, ticks[0])
    log(f'profile: {tag}: measured run: device idle share {idle:.3f}, host '
        f'{host_ms:.2f} ms per tick ({n_ticks} ticks, {wall:.3f} s wall, '
        f'{busy:.3f} s device busy from the repeat); profiled repeat: idle '
        f'{p_idle:.3f}, host {p_host_ms:.2f} ms per tick ({ticks[0]} ticks, '
        f'{p_wall:.3f} s wall); {kernels / max(ticks[0], 1):.0f} device '
        'kernels per tick')
    return idle, host_ms


def latency_line(tag, card):
    """TTFT, ITL and per-token latency of the run just served, from the
    port's own histograms (``metrics.REGISTRY``, reset before the run):
    count, mean (sum / count, exact) and p50/p99 (the bucket-interpolated
    estimate a PromQL ``histogram_quantile`` gives). Returns them."""
    from skypilot_tpu_torch import metrics
    out = {}
    parts = []
    for name, short in (('skytpu_engine_ttft_seconds', 'TTFT'),
                        ('skytpu_engine_itl_seconds', 'ITL'),
                        ('skytpu_engine_per_token_seconds', 'per-token')):
        hist = metrics.REGISTRY.get(name)
        series = hist.series()
        check(len(series) == 1, f'{tag}: no {name} observation')
        state = series[0][1]
        mean = state['sum'] / state['count']
        p50, p99 = hist.quantile(0.5), hist.quantile(0.99)
        out[short] = (state['count'], mean, p50, p99)
        parts.append(f'{short} n {state["count"]} mean {mean * 1e3:.2f} ms '
                     f'p50 {p50 * 1e3:.2f} ms p99 {p99 * 1e3:.2f} ms')
    log(f'{tag}: latency on {card} from the port\'s histograms: '
        + '; '.join(parts))
    return out


def phase_main_path(torch, dev, seed, card, handover, profile_dir=None):
    """The full-width engine run on captured tick programs, then the same
    requests served eagerly in the same call (graphs off through the
    engine's private attribute); returns the graphed run's launch
    counts. With ``profile_dir``, each run is then repeated under
    torch.profiler (device busy, idle share, host ms per tick). Leaves
    the model in ``handover['model']`` for phase 5c."""
    from skypilot_tpu_torch import metrics
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.models.serving_engine import (Request,
                                                          ServingEngine)
    cfg = llama.LlamaConfig.llama3_8b(max_seq=1024,
                                      param_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = llama.init_params(cfg, seed, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in [params['tok_emb'],
                                       params['final_norm'],
                                       params['lm_head'],
                                       *params['layers'].values()])
    log(f'main path: llama3_8b {cfg.n_layers} layers, d {cfg.dim}, '
        f'{n_params / 1e9:.3f}B params in bf16, init '
        f'{time.perf_counter() - t0:.1f} s')
    import numpy as np
    lengths = np.random.default_rng(seed + 1).integers(100, 513, 12)
    prompts = random_prompts(lengths, cfg.vocab_size, seed + 1)
    runs = {}
    for graphs in (True, False):
        tag = 'main path' + ('' if graphs else ' (eager)')
        eng = ServingEngine(params, cfg, batch_size=8, max_prompt=512,
                            prefill_chunk=128, prefill_budget=256,
                            decode_chunk=8, device=dev)
        warm(torch, eng, tag, graphs)
        reqs = [Request(i, p, max_new=32) for i, p in enumerate(prompts)]
        steps0, ticks0 = eng.decode_steps_total, eng.prefill_ticks
        torch.cuda.reset_peak_memory_stats()
        metrics.REGISTRY.reset()
        res, wall, launches, n_ticks = serve(torch, eng, reqs, tag)
        steps = eng.decode_steps_total - steps0
        ticks = eng.prefill_ticks - ticks0
        out_toks = sum(len(r.tokens) for r in res.values())
        toks = [res[i].tokens for i in range(len(prompts))]
        log(f'{tag}: {len(res)} requests, {sum(map(len, prompts))} prompt '
            f'tokens, {out_toks} output tokens in {wall:.3f} s = '
            f'{out_toks / wall:.1f} output tokens/s on {card}; {n_ticks} '
            f'ticks ({steps} decode steps, {ticks} prefill ticks); peak '
            f'memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; '
            f'launches {launches}')
        check(len(res) == 12 and all(
            r.status == 'finished' and len(r.tokens) == 32 and
            all(0 <= t < cfg.vocab_size for t in r.tokens)
            for r in res.values()), f'a {tag} request did not finish with '
              '32 tokens')
        check(launches.get('paged_decode', 0) == steps * cfg.n_layers > 0,
              f'{tag}: K1 launched {launches.get("paged_decode", 0)} times, '
              f'want {steps} x {cfg.n_layers}')
        check(launches.get('chunk_prefill', 0) == ticks * cfg.n_layers > 0,
              f'{tag}: K2 launched {launches.get("chunk_prefill", 0)} '
              f'times, want {ticks} x {cfg.n_layers}')
        check(launches.get('chunk_prefill.f32', 0) == 0 and
              launches.get('paged_decode.f32', 0) == 0,
              f'{tag}: bf16 serving launched K1 or K2 on the f32 route: '
              f'{launches}')
        runs[graphs] = (out_toks / wall, toks, launches)
        if graphs:
            check(metrics.REGISTRY.get('skytpu_engine_ttft_seconds')
                  .series()[0][1]['count'] == len(prompts),
                  f'{tag}: TTFT observed for other than {len(prompts)} '
                  'requests')
            handover['ttft'] = latency_line(tag, card)['TTFT'][1]
            # The idle share and host ms per tick of the measured run
            # (a profiled repeat gives the device busy time), then the
            # same run once more with tracing on.
            idle, host_ms = profile_serve(torch, eng, prompts, profile_dir,
                                          tag, wall, n_ticks)
            traced_run(torch, eng, prompts, toks, card, profile_dir,
                       (out_toks / wall, idle, host_ms))
        elif profile_dir:
            profile_serve(torch, eng, prompts, profile_dir, tag, wall,
                          n_ticks)
        del eng
    same = sum(a == b for a, b in zip(runs[True][1], runs[False][1]))
    log(f'main path on {card}: graphed {runs[True][0]:.1f} output tokens/s, '
        f'eager {runs[False][0]:.1f} in the same call '
        f'({runs[True][0] / runs[False][0]:.2f}x); {same}/{len(prompts)} '
        'requests give equal tokens')
    launches = runs[True][2]
    launches['verify_attention'] = phase_spec_path(torch, dev, seed, card,
                                                   cfg, params, profile_dir)
    handover['model'] = cfg, params
    handover['rate'] = runs[True][0]
    handover['main'] = prompts, runs[True][1]
    return launches


def traced_run(torch, eng, prompts, toks, card, profile_dir, untraced):
    """The graphed main path once more on the same engine with
    ``SKYTPU_TRACE_DIR`` set (a fresh temporary spool, removed after):
    the same tokens, and its output tokens/s, idle share and host ms per
    tick beside the untraced run's, with the spans it spooled."""
    import shutil
    import tempfile

    from skypilot_tpu_torch.models.serving_engine import Request
    from skypilot_tpu_torch.trace import export
    spool = tempfile.mkdtemp(prefix='chip_smoke_spans_')
    os.environ['SKYTPU_TRACE_DIR'] = spool
    try:
        reqs = [Request(('traced', i), p, max_new=32)
                for i, p in enumerate(prompts)]
        eng.reset()
        res, wall, _, n_ticks = serve(torch, eng, reqs, 'main path (traced)')
        spans = export.read_spans(spool)
        got = [res[('traced', i)].tokens for i in range(len(prompts))]
        check(got == toks, 'main path (traced): tokens differ from the '
              'untraced run on the same engine')
        names = sorted({s['name'] for s in spans})
        requests = sum(s['name'] == 'engine.request' for s in spans)
        check(requests == len(prompts) and 'engine.prefill.chunk' in names,
              f'main path (traced): spans {names}, {requests} '
              'engine.request')
        idle, host_ms = profile_serve(torch, eng, prompts, profile_dir,
                                      'main path (traced)', wall, n_ticks)
    finally:
        del os.environ['SKYTPU_TRACE_DIR']
        shutil.rmtree(spool, ignore_errors=True)
    rate = sum(map(len, got)) / wall
    log(f'main path on {card}, untraced / traced (SKYTPU_TRACE_DIR set), '
        f'same engine, same call: {untraced[0]:.1f} / {rate:.1f} output '
        f'tokens/s, idle share {untraced[1]:.3f} / {idle:.3f}, host '
        f'{untraced[2]:.2f} / {host_ms:.2f} ms per tick; {len(spans)} spans '
        f'spooled ({", ".join(names)})')


def phase_spec_path(torch, dev, seed, card, cfg, params, profile_dir=None):
    """Speculative decoding at full width on phase 5's weights: 12
    greedy requests of 32 new tokens on prompts of 100-512 tokens that
    repeat a random segment, served on captured tick programs three
    ways — spec off, spec on with the prompt-lookup proposer, spec on
    with the spec-off run's own tokens as drafts — and then prompt
    lookup once more with eager ticks in the same call. Each run counts
    its launches from 0: K1 must equal decode steps x layers, K2
    prefill ticks x layers and K3 verify ticks x layers, with K3 above 0
    in every spec run. bf16 spec-on tokens need not equal spec-off (K3
    and K1 round differently, and near-tied argmaxes may flip): the
    count that do is printed. Returns K3's launches in the graphed
    prompt-lookup run."""
    import numpy as np
    from skypilot_tpu_torch.models.serving_engine import (Request,
                                                          ServingEngine)
    lengths = np.random.default_rng(seed + 4).integers(100, 513, 12)
    prompts = repeated_prompts(lengths, cfg.vocab_size, seed + 4)
    runs, rates = {}, {}
    for mode in ('off', 'organic', 'oracle', 'organic eager'):
        eng = ServingEngine(params, cfg, batch_size=8, max_prompt=512,
                            prefill_chunk=128, prefill_budget=256,
                            decode_chunk=8, spec_decode=mode != 'off',
                            spec_k=4, device=dev)
        warm(torch, eng, f'spec path ({mode})', mode != 'organic eager')
        if mode == 'oracle':
            eng._lookup = oracle_lookup(prompts, runs['off'])
        reqs = [Request(i, p, max_new=32) for i, p in enumerate(prompts)]
        res, wall, launches, n_ticks = serve(torch, eng, reqs,
                                             f'spec path ({mode})')
        toks = [res[i].tokens for i in range(len(prompts))]
        runs[mode] = toks
        steps, ticks = eng.decode_steps_total, eng.prefill_ticks
        verify = eng.spec_ticks
        out_toks = sum(map(len, toks))
        rates[mode] = out_toks / wall
        same = sum(t == o for t, o in zip(toks, runs['off']))
        log(f'spec path ({mode}): {out_toks} output tokens in {wall:.3f} s '
            f'= {out_toks / wall:.1f} output tokens/s on {card}; {n_ticks} '
            f'ticks ({steps} decode steps, {ticks} prefill ticks, {verify} '
            f'verify ticks); {same}/{len(toks)} requests equal spec-off; '
            f'spec_stats {eng.spec_stats()}; launches {launches}')
        check(all(res[i].status == 'finished' and len(t) == 32 and
                  all(0 <= x < cfg.vocab_size for x in t)
                  for i, t in enumerate(toks)),
              f'spec path ({mode}): a request did not finish with 32 tokens')
        n_l = cfg.n_layers
        check(launches.get('paged_decode', 0) == steps * n_l and
              launches.get('chunk_prefill', 0) == ticks * n_l > 0 and
              launches.get('verify_attention', 0) == verify * n_l and
              not any(k.endswith('.f32') for k in launches),
              f'spec path ({mode}): launches {launches}, want K1 {steps} x '
              f'{n_l}, K2 {ticks} x {n_l}, K3 {verify} x {n_l}, none on '
              'the f32 route')
        check(mode == 'off' or verify > 0,
              f'spec path ({mode}): no verify tick ran')
        if mode == 'organic':
            organic_k3 = launches.get('verify_attention', 0)
        if profile_dir and mode in ('organic', 'organic eager'):
            profile_serve(torch, eng, prompts, profile_dir,
                          f'spec path ({mode})', wall, n_ticks)
        del eng
    log(f'spec path (prompt lookup) on {card}: graphed '
        f'{rates["organic"]:.1f} output tokens/s, eager '
        f'{rates["organic eager"]:.1f} in the same call '
        f'({rates["organic"] / rates["organic eager"]:.2f}x)')
    return organic_k3


def prefix_traffic(vocab, seed, max_prompt=512, n_requests=24):
    """``bench.py``'s serve_prefix traffic: 8 shared prefixes of 3/4 of
    max_prompt random tokens, Zipf 1.1 popularity, each prompt its
    prefix plus a fresh random suffix of 1 to max_prompt - prefix - 1
    tokens. Returns (prompts, the prefix index of each)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    n_prefixes, plen = 8, (3 * max_prompt) // 4
    prefixes = [rng.integers(0, vocab, plen).tolist()
                for _ in range(n_prefixes)]
    weights = np.arange(1, n_prefixes + 1, dtype=np.float64) ** -1.1
    weights /= weights.sum()
    prompts, picks = [], []
    for _ in range(n_requests):
        k = int(rng.choice(n_prefixes, p=weights))
        slen = int(rng.integers(1, max(2, max_prompt - plen)))
        prompts.append(prefixes[k] + rng.integers(0, vocab, slen).tolist())
        picks.append(k)
    return prompts, picks


def record_reuse(eng):
    """Per-request reuse of ``eng``'s prefix cache: wraps its acquire
    and returns the dict it fills (request id -> reused tokens)."""
    reuse, acquire = {}, eng.prefix.acquire

    def recorded(rid, *a, **kw):
        out = acquire(rid, *a, **kw)
        reuse[rid] = out[0]
        return out
    eng.prefix.acquire = recorded
    return reuse


def first_divergence(a, b):
    """Index of the first token where ``a`` and ``b`` differ (None if
    equal)."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return None if len(a) == len(b) else min(len(a), len(b))


def phase_prefix_path(torch, dev, seed, card, handover, profile_dir=None):
    """The prefix cache at full width on phase 5's weights: 24 greedy
    requests of 32 new tokens on ``prefix_traffic`` (8 shared prefixes of
    384 tokens, three 128-token pages each), served concurrently on
    captured tick programs with the cache on (the default pool of 512
    pages), then off, in the same call. There must be hits, tokens saved
    must equal the per-request reuse summed (each 0 or 384), prefill
    ticks must be fewer with the cache on, and each run's launches must
    equal its decode steps and prefill ticks x 32 on the bf16 route.

    Bit-identity: a hit leaves prefill ticks earlier, so its decode
    steps (and the other slots') write at other cache columns under
    other num_pages; K1 reduces each row's live keys in their own
    order, so the tokens must not move. Every request's cache-on tokens
    must equal its cache-off tokens (24/24), and so must a control's:
    the cache-off engine again with the arrival order reversed, outside
    the timed runs. As the control's slots finish, each request's own
    prefill K/V of its prefix is copied aside, and the pool's pages must
    equal it bitwise (24/24)."""
    from skypilot_tpu_torch.models.serving_engine import (Request,
                                                          ServingEngine)
    from skypilot_tpu_torch.utils.chain_hash import page_hashes
    check('model' in handover, 'phase 5 did not hand over its model')
    cfg, params = handover['model']
    prompts, picks = prefix_traffic(cfg.vocab_size, seed + 5)
    n, plen = len(prompts), 384
    log(f'prefix path: {n} prompts of {min(map(len, prompts))}-'
        f'{max(map(len, prompts))} tokens ({sum(map(len, prompts))} in all) '
        f'over {len(set(picks))} of 8 prefixes, requests per prefix '
        f'{[picks.count(k) for k in range(8)]}')

    def engine(on, tag):
        eng = ServingEngine(params, cfg, batch_size=8, max_prompt=512,
                            prefill_chunk=128, prefill_budget=256,
                            decode_chunk=8, page=128, prefix_cache=on,
                            device=dev)
        warm(torch, eng, tag)
        return eng

    def tokens(res, ids):
        return [res[i].tokens for i in ids]

    engines, runs = {}, {}
    for on in (True, False):
        tag = 'prefix path (cache ' + ('on)' if on else 'off)')
        resident = torch.cuda.memory_allocated()
        eng = engines[on] = engine(on, tag)
        reuse = record_reuse(eng) if on else {}
        reqs = [Request(i, p, max_new=32) for i, p in enumerate(prompts)]
        torch.cuda.reset_peak_memory_stats()
        res, wall, launches, n_ticks = serve(torch, eng, reqs, tag)
        if on:
            del eng.prefix.acquire     # the recorder's reference cycle
        steps, ticks = eng.decode_steps_total, eng.prefill_ticks
        toks = tokens(res, range(n))
        out_toks = sum(map(len, toks))
        stats = eng.prefix.stats() if on else None
        log(f'{tag}: {out_toks} output tokens in {wall:.3f} s = '
            f'{out_toks / wall:.1f} output tokens/s on {card}; {n_ticks} '
            f'ticks ({steps} decode steps, {ticks} prefill ticks); '
            f'{eng.graph_captures} tick programs captured; peak memory '
            f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB, '
            f'{resident / 2**30:.2f} GiB of it allocated before this engine '
            f'was built; prefix {stats}; launches {launches}')
        check(all(res[i].status == 'finished' and len(t) == 32 and
                  all(0 <= x < cfg.vocab_size for x in t)
                  for i, t in enumerate(toks)),
              f'{tag}: a request did not finish with 32 tokens')
        n_l = cfg.n_layers
        check(launches.get('paged_decode', 0) == steps * n_l > 0 and
              launches.get('chunk_prefill', 0) == ticks * n_l > 0 and
              not any(k.endswith('.f32') for k in launches),
              f'{tag}: launches {launches}, want K1 {steps} x {n_l} and K2 '
              f'{ticks} x {n_l}, none on the f32 route')
        if on:
            pool_gib = sum(t.numel() * t.element_size()
                           for t in eng.prefix.pool.values()) / 2**30
            log(f'{tag}: the pool holds {pool_gib:.2f} GiB')
            log(f'{tag}: reuse per request {[reuse[i] for i in range(n)]}')
            check(stats['hits'] > 0 and stats['lookups'] == n,
                  f'{tag}: {stats}')
            check(stats['tokens_saved'] == sum(reuse.values()) and
                  set(reuse.values()) <= {0, plen},
                  f'{tag}: tokens saved {stats["tokens_saved"]} against the '
                  f'per-request reuse {reuse}')
        runs[on] = (out_toks / wall, toks, ticks, wall, n_ticks)
    on_toks, off_toks = runs[True][1], runs[False][1]
    log(f'prefix path on {card}: cache on {runs[True][0]:.1f} output '
        f'tokens/s, off {runs[False][0]:.1f} in the same call '
        f'({runs[True][0] / runs[False][0]:.2f}x); prefill ticks '
        f'{runs[True][2]} on, {runs[False][2]} off')
    check(runs[True][2] < runs[False][2],
          f'prefix path: {runs[True][2]} prefill ticks with the cache on, '
          f'{runs[False][2]} off')

    # The control: the cache off, arrival order reversed. Each request's
    # own prefill K/V of its prefix is copied on the device (in stream
    # order) as its slot finishes, into buffers allocated before the run
    # (an allocation could sync it).
    eng = engines[False]
    shape = eng.cache['k'][:, 0, :plen].shape
    snaps = {(i, f): torch.empty(shape, dtype=eng.cache[f].dtype,
                                 device=dev)
             for i in range(n) for f in ('k', 'v')}

    def finish(slot, done=eng._finish):
        _, rid = eng.slots[slot].request_id
        for f in ('k', 'v'):
            snaps[rid, f].copy_(eng.cache[f][:, slot, :plen])
        done(slot)
    eng._finish = finish
    res, _, _, _ = serve(torch, eng, [
        Request(('reversed', i), prompts[i], max_new=32)
        for i in reversed(range(n))], 'prefix path (cache off, reversed)')
    del eng._finish
    ctrl = tokens(res, [('reversed', i) for i in range(n)])
    pool, page = engines[True].prefix, 128
    equal_pages = 0
    for i, p in enumerate(prompts):
        ids = [pool._by_hash[h] for h in page_hashes(p[:plen], page)]
        equal_pages += all(
            torch.equal(pool.pool[f][:, idx],
                        snaps[i, f][:, j * page:(j + 1) * page])
            for f in ('k', 'v') for j, idx in enumerate(ids))
    snaps.clear()
    same = sum(a == b for a, b in zip(on_toks, off_toks))
    same_ctrl = sum(a == b for a, b in zip(ctrl, off_toks))
    parts = [(i, first_divergence(a, b)) for i, (a, b) in
             enumerate(zip(on_toks, off_toks)) if a != b]
    parts_ctrl = [(i, first_divergence(a, b)) for i, (a, b) in
                  enumerate(zip(ctrl, off_toks)) if a != b]
    log(f'prefix path: {same}/{n} requests give the cache-off tokens with '
        f'the cache on, served concurrently (request, first divergent '
        f'token: {parts}); control, the cache off in reversed arrival '
        f'order: {same_ctrl}/{n} ({parts_ctrl}); pool pages equal to the '
        f'request\'s own prefill K/V, bitwise: {equal_pages}/{n}')
    check(equal_pages == n, f'prefix path: only {equal_pages}/{n} prefixes\' '
          'pool pages equal the cache-off prefill bitwise')
    check(same == n, f'prefix path: only {same}/{n} requests give the '
          f'cache-off tokens with the cache on (first divergent tokens '
          f'{parts})')
    check(same_ctrl == n, f'prefix path: only {same_ctrl}/{n} requests give '
          f'the same tokens in reversed arrival order ({parts_ctrl})')
    del eng, pool
    engines.clear()
    if profile_dir:
        # Fresh engines: the measured run started from an empty pool.
        for on in (True, False):
            tag = 'prefix path (cache ' + ('on)' if on else 'off)')
            eng = engine(on, tag + ', profiled')
            profile_serve(torch, eng, prompts, profile_dir, tag,
                          runs[on][3], runs[on][4])
            del eng


# Phase 5d's traffic, 24 requests: request i is of tenant
# LIFECYCLE_TENANTS[i % 4] (None: untagged) and of class
# LIFECYCLE_CLASS[i], and asks for 32 new tokens; a bulk one asks for 96
# (a batch job: with 32, slots turn over about once a tick and no
# admission stall lasts the two ticks a preemption takes), and so do the
# two whose deadlines pass mid-decode (long answers: a decode-only tick
# takes about half a mixed one, so 32 tokens can finish inside a
# deadline meant to cut them). The first
# burst, on the idle engine, is 0-9: two interactive requests whose
# deadlines pass mid-decode and eight bulk ones; the second, once at
# most two bulk requests are still queued, is 10-23: six interactive and
# eight standard requests, of which 21-23 carry deadlines that pass
# while they are queued and 16 and 17 are cancelled from a second
# thread once they have a token.
LIFECYCLE_TENANTS = ('a', 'b', 'c', None)
LIFECYCLE_CLASS = (('interactive',) * 2 + ('bulk',) * 8 +
                   ('interactive',) * 6 + ('standard',) * 8)
LIFECYCLE_MID_DECODE = (0, 1)
LIFECYCLE_QUEUED = (21, 22, 23)
LIFECYCLE_CANCELS = (16, 17)
LIFECYCLE_FIRST_BURST = 10
LIFECYCLE_MAX_QUEUE = 14
# Every class earns a full charge (at most 32 + 4 x 8 tick-tokens) per
# DRR round, so admission is by class rank and no slot idles for
# credit. With the default weights (8/4/1) a bulk stream earns 8 a
# round, one round a tick, and bulk requests leave slots empty.
LIFECYCLE_WEIGHTS = 'interactive=8,standard=8,bulk=8'


def lifecycle_max_new(i):
    long = LIFECYCLE_CLASS[i] == 'bulk' or i in LIFECYCLE_MID_DECODE
    return 96 if long else 32


def lifecycle_serve(torch, eng, prompts, tick_s, tag):
    """The lifecycle traffic of phase 5d on ``eng``, stepped to the end
    with launch counts from 0. Deadlines are in units of ``tick_s`` (the
    control's seconds per tick): a mid-decode one is its request's
    prefill ticks (of the uncached suffix) plus 4 ticks from its
    submission (of the 12 its 96 tokens take), a queued one 2.5 ticks. Returns (Results by request
    index, launches, ticks, wall seconds, the shed victims the rule
    picks from the queue as the second burst lands)."""
    import threading

    from skypilot_tpu_torch.models.serving_engine import Request
    from skypilot_tpu_torch.ops import _build
    from skypilot_tpu_torch.utils import qos
    n = len(prompts)

    def request(i):
        p, now = prompts[i], time.time()
        deadline = None
        if i in LIFECYCLE_MID_DECODE:
            ticks = eng._prefill_ticks(eng._suffix_len(len(p), p))
            deadline = now + (ticks + 4) * tick_s
        elif i in LIFECYCLE_QUEUED:
            deadline = now + 2.5 * tick_s
        return Request(('life', i), p, max_new=lifecycle_max_new(i),
                       deadline=deadline,
                       tenant=LIFECYCLE_TENANTS[i % 4],
                       priority_class=LIFECYCLE_CLASS[i])

    go = {i: threading.Event() for i in LIFECYCLE_CANCELS}
    done = threading.Event()

    def canceller():
        for i in LIFECYCLE_CANCELS:
            go[i].wait()
            if done.is_set():
                return
            eng.cancel(('life', i), reason='api')

    th = threading.Thread(target=canceller)
    th.start()
    ticks = [0]

    def counted(key, launch=eng._launch):
        ticks[0] += 1
        return launch(key)
    eng._launch = counted
    captures = eng.graph_captures
    terminal, want_shed, second = [], None, False
    _build.reset_launches()
    start = time.perf_counter()
    try:
        for i in range(LIFECYCLE_FIRST_BURST):
            eng.submit(request(i))
        while eng.queue or eng.num_active() or eng.has_pending or \
                not second:
            eng.step()
            terminal += list(eng.drain_results().values())
            for i in LIFECYCLE_CANCELS:
                slot = next((s for s in eng.slots if s is not None and
                             s.request_id == ('life', i)), None)
                if slot is not None and slot.generated:
                    go[i].set()
            queued_bulk = sum(r.priority_class == 'bulk'
                              for r in list(eng.queue))
            if not second and queued_bulk <= 2:
                for i in range(LIFECYCLE_FIRST_BURST, n):
                    eng.submit(request(i))
                second = True
                # The shedding rule on this queue: while it exceeds the
                # bound, the newest request of the lowest class goes.
                queue = [(qos.class_rank(r.priority_class), k,
                          r.request_id[1]) for k, r in enumerate(eng.queue)]
                want_shed = set()
                while len(queue) > LIFECYCLE_MAX_QUEUE:
                    victim = max(queue)
                    queue.remove(victim)
                    want_shed.add(victim[2])
        torch.cuda.synchronize()
    finally:
        done.set()
        for ev in go.values():
            ev.set()
        th.join()
        del eng._launch
    wall = time.perf_counter() - start
    launches = dict(_build.LAUNCHES)
    terminal += list(eng.drain_results().values())
    check(eng.graph_captures == captures,
          f'{tag}: {eng.graph_captures - captures} captures after warmup')
    ids = [r.request_id for r in terminal]
    check(sorted(ids) == sorted(('life', i) for i in range(n)),
          f'{tag}: {len(ids)} terminal Results for {n} requests '
          f'({len(set(ids))} distinct)')
    return ({r.request_id[1]: r for r in terminal}, launches, ticks[0],
            wall, want_shed)


def lifecycle_gates(tag, res, control, prompts, eng, exact, want_shed):
    """Phase 5d's gates on one leg's lifecycle run: statuses and reasons
    where the traffic puts them, partial tokens a prefix of the control's
    (and, with ``exact``, finished tokens equal to it), shed victims the
    newest of the lowest class, pins 0, and every counter equal to what
    the Results say, read from the rendered exposition too."""
    import collections

    from skypilot_tpu_torch import metrics
    n = len(prompts)
    by_status = collections.Counter((r.status, r.reason)
                                    for r in res.values())
    log(f'{tag}: terminal states {dict(by_status)}')
    for i in LIFECYCLE_MID_DECODE:
        check(res[i].status == 'expired' and
              0 < len(res[i].tokens) < lifecycle_max_new(i),
              f'{tag}: request {i} should expire mid-decode: '
              f'{res[i].status} with {len(res[i].tokens)} tokens')
    for i in LIFECYCLE_QUEUED:
        check(res[i].status == 'expired' and res[i].tokens == [],
              f'{tag}: request {i} should expire queued: {res[i].status} '
              f'with {len(res[i].tokens)} tokens')
    for i in LIFECYCLE_CANCELS:
        check((res[i].status, res[i].reason) == ('cancelled', 'api') and
              0 < len(res[i].tokens) < lifecycle_max_new(i),
              f'{tag}: request {i} should be cancelled mid-run: '
              f'{res[i].status}/{res[i].reason}, {len(res[i].tokens)} tokens')
    shed = {i for i, r in res.items() if r.reason == 'shed_by_priority'}
    check(shed == want_shed and shed and
          all(LIFECYCLE_CLASS[i] == 'bulk' and res[i].tokens == []
              for i in shed),
          f'{tag}: shed {sorted(shed)}, want the newest of the lowest class '
          f'{sorted(want_shed)}, all bulk')
    preempted = {i for i, r in res.items()
                 if r.reason == 'preempted_by_priority'}
    check(preempted and all(LIFECYCLE_CLASS[i] == 'bulk'
                            for i in preempted),
          f'{tag}: preempted {sorted(preempted)}, want at least one bulk '
          'slot')
    finished = [i for i, r in res.items() if r.status == 'finished']
    check(all(len(res[i].tokens) == lifecycle_max_new(i)
              for i in finished),
          f'{tag}: a finished request has other than its max_new tokens')
    same = [i for i in finished if res[i].tokens == control[i]]
    prefix = [i for i, r in res.items() if r.status != 'finished' and
              r.tokens == control[i][:len(r.tokens)]]
    partial = n - len(finished)
    log(f'{tag}: finished {len(finished)}, of them {len(same)} with the '
        f'control\'s tokens; partials that prefix the control '
        f'{len(prefix)}/{partial}; preempted {sorted(preempted)}; shed '
        f'{sorted(shed)}')
    if exact:
        check(len(same) == len(finished) and len(prefix) == partial,
              f'{tag}: finished tokens differ from the control or a '
              'partial is not its prefix')
    check(eng.prefix is None or eng.prefix.pinned_pages() == 0,
          f'{tag}: {eng.prefix and eng.prefix.pinned_pages()} pages '
          'still pinned')
    # The counters against the Results, in the rendered text.
    vals = metrics.parse_values(metrics.render_exposition())
    tokens = sum(len(r.tokens) for r in res.values())
    surfaced = sum(bool(r.tokens) for r in res.values())
    want = {'skytpu_engine_tokens_total': tokens,
            'skytpu_engine_requests_total': n,
            'skytpu_engine_ttft_seconds_count': surfaced}
    reasons = collections.Counter(r.reason for r in res.values()
                                  if r.status != 'finished')
    for reason, k in reasons.items():
        want[f'skytpu_engine_cancels_total{{reason="{reason}"}}'] = k
    for metric, ids in (('sheds', shed), ('preempted', preempted)):
        for cls, k in collections.Counter(
                LIFECYCLE_CLASS[i] for i in ids).items():
            want[f'skytpu_engine_{metric}_total{{class="{cls}"}}'] = k
    got = {k: vals.get(k) for k in want}
    check(got == want, f'{tag}: exposition {got}, Results say {want}')
    cancels = sum(v for k, v in vals.items()
                  if k.startswith('skytpu_engine_cancels_total{'))
    check(cancels == partial, f'{tag}: {cancels} cancels counted, '
          f'{partial} partial Results')
    log(f'{tag}: the exposition parses ({len(vals)} samples) and its '
        f'counters equal the Results: {want}')


def phase_lifecycle(torch, dev, seed, card, handover):
    """Request lifecycle and multi-tenant QoS at full width on phase 5's
    weights and engine geometry (batch 8, max_prompt 512, chunk 128,
    budget 256, decode chunk 8, captured ticks), with
    ``SKYTPU_QOS_MAX_QUEUE`` 14, ``SKYTPU_QOS_PREEMPT_AFTER_S`` 0.001 and
    ``SKYTPU_QOS_WEIGHTS`` ``LIFECYCLE_WEIGHTS``.
    Two legs, each on one engine: random prompts of 100-512 tokens with
    the prefix cache and speculation off, then the repeated-prompt
    generator with both on (prompt lookup; K3 runs). Each leg serves its
    24 requests (``lifecycle_max_new``) untagged, FIFO, with no deadline
    first: the control (before any tagged request, so the QoS latch is
    still off), whose seconds per tick time the deadlines. Then the
    lifecycle traffic (``LIFECYCLE_*``: 8 requests of each class over
    tenants a, b, c and untagged) in two bursts, batch work first and
    the chat burst onto a replica busy with it: two requests expire
    mid-decode, three while queued, two are cancelled from a second
    thread, the newest queued bulk requests are shed and bulk slots are
    preempted. (Submitted at once, the 24 would be admitted in strict
    class order, since every waiting stream banks DRR credit, and no
    bulk request would hold a slot while a higher class waits.)
    Gates: one Result per request, statuses where the traffic puts them,
    nothing captured after warmup, pins 0, the counters equal to the
    Results in the parsed exposition; without speculation every finished
    request has the control's tokens and every partial prefixes them
    (bf16 tokens follow each row's live keys alone); with it the count
    is printed, not held (a row's tokens come from K1 or K3 as the
    schedule makes its ticks decode or verify ticks, and the two round
    differently)."""
    import numpy as np

    from skypilot_tpu_torch import metrics
    from skypilot_tpu_torch.models.serving_engine import (Request,
                                                          ServingEngine)
    check('model' in handover, 'phase 5 did not hand over its model')
    cfg, params = handover['model']
    lengths = np.random.default_rng(seed + 7).integers(
        100, 513, len(LIFECYCLE_CLASS))
    knobs = {'SKYTPU_QOS_MAX_QUEUE': str(LIFECYCLE_MAX_QUEUE),
             'SKYTPU_QOS_PREEMPT_AFTER_S': '0.001',
             'SKYTPU_QOS_WEIGHTS': LIFECYCLE_WEIGHTS}
    saved = {k: os.environ.get(k) for k in knobs}
    os.environ.update(knobs)
    try:
        for leg, gen, on in (('5d', random_prompts, False),
                             ('5d spec+prefix', repeated_prompts, True)):
            tag = f'lifecycle ({leg})'
            prompts = gen(lengths, cfg.vocab_size, seed + 7)
            eng = ServingEngine(params, cfg, batch_size=8, max_prompt=512,
                                prefill_chunk=128, prefill_budget=256,
                                decode_chunk=8, spec_decode=on, spec_k=4,
                                prefix_cache=on, device=dev)
            warm(torch, eng, tag)
            ctrl, c_wall, _, c_ticks = serve(
                torch, eng, [Request(('ctrl', i), p,
                                     max_new=lifecycle_max_new(i))
                             for i, p in enumerate(prompts)], tag)
            check(not eng._qos_active, f'{tag}: the control latched QoS')
            control = [ctrl[('ctrl', i)].tokens for i in range(len(prompts))]
            tick_s = c_wall / c_ticks
            # A fresh decode region, as the lifecycle run's would be on a
            # new replica (the pool, with the cache on, keeps its pages).
            eng.reset()
            log(f'{tag}: control (untagged, FIFO) {sum(map(len, control))} '
                f'tokens in {c_wall:.3f} s, {c_ticks} ticks, '
                f'{tick_s * 1e3:.1f} ms per tick on {card}')
            metrics.REGISTRY.reset()
            steps0, pre0, ver0 = (eng.decode_steps_total, eng.prefill_ticks,
                                  eng.spec_ticks)
            res, launches, n_ticks, wall, want_shed = lifecycle_serve(
                torch, eng, prompts, tick_s, tag)
            steps = eng.decode_steps_total - steps0
            pre, ver = eng.prefill_ticks - pre0, eng.spec_ticks - ver0
            n_l = cfg.n_layers
            log(f'{tag}: {sum(len(r.tokens) for r in res.values())} tokens '
                f'in {wall:.3f} s, {n_ticks} ticks ({steps} decode steps, '
                f'{pre} prefill ticks, {ver} verify ticks); captures '
                f'{eng.graph_captures} = keys {len(eng._tick_keys())}; '
                f'launches {launches}')
            check(launches.get('paged_decode', 0) == steps * n_l and
                  launches.get('chunk_prefill', 0) == pre * n_l > 0 and
                  launches.get('verify_attention', 0) == ver * n_l and
                  not any(k.endswith('.f32') for k in launches),
                  f'{tag}: launches {launches}, want K1 {steps} x {n_l}, '
                  f'K2 {pre} x {n_l}, K3 {ver} x {n_l}')
            check(not on or ver > 0, f'{tag}: no verify tick ran')
            lifecycle_gates(tag, res, control, prompts, eng, not on,
                            want_shed)
            latency_line(tag, card)
            del eng
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def phase_prefix_parity(torch, dev, parity):
    """The prefix cache on phase 6's depth-2 f32 model, page 8 and
    prefill chunk 8, so short prompts span pages: a 32-token publisher,
    then a full hit, a miss and divergences at page - 1, page and page +
    1 (page 8), one at a time; each one's tokens must equal
    ``reference_generate``'s and its reuse the reference's (24/0/8/16/16
    after the publisher's 0). The same requests with an int8 KV cache
    must give equal tokens with the cache on and off (K1 and K2 on
    their int8 branches); and speculation with the cache on, prompt
    lookup and then the reference's tokens as drafts (K3 launched),
    must give the spec-off tokens. After the f32 cache-on run, the f32
    routes of K1 and K3 over that engine's cache must give the same bits
    wherever the decode keys sit (``p4_live_key_check``)."""
    from skypilot_tpu_torch.models import inference
    from skypilot_tpu_torch.models.serving_engine import (Request,
                                                          ServingEngine)
    check(parity is not None, 'phase 6 did not hand over its model')
    cfg, params, _, _, _, _ = parity
    import numpy as np
    rng = np.random.default_rng(11)

    def fresh(n):
        return rng.integers(0, cfg.vocab_size, n).tolist()
    base = fresh(32)
    cases = [('pub', base, 0), ('full hit', base, 24), ('miss', fresh(20), 0),
             ('div 15', base[:15] + fresh(12), 8),
             ('div 16', base[:16] + fresh(12), 16),
             ('div 17', base[:17] + fresh(12), 16)]
    width = max(len(p) for _, p, _ in cases)
    toks = torch.zeros((len(cases), width), dtype=torch.int64, device=dev)
    for i, (_, p, _) in enumerate(cases):
        toks[i, :len(p)] = torch.tensor(p, device=dev)
    want = inference.reference_generate(
        params, toks, [len(p) for _, p, _ in cases], cfg, 8).tolist()

    engines = {}

    def serve_cases(tag, lookup=None, **kw):
        eng = ServingEngine(params, cfg, batch_size=2, max_prompt=64,
                            max_seq=128, prefill_chunk=8, prefill_budget=16,
                            decode_chunk=4, page=8, prefix_pool_pages=16,
                            device=dev, **kw)
        engines[tag] = eng
        warm(torch, eng, tag)
        if lookup is not None:
            eng._lookup = lookup
        got, reuse, total = [], [], {}
        for rid, prompt, _ in cases:
            saved = eng.prefix.tokens_saved if eng.prefix else 0
            res, _, launches, _ = serve(
                torch, eng, [Request(rid, prompt, max_new=8)], tag)
            got.append(res[rid].tokens)
            reuse.append((eng.prefix.tokens_saved if eng.prefix else 0) -
                         saved)
            for k, n in launches.items():
                total[k] = total.get(k, 0) + n
        same = sum(g == w for g, w in zip(got, want))
        log(f'{tag}: {same}/{len(want)} requests equal reference_generate; '
            f'reuse {reuse}; prefix {eng.prefix and eng.prefix.stats()}; '
            f'spec {eng.spec_stats()}; launches {total}')
        check(all(len(g) == 8 for g in got), f'{tag}: a request did not '
              'finish')
        check(total.get('chunk_prefill.f32', 0) ==
              total.get('chunk_prefill', 0) > 0,
              f'{tag}: a f32 K2 launch missed the f32 route: {total}')
        return got, reuse, total

    got, reuse, _ = serve_cases('prefix parity (f32, cache on)',
                                prefix_cache=True)
    check(got == want, f'prefix parity: tokens {got} != reference {want}')
    check(reuse == [r for _, _, r in cases],
          f'prefix parity: reuse {reuse}, want {[r for _, _, r in cases]}')
    p4_live_key_check(torch, dev, engines.pop(
        'prefix parity (f32, cache on)'), 'prefix parity (P4, f32 routes)')
    q_on, _, total = serve_cases('prefix parity (int8 KV, cache on)',
                                 prefix_cache=True, kv_quant=True)
    check(total.get('paged_decode.int8', 0) > 0 and
          total.get('chunk_prefill.int8', 0) > 0,
          f'prefix parity (int8 KV): no int8 K1 or K2 launch: {total}')
    q_off, _, _ = serve_cases('prefix parity (int8 KV, cache off)',
                              prefix_cache=False, kv_quant=True)
    check(q_on == q_off, f'prefix parity (int8 KV): cache on {q_on} != '
          f'cache off {q_off}')
    for name, lookup in (('prompt lookup', None),
                         ('oracle drafts', oracle_lookup(
                             [p for _, p, _ in cases], want))):
        tag = f'prefix parity (spec, {name}, cache on)'
        spec, _, total = serve_cases(tag, lookup, prefix_cache=True,
                                     spec_decode=True, spec_k=4)
        check(spec == got, f'{tag}: tokens {spec} != spec off {got}')
        check(name != 'oracle drafts' or
              total.get('verify_attention.f32', 0) ==
              total.get('verify_attention', 0) > 0,
              f'{tag}: K3 did not run on its f32 route: {total}')


def p4_live_key_check(torch, dev, eng, tag):
    """P4 on the f32 routes: the attention output of K1 and K3 over an
    engine's own cache (layer 0 after the 6c traffic) must not move a
    bit when each row's decode keys sit at other columns, as another
    schedule (the prefix cache on or off, another slot history) puts
    them, or when other columns are dispatched; and stay within 1e-4 of
    the plain versions (which reduce by cache column, the reference's
    order)."""
    from skypilot_tpu_torch.ops import _build
    from skypilot_tpu_torch.ops import decode_attention as tda
    from skypilot_tpu_torch.ops import flash_attention as tfa
    cache = eng.cache
    k, v, valid = cache['k'][0], cache['v'][0], cache['dmask']
    b, s, n_kv, hd = k.shape
    base, page, vq = eng.max_prompt, eng._page, 5
    n_heads = eng.cfg.n_heads
    gen = torch.Generator(device=dev).manual_seed(5)
    q1 = torch.randn((b, n_heads, hd), generator=gen, device=dev)
    self_kv = [torch.randn((b, n_kv, hd), generator=gen, device=dev)
               for _ in range(2)]
    q3 = torch.randn((b, vq, n_heads, hd), generator=gen, device=dev)
    seg_kv = [torch.randn((b, vq, n_kv, hd), generator=gen, device=dev)
              for _ in range(2)]
    last = int(valid.nonzero()[:, 1].max())
    room = s - vq - last - 1
    check(room >= 2 and int(valid[:, base:].sum()) > 0,
          f'{tag}: no decode keys to move ({room} columns free)')
    outs = []
    for shift in (0, room // 2, room):
        kc = torch.full_like(k, float('nan'))
        vc = torch.full_like(v, float('nan'))
        val = torch.zeros_like(valid)
        for r in range(b):
            cols = valid[r].nonzero()[:, 0]
            new = torch.where(cols >= base, cols + shift, cols)
            kc[r, new], vc[r, new] = k[r, cols], v[r, cols]
            val[r, new] = True
        seg = last + shift + 1
        bound = torch.full((b,), seg, dtype=torch.int32, device=dev)
        got = []
        for num_pages in (-(-seg // page), -(-s // page)):
            args = (q1, kc, vc, val, bound, *self_kv)
            _build.reset_launches()
            o1 = tda.paged_gqa_decode_attention(*args, page=page,
                                                num_pages=num_pages)
            check(_build.LAUNCHES.get('paged_decode.f32') == 1,
                  f'{tag}: K1 missed its f32 route')
            ref = tda.paged_decode_reference(*args, page=page,
                                             num_pages=num_pages)
            check(float((o1 - ref).abs().max()) <= 1e-4,
                  f'{tag}: f32 K1 off its plain version')
            got.append(o1)
        k3, v3 = kc.clone(), vc.clone()
        k3[:, seg:seg + vq], v3[:, seg:seg + vq] = seg_kv
        seg_t = torch.tensor(seg, dtype=torch.int32, device=dev)
        for n_cols in (seg + vq, s):
            o3 = tfa.verify_attention(q3, k3, v3, val, seg_t, n_cols=n_cols)
            ref = verify_plain(tfa, (q3, k3, v3, val, seg_t, None, None),
                               n_cols)
            check(float((o3 - ref).abs().max()) <= 1e-4,
                  f'{tag}: f32 K3 off its plain version')
            got.append(o3)
        torch.cuda.synchronize()
        outs.append(got)
    same = [all(torch.equal(a, c) for a, c in zip(o, outs[0]))
            for o in outs[1:]]
    log(f'{tag}: f32 K1/K3 outputs over the engine\'s own keys, decode '
        f'keys moved by 0/{room // 2}/{room} columns and read under two '
        f'page and column counts: bitwise equal {same}')
    check(all(same) and all(torch.equal(a, c) for a, c in
                            ((outs[0][0], outs[0][1]),
                             (outs[0][2], outs[0][3]))),
          f'{tag}: f32 K1/K3 bits follow the cache columns (P4)')


HTTP_MAX_NEW = 32


def http_call(url, body=None, headers=None, timeout=600):
    """One request with the standard library (the card's machine
    promises no aiohttp): (status, headers, body bytes)."""
    import urllib.error
    import urllib.request
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={
        'Content-Type': 'application/json', **(headers or {})})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def http_sse(url, body, t0):
    """A streaming /generate read line by line: (done event, seconds
    from ``t0`` to the first token event, headers)."""
    import urllib.request
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={'Content-Type': 'application/json'})
    first, done = None, None
    with urllib.request.urlopen(req, timeout=600) as r:
        headers = dict(r.headers)
        for raw in r:
            line = raw.decode().strip()
            if not line.startswith('data:'):
                continue
            event = json.loads(line[5:])
            if first is None:
                first = time.perf_counter() - t0
            if event.get('done') or event.get('error'):
                done = event
    return done, first, headers


def wait_healthy(url, tag, timeout=900):
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        try:
            status, _, body = http_call(url + '/health', timeout=5)
            if status == 200:
                return json.loads(body)
            check(json.loads(body).get('status') != 'dead',
                  f'{tag}: replica died: {body}')
        except OSError:
            pass
        time.sleep(0.2)
    raise Failed(f'{tag}: /health not ok after {timeout} s')


def phase_http(torch, dev, seed, card, handover):
    """Phase 12: the replica's HTTP front end at full width on phase 5's
    weights. A fresh engine of phase 5's geometry behind the port's
    ``EngineServer`` on localhost (warmup and captured ticks on its
    driver thread) serves phase 5's 12 requests, sent at once from
    standard-library clients, half SSE and half JSON: the tokens must
    equal phase 5's engine tokens (12/12), the captures the enumerated
    keys with none after warmup, K1/K2 launches decode steps and prefill
    ticks x 32 on the bf16 route, /health ok and /metrics parsed with a
    TTFT observation per request. Output tokens/s and TTFT are printed
    beside phase 5's direct run. Then a drain with a request in flight
    must finish it and end clean. Then a prefill replica and a decode
    replica (the prefix cache on, sharing the weight tensors) hand four
    prompts over ``kv_prefill`` and /kv/fetch: the decode replica's
    tokens must equal phase 5's solo tokens bitwise, with pages
    imported."""
    import asyncio

    import numpy as np
    from skypilot_tpu_torch import metrics
    from skypilot_tpu_torch.models.serving_engine import ServingEngine
    from skypilot_tpu_torch.models.serving_http import EngineServer
    from skypilot_tpu_torch.ops import _build
    check('model' in handover and 'main' in handover,
          'phase 5 did not hand over its model')
    cfg, params = handover['model']
    prompts, want = handover['main']
    geometry = dict(batch_size=8, max_prompt=512, prefill_chunk=128,
                    prefill_budget=256, decode_chunk=8, device=dev)

    async def start(server, tag):
        runner = await server.start(0, host='127.0.0.1')
        url = f'http://127.0.0.1:{runner.addresses[0][1]}'
        t0 = time.perf_counter()
        health = await asyncio.to_thread(wait_healthy, url, tag)
        eng = server.engine
        log(f'{tag}: healthy after {time.perf_counter() - t0:.1f} s '
            f'(warmup on the driver thread: {eng.graph_captures} tick '
            f'programs captured of {len(eng._tick_keys())} in '
            f'{eng.graph_capture_s:.2f} s); /health {sorted(health)}')
        check(health['status'] == 'ok', f'{tag}: /health {health}')
        check(eng.graph_captures == len(eng._tick_keys()),
              f'{tag}: {eng.graph_captures} captures for '
              f'{len(eng._tick_keys())} keys')
        return runner, url

    async def main_traffic():
        server = EngineServer(ServingEngine(params, cfg, **geometry))
        runner, url = await start(server, 'http main path')
        eng = server.engine
        captures = eng.graph_captures
        steps0, ticks0 = eng.decode_steps_total, eng.prefill_ticks
        metrics.REGISTRY.reset()
        _build.reset_launches()          # counts start here ...
        t0 = time.perf_counter()

        def one(i):
            body = {'tokens': prompts[i], 'max_new': HTTP_MAX_NEW}
            if i % 2:
                done, first, _ = http_sse(url + '/generate',
                                          {**body, 'stream': True}, t0)
                return done, first
            status, _, raw = http_call(url + '/generate', body)
            check(status == 200, f'http main path: {status} {raw[:200]}')
            return json.loads(raw), None

        answers = await asyncio.gather(*(asyncio.to_thread(one, i)
                                         for i in range(len(prompts))))
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)  # ... and are read here
        steps = eng.decode_steps_total - steps0
        ticks = eng.prefill_ticks - ticks0
        got = [a[0]['tokens'] for a in answers]
        same = sum(g == w for g, w in zip(got, want))
        for i, (g, w) in enumerate(zip(got, want)):
            if g != w:
                log(f'http main path: request {i} parts from phase 5 at '
                    f'token {first_divergence(g, w)}')
        out_toks = sum(map(len, got))
        sse_ttft = [a[1] for a in answers if a[1] is not None]
        log(f'http main path: {len(got)} requests (6 SSE, 6 JSON), '
            f'{out_toks} output tokens in {wall:.3f} s = '
            f'{out_toks / wall:.1f} output tokens/s through HTTP on {card}'
            f', phase 5 direct {handover.get("rate", float("nan")):.1f} in '
            f'the same call; {steps} decode steps, {ticks} prefill ticks; '
            f'client TTFT (SSE) mean {np.mean(sse_ttft) * 1e3:.1f} ms; '
            f'launches {launches}; {same}/{len(want)} requests equal '
            'phase 5\'s tokens')
        lat = latency_line('http main path', card)
        log(f'http main path: server TTFT mean {lat["TTFT"][1] * 1e3:.1f} '
            f'ms against phase 5\'s {handover.get("ttft", float("nan")) * 1e3:.1f}'
            ' ms in the same call')
        check(all(a[0]['status'] == 'finished' for a in answers),
              'http main path: a request did not finish')
        check(same == len(want), f'http main path: {same}/{len(want)} '
              'requests equal phase 5\'s tokens')
        check(eng.graph_captures == captures,
              'http main path: a tick program was captured after warmup')
        check(launches.get('paged_decode', 0) == steps * cfg.n_layers > 0
              and launches.get('chunk_prefill', 0) ==
              ticks * cfg.n_layers > 0 and
              launches.get('paged_decode.f32', 0) == 0 and
              launches.get('chunk_prefill.f32', 0) == 0,
              f'http main path: launches {launches} for {steps} decode '
              f'steps and {ticks} prefill ticks')
        status, _, raw = await asyncio.to_thread(http_call,
                                                 url + '/metrics')
        values = metrics.parse_values(raw.decode())
        check(status == 200 and values.get(
            'skytpu_engine_ttft_seconds_count') == len(prompts),
            f'http main path: /metrics {status}, TTFT count '
            f'{values.get("skytpu_engine_ttft_seconds_count")}')
        # A drain with one request in flight: it finishes, then clean.
        t1 = time.perf_counter()
        late = asyncio.create_task(asyncio.to_thread(
            http_sse, url + '/generate',
            {'tokens': prompts[0], 'max_new': HTTP_MAX_NEW,
             'stream': True}, t1))
        while not (eng.queue or eng.num_active()):
            await asyncio.sleep(0.005)
        status, _, raw = await asyncio.to_thread(http_call, url + '/drain',
                                                 {})
        check(status == 202, f'http drain: POST /drain {status}')
        status, _, raw = await asyncio.to_thread(
            http_call, url + '/generate', {'tokens': [1, 2], 'max_new': 2})
        check(status == 503, f'http drain: a new request got {status}')
        clean = await server.drain()
        done, _, _ = await late
        log(f'http drain: clean {clean} in {time.perf_counter() - t1:.2f} s;'
            f' the in-flight request {done["status"]} with '
            f'{len(done["tokens"])} tokens, equal to phase 5\'s '
            f'{done["tokens"] == want[0]}')
        check(clean and done['status'] == 'finished' and
              done['tokens'] == want[0], 'http drain: not clean')
        await runner.cleanup()

    async def handoff():
        servers, urls, runners = [], [], []
        for role in ('prefill', 'decode'):
            server = EngineServer(ServingEngine(
                params, cfg, prefix_cache=True, prefix_pool_pages=64,
                **geometry))
            server.set_role(role)
            runner, url = await start(server, f'http {role} replica')
            servers.append(server)
            urls.append(url)
            runners.append(runner)
        imported0 = metrics.summary().get(
            'skytpu_engine_prefix_pages_imported_total', 0)
        same, reused = 0, []
        for i in range(4):
            status, _, raw = await asyncio.to_thread(
                http_call, urls[0] + '/generate',
                {'tokens': prompts[i], 'max_new': HTTP_MAX_NEW,
                 'kv_prefill': True})
            manifest = json.loads(raw)
            check(status == 200 and manifest['manifest'],
                  f'http handoff: manifest {status} {raw[:200]}')
            done, _, headers = await asyncio.to_thread(
                http_sse, urls[1] + '/generate',
                {'tokens': prompts[i], 'max_new': HTTP_MAX_NEW,
                 'stream': True, 'kv_source': urls[0]},
                time.perf_counter())
            reused.append(int(headers.get('X-KV-Reused-Tokens', -1)))
            same += done['tokens'] == want[i]
            if done['tokens'] != want[i]:
                log(f'http handoff: request {i} parts from the solo tokens '
                    f'at token {first_divergence(done["tokens"], want[i])}')
        imported = metrics.summary().get(
            'skytpu_engine_prefix_pages_imported_total', 0) - imported0
        log(f'http handoff (prefill -> decode replica, {card}): {same}/4 '
            f'equal phase 5\'s solo tokens; X-KV-Reused-Tokens {reused}; '
            f'{imported:.0f} pages imported; decode replica prefix '
            f'{servers[1].engine.prefix.stats()}')
        check(same == 4 and imported > 0 and min(reused) > 0,
              'http handoff: not bitwise equal to the solo tokens, or no '
              'page imported')
        for server, runner in zip(servers, runners):
            check(server.engine.graph_captures ==
                  len(server.engine._tick_keys()),
                  'http handoff: a capture after warmup')
            check(await server.drain(), 'http handoff: drain not clean')
            await runner.cleanup()

    asyncio.run(main_traffic())
    gc.collect()
    torch.cuda.empty_cache()
    asyncio.run(handoff())
    # The stopped servers and their engines (with phase 5's weights)
    # must be gone before the next phases read their peak memory.
    gc.collect()
    torch.cuda.empty_cache()


# (part of the kernel's name, group, its wrappers' launch count key).
# Each of Q1's routes is a group of its own.
KERNEL_GROUPS = (('paged_decode', 'K1 paged_decode', 'paged_decode'),
                 ('chunk_prefill', 'K2 chunk_prefill', 'chunk_prefill'),
                 ('verify_attention', 'K3 verify_attention',
                  'verify_attention'),
                 ('flash_fwd', 'K4 flash_fwd', 'flash_fwd'),
                 ('flash_dq', 'K5a flash_dq', 'flash_dq'),
                 ('flash_dkv', 'K5b flash_dkv', 'flash_dkv'),
                 ('int8_matmul_wgmma', 'Q1 int8_matmul (wgmma)',
                  'int8_matmul.wgmma'),
                 ('int8_matmul_mma', 'Q1 int8_matmul (mma.sync)',
                  'int8_matmul.mma'),
                 ('int8_matmul_f32', 'Q1 int8_matmul (f32)',
                  'int8_matmul.f32'))
# The last profile_run's device time by kernel group: {group: (ms, n)}.
LAST_PROFILE = {}


def kernel_group(name):
    for key, group, _ in KERNEL_GROUPS:
        if key in name:
            return group
    if 'nvjet' in name or 'gemm' in name or 'cublas' in name.lower():
        return 'matmul (cuBLAS)'
    return 'host<->device copies' if 'Memcpy' in name else \
        'other PyTorch kernels'


def profile_run(torch, fn, out_dir, tag):
    """Run ``fn()`` again under torch.profiler (after the measured run,
    so it does not slow that one): device busy time against wall time,
    and the kernels by device time, written to ``out_dir`` (None: logged
    only). Each of the
    port's kernels is also counted twice, by the profiler and by the
    wrappers' launch counts over the same ``fn()``, so a launch the
    profiler's window missed shows. Returns (device busy seconds, wall
    seconds, kernels the profiler saw)."""
    from torch.profiler import ProfilerActivity, profile

    from skypilot_tpu_torch.ops import _build
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        before = dict(_build.LAUNCHES)
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        host = {k: n - before.get(k, 0) for k, n in _build.LAUNCHES.items()}
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, 'self_device_time_total',
                       getattr(e, 'self_cuda_time_total', 0))

    kernels = sorted((e for e in events
                      if str(e.device_type).endswith('CUDA')),
                     key=dev_us, reverse=True)
    busy = sum(dev_us(e) for e in kernels) / 1e6
    groups = {}
    for e in kernels:
        group = kernel_group(e.key)
        ms, n = groups.get(group, (0.0, 0))
        groups[group] = (ms + dev_us(e) / 1e3, n + e.count)
    LAST_PROFILE['groups'] = groups
    path = None
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f'chip_smoke_profile_{tag}.txt')
        with open(path, 'w', encoding='utf-8') as f:
            f.write(f'wall {wall:.4f} s, device busy {busy:.4f} s\n')
            for e in kernels:
                f.write(f'{dev_us(e) / 1e3:12.3f} ms {e.count:7d}x  '
                        f'{e.key}\n')
            f.write('\n' + events.table(row_limit=60) + '\n')
    log(f'profile: wall under the profiler {wall:.3f} s, device busy '
        f'{busy:.3f} s ({sum(n for _, n in groups.values())} kernel '
        'launches); device time by group:')
    for group, (ms, n) in sorted(groups.items(), key=lambda t: -t[1][0]):
        log(f'  {group:30s} {ms:10.1f} ms {n:8d} launches '
            f'{100 * ms / 1e3 / busy:5.1f}%')
    counted = ', '.join(
        f'{group} {groups.get(group, (0.0, 0))[1]}/'
        f'{host.get(count, 0) if count else "-"}'
        for _, group, count in KERNEL_GROUPS
        if host.get(count, 0) or group in groups)
    log(f'profile ({tag}): kernel launches seen by the profiler / counted '
        f'by the wrappers: {counted}')
    log('profile: top kernels by device time:')
    for e in kernels[:8]:
        log(f'  {dev_us(e) / 1e3:10.3f} ms {e.count:6d}x  {e.key[:90]}')
    if path:
        log(f'profile: full table in {path}')
    return busy, wall, sum(n for _, n in groups.values())


def phase_parity(torch, dev, seed):
    from skypilot_tpu_torch.models import inference, llama
    from skypilot_tpu_torch.models.serving_engine import (Request,
                                                          ServingEngine)
    cfg = llama.LlamaConfig.llama3_8b(n_layers=2, max_seq=512,
                                      param_dtype=torch.float32,
                                      compute_dtype=torch.float32)
    params = llama.init_params(cfg, seed + 2, device=dev)
    # Lengths on both sides of the 128-token chunk edge.
    prompts = random_prompts([37, 127, 129, 250], cfg.vocab_size, seed + 3)
    width = max(map(len, prompts))
    toks = torch.zeros((len(prompts), width), dtype=torch.int64, device=dev)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.tensor(p, device=dev)
    want = inference.reference_generate(
        params, toks, [len(p) for p in prompts], cfg, 16).tolist()
    for kv_quant in (False, True):
        eng = ServingEngine(params, cfg, batch_size=4, max_prompt=256,
                            max_seq=512, prefill_chunk=128,
                            prefill_budget=256, decode_chunk=8,
                            kv_quant=kv_quant, device=dev)
        tag = f'parity (kv_quant={kv_quant})'
        warm(torch, eng, tag)
        res, _, launches, _ = serve(
            torch, eng, [Request(i, p, max_new=16)
                         for i, p in enumerate(prompts)], tag)
        got = [res[i].tokens for i in range(len(prompts))]
        same = sum(g == w for g, w in zip(got, want))
        log(f'parity (depth 2, f32, kv_quant={kv_quant}): {same}/'
            f'{len(want)} requests equal reference_generate; launches '
            f'{launches}')
        check(all(len(g) == 16 for g in got),
              f'kv_quant={kv_quant}: a request did not finish')
        check(launches.get('chunk_prefill.f32', 0) ==
              launches.get('chunk_prefill', 0) > 0 and
              launches.get('paged_decode.f32', 0) ==
              launches.get('paged_decode', 0) > 0,
              f'kv_quant={kv_quant}: a f32 K1 or K2 launch missed the f32 '
              f'route: {launches}')
        if kv_quant:
            check(launches.get('paged_decode.int8', 0) > 0 and
                  launches.get('chunk_prefill.int8', 0) > 0,
                  'the int8 pass did not run both kernels\' int8 branches')
        else:
            check(got == want, f'engine tokens {got} != reference {want}')
            engine_tokens = got
    return cfg, params, toks, [len(p) for p in prompts], want, engine_tokens


def phase_spec_parity(torch, dev, parity):
    """Speculation on phase 6's depth-2 f32 model and prompts: with the
    oracle proposer (the reference's tokens: all accept), garbage drafts
    (all reject) and the prompt-lookup proposer, the engine's greedy
    tokens must equal ``reference_generate``'s and the spec-off
    engine's, and the oracle and garbage runs must verify through K3.
    Then an int8-KV spec pass (oracle drafts) must finish every request
    through K3's int8 branch. Last, spec_k 16 on the same 32/8 heads:
    4 x 17 = 68 query rows per kv head, more than one 64-row tile; its
    tokens must equal the reference's and spec-off's, through K3 on its
    f32 route."""
    from skypilot_tpu_torch.models.serving_engine import (Request,
                                                          ServingEngine)
    check(parity is not None, 'phase 6 did not hand over its model')
    cfg, params, toks, lengths, want, engine_tokens = parity
    prompts = [toks[i, :n].tolist() for i, n in enumerate(lengths)]
    oracle = oracle_lookup(prompts, want)
    garbage = (lambda chain, k: [(int(chain[-1]) + 7) % cfg.vocab_size] * k)
    for name, lookup, kv_quant, spec_k in (
            ('oracle', oracle, False, 4), ('garbage', garbage, False, 4),
            ('organic', None, False, 4), ('int8 oracle', oracle, True, 4),
            ('wide oracle, spec_k 16', oracle, False, 16)):
        eng = ServingEngine(params, cfg, batch_size=4, max_prompt=256,
                            max_seq=512, prefill_chunk=128,
                            prefill_budget=256, decode_chunk=8,
                            kv_quant=kv_quant, spec_decode=True,
                            spec_k=spec_k, device=dev)
        check(eng.spec_decode, f'spec parity ({name}): speculation off')
        warm(torch, eng, f'spec parity ({name})')
        if lookup is not None:
            eng._lookup = lookup
        res, _, launches, _ = serve(
            torch, eng, [Request(i, p, max_new=16)
                         for i, p in enumerate(prompts)],
            f'spec parity ({name})')
        got = [res[i].tokens for i in range(len(prompts))]
        same = sum(g == w for g, w in zip(got, want))
        log(f'spec parity (depth 2, f32, {name}): {same}/{len(want)} '
            f'requests equal reference_generate; spec_stats '
            f'{eng.spec_stats()}; launches {launches}')
        check(all(len(g) == 16 for g in got),
              f'spec parity ({name}): a request did not finish')
        check(launches.get('chunk_prefill.f32', 0) ==
              launches.get('chunk_prefill', 0) > 0,
              f'spec parity ({name}): a f32 K2 launch missed the f32 '
              f'route: {launches}')
        k3 = launches.get('verify_attention', 0)
        check(k3 == eng.spec_ticks * cfg.n_layers ==
              launches.get('verify_attention.f32', 0),
              f'spec parity ({name}): K3 launched {k3} times for '
              f'{eng.spec_ticks} verify ticks, all on the f32 route: '
              f'{launches}')
        if kv_quant:
            check(launches.get('verify_attention.int8', 0) == k3 > 0,
                  'the int8 spec pass did not run K3\'s int8 branch')
            continue
        check(got == want and got == engine_tokens,
              f'spec parity ({name}): tokens {got} != reference {want}')
        if name != 'organic':
            check(k3 > 0, f'spec parity ({name}): no verify tick ran')
        del eng


# ------------------------------------------------------- K4, K5a, K5b

FLASH_ENTRIES = (
    ('flash_fwd', 'skypilot_tpu_torch/ops/csrc/flash_fwd.cu',
     'skypilot_tpu/ops/flash_attention.py:85'),
    ('flash_dq', 'skypilot_tpu_torch/ops/csrc/flash_bwd.cu',
     'skypilot_tpu/ops/flash_attention.py:182'),
    ('flash_dkv', 'skypilot_tpu_torch/ops/csrc/flash_bwd.cu',
     'skypilot_tpu/ops/flash_attention.py:224'))


def flash_inputs(torch, dev, b, sq, sk, h, dtype, seed, d=128):
    g = torch.Generator(device=dev).manual_seed(seed)

    def draw(s):
        return torch.randn((b, s, h, d), generator=g, device=dev).to(dtype)

    return draw(sq), draw(sk), draw(sk), draw(sq)          # q, k, v, dO


def attended_pairs(sq, sk, causal):
    """(query, key) pairs the mask lets through, per batch row and
    head (bottom-right causal alignment)."""
    if not causal:
        return sq * sk
    return sum(min(sk, max(0, i + sk - sq + 1)) for i in range(sq))


def flash_costs(q, k, causal):
    """(bytes, operations) each kernel needs on these inputs, each input
    read once and each output written once: K4 reads q, k, v and writes
    o and lse; K5a reads q, k, v, o, dO and lse and writes dQ and delta;
    K5b (bf16) reads q, k, v, dO, lse and delta and writes dK and dV. A
    product costs 2 * head_dim operations per attended pair: K4 does 2
    (scores, P @ V), K5a 3 (scores, dP, dQ), K5b 4 (scores, dP, dV,
    dK)."""
    b, sq, h, d = q.shape
    qb, kb = q.numel() * q.element_size(), k.numel() * k.element_size()
    lse = b * h * sq * 4
    prod = 2 * d * b * h * attended_pairs(sq, k.shape[1], causal)
    return {'flash_fwd': (2 * qb + 2 * kb + lse, 2 * prod),
            'flash_dq': (4 * qb + 2 * kb + 2 * lse, 3 * prod),
            'flash_dkv': (2 * qb + 4 * kb + 2 * lse, 4 * prod)}


def flash_check(torch, fa, args, causal, f32):
    """K4 against ``_plain_fwd``, and K5a/K5b against ``_plain_bwd`` on
    the kernel's own o and lse; every launch must count its route (the
    ``.f32`` entries on f32 only). Returns the max errors (o, lse, dq,
    dk, dv). lse is f32 either way and takes the f32 bar."""
    from skypilot_tpu_torch.ops import _build
    q, k, v, do = args
    kw = dict(causal=causal, scale=q.shape[-1]**-0.5)
    _build.reset_launches()
    o, lse = fa.flash_forward(q, k, v, **kw)
    got = (o, lse) + fa.flash_backward(q, k, v, o, lse, do, **kw)
    launches = dict(_build.LAUNCHES)
    want = fa._plain_fwd(q, k, v, **kw) + fa._plain_bwd(q, k, v, o, lse, do,
                                                         **kw)
    torch.cuda.synchronize()
    names = ('flash_fwd', 'flash_dq', 'flash_dkv')
    route = {n: 1 for n in names}
    if f32:
        route.update({f'{n}.f32': 1 for n in names})
    check(launches == route, f'launches {launches}, want {route}')
    errs = {}
    for name, g, w in zip(('o', 'lse', 'dq', 'dk', 'dv'), got, want):
        err, ok = compare(g, w, bf16_bar=not f32 and name != 'lse')
        check(ok and bool(torch.isfinite(g.float()).all()),
              f'{name} disagrees with its plain version (max abs err '
              f'{err:.3g})')
        errs[name] = err
    # K5a's delta output, which K5b reads: rowsum(dO * o) in f32.
    delta = fa._flash_dq_cuda(q, k, v, o, lse, do, **kw)[1]
    want_delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
    err = (delta - want_delta).abs().max().item()
    check(err <= 1e-4 * want_delta.abs().max().item(),
          f'delta disagrees with rowsum(dO * o) (max abs err {err:.3g})')
    errs['delta'] = err
    return errs


FLASH_EDGES = ((2, 256, 256, True, 128, 'causal S 256'),
               (2, 256, 256, False, 128, 'full S 256'),
               (2, 128, 256, True, 128, 'causal Sq 128 < Sk 256'),
               (2, 200, 200, True, 128, 'causal ragged S 200'))


def phase_flash(torch, dev, seed, report):
    """K4, K5a and K5b against their plain versions on both routes: f32
    edge cases at the 1e-4 bar, the same in bf16 plus a head_dim-64 case
    at the bf16 bar, then the training shapes in bf16, and times
    there."""
    from skypilot_tpu_torch.ops import flash_attention as fa
    edge_err = {'f32': 0.0, 'bf16': 0.0}
    for kind, dtype, extra in (
            ('f32', torch.float32, ()),
            ('bf16', torch.bfloat16,
             ((2, 256, 256, True, 64, 'causal S 256 head_dim 64'),))):
        for b, sq, sk, causal, d, tag in FLASH_EDGES + extra:
            errs = flash_check(torch, fa, flash_inputs(
                torch, dev, b, sq, sk, 16, dtype, seed, d), causal,
                kind == 'f32')
            edge_err[kind] = max(edge_err[kind], *(
                e for n, e in errs.items()
                if n != 'delta' and (kind == 'f32' or n != 'lse')))
            log(f'K4/K5 {kind} {tag}: max_abs_err ' +
                ', '.join(f'{n} {e:.3g}' for n, e in errs.items()))
    args = flash_inputs(torch, dev, 4, 2048, 2048, 16, torch.bfloat16, seed)
    errs = flash_check(torch, fa, args, True, False)
    log('K4/K5 bf16 B 4 x S 2048 x H 16 x D 128 causal: max_abs_err ' +
        ', '.join(f'{n} {e:.3g}' for n, e in errs.items()))
    q, k, v, do = args
    kw = dict(causal=True, scale=128**-0.5)
    o, lse = fa.flash_forward(q, k, v, **kw)
    costs = flash_costs(q, k, True)
    fwd_sets = copies_of((q, k, v), costs['flash_fwd'][0])
    bwd_sets = copies_of((q, k, v, o, lse, do), costs['flash_dq'][0])
    # K5b reads the delta K5a writes for the same inputs.
    dkv_sets = [a + (fa._flash_dq_cuda(*a, **kw)[1],) for a in bwd_sets]
    ms = {
        'flash_fwd': time_ms(lambda *a: fa._flash_fwd_cuda(*a, **kw),
                             fwd_sets, iters=20),
        'flash_dq': time_ms(lambda *a: fa._flash_dq_cuda(*a, **kw),
                            bwd_sets, iters=10),
        'flash_dkv': time_ms(lambda *a: fa._flash_dkv_cuda(*a, **kw),
                             dkv_sets, iters=20)}
    plain_fwd = time_ms(lambda *a: fa._plain_fwd(*a, **kw), fwd_sets,
                        iters=5)
    plain_bwd = time_ms(lambda *a: fa._plain_bwd(*a, **kw), bwd_sets,
                        iters=5)
    lib = flash_library_ms(torch, args)
    del fwd_sets, bwd_sets, dkv_sets
    for name, source, replaces in FLASH_ENTRIES:
        bound_ms, bound_by = bound(*costs[name], 'bfloat16')
        fwd = name == 'flash_fwd'
        entry = {
            'name': name, 'route': 'cuda', 'source': source,
            'replaces': replaces,
            'products': 'bf16 wgmma (f32 route: f32 CUDA cores)',
            'max_abs_err': errs['o'] if fwd else errs['dq'] if
            name == 'flash_dq' else max(errs['dk'], errs['dv']),
            'f32_max_abs_err': edge_err['f32'],
            'bf16_edge_max_abs_err': edge_err['bf16'], 'ms': ms[name],
            # The plain backward and the library's backward compute dQ,
            # dK and dV together: both K5 entries carry the pair's time.
            'plain_ms': plain_fwd if fwd else plain_bwd,
            'bound_ms': bound_ms, 'bound_by': bound_by,
            'library_ms': lib['fwd'] if fwd else lib['bwd'],
            'plain_and_library_cover': 'K4' if fwd else 'K5a + K5b '
            '(library: SDPA backward alone)'}
        if not fwd:
            entry['library_fwd_bwd_ms'] = lib['fwd_bwd']
        report.append(entry)
        note = '' if fwd else (f' (SDPA backward alone, for the K5 pair; '
                               f'fwd + bwd {lib["fwd_bwd"]:.4f})')
        log(f'{name} times (ms): kernel {ms[name]:.4f}, bound '
            f'{bound_ms:.4f} ({bound_by}); plain '
            f'{entry["plain_ms"]:.4f}, library {entry["library_ms"]:.4f}'
            f'{note}')
    log(f'K5 pair (K5a + K5b) {ms["flash_dq"] + ms["flash_dkv"]:.4f} ms '
        f'against SDPA backward alone {lib["bwd"]:.4f} ms')


def flash_library_ms(torch, args):
    """SDPA forward, SDPA backward alone (torch.autograd.grad on a graph
    kept from one forward per input copy, retain_graph) and SDPA forward
    + backward, on the same inputs in the library's [B, H, S, D] layout
    (laid out before the timing); causal."""
    import torch.nn.functional as F
    q, k, v, do = (x.transpose(1, 2).contiguous() for x in args)
    fwd = time_ms(lambda a, b, c: F.scaled_dot_product_attention(
        a, b, c, is_causal=True), copies_of((q, k, v), 3 * q.numel() * 2),
        iters=20)

    def fwd_bwd(a, b, c, g):
        out = F.scaled_dot_product_attention(a, b, c, is_causal=True)
        torch.autograd.grad(out, (a, b, c), g)

    leaves = tuple(x.requires_grad_(True) for x in (q, k, v)) + (do,)
    sets = copies_of(leaves, 4 * q.numel() * 2)
    both = time_ms(fwd_bwd, sets, iters=10)
    graphs = [(F.scaled_dot_product_attention(a, b, c, is_causal=True),
               (a, b, c), g) for a, b, c, g in sets]
    bwd = time_ms(lambda out, xs, g: torch.autograd.grad(
        out, xs, g, retain_graph=True), graphs, iters=20)
    return {'fwd': fwd, 'bwd': bwd, 'fwd_bwd': both}


# ------------------------------------------------------ training phases


def train_config(torch, llama, **kw):
    """``bench.py``'s default train preset (tpu_1b, bf16 params, full
    remat, loss_chunk 1024) at seq 2048."""
    d = dict(max_seq=2048, param_dtype=torch.bfloat16, remat=True,
             loss_chunk=1024)
    d.update(kw)
    return llama.LlamaConfig.tpu_1b(**d)


def phase_train(torch, dev, seed, card, profile_dir=None):
    """The training path at full width: tpu_1b, all 16 layers, bf16
    params, batch 4 x seq 2048, one fixed batch from the seed; a
    warm-up step, then 4 timed steps. Returns the launch counts of the
    timed steps."""
    from skypilot_tpu_torch.models import llama, train
    from skypilot_tpu_torch.ops import _build
    cfg = train_config(torch, llama)
    batch_size, seq, steps = 4, 2048, 4
    t0 = time.perf_counter()
    state, opt = train.init_train_state(cfg, seed, device=dev)
    torch.cuda.synchronize()
    n_params = llama.num_params(cfg)
    log(f'train: tpu_1b {cfg.n_layers} layers, d {cfg.dim}, '
        f'{cfg.n_heads}/{cfg.n_kv_heads} heads, {n_params / 1e9:.3f}B '
        f'params in bf16, AdamW; batch {batch_size} x seq {seq}; init '
        f'{time.perf_counter() - t0:.1f} s')
    step_fn = train.make_train_step(cfg, opt)
    g = torch.Generator(device=dev).manual_seed(seed + 5)
    batch = {'tokens': torch.randint(0, cfg.vocab_size,
                                     (batch_size, seq + 1), generator=g,
                                     device=dev)}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, m = step_fn(state, batch)            # warm-up
    torch.cuda.synchronize()
    log(f'train: warm-up step {time.perf_counter() - t0:.3f} s')
    metrics = [(m['loss'].item(), m['grad_norm'].item())]
    per_step, times = [], []
    names = ('flash_fwd', 'flash_dq', 'flash_dkv', 'flash_fwd.f32',
             'flash_dq.f32', 'flash_dkv.f32')
    _build.reset_launches()                      # counts start here ...
    for _ in range(steps):
        before = {n: _build.LAUNCHES[n] for n in names}
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        per_step.append({n: _build.LAUNCHES[n] - before[n] for n in names})
        metrics.append((m['loss'].item(), m['grad_norm'].item()))
    launches = dict(_build.LAUNCHES)             # ... and are read here
    step_s = sum(times) / steps
    tok_s = batch_size * seq / step_s
    # bench.py's count: 6 N for the matmuls forward and backward plus
    # 6 L S d for causal attention.
    flops_per_token = 6 * n_params + 6 * cfg.n_layers * seq * cfg.dim
    mfu = tok_s * flops_per_token / PEAK_OPS_PER_S['bfloat16']
    log(f'train: step times {[round(t, 4) for t in times]} s, mean '
        f'{step_s:.4f} s = {tok_s:.1f} tokens/s, MFU {100 * mfu:.2f}% of '
        f'the bf16 dense peak on {card}; peak memory '
        f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
    log('train: (loss, grad_norm) per step ' +
        ', '.join(f'({lo:.5f}, {gn:.4f})' for lo, gn in metrics))
    log(f'train: launches per step {per_step}, in all {launches}')
    check(all(math.isfinite(lo) and math.isfinite(gn) and gn > 0
              for lo, gn in metrics), 'a loss or grad_norm is not finite, '
          'or a grad_norm is 0')
    check(metrics[-1][0] < metrics[0][0],
          f'loss did not fall on the repeated batch: {metrics}')
    check(state.step == steps + 1, f'state.step is {state.step}')
    want = {'flash_fwd': 2 * cfg.n_layers, 'flash_dq': cfg.n_layers,
            'flash_dkv': cfg.n_layers, 'flash_fwd.f32': 0,
            'flash_dq.f32': 0, 'flash_dkv.f32': 0}
    check(all(p == want for p in per_step),
          f'launches per step {per_step}, want {want} (remat reruns K4; '
          'bf16 takes no f32 route)')
    if profile_dir:
        busy, _, _ = profile_run(torch, lambda: step_fn(state, batch),
                                 profile_dir, 'train')
        log(f'profile: device idle share of a training step '
            f'{1 - busy / step_s:.3f} (busy {busy:.3f} s against the mean '
            f'step {step_s:.3f} s)')
    del state, opt, step_fn
    torch.cuda.empty_cache()
    return launches


# Kernel functions whose SASS must hold HGMMA (wgmma): every
# instantiation of the bf16 routes of K1, K2, K3, K4, K5a and K5b, and
# Q1's wgmma route.
TENSOR_CORE_KERNELS = {
    'paged_decode': ('paged_decode_tc_kernel',),
    'verify_attention': ('verify_attention_tc_kernel',),
    'flash_fwd': ('flash_fwd_tc_kernel',),
    'flash_bwd': ('flash_dq_tc_kernel', 'flash_dkv_tc_kernel'),
    'chunk_prefill': ('chunk_prefill_tc_kernel',),
    'int8_matmul': ('int8_matmul_wgmma_kernel',),
}
# Kernel functions whose SASS must hold HMMA (mma.sync): Q1's mma.sync
# route, for the shapes a tensor map cannot take (N % 16 != 0, a
# misaligned q).
MMA_SYNC_KERNELS = {'int8_matmul': ('int8_matmul_mma_kernel',)}


def sass_functions(tool, path):
    """{kernel function: SASS lines} of one library, split at the
    ``Function :`` headers of ``cuobjdump -sass``."""
    out = subprocess.run([tool, '-sass', path], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    funcs, name = {}, None
    for line in out.splitlines():
        if 'Function : ' in line:
            name = line.split('Function : ', 1)[1].strip()
            funcs[name] = []
        elif name is not None:
            funcs[name].append(line)
    return funcs


def demangled(names, tool_dir):
    """Readable names through cu++filt where the toolkit has it."""
    filt = os.path.join(tool_dir, 'cu++filt')
    if not os.access(filt, os.X_OK):
        return dict(zip(names, names))
    out = subprocess.run([filt], input='\n'.join(names), capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return dict(zip(names, out.splitlines()))


def sass_counts():
    """Tensor-core instructions in each kernel function's SASS: HGMMA
    (wgmma) and HMMA (mma.sync), one line per function. Every
    instantiation of the bf16 kernels of paged_decode (K1),
    chunk_prefill (K2), verify_attention (K3), flash_fwd (K4) and
    flash_bwd (K5a and K5b) must hold HGMMA."""
    from skypilot_tpu_torch.ops import _build
    tool_dir = os.path.dirname(_build._nvcc())
    tool = os.path.join(tool_dir, 'cuobjdump')
    if not os.access(tool, os.X_OK):
        log(f'tensor-core instructions in SASS: not checked ({tool} '
            'missing)')
        return
    missing = []
    for lib in _build.SOURCES:
        funcs = sass_functions(tool, _build._lib_path(lib))
        names = demangled(sorted(funcs), tool_dir)
        required = [(key, 'HGMMA') for key in TENSOR_CORE_KERNELS.get(lib, ())]
        required += [(key, 'HMMA') for key in MMA_SYNC_KERNELS.get(lib, ())]
        found = {key: 0 for key, _ in required}
        for name in sorted(funcs):
            counts = {op: sum(op in line for line in funcs[name])
                      for op in ('HGMMA', 'HMMA')}
            log(f'  {lib}: {counts["HGMMA"]:4d} HGMMA, {counts["HMMA"]:3d} '
                f'HMMA  {names[name][:110]}')
            for key, op in required:
                if key in name:
                    found[key] += 1
                    if counts[op] == 0:
                        missing.append(f'{names[name]} (no {op})')
        missing += [f'{lib}: no {key} function'
                    for key, n in found.items() if n == 0]
    check(not missing, f'tensor-core instructions missing: {missing}')


def flat_params(tree, prefix=''):
    if isinstance(tree, dict):
        out = {}
        for key, val in tree.items():
            out.update(flat_params(val, f'{prefix}/{key}'))
        return out
    return {prefix: tree}


def phase_train_parity(torch, dev, seed):
    """tpu_1b width at depth 2 in f32, batch 2 x seq 256, 3 steps, with
    the kernels (attn_impl 'auto') against plain attention through
    autograd ('xla'), from the same weights. Bars: loss and grad_norm
    within rtol 1e-4 at every step; the first batch's gradient, leaf by
    leaf, within 1e-4 of the leaf's largest plain gradient; every
    parameter after step 1 within 1e-5 + 1e-4 |plain| wherever the
    plain gradient is at least 1e-6. Adam's first step moves a weight
    by lr * g / (|g| + 1e-8): where |g| is near 1e-8 that ratio
    magnifies the f32 rounding of g itself (seen on the CPU, where both
    runs are plain: g -8.0e-9 against -4.5e-9 moved a weight by 2.2e-5
    more), so there only |step difference| <= 2 lr is asked."""
    from skypilot_tpu_torch.models import llama, train
    from skypilot_tpu_torch.ops import _build
    cfgs = {impl: train_config(torch, llama, n_layers=2, max_seq=256,
                               param_dtype=torch.float32,
                               compute_dtype=torch.float32, attn_impl=impl)
            for impl in ('auto', 'xla')}
    g = torch.Generator(device=dev).manual_seed(seed + 7)
    batches = [{'tokens': torch.randint(0, cfgs['auto'].vocab_size,
                                        (2, 257), generator=g, device=dev)}
               for _ in range(3)]
    runs = {}
    for impl, cfg in cfgs.items():
        state, opt = train.init_train_state(cfg, seed + 8, device=dev)
        leaves = train._leaves(state.params)
        for p in leaves:
            p.requires_grad_(True)
        grads = torch.autograd.grad(
            llama.loss_fn(state.params, batches[0], cfg), leaves)
        grads = dict(zip(flat_params(state.params), grads))
        step = train.make_train_step(cfg, opt)
        _build.reset_launches()
        rows, after1 = [], None
        for i, batch in enumerate(batches):
            state, m = step(state, batch)
            rows.append((m['loss'].item(), m['grad_norm'].item()))
            if i == 0:
                after1 = {k: t.detach().clone()
                          for k, t in flat_params(state.params).items()}
        runs[impl] = (rows, grads, after1, dict(_build.LAUNCHES))
        del state, opt, step, leaves
    (k_rows, k_g, k_p, k_l), (x_rows, x_g, x_p, x_l) = (runs['auto'],
                                                        runs['xla'])
    rel = max(abs(a - b) / abs(b) for ka, xa in zip(k_rows, x_rows)
              for a, b in zip(ka, xa))
    g_err, p_err, tiny, ok_g, ok_p = 0.0, 0.0, 0, True, True
    lr = train.make_optimizer().lr
    for name, want in x_g.items():
        g_diff = (k_g[name] - want).abs().max().item()
        g_scale = want.abs().max().item()
        g_err = max(g_err, g_diff / max(g_scale, 1e-30))
        ok_g = ok_g and g_diff <= 1e-4 * g_scale
        diff = (k_p[name] - x_p[name]).abs()
        steady = want.abs() >= 1e-6
        p_err = max(p_err, diff[steady].max().item() if steady.any() else 0)
        tiny += int((~steady).sum())
        ok_p = ok_p and bool(
            (diff[steady] <= 1e-5 + 1e-4 * x_p[name].abs()[steady]).all()
            and (diff <= 2 * lr).all())
    log(f'train parity (depth 2, f32): (loss, grad_norm) kernels {k_rows} '
        f'vs plain {x_rows}, max rel diff {rel:.3g}; step-1 gradients max '
        f'diff {g_err:.3g} of the leaf scale; params after step 1 max abs '
        f'diff {p_err:.3g} where |g| >= 1e-6 ({tiny} elements below); '
        f'launches kernels {k_l}, plain {x_l}')
    check(rel <= 1e-4, f'loss/grad_norm differ by {rel:.3g} (bar 1e-4)')
    check(ok_g, 'step-1 gradients differ beyond 1e-4 of the leaf scale')
    check(ok_p, 'params after step 1 differ beyond their bar')
    check(k_l.get('flash_fwd', 0) == 3 * 2 * 2 and
          k_l.get('flash_dq', 0) == 3 * 2 and k_l.get('flash_dkv', 0) == 6,
          f'the kernel run launched {k_l}')
    check(all(k_l.get(f'{n}.f32', 0) == k_l[n]
              for n in ('flash_fwd', 'flash_dq', 'flash_dkv')),
          f'an f32 flash launch missed the f32 route: {k_l}')
    check(not x_l, f'the plain run launched {x_l}')
    del runs
    torch.cuda.empty_cache()


def phase_generate(torch, dev, parity):
    """Monolithic ``inference.generate`` (prefill through K4, then K1
    decode steps) on phase 6's model and prompts, greedy: its tokens
    must equal ``reference_generate``'s and the engine's."""
    from skypilot_tpu_torch.models import inference
    from skypilot_tpu_torch.ops import _build
    check(parity is not None, 'phase 6 did not hand over its model')
    cfg, params, toks, lengths, want, engine_tokens = parity
    _build.reset_launches()
    got = inference.generate(params, toks, lengths, cfg, 16,
                             max_seq=512).tolist()
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    same = sum(g == w for g, w in zip(got, want))
    log(f'generate (depth 2, f32): {same}/{len(want)} requests equal '
        f'reference_generate; launches {launches}')
    check(got == want, f'generate tokens {got} != reference {want}')
    check(got == engine_tokens, 'generate tokens != the engine\'s')
    check(launches.get('flash_fwd', 0) == cfg.n_layers ==
          launches.get('flash_fwd.f32', 0),
          f'K4 launched {launches.get("flash_fwd", 0)} times, want '
          f'{cfg.n_layers} (one prefill), all on the f32 route')
    check(launches.get('chunk_prefill.f32', 0) ==
          launches.get('chunk_prefill', 0),
          f'a f32 K2 launch missed the f32 route: {launches}')
    check(launches.get('paged_decode', 0) == 15 * cfg.n_layers,
          f'K1 launched {launches.get("paged_decode", 0)} times, want '
          f'15 decode steps x {cfg.n_layers}')


# ------------------------------------------------------------- int8 (Q1)

# Q1's shapes on the main path (Llama-3.1-8B): (leaf, K, N), and the rows
# M of a decode step (batch 8), a verify tick (8 x V 5), a batch-128
# step and a prefill chunk (2 rows x 128).
Q1_LEAVES = (('wq/wo', 4096, 4096), ('wk/wv', 4096, 1024),
             ('w_gate/w_up', 4096, 14336), ('w_down', 14336, 4096))
Q1_ROWS = (8, 40, 128, 256)
# tpu_1b's leaves and the rows the decode_w8 (batch 128) and serve_a8
# (decode batch 64, prefill chunk 256) shapes give them.
Q1_LEAVES_1B = (('wq/wo', 2048, 2048), ('wk/wv', 2048, 1024),
                ('w_gate/w_up', 2048, 8192), ('w_down', 8192, 2048))
Q1_ROWS_1B = (64, 128, 256)
# The lm_head (f32 output), one row, and a ragged N: (tag, M, K, N,
# f32 output).
Q1_EXTRA = (('lm_head M 8 (f32 out)', 8, 4096, 128256, True),
            ('M 1', 1, 4096, 4096, False),
            ('ragged N 1000, M 300', 300, 4096, 1000, False))
# One decoder layer's products in a decode step, in forward order, and
# the lm_head's: (leaf, K, N).
Q1_LAYER = (('wq', 4096, 4096), ('wk', 4096, 1024), ('wv', 4096, 1024),
            ('wo', 4096, 4096), ('w_gate', 4096, 14336),
            ('w_up', 4096, 14336), ('w_down', 14336, 4096))
Q1_HEAD = ('lm_head', 4096, 128256)
# tpu_1b's decode layer, the decode_w8 shape's products (batch 128).
Q1_LAYER_1B = (('wq', 2048, 2048), ('wk', 2048, 1024), ('wv', 2048, 1024),
               ('wo', 2048, 2048), ('w_gate', 2048, 8192),
               ('w_up', 2048, 8192), ('w_down', 8192, 2048))
# The timed layers: (model, layer, M) for every M the main path gives Q1
# -- an 8B decode step (batch 8), a verify tick (8 x V 5), a batch-128
# step, a prefill chunk -- and tpu_1b's decode_w8 step.
Q1_TIMED = (('8B', Q1_LAYER, 8), ('8B', Q1_LAYER, 40), ('8B', Q1_LAYER, 128),
            ('8B', Q1_LAYER, 256), ('tpu_1b', Q1_LAYER_1B, 128))
# qdot_a8's int32 products: (M, K, N); M 8 is padded to 17 rows.
INT_MM_SHAPES = ((8, 4096, 4096), (256, 4096, 14336), (256, 14336, 4096),
                 (300, 4096, 1000))


def q1_inputs(torch, dev, m, k, n, dtype, seed):
    """x ~ N(0, 1) (a normed activation), q uniform int8, scales around
    the born-int8 init's fan_in**-0.5 / 73.6: outputs O(1), as in the
    model."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
    q = torch.randint(-127, 128, (k, n), generator=gen, device=dev,
                      dtype=torch.int8)
    s = (0.5 + torch.rand((n,), generator=gen, device=dev)) * (
        k**-0.5 / 73.6116)
    return x, q, s


def q1_plan(im, x, q, route=None):
    """The wrapper's plan for these bf16 operands."""
    from skypilot_tpu_torch.ops import split_kv
    m, k = x.shape
    return im.plan(m, k, q.shape[1], split_kv.sm_count(x.device),
                   im.takes_tensor_map(q), route)


def q1_check(torch, x, q, s, tag, out_f32=False):
    """Q1 against its plain version; see ``phase_q1``. Returns the max
    abs error of the call's own output against the plain version's."""
    from skypilot_tpu_torch.ops import _build
    from skypilot_tpu_torch.ops import int8_matmul as im
    f32 = torch.float32
    _build.reset_launches()
    got = im.int8_matmul(x, q, s, f32 if out_f32 else None)
    launches = dict(_build.LAUNCHES)
    want = im.int8_matmul_reference(x, q, s, f32 if out_f32 else None)
    torch.cuda.synchronize()
    finite = bool(torch.isfinite(got.float()).all())
    bf16_route = q1_plan(im, x, q).route
    route = {'int8_matmul': 1,
             f'int8_matmul.{"f32" if x.dtype == f32 else bf16_route}': 1}
    check(launches == route, f'Q1 {tag}: launches {launches}, want {route}')
    err, ok = compare(got, want, bf16_bar=x.dtype != f32)
    if x.dtype == f32 or out_f32:
        log(f'Q1 {tag}: max_abs_err {err:.3g} (within bar: {ok}), finite '
            f'{finite}')
        check(ok and finite, f'Q1 {tag} disagrees with its plain version')
        return err
    # bf16 output: the product read as f32, then the rounding exactly.
    got_f32 = im.int8_matmul(x, q, s, f32)
    raw = im.int8_matmul(x, q, torch.ones_like(s), f32)
    want_f32 = im.int8_matmul_reference(x, q, s, f32)
    torch.cuda.synchronize()
    f32_err, f32_ok = compare(got_f32, want_f32)
    rounded = raw.to(torch.bfloat16) * s.to(torch.bfloat16)
    exact = torch.equal(got.view(torch.int16), rounded.view(torch.int16))
    beyond = int(((got.float() - want.float()).abs() >
                  1e-2 + 2**-7 * want.float().abs()).sum())
    differ = int((got != want).sum())
    log(f'Q1 {tag} ({bf16_route} route): product (f32 output) '
        f'max_abs_err {f32_err:.3g} (within bar: {f32_ok}); bf16 output = '
        f'the rounding of its own f32 sum: {exact}; against the plain bf16 '
        f'output max_abs_err {err:.3g}, {differ} of {got.numel()} differ, '
        f'{beyond} by more than one step (two roundings of sums in two '
        f'orders); finite {finite}')
    check(f32_ok and exact and finite,
          f'Q1 {tag} disagrees with its plain version')
    return err


def graph_ms(torch, fn, arg_sets, reps=20):
    """Device ms per call: ``reps`` calls (cycling through ``arg_sets``)
    captured in one CUDA graph, replayed 5 times between CUDA events, so
    the host's pace (a wrapper's Python) does not enter."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in arg_sets[:2]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(*arg_sets[i % len(arg_sets)])
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (5 * reps)


def q1_times(torch, dev, m, k, n, seed, out_f32=False, route=None,
             plain=False):
    """Device ms of one Q1 call at (m, k, n) on the bf16 route ``route``
    forces (None: the planned one), of the library call computing the
    same function and of a dense bf16 matmul of that shape, and, with
    ``plain``, of Q1's plain version; the bound (bytes over 3.35 TB/s or
    2 m k n operations over the bf16 peak: the products run in bf16)
    and what sets it; the plan (tile, splits). Each time is a CUDA graph
    of calls over copies of the inputs that overflow the L2 cache."""
    from skypilot_tpu_torch.ops import _build
    from skypilot_tpu_torch.ops import int8_matmul as im
    out_dtype = torch.float32 if out_f32 else None
    x, q, s = q1_inputs(torch, dev, m, k, n, torch.bfloat16, seed)
    nbytes = (x.numel() * 2 + q.numel() + s.numel() * 4 +
              m * n * (4 if out_f32 else 2))
    sets = copies_of((x, q, s), nbytes)
    before = dict(_build.LAUNCHES)
    if route is None:
        call = lambda a, b, c: im.int8_matmul(a, b, c, out_dtype)  # noqa
    else:
        call = lambda a, b, c: im._int8_matmul_cuda(  # noqa
            a, b, c, out_dtype, route)
    out = {'ms': graph_ms(torch, call, sets)}
    if plain:
        out['plain_ms'] = graph_ms(torch, lambda a, b, c: (
            im.int8_matmul_reference(a, b, c, out_dtype)), sets[:2], reps=4)
    # The library call computing the same function: cast the weight,
    # multiply, scale (it writes the bf16 copy Q1 never writes).
    out['library_ms'] = graph_ms(torch, lambda a, b, c: (
        torch.matmul(a, b.to(torch.bfloat16)) * c).to(out_dtype or a.dtype),
        sets[:2], reps=4)
    dense = [(x, torch.randn((k, n), device=dev).to(torch.bfloat16))
             for _ in range(min(len(sets), 4))]
    out['dense_ms'] = graph_ms(torch, torch.matmul, dense)
    _build.LAUNCHES.clear()               # timing launches count nowhere
    _build.LAUNCHES.update(before)
    out['bound_ms'], out['bound_by'] = bound(nbytes, 2 * m * k * n,
                                             'bfloat16')
    p = q1_plan(im, x, q, route)
    out['plan'] = f'{p.route} tile {p.m_tile} split {p.splits}'
    del sets, dense
    return out


def q1_layer(torch, dev, layer, m, seed, route=None):
    """One decoder layer's seven products at M ``m`` (``q1_times`` of
    each distinct shape, summed over the layer): Q1, library, dense and
    bound ms, what sets the bound (or 'both'), and each leaf's plan."""
    shapes = {}
    for _, k, n in layer:
        if (k, n) not in shapes:
            shapes[(k, n)] = q1_times(torch, dev, m, k, n, seed, route=route)
    out = {key: sum(shapes[(k, n)][key] for _, k, n in layer)
           for key in ('ms', 'library_ms', 'dense_ms', 'bound_ms')}
    by = {shapes[(k, n)]['bound_by'] for _, k, n in layer}
    out['bound_by'] = by.pop() if len(by) == 1 else 'both'
    out['plans'] = {leaf: shapes[(k, n)]['plan'] for leaf, k, n in layer}
    return out


def phase_q1(torch, dev, seed, report):
    """11a. Q1 against its plain version at every shape the paths this
    script drives give it: the 8B leaves (wq/wo, wk/wv, w_gate/w_up,
    w_down) at M 8, 40, 128 and 256, tpu_1b's at M 64, 128 and 256
    (serve_a8's decode and prefill, decode_w8), the lm_head (M 8, N
    128256) with its f32 output, M 1, and a ragged N (M 300, N 1000: the
    mma.sync route), on every route. f32 x (CUDA cores): |kernel -
    plain| <= 1e-4. bf16 x (tensor cores): the product read as f32
    within 1e-2 + 2^-7 |plain|, and the bf16 output bit for bit the
    reference's rounding of the kernel's own f32 sum (the sum rounded to
    bf16, times the scale rounded to bf16, rounded again); the bf16
    output's distance to the plain version's is printed, not held to the
    one-step bar: two sums in different orders round to neighbouring
    bf16 values now and then, and the second rounding can widen that to
    two steps. Each call must count its planned route. Then device times
    (a CUDA graph of 20 calls) of one decoder layer's seven products at
    every M the main path gives Q1 (``Q1_TIMED``: the 8B layer at M 8,
    40, 128 and 256, tpu_1b's at 128): Q1, the library call
    ``torch.matmul(x, q.to(bf16)) * s``, a dense bf16 ``torch.matmul`` of
    the same shapes, the bound and its share reached, and each leaf's
    plan; the lm_head; and the dense lm_head the way the bf16 main path
    runs it (``qdot`` with an f32 result: cuBLAS sums the bf16 operands
    into f32, P5) beside the bf16-out ``torch.matmul``, at M 8 and
    256."""
    from skypilot_tpu_torch.models import quantization
    entry = {'name': 'int8_matmul', 'route': 'cuda',
             'source': 'skypilot_tpu_torch/ops/csrc/int8_matmul.cu',
             'replaces': 'skypilot_tpu/models/quantization.py:146 (qdot: '
                         'XLA fuses the int8 convert into the dot; no '
                         'Pallas kernel)',
             'products': 'bf16 wgmma m64nMTk16 (q^T from registers, '
                         'converted once; x by TMA), split-K summed in the '
                         'kernel; mma.sync m16n8k16 where a tensor map '
                         'cannot take q (f32 route: f32 CUDA cores)'}
    cases = ([(f'{leaf} M {m}', m, k, n, False)
              for leaf, k, n in Q1_LEAVES for m in Q1_ROWS] +
             [(f'tpu_1b {leaf} M {m}', m, k, n, False)
              for leaf, k, n in Q1_LEAVES_1B for m in Q1_ROWS_1B] +
             list(Q1_EXTRA))
    errs = {}
    for i, (tag, m, k, n, out_f32) in enumerate(cases):
        for route in ('f32', 'bf16'):
            if route == 'f32' and out_f32:
                continue
            dtype = torch.float32 if route == 'f32' else torch.bfloat16
            x, q, s = q1_inputs(torch, dev, m, k, n, dtype, seed + i)
            errs[(tag, route)] = q1_check(torch, x, q, s, f'{tag} {route}',
                                          out_f32)
            del x, q, s
    layers = {}
    for model, layer, m in Q1_TIMED:
        t = q1_layer(torch, dev, layer, m, seed)
        layers[f'{model} M {m}'] = t
        plans = ', '.join(f'{leaf} {plan}'
                          for leaf, plan in t['plans'].items())
        log(f'Q1, one {model} decode layer\'s seven products at M {m}: '
            f'kernel {t["ms"]:.4f} ms ({1e3 * t["ms"] / 7:.1f} us a launch), '
            f'bound {t["bound_ms"]:.4f} ({t["bound_by"]}; '
            f'{100 * t["bound_ms"] / t["ms"]:.1f}% of it reached), library '
            f'(matmul(x, q.to(bf16)) * s) {t["library_ms"]:.4f}, dense bf16 '
            f'matmul {t["dense_ms"]:.4f}; plans: {plans}')
    main = q1_times(torch, dev, 8, 4096, 14336, seed, plain=True)
    head = q1_times(torch, dev, 8, *Q1_HEAD[1:], seed, out_f32=True)
    log(f'Q1 times at M 8, K 4096, N 14336 (w_gate): kernel '
        f'{main["ms"]:.4f} ms, plain {main["plain_ms"]:.4f}, library '
        f'{main["library_ms"]:.4f}, dense bf16 {main["dense_ms"]:.4f}, '
        f'bound {main["bound_ms"]:.4f} ({main["bound_by"]}); '
        f'{4096 * 14336 / main["ms"] / 1e6:.0f} GB/s of weight; lm_head M 8 '
        f'(f32 out): kernel {head["ms"]:.4f}, bound {head["bound_ms"]:.4f}, '
        f'library {head["library_ms"]:.4f}, dense bf16 {head["dense_ms"]:.4f}')
    head_f32 = {}
    for m in (8, 256):
        _, k, n = Q1_HEAD
        dense = [(torch.randn((m, k), device=dev).to(torch.bfloat16),
                  torch.randn((k, n), device=dev).to(torch.bfloat16))
                 for _ in range(4)]
        head_f32[m] = (graph_ms(torch, lambda a, b: quantization.qdot(
            a, b, torch.bfloat16, preferred=torch.float32), dense),
            graph_ms(torch, torch.matmul, dense))
        log(f'dense lm_head at M {m}, K {k}, N {n}: f32 sum of the bf16 '
            f'operands (qdot, P5) {head_f32[m][0]:.4f} ms, bf16-out '
            f'torch.matmul {head_f32[m][1]:.4f} ms')
        del dense
    layer = layers['8B M 8']
    entry.update(max_abs_err=errs[('w_gate/w_up M 8', 'bf16')],
                 f32_max_abs_err=errs[('w_gate/w_up M 8', 'f32')],
                 ms=main['ms'], plain_ms=main['plain_ms'],
                 bound_ms=main['bound_ms'], bound_by=main['bound_by'],
                 library_ms=main['library_ms'],
                 shape='M 8, K 4096, N 14336 (w_gate), bf16',
                 dense_bf16_ms=main['dense_ms'],
                 layer_ms=layer['ms'], layer_bound_ms=layer['bound_ms'],
                 layer_dense_bf16_ms=layer['dense_ms'],
                 layers={tag: {key: t[key] for key in (
                     'ms', 'bound_ms', 'bound_by', 'library_ms', 'dense_ms',
                     'plans')} for tag, t in layers.items()},
                 lm_head_ms=head['ms'], lm_head_bound_ms=head['bound_ms'],
                 lm_head_library_ms=head['library_ms'],
                 lm_head_dense_bf16_ms=head['dense_ms'],
                 lm_head_dense_f32_sum_ms=head_f32[8][0])
    report.append(entry)
    torch.cuda.empty_cache()


def phase_int_mm(torch, dev, seed):
    """11b. ``qdot_a8`` on the card: the int32 product of
    ``torch._int_mm`` (8 rows padded to the 17 it takes) equals the
    exact product (f64, exact at these sizes) bit for bit at M 8, 256
    and 300, and the f32 epilogue ``y * sx * s`` is within 1e-6
    relative of the same product taken in f64."""
    from skypilot_tpu_torch.models import quantization as qz
    from skypilot_tpu_torch.ops import _build
    for i, (m, k, n) in enumerate(INT_MM_SHAPES):
        x, q, s = q1_inputs(torch, dev, m, k, n, torch.bfloat16, seed + i)
        leaf = {'q': q, 's': s}
        xf = x.float()
        sx = torch.clamp(xf.abs().amax(-1, keepdim=True) / 127.0, min=1e-8)
        xq = torch.round(xf / sx).clamp(-127, 127).to(torch.int8)
        _build.reset_launches()
        y = qz._int_mm(xq, q)
        out = qz.qdot_a8(x, leaf, torch.bfloat16, preferred=torch.float32)
        launches = dict(_build.LAUNCHES)
        exact = (xq.double() @ q.double())
        plain = exact * sx.double() * s.double()
        torch.cuda.synchronize()
        same = torch.equal(y.double(), exact)
        rel = ((out.double() - plain).abs() /
               plain.abs().clamp(min=1e-30)).max().item()
        log(f'qdot_a8 M {m}, K {k}, N {n}: int32 product equals the exact '
            f'one: {same}; epilogue max relative error {rel:.3g}; '
            f'launches {launches}')
        check(same and y.dtype == torch.int32,
              f'qdot_a8 M {m}: the int32 product is not exact')
        check(rel <= 1e-6, f'qdot_a8 M {m}: epilogue off by {rel:.3g}')
        check(launches == {'torch._int_mm': 2},
              f'qdot_a8 M {m}: launches {launches}')
        del x, q, s, leaf, exact, plain
    torch.cuda.empty_cache()


def reprefill_oracle(torch, inference, params, cfg, prompts, max_new):
    """Greedy tokens of the cache-free oracle for int8 weights: the
    monolithic ``prefill`` over the growing sequences (the reference's own
    oracle for quantized weights, tests/unit_tests/test_quantization.py),
    all prompts right-padded in one batch."""
    dev = params['lm_head']['q'].device
    width = max(map(len, prompts)) + max_new
    buf = torch.zeros((len(prompts), width), dtype=torch.int64, device=dev)
    for i, p in enumerate(prompts):
        buf[i, :len(p)] = torch.tensor(p, device=dev)
    cur = [len(p) for p in prompts]
    out = [[] for _ in prompts]
    rows = torch.arange(len(prompts), device=dev)
    for _ in range(max_new):
        logits, _ = inference.prefill(params, buf[:, :max(cur) + 1], cur,
                                      cfg, max_seq=max(cur) + 1)
        nxt = torch.argmax(logits, -1)
        buf[rows, torch.tensor(cur, device=dev)] = nxt
        for i, t in enumerate(nxt.tolist()):
            out[i].append(t)
        cur = [c + 1 for c in cur]
    return out


def phase_int8_parity(torch, dev, seed):
    """11c. Parity at depth 2 in f32: phase 6's model (8B width, 2
    layers, its prompts of 37, 127, 129 and 250 tokens) quantized by the
    port's ``quantize_params``, 16 greedy tokens a request. The engine
    with ``weight_quant=True`` (on the dense tree) must give the
    re-prefill oracle's tokens and ``generate``'s; an int8-KV engine must
    finish every request through K1's and K2's int8 branches (its tokens
    against the oracle's are printed: int8 KV is another computation);
    speculation (prompt lookup, then the oracle's tokens as drafts
    through K3) must give the spec-off tokens; the prefix cache (page 8,
    chunk 8, a shared 32-token prefix) must give the tokens of the cache
    off; with ``prefill_a8`` the engine's tokens must equal
    ``generate``'s with ``prefill_a8`` (per-token scales do not depend
    on the chunking); ``generate(attn_impl='lax')`` must give
    ``attn_impl='paged'``'s tokens. Every Q1 launch is on the f32
    route."""
    import dataclasses

    import numpy as np

    from skypilot_tpu_torch.models import inference, llama
    from skypilot_tpu_torch.models import quantization as qz
    from skypilot_tpu_torch.models.serving_engine import (Request,
                                                          ServingEngine)
    cfg = llama.LlamaConfig.llama3_8b(n_layers=2, max_seq=512,
                                      param_dtype=torch.float32,
                                      compute_dtype=torch.float32)
    params = llama.init_params(cfg, seed + 2, device=dev)
    qp = qz.quantize_params(params)
    log(f'int8 parity: quantized {qz.quantized_bytes(params) / 2**30:.2f} '
        f'GiB of f32 weights into {qz.quantized_bytes(qp) / 2**30:.2f} GiB')
    prompts = random_prompts([37, 127, 129, 250], cfg.vocab_size, seed + 3)
    lengths = [len(p) for p in prompts]
    toks = torch.zeros((len(prompts), max(lengths)), dtype=torch.int64,
                       device=dev)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.tensor(p, device=dev)
    want = reprefill_oracle(torch, inference, qp, cfg, prompts, 16)
    gen = {impl: inference.generate(qp, toks, lengths, cfg, 16, max_seq=512,
                                    attn_impl=impl).tolist()
           for impl in ('paged', 'lax')}
    log(f'int8 parity: generate (paged) equals the oracle on '
        f'{sum(g == w for g, w in zip(gen["paged"], want))}/{len(want)}, '
        f'lax equals paged: {gen["lax"] == gen["paged"]}')
    check(gen['paged'] == want, f'generate {gen["paged"]} != oracle {want}')
    check(gen['lax'] == gen['paged'], 'generate: lax tokens != paged tokens')

    def run(tag, tree, run_cfg, reqs, lookup=None, **kw):
        geo = dict(batch_size=4, max_prompt=256, max_seq=512,
                   prefill_chunk=128, prefill_budget=256, decode_chunk=8)
        geo.update(kw)
        eng = ServingEngine(tree, run_cfg, device=dev, **geo)
        warm(torch, eng, tag)
        if lookup is not None:
            eng._lookup = lookup
        res, _, launches, _ = serve(torch, eng, reqs, tag)
        got = [res[r.request_id].tokens for r in reqs]
        check(all(len(g) == r.max_new for g, r in zip(got, reqs)),
              f'{tag}: a request did not finish')
        check(launches.get('int8_matmul', 0) ==
              launches.get('int8_matmul.f32', 0) > 0,
              f'{tag}: a Q1 launch missed the f32 route: {launches}')
        return got, launches, eng

    def reqs16():
        return [Request(i, p, max_new=16) for i, p in enumerate(prompts)]

    got, launches, _ = run('int8 parity (weight_quant)', params, cfg,
                           reqs16(), weight_quant=True)
    log(f'int8 parity (weight_quant): {sum(g == w for g, w in zip(got, want))}'
        f'/{len(want)} requests equal the re-prefill oracle; launches '
        f'{launches}')
    check(got == want, f'weight_quant engine {got} != oracle {want}')
    q8, launches, _ = run('int8 parity (int8 KV)', qp, cfg, reqs16(),
                          kv_quant=True)
    log(f'int8 parity (int8 KV): {sum(g == w for g, w in zip(q8, want))}/'
        f'{len(want)} requests equal the f32-KV oracle; launches {launches}')
    check(launches.get('paged_decode.int8', 0) > 0 and
          launches.get('chunk_prefill.int8', 0) > 0,
          'int8 parity: the int8-KV pass did not run the int8 branches')
    for name, lookup in (('prompt lookup', None),
                         ('oracle drafts', oracle_lookup(prompts, want))):
        tag = f'int8 parity (spec, {name})'
        spec, launches, eng = run(tag, qp, cfg, reqs16(), lookup,
                                  spec_decode=True, spec_k=4)
        log(f'{tag}: equal to spec off: {spec == got}; spec_stats '
            f'{eng.spec_stats()}; launches {launches}')
        check(spec == got, f'{tag}: tokens {spec} != spec off {got}')
        check(name != 'oracle drafts' or
              launches.get('verify_attention.f32', 0) > 0,
              f'{tag}: K3 did not run: {launches}')
    rng = np.random.default_rng(seed + 12)
    base = rng.integers(0, cfg.vocab_size, 32).tolist()
    shared = [base, base, base[:16] + rng.integers(0, cfg.vocab_size,
                                                   12).tolist()]
    pre = {}
    for on in (True, False):
        tag = f'int8 parity (prefix cache {"on" if on else "off"})'
        eng_kw = dict(batch_size=2, max_prompt=64, max_seq=128,
                      prefill_chunk=8, prefill_budget=16, decode_chunk=4,
                      page=8, prefix_cache=on, prefix_pool_pages=16)
        eng = ServingEngine(qp, cfg, device=dev, **eng_kw)
        warm(torch, eng, tag)
        pre[on] = []
        for i, p in enumerate(shared):     # one at a time: publish, hit
            res, _, _, _ = serve(torch, eng, [Request(i, p, max_new=8)], tag)
            pre[on].append(res[i].tokens)
        log(f'{tag}: prefix {eng.prefix and eng.prefix.stats()}')
        if on:
            check(eng.prefix.stats()['hits'] > 0, f'{tag}: no hit')
    check(pre[True] == pre[False], f'int8 parity: prefix cache on '
          f'{pre[True]} != off {pre[False]}')
    cfg_a8 = dataclasses.replace(cfg, prefill_a8=True)
    a8_gen = inference.generate(qp, toks, lengths, cfg_a8, 16,
                                max_seq=512).tolist()
    a8, launches, _ = run('int8 parity (prefill_a8)', qp, cfg_a8, reqs16())
    log(f'int8 parity (prefill_a8): engine equals generate with prefill_a8 '
        f'on {sum(g == w for g, w in zip(a8, a8_gen))}/{len(a8)}; equals '
        f'the weight-only tokens on {sum(g == w for g, w in zip(a8, want))}'
        f'/{len(a8)}; launches {launches}')
    check(a8 == a8_gen, f'prefill_a8 engine {a8} != generate {a8_gen}')
    check(launches.get('torch._int_mm', 0) > 0,
          f'prefill_a8: no torch._int_mm launch: {launches}')
    del params, qp
    torch.cuda.empty_cache()


def phase_int8_main_path(torch, dev, seed, card, bf16_rate, profile_dir):
    """11d. The main path on int8 weights at full width:
    ``LlamaConfig.llama3_8b(max_seq=1024)`` born int8 from ``--seed``
    (``init_quantized_params``: no dense tree is made), bf16 compute,
    phase 5's engine geometry and requests, captured ticks. Gates: every
    request gets its 32 tokens; captures equal the keys, none after
    warmup; Q1 launches equal the forward passes the schedule ran
    (decode steps + prefill ticks) x (7 x 32 + 1), all on the bf16
    route; K1 and K2 launch as in phase 5. Printed: output tokens/s
    beside phase 5's bf16 run of this call, the weight bytes int8 and
    bf16, the device ms of one decode step (one ``decode_step`` captured
    and replayed at batch 8 on a cache holding 512 tokens a row), Q1's
    share of device time in a profiled repeat, the graph pool, the peak
    memory. Returns {'int8_matmul': Q1's launches}."""
    import numpy as np

    from skypilot_tpu_torch import metrics
    from skypilot_tpu_torch.models import inference, llama
    from skypilot_tpu_torch.models import quantization as qz
    from skypilot_tpu_torch.models.serving_engine import (Request,
                                                          ServingEngine)
    cfg = llama.LlamaConfig.llama3_8b(max_seq=1024,
                                      param_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = qz.init_quantized_params(cfg, seed, device=dev)
    torch.cuda.synchronize()
    q_bytes = qz.quantized_bytes(params)
    d_bytes = 2 * llama.num_params(cfg)
    log(f'int8 main path: llama3_8b born int8 in '
        f'{time.perf_counter() - t0:.1f} s: {q_bytes / 1e9:.3f} GB of '
        f'weights (bf16: {d_bytes / 1e9:.3f} GB); memory allocated '
        f'{torch.cuda.memory_allocated() / 2**30:.2f} GiB')
    lengths = np.random.default_rng(seed + 1).integers(100, 513, 12)
    prompts = random_prompts(lengths, cfg.vocab_size, seed + 1)
    tag = 'int8 main path'
    eng = ServingEngine(params, cfg, batch_size=8, max_prompt=512,
                        prefill_chunk=128, prefill_budget=256,
                        decode_chunk=8, weight_quant=True, device=dev)
    check(eng.params is params, f'{tag}: the born-int8 tree was copied')
    warm(torch, eng, tag)
    reqs = [Request(i, p, max_new=32) for i, p in enumerate(prompts)]
    steps0, ticks0 = eng.decode_steps_total, eng.prefill_ticks
    torch.cuda.reset_peak_memory_stats()
    metrics.REGISTRY.reset()
    res, wall, launches, n_ticks = serve(torch, eng, reqs, tag)
    steps = eng.decode_steps_total - steps0
    ticks = eng.prefill_ticks - ticks0
    out_toks = sum(len(r.tokens) for r in res.values())
    rate = out_toks / wall
    log(f'{tag}: {len(res)} requests, {out_toks} output tokens in '
        f'{wall:.3f} s = {rate:.1f} output tokens/s on {card} (bf16 main '
        f'path, phase 5 of this call: '
        + (f'{bf16_rate:.1f}' if bf16_rate else 'not run')
        + f'); {n_ticks} ticks ({steps} decode steps, {ticks} prefill '
        f'ticks); peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f}'
        f' GiB; launches {launches}')
    check(len(res) == 12 and all(
        r.status == 'finished' and len(r.tokens) == 32 and
        all(0 <= t < cfg.vocab_size for t in r.tokens)
        for r in res.values()), f'a {tag} request did not finish with 32 '
          'tokens')
    n_l = cfg.n_layers
    want_q1 = (steps + ticks) * (7 * n_l + 1)
    check(launches.get('int8_matmul', 0) == want_q1 > 0 and
          'int8_matmul.f32' not in launches,
          f'{tag}: Q1 launched {launches.get("int8_matmul", 0)} times, want '
          f'({steps} + {ticks}) x {7 * n_l + 1} on the bf16 route')
    check(launches.get('paged_decode', 0) == steps * n_l > 0 and
          launches.get('chunk_prefill', 0) == ticks * n_l > 0 and
          not any(k.endswith('.f32') for k in launches),
          f'{tag}: K1/K2 launches {launches}, want {steps} x {n_l} and '
          f'{ticks} x {n_l}, none on the f32 route')
    latency_line(tag, card)
    idle, host_ms = profile_serve(torch, eng, prompts, profile_dir, tag,
                                  wall, n_ticks)
    groups = LAST_PROFILE.get('groups', {})
    busy_ms = sum(ms for ms, _ in groups.values())
    q1_ms = sum(ms for g, (ms, _) in groups.items() if g.startswith('Q1'))
    log(f'{tag}: Q1 {q1_ms:.1f} ms of {busy_ms:.1f} ms device time in the '
        f'profiled repeat ({100 * q1_ms / max(busy_ms, 1e-9):.1f}%); idle '
        f'share {idle:.3f}, host {host_ms:.2f} ms per tick; Q1 launches by '
        f'pass: {steps * (7 * n_l + 1)} in decode steps (M 8), '
        f'{ticks * (7 * n_l + 1)} in prefill ticks (M 256, lm_head on the '
        f'chunk\'s last rows); by route: '
        + ', '.join(f'{k} {v}' for k, v in sorted(launches.items())
                    if k.startswith('int8_matmul.')))
    del eng
    torch.cuda.empty_cache()
    # One decode step at batch 8, 512 tokens a row, captured and
    # replayed: the device ms a step.
    step_ms = decode_step_ms(torch, inference, params, cfg, dev, batch=8,
                             context=512, max_seq=1024, steps=32,
                             kv_quant=False, seed=seed)
    log(f'{tag}: one decode step (batch 8, 512 tokens a row, int8 '
        f'weights) {step_ms:.3f} device ms; its weight bytes alone bound '
        f'it at {(q_bytes - cfg.vocab_size * cfg.dim) / 3.35e9:.3f} ms')
    del params
    torch.cuda.empty_cache()
    return {'int8_matmul': launches.get('int8_matmul', 0)}


def random_cache(torch, inference, cfg, dev, batch, context, max_seq,
                 kv_quant, seed):
    """A cache whose first ``context`` slots of every row hold random K/V
    (int8 payloads with bf16 scales for ``kv_quant``) and are readable:
    the state a decode step meets after a prefill of that length."""
    cache = inference.make_cache(cfg, batch, max_seq, base=context,
                                 kv_quant=kv_quant, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)
    for f in ('k', 'v'):
        for li in range(cfg.n_layers):
            part = cache[f][li, :, :context]
            if kv_quant:
                part.copy_(torch.randint(-127, 128, part.shape, generator=gen,
                                         device=dev, dtype=torch.int8))
                cache[f'{f}_scale'][li, :, :context].copy_(
                    torch.rand(part.shape[:-1], generator=gen, device=dev)
                    * 0.007 + 0.001)
            else:
                part.copy_(torch.randn(part.shape, generator=gen,
                                       device=dev))
    cache['dmask'][:, :context] = True
    cache['length'].fill_(context)
    return cache


def decode_step_ms(torch, inference, params, cfg, dev, batch, context,
                   max_seq, steps, kv_quant, seed, profile_tag=None):
    """Device ms of one ``decode_step`` at ``batch`` rows on a cache of
    ``context`` live tokens a row: the step captured once with
    ``_build.capture`` (after one eager step that loads the kernels) and
    replayed ``steps`` times between CUDA events; each replay writes the
    next slot (the write slot comes from the cache's device ``steps``).
    Checks finite logits and the launches per replay. With
    ``profile_tag``, ``steps`` more replays run under torch.profiler
    (``profile_run``: device time by kernel group) and the profiled
    replays' device idle share is logged; the cache must hold
    ``context + 2 * steps`` slots then."""
    from skypilot_tpu_torch.ops import _build
    cache = random_cache(torch, inference, cfg, dev, batch, context,
                         max_seq, kv_quant, seed)
    tok = torch.randint(0, cfg.vocab_size, (batch,), device=dev,
                        dtype=torch.int32)
    inference.decode_step(params, cache, tok, cfg)          # eager: loads
    cache['steps'].zero_()
    cache['dmask'][:, context:] = False
    cache['length'].fill_(context)
    torch.cuda.synchronize()
    graph = _build.capture(lambda: inference.decode_step(
        params, cache, tok, cfg)[0])
    _build.reset_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(steps):
        logits = graph.replay()
    end.record()
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    check(bool(torch.isfinite(logits).all()), 'decode step: logits not '
          'finite')
    check(int(cache['steps']) == steps, 'decode step: the replays did not '
          'advance the write slot')
    check(launches.get('paged_decode', 0) == steps * cfg.n_layers,
          f'decode step: launches {launches}')
    if profile_tag:
        busy, wall, _ = profile_run(
            torch, lambda: [graph.replay() for _ in range(steps)], None,
            profile_tag)
        log(f'{profile_tag}: {steps} profiled replays, device busy '
            f'{busy * 1e3:.3f} ms of {wall * 1e3:.3f} ms wall: idle share '
            f'{1 - busy / wall:.3f}')
    del graph, cache
    return start.elapsed_time(end) / steps


def phase_decode_w8(torch, dev, seed, card):
    """11e. ``bench.py``'s decode_w8 shape (``bench.py:222-247``):
    tpu_1b width and depth, batch 128, int8 KV, context 1024, headroom
    256 (max_seq 1280), 64 decode steps: one ``decode_step`` captured and
    replayed 64 times, with int8 weights (born int8) and with bf16
    weights in the same call. Prints tokens/s, ms a step and the bound
    of a step: the weight bytes it reads (every matmul weight and the
    lm_head; the embedding's 128 rows) plus the cache bytes (K and V and
    their scales of the live slots, 1056 on average) over 3.35 TB/s."""
    from skypilot_tpu_torch.models import inference, llama
    from skypilot_tpu_torch.models import quantization as qz
    from skypilot_tpu_torch.ops import _build
    cfg = llama.LlamaConfig.tpu_1b(max_seq=1280, param_dtype=torch.bfloat16)
    batch, context, steps = 128, 1024, 64     # 1024 + 2 x 64 <= 1280
    live = context + (steps - 1) / 2
    cache_bytes = (2 * cfg.n_layers * batch * live * cfg.n_kv_heads *
                   (cfg.head_dim + 2))
    out = {}
    for kind in ('int8', 'bf16'):
        params = (qz.init_quantized_params(cfg, seed, device=dev)
                  if kind == 'int8' else
                  llama.init_params(cfg, seed, device=dev))
        emb = params['tok_emb']
        emb_bytes = qz.quantized_bytes(emb)
        w_bytes = qz.quantized_bytes(params) - emb_bytes + \
            emb_bytes * batch // cfg.vocab_size
        _build.reset_launches()
        tag = f'decode_w8 shape ({kind} weights, int8 KV)'
        ms = decode_step_ms(torch, inference, params, cfg, dev, batch,
                            context, 1280, steps, kv_quant=True, seed=seed,
                            profile_tag=tag)
        groups = LAST_PROFILE.get('groups', {})
        busy_ms = sum(t for t, _ in groups.values())
        split = {}
        for group, (t, n) in groups.items():
            key = ('Q1' if group.startswith('Q1') else
                   group if group.startswith(('K1', 'matmul')) else
                   'other PyTorch kernels')
            split[key] = (split.get(key, (0.0, 0))[0] + t / steps,
                          split.get(key, (0.0, 0))[1] + n / steps)
        log(f'{tag}: device ms a step by group (profiled replays): '
            + ', '.join(f'{key} {t:.3f} ms ({n:.0f} kernels, '
                        f'{100 * t * steps / max(busy_ms, 1e-9):.1f}%)'
                        for key, (t, n) in sorted(split.items(),
                                                  key=lambda kv: -kv[1][0])))
        bound_ms = (w_bytes + cache_bytes) / HBM_BYTES_PER_S * 1e3
        out[kind] = ms
        log(f'{tag}: {ms:.3f} ms a step '
            f'= {batch / ms * 1e3:.0f} tokens/s on {card}; bound '
            f'{bound_ms:.3f} ms ({w_bytes / 1e9:.3f} GB of weights + '
            f'{cache_bytes / 1e9:.3f} GB of cache)')
        del params, emb
        torch.cuda.empty_cache()
    log(f'decode_w8 shape: int8 weights {out["int8"]:.3f} ms, bf16 '
        f'{out["bf16"]:.3f} ms a step in the same call '
        f'({out["bf16"] / out["int8"]:.2f}x)')


def phase_serve_a8(torch, dev, seed, card):
    """11f. ``bench.py``'s serve_a8 shape (``bench.py:560-600``): tpu_1b
    born int8, int8 KV, batch 64, max_prompt 1024, max_seq 1024 + 4 x
    128, max_new 128, decode chunk 16, the engine's default prefill chunk
    and budget; prompts of 256-1023 random tokens. The bench's 192
    requests are cut to 96 (one and a half admission waves) to keep the
    script inside its time limit. Two runs in one call, weight-only and
    W8A8 (``prefill_a8``), each on its own engine and captured ticks:
    every request must finish with 128 tokens, and ``torch._int_mm`` must
    launch 7 x 16 times a prefill tick in the W8A8 run and never in the
    weight-only one. Prints each run's output tokens/s and
    ``torch._int_mm``'s launches."""
    import dataclasses

    import numpy as np

    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.models import quantization as qz
    from skypilot_tpu_torch.models.serving_engine import (Request,
                                                          ServingEngine)
    base = llama.LlamaConfig.tpu_1b(max_seq=1536, param_dtype=torch.bfloat16)
    params = qz.init_quantized_params(base, seed, device=dev)
    rng = np.random.default_rng(seed + 20)
    prompts = [rng.integers(0, base.vocab_size,
                            int(rng.integers(256, 1024))).tolist()
               for _ in range(96)]
    rates = {}
    for a8 in (False, True):
        cfg = dataclasses.replace(base, prefill_a8=a8)
        tag = f'serve_a8 shape ({"W8A8" if a8 else "weight-only"})'
        eng = ServingEngine(params, cfg, batch_size=64, max_prompt=1024,
                            max_seq=1536, kv_quant=True, decode_chunk=16,
                            device=dev)
        warm(torch, eng, tag)
        reqs = [Request(i, p, max_new=128) for i, p in enumerate(prompts)]
        ticks0 = eng.prefill_ticks
        res, wall, launches, n_ticks = serve(torch, eng, reqs, tag)
        ticks = eng.prefill_ticks - ticks0
        out_toks = sum(len(r.tokens) for r in res.values())
        rates[a8] = out_toks / wall
        int_mm = launches.get('torch._int_mm', 0)
        log(f'{tag}: {len(res)} requests, {sum(map(len, prompts))} prompt '
            f'tokens, {out_toks} output tokens in {wall:.3f} s = '
            f'{rates[a8]:.1f} output tokens/s on {card}; {n_ticks} ticks '
            f'({ticks} prefill ticks); torch._int_mm launches {int_mm}; '
            f'launches {launches}')
        check(len(res) == len(prompts) and all(
            r.status == 'finished' and len(r.tokens) == 128
            for r in res.values()), f'{tag}: a request did not finish')
        want = ticks * 7 * cfg.n_layers if a8 else 0
        check(int_mm == want, f'{tag}: torch._int_mm launched {int_mm} '
              f'times, want {want}')
        del eng
        torch.cuda.empty_cache()
    log(f'serve_a8 shape on {card}: weight-only {rates[False]:.1f}, W8A8 '
        f'{rates[True]:.1f} output tokens/s in the same call')
    del params
    torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--profile-dir', default=None,
                    help='after the serving and training runs, repeat '
                    'each under torch.profiler and write the kernel '
                    'tables in this directory')
    ap.add_argument('--only', default=None,
                    help='comma-separated phase numbers to run after the '
                    'build (e.g. 5,5c: a phase that takes another\'s '
                    'model needs that phase too; 11 runs 11a-11f, which '
                    'make their own models); such a partial run prints no '
                    'result lines')
    ap.add_argument('--tree', default=None,
                    help='import the port from this checkout instead of '
                    'the one beside the script (a same-call comparison with '
                    'another commit, e.g. one unpacked with git archive); '
                    'such a run prints no result lines')
    args = ap.parse_args(argv)
    only = None if args.only is None else set(args.only.split(','))
    root = os.path.abspath(args.tree) if args.tree else HERE
    try:
        import torch
    except ImportError as e:
        print(f'chip_smoke: no torch ({e})', file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this smoke '
              'test runs on an NVIDIA GPU only', file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(root, 'skypilot_tpu_torch')):
        print('chip_smoke: run it from a checkout of the repository (no '
              f'skypilot_tpu_torch package in {root})', file=sys.stderr)
        return 1
    sys.path.insert(0, root)
    # Full-f32 products everywhere: the parity phases compare f32 paths.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log('TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, '
        'torch.backends.cudnn.allow_tf32 = False')
    dev = torch.device('cuda')
    failures, report, main_launches, handover = [], [], {}, {}

    def phase(name, fn, *a):
        if only is not None and name.split()[0] not in only | {'1'}:
            return None
        t0 = time.perf_counter()
        try:
            out = fn(*a)
        except Exception as e:             # report, then the next phase
            failures.append(f'{name}: {type(e).__name__}: {e}')
            log(f'FAIL {name}: {type(e).__name__}: {e}')
            return None
        log(f'ok {name} ({time.perf_counter() - t0:.1f} s)')
        return out

    card = phase('1 card', card_line) or 'unknown card'
    log(card)
    log(f'python {sys.version.split()[0]}, torch {torch.__version__}, '
        f'CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} x '
        f'{torch.cuda.device_count()}')

    def build():
        from skypilot_tpu_torch.ops import _build
        t0 = time.perf_counter()
        logs = _build.build()
        log(f'kernels built in {time.perf_counter() - t0:.2f} s')
        for name, text in logs.items():
            for line in text.splitlines():
                if 'registers' in line or 'spill' in line or \
                        'arning' in line:
                    log(f'  {name}: {line.strip()}')

    phase('1 build', build)
    phase('1 tensor cores in SASS', sass_counts)
    phase('2 K1 vs plain', phase_decode, torch, dev, args.seed, report)
    phase('3+4 K2 vs plain', phase_chunk, torch, dev, args.seed, report)
    phase('3b+4 K3 vs plain', phase_verify, torch, dev, args.seed, report)
    main_launches = phase('5 main path and spec path', phase_main_path,
                          torch, dev, args.seed, card, handover,
                          args.profile_dir) or {}
    phase('5c prefix path', phase_prefix_path, torch, dev, args.seed, card,
          handover, args.profile_dir)
    phase('5d lifecycle', phase_lifecycle, torch, dev, args.seed, card,
          handover)
    phase('12 HTTP front end', phase_http, torch, dev, args.seed, card,
          handover)
    bf16_rate = handover.get('rate')
    handover.clear()
    gc.collect()
    torch.cuda.empty_cache()
    log(f'{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated after '
        'the serving phases let their models and engines go')
    parity = phase('6 parity', phase_parity, torch, dev, args.seed)
    phase('6b spec parity', phase_spec_parity, torch, dev, parity)
    phase('6c prefix parity', phase_prefix_parity, torch, dev, parity)
    phase('7 K4/K5a/K5b vs plain', phase_flash, torch, dev, args.seed,
          report)
    train_launches = phase('8 training path', phase_train, torch, dev,
                           args.seed, card, args.profile_dir) or {}
    phase('9 training parity', phase_train_parity, torch, dev, args.seed)
    phase('10 generate', phase_generate, torch, dev, parity)
    del parity
    torch.cuda.empty_cache()
    phase('11 (11a) Q1 vs plain', phase_q1, torch, dev, args.seed, report)
    phase('11 (11b) qdot_a8', phase_int_mm, torch, dev, args.seed)
    phase('11 (11c) int8 parity', phase_int8_parity, torch, dev, args.seed)
    q1_launches = phase('11 (11d) int8 main path', phase_int8_main_path,
                        torch, dev, args.seed, card, bf16_rate,
                        args.profile_dir) or {}
    phase('11 (11e) decode_w8 shape', phase_decode_w8, torch, dev,
          args.seed, card)
    phase('11 (11f) serve_a8 shape', phase_serve_a8, torch, dev, args.seed,
          card)
    # K1/K2 count from the serving path's run, K3 from the organic spec
    # run, K4/K5 from the training path's, Q1 from the int8 main path's;
    # neither path launches the other's kernels.
    for entry in report:
        entry['launches'] = {**main_launches, **train_launches,
                             **q1_launches}.get(entry['name'], 0)
    if failures:
        print('chip_smoke FAILED:\n  ' + '\n  '.join(failures),
              file=sys.stderr)
        return 1
    if only is not None or args.tree:
        log(f'chip_smoke: phases {sorted(only or ["all"])} passed (a partial '
            f'run or another tree: no result)')
        return 0
    log(card)
    log(json.dumps({'kernels': report}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
