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
   K1, K2, K3, K4, K5a and K5b must hold HGMMA.
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
   (K2, all on the bf16 route: no ``chunk_prefill.f32``). The same
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

``--profile-dir DIR`` adds a torch.profiler pass after the serving runs
(graphed and eager), the organic spec runs (graphed and eager) and
phase 8 (device idle share, host ms per tick = (wall - device busy) /
ticks, device time by kernel group, tables in DIR).

The lines before the last print the card line and one JSON object
``{"kernels": [...]}`` (launches: K1/K2 from phase 5's run, K3 from the
organic spec run, K4/K5 from phase 8's timed steps); the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
"""
import argparse
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
    inflates); and the device kernels per tick."""
    from skypilot_tpu_torch.models.serving_engine import Request
    again = [Request(('profiled', i), p, max_new=32)
             for i, p in enumerate(prompts)]
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


def phase_main_path(torch, dev, seed, card, profile_dir=None):
    """The full-width engine run on captured tick programs, then the same
    requests served eagerly in the same call (graphs off through the
    engine's private attribute); returns the graphed run's launch
    counts. With ``profile_dir``, each run is then repeated under
    torch.profiler (device busy, idle share, host ms per tick)."""
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
        if profile_dir:
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
    del params
    torch.cuda.empty_cache()
    return launches


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


KERNEL_GROUPS = (('paged_decode', 'K1 paged_decode'),
                 ('chunk_prefill', 'K2 chunk_prefill'),
                 ('verify_attention', 'K3 verify_attention'),
                 ('flash_fwd', 'K4 flash_fwd'), ('flash_dq', 'K5a flash_dq'),
                 ('flash_dkv', 'K5b flash_dkv'))


def kernel_group(name):
    for key, group in KERNEL_GROUPS:
        if key in name:
            return group
    if 'nvjet' in name or 'gemm' in name or 'cublas' in name.lower():
        return 'matmul (cuBLAS)'
    return 'host<->device copies' if 'Memcpy' in name else \
        'other PyTorch kernels'


def profile_run(torch, fn, out_dir, tag):
    """Run ``fn()`` again under torch.profiler (after the measured run,
    so it does not slow that one): device busy time against wall time,
    and the kernels by device time, written to ``out_dir``. Each of the
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
        log(f'  {group:24s} {ms:10.1f} ms {n:8d} launches '
            f'{100 * ms / 1e3 / busy:5.1f}%')
    counted = ', '.join(
        f'{group.split()[0]} {groups.get(group, (0.0, 0))[1]}/'
        f'{host.get(key, 0)}' for key, group in KERNEL_GROUPS
        if host.get(key, 0) or group in groups)
    log(f'profile ({tag}): kernel launches seen by the profiler / counted '
        f'by the wrappers: {counted}')
    log('profile: top kernels by device time:')
    for e in kernels[:8]:
        log(f'  {dev_us(e) / 1e3:10.3f} ms {e.count:6d}x  {e.key[:90]}')
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
# instantiation of the bf16 routes of K1, K2, K3, K4, K5a and K5b.
TENSOR_CORE_KERNELS = {
    'paged_decode': ('paged_decode_tc_kernel',),
    'verify_attention': ('verify_attention_tc_kernel',),
    'flash_fwd': ('flash_fwd_tc_kernel',),
    'flash_bwd': ('flash_dq_tc_kernel', 'flash_dkv_tc_kernel'),
    'chunk_prefill': ('chunk_prefill_tc_kernel',),
}


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
        required = TENSOR_CORE_KERNELS.get(lib, ())
        found = {key: 0 for key in required}
        for name in sorted(funcs):
            counts = {op: sum(op in line for line in funcs[name])
                      for op in ('HGMMA', 'HMMA')}
            log(f'  {lib}: {counts["HGMMA"]:4d} HGMMA, {counts["HMMA"]:3d} '
                f'HMMA  {names[name][:110]}')
            for key in required:
                if key in name:
                    found[key] += 1
                    if counts['HGMMA'] == 0:
                        missing.append(names[name])
        missing += [f'{lib}: no {key} function'
                    for key, n in found.items() if n == 0]
    check(not missing, f'no wgmma in the SASS of {missing}')


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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--profile-dir', default=None,
                    help='after the serving and training runs, repeat '
                    'each under torch.profiler and write the kernel '
                    'tables in this directory')
    args = ap.parse_args(argv)
    try:
        import torch
    except ImportError as e:
        print(f'chip_smoke: no torch ({e})', file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is False; this smoke '
              'test runs on an NVIDIA GPU only', file=sys.stderr)
        return 1
    if not os.path.isdir(os.path.join(HERE, 'skypilot_tpu_torch')):
        print('chip_smoke: run it from a checkout of the repository (no '
              'skypilot_tpu_torch package beside it)', file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    # Full-f32 products everywhere: the parity phases compare f32 paths.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log('TF32 off: torch.backends.cuda.matmul.allow_tf32 = False, '
        'torch.backends.cudnn.allow_tf32 = False')
    dev = torch.device('cuda')
    failures, report, main_launches = [], [], {}

    def phase(name, fn, *a):
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
                if 'registers' in line or 'spill' in line:
                    log(f'  {name}: {line.strip()}')

    phase('1 build', build)
    phase('1 tensor cores in SASS', sass_counts)
    phase('2 K1 vs plain', phase_decode, torch, dev, args.seed, report)
    phase('3+4 K2 vs plain', phase_chunk, torch, dev, args.seed, report)
    phase('3b+4 K3 vs plain', phase_verify, torch, dev, args.seed, report)
    main_launches = phase('5 main path and spec path', phase_main_path,
                          torch, dev, args.seed, card, args.profile_dir) or {}
    parity = phase('6 parity', phase_parity, torch, dev, args.seed)
    phase('6b spec parity', phase_spec_parity, torch, dev, parity)
    phase('7 K4/K5a/K5b vs plain', phase_flash, torch, dev, args.seed,
          report)
    train_launches = phase('8 training path', phase_train, torch, dev,
                           args.seed, card, args.profile_dir) or {}
    phase('9 training parity', phase_train_parity, torch, dev, args.seed)
    phase('10 generate', phase_generate, torch, dev, parity)
    del parity
    # K1/K2 count from the serving path's run, K3 from the organic spec
    # run, K4/K5 from the training path's; neither path launches the
    # other's kernels.
    for entry in report:
        entry['launches'] = {**main_launches, **train_launches}.get(
            entry['name'], 0)
    if failures:
        print('chip_smoke FAILED:\n  ' + '\n  '.join(failures),
              file=sys.stderr)
        return 1
    log(card)
    log(json.dumps({'kernels': report}))
    log(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
