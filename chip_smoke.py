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
   bf16; then the Mistral-7B chat engine's decode shape (B 64, S 4096,
   rows of the chat mix at their own decode columns, 16 and 64 of them
   live, idle rows at bound 0), bf16, timed at the kernel's split plan
   and, in the same call, at one run a row (the plan without its cap
   on a run's tiles).
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
   bf16; the published max_seq 8192 (segments up to column 8000), bf16.
   Each row's segment starts at its own column, an int32 [B] on the
   device, as the engine passes each row's own write frontier.
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
   Then, in bf16 against the plain versions under the same bars, phase
   14's shapes where its kernels first run: B 1 x S 8192 x H 16 x D 128
   causal (standing in for 14a's B 4), GPT-2's B 8 x S 1024 x H 12 x
   D 64, and B 1 x S 32768 x H 16 x D 128 with the plain versions run
   over blocks of 1024 query rows (``flash_check_blocked``). Times at B 4 x S 2048 and at phase
   14's three training shapes (B 4 x S 8192 x H 16 x D 128, B 1 x
   S 32768 x H 16 x D 128, B 8 x S 1024 x H 12 x D 64): each kernel,
   its plain version where it fits (``_plain_bwd`` computes dQ, dK and
   dV together; not at S 8192 x B 4 or S 32768, whose score matrices
   take 17 and 68 GB), SDPA forward, SDPA backward alone
   (torch.autograd.grad on a graph kept from one forward) and SDPA
   forward + backward, and the bound (operations over the bf16 peak: 2,
   3 and 4 products of 2 * head_dim operations per attended pair).
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
   ``phase_train_parity``). 9b, the same under ``Adafactor(3e-4)``
   for tpu_1b width under remat True, 'dots', 'qkvo' and 'kvo' (each
   within rtol 1e-5 of True), tpu_moe_1b width at cf 1.0 (sorted and
   dense dispatch, remat True, False and 'dots') and GPT-2 124M width under
   'dots', and Adafactor's update on CUDA tensors against the CPU's
   (``phase_family_parity``).
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
13. The MoE family and GPT-2 (``--only 13``; run after 11, each making its
   own model): 13a parity at Mixtral-8x7B width, depth 2, f32 — the
   engine against ``reference_generate`` (dropless), int8 KV, oracle
   drafts through K3, the prefix cache, the int8 tree against the
   re-prefill oracle, capacity dispatch against dropless, and
   ``prefill_a8`` with the experts on Q1 and only the attention
   projections on ``torch._int_mm`` (``phase_moe_parity``); 13b the
   MoE main path, Mixtral-8x7B width at all 32 layers born int8
   (46.7 GB), phase 5's geometry and requests on captured ticks and
   eagerly, exact K1/K2/Q1 launch counts, device time by group from a
   profiled repeat and a decode step's device ms beside its byte bound
   (``phase_moe_main_path``); 13c GPT-2 124M's forward at B 4 x S 1024
   through K4 at head_dim 64 against plain attention, its loss, and the
   engine's refusal (``phase_gpt2``). 11a also holds Q1 at Mixtral's
   lm_head (M 8, N 32000, f32 out) and the expert leaves at the
   capacity rows of 13a's and 13b's ticks, and times the lm_head and an
   expert's w_down at 13b's decode M 8 (w_gate/w_up have w_gate's shape).

14. The reference's training cells (``bench.py``'s ``train``,
   ``moe_train`` and ``longctx_train``) and GPT-2 124M training, all in
   bf16 under ``Adafactor(3e-4)`` with ``loss_chunk`` 1024, at full
   width and depth on one fixed batch from the seed (``--only 14``; run
   last): 14a tpu_1b, B 4 x S 8192, under remat True, 'kvo', 'qkvo'
   and 'dots' (first-step losses bitwise equal, grad_norms within rtol
   1e-3, the saved bytes of a loss forward ordered and their
   differences within 15% of q's and of k, v and o's bytes); 14b
   tpu_moe_1b at cf 1.0, 'dots', B 1 x S 8192 (the dropped share, MFU
   against the active params); 14c tpu_1b, 'kvo', B 1 x S 32768; 14d
   GPT-2 124M, 'dots', B 8 x S 1024 (head_dim 64). Each prints step
   time, tokens/s, MFU and peak memory (with ``--profile-dir``, for 14a
   under 'kvo' and the other three, a profiled extra step: device time
   by group and the idle share); every value finite, the loss
   falls, and every step launches K4 twice a layer and K5a and K5b
   once, on the bf16 route.
15. Tensor-parallel serving (``--only 5,15``; with 13 for the Mixtral
   cell's comparison). The card's machine has one H100, and NCCL
   refuses two ranks on one device, so: 15a (after 11a) the serving
   kernels at the shard shapes of tp 2 and 4, K1/K2/K3 at n_kv 4 and 2
   against their plain versions and, concatenated over the ranks,
   against the unsharded launch, and Q1 at every shard width of the 8B
   and Mixtral leaves and lm_heads (``phase_tp_kernels``); 15b (after
   12) a world of one rank over NCCL through ``initialize_from_env``:
   phase 5's model and requests on the TP engine, graphed, tokens equal
   to phase 5's, the all-reduces inside the captured graphs, then the
   same with speculation (K3 on the TP path) against phase 5's
   prompt-lookup run (``phase_tp_nccl_one``); 15c worlds of 2 and 4
   ranks sharing the card over gloo, eagerly (spawned with
   ``multiprocessing``'s spawn method): the 8B main path at full width,
   8 of its 32 layers (cut for the run's time), its first chunk's and
   decode step's logits held to the unsharded bf16 model's own distance
   from the exact ones, its tokens against the unsharded model's with
   every divergence explained by its top-2 margin, and the 8B width at
   depth 2 in f32, tokens exact
   (``phase_tp_gloo``); after 13b, the Mixtral width born int8 at tp 2
   (23.4 GB a rank), its logits held the same way against 13b's model
   (``phase_tp_moe``); 15d NCCL at tp = min(cards, 4), graphed, only
   where two or more cards are visible (``phase_tp_nccl_multi``; here
   it prints one line saying it did not run).
16. Sharded training over dp, fsdp and tp (``make_train_step(mesh=)``).
   16a (after 8, in every run): a world of one rank over NCCL through
   ``initialize_from_env``: each mesh collective once on each group of
   one, returning its input; then phase 8's model, state and batch
   (tpu_1b at full width and depth, bf16, AdamW, B 4 x S 2048), one
   warm-up and four timed steps: the first loss bitwise phase 8's, grad
   norms within rtol 1e-5, the params after the steps within the bf16
   bar, K4/K5a/K5b 32/16/16 a step as phase 8's, and the collectives a
   step the design's count (``sharded_collectives_per_step``: none, as
   no axis has more than one rank), the step time beside phase 8's
   (``phase_sharded_one``). 16b (``--only 16`` only: with it the whole
   run would pass 900 s): worlds sharing the card over gloo (CUDA
   gathers in the all-reduce form), two steps on phase 8's batch:
   tpu_1b width at depth 2 in bf16 under dp 2, fsdp 2 and fsdp 2 x tp
   2, and tpu_moe_1b width at depth 2 under fsdp 2 at capacity factor
   1.0; before each step the world gathers its state and rank 0 runs
   the unsharded step from it, and every step of every rank is held to
   that reference (loss within the bf16 bar, grad_norm rtol 1e-3), the
   MoE drops by layer equal to the reference's, attention at H / tp
   heads, K4/K5 launches and the collectives a step the design's
   (``phase_sharded_gloo``).
17. Sequence, expert and pipeline parallelism (``parallel/
   ring_attention.py``, MoE over 'ep', ``parallel/pipeline.py``). 17a
   (after 16a, in every run): ring attention's flash route over 2 and 4
   chunks in one process (``ring_attention_local``) at tpu_1b's heads on
   B 1 x S 32768 and at GPT-2's head_dim 64, the output against the
   exact result and the gradients against the plain backward on the
   ring's own o and lse within the bf16 bar, K4/K5's f32-output mode bit
   for bit their bf16 mode, n (n + 1) / 2 launches of each kernel a call,
   the f32 flash route against the plain route within 1e-4, the time
   beside ``flash_attention``'s (``phase_ring``). 17b
   (``--only 17`` only): seven worlds sharing the card over gloo, two
   steps each (sp 2 at B 1 x S 32768, sp 2 x fsdp 2, GPT-2 124M sp 2, MoE
   ep 2 and sp 2 x ep 2, the last also at the next seed, pp 2 and pp 2 x
   sp 2 at depth 4), every step against rank 0's unsharded step from the
   gathered state within the training bars, MoE drops equal, K4/K5 and
   the collectives a step the design's, and MoE sp 2 x ep 2's top-k
   choices that flip against ``flash_attention``'s with their router
   margins (``phase_ring_worlds``).
18. Checkpoints and the training recipe (``skypilot_tpu_torch/
   checkpoint.py``, ``quantize_checkpoint``, ``recipes/finetune.py``,
   ``utils/profiling.py``). 18a (in every run): Llama-3.1-8B width at
   depth 4 saved, loaded back bitwise and served (phase 5's geometry
   and 12 requests, captured ticks) with the in-memory tree's tokens;
   ``quantize_checkpoint`` on the host, then ``_build_replica`` with
   ``--checkpoint-quantized --weight-quant``: the tree bitwise
   ``quantize_params``, its load within its int8 bytes
   plus 64 MiB of device memory, the in-memory int8 tree's tokens; K1,
   K2 and Q1 launches by route, save and load GB/s, the quantize
   seconds (``phase_checkpoint_serve``). 18b (in every run): the
   finetune recipe at tpu_1b width, depth 2, B 4 x S 2048, 4 steps with
   a checkpoint every 2, then resumed from step 2 as a preempted job:
   losses, params and optimizer state bitwise; its one
   ``SKYTPU_PROFILE_DIR`` trace (step 2) and a profiler-server capture
   taken during train steps list K4, K5a and K5b (``phase_recipe``).
   18c (``--only 18`` only): the 32-layer 8B tree through the
   quantization CLI (host peak RSS) and ``python -m
   skypilot_tpu_torch.models.serving_http --checkpoint ...
   --checkpoint-quantized --weight-quant`` over HTTP, the Mixtral width
   at depth 2 int8, the recipe's resume at tpu_1b's full depth
   (``phase_checkpoint_full``).

``--tree DIR`` imports the port from another checkout (the parent
commit unpacked with ``git archive``), so one call can time two trees
with the same phases, in turns; such a run prints no result lines.

The graphed main path (untraced and traced) is always repeated under
torch.profiler for its idle share; ``--profile-dir DIR`` adds that pass
after the eager serving run, the organic spec runs (graphed and
eager), the prefix runs (cache on and off), phase 8 and phase 14's cells (device idle
share, host ms per tick = (wall - device busy) / ticks, device time by
kernel group), and writes the tables in DIR.

The lines before the last print the card line and one JSON object
``{"kernels": [...]}`` (launches: K1/K2 from phase 5's run, K3 from the
organic spec run, K4/K5 from phase 8's timed steps, Q1 from 11d's run;
``launches_moe_main_path``: K1, K2 and Q1 from 13b's graphed run;
``launches_train_cells``: K4, K5a and K5b from each phase 14 cell's
timed steps; K4/K5's ``train_shapes``: their times at phase 14's
shapes; ``launches_tp``: 15b's spec run on a tp 1 mesh and rank 0's
launches in 15c's worlds, n_kv / tp heads a K1/K2 launch; ``tp_shards``: 15a's errors and times at the
shard shapes; ``launches_sharded_train``: this kernel's launches and
the collectives, a timed step of 16a; ``launches_ring``: K4/K5's
launches a ring call of 17a, by shape and chunk count;
``launches_checkpoint``: 18a's runs served from checkpoints and 18b's
recipe run);
the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.
"""
import argparse
import dataclasses
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


def past_bf16_bar(got, want):
    """How many elements of ``got`` lie past the bf16 bar of ``want``."""
    err = (got.float() - want.float()).abs()
    return int((err > 1e-2 + 2**-7 * want.float().abs()).sum().item())


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


def serve_decode_inputs(torch, dev, seed, live):
    """K1 at the Mistral-7B chat engine's decode shape (B 64, S 4096,
    32/8 heads, D 128, page 128, num_pages 32): each row holds a prompt
    and part of an answer of the chat mix's lengths (log-normal, medians
    1020 and 129, clipped to 64-3072 and 16-1024), the answer at the
    row's own decode columns from 3072; the first ``live`` rows are
    occupied (bound at their own frontier), the others idle at bound 0
    with a finished occupant's keys still in the dmask. NaN wherever the
    kernel may not read."""
    import numpy as np
    b, s, n_kv, rep, hd, page, base = 64, 4096, 8, 4, 128, 128, 3072
    rng = np.random.default_rng(seed)
    g = torch.Generator(device=dev).manual_seed(seed)
    prompt = np.clip(rng.lognormal(np.log(1020), 0.8, b), 64, 3072)
    answer = np.clip(rng.lognormal(np.log(129), 0.8, b), 16, 1024)
    done = (rng.uniform(size=b) * answer).astype(int)
    pos = torch.arange(s, device=dev)[None, :]
    valid = ((pos < torch.tensor(prompt.astype(int), device=dev)[:, None]) |
             ((pos >= base) &
              (pos < base + torch.tensor(done, device=dev)[:, None])))
    bounds = torch.tensor([base + int(done[r]) if r < live else 0
                           for r in range(b)], dtype=torch.int32,
                          device=dev)
    readable = valid & (pos < bounds[:, None])
    q = torch.randn((b, n_kv * rep, hd), generator=g, device=dev).to(
        torch.bfloat16)
    kc = torch.randn((b, s, n_kv, hd), generator=g, device=dev).to(
        torch.bfloat16)
    vc = torch.randn((b, s, n_kv, hd), generator=g, device=dev).to(
        torch.bfloat16)
    kc[~readable] = float('nan')
    vc[~readable] = float('nan')
    k_self = torch.randn((b, n_kv, hd), generator=g, device=dev).to(
        torch.bfloat16)
    v_self = torch.randn((b, n_kv, hd), generator=g, device=dev).to(
        torch.bfloat16)
    args = (q, kc, vc, valid, bounds, k_self, v_self, None, None)
    return args, dict(page=page, num_pages=s // page), readable


def phase_decode_serve(torch, dev, seed, entry):
    """K1 at the chat engine's decode shape (``serve_decode_inputs``),
    16 and 64 of 64 rows live: against its plain version, then timed
    with the split plan the kernel takes (runs of at most
    ``split_kv.RUN_TILES`` tiles) and, in the same call, with one run a
    (row, kv head) (the plan without that cap); the bound as phase 4
    counts it."""
    from skypilot_tpu_torch.ops import decode_attention as da
    from skypilot_tpu_torch.ops import split_kv
    cap = split_kv.RUN_TILES
    for live in (16, 64):
        args, kw, readable = serve_decode_inputs(torch, dev, seed, live)
        got = da.paged_gqa_decode_attention(*args, **kw)
        want = da.paged_decode_reference(*args, **kw)
        torch.cuda.synchronize()
        err, ok = compare(got, want)
        finite = bool(torch.isfinite(got.float()).all())
        check(finite and ok, f'K1 at the chat shape, {live} rows live, '
              'disagrees with its plain version')
        nbytes, ops = decode_cost(args, kw, readable)
        sets = copies_of(args, nbytes)
        call = (lambda *a: da.paged_gqa_decode_attention(*a, **kw))
        plan = split_kv.tiles_per_split(64 * 8, kw['num_pages'] * 2,
                                        split_kv.sm_count(dev))
        ms = time_ms(call, sets, iters=100)
        split_kv.RUN_TILES = kw['num_pages'] * 2
        try:
            whole = split_kv.tiles_per_split(64 * 8, kw['num_pages'] * 2,
                                             split_kv.sm_count(dev))
            whole_ms = time_ms(call, sets, iters=100)
        finally:
            split_kv.RUN_TILES = cap
        bound_ms, _ = bound(nbytes, ops, 'bfloat16')
        entry[f'serve{live}'] = dict(
            max_abs_err=err, ms=ms, split_tiles=plan, one_run_ms=whole_ms,
            one_run_split_tiles=whole, bound_ms=bound_ms)
        log(f'K1 at the chat shape, {live}/64 rows live: max_abs_err '
            f'{err:.3g} (within bar: {ok}), finite {finite}; kernel '
            f'{ms:.4f} ms at {plan} tiles a split, {whole_ms:.4f} ms at '
            f'{whole} (one run a row); bound {bound_ms:.4f} ms')
        del sets
    entry['serve_shape'] = ('B 64, S 4096, 32/8 heads, D 128, bf16, rows '
                            'of the chat mix, idle rows at bound 0')


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
    phase_decode_serve(torch, dev, seed, entry)
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
    V 5, 32/8 heads, head_dim 128, S 1024, page 128): each row's segment
    at its own column, 700 less 0-188 (row 1 at 512, its first decode
    column; row 7 at 700), n_cols 768 (6 pages). Row 0 is inactive
    (dmask all false), row 1 a recycled row with only a 40-token prefix
    live; the others have prompts of 100-512 tokens and decode columns
    with rejected-candidate holes up to their own start (each earlier
    V-column verify tick kept its first 1-V columns). NaN sits in every
    column no query may attend (in the scales for int8). The starts are
    an int32 [B] on the device, as the engine passes each row's own
    write frontier. ``shape`` (V, H, n_kv, S, seg, n_cols) replaces the
    defaults; ``seg`` is the latest start."""
    b, vq, h, n_kv, d, s, seg, n_cols = 8, 5, 32, 8, 128, 1024, 700, 768
    if shape is not None:
        vq, h, n_kv, s, seg, n_cols = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    qdt = torch.float32 if kind == 'f32' else torch.bfloat16
    q = torch.randn((b, vq, h, d), generator=gen, device=dev).to(qdt)
    cols = torch.arange(s, device=dev)[None, :]
    prompt = torch.tensor([0, 40, 100, 250, 333, 480, 511, 512],
                          device=dev)[:, None]
    start = seg - torch.tensor(VERIFY_BACK, device=dev)[:, None]
    tick, pos = (cols - 512) // vq, (cols - 512) % vq
    kept = (cols >= 512) & (cols < start) & (pos <= tick % vq)
    valid = (cols < prompt) | kept
    valid[0] = False
    valid[1] = cols[0] < 40
    live = valid | ((cols >= start) & (cols < start + vq))
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
    seg_t = start[:, 0].to(torch.int32)
    return (q, k, v, valid, seg_t, ks, vs), n_cols


# How far each row's K3 segment starts before the latest one (row 1, a
# recycled row, at its first decode column; row 7 the latest).
VERIFY_BACK = (61, 188, 5, 130, 97, 23, 160, 0)
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
    its own segment, K and V (and scales) of the columns some query
    attends (dmask-true plus the segment); 4 * head_dim operations per
    attended (query row, column, head)."""
    q, k, _, valid, seg, ks, _ = args
    b, vq, h, d = q.shape
    n_kv = k.shape[2]
    ends = [min(n_cols, int(x) + vq) for x in seg.reshape(-1).expand(b)]
    dmask = sum(int(valid[r, :end].sum()) for r, end in enumerate(ends))
    cols = dmask + b * vq
    nbytes = (2 * q.numel() * q.element_size() + sum(ends) +
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
    seg = int(seg.reshape(-1)[0])
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
                         long_shape='B 8, V 5, S 8192, segments at '
                         '7812-8000, n_cols 8064, 32/8 heads, D 128, bf16')
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
    end] mask (dmask | each row's segment-causal) and GQA over the
    columns the kernel reads; inputs laid out before the timing, NaN
    cleared."""
    q, k, v, valid, seg, _, _ = args
    vq = q.shape[1]
    start = seg.reshape(-1, 1, 1)
    end = min(n_cols, int(seg.max()) + vq)
    col = torch.arange(end, device=q.device)[None, None, :]
    qi = torch.arange(vq, device=q.device)[None, :, None]
    mask = valid[:, None, :end] | ((col >= start) & (col <= start + qi))
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
    # A fresh cache, as the measured run had.
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
                                                   cfg, params, profile_dir,
                                                   handover)
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


def phase_spec_path(torch, dev, seed, card, cfg, params, profile_dir=None,
                    handover=None):
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
    prompt-lookup run; ``handover['spec']`` gets its prompts and tokens
    (phase 15b's spec run)."""
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
        if mode == 'organic' and handover is not None:
            handover['spec'] = prompts, toks
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
            # A fresh cache, as the lifecycle run's would be on a new
            # replica (the pool, with the cache on, keeps its pages).
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
    order). Each row's bound and segment start is its own frontier,
    just past its last key (the decode base at least), as the engine
    passes them."""
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
        own = [max(int(r.nonzero()[:, 0].max()) + 1 if bool(r.any())
                   else 0, base) for r in val]
        bound = torch.tensor(own, dtype=torch.int32, device=dev)
        seg = max(own)
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
        for r, start in enumerate(own):
            k3[r, start:start + vq] = seg_kv[0][r]
            v3[r, start:start + vq] = seg_kv[1][r]
        seg_t = bound
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
    if 'nvjet' in name or 'gemm' in name or 'gemv' in name or \
            'cublas' in name.lower():
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


def flash_check_blocked(torch, fa, args, rows=1024):
    """``flash_check`` at a causal shape (Sq == Sk) whose score matrix
    does not fit: the plain versions run over blocks of ``rows`` query
    rows, each block against the keys it sees (so the bottom-right mask
    of the block is the whole's): o and lse from ``_plain_fwd``, then
    ``_plain_bwd``'s formulas on the kernel's o and full lse, the block's
    dq whole and its dk and dv shares summed over blocks in f32 (the
    plain backward's sums) before the one cast. Same bars and launch
    counts as ``flash_check``; returns the max errors (o, lse, dq, dk,
    dv)."""
    from skypilot_tpu_torch.ops import _build
    q, k, v, do = args
    s, scale = q.shape[1], q.shape[-1]**-0.5
    kw = dict(causal=True, scale=scale)
    _build.reset_launches()
    o, lse = fa.flash_forward(q, k, v, **kw)
    dq, dk, dv = fa.flash_backward(q, k, v, o, lse, do, **kw)
    launches = dict(_build.LAUNCHES)
    route = {n: 1 for n in ('flash_fwd', 'flash_dq', 'flash_dkv')}
    check(launches == route, f'launches {launches}, want {route}')
    errs = dict.fromkeys(('o', 'lse', 'dq', 'dk', 'dv'), 0.0)
    bad = set()

    def hold(name, got, want):
        err, ok = compare(got, want, bf16_bar=name != 'lse')
        errs[name] = max(errs[name], err)
        if not ok or not bool(torch.isfinite(got.float()).all()):
            bad.add(name)

    dk_f = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv_f = torch.zeros_like(dk_f)
    for i0 in range(0, s, rows):
        i1 = min(s, i0 + rows)
        qb, kb, vb = q[:, i0:i1], k[:, :i1], v[:, :i1]
        dob, ob, lseb = do[:, i0:i1].float(), o[:, i0:i1], lse[:, :, i0:i1]
        want_o, want_lse = fa._plain_fwd(qb, kb, vb, **kw)
        hold('o', ob, want_o)
        hold('lse', lseb, want_lse)
        del want_o, want_lse
        p = torch.exp(fa._scores(qb, kb, True, scale) - lseb[..., None])
        dv_f[:, :i1] += torch.einsum('bhqk,bqhd->bkhd', p, dob)
        dp = torch.einsum('bqhd,bkhd->bhqk', dob, vb.float())
        delta = torch.sum(dob * ob.float(), dim=-1).transpose(1, 2)
        ds = p * (dp - delta[..., None]) * scale
        del p, dp
        hold('dq', dq[:, i0:i1],
             torch.einsum('bhqk,bkhd->bqhd', ds, kb.float()).to(q.dtype))
        dk_f[:, :i1] += torch.einsum('bhqk,bqhd->bkhd', ds, qb.float())
        del ds
    hold('dk', dk, dk_f.to(k.dtype))
    hold('dv', dv, dv_f.to(v.dtype))
    torch.cuda.synchronize()
    check(not bad, f'{sorted(bad)} disagree with the plain version over '
          f'blocks of {rows} rows (max abs err {errs})')
    return errs


FLASH_EDGES = ((2, 256, 256, True, 128, 'causal S 256'),
               (2, 256, 256, False, 128, 'full S 256'),
               (2, 128, 256, True, 128, 'causal Sq 128 < Sk 256'),
               (2, 200, 200, True, 128, 'causal ragged S 200'))


def phase_flash(torch, dev, seed, report):
    """K4, K5a and K5b against their plain versions on both routes: f32
    edge cases at the 1e-4 bar, the same in bf16 plus a head_dim-64 case
    at the bf16 bar, then B 4 x S 2048 and B 1 x S 8192 in bf16, and
    times at B 4 x S 2048 and at phase 14's training shapes."""
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
    times = flash_times(torch, fa, args, plain=True)
    times['shape'] = 'B 4 x S 2048 x H 16 x D 128'
    del args
    # The training cells' longest rows: S 8192 against the plain versions
    # (a [1, 16, 8192, 8192] f32 score matrix each), then times at the
    # three training shapes of phase 14.
    args = flash_inputs(torch, dev, 1, 8192, 8192, 16, torch.bfloat16, seed)
    errs_8k = flash_check(torch, fa, args, True, False)
    log('K4/K5 bf16 B 1 x S 8192 x H 16 x D 128 causal: max_abs_err ' +
        ', '.join(f'{n} {e:.3g}' for n, e in errs_8k.items()))
    del args
    # GPT-2's training shape at head_dim 64, whole; S 32768 over blocks of
    # query rows (its whole [1, 16, S, S] f32 score matrix is 68 GB).
    errs_d64 = flash_check(torch, fa, flash_inputs(
        torch, dev, 8, 1024, 1024, 12, torch.bfloat16, seed, 64), True, False)
    log('K4/K5 bf16 B 8 x S 1024 x H 12 x D 64 causal: max_abs_err ' +
        ', '.join(f'{n} {e:.3g}' for n, e in errs_d64.items()))
    torch.cuda.empty_cache()
    errs_32k = flash_check_blocked(torch, fa, flash_inputs(
        torch, dev, 1, 32768, 32768, 16, torch.bfloat16, seed))
    log('K4/K5 bf16 B 1 x S 32768 x H 16 x D 128 causal (plain over blocks '
        'of 1024 query rows): max_abs_err ' +
        ', '.join(f'{n} {e:.3g}' for n, e in errs_32k.items()))
    torch.cuda.empty_cache()
    train_times = []
    for b, s, h, d, tag in FLASH_TRAIN_SHAPES:
        args = flash_inputs(torch, dev, b, s, s, h, torch.bfloat16, seed, d)
        # The plain backward holds about six [B, H, S, S] f32 tensors:
        # timed where one of them is at most 1 GiB (not at S 8192 x B 4,
        # 17 GB each, nor at S 32768, 68 GB).
        t = flash_times(torch, fa, args, plain=b * h * s * s * 4 <= 2**30)
        t['shape'] = tag
        train_times.append(t)
        del args
        torch.cuda.empty_cache()
    for name, source, replaces in FLASH_ENTRIES:
        fwd = name == 'flash_fwd'
        entry = {
            'name': name, 'route': 'cuda', 'source': source,
            'replaces': replaces,
            'products': 'bf16 wgmma (f32 route: f32 CUDA cores)',
            'max_abs_err': errs['o'] if fwd else errs['dq'] if
            name == 'flash_dq' else max(errs['dk'], errs['dv']),
            'f32_max_abs_err': edge_err['f32'],
            'bf16_edge_max_abs_err': edge_err['bf16'],
            **{f'bf16_{key}_max_abs_err': e['o'] if fwd else e['dq'] if
               name == 'flash_dq' else max(e['dk'], e['dv'])
               for key, e in (('s8192', errs_8k), ('d64_s1024', errs_d64),
                              ('s32768', errs_32k))},
            'plain_and_library_cover': 'K4' if fwd else 'K5a + K5b '
            '(library: SDPA backward alone)'}
        entry.update(flash_entry_times(times, name))
        entry['train_shapes'] = [dict(shape=t['shape'],
                                      **flash_entry_times(t, name))
                                 for t in train_times]
        report.append(entry)
        for t in [times] + train_times:
            e = flash_entry_times(t, name)
            plain = 'not run' if e['plain_ms'] is None else \
                f'{e["plain_ms"]:.4f}'
            note = '' if fwd else (f' (SDPA backward alone, for the K5 pair;'
                                   f' fwd + bwd {e["library_fwd_bwd_ms"]:.4f})')
            log(f'{name} times (ms) at {t["shape"]}: kernel '
                f'{e["ms"]:.4f}, bound {e["bound_ms"]:.4f} '
                f'({e["bound_by"]}); plain {plain}, library '
                f'{e["library_ms"]:.4f}{note}')
    for t in [times] + train_times:
        log(f'K5 pair (K5a + K5b) at {t["shape"]}: '
            f'{t["ms"]["flash_dq"] + t["ms"]["flash_dkv"]:.4f} ms against '
            f'SDPA backward alone {t["lib"]["bwd"]:.4f} ms')


# phase 14's training shapes: (B, S, H, head_dim, label).
FLASH_TRAIN_SHAPES = (
    (4, 8192, 16, 128, 'tpu_1b train B 4 x S 8192 x H 16 x D 128'),
    (1, 32768, 16, 128, 'longctx_train B 1 x S 32768 x H 16 x D 128'),
    (8, 1024, 12, 64, 'GPT-2 124M B 8 x S 1024 x H 12 x D 64'))


def flash_times(torch, fa, args, plain):
    """Times (ms) of K4, K5a and K5b on ``args`` (q, k, v, dO; causal),
    of their plain versions when ``plain`` (``_plain_bwd`` computes dQ,
    dK and dV together), and of SDPA (``flash_library_ms``), with the
    kernels' (bytes, operations)."""
    q, k, v, do = args
    kw = dict(causal=True, scale=q.shape[-1]**-0.5)
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
    plain_fwd = plain_bwd = None
    if plain:
        plain_fwd = time_ms(lambda *a: fa._plain_fwd(*a, **kw), fwd_sets,
                            iters=5)
        plain_bwd = time_ms(lambda *a: fa._plain_bwd(*a, **kw), bwd_sets,
                            iters=5)
    del fwd_sets, bwd_sets, dkv_sets
    return {'ms': ms, 'plain_fwd': plain_fwd, 'plain_bwd': plain_bwd,
            'lib': flash_library_ms(torch, args), 'costs': costs}


def flash_entry_times(t, name):
    """One kernel's numbers from ``flash_times``: its time, bound, plain
    and library times (K5a and K5b both carry the plain and library
    backward, which cover the pair)."""
    bound_ms, bound_by = bound(*t['costs'][name], 'bfloat16')
    fwd = name == 'flash_fwd'
    out = {'ms': t['ms'][name],
           'plain_ms': t['plain_fwd'] if fwd else t['plain_bwd'],
           'bound_ms': bound_ms, 'bound_by': bound_by,
           'library_ms': t['lib']['fwd'] if fwd else t['lib']['bwd']}
    if not fwd:
        out['library_fwd_bwd_ms'] = t['lib']['fwd_bwd']
    return out


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


def train_batch(torch, cfg, dev, seed, batch_size=4, seq=2048):
    """Phase 8's batch: random tokens [B, S + 1] from the seed."""
    g = torch.Generator(device=dev).manual_seed(seed + 5)
    return {'tokens': torch.randint(0, cfg.vocab_size, (batch_size, seq + 1),
                                    generator=g, device=dev)}


def phase_train(torch, dev, seed, card, profile_dir=None, handover=None):
    """The training path at full width: tpu_1b, all 16 layers, bf16
    params, batch 4 x seq 2048, one fixed batch from the seed; a
    warm-up step, then 4 timed steps. Returns the launch counts of the
    timed steps; ``handover`` (a dict) receives the (loss, grad_norm) of
    every step, the launches of each timed step, the mean step time and
    the params after the last step, phase 16a's reference."""
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
    batch = train_batch(torch, cfg, dev, seed, batch_size, seq)
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
    if handover is not None and not profile_dir:
        handover.update(metrics=metrics, per_step=per_step, step_s=step_s,
                        params=state.params, steps=steps + 1)
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


def parity_run(torch, dev, cfg, seed, batches, optimizer):
    """``make_train_step`` of the config's family from
    ``init_train_state(cfg, seed)`` over ``batches``: ([(loss,
    grad_norm)] per step, the flash launches of the run)."""
    from skypilot_tpu_torch.models import train
    from skypilot_tpu_torch.ops import _build
    state, opt = train.init_train_state(cfg, seed, device=dev,
                                        optimizer=optimizer)
    step = train.make_train_step(cfg, opt)
    _build.reset_launches()
    rows = []
    for batch in batches:
        state, m = step(state, batch)
        rows.append((m['loss'].item(), m['grad_norm'].item()))
    launches = {k: n for k, n in _build.LAUNCHES.items()
                if k.startswith('flash')}
    del state, opt, step
    torch.cuda.empty_cache()
    return rows, launches


def max_rel(a, b):
    return max(abs(x - y) / abs(y) for ra, rb in zip(a, b)
               for x, y in zip(ra, rb))


def phase_family_parity(torch, dev, seed):
    """9b. Depth 2 in f32, batch 2 x seq 256, 3 steps under
    ``Adafactor(3e-4)``, each config run with the kernels (attn_impl
    'auto', every launch on the f32 route: K4 2 per layer per step under
    remat, 1 without, K5a and K5b 1) and with plain attention ('xla')
    from the same weights, loss and grad_norm within rtol 1e-4 (phase
    9's bar): tpu_1b width under remat True, 'dots', 'qkvo' and 'kvo',
    each policy's kernel run within rtol 1e-5 of True's (the reference's
    bar, tests/unit_tests/test_llama.py); tpu_moe_1b width at cf 1.0,
    sorted dispatch under remat True and False (grad_norm within rtol
    1e-5) and 'dots' (loss and grad_norm within rtol 1e-5 of True), and
    dense dispatch (loss within 1e-5 of sorted); GPT-2 124M
    width under 'dots'. Then Adafactor's update of a small tree on CUDA
    tensors against the same update on CPU tensors, 3 steps, within
    1e-6 + 1e-5 |p|."""
    import dataclasses

    from skypilot_tpu_torch.models import gpt2, llama, moe, train
    f32 = dict(n_layers=2, max_seq=256, param_dtype=torch.float32,
               compute_dtype=torch.float32, loss_chunk=1024)
    g = torch.Generator(device=dev).manual_seed(seed + 9)
    cases = {
        **{f'tpu_1b remat={r!r}': llama.LlamaConfig.tpu_1b(remat=r, **f32)
           for r in (True, 'dots', 'qkvo', 'kvo')},
        'tpu_moe_1b sorted remat=True': moe.MoEConfig.tpu_moe_1b(
            capacity_factor=1.0, dispatch='sorted', remat=True, **f32),
        'tpu_moe_1b sorted remat=False': moe.MoEConfig.tpu_moe_1b(
            capacity_factor=1.0, dispatch='sorted', remat=False, **f32),
        "tpu_moe_1b sorted remat='dots'": moe.MoEConfig.tpu_moe_1b(
            capacity_factor=1.0, dispatch='sorted', remat='dots', **f32),
        'tpu_moe_1b dense remat=True': moe.MoEConfig.tpu_moe_1b(
            capacity_factor=1.0, dispatch='dense', remat=True, **f32),
        "gpt2 remat='dots'": gpt2.GPT2Config.gpt2(
            remat='dots', **{k: v for k, v in f32.items()
                             if k != 'max_seq'})}
    batches = {}
    runs = {}
    for name, cfg in cases.items():
        if cfg.vocab_size not in batches:
            batches[cfg.vocab_size] = [
                {'tokens': torch.randint(0, cfg.vocab_size, (2, 257),
                                         generator=g, device=dev)}
                for _ in range(3)]
        kern, kl = parity_run(torch, dev, cfg, seed + 10,
                              batches[cfg.vocab_size], train.Adafactor())
        plain, pl = parity_run(torch, dev, dataclasses.replace(
            cfg, attn_impl='xla'), seed + 10, batches[cfg.vocab_size],
            train.Adafactor())
        runs[name] = kern
        rel = max_rel(kern, plain)
        per = 2 if cfg.remat else 1
        want = {n: c * 3 * cfg.n_layers for n, c in (
            ('flash_fwd', per), ('flash_dq', 1), ('flash_dkv', 1),
            ('flash_fwd.f32', per), ('flash_dq.f32', 1),
            ('flash_dkv.f32', 1))}
        log(f'9b {name}: (loss, grad_norm) kernels {kern} vs plain {plain}, '
            f'max rel diff {rel:.3g}; launches {kl}')
        check(rel <= 1e-4, f'{name}: kernels and plain attention differ by '
              f'{rel:.3g} (bar 1e-4)')
        check(kl == want, f'{name}: launches {kl}, want {want}')
        check(not pl, f'{name}: the plain run launched {pl}')
    full = runs['tpu_1b remat=True']
    for r in ('dots', 'qkvo', 'kvo'):
        rel = max_rel(runs[f'tpu_1b remat={r!r}'], full)
        log(f"9b tpu_1b remat={r!r} against remat=True: max rel diff "
            f'{rel:.3g} (bitwise: {runs[f"tpu_1b remat={r!r}"] == full})')
        check(rel <= 1e-5, f'remat={r!r} differs from remat=True by {rel:.3g}')
    srt = runs['tpu_moe_1b sorted remat=True']
    dense = runs['tpu_moe_1b dense remat=True']
    no_remat = runs['tpu_moe_1b sorted remat=False']
    loss_rel = max(abs(a[0] - b[0]) / b[0] for a, b in zip(dense, srt))
    gn_rel = max(abs(a[1] - b[1]) / b[1] for a, b in zip(no_remat, srt))
    log(f'9b tpu_moe_1b: dense against sorted loss max rel diff '
        f'{loss_rel:.3g}; remat False against True grad_norm max rel diff '
        f'{gn_rel:.3g}')
    check(loss_rel <= 1e-5, f'MoE sorted and dense losses differ by '
          f'{loss_rel:.3g}')
    check(gn_rel <= 1e-5, f'MoE remat False and True grad_norms differ by '
          f'{gn_rel:.3g}')
    dots = runs["tpu_moe_1b sorted remat='dots'"]
    rel = max_rel(dots, srt)
    log(f"9b tpu_moe_1b sorted remat='dots' against remat=True: max rel "
        f'diff {rel:.3g} (bitwise: {dots == srt})')
    check(rel <= 1e-5, f"MoE remat='dots' differs from remat=True by "
          f'{rel:.3g}')
    # Adafactor on the card against the same update on the CPU.
    gen = torch.Generator().manual_seed(seed + 11)
    shapes = {'emb': (512, 256), 'bank': (2, 4, 256, 128), 'w': (2, 128, 384),
              'norm': (2, 256), 'bias': (7,)}
    host = {k: torch.randn(s, generator=gen) for k, s in shapes.items()}
    host['bias'].zero_()
    card = {k: t.to(dev) for k, t in host.items()}
    opt = train.Adafactor()
    hs, cs = opt.init(host), opt.init(card)
    for _ in range(3):
        grads = [torch.randn(t.shape, generator=gen) for t in host.values()]
        hs = opt.update(grads, None, hs, list(host.values()))
        cs = opt.update([x.to(dev) for x in grads], None, cs,
                        list(card.values()))
    err = {k: ((card[k].cpu() - host[k]).abs() -
               1e-5 * host[k].abs()).max().item() for k in host}
    log(f'9b Adafactor CUDA against CPU after 3 steps: max(|diff| - 1e-5 '
        f'|p|) per leaf {err}')
    check(all(e <= 1e-6 for e in err.values()),
          f'Adafactor on the card differs from the CPU: {err}')


TRAIN_KERNELS = ('flash_fwd', 'flash_dq', 'flash_dkv', 'flash_fwd.f32',
                 'flash_dq.f32', 'flash_dkv.f32')


def active_params(cfg, n_params):
    """``bench.py``'s active params: a MoE token runs top_k of the
    n_experts SwiGLU banks."""
    n_experts = getattr(cfg, 'n_experts', None)
    if n_experts is None:
        return n_params
    return n_params - ((n_experts - cfg.top_k) * 3 * cfg.dim * cfg.ffn_dim *
                       cfg.n_layers)


def train_cell(torch, dev, tag, cfg, batch_size, seq, steps, seed, card,
               saved_bytes=False, profile_dir=None, spy=None):
    """One training cell of ``bench.py``: ``init_train_state`` of the
    config's family with ``Adafactor(3e-4)``, one batch of random tokens
    from the seed, a warm-up step, then ``steps`` timed steps. With
    ``saved_bytes``, first one loss forward with gradients on: the bytes
    it leaves allocated for the backward. ``spy`` is called around the
    warm-up step (True before, False after). Returns the cell's numbers
    (and prints them)."""
    from skypilot_tpu_torch import models
    from skypilot_tpu_torch.models import train
    from skypilot_tpu_torch.ops import _build
    fam = models.family(cfg)
    t0 = time.perf_counter()
    state, opt = train.init_train_state(cfg, seed, device=dev,
                                        optimizer=train.Adafactor(3e-4))
    n_params = fam.num_params(cfg)
    g = torch.Generator(device=dev).manual_seed(seed + 5)
    batch = {'tokens': torch.randint(0, cfg.vocab_size,
                                     (batch_size, seq + 1), generator=g,
                                     device=dev)}
    torch.cuda.synchronize()
    log(f'{tag}: {n_params / 1e9:.3f}B params in {cfg.param_dtype}, '
        f'remat={cfg.remat!r}, Adafactor(3e-4), batch {batch_size} x seq '
        f'{seq}; init {time.perf_counter() - t0:.1f} s')
    saved = None
    if saved_bytes:
        leaves = train._leaves(state.params)
        for p in leaves:
            p.requires_grad_(True)
        before = torch.cuda.memory_allocated()
        loss = fam.loss_fn(state.params, batch, cfg)
        saved = torch.cuda.memory_allocated() - before
        del loss, leaves
    step_fn = train.make_train_step(cfg, opt)
    torch.cuda.reset_peak_memory_stats()
    if spy:
        spy(True)
    t0 = time.perf_counter()
    state, m = step_fn(state, batch)             # warm-up
    torch.cuda.synchronize()
    if spy:
        spy(False)
    log(f'{tag}: warm-up step {time.perf_counter() - t0:.3f} s')
    rows = [(m['loss'].item(), m['grad_norm'].item())]
    per_step, times = [], []
    _build.reset_launches()
    for _ in range(steps):
        before = {n: _build.LAUNCHES[n] for n in TRAIN_KERNELS}
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        per_step.append({n: _build.LAUNCHES[n] - before[n]
                         for n in TRAIN_KERNELS})
        rows.append((m['loss'].item(), m['grad_norm'].item()))
    launches = {n: _build.LAUNCHES[n] for n in TRAIN_KERNELS}
    step_s = sum(times) / steps
    tok_s = batch_size * seq / step_s
    n_active = active_params(cfg, n_params)
    flops_per_token = 6 * n_active + 6 * cfg.n_layers * seq * cfg.dim
    tflop = flops_per_token * batch_size * seq / 1e12
    mfu = tok_s * flops_per_token / PEAK_OPS_PER_S['bfloat16']
    peak = torch.cuda.max_memory_allocated()
    active = '' if n_active == n_params else \
        f' (active params {n_active:,})'
    log(f'{tag}: step times {[round(t, 4) for t in times]} s, mean '
        f'{step_s:.4f} s = {tok_s:.1f} tokens/s, {tflop:.1f} TFLOP a step'
        f'{active}, MFU {100 * mfu:.2f}% of the bf16 dense peak on {card}; '
        f'peak memory {peak / 2**30:.2f} GiB' +
        ('' if saved is None else f'; saved bytes {saved:,} '
         f'({saved / 2**30:.3f} GiB)'))
    log(f'{tag}: (loss, grad_norm) per step ' +
        ', '.join(f'({lo:.6f}, {gn:.6f})' for lo, gn in rows))
    log(f'{tag}: launches per step {per_step}')
    busy = None
    if profile_dir:
        busy, _, _ = profile_run(torch, lambda: step_fn(state, batch),
                                 profile_dir, tag.split()[0])
        log(f'profile: device idle share of a {tag} step '
            f'{1 - busy / step_s:.3f} (busy {busy:.3f} s against the mean '
            f'step {step_s:.3f} s)')
    check(all(math.isfinite(lo) and math.isfinite(gn) and gn > 0
              for lo, gn in rows), f'{tag}: a loss or grad_norm is not '
          'finite, or a grad_norm is 0')
    check(rows[-1][0] < rows[0][0],
          f'{tag}: loss did not fall on the repeated batch: {rows}')
    check(state.step == steps + 1, f'{tag}: state.step is {state.step}')
    want = {n: 0 for n in TRAIN_KERNELS}
    want.update(flash_fwd=2 * cfg.n_layers, flash_dq=cfg.n_layers,
                flash_dkv=cfg.n_layers)
    check(all(p == want for p in per_step),
          f'{tag}: launches per step {per_step}, want {want} (remat reruns '
          'K4; bf16 takes no f32 route)')
    del state, opt, step_fn, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {'rows': rows, 'saved': saved, 'step_s': step_s, 'tok_s': tok_s,
            'mfu': mfu, 'peak': peak, 'launches': launches}


TRAIN_POLICIES = (True, 'kvo', 'qkvo', 'dots')


def phase_train_kvo_cell(torch, dev, seed, card, profile_dir=None):
    """14a. ``bench.py``'s ``train`` cell: tpu_1b at max_seq 8192 in
    bf16, all 16 layers, B 4 x S 8192, under remat True, 'kvo', 'qkvo'
    and 'dots' from the same seed, each 1 warm-up and 2 timed steps
    ('kvo', the reference bench's default, profiled with
    ``profile_dir``). Gates: first-step loss bitwise equal across the four, grad_norm
    within rtol 1e-3; K4 32, K5a 16, K5b 16 a step on the bf16 route;
    saved bytes ordered True < 'kvo' < 'qkvo' < 'dots', 'qkvo' - 'kvo'
    within 15% of q's bytes (16 x B S H D x 2 = 2.15 GB) and 'kvo' -
    True within 15% of k, v and o's (4.29 GB); the loss falls, every
    value finite."""
    from skypilot_tpu_torch.models import llama
    b, s = 4, 8192
    cells = {}
    for remat in TRAIN_POLICIES:
        cfg = llama.LlamaConfig.tpu_1b(max_seq=s, param_dtype=torch.bfloat16,
                                       loss_chunk=1024, remat=remat)
        cells[remat] = train_cell(
            torch, dev, f'14a train remat={remat!r}', cfg, b, s, 2, seed,
            card, saved_bytes=True,
            profile_dir=profile_dir if remat == 'kvo' else None)
    first = {r: c['rows'][0] for r, c in cells.items()}
    loss0 = {r: lo for r, (lo, _) in first.items()}
    gn0 = {r: gn for r, (_, gn) in first.items()}
    gn_rel = max(abs(gn - gn0[True]) / gn0[True] for gn in gn0.values())
    log(f'14a first-step loss by policy {loss0} (bitwise equal: '
        f'{len(set(loss0.values())) == 1}); grad_norm {gn0} (bitwise equal: '
        f'{len(set(gn0.values())) == 1}, max rel diff {gn_rel:.3g})')
    check(len(set(loss0.values())) == 1,
          f'14a: first-step losses differ across policies: {loss0}')
    check(gn_rel <= 1e-3, f'14a: first-step grad_norms differ by {gn_rel:.3g}')
    cfg = llama.LlamaConfig.tpu_1b()
    q_bytes = cfg.n_layers * b * s * cfg.n_heads * cfg.head_dim * 2
    kvo_bytes = cfg.n_layers * b * s * (2 * cfg.n_kv_heads +
                                        cfg.n_heads) * cfg.head_dim * 2
    saved = {r: c['saved'] for r, c in cells.items()}
    d_q = saved['qkvo'] - saved['kvo']
    d_kvo = saved['kvo'] - saved[True]
    log(f'14a saved bytes by policy {saved}; qkvo - kvo {d_q:,} against q '
        f'{q_bytes:,} ({d_q / q_bytes:.4f}x); kvo - True {d_kvo:,} against '
        f'k, v and o {kvo_bytes:,} ({d_kvo / kvo_bytes:.4f}x)')
    check(saved[True] < saved['kvo'] < saved['qkvo'] < saved['dots'],
          f'14a: saved bytes out of order: {saved}')
    check(abs(d_q - q_bytes) <= 0.15 * q_bytes,
          f"14a: 'qkvo' - 'kvo' = {d_q:,} bytes, not within 15% of q's "
          f'{q_bytes:,}')
    check(abs(d_kvo - kvo_bytes) <= 0.15 * kvo_bytes,
          f"14a: 'kvo' - True = {d_kvo:,} bytes, not within 15% of k, v and "
          f"o's {kvo_bytes:,}")
    return {f'14a {r!r}': c['launches'] for r, c in cells.items()}


def phase_moe_train_cell(torch, dev, seed, card, profile_dir=None):
    """14b. ``bench.py``'s ``moe_train`` cell: tpu_moe_1b at max_seq 8192
    in bf16, all 16 layers, cf 1.0, remat 'dots', sorted dispatch (2048
    slot rows an expert), B 1 x S 8192, 1 warm-up and 3 timed steps; the
    share of assignments dropped in the warm-up step's routing (its
    forward and the backward's rerun), and by layer beside how far the
    router's inputs share one direction; the rerun must route as the
    forward did; MFU against the active params."""
    from skypilot_tpu_torch.models import moe
    cfg = moe.MoEConfig.tpu_moe_1b(max_seq=8192, param_dtype=torch.bfloat16,
                                   capacity_factor=1.0, remat='dots',
                                   loss_chunk=1024, dispatch='sorted')
    kept, shared = [], []
    orig_assign, orig_sorted = moe._sorted_assignment, moe._moe_sorted

    def record_assign(idx, *a):
        out = orig_assign(idx, *a)
        kept.append(out[2])
        return out

    def record_sorted(xf, lp, c, *a):
        # How far the router's inputs share one direction: the squared
        # norm of the mean unit row (the mean pairwise cosine, self pairs
        # included).
        unit = torch.nn.functional.normalize(xf.detach().float(), dim=-1)
        shared.append(unit.mean(0).square().sum())
        return orig_sorted(xf, lp, c, *a)

    def spy(on):
        moe._sorted_assignment = record_assign if on else orig_assign
        moe._moe_sorted = record_sorted if on else orig_sorted

    try:
        cell = train_cell(torch, dev, '14b moe_train', cfg, 1, 8192, 3, seed,
                          card, profile_dir=profile_dir, spy=spy)
    finally:
        moe._sorted_assignment, moe._moe_sorted = orig_assign, orig_sorted
    n = cfg.n_layers
    keep = torch.cat(kept).float()
    log(f'14b moe_train: {int(keep.numel() - keep.sum().item()):,} of '
        f'{keep.numel():,} expert assignments dropped at capacity '
        f'{moe._capacity(cfg, 8192)} ({100 * (1 - keep.mean().item()):.3f}%)'
        f', over {len(kept)} routings of the warm-up step')
    per_layer = [100 * (1 - k.float().mean().item()) for k in kept[:n]]
    cosine = [c.item() for c in shared[:n]]
    log('14b moe_train: dropped share by layer (%) ' +
        ', '.join(f'{d:.2f}' for d in per_layer) + '; mean pairwise cosine '
        'of the router inputs by layer ' +
        ', '.join(f'{c:.3f}' for c in cosine))
    # The backward reruns each layer's routing ('dots' keeps the router
    # product, not the top-k), last layer first: it must keep and drop
    # what the forward did.
    check(len(kept) == 2 * n, f'14b: {len(kept)} routings in the warm-up '
          f'step, want {2 * n} (the forward and the backward\'s rerun)')
    same = [bool(torch.equal(kept[li], kept[2 * n - 1 - li]))
            for li in range(min(n, len(kept) - n))]
    log(f'14b moe_train: the backward\'s rerun keeps what the forward kept, '
        f'by layer: {same}')
    check(all(same), '14b: the backward\'s rerun of the routing kept other '
          'assignments than the forward')
    return {'14b moe_train': cell['launches']}


def phase_longctx_train_cell(torch, dev, seed, card, profile_dir=None):
    """14c. ``bench.py``'s ``longctx_train`` cell: tpu_1b at max_seq 32768
    in bf16, all 16 layers, remat 'kvo', B 1 x S 32768, 1 warm-up and 2
    timed steps."""
    from skypilot_tpu_torch.models import llama
    cfg = llama.LlamaConfig.tpu_1b(max_seq=32768, param_dtype=torch.bfloat16,
                                   loss_chunk=1024, remat='kvo')
    cell = train_cell(torch, dev, '14c longctx_train', cfg, 1, 32768, 2,
                      seed, card, profile_dir=profile_dir)
    return {'14c longctx_train': cell['launches']}


def phase_gpt2_train_cell(torch, dev, seed, card, profile_dir=None):
    """14d. GPT-2 124M training: ``GPT2Config.gpt2()`` in bf16, remat
    'dots', B 8 x S 1024, 1 warm-up and 3 timed steps: K4 24, K5a 12,
    K5b 12 a step on the bf16 route at head_dim 64."""
    from skypilot_tpu_torch.models import gpt2
    cfg = gpt2.GPT2Config.gpt2(param_dtype=torch.bfloat16, remat='dots',
                               loss_chunk=1024)
    cell = train_cell(torch, dev, '14d gpt2_train', cfg, 8, 1024, 3, seed,
                      card, profile_dir=profile_dir)
    return {'14d gpt2_train': cell['launches']}


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
             list(Q1_EXTRA) + list(Q1_MOE))
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
    mix_head = q1_times(torch, dev, 8, *MIXTRAL_HEAD[1:], seed, out_f32=True,
                        plain=True)
    # Mixtral's expert leaves at 13b's decode (M 8): w_gate and w_up have
    # main's shape, w_down this one.
    mix_down = q1_times(torch, dev, 8, 14336, 4096, seed)
    log(f'Q1 Mixtral expert w_down M 8, K 14336, N 4096: kernel '
        f'{mix_down["ms"]:.4f} ms, bound {mix_down["bound_ms"]:.4f} '
        f'({mix_down["bound_by"]}), library (matmul(x, q.to(bf16)) * s) '
        f'{mix_down["library_ms"]:.4f}, dense bf16 {mix_down["dense_ms"]:.4f};'
        f' an expert\'s three products (w_gate and w_up as M 8, K 4096, '
        f'N 14336): kernel {2 * main["ms"] + mix_down["ms"]:.4f}, library '
        f'{2 * main["library_ms"] + mix_down["library_ms"]:.4f}, bound '
        f'{2 * main["bound_ms"] + mix_down["bound_ms"]:.4f}')
    log(f'Q1 Mixtral lm_head M 8, K 4096, N 32000 (f32 out): kernel '
        f'{mix_head["ms"]:.4f} ms, plain {mix_head["plain_ms"]:.4f}, bound '
        f'{mix_head["bound_ms"]:.4f} ({mix_head["bound_by"]}), library '
        f'(matmul(x, q.to(bf16)) * s) {mix_head["library_ms"]:.4f}, dense '
        f'bf16 {mix_head["dense_ms"]:.4f}; plan {mix_head["plan"]}')
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
                 lm_head_dense_f32_sum_ms=head_f32[8][0],
                 mixtral_lm_head={key: mix_head[key] for key in (
                     'ms', 'plain_ms', 'bound_ms', 'bound_by', 'library_ms',
                     'dense_ms', 'plan')},
                 mixtral_expert_w_down={key: mix_down[key] for key in (
                     'ms', 'bound_ms', 'bound_by', 'library_ms', 'dense_ms',
                     'plan')})
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
    port's ``quantize_params`` (the tree ``weight_quant``
    makes), 16 greedy tokens a request. The engine
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
    # The tree the weight_quant engine holds: the reference engine's
    # jitted rounding.
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
    replayed ``steps`` times between CUDA events; each replay writes each
    row's next column (its own count in the cache's device ``steps``).
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
    check(bool((cache['steps'] == steps).all()), 'decode step: the replays '
          'did not advance every row\'s write column')
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
    requests are cut to 96 (one and a half admission waves), and its 16
    layers to 8, to keep the script inside its time limit. Two runs in one call, weight-only and
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
    base = llama.LlamaConfig.tpu_1b(max_seq=1536, n_layers=8,
                                    param_dtype=torch.bfloat16)
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


# --------------------------------------------------------- MoE, GPT-2

# Mixtral's lm_head (f32 output) and the expert leaves at the capacity
# rows C that 13a's and 13b's tick shapes give them at cf 1.0 (decode
# batch 4: C 1; batch 8: C 2; a prefill tick of 256 tokens: C 64):
# (tag, M, K, N, f32 output).
Q1_MOE = (('mixtral lm_head M 8 (f32 out)', 8, 4096, 32000, True),
          ('expert w_gate/w_up C 1', 1, 4096, 14336, False),
          ('expert w_down C 1', 1, 14336, 4096, False),
          ('expert w_gate/w_up C 2', 2, 4096, 14336, False),
          ('expert w_down C 2', 2, 14336, 4096, False),
          ('expert w_gate/w_up C 64', 64, 4096, 14336, False),
          ('expert w_down C 64', 64, 14336, 4096, False))
MIXTRAL_HEAD = ('lm_head', 4096, 32000)


def moe_q1_per_forward(cfg, a8_prefill=False):
    """Q1 launches of one forward over int8 weights: per layer the four
    attention products (on ``_int_mm`` instead with ``prefill_a8`` in a
    prefill) and three per expert (the dropless loop runs every expert;
    ``qdot`` even under ``prefill_a8``), plus the lm_head."""
    per_layer = 3 * cfg.n_experts + (0 if a8_prefill else 4)
    return per_layer * cfg.n_layers + 1


def agreement(a, b):
    """Share of equal tokens, position by position, over all requests."""
    pairs = [(x, y) for ra, rb in zip(a, b) for x, y in zip(ra, rb)]
    return sum(x == y for x, y in pairs) / max(len(pairs), 1)


def phase_moe_parity(torch, dev, seed):
    """13a. Parity at Mixtral-8x7B width, depth 2, f32 (params and
    compute): ``MoEConfig.mixtral_8x7b(n_layers=2, max_seq=512)``, random
    weights from ``--seed``, phase 6's prompts (37, 127, 129, 250 tokens)
    and engine geometry, 16 greedy tokens a request. The engine's tokens
    must equal the port's ``reference_generate`` (``moe.forward_hidden(
    dropless=True)``, its attention K4 on the f32 route) with K1 and K2
    on their f32 routes; an int8-KV pass must finish through both
    kernels' int8 branches; an oracle-draft spec pass (K3) and the prefix
    cache (page 8, chunk 8, a shared 32-token prefix) must give the
    tokens of spec and cache off. ``quantize_params`` of the same tree:
    the engine's tokens must equal the re-prefill oracle's on the int8
    tree, every Q1 launch on its f32 route, Q1 = (decode steps + prefill
    ticks) x (28 x 2 + 1). ``infer_dispatch='capacity'`` at the auto cf
    must agree with dropless on at least 0.9 of the tokens (the
    reference's bar), and at cf 1.0 every request must finish; every
    engine's captures equal its keys, none after warmup. With
    ``prefill_a8`` on the int8 tree the expert products stay on Q1 and
    only the attention projections run ``torch._int_mm``, by launch
    count."""
    import dataclasses

    import numpy as np

    from skypilot_tpu_torch.models import inference, moe
    from skypilot_tpu_torch.models import quantization as qz
    from skypilot_tpu_torch.models.serving_engine import (Request,
                                                          ServingEngine)
    cfg = moe.MoEConfig.mixtral_8x7b(n_layers=2, max_seq=512,
                                     param_dtype=torch.float32,
                                     compute_dtype=torch.float32)
    t0 = time.perf_counter()
    params = moe.init_params(cfg, seed + 13, device=dev)
    torch.cuda.synchronize()
    log(f'moe parity: mixtral_8x7b width, {cfg.n_layers} layers, f32: '
        f'{qz.quantized_bytes(params) / 1e9:.2f} GB, init '
        f'{time.perf_counter() - t0:.1f} s')
    prompts = random_prompts([37, 127, 129, 250], cfg.vocab_size, seed + 3)
    lengths = [len(p) for p in prompts]
    toks = torch.zeros((len(prompts), max(lengths)), dtype=torch.int64,
                       device=dev)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = torch.tensor(p, device=dev)
    from skypilot_tpu_torch.ops import _build
    _build.reset_launches()
    want = inference.reference_generate(params, toks, lengths, cfg,
                                        16).tolist()
    torch.cuda.synchronize()
    k4 = dict(_build.LAUNCHES)
    check(k4.get('flash_fwd', 0) == 16 * cfg.n_layers ==
          k4.get('flash_fwd.f32', 0),
          f'moe parity: the oracle launched K4 {k4}, want 16 x '
          f'{cfg.n_layers} on the f32 route')

    def run(tag, tree, run_cfg, lookup=None, reqs=None, **kw):
        geo = dict(batch_size=4, max_prompt=256, max_seq=512,
                   prefill_chunk=128, prefill_budget=256, decode_chunk=8)
        geo.update(kw)
        eng = ServingEngine(tree, run_cfg, device=dev, **geo)
        warm(torch, eng, tag)
        if lookup is not None:
            eng._lookup = lookup
        reqs = reqs or [Request(i, p, max_new=16)
                        for i, p in enumerate(prompts)]
        steps0, ticks0 = eng.decode_steps_total, eng.prefill_ticks
        res, _, launches, _ = serve(torch, eng, reqs, tag)
        got = [res[r.request_id].tokens for r in reqs]
        check(all(res[r.request_id].status == 'finished' and
                  len(g) == r.max_new for g, r in zip(got, reqs)),
              f'{tag}: a request did not finish')
        steps = eng.decode_steps_total - steps0
        ticks = eng.prefill_ticks - ticks0
        # Oracle drafts all accept: such a run may take no decode step.
        check(launches.get('chunk_prefill.f32', 0) ==
              launches.get('chunk_prefill', 0) == ticks * cfg.n_layers > 0
              and launches.get('paged_decode.f32', 0) ==
              launches.get('paged_decode', 0) == steps * cfg.n_layers,
              f'{tag}: K1/K2 launches {launches}, want {steps} and {ticks} '
              f'x {cfg.n_layers}, all on the f32 route')
        log(f'{tag}: {sum(g == w for g, w in zip(got, want))}/{len(want)} '
            f'requests equal reference_generate; {steps} decode steps, '
            f'{ticks} prefill ticks; spec {eng.spec_stats()}; launches '
            f'{launches}')
        return got, launches, steps, ticks

    got, _, _, _ = run('moe parity (dropless)', params, cfg)
    check(got == want, f'moe parity: engine {got} != reference {want}')
    _, launches, _, _ = run('moe parity (int8 KV)', params, cfg,
                            kv_quant=True)
    check(launches.get('paged_decode.int8', 0) > 0 and
          launches.get('chunk_prefill.int8', 0) > 0,
          'moe parity: the int8-KV pass did not run the int8 branches')
    spec, launches, _, _ = run('moe parity (spec, oracle drafts)', params,
                               cfg, oracle_lookup(prompts, want),
                               spec_decode=True, spec_k=4)
    check(spec == got, f'moe parity (spec): {spec} != spec off {got}')
    check(launches.get('verify_attention.f32', 0) ==
          launches.get('verify_attention', 0) > 0,
          f'moe parity (spec): K3 did not run on its f32 route: {launches}')
    rng = np.random.default_rng(seed + 14)
    base = rng.integers(0, cfg.vocab_size, 32).tolist()
    shared = [base, base, base[:16] + rng.integers(0, cfg.vocab_size,
                                                   12).tolist()]
    pre = {}
    for on in (True, False):
        tag = f'moe parity (prefix cache {"on" if on else "off"})'
        eng = ServingEngine(params, cfg, batch_size=2, max_prompt=64,
                            max_seq=128, prefill_chunk=8, prefill_budget=16,
                            decode_chunk=4, page=8, prefix_cache=on,
                            prefix_pool_pages=16, device=dev)
        warm(torch, eng, tag)
        pre[on] = []
        for i, p in enumerate(shared):     # one at a time: publish, hit
            res, _, _, _ = serve(torch, eng, [Request(i, p, max_new=8)], tag)
            pre[on].append(res[i].tokens)
        log(f'{tag}: prefix {eng.prefix and eng.prefix.stats()}')
        if on:
            check(eng.prefix.stats()['hits'] > 0, f'{tag}: no hit')
        del eng
    check(pre[True] == pre[False], f'moe parity: prefix cache on '
          f'{pre[True]} != off {pre[False]}')
    caps = {}
    for cf in (0.0, 1.0):
        tag = f'moe parity (capacity, cf {cf or "auto"})'
        cap_cfg = dataclasses.replace(cfg, infer_dispatch='capacity',
                                      infer_capacity_factor=cf)
        caps[cf], _, _, _ = run(tag, params, cap_cfg)
    share = agreement(caps[0.0], got)
    log(f'moe parity: capacity dispatch at the auto cf agrees with dropless '
        f'on {share:.4f} of the tokens; cf 1.0 on '
        f'{agreement(caps[1.0], got):.4f}')
    check(share >= 0.9, f'moe parity: capacity agrees with dropless on '
          f'{share:.4f} < 0.9 of the tokens')
    qp = qz.quantize_params(params)
    check(qp['layers']['router'] is params['layers']['router'],
          'moe parity: quantize_params did not keep the router dense')
    del params
    torch.cuda.empty_cache()
    oracle8 = reprefill_oracle(torch, inference, qp, cfg, prompts, 16)
    q8, launches, steps, ticks = run('moe parity (int8 weights)', qp, cfg)
    n_q1 = (steps + ticks) * moe_q1_per_forward(cfg)
    check(q8 == oracle8, f'moe parity (int8 weights): engine {q8} != '
          f're-prefill oracle {oracle8}')
    check(launches.get('int8_matmul', 0) == launches.get(
        'int8_matmul.f32', 0) == n_q1,
          f'moe parity (int8 weights): Q1 launches {launches}, want '
          f'{n_q1} on the f32 route')
    cfg_a8 = dataclasses.replace(cfg, prefill_a8=True)
    a8, launches, steps, ticks = run('moe parity (prefill_a8)', qp, cfg_a8)
    n_q1 = (steps * moe_q1_per_forward(cfg) +
            ticks * moe_q1_per_forward(cfg, a8_prefill=True))
    n_mm = ticks * 4 * cfg.n_layers
    log(f'moe parity (prefill_a8): equal to the weight-only tokens on '
        f'{sum(g == w for g, w in zip(a8, q8))}/{len(a8)}; Q1 '
        f'{launches.get("int8_matmul", 0)} (want {n_q1}), torch._int_mm '
        f'{launches.get("torch._int_mm", 0)} (want {n_mm})')
    check(launches.get('int8_matmul', 0) == n_q1 and
          launches.get('torch._int_mm', 0) == n_mm > 0,
          f'moe parity (prefill_a8): launches {launches}, want Q1 {n_q1} '
          f'and torch._int_mm {n_mm} (attention projections only)')
    del qp
    torch.cuda.empty_cache()


def phase_moe_main_path(torch, dev, seed, card, profile_dir,
                        handover=None):
    """13b. The MoE main path: ``MoEConfig.mixtral_8x7b(max_seq=1024,
    param_dtype=bfloat16)``, all 32 layers, born int8 from ``--seed``
    (``init_quantized_params``: the dense tree is never made), bf16 KV,
    phase 5's engine geometry and its 12 requests, dropless routing, on
    captured ticks and then eagerly in the same call. Gates on both runs:
    every request finishes with 32 in-vocab tokens; K1 = decode steps x
    32 and K2 = prefill ticks x 32 on the bf16 routes; Q1 = (decode steps
    + prefill ticks) x (28 x 32 + 1) on the bf16 route (each forward's
    four attention and 8 x 3 expert products a layer, plus the lm_head);
    captures equal keys, none after warmup. Prints output tokens/s of
    both runs and how many requests give equal tokens, TTFT and ITL,
    weight bytes, peak memory, the graph pool (``warm``); from a profiled
    repeat the device time by kernel group and the idle share; and the
    device ms of one captured decode step (batch 8, 512 tokens a row)
    beside its bound, the weight bytes a step reads over 3.35 TB/s.
    Then the same decode step with ``infer_dispatch='capacity'`` at cf
    1.0, timed beside it. Returns the graphed run's launch counts."""
    import dataclasses

    import numpy as np

    from skypilot_tpu_torch import metrics
    from skypilot_tpu_torch.models import inference, moe
    from skypilot_tpu_torch.models import quantization as qz
    from skypilot_tpu_torch.models.serving_engine import (Request,
                                                          ServingEngine)
    cfg = moe.MoEConfig.mixtral_8x7b(max_seq=1024,
                                     param_dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = qz.init_quantized_params(cfg, seed, device=dev)
    torch.cuda.synchronize()
    q_bytes = qz.quantized_bytes(params)
    log(f'moe main path: mixtral_8x7b {cfg.n_layers} layers born int8 in '
        f'{time.perf_counter() - t0:.1f} s: {q_bytes / 1e9:.3f} GB of '
        f'weights (bf16: {2 * moe.num_params(cfg) / 1e9:.3f} GB); memory '
        f'allocated {torch.cuda.memory_allocated() / 2**30:.2f} GiB')
    lengths = np.random.default_rng(seed + 1).integers(100, 513, 12)
    prompts = random_prompts(lengths, cfg.vocab_size, seed + 1)
    per_fwd = moe_q1_per_forward(cfg)
    n_l = cfg.n_layers
    runs = {}
    for graphs in (True, False):
        tag = 'moe main path' + ('' if graphs else ' (eager)')
        eng = ServingEngine(params, cfg, batch_size=8, max_prompt=512,
                            prefill_chunk=128, prefill_budget=256,
                            decode_chunk=8, device=dev)
        check(eng.params is params, f'{tag}: the born-int8 tree was copied')
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
        check(launches.get('paged_decode', 0) == steps * n_l > 0 and
              launches.get('chunk_prefill', 0) == ticks * n_l > 0 and
              not any(k.endswith('.f32') for k in launches),
              f'{tag}: K1/K2 launches {launches}, want {steps} x {n_l} and '
              f'{ticks} x {n_l}, none on a f32 route')
        want_q1 = (steps + ticks) * per_fwd
        check(launches.get('int8_matmul', 0) == want_q1 ==
              launches.get('int8_matmul.wgmma', 0),
              f'{tag}: Q1 launched {launches.get("int8_matmul", 0)} times, '
              f'want ({steps} + {ticks}) x {per_fwd} on the wgmma route')
        runs[graphs] = (out_toks / wall, toks, launches)
        if graphs:
            lat = latency_line(tag, card)
            idle, host_ms = profile_serve(torch, eng, prompts, profile_dir,
                                          tag, wall, n_ticks)
            groups = LAST_PROFILE.get('groups', {})
            busy_ms = sum(ms for ms, _ in groups.values())
            log(f'{tag}: device time by group (profiled repeat, '
                f'{busy_ms:.1f} ms busy; idle share {idle:.3f}, host '
                f'{host_ms:.2f} ms per tick): ' + ', '.join(
                    f'{g} {ms:.1f} ms ({100 * ms / max(busy_ms, 1e-9):.1f}%, '
                    f'{n} kernels)' for g, (ms, n) in sorted(
                        groups.items(), key=lambda kv: -kv[1][0])))
            log(f'{tag}: TTFT mean {lat["TTFT"][1] * 1e3:.1f} ms, ITL mean '
                f'{lat["ITL"][1] * 1e3:.1f} ms')
        del eng
    if handover is not None:
        # For 15c's Mixtral cell: the tokens, and the first chunk's and
        # decode step's logits, bf16 and exact (an f32 compute dtype).
        handover['main'] = prompts, runs[True][1]
        handover['logits'] = tp_step_logits(torch, params, cfg, dev, None,
                                            prompts)
        handover['exact'] = tp_step_logits(
            torch, params, dataclasses.replace(cfg,
                                               compute_dtype=torch.float32),
            dev, None, prompts, handover['logits']['next'])
    same = sum(a == b for a, b in zip(runs[True][1], runs[False][1]))
    log(f'moe main path on {card}: graphed {runs[True][0]:.1f} output '
        f'tokens/s, eager {runs[False][0]:.1f} in the same call '
        f'({runs[True][0] / runs[False][0]:.2f}x); {same}/{len(prompts)} '
        'requests give equal tokens graphed and eager')
    torch.cuda.empty_cache()
    # The byte bound of a decode step: every weight but the embedding
    # table (8 of its rows) is read once.
    emb = qz.quantized_bytes(params['tok_emb'])
    step_bytes = q_bytes - emb + emb * 8 // cfg.vocab_size
    step_ms = decode_step_ms(torch, inference, params, cfg, dev, batch=8,
                             context=512, max_seq=1024, steps=16,
                             kv_quant=False, seed=seed,
                             profile_tag='moe main path decode step')
    log(f'moe main path: one decode step (batch 8, 512 tokens a row, int8 '
        f'weights) {step_ms:.3f} device ms on {card}; bound '
        f'{step_bytes / HBM_BYTES_PER_S * 1e3:.3f} ms '
        f'({step_bytes / 1e9:.3f} GB of weights over 3.35 TB/s; '
        f'{100 * step_bytes / HBM_BYTES_PER_S * 1e3 / step_ms:.1f}% of it '
        'reached)')
    # Capacity dispatch at cf 1.0 (C = 2 rows an expert at batch 8) runs
    # every expert's products on fewer rows: the same weight bytes.
    cap_cfg = dataclasses.replace(cfg, infer_dispatch='capacity',
                                  infer_capacity_factor=1.0)
    cap_ms = decode_step_ms(torch, inference, params, cap_cfg, dev, batch=8,
                            context=512, max_seq=1024, steps=16,
                            kv_quant=False, seed=seed)
    log(f'moe main path: the same decode step with capacity dispatch at cf '
        f'1.0 (C 2 rows an expert) {cap_ms:.3f} device ms on {card} '
        f'({cap_ms / step_ms:.3f}x the dropless step)')
    del params
    torch.cuda.empty_cache()
    return runs[True][2]


def phase_gpt2(torch, dev, seed):
    """13c. GPT-2 124M (``GPT2Config.gpt2()``: f32 params, bf16 compute)
    forward at B 4 x S 1024 on random tokens from ``--seed``: finite f32
    logits of shape [4, 1024, 50304]; K4 launched 12 times (one forward,
    no grad), on the bf16 route at head_dim 64. Accuracy: two bf16
    forwards that round attention at different places part by more
    than the element-wise bf16 bar after 12 layers (the plain versions
    of K4 and of ``attn_impl='xla'`` already leave 7.9% of the logits
    beyond it on the CPU, B 1 x S 256), so each bf16 forward is held to
    the same forward in f32 with plain attention: the K4 forward's mean
    and max distance to it within 1.25x and 1.5x of the plain bf16
    forward's (``attn_impl='xla'``); the share of logits within the bf16
    bar of the plain bf16 forward is printed. ``loss_fn`` finite and
    within 1.0 of ln 50304; ``ServingEngine`` refuses the config with
    ``NotSupportedError``."""
    import dataclasses

    from skypilot_tpu_torch import exceptions
    from skypilot_tpu_torch.models import gpt2
    from skypilot_tpu_torch.models.serving_engine import ServingEngine
    from skypilot_tpu_torch.ops import _build
    cfg = gpt2.GPT2Config.gpt2()
    params = gpt2.init_params(cfg, seed, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 15)
    toks = torch.randint(0, cfg.vocab_size, (4, 1025), generator=gen,
                         device=dev)
    with torch.no_grad():
        _build.reset_launches()
        got = gpt2.forward(params, toks[:, :-1], cfg)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        plain = gpt2.forward(params, toks[:, :-1],
                             dataclasses.replace(cfg, attn_impl='xla'))
        exact = gpt2.forward(params, toks[:, :-1], dataclasses.replace(
            cfg, attn_impl='xla', compute_dtype=torch.float32))
        loss = float(gpt2.loss_fn(params, {'tokens': toks}, cfg))
    err = {name: (x - exact).abs() for name, x in (('K4', got),
                                                   ('plain', plain))}
    stats = {name: (float(e.max()), float(e.mean())) for name, e in
             err.items()}
    within = float(((got - plain).abs() <=
                    1e-2 + 2**-7 * plain.abs()).float().mean())
    finite = bool(torch.isfinite(got).all())
    log(f'gpt2 124M ({gpt2.num_params(cfg) / 1e6:.1f}M params) forward at '
        f'B 4 x S 1024: logits {tuple(got.shape)} {got.dtype}, finite '
        f'{finite}; distance to the f32 forward (max, mean): K4 '
        f'{stats["K4"][0]:.4g}, {stats["K4"][1]:.4g}; plain bf16 attention '
        f'{stats["plain"][0]:.4g}, {stats["plain"][1]:.4g}; '
        f'{100 * within:.3f}% of the logits within the bf16 bar of the '
        f'plain bf16 forward; loss {loss:.4f} (ln {cfg.vocab_size} = '
        f'{math.log(cfg.vocab_size):.4f}); launches {launches}')
    check(finite and got.dtype == torch.float32 and
          tuple(got.shape) == (4, 1024, cfg.vocab_size),
          'gpt2: logits not finite or misshapen')
    check(stats['K4'][1] <= 1.25 * stats['plain'][1] and
          stats['K4'][0] <= 1.5 * stats['plain'][0],
          f'gpt2: the K4 forward is further from the f32 forward '
          f'{stats["K4"]} than plain bf16 attention {stats["plain"]} allows')
    check(launches.get('flash_fwd', 0) == cfg.n_layers and
          'flash_fwd.f32' not in launches,
          f'gpt2: K4 launches {launches}, want {cfg.n_layers} on the bf16 '
          'route')
    check(math.isfinite(loss) and abs(loss - math.log(cfg.vocab_size)) < 1,
          f'gpt2: loss {loss} not within 1.0 of ln {cfg.vocab_size}')
    try:
        ServingEngine(params, cfg, device=dev)
    except exceptions.NotSupportedError as e:
        log(f'gpt2: the engine refuses the family: {e}')
    else:
        raise Failed('gpt2: ServingEngine took a GPT2Config')
    del params, got, plain, exact, err
    torch.cuda.empty_cache()


# ------------------------------------------------------------ phase 15
#
# Tensor-parallel serving. The card's machine has one H100: NCCL refuses
# two ranks on one device, so TP > 1 runs there over gloo with its ranks
# sharing the card (eagerly), and world size 1 runs over NCCL (graphed);
# NCCL at TP > 1 (15d) runs only where two or more cards are visible.

TP_WAYS = (2, 4)
# 15c's 8B bf16 worlds run this many of the 32 layers (the no-argument
# run's time: at 32 they took 198-273 s).
TP_GLOO_LAYERS = 8
# Q1's shard widths (leaf, K, N, parallel): the 8B layer (Mixtral's
# attention is the same; its experts are the 8B MLP's shapes) and both
# lm_heads. A column-parallel leaf splits N, a row-parallel one K (its
# output is the f32 partial the TP sum takes).
TP_Q1_LEAVES = (('wq/wo^T', 4096, 4096, 'col'), ('wk/wv', 4096, 1024, 'col'),
                ('wo', 4096, 4096, 'row'), ('w_gate/w_up', 4096, 14336, 'col'),
                ('w_down', 14336, 4096, 'row'),
                ('lm_head 8B', 4096, 128256, 'col'),
                ('lm_head Mixtral', 4096, 32000, 'col'))
TP_Q1_M = (8, 256)                    # a decode step's rows, a prefill tick's


def shard_of(t, dim, r, tp):
    """Rank ``r``'s contiguous block of ``t`` along the head axis ``dim``
    (a contiguous copy), as a rank's cache and projections hold it."""
    if t is None:
        return None
    n = t.shape[dim] // tp
    return t.narrow(dim, r * n, n).contiguous()


def tp_attention_cases(torch, dev, seed):
    """(label, LAUNCHES name, kind, args, {arg index: head axis}, output
    head axis, kernel call, plain call) of K1, K2 and K3 at the 8B serving
    shapes of phases 2, 3 and 3b, bf16 and int8 caches, NaN-poisoned."""
    from skypilot_tpu_torch.ops import decode_attention as da
    from skypilot_tpu_torch.ops import flash_attention as fa
    cases = []
    for kind in ('bf16', 'int8'):
        args, kw, _ = decode_inputs(torch, dev, kind, seed)
        cases.append((
            'K1', 'paged_decode', kind, args,
            {0: 1, 1: 2, 2: 2, 5: 1, 6: 1, 7: 2, 8: 2}, 1,
            lambda *a, kw=kw: da.paged_gqa_decode_attention(*a, **kw),
            lambda *a, kw=kw: da.paged_decode_reference(*a, **kw)))
        args = chunk_inputs(torch, dev, kind, seed)
        cases.append(('K2', 'chunk_prefill', kind, args,
                      {0: 2, 1: 2, 2: 2, 4: 2, 5: 2}, 2,
                      fa.chunk_prefill_attention,
                      fa.chunk_attention_reference))
        args, n_cols = verify_inputs(torch, dev, kind, seed)
        cases.append((
            'K3', 'verify_attention', kind, args,
            {0: 2, 1: 2, 2: 2, 5: 2, 6: 2}, 2,
            lambda *a, n=n_cols: fa.verify_attention(*a, n_cols=n),
            lambda *a, n=n_cols: verify_plain(fa, a, n)))
    return cases


def phase_tp_kernels(torch, dev, seed, report):
    """15a. The serving kernels at the shard shapes tensor parallelism
    gives them: K1, K2 and K3 at the 8B serving shapes (8 kv heads, 4
    query heads each) cut to n_kv 4 and 2 (tp 2 and 4), bf16 and int8
    caches, NaN wherever nothing may be read. Each rank's launch against
    its plain version within the bar, counting its route; the ranks'
    outputs concatenated over heads against the unsharded launch within
    the bar; a rank's kernel ms beside the unsharded shape's, and the
    split-KV plan (tiles a split) at both. Then Q1 at every shard width
    of the 8B and Mixtral layers and lm_heads at tp 2 and 4 (N / tp for
    a column-parallel leaf, K / tp for wo and w_down, whose f32 output is
    the partial the TP sum takes), at M 8 and 256, by Q1's rule
    (``q1_check``) and through ``int8_matmul.plan``, with its device ms
    at M 8 beside the unsharded shape's."""
    from skypilot_tpu_torch.ops import _build, split_kv
    entries = {e['name']: e for e in report}
    n_sm = split_kv.sm_count(dev)
    for label, name, kind, args, heads, out_dim, call, plain in \
            tp_attention_cases(torch, dev, seed):
        whole = call(*args)
        n_kv = args[1].shape[2]
        b_rows = args[1].shape[0]
        s_tiles = -(-args[1].shape[1] // split_kv.TILE)
        nbytes = sum(a.numel() * a.element_size() for a in args
                     if isinstance(a, torch.Tensor))
        full_ms = time_ms(call, copies_of(args, nbytes))
        line = {}
        for tp in TP_WAYS:
            outs, err = [], 0.0
            for r in range(tp):
                sargs = tuple(shard_of(a, heads[i], r, tp) if i in heads
                              else a for i, a in enumerate(args))
                _build.reset_launches()
                got = call(*sargs)
                launches = dict(_build.LAUNCHES)
                want = plain(*sargs)
                torch.cuda.synchronize()
                e, ok = compare(got, want)
                finite = bool(torch.isfinite(got.float()).all())
                route = route_launches(name, kind)
                check(launches == route, f'15a {label} {kind} tp {tp} rank '
                      f'{r}: launches {launches}, want {route}')
                check(ok and finite, f'15a {label} {kind} tp {tp} rank {r} '
                      f'disagrees with its plain version ({e:.3g})')
                err = max(err, e)
                outs.append(got)
            cat_err, cat_ok = compare(torch.cat(outs, out_dim), whole)
            check(cat_ok, f'15a {label} {kind} tp {tp}: the ranks\' outputs '
                  f'concatenated disagree with the unsharded launch '
                  f'({cat_err:.3g})')
            sargs = tuple(shard_of(a, heads[i], 0, tp) if i in heads else a
                          for i, a in enumerate(args))
            ms = time_ms(call, copies_of(sargs, nbytes // tp))
            _build.reset_launches()
            line[tp] = {'n_kv': n_kv // tp, 'max_abs_err': err,
                        'concat_max_abs_err': cat_err, 'ms': ms}
            plan = ''
            if name != 'chunk_prefill':       # the split-KV kernels
                line[tp]['tiles_per_split'] = split_kv.tiles_per_split(
                    b_rows * n_kv // tp, s_tiles, n_sm)
                plan = (f'; split-KV tiles a split '
                        f'{line[tp]["tiles_per_split"]} vs '
                        f'{split_kv.tiles_per_split(b_rows * n_kv, s_tiles, n_sm)}'
                        ' unsharded')
            log(f'15a {label} {kind} tp {tp}: n_kv {n_kv // tp} a rank, '
                f'rank vs plain max_abs_err {err:.3g}, ranks concatenated '
                f'vs unsharded {cat_err:.3g}, launches a rank {route}; '
                f'kernel {ms:.4f} ms a rank vs {full_ms:.4f} ms '
                f'unsharded{plan}')
        entry = entries.get(name)
        if entry is not None:
            entry.setdefault('tp_shards', {})[kind] = {
                'unsharded_ms': full_ms,
                **{f'tp{tp}': v for tp, v in line.items()}}
        del whole
    q1 = {}
    for leaf, k, n, par in TP_Q1_LEAVES:
        full = q1_times(torch, dev, 8, k, n, seed, out_f32=par == 'row')
        for tp in TP_WAYS:
            ks, ns = (k // tp, n) if par == 'row' else (k, n // tp)
            for m in TP_Q1_M:
                x, q, s = q1_inputs(torch, dev, m, ks, ns, torch.bfloat16,
                                    seed)
                q1_check(torch, x, q, s, f'15a {leaf} tp {tp} shard '
                         f'[{m}, {ks}] @ [{ks}, {ns}]',
                         out_f32=par == 'row' or leaf.startswith('lm_head'))
            t = q1_times(torch, dev, 8, ks, ns, seed, out_f32=par == 'row')
            q1[f'{leaf} tp{tp}'] = {'k': ks, 'n': ns, 'ms': t['ms'],
                                    'unsharded_ms': full['ms'],
                                    'bound_ms': t['bound_ms'],
                                    'library_ms': t['library_ms'],
                                    'plan': t['plan']}
            log(f'15a Q1 {leaf} tp {tp}: shard [8, {ks}] @ [{ks}, {ns}] '
                f'({par}-parallel) plan {t["plan"]}, {t["ms"]:.4f} ms (bound '
                f'{t["bound_ms"]:.4f}, library matmul(x, q.to(bf16)) * s '
                f'{t["library_ms"]:.4f}) vs unsharded [8, {k}] @ [{k}, {n}] '
                f'{full["ms"]:.4f} ms ({full["plan"]})')
    entry = entries.get('int8_matmul')
    if entry is not None:
        entry['tp_shards'] = q1


def free_port():
    import socket
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        return sock.getsockname()[1]


def tp_env(world, port):
    """The rank contract of a one-node world of ``world`` ranks."""
    from skypilot_tpu_torch.parallel import distributed as dist_lib
    return {dist_lib.NUM_NODES: '1',
            dist_lib.NUM_CHIPS_PER_NODE: str(world),
            dist_lib.NODE_RANK: '0',
            dist_lib.COORDINATOR_ADDR: f'127.0.0.1:{port}'}


def tp_step_logits(torch, params, cfg, dev, mesh, prompts, nxt=None):
    """The first prefill chunk's logits of two requests (128 prompt
    tokens each, the engine's chunk) and the first decode step's after
    it, feeding ``nxt`` (default: the chunk's greedy tokens), on a fresh
    cache of the engine's geometry; f32 [2, vocab] each and the tokens
    fed, on the host."""
    from skypilot_tpu_torch.models import inference
    cache = inference.make_cache(cfg, 2, 1024, base=512, device=dev,
                                 mesh=mesh)
    lens = [min(128, len(p)) for p in prompts[:2]]
    toks = torch.zeros((2, 128), dtype=torch.int32, device=dev)
    for i, p in enumerate(prompts[:2]):
        toks[i, :lens[i]] = torch.tensor(p[:lens[i]], device=dev)
    pre, _ = inference.prefill_chunk(params, cache, toks, [0, 0], lens,
                                     [True, True], [0, 1], cfg,
                                     prompt_base=512, mesh=mesh)
    if nxt is None:
        nxt = torch.argmax(pre, dim=-1).to(torch.int32).cpu()
    dec, _ = inference.decode_step(params, cache, nxt.to(dev), cfg,
                                   page=128, mesh=mesh)
    return {'prefill': pre.cpu(), 'decode': dec.cpu(), 'next': nxt}


def tp_job(torch, mesh, dev, job):
    """One cell of a TP world, on this rank: its shard of the job's
    model (random from the seed, born int8 where ``quant``), the step
    logits (``tp_step_logits``) where asked, then the TP engine serving
    the job's prompts (rank 0; the workers replay). Rank 0 returns the
    tokens, the step logits, the wall time, the ticks, the kernel and
    collective launches and the host seconds in all-reduces."""
    from skypilot_tpu_torch import models
    from skypilot_tpu_torch.models import quantization as qz
    from skypilot_tpu_torch.models.serving_engine import (Request,
                                                          ServingEngine,
                                                          serve_worker)
    from skypilot_tpu_torch.ops import _build
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    cfg = job['cfg']
    cuda = dev.type == 'cuda'
    t0 = time.perf_counter()
    if job.get('quant'):
        params = qz.init_quantized_params(cfg, job['seed'], device=dev,
                                          mesh=mesh)
    else:
        params = models.family(cfg).init_params(cfg, job['seed'],
                                                device=dev, mesh=mesh)
    if cuda:
        torch.cuda.synchronize()
    out = {'init_s': time.perf_counter() - t0,
           'weight_gb': qz.quantized_bytes(params) / 1e9}
    if job.get('next') is not None:
        out['logits'] = tp_step_logits(torch, params, cfg, dev, mesh,
                                       job['prompts'], job['next'])
    kw = dict(job['engine_kw'], device=dev)
    if mesh.rank:
        serve_worker(mesh, params, cfg, **kw)
        return out
    eng = ServingEngine(params, cfg, mesh=mesh, **kw)
    try:
        t0 = time.perf_counter()
        eng.warmup()
        if cuda:
            torch.cuda.synchronize()
        out['warmup_s'] = time.perf_counter() - t0
        out['graphs'] = eng.graph_captures
        out['mesh'] = eng.mesh_info()
        reqs = [Request(i, p, max_new=job['max_new'])
                for i, p in enumerate(job['prompts'])]
        steps0, ticks0 = eng.decode_steps_total, eng.prefill_ticks
        spent = [0.0, 0]
        reduce = mesh_lib.Mesh.all_reduce

        def timed(self, t, op='sum'):
            t1 = time.perf_counter()
            try:
                return reduce(self, t, op)
            finally:
                spent[0] += time.perf_counter() - t1
                spent[1] += 1
        mesh_lib.Mesh.all_reduce = timed
        _build.reset_launches()
        t0 = time.perf_counter()
        try:
            res = eng.run(reqs)
            if cuda:
                torch.cuda.synchronize()
        finally:
            mesh_lib.Mesh.all_reduce = reduce
        out['wall'] = time.perf_counter() - t0
        out['launches'] = dict(_build.LAUNCHES)
        out['all_reduce_s'], out['all_reduces'] = spent
        out['steps'] = eng.decode_steps_total - steps0
        out['ticks'] = eng.prefill_ticks - ticks0
        out['tokens'] = [res[i].tokens for i in range(len(reqs))]
        out['finished'] = all(r.status == 'finished' for r in res.values())
        out['peak_gib'] = (torch.cuda.max_memory_allocated(dev) / 2**30
                           if cuda else 0.0)
    finally:
        eng.close()
    return out


def tp_rank(rank, world, port, backend, jobs_path, out_path, root,
            device_type='cuda', axes=None):
    """A spawned rank of a world (``multiprocessing`` spawn): join the
    group from the rank contract, build the mesh (``axes``, default tp =
    world), run every job of ``jobs_path`` on this rank's shard (a job
    with ``train`` set through ``sharded_train_job``, else ``tp_job``),
    and pickle its results to ``out_path``.<rank>. ``device_type`` 'cpu'
    rehearses a world without a card."""
    import pickle
    import traceback
    sys.path.insert(0, root)
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = {}
    try:
        from skypilot_tpu_torch.parallel import distributed as dist_lib
        from skypilot_tpu_torch.parallel import make_mesh
        # The ranks share the host's cores: a share of them each (one
        # thread a rank slowed tp 2's gloo all-reduces, the default of
        # every core a rank slowed tp 4's).
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        if device_type == 'cuda':
            dev = torch.device('cuda', rank if backend == 'nccl' else 0)
            torch.cuda.set_device(dev)
        else:
            dev = torch.device('cpu')
        dist_lib.initialize_from_env(tp_env(world, port), backend=backend,
                                     local_rank=rank)
        mesh = make_mesh(device=dev, **(axes or {'tp': world}))
        with open(jobs_path, 'rb') as fh:
            jobs = pickle.load(fh)
        for job in jobs:
            if dev.type == 'cuda':
                torch.cuda.reset_peak_memory_stats(dev)
            run = sharded_train_job if job.get('train') else tp_job
            result[job['tag']] = run(torch, mesh, dev, job)
            if dev.type == 'cuda':
                torch.cuda.empty_cache()
        torch.distributed.destroy_process_group()
    except Exception as e:  # pylint: disable=broad-except
        result = {'error': f'rank {rank}: {type(e).__name__}: {e}\n'
                           f'{traceback.format_exc()}'}
    with open(f'{out_path}.{rank}', 'wb') as fh:
        pickle.dump(result, fh)


def run_tp_world(world, backend, jobs, tag, timeout_s=420,
                 device_type='cuda', axes=None, all_ranks=False):
    """Spawn a world of ``world`` ranks (spawn start method: no CUDA
    state crosses; ``axes`` the mesh's axis sizes, default tp = world),
    join each within ``timeout_s`` and return rank 0's results (every
    rank's, in rank order, with ``all_ranks``); a failing or hanging
    rank fails the phase."""
    import multiprocessing
    import pickle
    import tempfile
    tmp = tempfile.mkdtemp(prefix='tp_world_')
    jobs_path = os.path.join(tmp, 'jobs.pkl')
    out_path = os.path.join(tmp, 'out.pkl')
    with open(jobs_path, 'wb') as fh:
        pickle.dump(jobs, fh)
    ctx = multiprocessing.get_context('spawn')
    port = free_port()
    procs = [ctx.Process(target=tp_rank, args=(
        r, world, port, backend, jobs_path, out_path, sys.path[0],
        device_type, axes)) for r in range(world)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        for r, p in enumerate(procs):
            p.join(max(1.0, deadline - time.monotonic()))
            check(not p.is_alive(), f'{tag}: rank {r} of {world} still '
                  f'running after {timeout_s} s')
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(10)
    errors, every = [], []
    for r in range(world):
        path = f'{out_path}.{r}'
        if os.path.exists(path):
            with open(path, 'rb') as fh:
                res = pickle.load(fh)
            if 'error' in res:
                errors.append(res['error'])
            every.append(res)
    check(not errors, f'{tag}: ' + '\n'.join(errors))
    check(all(p.exitcode == 0 for p in procs), f'{tag}: exit codes '
          f'{[p.exitcode for p in procs]}')
    check(len(every) == world, f'{tag}: {len(every)} of {world} ranks left '
          'results')
    log(f'{tag}: world of {world} ({backend}) ran in '
        f'{time.perf_counter() - t0:.1f} s')
    return every if all_ranks else every[0]


def collectives_per_forward(cfg):
    """All-reduces one forward (a decode step, a prefill chunk, a verify
    segment) runs: the embedding, two a layer, the lm_head."""
    return 2 * cfg.n_layers + 2


def phase_tp_nccl_one(torch, dev, seed, card, handover):
    """15b. World size 1 over NCCL, through ``initialize_from_env`` with
    the contract's variables set here: phase 5's 8B model and 12 requests
    on the TP engine (``mesh=``), graphed. Its tokens must equal phase
    5's (12/12); captures must equal the keys, none after warmup; the
    collectives run inside the captured graphs (every graph holds its
    all-reduces, and the run's count equals (decode steps + prefill
    ticks) x (2 x 32 + 2)); K1/K2 counts as phase 5's. Then the same
    with speculation (``spec_k`` 4, prompt lookup) on phase 5's spec
    prompts: tokens equal to its graphed prompt-lookup run's, K3 on the
    TP path (verify ticks x 32 launches), the all-reduces (decode steps
    + prefill ticks + verify ticks) x 66. Returns the spec run's
    launches."""
    import torch.distributed as dist
    from skypilot_tpu_torch.models.serving_engine import (Request,
                                                          ServingEngine)
    from skypilot_tpu_torch.parallel import distributed as dist_lib
    from skypilot_tpu_torch.parallel import make_mesh
    cfg, params = handover['model']
    prompts, want = handover['main']
    env = tp_env(1, free_port())
    os.environ.update(env)
    try:
        dist_lib.initialize_from_env(backend='nccl')
        mesh = make_mesh(tp=1)
        check(mesh.backend == 'nccl' and mesh.collective,
              f'15b: mesh {mesh.info()}')
        eng = ServingEngine(params, cfg, batch_size=8, max_prompt=512,
                            prefill_chunk=128, prefill_budget=256,
                            decode_chunk=8, device=dev, mesh=mesh)
        warm(torch, eng, '15b tp 1 NCCL', True)
        per_graph = {k: g.launches.get('all_reduce.nccl', 0)
                     for k, g in eng._graphs.items()}
        check(all(n > 0 for n in per_graph.values()),
              f'15b: graphs without a captured all-reduce: '
              f'{[k for k, n in per_graph.items() if not n]}')
        reqs = [Request(i, p, max_new=32) for i, p in enumerate(prompts)]
        steps0, ticks0 = eng.decode_steps_total, eng.prefill_ticks
        res, wall, launches, n_ticks = serve(torch, eng, reqs, '15b')
        steps = eng.decode_steps_total - steps0
        ticks = eng.prefill_ticks - ticks0
        toks = [res[i].tokens for i in range(len(prompts))]
        same = sum(a == b for a, b in zip(toks, want))
        per = collectives_per_forward(cfg)
        out_toks = sum(map(len, toks))
        log(f'15b tp 1 over NCCL on {card}: {same}/{len(prompts)} requests '
            f'equal phase 5\'s tokens; {out_toks / wall:.1f} output tokens/s '
            f'(phase 5 graphed: {handover.get("rate", 0):.1f}); {n_ticks} '
            f'ticks ({steps} decode steps, {ticks} prefill ticks); '
            f'mesh_info {eng.mesh_info()}; launches {launches}')
        check(same == len(prompts), f'15b: {same}/{len(prompts)} requests '
              'equal phase 5\'s tokens')
        check(launches.get('all_reduce.nccl', 0) == (steps + ticks) * per,
              f'15b: {launches.get("all_reduce.nccl", 0)} all-reduces, want '
              f'({steps} + {ticks}) x {per}')
        check(launches.get('paged_decode', 0) == steps * cfg.n_layers and
              launches.get('chunk_prefill', 0) == ticks * cfg.n_layers,
              f'15b: K1/K2 launches {launches}')
        del eng
        spec_prompts, spec_want = handover['spec']
        eng = ServingEngine(params, cfg, batch_size=8, max_prompt=512,
                            prefill_chunk=128, prefill_budget=256,
                            decode_chunk=8, spec_decode=True, spec_k=4,
                            device=dev, mesh=mesh)
        warm(torch, eng, '15b tp 1 NCCL (spec)', True)
        reqs = [Request(i, p, max_new=32)
                for i, p in enumerate(spec_prompts)]
        res, wall, launches, _ = serve(torch, eng, reqs, '15b (spec)')
        toks = [res[i].tokens for i in range(len(spec_prompts))]
        same = sum(a == b for a, b in zip(toks, spec_want))
        fwd = eng.decode_steps_total + eng.prefill_ticks + eng.spec_ticks
        log(f'15b tp 1 over NCCL, speculation on: {same}/{len(toks)} '
            f'requests equal phase 5\'s prompt-lookup run; '
            f'{sum(map(len, toks)) / wall:.1f} output tokens/s; '
            f'{eng.spec_ticks} verify ticks; launches {launches}')
        check(same == len(toks), f'15b (spec): {same}/{len(toks)}')
        check(launches.get('verify_attention', 0) ==
              eng.spec_ticks * cfg.n_layers > 0 and
              launches.get('all_reduce.nccl', 0) == fwd * per,
              f'15b (spec): launches {launches}, {fwd} forwards')
        del eng
        return launches
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            os.environ.pop(k, None)
    torch.cuda.empty_cache()


def tp_logits_gate(got, ref, exact, tag, card):
    """The TP step logits ``got`` against the unsharded model's ``ref``
    and the exact ones (``exact``: the same weights with an f32 compute
    dtype): printed with the element-wise bf16 bar's verdict, and held
    to no more than twice the unsharded bf16 model's own distance from
    the exact logits (+ 1e-4, for an f32 model whose distance is 0).
    Returns |got - ref| by step."""
    diffs, lines = {}, []
    for k in ('prefill', 'decode'):
        err, ok = compare(got[k], ref[k])
        diffs[k] = err
        tp_off = (got[k] - exact[k]).abs().max().item()
        own = (ref[k] - exact[k]).abs().max().item()
        lines.append(
            f'{k}: |tp - unsharded| {err:.3g} (element-wise bf16 bar '
            f'{"met" if ok else "not met"}), |tp - exact| {tp_off:.3g}, '
            f'|unsharded - exact| {own:.3g}, max |logit| '
            f'{exact[k].abs().max().item():.3g}')
        check(tp_off <= 2 * own + 1e-4, f'{tag}: the first {k} logits are '
              f'{tp_off:.3g} from the exact ones, past twice the unsharded '
              f'bf16 model\'s {own:.3g} (+ 1e-4)')
    log(f'{tag} logits on {card}: ' + '; '.join(lines))
    return diffs


def tp_margins(torch, params, cfg, dev, prompts, want, got):
    """For each request whose TP tokens part from ``want``: (request,
    first differing step, the unsharded top-2 logit margin there),
    the margin from a monolithic prefill of prompt + want[:step]."""
    from skypilot_tpu_torch.models import inference
    out = []
    for i, (a, b) in enumerate(zip(got, want)):
        j = first_divergence(a, b)
        if j is None:
            continue
        seq = list(prompts[i]) + list(b[:j])
        toks = torch.tensor([seq], dtype=torch.int64, device=dev)
        logits, _ = inference.prefill(params, toks, [len(seq)], cfg,
                                      max_seq=len(seq))
        top = torch.topk(logits[0].float(), 2).values
        out.append((i, j, float(top[0] - top[1])))
    return out


def phase_tp_gloo(torch, dev, seed, card, handover):
    """15c. Two and four ranks sharing the one card over gloo, eagerly
    (no graphs off NCCL). The 8B main path at full width in bf16, at
    ``TP_GLOO_LAYERS`` of its 32 layers (cut for the run's time; the
    model from ``--seed``, each rank building only its shard, and phase
    5's 12 requests) at tp 2 and 4. The first prefill chunk's
    and the first decode step's logits (the same tokens fed) against
    the unsharded model's: printed with the element-wise bf16 bar's
    verdict, and held to the unsharded bf16 model's own distance from
    the exact one (the same bf16 weights with an f32 compute dtype): the
    TP logits may be no farther from the exact ones than twice that.
    The greedy tokens against the unsharded model's (served eagerly
    here): where a request parts, the
    first step at which it does and the unsharded top-2 margin there, a
    divergence accepted only where that margin is below the measured
    logit difference. Then the 8B width at depth 2 in f32, where the
    tokens must equal the unsharded engine's 12/12. Prints output
    tokens/s and the host ms a forward in all-reduces (the
    gloo-on-one-card numbers, not a multi-GPU measurement)."""
    import dataclasses
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.models.serving_engine import (Request,
                                                          ServingEngine)
    full_cfg, _ = handover['model']
    prompts, _ = handover['main']
    engine_kw = dict(batch_size=8, max_prompt=512, prefill_chunk=128,
                     prefill_budget=256, decode_chunk=8)
    # The bf16 worlds at TP_GLOO_LAYERS of the 32 layers (the run's time):
    # their reference is the unsharded model of that depth from the same
    # seed, served eagerly here.
    cfg = dataclasses.replace(full_cfg, n_layers=TP_GLOO_LAYERS)
    params = llama.init_params(cfg, seed, device=dev)
    eng = ServingEngine(params, cfg, device=dev, **engine_kw)
    eng._graphs = None
    eng.warmup()
    res = eng.run([Request(i, p, max_new=32) for i, p in enumerate(prompts)])
    want = [res[i].tokens for i in range(len(prompts))]
    del eng
    ref = tp_step_logits(torch, params, cfg, dev, None, prompts)
    exact = tp_step_logits(torch, params, dataclasses.replace(
        cfg, compute_dtype=torch.float32), dev, None, prompts, ref['next'])
    torch.cuda.empty_cache()
    f32_cfg = dataclasses.replace(cfg, n_layers=2,
                                  param_dtype=torch.float32,
                                  compute_dtype=torch.float32)
    f32_params = llama.init_params(f32_cfg, seed, device=dev)
    eng = ServingEngine(f32_params, f32_cfg, device=dev, **engine_kw)
    eng._graphs = None
    eng.warmup()
    res = eng.run([Request(i, p, max_new=32) for i, p in enumerate(prompts)])
    f32_want = [res[i].tokens for i in range(len(prompts))]
    del eng, f32_params
    torch.cuda.empty_cache()
    jobs = [dict(tag='8B bf16', cfg=cfg, seed=seed, next=ref['next'],
                 prompts=prompts, max_new=32, engine_kw=engine_kw),
            dict(tag='8B f32 depth 2', cfg=f32_cfg, seed=seed,
                 prompts=prompts, max_new=32, engine_kw=engine_kw)]
    per = collectives_per_forward(cfg)
    summary = {}
    for tp in TP_WAYS:
        got = run_tp_world(tp, 'gloo', jobs, f'15c tp {tp}')
        main, f32 = got['8B bf16'], got['8B f32 depth 2']
        diffs = tp_logits_gate(main['logits'], ref, exact, f'15c tp {tp}',
                               card)
        measured = max(diffs.values())
        parts = tp_margins(torch, params, cfg, dev, prompts, want,
                           main['tokens'])
        unexplained = [p for p in parts if p[2] >= measured]
        same = len(prompts) - len(parts)
        steps, ticks = main['steps'], main['ticks']
        n_ticks = max(1, main['all_reduces'] // per)
        out_toks = sum(map(len, main['tokens']))
        log(f'15c tp {tp} on {card} (gloo, ranks sharing the card, eager): '
            f'8B bf16 logits vs unsharded: prefill {diffs["prefill"]:.3g}, '
            f'decode {diffs["decode"]:.3g}; {same}/{len(prompts)} requests '
            f'equal the unsharded model\'s tokens; divergences (request, '
            f'first step, '
            f'unsharded top-2 margin) {parts}; {out_toks / main["wall"]:.1f} '
            f'output tokens/s, {main["all_reduce_s"] * 1e3 / n_ticks:.2f} '
            f'host ms in all-reduces a forward ({main["all_reduces"]} '
            f'all-reduces, {main["all_reduce_s"]:.2f} s of {main["wall"]:.2f}'
            f' s wall); {steps} decode steps, {ticks} prefill ticks; '
            f'rank 0 weights {main["weight_gb"]:.2f} GB, peak '
            f'{main["peak_gib"]:.2f} GiB; mesh {main["mesh"]}; launches '
            f'{main["launches"]}')
        check(main['finished'] and all(len(t) == 32 for t in main['tokens']),
              f'15c tp {tp}: a request did not finish with 32 tokens')
        check(not unexplained, f'15c tp {tp}: divergences with a margin at '
              f'or above the measured logit difference {measured:.3g}: '
              f'{unexplained}')
        check(main['launches'].get('paged_decode', 0) == steps * cfg.n_layers
              and main['launches'].get('chunk_prefill', 0) ==
              ticks * cfg.n_layers,
              f'15c tp {tp}: K1/K2 launches {main["launches"]}')
        check(main['launches'].get('all_reduce.gloo', 0) ==
              (steps + ticks) * per, f'15c tp {tp}: all-reduces '
              f'{main["launches"].get("all_reduce.gloo", 0)}, want '
              f'({steps} + {ticks}) x {per}')
        f32_same = sum(a == b for a, b in zip(f32['tokens'], f32_want))
        log(f'15c tp {tp}: 8B width depth 2 f32: {f32_same}/{len(prompts)} '
            f'requests equal the unsharded engine\'s tokens')
        check(f32_same == len(prompts), f'15c tp {tp}: f32 depth 2 '
              f'{f32_same}/{len(prompts)}')
        summary[tp] = {'launches': main['launches'],
                       'rate': out_toks / main['wall'],
                       'logit_diff': diffs, 'same': same}
    handover['tp'] = summary
    return summary


def phase_tp_moe(torch, dev, seed, card, moe_handover, layers=32):
    """15c (MoE). Mixtral-8x7B width born int8 at tp 2 over gloo, both
    ranks on the one card (23 GB of weights a rank at 32 layers), phase
    13b's engine geometry and 12 requests, dropless routing, eagerly:
    every request finishes with 32 in-vocab tokens, K1/K2/Q1 launch a
    rank as 13b's per forward; where phase 13b ran in this call, the
    first chunk's and decode step's logits held as 15c's 8B ones
    (``tp_logits_gate``, 13b's model the unsharded one) and the tokens
    against 13b's, with where they part; output tokens/s and host ms in
    all-reduces."""
    import numpy as np
    from skypilot_tpu_torch.models import moe
    cfg = moe.MoEConfig.mixtral_8x7b(max_seq=1024, n_layers=layers,
                                     param_dtype=torch.bfloat16)
    lengths = np.random.default_rng(seed + 1).integers(100, 513, 12)
    prompts = random_prompts(lengths, cfg.vocab_size, seed + 1)
    l13 = moe_handover.get('main') if layers == 32 else None
    job = dict(tag='mixtral', cfg=cfg, seed=seed, quant=True,
               prompts=prompts, max_new=32,
               next=None if l13 is None else moe_handover['logits']['next'],
               engine_kw=dict(batch_size=8, max_prompt=512,
                              prefill_chunk=128, prefill_budget=256,
                              decode_chunk=8))
    got = run_tp_world(2, 'gloo', [job], '15c Mixtral tp 2')['mixtral']
    per = collectives_per_forward(cfg)
    steps, ticks = got['steps'], got['ticks']
    out_toks = sum(map(len, got['tokens']))
    same = parts = None
    if l13 is not None:
        tp_logits_gate(got['logits'], moe_handover['logits'],
                       moe_handover['exact'], '15c Mixtral tp 2', card)
        same = sum(a == b for a, b in zip(got['tokens'], l13[1]))
        parts = [(i, first_divergence(a, b)) for i, (a, b) in
                 enumerate(zip(got['tokens'], l13[1])) if a != b]
    log(f'15c Mixtral-8x7B width, {layers} layers, born int8, tp 2 on {card}'
        f' (gloo, both ranks on the card, eager): {out_toks} output tokens '
        f'in {got["wall"]:.2f} s = {out_toks / got["wall"]:.1f} tokens/s; '
        f'{got["all_reduce_s"] * 1e3 / max(1, steps + ticks):.2f} host ms in'
        f' all-reduces a forward; rank 0 weights {got["weight_gb"]:.2f} GB, '
        f'peak {got["peak_gib"]:.2f} GiB; '
        + (f'{same}/12 requests equal 13b\'s unsharded tokens (the '
           f'others part at (request, step) {parts}); '
           if same is not None else '13b did not run in this call; ')
        + f'launches {got["launches"]}')
    check(got['finished'] and all(
        len(t) == 32 and all(0 <= x < cfg.vocab_size for x in t)
        for t in got['tokens']), '15c Mixtral: a request did not finish '
        'with 32 in-vocab tokens')
    check(got['launches'].get('paged_decode', 0) == steps * layers and
          got['launches'].get('chunk_prefill', 0) == ticks * layers and
          got['launches'].get('int8_matmul', 0) ==
          (steps + ticks) * moe_q1_per_forward(cfg) and
          got['launches'].get('all_reduce.gloo', 0) == (steps + ticks) * per,
          f'15c Mixtral: launches {got["launches"]}')
    return got['launches']


def phase_tp_nccl_multi(torch, dev, seed, card, handover):
    """15d. The 8B main path over NCCL at tp = min(cards, 4), graphed,
    one rank a card; only where two or more cards are visible (NCCL
    refuses two ranks on one device). Returns whether it ran."""
    count = torch.cuda.device_count()
    if count < 2:
        log(f'15d NCCL at tp > 1: not run: {count} GPU visible on this '
            'machine, and NCCL refuses two ranks on one device (not '
            'counted as passed)')
        return False
    tp = min(count, 4)
    cfg, _ = handover['model']
    prompts, want = handover['main']
    job = dict(tag='8B bf16', cfg=cfg, seed=seed, prompts=prompts,
               max_new=32, engine_kw=dict(batch_size=8, max_prompt=512,
                                          prefill_chunk=128,
                                          prefill_budget=256,
                                          decode_chunk=8))
    got = run_tp_world(tp, 'nccl', [job], f'15d tp {tp} NCCL')['8B bf16']
    same = sum(a == b for a, b in zip(got['tokens'], want))
    out_toks = sum(map(len, got['tokens']))
    log(f'15d tp {tp} over NCCL on {count} cards of {card}: {same}/12 '
        f'requests equal phase 5\'s tokens; {out_toks / got["wall"]:.1f} '
        f'output tokens/s; {got["graphs"]} graphs; mesh {got["mesh"]}')
    check(got['finished'] and got['graphs'] > 0, f'15d: {got["mesh"]}')
    return True


# ------------------------------------------------------------------ 16
#
# Sharded training over dp, fsdp and tp (``train.make_train_step(mesh=)``).
# The card's machine has one H100 and NCCL refuses two ranks on one
# device, so 16a runs a world of one over NCCL (every collective on a
# group of one) and 16b worlds of 2 and 4 ranks sharing the card over
# gloo, whose CUDA collectives take the all-reduce form.

COLLECTIVES = ('all_gather', 'reduce_scatter', 'all_reduce')


def sharded_collectives_per_step(cfg, axes, seq, batch=4, ring='flash'):
    """The collectives a step of the sharded Llama or MoE family runs
    under remat True on a global batch of ``batch`` rows of ``seq``
    tokens on a mesh of ``axes`` (the design, ``PERF.md``), each over
    axes of more than one rank only (``collectives.spans``: a world of
    one runs none). A layer run is one layer on one microbatch: the
    layers of the rank's stage times its microbatches under pp > 1
    (``pipeline.local_microbatches``), else every layer once. fsdp: each
    layer run's 'fsdp'-sharded weights (7; MoE's router makes 8)
    gathered in the forward and again in remat's rerun and
    reduce-scattered once, and the embedding's and the head's. The token
    axes (dp, fsdp, sp): the summed cross entropy and the mask count; MoE
    adds, a layer in each pass, the all-gather of the routing counts and
    the all-reduce of the aux sums. The gradient buckets: the
    'fsdp'-sharded leaves' over dp and sp, the others' over dp, fsdp and
    sp, and under pp the embedding's over dp, sp and pp. tp: a layer
    run's two column-parallel inputs' backward sums, the attention
    output's sum in both passes, the MLP's in the forward only (the rerun
    stops once its saved tensors are back, before that sum) and MoE's
    expert sum in both; the embedding's sum, the loss input's backward
    sum and three a loss chunk in each pass. ep: a MoE layer's output sum
    in the forward and its two inputs' (the tokens and the routing
    weights) backward sums. sp: a layer run's ring in the forward, the
    rerun and the backward, each sp - 1 K/V hops, and on the flash route
    ('flash': CUDA tensors; 'plain' on CPU ones) sp more in the backward,
    the dK/dV accumulators'. pp: the activation hops of the M + pp - 1
    ticks (one after each tick but the last) in the forward and as many
    in the backward, and the all-reduce of the last stage's outputs. The
    norm over every rank."""
    from skypilot_tpu_torch.parallel import pipeline
    dp, fsdp, sp, tp, ep, pp = (axes.get(a, 1) for a in
                                ('dp', 'fsdp', 'sp', 'tp', 'ep', 'pp'))
    moe, n = hasattr(cfg, 'n_experts'), cfg.n_layers
    s = seq // sp
    chunks = max(1, s // max(1, cfg.loss_chunk))
    while s % chunks:
        chunks -= 1
    tokens, runs = dp * fsdp * sp, n
    out = {'all_gather': 0, 'reduce_scatter': 0, 'all_reduce': 0,
           'ppermute': 0}
    if pp > 1:
        m = pipeline.local_microbatches(
            pipeline.microbatches(cfg, batch, pp), batch, batch // (dp * fsdp))
        runs = n // pp * m
        out['ppermute'] += 2 * (m + pp - 2)
        out['all_reduce'] += 1
    gathered = 8 if moe else 7
    if fsdp > 1:
        out['all_gather'] += 2 * gathered * runs + 2
        out['reduce_scatter'] += gathered * runs + 2
    if tokens > 1:
        out['all_gather'] += 2 * runs if moe else 0
        out['all_reduce'] += 2 + (2 * runs if moe else 0)
    out['all_reduce'] += ((dp * sp > 1) + (tokens > 1) + (pp > 1) +
                          (tokens * tp * ep * pp > 1))
    if tp > 1:
        out['all_reduce'] += (6 if moe else 5) * runs + 2 + 6 * chunks
    if ep > 1:
        out['all_reduce'] += 3 * runs
    if sp > 1:
        out['ppermute'] += runs * (3 * (sp - 1) + (sp if ring == 'flash'
                                                   else 0))
    return out


def phase_sharded_one(torch, dev, seed, card, ref):
    """16a. A world of one rank over NCCL through ``initialize_from_env``:
    each collective of the mesh (all-reduce, and all-gather and
    reduce-scatter in both forms) once on each group of one, equal to its
    input; then phase 8's model (tpu_1b at full width and depth, bf16,
    AdamW), state and batch through ``make_train_step(mesh=)``, one
    warm-up and four timed steps. Its first loss must equal phase 8's bit
    for bit, its grad norms phase 8's within rtol 1e-5, its params after
    the five steps phase 8's within the bf16 bar, its K4/K5a/K5b
    launches a step phase 8's, and its collectives a step the design's
    count (``sharded_collectives_per_step``: none, every axis holding one
    rank). Prints the step time beside phase 8's. ``ref`` is phase 8's
    handover (filled here by running phase 8 when it did not run).
    Returns the per-step launches of the timed steps."""
    import torch.distributed as dist
    from skypilot_tpu_torch.models import llama, train
    from skypilot_tpu_torch.ops import _build
    from skypilot_tpu_torch.parallel import distributed as dist_lib
    from skypilot_tpu_torch.parallel import make_mesh
    if not ref:
        phase_train(torch, dev, seed, card, None, ref)
    cfg = train_config(torch, llama)
    env = tp_env(1, free_port())
    os.environ.update(env)
    names = ('flash_fwd', 'flash_dq', 'flash_dkv', 'flash_fwd.f32',
             'flash_dq.f32', 'flash_dkv.f32') + tuple(
                 f'{op}.{form}' for op in COLLECTIVES
                 for form in ('nccl', 'nccl_ar'))
    try:
        dist_lib.initialize_from_env(backend='nccl')
        mesh = make_mesh(device=dev, dp=1, fsdp=1, tp=1)
        check(mesh.backend == 'nccl' and mesh.collective and all(
            mesh.size_of(a) == 1 for a in mesh.groups),
              f'16a: mesh {mesh.info()}, groups {sorted(mesh.groups)}')
        _build.reset_launches()
        x = torch.randn(64, 32, device=dev, dtype=torch.bfloat16)
        for axes in mesh.groups:
            same = [mesh.all_reduce(x.clone(), axes=axes)] + [
                op(x, axes, 1, form) for op in (mesh.all_gather,
                                                mesh.reduce_scatter)
                for form in ('native', 'ar')]
            check(all(torch.equal(y, x) for y in same),
                  f'16a: a collective over the group of one {axes} changed '
                  'its input')
        n = len(mesh.groups)
        counts = {k: _build.LAUNCHES[k] for k in names[6:]}
        check(counts == {f'{op}.{form}': n if op != 'all_reduce' or
                         form == 'nccl' else 0 for op in COLLECTIVES
                         for form in ('nccl', 'nccl_ar')},
              f'16a: collectives on the groups of one {counts}')
        log(f'16a: every collective on the {n} groups of one '
            f'{sorted(mesh.groups)} returned its input: {counts}')
        state, opt = train.init_train_state(cfg, seed, device=dev,
                                            mesh=mesh)
        step_fn = train.make_train_step(cfg, opt, mesh=mesh)
        batch = train.shard_batch(train_batch(torch, cfg, dev, seed), mesh)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, m = step_fn(state, batch)                    # warm-up
        torch.cuda.synchronize()
        log(f'16a: warm-up step {time.perf_counter() - t0:.3f} s')
        metrics = [(m['loss'].item(), m['grad_norm'].item())]
        per_step, times = [], []
        _build.reset_launches()
        for _ in range(ref['steps'] - 1):
            before = {n: _build.LAUNCHES[n] for n in names}
            t0 = time.perf_counter()
            state, m = step_fn(state, batch)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            per_step.append({n: _build.LAUNCHES[n] - before[n]
                             for n in names if _build.LAUNCHES[n] -
                             before[n]})
            metrics.append((m['loss'].item(), m['grad_norm'].item()))
        step_s = sum(times) / len(times)
        worst, within = 0.0, True
        for a, b in zip(train._leaves(state.params),
                        train._leaves(ref['params'])):
            err, ok = compare(a, b)
            worst, within = max(worst, err), within and ok
        want = sharded_collectives_per_step(cfg, mesh.shape, 2048)
        kernels = {'flash_fwd': 2 * cfg.n_layers, 'flash_dq': cfg.n_layers,
                   'flash_dkv': cfg.n_layers}
        log(f'16a world of one over NCCL on {card}: tpu_1b {cfg.n_layers} '
            f'layers bf16 AdamW, B 4 x S 2048; step times '
            f'{[round(t, 4) for t in times]} s, mean {step_s:.4f} s against '
            f'phase 8\'s {ref["step_s"]:.4f} s in this call '
            f'({step_s / ref["step_s"]:.3f}x); peak '
            f'{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB')
        log('16a: (loss, grad_norm) per step ' + ', '.join(
            f'({lo:.6f}, {gn:.5f})' for lo, gn in metrics) + '; phase 8: ' +
            ', '.join(f'({lo:.6f}, {gn:.5f})' for lo, gn in ref['metrics']))
        log(f'16a: params after {ref["steps"]} steps vs phase 8\'s: max abs '
            f'error {worst:.3g} (within the bf16 bar: {within}); launches a '
            f'step {per_step}; the design\'s collectives a step {want}')
        check(metrics[0][0] == ref['metrics'][0][0],
              f'16a: first loss {metrics[0][0]!r}, phase 8 '
              f'{ref["metrics"][0][0]!r} (want bit for bit)')
        check(all(math.isclose(a[1], b[1], rel_tol=1e-5, abs_tol=0)
                  for a, b in zip(metrics, ref['metrics'])),
              f'16a: grad norms {metrics} vs phase 8 {ref["metrics"]}')
        check(within, f'16a: params {worst:.3g} past the bf16 bar')
        for got, base in zip(per_step, ref['per_step']):
            check(all(got.get(n, 0) == base.get(n, 0) == w
                      for n, w in kernels.items()) and not any(
                          got.get(f'{n}.f32', 0) for n in kernels),
                  f'16a: K4/K5 launches {got}, phase 8 {base}, want '
                  f'{kernels}')
            check({op: got.get(f'{op}.nccl', 0) for op in want} == want
                  and not any(got.get(f'{op}.nccl_ar', 0)
                              for op in COLLECTIVES),
                  f'16a: collectives a step {got}, want {want}')
        return {'per_step': per_step[-1], 'step_s': step_s,
                'phase8_step_s': ref['step_s']}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k in env:
            os.environ.pop(k, None)
        torch.cuda.empty_cache()


def gathered_tree(tree, specs, mesh, keep):
    """The whole tensors of a tree of this rank's blocks under ``specs``
    (every rank takes part; only where ``keep`` the result is kept, else
    None): each dim gathered over its spec entry's axes of more than one
    rank, the minor axis first (a dim split over ('fsdp', 'tp') holds
    block fsdp_index x tp + tp_index)."""
    if isinstance(tree, dict):
        return {k: gathered_tree(v, specs[k], mesh, keep)
                for k, v in tree.items()}
    t = tree.detach()
    for dim, entry in enumerate(specs):
        names = (entry,) if isinstance(entry, str) else tuple(entry or ())
        for a in reversed(names):
            if mesh.size_of(a) > 1:
                t = mesh.all_gather(t, a, dim)
    return t.clone() if keep else None


def sharded_train_job(torch, mesh, dev, job):
    """One world's sharded training on this rank (16b, 17b): its blocks
    of the job's model (``init_train_state(mesh=)`` from the seed: the
    unsharded draws' slices), its rows (and sequence chunk) of phase 8's
    batch, in the {'inputs', 'targets'} form, ``job['steps']`` steps.
    Before each step the world gathers its state whole, and after it
    rank 0 runs the unsharded step from that state on the global batch
    (of ``job['ref_cfg']`` where given: the same dispatch as the world's;
    with ``job['ref_ring']`` its attention the ring over sp chunks in one
    process, ``ring_attention_local``: the same blocks, kernels and merges
    as the world's, for MoE under sp, whose random router turns on
    near-ties that the blocking's roundings flip): every step's
    reference starts where the world's step starts. Returns
    its coordinates, per step its (loss, grad_norm), kernel and
    collective launches and dropped assignments a MoE layer (of this
    rank's tokens, in the forward's layer order, either dispatch), the
    (query, key) heads attention ran at, its step times and peak memory;
    rank 0 adds the reference's (loss, grad_norm) and drops a layer per
    step. With ``job['margins']`` every rank also keeps its forward's
    top-k experts a MoE layer (``routes``), and rank 0, before each
    reference step, the forward of the unsharded model with
    ``flash_attention`` on the whole sequence from the same state: its
    drops, top-k experts and router probabilities a layer
    (``flash_ref``, read by ``route_flips``)."""
    from skypilot_tpu_torch.models import llama, moe, train
    from skypilot_tpu_torch.ops import _build
    from skypilot_tpu_torch.parallel import ring_attention
    from skypilot_tpu_torch.parallel.sharding import batch_block
    cfg, lead = job['cfg'], mesh.rank == 0
    ref_cfg = job.get('ref_cfg', cfg)
    state, opt = train.init_train_state(cfg, job['seed'], device=dev,
                                        mesh=mesh)
    specs = train.state_specs(cfg, opt, mesh.shape['pp'] > 1)
    batch = train.split_tokens(train_batch(torch, cfg, dev, job['seed'],
                                           *job['shape']))
    rows = train.shard_batch({k: batch_block(v, mesh)
                              for k, v in batch.items()}, mesh)
    step_fn = train.make_train_step(cfg, opt, mesh=mesh)
    plain_fn = train.make_train_step(ref_cfg, opt)
    heads, drops, routes = set(), [], []
    attention = llama._attention
    assign, route, topk = (moe._sorted_assignment, moe._route,
                           moe._topk_weights)

    def attend(q, k, v, c, *a):
        heads.add((q.shape[2], k.shape[2]))
        return attention(q, k, v, c, *a)

    def record(idx, *a):
        out = assign(idx, *a)
        drops.append(int((~out[2]).sum().item()))
        return out

    sp = mesh.shape['sp']

    def local_ring(q, k, v, c, *a):
        return ring_attention.ring_attention_local(q, k, v, sp)

    def record_route(xf, router, c, *a):
        combine, aux = route(xf, router, c, *a)
        drops.append(xf.shape[0] * c.top_k -
                     int((combine > 0).sum().item()))
        return combine, aux

    def record_topk(xf, router, c):
        weights, idx, probs = topk(xf, router, c)
        routes.append((idx.detach().cpu(), probs.detach().cpu()))
        return weights, idx, probs

    out = {'coords': mesh.coords, 'metrics': [], 'launches': [],
           'times': [], 'drops': [], 'ref': [], 'ref_drops': [],
           'routes': [], 'flash_ref': []}
    n_moe = cfg.n_layers if hasattr(cfg, 'n_experts') else 0
    peak = 0.0
    moe._sorted_assignment, moe._route = record, record_route
    if job.get('margins'):
        moe._topk_weights = record_topk
    try:
        for i in range(job['steps']):
            with torch.no_grad():
                full = train.TrainState(
                    params=gathered_tree(state.params, specs.params, mesh,
                                         lead),
                    opt_state={'count': state.opt_state['count'],
                               'mu': gathered_tree(state.opt_state['mu'],
                                                   specs.opt_state['mu'],
                                                   mesh, lead),
                               'nu': gathered_tree(state.opt_state['nu'],
                                                   specs.opt_state['nu'],
                                                   mesh, lead)},
                    step=state.step)
            if i == 0:
                llama._attention = attend
            if dev.type == 'cuda':
                torch.cuda.synchronize(dev)
                torch.cuda.reset_peak_memory_stats(dev)
            drops.clear()
            routes.clear()
            _build.reset_launches()
            t0 = time.perf_counter()
            try:
                state, m = step_fn(state, rows)
                if dev.type == 'cuda':
                    torch.cuda.synchronize(dev)
            finally:
                llama._attention = attention
            out['times'].append(time.perf_counter() - t0)
            out['launches'].append({k: v for k, v in _build.LAUNCHES.items()
                                    if v})
            out['metrics'].append((m['loss'].item(), m['grad_norm'].item()))
            out['drops'].append(drops[:n_moe])
            out['routes'].append([idx for idx, _ in routes[:n_moe]])
            if dev.type == 'cuda':
                peak = max(peak, torch.cuda.max_memory_allocated(dev))
            if lead and job.get('margins'):
                # The routing flash_attention on the whole sequence gives
                # from the same state (a forward: nothing updated).
                drops.clear()
                routes.clear()
                train.make_eval_step(ref_cfg)(full.params, batch)
                out['flash_ref'].append({'drops': drops[:n_moe],
                                         'routes': routes[:n_moe]})
            if lead:
                drops.clear()
                if job.get('ref_ring'):
                    # The same blocks, kernels and merges as the world's
                    # ring, over its sp chunks in one process.
                    llama._attention = local_ring
                try:
                    _, rm = plain_fn(full, batch)
                finally:
                    llama._attention = attention
                out['ref'].append((rm['loss'].item(),
                                   rm['grad_norm'].item()))
                out['ref_drops'].append(drops[:n_moe])
            del full
    finally:
        moe._sorted_assignment, moe._route = assign, route
        moe._topk_weights = topk
    out['heads'] = sorted(heads)
    out['peak_gib'] = peak / 2**30
    return out


# 16b's global batch (phase 8's) and steps.
SHARDED_SHAPE, SHARDED_STEPS = (4, 2048), 2
# 16b's worlds: (tag, world, axes, family).
SHARDED_WORLDS = (('dp 2', 2, {'dp': 2, 'fsdp': 1}, 'llama'),
                  ('fsdp 2', 2, {'fsdp': 2}, 'llama'),
                  ('fsdp 2 x tp 2', 4, {'fsdp': 2, 'tp': 2}, 'llama'),
                  ('MoE fsdp 2', 2, {'fsdp': 2}, 'moe'))


def phase_sharded_gloo(torch, dev, seed, card):
    """16b. Worlds of 2 and 4 ranks sharing the card over gloo (spawned
    as 15c's; CUDA collectives in the all-reduce form), two AdamW steps
    each on phase 8's batch (B 4 x S 2048): tpu_1b width at depth 2 in
    bf16 under dp 2, fsdp 2 and fsdp 2 x tp 2, and tpu_moe_1b width at
    depth 2 under fsdp 2 at capacity factor 1.0 (tokens drop). Every
    step of every rank against the unsharded step from the same state
    (the world's, gathered: ``sharded_train_job``), held to the training
    phases' bf16 bars (the loss within the bf16 bar, grad_norm within
    rtol 1e-3, 14a's); the MoE layers' drop counts summed over the data
    ranks equal the reference's at every step; attention at H / tp heads
    with K4 twice and K5a, K5b once a layer a step on every rank; the
    collectives a step the design's count (``sharded_collectives_per_step``).
    Returns rank 0's launches a step by world."""
    from skypilot_tpu_torch.models import llama, moe
    shape, steps = SHARDED_SHAPE, SHARDED_STEPS
    cfgs = {'llama': train_config(torch, llama, n_layers=2),
            'moe': moe.MoEConfig.tpu_moe_1b(
                n_layers=2, max_seq=2048, param_dtype=torch.bfloat16,
                capacity_factor=1.0, remat=True, loss_chunk=1024,
                dispatch='sorted')}
    summary = {}
    for tag, world, axes, fam in SHARDED_WORLDS:
        cfg = cfgs[fam]
        ranks = run_tp_world(world, 'gloo', [dict(
            tag=tag, train=True, cfg=cfg, seed=seed, shape=shape,
            steps=steps)], f'16b {tag}', axes=axes, all_ranks=True)
        ranks = [r[tag] for r in ranks]
        r0 = ranks[0]
        ref, ref_drops = r0['ref'], r0['ref_drops']
        tp = axes.get('tp', 1)
        kernels = {'flash_fwd': 2 * cfg.n_layers, 'flash_dq': cfg.n_layers,
                   'flash_dkv': cfg.n_layers}
        # gloo takes CUDA tensors' gathers in the all-reduce form.
        form = '_ar' if dev.type == 'cuda' else ''
        want = {f'{op}.gloo{form if op != "all_reduce" else ""}': n
                for op, n in sharded_collectives_per_step(
                    cfg, axes, shape[1]).items()}
        data = sorted((r for r in ranks if r['coords']['tp'] == 0),
                      key=lambda r: (r['coords']['dp'], r['coords']['fsdp']))
        drops = [[sum(r['drops'][i][li] for r in data)
                  for li in range(len(ref_drops[i]))] for i in range(steps)]
        log(f'16b {tag} on {card} ({fam}, world {world}, gloo, ranks sharing '
            f'the card): (loss, grad_norm) per step rank 0 {r0["metrics"]}, '
            f'the unsharded step from the same state {ref}; every rank '
            f'equal: {all(r["metrics"] == r0["metrics"] for r in ranks)}; '
            f'heads {r0["heads"]}; step times rank 0 '
            f'{[round(t, 3) for t in r0["times"]]} s; peak '
            f'{max(r["peak_gib"] for r in ranks[1:]):.2f} GiB a rank (rank '
            f'0 also holds the gathered state: {r0["peak_gib"]:.2f}); '
            f'launches a '
            f'step rank 0 {r0["launches"][-1]}, the design\'s collectives '
            f'{want}' + (f'; dropped assignments by step and layer {drops}, '
                         f'the reference {ref_drops}' if fam == 'moe' else ''))
        log(f'16b {tag}: relative difference by step, loss / grad_norm '
            + ', '.join(f'{abs(a[0] - b[0]) / abs(b[0]):.3g} / '
                        f'{abs(a[1] - b[1]) / b[1]:.3g}'
                        for a, b in zip(r0['metrics'], ref)))
        for r in ranks:
            check(r['metrics'] == r0['metrics'],
                  f'16b {tag}: ranks disagree on the metrics')
            for i, ((lo, gn), (rlo, rgn)) in enumerate(zip(r['metrics'],
                                                           ref)):
                _, ok = compare(torch.tensor(lo), torch.tensor(rlo))
                check(ok and math.isclose(gn, rgn, rel_tol=1e-3),
                      f'16b {tag}: step {i} (loss, grad_norm) '
                      f'{r["metrics"][i]} vs the unsharded {ref[i]}')
            check(r['heads'] == [(cfg.n_heads // tp, cfg.n_kv_heads // tp)],
                  f'16b {tag}: attention heads {r["heads"]}')
            for step in r['launches']:
                check(all(step.get(n, 0) == w for n, w in kernels.items()),
                      f'16b {tag}: K4/K5 launches {step}, want {kernels} a '
                      'step')
                check({k: step.get(k, 0) for k in want} == want,
                      f'16b {tag}: collectives a step {step}, want {want}')
        if fam == 'moe':
            check(drops == ref_drops and all(sum(d) > 0 for d in drops),
                  f'16b {tag}: dropped assignments by step and layer '
                  f'{drops}, the reference {ref_drops}')
        summary[tag] = r0['launches'][-1]
    log('16b launches a step, rank 0: ' + json.dumps(summary))
    return summary

# 17a's shapes: (tag, B, S, H, n_kv, head_dim), bf16; the f32 check's.
RING_SHAPES = (('tpu_1b heads, longctx_train', 1, 32768, 16, 8, 128),
               ('GPT-2 124M heads', 4, 1024, 12, 12, 64))
RING_F32_SHAPE = (1, 2048, 4, 2, 64)
RING_CHUNKS = (2, 4)


def ring_run(torch, fn, q, k, v, do):
    """``fn(q, k, v)``'s output and its gradients by q, k and v against
    ``do``."""
    qq, kk, vv = (t.detach().requires_grad_() for t in (q, k, v))
    o = fn(qq, kk, vv)
    grads = torch.autograd.grad(o, (qq, kk, vv), do)
    return (o.detach(),) + grads


def ring_inputs(torch, dev, b, s, h, kv, d, dtype, seed):
    g = torch.Generator(device=dev).manual_seed(seed + 17)

    def draw(heads):
        return torch.randn((b, s, heads, d), generator=g, device=dev,
                           dtype=torch.float32).to(dtype)

    return draw(h), draw(kv), draw(kv), draw(h)


def ring_plain(torch, fa, q, k, v, do, rows=1024, fwd=None):
    """Causal attention's (o, dq, dk, dv) from the plain versions' f32
    formulas over blocks of ``rows`` query rows (each against the keys it
    sees), on k/v repeated to the query heads, dk and dv summed over the
    blocks and over each query group in f32; each cast once to the input
    dtype. The exact result the kernels round: S 32768's whole score
    matrix would take 68 GB. With ``fwd`` = (o, lse) a kernel's forward,
    the backward's formulas take those (phase 7's check of K5 against its
    plain version on the same inputs)."""
    qr, kr, vr = fa._repeat_kv(q, k, v)
    b, s, h, d = q.shape
    n_kv, scale = k.shape[2], d**-0.5
    o, dq = torch.empty_like(q), torch.empty_like(q)
    dk = torch.zeros((b, s, h, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for i0 in range(0, s, rows):
        i1 = min(s, i0 + rows)
        qb, kb, vb = qr[:, i0:i1].float(), kr[:, :i1].float(), vr[:, :i1]
        dob = do[:, i0:i1].float()
        sc = fa._scores(qb, kb, True, scale)
        lse = (torch.logsumexp(sc, dim=-1, keepdim=True) if fwd is None
               else fwd[1][:, :, i0:i1, None])
        p = torch.exp(sc - lse)
        del sc
        ob = torch.einsum('bhqk,bkhd->bqhd', p, vb.float())
        o[:, i0:i1] = ob.to(q.dtype)
        if fwd is not None:
            ob = fwd[0][:, i0:i1].float()
        dv[:, :i1] += torch.einsum('bhqk,bqhd->bkhd', p, dob)
        dp = torch.einsum('bqhd,bkhd->bhqk', dob, vb.float())
        delta = torch.sum(dob * ob, dim=-1).transpose(1, 2)
        ds = p * (dp - delta[..., None]) * scale
        del p, dp
        dq[:, i0:i1] = torch.einsum('bhqk,bkhd->bqhd', ds, kb).to(q.dtype)
        dk[:, :i1] += torch.einsum('bhqk,bqhd->bkhd', ds, qb)
        del ds

    def fold(t):
        return t.view(b, s, n_kv, h // n_kv, d).sum(3).to(k.dtype)

    return o, dq, fold(dk), fold(dv)


def phase_ring(torch, dev, seed, card):
    """17a. Ring attention's flash route over n = 2 and 4 sequence chunks
    in one process (``ring_attention_local``: the blocks, kernels and
    merges of n ranks, the rotation an index shift), causal, in bf16 at
    tpu_1b's heads on longctx_train's B 1 x S 32768 and at GPT-2's head_dim
    64 (B 4 x S 1024). The ring's output is held to the exact result
    (``ring_plain``) within the bf16 bar, and its dQ, dK, dV to the plain
    backward's formulas on the ring's own merged o and lse (as phase 7
    holds K5 to its plain version on the kernel's forward: the bar is a
    kernel's, and at S 32768 the whole sequence's K5b, too, lies past it
    from the exact result at a few elements in 10^7). Their distance from
    ``flash_attention`` on the whole sequence (K4, K5a, K5b) is printed
    beside ``flash_attention``'s own from the exact result. K4's, K5a's
    and K5b's f32-output mode must round to their bf16 mode bit for bit.
    K4, K5a and K5b launch once a
    visited block each (chunk r visits r + 1, so n (n + 1) / 2 a call),
    in their f32-output mode, none on the f32 route; the time of a
    forward and backward is printed beside ``flash_attention``'s in this
    call. Then the flash route in f32 against the plain route (the
    reference's update step, ``route='plain'``) at B 1 x S 2048, 4/2
    heads, head_dim 64, causal and not, within 1e-4, the f32 launches
    counted. Returns the launches a call by case."""
    from skypilot_tpu_torch.ops import _build
    from skypilot_tpu_torch.ops import flash_attention as fa
    from skypilot_tpu_torch.parallel import ring_attention as ra
    names = ('flash_fwd', 'flash_dq', 'flash_dkv')
    what = ('o', 'dq', 'dk', 'dv')
    launches = {}
    for tag, b, s, h, kv, d in RING_SHAPES:
        args = ring_inputs(torch, dev, b, s, h, kv, d, torch.bfloat16, seed)
        exact = ring_plain(torch, fa, *args)
        whole = ring_run(torch, lambda q, k, v: fa.flash_attention(
            q, k, v, causal=True), *args)
        errs = [compare(a, w) for a, w in zip(whole, exact)]
        past = [past_bf16_bar(a, w) for a, w in zip(whole, exact)]
        # The f32-output mode writes the accumulators the bf16 mode rounds.
        q, k, v, do = (t.contiguous() for t in
                       (args[0],) + fa._repeat_kv(*args[:3])[1:] + args[3:])
        kw = dict(causal=True, scale=d**-0.5)
        o, lse = fa.flash_forward(q, k, v, **kw)
        o32, _ = fa.flash_forward(q, k, v, out_dtype=torch.float32, **kw)
        same = [torch.equal(o32.to(o.dtype), o)] + [
            torch.equal(g32.to(g.dtype), g) for g, g32 in zip(
                fa.flash_backward(q, k, v, o, lse, do, **kw),
                fa.flash_backward(q, k, v, o, lse, do,
                                  out_dtype=torch.float32, **kw))]
        check(all(same), f'17a {tag}: the f32-output mode rounded to bf16 '
              f'differs from the bf16 mode (o, dq, dk, dv: {same})')
        del q, k, v, do, o, lse, o32
        whole_ms = time_ms(lambda *a: ring_run(
            torch, lambda q, k, v: fa.flash_attention(q, k, v, causal=True),
            *a), [args], iters=5, warmup=1)
        log(f'17a {tag} (B {b} x S {s}, {h}/{kv} heads, head_dim {d}, bf16) '
            f'on {card}: K4/K5a/K5b\'s f32-output mode rounds to their bf16 '
            f'mode bit for bit; flash_attention on the whole sequence against '
            f'the exact result, max abs error o/dq/dk/dv '
            f'{", ".join(f"{e:.3g}" for e, _ in errs)}, elements past the '
            f'bf16 bar {past} of {[t.numel() for t in whole]}; forward + '
            f'backward {whole_ms:.3f} ms')
        for n in RING_CHUNKS:
            def ring(q, k, v, n=n):
                return ra.ring_attention_local(q, k, v, n, causal=True)
            _build.reset_launches()
            got = ring_run(torch, ring, *args)
            torch.cuda.synchronize()
            count = {k: _build.LAUNCHES[k] for k in names}
            blocks = n * (n + 1) // 2
            check(count == {k: blocks for k in names} and all(
                _build.LAUNCHES[f'{k}.f32_out'] == blocks and
                not _build.LAUNCHES[f'{k}.f32'] for k in names),
                  f'17a {tag} n {n}: launches {dict(_build.LAUNCHES)}, '
                  f'want {blocks} of each kernel, f32 outputs')
            outs, lses = ra._local_forward(*args[:3], n, True, d**-0.5)
            plain = ring_plain(torch, fa, *args, fwd=(
                torch.cat(outs, 1), torch.cat(lses, 2)))
            del outs, lses
            to_exact = [compare(got[0], exact[0])] + [
                compare(a, w) for a, w in zip(got[1:], plain[1:])]
            apart = [compare(a, w)[0] for a, w in zip(got, whole)]
            past = [past_bf16_bar(a, w) for a, w in zip(got, exact)]
            ms = time_ms(lambda *a: ring_run(torch, ring, *a), [args],
                         iters=5, warmup=1)
            launches[f'{tag} n {n}'] = count
            log(f'17a {tag}: ring over {n} chunks, max abs error o/dq/dk/dv '
                f'{", ".join(f"{e:.3g}" for e, _ in to_exact)} against the '
                f'exact o and the plain backward on the ring\'s o and lse '
                f'(elements past the bf16 bar of the exact result {past}), '
                f'{", ".join(f"{e:.3g}" for e in apart)} from '
                f'flash_attention; K4/K5a/K5b {blocks} each; forward + '
                f'backward {ms:.3f} ms, flash_attention {whole_ms:.3f} ms '
                f'({ms / whole_ms:.3f}x)')
            for name, (err, ok) in zip(what, to_exact):
                check(ok, f'17a {tag} n {n}: {name} {err:.3g} past the bf16 '
                      'bar of its plain version')
        del args, exact, whole, got
        torch.cuda.empty_cache()
    b, s, h, kv, d = RING_F32_SHAPE
    args = ring_inputs(torch, dev, b, s, h, kv, d, torch.float32, seed)
    for causal in (True, False):
        for n in RING_CHUNKS:
            outs = {}
            for route in ra.ROUTES:
                _build.reset_launches()
                outs[route] = ring_run(torch, lambda q, k, v: (
                    ra.ring_attention_local(q, k, v, n, causal=causal,
                                            route=route)), *args)
                torch.cuda.synchronize()
                if route == 'flash':
                    blocks = n * (n + 1) // 2 if causal else n * n
                    count = {k: _build.LAUNCHES[f'{k}.f32'] for k in names}
                    check(count == {k: blocks for k in names},
                          f'17a f32 n {n} causal {causal}: launches '
                          f'{dict(_build.LAUNCHES)}, want {blocks} each')
                    launches[f'f32 causal {causal} n {n}'] = count
                else:
                    check(not any(_build.LAUNCHES[k] for k in names),
                          '17a: the plain route launched a kernel')
            errs = [compare(a, w, bf16_bar=False)
                    for a, w in zip(outs['flash'], outs['plain'])]
            check(all(ok for _, ok in errs),
                  f'17a f32 n {n} causal {causal}: flash vs plain route '
                  f'{[e for e, _ in errs]} past 1e-4')
            log(f'17a f32 (B {b} x S {s}, {h}/{kv} heads, head_dim {d}) '
                f'causal {causal}, {n} chunks: flash route vs plain route '
                f'max abs error o/dq/dk/dv '
                f'{", ".join(f"{e:.3g}" for e, _ in errs)}')
    del args, outs
    torch.cuda.empty_cache()
    return launches


# 17b's worlds: (tag, world, axes, family, (B, S)); two steps each.
RING_WORLDS = (
    ('Llama sp 2, B 1 x S 32768', 2, {'sp': 2, 'fsdp': 1}, 'llama',
     (1, 32768)),
    ('Llama sp 2 x fsdp 2', 4, {'sp': 2, 'fsdp': 2}, 'llama', (4, 2048)),
    ('GPT-2 sp 2', 2, {'sp': 2, 'fsdp': 1}, 'gpt2', (4, 1024)),
    ('MoE ep 2', 2, {'ep': 2, 'fsdp': 1}, 'moe', (4, 2048)),
    ('MoE sp 2 x ep 2', 4, {'sp': 2, 'ep': 2, 'fsdp': 1}, 'moe', (4, 2048)),
    ('Llama pp 2', 2, {'pp': 2, 'fsdp': 1}, 'llama4', (4, 2048)),
    ('Llama pp 2 x sp 2', 4, {'pp': 2, 'sp': 2, 'fsdp': 1}, 'llama4',
     (4, 2048)))


def route_flips(data, flash_ref, b):
    """The top-k choices of a MoE world's forward (``data``: its ranks of
    distinct tokens, splitting the sequence only) that differ from the
    unsharded forward's with ``flash_attention`` from the same state
    (``flash_ref``, ``sharded_train_job``'s), and the router margins that
    decided them. A token's margin is the least gap between consecutive
    sorted router probabilities over its k ordered choices and the first
    left out (a smaller gap, a nearer tie). Per step and layer: the
    flipped tokens, their margins (the first eight), the share of all
    tokens whose margin is at most the largest flipped one, and the
    median margin."""
    import torch
    check(all(r['coords']['dp'] == r['coords']['fsdp'] == 0 for r in data),
          'route_flips: the world splits rows')
    data = sorted(data, key=lambda r: r['coords']['sp'])
    out = []
    for i, ref in enumerate(flash_ref):
        layers = []
        for li, (ridx, probs) in enumerate(ref['routes']):
            k = ridx.shape[-1]
            world = torch.cat([r['routes'][i][li].view(b, -1, k)
                               for r in data], 1).reshape(-1, k)
            flipped = (world != ridx).any(-1)
            top = probs.sort(-1, descending=True).values[:, :k + 1]
            margin = (top[:, :-1] - top[:, 1:]).min(-1).values
            worst = margin[flipped].max() if flipped.any() else None
            layers.append({
                'flipped': int(flipped.sum()),
                'margins': [float(m) for m in margin[flipped][:8]],
                'share_at_most': (None if worst is None else
                                  float((margin <= worst).float().mean())),
                'median': float(margin.median())})
        out.append(layers)
    return out


def ring_world_kernels(cfg, axes, coords, batch):
    """K4, K5a and K5b a step on the rank at ``coords``: a layer run
    (``sharded_collectives_per_step``'s) launches K4 for each block its
    ring visits in the forward and again in remat's rerun, K5a and K5b
    once each; without sp one block."""
    from skypilot_tpu_torch.parallel import pipeline
    pp, blocks = axes.get('pp', 1), coords['sp'] + 1
    runs = cfg.n_layers
    if pp > 1:
        data = axes.get('dp', 1) * axes.get('fsdp', 1)
        runs = cfg.n_layers // pp * pipeline.local_microbatches(
            pipeline.microbatches(cfg, batch, pp), batch, batch // data)
    return {'flash_fwd': 2 * runs * blocks, 'flash_dq': runs * blocks,
            'flash_dkv': runs * blocks}


def phase_ring_worlds(torch, dev, seed, card):
    """17b. Worlds of 2 and 4 ranks sharing the card over gloo (spawned as
    15c's; CUDA gathers in the all-reduce form, hops through host
    memory), two AdamW steps each: tpu_1b width at depth 2 under sp 2 on
    longctx_train's B 1 x S 32768 and under sp 2 x fsdp 2 on phase 8's B
    4 x S 2048; GPT-2 124M at full depth under sp 2 (B 4 x S 1024);
    tpu_moe_1b width at depth 2 (capacity factor 1.0, 'auto' dispatch:
    dense where ep > 1) under ep 2 and sp 2 x ep 2 (B 4 x S 2048); tpu_1b
    width at depth 4 under pp 2 (M 4) and pp 2 x sp 2 (B 4 x S 2048).
    Every step of every rank against the unsharded step from the same
    state (``sharded_train_job``; its attention ``flash_attention`` on the
    whole sequence, or for MoE under sp the same ring as the world's in
    one process), held to the training phases' bars
    (the loss within the bf16 bar, grad_norm within rtol 1e-3; the MoE
    reference takes the world's dispatch); the MoE
    layers' drops summed over the ranks of distinct tokens equal the
    reference's at every step. MoE sp 2 x ep 2 runs at ``seed`` and
    ``seed + 1`` and prints, against ``flash_attention``'s routing from
    the same state, its flipped top-k choices and their router margins
    (``route_flips``). K4/K5a/K5b a step the ring's schedule
    (``ring_world_kernels``) and the collectives a step the design's
    (``sharded_collectives_per_step``, the flash route). Returns rank 0's
    launches a step by world."""
    from skypilot_tpu_torch.models import gpt2, llama, moe
    cfgs = {'llama': train_config(torch, llama, n_layers=2),
            'llama4': train_config(torch, llama, n_layers=4),
            'gpt2': gpt2.GPT2Config.gpt2(param_dtype=torch.bfloat16,
                                         remat=True, loss_chunk=1024),
            'moe': moe.MoEConfig.tpu_moe_1b(
                n_layers=2, max_seq=2048, param_dtype=torch.bfloat16,
                capacity_factor=1.0, remat=True, loss_chunk=1024)}
    summary = {}
    runs = []
    for tag, world, axes, fam, shape in RING_WORLDS:
        runs.append((tag, world, axes, fam, shape, seed))
        if fam == 'moe' and axes.get('sp', 1) > 1:
            runs.append((f'{tag}, seed + 1', world, axes, fam, shape,
                         seed + 1))
    for tag, world, axes, fam, shape, world_seed in runs:
        cfg = cfgs[fam]
        moe_sp = fam == 'moe' and axes.get('sp', 1) > 1
        # 'auto' dispatches densely where ep > 1: so does the reference step
        # (the same function as sorted, rounded in the same places).
        ref_cfg = (dataclasses.replace(cfg, dispatch='dense')
                   if fam == 'moe' and axes.get('ep', 1) > 1 else cfg)
        ranks = run_tp_world(world, 'gloo', [dict(
            tag=tag, train=True, cfg=cfg, ref_cfg=ref_cfg, seed=world_seed,
            shape=shape, steps=SHARDED_STEPS, ref_ring=moe_sp,
            margins=moe_sp)], f'17b {tag}', axes=axes, all_ranks=True,
            timeout_s=600)
        ranks = [r[tag] for r in ranks]
        r0 = ranks[0]
        ref, ref_drops = r0['ref'], r0['ref_drops']
        want = {}
        for op, n in sharded_collectives_per_step(
                cfg, axes, shape[1], shape[0], 'flash').items():
            suffix = {'all_reduce': '', 'ppermute': '_host'}.get(op, '_ar')
            want[f'{op}.gloo{suffix}'] = n
        # Ranks of distinct tokens (ep and pp peers repeat them).
        data = [r for r in ranks
                if r['coords']['ep'] == 0 and r['coords']['pp'] == 0]
        drops = [[sum(r['drops'][i][li] for r in data)
                  for li in range(len(ref_drops[i]))]
                 for i in range(SHARDED_STEPS)]
        log(f'17b {tag} on {card} ({fam}, world {world}, gloo, ranks sharing '
            f'the card, B {shape[0]} x S {shape[1]}): (loss, grad_norm) per '
            f'step rank 0 {r0["metrics"]}, the unsharded step from the same '
            f'state {ref}; every rank equal: '
            f'{all(r["metrics"] == r0["metrics"] for r in ranks)}; heads '
            f'{r0["heads"]}; step times rank 0 '
            f'{[round(t, 3) for t in r0["times"]]} s; peak '
            f'{max(r["peak_gib"] for r in ranks[1:]):.2f} GiB a rank (rank 0 '
            f'also holds the gathered state: {r0["peak_gib"]:.2f}); launches '
            f'a step rank 0 {r0["launches"][-1]}, the design\'s collectives '
            f'{want}' + (f'; dropped assignments by step and layer {drops}, '
                         f'the reference {ref_drops}' if fam == 'moe' else ''))
        log(f'17b {tag}: relative difference by step, loss / grad_norm '
            + ', '.join(f'{abs(a[0] - b[0]) / abs(b[0]):.3g} / '
                        f'{abs(a[1] - b[1]) / b[1]:.3g}'
                        for a, b in zip(r0['metrics'], ref)))
        for r in ranks:
            check(r['metrics'] == r0['metrics'],
                  f'17b {tag}: ranks disagree on the metrics')
            for i, ((lo, gn), (rlo, rgn)) in enumerate(zip(r['metrics'],
                                                           ref)):
                _, ok = compare(torch.tensor(lo), torch.tensor(rlo))
                check(ok and math.isclose(gn, rgn, rel_tol=1e-3),
                      f'17b {tag}: step {i} (loss, grad_norm) '
                      f'{r["metrics"][i]} vs the unsharded {ref[i]}')
            kernels = ring_world_kernels(cfg, axes, r['coords'], shape[0])
            for step in r['launches']:
                check(all(step.get(n, 0) == w for n, w in kernels.items()),
                      f'17b {tag} rank {r["coords"]}: K4/K5 launches {step}, '
                      f'want {kernels} a step')
                check({k: step.get(k, 0) for k in want} == want,
                      f'17b {tag} rank {r["coords"]}: collectives a step '
                      f'{step}, want {want}')
        if moe_sp:
            log(f'17b {tag}: against flash_attention\'s routing from the same '
                f'state, drops by step and layer '
                f'{[f["drops"] for f in r0["flash_ref"]]}; flipped top-k '
                f'choices and their router margins by step and layer '
                f'{json.dumps(route_flips(data, r0["flash_ref"], shape[0]))}')
        if fam == 'moe':
            check(drops == ref_drops and all(sum(d) > 0 for d in drops),
                  f'17b {tag}: dropped assignments by step and layer '
                  f'{drops}, the reference {ref_drops}')
        summary[tag] = r0['launches'][-1]
    log('17b launches a step, rank 0: ' + json.dumps(summary))
    return summary


# ---------------------------------------------------------------- phase 18
CKPT_LAYERS = 4             # 18a: Llama-3.1-8B width at depth 4
RECIPE_LAYERS = 2           # 18b: tpu_1b width at depth 2
RECIPE_KERNELS = ('flash_fwd', 'flash_dq', 'flash_dkv')
# Device bytes an int8 tree's load may take past the tree's own.
INT8_LOAD_MARGIN = 64 << 20
SERVE_ARGV = ['--batch', '8', '--max-prompt', '512', '--max-seq', '1024',
              '--prefill-chunk', '128', '--prefill-budget', '256',
              '--decode-chunk', '8']


def main_prompts(vocab, seed):
    """Phase 5's 12 prompts (100-512 tokens) from the seed."""
    import numpy as np
    lengths = np.random.default_rng(seed + 1).integers(100, 513, 12)
    return random_prompts(lengths, vocab, seed + 1)


def disk_room(path, need, tag):
    """Raise, naming the bytes, where ``path``'s file system has less
    than ``need`` bytes free: a phase that writes checkpoints never
    skips quietly."""
    import shutil
    free = shutil.disk_usage(path).free
    log(f'{tag}: {free / 1e9:.2f} GB free under {path}, '
        f'{need / 1e9:.2f} GB needed')
    if free < need:
        raise Failed(f'{tag}: {free} bytes free under {path}, {need} '
                     'needed for its checkpoints')


def tree_bytes(tree):
    from skypilot_tpu_torch.models import quantization
    return quantization.quantized_bytes(tree)


def trees_equal(torch, a, b):
    """Bitwise equal nested dicts of tensors (the paths that differ)."""
    from skypilot_tpu_torch import checkpoint
    fa = dict(checkpoint._flatten(a))
    fb = dict(checkpoint._flatten(b))
    if set(fa) != set(fb):
        return sorted(set(fa) ^ set(fb))
    return [p for p in fa if not (
        fa[p].dtype == fb[p].dtype and fa[p].shape == fb[p].shape and
        torch.equal(fa[p], fb[p]))]


def serve_tokens(torch, eng, prompts, tag, graphs=True):
    """Warm ``eng`` and serve the prompts, 32 tokens each: (tokens by
    request, launches, decode steps, prefill ticks)."""
    from skypilot_tpu_torch.models.serving_engine import Request
    warm(torch, eng, tag, graphs)
    steps0, ticks0 = eng.decode_steps_total, eng.prefill_ticks
    res, wall, launches, _ = serve(torch, eng, [
        Request(i, p, max_new=32) for i, p in enumerate(prompts)], tag)
    check(len(res) == len(prompts) and all(
        r.status == 'finished' and len(r.tokens) == 32
        for r in res.values()), f'{tag}: a request did not finish')
    toks = [res[i].tokens for i in range(len(prompts))]
    out = sum(map(len, toks))
    steps = eng.decode_steps_total - steps0
    ticks = eng.prefill_ticks - ticks0
    log(f'{tag}: {out} output tokens in {wall:.3f} s = {out / wall:.1f} '
        f'output tokens/s; {steps} decode steps, {ticks} prefill ticks; '
        f'launches {launches}')
    return toks, launches, steps, ticks


class cut_depth:
    """Within the block, ``serving_http._model`` gives its preset at
    ``layers`` layers (18a and 18c serve depth-cut checkpoints through
    ``_build_replica``) and records the device memory a checkpoint load
    takes (``_checkpoint_params``: peak allocated over the allocated
    before it, and the tree's bytes)."""

    def __init__(self, torch, layers):
        self.torch, self.layers, self.load = torch, layers, {}

    def __enter__(self):
        from skypilot_tpu_torch.models import serving_http
        self.mod = serving_http
        self.model, self.params = serving_http._model, \
            serving_http._checkpoint_params
        torch, layers = self.torch, self.layers

        def model(args, dev):
            return dataclasses.replace(self.model(args, dev), n_layers=layers)

        def params(*a):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            tree = self.params(*a)
            torch.cuda.synchronize()
            self.load = {'s': time.perf_counter() - t0,
                         'peak': torch.cuda.max_memory_allocated() - base,
                         'bytes': tree_bytes(tree)}
            return tree
        serving_http._model = model
        serving_http._checkpoint_params = params
        return self

    def __exit__(self, *exc):
        self.mod._model = self.model
        self.mod._checkpoint_params = self.params


def replica_argv(model, ckpt, quantized):
    return (['--model', model, '--checkpoint', ckpt] + SERVE_ARGV +
            (['--checkpoint-quantized', '--weight-quant'] if quantized
             else []))


def phase_checkpoint_serve(torch, dev, seed, card, tmp_root=None):
    """18a. Serving from the port's checkpoints at Llama-3.1-8B width,
    depth 4 (3.8 GB in bf16), phase 5's geometry and 12 requests on
    captured ticks. The dense tree from the seed is saved
    (``checkpoint.save``), loaded back (bitwise the tree) and served:
    its tokens must equal the in-memory tree's. ``quantize_checkpoint``
    then writes its int8 checkpoint on the host, and ``_build_replica``
    with ``--checkpoint ... --checkpoint-quantized --weight-quant``
    serves it: the tree must be bitwise ``quantize_params(tree)`` in
    memory, the device memory its load takes at most
    its int8 bytes plus 64 MiB, and its tokens those of that in-memory
    tree. K1, K2 and Q1 launch counts by route for both runs, save and
    load GB/s (warm file cache), the host quantize seconds. Returns the
    launches of the two checkpoint-served runs."""
    import shutil
    import tempfile

    from skypilot_tpu_torch import checkpoint
    from skypilot_tpu_torch.models import llama, quantization, serving_http
    cfg = llama.LlamaConfig.llama3_8b(max_seq=1024, param_dtype=torch.bfloat16,
                                      n_layers=CKPT_LAYERS)
    params = llama.init_params(cfg, seed, device=dev)
    dense_bytes = tree_bytes(params)
    tmp = tempfile.mkdtemp(prefix='skytpu-18a-', dir=tmp_root)
    out = {}
    try:
        disk_room(tmp, int(dense_bytes * 1.6), '18a')
        prompts = main_prompts(cfg.vocab_size, seed)
        geometry = dict(batch_size=8, max_prompt=512, prefill_chunk=128,
                        prefill_budget=256, decode_chunk=8, device=dev)
        from skypilot_tpu_torch.models.serving_engine import ServingEngine
        want, _, _, _ = serve_tokens(
            torch, ServingEngine(params, cfg, **geometry), prompts,
            '18a in-memory dense')
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = checkpoint.save(os.path.join(tmp, 'dense'), params)
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        loaded = checkpoint.load(os.path.join(tmp, 'dense'),
                                 checkpoint.param_like(cfg), device=dev,
                                 dtype=cfg.param_dtype)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        log(f'18a on {card}: dense depth {CKPT_LAYERS} tree {n / 1e9:.3f} GB '
            f'saved in {save_s:.2f} s ({n / save_s / 1e9:.2f} GB/s), loaded '
            f'to the card in {load_s:.2f} s ({n / load_s / 1e9:.2f} GB/s, '
            'file cache warm)')
        check(n == dense_bytes, f'18a: saved {n} of {dense_bytes} bytes')
        bad = trees_equal(torch, params, loaded)
        check(not bad, f'18a: the loaded tree differs at {bad[:4]}')
        toks, dense_launches, steps, ticks = serve_tokens(
            torch, ServingEngine(loaded, cfg, **geometry), prompts,
            '18a dense from the checkpoint')
        del loaded
        same = sum(a == b for a, b in zip(toks, want))
        log(f'18a: dense from the checkpoint {same}/12 requests equal the '
            'in-memory tree\'s tokens')
        check(same == 12, f'18a dense: {same}/12 requests equal')
        check(dense_launches.get('paged_decode', 0) == steps * CKPT_LAYERS
              and dense_launches.get('chunk_prefill', 0) ==
              ticks * CKPT_LAYERS and not any(
                  k.endswith('.f32') for k in dense_launches),
              f'18a dense: launches {dense_launches}')
        out['18a dense'] = dense_launches

        t0 = time.perf_counter()
        quantization.quantize_checkpoint(os.path.join(tmp, 'dense'),
                                         os.path.join(tmp, 'int8'), cfg)
        quant_s = time.perf_counter() - t0
        int8_disk = sum(os.path.getsize(os.path.join(tmp, 'int8', f))
                        for f in os.listdir(os.path.join(tmp, 'int8')))
        log(f'18a: quantize_checkpoint on the host {quant_s:.2f} s '
            f'({n / 1e9:.3f} GB bf16 -> {int8_disk / 1e9:.3f} GB on disk)')
        qmem = quantization.quantize_params(params)
        del params
        torch.cuda.empty_cache()
        qwant, _, _, _ = serve_tokens(
            torch, ServingEngine(qmem, cfg, **geometry), prompts,
            '18a in-memory int8')
        args = serving_http.parse_args(replica_argv(
            'llama3_8b', os.path.join(tmp, 'int8'), True))
        with cut_depth(torch, CKPT_LAYERS) as cut:
            eng, workers = serving_http._build_replica(args)
        check(workers is None, '18a: a tp 1 replica spawned workers')
        load = cut.load
        log(f'18a: int8 checkpoint loaded to the card in {load["s"]:.2f} s '
            f'({load["bytes"] / load["s"] / 1e9:.2f} GB/s); device memory '
            f'the load took {load["peak"] / 2**20:.1f} MiB against the tree\'s '
            f'{load["bytes"] / 2**20:.1f} MiB')
        check(load['peak'] <= load['bytes'] + INT8_LOAD_MARGIN,
              f'18a: the int8 load took {load["peak"]} bytes of device memory '
              f'for a {load["bytes"]}-byte tree')
        bad = trees_equal(torch, eng.params, qmem)
        check(not bad, f'18a: the int8 checkpoint differs from '
              f'quantize_params at {bad[:4]}')
        del qmem
        qtoks, q_launches, steps, ticks = serve_tokens(
            torch, eng, prompts, '18a int8 from the checkpoint')
        del eng
        same = sum(a == b for a, b in zip(qtoks, qwant))
        log(f'18a: int8 from the checkpoint {same}/12 requests equal the '
            'in-memory quantized tree\'s tokens')
        check(same == 12, f'18a int8: {same}/12 requests equal')
        want_q1 = (steps + ticks) * (7 * CKPT_LAYERS + 1)
        check(q_launches.get('int8_matmul', 0) == want_q1 > 0 and
              'int8_matmul.f32' not in q_launches and
              q_launches.get('paged_decode', 0) == steps * CKPT_LAYERS and
              q_launches.get('chunk_prefill', 0) == ticks * CKPT_LAYERS,
              f'18a int8: launches {q_launches}, want Q1 {want_q1}')
        out['18a int8'] = q_launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    return out


def trace_kernels(path):
    """{kernel group: launches} of the CUDA kernels in a Chrome trace,
    and whether it holds CPU operators (``aten::``)."""
    with open(path, encoding='utf-8') as fh:
        events = json.load(fh).get('traceEvents', [])
    counts, aten = {}, False
    for e in events:
        name = str(e.get('name', ''))
        if e.get('cat') == 'kernel':
            for key in RECIPE_KERNELS:
                if key in name:
                    counts[key] = counts.get(key, 0) + 1
        aten = aten or name.startswith('aten::')
    return counts, aten


class patched_preset:
    """Within the block, ``models.config_preset`` gives its presets at
    ``layers`` layers (the recipe's depth cut in 18b)."""

    def __init__(self, layers):
        self.layers = layers

    def __enter__(self):
        from skypilot_tpu_torch import models
        self.models, self.orig = models, models.config_preset
        orig, layers = self.orig, self.layers

        def preset(name):
            fn = orig(name)
            return lambda **kw: dataclasses.replace(fn(**kw), n_layers=layers)
        models.config_preset = preset
        return self

    def __exit__(self, *exc):
        self.models.config_preset = self.orig


def recipe_runs(torch, tmp, tag, card, profile=True):
    """The finetune recipe at tpu_1b width, B 4 x S 2048, 4 steps with a
    checkpoint every 2 (run A, under ``SKYTPU_PROFILE_DIR`` when
    ``profile``), then run B: A's step-2 checkpoint as a preempted job
    left it, and the same command resumed. Returns (A, B, A's launches,
    the trace path)."""
    import shutil

    from skypilot_tpu_torch.ops import _build
    from skypilot_tpu_torch.recipes import finetune
    from skypilot_tpu_torch.utils import profiling
    argv = ['--model', 'tpu_1b', '--seq', '2048', '--batch-per-host', '4',
            '--steps', '4', '--ckpt-every', '2']
    os.environ['SKYTPU_TASK_ID'] = 'chip-smoke-18'
    prof_dir = os.path.join(tmp, 'profile')
    try:
        if profile:
            os.environ[profiling.PROFILE_DIR_ENV] = prof_dir
            profiling._traced_once = False
        _build.reset_launches()
        t0 = time.perf_counter()
        a = finetune.main(argv + ['--ckpt-dir', os.path.join(tmp, 'a')])
        torch.cuda.synchronize()
        a_s = time.perf_counter() - t0
        launches = {k: _build.LAUNCHES.get(k, 0) for k in RECIPE_KERNELS}
        os.environ.pop(profiling.PROFILE_DIR_ENV, None)
        run_a = os.path.join(tmp, 'a', 'chip-smoke-18')
        check(sorted(os.listdir(run_a)) == ['2', '4'],
              f'{tag}: run A committed {sorted(os.listdir(run_a))}')
        run_b = os.path.join(tmp, 'b', 'chip-smoke-18')
        os.makedirs(run_b)
        shutil.copytree(os.path.join(run_a, '2'), os.path.join(run_b, '2'))
        t0 = time.perf_counter()
        b = finetune.main(argv + ['--ckpt-dir', os.path.join(tmp, 'b')])
        torch.cuda.synchronize()
        b_s = time.perf_counter() - t0
    finally:
        os.environ.pop('SKYTPU_TASK_ID', None)
        os.environ.pop(profiling.PROFILE_DIR_ENV, None)
    cfg = a['cfg']
    log(f'{tag} on {card}: tpu_1b width, {cfg.n_layers} layers, B 4 x S '
        f'2048, AdamW: run A 4 steps in {a_s:.1f} s ({a["tokens_per_s"]:.0f} '
        f'tokens/s with 2 checkpoint saves), losses {a["losses"]}; run B '
        f'resumed from step {b["resumed_from"]}, 2 steps in {b_s:.1f} s, '
        f'losses {b["losses"]}; launches in run A {launches}')
    check(b['resumed_from'] == 2 and b['steps_done'] == 2,
          f'{tag}: run B resumed from {b["resumed_from"]}')
    check(b['losses'] == a['losses'][2:],
          f'{tag}: resumed losses {b["losses"]} against {a["losses"][2:]}')
    from skypilot_tpu_torch import checkpoint
    sa = checkpoint._as_tree(a['state'])[1]
    sb = checkpoint._as_tree(b['state'])[1]
    check(sa['step'] == sb['step'] == 4, f'{tag}: steps {sa["step"]}, '
          f'{sb["step"]}')
    for part in ('params', 'opt_state'):
        bad = trees_equal(torch, {k: v for k, v in sa[part].items()
                                  if k != 'count'},
                          {k: v for k, v in sb[part].items()
                           if k != 'count'})
        check(not bad, f'{tag}: resumed {part} differ at {bad[:4]}')
    n_l = cfg.n_layers
    check(launches['flash_fwd'] == 4 * 2 * n_l and
          launches['flash_dq'] == launches['flash_dkv'] == 4 * n_l,
          f'{tag}: K4/K5a/K5b launches {launches}, want {8 * n_l}/{4 * n_l}/'
          f'{4 * n_l}')
    traces = sorted(os.listdir(prof_dir)) if profile else []
    return a, b, launches, [os.path.join(prof_dir, t) for t in traces]


def phase_recipe(torch, dev, seed, card, tmp_root=None):
    """18b. The finetune recipe (``recipes/finetune.py``, its own NCCL
    world of one) at tpu_1b width, depth 2, B 4 x S 2048: 4 steps with a
    checkpoint every 2, then the same command resumed from step 2 as a
    preempted managed job: its final loss, every parameter and the
    optimizer state bitwise the uninterrupted run's. Under
    ``SKYTPU_PROFILE_DIR`` run A writes one Chrome trace, at step 2,
    which must list K4, K5a and K5b; a capture from the profiler server
    (``SKYTPU_PROFILER_PORT``), taken from its thread while this thread
    runs train steps, must list them too (whether it holds this thread's
    CPU operators is printed). K4/K5a/K5b launches: 8/4/4 a layer over
    run A's 4 steps. Returns run A's launches."""
    del seed                      # the recipe seeds itself (0)
    import shutil
    import tempfile
    import threading

    from skypilot_tpu_torch import models
    from skypilot_tpu_torch.models import train
    from skypilot_tpu_torch.recipes import finetune
    from skypilot_tpu_torch.utils import profiling
    tmp = tempfile.mkdtemp(prefix='skytpu-18b-', dir=tmp_root)
    try:
        # tpu_1b at depth 2: 0.84B params; 3 saves of params + AdamW.
        disk_room(tmp, 3 * 3 * 2 * 840_000_000 + (1 << 30), '18b')
        with patched_preset(RECIPE_LAYERS):
            a, b, launches, traces = recipe_runs(torch, tmp, '18b', card)
        check(len(traces) == 1 and traces[0].endswith('-step2.json'),
              f'18b: SKYTPU_PROFILE_DIR holds {traces}')
        counts, _ = trace_kernels(traces[0])
        log(f'18b: the step-2 trace lists {counts} ({traces[0]})')
        check(all(counts.get(k, 0) > 0 for k in RECIPE_KERNELS),
              f'18b: the step-2 trace lists {counts}')

        # The profiler server: a capture from its thread while this
        # thread trains.
        os.environ[profiling.PROFILER_PORT_ENV] = str(free_port())
        os.environ[profiling.PROFILE_DIR_ENV] = os.path.join(tmp, 'server')
        try:
            port = profiling.maybe_start_profiler_server()
            cfg = b['cfg']
            state = b['state']
            step = train.make_train_step(cfg, models.make_optimizer())
            batch = {'tokens': finetune.batch_rows(9, 0, 4, 2048,
                                                   cfg.vocab_size).to(dev)}
            got = {}

            def capture():
                got['answer'] = http_call(
                    f'http://127.0.0.1:{port}/capture?ms=1500')
            t = threading.Thread(target=capture)
            t.start()
            steps = 0
            while t.is_alive():
                state, _ = step(state, batch)
                torch.cuda.synchronize()
                steps += 1
            t.join()
        finally:
            profiling.stop_profiler_server()
            os.environ.pop(profiling.PROFILER_PORT_ENV, None)
            os.environ.pop(profiling.PROFILE_DIR_ENV, None)
        status, _, body = got['answer']
        check(status == 200, f'18b: the server answered {status} {body!r}')
        path = json.loads(body)['path']
        counts, aten = trace_kernels(path)
        log(f'18b: a 1500 ms server capture during {steps} train steps on '
            f'this thread lists {counts}; this thread\'s CPU operators '
            f'{"present" if aten else "absent"}')
        check(all(counts.get(k, 0) > 0 for k in RECIPE_KERNELS),
              f'18b: the server capture lists {counts}')
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()


# Runs argv[1:] and prints its own peak resident set: the ru_maxrss of
# its child from os.wait4. A launcher this small keeps the figure the
# command's own (a child's ru_maxrss also counts the pages it held
# between its fork and its exec, which a fork of this process would
# make its whole resident set).
_PEAK_RSS_LAUNCHER = (
    'import os, subprocess, sys\n'
    'p = subprocess.Popen(sys.argv[1:])\n'
    '_, status, usage = os.wait4(p.pid, 0)\n'
    'print(f"peak_rss_kb={usage.ru_maxrss}", flush=True)\n'
    'sys.exit(os.waitstatus_to_exitcode(status))\n')


def peak_rss_run(cmd, env, timeout, log_path):
    """Run ``cmd`` (its output to ``log_path``) under a small launcher,
    killed after ``timeout`` s; (exit code, its output, seconds, its peak
    resident bytes, 0 where none was reported)."""
    import re
    with open(log_path, 'w', encoding='utf-8') as fh:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, '-c', _PEAK_RSS_LAUNCHER] +
                              cmd, env=env, cwd=HERE, stdout=fh,
                              stderr=subprocess.STDOUT, timeout=timeout,
                              check=False)
        secs = time.perf_counter() - t0
    with open(log_path, encoding='utf-8') as fh:
        out = fh.read()
    found = re.findall(r'peak_rss_kb=(\d+)', out)
    return proc.returncode, out, secs, int(found[-1]) * 1024 if found else 0


def phase_checkpoint_full(torch, dev, seed, card):
    """18c (``--only 18`` only): the full cells, through the CLIs. The
    32-layer Llama-3.1-8B tree from the seed (16.06 GB bf16) saved, the
    quantization CLI run as a subprocess (its host peak RSS printed),
    then ``python -m skypilot_tpu_torch.models.serving_http --model
    llama3_8b --checkpoint ... --checkpoint-quantized --weight-quant``
    serving phase 12's 12 requests over HTTP: the tokens of an in-process
    engine on ``quantize_params(tree)``. The Mixtral-8x7B
    width at depth 2 born int8, saved and served through
    ``_build_replica``, equal to the in-memory tree's tokens. The
    finetune recipe's resume at tpu_1b's full 16 layers, bitwise. Free
    disk space is checked before each part (raising with the bytes);
    everything is written to a temporary directory and removed."""
    import shutil
    import signal
    import tempfile

    from skypilot_tpu_torch import checkpoint
    from skypilot_tpu_torch.models import llama, moe, quantization, serving_http
    from skypilot_tpu_torch.models.serving_engine import ServingEngine
    tmp = tempfile.mkdtemp(prefix='skytpu-18c-')
    env = dict(os.environ, PYTHONPATH=HERE)
    geometry = dict(batch_size=8, max_prompt=512, prefill_chunk=128,
                    prefill_budget=256, decode_chunk=8, device=dev)
    try:
        cfg = llama.LlamaConfig.llama3_8b(max_seq=1024,
                                          param_dtype=torch.bfloat16)
        params = llama.init_params(cfg, seed, device=dev)
        n_dense = tree_bytes(params)
        disk_room(tmp, int(n_dense * 1.6), '18c 8B')
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        checkpoint.save(os.path.join(tmp, 'dense'), params)
        save_s = time.perf_counter() - t0
        log(f'18c on {card}: 8B dense tree {n_dense / 1e9:.3f} GB saved in '
            f'{save_s:.1f} s ({n_dense / save_s / 1e9:.2f} GB/s)')
        qmem = quantization.quantize_params(params)
        del params
        torch.cuda.empty_cache()
        rc, out, secs, rss = peak_rss_run(
            [sys.executable, '-m', 'skypilot_tpu_torch.models.quantization',
             os.path.join(tmp, 'dense'), os.path.join(tmp, 'int8'),
             '--model', 'llama3_8b'], env, 1200, os.path.join(tmp, 'cli.log'))
        # What the process holds before it reads anything: Python with
        # torch's CUDA build and the port imported.
        _, _, _, base = peak_rss_run(
            [sys.executable, '-c',
             'import skypilot_tpu_torch.models.quantization'], env, 300,
            os.path.join(tmp, 'import.log'))
        log(f'18c: the quantization CLI exited {rc} after {secs:.1f} s; its '
            f'host peak RSS ' + (f'{rss / 2**30:.2f} GiB' if rss else
                                 'not measured (no ru_maxrss here)')
            + f', of which {base / 2**30:.2f} GiB is the interpreter with '
            f'torch and the port imported; {out.strip()[-200:]}')
        check(rc == 0, f'18c: quantization CLI exit {rc}: {out[-2000:]}')
        shutil.rmtree(os.path.join(tmp, 'dense'))
        int8_disk = sum(os.path.getsize(os.path.join(tmp, 'int8', f))
                        for f in os.listdir(os.path.join(tmp, 'int8')))
        log(f'18c: int8 checkpoint {int8_disk / 1e9:.3f} GB on disk')
        prompts = main_prompts(cfg.vocab_size, seed)
        want, _, _, _ = serve_tokens(
            torch, ServingEngine(qmem, cfg, **geometry), prompts,
            '18c in-memory int8 8B')
        del qmem
        torch.cuda.empty_cache()
        port = free_port()
        replica_log = os.path.join(tmp, 'replica.log')
        with open(replica_log, 'w', encoding='utf-8') as fh:
            proc = subprocess.Popen(
                [sys.executable, '-m',
                 'skypilot_tpu_torch.models.serving_http',
                 '--port', str(port)] + replica_argv(
                     'llama3_8b', os.path.join(tmp, 'int8'), True),
                env=env, cwd=HERE, stdout=fh, stderr=subprocess.STDOUT)
        try:
            url = f'http://127.0.0.1:{port}'
            t0 = time.perf_counter()
            wait_healthy(url, '18c replica')
            log(f'18c: the replica served /health after '
                f'{time.perf_counter() - t0:.1f} s (load and warmup)')
            import concurrent.futures
            with concurrent.futures.ThreadPoolExecutor(12) as pool:
                answers = list(pool.map(lambda p: http_call(
                    url + '/generate', {'tokens': p, 'max_new': 32}),
                    prompts))
            got = [json.loads(a[2]).get('tokens') for a in answers]
            same = sum(a == b for a, b in zip(got, want))
            log(f'18c: {same}/12 HTTP answers equal the in-memory int8 '
                'tree\'s tokens')
            check(same == 12, f'18c: {same}/12 equal over HTTP')
        finally:
            proc.send_signal(signal.SIGTERM)
            try:
                rc = proc.wait(120)
            except subprocess.TimeoutExpired:
                proc.kill()
                rc = proc.wait(10)
            with open(replica_log, encoding='utf-8') as fh:
                tail = fh.read()[-1500:]
        check(rc == 0, f'18c: the replica exited {rc}: {tail}')
        shutil.rmtree(os.path.join(tmp, 'int8'))

        mcfg = moe.MoEConfig.mixtral_8x7b(max_seq=1024,
                                          param_dtype=torch.bfloat16,
                                          n_layers=2)
        mq = quantization.init_quantized_params(mcfg, seed, device=dev)
        disk_room(tmp, int(tree_bytes(mq) * 1.2), '18c Mixtral')
        checkpoint.save(os.path.join(tmp, 'mixtral'), mq)
        prompts = main_prompts(mcfg.vocab_size, seed)
        mwant, _, _, _ = serve_tokens(
            torch, ServingEngine(mq, mcfg, **geometry), prompts,
            '18c in-memory Mixtral depth 2 int8')
        del mq
        torch.cuda.empty_cache()
        args = serving_http.parse_args(replica_argv(
            'mixtral_8x7b', os.path.join(tmp, 'mixtral'), True))
        with cut_depth(torch, 2) as cut:
            eng, _ = serving_http._build_replica(args)
        log(f'18c: Mixtral depth 2 int8 ({cut.load["bytes"] / 1e9:.2f} GB) '
            f'loaded in {cut.load["s"]:.2f} s; device memory the load took '
            f'{cut.load["peak"] / 2**20:.1f} MiB')
        mgot, m_launches, steps, ticks = serve_tokens(
            torch, eng, prompts, '18c Mixtral depth 2 from the checkpoint')
        del eng
        same = sum(a == b for a, b in zip(mgot, mwant))
        check(same == 12, f'18c Mixtral: {same}/12 requests equal')
        check(m_launches.get('int8_matmul', 0) ==
              (steps + ticks) * moe_q1_per_forward(mcfg),
              f'18c Mixtral: Q1 launches {m_launches}')
        shutil.rmtree(os.path.join(tmp, 'mixtral'))
        torch.cuda.empty_cache()

        # tpu_1b at 16 layers: 1.5B params; 3 saves of params + AdamW.
        disk_room(tmp, 3 * 3 * 2 * 1_500_000_000 + (1 << 30),
                  '18c recipe')
        recipe_runs(torch, tmp, '18c recipe, tpu_1b full depth', card,
                    profile=False)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
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
    tp_one = phase('15 (15b) tp 1 over NCCL', phase_tp_nccl_one, torch, dev,
                   args.seed, card, handover) or {}
    tp_summary = phase('15 (15c) 8B tp 2 and 4 over gloo', phase_tp_gloo,
                       torch, dev, args.seed, card, handover) or {}
    tp_multi = phase('15 (15d) NCCL tp > 1', phase_tp_nccl_multi, torch,
                     dev, args.seed, card, handover)
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
    train_ref = {}
    train_launches = phase('8 training path', phase_train, torch, dev,
                           args.seed, card, args.profile_dir,
                           train_ref) or {}
    sharded_one = phase('16 (16a) sharded step, a world of one over NCCL',
                        phase_sharded_one, torch, dev, args.seed, card,
                        train_ref) or {}
    train_ref.clear()
    torch.cuda.empty_cache()
    ring_launches = phase('17 (17a) ring attention\'s flash route',
                          phase_ring, torch, dev, args.seed, card) or {}
    # The spawned worlds share the card: leave them its memory.
    gc.collect()
    torch.cuda.empty_cache()
    if only is not None and '17' in only:
        phase('17 (17b) sp, ep and pp steps over gloo', phase_ring_worlds,
              torch, dev, args.seed, card)
    else:
        log('17b (sp, ep and pp worlds of 2 and 4 ranks over gloo) runs '
            'under --only 17: with it the whole run would pass 900 s')
    if only is not None and '16' in only:
        phase('16 (16b) sharded steps over gloo', phase_sharded_gloo, torch,
              dev, args.seed, card)
    else:
        log('16b (sharded worlds of 2 and 4 ranks over gloo) runs under '
            '--only 16: with it the whole run would pass 900 s')
    phase('9 training parity', phase_train_parity, torch, dev, args.seed)
    phase('9 (9b) policy, MoE, GPT-2 and Adafactor parity',
          phase_family_parity, torch, dev, args.seed)
    phase('10 generate', phase_generate, torch, dev, parity)
    del parity
    torch.cuda.empty_cache()
    phase('11 (11a) Q1 vs plain', phase_q1, torch, dev, args.seed, report)
    phase('15 (15a) kernels at the shard shapes', phase_tp_kernels, torch,
          dev, args.seed, report)
    phase('11 (11b) qdot_a8', phase_int_mm, torch, dev, args.seed)
    phase('11 (11c) int8 parity', phase_int8_parity, torch, dev, args.seed)
    q1_launches = phase('11 (11d) int8 main path', phase_int8_main_path,
                        torch, dev, args.seed, card, bf16_rate,
                        args.profile_dir) or {}
    phase('11 (11e) decode_w8 shape', phase_decode_w8, torch, dev,
          args.seed, card)
    phase('11 (11f) serve_a8 shape', phase_serve_a8, torch, dev, args.seed,
          card)
    phase('13 (13a) MoE parity', phase_moe_parity, torch, dev, args.seed)
    moe_handover = {}
    moe_launches = phase('13 (13b) MoE main path', phase_moe_main_path,
                         torch, dev, args.seed, card, args.profile_dir,
                         moe_handover) or {}
    tp_moe_launches = phase('15 (15c) Mixtral tp 2 over gloo', phase_tp_moe,
                            torch, dev, args.seed, card, moe_handover) or {}
    phase('13 (13c) GPT-2', phase_gpt2, torch, dev, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    cell_launches = {}
    for name, fn in (
            ('14 (14a) train cell', phase_train_kvo_cell),
            ('14 (14b) moe_train cell', phase_moe_train_cell),
            ('14 (14c) longctx_train cell', phase_longctx_train_cell),
            ('14 (14d) GPT-2 train cell', phase_gpt2_train_cell)):
        cell_launches.update(phase(name, fn, torch, dev, args.seed, card,
                                   args.profile_dir) or {})
    gc.collect()
    torch.cuda.empty_cache()
    ckpt_launches = phase('18 (18a) serving from checkpoints',
                          phase_checkpoint_serve, torch, dev, args.seed,
                          card) or {}
    ckpt_launches['18b recipe, run A'] = phase(
        '18 (18b) the finetune recipe, resumed', phase_recipe, torch, dev,
        args.seed, card) or {}
    if only is not None and '18' in only:
        phase('18 (18c) the full cells through the CLIs',
              phase_checkpoint_full, torch, dev, args.seed, card)
    else:
        log('18c (the 32-layer 8B checkpoint through the CLIs, Mixtral '
            'depth 2, the recipe at full depth) runs under --only 18')
    # K1/K2 count from the serving path's run, K3 from the organic spec
    # run, K4/K5 from the training path's, Q1 from the int8 main path's;
    # neither path launches the other's kernels.
    for entry in report:
        entry['launches'] = {**main_launches, **train_launches,
                             **q1_launches}.get(entry['name'], 0)
        # The MoE main path (13b) drives K1, K2 and Q1 again.
        entry['launches_moe_main_path'] = moe_launches.get(entry['name'], 0)
        # Phase 15c's TP engines drive K1, K2 (and Q1 for Mixtral) on each
        # rank's shard: rank 0's counts, n_kv / tp heads a launch.
        entry['launches_tp'] = {
            '8B tp1 NCCL spec': tp_one.get(entry['name'], 0),
            **{f'8B tp{tp}': s['launches'].get(entry['name'], 0)
               for tp, s in tp_summary.items()},
            'Mixtral tp2': tp_moe_launches.get(entry['name'], 0)}
        # Phase 14's training cells drive K4, K5a and K5b (timed steps).
        entry['launches_train_cells'] = {
            cell: launches.get(entry['name'], 0)
            for cell, launches in cell_launches.items()}
        # Phase 16a's sharded step (a world of one over NCCL): this
        # kernel's launches and the collectives, a timed step.
        step = sharded_one.get('per_step', {})
        entry['launches_sharded_train'] = {
            '16a a step': step.get(entry['name'], 0),
            '16a collectives a step': {
                k: v for k, v in step.items()
                if k.split('.')[0] in COLLECTIVES}}
        # Phase 17a's ring (one process, n chunks): K4, K5a and K5b a
        # call, by shape and chunk count.
        entry['launches_ring'] = {case: c[entry['name']]
                                  for case, c in ring_launches.items()
                                  if entry['name'] in c}
        # Phase 18: 18a's runs served from checkpoints (K1, K2, Q1) and
        # the recipe's run A in 18b (K4, K5a, K5b).
        entry['launches_checkpoint'] = {
            run: c.get(entry['name'], 0) for run, c in ckpt_launches.items()}
    if tp_multi is False:
        log('15d: reported as not run (one card): not counted as passed')
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
