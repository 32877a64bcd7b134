"""Continuous-batching serving engine over the KV-cache decoder.

Port of the core of ``skypilot_tpu/models/serving_engine.py``: a fixed
decode batch of ``batch_size`` slots recycled as requests finish;
chunked prefill under a per-tick token budget (each admitted prompt
streams into its slot's prompt-region KV ``prefill_chunk`` tokens per
tick, at most ``budget // chunk`` prefilling rows per tick, fused with
the decode chunk of the active slots); an ``n``-step decode scan per
tick whose page count follows the longest live row; slot epochs so a
tick in flight never credits tokens to a slot's next occupant. Each
slot owns its decode columns (``inference``'s per-row ``steps``): a
row writes at its own frontier, its count returns to 0 with its next
occupant, and ``max_new <= decode_capacity()`` (checked at submit) is
all a request needs to finish. So admission takes the next request
whenever a slot is free and the prefill-row cap allows, however long
the answers in the other slots run.

Each tick is one program, keyed as the reference keys its jitted tick
programs: decode ``(n, num_pages)``, mixed ``(n, num_pages, spec)``
(prefill chunk rows fused with the decode scan or the verify pass;
``(0, None, 0)`` prefills only) and verify ``(num_pages)``. On the card
``warmup()`` captures one CUDA graph per key the reference's warmup
compiles, all in one memory pool, over static device buffers (the
cache, the token vector, the inputs below); a tick is then one copy of
its small inputs into those buffers and one replay. A key warmup did
not capture raises: nothing is captured late or run eagerly. On the CPU
the same tick bodies run eagerly.

Double buffering: ``step()`` launches tick N+1 before it reads tick N.
A tick's inputs (active mask, temperatures, chunk metadata, drafts)
are staged in one of two pinned host buffers and copied to the static
device inputs in stream order; its outputs (tokens, verify counts,
first tokens) are copied, in stream order, out of the program's static
output into one of two pinned host buffers, with an event that
``_process_tick`` waits on. So a replay never overwrites what the host
has yet to read, and the host work of one tick overlaps the device work
of the next.

Speculative decoding (``spec_decode`` / ``SKYTPU_SPEC_DECODE``): a
host-side prompt-lookup proposer drafts up to ``spec_k`` tokens per
greedy decode slot, and a tick with drafts runs one batched
``inference.verify_step`` instead of the decode chunk; each row
advances by its accepted prefix + 1, and greedy output stays equal to
speculation off. A capacity guard falls back to the decode chunk when
a verify segment could strand a row in its own columns, and a
dry-spell latch keeps no-match traffic on the pipelined path.

Automatic prefix caching (``prefix_cache`` / ``SKYTPU_PREFIX_CACHE``;
``models/prefix_cache.py``): an admission looks up the prompt's chain
hashes in a shared page pool, copies the matched pages into the slot's
prompt region (in place, on the ticks' stream) and starts its chunked
prefill at the chunk-aligned cached boundary; a terminal slot publishes
its finished prompt pages and releases its pins. A hit adds no tick
program (chunk starts are device inputs). Greedy output stays
bit-identical to the cache off on the card: the pool holds the bits
the request's own prefill would write, and the decode and verify
kernels (both routes) reduce each row's live keys in their own order,
so a hit's earlier decode start (other cache columns, other num_pages)
moves no bit. The CPU plain versions reduce by cache column, the
reference's order, so there a change of schedule can move the last f32
bit.
Remote pages queued by
``queue_kv_import`` land in the pool first thing at a tick boundary.

Request lifecycle and telemetry, as the reference's: ``Request.deadline``
bounds a request's lifetime (queued or in a slot, it expires with status
``expired`` and its tokens so far); ``cancel()`` from any thread frees a
slot at the next tick boundary; ``estimate_wait_s()`` is the admission
signal a front end sheds on; ``limits()`` what stream resumption sizes
against; a tick watchdog (``SKYTPU_TICK_HANG_SECONDS``) flags stalls.
Multi-tenant QoS (``Request.tenant``/``priority_class``, the
``SKYTPU_QOS_*`` knobs, ``utils/qos.py``) orders admission by deficit
round robin across (tenant, class) streams once a request names a tenant
or a non-default class, sheds the newest lowest-class request past
``SKYTPU_QOS_MAX_QUEUE`` and preempts a lower-class slot after a
sustained stall. Every one of these acts at the tick boundary through
``_cancel_now`` or ``_admit``'s pick: none adds a tick program or a
device sync. The ``skytpu_engine_*`` series (``metrics/``), the
``engine.*`` spans (``trace/``, under ``SKYTPU_TRACE_DIR``) and the
``engine.tick.hang``/``engine.tenant.burst`` fault sites carry the
reference's names, labels and buckets. Warmup counts in none of them.
The port's own tick spans (``engine.tick`` and its phases, and
``engine.tick.device`` with the tick's work and device time) exist
only under ``SKYTPU_TRACE_DIR``; docs/tracing.md lists them.

int8 weights (``weight_quant``): a dense tree is quantized once at
construction (``quantization.quantize_params``, the reference
engine's jitted rounding, per-output-channel scales; the
caller's tree is left whole), a quantized one is taken as
it is. The leaves are dicts of tensors whose addresses never change, so
the captured ticks close over them as over dense weights: no tick key
is added, and every product against them is Q1 (``ops/int8_matmul``) or,
with ``cfg.prefill_a8``, ``torch._int_mm`` in the prefill chunks.

Model families: a ``LlamaConfig`` or a ``MoEConfig`` (whose layers route
through ``cfg.infer_dispatch``, dropless or capacity, over dense or int8
expert banks: same ticks, same keys); a ``GPT2Config`` raises
``exceptions.NotSupportedError``, as the reference's engine does.

The decode attention is the reference's option (``decode_attn`` /
``SKYTPU_DECODE_ATTN``, resolved once). On the CPU a page-misaligned
``max_seq`` downgrades 'paged' to the cache-wide einsum with one
warning, as the reference does; on the card the cache instead gets the
columns up to the next page boundary, which no row ever reads, so K1
stays on the path. Length-aware dispatch is always on
(``paged_dispatch`` takes True only). The HTTP front end is
``models/serving_http.py``.

Tensor parallelism (``mesh=``, ``parallel/mesh.py``): one engine per
rank, each over its shard of the params (``param_specs``), its kv heads
of the cache and of the prefix pool. Rank 0 runs everything host-side
(admission, QoS, the proposer, the prefix directory), as the
reference's single controller does; every device operation goes
through one point, ``self._op`` (``parallel/channel.py``), which
broadcasts it to the workers before rank 0 runs its own part: the tick
(its key and its staged inputs), a cache reset, a prefix copy-in or
publish, a KV import or export, the warmup build and capture, and the
stop. Each worker runs ``serve_worker``: the same engine replaying what
rank 0 sends, so every rank launches the same ticks and ends each with
the same token vector (the collectives give every rank the same
logits; ``SKYTPU_TP_CHECK=1`` compares the vectors after each tick).
Under NCCL every rank captures the same tick graphs, the collectives
inside them; under gloo (CPU ranks, or ranks sharing one card) the
ticks run eagerly, as the CPU's always do, and ``mesh_info`` says so.
"""
from __future__ import annotations

import collections
import contextlib
import contextvars
import dataclasses
import functools
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from skypilot_tpu_torch import exceptions
from skypilot_tpu_torch import metrics as metrics_lib
from skypilot_tpu_torch import trace as trace_lib
from skypilot_tpu_torch.models import inference
from skypilot_tpu_torch.models import prefix_cache as prefix_mod
from skypilot_tpu_torch.models import quantization
from skypilot_tpu_torch.models.gpt2 import GPT2Config
from skypilot_tpu_torch.models.llama import LlamaConfig
from skypilot_tpu_torch.ops import _build
from skypilot_tpu_torch.ops import decode_attention as decode_attn_mod
from skypilot_tpu_torch.ops import split_kv
from skypilot_tpu_torch.parallel import channel as channel_lib
from skypilot_tpu_torch.parallel import distributed
from skypilot_tpu_torch.utils import env_registry
from skypilot_tpu_torch.utils import fault_injection
from skypilot_tpu_torch.utils import lifecycle
from skypilot_tpu_torch.utils import qos as qos_lib
from skypilot_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

# Serving metrics: the reference's series under its names, help, labels
# and buckets (a torch replica is scraped as a JAX one is). Host-side
# only: nothing here touches the tick programs.
_M_QUEUE_DEPTH = metrics_lib.gauge(
    'skytpu_engine_queue_depth',
    'Requests queued for admission (not yet in a decode slot).')
_M_ACTIVE_SLOTS = metrics_lib.gauge(
    'skytpu_engine_active_slots',
    'Decode slots currently occupied by a live request.')
_M_REQUESTS = metrics_lib.counter(
    'skytpu_engine_requests_total',
    'Requests accepted by submit().')
_M_TOKENS = metrics_lib.counter(
    'skytpu_engine_tokens_total',
    'Output tokens emitted to requests (rate() of this is tokens/s).')
_M_PREFILL_TOKENS = metrics_lib.counter(
    'skytpu_engine_prefill_tokens_total',
    'Prompt tokens prefilled into slot KV caches (chunked prefill; '
    'per tick this never exceeds the prefill token budget).')
# The reference's series, kept so a scrape lists what it lists: the
# port's slots own their decode columns, so it never rebuilds the
# cache and the series stays 0.
_M_RESETS = metrics_lib.counter(
    'skytpu_engine_cache_resets_total',
    'KV-cache rebuilds after decode-region exhaustion.')
_M_TTFT = metrics_lib.histogram(
    'skytpu_engine_ttft_seconds',
    'Submit-to-first-token latency (queue wait + prefill + sync).',
    buckets=metrics_lib.LATENCY_BUCKETS)
_M_ITL = metrics_lib.histogram(
    'skytpu_engine_itl_seconds',
    'Inter-token latency: gap between consecutive token batches '
    'surfaced to one request (the streaming stall a client feels). '
    'With chunked prefill its p99 is bounded by the tick budget, not '
    'by co-admitted prompt lengths. Acceptance-aware by '
    'construction: a speculative burst observes its full gap ONCE '
    '(never gap/burst-size) — accepted drafts widen bursts, they '
    'never shrink the reported stall.',
    buckets=metrics_lib.LATENCY_BUCKETS)
_M_CANCELS = metrics_lib.counter(
    'skytpu_engine_cancels_total',
    'Requests removed before natural completion, by reason '
    '(deadline, client_disconnect, shutdown, api, ...). The freed '
    'slot is recycled for the next admission '
    '(docs/request_lifecycle.md).',
    labels=('reason',))
_M_TICK_HANGS = metrics_lib.counter(
    'skytpu_engine_tick_hangs_total',
    'Engine ticks slower than SKYTPU_TICK_HANG_SECONDS (watchdog: a '
    'wedged device tick must be visible, not a silent stall).')
_M_TOKEN_LATENCY = metrics_lib.histogram(
    'skytpu_engine_per_token_seconds',
    'Decode latency per MODEL-STEP token: engine tick interval over '
    'tokens emitted that tick MINUS speculatively accepted draft '
    'tokens (chunk-granular; in steady state the tick interval IS '
    'the device chunk time, thanks to the double-buffered dispatch). '
    'Acceptance-aware: a 4-token accepted burst rides along free in '
    'wall-time and must not deflate the reported per-token latency '
    '4x — speculative throughput shows up in tokens_total and the '
    'spec counters instead.',
    buckets=metrics_lib.FAST_LATENCY_BUCKETS)
_M_SPEC_PROPOSED = metrics_lib.counter(
    'skytpu_engine_spec_proposed_tokens_total',
    'Draft tokens proposed to verify ticks by the prompt-lookup '
    'proposer (SKYTPU_SPEC_DECODE; accepted/proposed is the '
    'acceptance rate metrics.summary() derives).')
_M_SPEC_ACCEPTED = metrics_lib.counter(
    'skytpu_engine_spec_accepted_tokens_total',
    'Drafted tokens the batched verify pass accepted (each one is an '
    'output token that skipped a sequential decode step).')
# SLO telemetry: sliding-window p99 gauges (the cumulative histograms
# never forget), each with the trace id of the latest SLO-violating
# request as its exemplar.
_M_TTFT_P99 = metrics_lib.gauge(
    'skytpu_engine_ttft_p99_seconds',
    'Sliding-window p99 of submit-to-first-token latency '
    '(SKYTPU_SLO_WINDOW_S; exemplar = trace id of the latest request '
    'over the SKYTPU_SLO_TTFT_S threshold). The TTFT signal the SLO '
    'autoscaler scrapes.')
_M_ITL_P99 = metrics_lib.gauge(
    'skytpu_engine_itl_p99_seconds',
    'Sliding-window p99 of inter-token latency (SKYTPU_SLO_WINDOW_S; '
    'exemplar = trace id of the latest request over the '
    'SKYTPU_SLO_ITL_S threshold). The ITL signal the SLO autoscaler '
    'scrapes.')
_M_EST_WAIT = metrics_lib.gauge(
    'skytpu_engine_est_wait_seconds',
    'estimate_wait_s(0, 1) refreshed every tick: the queue-wait a '
    'minimal request arriving NOW would see, from queue depth + '
    'prefill backlog + decode width over the measured tick EWMA. '
    'The admission-pressure signal the SLO autoscaler scrapes — it '
    'rises with a traffic spike ticks before the 60 s QPS window '
    'does.')
_M_SLO_VIOLATIONS = metrics_lib.counter(
    'skytpu_engine_slo_violations_total',
    'Latency observations over their configured SLO threshold, by '
    'kind: one per request for ttft (SKYTPU_SLO_TTFT_S), one per '
    'inter-token gap for itl (SKYTPU_SLO_ITL_S) — a long stream '
    'with many slow gaps counts each stall it inflicted.',
    labels=('kind',))
# Multi-tenant QoS telemetry: class labels are a closed set; tenant
# labels are caller-controlled, so that series folds into '_other'
# past max_series.
_M_SHEDS = metrics_lib.counter(
    'skytpu_engine_sheds_total',
    'Queued requests shed by the QoS queue-pressure bound '
    '(SKYTPU_QOS_MAX_QUEUE), by priority class — bulk sheds before '
    'standard before interactive (docs/qos.md).',
    labels=('class',), max_series=8)
_M_PREEMPTS = metrics_lib.counter(
    'skytpu_engine_preempted_total',
    'Decode slots preempt-cancelled (reason=preempted_by_priority) '
    'to unblock a sustained higher-priority admission stall '
    '(SKYTPU_QOS_PREEMPT_AFTER_S), by the VICTIM\'s priority class.',
    labels=('class',), max_series=8)
_M_TENANT_TOKENS = metrics_lib.counter(
    'skytpu_engine_tenant_tokens_total',
    'Output tokens emitted, by tenant (requests that name no tenant '
    'are not counted here — skytpu_engine_tokens_total is the '
    'all-traffic series). Bounded: past max_series tenants fold '
    'into _other.',
    labels=('tenant',), max_series=64)
_M_CLASS_TTFT_P99 = metrics_lib.gauge(
    'skytpu_engine_class_ttft_p99_seconds',
    'Sliding-window p99 of submit-to-first-token latency by '
    'priority class (SKYTPU_SLO_WINDOW_S): the per-class SLO signal '
    'the autoscaler scrapes when the ServiceSpec declares per-class '
    'targets (docs/qos.md).',
    labels=('class',), max_series=8)
_M_ATTN_IMPL = metrics_lib.gauge(
    'skytpu_engine_attn_impl',
    'Info gauge (value 1, impl label): the decode-attention impl '
    'this engine actually dispatches. A downgrade from the requested '
    "'paged' fast path (page-misaligned max_seq) is warned once and "
    'surfaces here in a scrape — a perf cliff must show up in '
    'monitoring, not in a roofline postmortem (docs/metrics.md).',
    labels=('impl',), max_series=4)

# Warn-once registry for decode-attention downgrades: every engine of a
# process shares the page and env configuration, so one warning per
# reason is signal and N are noise.
_ATTN_DOWNGRADE_WARNED: set = set()


def _warn_attn_downgrade(reason: str, detail: str) -> None:
    if reason in _ATTN_DOWNGRADE_WARNED:
        return
    _ATTN_DOWNGRADE_WARNED.add(reason)
    logger.warning(
        'Decode attention downgraded to the lax reference (%s): %s. '
        'The effective impl is exported as skytpu_engine_attn_impl.',
        reason, detail)


# Consecutive no-draft (or all-rejected) rounds before the engine goes
# "dry": while dry, ticks stay pipelined (no flush) and proposals only
# probe the chain for a re-arm.
_SPEC_DRY_AFTER = 4
# Cap on the doubling re-arm cooldown (dry probe-hit rounds).
_SPEC_COOLDOWN_MAX = 256
# A tick phase's stand-in while no engine.tick span is open.
_NO_SPAN = contextlib.nullcontext()


def _prompt_lookup(chain: Sequence[int], k: int,
                   max_ngram: int) -> List[int]:
    """Model-free n-gram draft proposer (prompt-lookup decoding): find
    the most recent EARLIER occurrence of the chain's trailing n-gram
    (longest n first, n = max_ngram .. 1) and propose the up to ``k``
    tokens that followed it. Returns [] when nothing matches."""
    n_total = len(chain)
    if n_total < 2 or k <= 0:
        return []
    arr = np.asarray(chain, np.int64)
    for n in range(min(max_ngram, n_total - 1), 0, -1):
        pat = arr[n_total - n:]
        # Windows starting before n_total - n: the window there is the
        # pattern itself.
        win = np.lib.stride_tricks.sliding_window_view(
            arr, n)[:n_total - n]
        hits = np.nonzero((win == pat).all(axis=1))[0]
        if hits.size:
            s = int(hits[-1])          # most recent match wins
            cont = chain[s + n:s + n + k]
            if len(cont):              # chain may be a numpy view
                return [int(t) for t in cont]
    return []


class DuplicateRequestError(ValueError):
    """``submit()`` with a request_id already queued or in a slot."""


@dataclasses.dataclass
class Request:
    request_id: Any
    tokens: Sequence[int]          # prompt token ids
    max_new: int
    # None -> the engine's default temperature.
    temperature: Optional[float] = None
    # Absolute time.time() deadline: the tick loop expires the request
    # (queued or in a slot) once it passes, with status 'expired' and
    # its tokens so far. None = no deadline.
    deadline: Optional[float] = None
    # Multi-tenant QoS: the submitting tenant (None = anonymous, never
    # rate-limited) and the priority class ('interactive' | 'standard'
    # | 'bulk'; None = standard). Requests that set neither ride the
    # FIFO admission bit for bit.
    tenant: Optional[str] = None
    priority_class: Optional[str] = None


@dataclasses.dataclass
class _SlotState:
    request_id: Any
    max_new: int
    generated: List[int]
    prompt: List[int]
    prompt_len: int = 0
    phase: str = 'prefill'         # 'prefill' -> 'decode'
    prefill_pos: int = 0
    # Admission order: prefill scheduling is FIFO across slots.
    seq: int = 0
    # Occupancy generation: a tick only credits its tokens to a slot
    # whose epoch still matches.
    epoch: int = 0
    # Speculation: the draft for the next tick (None = no match or a
    # sampling slot), and the prompt + generated chain the proposer
    # reads, kept in a doubling int64 buffer so each tick appends only
    # the new tokens; chain_len is its filled length.
    draft: Optional[List[int]] = None
    chain_buf: Optional[np.ndarray] = None
    chain_len: int = 0
    # Prefix cache: prompt tokens served from the pool at admission (0
    # on a miss), and the admission lookup's chain hashes, kept so the
    # terminal publish never re-hashes the prompt.
    reused: int = 0
    prompt_hashes: Optional[List[bytes]] = None
    # perf_counter of the last host-side token emission (the ITL
    # anchor); the deadline, tenant and class copied from the Request.
    last_emit_at: Optional[float] = None
    deadline: Optional[float] = None
    tenant: Optional[str] = None
    priority_class: Optional[str] = None


@dataclasses.dataclass
class Result:
    request_id: Any
    tokens: List[int]
    prompt_len: int
    submitted_at: float
    finished_at: float
    # 'finished' | 'cancelled' | 'expired'; cancelled and expired
    # results keep the tokens decoded so far.
    status: str = lifecycle.FINISHED
    # Why a non-finished request ended ('deadline', 'api',
    # 'shed_by_priority', 'preempted_by_priority', ...).
    reason: Optional[str] = None


class ServingEngine:
    """Host-side slot orchestrator over ``inference.prefill_chunk``,
    ``inference.decode_step`` and ``inference.verify_step``.
    ``device=None`` means CUDA (raises with no GPU); the params must
    already live on that device."""

    def __init__(self,
                 params: Dict,
                 cfg: LlamaConfig,
                 batch_size: int = 8,
                 max_prompt: int = 512,
                 max_seq: Optional[int] = None,
                 kv_quant: bool = False,
                 weight_quant: bool = False,
                 eos_id: Optional[int] = None,
                 temperature: float = 0.0,
                 top_k: int = 0,
                 decode_chunk: int = 8,
                 page: Optional[int] = None,
                 decode_attn: Optional[str] = None,
                 paged_dispatch: bool = True,
                 prefill_chunk: Optional[int] = None,
                 prefill_budget: Optional[int] = None,
                 device=None,
                 spec_decode: Optional[bool] = None,
                 spec_k: Optional[int] = None,
                 spec_ngram: Optional[int] = None,
                 prefix_cache: Optional[bool] = None,
                 prefix_pool_pages: Optional[int] = None,
                 mesh=None) -> None:
        if isinstance(cfg, GPT2Config):
            # The cache paths (models/inference.py) take the Llama/MoE
            # tree; a GPT-2 tree would die deep in a tick on 'tok_emb'.
            raise exceptions.NotSupportedError(
                'The serving engine supports the Llama and MoE families; '
                'GPT-2 is a training family here.')
        self.device = resolve_device(device)
        emb = params['tok_emb']
        if isinstance(emb, dict):
            emb = emb['q']
        if emb.device.type != self.device.type:
            raise ValueError(f'params live on {emb.device}, the engine '
                             f'runs on {self.device}')
        # Tensor parallelism: this rank's shard and the control channel
        # (made last, when every rank has built its engine).
        self.mesh = mesh
        self._rank0 = mesh is None or mesh.rank == 0
        self._channel: Optional[channel_lib.ControlChannel] = None
        self._op: Callable[..., Any] = channel_lib.no_op
        if mesh is not None and weight_quant and \
                not quantization.is_quantized(params):
            raise ValueError(
                'weight_quant with a dense shard: a row-parallel scale is '
                'the amax over the whole contraction, so quantize the whole '
                'tree, then shard it (init_quantized_params(mesh=...) or '
                'convert.params_from_numpy(quantized_tree, mesh=...))')
        if weight_quant and not quantization.is_quantized(params):
            # int8 weight-only quantization (per-output-channel scales):
            # half the bytes a decode step reads. Not donated: the norms
            # are the caller's tensors and the caller's tree stays whole.
            # A tree that arrives quantized (init_quantized_params, a
            # converted int8 checkpoint) passes as it is. The rounding is
            # the reference engine's jax.jit(quantize_params)'s.
            params = quantization.quantize_params(params)
        self.params = params
        self.cfg = cfg
        self.batch_size = batch_size
        self.max_prompt = max_prompt
        self.max_seq = max_seq or cfg.max_seq
        if self.max_seq <= max_prompt:
            raise ValueError(
                f'max_seq ({self.max_seq}) must exceed max_prompt '
                f'({max_prompt}) to leave decode slots.')
        self.kv_quant = kv_quant
        self.eos_id = eos_id
        self.temperature = temperature
        self.top_k = top_k
        # Length-aware decode dispatch: the page count read per decode
        # chunk covers [0, base + the longest decode row's own count +
        # n), rounded per num_pages_for.
        if not paged_dispatch:
            raise ValueError('paged_dispatch=False (full-cache decode '
                             'reads) is not ported: the engine always '
                             'dispatches by live length')
        self._page = page or decode_attn_mod.default_page()
        self._total_pages = -(-self.max_seq // self._page)
        self._base_pages = -(-max_prompt // self._page)
        # The decode attention, resolved once here ('auto' and
        # SKYTPU_DECODE_ATTN through resolve_impl); the effective impl
        # is exported. K1 reads whole pages: on the card a misaligned
        # cache gets the columns up to the next page boundary (dmask
        # and the row bounds keep every read below max_seq), on the CPU
        # 'paged' downgrades to the einsum with one warning, as the
        # reference's does.
        self.attn_impl = decode_attn_mod.resolve_impl(decode_attn,
                                                      self.device)
        cache_cols = self.max_seq
        if self.attn_impl == 'paged' and self.max_seq % self._page:
            if self.device.type == 'cuda':
                cache_cols = self._total_pages * self._page
            else:
                _warn_attn_downgrade(
                    'page_misaligned',
                    f'max_seq {self.max_seq} is not a multiple of the '
                    f'decode page size {self._page}')
                self.attn_impl = 'lax'
        _M_ATTN_IMPL.set(1, impl=self.attn_impl)
        self.decode_chunk = max(1, decode_chunk)
        chunk = prefill_chunk or int(env_registry.get(
            env_registry.SKYTPU_PREFILL_CHUNK, '128'))
        budget = prefill_budget or int(env_registry.get(
            env_registry.SKYTPU_PREFILL_BUDGET, '256'))
        self.prefill_chunk = max(1, min(chunk, max_prompt))
        self._prefill_rows = max(
            1, min(budget // self.prefill_chunk, batch_size))
        self.prefill_budget = self._prefill_rows * self.prefill_chunk
        # Automatic prefix caching (SKYTPU_PREFIX_CACHE /
        # SKYTPU_PREFIX_POOL_PAGES): pages are hashed at the decode page
        # size. Off by default, and off every path below is bit-identical
        # to the engine without the cache. The pool is allocated here,
        # once, outside the graphs' memory pool; no tick reads it.
        enable_prefix = prefix_cache
        if enable_prefix is None:
            enable_prefix = env_registry.is_enabled(
                env_registry.SKYTPU_PREFIX_CACHE)
        self.prefix: Optional[prefix_mod.PrefixCache] = None
        if enable_prefix:
            pool_pages = prefix_pool_pages or int(env_registry.get(
                env_registry.SKYTPU_PREFIX_POOL_PAGES,
                str(prefix_mod.DEFAULT_POOL_PAGES)))
            self.prefix = prefix_mod.PrefixCache(
                cfg, page=self._page, pool_pages=pool_pages,
                kv_quant=kv_quant, device=self.device, mesh=mesh)
        # Speculative decoding: off unless asked for (constructor or
        # SKYTPU_SPEC_DECODE). An explicit spec_k of 0 means no draft
        # tokens, so speculation off; so does a verify segment wider
        # than a slot's decode columns.
        enable_spec = spec_decode
        if enable_spec is None:
            enable_spec = env_registry.is_enabled(
                env_registry.SKYTPU_SPEC_DECODE)
        k_req = spec_k if spec_k is not None else int(env_registry.get(
            env_registry.SKYTPU_SPEC_K, '4'))
        if enable_spec and k_req < 1:
            logger.warning('Speculative decoding disabled: spec_k=%d '
                           'requests no draft tokens.', k_req)
            enable_spec = False
        self.spec_k = max(1, k_req)
        self._spec_ngram = max(1, spec_ngram or int(env_registry.get(
            env_registry.SKYTPU_SPEC_NGRAM, '3')))
        self._spec_v = self.spec_k + 1      # fed segment width
        if enable_spec and self._spec_v > self.decode_capacity():
            logger.warning(
                'Speculative decoding disabled: the verify segment (%d '
                'columns) exceeds a slot\'s decode columns (%d); raise '
                'max_seq or lower SKYTPU_SPEC_K.', self._spec_v,
                self.decode_capacity())
            enable_spec = False
        self.spec_decode = bool(enable_spec)
        # Host-side speculation accounting (spec_stats()), outside
        # warmup.
        self.spec_proposed_total = 0
        self.spec_accepted_total = 0
        self.spec_emitted_total = 0
        self.spec_ticks = 0
        self.spec_row_steps = 0
        self.spec_draft_s = 0.0
        # Accepted drafts surfaced by the ticks processed in this
        # step() (zeroed after admission, added to by _process_tick):
        # the acceptance-aware divisor of the per-token histogram.
        self._tick_accepted = 0
        # Dry-spell latch: after _SPEC_DRY_AFTER consecutive rounds
        # with a draftable slot but no draft (or a verify tick whose
        # drafts were all rejected), step() keeps the pipelined
        # dispatch and only probes the chain for a re-arm. The re-arm
        # cooldown, in dry probe-hit rounds, doubles each time the
        # latch re-arms without an accepted draft since; an accepted
        # draft resets it.
        self._spec_dry = False
        self._spec_misses = 0
        self._spec_cooldown = 0
        self._spec_dry_rounds = 0

        self.queue: collections.deque = collections.deque()
        self.slots: List[Optional[_SlotState]] = [None] * batch_size
        self.results: Dict[Any, Result] = {}
        self._submitted_at: Dict[Any, float] = {}
        # Per-request spans while tracing is on (not in warmup):
        # {'request', 'queue', 'prefill', 'first_chunk'} by request id.
        # The request span's start is the TTFT histogram's timing
        # source, its trace id the exemplar.
        self._req_spans: Dict[Any, Dict[str, Any]] = {}
        # Each slot's own decode column count, the host mirror of the
        # cache's device ``steps``: moved at dispatch as the tick moves
        # it (active rows by their steps, held at the cache's end), set
        # to 0 at admission (the new occupant's first chunk or prefix
        # copy-in zeroes the device's). It sets a tick's page count and
        # the speculation guard; nothing is read back.
        self._cols = np.zeros((batch_size,), np.int64)
        self._col_cap = cache_cols - max_prompt
        # The decode chunk a tick runs, folded to a power of two as the
        # reference folds it.
        self._chunk_steps = 1 << (self.decode_chunk.bit_length() - 1)
        self._epoch = 0
        self._seq = 0
        # The in-flight tick (double buffering).
        self._pending: Optional[Dict[str, Any]] = None
        # Optional streaming hook: on_token(request_id, [new tokens]),
        # called on the driving thread whenever tokens reach the host.
        self.on_token: Optional[Callable[[Any, List[int]], None]] = None
        # Cancellations recorded by cancel() from any thread, applied
        # by the driver at the next tick boundary.
        self._cancels: Dict[Any, str] = {}
        self._cancel_lock = threading.Lock()
        # Makes submit()'s duplicate check and append one step.
        self._submit_lock = threading.Lock()
        # Fetched remote KV pages awaiting import: any thread appends a
        # [(hash, block)] batch, and step() lands them in the prefix
        # pool first thing at the next tick boundary, so a request
        # submitted after its pages were queued sees them at its own
        # admission. deque append/popleft are atomic.
        self._kv_imports: collections.deque = collections.deque()
        # EWMA of working-tick durations outside warmup: the time base
        # of estimate_wait_s() (None until the first measured tick).
        self._tick_ewma: Optional[float] = None
        # Tick watchdog threshold (0 disables).
        self._tick_hang_s = lifecycle.tick_hang_s()
        # Sampled (temperature > 0) rows draw from this generator (every
        # tick draws; greedy rows ignore the draw).
        self._gen = torch.Generator(device=self.device).manual_seed(0)
        # One cache for the engine's lifetime: resets restore it in
        # place, so captured programs keep pointing at it.
        self.cache = inference.make_cache(
            cfg, batch_size, cache_cols, base=max_prompt,
            kv_quant=kv_quant, device=self.device, mesh=mesh)
        # Per-slot current token, device-resident: prefill-sampled
        # first tokens flow into the decode chain without a host sync.
        self._tokens_dev = torch.zeros((batch_size,), dtype=torch.int32,
                                       device=self.device)
        self._temps = np.full((batch_size,), temperature, np.float32)
        # The tick programs' static inputs: one int32 device buffer,
        # viewed per field (temperatures as f32), filled each tick from
        # one of two host staging buffers (pinned on the card).
        g, c, b = self._prefill_rows, self.prefill_chunk, batch_size
        self._in_layout = (('active', (b,)), ('temps', (b,)),
                           ('ctoks', (g, c)), ('cstarts', (g,)),
                           ('clens', (g,)), ('clive', (g,)),
                           ('cslots', (g,)), ('clast', (g,)),
                           ('drafts', (b, self.spec_k)), ('spec_len', (b,)))
        n_in = sum(int(np.prod(shape)) for _, shape in self._in_layout)
        cuda = self.device.type == 'cuda'
        self._in_dev = torch.zeros((n_in,), dtype=torch.int32,
                                   device=self.device)
        self._in = self._views(self._in_dev)
        self._stage = [torch.zeros((n_in,), dtype=torch.int32,
                                   pin_memory=cuda) for _ in range(2)]
        # The largest packed output: a decode chunk's or a verify
        # segment's tokens (+ counts), then the first tokens.
        n_out = b * max(self.decode_chunk, self._spec_v + 1) + g
        self._out = [torch.zeros((n_out,), dtype=torch.int32,
                                 pin_memory=cuda) for _ in range(2)]
        self._stage_events = [torch.cuda.Event() if cuda else None
                              for _ in range(2)]
        self._out_events = [torch.cuda.Event() if cuda else None
                            for _ in range(2)]
        self._ring = 0
        # Captured tick programs by key (on the card, NCCL meshes
        # included; None = run the bodies eagerly, the CPU's only path
        # and a gloo mesh's). Tests and chip_smoke.py set it to None to
        # time the eager ticks.
        self._graphs: Optional[Dict[tuple, _build.Captured]] = (
            {} if cuda and (mesh is None or mesh.backend in (None, 'nccl'))
            else None)
        self._graph_pool = None
        # Graphs captured, and the seconds warmup() spent capturing
        # (the counterpart of the reference's compiled-program count).
        self.graph_captures = 0
        self.graph_capture_s = 0.0
        # Admissions, counted while tracing, that a region shared by
        # every slot, even compacted to its longest live occupant, would
        # have refused (engine.tick.admit's past_frontier).
        self.admits_past_frontier = 0
        self._warming = False
        # Tick keys dispatched so far, warmup's included: a key's first
        # dispatch is its graph's first replay, which uploads the graph.
        self._dispatched_keys: set = set()
        # The engine.tick span of the step() in progress (tracing on,
        # outside warmup), the parent of its phases.
        self._tick: Optional[trace_lib.Span] = None
        # Work accounting outside warmup: decode steps and prefill ticks
        # dispatched (each runs every layer's kernel once), and the most
        # prompt tokens one tick prefilled (never above prefill_budget).
        self.decode_steps_total = 0
        self.prefill_ticks = 0
        self.max_tick_prefill_tokens = 0
        # SLO telemetry: sliding p99 windows behind the cumulative
        # histograms, and the violation thresholds (0 = none).
        window_s = float(env_registry.get(
            env_registry.SKYTPU_SLO_WINDOW_S, '60'))
        self._slo_ttft_s = float(env_registry.get(
            env_registry.SKYTPU_SLO_TTFT_S, '0'))
        self._slo_itl_s = float(env_registry.get(
            env_registry.SKYTPU_SLO_ITL_S, '0'))
        self._ttft_window = metrics_lib.SlidingWindowPercentile(window_s)
        self._itl_window = metrics_lib.SlidingWindowPercentile(window_s)
        # Multi-tenant QoS, resolved here. Admission stays the FIFO pop
        # until a request names a tenant or a non-default class, or the
        # per-tenant buckets are configured; _qos_active latches then
        # and never clears.
        self._qos_cfg = qos_lib.qos_config_from_env()
        self._qos_weights = qos_lib.parse_weights()
        # DRR quantum: one decode chunk of tick-tokens per weight unit.
        self._drr = qos_lib.DeficitRoundRobin(
            self._qos_weights, quantum=float(self.decode_chunk))
        self._buckets: Dict[str, qos_lib.TokenBucket] = {}
        self._qos_active = (self._qos_cfg['tenant_rate'] > 0 and
                            not self._qos_cfg['disable'])
        # Monotonic time since when the best-ranked queued request has
        # been admission-blocked while a strictly lower class holds a
        # slot (the preemption timer); None = not blocked that way.
        self._qos_blocked_since: Optional[float] = None
        self._burst_seq = 0
        self._class_ttft_windows = {
            cls: metrics_lib.SlidingWindowPercentile(window_s)
            for cls in qos_lib.PRIORITY_CLASSES}
        # Next refresh_slo_gauges() time (perf_counter): the est-wait
        # scan runs at most 4 times a second.
        self._slo_refresh_at = 0.0
        # Gauges exist (as 0) from construction on.
        _M_QUEUE_DEPTH.touch()
        _M_ACTIVE_SLOTS.touch()
        _M_TTFT_P99.touch()
        _M_ITL_P99.touch()
        _M_EST_WAIT.touch()
        if self.spec_decode:
            _M_SPEC_PROPOSED.inc(0)
            _M_SPEC_ACCEPTED.inc(0)
        # Previous step() time, the per-token latency anchor.
        self._last_tick_at: Optional[float] = None
        # The replicas' debug check (SKYTPU_TP_CHECK), rank 0's choice.
        self._tp_check = mesh is not None and env_registry.is_enabled(
            env_registry.SKYTPU_TP_CHECK)
        if mesh is not None and mesh.size > 1:
            self._channel = channel_lib.ControlChannel(mesh)
            if self._rank0:
                self._op = self._channel.op
                if self.prefix is not None:
                    self.prefix.op = self._channel.op

    def _views(self, flat: torch.Tensor) -> Dict[str, Any]:
        """The input fields as views of ``flat`` (a tensor or an
        array), in ``_in_layout`` order; temperatures as f32."""
        views, off = {}, 0
        f32 = torch.float32 if isinstance(flat, torch.Tensor) else \
            np.float32
        for name, shape in self._in_layout:
            n = int(np.prod(shape))
            view = flat[off:off + n].reshape(shape)
            views[name] = view.view(f32) if name == 'temps' else view
            off += n
        return views

    # ------------------------------------------------------------------
    def warmup(self) -> None:
        """Build the CUDA kernels and capture every tick program a run
        can dispatch (on the card; every rank of a mesh), then serve two
        synthetic requests — one full-length prompt, one shorter than a
        chunk — through every host path, and reset. Speculation stays
        off while warming up."""
        with self._op('capture'):
            self._prepare_device()
        rng = np.random.default_rng(0)
        reqs = [
            Request(('warmup', 0),
                    list(rng.integers(0, self.cfg.vocab_size,
                                      self.max_prompt)), max_new=2),
            Request(('warmup', 1),
                    list(rng.integers(0, self.cfg.vocab_size,
                                      max(1, self.prefill_chunk // 2))),
                    max_new=2),
        ]
        self._warming = True
        try:
            self.run(reqs)
        finally:
            self._warming = False
        self.reset()

    def _prepare_device(self) -> None:
        """Build the kernels (on the card) and capture the tick graphs
        (where the engine has them)."""
        if self.device.type == 'cuda':
            _build.build()
        if self._graphs is not None:
            self._capture()

    def _tick_keys(self) -> List[tuple]:
        """Every tick program a run can dispatch. A decode tick always
        runs the main chunk, over the pages that cover its longest row's
        own count plus the chunk: any count in [0, the cache's decode
        columns], a row past its need included. A verify tick's rows
        start their segments at counts in [0, capacity - V]. The page
        count moves only at page boundaries, so a page-stride walk of
        the counts (and the last) meets every value."""
        def counts(hi: int, n: int) -> List[int]:
            walk = list(range(0, max(hi, 0) + 1, self._page)) + [max(hi, 0)]
            return sorted({self._num_pages(c, n) for c in walk})

        chunk = self._chunk_steps
        pages = counts(self._col_cap, chunk)
        keys = [('decode', chunk, p) for p in pages]
        keys.append(('mixed', 0, None, 0))
        keys += [('mixed', chunk, p, 0) for p in pages]
        if self.spec_decode:
            v = self._spec_v
            verify = counts(self.decode_capacity() - v, v)
            keys += [('verify', p) for p in verify]
            keys += [('mixed', 0, p, v) for p in verify]
        return keys

    def _capture(self) -> None:
        """Capture one CUDA graph per tick key not captured yet, all in
        one memory pool. One eager tick of each kind first, on a side
        stream, loads every kernel and library the programs launch; it
        dirties the cache, which is then restored in place."""
        keys = [k for k in self._tick_keys() if k not in self._graphs]
        if not keys:
            return
        t0 = time.perf_counter()
        rep = self.cfg.n_heads // self.cfg.n_kv_heads
        n_kv = inference.kv_heads(self.cfg, self.mesh)
        split_kv.reserve(self.device, self.batch_size * n_kv *
                         -(-rep * self._spec_v // split_kv.TILE))
        self._in_dev.zero_()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for kind in ('decode', 'mixed', 'verify'):
                first = next((k for k in keys if k[0] == kind), None)
                if first is not None:
                    self._tick_body(first)
        torch.cuda.current_stream(self.device).wait_stream(side)
        inference.reset_cache(self.cache)
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        for key in keys:
            self._graphs[key] = _build.capture(
                functools.partial(self._tick_body, key), self._graph_pool,
                generators=(self._gen,), error_mode=(
                    'thread_local' if self.mesh is not None and
                    self.mesh.collective else 'global'))
            self.graph_captures += 1
        torch.cuda.synchronize(self.device)
        self.graph_capture_s += time.perf_counter() - t0

    def reset(self) -> None:
        """Drop all cache state (in place: every cache tensor keeps its
        address). Only valid with nothing in flight."""
        if self.num_active() or self.queue or self._pending is not None:
            raise RuntimeError('reset() with requests in flight')
        with self._op('reset'):
            inference.reset_cache(self.cache)
        self._cols[:] = 0
        self.results = {}

    def submit(self, request: Request) -> None:
        if len(request.tokens) == 0:
            raise ValueError(
                'empty prompt: a request needs at least one token '
                '(prefill has no position to sample from).')
        if len(request.tokens) > self.max_prompt:
            raise ValueError(
                f'prompt ({len(request.tokens)}) exceeds max_prompt '
                f'({self.max_prompt}).')
        if request.max_new <= 0:
            raise ValueError(
                f'max_new ({request.max_new}) must be positive.')
        if request.max_new > self.decode_capacity():
            raise ValueError(
                f'max_new ({request.max_new}) exceeds the decode '
                f'capacity ({self.decode_capacity()}); raise max_seq.')
        if (not self._qos_active and not self._qos_cfg['disable'] and
                (request.tenant is not None or
                 (request.priority_class is not None and
                  request.priority_class != qos_lib.DEFAULT_CLASS))):
            # Sticky latch (one bool write; the driver reads it at the
            # next tick boundary): from the first request that names a
            # tenant or a non-default class, admission switches to the
            # QoS scheduler. SKYTPU_QOS_DISABLE=1 pins FIFO.
            self._qos_active = True
        with self._submit_lock:
            # _submitted_at holds exactly the in-flight ids: added
            # here, removed when the request's one Result is recorded.
            if request.request_id in self._submitted_at:
                raise DuplicateRequestError(
                    f'duplicate request_id {request.request_id!r}: a '
                    'request with this id is already in flight.')
            self._submitted_at[request.request_id] = time.time()
            if not self._warming and trace_lib.enabled():
                # Parent: the submitting thread's ambient span or the
                # inherited process context; the spans then live across
                # ticks, keyed by request id.
                req_span = trace_lib.start_span(
                    'engine.request',
                    request_id=str(request.request_id),
                    prompt_len=len(request.tokens),
                    max_new=request.max_new)
                self._req_spans[request.request_id] = {
                    'request': req_span,
                    'queue': trace_lib.start_span('engine.queue_wait',
                                                  parent=req_span),
                }
            self.queue.append(request)
        if not self._warming:
            _M_REQUESTS.inc()
            _M_QUEUE_DEPTH.set(len(self.queue))

    def decode_capacity(self) -> int:
        return self.max_seq - self.max_prompt

    def limits(self) -> Dict[str, int]:
        """The replica's static admission limits: a resumed stream
        re-submits prompt + tokens so far, which must fit max_prompt."""
        return {
            'max_prompt': self.max_prompt,
            'max_seq': self.max_seq,
            'decode_capacity': self.decode_capacity(),
            'batch_size': self.batch_size,
        }

    def mesh_info(self) -> Optional[Dict[str, Any]]:
        """Mesh shape for /health and bench detail: None for a
        single-device engine, as the reference's; else the reference's
        {'devices', 'axes', 'tp'} plus the group's ``backend`` and
        whether the ticks run as captured ``graphs`` (NCCL) or eagerly
        (gloo)."""
        if self.mesh is None:
            return None
        return dict(self.mesh.info(), graphs=self._graphs is not None)

    # ------------------------------------------------ tensor parallel
    def close(self) -> None:
        """Stop the worker ranks (rank 0; idempotent, a no-op without
        workers or on a broken channel)."""
        ch = self._channel
        if ch is None or not self._rank0 or ch.broken is not None:
            return
        with ch.op('stop'):
            pass
        ch.broken = 'stopped'

    def serve_ops(self) -> None:
        """A worker rank's loop: replay every operation rank 0 sends on
        this rank's shard, until the stop."""
        ch = self._channel
        if ch is None or self._rank0:
            raise RuntimeError('serve_ops runs on a worker rank of a mesh')
        prefix = self.prefix
        while True:
            name, args = ch.recv()
            if name == 'stop':
                return
            if name == 'tick':
                key, stage, check = args
                self._in_dev.copy_(torch.from_numpy(stage))
                self._launch(key)
                if check:
                    self._check_replicas()
            elif name == 'reset':
                inference.reset_cache(self.cache)
            elif name == 'capture':
                self._prepare_device()
            elif name == 'copy_in':
                prefix.copy_into(self.cache, *args)
            elif name == 'copy_out':
                prefix.copy_out(self.cache, *args)
            elif name == 'import':
                for dst, wire in args[0]:
                    prefix.write_page(dst, {f: prefix._to_pool(f, wire[f])
                                            for f in wire})
            elif name == 'export':
                prefix._read_page(*args)
            else:
                raise RuntimeError(f'unknown engine operation {name!r}')

    def _check_replicas(self) -> None:
        """The replicas' debug check: every rank's token vector equal
        (its min and max over 'tp' agree)."""
        t = self._tokens_dev.float()
        lo = self.mesh.all_reduce(t.clone(), 'min')
        hi = self.mesh.all_reduce(t.clone(), 'max')
        if not torch.equal(lo, hi):
            raise RuntimeError(
                'tensor-parallel ranks disagree on the token vector after '
                f'a tick (rank {self.mesh.rank}): a device operation ran '
                'outside the control channel')

    def _num_pages(self, front: int, n: int) -> int:
        """Page count for an ``n``-column tick whose longest row has
        ``front`` decode columns: covers [0, base + front + n)."""
        live = self.max_prompt + front + n
        return decode_attn_mod.num_pages_for(live, self._page,
                                             self._total_pages,
                                             base_pages=self._base_pages)

    def num_active(self) -> int:
        return sum(s is not None for s in self.slots)

    # ------------------------------------------------------------------
    def _prefill_ticks(self, tokens_left: int) -> int:
        return -(-tokens_left // self.prefill_chunk)

    def _suffix_len(self, prompt_len: int,
                    tokens: Optional[Sequence[int]] = None,
                    holder: Optional[Any] = None) -> int:
        """Prompt tokens that must actually be prefilled: with the
        prefix cache on and the token ids known, only the uncached
        suffix. Pure read; ``holder`` (the Request) caches the chain
        hashes so repeated checks never re-hash a prompt."""
        if self.prefix is None or tokens is None:
            return prompt_len
        return prompt_len - self.prefix.reusable_tokens(
            tokens, self.prefill_chunk, holder=holder)

    def _admission_charge(self, req: Request) -> int:
        """The request's admission cost in tick-tokens: max_new plus
        decode_chunk per prefill tick of the uncached suffix (a prefix
        hit charges only the suffix). The currency of the token buckets
        and DRR, and the worst case a shared decode region would have
        had to hold (``_past_frontier``)."""
        if self.prefix is None or self._warming:
            suffix = len(req.tokens)
        else:
            suffix = self._suffix_len(len(req.tokens), req.tokens,
                                      holder=req)
        return (req.max_new +
                self._prefill_ticks(suffix) * self.decode_chunk)

    def _bucket_for(self, tenant: Optional[str]
                    ) -> Optional[qos_lib.TokenBucket]:
        """The tenant's token bucket (created full on first sight);
        None when rate limiting is off or the request is anonymous."""
        if tenant is None or self._qos_cfg['tenant_rate'] <= 0:
            return None
        bkt = self._buckets.get(tenant)
        if bkt is None:
            bkt = qos_lib.TokenBucket(
                rate=self._qos_cfg['tenant_rate'],
                burst=self._qos_cfg['tenant_burst'],
                updated=time.monotonic())
            self._buckets[tenant] = bkt
        return bkt

    def _qos_select(self) -> Optional[int]:
        """Queue index of the request the QoS scheduler admits next, or
        None when every stream head is blocked by its bucket or DRR
        deficit this round. One call is one DRR round: every live
        (tenant, class) stream earns its quantum, then streams are
        visited by class rank (rotating within a rank) and the first
        head whose charge clears both its bucket and its deficit wins.
        Nothing is spent here (_admit charges on admission). Index
        scan: submit() may append concurrently."""
        heads: Dict[tuple, tuple] = {}
        for i in range(len(self.queue)):
            try:
                r = self.queue[i]
            except IndexError:
                break
            key = (r.tenant, r.priority_class or qos_lib.DEFAULT_CLASS)
            if key not in heads:
                heads[key] = (i, r)
        if not heads:
            return None
        self._drr.earn(list(heads.keys()))
        now = time.monotonic()
        for key in self._drr.order():
            if key not in heads:
                continue
            idx, r = heads[key]
            charge = self._admission_charge(r)
            bkt = self._bucket_for(key[0])
            if bkt is not None and not bkt.peek(charge, now):
                continue
            if not self._drr.can_spend(key, charge):
                continue
            return idx
        return None

    def _qos_shed_queue(self) -> None:
        """Queue-pressure shedding (SKYTPU_QOS_MAX_QUEUE): while the
        queue exceeds the bound, cancel the newest request of the
        lowest class (reason 'shed_by_priority')."""
        bound = self._qos_cfg['max_queue']
        while bound > 0 and len(self.queue) > bound:
            victim = None      # (rank, queue index, request)
            for i in range(len(self.queue)):
                try:
                    r = self.queue[i]
                except IndexError:
                    break
                cand = (qos_lib.class_rank(r.priority_class), i, r)
                if victim is None or cand > victim:
                    victim = cand
            if victim is None:
                return
            _, _, req = victim
            cls = req.priority_class or qos_lib.DEFAULT_CLASS
            self._cancel_now(req.request_id, 'shed_by_priority',
                             lifecycle.CANCELLED)
            if not self._warming:
                _M_SHEDS.inc(1, **{'class': cls})

    def _qos_maybe_preempt(self) -> None:
        """Sustained-overload preemption (SKYTPU_QOS_PREEMPT_AFTER_S):
        when the best-ranked queued request has been admission-blocked
        that long while a strictly lower class holds a slot, cancel the
        youngest lowest-class slot (reason 'preempted_by_priority').
        At most one victim per tick."""
        threshold = self._qos_cfg['preempt_after_s']
        if threshold <= 0:
            return
        rank = None            # the best-ranked queued request's
        for i in range(len(self.queue)):
            try:
                r = self.queue[i]
            except IndexError:
                break
            r_rank = qos_lib.class_rank(r.priority_class)
            if rank is None or r_rank < rank:
                rank = r_rank
        if rank is None:
            self._qos_blocked_since = None
            return
        victim = None          # (victim rank, seq, slot state)
        for s in self.slots:
            if s is None:
                continue
            vrank = qos_lib.class_rank(s.priority_class)
            if vrank <= rank:
                continue
            cand = (vrank, s.seq, s)
            if victim is None or cand[:2] > victim[:2]:
                victim = cand
        blocked = (victim is not None and
                   all(s is not None for s in self.slots))
        if not blocked:
            self._qos_blocked_since = None
            return
        now = time.monotonic()
        if self._qos_blocked_since is None:
            self._qos_blocked_since = now
            return
        if now - self._qos_blocked_since < threshold:
            return
        state = victim[2]
        cls = state.priority_class or qos_lib.DEFAULT_CLASS
        self._cancel_now(state.request_id, 'preempted_by_priority',
                         lifecycle.CANCELLED)
        if not self._warming:
            _M_PREEMPTS.inc(1, **{'class': cls})
        self._qos_blocked_since = None

    def _inject_tenant_burst(self, params: Dict[str, Any]) -> None:
        """Act out a fired engine.tenant.burst fault: submit the
        params-described synthetic requests (seeded, counter-unique
        ids) from the named tenant into this engine's queue."""
        tenant = str(params.get('tenant', 'chaos-tenant'))
        cls = str(params.get('priority_class', 'bulk'))
        n = int(params.get('n', 8))
        prompt_len = min(int(params.get('prompt_len', 32)),
                         self.max_prompt)
        max_new = min(int(params.get('max_new', 16)),
                      self.decode_capacity())
        rng = np.random.default_rng(int(params.get('seed', 0)))
        for _ in range(max(0, n)):
            self._burst_seq += 1
            toks = rng.integers(
                1, max(2, self.cfg.vocab_size - 1),
                size=max(1, prompt_len)).tolist()
            # In a fresh context: the request's span tree is its own,
            # never a child of the tick that injected it.
            contextvars.Context().run(self.submit, Request(
                request_id=f'burst-{tenant}-{self._burst_seq}',
                tokens=toks, max_new=max(1, max_new),
                tenant=tenant, priority_class=cls))

    def _past_frontier(self, req: Request) -> bool:
        """Would a decode region shared by every slot, compacted to its
        longest live occupant, have refused ``req``? Its worst case
        (``_admission_charge``) past the columns such a region has left
        beside the occupant with the most decode columns."""
        cols = [self._cols[i] for i, s in enumerate(self.slots)
                if s is not None]
        return bool(cols) and (self._admission_charge(req) >
                               self.decode_capacity() - max(cols))

    def _admit(self, phase: Optional[trace_lib.Span] = None) -> None:
        """Move queued requests into free slots; prefilling slots are
        capped at the budget's row count so every one of them is
        scheduled every tick. Each slot owns its decode columns, so a
        free slot is all a request needs. Strict FIFO until QoS
        latches, then the DRR pick of _qos_select; either way only
        which request is popped changes, never a tick program.
        ``phase`` (the tick's engine.tick.admit span, when traced) gets
        what admission did, why it stopped, and how many admissions
        went ``past_frontier``."""
        free = [i for i, s in enumerate(self.slots) if s is None]
        n_prefilling = sum(1 for s in self.slots
                           if s is not None and s.phase == 'prefill')
        admitted = past = 0
        stop = None
        qos_on = self._qos_active
        while self.queue and free and n_prefilling < self._prefill_rows:
            if qos_on:
                idx = self._qos_select()
                if idx is None:
                    stop = 'qos'
                    break   # every stream head is budget-blocked
            else:
                idx = 0
            req = self.queue[idx]
            if phase is not None and self._past_frontier(req):
                past += 1
            if qos_on:
                # Spend only on admission: the charge clears the
                # stream's deficit and (with rate limiting on and a
                # named tenant) its bucket.
                charge = self._admission_charge(req)
                self._drr.spend(
                    (req.tenant,
                     req.priority_class or qos_lib.DEFAULT_CLASS), charge)
                bkt = self._bucket_for(req.tenant)
                if bkt is not None:
                    bkt.spend(charge, time.monotonic())
            # Slot assignment before the pop: the request is never in
            # neither container.
            slot_idx = free.pop(0)
            self._cols[slot_idx] = 0
            self._epoch += 1
            self._seq += 1
            self.slots[slot_idx] = _SlotState(
                request_id=req.request_id, max_new=req.max_new,
                generated=[], prompt=list(req.tokens),
                prompt_len=len(req.tokens), seq=self._seq,
                epoch=self._epoch, deadline=req.deadline,
                tenant=req.tenant, priority_class=req.priority_class)
            if idx:
                del self.queue[idx]
            else:
                self.queue.popleft()
            self._temps[slot_idx] = (
                req.temperature if req.temperature is not None
                else self.temperature)
            n_prefilling += 1
            admitted += 1
            # Queue wait ends where the prefill phase begins.
            ts = self._req_spans.get(req.request_id)
            if ts is not None:
                qs = ts.pop('queue', None)
                if qs is not None:
                    qs.finish()
                ts['prefill'] = trace_lib.start_span(
                    'engine.prefill', parent=ts['request'],
                    slot=slot_idx, prompt_len=len(req.tokens))
            if self.prefix is not None and not self._warming:
                # Longest cached prefix: pin it, copy its pages into the
                # slot's prompt region (enqueued after the tick in
                # flight, before the next), and start the chunk cursor
                # at the cached boundary.
                sp = trace_lib.start_span(
                    'engine.prefix_lookup',
                    parent=None if ts is None else ts.get('prefill'))
                reuse, pages, hashes = self.prefix.acquire(
                    req.request_id, req.tokens, self.prefill_chunk,
                    holder=req)
                st = self.slots[slot_idx]
                st.prompt_hashes = hashes
                if reuse:
                    self.prefix.copy_into(self.cache, slot_idx, pages,
                                          reuse)
                    st.prefill_pos = st.reused = reuse
                sp.finish(matched_pages=len(pages), reuse_tokens=reuse,
                          hit=bool(reuse))
        if phase is not None:
            if stop is None:
                stop = ('queue_empty' if not self.queue else
                        'no_slot' if not free else 'prefill_rows')
            self.admits_past_frontier += past
            phase.set_attr(admitted=admitted, admit_stop=stop,
                           past_frontier=past, queued=len(self.queue),
                           free_slots=len(free))

    def _retire_prefix(self, state: _SlotState, slot_idx: int) -> None:
        """Terminal-slot prefix bookkeeping: publish the slot's
        finalized prompt pages (only those its prefill cursor passed: a
        cancel mid-prefill publishes the finished prefix) and release
        its pins. The publish copies are enqueued after every tick that
        wrote the slot's prompt region. No-op without the cache."""
        if self.prefix is None:
            return
        if not self._warming:
            self.prefix.publish(state.prompt, state.prefill_pos,
                                self.cache, slot_idx,
                                hashes=state.prompt_hashes)
        self.prefix.release(state.request_id)

    def _finish(self, slot_idx: int) -> None:
        state = self.slots[slot_idx]
        self._retire_prefix(state, slot_idx)
        self._terminal(state.request_id, state.generated,
                       state.prompt_len, lifecycle.FINISHED, None)
        self.slots[slot_idx] = None

    def _terminal(self, rid: Any, tokens: List[int], prompt_len: int,
                  status: str, reason: Optional[str]) -> None:
        """Record the request's one terminal Result and close its span
        tree."""
        self.results[rid] = Result(
            request_id=rid, tokens=list(tokens), prompt_len=prompt_len,
            submitted_at=self._submitted_at.pop(rid, 0.0),
            finished_at=time.time(), status=status, reason=reason)
        ts = self._req_spans.pop(rid, None)
        if ts is None:
            return
        if status != lifecycle.FINISHED:
            # The cut is its own span under the request span, so it
            # carries the request's trace id.
            trace_lib.start_span(
                'engine.cancel', parent=ts['request'],
                request_id=str(rid), status=status,
                reason=reason or '').finish()
        # A request can end without surfacing a first token (cancelled
        # mid-prefill): close the stragglers before the root.
        for name in ('queue', 'prefill', 'first_chunk'):
            sp = ts.pop(name, None)
            if sp is not None:
                sp.finish()
        if status == lifecycle.FINISHED:
            ts['request'].finish(tokens=len(tokens))
        else:
            ts['request'].finish(tokens=len(tokens), status=status)

    # ------------------------------------------------- cancellation
    def cancel(self, request_id: Any, reason: str = 'api') -> bool:
        """Request cancellation of a queued or in-flight request
        (thread-safe; applied at the next tick boundary, where the
        freed slot is recycled and a 'cancelled' Result with the tokens
        so far is recorded). Returns True when the request was in
        flight at the time of the call."""
        if request_id not in self._submitted_at:
            return False
        with self._cancel_lock:
            self._cancels[request_id] = reason
        return True

    def queue_kv_import(self, items) -> bool:
        """Queue fetched remote KV pages (``[(chain_hash, {field:
        array})]``, the kv_transfer decode shape) for import into the
        prefix pool. Any-thread safe; returns False when no prefix
        cache is configured. step() lands queued batches at the
        next tick boundary, before admission."""
        if self.prefix is None or not items:
            return self.prefix is not None
        self._kv_imports.append(list(items))
        return True

    def _apply_kv_imports(self) -> None:
        """Tick-boundary work: land every queued import batch
        into the prefix pool (import_pages' dedup/alloc/eviction, the
        same as publish)."""
        while self._kv_imports:
            try:
                batch = self._kv_imports.popleft()
            except IndexError:
                break
            self.prefix.import_pages(batch)

    def _apply_cancellations(self) -> None:
        if not self._cancels:
            return
        with self._cancel_lock:
            cancels, self._cancels = self._cancels, {}
        for rid, reason in cancels.items():
            self._cancel_now(rid, reason, lifecycle.CANCELLED)

    def _cancel_now(self, rid: Any, reason: str, status: str) -> bool:
        """Driver-thread removal of a request wherever it lives, with
        ``status`` (cancelled or expired). A request already terminal
        is left alone: exactly one Result per request. Index scan over
        the queue: submit() may append from another thread."""
        for i in range(len(self.queue)):
            req = self.queue[i]
            if req.request_id == rid:
                del self.queue[i]
                self._terminal(rid, [], len(req.tokens), status, reason)
                if not self._warming:
                    _M_CANCELS.inc(1, reason=reason)
                return True
        for slot_idx, state in enumerate(self.slots):
            if state is not None and state.request_id == rid:
                # The in-flight tick's tokens for this slot are dropped
                # by the epoch check, and the freed row leaves the next
                # tick's active mask; the next occupant's first prefill
                # chunk (or its prefix copy-in) clears the row's dmask.
                self._retire_prefix(state, slot_idx)
                self._terminal(rid, state.generated, state.prompt_len,
                               status, reason)
                self.slots[slot_idx] = None
                if not self._warming:
                    _M_CANCELS.inc(1, reason=reason)
                return True
        return False

    def cancel_all(self, reason: str = 'shutdown') -> List[Any]:
        """Driver-thread bulk cancel: every queued and in-slot request
        gets its cancelled Result now. Returns the cancelled ids."""
        self._apply_cancellations()
        rids = [r.request_id for r in self.queue]
        rids += [s.request_id for s in self.slots if s is not None]
        for rid in rids:
            self._cancel_now(rid, reason, lifecycle.CANCELLED)
        return rids

    def _expire_deadlines(self) -> None:
        now = time.time()
        expired = []
        for i in range(len(self.queue)):   # index scan: see _cancel_now
            r = self.queue[i]
            if r.deadline is not None and now >= r.deadline:
                expired.append(r.request_id)
        expired += [s.request_id for s in self.slots
                    if s is not None and s.deadline is not None and
                    now >= s.deadline]
        for rid in expired:
            self._cancel_now(rid, 'deadline', lifecycle.EXPIRED)

    def estimate_wait_s(self, prompt_len: int, max_new: int,
                        tokens: Optional[Sequence[int]] = None,
                        priority_class: Optional[str] = None) -> float:
        """Estimated submit-to-finish seconds for a request arriving
        now: its own prefill and decode ticks plus the remaining ticks
        of everything in a slot or queued, divided by the decode width,
        times the measured tick EWMA (0 before the first measured
        tick). With the prefix cache on and ``tokens`` given, prefill is
        charged over the uncached suffix. With ``priority_class`` and
        QoS live, queued work of a strictly lower class is left out (the
        DRR jumps it); slot work is always charged. Safe off the driver
        thread: the slots are snapshotted, the queue index-scanned."""
        tick = self._tick_ewma
        if tick is None:
            return 0.0
        skip_below = None
        if priority_class is not None and self._qos_active:
            skip_below = qos_lib.class_rank(priority_class)
        own = (self._prefill_ticks(self._suffix_len(prompt_len, tokens))
               + -(-max_new // self.decode_chunk))
        backlog = 0
        slot_ids = set()
        for s in list(self.slots):
            if s is None:
                continue
            slot_ids.add(s.request_id)
            backlog += -(-max(0, s.max_new - len(s.generated)) //
                         self.decode_chunk)
            if s.phase == 'prefill':
                backlog += self._prefill_ticks(
                    max(0, s.prompt_len - s.prefill_pos))
        for i in range(len(self.queue)):
            try:
                r = self.queue[i]
            except IndexError:
                break
            if r.request_id in slot_ids:
                # Being admitted right now (the slot is assigned before
                # the pop): count it once.
                continue
            if (skip_below is not None and
                    qos_lib.class_rank(r.priority_class) > skip_below):
                continue    # work this class would jump via DRR
            backlog += (self._prefill_ticks(
                self._suffix_len(len(r.tokens), r.tokens, holder=r)) +
                        -(-r.max_new // self.decode_chunk))
        wait_ticks = own + backlog / max(1, self.batch_size)
        return wait_ticks * tick

    def _is_done(self, state: _SlotState) -> bool:
        return (len(state.generated) >= state.max_new or
                (self.eos_id is not None and bool(state.generated) and
                 state.generated[-1] == self.eos_id))

    # ------------------------------------------------------ speculation
    def _spec_candidates(self) -> bool:
        """Could any slot draft this tick? A greedy decode slot with
        more than one token still to produce (generated counts may lag
        an in-flight tick, which only over-estimates)."""
        return any(
            s is not None and s.phase == 'decode' and
            self._temps[i] <= 0.0 and s.max_new - len(s.generated) > 1
            for i, s in enumerate(self.slots))

    def _lookup(self, chain: Sequence[int], k: int) -> List[int]:
        """Draft proposer hook: up to ``k`` candidate continuations of
        ``chain`` (prompt + generated as an int array, ending at the
        current token). Prompt-lookup by default; tests replace it to
        drive acceptance patterns. Correctness never depends on the
        drafts (a rejection falls back to the model's own token)."""
        return _prompt_lookup(chain, k, self._spec_ngram)

    @staticmethod
    def _slot_chain(st: _SlotState) -> np.ndarray:
        """The slot's prompt + generated chain as an int64 view over a
        buffer that each tick only appends the new tokens to."""
        n = st.prompt_len + len(st.generated)
        if st.chain_buf is None or st.chain_buf.shape[0] < n:
            cap = max(64, st.chain_buf.shape[0] if st.chain_buf
                      is not None else 0)
            while cap < n:
                cap *= 2
            buf = np.empty((cap,), np.int64)
            buf[:st.prompt_len] = st.prompt
            buf[st.prompt_len:n] = st.generated
            st.chain_buf = buf
        elif st.chain_len < n:
            st.chain_buf[st.chain_len:n] = \
                st.generated[st.chain_len - st.prompt_len:]
        st.chain_len = n
        return st.chain_buf[:n]

    def _propose_drafts(self) -> tuple:
        """Refresh every greedy decode slot's draft from its chain
        (fresh when no tick is in flight; a stale chain is only probed,
        for the dry-spell re-arm). A draft is clipped to the slot's
        remaining need minus one. Returns (eligible, found): how many
        slots could draft, and whether any did."""
        t0 = time.perf_counter()
        eligible = 0
        found = False
        for i, st in enumerate(self.slots):
            if st is None or st.phase != 'decode':
                continue
            st.draft = None
            if self._temps[i] > 0.0:
                continue            # sampling slots bypass speculation
            budget = min(self.spec_k, st.max_new - len(st.generated) - 1)
            if budget < 1:
                continue
            eligible += 1
            drafts = self._lookup(self._slot_chain(st), budget)
            st.draft = drafts or None
            found = found or bool(drafts)
        self.spec_draft_s += time.perf_counter() - t0
        return eligible, found

    def _spec_may_run(self) -> bool:
        """May a verify segment run without stranding a row? Each decode
        row writes V columns from its own frontier while its worst case
        (all rejected) advances it by one token, so the columns it has
        left after the segment must still cover the tokens it may still
        need (counts that lag the in-flight tick only over-estimate
        them). Prefilling rows write no kept column in it."""
        after = self.decode_capacity() - self._spec_v
        for i, s in enumerate(self.slots):
            if s is None or s.phase != 'decode':
                continue
            if s.max_new - len(s.generated) - 1 > after - self._cols[i]:
                return False
        return True

    def spec_stats(self) -> Dict[str, Any]:
        """Speculation accounting (outside warmup)."""
        prop, acc = self.spec_proposed_total, self.spec_accepted_total
        return {
            'enabled': self.spec_decode,
            'k': self.spec_k if self.spec_decode else 0,
            'proposed': prop,
            'accepted': acc,
            'acceptance_rate': round(acc / prop, 4) if prop else None,
            'spec_ticks': self.spec_ticks,
            'tokens_per_step': (
                round(self.spec_emitted_total / self.spec_row_steps, 3)
                if self.spec_row_steps else None),
            'draft_time_s': round(self.spec_draft_s, 4),
        }

    def _spec_round(self) -> None:
        """Propose this tick's drafts and move the dry-spell latch."""
        eligible, found = self._propose_drafts()
        if not eligible:
            return
        if found:
            if self._spec_dry and self._pending is not None:
                # Dry: this round only probed the stale chain (no flush
                # ran). A hit re-arms speculation once the cooldown is
                # waited out; the stale drafts themselves are unusable.
                for s in self.slots:
                    if s is not None:
                        s.draft = None
                self._spec_dry_rounds += 1
                if self._spec_dry_rounds >= self._spec_cooldown:
                    self._spec_misses = 0
                    self._spec_dry_rounds = 0
                    self._spec_cooldown = min(
                        _SPEC_COOLDOWN_MAX, max(1, self._spec_cooldown * 2))
            # An armed round with drafts does not reset the streak: the
            # reset belongs to acceptance (_process_tick).
        else:
            self._spec_misses += 1
        self._spec_dry = self._spec_misses >= _SPEC_DRY_AFTER

    # ------------------------------------------------------------ ticks
    def _observe_per_token(self, interval: float, emitted: int) -> None:
        """skytpu_engine_per_token_seconds, acceptance-aware: the
        divisor is the model-step tokens, emitted minus the accepted
        drafts that rode along in the same wall time."""
        _M_TOKEN_LATENCY.observe(
            interval / max(1, emitted - self._tick_accepted))

    def step(self) -> int:
        """One pipelined engine tick: the lifecycle work at the tick
        boundary (fault polls, KV imports, cancellations, deadline
        expiry, QoS shedding and preemption), admission, then launch
        tick N+1 (up to ``prefill_budget`` prompt tokens fused with the
        decode chunk of the active slots, or with a verify segment when
        slots hold drafts), then sync and process tick N. Results
        therefore surface one tick after their final decode chunk.
        Speculation needs the fresh chain to draft from, so while it is
        armed the in-flight tick is processed first. After the tick:
        the per-token histogram, the tick EWMA, the watchdog and the
        gauges, none of them in warmup. Returns the tokens emitted.

        With tracing on, a step outside warmup that finds work (a tick
        in flight, a queued request or an occupied slot) is one
        ``engine.tick`` span, the root of a trace of its own, with its
        phases as children: ``engine.tick.admit`` (the boundary work
        and admission), ``engine.tick.dispatch``, ``engine.tick.sync``
        and ``engine.tick.process`` (docs/tracing.md)."""
        if (self._warming or not trace_lib.enabled() or
                not (self._pending is not None or self.queue or
                     self.num_active())):
            return self._step()
        with trace_lib.span('engine.tick', root=True) as tick:
            self._tick = tick
            try:
                return self._step()
            finally:
                self._tick = None

    def _phase(self, name: str):
        """A phase of the open engine.tick span (a context manager that
        yields the phase's span), or a no-op without one."""
        return _NO_SPAN if self._tick is None else trace_lib.span(name)

    def _step(self) -> int:
        t0 = time.perf_counter()
        with self._phase('engine.tick.admit') as phase:
            hang = burst = None
            if not self._warming:
                # Warmup ticks never poll: they would burn a plan's
                # counts.
                hang = fault_injection.poll(
                    'engine.tick.hang',
                    kinds=(fault_injection.FaultKind.HANG,))
                burst = fault_injection.poll(
                    'engine.tenant.burst',
                    kinds=(fault_injection.FaultKind.TENANT_BURST,))
            if hang is not None:
                # A wedged tick, acted out: the watchdog sees it as real.
                time.sleep(float(hang.params.get('seconds', 0.05)))
            if burst is not None:
                self._inject_tenant_burst(burst.params)
            if self._kv_imports:
                # Remote pages first: a request whose pages were queued
                # before its submit sees them in this tick's admission.
                self._apply_kv_imports()
            self._apply_cancellations()
            self._expire_deadlines()
            if self._qos_active:
                # Both act through _cancel_now, so a freed slot is
                # admissible in this tick's _admit.
                self._qos_shed_queue()
                self._qos_maybe_preempt()
            self._admit(phase)
        self._tick_accepted = 0
        emitted = 0
        # The capacity guard, checked before the flush with counts that
        # may lag the in-flight tick (which only makes it stricter): a
        # guard that cannot pass skips the flush and the proposer.
        spec_may = (self.spec_decode and not self._warming and
                    self._spec_may_run())
        if (spec_may and self._pending is not None and
                self._spec_candidates() and not self._spec_dry):
            prev, self._pending = self._pending, None
            emitted += self._process_tick(prev)
            # The flush may have freed slots: a second admission.
            with self._phase('engine.tick.admit') as phase:
                self._admit(phase)
        with self._phase('engine.tick.dispatch') as phase:
            if spec_may:
                self._spec_round()
            new_entry = self._dispatch_tick()
            if phase is not None:
                phase.set_attr(
                    key=None if new_entry is None else new_entry['key'],
                    first_replay=(new_entry is not None and
                                  new_entry['first']))
        prev, self._pending = self._pending, new_entry
        emitted += self._process_tick(prev)
        # Per-token latency at tick granularity: the interval between
        # consecutive step() returns over this step's model-step
        # tokens (in steady state the interval is the device tick).
        tick_at = time.perf_counter()
        if (emitted and not self._warming and
                self._last_tick_at is not None):
            self._observe_per_token(tick_at - self._last_tick_at, emitted)
        self._last_tick_at = tick_at
        dur = tick_at - t0
        if (new_entry is not None or prev is not None) and \
                not self._warming:
            # Working ticks only (idle step()s would drag the estimate
            # to 0); warmup's ticks carry capture and first-launch time.
            self._tick_ewma = (dur if self._tick_ewma is None else
                               0.8 * self._tick_ewma + 0.2 * dur)
        if (self._tick_hang_s > 0 and dur > self._tick_hang_s and
                not self._warming):
            _M_TICK_HANGS.inc()
            # Snapshot first: submit() inserts into _req_spans from
            # other threads.
            traces = sorted({
                ts['request'].trace_id
                for ts in list(self._req_spans.values())
                if 'request' in ts})
            logger.warning(
                'Engine tick took %.3fs (SKYTPU_TICK_HANG_SECONDS='
                '%.1f): device hang or severe contention; active=%d '
                'queued=%d traces=%s', dur, self._tick_hang_s,
                self.num_active(), len(self.queue), traces[:4] or None)
        _M_QUEUE_DEPTH.set(len(self.queue))
        _M_ACTIVE_SLOTS.set(self.num_active())
        if not self._warming:
            self.refresh_slo_gauges()
        return emitted

    def refresh_slo_gauges(self, force: bool = False) -> None:
        """Re-derive the scraped SLO gauges from live state, at most 4
        times a second (``force`` skips the throttle): the sliding
        p99s, which decay to 0 in a quiet window, per class too, and
        the est-wait gauge."""
        now_pc = time.perf_counter()
        if not force and now_pc < self._slo_refresh_at:
            return
        self._slo_refresh_at = now_pc + 0.25
        p99 = self._ttft_window.quantile(0.99)
        _M_TTFT_P99.set(p99 if p99 is not None else 0.0)
        p99 = self._itl_window.quantile(0.99)
        _M_ITL_P99.set(p99 if p99 is not None else 0.0)
        for cls, win in self._class_ttft_windows.items():
            p99 = win.quantile(0.99)
            _M_CLASS_TTFT_P99.set(p99 if p99 is not None else 0.0,
                                  **{'class': cls})
        _M_EST_WAIT.set(self.estimate_wait_s(0, 1))

    def flush(self) -> int:
        """Sync and process the in-flight tick without launching a new
        one."""
        prev, self._pending = self._pending, None
        return self._process_tick(prev)

    @property
    def has_pending(self) -> bool:
        return self._pending is not None

    def _decode_scan(self, tok: torch.Tensor, active: torch.Tensor,
                     temps: torch.Tensor, n: int, num_pages: int):
        """``n`` decode steps feeding each sampled token forward;
        inactive rows freeze their token (a slot whose prefill finished
        this tick holds its first token until it joins the active mask
        next tick). Returns (tokens [n, B], last tokens [B])."""
        outs = []
        for _ in range(n):
            logits, _ = inference.decode_step(
                self.params, self.cache, tok, self.cfg, active=active,
                attn_impl=self.attn_impl, num_pages=num_pages,
                page=self._page, mesh=self.mesh)
            nxt = inference._sample(logits, temps, self.top_k, self._gen)
            tok = torch.where(active, nxt, tok)
            outs.append(tok)
        return torch.stack(outs), tok

    def _tick_body(self, key: tuple) -> torch.Tensor:
        """The tick program of ``key`` over the static buffers: it
        updates the cache and the token vector in place and returns its
        outputs packed in one int32 tensor — the tokens (a decode chunk's
        [n, B] or a verify segment's [B, V]), then the verify counts [B],
        then the chunk rows' first tokens [G] (mixed ticks). It reads no
        device value on the host, so it runs eagerly or under capture
        alike."""
        kind = key[0]
        if kind == 'decode':
            n, num_pages, spec = key[1], key[2], 0
        elif kind == 'mixed':
            n, num_pages, spec = key[1:]
        else:
            n, num_pages, spec = 0, key[1], self._spec_v
        inp = self._in
        active = inp['active'] != 0
        temps = inp['temps']
        cur = self._tokens_dev
        outs, firsts = [], None
        if kind == 'mixed':
            live = inp['clive'] != 0
            cslots = inp['cslots']
            logits, _ = inference.prefill_chunk(
                self.params, self.cache, inp['ctoks'], inp['cstarts'],
                inp['clens'], live, cslots, self.cfg,
                prompt_base=self.max_prompt, mesh=self.mesh)
            firsts = inference._sample(
                logits, temps.index_select(0, cslots.long()), self.top_k,
                self._gen)
            # The reference's static unroll over the chunk rows: a row
            # whose chunk completes its prompt folds its first token
            # into the token vector (the slot decodes from next tick).
            take = live & (inp['clast'] != 0)
            slot_ids = torch.arange(self.batch_size, device=self.device)
            for j in range(self._prefill_rows):
                cur = torch.where(take[j] & (slot_ids == cslots[j]),
                                  firsts[j], cur)
        if spec:
            # Slots whose prefill finished above are inactive here: they
            # hold their first token until they join next tick.
            emit, counts, cur, _ = inference.verify_step(
                self.params, self.cache, cur, inp['drafts'],
                inp['spec_len'], self.cfg, temps, self.top_k, self._gen,
                active=active, num_pages=num_pages, page=self._page,
                mesh=self.mesh)
            outs += [emit.reshape(-1), counts]
        elif n:
            toks, cur = self._decode_scan(cur, active, temps, n, num_pages)
            outs.append(toks.reshape(-1))
        self._tokens_dev.copy_(cur)
        if firsts is not None:
            outs.append(firsts)
        return torch.cat(outs)

    def _launch(self, key: tuple) -> torch.Tensor:
        """Run tick program ``key``: replay its graph, or run its body
        eagerly where there are no graphs. Returns its packed output."""
        if self._graphs is None:
            return self._tick_body(key)
        graph = self._graphs.get(key)
        if graph is None:
            raise RuntimeError(
                f'tick program {key} was not captured: warmup() captures '
                f'the {len(self._tick_keys())} keys a run can dispatch '
                f'({len(self._graphs)} captured)')
        return graph.replay()

    def _dispatch_tick(self) -> Optional[Dict[str, Any]]:
        active_list = [s is not None and s.phase == 'decode'
                       for s in self.slots]
        prefilling = sorted(
            ((i, s) for i, s in enumerate(self.slots)
             if s is not None and s.phase == 'prefill'),
            key=lambda t: t[1].seq)
        any_active = any(active_list)
        if not prefilling and not any_active:
            return None
        # Speculation: when a decode slot holds a draft and the
        # capacity guard passes, one verify segment replaces the decode
        # chunk: every active slot feeds its current token (+ drafts,
        # where it has them) and advances by its accepted prefix + 1.
        spec_rows = []
        if self.spec_decode and any_active:
            spec_rows = [(i, s) for i, s in enumerate(self.slots)
                         if s is not None and s.phase == 'decode' and
                         s.draft]
        run_spec = bool(spec_rows) and self._spec_may_run()
        # Every decode tick runs the whole chunk: a row past its need
        # writes columns no kept token reads (held at the cache's end).
        n = self._chunk_steps if any_active and not run_spec else 0
        spec = self._spec_v if run_spec else 0
        num_pages = None
        if spec or n:
            front = max(self._cols[i] for i, a in enumerate(active_list)
                        if a)
            num_pages = self._num_pages(front, spec or n)
        if not prefilling:
            key = (('verify', num_pages) if spec else
                   ('decode', n, num_pages))
        else:
            key = ('mixed', n, num_pages, spec)

        # Stage this tick's inputs in the staging buffer the tick before
        # the previous one used (its copy has run: that tick was read).
        ring = self._ring
        self._ring ^= 1
        cuda = self.device.type == 'cuda'
        if cuda:
            self._stage_events[ring].synchronize()
        stage = self._stage[ring]
        stage.numpy()[:] = 0
        host = self._views(stage.numpy())
        host['active'][:] = active_list
        host['temps'][:] = self._temps
        if spec:
            for i, st in spec_rows:
                d = st.draft[:self.spec_k]
                host['drafts'][i, :len(d)] = d
                host['spec_len'][i] = len(d)
                st.draft = None            # consumed by this tick
            if not self._warming:
                proposed = int(host['spec_len'].sum())
                _M_SPEC_PROPOSED.inc(proposed)
                self.spec_proposed_total += proposed
                self.spec_ticks += 1
                self.spec_row_steps += sum(active_list)
                # Host-side dispatch window, one span per verify tick.
                trace_lib.start_span(
                    'engine.spec_verify', rows=len(spec_rows),
                    proposed=proposed, k=self.spec_k).finish()
        chunk_meta: List[Dict[str, Any]] = []
        budget_used = 0
        if prefilling:
            host['clens'][:] = 1               # dead rows: len 1 slack
            for j, (slot_idx, st) in enumerate(
                    prefilling[:self._prefill_rows]):
                ln = min(self.prefill_chunk, st.prompt_len - st.prefill_pos)
                last = st.prefill_pos + ln == st.prompt_len
                host['ctoks'][j, :ln] = st.prompt[st.prefill_pos:
                                                  st.prefill_pos + ln]
                host['cstarts'][j] = st.prefill_pos
                host['clens'][j] = ln
                host['clive'][j] = 1
                host['clast'][j] = last
                host['cslots'][j] = slot_idx
                budget_used += ln
                chunk_meta.append({'row': j, 'slot': slot_idx,
                                   'epoch': st.epoch, 'n': ln,
                                   'last': last, 'start': st.prefill_pos})
        first = key not in self._dispatched_keys
        self._dispatched_keys.add(key)
        # The tick's device time (traced ticks only): a pair of timing
        # events around the input copy and the replay, read once the
        # tick is processed; on the CPU the body runs here, so the host
        # clock times it.
        timer = None
        if self._tick is not None:
            timer = ((torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True)) if cuda
                     else [time.perf_counter(), None])
            if cuda:
                timer[0].record()
        with self._op('tick', key, stage.numpy().copy(), self._tp_check):
            self._in_dev.copy_(stage, non_blocking=cuda)
            if cuda:
                self._stage_events[ring].record()
            packed = self._launch(key)
            if timer is not None:
                if cuda:
                    timer[1].record()
                else:
                    timer[1] = time.perf_counter()
            if self._tp_check:
                self._check_replicas()
        # Out of the program's static output before it can run again.
        out = self._out[ring][:packed.numel()]
        out.copy_(packed, non_blocking=cuda)
        if cuda:
            self._out_events[ring].record()

        if prefilling and not self._warming:
            _M_PREFILL_TOKENS.inc(budget_used)
            self.prefill_ticks += 1
            self.max_tick_prefill_tokens = max(
                self.max_tick_prefill_tokens, budget_used)
        for m in chunk_meta:
            st = self.slots[m['slot']]
            st.prefill_pos += m['n']
            ts = self._req_spans.get(st.request_id)
            if ts is not None and 'prefill' in ts:
                # Host-side dispatch window of the chunk.
                trace_lib.start_span(
                    'engine.prefill.chunk', parent=ts['prefill'],
                    start=m['start'], tokens=m['n'],
                    slot=m['slot']).finish()
            if m['last']:
                # The first token is already in the device token vector;
                # the slot decodes from the next tick on.
                st.phase = 'decode'
                if ts is not None:
                    ps = ts.pop('prefill', None)
                    if ps is not None:
                        # Chunks that ran: a hit starts at the cached
                        # boundary.
                        ps.finish(chunks=self._prefill_ticks(
                            st.prompt_len - st.reused),
                            reused_tokens=st.reused)
                    ts['first_chunk'] = trace_lib.start_span(
                        'engine.decode.first_chunk',
                        parent=ts['request'], slot=m['slot'])
        if n and not self._warming:
            self.decode_steps_total += n
        # Which occupant each decoded column belongs to: by the time
        # this tick syncs, a slot may have been freed and recycled.
        snapshot = [(i, s.epoch) for i, s in enumerate(self.slots)
                    if s is not None and active_list[i]]
        device = None
        if timer is not None:
            device = (self._device_span(key, spec or n, snapshot,
                                        chunk_meta), timer)
        if spec or n:
            act = np.asarray(active_list)
            self._cols[act] = np.minimum(self._cols[act] + (spec or n),
                                         self._col_cap)
        return {'out': out, 'event': self._out_events[ring], 'n': n,
                'spec': spec, 'snapshot': snapshot, 'chunks': chunk_meta,
                'key': key, 'first': first, 'device': device}

    def _device_span(self, key: tuple, n: int, snapshot: List[tuple],
                     chunks: List[Dict[str, Any]]) -> trace_lib.Span:
        """The engine.tick.device span of a tick just dispatched (called
        before the rows' column counts move): its kind, decode steps (or
        verify width) ``n``, live decode ``rows``, the ``keys`` those
        rows attend over the n steps (step j of a row with c keys before
        it attends c + j + 1), and its prefill tokens, chunks and
        query-key pairs. It ends with ``device_ms`` when the tick is
        processed."""
        keys = 0
        if n:
            for i, _ in snapshot:
                c = self.slots[i].prompt_len + int(self._cols[i])
                keys += n * c + n * (n + 1) // 2
        pairs = sum(((m['start'] + m['n']) * (m['start'] + m['n'] + 1) -
                     m['start'] * (m['start'] + 1)) // 2 for m in chunks)
        return trace_lib.start_span(
            'engine.tick.device', parent=self._tick, kind=key[0], n=n,
            rows=len(snapshot) if n else 0, keys=keys,
            prefill_tokens=sum(m['n'] for m in chunks), chunks=len(chunks),
            prefill_pairs=pairs)

    def _emit_first_token(self, state: _SlotState, tok: int,
                          now: float) -> List[int]:
        state.generated.append(tok)
        if not self._warming:
            # One timing source: with tracing on, TTFT is the request
            # span's age at the first token, the trace id its exemplar.
            ts = self._req_spans.get(state.request_id)
            if ts is not None:
                fc = ts.pop('first_chunk', None)
                if fc is not None:
                    fc.finish()
                ttft = now - ts['request'].start_time
                _M_TTFT.observe(ttft, exemplar=ts['request'].exemplar)
                self._observe_slo('ttft', ttft, ts['request'].exemplar)
            else:
                ttft = now - self._submitted_at.get(state.request_id, now)
                _M_TTFT.observe(ttft)
                self._observe_slo('ttft', ttft, None)
            # Classless requests observe as the default class.
            cls = state.priority_class or qos_lib.DEFAULT_CLASS
            win = self._class_ttft_windows.get(cls)
            if win is not None:
                win.observe(ttft)
        return [tok]

    def _observe_slo(self, kind: str, value: float,
                     exemplar: Optional[str]) -> None:
        """Feed the sliding window behind the cumulative histogram. A
        value past the configured threshold counts a violation and
        pins its trace id on the gauge (a sticky exemplar); otherwise
        the 4 Hz refresher owns the gauge."""
        if kind == 'ttft':
            win, gauge, thr = (self._ttft_window, _M_TTFT_P99,
                               self._slo_ttft_s)
        else:
            win, gauge, thr = (self._itl_window, _M_ITL_P99,
                               self._slo_itl_s)
        win.observe(value)
        if not (thr > 0 and value > thr):
            return
        _M_SLO_VIOLATIONS.inc(1, kind=kind)
        p99 = win.quantile(0.99)
        gauge.set(value if p99 is None else p99, exemplar=exemplar)

    def _process_tick(self, entry: Optional[Dict[str, Any]]) -> int:
        """Wait for a dispatched tick's outputs (the sync), then hand
        its tokens to their requests. Returns the tokens emitted. A
        traced step has both phases even with no tick to process."""
        if entry is None and self._tick is None:
            return 0
        with self._phase('engine.tick.sync'):
            if entry is not None and entry['event'] is not None:
                self._wait(entry['event'])
        # TTFT and ITL end here, once the tick's tokens are on the host
        # (the reference stamps them before the wait; on the CPU nothing
        # runs in between).
        now = time.time()
        now_pc = time.perf_counter()
        with self._phase('engine.tick.process') as phase:
            emitted = (0 if entry is None else
                       self._emit_tick(entry, now, now_pc))
            if phase is not None:
                phase.set_attr(emitted=emitted)
        if entry is not None and entry['device'] is not None:
            sp, (start, end) = entry['device']
            sp.finish(device_ms=(end - start) * 1e3
                      if isinstance(start, float)
                      else start.elapsed_time(end))
        return emitted

    def _emit_tick(self, entry: Dict[str, Any], now: float,
                   now_pc: float) -> int:
        """Credit a synced tick's tokens to the slots that still hold
        the requests it ran for; stamp first tokens at ``now`` and
        token batches at ``now_pc``."""
        emitted = 0
        fresh_by_slot: Dict[int, List[int]] = {}
        # The packed outputs (_tick_body), read before the buffer is
        # staged again two ticks on.
        out = entry['out'].numpy().copy()
        b, n, spec = self.batch_size, entry['n'], entry['spec']
        n_toks = b * spec if spec else b * n
        firsts_host = out[n_toks + (b if spec else 0):]
        # Completed prefill chunks first: their first token was sampled
        # before this tick's decode scan.
        for m in entry['chunks']:
            if not m['last']:
                continue
            state = self.slots[m['slot']]
            if state is None or state.epoch != m['epoch']:
                continue          # freed/recycled mid-flight
            fresh_by_slot[m['slot']] = self._emit_first_token(
                state, int(firsts_host[m['row']]), now)
            emitted += 1
        if entry['spec']:
            # Verify tick: row b surfaced counts[b] tokens, its accepted
            # drafts and then the model's own token; the rest of the row
            # is rejected-candidate garbage, rolled back on the device.
            toks_host = out[:n_toks].reshape(b, spec)
            counts_host = out[n_toks:n_toks + b]
            tick_acc = 0
            for slot_idx, epoch in entry['snapshot']:
                state = self.slots[slot_idx]
                if state is None or state.epoch != epoch:
                    continue      # freed/recycled mid-flight
                if self._is_done(state):
                    continue
                fresh = fresh_by_slot.setdefault(slot_idx, [])
                e = int(counts_host[slot_idx])
                for t in range(e):
                    tok = int(toks_host[slot_idx, t])
                    state.generated.append(tok)
                    fresh.append(tok)
                    emitted += 1
                    if self._is_done(state):
                        break     # tokens past max_new/EOS are dropped
                # Burst positions 0 .. e-2 are drafts, e-1 the model's
                # own token: only drafts that surfaced count as
                # accepted, so an EOS mid-burst truncates the count too.
                accepted = min(len(fresh), max(0, e - 1))
                tick_acc += accepted
                if not self._warming:
                    if accepted:
                        _M_SPEC_ACCEPTED.inc(accepted)
                        self.spec_accepted_total += accepted
                        self._tick_accepted += accepted
                    self.spec_emitted_total += len(fresh)
            if not self._warming:
                # Acceptance feedback for the dry-spell latch: a verify
                # tick whose drafts were all rejected is a miss like a
                # round without drafts; any accepted draft re-arms.
                if tick_acc:
                    self._spec_misses = 0
                    self._spec_cooldown = 0
                    self._spec_dry_rounds = 0
                else:
                    self._spec_misses += 1
                self._spec_dry = self._spec_misses >= _SPEC_DRY_AFTER
        elif n:
            toks_host = out[:n_toks].reshape(n, b)
            for slot_idx, epoch in entry['snapshot']:
                state = self.slots[slot_idx]
                if state is None or state.epoch != epoch:
                    continue      # freed/recycled mid-flight
                if self._is_done(state):
                    continue
                fresh = fresh_by_slot.setdefault(slot_idx, [])
                for t in range(n):
                    tok = int(toks_host[t, slot_idx])
                    state.generated.append(tok)
                    fresh.append(tok)
                    emitted += 1
                    if self._is_done(state):
                        break     # tokens past max_new/EOS are dropped
        for slot_idx, fresh in fresh_by_slot.items():
            state = self.slots[slot_idx]
            if state is None or not fresh:
                continue
            if not self._warming and state.last_emit_at is not None:
                # ITL: the gap a streaming client sees between two token
                # batches of one request.
                ts = self._req_spans.get(state.request_id)
                itl = now_pc - state.last_emit_at
                itl_exemplar = (ts['request'].exemplar
                                if ts is not None else None)
                _M_ITL.observe(itl, exemplar=itl_exemplar)
                self._observe_slo('itl', itl, itl_exemplar)
            state.last_emit_at = now_pc
            if state.tenant is not None and not self._warming:
                _M_TENANT_TOKENS.inc(len(fresh), tenant=state.tenant)
            if self.on_token is not None:
                self.on_token(state.request_id, fresh)
            if self._is_done(state):
                self._finish(slot_idx)
        if emitted and not self._warming:
            _M_TOKENS.inc(emitted)
        return emitted

    def _wait(self, event) -> None:
        """Wait for a tick's output event; on a mesh with workers, at
        most the group's timeout (a captured collective whose peer died
        never completes), then fail naming the ranks."""
        if self._channel is None:
            event.synchronize()
            return
        deadline = time.monotonic() + distributed.timeout_s()
        while not event.query():
            if time.monotonic() > deadline:
                with self._channel.lock:
                    self._channel.broken = self._channel.diagnose(
                        'tick', TimeoutError('the tick never finished'))
                raise channel_lib.WorkerError(self._channel.broken)
            time.sleep(20e-6)

    def drain_results(self) -> Dict[Any, Result]:
        """Pop and return all finished results."""
        out = self.results
        self.results = {}
        return out

    def _inflight_ids(self) -> set:
        return ({r.request_id for r in list(self.queue)} |
                {s.request_id for s in self.slots if s is not None})

    def run(self, requests: Sequence[Request],
            on_result: Optional[Callable[[Result], None]] = None
            ) -> Dict[Any, Result]:
        """Serve ``requests`` to completion (continuous batching);
        returns (and fires ``on_result`` for) only this call's
        requests."""
        wanted = set()
        inflight = self._inflight_ids()
        for r in requests:
            if r.request_id in wanted or r.request_id in inflight:
                raise ValueError(f'duplicate request_id {r.request_id!r}')
            wanted.add(r.request_id)
        for r in requests:
            self.submit(r)
        collected: Dict[Any, Result] = {}
        while self.queue or self.num_active() or self.has_pending:
            self.step()
            for rid, res in self.drain_results().items():
                collected[rid] = res
                if on_result and rid in wanted:
                    on_result(res)
        return {rid: collected[rid] for rid in wanted}


def serve_worker(mesh, params: Dict, cfg, **engine_kwargs) -> None:
    """A worker rank of a tensor-parallel replica: build the same engine
    as rank 0 (``engine_kwargs`` equal to rank 0's, ``params`` this
    rank's shard) and replay rank 0's operations until it stops the
    replica."""
    if mesh.rank == 0:
        raise ValueError('serve_worker runs on the ranks other than 0')
    ServingEngine(params, cfg, mesh=mesh, **engine_kwargs).serve_ops()
