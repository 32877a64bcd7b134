"""Continuous-batching serving engine over the KV-cache decoder.

Port of the core of ``skypilot_tpu/models/serving_engine.py``: a fixed
decode batch of ``batch_size`` slots recycled as requests finish;
chunked prefill under a per-tick token budget (each admitted prompt
streams into its slot's prompt-region KV ``prefill_chunk`` tokens per
tick, at most ``budget // chunk`` prefilling rows per tick, fused with
the decode chunk of the active slots); an ``n``-step decode scan per
tick whose page count follows cache occupancy; slot epochs so a tick
in flight never credits tokens to a slot's next occupant; admission
that guarantees every admitted request finishes, with a cache reset
when the decode region is exhausted and no slot is occupied.

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
a verify segment could strand an admitted request, and a dry-spell
latch keeps no-match traffic on the pipelined path.

Not ported yet (later slices): prefix cache, QoS, deadlines, KV
import, metrics, tracing, fault injection, meshes.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import logging
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from skypilot_tpu_torch.models import inference
from skypilot_tpu_torch.models.llama import LlamaConfig
from skypilot_tpu_torch.ops import _build
from skypilot_tpu_torch.ops import decode_attention as decode_attn
from skypilot_tpu_torch.ops import split_kv
from skypilot_tpu_torch.utils import env_registry
from skypilot_tpu_torch.utils import lifecycle
from skypilot_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

# Consecutive no-draft (or all-rejected) rounds before the engine goes
# "dry": while dry, ticks stay pipelined (no flush) and proposals only
# probe the chain for a re-arm.
_SPEC_DRY_AFTER = 4
# Cap on the doubling re-arm cooldown (dry probe-hit rounds).
_SPEC_COOLDOWN_MAX = 256


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


@dataclasses.dataclass
class Result:
    request_id: Any
    tokens: List[int]
    prompt_len: int
    submitted_at: float
    finished_at: float
    # 'finished' | 'cancelled'; cancelled results keep the tokens
    # decoded so far.
    status: str = lifecycle.FINISHED
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
                 eos_id: Optional[int] = None,
                 temperature: float = 0.0,
                 top_k: int = 0,
                 decode_chunk: int = 8,
                 page: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 prefill_budget: Optional[int] = None,
                 device=None,
                 spec_decode: Optional[bool] = None,
                 spec_k: Optional[int] = None,
                 spec_ngram: Optional[int] = None) -> None:
        self.device = resolve_device(device)
        emb = params['tok_emb']
        if emb.device.type != self.device.type:
            raise ValueError(f'params live on {emb.device}, the engine '
                             f'runs on {self.device}')
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
        # chunk covers the live region [0, base + steps + n), rounded
        # per num_pages_for.
        self._page = page or decode_attn.default_page()
        if self.device.type == 'cuda' and self.max_seq % self._page:
            # The reference downgrades to its einsum path here; the
            # port has no slow path on the card to downgrade to.
            raise ValueError(
                f'max_seq {self.max_seq} is not a multiple of the decode '
                f'page size {self._page}; the paged decode kernel needs '
                'page-aligned caches.')
        self._total_pages = -(-self.max_seq // self._page)
        self._base_pages = -(-max_prompt // self._page)
        self.decode_chunk = max(1, decode_chunk)
        chunk = prefill_chunk or int(env_registry.get(
            env_registry.SKYTPU_PREFILL_CHUNK, '128'))
        budget = prefill_budget or int(env_registry.get(
            env_registry.SKYTPU_PREFILL_BUDGET, '256'))
        self.prefill_chunk = max(1, min(chunk, max_prompt))
        self._prefill_rows = max(
            1, min(budget // self.prefill_chunk, batch_size))
        self.prefill_budget = self._prefill_rows * self.prefill_chunk
        # Speculative decoding: off unless asked for (constructor or
        # SKYTPU_SPEC_DECODE). An explicit spec_k of 0 means no draft
        # tokens, so speculation off; so does a verify segment wider
        # than the decode region.
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
                'columns) exceeds the decode region (%d); raise max_seq '
                'or lower SKYTPU_SPEC_K.', self._spec_v,
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
        self._steps_done = 0
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
        # Sampled (temperature > 0) rows draw from this generator (every
        # tick draws; greedy rows ignore the draw).
        self._gen = torch.Generator(device=self.device).manual_seed(0)
        # One cache for the engine's lifetime: resets restore it in
        # place, so captured programs keep pointing at it.
        self.cache = inference.make_cache(
            cfg, batch_size, self.max_seq, base=max_prompt,
            kv_quant=kv_quant, device=self.device)
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
        # Captured tick programs by key (on the card; None = run the
        # bodies eagerly, the CPU's only path). Tests and chip_smoke.py
        # set it to None to time the eager ticks.
        self._graphs: Optional[Dict[tuple, _build.Captured]] = (
            {} if cuda else None)
        self._graph_pool = None
        # Graphs captured, and the seconds warmup() spent capturing
        # (the counterpart of the reference's compiled-program count).
        self.graph_captures = 0
        self.graph_capture_s = 0.0
        self._warming = False
        # Work accounting outside warmup: decode steps and prefill ticks
        # dispatched (each runs every layer's kernel once), and the most
        # prompt tokens one tick prefilled (never above prefill_budget).
        self.decode_steps_total = 0
        self.prefill_ticks = 0
        self.max_tick_prefill_tokens = 0

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
        can dispatch (on the card), then serve two synthetic requests —
        one full-length prompt, one shorter than a chunk — through every
        host path, and reset. Speculation stays off while warming up."""
        if self.device.type == 'cuda':
            _build.build()
        if self._graphs is not None:
            self._capture()
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

    def _tick_keys(self) -> List[tuple]:
        """Every tick program a run can dispatch: the reference's
        warmup() key set (skypilot_tpu/models/serving_engine.py:955-1050).
        Decode chunks fold to powers of two as step() folds them; the
        main chunk runs at any occupancy (page-stride enumeration: the
        page count changes only at page boundaries), tail chunks only
        near region exhaustion, where the remaining slots lie in
        [n, 2n). Verify ticks advance the frontier by V columns, so with
        speculation on every steps value is walked (stride 1) and the
        verify page counts over [0, cap - V] added."""
        n = self.decode_chunk
        while n & (n - 1):
            n &= n - 1
        chunk = n

        def count_for(steps_done: int, n_: int) -> int:
            return decode_attn.num_pages_for(
                self.max_prompt + steps_done + n_, self._page,
                self._total_pages, base_pages=self._base_pages)

        cap = self.decode_capacity()
        stride = 1 if self.spec_decode else max(1, self._page)
        pairs = {(chunk, count_for(s, chunk))
                 for s in range(0, max(cap - chunk, 0) + 1, stride)}
        pairs.add((chunk, count_for(max(cap - chunk, 0), chunk)))
        while n > 1:
            n //= 2
            lo, hi = max(0, cap - 2 * n + 1), max(0, cap - n)
            walk = range(lo, hi + 1) if self.spec_decode else (lo, hi)
            pairs.update((n, count_for(s, n)) for s in walk)
        pairs = sorted(pairs)
        keys = [('decode', n_, p) for n_, p in pairs]
        keys.append(('mixed', 0, None, 0))
        keys += [('mixed', n_, p, 0) for n_, p in pairs]
        if self.spec_decode:
            v = self._spec_v
            counts = sorted({count_for(s, v)
                             for s in range(0, max(cap - v, 0) + 1)})
            keys += [('verify', p) for p in counts]
            keys += [('mixed', 0, p, v) for p in counts]
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
        split_kv.reserve(self.device, self.batch_size * self.cfg.n_kv_heads *
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
                generators=(self._gen,))
            self.graph_captures += 1
        torch.cuda.synchronize(self.device)
        self.graph_capture_s += time.perf_counter() - t0

    def reset(self) -> None:
        """Drop all cache state (in place: every cache tensor keeps its
        address). Only valid with nothing in flight."""
        if self.num_active() or self.queue or self._pending is not None:
            raise RuntimeError('reset() with requests in flight')
        inference.reset_cache(self.cache)
        self._steps_done = 0
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
        with self._submit_lock:
            # _submitted_at holds exactly the in-flight ids: added
            # here, removed when the request's one Result is recorded.
            if request.request_id in self._submitted_at:
                raise DuplicateRequestError(
                    f'duplicate request_id {request.request_id!r}: a '
                    'request with this id is already in flight.')
            self._submitted_at[request.request_id] = time.time()
            self.queue.append(request)

    def decode_capacity(self) -> int:
        return self.max_seq - self.max_prompt

    def _num_pages(self, n: int) -> int:
        """Page count for the next ``n``-step decode chunk: covers the
        live region [0, base + steps_done + n)."""
        live = self.max_prompt + self._steps_done + n
        return decode_attn.num_pages_for(live, self._page,
                                         self._total_pages,
                                         base_pages=self._base_pages)

    def remaining_slots(self) -> int:
        return self.decode_capacity() - self._steps_done

    def num_active(self) -> int:
        return sum(s is not None for s in self.slots)

    # ------------------------------------------------------------------
    def _prefill_ticks(self, tokens_left: int) -> int:
        return -(-tokens_left // self.prefill_chunk)

    def _fits(self, req: Request) -> bool:
        """May ``req`` be admitted without breaking the finish
        guarantee? At every tick the remaining decode region must cover
        the worst case any occupied slot still needs: ``max_new`` left
        plus ``decode_chunk`` steps other slots may burn per remaining
        prefill tick. A request with no co-resident slot only needs
        ``max_new`` (prefill-only ticks dispatch no decode steps)."""
        remaining = self.remaining_slots()
        occupied = [s for s in self.slots if s is not None]
        if not occupied:
            return req.max_new <= remaining
        charge = (req.max_new + self._prefill_ticks(len(req.tokens)) *
                  self.decode_chunk)
        if charge > remaining:
            return False
        for s in occupied:
            left = s.max_new - len(s.generated)
            if s.phase == 'prefill':
                left += (self._prefill_ticks(s.prompt_len - s.prefill_pos)
                         * self.decode_chunk)
            if left > remaining:
                return False
        return True

    def _admit(self) -> None:
        """Move queued requests into free slots, FIFO; prefilling slots
        are capped at the budget's row count so every one of them is
        scheduled every tick."""
        free = [i for i, s in enumerate(self.slots) if s is None]
        n_prefilling = sum(1 for s in self.slots
                           if s is not None and s.phase == 'prefill')
        admitted = False
        while self.queue and free and n_prefilling < self._prefill_rows:
            req = self.queue[0]
            if not self._fits(req):
                if (self.num_active() == 0 and not admitted and
                        self._pending is None and self._steps_done):
                    # Region exhausted with nothing running: fresh
                    # cache (restored in place), then re-check.
                    inference.reset_cache(self.cache)
                    self._steps_done = 0
                    continue
                break  # wait for running requests to drain
            # Slot assignment before popleft: the request is never in
            # neither container.
            slot_idx = free.pop(0)
            self._epoch += 1
            self._seq += 1
            self.slots[slot_idx] = _SlotState(
                request_id=req.request_id, max_new=req.max_new,
                generated=[], prompt=list(req.tokens),
                prompt_len=len(req.tokens), seq=self._seq,
                epoch=self._epoch)
            self.queue.popleft()
            self._temps[slot_idx] = (
                req.temperature if req.temperature is not None
                else self.temperature)
            n_prefilling += 1
            admitted = True

    def _finish(self, slot_idx: int) -> None:
        state = self.slots[slot_idx]
        self._terminal(state.request_id, state.generated,
                       state.prompt_len, lifecycle.FINISHED, None)
        self.slots[slot_idx] = None

    def _terminal(self, rid: Any, tokens: List[int], prompt_len: int,
                  status: str, reason: Optional[str]) -> None:
        """Record the request's one terminal Result."""
        self.results[rid] = Result(
            request_id=rid, tokens=list(tokens), prompt_len=prompt_len,
            submitted_at=self._submitted_at.pop(rid, 0.0),
            finished_at=time.time(), status=status, reason=reason)

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

    def _apply_cancellations(self) -> None:
        if not self._cancels:
            return
        with self._cancel_lock:
            cancels, self._cancels = self._cancels, {}
        for rid, reason in cancels.items():
            self._cancel_now(rid, reason)

    def _cancel_now(self, rid: Any, reason: str) -> bool:
        for i in range(len(self.queue)):
            req = self.queue[i]
            if req.request_id == rid:
                del self.queue[i]
                self._terminal(rid, [], len(req.tokens),
                               lifecycle.CANCELLED, reason)
                return True
        for slot_idx, state in enumerate(self.slots):
            if state is not None and state.request_id == rid:
                # The in-flight tick's tokens for this slot are dropped
                # by the epoch check; the next occupant's first prefill
                # chunk clears the row's dmask.
                self._terminal(rid, state.generated, state.prompt_len,
                               lifecycle.CANCELLED, reason)
                self.slots[slot_idx] = None
                return True
        return False

    def cancel_all(self, reason: str = 'shutdown') -> List[Any]:
        """Driver-thread bulk cancel: every queued and in-slot request
        gets its cancelled Result now. Returns the cancelled ids."""
        self._apply_cancellations()
        rids = [r.request_id for r in self.queue]
        rids += [s.request_id for s in self.slots if s is not None]
        for rid in rids:
            self._cancel_now(rid, reason)
        return rids

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
        """May a verify segment run without breaking the finish
        guarantee? It consumes V shared columns while its worst case
        (all rejected) advances each decode row by one token, so the
        region left after it must still cover every occupant's
        pessimistic remaining need."""
        after = self.remaining_slots() - self._spec_v
        if after < 0:
            return False
        for s in self.slots:
            if s is None:
                continue
            left = s.max_new - len(s.generated)
            if s.phase == 'prefill':
                left += (self._prefill_ticks(s.prompt_len - s.prefill_pos)
                         * self.decode_chunk)
            else:
                left -= 1           # every decode row advances >= 1
            if left > after:
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
    def step(self) -> int:
        """One pipelined engine tick: apply cancellations, admit,
        launch tick N+1 (up to ``prefill_budget`` prompt tokens fused
        with the decode chunk of the active slots, or with a verify
        segment when slots hold drafts), then sync and process tick N.
        Results therefore surface one tick after their final decode
        chunk. Speculation needs the fresh chain to draft from, so
        while it is armed the in-flight tick is processed first.
        Returns the tokens emitted."""
        self._apply_cancellations()
        self._admit()
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
            self._admit()       # the flush may have freed slots
        if spec_may:
            self._spec_round()
        new_entry = self._dispatch_tick()
        prev, self._pending = self._pending, new_entry
        return emitted + self._process_tick(prev)

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
                num_pages=num_pages, page=self._page)
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
                prompt_base=self.max_prompt)
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
                active=active, num_pages=num_pages, page=self._page)
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
        # Decode chunk: bounded by the remaining region (admission
        # guarantees every active request fits) and folded to a power
        # of two, as in the reference.
        n = 0
        if any_active and not run_spec:
            n = min(self.decode_chunk, self.remaining_slots())
            if n < 1:
                # Slots free one tick after their final chunk, so a
                # request whose max_new consumed the region exactly is
                # still occupied here; processing the pending tick
                # frees it.
                if self._pending is None and not prefilling:
                    raise RuntimeError(
                        'capacity accounting violated: region exhausted '
                        'with active slots and no tick in flight')
                n = 0
            while n & (n - 1):
                n &= n - 1
        if not prefilling and n == 0 and not run_spec:
            return None
        spec = self._spec_v if run_spec else 0
        if spec and self.remaining_slots() < spec:
            # The device reads the segment start from the cache; the
            # host mirror of steps is where the bound is checked.
            raise RuntimeError(
                f'the verify segment at {self.max_prompt + self._steps_done}'
                f' runs past the cache ({self.max_seq} slots)')
        num_pages = self._num_pages(spec or n) if spec or n else None
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
                self.spec_proposed_total += int(host['spec_len'].sum())
                self.spec_ticks += 1
                self.spec_row_steps += sum(active_list)
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
                                   'last': last})
        self._in_dev.copy_(stage, non_blocking=cuda)
        if cuda:
            self._stage_events[ring].record()
        packed = self._launch(key)
        # Out of the program's static output before it can run again.
        out = self._out[ring][:packed.numel()]
        out.copy_(packed, non_blocking=cuda)
        if cuda:
            self._out_events[ring].record()

        for m in chunk_meta:
            st = self.slots[m['slot']]
            st.prefill_pos += m['n']
            if m['last']:
                # The first token is already in the device token vector;
                # the slot decodes from the next tick on.
                st.phase = 'decode'
        if prefilling and not self._warming:
            self.prefill_ticks += 1
            self.max_tick_prefill_tokens = max(
                self.max_tick_prefill_tokens, budget_used)
        if n and not self._warming:
            self.decode_steps_total += n
        self._steps_done += spec or n
        # Which occupant each decoded column belongs to: by the time
        # this tick syncs, a slot may have been freed and recycled.
        snapshot = [(i, s.epoch) for i, s in enumerate(self.slots)
                    if s is not None and active_list[i]]
        return {'out': out, 'event': self._out_events[ring], 'n': n,
                'spec': spec, 'snapshot': snapshot, 'chunks': chunk_meta}

    def _process_tick(self, entry: Optional[Dict[str, Any]]) -> int:
        if entry is None:
            return 0
        emitted = 0
        fresh_by_slot: Dict[int, List[int]] = {}
        if entry['event'] is not None:
            entry['event'].synchronize()                     # the sync
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
            tok = int(firsts_host[m['row']])
            state.generated.append(tok)
            fresh_by_slot[m['slot']] = [tok]
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
                    self.spec_accepted_total += accepted
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
            if self.on_token is not None:
                self.on_token(state.request_id, fresh)
            if self._is_done(state):
                self._finish(slot_idx)
        return emitted

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
