"""Automatic prefix caching for the serving engine: a block-hash page
pool with copy-on-write sharing.

Port of ``skypilot_tpu/models/prefix_cache.py``. A device-resident pool
of **KV pages** is keyed by a **chain hash** of the prompt token blocks
they were computed from (``utils/chain_hash.py``, bitwise the
reference's): a page's key commits to its WHOLE prefix, so a hash hit
means the page's K/V are exactly what this request's own prefill would
compute for those positions.

Sharing model (the copy-on-write discipline):

- Pool pages are **immutable once published**. An admission hit copies
  the matched pages into the slot's private prompt-region KV; the
  slot's chunked prefill then resumes at the cached boundary. The
  writer only ever touches its own row, so a sharer's pages can never
  be corrupted.
- Pages a slot copied in stay **pinned** (refcounted) until the
  request reaches a terminal state, so eviction never recycles a page
  an in-flight request may still need republished.
- A completed (or cancelled) slot **publishes** its now-final full
  prompt pages back to the pool and releases its pins; pages already
  present are deduplicated by hash.
- Eviction is LRU over **unpinned** pages only; when every page is
  pinned, publishing degrades gracefully (the pool just misses).

Bitwise-parity discipline: the reuse boundary is rounded DOWN to a
multiple of the engine's ``prefill_chunk`` and capped at
``prompt_len - 1``, so the uncached suffix prefills at exactly the
chunk starts a cache-off run would use, and the pages a hit copies in
are the bits its own prefill would write. Greedy output over a hit is
then bit-identical to the cache-off path wherever the decode's
reduction follows each row's keys, not the cache columns the schedule
put them at: the card's bf16 split kernels (``ops/split_kv.py``).

On the device, everything is in place. The pool is allocated once, at
construction, and never rebound; a copy-in, publish, export or import
is a ``copy_``/``fill_`` on slices at Python-int indices, so no device
index tensor is built from host lists and the engine's cache tensors
keep the addresses its captured tick programs hold. Every copy runs on
the stream the engine's ticks run on, so stream order gives what JAX's
dataflow gives the reference: a copy-in lands after the tick in flight
and before the next, and a publish reads a slot after the last tick
that wrote its prompt region.

Threading: all mutation (acquire/publish/import/evict) happens on the
thread that steps the engine; ``reusable_tokens``, ``prefix_summary`` and
``export_page`` are safe to call from other threads.

Tensor parallelism (``mesh=``): each rank's pool holds its kv heads, as
its live cache does (the reference's ``POOL_SPEC``); with
``SKYTPU_PREFIX_POOL_SHARD=0`` every rank holds every head, as the
reference's replicated pool does. The directory is rank 0's; each device
operation runs through ``op`` (the engine's control channel, which
replays it on the workers): a copy-in and a publish move each rank's
heads; ``export_page`` gathers the heads of every rank onto rank 0, so an
SKKV1 page has the unsharded pool's layout and bytes (a page imported,
then exported, comes back byte for byte), and ``import_pages`` hands
every rank the whole page to keep its heads of.
"""
from __future__ import annotations

import logging
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from skypilot_tpu_torch import metrics as metrics_lib
from skypilot_tpu_torch.models.llama import LlamaConfig
from skypilot_tpu_torch.parallel import channel as channel_lib
from skypilot_tpu_torch.serve import kv_transfer
from skypilot_tpu_torch.utils import chain_hash
from skypilot_tpu_torch.utils import env_registry
from skypilot_tpu_torch.utils.device import resolve_device

logger = logging.getLogger(__name__)

# Default pool size in pages (SKYTPU_PREFIX_POOL_PAGES overrides).
DEFAULT_POOL_PAGES = 512

# The reference's five prefix series, under its names and help.
_M_HITS = metrics_lib.counter(
    'skytpu_engine_prefix_hits_total',
    'Admissions that reused at least one cached prompt page from the '
    'prefix pool (docs/metrics.md; PERFORMANCE.md "Prefix-reuse KV '
    'cache").')
_M_SAVED = metrics_lib.counter(
    'skytpu_engine_prefix_tokens_saved_total',
    'Prompt tokens served from the prefix pool instead of being '
    'prefilled (chunk-aligned reuse boundary; rate() of this is the '
    'prefill compute the cache is saving).')
_M_POOL = metrics_lib.gauge(
    'skytpu_engine_prefix_pool_pages',
    'Occupied pages in the shared prefix pool (capacity is '
    'SKYTPU_PREFIX_POOL_PAGES).')
_M_EVICTIONS = metrics_lib.counter(
    'skytpu_engine_prefix_evictions_total',
    'Cold (unpinned) prefix pages evicted LRU to make room for a '
    'newly published page.')
_M_IMPORTED = metrics_lib.counter(
    'skytpu_engine_prefix_pages_imported_total',
    'Remote KV pages landed into the local prefix pool via the '
    'transfer import path (serve/kv_transfer.py; '
    'docs/disaggregation.md).')

# Pool dtype -> its name in a page signature (numpy's names, as the
# reference's ``str(np.dtype(...))`` writes them).
_DTYPE_NAMES = {torch.bfloat16: 'bfloat16', torch.int8: 'int8',
                torch.float32: 'float32'}


def summary_pages() -> int:
    """Bound on the hash list a /health digest advertises
    (SKYTPU_AFFINITY_SUMMARY_PAGES, default 128)."""
    return max(0, int(env_registry.get(
        env_registry.SKYTPU_AFFINITY_SUMMARY_PAGES, '128')))


class PrefixCache:
    """Device-resident shared page pool + host-side hash directory.

    The pool holds ``pool_pages`` pages of ``page`` token positions
    each, laid out ``[n_layers, pool_pages, page, n_kv, head_dim]`` in
    the cache's dtype (+ per-vector bf16 scale planes for int8 KV
    caches: pages are copied in the cache's native dtype, never
    dequantized). ``device=None`` means CUDA."""

    def __init__(self, cfg: LlamaConfig, *, page: int, pool_pages: int,
                 kv_quant: bool = False, device=None, mesh=None) -> None:
        if page < 1:
            raise ValueError(f'page ({page}) must be positive')
        if pool_pages < 1:
            raise ValueError(
                f'pool_pages ({pool_pages}) must be positive')
        self.device = resolve_device(device)
        self.page = int(page)
        self.pool_pages = int(pool_pages)
        kv_dtype = torch.int8 if kv_quant else cfg.compute_dtype
        if kv_dtype not in _DTYPE_NAMES:
            raise ValueError(f'no SKKV1 page dtype for {kv_dtype}')
        # This rank's kv heads [h0, h0 + n) of the model's n_kv_heads;
        # the pool holds them, or every head where it is replicated.
        self.mesh = mesh
        n_heads = cfg.n_kv_heads
        n = n_heads if mesh is None else mesh.local(n_heads, 'n_kv_heads')
        self.heads = (0 if mesh is None else mesh.tp_rank * n, n)
        self.replicated = mesh is not None and mesh.tp > 1 and \
            env_registry.get(env_registry.SKYTPU_PREFIX_POOL_SHARD,
                             '1') != '1'
        pool_heads = n_heads if self.replicated else n
        shape = (cfg.n_layers, self.pool_pages, self.page, pool_heads,
                 cfg.head_dim)
        # A page block's wire shape, every head: [n_layers, 1, page, ...].
        self._block_shape = (cfg.n_layers, 1, self.page, n_heads,
                             cfg.head_dim)
        # Device operations go through ``op`` (the engine's control
        # channel under tensor parallelism, which replays them on the
        # workers; a plain context here).
        self.op: Callable[..., Any] = channel_lib.no_op
        self._fields: Tuple[str, ...] = ('k', 'v')
        self.pool = {f: torch.zeros(shape, dtype=kv_dtype,
                                    device=self.device)
                     for f in self._fields}
        if kv_quant:
            self._fields += ('k_scale', 'v_scale')
            for f in ('k_scale', 'v_scale'):
                self.pool[f] = torch.ones(shape[:4], dtype=torch.bfloat16,
                                          device=self.device)
        # The stream the engine's ticks run on (the constructing
        # thread's): exports from other threads copy on it, ordered
        # against publishes and imports.
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.device.type == 'cuda' else None)

        # Host directory: hash -> pool page index, plus per-page
        # refcounts (pins), LRU stamps and the free list. Mutated only
        # on the thread that steps the engine.
        self._by_hash: Dict[bytes, int] = {}
        self._hash_of: List[Optional[bytes]] = [None] * self.pool_pages
        self._refs: List[int] = [0] * self.pool_pages
        self._stamp: List[int] = [0] * self.pool_pages
        self._tick = 0
        # pop() hands out low indices first (cosmetic determinism).
        self._free: List[int] = list(range(self.pool_pages - 1, -1, -1))
        self._pins: Dict[Any, List[int]] = {}
        self.hits = 0
        self.lookups = 0
        self.tokens_saved = 0
        self.evictions = 0
        _M_POOL.touch()
        # Directory version: bumped whenever the hash->page mapping
        # changes (insertions, evictions). Lookup results are a pure
        # function of (tokens, version), so a memo keyed on it stays
        # true.
        self.version = 0
        # prefix_summary memo: (version, bound, dict).
        self._summary_cache: Optional[Tuple[int, int, Dict]] = None

    # --------------------------------------------------------- lookup
    def _hashes_of(self, tokens: Sequence[int],
                   holder: Optional[Any] = None) -> List[bytes]:
        """Chain hashes of ``tokens``, cached on ``holder`` (the
        engine's Request object) when one is given, keyed on the token
        list's identity (prompts are immutable after submit)."""
        if holder is not None:
            cached = getattr(holder, '_prefix_hashes', None)
            if cached is not None and cached[0] is tokens:
                return cached[1]
        out = chain_hash.page_hashes(tokens, self.page)
        if holder is not None:
            try:
                holder._prefix_hashes = (tokens, out)
            except (AttributeError, TypeError):
                pass               # slotted/frozen holder: no cache
        return out

    def match_pages(self, tokens: Sequence[int],
                    holder: Optional[Any] = None) -> List[int]:
        """Pool page indices of the longest cached prefix (pure read)."""
        ids: List[int] = []
        for h in self._hashes_of(tokens, holder):
            idx = self._by_hash.get(h)
            if idx is None:
                break
            ids.append(idx)
        return ids

    def _reuse_len(self, n_pages: int, prompt_len: int,
                   chunk: int) -> int:
        """Reusable prompt tokens given ``n_pages`` matched pages:
        capped at prompt_len - 1 (the last token always prefills) and
        rounded DOWN to a ``chunk`` multiple (the parity discipline)."""
        cap = min(n_pages * self.page, prompt_len - 1)
        return max(0, (cap // max(1, chunk)) * chunk)

    def reusable_tokens(self, tokens: Sequence[int], chunk: int,
                        holder: Optional[Any] = None) -> int:
        """How many prompt tokens a lookup NOW would serve from the
        pool (pure read)."""
        return self._reuse_len(len(self.match_pages(tokens, holder)),
                               len(tokens), chunk)

    def would_reuse(self, tokens: Sequence[int], chunk: int,
                    extra_hashes: Sequence[bytes] = ()) -> int:
        """Reuse length IF the pages named by ``extra_hashes`` were
        also in the pool (pure read: pages queued for import)."""
        extra = set(extra_hashes)
        n = 0
        for h in chain_hash.page_hashes(tokens, self.page):
            if h in self._by_hash or h in extra:
                n += 1
            else:
                break
        return self._reuse_len(n, len(tokens), chunk)

    # ----------------------------------------------------- admission
    def acquire(self, request_id: Any, tokens: Sequence[int],
                chunk: int, holder: Optional[Any] = None
                ) -> Tuple[int, List[int], List[bytes]]:
        """Look up the longest cached prefix for an admission and PIN
        the pages to copy. Returns (reuse_tokens, page_ids,
        prompt_hashes); reuse of 0 means a miss (no pins held). The
        hash list covers every full page of the prompt, so the
        terminal ``publish`` never re-hashes."""
        self.lookups += 1
        hashes = self._hashes_of(tokens, holder)
        ids = self.match_pages(tokens, holder)
        reuse = self._reuse_len(len(ids), len(tokens), chunk)
        if reuse == 0:
            return 0, [], hashes
        ids = ids[:-(-reuse // self.page)]
        for i in ids:
            self._refs[i] += 1
            self._touch(i)
        self._pins[request_id] = list(ids)
        self.hits += 1
        self.tokens_saved += reuse
        _M_HITS.inc()
        _M_SAVED.inc(reuse)
        return reuse, ids, hashes

    def release(self, request_id: Any) -> None:
        """Drop a terminal request's pins (idempotent; misses and
        queued-only requests hold none)."""
        for i in self._pins.pop(request_id, ()):
            self._refs[i] -= 1

    def pinned_pages(self) -> int:
        return sum(1 for r in self._refs if r > 0)

    def copy_into(self, cache: Dict, slot: int, page_ids: List[int],
                  cached_len: int) -> Dict:
        """Copy the acquired pages into ``slot``'s prompt-region KV and
        mark exactly [0, cached_len) readable, all in place (returns
        ``cache`` itself, no tensor of it replaced). The whole dmask
        row is rewritten: a hit's first chunk starts at the cached
        boundary, where ``prefill_chunk`` keeps the row's old mask, so
        the previous occupant's prompt tail and decode columns must go
        dark here, and the row's decode column count returns to 0: the
        new occupant writes its decode columns from ``base`` on."""
        with self.op('copy_in', slot, list(page_ids), cached_len):
            p = self.page
            for j, src in enumerate(page_ids):
                for f in self._fields:
                    cache[f][:, slot, j * p:(j + 1) * p].copy_(
                        self._mine(self.pool[f][:, src], 2))
            cache['dmask'][slot, :cached_len].fill_(True)
            cache['dmask'][slot, cached_len:].fill_(False)
            cache['length'][slot].fill_(cached_len)
            cache['steps'][slot].fill_(0)
        return cache

    def _mine(self, t: torch.Tensor, head_dim: int) -> torch.Tensor:
        """``t``'s slice of this rank's heads where the pool holds every
        head (``head_dim`` the heads' axis of ``t``), else ``t``."""
        if not self.replicated:
            return t
        return t.narrow(head_dim, *self.heads)

    # ------------------------------------------------------- publish
    def publish(self, tokens: Sequence[int], final_len: int,
                cache: Dict, slot: int,
                hashes: Optional[List[bytes]] = None) -> None:
        """Copy a terminal slot's finalized full prompt pages into the
        pool (dedup by hash). ``final_len`` is the slot's prefill
        cursor at the end — a cancel mid-prefill publishes only the
        pages it actually finished. ``hashes`` (the admission lookup's
        chain hashes) skips re-hashing. Publishing stops at the first
        allocation failure (every page pinned): a chain with a missing
        link is unreachable anyway."""
        n_full = min(final_len, len(tokens)) // self.page
        if n_full == 0:
            return
        if hashes is None or len(hashes) < n_full:
            hashes = chain_hash.page_hashes(tokens[:n_full * self.page],
                                            self.page)
        moves = []
        for i, h in enumerate(hashes[:n_full]):
            cur = self._by_hash.get(h)
            if cur is not None:
                self._touch(cur)
                continue
            dst = self._alloc()
            if dst is None:
                logger.debug(
                    'Prefix pool exhausted (all %d pages pinned): '
                    'skipping publish of %d page(s).', self.pool_pages,
                    n_full - i)
                break
            moves.append((i, dst))
            self._by_hash[h] = dst
            self._hash_of[dst] = h
            self._refs[dst] = 0
            self._touch(dst)
            self.version += 1
        if moves:
            with self.op('copy_out', slot, moves):
                self.copy_out(cache, slot, moves)
        _M_POOL.set(len(self._by_hash))

    def copy_out(self, cache: Dict, slot: int,
                 moves: Sequence[Tuple[int, int]]) -> None:
        """Copy page i of ``slot``'s prompt region into pool page dst for
        each (i, dst) of ``moves``; a replicated pool under a mesh
        gathers every rank's heads into it."""
        p = self.page
        for i, dst in moves:
            for f in self._fields:
                src = cache[f][:, slot, i * p:(i + 1) * p]
                if self.replicated:
                    src = self._gather(src[:, None], 3)[:, 0]
                self.pool[f][:, dst].copy_(src)

    def _alloc(self) -> Optional[int]:
        if self._free:
            return self._free.pop()
        victim, best = None, None
        for i, h in enumerate(self._hash_of):
            if h is None or self._refs[i] > 0:
                continue
            if best is None or self._stamp[i] < best:
                victim, best = i, self._stamp[i]
        if victim is None:
            return None            # every occupied page is pinned
        del self._by_hash[self._hash_of[victim]]
        self._hash_of[victim] = None
        self.evictions += 1
        self.version += 1
        _M_EVICTIONS.inc()
        return victim

    def _touch(self, idx: int) -> None:
        self._tick += 1
        self._stamp[idx] = self._tick

    # ------------------------------------------------------ transfer
    def page_signature(self) -> Dict[str, Any]:
        """Wire-compat signature of this pool's page blocks
        (serve/kv_transfer.py): page size plus per-field dtype and
        block shape ``[n_layers, 1, page, ...]``, equal to a JAX pool's
        of the same model and cache dtype."""
        return {
            'page': self.page,
            'fields': {
                f: {'dtype': _DTYPE_NAMES[self.pool[f].dtype],
                    'shape': list(self._block_shape[:4 if 'scale' in f
                                                    else 5])}
                for f in self._fields},
        }

    def _host(self, t: torch.Tensor) -> torch.Tensor:
        """A host copy of ``t``, on the engine's stream."""
        if self._stream is not None:
            with torch.cuda.stream(self._stream):
                return t.cpu()
        return t.clone(memory_format=torch.contiguous_format)

    def _gather(self, t: torch.Tensor, head_dim: int) -> torch.Tensor:
        """Every rank's heads of ``t`` (this rank's [.., n, ..] on axis
        ``head_dim``) as the whole [.., n_kv_heads, ..], on every rank:
        each rank places its heads' bits, widened to int32, in zeros, and
        the sum over the control group is exact. Returned on ``t``'s
        device."""
        h0, n = self.heads
        full = list(t.shape)
        full[head_dim] = self._block_shape[3]
        bits = torch.zeros(full, dtype=torch.int32)
        host = self._host(t)
        if host.dtype == torch.float32:
            wide = host.view(torch.int32)
        else:
            wide = host.view({2: torch.int16, 1: torch.int8}[
                host.element_size()]).to(torch.int32)
        bits.narrow(head_dim, h0, n).copy_(wide)
        torch.distributed.all_reduce(bits, group=self.mesh.ctrl_group)
        if t.dtype == torch.float32:
            out = bits.view(torch.float32)
        else:
            narrow = {2: torch.int16, 1: torch.int8}[t.element_size()]
            out = bits.to(narrow).view(t.dtype)
        return out.to(t.device)

    def _read_page(self, idx: int) -> Dict[str, np.ndarray]:
        """Host copy of pool page ``idx`` as wire arrays (bf16 as its
        uint16 bits), copied on the engine's stream; every rank's heads
        gathered where the pool is sharded over a mesh (each rank runs
        this for the same ``idx``)."""
        out = {}
        with self.op('export', idx):
            for f in self._fields:
                t = self.pool[f][:, idx:idx + 1]
                if self.mesh is not None and self.mesh.tp > 1 and \
                        not self.replicated:
                    host = self._gather(t, 3).cpu()
                else:
                    host = self._host(t)
                if host.dtype == torch.bfloat16:
                    host = host.view(torch.int16)
                arr = host.numpy()
                out[f] = arr.view(np.uint16) if arr.dtype == np.int16 \
                    else arr
        return out

    def export_page(self, h: bytes
                    ) -> Optional[Dict[str, np.ndarray]]:
        """Host copy of the pool page for chain hash ``h`` (None on a
        miss). Safe from other threads against a publishing engine:
        the pool is written in place, so a page evicted and rewritten
        while this read walks it would tear. Every write to a mapped
        page follows an eviction that bumps ``version``, so the
        directory (version and mapping) is checked before AND after
        the copy, and the copy retried (bounded) when it moved. A page
        that cannot be read consistently is reported as a miss."""
        for _ in range(3):
            version = self.version
            idx = self._by_hash.get(h)
            if idx is None:
                return None
            blk = self._read_page(idx)
            if self.version == version and self._by_hash.get(h) == idx:
                return blk
        return None

    def import_pages(
            self,
            items: Sequence[Tuple[bytes, Dict[str, np.ndarray]]]
    ) -> int:
        """Land fetched remote pages into the pool (dedup by hash;
        ENGINE THREAD ONLY — this mutates the pool and directory
        exactly like publish). bf16 fields come as uint16 bits (the
        codec's ``decode``) or as ml_dtypes bfloat16 arrays. A block
        whose shape disagrees with the pool's raises. Stops at the
        first allocation failure (every page pinned). Returns the
        number of pages imported."""
        imported = 0
        landed = []
        for h, blk in items:
            if h in self._by_hash:
                self._touch(self._by_hash[h])
                continue
            wire = {f: blk[f] for f in self._fields}
            dev = {f: self._to_pool(f, wire[f]) for f in self._fields}
            dst = self._alloc()
            if dst is None:
                logger.debug(
                    'Prefix pool exhausted (all %d pages pinned): '
                    'dropping remaining KV import(s).', self.pool_pages)
                break
            self.write_page(dst, dev)
            landed.append((dst, wire))
            self._by_hash[h] = dst
            self._hash_of[dst] = h
            self._refs[dst] = 0
            self._touch(dst)
            self.version += 1
            imported += 1
        if imported:
            with self.op('import', landed):
                pass
            _M_IMPORTED.inc(imported)
            _M_POOL.set(len(self._by_hash))
        return imported

    def write_page(self, dst: int, dev: Dict[str, torch.Tensor]) -> None:
        """Land one page's fields (``_to_pool``'s tensors) at pool page
        ``dst``."""
        for f in self._fields:
            self.pool[f][:, dst:dst + 1].copy_(
                dev[f], non_blocking=dev[f].is_pinned())

    def _to_pool(self, f: str, arr: Any) -> torch.Tensor:
        """One page field (every head) as a host tensor in the pool's
        dtype, cut to the heads this rank's pool holds (pinned on the
        card, so its copy does not stall the host)."""
        # A copy: decoded pages are read-only views of the payload.
        wire = np.array(kv_transfer.as_wire_array(
            arr, _DTYPE_NAMES[self.pool[f].dtype]), order='C')
        if wire.dtype == np.uint16:
            src = torch.from_numpy(wire.view(np.int16)).view(torch.bfloat16)
        else:
            src = torch.from_numpy(wire)
        want = self._block_shape[:4 if 'scale' in f else 5]
        if tuple(src.shape) != want:
            raise ValueError(f'page field {f!r} has shape '
                             f'{tuple(src.shape)}, the pool wants '
                             f'{tuple(want)}')
        if not self.replicated and src.shape[3] != self.heads[1]:
            src = src.narrow(3, *self.heads).contiguous()
        return src.pin_memory() if self._stream is not None else src

    def prefix_summary(self,
                       sample: Optional[int] = None) -> Dict[str, Any]:
        """Versioned directory digest for /health: occupied-page count,
        page size, the directory ``version``, and a recency-ordered
        bounded hash list with an explicit ``truncated`` flag. Memoized
        on the directory version. Pure host read."""
        if sample is None:
            sample = summary_pages()
        sample = max(0, int(sample))
        version = self.version
        cached = self._summary_cache
        if (cached is not None and cached[0] == version
                and cached[1] == sample):
            return cached[2]
        occupied = [(self._stamp[i], h)
                    for i, h in enumerate(self._hash_of)
                    if h is not None]
        occupied.sort(reverse=True)
        summary = {
            'v': chain_hash.SUMMARY_SCHEMA_VERSION,
            'version': version,
            'pages': len(self._by_hash),
            'page': self.page,
            'hashes': [h.hex() for _, h in occupied[:sample]],
            'truncated': len(occupied) > sample,
        }
        self._summary_cache = (version, sample, summary)
        return summary

    def stats(self) -> Dict[str, Any]:
        """Flat summary of the pool and its lookups."""
        return {
            'page': self.page,
            'pool_pages': self.pool_pages,
            'occupied': len(self._by_hash),
            'pinned': self.pinned_pages(),
            'lookups': self.lookups,
            'hits': self.hits,
            'hit_rate': (round(self.hits / self.lookups, 4)
                         if self.lookups else None),
            'tokens_saved': self.tokens_saved,
            'evictions': self.evictions,
        }
