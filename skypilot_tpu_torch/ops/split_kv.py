"""Launch geometry and scratch of the split-KV kernels: the bf16 routes
of K1 (``csrc/paged_decode.cu``) and K3 (``csrc/verify_attention.cu``),
both built on ``csrc/split_kv.cuh``.

Each (row, kv head) of such a call is split into ``n_split`` blocks.
The kernels cut a row's live keys (the columns it may read, in column
order, wherever they sit) into 64-key tiles, and block i takes the tiles
``split_ranges(n_live_tiles, split_tiles, n_split)[i]``. ``split_tiles``
comes from the launch's fixed shape (``tiles_per_split``), never from
the columns dispatched, so a row's reduction order, and its rounding,
follows its own keys alone: a schedule that writes them at other
columns, or dispatches more columns, gives the same bits. Every block
writes an unnormalised f32
partial (m, l, acc) into scratch the wrapper allocates with
``torch.empty``; the last block of a (row, kv head) to arrive, counted
in an int32 counter, merges the partials in split order and resets its
counter to 0. The counters are allocated zeroed once per device, outside
any CUDA graph capture (``reserve``, or the first ``workspace`` call),
and kept, so no call clears anything and a captured launch never owns
them: the kernels' own reset makes one buffer safe for every launch on
a device, as long as those launches are ordered (one stream at a
time, as the engine's ticks and their replays are).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

TILE = 64                 # cache columns per tile (split_kv::kBk)
MAX_ROWS_PER_BLOCK = 128  # query rows of a K3 block (split_kv::kMaxRows)
MAX_SPLIT = 64            # splits the merge holds (split_kv::kMaxSplit)
RUN_TILES = 16            # live-key tiles a block takes at most

MIN_COUNTERS = 1024       # counters allocated at least (slots per launch)

_counters: Dict[torch.device, torch.Tensor] = {}
_sm_counts: Dict[torch.device, int] = {}


def tiles_per_split(slots: int, s_tiles: int, n_sm: int) -> int:
    """Live-key tiles a block takes, from the launch's fixed shape only:
    ``slots`` (row, kv head) pairs over a cache of ``s_tiles`` 64-column
    tiles. A full cache is cut into as many splits as keep the grid
    within four blocks per SM (two waves: the kernels' shared memory
    holds two blocks on an SM), and into runs of at most RUN_TILES tiles
    (1,024 keys) besides; no more than one split per tile or MAX_SPLIT,
    and at least one; a shorter live run takes fewer. The runs' cap is
    for a serving batch, whose rows hold far fewer keys than the cache
    and are mostly idle: a few live rows then fill few SMs, and their
    longest walk, not the grid's size, sets the launch's time (K1 at
    the Mistral-7B chat engine's decode shape, 16 of 64 rows live: 82
    us a launch against 178 with one run a row; all 64 live: 234
    against 266)."""
    n = max(1, min(max(4 * n_sm // max(1, slots), -(-s_tiles // RUN_TILES)),
                   s_tiles, MAX_SPLIT))
    return max(1, -(-s_tiles // n))


def split_count(n_tiles: int, split_tiles: int) -> int:
    """Blocks per (row, kv head) for ``n_tiles`` dispatched 64-column
    tiles: enough that their runs of ``split_tiles`` cover every live
    key the call may read."""
    return max(1, -(-n_tiles // split_tiles))


def split_ranges(n_live_tiles: int, split_tiles: int,
                 n_split: int) -> List[Tuple[int, int]]:
    """The live-key tile range [t0, t1) of each split, in split order:
    runs of ``split_tiles``, cut at ``n_live_tiles``, empty past it (as
    split_kv::attend cuts them)."""
    return [(min(i * split_tiles, n_live_tiles),
             min((i + 1) * split_tiles, n_live_tiles))
            for i in range(n_split)]


def rows_per_block(rows: int) -> int:
    """Query rows a K3 block holds: one 64-row warpgroup tile, or two
    where the segment's rows need more (wider segments take more
    blocks)."""
    return TILE if rows <= TILE else MAX_ROWS_PER_BLOCK


def sm_count(device: torch.device) -> int:
    n = _sm_counts.get(device)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _sm_counts[device] = n
    return n


def reserve(device: torch.device, slots: int = MIN_COUNTERS) -> torch.Tensor:
    """The int32 arrival counters of ``device``, at least ``slots`` long,
    allocated zeroed now if they are missing or short. Call it before a
    CUDA graph capture: inside one it raises rather than let the graph's
    private pool own them (and capture their memset)."""
    counters = _counters.get(device)
    if counters is None or counters.numel() < slots:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                f'split-KV counters for {slots} slots on {device} must be '
                'reserved before a CUDA graph capture (split_kv.reserve)')
        counters = torch.zeros(max(slots, MIN_COUNTERS), dtype=torch.int32,
                               device=device)
        _counters[device] = counters
    return counters


def workspace(device: torch.device, slots: int, n_split: int, rows: int,
              head_dim: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(ml, acc, counters) for one launch: f32 partials [slots, n_split,
    rows, 2] and [slots, n_split, rows, head_dim], uninitialised (views
    of one allocation, from the graph's pool under capture), and the
    int32 arrival counters of ``device`` (``reserve``), at least
    ``slots`` long, zero between launches (the kernels leave them so)."""
    n = slots * n_split * rows
    scratch = torch.empty(n * (2 + head_dim), dtype=torch.float32,
                          device=device)
    # acc first: the merge reads it as 16-byte float4s.
    acc, ml = scratch[:n * head_dim], scratch[n * head_dim:]
    return ml, acc, reserve(device, slots)
