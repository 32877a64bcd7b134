"""Launch geometry and scratch of the split-KV kernels: the bf16 routes
of K1 (``csrc/paged_decode.cu``) and K3 (``csrc/verify_attention.cu``),
both built on ``csrc/split_kv.cuh``.

Each (row, kv head) of such a call is split into ``n_split`` blocks,
block i taking the 64-column tiles ``split_ranges(n_tiles, n_split)[i]``
of the columns the call reads. Every block writes an unnormalised f32
partial (m, l, acc) into scratch the wrapper allocates with
``torch.empty``; the last block of a (row, kv head) to arrive, counted
in an int32 counter, merges the partials in split order and resets its
counter to 0. The counters are allocated zeroed once per device and
stream and kept (``workspace``), so no call clears anything.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch

TILE = 64                 # cache columns per tile (split_kv::kBk)
MAX_ROWS_PER_BLOCK = 128  # query rows of a K3 block (split_kv::kMaxRows)
MAX_SPLIT = 64            # splits the merge holds (split_kv::kMaxSplit)

_counters: Dict[Tuple[torch.device, int], torch.Tensor] = {}
_sm_counts: Dict[torch.device, int] = {}


def split_count(slots: int, n_tiles: int, n_sm: int) -> int:
    """Blocks per (row, kv head): as many as ``slots`` such pairs can
    take while all their blocks stay within two per SM (so the grid
    runs as one wave: the kernels' shared memory holds two or three
    blocks on an SM), but no more than one per tile or MAX_SPLIT, and
    at least one."""
    return max(1, min(2 * n_sm // max(1, slots), n_tiles, MAX_SPLIT))


def split_ranges(n_tiles: int, n_split: int) -> List[Tuple[int, int]]:
    """The tile range [t0, t1) of each split, in split order: contiguous,
    sizes differing by at most one, empty where n_tiles < n_split (as
    split_kv::split_begin cuts them)."""
    return [(n_tiles * i // n_split, n_tiles * (i + 1) // n_split)
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


def workspace(device: torch.device, stream: int, slots: int, n_split: int,
              rows: int, head_dim: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(ml, acc, counters) for one launch: f32 partials [slots, n_split,
    rows, 2] and [slots, n_split, rows, head_dim], uninitialised (views
    of one allocation), and the int32 arrival counters of ``stream`` on
    ``device``, at least ``slots`` long, zero between launches (the
    kernels leave them so)."""
    n = slots * n_split * rows
    scratch = torch.empty(n * (2 + head_dim), dtype=torch.float32,
                          device=device)
    # acc first: the merge reads it as 16-byte float4s.
    acc, ml = scratch[:n * head_dim], scratch[n * head_dim:]
    key = (device, stream)
    counters = _counters.get(key)
    if counters is None or counters.numel() < slots:
        counters = torch.zeros(max(slots, 1024), dtype=torch.int32,
                               device=device)
        _counters[key] = counters
    return ml, acc, counters
