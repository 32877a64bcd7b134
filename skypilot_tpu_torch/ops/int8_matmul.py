"""Q1: the product of activations with an int8 weight,
``y = (x @ q) * s``.

x [M, K] (bf16 or f32), q [K, N] int8 (the reference's [in, out]
layout), s [N] f32 (the per-output-channel scale). The reference's
``qdot`` (``skypilot_tpu/models/quantization.py``) leaves this product
to XLA, which fuses the int8 -> bf16 convert into the dot's operand
read; PyTorch has no such fusion (``torch.matmul(x, q.to(bf16))``
writes a bf16 copy of the weight on every call), so the port carries
the fusion as a hand-written kernel, ``csrc/int8_matmul.cu``.
``int8_matmul_reference`` is its plain PyTorch version;
``int8_matmul`` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors — no other switch, no fallback. The dtype of x
picks the kernel's route: f32 the CUDA-core one; bf16 a tensor-core one,
which ``plan`` picks from the operands (wgmma, TMA-fed, where a tensor
map takes q; mma.sync otherwise) along with its tile and its split of K.
Every launch counts under ``int8_matmul`` and under its route,
``int8_matmul.f32``, ``.wgmma`` or ``.mma``.

Rounding (both versions): a bf16 x with no ``out_dtype`` gives the f32
sum rounded to bf16, times the scale rounded to bf16, rounded again
(the reference's bf16 matmul, then ``* s.astype(bf16)``); with
``out_dtype=torch.float32`` (the lm_head's ``preferred``) the f32 sum
times the f32 scale, rounded nowhere. A f32 x gives f32.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from skypilot_tpu_torch.ops import _build, split_kv

KERNEL = 'int8_matmul'
SLAB = 64        # K rows per slab of both bf16 routes (kBk)
COLUMNS = 128    # output columns per block (kBn)
# The wgmma route's token tiles. 256 would hold a prefill chunk in one
# tile, but its 128 accumulators a thread leave ptxas too few registers
# to pipeline the wgmmas: two tiles of 128 measured as fast (PERF.md).
TOKEN_TILES = (8, 16, 32, 64, 128)
MMA_TILE = 64    # the mma.sync route's row block
MIN_SPLIT_SLABS = 4  # K slabs a split takes at least
ROUTES = {'mma': 1, 'wgmma': 2}   # the C interface's route numbers


@dataclasses.dataclass(frozen=True)
class Plan:
    """One bf16 launch of Q1: the route ('wgmma' or 'mma'), its M tile
    (the wgmma route's token tile, the mma.sync route's row block), the
    splits of K and the slabs each takes, the grid (column blocks, M
    tiles, splits), and the scratch a split launch needs: f32 partials
    (one per split, output tile and accumulator) and one int32 arrival
    counter per output tile (none without a split)."""
    route: str
    m_tile: int
    splits: int
    slabs_per_split: int
    grid: Tuple[int, int, int]
    partial_floats: int
    counters: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def takes_tensor_map(q: torch.Tensor) -> bool:
    """Whether the wgmma route's tensor map takes the weight q [K, N]:
    rows of whole 16-byte units (N % 16 == 0) from a 16-byte-aligned
    address."""
    return q.shape[1] % 16 == 0 and q.data_ptr() % 16 == 0


def plan(m: int, k: int, n: int, n_sm: int, tma_ok: bool = True,
         route: Optional[str] = None) -> Plan:
    """The launch of a bf16 ``[m, k] @ [k, n]`` on a card of ``n_sm``
    SMs. ``tma_ok``: ``takes_tensor_map(q)``; ``route`` forces a route
    (None plans it: wgmma where a tensor map takes q, mma.sync
    elsewhere). The wgmma route is the faster at every M the main path
    gives Q1, decode's 8 rows and the lm_head included (PERF.md, Q1
    table); the mma.sync route serves only a q no tensor map takes, with
    one row block of MMA_TILE.

    The wgmma route's token tile is the smallest of TOKEN_TILES holding
    min(m, 128) rows, halved (down to 64) while the output tiles, even
    split, would leave more than a quarter of the SMs idle: each halving
    reads the weight once more (from L2) and converts it once more. On
    both routes K is split where the output tiles are fewer than the
    SMs, each split taking at least MIN_SPLIT_SLABS slabs of 64 and none
    empty, and never so far that the f32 partials (S x the tiles' rows x
    columns x 4 bytes) exceed the weight's k x n bytes."""
    if route is None:
        route = 'wgmma' if tma_ok else 'mma'
    if route not in ROUTES:
        raise ValueError(f'unknown Q1 route {route!r}')
    if route == 'wgmma' and not tma_ok:
        raise ValueError('the wgmma route takes N a multiple of 16 and q '
                         'aligned to 16 bytes')
    slabs = _cdiv(k, SLAB)
    cols = _cdiv(n, COLUMNS)

    def split_for(tile):
        rows = _cdiv(m, tile)
        cap = max(1, min(slabs // MIN_SPLIT_SLABS,
                         k * n // (4 * rows * tile * cols * COLUMNS)))
        return cols * rows, max(1, min(n_sm // (cols * rows), cap))

    if route == 'mma':
        tile = MMA_TILE
        blocks, split = split_for(tile)
    else:
        tile = next(t for t in TOKEN_TILES if t >= min(m, TOKEN_TILES[-1]))
        while True:
            blocks, split = split_for(tile)
            if 4 * blocks * split >= 3 * n_sm or tile <= 64:
                break
            tile //= 2
    per = _cdiv(slabs, split)
    split = _cdiv(slabs, per)
    tiles = blocks if split > 1 else 0
    return Plan(route=route, m_tile=tile, splits=split, slabs_per_split=per,
                grid=(cols, _cdiv(m, tile), split),
                partial_floats=tiles * split * tile * COLUMNS,
                counters=tiles)


def int8_matmul_reference(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                          out_dtype: Optional[torch.dtype] = None
                          ) -> torch.Tensor:
    """Plain PyTorch version of Q1 (same rounding; the sum in f32, as
    the kernel's, so the bf16 rounding of the sum is the only one the
    two versions may place differently)."""
    y = torch.matmul(x.float(), q.float())
    if out_dtype == torch.float32 or x.dtype == torch.float32:
        return y * s.float()
    return y.to(x.dtype) * s.to(x.dtype)


def _check_cuda_args(x, q, s, out_dtype):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'x must be float32 or bfloat16, got {x.dtype}')
    if q.dtype != torch.int8:
        raise TypeError(f'q must be int8, got {q.dtype}')
    if s.dtype != torch.float32:
        raise TypeError(f's must be float32, got {s.dtype}')
    if out_dtype not in (None, torch.float32, x.dtype):
        raise TypeError(f'out_dtype {out_dtype} for a {x.dtype} x')
    if x.dim() != 2 or q.dim() != 2 or s.dim() != 1 or \
            x.shape[1] != q.shape[0] or s.shape[0] != q.shape[1]:
        raise ValueError(f'shapes x {tuple(x.shape)}, q {tuple(q.shape)}, '
                         f's {tuple(s.shape)} do not form [M, K] @ [K, N] '
                         '* [N]')
    for t in (x, q, s):
        if t.device != x.device:
            raise ValueError('x, q and s must be on one CUDA device')
        if not t.is_contiguous():
            raise ValueError('x, q and s must be contiguous')
    if x.dtype == torch.bfloat16 and (x.shape[1] % 8 or x.data_ptr() % 16):
        raise ValueError('the bf16 route takes K a multiple of 8 and x '
                         'aligned to 16 bytes')


def _int8_matmul_cuda(x, q, s, out_dtype, route=None):
    """The kernel on CUDA tensors; ``route`` forces a bf16 route (see
    ``plan``; chip_smoke.py 11a times both at small M)."""
    _check_cuda_args(x, q, s, out_dtype)
    m, k = x.shape
    n = q.shape[1]
    bf16 = x.dtype == torch.bfloat16
    out_f32 = not bf16 or out_dtype == torch.float32
    P, I = ctypes.c_void_p, ctypes.c_int
    fn = _build.function(KERNEL, 'int8_matmul', [P] * 6 + [I] * 8 + [P])
    out = torch.empty((m, n), dtype=torch.float32 if out_f32 else x.dtype,
                      device=x.device)
    launch = None
    partial = counters = None
    if bf16:
        launch = plan(m, k, n, split_kv.sm_count(x.device),
                      takes_tensor_map(q), route)
        if launch.splits > 1:
            partial = torch.empty(launch.partial_floats, dtype=torch.float32,
                                  device=x.device)
            counters = split_kv.reserve(x.device, launch.counters)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
                None if partial is None else partial.data_ptr(),
                None if counters is None else counters.data_ptr(), m, k, n,
                int(bf16), int(out_f32),
                ROUTES[launch.route] if launch else 0,
                launch.m_tile if launch else 0,
                launch.splits if launch else 1, stream)
    _build.check(status, KERNEL)
    _build.LAUNCHES[KERNEL] += 1
    _build.LAUNCHES[f'{KERNEL}.{launch.route if launch else "f32"}'] += 1
    return out


def int8_matmul(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """``(x @ q) * s`` for x [M, K], q [K, N] int8, s [N] f32; returns
    [M, N] in ``out_dtype`` (default x's dtype). CUDA tensors run the
    hand-written kernel (a tensor it does not take raises); CPU tensors
    run ``int8_matmul_reference``."""
    if x.is_cuda:
        return _int8_matmul_cuda(x, q, s, out_dtype)
    return int8_matmul_reference(x, q, s, out_dtype)
