"""Q1's launch plan (``skypilot_tpu_torch/ops/int8_matmul.py::plan``)
on the CPU: plain Python, so every shape the card meets is checked here.

For the Llama-3.1-8B and tpu_1b leaves, their lm_heads and ragged
shapes, at M 1, 8, 16, 17, 40, 128, 129, 256, 300 and 512 on an H100's
132 SMs:

- the grid covers the output (columns and rows), every split of K is
  non-empty and there are no more splits than K slabs;
- the scratch covers the grid: one f32 partial per split, output tile
  and accumulator, one arrival counter per output tile, both none
  without a split, and no more counters than ``split_kv.reserve`` holds
  by default;
- every M takes the wgmma route, M <= 16 too (faster there on the
  card, PERF.md's Q1 table), and a shape a tensor map cannot take
  (N % 16 != 0 or a misaligned q) the mma.sync route; asking for the
  wgmma route there raises;
- no plan's partials exceed the weight's bytes (at M 256 on the 8B
  leaves, where they would cost more than the weight itself).

Then the index arithmetic the wgmma route rests on, rehearsed in numpy:
the ldmatrix .trans registers of a 128-byte-swizzled int8 tile, turned
into bf16 pairs (int8_pairs_to_bf16), are exactly the A fragments of
q^T with rows interleaved even, odd; placed by the PTX ISA's register
layouts of wgmma .m64nNk16 (A from registers, the f32 accumulator D),
they make products that the kernel's epilogue map turns back into y;
and the split partials' fragment-order layout gives every (split,
tile, accumulator, thread) its own float.
"""
import numpy as np
import pytest

from skypilot_tpu_torch.ops import int8_matmul as tim
from skypilot_tpu_torch.ops import split_kv

N_SM = 132
LEAVES = {
    '8b wq/wo': (4096, 4096), '8b wk/wv': (4096, 1024),
    '8b w_gate/w_up': (4096, 14336), '8b w_down': (14336, 4096),
    '8b lm_head': (4096, 128256),
    '1b wq/wo': (2048, 2048), '1b wk/wv': (2048, 1024),
    '1b w_gate/w_up': (2048, 8192), '1b w_down': (8192, 2048),
    '1b lm_head': (2048, 128256),
    'ragged N 1000': (4096, 1000), 'K 72': (72, 48), 'K 72, N 40': (72, 40),
    'K 64, N 48': (64, 48),
}
ROWS = (1, 8, 16, 17, 40, 128, 129, 256, 300, 512)


def _cdiv(a, b):
    return -(-a // b)


@pytest.mark.parametrize('m', ROWS)
@pytest.mark.parametrize('leaf', sorted(LEAVES))
def test_plan_covers_the_output_and_its_scratch(leaf, m):
    k, n = LEAVES[leaf]
    tma_ok = n % 16 == 0
    p = tim.plan(m, k, n, N_SM, tma_ok)
    slabs = _cdiv(k, tim.SLAB)
    cols, rows, splits = p.grid
    assert p.route == ('wgmma' if tma_ok else 'mma')
    assert p.m_tile in (tim.TOKEN_TILES if p.route == 'wgmma'
                        else (tim.MMA_TILE,))
    assert cols * tim.COLUMNS >= n > (cols - 1) * tim.COLUMNS
    assert rows * p.m_tile >= m > (rows - 1) * p.m_tile
    assert splits == p.splits <= slabs
    # Split z takes slabs [z * per, (z + 1) * per): all of K, none empty.
    assert splits * p.slabs_per_split >= slabs
    assert (splits - 1) * p.slabs_per_split < slabs
    if splits > 1:
        assert p.counters == cols * rows <= split_kv.MIN_COUNTERS
        assert p.partial_floats == cols * rows * splits * p.m_tile * \
            tim.COLUMNS
    else:
        assert p.counters == 0 and p.partial_floats == 0
    assert 4 * p.partial_floats <= k * n


@pytest.mark.parametrize('leaf', ['8b wq/wo', '8b wk/wv', '8b w_gate/w_up',
                                  '8b w_down'])
def test_prefill_plans_keep_partials_within_the_weight(leaf):
    k, n = LEAVES[leaf]
    p = tim.plan(256, k, n, N_SM)
    assert p.route == 'wgmma'
    assert p.splits == 1 or 4 * p.partial_floats <= k * n
    # The grid fills at least three quarters of the SMs.
    assert 4 * p.grid[0] * p.grid[1] * p.grid[2] >= 3 * N_SM


@pytest.mark.parametrize('m', (1, 8, 16, 17, 256))
def test_routes_follow_the_operands(m):
    k, n = LEAVES['8b wq/wo']
    assert tim.plan(m, k, n, N_SM, tma_ok=False).route == 'mma'
    assert tim.plan(m, k, n, N_SM, route='mma').route == 'mma'
    assert tim.plan(m, k, n, N_SM, route='wgmma').route == 'wgmma'
    with pytest.raises(ValueError, match='multiple of 16'):
        tim.plan(m, k, n, N_SM, tma_ok=False, route='wgmma')
    with pytest.raises(ValueError, match='unknown'):
        tim.plan(m, k, n, N_SM, route='hmma')


def _bf16_pairs(w):
    """int8_pairs_to_bf16 on uint32 words: (even, odd) as pairs of
    floats (low half, high half); bf16 holds |q| <= 128 exactly."""
    b = [((w >> (8 * i)) & 0xFF).astype(np.uint8).view(np.int8)
         .astype(np.float32) for i in range(4)]
    return (b[0], b[2]), (b[1], b[3])


def _ptx_a_place(lane, reg):
    """PTX ISA, wgmma .m64nNk16 with A from registers (16-bit types):
    (row within the warp's 16 rows, first k of the pair) of A register
    ``reg`` of ``lane``."""
    g, t = divmod(lane, 4)
    return g + 8 * (reg & 1), 2 * t + 8 * (reg >> 1)


def _ptx_d_place(lane, i):
    """PTX ISA, wgmma .m64nNk16 f32 accumulator D: (row within the
    warp's 16 rows, column) of D register ``i`` of ``lane``."""
    g, t = divmod(lane, 4)
    return g + 8 * ((i >> 1) & 1), 8 * (i >> 2) + 2 * t + (i & 1)


def test_wgmma_fragments_of_a_swizzled_int8_tile_rebuild_the_product():
    rng = np.random.default_rng(0)
    q = rng.integers(-127, 128, (64, 128), dtype=np.int8)  # [k][n] slab
    x = rng.standard_normal((16, 64))                      # [m][k]
    # The TMA tile: row k at 128 k, 16-byte unit u at (u ^ (k % 8)).
    tile = np.zeros(64 * 128, np.uint8)
    for k in range(64):
        for u in range(8):
            dst = k * 128 + ((u ^ (k % 8)) << 4)
            tile[dst:dst + 16] = q[k, 16 * u:16 * u + 16].view(np.uint8)
    # A of each warpgroup and k-step, as the ISA reads the registers.
    a_mat = np.full((2, 4, 64, 16), np.nan)  # [wg][ks][row][k]
    for wg in range(2):
        for w in range(4):
            unit = wg * 4 + w
            for kp in range(2):
                # ldmatrix.x4.trans: lane l addresses row 32 kp + l; the
                # lane's register i holds b16 elements (row 2t, 2t + 1 of
                # matrix i; column g), bytes (k, n), (k, n + 1), ...
                rows = [kp * 32 + i * 8 + r for i in range(4)
                        for r in range(8)]
                addr = [r * 128 + ((unit ^ (r % 8)) << 4) for r in rows]
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    regs = []
                    for i in range(4):
                        lo = addr[8 * i + 2 * t] + 2 * g
                        hi = addr[8 * i + 2 * t + 1] + 2 * g
                        b = [int(v) for v in (tile[lo], tile[lo + 1],
                                              tile[hi], tile[hi + 1])]
                        regs.append(np.array(
                            b[0] | b[1] << 8 | b[2] << 16 | b[3] << 24,
                            np.uint32))
                    for h in range(2):
                        ks = 2 * kp + h
                        even, odd = _bf16_pairs(regs[2 * h])
                        even8, odd8 = _bf16_pairs(regs[2 * h + 1])
                        # Columns 2 g (even) and 2 g + 1 (odd) of the
                        # warp's 16, k 2t, 2t + 1 and 2t + 8, 2t + 9.
                        col = 16 * unit + 2 * g
                        k0 = 16 * ks + 2 * t
                        assert even + even8 == tuple(
                            q[[k0, k0 + 1, k0 + 8, k0 + 9], col])
                        assert odd + odd8 == tuple(
                            q[[k0, k0 + 1, k0 + 8, k0 + 9], col + 1])
                        # The kernel's A registers a[ks][0..3].
                        for reg, pair in enumerate((even, odd, even8,
                                                    odd8)):
                            row, kk = _ptx_a_place(lane, reg)
                            a_mat[wg, ks, 16 * w + row, kk:kk + 2] = pair
    assert not np.isnan(a_mat).any()
    # D = sum over k-steps of A (64 x 16) B (16 x 16 tokens: x^T), into
    # the registers the ISA gives each thread.
    acc = np.zeros((2, 4, 32, 8))  # [wg][warp][lane][regs]
    for wg in range(2):
        d = sum(a_mat[wg, ks] @ x[:, 16 * ks:16 * ks + 16].T
                for ks in range(4))
        for w in range(4):
            for lane in range(32):
                for i in range(8):
                    row, col = _ptx_d_place(lane, i)
                    acc[wg, w, lane, i] = d[16 * w + row, col]
    # The kernel's epilogue: acc[4 j + e] is y[8 j + 2 t + e][n],
    # acc[4 j + 2 + e] is y[8 j + 2 t + e][n + 1], n = 64 wg + 16 w + 2 g.
    y = np.full((16, 128), np.nan)
    for wg in range(2):
        for w in range(4):
            for lane in range(32):
                g, t = lane // 4, lane % 4
                n = 64 * wg + 16 * w + 2 * g
                for j in range(2):
                    for e in range(2):
                        mm = 8 * j + 2 * t + e
                        y[mm, n] = acc[wg, w, lane, 4 * j + e]
                        y[mm, n + 1] = acc[wg, w, lane, 4 * j + 2 + e]
    np.testing.assert_allclose(y, x @ q.astype(np.float64), rtol=1e-5,
                               atol=1e-4)


@pytest.mark.parametrize('route,m', [('wgmma', 40), ('wgmma', 256),
                                     ('mma', 8)])
def test_split_partials_give_each_float_its_own_place(route, m):
    k, n = LEAVES['8b wk/wv']
    p = tim.plan(m, k, n, N_SM, route=route)
    assert p.splits > 1
    cols, rows, splits = p.grid
    threads = 256
    regs = p.m_tile * tim.COLUMNS // threads   # accumulator floats a thread
    seen = np.zeros(p.partial_floats, np.int32)
    for tile in range(cols * rows):
        base = tile * splits * (regs // 4) * threads
        for z in range(splits):
            for j in range(regs // 4):
                idx = base + (z * (regs // 4) + j) * threads + \
                    np.arange(threads)
                seen[4 * idx[:, None] + np.arange(4)] += 1
    assert (seen == 1).all()
