"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on an NVIDIA GPU (``gpu`` marker; every test skips without
one). The file imports only torch and the port, so it also runs where
JAX is not installed:

    python -m pytest --noconftest -p no:cacheprovider \\
        tests/test_torch_kernels_gpu.py -q

K1 (paged decode) at Llama-3.1-8B decode shapes and its split edges
(one-tile rows, holes across split boundaries, bound-0 rows, one long
row split many ways), K2 (chunked prefill) at the engine's chunk shapes
and its edges (head_dim 16, 64 and 128, ragged C, offsets 0, 63, 64
and S - C, GQA 1, 4 and 8) and K3 (spec-decode verify) at the 8B verify
shapes and its edges (72 and 136 query rows per kv head, split edges),
NaN planted wherever a kernel may not read; K1's and K3's bf16 bits
unchanged when a row's live keys move to other cache columns (their
tiles are cut from the live keys), and K3's bits the same with each row
at its own segment start as at one shared start; an f32 engine with a 72-row
verify segment against spec-off; K4 (flash forward: o and lse) and
K5a/K5b (flash dQ and dK/dV) causal and not, with Sq < Sk, a ragged S
and every head_dim they take, on both routes (f32: CUDA cores; bf16:
tensor cores), the route each launch counts and the delta K5a hands to
K5b. Bars, element-wise: |kernel - plain| <= 1e-4 in f32; in bf16 and
int8, <= 1e-2 + 2^-7 |plain| (the TPU kernel's 1e-2 plus one bf16 step
of the value: the plain versions keep f32 inside and round once at the
end, or round the normalized probabilities, while a bf16 kernel rounds
the unnormalized P, and dS, to bf16 for its second products).
int8 scales keep the dequantized values within +-1. TF32 is off: the
plain versions' f32 products run in full f32.
"""
import pytest
import torch

from skypilot_tpu_torch.ops import _build
from skypilot_tpu_torch.ops import decode_attention as tda
from skypilot_tpu_torch.ops import flash_attention as tfa


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the CUDA kernels have no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _assert_within_bar(got, want, f32=False):
    err = (got.float() - want.float()).abs()
    bar = 1e-4 if f32 else 1e-2 + 2**-7 * want.float().abs()
    assert bool((err <= bar).all()), err.max().item()


def _scales(shape, gen, dev):
    return (torch.rand(shape, generator=gen, device=dev) * 0.007 +
            0.001).to(torch.bfloat16)


def _decode_inputs(dev, b, s, n_kv, rep, hd, page, num_pages, bounds,
                   holes, dtype, seed):
    """K1 inputs: row bounds ``bounds``, dmask holes ``holes`` (row,
    start, stop), NaN wherever the kernel may not read (past num_pages,
    past each row's bound, in the holes; in the scales for int8)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    qdt = torch.float32 if dtype == 'f32' else torch.bfloat16
    q = torch.randn((b, n_kv * rep, hd), generator=gen, device=dev).to(qdt)
    bounds = torch.tensor(bounds, dtype=torch.int32, device=dev)
    pos = torch.arange(s, device=dev)[None, :]
    valid = pos < bounds[:, None]
    for row, start, stop in holes:
        valid[row, start:stop] = False
    live_end = torch.clamp((bounds + page - 1) // page * page,
                           max=num_pages * page)
    readable = valid & (pos < live_end[:, None])
    ks = vs = None
    if dtype == 'int8':
        kc, vc = (torch.randint(-127, 128, (b, s, n_kv, hd), generator=gen,
                                device=dev, dtype=torch.int8)
                  for _ in range(2))
        ks, vs = (_scales((b, s, n_kv), gen, dev) for _ in range(2))
        ks[~readable] = float('nan')
        vs[~readable] = float('nan')
    else:
        kc, vc = (torch.randn((b, s, n_kv, hd), generator=gen,
                              device=dev).to(qdt) for _ in range(2))
        kc[~readable] = float('nan')
        vc[~readable] = float('nan')
    k_self, v_self = (torch.randn((b, n_kv, hd), generator=gen,
                                  device=dev).to(qdt) for _ in range(2))
    return q, kc, vc, valid, bounds, k_self, v_self, ks, vs


def _decode_check(args, page, num_pages, dtype):
    """K1 against its plain version; the launch counts its route."""
    _build.reset_launches()
    got = tda.paged_gqa_decode_attention(*args, page=page,
                                         num_pages=num_pages)
    want = tda.paged_decode_reference(*args, page=page, num_pages=num_pages)
    torch.cuda.synchronize()
    route = {tda.KERNEL: 1}
    if dtype != 'bf16':
        route[f'{tda.KERNEL}.{dtype}'] = 1
    assert dict(_build.LAUNCHES) == route
    assert torch.isfinite(got.float()).all()
    _assert_within_bar(got, want, f32=dtype == 'f32')


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', ['bf16', 'int8', 'f32'])
def test_paged_decode_kernel_matches_plain(cuda, dtype):
    args = _decode_inputs(cuda, 8, 512, 8, 4, 128, 128, 3,
                          [0, 1, 127, 128, 129, 300, 384, 512],
                          [(5, 200, 210)], dtype, 0)
    _decode_check(args, 128, 3, dtype)


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', ['bf16', 'int8'])
@pytest.mark.parametrize('b,s,bounds,holes,num_pages', [
    (4, 256, [1, 64, 0, 65], [], 2),
    (2, 8192, [8000, 0], [(0, 3000, 5100)], 64),
    (1, 8192, [8192], [(0, 2000, 2100)], 64),
    (8, 1024, [0] * 8, [], 8),
], ids=['one-tile-rows', 'hole-across-splits', 'one-row-many-splits',
        'all-empty'])
def test_paged_decode_split_edges(cuda, dtype, b, s, bounds, holes,
                                  num_pages):
    """The split kernel at its edges: rows of one tile (splits past them
    empty), a hole over whole splits and across split boundaries, one
    row split many ways, rows with bound 0 (every split empty: the self
    value), NaN past every frontier."""
    args = _decode_inputs(cuda, b, s, 8, 4, 128, 128, num_pages, bounds,
                          holes, dtype, b + s)
    _decode_check(args, 128, num_pages, dtype)


def _placed(dev, keys, prompts, starts, s):
    """A cache of ``s`` columns holding each row's live keys (``keys``:
    K, V [B, L, n_kv, hd] and the int8 scales [B, L, n_kv], or None) at
    its prompt columns [0, P) and the rest from column ``start`` on; NaN
    in every other column (0 in an int8 cache, NaN in its scales).
    Returns (kc, vc, valid, row_bound, k_scale, v_scale)."""
    b, n = keys[0].shape[:2]
    out = [None if x is None else torch.full(
        (b, s) + x.shape[2:], 0 if x.dtype == torch.int8 else float('nan'),
        dtype=x.dtype, device=dev) for x in keys]
    valid = torch.zeros((b, s), dtype=torch.bool, device=dev)
    for row, (p, c0) in enumerate(zip(prompts, starts)):
        cols = torch.cat([torch.arange(p), torch.arange(c0, c0 + n - p)])
        valid[row, cols.to(dev)] = True
        for dst, src in zip(out, keys):
            if dst is not None:
                dst[row, cols.to(dev)] = src[row]
    bound = torch.tensor([c0 + n - p for p, c0 in zip(prompts, starts)],
                         dtype=torch.int32, device=dev)
    kc, vc, ks, vs = out
    return kc, vc, valid, bound, ks, vs


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', ['f32', 'bf16', 'int8'])
def test_paged_decode_bits_follow_the_live_keys_alone(cuda, dtype):
    """K1's reduction order follows each row's own live keys: the same
    keys written at other decode columns (another serving schedule),
    read under other num_pages, in another batch order, give the same
    bits on the split route and on the f32 route, at Llama-3.1-8B's
    decode shape."""
    gen = torch.Generator(device=cuda).manual_seed(7)
    b, n_kv, rep, hd, s, page, live = 8, 8, 4, 128, 1024, 128, 540
    prompts = [386, 400, 430, 450, 470, 490, 505, 512]
    qdt = torch.float32 if dtype == 'f32' else torch.bfloat16
    q, k_self, v_self = (torch.randn(shape, generator=gen, device=cuda).to(
        qdt) for shape in ((b, n_kv * rep, hd), (b, n_kv, hd),
                           (b, n_kv, hd)))
    if dtype == 'int8':
        keys = [torch.randint(-127, 128, (b, live, n_kv, hd), generator=gen,
                              device=cuda, dtype=torch.int8)
                for _ in range(2)]
        keys += [_scales((b, live, n_kv), gen, cuda) for _ in range(2)]
    else:
        keys = [torch.randn((b, live, n_kv, hd), generator=gen,
                            device=cuda).to(qdt) * 3
                for _ in range(2)] + [None, None]
    outs = []
    for starts, num_pages, order in (
            ([512] * b, 6, list(range(b))),
            ([512 + 37 * i for i in range(b)], 8, list(range(b))),
            ([700 - 9 * i for i in range(b)], 8, list(range(b))[::-1])):
        kc, vc, valid, bound, ks, vs = _placed(cuda, keys, prompts, starts,
                                               s)
        perm = torch.tensor(order, device=cuda)
        pick = (lambda t: None if t is None else t[perm].contiguous())
        out = tda.paged_gqa_decode_attention(
            pick(q), pick(kc), pick(vc), pick(valid), pick(bound),
            pick(k_self), pick(v_self), pick(ks), pick(vs), page=page,
            num_pages=num_pages)
        outs.append(out[torch.argsort(perm)])
    torch.cuda.synchronize()
    assert torch.isfinite(outs[0].float()).all()
    for out in outs[1:]:
        assert torch.equal(out, outs[0])


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_verify_bits_follow_the_live_keys_alone(cuda, dtype):
    """K3's reduction order follows each row's own live keys as K1's
    does: the same keys and segment moved to other columns, read under
    another n_cols, give the same bits on the bf16 split route and on
    the f32 route."""
    gen = torch.Generator(device=cuda).manual_seed(8)
    b, vq, h, n_kv, hd, s = 4, 5, 32, 8, 128, 1024
    prompts, live = [300, 410, 450, 512], 560
    qdt = torch.float32 if dtype == 'f32' else torch.bfloat16
    q = torch.randn((b, vq, h, hd), generator=gen, device=cuda).to(qdt)
    keys = [torch.randn((b, live, n_kv, hd), generator=gen,
                        device=cuda).to(qdt) * 3
            for _ in range(2)]
    outs = []
    for seg, n_cols in ((600, 640), (700, 768), (900, 1024)):
        # Each row's decode keys run up to the segment, which holds its
        # last vq keys (dmask-false there: the segment's own columns).
        starts = [seg - (live - p - vq) for p in prompts]
        kc, vc, valid, _, _, _ = _placed(cuda, keys + [None, None],
                                         prompts, starts, s)
        valid[:, seg:] = False
        outs.append(tfa.verify_attention(q, kc, vc, valid, seg,
                                         n_cols=n_cols))
    torch.cuda.synchronize()
    assert torch.isfinite(outs[0].float()).all()
    for out in outs[1:]:
        assert torch.equal(out, outs[0])


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_verify_per_row_segment_starts_equal_a_shared_start(cuda, dtype):
    """K3 takes each row's own segment start ([B] int32 on the device,
    read per row): rows whose decode keys and segments sit at their own
    frontiers give the bits of the same keys and segments placed at one
    shared start, on the bf16 split route and on the f32 route, and the
    plain version agrees within the bar."""
    gen = torch.Generator(device=cuda).manual_seed(9)
    b, vq, h, n_kv, hd, s, n_cols = 4, 5, 32, 8, 128, 1024, 768
    prompts, live = [300, 410, 450, 512], 560
    qdt = torch.float32 if dtype == 'f32' else torch.bfloat16
    q = torch.randn((b, vq, h, hd), generator=gen, device=cuda).to(qdt)
    keys = [torch.randn((b, live, n_kv, hd), generator=gen,
                        device=cuda).to(qdt) * 3
            for _ in range(2)]
    cols = torch.arange(s, device=cuda)[None, :]
    outs = []
    for segs in ([600] * b, [560, 640, 600, 700]):
        # Each row's decode keys run up to its own segment, which holds
        # its last vq keys (dmask-false there).
        starts = [g - (live - p - vq) for g, p in zip(segs, prompts)]
        kc, vc, valid, _, _, _ = _placed(cuda, keys + [None, None],
                                         prompts, starts, s)
        seg = torch.tensor(segs, dtype=torch.int32, device=cuda)
        valid &= cols < seg[:, None]
        got = tfa.verify_attention(q, kc, vc, valid, seg, n_cols=n_cols)
        want = tfa.verify_attention_reference(
            q, kc[:, :n_cols], vc[:, :n_cols], valid[:, :n_cols], seg)
        torch.cuda.synchronize()
        assert torch.isfinite(got.float()).all()
        _assert_within_bar(got, want, f32=dtype == 'f32')
        outs.append(got)
    assert torch.equal(outs[1], outs[0])


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', ['f32', 'bf16', 'int8'])
def test_chunk_prefill_kernel_matches_plain(cuda, dtype):
    g, c, s, h, n_kv, d = 2, 128, 640, 32, 8, 128
    gen = torch.Generator(device=cuda).manual_seed(0)
    qdt = torch.float32 if dtype == 'f32' else torch.bfloat16
    q = torch.randn((g, c, h, d), generator=gen, device=cuda).to(qdt)
    off = torch.tensor([0, 384], dtype=torch.int32, device=cuda)
    dead = (off + c)[:, None] <= torch.arange(s, device=cuda)[None, :]
    ks = vs = None
    if dtype == 'int8':
        k = torch.randint(-127, 128, (g, s, n_kv, d), generator=gen,
                          device=cuda, dtype=torch.int8)
        v = torch.randint(-127, 128, (g, s, n_kv, d), generator=gen,
                          device=cuda, dtype=torch.int8)
        ks, vs = (_scales((g, s, n_kv), gen, cuda) for _ in range(2))
        ks[dead] = float('nan')
        vs[dead] = float('nan')
    else:
        k = torch.randn((g, s, n_kv, d), generator=gen, device=cuda).to(qdt)
        v = torch.randn((g, s, n_kv, d), generator=gen, device=cuda).to(qdt)
        k[dead] = float('nan')
        v[dead] = float('nan')
    _build.reset_launches()
    got = tfa.chunk_prefill_attention(q, k, v, off, ks, vs)
    want = tfa.chunk_attention_reference(q, k, v, off, ks, vs)
    torch.cuda.synchronize()
    assert _build.LAUNCHES[tfa.KERNEL] == 1
    assert torch.isfinite(got.float()).all()
    _assert_within_bar(got, want, f32=dtype == 'f32')


def _chunk_edge_inputs(dev, c, h, n_kv, d, s, dtype, seed):
    """Four chunk rows at offsets 0, 63, 64 and S - C; NaN in the cache
    from each row's frontier offset + C on (in the scales for int8)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    g = 4
    off = torch.tensor([0, 63, 64, s - c], dtype=torch.int32, device=dev)
    dead = (off + c)[:, None] <= torch.arange(s, device=dev)[None, :]
    q = torch.randn((g, c, h, d), generator=gen,
                    device=dev).to(torch.bfloat16)
    ks = vs = None
    if dtype == 'int8':
        k, v = (torch.randint(-127, 128, (g, s, n_kv, d), generator=gen,
                              device=dev, dtype=torch.int8)
                for _ in range(2))
        ks, vs = (_scales((g, s, n_kv), gen, dev) for _ in range(2))
        ks[dead] = float('nan')
        vs[dead] = float('nan')
    else:
        k, v = (torch.randn((g, s, n_kv, d), generator=gen,
                            device=dev).to(torch.bfloat16) for _ in range(2))
        k[dead] = float('nan')
        v[dead] = float('nan')
    return q, k, v, off, ks, vs


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', ['bf16', 'int8'])
@pytest.mark.parametrize('c,h,n_kv,d,s', [
    (40, 4, 4, 16, 300),
    (200, 16, 4, 64, 400),
    (40, 32, 4, 128, 256),
    (200, 16, 2, 128, 512),
], ids=['d16-c40-gqa1', 'd64-c200-gqa4', 'd128-c40-gqa8',
        'd128-c200-gqa8'])
def test_chunk_prefill_tensor_core_edges(cuda, dtype, c, h, n_kv, d, s):
    """The bf16 q route (tensor cores) on bf16 and int8 caches at its
    edges: C off the 64-row tile, rows whose frontier falls inside a
    key tile, at a tile edge and at the cache end, NaN past every
    frontier."""
    args = _chunk_edge_inputs(cuda, c, h, n_kv, d, s, dtype, c + d)
    _build.reset_launches()
    got = tfa.chunk_prefill_attention(*args)
    want = tfa.chunk_attention_reference(*args)
    torch.cuda.synchronize()
    want_launches = {tfa.KERNEL: 1}
    if dtype == 'int8':
        want_launches[tfa.KERNEL + '.int8'] = 1
    assert dict(_build.LAUNCHES) == want_launches
    assert torch.isfinite(got.float()).all()
    _assert_within_bar(got, want)


def _verify_inputs(dev, b, vq, h, n_kv, d, s, seg, dtype, gen):
    """Verify-kernel inputs: an inactive row (dmask all false), a
    recycled row with only a short prefix live, rejected-candidate holes
    among the decode columns, and NaN in every column no query may
    attend (the segment [seg, seg + vq) is live for every row)."""
    qdt = torch.float32 if dtype == 'f32' else torch.bfloat16
    q = torch.randn((b, vq, h, d), generator=gen, device=dev).to(qdt)
    cols = torch.arange(s, device=dev)[None, :]
    prompt = torch.randint(1, min(seg, 512) + 1, (b,), generator=gen,
                           device=dev)
    decode = (cols >= min(seg, 512)) & (cols < seg)
    valid = (cols < prompt[:, None]) | (decode & (cols % 5 != 3))
    valid[0] = False
    valid[1] = cols[0] < 7
    live = valid | ((cols >= seg) & (cols < seg + vq))
    ks = vs = None
    if dtype == 'int8':
        k = torch.randint(-127, 128, (b, s, n_kv, d), generator=gen,
                          device=dev, dtype=torch.int8)
        v = torch.randint(-127, 128, (b, s, n_kv, d), generator=gen,
                          device=dev, dtype=torch.int8)
        ks, vs = (_scales((b, s, n_kv), gen, dev) for _ in range(2))
        ks[~live] = float('nan')
        vs[~live] = float('nan')
    else:
        k = torch.randn((b, s, n_kv, d), generator=gen, device=dev).to(qdt)
        v = torch.randn((b, s, n_kv, d), generator=gen, device=dev).to(qdt)
        k[~live] = float('nan')
        v[~live] = float('nan')
    return q, k, v, valid, ks, vs


@pytest.mark.gpu
@pytest.mark.parametrize('b,vq,h,n_kv,d,s,seg,n_cols,dtype', [
    (8, 5, 32, 8, 128, 1024, 700, 768, 'f32'),
    (8, 5, 32, 8, 128, 1024, 700, 768, 'bf16'),
    (8, 5, 32, 8, 128, 1024, 700, 768, 'int8'),
    (2, 8, 16, 2, 128, 300, 250, None, 'bf16'),     # 64 rows per block
    (3, 1, 4, 4, 16, 40, 20, 33, 'f32'),            # V 1, tiny()'s D
    (2, 9, 4, 2, 64, 77, 60, None, 'f32'),          # S off the tile grid
], ids=['8b-f32', '8b-bf16', '8b-int8', 'rows64', 'v1-d16', 'ragged'])
def test_verify_kernel_matches_plain(cuda, b, vq, h, n_kv, d, s, seg, n_cols,
                                     dtype):
    gen = torch.Generator(device=cuda).manual_seed(seg)
    q, k, v, valid, ks, vs = _verify_inputs(cuda, b, vq, h, n_kv, d, s, seg,
                                            dtype, gen)
    _build.reset_launches()
    got = tfa.verify_attention(q, k, v, valid, seg, ks, vs, n_cols=n_cols)
    n = n_cols or s
    want = tfa.verify_attention_reference(
        q, k[:, :n], v[:, :n], valid[:, :n], seg,
        None if ks is None else ks[:, :n], None if vs is None else vs[:, :n])
    torch.cuda.synchronize()
    assert _build.LAUNCHES[tfa.VERIFY_KERNEL] == 1
    assert _build.LAUNCHES[tfa.VERIFY_KERNEL + '.int8'] == (dtype == 'int8')
    assert torch.isfinite(got.float()).all()
    _assert_within_bar(got, want, f32=dtype == 'f32')


@pytest.mark.gpu
def test_verify_kernel_rejects_what_it_does_not_take(cuda):
    """Any number of query rows is taken: 8 x 9 = 72 rows (two 64-row
    tiles in one bf16 block, two f32 row groups) and 8 x 17 = 136 rows
    (two bf16 row chunks, three f32 row groups) agree with the plain
    version on both routes. A float16 q is refused."""
    for h, n_kv, vq in ((16, 2, 9), (32, 4, 17)):
        for dtype in ('f32', 'bf16'):
            gen = torch.Generator(device=cuda).manual_seed(vq)
            q, k, v, valid, ks, vs = _verify_inputs(
                cuda, 2, vq, h, n_kv, 128, 320, 290, dtype, gen)
            _build.reset_launches()
            got = tfa.verify_attention(q, k, v, valid, 290)
            want = tfa.verify_attention_reference(q, k, v, valid, 290)
            torch.cuda.synchronize()
            assert _build.LAUNCHES[tfa.VERIFY_KERNEL + '.f32'] == \
                (dtype == 'f32')
            assert torch.isfinite(got.float()).all()
            _assert_within_bar(got, want, f32=dtype == 'f32')
    k = torch.zeros((1, 64, 2, 64), device=cuda)
    valid = torch.zeros((1, 64), dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError):
        tfa.verify_attention(torch.zeros((1, 4, 16, 64), device=cuda).to(
            torch.float16), k.to(torch.float16), k.to(torch.float16),
            valid, 10)


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', ['bf16', 'int8'])
@pytest.mark.parametrize('b,vq,s,seg,n_cols', [
    (2, 3, 64, 10, None),          # one tile
    (2, 5, 8192, 8000, None),      # few rows, each split many ways
    (8, 5, 8192, 6000, 6016),      # holes across split boundaries
], ids=['one-tile', 'few-rows-many-splits', 'holes-across-splits'])
def test_verify_split_edges(cuda, dtype, b, vq, s, seg, n_cols):
    """The split kernel at its edges: a single tile, two rows split many
    ways, decode columns with holes (every fifth column) across split
    boundaries, an inactive row (only its segment), NaN in every column
    no query may attend."""
    gen = torch.Generator(device=cuda).manual_seed(seg)
    q, k, v, valid, ks, vs = _verify_inputs(cuda, b, vq, 32, 8, 128, s, seg,
                                            dtype, gen)
    _build.reset_launches()
    got = tfa.verify_attention(q, k, v, valid, seg, ks, vs, n_cols=n_cols)
    n = n_cols or s
    cut = (lambda t: None if t is None else t[:, :n])
    want = tfa.verify_attention_reference(q, cut(k), cut(v), cut(valid),
                                          seg, cut(ks), cut(vs))
    torch.cuda.synchronize()
    assert _build.LAUNCHES[tfa.VERIFY_KERNEL] == 1
    assert _build.LAUNCHES[tfa.VERIFY_KERNEL + '.f32'] == 0
    assert torch.isfinite(got.float()).all()
    _assert_within_bar(got, want)


@pytest.mark.gpu
def test_wide_verify_segment_engine_on_the_card(cuda):
    """An f32 engine whose verify segment is wider than one 64-row tile
    (8 query heads on one kv head, spec_k 8: 72 rows) gives spec-off's
    greedy tokens, with K3 on its f32 route."""
    from skypilot_tpu_torch.models import llama
    from skypilot_tpu_torch.models import serving_engine as se
    cfg = llama.LlamaConfig.tiny(dim=128, n_heads=8, n_kv_heads=1)
    params = llama.init_params(cfg, 0, device=cuda)
    gen = torch.Generator().manual_seed(4)
    pat = torch.randint(0, cfg.vocab_size, (5,), generator=gen).tolist()
    prompts = {'a': torch.randint(0, cfg.vocab_size, (11,),
                                  generator=gen).tolist(),
               'rep': (pat * 6)[:28]}
    kw = dict(batch_size=3, max_prompt=32, max_seq=160, decode_chunk=4,
              prefill_chunk=8, prefill_budget=16, page=8, device=cuda)

    def run(**extra):
        eng = se.ServingEngine(params, cfg, **kw, **extra)
        eng.warmup()                   # captures the tick programs
        _build.reset_launches()        # count the served requests only
        res = eng.run([se.Request(r, p, max_new=14)
                       for r, p in prompts.items()])
        return eng, {r: res[r].tokens for r in prompts}

    _, want = run()
    eng, got = run(spec_decode=True, spec_k=8)
    torch.cuda.synchronize()
    assert got == want
    k3 = _build.LAUNCHES[tfa.VERIFY_KERNEL]
    assert k3 == eng.spec_ticks * cfg.n_layers > 0
    assert _build.LAUNCHES[tfa.VERIFY_KERNEL + '.f32'] == k3


@pytest.mark.gpu
def test_kernels_reject_what_they_do_not_take(cuda):
    """No quiet fallback: a wrong dtype or a page-misaligned cache on
    the card raises instead of running the plain version."""
    q = torch.zeros((1, 4, 128), dtype=torch.bfloat16, device=cuda)
    kc = torch.zeros((1, 100, 2, 128), dtype=torch.bfloat16, device=cuda)
    valid = torch.ones((1, 100), dtype=torch.bool, device=cuda)
    bound = torch.full((1,), 100, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match='multiple of the page'):
        tda.paged_gqa_decode_attention(q, kc, kc, valid, bound, page=128)
    with pytest.raises(TypeError):
        tfa.chunk_prefill_attention(
            torch.zeros((1, 4, 2, 128), dtype=torch.float16, device=cuda),
            kc, kc, torch.zeros((1,), dtype=torch.int32, device=cuda))
    # The bf16 chunk kernel takes head_dim in FLASH_HEAD_DIMS only; the
    # f32 one takes any head_dim up to 128.
    off = torch.zeros((1,), dtype=torch.int32, device=cuda)
    k40 = torch.zeros((1, 100, 2, 40), dtype=torch.bfloat16, device=cuda)
    _build.reset_launches()
    with pytest.raises(ValueError, match='head_dim'):
        tfa.chunk_prefill_attention(
            torch.zeros((1, 4, 2, 40), dtype=torch.bfloat16, device=cuda),
            k40, k40, off)
    assert not _build.LAUNCHES
    tfa.chunk_prefill_attention(
        torch.zeros((1, 4, 2, 40), device=cuda), k40.float(), k40.float(),
        off)
    assert _build.LAUNCHES[tfa.KERNEL + '.f32'] == 1


def _flash_inputs(dev, b, sq, sk, h, d, dt, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randn((b, s, h, d), generator=gen, device=dev).to(dt)
            for s in (sq, sk, sk, sq)]                     # q, k, v, dO


def _flash_launches(f32):
    """One K4, K5a and K5b launch, on the f32 route or the bf16 one."""
    want = {tfa.FWD_KERNEL: 1, tfa.DQ_KERNEL: 1, tfa.DKV_KERNEL: 1}
    if f32:
        want.update({f'{name}.f32': 1 for name in list(want)})
    return want


@pytest.mark.gpu
@pytest.mark.parametrize('b,sq,sk,h,d,dtype,causal', [
    (2, 256, 256, 4, 128, 'f32', True),
    (2, 256, 256, 4, 128, 'f32', False),
    (1, 128, 256, 4, 128, 'f32', True),       # Sq < Sk, bottom-right mask
    (2, 200, 200, 3, 64, 'f32', True),        # S off the tile grid
    (1, 96, 160, 2, 32, 'f32', False),
    (2, 40, 40, 4, 16, 'f32', True),          # tiny()'s head_dim
    (1, 70, 70, 2, 96, 'bf16', True),
    (1, 512, 512, 4, 128, 'bf16', True),
    (2, 256, 256, 4, 128, 'bf16', True),
    (2, 256, 256, 4, 128, 'bf16', False),
    (1, 128, 256, 4, 128, 'bf16', True),
    (2, 200, 200, 3, 128, 'bf16', True),
    (2, 200, 200, 3, 64, 'bf16', True),
    (2, 40, 40, 4, 16, 'bf16', True),
    (1, 130, 190, 2, 80, 'bf16', False),      # two column chunks, padded
    (4, 2048, 2048, 16, 128, 'bf16', True),   # the training shapes
], ids=['causal', 'full', 'sq<sk', 'ragged-d64', 'd32', 'd16', 'd96-bf16',
        'bf16', 'bf16-causal', 'bf16-full', 'bf16-sq<sk', 'bf16-ragged',
        'bf16-ragged-d64', 'bf16-d16', 'bf16-d80', 'bf16-train'])
def test_flash_kernels_match_plain(cuda, b, sq, sk, h, d, dtype, causal):
    dt = torch.float32 if dtype == 'f32' else torch.bfloat16
    q, k, v, do = _flash_inputs(cuda, b, sq, sk, h, d, dt, sq + d)
    kw = dict(causal=causal, scale=d**-0.5)
    _build.reset_launches()
    o, lse = tfa.flash_forward(q, k, v, **kw)
    grads = tfa.flash_backward(q, k, v, o, lse, do, **kw)
    launches = dict(_build.LAUNCHES)
    want_o, want_lse = tfa._plain_fwd(q, k, v, **kw)
    want = tfa._plain_bwd(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    assert launches == _flash_launches(dtype == 'f32')
    _assert_within_bar(o, want_o, f32=dtype == 'f32')
    _assert_within_bar(lse, want_lse, f32=True)
    for got, ref in zip(grads, want):
        assert torch.isfinite(got.float()).all()
        _assert_within_bar(got, ref, f32=dtype == 'f32')


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_flash_launches_count_their_route(cuda, dtype):
    """The input dtype picks the route of the flash kernels and the
    chunk kernel: bf16 launches count no .f32 entry, f32 launches count
    every one under .f32 as well."""
    dt = torch.float32 if dtype == 'f32' else torch.bfloat16
    xs = [x.requires_grad_(True)
          for x in _flash_inputs(cuda, 1, 64, 64, 2, 64, dt, 1)[:3]]
    q, k = _flash_inputs(cuda, 2, 48, 160, 2, 64, dt, 5)[:2]
    _build.reset_launches()
    o = tfa.flash_attention(*xs)
    torch.autograd.grad(o.float().sum(), xs)
    tfa.chunk_prefill_attention(
        q, k, k, torch.tensor([0, 100], dtype=torch.int32, device=cuda))
    torch.cuda.synchronize()
    want = _flash_launches(dtype == 'f32')
    want[tfa.KERNEL] = 1
    if dtype == 'f32':
        want[tfa.KERNEL + '.f32'] = 1
    assert dict(_build.LAUNCHES) == want


@pytest.mark.gpu
@pytest.mark.parametrize('dtype', ['f32', 'bf16'])
def test_flash_dq_writes_delta(cuda, dtype):
    """K5a's delta output is rowsum(dO * O), [B, H, Sq] f32."""
    dt = torch.float32 if dtype == 'f32' else torch.bfloat16
    q, k, v, do = _flash_inputs(cuda, 2, 200, 200, 3, 128, dt, 2)
    kw = dict(causal=True, scale=128**-0.5)
    o, lse = tfa.flash_forward(q, k, v, **kw)
    _, delta = tfa._flash_dq_cuda(q, k, v, o, lse, do, **kw)
    want = (do.float() * o.float()).sum(-1).transpose(1, 2)
    torch.cuda.synchronize()
    assert delta.shape == want.shape and delta.dtype == torch.float32
    err = (delta - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item(), err


@pytest.mark.gpu
def test_flash_attention_autograd_gqa_on_the_card(cuda):
    """flash_attention's Function on CUDA tensors (GQA repeated at the
    API) against the same call on the CPU (the plain versions). The bar
    is 1e-4 of each tensor's scale, max(1, max |want|), as phase 9 of
    chip_smoke.py holds gradients: these reach tens in magnitude, where
    f32 sums taken in another order differ by more than an absolute
    1e-4 (2.4e-4 seen once on the card)."""
    gen = torch.Generator().manual_seed(3)
    q = torch.randn((2, 64, 4, 32), generator=gen)
    k = torch.randn((2, 64, 2, 32), generator=gen)
    v = torch.randn((2, 64, 2, 32), generator=gen)
    outs = []
    for dev in ('cpu', cuda):
        xs = [t.to(dev).requires_grad_(True) for t in (q, k, v)]
        o = tfa.flash_attention(*xs)
        outs.append([o] + list(torch.autograd.grad((o * o).sum(), xs)))
    for got, want in zip(outs[1], outs[0]):
        want = want.detach()
        err = (got.cpu() - want).abs().max().item()
        assert err <= 1e-4 * max(1.0, want.abs().max().item()), err


@pytest.mark.gpu
def test_flash_kernels_reject_what_they_do_not_take(cuda):
    q = torch.zeros((1, 8, 2, 72), device=cuda)
    with pytest.raises(ValueError, match='head_dim'):
        tfa.flash_forward(q, q, q, causal=True, scale=1.0)
    with pytest.raises(TypeError):
        h = q[..., :64].to(torch.float16).contiguous()
        tfa.flash_forward(h, h, h, causal=True, scale=1.0)
    with pytest.raises(ValueError, match='Sq <= Sk'):
        z = torch.zeros((1, 8, 2, 64), device=cuda)
        tfa.flash_attention(z, z[:, :4], z[:, :4])
