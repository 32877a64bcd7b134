"""The operation and byte counts against shapes worked by hand."""
import json
import os

import pytest

from portbench.core import spec
from portbench.core.peaks import BF16_FLOPS, HBM_BYTES_PER_S
from portbench.tests import tiny


def _config(name):
    with open(os.path.join(tiny.REPO, 'portbench', 'configs', name + '.json'),
              encoding='utf-8') as f:
        return json.load(f)


MISTRAL = _config('mistral-7b')
MIXTRAL = _config('mixtral-8x7b-w8')


def count(name):
    return spec.count(tiny.REPO, name)


def test_parameter_counts_are_the_published_models():
    model = count('model')
    # Mistral-7B: 32 x (4096 x 128 x (32 + 32 + 8 + 8) + 3 x 4096 x 14336)
    assert model.body_params(MISTRAL) == 32 * (41_943_040 + 176_160_768)
    assert model.head_params(MISTRAL) == 4096 * 32768
    # With the embedding table, the published 7.25B.
    assert (model.body_params(MISTRAL) + 2 * 4096 * 32768) == 7_247_757_312
    # Mixtral: attention, router and two of eight experts a layer.
    assert model.body_params(MIXTRAL) == 32 * (
        41_943_040 + 2 * 176_160_768 + 4096 * 8)


def test_serve_ops_of_a_tick():
    model = count('model')
    # One tick: 8 decode steps of 3 rows whose keys sum to 1000, and one
    # prefill of 512 tokens in 2 chunks whose keys sum to 131,328.
    log = [(8, 3, 1000, 512, 2, 131_328)]
    body, head = model.body_params(MISTRAL), model.head_params(MISTRAL)
    want = (2 * body * (24 + 512) + 2 * head * (24 + 2) +
            4 * 32 * 32 * 128 * (1000 + 131_328))
    assert model.serve_ops(MISTRAL, log) == want


def test_train_ops_per_token():
    # 6 N (embedding table left out) + 6 L S d.
    assert count('model').train_ops_per_token(MISTRAL, 4096) == \
        6 * 7_113_539_584 + 6 * 32 * 4096 * 4096


def test_q1_call_bound():
    q1 = count('q1')
    # x [8, 4096] bf16 @ q [4096, 14336] int8, scales f32, out bf16.
    nbytes = 4096 * 14336 + 4 * 14336 + 2 * 8 * 4096 + 2 * 8 * 14336
    assert nbytes == 59_072_512
    assert q1.call_s(8, 4096, 14336) == pytest.approx(
        nbytes / HBM_BYTES_PER_S)
    # At 1024 rows the operations bound it.
    assert q1.call_s(1024, 4096, 14336) == pytest.approx(
        2 * 1024 * 4096 * 14336 / BF16_FLOPS)


def test_q1_forward_reads_every_expert_once():
    q1 = count('q1')
    c = dict(MIXTRAL, num_hidden_layers=1, vocab_size=32000)
    attn = (q1.call_s(8, 4096, 4096) + 2 * q1.call_s(8, 4096, 1024) +
            q1.call_s(8, 4096, 4096))
    w = 8 * 3 * (4096 * 14336 + 4 * 14336)
    x = 2 * 8 * 4096 * 2 + 2 * 8 * 2 * 14336 * 3 + 2 * 8 * 2 * 4096
    head = q1.call_s(8, 4096, 32000, 4)
    assert q1.forward_s(c, 8, 8) == pytest.approx(
        attn + (w + x) / HBM_BYTES_PER_S + head)
    assert q1.bound_s(c, [(8, 8, 0, 0, 0, 0)]) == pytest.approx(
        8 * q1.forward_s(c, 8, 8))


def test_k1_bound():
    k1 = count('k1')
    # 1000 keys x (K and V, 8 heads x 128, bf16) + one row's q and out
    # (32 heads x 128, bf16), in 32 layers.
    nbytes = 32 * (1000 * 2 * 8 * 128 * 2 + 2 * 32 * 128 * 2)
    assert nbytes == 131_596_288
    assert k1.bound_s(MISTRAL, [(1, 1, 1000, 0, 0, 0)]) == pytest.approx(
        nbytes / HBM_BYTES_PER_S)


def test_flash_step_bound():
    flash = count('flash')
    pairs = 2 * 4096 * 4097 // 2
    assert pairs == 16_781_312
    fwd = 4 * 32 * 128 * pairs
    assert flash.step_bound_s(MISTRAL, 2, 4096) == pytest.approx(
        32 * 3.5 * fwd / BF16_FLOPS)
