"""The operation and byte counts, checked by hand, and the share guard."""

import math
from types import SimpleNamespace

import pytest

from bench_torch import roofline


def test_search_bound_matches_the_kernel_table():
    # PERF.md's kernel table, row 1 (B=512, N=2,000,000, d=768): 1.590 ms by ops
    assert roofline.search_bound_s(512, 2_000_000, 768) * 1e3 == pytest.approx(1.5903, abs=1e-4)
    # row 9's corpus (N=2,002,944): 1.593 ms by ops
    assert roofline.search_bound_s(512, 2_002_944, 768) * 1e3 == pytest.approx(1.5927, abs=1e-4)
    # B=1 is bound by the rows read once: 2,000,000 x 768 bf16 at 3.35 TB/s
    assert roofline.search_bound_s(1, 2_000_000, 768) == pytest.approx(
        (2_000_000 * 768 * 2 + 4 * 768 + 80) / 3.35e12)


def test_encoder_flops_by_hand():
    # one token, one layer, d=2, mlp=8: 2*2*(6+2+16) matmul + 4*1*1*2 attention
    assert roofline.encoder_flops(1, 2, 1, 8) == 2 * 2 * (3 * 2 + 2 + 2 * 8) + 4 * 2
    assert roofline.encoder_flops(10, 768, 12, 3072) == 12 * (
        10 * 2 * 768 * (4 * 768 + 2 * 3072) + 4 * 100 * 768)


QWEN = SimpleNamespace(hidden_size=1024, head_dim=128, num_attention_heads=16,
                       num_key_value_heads=8, intermediate_size=3072, num_hidden_layers=28,
                       vocab_size=151_669)


def test_rerank_counts():
    per_layer = 2 * 1024 * 128 * (32 + 16) + 6 * 1024 * 3072
    assert roofline.rerank_flops_per_pair(QWEN, 512) == 512 * 28 * (per_layer + 4 * 512 * 16 * 128)
    # causal: the attention term halves (plus the diagonal), the yes/no head is added
    full = roofline.rerank_flops_per_pair(QWEN, 100)
    want = (full - 28 * (4 * 100 * 100 * 16 * 128) + 28 * 2 * 16 * 128 * 100 * 101
            + 2 * 1024 * 151_669)
    assert roofline.rerank_model_flops(QWEN, 100) == pytest.approx(want)


def test_attention_bound_by_hand():
    # L=1, one head each, D=1: rope moves 2 bytes x 2 x 3 elements; flash does
    # 2*1*1*1*2 = 4 FLOP over 2 bytes x (3 + 1) elements
    got = roofline.attention_layer_bound_s(1, 1, 1, 1)
    assert got == pytest.approx(12 / 3.35e12 + max(4 / 989e12, 8 / 3.35e12))


def test_share_guard_refuses_over_100():
    assert roofline.share_pct(1.0, 2.0) == 50.0
    with pytest.raises(ValueError):
        roofline.share_pct(1.01, 1.0)
    with pytest.raises(ValueError):
        roofline.share_pct(1.0, 0.0)
    assert math.isfinite(roofline.share_pct(0.0, 1.0))
