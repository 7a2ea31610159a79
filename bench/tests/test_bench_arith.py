"""The benchmark's frozen arithmetic against hand-worked values."""
import math

import pytest

from bench.metrics import arith

# SmolLM-360M's packed projections of one layer at M = 4: (K, N) x count
SMOLLM_LAYER = {(960, 960): 2, (960, 320): 2, (960, 2560): 2, (2560, 960): 1}


def test_bitplane_bytes_of_one_projection():
    # 8-bit planes 960 x 960 -> 921,600 B; scale 3,840 B; bf16 x and y at
    # M = 4: 7,680 B each
    assert arith.bitplane_bytes(4, 960, 960, 8) == 921_600 + 3_840 + \
        7_680 + 7_680


def test_bitplane_bound_of_a_smollm_layer_is_2_99_us():
    # 1,881,600 + 637,440 + 4,992,000 + 2,489,600 = 10,000,640 bytes
    total = sum(c * arith.bitplane_bytes(4, k, n, 8)
                for (k, n), c in SMOLLM_LAYER.items())
    assert total == 10_000_640
    bound = sum(c * arith.bitplane_bound_s(4, k, n, 8)
                for (k, n), c in SMOLLM_LAYER.items())
    assert round(bound * 1e6, 2) == 2.99          # PERF.md's 2.99 us
    # the bytes bound it: 2 M K N over the bf16 peak is 33x smaller
    assert 2 * 4 * 960 * 2560 / arith.BF16_FLOP_PER_S < \
        arith.bitplane_bytes(4, 960, 2560, 8) / arith.HBM_BYTES_PER_S / 30


def test_roofline_takes_the_larger_bound():
    assert arith.roofline_s(3.35e12, 0) == pytest.approx(1.0)
    assert arith.roofline_s(0, 989e12 * 2) == pytest.approx(2.0)


def test_moe_bytes():
    # two experts of d 4096, f 14336 in bf16, 16 tokens in and out
    assert arith.moe_bytes(2, 16, 4096, 14336) == \
        2 * 3 * 4096 * 14336 * 2 + 2 * 2 * 16 * 4096
    # all 8 experts of 16 layers: 45.1 GB, 13.5 ms at full bandwidth
    full = 16 * 8 * arith.expert_bytes(4096, 14336)
    assert round(full / 1e9, 1) == 45.1
    assert round(full / arith.HBM_BYTES_PER_S * 1e3, 1) == 13.5


def test_decode_flops_of_a_smollm_token():
    proj = [(k, n) for (k, n), c in SMOLLM_LAYER.items()
            for _ in range(c)] * 32
    per_token = arith.decode_token_flops(proj, head=(960, 49152))
    # 2 x (32 layers x 9,830,400 weights + the 47,185,920 of the head)
    assert per_token == 2 * (32 * 9_830_400 + 47_185_920)
    # attention over 10 positions: 32 layers x 2 products x 2 x 15 x 64
    assert arith.attention_flops(32, 15, 64, 10) == 32 * 4 * 15 * 64 * 10


def test_decode_flops_of_a_mixtral_token_count_top2_experts():
    f = arith.decode_token_flops([], head=(4096, 32000), moe_layers=16,
                                 top_k=2, d_model=4096, d_ff=14336,
                                 n_experts=8)
    assert f == 2 * 4096 * 32000 + 16 * (2 * 4096 * 8 +
                                          2 * 2 * 3 * 4096 * 14336)


def test_busy_union_counts_overlap_once():
    assert arith.busy_union([]) == 0.0
    assert arith.busy_union([(0, 2), (1, 3), (5, 6)]) == 4.0
    assert arith.busy_union([(5, 6), (0, 10), (2, 3)]) == 10.0
    # touching intervals merge; nested ones add nothing
    assert arith.busy_union([(0, 1), (1, 2), (0.5, 0.7)]) == 2.0
    assert arith.idle_gaps([(0, 2), (1, 3), (5, 6), (8, 9)]) == \
        [(3, 5), (6, 8)]


def test_percentile_nearest_rank():
    values = list(range(1, 201))               # 1 .. 200
    assert arith.percentile(values, 95) == 190  # ceil(0.95 * 200) = 190
    assert arith.percentile([3.0], 95) == 3.0
    assert arith.percentile([4, 1, 3, 2], 50) == 2
    assert arith.percentile(values[::-1], 100) == 200
    with pytest.raises(ValueError):
        arith.percentile([], 95)
    assert math.isclose(arith.percentile([0.5, 0.25], 95), 0.5)
