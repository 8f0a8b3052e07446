"""The frozen bounds and FLOP counts against hand-computed values, and the
selected-row count against the program's own."""
import numpy as np
import pytest
import torch

from tdbench import flops
from tdbench.reference.tokendance import n_sel_blocks


def test_attention_pairs_causal_window_and_kv_len():
    q_pos = torch.arange(5, dtype=torch.int32)[None]
    assert flops.attention_pairs(q_pos, 1 << 30, 5) == 15
    assert flops.attention_pairs(q_pos, 2, 5) == 1 + 2 + 2 + 2 + 2
    kv = torch.tensor([3], dtype=torch.int32)
    assert flops.attention_pairs(q_pos, 1 << 30, 5, kv) == 1 + 2 + 3 + 3 + 3
    sel = torch.tensor([[0, 7]], dtype=torch.int32)
    assert flops.attention_pairs(sel, 1 << 30, 8) == 1 + 8


def test_flash_attention_bound_by_hand():
    # q [2, 4, 8, 64] bf16, k [2, 4, 2, 64], causal: 2 * 10 pairs
    b = flops.flash_attention_bound((2, 4, 8, 64), (2, 4, 2, 64), 2, 20,
                                    False)
    n_bytes = 2 * (2 * 2 * 4 * 8 * 64 + 2 * 2 * 4 * 2 * 64) + 4 * 2 * 4
    f = 4 * 8 * 64 * 20
    assert b == pytest.approx(max(n_bytes / 3.35e12, f / 989e12), rel=1e-12)
    # f32 operands take the split-TF32 peak
    b32 = flops.flash_attention_bound((1, 4096, 32, 128), (1, 4096, 8, 128),
                                      4, 4096 * 4097 // 2, False)
    assert b32 == pytest.approx(4 * 32 * 128 * 4096 * 4097 / 2 / (495e12 / 3))


def test_decode_paged_bound_counts_span_rows():
    # PERF.md's row 4: q [8, 28, 128] f32 over 8 x 545 span rows, 4 KV heads
    b = flops.decode_paged_bound((8, 28, 128), 4, 4, 8 * 545, 8 * 18)
    n_bytes = 4 * (2 * 8 * 28 * 128 + 2 * 8 * 545 * 4 * 128) + 4 * 144 + 32
    assert b == pytest.approx(n_bytes / 3.35e12)
    assert b * 1e3 == pytest.approx(0.0054, abs=1e-4)


def test_batch_flops_by_hand():
    s = dict(L=2, D=4, H=2, KV=1, hd=2, F=8, V=10)
    lin = 2 * (4 * 4 + 2 * 4 * 2 + 4 * 4 + 3 * 4 * 8)
    assert flops.layer_flops_per_token(s) == lin
    head = 2 * 4 * 10
    # round 0: 1 sequence of 3 tokens, G = 2 (one fed token)
    got = flops.batch_flops(s, 1, 3, 2)
    want = (2 * 3 * lin + 2 * 4 * 2 * 2 * 6
            + 1 * 2 * lin + 2 * 4 * 2 * 2 * 4 + 2 * head)
    assert got == want
    # a reuse round, check layer 0: layer 0 whole, layer 1 at rows 1 and 2
    got = flops.batch_flops(s, 1, 3, 2, sel=[np.array([1, 2])],
                            check_layer=0)
    want = (3 * lin + 4 * 2 * 2 * 6 + 2 * lin + 4 * 2 * 2 * 5
            + 2 * lin + 2 * 4 * 2 * 2 * 4 + 2 * head)
    assert got == want


@pytest.mark.parametrize("fresh_blocks, cached_blocks", [(1, 42), (1, 12),
                                                          (2, 3)])
def test_n_sel_blocks(fresh_blocks, cached_blocks):
    bt = 32
    fresh = np.r_[np.zeros(cached_blocks * bt, bool),
                  np.ones(fresh_blocks * bt, bool)]
    want = fresh_blocks + max(1, int(np.ceil(0.15 * cached_blocks)))
    assert n_sel_blocks(fresh, bt, 0.15) == want
