"""The operation and byte counts behind mfu.warm and b3_roofline.warm,
held to counts made by hand."""
import pytest

from portbench import counts

DENSE = {"family": "dense", "n_layers": 2, "d_model": 8, "n_heads": 2, "n_kv_heads": 1,
         "head_dim": 4, "d_ff": 16, "vocab": 10}


def test_attention_call_by_hand():
    # B=2, S=3, H=2, KV=1, D=4 in bf16: q and o 2*3*2*4 each, k and v 2*3*1*4
    n_bytes, n_ops = counts.attention_call(2, 3, 2, 1, 4)
    assert n_bytes == (48 + 48 + 24 + 24) * 2
    # causal pairs (q, k<=q): 1 + 2 + 3 = 6 a (b, head); QK^T and PV 2 * 2 * D each
    assert n_ops == 2 * 2 * 6 * 4 * 4


def test_bound_takes_the_larger_side():
    assert counts.bound_s(3.35e12, 0, "bfloat16") == pytest.approx(1.0)
    assert counts.bound_s(0, 989e12 * 2, "bfloat16") == pytest.approx(2.0)


def test_dense_forward_flops_by_hand():
    S = 5
    # per layer: q 8*8, k and v 8*4 each, o 8*8, MLP 3*8*16 -> 2*S*(64+64+64+384)
    linear = 2 * S * (8 * 2 * 4 + 2 * 8 * 1 * 4 + 2 * 4 * 8 + 3 * 8 * 16)
    attn = 2 * 2 * 4 * S * (S + 1)                # 2 H D S (S + 1)
    head = 2 * S * 8 * 10
    assert counts.forward_flops(DENSE, 3, S) == 3 * (2 * (linear + attn) + head)
    assert counts.attention_shapes(DENSE, 3, S) == [(2, (3, S, 2, 1, 4))]


def test_other_families_are_refused():
    with pytest.raises(ValueError):
        counts.forward_flops(dict(DENSE, family="hybrid"), 1, 4)
