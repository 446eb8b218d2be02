"""flops.py and the ``pfn`` model kind's counts (``models/pfn.py``)
against counts made by hand at tiny shapes."""

import pytest

from pfnbench import flops, spec

MODEL = {"emsize": 8, "nhid": 16, "nlayers": 2, "nhead": 2}
PFN = spec.program_model("pfn")


def test_pfn_pairs_by_enumeration():
    for T in (1, 5, 9):
        for sep in (-1, 0, 1, 4, T, T + 3):
            s = min(max(sep, 0), T)
            allowed = sum(1 for i in range(T) for j in range(T) if j < s or j == i)
            assert flops.pfn_pairs(T, sep) == allowed


def test_layer_weights():
    # qkv 8x24, out 8x8, linear1 8x16, linear2 16x8
    assert PFN.layer_weights(MODEL) == 8 * 24 + 8 * 8 + 8 * 16 + 16 * 8


def test_forward_by_hand():
    # 3 datasets, 5 rows, sep 2: pairs 5*2 + 3 = 13; 1 feature; 4 outputs;
    # the decoder on the 3 rows at and after sep of each dataset.
    got = PFN.forward_flops(MODEL, 1, 4, 3, 5, 13, 9)
    encoder = 2 * 3 * 5 * (2 * 512 + 1 * 8 + 8)
    attention = 2 * 2 * 2 * 3 * 2 * 13 * 4  # 2 products, 2 layers, 2 heads, head dim 4
    decoder = 2 * 9 * (8 * 16 + 16 * 4)
    assert got == encoder + attention + decoder


def test_train_counts_the_decoder_on_rows_at_and_after_sep():
    T, B = 6, 2
    one = PFN.train_flops(MODEL, 1, 4, B, T, [2])
    assert one == 3 * PFN.forward_flops(MODEL, 1, 4, B, T, flops.pfn_pairs(T, 2), B * (T - 2))
    assert PFN.train_flops(MODEL, 1, 4, B, T, [2, 5]) == one + PFN.train_flops(MODEL, 1, 4, B, T, [5])
    # A later sep decodes fewer rows and attends over more pairs.
    d_rows = PFN.train_flops(MODEL, 1, 4, B, T, [5]) - PFN.train_flops(MODEL, 1, 4, B, T, [2])
    assert d_rows == 3 * (2.0 * 2 * 2 * B * 2 * (flops.pfn_pairs(T, 5) - flops.pfn_pairs(T, 2)) * 4
                          - 2.0 * B * 3 * (8 * 16 + 16 * 4))


def test_score_counts_rows_up_to_the_position_and_one_decoded_row():
    got = PFN.score_flops(MODEL, 1, 4, 3, [0, 4])
    want = sum(PFN.forward_flops(MODEL, 1, 4, 3, p + 1, p * p + p + 1, 3) for p in (0, 4))
    assert got == want


@pytest.mark.parametrize("dtype,backward", [("bfloat16", False), ("bfloat16", True), ("float32", False),
                                            ("float32", True)])
def test_attention_bound(dtype, backward):
    BH, T, D, sep = 4, 8, 16, 3
    pairs = 8 * 3 + 5
    ops = 2 * (4 if backward else 2) * D * BH * pairs
    e = 2 if dtype == "bfloat16" else 4
    nbytes = (7 * BH * T * D * e + 2 * BH * T * 4) if backward else (4 * BH * T * D * e + BH * T * 4)
    want = max(ops / flops.PEAK_FLOPS[dtype], nbytes / flops.HBM_BYTES_PER_S)
    assert flops.attention_bound_s(BH, T, D, sep, dtype, backward) == pytest.approx(want, rel=1e-12)
