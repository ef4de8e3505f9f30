"""The benchmark's operation and byte counts against hand counts at small
shapes, and the peaks table."""
import pytest
from conftest import REPO

from perfbench import counts, harness
from perfbench.reference import model, weights

TINY = model.Arch(layers=2, d_model=8, heads=4, kv_heads=2, head_dim=2, d_ff=6, vocab=10,
                  rope_theta=1e4, window=0, eps=1e-5, tie_embeddings=False)


@pytest.mark.parametrize("s, window, pairs", [(1, 0, 1), (4, 0, 10), (5, 3, 1 + 2 + 3 + 3 + 3),
                                              (5, 5, 15), (5, 9, 15), (6, 1, 6)])
def test_kept_pairs(s, window, pairs):
    assert counts.kept_pairs(s, window) == pairs
    brute = sum(1 for i in range(s) for j in range(s) if j <= i and (not window or i - j < window))
    assert brute == pairs


def test_layer_params_are_the_matrices():
    by_hand = 8 * 8 + 8 * 4 + 8 * 4 + 8 * 8 + 8 * 12 + 6 * 8   # wq wk wv wo wi wo: 336
    assert counts.layer_matmul_params(TINY) == by_hand
    specs = weights.leaf_specs(TINY, 1)
    assert sum(a * b for _, (a, *rest), fan in specs if fan for b in rest) == by_hand


def test_prefill_and_train_flops_by_hand():
    s = 3
    layer = 2 * 336 * s + 4 * 1 * 4 * 2 * 6       # products over 3 tokens + 6 kept pairs
    assert counts.prefill_flops(TINY, s) == 2 * layer + 2 * 8 * 10
    tokens = 2 * s
    train = 6 * (2 * 336 + 80) * tokens + 3 * 2 * (4 * 2 * 4 * 2 * 6)
    assert counts.train_flops(TINY, 2, s) == train


def test_attention_flops_match_the_kernel_table():
    # PERF.md's kernel table, row 8n: yi-6b's prefill shape at B 4, S 2048 is 137.506 GFLOP
    yi = model.Arch.from_config(harness.config_file(harness.load_bench(), "yi-6b"))
    assert round(counts.attention_flops(yi, 4, 2048) / 1e9, 3) == 137.506


def test_planes_bytes_by_hand():
    # 2 blocks of 4 values, P = 1: encode reads 32 B, writes 8 planes + 2 * (4 mu + 4 sexp)
    assert counts.planes_bytes(8, 4, 1, sexp_in=0, sexp_out=4) == 32 + 8 + 16
    # decode reads 8 planes + 2 * (4 + 2) and writes 32 B
    assert counts.planes_bytes(8, 4, 1, sexp_in=2, sexp_out=0) == 8 + 12 + 32
    # a leaf of (3, 5) in blocks of 4: padded to (3, 8), 6 blocks
    assert counts.grad_planes_bytes([(3, 5)], 4, 1) == counts.planes_bytes(24, 4, 1, 2, 4)
    assert counts.grad_planes_bytes([(6,)], 4, 2) == counts.planes_bytes(8, 4, 2, 2, 4)


def test_kv_bytes_by_hand():
    n = 2 * 5 * 2 * 2                                # layers x positions x kv heads x hd
    assert counts.kv_encode_bytes(TINY, 5, 1) == 2 * (4 * n + n + (n // 2) * 8)


def test_peaks_table():
    p = counts.peaks("NVIDIA H100 80GB HBM3")
    assert p["bf16_flops"] == 989e12 and p["hbm_bytes_per_s"] == 3.35e12
    assert counts.peaks("cpu") is None
    assert (REPO / "perfbench" / "peaks.json").is_file()
