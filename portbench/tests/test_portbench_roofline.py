"""The work counts against shapes worked out by hand."""
import pytest

from portbench import roofline


def test_peaks():
    assert roofline.HBM_BYTES_PER_S == 3.35e12
    assert roofline.BF16_FLOP_PER_S == 989e12
    assert roofline.INT8_OP_PER_S == 1979e12


def test_k1_at_an_encode_batch():
    # 256 x 128 tokens at bert-base: two products of 32,768 x 768 x 3,072
    ops, nbytes = roofline.ffn_block_work(32768, 768, 3072)
    assert ops == 2 * (2 * 32768 * 768 * 3072) == 309_237_645_312
    # r in and out, w1 and w2 in bf16, b1 and b2, four LayerNorm vectors
    assert nbytes == (2 * 32768 * 768 * 2 + 2 * 768 * 3072 * 2
                      + (3072 + 768) * 2 + 4 * 768 * 4)
    t = roofline.least_seconds(ops, nbytes)
    assert t == pytest.approx(ops / 989e12)  # bound by operations
    assert t * 1e3 == pytest.approx(0.3127, abs=1e-4)  # PERF.md's 0.313 ms


def test_k4_and_k5():
    ops, _ = roofline.ffn_block_work(32768, 1024, 4096)
    assert ops / 989e12 * 1e3 == pytest.approx(0.556, abs=1e-3)
    ops, nbytes = roofline.ffn_work(8192, 768, 3072)
    assert ops == 4 * 8192 * 768 * 3072
    assert nbytes == 2 * 8192 * 768 * 2 + 2 * 768 * 3072 * 2 + 3840 * 2
    assert roofline.least_seconds(ops, nbytes) * 1e3 == pytest.approx(
        0.078, abs=1e-3)


def test_k2_sweep():
    ops, nbytes = roofline.sweep_work(1024, 1 << 20, 768)
    assert ops == 2 * 1024 * (1 << 20) * 768
    assert nbytes == ((1 << 20) * 768 * 2 + 1024 * 768 * 2
                      + 1024 * ((1 << 20) // 8 + (1 << 20) // 64) * 4)
    assert roofline.least_seconds(ops, nbytes) * 1e3 == pytest.approx(
        1.668, abs=1e-3)


def test_k3_topk():
    ops, nbytes = roofline.topk_work(1024, 6400, 100)
    assert ops == 1024 * 6400  # 6,400 is a multiple of 128
    assert nbytes == 1024 * 6400 * 4 + 1024 * 100 * 8
    ops, _ = roofline.topk_work(2, 129, 1)
    assert ops == 2 * 256  # rows padded to 128
    t = roofline.least_seconds(*roofline.topk_work(1024, 6400, 100),
                               roofline.FP32_OP_PER_S)
    assert t == pytest.approx((1024 * 6400 * 4 + 819200) / 3.35e12)


def test_encoder_forward_and_search_flops():
    # one 72-token record at bert-base: 12.4 GFLOP
    f = roofline.encoder_forward_flops(72, 768, 3072, 12)
    assert f == 12 * (72 * (8 * 768 ** 2 + 4 * 768 * 3072)
                      + 4 * 72 * 72 * 768)
    assert f / 1e9 == pytest.approx(12.4, abs=0.05)
    assert roofline.search_flops(4096, 8841823, 768) == \
        2 * 4096 * 8841823 * 768


def test_coco_step_flops():
    H, F, V, S = 768, 3072, 30522, 128
    f = roofline.coco_step_flops(H, F, V, 12, 2, 400, S, 0)
    tokens = 400 * S * 14
    assert f == tokens * 3 * (8 * H * H + 4 * S * H + 4 * H * F) \
        + 6 * 400 * 400 * H
    extra = roofline.coco_step_flops(H, F, V, 12, 2, 400, S, 10) - f
    assert extra == 10 * 3 * (2 * H * H + 2 * H * V)
    # 716,800 token-layers of 14,548,992 operations a forward: 31.29 TFLOP
    assert f / 1e12 == pytest.approx(31.287, abs=1e-3)
