"""The MoE encode and warmup drivers on the CPU at tiny sizes
(tests/tiny_cells/) against their references: sound runs come out
correct, and runs with the timed path broken underneath come out not
correct, one fault at a time; their metric readers on hand-made runs."""
import time

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.tests.helpers import DATA

CELLS = DATA.parent / "tiny_cells"


def manifest():
    return harness.load_json(CELLS / "manifest.json")


def run_tiny(cell, seed=7, seconds=0.3, trace=False):
    return harness.run_cell(manifest(), cell, seed, seconds, trace,
                            device="cpu", traffic_dir=CELLS,
                            limits_dir=CELLS)


def tiny_ctx(cell, tmp_path, seed=7):
    m = manifest()
    files = harness.cell_files(m, harness.find_cell(m, cell),
                               traffic_dir=CELLS, limits_dir=CELLS)
    return harness.Ctx(files, seed, 0.0, False, "cpu", str(tmp_path),
                       time.perf_counter())


def test_moe_encode_is_correct():
    line = run_tiny("tiny.moe_encode")
    assert line["correct"], line["checks"]
    assert line["attempted"] > 0


def test_moe_encode_traced_reads_its_metrics():
    """A traced CPU run: the spans and the expert counter give
    route_ms and expert_load_max (the device metrics need a card)."""
    line = run_tiny("tiny.moe_encode", trace=True)
    assert line["correct"], line["checks"]
    assert line["metrics"]["route_ms.moe_encode"]["value"] > 0
    assert line["metrics"]["expert_load_max.moe_encode"]["value"] >= 1.0


def test_warmup_is_correct():
    line = run_tiny("tiny.warmup", seconds=0.5)
    assert line["correct"], line["checks"]
    assert line["checks"]["batch_bad_rows"]["value"] == 0


def _no_shared_expert(monkeypatch):
    from cocodr_tpu_torch.ops import moe

    real = moe.combine
    monkeypatch.setattr(moe, "combine", lambda routed, shared, r, k: real(
        routed, torch.zeros_like(shared), r, k))


def _renormalised_weights(monkeypatch):
    from cocodr_tpu_torch.ops import moe

    real = moe.route

    def route(x, gate, k, real_mask=None):
        r = real(x, gate, k, real_mask)
        token = r.order // k
        sums = torch.zeros(x.shape[0], dtype=r.weights.dtype).index_add_(
            0, token, r.weights)
        return r._replace(weights=r.weights / sums[token])

    monkeypatch.setattr(moe, "route", route)


def _no_mscale(monkeypatch):
    from cocodr_tpu_torch.models.deepseek_v2 import DeepseekV2Config

    monkeypatch.setattr(DeepseekV2Config, "softmax_scale", property(
        lambda self: self.qk_head_dim ** -0.5))


def _rotate_half(monkeypatch):
    from cocodr_tpu_torch.models import deepseek_v2

    def rotate(x, cos, sin):
        """pairs (x_i, x_i+D/2), the other rotary layout"""
        xf = x.float()
        x0, x1 = xf.chunk(2, -1)
        if x.dim() == 4:
            cos, sin = cos[:, None], sin[:, None]
        return torch.cat([x0 * cos - x1 * sin, x0 * sin + x1 * cos],
                         -1).to(x.dtype)

    monkeypatch.setattr(deepseek_v2, "rotate_pairs", rotate)


def _warmup_no_negative(monkeypatch):
    from cocodr_tpu_torch.losses import nll

    real = nll._two_way

    def positive_only(pos, neg):
        return real(pos, torch.full_like(neg, -1e4))

    monkeypatch.setattr(nll, "_two_way", positive_only)


def _warmup_unchanged(monkeypatch):
    from cocodr_tpu_torch.pipelines import train_step

    def no_update(state, max_grad_norm):
        state.step += 1  # the step counts, the state stays as it was

    monkeypatch.setattr(train_step, "apply_gradients", no_update)


@pytest.mark.parametrize("cell,fault", [
    ("tiny.moe_encode", _no_shared_expert),
    ("tiny.moe_encode", _renormalised_weights),
    ("tiny.moe_encode", _no_mscale),
    ("tiny.moe_encode", _rotate_half),
    ("tiny.warmup", _warmup_no_negative),
    ("tiny.warmup", _warmup_unchanged),
], ids=lambda x: getattr(x, "__name__", x))
def test_a_broken_path_is_not_correct(monkeypatch, cell, fault):
    fault(monkeypatch)
    line = run_tiny(cell, seconds=0.3)
    assert line["correct"] is False, line["checks"]


@pytest.mark.parametrize("cell,variant", [
    ("tiny.moe_encode", "control_fp8"), ("tiny.warmup", "control_fp8"),
    ("tiny.warmup", "fault_half")])
def test_controls_read_above_the_sound_path(tmp_path, cell, variant):
    ctx = tiny_ctx(cell, tmp_path)
    driver = harness.load_driver(ctx.traffic["driver"])
    sound = driver.readings(tiny_ctx(cell, tmp_path), "program")
    control = driver.readings(ctx, variant)
    assert any(control[k] > 3 * sound[k] + 1e-9 for k in sound
               if k in ctx.limits), (sound, control)


def test_moe_records_have_the_same_lengths_every_seed(tmp_path):
    from portbench.drivers.moe_encode import make_records

    a_ids, a_len = make_records(tiny_ctx("tiny.moe_encode", tmp_path, 7))
    b_ids, b_len = make_records(tiny_ctx("tiny.moe_encode", tmp_path,
                                         2 ** 31 + 11))
    assert np.array_equal(a_len, b_len) and not np.array_equal(a_ids, b_ids)
    tr = manifest()
    assert a_ids[0, 0] == harness.load_json(
        CELLS / "tiny_moe_encode.json")["bos_id"] and tr


def _run(calls, counts, host_ops=(), window=(0, 10**9)):
    return harness.TraceRun(
        device_ops=[("void (anonymous namespace)::moe_gemm_kernel<true>"
                     "(CUtensorMap_st)", 0, 4_000_000)],
        host_ops=list(host_ops), window_ns=window, calls=calls,
        counts=counts)


def test_expert_roofline_reads_the_counted_rows():
    """Two probed calls of 1,000 rows each (pads included) and 1,500 rows
    counted on the card: each call's work is of 750 rows."""
    from portbench import roofline, work_moe

    sig = ((1000, 2048), (64, 1408, 2048), (64, 1408, 2048),
           (64, 2048, 1408), (65,), (1000,), (1000,))
    run = _run({"experts": [sig, sig]},
               {"expert_rows": [[0] * 4, [500, 250, 0, 0], [750, 0, 0, 0]]})
    want = 2 * roofline.least_seconds(*work_moe.expert_work(
        750, 64, 2048, 1408))
    got = harness.load_reader("expert_roofline.moe_encode").read(run)
    assert got == pytest.approx(100 * want / 4e-3)


def test_expert_load_max_averages_the_moe_layers():
    run = _run({}, {"expert_rows": [[0, 0], [3, 1], [2, 2]]})
    got = harness.load_reader("expert_load_max.moe_encode").read(run)
    assert got == pytest.approx((1.5 + 1.0) / 2)
    assert harness.load_reader("expert_load_max.moe_encode").read(
        _run({}, {})) is None
