"""The controls on the card: for each cell, the sound path reads within its
limits and the control (the computation in the next lower precision) reads
past one of them, at the cell's own widths and batch, on one seed each.
The traffic is the cell's, with fewer calls than a run makes. Each test
needs a CUDA card and skips without one."""
import pytest
import torch

from portbench import harness

CONTROLS = [("bert-base.encode", "control_fp8"),
            ("bert-large.encode", "control_fp8"),
            ("bert-base.mine_search", "control_int8"),
            ("bert-base.coco_pretrain", "control_fp8")]


@pytest.mark.card
@pytest.mark.parametrize("cell,control", CONTROLS)
def test_control_fails_and_program_passes(tmp_path, cell, control):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import time

    bench = harness.load_json(harness.BENCHMARK)
    files = harness.cell_files(bench, harness.find_cell(bench, cell))
    driver = harness.load_driver(files.traffic["driver"])

    def read(variant):
        ctx = harness.Ctx(files, 20231, 0.0, False, "cuda:0", str(tmp_path),
                          time.perf_counter())
        return driver.readings(ctx, variant)

    sound, bad = read("program"), read(control)
    for name, limit in files.limits.items():
        assert sound[name] <= limit, (name, sound)
    assert any(bad[name] > limit for name, limit in files.limits.items()), bad
