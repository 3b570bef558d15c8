"""The expert kernel's share of its roofline in the MoE encode window, %:
the least time of each recorded call of ops/moe.py::expert_ffn (its two
grouped products, csrc/moe_experts.cu) over the device time of its
kernels. A call's work is portbench/work_moe.py::expert_work of its rows:
the host knows a call's routed rows only with its pads (T k, the probed
shape), so the rows the card computed in the window (the model's expert
counter, counts['expert_rows']) are shared among the calls in proportion
to their probed rows."""
import re

from portbench import roofline, work_moe

KERNELS = re.compile(r"\bmoe_gemm_kernel\b")


def read(run):
    calls = run.calls.get("experts", [])
    device = run.device_seconds(KERNELS)
    counted = run.counts.get("expert_rows")
    if not calls or not device or not counted:
        return None
    rows = sum(sum(layer) for layer in counted)
    probed = sum(sig[0][0] for sig in calls)
    least = 0.0
    for sig in calls:
        (R, H), (E, F, _) = sig[0], sig[1]
        least += roofline.least_seconds(
            *work_moe.expert_work(R * rows / probed, E, H, F))
    return 100.0 * least / device
