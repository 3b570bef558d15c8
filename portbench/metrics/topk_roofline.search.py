"""K3's share of its roofline in the search window, %: the least time of
each recorded launch of ops/mips_hier.py::topk, from its input shape
([Q, W] and k), over the device time of csrc/topk.cu's kernel."""
import re

from portbench import roofline

KERNELS = re.compile(r"\bradix_topk_kernel\b")


def read(run):
    calls = run.calls.get("K3", [])
    device = run.device_seconds(KERNELS)
    if not calls or not device:
        return None
    least = 0.0
    for sig in calls:
        (Q, W), k = sig[0], sig[1]
        ops, nbytes = roofline.topk_work(Q, W, k)
        least += roofline.least_seconds(ops, nbytes, roofline.FP32_OP_PER_S)
    return 100.0 * least / device
