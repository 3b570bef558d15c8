"""K2's share of its roofline in the search window, %: the least time of
each recorded launch of ops/mips_hier.py::dual_sweep, from its input shapes
(queries [Q, D], corpus [N, D]), over the device time of the sweep's
kernel. In a search window no other code runs that kernel."""
import re

from portbench import roofline

KERNELS = re.compile(r"\bgemm_kernel\b")  # csrc/mips_sweep.cu's GEMM


def read(run):
    calls = run.calls.get("K2", [])
    device = run.device_seconds(KERNELS)
    if not calls or not device:
        return None
    least = 0.0
    for sig in calls:
        (Q, D), (N, _) = sig[0], sig[1]
        least += roofline.least_seconds(*roofline.sweep_work(Q, N, D))
    return 100.0 * least / device
