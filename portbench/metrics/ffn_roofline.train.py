"""K5's share of its roofline in the COCO window, %: the least time of each
recorded launch of ops/ffn.py::fused_ffn (the FFN of the dropout path),
from its input shapes, over the device time of the kernels that launch
makes. A COCO step with dropout runs no K1, so these kernels are K5's."""
import re

from portbench import roofline

# csrc/ffn_block.cu's K5: the GEMM template of csrc/gemm_wgmma.cuh (up
# product with GELU, down product) and its bias and rounding kernel
KERNELS = re.compile(r"\b(gemm_kernel|bias_round_kernel)\b")


def read(run):
    calls = run.calls.get("K5", [])
    device = run.device_seconds(KERNELS)
    if not calls or not device:
        return None
    least = 0.0
    for sig in calls:
        (T, H), (F, _) = sig[0], sig[1]
        least += roofline.least_seconds(*roofline.ffn_work(T, H, F))
    return 100.0 * least / device
