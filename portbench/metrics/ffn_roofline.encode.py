"""K1's share of its roofline in the encode window, %: the least time of
each recorded launch of ops/ffn.py::fused_ffn_block (K1; K4 at bert-large
widths), from its input shapes, over the device time of the kernels that
launch makes. In an encode window no other code runs these kernels."""
import re

from portbench import roofline

# csrc/ffn_block.cu's kernels and the GEMM template of csrc/gemm_wgmma.cuh
# and the row kernels of csrc/rowwise.cuh it launches
KERNELS = re.compile(r"\b(ln1_kernel|gemm_kernel|residual_ln2_kernel|"
                     r"ln2_kernel|bias_round_kernel)\b")


def read(run):
    calls = run.calls.get("K1", [])
    device = run.device_seconds(KERNELS)
    if not calls or not device:
        return None
    least = 0.0
    for sig in calls:
        (T, H), (F, _) = sig[0], sig[3]
        least += roofline.least_seconds(*roofline.ffn_block_work(T, H, F))
    return 100.0 * least / device
