"""Device time outside the port's own search kernels (K2's sweep, K3's
top-k) per 4,096 queries of the search window, ms: the rescoring gathers
and products, the masks and selections around the kernels, the copies."""
import re

# csrc/mips_sweep.cu launches the GEMM template of csrc/gemm_wgmma.cuh;
# csrc/topk.cu its radix select
KERNELS = re.compile(r"\b(gemm_kernel|radix_topk_kernel)\b")


def read(run):
    queries = run.counts.get("queries", 0)
    if not queries or not run.device_ops:
        return None
    glue = run.device_seconds() - run.device_seconds(KERNELS)
    return 1e3 * glue / (queries / 4096)
