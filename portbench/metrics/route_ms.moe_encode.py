"""The host's time inside the router a batch of the MoE encode window, ms:
the `cocodr.moe.route` spans (ops/moe.py::route: the router's product,
softmax, top k, the sort into expert order and the gather of the rows, one
a MoE layer) summed over the window, less the time their kernel launches
and asynchronous copies spend in the CUDA runtime, over the window's
batches. The host runs a full launch queue ahead of the card in this cell,
so each launch waits for a free slot, for as long as the card takes to
free one: that wait is the card's pace, not the router's, and is left out.
A host sync inside the router (a cudaStreamSynchronize, a blocking copy)
stays in and shows as a jump."""
from portbench import spans

QUEUED = ("cudaLaunch", "cuLaunch", "cudaMemcpyAsync", "cudaMemsetAsync")


def read(run):
    found = spans.spans(run, "cocodr.moe.route")
    batches = run.counts.get("batches", 0)
    if not found or not batches:
        return None
    launches = spans.union((s, s + d) for n, s, d, _ in run.host_ops
                           if n.startswith(QUEUED))
    inside = spans.subtract(found, launches)
    return 1e3 * spans.seconds(inside) / batches
