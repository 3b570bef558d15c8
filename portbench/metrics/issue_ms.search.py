"""The host's time in the search per 4,096 queries of the search window, ms:
the `cocodr.search` spans (ops/mips.py::mips_topk_chunked_queries) less
their `cocodr.search.to_host` spans (each chunk's copy of its answers,
which waits for the card), over the driver's count of queries, as
glue_card_ms.search counts them."""
from portbench import spans


def read(run):
    queries = run.counts.get("queries", 0)
    found = spans.spans(run, "cocodr.search")
    if not queries or not found:
        return None
    host = spans.subtract(found, spans.spans(run, "cocodr.search.to_host"))
    return 1e3 * spans.seconds(host) / (queries / 4096)
