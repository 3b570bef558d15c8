"""The collator's time a batch of the COCO window, ms: the mean
`cocodr.coco.collate` span (data/coco_spans.py::span_batches, the
CoCondenserCollator on data/prefetch.py's producer thread)."""
from portbench import spans


def read(run):
    return spans.mean_ms(run, "cocodr.coco.collate")
