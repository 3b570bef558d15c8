"""The training loop's wait for its next batch, ms a step of the COCO
window: the mean `cocodr.feed.wait` span (data/prefetch.py, the get on the
prefetch queue; one a step)."""
from portbench import spans


def read(run):
    return spans.mean_ms(run, "cocodr.feed.wait")
