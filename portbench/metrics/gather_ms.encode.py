"""The record gather of a batch of the encode window, ms: the mean
`cocodr.feed.produce` span (data/prefetch.py's producer thread taking the
next batch of records off the token cache)."""
from portbench import spans


def read(run):
    return spans.mean_ms(run, "cocodr.feed.produce")
