"""Share of the COCO window in which the device idles while the training
loop waits for its next batch (`cocodr.feed.wait`), %: the card waiting on
the collator. With step_idle_share.train it never exceeds
idle_share.train: the two spans take turns on one thread."""
from portbench import spans


def read(run):
    return spans.idle_share(run, "cocodr.feed.wait")
