"""Share of the COCO window in which the device idles while the host is in
a step (`cocodr.coco.step`), %: the card waiting on the step's own issue."""
from portbench import spans


def read(run):
    return spans.idle_share(run, "cocodr.coco.step")
