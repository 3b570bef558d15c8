"""The host's time in a step of the COCO window, ms: the mean
`cocodr.coco.step` span (pipelines/coco.py's step: the forward's and the
backward's launches, the update). Compare with step_card_ms.train."""
from portbench import spans


def read(run):
    return spans.mean_ms(run, "cocodr.coco.step")
