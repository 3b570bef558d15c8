"""The COCO window's useful operations over its seconds and the H100's
bf16 peak, %: each step's operations as roofline.coco_step_flops counts
them (the forward, twice it for the backward, the MLM head over the
labelled rows, the contrastive product), counted by the driver."""


def read(run):
    return run.mfu_percent()
