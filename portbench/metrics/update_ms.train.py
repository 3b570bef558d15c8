"""The host's time in a step's update of the COCO window, ms: the mean
`cocodr.coco.update` span (pipelines/train_step.py::apply_gradients: the
clip and the optimizer's step)."""
from portbench import spans


def read(run):
    return spans.mean_ms(run, "cocodr.coco.update")
