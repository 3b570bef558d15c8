"""Device time a step of the COCO window, ms: every device operation of
the traced window (kernels, copies, sets) over the steps it took."""


def read(run):
    steps = run.counts.get("steps", 0)
    busy = run.device_seconds()
    if not steps or not busy:
        return None
    return 1e3 * busy / steps
