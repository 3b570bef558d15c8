"""Device time a batch of the encode window, ms: every device operation of
the traced window (kernels, copies, sets) over the batches it encoded."""


def read(run):
    batches = run.counts.get("batches", 0)
    busy = run.device_seconds()
    if not batches or not busy:
        return None
    return 1e3 * busy / batches
