"""Share of the traced search window in which no operation ran on the
device, %."""


def read(run):
    return run.idle_percent()
