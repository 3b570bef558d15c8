"""The encode window's useful operations over its seconds and the H100's
bf16 peak, %: each record's encoder forward at its own length, so padding
is not useful work (roofline.encoder_forward_flops, counted by the
driver)."""


def read(run):
    return run.mfu_percent()
