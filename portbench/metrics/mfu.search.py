"""The search window's useful operations over its seconds and the H100's
bf16 peak, %: the exact score product, 2 Q N D a chunk over the corpus's
real rows (roofline.search_flops, counted by the driver)."""


def read(run):
    return run.mfu_percent()
