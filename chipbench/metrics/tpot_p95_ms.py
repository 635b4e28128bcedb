"""95th percentile of the wall gap between a request's consecutive output tokens, over every gap that ends in the window."""
from chipbench import readers


def read(run):
    return readers.tpot_p95_ms(run)
