"""95th percentile, over requests whose first token came in the window, of the wall time from admission to that token."""
from chipbench import readers


def read(run):
    return readers.ttft_p95_ms(run)
