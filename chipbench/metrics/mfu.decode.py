"""Percent of the card's float32 peak: the operations the decode steps' valid tokens need over the steps' wall time."""
from chipbench import readers


def read(run):
    return readers.mfu(run, "decode")
