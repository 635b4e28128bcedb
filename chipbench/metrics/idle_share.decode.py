"""Percent of the traced decode steps' window with no device op running."""
from chipbench import readers


def read(run):
    return readers.idle_share(run, "decode")
