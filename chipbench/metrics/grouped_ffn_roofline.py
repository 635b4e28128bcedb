"""Percent of its bound that grouped_ffn reaches: the routed rows' operations and the live experts' bytes, over the CUDA-event time of its calls."""
from chipbench import readers


def read(run):
    return readers.roofline(run, "grouped_ffn")
