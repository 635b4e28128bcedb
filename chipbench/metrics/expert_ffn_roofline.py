"""Percent of its bound that expert_ffn reaches: the filled rows' operations and the live experts' bytes, over the CUDA-event time of its calls."""
from chipbench import readers


def read(run):
    return readers.roofline(run, "expert_ffn")
