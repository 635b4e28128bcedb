"""Seconds from process start to the window's opening: import, weights, engine build with buddy profiling, and the warm-up steps."""
from chipbench import readers


def read(run):
    return run.setup["setup_s"]
