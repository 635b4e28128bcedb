"""Output tokens emitted in the window per second of the window."""
from chipbench import readers


def read(run):
    return readers.output_tokens_per_s(run)
