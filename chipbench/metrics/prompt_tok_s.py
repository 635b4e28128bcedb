"""Valid prompt tokens fed in the window's steps per second of the window."""
from chipbench import readers


def read(run):
    return readers.prompt_tokens_per_s(run)
