"""Host ms per prefill step in the engine's _account (the replay of the modeled transfer timeline), after the step's device work is done."""
from chipbench import readers


def read(run):
    return readers.account_ms(run, "prefill")
