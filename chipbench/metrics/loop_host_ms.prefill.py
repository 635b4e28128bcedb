"""Host ms per prefill step outside the engine's step / prefill_rows and sample_tokens: the scheduler's own loop."""
from chipbench import readers


def read(run):
    return readers.loop_host_ms(run, "prefill")
