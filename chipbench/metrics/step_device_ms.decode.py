"""Device busy ms per traced decode step: the union of device op intervals in the torch.profiler trace."""
from chipbench import readers


def read(run):
    return readers.step_device_ms(run, "decode")
