"""Seconds of the launcher's offline buddy profiling (serve.profile_buddies) in set-up."""
from chipbench import readers


def read(run):
    return run.setup.get("profile_s")
