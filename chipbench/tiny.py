"""Tiny versions of the benchmark's cells for the CPU tests: the launcher's
``--reduced`` configs of the same architectures (each family's ``TINY``),
a few slots and short requests, and the cells' own flags, traffic shape
and check otherwise."""
from __future__ import annotations

from chipbench import bench

def cell(name: str, slots: int = 4, requests: int = 4,
         root=bench.ROOT) -> dict:
    """``name``'s cell (of the benchmark under ``root``) on its
    architecture's reduced config."""
    c = bench.load_cell(name, root)
    arch = c["config"]["launcher"][1]
    c["config"]["launcher"] = ["--arch", arch, "--reduced"]
    c["config"]["as_run"] = dict(c["family"].TINY[arch])
    flags = c["cell"]["launcher"]
    flags[flags.index("--slots") + 1] = str(slots)
    chunk = flags.index("--prefill-chunk") + 1
    if flags[chunk] != "1":
        flags[chunk] = "8"
        c["mix"].update(prompt_len={"dist": "lognormal", "median": 12,
                                    "sigma": 0.7, "min": 4, "max": 24},
                        block=8, blocks=200)
    else:
        c["mix"].update(prompt_len={"dist": "uniform", "min": 2, "max": 4},
                        output_len={"dist": "uniform", "min": 2, "max": 5},
                        block=8, blocks=200)
    c["cell"]["check"].update(requests=requests, block=2)
    return c


def run(name: str, seed: int = 1234567890123, seconds: float = 1.0,
        **kw) -> "bench.Run":
    """A run of ``name``'s tiny cell. Its requests take a few steps each,
    so that some finish inside a short window however loaded the CPU."""
    r = bench.Run(cell(name, **kw), seed, seconds, False, "cpu")
    r.build()
    r.serve()
    return r
