"""The port's example scripts (``examples/torch_*.py``) run on the CPU to
their end, in a fresh interpreter each, and print their results. Their
engines and functions are held against the JAX package elsewhere
(tests/test_torch_engine.py, test_torch_similarity.py, ...)."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("script,args,expect", [
    ("torch_quickstart.py", [], "throughput gain"),
    ("torch_profile_and_build_buddies.py", ["--out", "{tmp}/tables.npz"],
     "serialized buddy tables"),
    ("torch_serve_buddymoe.py", [], "stall breakdown"),
    ("torch_serve_buddymoe.py", ["--continuous", "--prefill-chunk", "8",
                                 "--quant-tier", "int8", "--tier-coverage",
                                 "0.5"], "8/8 done"),
])
def test_example_runs_on_cpu(tmp_path, script, args, expect):
    # one intra-op thread: the examples' models are tiny, and the test
    # workers share the machine's cores
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, str(ROOT / "examples" / script), "--device", "cpu"]
        + [a.format(tmp=tmp_path) for a in args],
        env=env, cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert expect in out.stdout, out.stdout[-2000:]
    if script == "torch_profile_and_build_buddies.py":
        assert (tmp_path / "tables.npz").exists()
