"""The port's example scripts (``examples/torch_*.py``) run on the CPU to
their end, in a fresh interpreter each, and print their results. Their
engines and functions are held against the JAX package elsewhere
(tests/test_torch_engine.py, test_torch_similarity.py,
test_torch_moe_train.py, ...). The MoE training twin runs 41 steps of its
reduced config at lr 3e-3 (the default 1e-3 is for its 200-step run: over
41 steps of 256 tokens its loss moves less than one batch's noise), must
pass its convergence check, and its checkpoint must load into the
reference example's parameter tree."""
import importlib.util
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
    ("torch_train_moe_100m.py", ["--reduced", "--steps", "41", "--batch",
                                 "8", "--seq", "32", "--lr", "3e-3",
                                 "--save", "{tmp}/moe.npz"], "checkpoint"),
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
    if script == "torch_train_moe_100m.py":
        _load_in_reference(tmp_path / "moe.npz")


def _load_in_reference(path):
    """The checkpoint restores into the reference example's reduced
    parameter tree (same keys and shapes), with finite values."""
    import jax
    import numpy as np
    from repro.checkpoint.io import load_pytree
    from repro.models import transformer
    spec = importlib.util.spec_from_file_location(
        "train_moe_100m", ROOT / "examples" / "train_moe_100m.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    like = transformer.init_params(ref.config_100m(True),
                                   jax.random.PRNGKey(0))
    loaded = load_pytree(str(path), like)
    assert all(np.all(np.isfinite(a)) for a in jax.tree.leaves(loaded))
