"""The port stands alone: importing every ``repro_torch`` module pulls in no
JAX and nothing of the JAX package (checked in a fresh interpreter, since
the test process itself has JAX loaded), and no source file of the port or
the chip smoke script imports either."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_PROBE = r"""
import importlib, pkgutil, sys
import repro_torch
NEW = ("repro_torch.core.quantize", "repro_torch.runtime.tiers",
       "repro_torch.kernels.quant_ffn", "repro_torch.kernels.wkv_chunk",
       "repro_torch.models.rwkv", "repro_torch.configs.rwkv6_1p6b",
       "repro_torch.training.optimizer", "repro_torch.training.train_loop",
       "repro_torch.launch.train", "repro_torch.serving.scheduler",
       "repro_torch.serving.requests")
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), int(all(m in names for m in NEW)), bad)
"""


def test_importing_every_module_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, tier, bad = out.stdout.strip().split(" ", 2)
    assert int(n) >= 44, out.stdout          # the walk found the package
    assert tier == "1", out.stdout           # ... the later slices' too
    assert bad == "[]", f"modules loaded by repro_torch: {bad}"


_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                     re.MULTILINE)


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")]
    + ["chip_smoke.py"]))
def test_source_imports_no_jax(path):
    text = (ROOT / path).read_text()
    assert not _IMPORT.search(text), f"{path} imports JAX or the JAX package"
