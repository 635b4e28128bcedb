"""The port stands alone: importing every ``repro_torch`` module, and
bringing up the sharded dry run's fake process group (torch's own
backend), pulls in no JAX and nothing of the JAX package (checked in a
fresh interpreter, since the test process itself has JAX loaded), and no
source file of the port, its examples (``examples/torch_*.py``) or the
chip smoke script imports either."""
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
       "repro_torch.serving.requests", "repro_torch.runtime.paged_kv",
       "repro_torch.serving.prefix", "repro_torch.runtime.trace",
       "repro_torch.runtime.telemetry", "repro_torch.runtime.placement",
       "repro_torch.core.similarity", "repro_torch.configs.mixtral_8x7b",
       "repro_torch.configs.mixtral_8x22b",
       "repro_torch.configs.internlm2_1p8b",
       "repro_torch.configs.internlm2_20b",
       "repro_torch.configs.phi3_medium_14b",
       "repro_torch.configs.smollm_360m", "repro_torch.launch.mesh",
       "repro_torch.launch.sharding", "repro_torch.launch.roofline",
       "repro_torch.launch.dryrun")
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for n in names:
    importlib.import_module(n)
# the sharded dry run's fake process group: torch's own backend
from repro_torch.launch.mesh import fake_mesh, make_test_mesh
with fake_mesh(make_test_mesh(8)) as m:
    assert m.size() == 8
fake = "torch.testing._internal.distributed.fake_pg" in sys.modules
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), int(all(m in names for m in NEW) and fake), bad)
"""


def test_importing_every_module_loads_no_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n, tier, bad = out.stdout.strip().split(" ", 2)
    assert int(n) >= 47, out.stdout          # the walk found the package
    assert tier == "1", out.stdout           # ... the later slices' too
    assert bad == "[]", f"modules loaded by repro_torch: {bad}"


_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|$)",
                     re.MULTILINE)


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")]
    + [str(p.relative_to(ROOT))
       for p in (ROOT / "examples").glob("torch_*.py")]
    + ["chip_smoke.py"]))
def test_source_imports_no_jax(path):
    text = (ROOT / path).read_text()
    assert not _IMPORT.search(text), f"{path} imports JAX or the JAX package"
