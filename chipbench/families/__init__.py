"""The architectures the benchmark can build and judge, one module a family:
``chipbench/families/<name>.py``, named by a configuration file's
``"family"`` and found by that name, as ``bench.reader`` finds a metric's
reader. A configuration of a new architecture brings a module of its own;
no other file of the benchmark knows an architecture.

A family module gives:

* ``CFG_KEYS``: {``as_run`` key: the program config's attribute path} that
  must be equal before a run starts;
* ``TINY``: {the launcher's ``--arch``: the ``as_run`` of its
  ``--reduced`` config}, for the CPU tests (``chipbench/tiny.py``);
* ``shapes(rc)``: {leaf path: (shape, scale)} in the port's ``params``
  layout and in draw order, scale None for a norm gain; a path
  ``groups.<i>.<...>`` lies in the i-th group of layers
  (``chipbench/weights.py`` draws them);
* ``Reference(params, rc, arith)``: the plain float32 forward, importing
  nothing of the program: ``forward(tokens, seqs, route, head_at,
  capacity, follow)`` -> (logits, the router's own top-k
  ``[moe_layers, N, K]``), where ``route`` (``reference.moe_lm.Routing``)
  and ``follow`` are indexed by MoE layer as well;
* ``moe_layers(rc)``: the number of MoE layers; every array the check and
  ``reference.residency.Replay`` keep per layer has this many;
* ``active_params(rc)``: per-token active parameters by the serving
  runtime's own count, which prices the residency replay's modeled compute;
* ``layer_flops(rc, ctx, layer)``: operations of one token through layer
  ``layer`` at context ``ctx`` (``yardstick.token_flops`` sums them).
"""
from __future__ import annotations

import importlib.util
import re
from pathlib import Path

DIR = Path(__file__).resolve().parent
_NAME = re.compile(r"^[A-Za-z_][A-Za-z0-9_]{0,63}$")


def load(name, where: Path = DIR):
    """The module of family ``name`` under ``where``; a configuration that
    names none, or one that has no module there, stops the run."""
    if not isinstance(name, str) or not _NAME.match(name):
        raise SystemExit(f"chipbench: the configuration names no family "
                         f"(got {name!r}); give it \"family\": <a module "
                         "of chipbench/families/>")
    path = Path(where) / f"{name}.py"
    if not path.is_file():
        known = sorted(p.stem for p in Path(where).glob("*.py")
                       if not p.stem.startswith("_"))
        raise SystemExit(f"chipbench: no family {name!r} ({path} does not "
                         f"exist; families: {known})")
    spec = importlib.util.spec_from_file_location(
        f"chipbench_family_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
