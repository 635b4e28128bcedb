"""Production dry run as meta-device accounting: trace every (arch x input
shape) step as one device of the production mesh, on the meta device,
under an op counter, and report per-device memory, FLOPs, bytes,
collectives and the roofline terms.

Counterpart of ``repro/launch/dryrun.py``, which lowers and compiles each
step with ``NamedSharding``s for 256 or 512 fake devices and reads one
device's partitioned program. Here nothing is compiled or allocated: the
step runs once as rank 0 of a ``launch.mesh.fake_mesh`` of the production
shape, its arguments DTensors of rank 0's meta blocks under their
sanitized partition specs (``launch.sharding.to_dtensors``), the model's
``shard`` hints redistributing its activations under the reference's
activation rules, and its outputs redistributed to their specs at the end,
as the reference's ``out_shardings`` place them. ``roofline.OpCounter``
counts rank 0's local ops (``"split": "sharded"``). Per device:

  * memory: the arguments' and outputs' bytes under their sanitized
    partition specs (exact; the arguments' DTensor blocks hold exactly
    these bytes), and ``temp_size_bytes``: the peak of the step's new
    storages less its new outputs (``OpCounter.temp_bytes``);
  * FLOPs and bytes of the local ops and the kernels' charges at their
    local shapes; the collectives' bytes by op type and their counts (the
    reference's ``hlo_analysis`` keys), and from them the collective term.

``make_case`` and ``trace`` trace one step unsharded on any device, as
the smoke's card cases run it; their counter carries the same peak and
temporaries.

    python -m repro_torch.launch.dryrun --arch all --shape all
    python -m repro_torch.launch.dryrun --reanalyze   # stored counts, H100 spec as it stands

One JSON per case goes to ``results/dryrun_torch/`` (git-ignored).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import json
import os
import time
import traceback
from pathlib import Path
from typing import NamedTuple

import torch

from repro_torch.configs.base import ARCH_IDS, SHAPES, ModelConfig, get_config
from repro_torch.core.policy import BuddyPolicy
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import fake_mesh, make_production_mesh
from repro_torch.launch.sharding import (P, ShardingProfile, activation_rules,
                                         bytes_per_device, param_specs,
                                         _zip_specs, placements,
                                         profile_for, sanitize_spec,
                                         sanitize_specs, to_dtensors)
from repro_torch.models import transformer
from repro_torch.models.common import axis_rules
from repro_torch.models.moe import BuddyState
from repro_torch.training.optimizer import (AdamWConfig, OptState,
                                            init_opt_state)
from repro_torch.training.train_loop import make_train_step

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"
R_MAX = 8


# ---------------------------------------------------------------------------
# Inputs (meta tensors: shapes and dtypes, no memory)
# ---------------------------------------------------------------------------
def params_struct(cfg: ModelConfig, device="meta"):
    """The model's parameters on meta: every shape and dtype, no memory."""
    return transformer.init_params(cfg, device=device)


def cond_struct(cfg: ModelConfig, batch: int, device="meta"):
    if cfg.num_cond_tokens:
        return torch.zeros((batch, cfg.num_cond_tokens, cfg.cond_dim),
                           dtype=torch.bfloat16, device=device)
    return None


def _moe_layers(cfg: ModelConfig) -> int:
    return sum(r for k, r in cfg.stack() if k == "attn_moe")


def buddy_struct(cfg: ModelConfig, device="meta"):
    """A MoE stack's BuddyState with R_MAX buddies per expert, stacked on
    the MoE layers."""
    if not cfg.is_moe:
        return None
    n, e = _moe_layers(cfg), cfg.moe.num_experts
    return BuddyState(
        resident=torch.zeros((n, e), dtype=torch.bool, device=device),
        table=torch.zeros((n, e, R_MAX), dtype=torch.int32, device=device),
        q=torch.zeros((n, e, R_MAX), dtype=torch.float32, device=device),
        hop=torch.zeros((n, e), dtype=torch.int32, device=device))


def _random_buddies(gen, n_layers: int, e: int) -> torch.Tensor:
    """[L, E, R_MAX] int32: each expert's buddies, the other experts in a
    random order, -1 past the last."""
    table = torch.full((n_layers * e, R_MAX), -1, dtype=torch.int32)
    for i in range(n_layers * e):
        perm = torch.randperm(e, generator=gen)
        others = perm[perm != i % e][:R_MAX]
        table[i, :len(others)] = others.to(torch.int32)
    return table.reshape(n_layers, e, R_MAX)


def _inputs(cfg: ModelConfig, kind: str, batch: int, seq: int, device,
            gen=None) -> dict:
    """The token inputs and conditioning of a step: zeros without ``gen``
    (meta holds no values anyway), else random from ``gen``."""
    dev = torch.device(device)

    def ints(shape):
        if gen is None:
            return torch.zeros(shape, dtype=torch.int64, device=dev)
        return torch.randint(0, cfg.vocab_size, shape, generator=gen).to(dev)

    out = {"tokens": ints((batch, seq))}
    if kind == "train":
        out["targets"] = ints((batch, seq))
    if kind == "decode":
        out["token"] = ints((batch,))
        out["pos"] = seq - 1
    c = cond_struct(cfg, batch, dev)
    if c is not None:
        out["cond"] = c if gen is None else \
            torch.randn(c.shape, generator=gen).to(c)
    return out


def input_specs(cfg: ModelConfig, shape_name: str, device="meta") -> dict:
    """Every model input for the shape: tokens [B, S] (int64, as the port's
    launchers index), targets for training, the decode step's token [B]
    and position (a host int: the shape's last), and the conditioning
    where the config has it."""
    shp = SHAPES[shape_name]
    return _inputs(cfg, shp.kind, shp.global_batch, shp.seq_len, device)


# ---------------------------------------------------------------------------
# Sharding spec trees
# ---------------------------------------------------------------------------
def _cache_spec_tree(cfg: ModelConfig, prof: ShardingProfile, rules: dict):
    """Partition specs mirroring transformer.init_caches' structure."""
    bt = prof.batch
    kvh, hd = rules.get("cache_heads"), rules.get("cache_hd")
    cseq = rules.get("cache_seq")
    kv = {"k": P(None, bt, cseq, kvh, hd),
          "v": P(None, bt, cseq, kvh, hd)}
    specs = []
    for kind, _ in cfg.stack():
        if kind in ("attn_dense", "attn_moe"):
            specs.append({"kv": kv})
        elif kind == "rwkv6":
            specs.append({"wkv": P(None, bt, "model", None, None),
                          "x_tm": P(None, bt, None, None),
                          "x_cm": P(None, bt, None, None)})
        elif kind == "mamba2":
            specs.append({"conv": P(None, bt, None, "model"),
                          "ssm": P(None, bt, "model", None, None)})
        elif kind == "hybrid_super":
            specs.append({
                "mamba": {"conv": P(None, None, bt, None, "model"),
                          "ssm": P(None, None, bt, "model", None, None)},
                "kv": kv})
        elif kind == "vlm_super":
            specs.append({
                "self_kv": {"k": P(None, None, bt, cseq, kvh, hd),
                            "v": P(None, None, bt, cseq, kvh, hd)},
                "cross_kv": (P(None, bt, None, kvh, hd),
                             P(None, bt, None, kvh, hd))})
        else:
            raise ValueError(kind)
    return tuple(specs)


def _bf16(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, dtype="bfloat16")


# ---------------------------------------------------------------------------
# One step: its arguments, its function, its specs
# ---------------------------------------------------------------------------
class Case(NamedTuple):
    kind: str                # train | prefill | decode
    window: int              # decode's attention window (0: full)
    args: dict               # name -> tensor tree (or the decode pos int)
    fn: object               # fn(args) -> {name: output tree}


def _is_tensor_tree(x) -> bool:
    return not isinstance(x, (int, float))


def make_case(cfg: ModelConfig, kind: str, batch: int, seq: int, *,
              device="meta", params=None,
              long_context: bool = False) -> Case:
    """The step of ``kind`` at [batch, seq] and its arguments on ``device``.
    On meta every argument is a meta tensor; on a real device the tokens,
    buddy tables and conditioning are random from seed 0 (caches and
    optimizer state zero) and ``params`` default to ``init_params``'. The
    train step is the reference dry run's: ``lm_loss`` forward and
    backward with remat, then the AdamW update; prefill is
    ``forward_train`` (train and prefill attend through
    ``attention._flash_attend``'s kv-chunk loop, whose padded products
    are the reference's); decode is ``decode_step`` with
    ``BuddyPolicy()`` and the buddy state for MoE stacks, at
    ``effective_window``."""
    dev = torch.device(device)
    meta = dev.type == "meta"
    gen = torch.Generator().manual_seed(0)
    if params is None:
        params = params_struct(cfg) if meta else transformer.init_params(
            cfg, torch.Generator(device=dev).manual_seed(0), dev)
    args = {"params": params,
            **_inputs(cfg, kind, batch, seq, dev, None if meta else gen)}
    window = 0
    if kind == "train":
        args["opt_state"] = init_opt_state(params)
        step = make_train_step(cfg, AdamWConfig(), remat=True)

        def fn(a):
            p, o, m = step(a["params"], a["opt_state"], a["tokens"],
                           a["targets"], None, cond_embeds=a.get("cond"))
            return {"params": p, "opt_state": o,
                    "metrics": {k: v for k, v in m.items()
                                if isinstance(v, torch.Tensor)}}
    elif kind == "prefill":
        def fn(a):
            with torch.no_grad():
                logits, _ = transformer.forward_train(
                    a["params"], cfg, a["tokens"], cond_embeds=a.get("cond"))
            return {"logits": logits}
    else:
        del args["tokens"]                    # decode takes one token
        window = transformer.effective_window(cfg, seq,
                                              long_context=long_context)
        args["caches"] = transformer.init_caches(cfg, batch, seq,
                                                 window=window, device=dev)
        if "cond" not in args and cfg.is_moe:
            bd = buddy_struct(cfg, dev)
            if not meta:
                bd = BuddyState(
                    resident=torch.rand(bd.resident.shape, generator=gen)
                    .lt(0.5).to(dev),
                    table=_random_buddies(gen, *bd.resident.shape).to(dev),
                    q=torch.rand(bd.q.shape, generator=gen).to(dev),
                    hop=bd.hop)
            args["buddies"] = bd

        def fn(a):
            with torch.no_grad():
                logits, caches, _ = transformer.decode_step(
                    a["params"], cfg, a["token"], a["caches"], a["pos"],
                    cond_embeds=a.get("cond"),
                    policy=BuddyPolicy() if cfg.is_moe else None,
                    buddies=a.get("buddies"), window=window)
            return {"logits": logits, "caches": caches}
    return Case(kind, window, args, fn)


def case_specs(cfg: ModelConfig, case: Case, outputs: dict,
               prof: ShardingProfile, rules: dict) -> tuple:
    """(argument specs, output specs): name -> spec tree, unsanitized;
    ``outputs`` (name -> tree, or the train step's metric names under
    "metrics") picks the output names."""
    bt = prof.batch
    p_spec = param_specs(cfg, case.args["params"], prof)
    specs = {"params": p_spec, "tokens": P(bt, None),
             "targets": P(bt, None), "token": P(bt),
             "cond": P(bt, None, None),
             "opt_state": OptState(P(), p_spec, p_spec)}
    if "caches" in case.args:
        specs["caches"] = _cache_spec_tree(cfg, prof, rules)
    if "buddies" in case.args:
        specs["buddies"] = BuddyState(*(None if a is None else P()
                                        for a in case.args["buddies"]))
    arg_specs = {k: specs[k] for k, v in case.args.items()
                 if _is_tensor_tree(v)}
    out_specs = {"params": p_spec, "opt_state": specs["opt_state"],
                 "metrics": {k: P() for k in outputs.get("metrics", {})},
                 "caches": specs.get("caches"),
                 "logits": P(bt, None, None) if case.kind == "prefill"
                 else P(bt, None)}
    return arg_specs, {k: out_specs[k] for k in outputs}


def memory_per_device(trees: dict, specs: dict, mesh) -> dict:
    """name -> bytes one device holds of each tree under its sanitized
    spec tree."""
    return {k: bytes_per_device(trees[k], sanitize_specs(specs[k], trees[k],
                                                         mesh), mesh)
            for k in specs}


def trace(case: Case) -> tuple:
    """Run the case's step once, unsharded, under an OpCounter (its
    arguments registered, so its peak and ``temp_size_bytes`` are the
    step's own). Returns (counter, outputs)."""
    with rl.OpCounter() as counter:
        counter.arguments(case.args)
        outputs = case.fn(case.args)
        counter.temp_size_bytes = counter.temp_bytes(outputs)
    return counter, outputs


_TRAIN_METRICS = ("ce", "grad_norm", "lb", "loss", "lr")


def _place_outputs(outputs: dict, out_specs: dict, mesh, mesh_shape):
    """Each output DTensor redistributed to its sanitized spec, as the
    reference's ``out_shardings`` place them."""
    def one(spec, leaf):
        if not hasattr(leaf, "device_mesh"):
            return leaf
        want = placements(sanitize_spec(spec, tuple(leaf.shape),
                                        mesh_shape), mesh, leaf.ndim)
        if tuple(leaf.placements) == want:
            return leaf
        return leaf.redistribute(mesh, want)
    return {k: _zip_specs(one, out_specs[k], v) for k, v in outputs.items()}


class Sharded(NamedTuple):
    step: object             # step(counter=None) -> outputs (DTensors)
    argument_local_bytes: int    # of rank 0's blocks of the arguments


@contextlib.contextmanager
def sharded(fn, args: dict, arg_specs: dict, out_specs: dict, mesh_shape,
            rules: dict, device_type: str = "cpu"):
    """``fn(args)`` as rank 0 of ``mesh_shape`` over the fake backend
    (``fake_mesh`` on ``device_type``, up for the context): the arguments
    named in ``arg_specs`` become DTensors of rank 0's blocks under their
    sanitized specs (the rest, a host int, as they are). Yields a
    ``Sharded`` whose ``step(counter)`` runs ``fn`` with the model's hints
    under ``rules``, the plain tensors the step makes taken as replicated
    (``implicit_replication``), and the outputs named in ``out_specs``
    placed by them, as the reference's ``out_shardings`` place them;
    given an ``OpCounter``, under it, with the arguments registered and
    its ``temp_size_bytes`` set."""
    from torch.distributed.tensor.experimental import implicit_replication
    with fake_mesh(mesh_shape, device_type) as mesh:
        args = dict(args)
        for k, spec in arg_specs.items():
            args[k] = to_dtensors(args[k], spec, mesh, mesh_shape)
        local_bytes = sum(t._local_tensor.numel()
                          * t._local_tensor.element_size()
                          for t in transformer.tree_leaves(
                              [args[k] for k in arg_specs])
                          if t is not None)

        def step(counter=None):
            with contextlib.ExitStack() as stack:
                if counter is not None:
                    stack.enter_context(counter)
                    counter.arguments(args)
                stack.enter_context(axis_rules(rules))
                stack.enter_context(implicit_replication())
                outputs = _place_outputs(fn(args), out_specs, mesh,
                                         mesh_shape)
                if counter is not None:
                    counter.temp_size_bytes = counter.temp_bytes(outputs)
            return outputs
        yield Sharded(step, local_bytes)


def run_sharded(fn, args: dict, arg_specs: dict, out_specs: dict,
                mesh_shape, rules: dict, device_type: str = "cpu") -> dict:
    """One step of ``sharded`` under an OpCounter. Returns the counter,
    the outputs (DTensors) and the arguments' local bytes."""
    with sharded(fn, args, arg_specs, out_specs, mesh_shape, rules,
                 device_type) as sh:
        counter = rl.OpCounter()
        outputs = sh.step(counter)
    return {"counter": counter, "outputs": outputs,
            "argument_local_bytes": sh.argument_local_bytes}


def trace_sharded(cfg: ModelConfig, case: Case, mesh_shape,
                  prof: ShardingProfile, rules: dict,
                  device_type: str = "cpu") -> dict:
    """The case's step through ``run_sharded``, its arguments and outputs
    under ``case_specs``. Returns ``run_sharded``'s dict with the
    argument and output specs."""
    names = {"params": None, "opt_state": None,
             "metrics": dict.fromkeys(_TRAIN_METRICS)} \
        if case.kind == "train" else \
        ({"logits": None} if case.kind == "prefill"
         else {"logits": None, "caches": None})
    arg_specs, out_specs = case_specs(cfg, case, names, prof, rules)
    out = run_sharded(case.fn, case.args, arg_specs, out_specs, mesh_shape,
                      rules, device_type)
    return dict(out, arg_specs=arg_specs, out_specs=out_specs)


def trace_case(cfg: ModelConfig, shape_name: str, mesh,
               prof: ShardingProfile) -> dict:
    """Trace one (arch x shape) step sharded on meta, cfg cast to bf16.
    Returns the counter, the case, its outputs and the spec trees."""
    shp = SHAPES[shape_name]
    cfg = _bf16(cfg)
    rules = activation_rules(prof, cfg, mesh.shape["model"])
    case = make_case(cfg, shp.kind, shp.global_batch, shp.seq_len,
                     long_context=shp.seq_len >= 262144)
    tr = trace_sharded(cfg, case, mesh, prof, rules)
    return dict(tr, cfg=cfg, case=case)


# ---------------------------------------------------------------------------
# Run + report
# ---------------------------------------------------------------------------
def _report(arch, shape_name, mesh_name, chips, flops, nbytes,
            coll_bytes) -> rl.RooflineReport:
    """The case's roofline from its per-device counts under
    ``roofline.H100``, read at the call, so a stored count is recomputed
    against the spec as it now stands."""
    cfg = get_config(arch)
    shp = SHAPES[shape_name]
    return rl.RooflineReport(
        arch=arch, shape=shape_name, mesh=mesh_name, chips=chips,
        flops_per_device=flops, bytes_per_device=nbytes,
        coll_bytes_per_device=coll_bytes, dtype="bfloat16",
        model_flops=rl.model_flops(cfg, shp.kind, shp.seq_len,
                                   shp.global_batch)).finalize(rl.H100)


def _roofline_dict(report: rl.RooflineReport) -> dict:
    return dict(report.as_dict(), split="sharded",
                link=rl.H100.link_name)


def run_one(arch: str, shape_name: str, multi_pod: bool = False,
            save: bool = True, verbose: bool = True,
            cache_layout: str = "auto", results_dir=None) -> dict:
    cfg = get_config(arch)
    mesh = make_production_mesh(multi_pod=multi_pod)
    prof = profile_for(cfg, multi_pod=multi_pod,
                       train=SHAPES[shape_name].kind == "train")
    if cache_layout != "auto":
        prof = dataclasses.replace(prof, cache_layout=cache_layout)
    mesh_name, chips = mesh.name, mesh.size
    t0 = time.perf_counter()
    tr = trace_case(cfg, shape_name, mesh, prof)
    trace_s = time.perf_counter() - t0
    case, counter = tr["case"], tr["counter"]
    args_b = memory_per_device(case.args, tr["arg_specs"], mesh)
    outs_b = memory_per_device(tr["outputs"], tr["out_specs"], mesh)
    coll = counter.collectives()
    report = _report(arch, shape_name, mesh_name, chips, counter.flops,
                     counter.bytes, coll["coll_bytes"])
    out = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "chips": chips,
        "device": "meta", "meta": {"kind": case.kind, "window": case.window},
        "trace_s": trace_s,
        "memory": {"argument_size_bytes": sum(args_b.values()),
                   "argument_bytes_by_input": args_b,
                   "output_size_bytes": sum(outs_b.values()),
                   "output_bytes_by_output": outs_b,
                   "temp_size_bytes": counter.temp_size_bytes,
                   "peak_bytes": counter.peak_bytes},
        "counts": counter.as_dict(),
        "hlo_analysis": dict(coll, flops=counter.flops,
                             traffic_bytes=counter.bytes),
        "roofline": _roofline_dict(report),
    }
    if verbose:
        ma = out["memory"]
        print(f"[dryrun] {arch} {shape_name} {mesh_name}: trace "
              f"{trace_s:.1f}s | args {_gb(ma['argument_size_bytes'])} "
              f"temp {_gb(ma['temp_size_bytes'])} | flops/dev "
              f"{counter.flops:.3e} bytes/dev {counter.bytes:.3e} coll/dev "
              f"{coll['coll_bytes']:.3e} {coll['coll_counts']}")
        print("         " + rl.summarize(report))
    if save:
        d = Path(results_dir or RESULTS_DIR)
        d.mkdir(parents=True, exist_ok=True)
        with open(d / f"{arch}_{shape_name}_{mesh_name}.json", "w") as f:
            json.dump(out, f, indent=1)
    return out


def reanalyze_all(results_dir=None) -> None:
    """Recompute every stored case's roofline from its stored counts under
    ``roofline.H100`` (no trace)."""
    d = Path(results_dir or RESULTS_DIR)
    for fn in sorted(glob.glob(os.path.join(d, "*.json"))):
        with open(fn) as f:
            out = json.load(f)
        report = _report(out["arch"], out["shape"], out["mesh"],
                         out["chips"], out["counts"]["flops"],
                         out["counts"]["bytes"],
                         out["hlo_analysis"]["coll_bytes"])
        out["roofline"] = _roofline_dict(report)
        with open(fn, "w") as f:
            json.dump(out, f, indent=1)
        print("[reanalyze] " + rl.summarize(report))


def _gb(x):
    return f"{x / 1e9:.2f}GB" if x is not None else "?"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="arch id or 'all'")
    ap.add_argument("--shape", default=None, help="shape name or 'all'")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--reanalyze", action="store_true",
                    help="recompute rooflines from the stored counts")
    ap.add_argument("--cache-layout", default="auto",
                    choices=["auto", "seq"])
    args = ap.parse_args(argv)
    if args.reanalyze:
        reanalyze_all()
        return

    archs = ARCH_IDS[:10] if args.arch in (None, "all") else [args.arch]
    shapes = list(SHAPES) if args.shape in (None, "all") else [args.shape]
    mesh_name = make_production_mesh(multi_pod=args.multi_pod).name
    failures = []
    t0 = time.perf_counter()
    for arch in archs:
        for shape in shapes:
            fn = RESULTS_DIR / f"{arch}_{shape}_{mesh_name}.json"
            if args.skip_existing and fn.exists():
                print(f"[dryrun] skip {arch} {shape} {mesh_name} (exists)")
                continue
            try:
                run_one(arch, shape, args.multi_pod,
                        cache_layout=args.cache_layout)
            except Exception as e:  # noqa: BLE001
                failures.append((arch, shape, repr(e)))
                print(f"[dryrun] FAIL {arch} {shape}: {e}")
                traceback.print_exc(limit=4)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f)
        raise SystemExit(1)
    print(f"\nall dry-runs passed in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
