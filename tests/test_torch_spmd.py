"""The dry run's sharded step (``launch.dryrun.run_sharded``): the port's
``lm_loss`` traced as rank 0 of a 4 x 2 (data, model) fake mesh, its
per-device dot FLOPs and collectives held against the reference's
partitioned HLO (``repro.launch.roofline.analyze_hlo`` of the same loss
lowered with NamedShardings on 8 host devices, as ``test_dryrun_small``
lowers it, on a mesh of Auto axes), and the port's own invariants: the
arguments' local bytes, a 1 x 1 mesh against the unsharded trace, the
peak and temporaries on meta against the CPU, ``shard`` outside the rules,
the process group's lifetime."""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import torch.distributed as dist  # noqa: E402
from torch.distributed.tensor import (DTensor, Partial, Replicate,  # noqa: E402
                                      Shard)

from repro_torch.configs import base  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.launch import sharding as sh  # noqa: E402
from repro_torch.launch.mesh import MeshShape, fake_mesh, make_test_mesh  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.training.train_loop import lm_loss  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ARCHS = ["internlm2-1.8b", "mixtral-8x7b", "deepseek-v2-lite-buddy",
         "rwkv6-1.6b", "zamba2-7b"]
BATCH, SEQ, DATA, MODEL = 8, 32, 4, 2
F32, BF16 = 4, 2
COLL = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
        "collective-permute")

# The reference, for all five configs in one process (the device count is
# fixed before JAX starts): test_dryrun_small's loss lowering on a mesh of
# Auto axes. Per config: analyze_hlo's FLOPs and collective bytes by op
# type, and each op type's count as executed (an op inside a while body
# once per trip; analyze_hlo's coll_counts counts the program text).
SCRIPT = r"""
import os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import dataclasses, json, re, sys
from collections import defaultdict
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import AxisType, Mesh, NamedSharding, PartitionSpec as P
from repro.configs.base import get_reduced
from repro.launch import roofline as rl
from repro.launch.sharding import (ShardingProfile, activation_rules,
                                   param_specs, sanitize_specs)
from repro.models import transformer
from repro.models.common import axis_rules
from repro.training.train_loop import lm_loss

mesh = Mesh(np.array(jax.devices()).reshape(4, 2), ("data", "model"),
            axis_types=(AxisType.Auto,) * 2)


def executed_counts(hlo):
    mod = rl.parse_hlo_module(hlo)
    comps, mult = mod["comps"], defaultdict(float)

    def visit(comp, m):
        mult[comp] += m
        for line in comps.get(comp, []):
            om = rl._OP_RE.match(line)
            trip = 1.0
            if om and om.group(3) == "while":
                t = rl._TRIP_RE.search(line)
                trip = float(t.group(1)) if t else 1.0
            for cre in rl._CALLEE_RES:
                cm = cre.search(line)
                if not cm:
                    continue
                loop = "body=" in cre.pattern or "condition=" in cre.pattern
                for name in cm.group(1).split(","):
                    name = name.strip().lstrip("%")
                    if name in comps:
                        visit(name, m * (trip if loop else 1.0))
    visit(mod["entry"], 1.0)
    counts = defaultdict(float)
    for comp, lines in comps.items():
        for line in lines:
            om = rl._OP_RE.match(line)
            if om:
                op = om.group(3).replace("-start", "")
                if op in ("all-reduce", "all-gather", "reduce-scatter",
                          "all-to-all", "collective-permute"):
                    counts[op] += mult[comp]
    return dict(counts)


for arch in sys.argv[1:]:
    cfg = dataclasses.replace(get_reduced(arch), dtype="bfloat16")
    prof = ShardingProfile()
    rules = activation_rules(prof, cfg, 2)
    key = jax.random.PRNGKey(0)
    p_struct = jax.eval_shape(lambda k: transformer.init_params(cfg, k), key)
    p_spec = param_specs(cfg, p_struct, prof)
    toks = jax.ShapeDtypeStruct((8, 32), jnp.int32)

    def fn(params, tokens, targets, rng):
        with axis_rules(rules):
            return lm_loss(params, cfg, tokens, targets, rng=rng)[0]

    def ns(tree, structs):
        return jax.tree.map(lambda s, x: NamedSharding(mesh, s),
                            sanitize_specs(tree, structs, mesh), structs,
                            is_leaf=lambda x: isinstance(x, P))

    with mesh:
        jitted = jax.jit(fn, in_shardings=(
            ns(p_spec, p_struct), NamedSharding(mesh, P("data", None)),
            NamedSharding(mesh, P("data", None)), NamedSharding(mesh, P())))
        hlo = jitted.lower(p_struct, toks, toks, key).compile().as_text()
    r = rl.analyze_hlo(hlo, 8)
    print(json.dumps({"arch": arch, "flops": r["flops"],
                      "coll_bytes_by_op": r["coll_bytes_by_op"],
                      "counts": executed_counts(hlo)}))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", SCRIPT, *ARCHS],
                         capture_output=True, text=True, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    rows = [json.loads(ln) for ln in out.stdout.splitlines()
            if ln.startswith("{")]
    return {r["arch"]: r for r in rows}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    assert not dist.is_initialized()


def _cfg(arch: str):
    return dataclasses.replace(base.get_reduced(arch), dtype="bfloat16")


def _port_loss(arch: str):
    """The port's lm_loss traced as rank 0 of the 4 x 2 fake mesh, as the
    reference lowers it: the reference's ShardingProfile and rules."""
    cfg = _cfg(arch)
    prof = sh.ShardingProfile()
    rules = sh.activation_rules(prof, cfg, MODEL)
    params = tf.init_params(cfg, device="meta")
    tok = torch.zeros((BATCH, SEQ), dtype=torch.int64, device="meta")
    args = {"params": params, "tokens": tok, "targets": tok}
    specs = {"params": sh.param_specs(cfg, params, prof),
             "tokens": sh.P("data", None), "targets": sh.P("data", None)}

    def fn(a):
        return {"loss": lm_loss(a["params"], cfg, a["tokens"],
                                a["targets"])[0]}
    out = dryrun.run_sharded(fn, args, specs, {"loss": sh.P()},
                             make_test_mesh(DATA * MODEL), rules)
    return cfg, out["counter"]


# ---------------------------------------------------------------------------
# Where the two partitioners differ, each difference from its cause.
# ---------------------------------------------------------------------------
def _ring(n: int) -> float:
    return (n - 1) / n


def _hlo_bytes(result: int, src: int) -> int:
    """analyze_hlo's size of a collective (``roofline.py:389-393``): its
    result's bytes, or the bytes of its operand read through converts when
    those are smaller, but never under half the result (the CPU backend's
    f32 copies of bf16 values)."""
    return min(result, max(src, result // 2))


def _term(op, cause, ref=(0.0, 0), port=(0.0, 0)):
    """One named difference: (bytes, executed count) of op type ``op`` on
    the reference's side and on the port's."""
    return {"op": op, "cause": cause, "ref": ref, "port": port}


def _differences(cfg) -> list:
    """The named differences of one reduced config's loss on 4 x 2, per
    device: B = 2 rows of S = 32 tokens, the model axis 2 devices."""
    b, s, d, layers = BATCH // DATA, SEQ, cfg.d_model, cfg.num_layers
    rows = b * s * d                            # one [B, S, D] activation
    out = []
    if cfg.is_moe:
        e, k = cfg.moe.num_experts, cfg.moe.top_k
        cap = dryrun_capacity(s, k, e)
        buf = e * b * cap * d * F32             # [E, B, C, D] f32
        out.append(_term(
            "all-gather", "XLA's top_k does not partition the batch: it "
            "gathers the router logits [T, E] f32 over data first; the port "
            "routes each device's rows",
            ref=(layers * _ring(DATA) * _hlo_bytes(BATCH * s * e * F32,
                                                   b * s * e * F32),
                 layers)))
        out.append(_term(
            "all-reduce", "XLA merges the load-balance loss's two means "
            "(p_mean, f_frac, [E] f32) into one tuple all-reduce, sized by "
            "analyze_hlo from its first operand; the port reduces each",
            ref=(layers * 2 * _ring(DATA) * e * F32, layers),
            port=(layers * 2 * 2 * _ring(DATA) * e * F32, 2 * layers)))
        port_moe = 2 * _ring(MODEL) * rows * BF16
        if cfg.moe.num_shared_experts:
            shared = b * s * d * F32
            ref_moe = 2 * _ring(MODEL) * _hlo_bytes(shared + buf, shared)
            out.append(_term(
                "all-reduce", "the partial sums over the split d_ff: XLA "
                "reduces the shared expert's [T, D] f32 and the capacity "
                "buffer's expert outputs [E, B, C, D] f32 in one tuple "
                "all-reduce (sized from its first operand); the port "
                "reduces the shared expert's [T, D] f32 and carries the "
                "routed partial sum through the unbin and the weighted "
                "sum to the [B, S, D] bf16 residual",
                ref=(layers * ref_moe, layers),
                port=(layers * (2 * _ring(MODEL) * shared + port_moe),
                      2 * layers)))
        else:
            out.append(_term(
                "all-reduce", "the partial sum over the split d_ff: XLA "
                "reduces the capacity buffer's expert outputs [E, B, C, D] "
                "f32 before the gather back to tokens; the port carries it "
                "through the unbin and the weighted sum to the [B, S, D] "
                "bf16 residual",
                ref=(layers * 2 * _ring(MODEL) * buf, layers),
                port=(layers * port_moe, layers)))
    if cfg.family == "ssm":
        out.append(_term(
            "all-reduce", "ln_x's sum of squares over the head-split "
            "features: XLA all-reduces it [B, S] f32",
            ref=(layers * 2 * _ring(MODEL) * b * s * F32, layers)))
        out.append(_term(
            "reduce-scatter", "... DTensor reduce-scatters it and "
            "gathers it back: the same bytes",
            port=(layers * _ring(MODEL) * b * s * F32, layers)))
        out.append(_term(
            "all-gather", "... the gather back of ln_x's reduce-scatter",
            port=(layers * _ring(MODEL) * b * s * F32, layers)))
        out.append(_term(
            "all-reduce", "the time mix's wo and the channel mix's cv "
            "products over the split features are bf16 dots: XLA's CPU "
            "backend computes them in f32 (analyze_hlo's note: no native "
            "bf16) and reduces f32; the port reduces the bf16 product",
            ref=(layers * 2 * 2 * _ring(MODEL) * rows * F32, 2 * layers),
            port=(layers * 2 * 2 * _ring(MODEL) * rows * BF16, 2 * layers)))
    if cfg.family == "hybrid":
        ssm = cfg.ssm
        inner = ssm.expand * d
        width = 2 * inner + 2 * ssm.state_dim + inner // ssm.head_dim
        mamba = sum(r for kind, r in cfg.stack()) * cfg.attn_every
        out.append(_term(
            "collective-permute", "in_proj's output [B, S, 2I + 2N + H] "
            "split over model is cut into x, z, b, c and dt: XLA moves the "
            "pieces that cross the shard boundary (its bytes read from the "
            "HLO)", ref=(None, None)))
        out.append(_term(
            "all-gather", "... DTensor cannot split a split dim: it "
            "gathers the whole output",
            port=(mamba * _ring(MODEL) * 2 * b * s * (width // 2) * BF16,
                  mamba)))
        out.append(_term(
            "all-gather", "XLA gathers the chunk's [1, B, C, C] f32 decay "
            "products over model twice in each Mamba2 layer (sized at half "
            "its f32 result); the port runs the scan by (batch, head) "
            "lanes and gathers nothing",
            ref=(mamba * 2 * _ring(MODEL) * b * s * s * F32 // 2,
                 2 * mamba)))
        out.append(_term(
            "all-reduce", "out_proj's product over the split inner dim is "
            "a bf16 dot: XLA's CPU backend reduces it in f32, the port in "
            "bf16",
            ref=(mamba * 2 * _ring(MODEL) * rows * F32, mamba),
            port=(mamba * 2 * _ring(MODEL) * rows * BF16, mamba)))
    return out


def dryrun_capacity(s: int, k: int, e: int) -> int:
    """The train forward's capacity per row (factor 1.25, multiple of 8),
    the port's ``moe._capacity`` as the reference computes it."""
    from repro_torch.models.moe import _capacity
    return _capacity(s, k, e, 1.25)


def _flops_gap(cfg) -> int:
    """Port minus reference dot FLOPs per device, the chunked-scan
    families' gap of ``test_torch_dryrun._explained_gap`` on rank 0's
    lanes (2 rows, half the heads): at S = 32 the one-chunk scan's dead
    final-state product, which XLA drops and the port computes, and
    RWKV6's bonus einsum, a dot in the HLO and a product and a sum here."""
    c, b = SEQ, BATCH // DATA
    if cfg.family == "ssm":
        lanes = cfg.num_layers * b * cfg.ssm.num_heads // MODEL
        d = cfg.ssm.head_dim
        return lanes * (2 * c * d * d - 2 * c * d)
    if cfg.family == "hybrid":
        ssm = cfg.ssm
        heads = ssm.expand * cfg.d_model // ssm.head_dim
        lanes = cfg.num_layers * b * heads // MODEL
        return lanes * 2 * c * ssm.head_dim * ssm.state_dim
    return 0


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_on_4x2_matches_reference_partitioned_hlo(reference, arch):
    """Per-device dot FLOPs, and collective bytes and executed counts by op
    type: the port's equal the reference's once each named difference is
    taken out of both sides."""
    cfg, c = _port_loss(arch)
    ref = reference[arch]
    assert c.flops - ref["flops"] == _flops_gap(cfg)
    port_b, port_n = dict(c.coll_bytes_by_op), dict(c.coll_counts)
    ref_b, ref_n = dict(ref["coll_bytes_by_op"]), dict(ref["counts"])
    for t in _differences(cfg):
        op = t["op"]
        if t["ref"] == (None, None):          # read from the HLO: all of it
            assert port_b.get(op, 0) == 0
            ref_b.pop(op, None)
            ref_n.pop(op, None)
            continue
        ref_b[op] = ref_b.get(op, 0) - t["ref"][0]
        ref_n[op] = ref_n.get(op, 0) - t["ref"][1]
        port_b[op] = port_b.get(op, 0) - t["port"][0]
        port_n[op] = port_n.get(op, 0) - t["port"][1]
    for op in COLL:
        assert port_b.get(op, 0) == pytest.approx(ref_b.get(op, 0),
                                                  abs=1e-6), op
        assert port_n.get(op, 0) == pytest.approx(ref_n.get(op, 0)), op
    if arch == "internlm2-1.8b":        # no difference at all
        assert not _differences(cfg)
        assert dict(c.coll_bytes_by_op) == ref["coll_bytes_by_op"]


# ---------------------------------------------------------------------------
# The port's own invariants
# ---------------------------------------------------------------------------
STEPS = [("internlm2-1.8b", "train", 8, 32), ("mixtral-8x7b", "decode", 8, 16),
         ("deepseek-v2-lite-buddy", "train", 8, 32),
         ("rwkv6-1.6b", "prefill", 8, 32), ("zamba2-7b", "decode", 8, 16)]


def _sharded(cfg, kind, b, s, mesh, device="meta"):
    prof = sh.profile_for(cfg, train=kind == "train")
    rules = sh.activation_rules(prof, cfg, mesh.shape["model"])
    case = dryrun.make_case(cfg, kind, b, s, device=device)
    return case, dryrun.trace_sharded(cfg, case, mesh, prof, rules)


@pytest.mark.parametrize("arch,kind,b,s", STEPS)
def test_local_argument_bytes_equal_memory_per_device(arch, kind, b, s):
    cfg, mesh = _cfg(arch), make_test_mesh(DATA * MODEL)
    case, tr = _sharded(cfg, kind, b, s, mesh)
    want = dryrun.memory_per_device(case.args, tr["arg_specs"], mesh)
    assert tr["argument_local_bytes"] == sum(want.values()) > 0
    counter = tr["counter"]
    assert counter.flops > 0 and counter.coll_bytes > 0
    assert counter.peak_bytes >= counter.temp_size_bytes > 0


def test_production_case_argument_bytes_equal_memory_per_device():
    """smollm-360m decode_32k on 16 x 16: its 5 kv heads do not divide the
    model axis, so its caches split by head dim (sanitized specs)."""
    cfg = base.get_config("smollm-360m")
    mesh = MeshShape((16, 16), ("data", "model"))
    tr = dryrun.trace_case(cfg, "decode_32k", mesh, sh.profile_for(cfg))
    want = dryrun.memory_per_device(tr["case"].args, tr["arg_specs"], mesh)
    assert tr["argument_local_bytes"] == sum(want.values())


@pytest.mark.parametrize("arch,kind,b,s", STEPS)
def test_one_by_one_mesh_gives_the_unsharded_counts(arch, kind, b, s):
    """On a 1 x 1 mesh every DTensor is whole: the local ops are the
    unsharded step's, with no collective."""
    cfg = _cfg(arch)
    case, tr = _sharded(cfg, kind, b, s, MeshShape((1, 1),
                                                   ("data", "model")))
    counter, _ = dryrun.trace(dryrun.make_case(cfg, kind, b, s))
    got, want = tr["counter"].as_dict(), counter.as_dict()
    assert tr["counter"].coll_bytes == 0 and not tr["counter"].coll_counts
    assert got["flops"] == want["flops"]
    assert got["by_kernel"] == want["by_kernel"]
    # one named difference: a local region (flash attention by heads)
    # hands its gradients back contiguous, since DTensor views a local
    # block as if it were; the plain path reads the strided ones, so the
    # train step's copies differ
    clone = "aten.clone.default"
    if kind != "train":
        assert got == want
    assert {k: v for k, v in got["by_op"].items() if k != clone} == \
        {k: v for k, v in want["by_op"].items() if k != clone}


@pytest.mark.parametrize("arch,kind,b,s",
                         [("internlm2-1.8b", "train", 2, 32),
                          ("deepseek-v2-lite-buddy", "train", 2, 32),
                          ("mixtral-8x7b", "decode", 4, 16),
                          ("rwkv6-1.6b", "decode", 2, 8)])
def test_meta_peak_and_temp_equal_cpu(arch, kind, b, s):
    """The tracker's peak and temporaries of the same step on meta and on
    real CPU tensors, unsharded and on the 4 x 2 mesh (the fake group's
    collectives allocate their outputs and move nothing)."""
    cfg = _cfg(arch)
    got = {}
    for device in ("meta", "cpu"):
        counter, outs = dryrun.trace(dryrun.make_case(cfg, kind, b, s,
                                                      device=device))
        got[device] = (counter.peak_bytes, counter.temp_bytes(outs),
                       counter.as_dict())
    assert got["meta"] == got["cpu"]
    assert got["meta"][0] > 0
    sharded = {}
    for device in ("meta", "cpu"):
        _, tr = _sharded(cfg, kind, 8, s, make_test_mesh(8), device)
        c = tr["counter"]
        sharded[device] = (c.peak_bytes, c.temp_size_bytes, c.flops,
                           c.bytes, c.collectives())
    assert sharded["meta"] == sharded["cpu"]


def test_peak_counts_each_storage_once_and_rounds_blocks():
    x = torch.zeros(1000, device="meta")          # 4000 bytes, an argument
    with rl.OpCounter() as c:
        c.arguments(x)
        y = x + 1                                   # 4096 after rounding
        v = y[10:].view(-1)                         # views: no storage
        z = y * 2
        del y, z                                    # y lives on in v
        w = torch.empty(1, device="meta")           # 512
    assert c.peak_bytes == 2 * 4096
    assert c.temp_bytes((v, w)) == c.peak_bytes - 4096 - 512
    assert rl.alloc_bytes(1) == 512 and rl.alloc_bytes(513) == 1024


def test_collective_bytes_follow_the_reference_ring_conventions():
    t = torch.empty(4, 256, device="meta")          # 4096 bytes
    big = torch.empty(16, 256, device="meta")
    assert rl.collective_bytes("all-gather", t, big, 4) == 0.75 * 16384
    assert rl.collective_bytes("reduce-scatter", big, t, 4) == 0.75 * 16384
    assert rl.collective_bytes("all-reduce", t, t, 4) == 2 * 0.75 * 4096
    assert rl.collective_bytes("all-to-all", t, t, 4) == 0.75 * 4096
    assert rl.collective_bytes("collective-permute", t, t, 4) == 4096


def test_shard_outside_rules_or_on_a_plain_tensor_adds_no_op():
    x = torch.ones(8, 4)
    with rl.OpCounter() as c:
        assert common.shard(x, "batch", None) is x
        with common.axis_rules(sh.activation_rules(sh.ShardingProfile())):
            assert common.shard(x, "batch", None) is x
            assert common.settle(x) is x
    assert not c.by_op and not c.coll_counts
    mesh = make_test_mesh(8)
    with fake_mesh(mesh) as m:
        d = DTensor.from_local(torch.ones(2, 4), m, (Shard(0), Replicate()),
                               run_check=False)
        assert common.shard(d, "batch", None) is d          # no rules
        rules = sh.activation_rules(sh.ShardingProfile())
        with common.axis_rules(rules), rl.OpCounter() as c:
            assert common.shard(d, "batch", None) is d     # already there
            r = common.shard(d, None, "vocab")   # data gathered, sliced
        assert r.placements == (Shard(0), Shard(1))
        assert c.coll_counts == {"all-gather": 1}


def test_placements_follow_the_spec_major_to_minor():
    mesh = MeshShape((2, 4, 2), ("pod", "data", "model"))
    with fake_mesh(mesh) as m:
        assert sh.placements(sh.P(("pod", "data"), "model"), m, 2) == \
            (Shard(0), Shard(0), Shard(1))
        assert sh.placements(sh.P(None, "data"), m, 3) == \
            (Replicate(), Shard(1), Replicate())
        with pytest.raises(ValueError):
            sh.placements(sh.P(("data", "pod")), m, 1)
        t = torch.empty(8, 6, device="meta")
        d = sh.to_dtensors({"w": t}, {"w": sh.P(("pod", "data"), "model")},
                           m, mesh)["w"]
        assert d._local_tensor.shape == (1, 3) and d.shape == (8, 6)
    with fake_mesh(MeshShape((1, 2), ("data", "model"))) as m:
        assert sh.placements(sh.P("data", "model"), m, 2) == \
            (Replicate(), Shard(1))


def test_fake_mesh_owns_the_process_group():
    mesh = make_test_mesh(8)
    with fake_mesh(mesh) as m:
        assert dist.is_initialized() and dist.get_world_size() == 8
        assert dist.get_rank() == 0 and m.mesh_dim_names == ("data", "model")
        with pytest.raises(RuntimeError):
            with fake_mesh(mesh):
                pass
        assert dist.is_initialized()
    assert not dist.is_initialized()


def test_local_call_splits_plain_tensors_and_keeps_partial_sums():
    with fake_mesh(make_test_mesh(8)) as m:
        x = DTensor.from_local(torch.ones(2, 4), m, (Shard(0), Partial()),
                               run_check=False)
        plain = torch.ones(8, 3)                    # whole: split inside
        seen = []

        def fn(a, b):
            seen.append((tuple(a.shape), tuple(b.shape)))
            return a.sum(1, keepdim=True) + b[:, :1]
        pl = (Shard(0), Replicate())
        out = common.local_call(fn, (x, plain),
                                (common.no_partial(x.placements), pl), pl)
        assert seen == [((2, 4), (2, 3))]
        assert out.placements == pl and out.shape == (8, 1)
        assert common.remap((Shard(2), Partial(), Shard(0)), {2: 1}) == \
            (Shard(1), Partial(), Replicate())


def _kernel_case(name, gen):
    """(ops wrapper call, its arguments whole, their placements on the
    4 x 2 mesh, the cost function) for one kernel, at a small size."""
    from repro_torch.core.quantize import quantize_expert_ffn
    from repro_torch.kernels import (buddy_substitute, expert_ffn,
                                     grouped_ffn, quant_ffn, route,
                                     topk_gate, wkv_chunk)
    from repro_torch.models.rwkv import random_chunk_operands
    rows, rep = (Shard(0), Replicate()), (Replicate(), Replicate())
    e, k, t, d, f = 4, 2, 16, 8, 6
    ffn_x, f_split = (Replicate(), Shard(1)), (Replicate(), Shard(2))
    w1, w3 = (torch.randn(e, d, f, generator=gen) for _ in range(2))
    w2 = torch.randn(e, f, d, generator=gen)
    logits = torch.randn(t, e, generator=gen)
    resident = torch.rand(e, generator=gen) < 0.5
    table = torch.stack([torch.roll(torch.arange(e), -i - 1)[:e - 1]
                         for i in range(e)]).to(torch.int32)
    q = torch.rand(e, e - 1, generator=gen)
    if name == "topk_gate":
        return (lambda lg: ops.topk_gate(lg, 0.5, k=k), (logits,), (rows,),
                lambda lg: topk_gate.topk_gate_cost(lg, 0.5, k=k))
    if name == "route":
        return (lambda *a: ops.route(a[0], 0.5, 0.9, *a[1:], k=k),
                (logits, resident, table, q), (rows, rep, rep, rep),
                lambda *a: route.route_cost(a[0], 0.5, 0.9, *a[1:], k=k))
    if name == "buddy_substitute":
        s = torch.randint(0, e, (t, k), generator=gen).to(torch.int32)
        gate = torch.rand(t, generator=gen) < 0.5
        return (ops.buddy_substitute, (s, gate, resident, table, q),
                (rows, rows, rep, rep, rep),
                buddy_substitute.buddy_substitute_cost)
    x = torch.randn(e, 8, d, generator=gen)
    w_pl = (f_split, f_split, (Replicate(), Shard(1)))
    if name == "expert_ffn":
        return (ops.expert_ffn, (x, w1, w3, w2), (ffn_x, *w_pl),
                expert_ffn.expert_ffn_cost)
    counts = torch.full((2 * e,), 3, dtype=torch.int32)
    if name == "grouped_ffn":
        x2 = torch.randn(2 * e, 8, d, generator=gen)
        return (lambda *a: ops.grouped_ffn(*a[:4], None, a[4]),
                (x2, w1, w3, w2, counts), (ffn_x, *w_pl, rep),
                lambda *a: grouped_ffn.grouped_ffn_cost(*a[:4], None, a[4]))
    if name == "quant_ffn":
        qd = quantize_expert_ffn(w1, w3, w2, 8)
        names = ("w1_q", "w1_s", "w3_q", "w3_s", "w2_q", "w2_s")
        q_pl = (f_split, (Replicate(), Shard(1)), f_split,
                (Replicate(), Shard(1)), (Replicate(), Shard(1)), rep)
        return (ops.quant_ffn, (x, *(qd[n] for n in names), counts[:e]),
                (ffn_x, *q_pl, rep), quant_ffn.quant_ffn_cost)
    ops_ = random_chunk_operands(gen, 2, 4, 2, 4, 8, "cpu")
    return (ops.wkv_chunk, tuple(ops_), (rows,) * 7,
            wkv_chunk.wkv_chunk_cost)


@pytest.mark.parametrize("name", ["topk_gate", "route", "buddy_substitute",
                                  "expert_ffn", "grouped_ffn", "quant_ffn",
                                  "wkv_chunk"])
def test_kernels_run_on_local_blocks_under_a_mesh(name):
    """Each kernel wrapper given DTensors runs its plain version on rank 0's
    blocks (``local_map``): its outputs' local blocks equal the plain call
    on the local inputs, and the charge is the cost of the local shapes."""
    gen = torch.Generator().manual_seed(0)
    call, args, pls, cost = _kernel_case(name, gen)
    with fake_mesh(make_test_mesh(8)) as m:
        dargs = [DTensor.from_local(a, m, pl, run_check=False)
                 for a, pl in zip(args, pls)]
        with rl.OpCounter() as c:
            out = call(*dargs)
        local = [a.to_local() for a in dargs]
        want = call(*local)
    outs = out if isinstance(out, tuple) else (out,)
    wants = want if isinstance(want, tuple) else (want,)
    assert len(outs) == len(wants)
    for o, w in zip(outs, wants):
        assert isinstance(o, DTensor)
        torch.testing.assert_close(o.to_local(), w, rtol=0, atol=0)
    flops, nbytes = cost(*local)
    assert c.by_kernel[name] == {"calls": 1, "flops": flops,
                                 "bytes": nbytes}
