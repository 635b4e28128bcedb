"""The launch tooling's dry run (``repro_torch.launch.dryrun``) against the
reference's: decode caches and their partition specs, the decode window,
the FLOPs of a step counted on the meta device against the reference's
loop-aware HLO count (``repro.launch.roofline.analyze_hlo`` of a
single-device compile), meta counts against CPU counts of the same step,
and one production case written to JSON (traced sharded on the 16 x 16
mesh: per-device counts, collectives and temporaries)."""
import dataclasses
import functools
import json
import os

import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as RefP  # noqa: E402

from repro.configs import base as ref_base  # noqa: E402
from repro.launch import roofline as ref_rl  # noqa: E402
from repro.launch import sharding as ref_sh  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro.training.train_loop import lm_loss as ref_lm_loss  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import roofline as rl  # noqa: E402
from repro_torch.launch import sharding as sh  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402
from repro_torch.training.train_loop import lm_loss  # noqa: E402

ARCHS = list(base.ARCH_IDS)
DECODE_SHAPES = [n for n, s in base.SHAPES.items() if s.kind == "decode"]


def _ref_dryrun():
    """The reference's dry-run module, imported without its XLA_FLAGS
    (512 host devices) reaching a backend that has not started yet."""
    old = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref_dry
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return ref_dry


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _key_str(k):
    return str(getattr(k, "key", getattr(k, "idx", k)))


def _flat_ref(tree, is_leaf=None):
    return {"/".join(_key_str(k) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]}


def _flat_port(tree, path=()):
    kids = sh._children(tree)
    if kids is None:
        return {"/".join(map(str, path)): tree}
    out = {}
    for k, v in kids:
        out.update(_flat_port(v, path + (k,)))
    return out


@pytest.mark.parametrize("shape_name", DECODE_SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_caches_and_cache_specs_match_reference(arch, shape_name):
    """init_caches on meta (cfg in bf16, as the dry run casts it) against
    the reference's eval_shape, leaf by leaf, at its effective window; and
    the cache spec tree against the reference's _cache_spec_tree."""
    shp = base.SHAPES[shape_name]
    b, s, long_ctx = shp.global_batch, shp.seq_len, shp.seq_len >= 262144
    ref_cfg = dataclasses.replace(ref_base.get_config(arch),
                                  dtype="bfloat16")
    cfg = dataclasses.replace(base.get_config(arch), dtype="bfloat16")
    window = tf.effective_window(cfg, s, long_context=long_ctx)
    assert window == ref_tf.effective_window(ref_cfg, s,
                                             long_context=long_ctx)
    ref = _flat_ref(jax.eval_shape(lambda: ref_tf.init_caches(
        ref_cfg, b, s, window=window, dtype=jnp.bfloat16)))
    got = _flat_port(tf.init_caches(cfg, b, s, window=window,
                                    device="meta"))
    assert set(got) == set(ref)
    for k, leaf in got.items():
        assert leaf.device.type == "meta"
        assert tuple(leaf.shape) == tuple(ref[k].shape), k
        assert str(leaf.dtype).replace("torch.", "") == str(ref[k].dtype), k
    ref_prof = ref_sh.profile_for(ref_cfg)
    prof = sh.profile_for(cfg)
    ref_specs = _flat_ref(_ref_dryrun()._cache_spec_tree(
        ref_cfg, ref_prof, ref_sh.activation_rules(ref_prof, ref_cfg, 16)),
        is_leaf=lambda x: isinstance(x, RefP))
    specs = _flat_port(dryrun._cache_spec_tree(
        cfg, prof, sh.activation_rules(prof, cfg, 16)))
    assert set(specs) == set(got)
    assert {k: tuple(v) for k, v in specs.items()} == \
        {k: tuple(v) for k, v in ref_specs.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_effective_window_matches_reference(arch):
    cfg, ref_cfg = base.get_config(arch), ref_base.get_config(arch)
    for s in (1, 4096, 32768, 524288):
        for long_ctx in (False, True):
            assert tf.effective_window(cfg, s, long_ctx) == \
                ref_tf.effective_window(ref_cfg, s, long_ctx)


# ---------------------------------------------------------------------------
# FLOPs of lm_loss: the meta count against the reference's HLO count
# ---------------------------------------------------------------------------
LOSS_CASES = [("internlm2-1.8b", 32), ("mixtral-8x7b", 32),
              ("deepseek-v2-lite-buddy", 32), ("rwkv6-1.6b", 32),
              ("zamba2-7b", 32), ("rwkv6-1.6b", 64), ("zamba2-7b", 64)]
BATCH = 8


@functools.lru_cache(maxsize=None)
def _ref_loss_flops(arch: str, s: int) -> float:
    """analyze_hlo's FLOPs of the reference's jitted lm_loss (reduced,
    bf16, tokens [8, s]) compiled for one device."""
    cfg = dataclasses.replace(ref_base.get_reduced(arch), dtype="bfloat16")
    p = jax.eval_shape(lambda k: ref_tf.init_params(cfg, k),
                       jax.random.PRNGKey(0))
    toks = jax.ShapeDtypeStruct((BATCH, s), jnp.int32)
    fn = jax.jit(lambda p, t, y: ref_lm_loss(p, cfg, t, y)[0])
    return ref_rl.analyze_hlo(fn.lower(p, toks, toks).compile().as_text(),
                              1)["flops"]


def _port_loss_counter(arch: str, s: int, device: str):
    cfg = dataclasses.replace(base.get_reduced(arch), dtype="bfloat16")
    params = tf.init_params(cfg, device=device)
    toks = torch.zeros((BATCH, s), dtype=torch.int64, device=device)
    with rl.OpCounter() as c:
        lm_loss(params, cfg, toks, toks)
    return cfg, c


def _explained_gap(cfg, s: int) -> int:
    """Port minus reference FLOPs of the chunked-scan families, each term
    from its cause (both scans run at chunk 32):

    * at S = 32 the sequence is one chunk: XLA unrolls the reference's
      one-trip scan, and the final state's product of that chunk (RWKV6:
      k_end^T v, 2 C dk^2 per lane; Mamba2: b_end^T x, 2 C hd N) is dead
      code, since lm_loss never reads the final state, so the compile
      drops it. The port computes it (the wkv_chunk kernel writes
      s_final). At S = 64 the scan stays a loop and nothing is dropped.
    * RWKV6's bonus term dg = r . (u * k) is an einsum in the reference,
      which the HLO counts as a dot (2 C dk per lane and chunk); the port
      forms it as a product and a sum, 0 FLOPs in the dot convention.

    The attention and MoE stacks have no gap: their counts are equal."""
    n_chunks, c = s // 32, 32
    if cfg.family == "ssm":
        lanes = cfg.num_layers * BATCH * cfg.ssm.num_heads
        d = cfg.ssm.head_dim
        dead = 2 * c * d * d if n_chunks == 1 else 0
        return lanes * (dead - n_chunks * 2 * c * d)
    if cfg.family == "hybrid":
        ssm = cfg.ssm
        heads = ssm.expand * cfg.d_model // ssm.head_dim
        lanes = cfg.num_layers * BATCH * heads      # every layer is Mamba2
        dead = 2 * c * ssm.head_dim * ssm.state_dim if n_chunks == 1 else 0
        return lanes * dead
    return 0


@pytest.mark.parametrize("arch,s", LOSS_CASES)
def test_loss_flops_on_meta_match_reference_hlo(arch, s):
    cfg, c = _port_loss_counter(arch, s, "meta")
    want = _ref_loss_flops(arch, s)
    gap = _explained_gap(cfg, s)
    if cfg.family in ("ssm", "hybrid") and s == 32:
        assert gap > 0                  # the dead final-state product
    assert c.flops - want == gap, (c.flops, want, gap)


def _ref_train_step_flops(arch: str, s: int) -> float:
    """analyze_hlo's FLOPs of the reference's jitted train step with remat
    (reduced, bf16, tokens [8, s]) compiled for one device."""
    from repro.training.optimizer import AdamWConfig, init_opt_state
    from repro.training.train_loop import make_train_step
    ref_cfg = dataclasses.replace(ref_base.get_reduced(arch),
                                  dtype="bfloat16")
    p = jax.eval_shape(lambda k: ref_tf.init_params(ref_cfg, k),
                       jax.random.PRNGKey(0))
    toks = jax.ShapeDtypeStruct((BATCH, s), jnp.int32)
    step = make_train_step(ref_cfg, AdamWConfig(), remat=True)
    hlo = jax.jit(step).lower(p, jax.eval_shape(init_opt_state, p), toks,
                              toks, jax.random.PRNGKey(0)).compile().as_text()
    return ref_rl.analyze_hlo(hlo, 1)["flops"]


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "smollm-360m"])
def test_dense_train_step_flops_with_remat_match_reference_hlo(arch):
    """The dry run's train step (lm_loss forward and backward with remat,
    then AdamW) on meta against the reference's jitted train step with
    remat, reduced, bf16, tokens [8, 64]: the recomputed forward's products
    count the same on both sides. The FFN's down product is in neither
    recompute: XLA drops it as dead code, and the port's checkpoint stops
    once every saved tensor is back, which the down product's saved
    inputs are before it runs."""
    cfg = dataclasses.replace(base.get_reduced(arch), dtype="bfloat16")
    counter, _ = dryrun.trace(dryrun.make_case(cfg, "train", BATCH, 64))
    assert counter.flops == _ref_train_step_flops(arch, 64)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v2-lite-buddy"])
def test_moe_train_step_flops_with_remat_match_reference_hlo(arch):
    """As the dense step, for the MoE stacks, with one gap worked out from
    its cause. ExpertFFN's backward recomputes the two hidden products
    x @ w1 and x @ w3 over the whole [E, C, D] buffer (the kernel writes
    only their SwiGLU product to its scratch, not the two the gradient
    reads), where the reference's autodiff keeps them from the remat
    recompute: 2 x 2 E C D F per MoE
    layer, C = B x the capacity at factor 1.25. DeepSeek's shared expert
    has no gap: its down product is in neither recompute (moe_forward runs
    it last, so the port's checkpoint stops before it)."""
    from repro_torch.models.moe import _capacity
    cfg = dataclasses.replace(base.get_reduced(arch), dtype="bfloat16")
    counter, _ = dryrun.trace(dryrun.make_case(cfg, "train", BATCH, 64))
    m = cfg.moe
    c = BATCH * _capacity(64, m.top_k, m.num_experts, 1.25)
    layers = sum(r for k, r in cfg.stack() if k == "attn_moe")
    gap = layers * 2 * 2 * m.num_experts * c * cfg.d_model * m.d_ff
    assert counter.by_kernel["expert_ffn"]["calls"] == 2 * layers
    assert counter.flops - _ref_train_step_flops(arch, 64) == gap


# ---------------------------------------------------------------------------
# meta against the CPU: the same step counts the same
# ---------------------------------------------------------------------------
STEP_CASES = [("deepseek-v2-lite-buddy", "decode", 4, 16),
              ("mixtral-8x7b", "decode", 4, 16),
              ("deepseek-v2-lite-buddy", "train", 2, 32),
              ("rwkv6-1.6b", "train", 2, 32),
              ("zamba2-7b", "prefill", 2, 32),
              ("llama-3.2-vision-11b", "decode", 2, 8),
              ("musicgen-large", "train", 2, 8)]


@pytest.mark.parametrize("arch,kind,b,s", STEP_CASES)
def test_meta_counts_equal_cpu_counts(arch, kind, b, s):
    """The same step (reduced, bf16) on meta and on the CPU: equal FLOPs,
    bytes, per-op tallies and kernel charges, so each kernel is charged the
    same whichever implementation runs."""
    cfg = dataclasses.replace(base.get_reduced(arch), dtype="bfloat16")
    got = {}
    for device in ("meta", "cpu"):
        case = dryrun.make_case(cfg, kind, b, s, device=device)
        counter, outs = dryrun.trace(case)
        got[device] = counter.as_dict()
        leaf = next(iter(_flat_port(outs).values()))
        assert leaf.device.type == device
    assert got["meta"] == got["cpu"]
    assert got["meta"]["flops"] > 0
    if cfg.is_moe:
        assert got["meta"]["by_kernel"]


def test_loss_flops_on_meta_equal_cpu_for_every_family():
    for arch in ("internlm2-1.8b", "mixtral-8x7b", "rwkv6-1.6b",
                 "zamba2-7b"):
        _, meta = _port_loss_counter(arch, 32, "meta")
        _, cpu = _port_loss_counter(arch, 32, "cpu")
        assert meta.as_dict() == cpu.as_dict(), arch


# ---------------------------------------------------------------------------
# one production case end to end
# ---------------------------------------------------------------------------
def test_run_one_writes_a_complete_json(tmp_path, monkeypatch):
    out = dryrun.run_one("smollm-360m", "decode_32k", save=True,
                         verbose=False, results_dir=tmp_path)
    path = tmp_path / "smollm-360m_decode_32k_16x16.json"
    assert json.loads(path.read_text()) == json.loads(json.dumps(out))
    cfg = base.get_config("smollm-360m")
    assert (out["chips"], out["mesh"], out["device"]) == (256, "16x16",
                                                          "meta")
    mem = out["memory"]
    assert mem["argument_size_bytes"] == sum(
        mem["argument_bytes_by_input"].values())
    assert mem["output_size_bytes"] == sum(
        mem["output_bytes_by_output"].values())
    assert mem["peak_bytes"] >= mem["temp_size_bytes"] > 0
    # kv heads (5) do not divide the model axis, the head dim (64) does:
    # per device k and v [L, B / 16, S, KV, hd / 16] bf16
    assert mem["argument_bytes_by_input"]["caches"] == \
        2 * cfg.num_layers * (128 // 16) * 32768 * cfg.num_kv_heads \
        * (cfg.head_dim // 16) * 2
    assert mem["argument_bytes_by_input"]["token"] == 8 * 8
    counts, roof = out["counts"], out["roofline"]
    assert counts["flops"] > 0 and counts["bytes"] > 0
    assert counts["flops"] == sum(v["flops"] for v in
                                  counts["by_op"].values())
    hla = out["hlo_analysis"]
    assert roof["split"] == "sharded" and roof["collective_s"] > 0
    assert roof["collective_s"] == hla["coll_bytes"] / rl.H100.link_bytes_per_s
    assert hla["coll_bytes"] == sum(hla["coll_bytes_by_op"].values()) > 0
    assert set(hla["coll_counts"]) == set(hla["coll_bytes_by_op"])
    assert roof["flops_per_device"] == counts["flops"] == hla["flops"]
    assert roof["memory_s"] == counts["bytes"] / 3.35e12
    assert roof["dominant"] in ("compute", "memory", "collective")
    assert roof["model_flops"] == rl.model_flops(cfg, "decode", 32768, 128)
    monkeypatch.setattr(rl, "H100", rl.HardwareSpec(hbm_bytes_per_s=1e12))
    dryrun.reanalyze_all(tmp_path)
    again = json.loads(path.read_text())["roofline"]
    assert again["memory_s"] == counts["bytes"] / 1e12
    assert again["collective_s"] == roof["collective_s"]


def test_main_runs_a_case_into_the_results_dir(tmp_path, monkeypatch,
                                               capsys):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", tmp_path)
    dryrun.main(["--arch", "internlm2-1.8b", "--shape", "long_500k"])
    assert (tmp_path / "internlm2-1.8b_long_500k_16x16.json").exists()
    assert "all dry-runs passed" in capsys.readouterr().out
    out = json.loads(
        (tmp_path / "internlm2-1.8b_long_500k_16x16.json").read_text())
    assert out["meta"] == {"kind": "decode", "window": 8192}


@pytest.mark.parametrize("arch", ARCHS)
def test_inputs_and_buddy_state_match_reference(arch):
    """input_specs (tokens int64 where the reference's are int32: the
    port's launchers index with int64; the decode position a host int),
    the conditioning and the buddy state, shape by shape."""
    ref_dry = _ref_dryrun()
    ref_cfg, cfg = ref_base.get_config(arch), base.get_config(arch)
    for name in base.SHAPES:
        want = ref_dry.input_specs(ref_cfg, name)
        got = dryrun.input_specs(cfg, name)
        assert set(got) == set(want)
        for k, v in got.items():
            if k == "pos":
                assert v == base.SHAPES[name].seq_len - 1
                assert want[k].shape == ()
                continue
            assert v.device.type == "meta"
            assert tuple(v.shape) == tuple(want[k].shape), (name, k)
            assert v.dtype == (torch.bfloat16 if k == "cond"
                               else torch.int64)
    ref_bd, bd = ref_dry.buddy_struct(ref_cfg), dryrun.buddy_struct(cfg)
    assert (ref_bd is None) == (bd is None)
    if bd is not None:
        for a, b in zip(bd, ref_bd):
            if a is None:
                assert b is None
            else:
                assert tuple(a.shape) == tuple(b.shape)
                assert str(a.dtype).replace("torch.", "") == str(b.dtype)
