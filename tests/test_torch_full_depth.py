"""The serve launcher's defaults at full size, held against the JAX package
without building a full-size model: ``init_params`` of the full
deepseek-v2-lite-buddy (27 layers) and of mixtral-8x22b (4 and 56 layers)
on the meta device against the reference's ``jax.eval_shape(init_params)``
leaf by leaf, with their byte totals; the int8 / int4 replica tree of the
full DeepSeek (``quantize_expert_ffn`` on meta, the shapes
``attach_quant_tier`` allocates) against the reference's; the per-pass
``attach_quant_tier`` against one pass over the whole stack and against the
reference on the committed fixture; and the launcher's defaults
(``parse_args([])``, ``model_config``) against the reference launcher's."""
import argparse
import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import base as ref_base  # noqa: E402
from repro.configs.deepseek_v2_lite_buddy import \
    profiling as ref_profiling  # noqa: E402
from repro.core import quantize as ref_q  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch.checkpoint.io import load_npz  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.configs.deepseek_v2_lite_buddy import profiling  # noqa: E402
from repro_torch.core import quantize as pq  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

FIXTURE = Path(__file__).resolve().parents[1] / "results" / "bench"
DEFAULT_ARCH = "deepseek-v2-lite-buddy"
# (arch, layers: 0 for the config's own, bytes of its f32 weights)
SIZES = [(DEFAULT_ARCH, 0, 65_166_827_520),
         ("mixtral-8x22b", 4, 41_675_612_160),
         ("mixtral-8x22b", 0, 562_520_285_184)]
# int8 values + f32 scales of every routed expert of the 27 DeepSeek layers
# (shared experts are not quantized)
REPLICA_BYTES = 14_982_119_424


def _cut(cfg, layers: int):
    return dataclasses.replace(cfg, num_layers=layers) if layers else cfg


def _key(k) -> str:
    return str(getattr(k, "key", getattr(k, "idx", k)))


def _ref_flat(struct) -> dict:
    """{path: (shape, dtype name)} of a reference pytree of arrays."""
    return {"/".join(_key(k) for k in path): (tuple(x.shape), str(x.dtype))
            for path, x in jax.tree_util.tree_flatten_with_path(struct)[0]}


def _port_flat(tree, prefix: str = "") -> dict:
    """{path: (shape, dtype name)} of a nested dict / tuple of tensors."""
    if isinstance(tree, torch.Tensor):
        return {prefix: (tuple(tree.shape), str(tree.dtype).split(".")[-1])}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(_port_flat(v, f"{prefix}/{k}" if prefix else str(k)))
    return out


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    vals = tree.values() if isinstance(tree, dict) else tree
    return [t for v in vals for t in _leaves(v)]


def _nbytes(tree) -> int:
    return sum(int(np.prod(s)) * np.dtype(d).itemsize
               for s, d in _port_flat(tree).values())


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch,layers,_", SIZES)
def test_init_params_leaves_are_the_references(arch, layers, _):
    cfg = _cut(base.get_config(arch), layers)
    ref_cfg = _cut(ref_base.get_config(arch), layers)
    want = _ref_flat(jax.eval_shape(lambda k: ref_tf.init_params(ref_cfg, k),
                                    jax.random.PRNGKey(0)))
    got = _port_flat(tf.init_params(cfg, None, "meta"))
    assert got == want


@pytest.mark.parametrize("arch,layers,nbytes", SIZES)
def test_weight_bytes(arch, layers, nbytes):
    cfg = _cut(base.get_config(arch), layers)
    params = tf.init_params(cfg, None, "meta")
    assert _nbytes(params) == nbytes
    assert all(t.device.type == "meta" for t in _leaves(params))


@pytest.mark.parametrize("bits", [8, 4])
def test_replica_tree_at_full_depth_is_the_references(bits):
    """attach_quant_tier allocates its stacked replicas at the shapes
    quantize_expert_ffn gives the whole stack on meta; those equal the
    reference's replica tree of the 27-layer DeepSeek, int4 stored as int8
    like int8, and take REPLICA_BYTES either way."""
    cfg = base.get_config(DEFAULT_ARCH)
    moe = tf.init_params(cfg, None, "meta")["groups"][0]["moe"]
    got = pq.quantize_expert_ffn(moe["w1"], moe["w3"], moe["w2"], bits)
    ref_moe = jax.eval_shape(
        lambda k: ref_tf.init_params(ref_base.get_config(DEFAULT_ARCH), k),
        jax.random.PRNGKey(0))["groups"][0]["moe"]
    want = jax.eval_shape(lambda a, b, c: ref_q.quantize_expert_ffn(
        a, b, c, bits), ref_moe["w1"], ref_moe["w3"], ref_moe["w2"])
    assert _port_flat(got) == _ref_flat(want)
    assert got["w1_q"].shape == (27, 64, 2048, 1408)
    assert _nbytes(got) == REPLICA_BYTES


def _fixture_groups():
    cfg = profiling()
    params = load_npz(str(FIXTURE / "model.npz"), "cpu")
    moe = [g["moe"] for (kind, _), g in zip(cfg.stack(), params["groups"])
           if kind == "attn_moe"]
    return cfg, params, moe


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("experts_per_pass", [0, 5, 1])
def test_passes_give_the_whole_stack_replicas(bits, experts_per_pass,
                                              monkeypatch):
    """On the committed fixture (2 layers x 64 experts): attach_quant_tier,
    at its own pass size (0) and at 5 and 1 experts a pass (ragged: 64 =
    12 x 5 + 4), gives replicas bit-equal to quantize_expert_ffn over the
    whole [L, E, ...] stack and fidelities within 1e-6 of expert_fidelity
    over it; and the replicas equal the reference's attach_quant_tier's,
    the fidelities within its tier tests' 1e-5."""
    cfg, params, moe = _fixture_groups()
    if experts_per_pass:
        one = moe[0]["w1"][0, 0].numel() * 4
        monkeypatch.setattr(pq, "PASS_BYTES", experts_per_pass * one)
    out, fid = pq.attach_quant_tier(cfg, params, bits)
    assert fid.dtype == np.float32 and fid.shape == (2, 64)
    got = [g["moe"]["quant"] for (kind, _), g in
           zip(cfg.stack(), out["groups"]) if kind == "attn_moe"]
    whole_fid = []
    for q, m in zip(got, moe):
        whole = pq.quantize_expert_ffn(m["w1"], m["w3"], m["w2"], bits)
        assert set(q) == set(whole)
        for k in whole:
            assert q[k].dtype == whole[k].dtype and torch.equal(q[k],
                                                                whole[k]), k
        whole_fid.append(pq.expert_fidelity(m["w1"], m["w3"], m["w2"], whole))
    np.testing.assert_allclose(fid, np.concatenate(whole_fid), rtol=1e-6)

    ref_params = {"groups": tuple(
        {"moe": {n: jnp.asarray(m[n].numpy()) for n in ("w1", "w3", "w2")}}
        for m in moe)}
    ref_out, ref_fid = ref_q.attach_quant_tier(ref_profiling(), ref_params,
                                               bits)
    for q, g in zip(got, ref_out["groups"]):
        for k, v in g["moe"]["quant"].items():
            np.testing.assert_array_equal(q[k].numpy(), np.asarray(v))
    np.testing.assert_allclose(fid, ref_fid, rtol=1e-5)


class _Parsed(Exception):
    """Carries the namespace the reference launcher parsed."""


def _reference_defaults(monkeypatch) -> dict:
    """The reference launcher's defaults: its main() builds its parser
    inline and parses sys.argv, so parse_args is stopped there and given
    no arguments."""
    real = argparse.ArgumentParser.parse_args

    def parsed(self, args=None, namespace=None):
        raise _Parsed(real(self, []))

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parsed)
    with pytest.raises(_Parsed) as got:
        ref_serve.main()
    monkeypatch.undo()
    return vars(got.value.args[0])


def test_launcher_defaults_are_the_references(monkeypatch):
    """Every flag both launchers have defaults alike; the port adds only
    --layers (0: the config's depth) and --device (cuda)."""
    ref = _reference_defaults(monkeypatch)
    port = vars(serve.parse_args([]))
    assert set(port) - set(ref) == {"layers", "device"}
    assert set(ref) <= set(port)
    assert {k: port[k] for k in ref} == ref
    assert (port["layers"], port["device"]) == (0, "cuda")


def test_default_model_config_is_the_references_full_depth():
    """model_config of the defaults is the reference launcher's get_config
    of its default arch (not --reduced), field by field: 27 layers of f32,
    64 experts x 1408, top-6, 2 shared experts."""
    cfg = serve.model_config(serve.parse_args([]))
    want = ref_base.get_config(DEFAULT_ARCH)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want)
    assert cfg.stack() == want.stack()
    assert (cfg.num_layers, cfg.dtype, cfg.d_model) == (27, "float32", 2048)
    assert (cfg.moe.num_experts, cfg.moe.d_ff, cfg.moe.top_k,
            cfg.moe.num_shared_experts) == (64, 1408, 6, 2)
