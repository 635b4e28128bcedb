"""The launch tooling's mesh and sharding rules (``repro_torch.launch.mesh``
and ``.sharding``) against the reference's ``repro.launch.sharding``: the
profiles and activation rules of every arch, every parameter's partition
spec (the port's params on the meta device against ``jax.eval_shape``
structs, reduced and full configs), ``sanitize_spec`` on a fake mesh, and
the bytes a device holds under the sanitized specs."""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from jax.sharding import PartitionSpec as RefP  # noqa: E402

from repro.configs import base as ref_base  # noqa: E402
from repro.launch import sharding as ref_sh  # noqa: E402
from repro.models import transformer as ref_tf  # noqa: E402
from repro_torch.configs import base  # noqa: E402
from repro_torch.launch import mesh as port_mesh  # noqa: E402
from repro_torch.launch import sharding as sh  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models import transformer as tf  # noqa: E402

ARCHS = list(base.ARCH_IDS)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakeMesh:
    """The reference test's mesh stand-in (tests/test_dryrun_small.py)."""
    shape = {"model": 16, "data": 4}


class ProdMesh:
    shape = {"data": 16, "model": 16}


def _cfgs(arch, size):
    if size == "reduced":
        return ref_base.get_reduced(arch), base.get_reduced(arch)
    return ref_base.get_config(arch), base.get_config(arch)


def _key_str(k):
    return str(getattr(k, "key", getattr(k, "idx", k)))


@functools.lru_cache(maxsize=None)
def _ref_params(arch, size):
    """{path: (shape, spec entries)} of the reference's params under the
    train and serve profiles (one eval_shape per arch and size)."""
    cfg, _ = _cfgs(arch, size)
    struct = jax.eval_shape(lambda k: ref_tf.init_params(cfg, k),
                            jax.random.PRNGKey(0))
    out = {}
    for train in (False, True):
        prof = ref_sh.profile_for(cfg, train=train)
        specs = ref_sh.param_specs(cfg, struct, prof)
        flat_s = jax.tree_util.tree_flatten_with_path(
            specs, is_leaf=lambda x: isinstance(x, RefP))[0]
        flat_x = dict(jax.tree_util.tree_flatten_with_path(struct)[0])
        for path, spec in flat_s:
            key = "/".join(_key_str(k) for k in path)
            leaf = flat_x[path]
            out[(train, key)] = (tuple(leaf.shape), tuple(spec),
                                 leaf.dtype.itemsize)
    return out


def _port_flat(tree, path=()):
    """{path: leaf} of a nested dict / tuple tree."""
    kids = sh._children(tree)
    if kids is None:
        return {"/".join(map(str, path)): tree}
    out = {}
    for k, v in kids:
        out.update(_port_flat(v, path + (k,)))
    return out


@functools.lru_cache(maxsize=None)
def _port_params(arch, size):
    return tf.init_params(_cfgs(arch, size)[1], device="meta")


@pytest.mark.parametrize("arch", ARCHS)
def test_profiles_and_activation_rules_match_reference(arch):
    ref_cfg, cfg = ref_base.get_config(arch), base.get_config(arch)
    for train in (False, True):
        for multi_pod in (False, True):
            ref_prof = ref_sh.profile_for(ref_cfg, multi_pod, train)
            prof = sh.profile_for(cfg, multi_pod, train)
            fields = ("multi_pod", "fsdp_experts", "fsdp_dense",
                      "shard_vocab", "cache_layout", "batch", "fsdp_axis")
            assert {f: getattr(prof, f) for f in fields} == \
                {f: getattr(ref_prof, f) for f in fields}
            assert sh.activation_rules(prof) == \
                ref_sh.activation_rules(ref_prof)
            for model_size in (2, 16):
                assert sh.activation_rules(prof, cfg, model_size) == \
                    ref_sh.activation_rules(ref_prof, ref_cfg, model_size)


@pytest.mark.parametrize("size", ["reduced", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch, size):
    ref = _ref_params(arch, size)
    params = _port_params(arch, size)
    cfg = _cfgs(arch, size)[1]
    leaves = _port_flat(params)
    assert all(t.device.type == "meta" for t in leaves.values())
    for train in (False, True):
        specs = _port_flat(sh.param_specs(cfg, params,
                                          sh.profile_for(cfg, train=train)))
        assert set(specs) == {k for t, k in ref if t == train}
        for key, spec in specs.items():
            shape, ref_spec, _ = ref[(train, key)]
            assert isinstance(spec, sh.P)
            assert tuple(leaves[key].shape) == shape, key
            assert tuple(spec) == ref_spec, (key, spec, ref_spec)


SANITIZE = [(("model",), (32,)), (("model",), (5,)),
            ((("data", "model"),), (64,)), ((("data", "model"),), (8,)),
            ((("data", "model"),), (12,)), ((("model", "data"),), (48,)),
            ((None, "model"), (3, 48)), (("data", None, "model"), (8, 7, 6)),
            (("data", "model"), (4,)), ((), (9, 9)),
            ((("data", "model"), "model"), (128, 32))]


@pytest.mark.parametrize("entries,shape", SANITIZE)
def test_sanitize_spec_matches_reference(entries, shape):
    got = sh.sanitize_spec(sh.P(*entries), shape, FakeMesh())
    want = ref_sh.sanitize_spec(RefP(*entries), shape, FakeMesh())
    assert isinstance(got, sh.P)
    assert tuple(got) == tuple(want)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "deepseek-v2-lite-buddy",
                                  "rwkv6-1.6b", "zamba2-7b", "smollm-360m"])
def test_bytes_per_device_matches_reference_specs(arch):
    """Per-device bytes of the full config's params on the 16 x 16 mesh:
    the sum over the reference's sanitized specs and shapes."""
    ref = _ref_params(arch, "full")
    params = _port_params(arch, "full")
    cfg = _cfgs(arch, "full")[1]
    mesh = port_mesh.make_production_mesh()
    assert mesh.shape == ProdMesh.shape
    for train in (False, True):
        want = 0
        for (t, _), (shape, spec, itemsize) in ref.items():
            if t != train:
                continue
            s = ref_sh.sanitize_spec(RefP(*spec), shape, ProdMesh())
            div = [ref_sh._axis_size(ProdMesh(), s[i] if i < len(s)
                                     else None) for i in range(len(shape))]
            assert all(n % d == 0 for n, d in zip(shape, div))
            want += int(np.prod([n // d for n, d in zip(shape, div)])) \
                * itemsize
        specs = sh.param_specs(cfg, params, sh.profile_for(cfg, train=train))
        got = sh.bytes_per_device(params, sh.sanitize_specs(specs, params,
                                                            mesh), mesh)
        assert got == want


def test_shard_shape_and_mesh_shapes():
    mesh = port_mesh.make_production_mesh(multi_pod=True)
    assert (mesh.shape, mesh.size, mesh.name) == (
        {"pod": 2, "data": 16, "model": 16}, 512, "2x16x16")
    assert port_mesh.make_test_mesh(8).shape == {"data": 4, "model": 2}
    assert port_mesh.batch_axes(True) == ("pod", "data")
    assert port_mesh.batch_axes(False) == ("data",)
    assert sh.shard_shape((64, 30, 7), sh.P(("pod", "data"), "model"),
                          mesh) == (2, 2, 7)
    t = torch.empty((64, 32), dtype=torch.bfloat16, device="meta")
    assert sh.bytes_per_device({"a": t, "b": (t, None)},
                               {"a": sh.P("data"), "b": (sh.P(), None)},
                               mesh) == 4 * 32 * 2 + 64 * 32 * 2
    with pytest.raises(NotImplementedError):
        sh.cache_specs(None, sh.ShardingProfile())


def test_apply_rules_records_the_mapping_and_shard_is_identity():
    prof = sh.ShardingProfile(multi_pod=True)
    x = torch.ones(2, 3)
    with sh.apply_rules(prof) as rules:
        assert rules == sh.activation_rules(prof)
        assert rules["batch"] == ("pod", "data")
        assert common.shard(x, "batch", None) is x
