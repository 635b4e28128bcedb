"""CPU tests of the families (``chipbench/families/``): the ``moe_gqa``
family gives the very weights, reference outputs, counts and residency
replay the harness gave before it knew families (golden values frozen
from that harness), a family is taken from new files alone, a
configuration without a known family stops before any weight is made, and
the arrays kept per layer follow the family's count of MoE layers."""
import hashlib
import json
import shutil
import types

import numpy as np
import pytest
import torch

from chipbench import bench, check, families, tiny, weights, yardstick
from chipbench.families import moe_gqa
from chipbench.reference import moe_lm, residency, serving_state

RC = moe_gqa.TINY["mixtral-8x22b"]
FULL = json.loads((bench.HERE / "configs" / "mixtral-8x22b-6l.json")
                  .read_text())["as_run"]
SEED = 2**31 + 4242
CELL = "mixtral22.decode64"
TIGHT = {"logit_gap": 1e-4, "logit_err": 1e-4, "topk_mismatch": 0.0,
         "table_mismatch": 0.0, "state_faults": 0.0}

# SHA-256 of the bytes, and the counts, that the harness gave for RC
# before the families (the same computations through its own functions)
GOLDEN = {
    "weights": "320a00badffceb18e55ea9f61809723e7ab008b40e22099888e0b552f5d2da45",
    "logits_plain": "5218b3c9915af26a94415edcf1d59a8ec33da171b0efcdf4c806efdbd51daa5c",
    "topk_plain": "04f230496bd9005072570202ba760b3b4302300c73d0271e58a1b2bcb802a79b",
    "logits_tf32": "b83b554dd3c5e105584ce212847844f59beeb30424a5415dd5a05a6515a16d59",
    "topk_tf32": "04f230496bd9005072570202ba760b3b4302300c73d0271e58a1b2bcb802a79b",
    "logits_routed": "235d3d57aaadffce289c55593b05fd741dc5d65fb44bc0d527d6a3532c78837a",
    "topk_routed": "88e89ab1b4ffcddda518ae4446636d3428f593cd0417fd65c80e1e20b3625c37",
    "topk_profile": "d07cbce8f71ebdc91f6b57b21c1f1a1e52e81af8573f5656723191ece2a568b4",
    "logits_capacity_follow": "0b085556060bab4cc202991e80ae406f1727ae886d739a650f69153c8fb5b035",
    "replay": "5aae61f9ef7508503d437a78a90fdc10054df4fc8b86805ac8a1363ac43f19fe",
}
ACTIVE_PARAMS = {"tiny": 2231296, "full": 4555382784}
# token_flops at (context, head)
TOKEN_FLOPS = {
    "tiny": {(5, True): 4208640.0, (5, False): 3946496.0,
             (300, True): 4460544.0, (300, False): 4198400.0,
             (5000, True): 4460544.0, (5000, False): 4198400.0},
    "full": {(5, True): 8708702208.0, (5, False): 8306049024.0,
             (300, True): 8752201728.0, (300, False): 8349548544.0,
             (5000, True): 9311944704.0, (5000, False): 8909291520.0},
}


def _sha(*tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()


def _leaf(params, path):
    keys = path.split(".")
    node = params
    if keys[0] == "groups":
        node, keys = params["groups"][int(keys[1])], keys[2:]
    for k in keys:
        node = node[k]
    return node


@pytest.fixture(scope="module")
def params():
    return weights.make(moe_gqa, RC, SEED, "cpu")


def test_golden_weights(params):
    h = hashlib.sha256()
    for path in moe_gqa.shapes(RC):
        h.update(path.encode())
        h.update(_leaf(params, path).numpy().tobytes())
    assert h.hexdigest() == GOLDEN["weights"]
    assert isinstance(params["groups"], tuple) and len(params["groups"]) == 1


def _reference_outputs(params, which):
    tokens = (torch.arange(40) * 37 + 11) % RC["vocab_size"]
    seqs = [(0, torch.arange(24)), (24, torch.arange(16))]
    e_n = RC["num_experts"]
    ref = moe_gqa.Reference(params, RC)
    if which in ("plain", "tf32"):
        arith = moe_lm.Arith(tf32=which == "tf32")
        return moe_gqa.Reference(params, RC, arith).forward(tokens, seqs)
    if which == "routed":
        _, own = ref.forward(tokens, seqs)
        table, q = serving_state.buddy_lists(own.numpy(), e_n, 0.9)
        rng = np.random.default_rng(7)
        m, n = own.shape[0], tokens.shape[0]
        route = moe_lm.Routing(
            resident=torch.as_tensor(rng.random((m, n, e_n)) < 0.5),
            dist_ok=torch.as_tensor(rng.random((m, n)) < 0.8),
            table=torch.as_tensor(table).long(),
            q=torch.as_tensor(q).float(), tau=0.2, rho=3, h=8)
        return ref.forward(tokens, seqs, route,
                           head_at=torch.tensor([3, 23, 30, 39]))
    # the profiling form: row-local capacity, then continued with a follow
    pos = torch.arange(16)
    pseqs = [(0, pos), (16, pos)]
    _, own = ref.forward(tokens[:32], pseqs, None,
                         head_at=torch.zeros(1, dtype=torch.int64),
                         capacity=(2, serving_state.full_capacity(16, 2,
                                                                  e_n)))
    logits, _ = ref.forward(tokens[:32], pseqs, None, capacity=(2, 4),
                            follow=torch.flip(own, [-1]))
    return logits, own


@pytest.mark.parametrize("which", ["plain", "tf32", "routed", "profile"])
def test_golden_reference(params, which):
    with torch.no_grad():
        logits, own = _reference_outputs(params, which)
    if which == "profile":
        assert _sha(own) == GOLDEN["topk_profile"]
        assert _sha(logits) == GOLDEN["logits_capacity_follow"]
    else:
        assert _sha(logits) == GOLDEN[f"logits_{which}"]
        assert _sha(own) == GOLDEN[f"topk_{which}"]


@pytest.mark.parametrize("size", ["tiny", "full"])
def test_golden_counts(size):
    rc = RC if size == "tiny" else FULL
    assert moe_gqa.moe_layers(rc) == rc["num_layers"]
    assert moe_gqa.active_params(rc) == ACTIVE_PARAMS[size]
    for (ctx, head), want in TOKEN_FLOPS[size].items():
        assert yardstick.token_flops(moe_gqa, rc, ctx, head) == want


def test_golden_replay():
    rng = np.random.default_rng(11)
    l_n, e_n, k_n, t_n = (moe_gqa.moe_layers(RC), RC["num_experts"],
                          RC["top_k"], 6)
    table = np.stack([serving_state.buddy_lists(
        rng.integers(0, e_n, (1, 64, k_n)), e_n, 0.9)[0][0]
        for _ in range(l_n)])
    rp = residency.Replay(moe_gqa, RC, 0.5, table, -1, 1)
    h = hashlib.sha256()
    for _ in range(30):
        h.update(rp.residency().tobytes())
        idx = np.stack([np.stack([rng.permutation(e_n)[:k_n]
                                  for _ in range(t_n)]) for _ in range(l_n)])
        missed = rng.random((l_n, t_n, k_n)) < 0.3
        active = rng.random(t_n) < 0.8
        rp.step(idx, missed, active)
    h.update(rp.residency().tobytes())
    h.update(np.float64(rp.link.now).tobytes())
    assert h.hexdigest() == GOLDEN["replay"]


def _root(tmp_path, family):
    """A benchmark tree under ``tmp_path`` holding BENCHMARK.json and the
    cells' files, its configuration naming ``family`` (None: no key), and
    no family module."""
    shutil.copy(bench.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for d in ("configs", "workloads", "traffic"):
        shutil.copytree(bench.HERE / d, tmp_path / "chipbench" / d)
    (tmp_path / "chipbench" / "families").mkdir()
    cfg_path = tmp_path / "chipbench" / "configs" / "mixtral-8x22b-6l.json"
    cfg = json.loads(cfg_path.read_text())
    cfg.pop("family")
    if family is not None:
        cfg["family"] = family
    cfg_path.write_text(json.dumps(cfg))
    return tmp_path


def test_family_from_new_files_alone(tmp_path):
    """A family module written beside the cell's files, re-exporting
    ``moe_gqa`` under another name, serves the tiny cell end to end, and
    the cell reads the same numbers through it as through ``moe_gqa``."""
    root = _root(tmp_path, "gqa_copy")
    (root / "chipbench" / "families" / "gqa_copy.py").write_text(
        "from chipbench.families import moe_gqa as _m\n"
        "globals().update({k: getattr(_m, k) for k in dir(_m)\n"
        "                  if not k.startswith('__')})\n")
    run = bench.Run(tiny.cell(CELL, root=root), 1234567890123, 1.0, False,
                    "cpu")
    assert run.family.__file__ == str(root / "chipbench" / "families"
                                      / "gqa_copy.py")
    run.build()
    run.serve()
    mine = weights.make(moe_gqa, run.rc, run.seed, "cpu")
    for path in moe_gqa.shapes(run.rc):
        assert torch.equal(_leaf(run.params, path), _leaf(mine, path))
    copy = check.program_numbers(run)
    ok, compared = check.judge(copy, TIGHT)
    assert ok, compared
    run.family = moe_gqa
    assert check.program_numbers(run) == copy


@pytest.mark.parametrize("family", [None, "no_such_family", "../moe_gqa"])
def test_unknown_family_stops_before_weights(tmp_path, monkeypatch, family):
    def make(*a, **kw):
        raise AssertionError("weights made for an unknown family")
    monkeypatch.setattr(weights, "make", make)
    root = _root(tmp_path, family)
    with pytest.raises(SystemExit, match="family"):
        tiny.run(CELL, root=root)
    with pytest.raises(SystemExit, match="family"):
        families.load(family, root / "chipbench" / "families")


def test_arrays_follow_the_moe_layer_count():
    """A family with fewer MoE layers than layers sizes the residency
    replay, the program's records and the reference's routing state by
    its count: here the tiny cell's records cut to its first layer."""
    run = tiny.run(CELL)
    one = types.SimpleNamespace(**{k: v for k, v in vars(moe_gqa).items()
                                   if not k.startswith("__")})
    one.moe_layers = lambda rc: rc["num_layers"] - 1
    run.family = one
    m, e_n = one.moe_layers(run.rc), run.rc["num_experts"]
    assert 0 < m < run.rc["num_layers"]
    for st in run.steps:
        st.residency = st.residency[:m]
        if st.aux is not None:
            st.aux = {k: v[:m] for k, v in st.aux.items()}
    table = check._program_tables(run, run.device)[0].cpu().numpy()[:m]
    rp = residency.Replay(one, run.rc, 0.5, table)
    assert rp.residency().shape == (m, e_n)
    res_steps, _ = check.replay(run, table)
    assert {r.shape for r in res_steps} == {(m, e_n)}
    blk = next(iter(check._blocks(run, run.device, res_steps)))
    assert blk.prog["indices"].shape[0] == m
    assert blk.prog["substituted"].shape[0] == m
    assert blk.resident.shape[:1] == (m,) and blk.dist_ok.shape[0] == m
