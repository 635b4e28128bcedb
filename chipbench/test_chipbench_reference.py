"""CPU tests of the comparison that decides ``correct``: the plain
reference agrees with the port's CPU path (the kernels' plain versions)
on the reduced Mixtral config through the cells' own decode and chunk
paths, and each fault a serving cell can have, planted under the timed
path, comes out as not correct."""
import numpy as np
import pytest
import torch

from chipbench import check, tiny
from chipbench.families import moe_gqa
from chipbench.reference import moe_lm

CELLS = ["mixtral22.decode64", "mixtral22.prefill"]
# what sound CPU runs read at these sizes: the same arithmetic as the
# plain versions, so every number is exact up to float32 rounding
# a tiny run's window in which the residency changes (from the tenth
# decode step) even when every step is slow
RESIDENCY_S = 3.0
TIGHT = {"logit_gap": 1e-4, "logit_err": 1e-4, "topk_mismatch": 0.0,
         "table_mismatch": 0.0, "state_faults": 0.0}


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees_with_the_port(name):
    # long enough for the residency to change however loaded the CPU
    run = tiny.run(name, seconds=RESIDENCY_S)
    steps = {s.kind for s in run.steps}
    assert steps == ({"chunk"} if "prefill" in name else {"decode"})
    nums = check.program_numbers(run)
    ok, compared = check.judge(nums, TIGHT)
    assert ok, compared
    res_steps, _ = check.replay(run, check._program_tables(
        run, run.device)[0].cpu().numpy())
    # the comparison saw substitutions, not only hits, and a residency
    # that the steps changed
    subs = sum(int(b.prog["substituted"].sum())
               for b in check._blocks(run, run.device, res_steps))
    assert subs > 0
    assert any((r != res_steps[0]).any() for r in res_steps)


def test_control_rounds_where_the_program_does_not():
    """The TF32 control's logits move off the float32 reference's where the
    program's CPU path does not (the chip test reads its numbers at the
    cell's size)."""
    run = tiny.run("mixtral22.decode64")
    tables = check._program_tables(run, run.device)
    res_steps, _ = check.replay(run, tables[0].cpu().numpy())
    blk = next(iter(check._blocks(run, run.device, res_steps)))
    route = blk.routing(run, *tables, blk.prog["indices"])
    ref = run.family.Reference(run.params, run.rc)
    ctl = run.family.Reference(run.params, run.rc, moe_lm.Arith(tf32=True))
    a, _ = ref.forward(blk.tokens, blk.seqs, route, head_at=blk.served_at)
    b, _ = ctl.forward(blk.tokens, blk.seqs, route, head_at=blk.served_at)
    assert float((a - b).abs().max()) > 1e-4
    assert check.program_numbers(run)["logit_gap"] <= TIGHT["logit_gap"]


def test_tf32_round_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11 + 2**-12, 3.0, -2.5])
    y = moe_lm.tf32_round(x)
    assert y.tolist() == [1.0 + 2**-10, 1.0 + 2**-10, 3.0, -2.5]


def _broken_cache_write(monkeypatch):
    """A step that returns its state unchanged: attention reads the KV
    cache, but the step's keys and values never land in it."""
    from repro_torch.models import attention

    orig = attention.attn_decode

    def attn_decode(params, x_tok, cache, pos, **kw):
        y, _ = orig(params, x_tok, {k: v.clone() for k, v in cache.items()},
                    pos, **kw)
        return y, cache
    monkeypatch.setattr(attention, "attn_decode", attn_decode)


def _half_batch(monkeypatch):
    """Half of the batch left out: the expert outputs of the second half
    of the batch rows are zero."""
    from repro_torch.kernels import ops

    orig = ops.expert_ffn

    def expert_ffn(x, w1, w3, w2):
        out = orig(x, w1, w3, w2).clone()
        out[:, out.shape[1] // 2:] = 0
        return out
    monkeypatch.setattr(ops, "expert_ffn", expert_ffn)


def _altered_token(monkeypatch):
    """A token altered where it is produced: every row's sampled token
    moved by one."""
    from repro_torch.serving.engine import ServeEngine

    orig = ServeEngine.sample_tokens

    def sample_tokens(self, logits, greedy, temperature=1.0):
        out = np.array(orig(self, logits, greedy, temperature))
        out = (out + 1) % logits.shape[-1]
        return out
    monkeypatch.setattr(ServeEngine, "sample_tokens", sample_tokens)


def _no_replay(monkeypatch):
    """The engine's replay of each step left out: no transfer is issued or
    lands, so the residency the next steps route with never changes."""
    from repro_torch.serving.engine import ServeEngine
    monkeypatch.setattr(ServeEngine, "_account",
                        lambda self, aux, active: None)


def _one_table_list_wrong(monkeypatch):
    """A buddy list of the profiling altered: pivot 0's list in every layer
    reversed."""
    from repro_torch.launch import serve

    orig = serve.profile_buddies

    def profile_buddies(*a, **kw):
        tables, rec = orig(*a, **kw)
        for l in range(tables.table.shape[0]):
            row = tables.table[l, 0]
            n = int((row >= 0).sum())
            if n < 2:
                row[0] = (int(row[0]) + 1) % tables.table.shape[1]
            else:
                row[:n] = row[:n][::-1].copy()
        return tables, rec
    monkeypatch.setattr(serve, "profile_buddies", profile_buddies)


@pytest.mark.parametrize("name,fault", [
    ("mixtral22.decode64", _broken_cache_write),
    ("mixtral22.decode64", _half_batch),
    ("mixtral22.decode64", _altered_token),
    ("mixtral22.decode64", _no_replay),
    ("mixtral22.decode64", _one_table_list_wrong),
    ("mixtral22.prefill", _altered_token),
    ("mixtral22.prefill", _no_replay)])
def test_faults_come_out_not_correct(name, fault, monkeypatch):
    """Judged by the numbers the cell compares (the prefill cell has no
    ``logit_gap``: ``logit_err`` has to catch the altered token)."""
    fault(monkeypatch)
    seconds = RESIDENCY_S if fault is _no_replay else 1.0
    run = tiny.run(name, seconds=seconds, requests=1000)
    limits = {k: v for k, v in TIGHT.items()
              if k in run.cell["cell"]["check"]["limits"]}
    ok, compared = check.judge(check.program_numbers(run), limits)
    assert not ok, compared


@pytest.mark.parametrize("name", ["mixtral22.decode64"])
def test_weights_in_the_programs_layout(name):
    """The benchmark's weights have the leaves, shapes and dtypes of the
    program's own init at the configuration's full size (on meta)."""
    from chipbench import bench
    from repro_torch.launch import serve
    from repro_torch.models import transformer
    cell = bench.load_cell(name)
    cfg = serve.model_config(serve.parse_args(cell["config"]["launcher"]))
    meta = transformer.init_params(cfg, device="meta")

    def leaves(tree, pre=""):
        if isinstance(tree, dict):
            for k, v in tree.items():
                yield from leaves(v, f"{pre}.{k}" if pre else k)
        elif isinstance(tree, (tuple, list)):
            for i, v in enumerate(tree):
                yield from leaves(v, f"{pre}.{i}")
        else:
            yield pre, tuple(tree.shape), tree.dtype
    want = sorted(leaves(meta))
    assert cell["family"].__file__ == moe_gqa.__file__
    got = sorted((p, s, torch.float32) for p, (s, _) in
                 cell["family"].shapes(cell["config"]["as_run"]).items())
    assert got == want
