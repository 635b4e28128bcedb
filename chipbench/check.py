"""How ``correct`` is decided: the served tokens of a sample of the
requests the window finished, judged by the plain reference (the
configuration's family's ``Reference``, ``chipbench/families/``, on the
shared parts of ``chipbench.reference``) over each prompt and its served
tokens. Every array kept per layer is kept per MoE layer
(``family.moe_layers``).

The reference works out again the serving state the routing reads:
  * the buddy tables, from its own profiling forwards over the seed-0
    stream, continued with the program's top-k of each profiling token
    where its own differs by rounding (counted in ``topk_mismatch``); the
    program's tables have to equal them (``table_mismatch``: share of
    pivots whose list differs);
  * the expert residency of every step, by a frozen copy of the serving
    runtime (``reference.residency``) driven by the program's records of
    each step (the router's top-k and the substitution flags of every
    active token); every residency cell of every step that differs from
    the program's, and every slot the program marked missed where the
    reference does not or the other way round, is a ``state_faults``;
  * the router's top-k of each served token in each layer, which the
    reference continues with where its own differs by rounding
    (``topk_mismatch``: share of (layer, token) sets that differ, over
    the sample's tokens and the profiling tokens).
With its own tables and residency the reference computes itself the gates,
Algorithm 1's substitutions and misses, every expert, attention and the
head, and so the widest gap by which a served token's logit lies below
the reference's best (``logit_gap``) and the widest difference between
the logit the program sampled each served token from and the reference's
best logit at that position (``logit_err``: rounding where the two agree,
the gap where the token was altered after its logits). ``state_faults``
also counts records the program left missing.

The control (``control_numbers``) is the same reference computed with
TF32 matmuls, put in the program's place.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from chipbench.reference import moe_lm, residency, serving_state

NAMES = ("logit_gap", "logit_err", "topk_mismatch", "table_mismatch",
         "state_faults")


def sample(run) -> list:
    """Requests finished in the window, drawn from the seed: the longest
    (prompt and output) first, then ``check.requests`` - 1 others."""
    done = []
    for r in run.requests:
        walls = run.emitted.get(r.rid, [])
        if len(walls) >= r.max_new_tokens and \
                run.t_open <= walls[-1] <= run.t_close:
            done.append(r)
    if not done:
        raise RuntimeError("no request finished in the window")
    done.sort(key=lambda r: (-(len(r.prompt) + r.max_new_tokens), r.rid))
    n = min(int(run.cell["cell"]["check"]["requests"]), len(done))
    rng = np.random.default_rng(run.seed)
    rest = rng.permutation(len(done) - 1)[:n - 1] + 1
    return [done[0]] + [done[int(i)] for i in sorted(rest)]


def _where(run, rids: set) -> dict:
    """(rid, position) -> (step index, token index on the step's T axis)."""
    out = {}
    for si, st in enumerate(run.steps):
        if st.aux is None:
            continue
        for i, rid in enumerate(st.rids):
            if rid not in rids:
                continue
            if st.kind == "decode":
                if st.valid[i]:
                    out[(rid, int(st.pos[i]))] = (si, i)
            else:
                c = st.valid.shape[1]
                for j in np.flatnonzero(st.valid[i]):
                    out[(rid, int(st.pos[i]) + int(j))] = (si, i * c + int(j))
    return out


class Block:
    """A block of sampled requests laid out flat for the reference, with
    the program's records of every position."""

    def __init__(self, run, reqs, where, dev, res_steps):
        toks, seqs, served_at, served_tok, spots = [], [], [], [], []
        served_logit = []
        self.missing = 0
        for r in reqs:
            fed = list(map(int, r.prompt)) + list(map(int, r.tokens[:-1]))
            start = len(toks)
            toks += fed
            seqs.append((start, torch.arange(len(fed), device=dev)))
            for j, tok in enumerate(r.tokens):
                served_at.append(start + len(r.prompt) - 1 + j)
                served_tok.append(int(tok))
                e = run.emitted_at.get((r.rid, j))
                if e is None or run.steps[e[0]].served_logit is None:
                    self.missing += 1
                    served_logit.append(math.nan)
                else:
                    served_logit.append(float(
                        run.steps[e[0]].served_logit[e[1]]))
            for p in range(len(fed)):
                s = where.get((r.rid, p))
                if s is None:
                    self.missing += 1
                    s = (-1, 0)
                spots.append(s)
        self.tokens = torch.as_tensor(toks, device=dev)
        self.seqs = seqs
        self.served_at = torch.as_tensor(served_at, device=dev)
        self.served_tok = torch.as_tensor(served_tok, device=dev)
        self.served_logit = torch.as_tensor(served_logit,
                                            dtype=torch.float32, device=dev)
        self.n = len(toks)
        self.spots = spots
        self._program(run, dev, res_steps)

    def _program(self, run, dev, res_steps):
        """The program's top-k and substitutions at every position, and
        the reference's residency and distribution gate of the step that
        made it."""
        rc = run.rc
        l_n = run.family.moe_layers(rc)
        k_n, e_n = rc["top_k"], rc["num_experts"]
        beta = float(run.args.beta)
        self.prog = {k: torch.zeros((l_n, self.n, k_n), dtype=dt, device=dev)
                     for k, dt in (("indices", torch.int64),
                                   ("substituted", torch.bool))}
        self.resident = torch.zeros((l_n, self.n, e_n), dtype=torch.bool,
                                    device=dev)
        self.dist_ok = torch.zeros((l_n, self.n), dtype=torch.bool,
                                   device=dev)
        by_step: dict = {}
        for n, (si, t) in enumerate(self.spots):
            if si >= 0:
                by_step.setdefault(si, ([], []))
                by_step[si][0].append(n)
                by_step[si][1].append(t)
        for si, (ns, ts) in by_step.items():
            st = run.steps[si]
            ns_t = torch.as_tensor(ns, device=dev)
            ts_t = torch.as_tensor(ts, device=dev)
            for k in self.prog:
                self.prog[k][:, ns_t] = st.aux[k].to(dev)[:, ts_t].to(
                    self.prog[k].dtype)
            res = torch.as_tensor(res_steps[si], device=dev)     # [M, E]
            self.resident[:, ns_t] = res[:, None, :]
            idx = st.aux["indices"].to(dev).long()                # [M, T, K]
            req = torch.zeros((l_n, e_n), dtype=torch.bool, device=dev)
            req.scatter_(1, idx.reshape(l_n, -1), True)
            n_req = req.sum(-1).float().clamp(min=1.0)
            n_cpu = (req & ~res).sum(-1).float()
            self.dist_ok[:, ns_t] = ((n_cpu / n_req) < beta)[:, None]

    def routing(self, run, table, q, follow):
        args = run.args
        return moe_lm.Routing(
            resident=self.resident, dist_ok=self.dist_ok, table=table, q=q,
            tau=float(args.tau), rho=int(args.rho), h=8,
            substitute=args.policy == "buddy", follow=follow)


def _program_tables(run, dev):
    return (run.eng._table_dev.to(dev).long(), run.eng._q_dev.to(dev).float())


def _table_mismatch(a_table, a_q, b_table, b_q) -> float:
    a_t, b_t = np.asarray(a_table), np.asarray(b_table)
    diff = (a_t != b_t).any(-1) | (np.abs(np.asarray(a_q, np.float64)
                                          - np.asarray(b_q, np.float64))
                                   > 1e-7).any(-1)
    return float(diff.mean())


def replay(run, table) -> tuple:
    """The residency of every step as the reference works it out from the
    program's records of the steps before it, and the state faults: the
    residency cells that differ from the program's, the missed slots that
    differ, and the active tokens of a step without records."""
    rc, args = run.rc, run.args
    rp = residency.Replay(run.family, rc, float(args.cache_rate), table,
                          int(args.prefetch_k), int(args.lookahead))
    layers = np.arange(run.family.moe_layers(rc))[:, None, None]
    out, faults = [], 0
    for st in run.steps:
        res = rp.residency()
        out.append(res)
        faults += int((st.residency != res).sum())
        active = np.asarray(st.valid, bool).reshape(-1)
        if not active.any():
            continue
        if st.aux is None:
            faults += int(active.sum())
            continue
        idx, sub, missed = (st.aux[k].cpu().numpy() for k in
                            ("indices", "substituted", "missed"))
        idx = idx.astype(np.int64)
        miss = ~res[layers, idx] & (sub == 0)
        faults += int((miss != (missed != 0))[:, active].sum())
        rp.step(idx, miss, active)
    return out, faults


def _tables(tables, dev):
    return (torch.as_tensor(tables[0], device=dev).long(),
            torch.as_tensor(tables[1], device=dev).float())


def _compare(ref, blk, route, subj_topk, served_tok, served_logit):
    """Run the reference over a block following ``route`` and compare
    with the subject's records. Returns (gap, logit err, topk diffs,
    L*N)."""
    logits, own = ref.forward(blk.tokens, blk.seqs, route,
                              head_at=blk.served_at)
    rows = torch.arange(logits.shape[0], device=logits.device)
    best = logits.max(-1).values
    gap = float((best - logits[rows, served_tok]).max())
    err = (served_logit - best).abs().max()
    err = float(err) if bool(torch.isfinite(err)) else math.inf
    tk = int((own.sort(-1).values != subj_topk.sort(-1).values)
             .any(-1).sum())
    return gap, err, tk, own.shape[0] * own.shape[1]


def _blocks(run, dev, res_steps):
    reqs = sample(run)
    where = _where(run, {r.rid for r in reqs})
    size = int(run.cell["cell"]["check"].get("block", len(reqs)))
    for i in range(0, len(reqs), size):
        yield Block(run, reqs[i:i + size], where, dev, res_steps)


def _tally(parts, flips: int, sets: int) -> dict:
    """``flips`` of ``sets`` profiling top-k sets differ."""
    return {"logit_gap": max(p[0] for p in parts),
            "logit_err": max(p[1] for p in parts),
            "topk_mismatch": (sum(p[2] for p in parts) + flips)
            / max(1, sum(p[3] for p in parts) + sets)}


def _setup_reference(run, tf32: bool):
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return run.family.Reference(run.params, run.rc,
                                moe_lm.Arith(tf32=tf32))


def program_numbers(run) -> dict:
    """The compared numbers of the program's run."""
    dev = run.device
    ref = _setup_reference(run, tf32=False)
    alpha = float(run.args.alpha)
    follow = run.profile_topk
    faults = 0
    if len(follow) != serving_state.PROFILE_STEPS or \
            any(f is None for f in follow):
        faults += 1
        follow = None
    with torch.no_grad():
        own_t, own_q, _, flips, sets = serving_state.profile_tables(
            ref, run.rc, alpha, dev, follow)
        p_t, p_q = _program_tables(run, dev)
        table = _table_mismatch(own_t, own_q, p_t.cpu().numpy(),
                                p_q.cpu().numpy())
        res_steps, n = replay(run, own_t)
        faults += n
        t_dev, q_dev = _tables((own_t, own_q), dev)
        parts = []
        for blk in _blocks(run, dev, res_steps):
            faults += blk.missing
            route = blk.routing(run, t_dev, q_dev, blk.prog["indices"])
            parts.append(_compare(ref, blk, route, blk.prog["indices"],
                                  blk.served_tok, blk.served_logit))
    return dict(_tally(parts, flips, sets), table_mismatch=table,
                state_faults=float(faults))


def control_numbers(run) -> dict:
    """The same numbers with the TF32 reference in the program's place:
    its own profiling, tables and top-k, and the token it puts first
    (with its logit) at each served position of the program's prompts
    and tokens. The residency is the reference's replay of the program's
    steps: the control serves no steps of its own."""
    dev = run.device
    ref = _setup_reference(run, tf32=False)
    ctl = run.family.Reference(run.params, run.rc,
                               moe_lm.Arith(tf32=True))
    alpha = float(run.args.alpha)
    with torch.no_grad():
        c_t, c_q, c_top, _, _ = serving_state.profile_tables(
            ctl, run.rc, alpha, dev)
        r_t, r_q, _, flips, sets = serving_state.profile_tables(
            ref, run.rc, alpha, dev, c_top)
        table = _table_mismatch(r_t, r_q, c_t, c_q)
        res_steps, _ = replay(run, r_t)
        c_tab, r_tab = _tables((c_t, c_q), dev), _tables((r_t, r_q), dev)
        parts = []
        for blk in _blocks(run, dev, res_steps):
            route = blk.routing(run, *c_tab, None)
            c_logits, c_top_s = ctl.forward(blk.tokens, blk.seqs, route,
                                            head_at=blk.served_at)
            route = blk.routing(run, *r_tab, c_top_s)
            first = c_logits.argmax(-1)
            rows = torch.arange(first.shape[0], device=dev)
            parts.append(_compare(ref, blk, route, c_top_s, first,
                                  c_logits[rows, first]))
    return dict(_tally(parts, flips, sets), table_mismatch=table,
                state_faults=0.0)


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: [value, limit]}) over the numbers the cell gives a
    limit: every one at or under its limit; one that is not finite
    fails."""
    out = {k: [numbers[k], limits[k]] for k in NAMES if k in limits}
    ok = all(math.isfinite(v) and v <= lim for v, lim in out.values())
    return ok, out
