"""The port's config registry against the JAX package's: every registered
arch's ``CONFIG`` and ``reduced()`` equal the reference's field by field
(``dataclasses.asdict``, the nested MoE and SSM configs included), and the
port registers the reference's arch ids, in its order (``UNPORTED``, the
arch ids whose model code the port lacks, is empty); and every arch's
reduced config builds, runs forward_train, a decode_step and a train step
on the CPU, with conditioning where the config has conditioning tokens."""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

from repro.configs import base as JB  # noqa: E402
from repro_torch.configs import base as B  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.training import optimizer as O  # noqa: E402
from repro_torch.training import train_loop as L  # noqa: E402
from test_torch_mixtral import one_torch_thread  # noqa: E402,F401

UNPORTED = ()


def test_arch_ids_are_the_references_less_the_unported_families():
    assert B.ARCH_IDS == [a for a in JB.ARCH_IDS if a not in UNPORTED]
    assert set(B._MODULES) == set(B.ARCH_IDS)
    for a in UNPORTED:
        with pytest.raises(KeyError):
            B.get_config(a)


@pytest.mark.parametrize("kind", ["config", "reduced"])
@pytest.mark.parametrize("arch", B.ARCH_IDS)
def test_config_equals_reference(arch, kind):
    get, jget = ((B.get_config, JB.get_config) if kind == "config"
                 else (B.get_reduced, JB.get_reduced))
    got, want = get(arch), jget(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.stack() == want.stack()
    assert got.param_count() == want.param_count()
    assert got.active_param_count() == want.active_param_count()


def test_mixtral_is_the_published_shape():
    """The widths the chip run serves: 32 query heads over 8 KV heads,
    8 experts x 14336, top-2, no shared expert, window 4096, theta 1e6."""
    c = B.get_config("mixtral-8x7b")
    assert (c.d_model, c.num_heads, c.num_kv_heads, c.head_dim) == \
        (4096, 32, 8, 128)
    assert (c.moe.num_experts, c.moe.d_ff, c.moe.top_k,
            c.moe.num_shared_experts) == (8, 14336, 2, 0)
    assert (c.sliding_window, c.rope_theta, c.vocab_size) == \
        (4096, 1e6, 32000)


@pytest.mark.parametrize("arch", B.ARCH_IDS)
def test_every_arch_runs_on_cpu(arch):
    cfg = B.get_reduced(arch)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    toks = torch.randint(0, cfg.vocab_size, (2, 9), generator=gen)
    cond = (torch.randn(2, cfg.num_cond_tokens, cfg.cond_dim, generator=gen)
            if cfg.num_cond_tokens else None)
    with torch.no_grad():
        logits, _ = T.forward_train(params, cfg, toks[:, :-1],
                                    cond_embeds=cond)
        caches = T.init_caches(cfg, 2, 8, device="cpu")
        lg, _, _ = T.decode_step(params, cfg, toks[:, 0], caches, 0)
    assert logits.shape == (2, 8, cfg.vocab_size)
    assert lg.shape == (2, cfg.vocab_size)
    assert bool(torch.isfinite(logits).all() and torch.isfinite(lg).all())
    _, _, m = L.make_train_step(cfg, O.AdamWConfig(total_steps=3))(
        params, O.init_opt_state(params), toks[:, :-1], toks[:, 1:],
        cond_embeds=cond)
    assert math.isfinite(float(m["loss"])) and float(m["grad_norm"]) > 0
