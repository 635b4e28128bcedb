"""The port's config registry against the JAX package's: every registered
arch's ``CONFIG`` and ``reduced()`` equal the reference's field by field
(``dataclasses.asdict``, the nested MoE and SSM configs included), and the
port registers the reference's arch ids, in its order, less the three
families whose model code is not ported yet."""
import dataclasses

import pytest

pytest.importorskip("torch")

from repro.configs import base as JB  # noqa: E402
from repro_torch.configs import base as B  # noqa: E402

UNPORTED = ("zamba2-7b", "llama-3.2-vision-11b", "musicgen-large")


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
