"""The port's chunked attention against the JAX package's, on the CPU:
``models/attention._flash_attend`` (an online softmax over q chunks and kv
chunks) against ``repro.models.attention._flash_attend`` on the same
seeded numpy inputs, its gradients against ``jax.grad`` through the
reference's scan, and ``forward_train`` of the reduced internlm2-1.8b and
Mixtral-8x7B (window 128) at lengths above one chunk, with the reference's
random weights from PRNGKey(0) carried across by ``params_from_numpy``.

Tolerances: f32 outputs within 1e-5 absolute (inputs of unit scale; the
same recurrence, only the dot products' inner sums in another order);
bf16 outputs within one bf16 ulp of the reference's (2^-7 of the value:
the f32 result rounded to bf16 may land on the other side of a rounding
boundary); each gradient within 1e-4 of its largest entry; model logits
within ``LOGIT_TOL`` = 1e-4, as tests/test_torch_model.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint.io import _flatten_with_paths  # noqa: E402
from repro.configs.base import get_reduced as jreduced  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.checkpoint.io import params_from_numpy  # noqa: E402
from repro_torch.configs.base import get_reduced  # noqa: E402
from repro_torch.launch.roofline import OpCounter  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from test_torch_mixtral import one_torch_thread  # noqa: E402,F401

F32_TOL = 1e-5
GRAD_RTOL = 1e-4
LOGIT_TOL = 1e-4
SMALL = dict(q_chunk=16, kv_chunk=8)     # as tests/test_attention.py


def _inputs(seed, b, sq, skv, h, kv, hd, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(dtype) for shape in
            ((b, sq, h, hd), (b, skv, kv, hd), (b, skv, kv, hd))]


def _both(arrays, q_offset, jdtype=jnp.float32, tdtype=torch.float32,
          **kw):
    """(port, reference) _flash_attend on the same inputs, as f32 numpy."""
    want = JA._flash_attend(*[jnp.asarray(a, jdtype) for a in arrays],
                            q_offset, **kw)
    got = A._flash_attend(*[torch.from_numpy(a).to(tdtype) for a in arrays],
                          q_offset, **kw)
    assert got.dtype == tdtype and got.shape == tuple(want.shape)
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


# (seed, b, sq, skv, h, kv, q_offset, causal, window)
CASES = {
    "causal": (0, 2, 64, 64, 4, 2, 0, True, 0),
    # a window narrower than a kv chunk: from query 16 on, whole earlier
    # chunks are masked before a visible one (the -1e30 path)
    "window_inside_chunk": (1, 2, 64, 64, 4, 2, 0, True, 5),
    "gqa_g1": (2, 1, 48, 48, 4, 4, 0, True, 0),
    "gqa_g2": (3, 1, 48, 48, 4, 2, 0, True, 0),
    "gqa_g4": (4, 1, 48, 48, 8, 2, 0, True, 0),
    # neither length a multiple of its chunk: padded queries and keys
    "padding": (5, 2, 37, 37, 4, 2, 0, True, 0),
    "padding_window": (6, 1, 53, 53, 4, 2, 0, True, 11),
    # queries at the end of a longer key range
    "q_offset": (7, 2, 20, 45, 4, 2, 25, True, 0),
    "q_offset_window": (8, 1, 19, 43, 4, 1, 24, True, 9),
    # cross attention: no mask but the padded keys
    "not_causal": (9, 2, 30, 37, 4, 2, 0, False, 0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_flash_attend_matches_reference(name):
    seed, b, sq, skv, h, kv, off, causal, window = CASES[name]
    got, want = _both(_inputs(seed, b, sq, skv, h, kv, 16), off,
                      causal=causal, window=window, **SMALL)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("name", ["causal", "padding_window", "not_causal"])
def test_flash_attend_bf16_matches_reference(name):
    seed, b, sq, skv, h, kv, off, causal, window = CASES[name]
    got, want = _both(_inputs(seed, b, sq, skv, h, kv, 16), off,
                      jdtype=jnp.bfloat16, tdtype=torch.bfloat16,
                      causal=causal, window=window, **SMALL)
    assert (np.abs(got - want) <= 2.0 ** -7 * np.abs(want) + 1e-6).all()


def test_flash_attend_default_chunks_matches_reference():
    """The reference's own chunks at S = 1100: 3 q chunks of 512 (the last
    padded by 436 rows) and 2 kv chunks of 1024 (the second padded by
    948 keys), at a narrow width."""
    got, want = _both(_inputs(10, 1, 1100, 1100, 4, 2, 16), 0,
                      causal=True, window=0)
    np.testing.assert_allclose(got, want, rtol=0, atol=F32_TOL)


# (seed, b, sq, skv, h, kv, q_offset, window): both above one chunk
GRAD_CASES = [(11, 2, 40, 40, 4, 2, 0, 0), (12, 1, 29, 45, 4, 1, 16, 6)]


@pytest.mark.parametrize("case", GRAD_CASES, ids=["causal", "offset_window"])
def test_flash_attend_gradients_match_jax_grad(case):
    """Torch autograd through the port's kv loop against jax.grad through
    the reference's lax.map and lax.scan, of sum(out * w)."""
    seed, b, sq, skv, h, kv, off, window = case
    q, k, v = _inputs(seed, b, sq, skv, h, kv, 16)
    w = np.random.default_rng(seed + 100).standard_normal(
        (b, sq, h, 16)).astype(np.float32)

    def jloss(q, k, v):
        return jnp.sum(JA._flash_attend(q, k, v, off, causal=True,
                                        window=window, **SMALL) * w)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    loss = (A._flash_attend(tq, tk, tv, off, causal=True, window=window,
                            **SMALL) * torch.from_numpy(w)).sum()
    loss.backward()
    for name, t, want in zip("qkv", (tq, tk, tv), jg):
        want = np.asarray(want)
        err = np.abs(t.grad.numpy() - want).max()
        assert err <= GRAD_RTOL * np.abs(want).max(), (name, err)


def _model(arch):
    jcfg, cfg = jreduced(arch), get_reduced(arch)
    jp = JT.init_params(jcfg, jax.random.PRNGKey(0))
    flat = {k: np.asarray(a) for k, a in _flatten_with_paths(jp).items()}
    return jcfg, jp, cfg, params_from_numpy(flat, "cpu")


@pytest.mark.parametrize("arch,s", [("internlm2-1.8b", 1100),
                                    ("mixtral-8x7b", 1200)])
def test_forward_train_above_one_chunk_matches_reference(arch, s):
    """forward_train of the reduced config on 1 x s tokens: 3 q chunks and
    2 kv chunks per layer. Mixtral's window is 128, so queries from 1152
    on see nothing of kv chunk 0: the -1e30 path at the model level."""
    jcfg, jp, cfg, tp = _model(arch)
    assert cfg.sliding_window == (128 if arch == "mixtral-8x7b" else 0)
    toks = np.random.default_rng(13).integers(0, cfg.vocab_size, (1, s))
    want, _ = jax.jit(lambda p, t: JT.forward_train(p, jcfg, t))(
        jp, jnp.asarray(toks))
    with torch.no_grad():
        got, _ = T.forward_train(tp, cfg, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_attn_forward_counts_equal_on_meta_and_cpu():
    """The OpCounter count of attn_forward at S = 1100 (the chunk loop) on
    the meta device equals the CPU's."""
    cfg = get_reduced("internlm2-1.8b")
    kw = dict(num_heads=cfg.num_heads, num_kv_heads=cfg.num_kv_heads,
              head_dim=cfg.head_dim, rope_theta=cfg.rope_theta)
    params = A.init_attn(torch.Generator().manual_seed(0), cfg.d_model,
                         cfg.num_heads, cfg.num_kv_heads, cfg.head_dim,
                         torch.float32, "cpu")
    x = torch.randn(1, 1100, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    counts = {}
    for dev in ("meta", "cpu"):
        p_dev = {n: t.to(dev) for n, t in params.items()}
        x_dev, pos = x.to(dev), torch.arange(1100, device=dev)[None]
        with torch.no_grad(), OpCounter() as c:
            y = A.attn_forward(p_dev, x_dev, pos, **kw)
        assert y.device.type == dev and y.shape == x.shape
        counts[dev] = c.as_dict()
    assert counts["meta"] == counts["cpu"]
    # the products at the padded shape: 2 kv chunks of 1024 x 1536 rows
    # x H heads, q.k and p.v
    hd, h = cfg.head_dim, cfg.num_heads
    attn_flops = 2 * (2 * 1536 * 2048 * h * hd)
    proj_flops = 2 * 1100 * cfg.d_model * hd * (2 * h + 2 * cfg.num_kv_heads)
    assert counts["cpu"]["flops"] == attn_flops + proj_flops

