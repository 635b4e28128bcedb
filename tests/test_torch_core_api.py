"""The port's core API beside the JAX package's: ``repro_torch.core``
re-exports every name ``repro.core`` does; the random-substitution baseline
(``make_random_table``) by its properties, since torch's draws cannot
reproduce ``jax.random.permutation``; ``tae_from_probs`` and
``calibrate_tau`` against the reference's on the same seeded inputs (TAE
within 1e-6: the same f32 formulas; tau equal: the same numpy percentile);
and ``save_config`` / ``load_config``, each reading the other package's
file."""
import dataclasses
import inspect

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.core as jcore  # noqa: E402
import repro_torch.core as core  # noqa: E402
from repro.checkpoint import io as jio  # noqa: E402
from repro.configs.deepseek_v2_lite_buddy import profiling as jprofiling  # noqa: E402
from repro_torch.checkpoint import io  # noqa: E402
from repro_torch.configs.deepseek_v2_lite_buddy import profiling  # noqa: E402

TAE_TOL = 1e-6


def _public(mod) -> set:
    return {n for n, v in vars(mod).items()
            if not n.startswith("_") and not inspect.ismodule(v)}


def test_core_exports_every_reference_name():
    want = _public(jcore)
    assert want, "the reference exports nothing"
    assert want <= _public(core), sorted(want - _public(core))
    assert set(core.__all__) == want
    for name in want:
        mod = getattr(getattr(core, name), "__module__", None)
        assert mod is None or mod.startswith("repro_torch."), (name, mod)


# ---------------------------------------------------------- random baseline
@pytest.mark.parametrize("e,r", [(64, 16), (8, 16), (8, 7), (2, 1), (1, 4)])
def test_make_random_table_properties(e, r):
    table, q = core.make_random_table(
        e, r, generator=torch.Generator().manual_seed(7))
    r_n = min(r, e - 1)
    assert table.dtype == torch.int32 and q.dtype == torch.float32
    assert tuple(table.shape) == tuple(q.shape) == (e, r_n)
    t = table.numpy()
    for i in range(e):
        row = t[i]
        assert i not in row, (i, row)                      # no self
        assert len(set(row.tolist())) == r_n               # no repeats
        assert ((row >= 0) & (row < e)).all()
    np.testing.assert_array_equal(q.numpy(), np.float32(1 / max(e - 1, 1)))
    # the reference's table: the same shape and q
    jt, jq = jcore.make_random_table(jax.random.PRNGKey(7), e, r)
    assert np.asarray(jt).shape == (e, r_n)
    np.testing.assert_array_equal(np.asarray(jq), q.numpy())


def test_make_random_table_follows_the_generator():
    g = torch.Generator().manual_seed(3)
    a, _ = core.make_random_table(64, 16, generator=g)
    b, _ = core.make_random_table(64, 16, generator=g)  # the state moved on
    c, _ = core.make_random_table(
        64, 16, generator=torch.Generator().manual_seed(3))
    assert torch.equal(a, c)
    assert not torch.equal(a, b)


def test_make_random_table_rows_are_uniform():
    """A uniform permutation of the others: over 64 rows x 200 draws at
    E = 8, each other expert opens a row 1/7 of the time (within 5 sigma)."""
    g = torch.Generator().manual_seed(0)
    first = np.concatenate([core.make_random_table(8, 3, generator=g)[0][:, 0]
                            .numpy() for _ in range(200)])
    rows = np.tile(np.arange(8), 200)
    n = 200                                       # draws per expert's row
    for i in range(8):
        counts = np.bincount(first[rows == i], minlength=8)
        assert counts[i] == 0
        sigma = np.sqrt(n * (1 / 7) * (6 / 7))
        assert np.abs(np.delete(counts, i) - n / 7).max() < 5 * sigma, counts


# ------------------------------------------------------------- calibration
@pytest.mark.parametrize("shape", [(37, 6), (2, 5, 4), (9, 2), (4, 1)])
@pytest.mark.parametrize("form", ["tensor", "numpy"])
def test_tae_from_probs_matches_reference(shape, form):
    rng = np.random.default_rng(sum(shape))
    p = rng.random(shape).astype(np.float32)
    p[..., 0][rng.random(shape[:-1]) < 0.2] = 0.0      # an empty slot
    if shape[-1] > 1:
        p[0] = 0.0                                      # an all-zero row
        p[-1] = p[-1] / p[-1].sum(-1, keepdims=True)    # already normalized
    got = core.tae_from_probs(torch.from_numpy(p) if form == "tensor" else p)
    want = np.asarray(jcore.tae_from_probs(jnp.asarray(p)))
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    assert tuple(got.shape) == want.shape == shape[:-1]
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TAE_TOL)


def test_tae_from_probs_is_tae_from_logits_of_log_probs():
    """Eq. 1 both ways on the router's renormalized top-k probabilities."""
    rng = np.random.default_rng(1)
    z = torch.from_numpy(rng.normal(size=(64, 6)).astype(np.float32))
    p = torch.softmax(z, -1)
    torch.testing.assert_close(core.tae_from_probs(p),
                               core.tae_from_logits(z), rtol=0,
                               atol=TAE_TOL)


@pytest.mark.parametrize("percentile", [10.0, 15.0, 20.0, 50.0])
@pytest.mark.parametrize("form", ["tensor", "numpy", "list"])
def test_calibrate_tau_matches_reference(percentile, form):
    rng = np.random.default_rng(int(percentile))
    s = rng.random(1001).astype(np.float32)
    arg = {"tensor": torch.from_numpy(s), "numpy": s,
           "list": s.tolist()}[form]
    got = core.calibrate_tau(arg, percentile)
    assert isinstance(got, float)
    assert got == jcore.calibrate_tau(s, percentile)


def test_calibrate_tau_default_is_p15():
    s = np.linspace(0, 1, 101)
    assert core.calibrate_tau(s) == jcore.calibrate_tau(s) \
        == pytest.approx(0.15)


# -------------------------------------------------------------- config I/O
def _cfg_dict(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d["note"] = object.__new__(type("Opaque", (), {}))  # json: str()'d
    return d


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_config_files_read_across_packages(tmp_path, writer):
    cfg = profiling() if writer == "port" else jprofiling()
    d = _cfg_dict(cfg)
    path = str(tmp_path / "sub" / "cfg.json")          # makes the directory
    (io.save_config if writer == "port" else jio.save_config)(path, d)
    read_by_port, read_by_ref = io.load_config(path), jio.load_config(path)
    assert read_by_port == read_by_ref
    assert read_by_port["num_layers"] == cfg.num_layers
    assert read_by_port["moe"]["num_experts"] == cfg.moe.num_experts
    assert isinstance(read_by_port["note"], str)


def test_config_files_are_byte_equal(tmp_path):
    d = dataclasses.asdict(profiling())
    io.save_config(str(tmp_path / "a.json"), d)
    jio.save_config(str(tmp_path / "b.json"), d)
    assert (tmp_path / "a.json").read_bytes() == \
        (tmp_path / "b.json").read_bytes()
    assert dataclasses.asdict(profiling()) == dataclasses.asdict(jprofiling())
