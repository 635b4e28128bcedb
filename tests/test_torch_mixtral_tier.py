"""The port serving Mixtral with the int8 replica tier against the JAX
package (set-up in tests/test_torch_mixtral.py), on ``mixtral-8x7b`` and
``mixtral-8x22b`` reduced: a batch of 4 served past the 128-token window
as tests/test_torch_mixtral.py serves it (a 128-token prompt in chunks of
8, then 8 decode steps), with the tier at coverage 0.5 on the capacity
path (degraded slots through ``quant_ffn``'s plain version), on the fused
path (the grouped dispatch's degraded half), and in cost mode. Equal
tokens, ``stats``, ledger, stall breakdown and tier counters (floats on
the simulated clock to rel 1e-9; the tier's ``mean_fidelity_loss`` to rel
1e-5, f32 sums in another order)."""
import pytest

pytest.importorskip("torch")

import test_torch_mixtral as P  # noqa: E402
from test_torch_mixtral import one_torch_thread  # noqa: E402,F401

TIER = dict(bits=8, coverage=0.5)
CASES = {
    "capacity_int8": dict(quant_tier="int8"),
    "fused_int8": dict(quant_tier="int8", use_fused_dispatch=True),
    "cost_int8": dict(quant_tier="int8", miss_policy="cost",
                      stall_per_quality=0.05),
}


@pytest.fixture(scope="module", params=P.ARCHS)
def model(request):
    return P.build_model(request.param)


@pytest.mark.parametrize("name", list(CASES))
def test_batch_serving_with_tier_matches_reference(model, name):
    st = P.check_batch_serving(model, CASES[name], TIER, {})
    if name.startswith("cost"):
        assert st["n_miss_drop"] + st["n_miss_fetch"] > 0
