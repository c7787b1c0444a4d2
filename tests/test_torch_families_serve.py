"""The port's engines on the MoE family against the JAX package's engines,
on the same weights (made by `repro.models.model.init_params`, carried
across by `params_from_jax`; the JAX kernels run in interpret mode) and the
same traffic: reduced granite-moe-1b-a400m (4 experts, top 2, capacity
1.25) on the packed and lockstep PagedEngine, the ContinuousEngine and the
wave ServeEngine, the fused kernels on and off. The SSM and hybrid families
are in test_torch_families_ssm.py, the bf16 witnesses in
test_torch_families_bf16.py; the shared substrate in torch_families.py.

One behaviour of the JAX engines is reproduced, not corrected (ROADMAP.md
section C3), and pinned here with its tokens: the packed PagedEngine routes
all of a step's tokens, pad lanes included, through one MoE dispatch group,
so capacity drops make a request's tokens depend on the batch: request 2 of
DROP_TRAFFIC gets other tokens there than on the wave engine.

Every engine gate is token identity (no greedy token moved on these f32
configs).
"""
import torch_threads  # noqa: F401  (first: one torch thread a worker)
import pytest

import torch_families as F


@pytest.mark.parametrize("kernel", ["fused", "none"])
@pytest.mark.parametrize("engine", list(F.ENGINES))
def test_moe_engine_matches_jax_engine(engine, kernel):
    """DROP_TRAFFIC and a mixed batch of six requests (several waves,
    a one-token budget, prompts past one paged block)."""
    models = F.models("granite-moe-1b-a400m", decode_kernel=kernel)
    for reqs in (F.requests(models[0], F.DROP_TRAFFIC),
                 F.requests(models[0], (5, 21, 9, 21, 5, 14), seed=1)):
        got, want = F.both(engine, models, reqs)
        assert got == want
        assert all(len(t) == m for (u, _, m), t in
                   zip(reqs, (got[u] for u, _, _ in reqs)))


def test_moe_packed_step_routes_pad_lanes_with_the_batch():
    """The JAX packed engine's tokens depend on the batch under capacity
    drops (its pad lanes share the step's dispatch group): requests 0 and 1
    agree with the wave engine, request 2 does not. The port serves the
    same tokens as each JAX engine."""
    models = F.models("granite-moe-1b-a400m", decode_kernel="fused")
    reqs = F.requests(models[0], F.DROP_TRAFFIC)
    packed, jpacked = F.both("packed", models, reqs)
    wave, jwave = F.both("wave", models, reqs)
    assert packed == jpacked and wave == jwave
    assert packed[0] == wave[0] and packed[1] == wave[1]
    assert wave[2][:3] == [499, 397, 453]
    assert packed[2][:3] == [164, 77, 77]
