"""The port's frontend and HA plane against the JAX package's, on the CPU.

The JAX package's own cases run against both packages
(`torch_tier_cases`): `tests/test_frontend.py` (registration, proxying,
SSE passthrough, failover, eviction, metrics; the port's frontend in front
of a port worker on the CPU) and the frontend cases of `tests/test_ha.py`
(the readiness gate, the resume refusal matrix over a journal replicated
on NATS, resume claims, worker and tenant gossip, cursor validation and
the continuation built from it; its loadgen cases test the benchmark's
client, not the frontend)."""

import pytest

from torch_tier_cases import FixtureCache, cases, run


@pytest.fixture(scope="module")
def tier_fixtures():
    with FixtureCache() as cache:
        yield cache


@pytest.mark.parametrize("pkg,case", cases("test_frontend"))
def test_frontend_cases(pkg, case, request, tier_fixtures):
    run(request, tier_fixtures, "test_frontend", pkg, case)


@pytest.mark.parametrize("pkg,case", cases(
    "test_ha", only=lambda name: not name.startswith("test_loadgen")))
def test_ha_cases(pkg, case, request, tier_fixtures):
    run(request, tier_fixtures, "test_ha", pkg, case)
