"""The JAX package's own disaggregation cases, run against both packages
(`torch_tier_cases`, the port's engines on the CPU):

- `tests/test_disagg.py`: the in-process and TCP handoffs against the
  aggregated engine, unknown keys, the parked-KV TTL and re-prefill books,
  a first token that already stops, the two-worker topology behind the
  frontend, seeded sampling and guided JSON across the handoff, the ici
  backend with the host paths forbidden, failover from an unreachable
  prefill worker, and the stage ledger after a failed device pull;
- `tests/test_transport.py`: the native library's build, the rendezvous
  handshake and framing across the native and Python ends, timeouts and
  an 8 MB message;
- the cross-worker pulls of `tests/test_kvbm.py` (a cold worker onboards a
  warm worker's host-tier blocks; a miss is harmless);
- the disagg case of `tests/test_tracing_propagation.py` (one trace over
  the frontend, the decode worker and the prefill worker);
- the disagg case of `tests/test_async_scheduling.py` (an import between
  two steps of an async decode worker, a window in flight: both streams
  equal their synchronous runs).

The device plane's cross-process case (`tests/test_disagg_device_plane.py`)
pulls through `jax.experimental.transfer`; the port's CUDA IPC pull needs
the card (`tests/test_torch_cuda.py`)."""

import pytest
import torch

from torch_tier_cases import FixtureCache, cases, run


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    # the suite runs in parallel workers: eight eager torch threads in each
    # would crowd the JAX engines' compiles out
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tier_fixtures():
    with FixtureCache() as cache:
        yield cache


@pytest.mark.parametrize("pkg,case", cases("test_disagg"))
def test_disagg_cases(pkg, case, request, tier_fixtures):
    run(request, tier_fixtures, "test_disagg", pkg, case)


@pytest.mark.parametrize("pkg,case", cases("test_transport"))
def test_transport_cases(pkg, case, request, tier_fixtures):
    run(request, tier_fixtures, "test_transport", pkg, case)


@pytest.mark.parametrize("pkg,case", cases(
    "test_kvbm", only=lambda name: name.startswith("test_cross_worker")))
def test_kvbm_peer_cases(pkg, case, request, tier_fixtures):
    run(request, tier_fixtures, "test_kvbm", pkg, case)


@pytest.mark.parametrize("pkg,case", cases(
    "test_tracing_propagation",
    only=lambda name: name == "test_disagg_trace_spans_three_components"))
def test_disagg_trace_case(pkg, case, request, tier_fixtures):
    run(request, tier_fixtures, "test_tracing_propagation", pkg, case)


@pytest.mark.parametrize("pkg,case", cases(
    "test_async_scheduling",
    only=lambda name: name == "test_async_disagg_import_mid_pipeline"))
def test_async_import_case(pkg, case, request, tier_fixtures):
    run(request, tier_fixtures, "test_async_scheduling", pkg, case)
