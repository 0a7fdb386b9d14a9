"""chip_smoke.py's check of the served windowed streams, on the CPU.

A served run is held against its pool kind's reference run (HELD,
REFERENCE): on every state both runs saw (up to and including a stream's
first difference) the two runs' logprobs of either's top tokens must
stay within BOUND_FACTOR times the same quantity between the same two
paths through the plain attention over teacher-forced decode states
(path_bounds over path_states); a run served without logprobs (n-gram
speculation) must give the reference's tokens or first differ at a
near-tie. The streams here are synthetic: {rid: [(token, logprob, top
[(token, logprob)])]}, two top tokens a state. path_states, path_bounds
and the controls' planted faults run on a tiny model on the CPU.
"""

import math

import pytest
import torch

import chip_smoke as cs
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import Engine
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.ops import attention as att

BOUND = 0.2  # a plain paths' logprob difference, as path_bounds gives one


def _stream(tops):
    """A greedy stream from its states' top-2: [(a, lp_a), (b, lp_b)] each;
    the token is the first."""
    return [(t[0][0], t[0][1], list(t)) for t in tops]


def _ref(n=8, gap=0.5, at=None, small_gap=None):
    """A reference stream of n states, tokens 10, 11, ...; each state's
    runner-up is token 100 + i, `gap` below; at state `at` the gap is
    `small_gap`."""
    tops = []
    for i in range(n):
        g = small_gap if i == at else gap
        tops.append([(10 + i, -0.5), (100 + i, -0.5 - g)])
    return tops


def _moved(tops, shift, at=None):
    """The same states with every logprob moved by `shift` (the first one
    up, the second down), and from state `at` on the top-2 swapped: the
    stream takes the runner-up there and later states are its own."""
    out = []
    for i, ((a, la), (b, lb)) in enumerate(tops):
        if at is not None and i == at:
            out.append([(b, lb + shift), (a, la - shift)])
        elif at is not None and i > at:
            out.append([(500 + i, -0.1), (600 + i, -3.0)])
        else:
            out.append([(a, la + shift), (b, lb - shift)])
    return out


def _shifted(tops, shift):
    """The same states with both logprobs moved by `shift`: the same
    tokens and gaps."""
    return [[(a, la + shift), (b, lb + shift)] for (a, la), (b, lb) in tops]


def _runs(got_tops, ref_tops, rids=("g0", "g1")):
    return ({r: _stream(got_tops) for r in rids},
            {r: _stream(ref_tops) for r in rids})


@pytest.mark.parametrize("bound", [None, BOUND], ids=["no_bound", "bound"])
def test_equal_streams_pass(bound):
    got, ref = _runs(_ref(), _ref())
    row = cs.stream_agreement(got, ref, bound)
    assert row["ok"] and row["equal"] and row["first_difference"] is None
    if bound is not None:
        assert row["max_shared_diff"] == 0.0
        assert row["shared_states"] == 16 and row["lower_bounded"] == 0


@pytest.mark.parametrize("bound", [None, BOUND], ids=["no_bound", "bound"])
def test_a_first_difference_at_a_near_tie_passes(bound):
    """The reference's top-2 gap is 0.03 at state 5 (under NEAR_TIE) and
    the run takes the runner-up there, its logprobs 0.02 from the
    reference's."""
    ref_tops = _ref(at=5, small_gap=0.03)
    got, ref = _runs(_moved(ref_tops, 0.02, at=5), ref_tops)
    row = cs.stream_agreement(got, ref, bound)
    assert row["ok"] and not row["equal"] and row["near_tie"]
    assert row["first_difference"] == {"rid": "g0", "index": 5,
                                       "lengths": [8, 8]}
    assert math.isclose(row["ref_top2_gap"], 0.03)
    if bound is not None:
        # states 0..5 of each stream: the first difference's own included
        assert row["shared_states"] == 12
        assert math.isclose(row["max_shared_diff"], 0.02, abs_tol=1e-12)


def test_a_first_difference_within_the_plain_bound_passes():
    """A gap of 0.3 (no near-tie) at state 4; the two runs' logprobs are
    0.35 apart on the shared states, within BOUND_FACTOR * BOUND."""
    ref_tops = _ref(at=4, small_gap=0.3)
    got, ref = _runs(_moved(ref_tops, 0.35, at=4), ref_tops)
    row = cs.stream_agreement(got, ref, BOUND)
    assert not row["equal"] and not row["near_tie"]
    assert row["ok"] and row["limit"] == cs.BOUND_FACTOR * BOUND
    assert math.isclose(row["max_shared_diff"], 0.35, abs_tol=1e-12)
    # without logprobs (a near-tie is all it may show) it would fail
    assert not cs.stream_agreement(got, ref)["ok"]


@pytest.mark.parametrize("small_gap", [0.01, 0.3], ids=["near_tie", "gap"])
def test_past_the_bound_fails_even_at_a_small_gap(small_gap):
    """Logprobs 0.45 apart on the shared states, past BOUND_FACTOR *
    BOUND = 0.4: the run fails wherever its streams first differ, at a
    near-tie too, and when they never differ."""
    ref_tops = _ref(at=3, small_gap=small_gap)
    got, ref = _runs(_moved(ref_tops, 0.45, at=3), ref_tops)
    row = cs.stream_agreement(got, ref, BOUND)
    assert not row["ok"] and row["max_shared_diff"] > row["limit"]
    assert row["near_tie"] == (small_gap < cs.NEAR_TIE)
    got, ref = _runs(_moved(_ref(), 0.45), _ref())
    row = cs.stream_agreement(got, ref, BOUND)
    assert row["equal"] and not row["ok"]


def test_a_token_missing_from_the_runs_top2_counts_from_its_cap():
    """Where one run's top tokens leave out one the other lists, its own
    least listed logprob caps its logprob there: the difference counts
    from that cap, a lower bound, both ways."""
    ref_tops = _ref(n=4)

    def row(second):
        got_tops = [[(a, la), (999, second(lb))]
                    for (a, la), (_, lb) in ref_tops]
        got, ref = _runs(got_tops, ref_tops, rids=("g0",))
        return cs.stream_agreement(got, ref, BOUND)

    # the run's 999 above the reference's least listed, by 0.5
    above = row(lambda lb: lb + 0.5)
    assert above["lower_bounded"] == 8 and not above["ok"]
    assert math.isclose(above["max_shared_diff"], 0.5)
    # the reference's runner-up above the run's least listed, by 0.5
    below = row(lambda lb: lb - 0.5)
    assert math.isclose(below["max_shared_diff"], 0.5) and not below["ok"]
    # both within 0.1 of the other's cap: within the bound
    near = row(lambda lb: lb - 0.1)
    assert math.isclose(near["max_shared_diff"], 0.1) and near["ok"]


def test_streams_of_other_lengths_fail():
    got, ref = _runs(_ref(n=6), _ref(n=8))
    for bound in (None, BOUND):
        row = cs.stream_agreement(got, ref, bound)
        assert not row["ok"]
        assert row["first_difference"]["lengths"] == [6, 8]


def test_a_run_held_to_a_bound_must_carry_logprobs():
    ref = {"g0": _stream(_ref())}
    got = {"g0": [(t, None, None) for t, _, _ in ref["g0"]]}
    with pytest.raises(ValueError, match="logprobs"):
        cs.stream_agreement(got, ref, BOUND)


def test_every_held_run_has_a_reference_of_its_pool_and_logprobs():
    """Each held run's reference is its pool kind's and serves with 2
    logprobs, as does every run held to a bound (the runs of RUN_PATH);
    the served runs name their references before them."""
    assert set(cs.REFERENCE) == {"bf16", "int8"}
    for run in cs.HELD:
        ref = cs.reference_of(run)
        assert cs.pool_of(ref) == cs.pool_of(run), run
        assert cs.served_logprobs(ref) == cs.TOP_LOGPROBS
        held = run in cs.RUN_PATH
        assert cs.served_logprobs(run) == (cs.TOP_LOGPROBS if held
                                           else None)
        assert (cs.bound_pair(run) is not None) == held
    assert cs.bound_pair("mixed_int8") == "chunks_vs_mixed"
    assert cs.bound_pair("jetstream_int8") == "chunks_vs_whole"
    assert cs.bound_pair("mixed") == "whole_vs_mixed"
    assert cs.served_logprobs("jetstream") is None
    assert set(cs.UNSEEN_FAULTS) < set(cs.PLANTED_FAULTS)
    for runs in (cs.GEMMA_RUNS, cs.PHI3_RUNS, cs.LONGROPE_RUNS):
        for i, run in enumerate(runs):
            if run in cs.HELD:
                assert cs.reference_of(run) in runs[:i], (runs, run)


def _bounds(bf16, int8):
    return {"bf16": {"top": {p: bf16 for p in (
                "whole_vs_chunks", "whole_vs_mixed")}},
            "int8": {"top": {p: int8 for p in (
                "chunks_vs_whole", "chunks_vs_mixed")}}}


def test_a_run_held_against_the_wrong_pools_reference_is_caught():
    """mixed_int8 is held against its pool kind's chunked_int8 run, within
    the int8 paths' bound; held against the bf16 classic run instead, its
    streams (int8 K/V move the logprobs by 0.6) are past the bf16 paths'
    bound, though their first difference is at a near-tie."""
    bounds = _bounds(BOUND, 0.4)
    ref_tops = _ref(at=6, small_gap=0.02)
    int8_tops = _shifted(ref_tops, -0.6)
    outs = {"classic": _runs(ref_tops, ref_tops)[1],
            "chunked_int8": _runs(int8_tops, int8_tops)[1],
            "mixed_int8": _runs(_moved(int8_tops, 0.05, at=6),
                                int8_tops)[0]}
    row = cs.held_agreement("mixed_int8", outs, bounds)
    assert row["ok"] and row["reference"] == "chunked_int8"
    assert row["paths"] == "chunks_vs_mixed" and row["limit"] == 0.8
    assert row["near_tie"] and row["max_shared_diff"] < 0.1
    row = cs.stream_agreement(outs["mixed_int8"], outs["classic"],
                              bounds["bf16"]["top"]["whole_vs_mixed"])
    assert row["near_tie"] and not row["ok"]


@pytest.fixture(scope="module")
def tiny_engine():
    """A tiny-debug engine on the CPU at chip_smoke's page size and
    slots."""
    return Engine(EngineConfig(model="tiny-debug", page_size=cs.PS,
                               num_pages=128, max_num_seqs=cs.MAX_SEQS,
                               max_seq_len=512, enable_prefix_caching=False,
                               seed=0), device="cpu")


def test_path_states_paths_agree_on_the_cpu(tiny_engine):
    """path_states in f32 on the CPU: each path's [steps, slots, V]
    logits; whole, chunked and mixed agree to rounding (the prompts' K/V,
    the teacher-forced tokens and the pages line up), the slots' rows are
    their own prompts', and the pages go back to the pool."""
    free = tiny_engine.allocator.free_pages
    with torch.inference_mode():
        out = cs.path_states(tiny_engine, 200, 2, 3)
    assert tiny_engine.allocator.free_pages == free
    assert set(out) == {"whole", "chunks", "mixed"}
    for path, logits in out.items():
        assert logits.shape == (3, 2, tiny_engine.model_cfg.vocab_size)
        assert torch.isfinite(logits).all(), path
        torch.testing.assert_close(logits, out["whole"], rtol=1e-4,
                                   atol=1e-4)
    assert (out["whole"][:, 0] - out["whole"][:, 1]).abs().max() > 1e-2


def test_path_bounds_on_a_tiny_model(tiny_engine):
    """path_bounds on the CPU: every held run's pair, finite and
    non-negative; the top-2 bound never exceeds the vocabulary's."""
    bounds = cs.path_bounds(tiny_engine, 200, 2)
    pairs = {cs.bound_pair(r) for r in cs.HELD} - {None}
    assert set(bounds["top"]) == set(bounds["vocabulary"]) == pairs
    assert bounds["states"] == 2 * cs.BOUND_STEPS
    for pair, b in bounds["top"].items():
        assert math.isfinite(b) and 0.0 <= b <= bounds["vocabulary"][pair]
        assert bounds["top_spread"][pair]["max"] == b


@pytest.mark.parametrize("kind", sorted(cs.PLANTED_FAULTS))
def test_a_planted_fault_moves_only_the_mixed_step(tiny_engine, kind):
    """Each of the controls' faults (planted_fault) moves the mixed step's
    logits (its decode row's, or for the shifted chunk its chunk's) and
    no other forward's; llama.mixed_step is the engine's again after
    it."""
    orig = llama.mixed_step
    with torch.inference_mode():
        clean = cs.three_paths(tiny_engine, att.DISPATCH)
        with cs.planted_fault(kind):
            assert llama.mixed_step is not orig
            faulty = cs.three_paths(tiny_engine, att.DISPATCH)
    assert llama.mixed_step is orig
    moved = "mixed_chunk" if kind == "chunk_shifted" else "mixed_decode"
    assert (faulty[moved] - clean[moved]).abs().max() > 1e-3
    for path in ("prefill", "decode", "chunked_prefill", "verify"):
        assert torch.equal(faulty[path], clean[path]), path


def test_profile_drops_reads_a_trace_on_the_cpu():
    """mla_prefill_profile's account of a short trace (profile_drops)
    reads both prof.events() and the kineto result of a CPU trace: no
    device event and no launch there, and no kernel starts to list."""
    from torch.profiler import ProfilerActivity, profile

    prof = profile(activities=[ProfilerActivity.CPU])
    with prof:
        x = torch.ones(16, 16)
        for _ in range(3):
            x = x @ x
    out = cs.profile_drops(prof, "mm")
    assert out == {"device_events": 0, "launch_calls": 0,
                   "kineto_device_events": 0, "kineto_launch_calls": 0,
                   "kineto_unanswered_launches": 0,
                   "kineto_unanswered_at": []}


class _Trace:
    """A stand-in for a finished torch.profiler session: its events."""

    def __init__(self, names):
        cuda = torch.autograd.DeviceType.CUDA
        self._events = [type("Ev", (), {"device_type": cuda, "name": n})()
                        for n in names]

    def events(self):
        return self._events


def test_a_traced_session_leaves_its_opening_kernels_out(monkeypatch):
    """`traced` opens a session with PROFILE_LEAD sleep kernels, which
    kineto's out-of-window drops may take: device_events leaves them out
    of the account and lead_lost counts the ones the trace lost."""
    names = (["spin_kernel(long)"] * (cs.PROFILE_LEAD - 3)
             + ["prefill_latent_kernel", "gemm"])
    trace = _Trace(names)
    assert [ev.name for ev in cs.device_events(trace)] == [
        "prefill_latent_kernel", "gemm"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert cs.lead_lost(trace) == 3


def test_a_traced_session_on_the_cpu_runs_no_lead():
    """On the CPU `traced` runs the caller's work in the session without
    the opening kernels (no device records to lose)."""
    from torch.profiler import ProfilerActivity, profile

    with cs.traced(profile(activities=[ProfilerActivity.CPU])) as prof:
        torch.ones(4, 4) @ torch.ones(4, 4)
    assert any("mm" in ev.name for ev in prof.events())
    assert cs.lead_lost(prof) == 0 and cs.device_events(prof) == []
