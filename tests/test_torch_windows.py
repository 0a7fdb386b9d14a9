"""Multi-step decode windows and async scheduling: the port's Engine against
the JAX package's, and its on-device sampling noise.

Same weights (the JAX tree of tiny-debug from PRNGKey(0)), float32 on the
CPU, where the port runs its window body eagerly (the card replays it as a
CUDA graph: tests/test_torch_cuda.py). With num_scheduler_steps=4, sync and
async, the greedy streams and finish reasons must be the JAX engine's token
for token through a stop token mid-window, an abort while a window is in
flight, a chunked admission mid-decode and page pressure with preemption;
the same script of adds and aborts at the same step() calls drives both, so
the schedule itself must match. Sampled streams match only the port's own
k=1 run (the noise differs from JAX's by design: ROADMAP queue 3).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from dynamo_tpu.engine.config import EngineConfig as JEngineConfig
from dynamo_tpu.engine.engine import Engine as JEngine
from dynamo_tpu.engine.request import GenRequest as JGenRequest
from dynamo_tpu.models import llama as jllama
from dynamo_tpu.models.config import PRESETS as JPRESETS
from dynamo_tpu_torch.engine import sampling as smp
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.decode_graphs import CapturedStep
from dynamo_tpu_torch.engine.engine import Engine
from dynamo_tpu_torch.engine.request import GenRequest
from dynamo_tpu_torch.ops import cuda_attention

BASE = dict(model="tiny-debug", page_size=16, num_pages=64, max_num_seqs=4,
            max_seq_len=512, prefill_chunk_tokens=32,
            enable_prefix_caching=False, num_scheduler_steps=4)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One torch thread for this module: the parallel test workers share
    the cores, and torch's default pool in each of them oversubscribes
    them (the suite's tiny eager ops are as fast on one thread)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def jparams():
    cfg = dataclasses.replace(JPRESETS["tiny-debug"], dtype="float32")
    return jllama.init_params(cfg, jax.random.PRNGKey(0))


def _np(params):
    return {k: np.asarray(v) for k, v in params.items()}


def _prompt(seed, n):
    return np.random.default_rng(seed).integers(0, 256, size=n).tolist()


def drive(engine, make_req, script, steps=400):
    """Run `script` {step index: [("add", rid, prompt, kwargs) |
    ("abort", rid)]} against `engine`, calling step() until it is idle;
    returns ({rid: tokens}, {rid: finish reason})."""
    streams, reasons = {}, {}
    for i in range(steps):
        for action in script.get(i, []):
            if action[0] == "add":
                _, rid, prompt, kw = action
                engine.add_request(make_req(rid, prompt, **kw))
            else:
                engine.abort_request(action[1])
        if not engine.has_work and i > max(script):
            break
        for ev in engine.step():
            if ev.token_id >= 0:
                streams.setdefault(ev.request_id, []).append(ev.token_id)
            if ev.finished:
                reasons[ev.request_id] = ev.finish_reason
    return streams, reasons


def _greedy(max_tokens, **kw):
    return dict(max_tokens=max_tokens, temperature=0.0, ignore_eos=True, **kw)


def _stop_token(stream, at):
    """A token of `stream` at index >= `at` that appears nowhere before."""
    for i in range(at, len(stream)):
        if stream[i] not in stream[:i]:
            return stream[i]
    raise AssertionError("no fresh token to stop on")


@pytest.mark.parametrize("async_scheduling", [False, True],
                         ids=["sync", "async"])
def test_window_streams_match_jax(jparams, async_scheduling):
    """Three prompts decode in 4-step windows; r1 stops on a token in the
    middle of a window, a 70-token prompt arrives at step 3 and prefills
    in 32-token chunks between windows, r2 is aborted at step 6."""
    cfg = dict(BASE, async_scheduling=async_scheduling)
    plain = {0: [("add", "r1", _prompt(1, 9), _greedy(24))]}
    probe, _ = drive(JEngine(JEngineConfig(**cfg), params=jparams),
                     JGenRequest, plain)
    stop = _stop_token(probe["r1"], 6)
    script = {
        0: [("add", "r0", _prompt(0, 5), _greedy(20)),
            ("add", "r1", _prompt(1, 9), _greedy(24, stop_token_ids=[stop])),
            ("add", "r2", _prompt(2, 12), _greedy(40))],
        3: [("add", "r3", _prompt(3, 70), _greedy(10))],
        6: [("abort", "r2")],
    }
    ref = drive(JEngine(JEngineConfig(**cfg), params=jparams), JGenRequest,
                script)
    eng = Engine(EngineConfig(**cfg), params=_np(jparams), device="cpu")
    got = drive(eng, GenRequest, script)
    assert got == ref
    streams, reasons = got
    assert reasons == {"r0": "length", "r1": "stop", "r2": "abort",
                       "r3": "length"}
    assert streams["r1"][-1] == stop and len(streams["r1"]) < 24
    assert 1 < len(streams["r2"]) < 40
    assert eng.metrics.decode_steps < sum(map(len, streams.values()))
    assert eng.allocator.free_pages == cfg["num_pages"] - 1
    assert eng._pending_win is None


@pytest.mark.parametrize("async_scheduling", [False, True],
                         ids=["sync", "async"])
def test_window_streams_match_jax_under_page_pressure(jparams,
                                                       async_scheduling):
    """A pool too small for every sequence: windows fall back to one step,
    admission defers and decode preempts by recompute, in both engines."""
    cfg = dict(BASE, num_pages=10, max_seq_len=128,
               async_scheduling=async_scheduling)
    script = {0: [("add", f"r{i}", _prompt(10 + i, n), _greedy(40))
                  for i, n in enumerate([20, 24, 18, 30])]}
    ref = drive(JEngine(JEngineConfig(**cfg), params=jparams), JGenRequest,
                script)
    eng = Engine(EngineConfig(**cfg), params=_np(jparams), device="cpu")
    got = drive(eng, GenRequest, script)
    assert got == ref
    assert all(len(s) == 40 for s in got[0].values())
    assert eng.metrics.num_preempted > 0 and eng.metrics.kv_oom == 0


def _sampled_script():
    return {0: [("add", "s0", _prompt(20, 7),
                 dict(max_tokens=18, temperature=0.8, top_p=0.9, seed=11,
                      ignore_eos=True)),
                ("add", "g0", _prompt(21, 10), _greedy(14)),
                ("add", "s1", _prompt(22, 40),
                 dict(max_tokens=12, temperature=1.1, top_k=20, seed=5,
                      ignore_eos=True))],
            4: [("add", "s2", _prompt(23, 5),
                 dict(max_tokens=9, temperature=0.7, min_p=0.05, seed=3,
                      ignore_eos=True, logprobs=2))]}


def test_sampled_streams_equal_for_every_window_length():
    """Seeded sampled requests beside a greedy one: the noise is keyed by
    chain root and position, so 1-step, 4-step sync and 4-step async
    stepping give the same tokens, and so does a run where the requests
    arrive in another order (other slots, other batch-mates)."""
    runs = []
    for k, async_ in ((1, False), (4, False), (4, True)):
        eng = Engine(EngineConfig(**dict(BASE, num_scheduler_steps=k,
                                         async_scheduling=async_)),
                     device="cpu")
        runs.append(drive(eng, GenRequest, _sampled_script()))
    assert runs[0] == runs[1] == runs[2]
    script = _sampled_script()
    script[0].reverse()
    eng = Engine(EngineConfig(**BASE), device="cpu")
    assert drive(eng, GenRequest, script)[0] == runs[0][0]
    greedy = drive(Engine(EngineConfig(**BASE), device="cpu"), GenRequest,
                   {0: [("add", "s0", _prompt(20, 7), _greedy(18))]})[0]
    assert runs[0][0]["s0"] != greedy["s0"]  # the noise does something


# the bits the card must draw too (tests/test_torch_cuda.py)
PINNED_ROW_KEY = 0x72991238AD2EB1B1  # fold_in(1234, 17)
PINNED_BITS = [3506449212, 1812485701, 505603136, 2319869864, 3651098138,
               3592466632, 1436975056, 3455550514]


def test_noise_bits_are_pinned_and_batch_independent():
    """fold_in on ints and on int64 tensors agree; a row's bits depend on
    its row key only (alone or in a batch, run after run) and equal the
    pinned values; the Gumbel noise is finite."""
    assert smp.fold_in(1234, 17) == PINNED_ROW_KEY
    keys = torch.tensor([7, 1234, (1 << 63) - 1], dtype=torch.int64)
    pos = torch.tensor([3, 17, 4095], dtype=torch.int32)
    rows = smp.fold_positions(keys, pos)
    assert rows.tolist() == smp.fold_positions([7, 1234, (1 << 63) - 1],
                                                [3, 17, 4095])
    assert all(0 <= r < (1 << 63) for r in rows.tolist())
    alone = smp.uniform_bits(torch.tensor([PINNED_ROW_KEY]), 300)
    batch = smp.uniform_bits(rows, 300)
    assert torch.equal(batch[1], alone[0])
    assert torch.equal(smp.uniform_bits(rows, 300), batch)
    assert alone[0, :8].tolist() == PINNED_BITS
    assert int(alone.min()) >= 0 and int(alone.max()) < (1 << 32)
    # roughly uniform: each of 16 buckets holds 1/16 of 3 x 4096 draws
    many = smp.uniform_bits(rows, 4096).flatten() >> 28
    counts = torch.bincount(many, minlength=16).float() / many.numel()
    assert float((counts - 1 / 16).abs().max()) < 0.02
    assert bool(torch.isfinite(smp.gumbel(rows, 4096)).all())


def test_replay_counts_the_launches_recorded_at_capture():
    """A capture's wrapper calls leave LAUNCHES as they were and are kept
    with the graph; each replay of the graph adds them (a fake graph here:
    the card test replays real ones)."""
    before = dict(cuda_attention.LAUNCHES)
    with cuda_attention.counting_capture() as recorded:
        cuda_attention.LAUNCHES["decode"] += 3  # three wrapper calls
        cuda_attention.LAUNCHES["decode_int8"] += 1
    assert cuda_attention.LAUNCHES == before
    assert recorded == {"decode": 3, "decode_int8": 1}

    class FakeGraph:
        replays = 0

        def replay(self):
            self.replays += 1

    step = CapturedStep(FakeGraph(), recorded)
    for _ in range(4):
        step.replay()
    assert step.graph.replays == 4
    assert cuda_attention.LAUNCHES["decode"] == before["decode"] + 12
    assert cuda_attention.LAUNCHES["decode_int8"] == before["decode_int8"] + 4
    cuda_attention.LAUNCHES.update(before)


def test_windows_on_the_cpu_run_eagerly_and_count_steps():
    """On the CPU the window body runs eagerly: no graph is captured, and
    a 9-token greedy request takes its first token from prefill, then two
    4-step windows."""
    eng = Engine(EngineConfig(**dict(BASE, async_scheduling=False)),
                 device="cpu")
    out = eng.generate(GenRequest("w", _prompt(30, 6), max_tokens=9,
                                  ignore_eos=True))
    assert len(out) == 9
    stats = eng.windows.stats()
    assert stats["eager"] and stats["graphs"] == 0 and stats["windows"] == 2
    assert eng.metrics.decode_steps == 8
