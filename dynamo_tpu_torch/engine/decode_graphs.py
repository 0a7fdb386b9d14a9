"""Decode windows on CUDA graphs: the GPU counterpart of the JAX engine's
jitted decode window (`make_decode_window`, `dynamo_tpu/engine/engine.py`).

The batch lives on the device in static buffers (`DeviceBatch`), allocated
once and updated in place with `copy_`, so a captured graph's pointers stay
valid: tokens, positions, context lengths and the active-slot step, the
block tables, the sampling parameters, bias lanes and chain roots, the
output-token counts, and the static [K, B] outputs. The engine rebuilds
them from its host mirrors only when membership, pages or sampling change.

One decode step's body (`DecodeWindows._body`): `llama.decode_step` over
every slot, sampling (on-device Gumbel noise keyed by chain root and
position, `engine/sampling.py`), the token_counts update, the carry update
(tokens <- sampled, positions and contexts + step, where step is 1 for an
active slot and 0 for an inactive one, which stays on the trash page at
position 0 and context 1), and the step's token (with logprobs: the chosen
token's logprob and the top 5) written into row `step_idx` of the
outputs. A JSON-guided step (any live sequence with `guided_json`) masks
the logits before sampling and advances each guided slot's grammar state
(`gmode`, `gdepth`, `gbits`, for the slots `gactive` marks) through its
sampled token after, with the CUDA kernel of `ops/cuda_guide.py` (JAX:
`json_guide.token_mask` and `fold_bytes` inside the window's scan); with
LoRA the forward reads each slot's adapter slot from `adapters`. A k-step
window is k replays of ONE captured step: one capture
serves every window length (the JAX package compiles a 1-step and a
k-step program), so a key costs one capture's time and one step's graph
memory, and a replay's host cost is microseconds against a step's
milliseconds of device time.

Graphs are keyed by (logprobs, guided, sampling gates): the gates decide
which sampling ops run, `guided` whether the grammar kernel does (the JAX
engine's four guided window variants are two here: one capture serves
every window length). They are captured lazily, in one memory pool shared by
all keys (every graph's temporaries are dead when it ends, and replays are
serialised on one stream), after one warm-up pass of the body on the
capture stream over an idle batch (every slot inactive: the pass writes
the trash page and adds nothing to token_counts), so that lazily built
state (the kernel library, cuBLAS workspaces, rope tables) exists before
capture begins; the live carry is saved before and restored after.

Launch counts: `cuda_attention.LAUNCHES` counts wrapper calls, which
happen only while a graph is captured. The capture's counts are taken out
of LAUNCHES and kept with the graph (`cuda_attention.counting_capture`),
and every replay adds them back (`cuda_attention.count_replay`).

The speculative verify step (`VerifySteps`, the counterpart of the JAX
engine's jitted `spec_fn`) is one more captured step over the same
buffers and memory pool, keyed by the sampling gates alone (logprobs
requests never speculate): `llama.decode_verify` over every slot's
current token and its K drafts (`DeviceBatch.drafts`, `room`), the
acceptance of `sampling.verify_accept`, the emitted tokens banked into
token_counts, and the carry advanced by n_acc + 1 on active slots; its
outputs are `out_emitted` [B, K1] and `out_nacc` [B].

On the CPU, and with `enforce_eager`, the same bodies run eagerly. On
CUDA a capture or replay that fails raises: nothing falls back to eager.

Graphs outlive the engine's lifecycle events because nothing they read
moves: a weight flip swaps contents into the live weights' storage
(`elasticity/weights.py`), and a resurrection zeroes the pools and these
buffers in place (`DeviceBatch.reset`). A capture runs inside
`DecodeWindows.capture_guard` (the engine's watchdog exemption: a lazy
capture inside a watched seam takes seconds without being a hang).
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from dynamo_tpu_torch.engine import sampling as smp
from dynamo_tpu_torch.ops import cuda_attention, cuda_guide

NUM_TOP = 5  # logprobs alternatives the outputs hold per step

# forward(tokens [B], positions [B], tables [B, Pmax], context_lens [B])
# -> logits [B, V]
Forward = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
                   torch.Tensor]
Gates = Tuple[bool, bool, bool, bool, bool]  # smp.gates()
# verify_forward(tokens [B, K1], positions [B], tables [B, Pmax], room [B])
# -> logits [B, K1, V]
VerifyForward = Callable[[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor], torch.Tensor]


def upload(dst: torch.Tensor, arr) -> None:
    """Copy host values into a static device buffer, in place. On the card
    through pinned memory without blocking the host: the copy is ordered on
    the stream after any window in flight."""
    src = torch.from_numpy(np.ascontiguousarray(arr)).to(dst.dtype)
    if dst.is_cuda:
        dst.copy_(src.pin_memory(), non_blocking=True)
    else:
        dst.copy_(src)


class DeviceBatch:
    """The decode batch's static device buffers; with spec_k > 0 also the
    verify step's drafts [B, K] and room [B] inputs and its emitted
    [B, K+1] and n_acc [B] outputs. gmode, gdepth, gbits [B] int32 and
    gactive [B] bool are the guided slots' grammar state (a slot that is
    not guided has gactive False); adapters [B] int32 each slot's LoRA
    slot (0 = base)."""

    def __init__(self, b: int, pmax: int, vocab: int, k_max: int, device,
                 spec_k: int = 0):
        def z(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=device)

        self.tokens = z(b, dtype=torch.int64)
        self.positions = z(b)
        self.context_lens = torch.ones((b,), dtype=torch.int32, device=device)
        self.step = z(b)  # 1 for an active slot, 0 for an inactive one
        self.tables = z(b, pmax)
        self.temperature = z(b, dtype=torch.float32)
        self.top_p = torch.ones((b,), dtype=torch.float32, device=device)
        self.top_k = z(b, dtype=torch.int64)
        self.presence = z(b, dtype=torch.float32)
        self.frequency = z(b, dtype=torch.float32)
        self.min_p = z(b, dtype=torch.float32)
        self.bias_ids = torch.full((b, smp.BIAS_K), -1, dtype=torch.int64,
                                   device=device)
        self.bias_vals = z(b, smp.BIAS_K, dtype=torch.float32)
        self.slot_keys = z(b, dtype=torch.int64)  # chain roots
        self.token_counts = z(b, vocab)  # output tokens per slot [B, V]
        self.rows = torch.arange(b, device=device)
        self.step_idx = z(1, dtype=torch.int64)  # output row of this step
        n_top = min(NUM_TOP, vocab)
        self.out_tokens = z(k_max, b, dtype=torch.int64)
        self.out_chosen = z(k_max, b, dtype=torch.float32)
        self.out_tids = z(k_max, b, n_top, dtype=torch.int64)
        self.out_tvals = z(k_max, b, n_top, dtype=torch.float32)
        self.drafts = z(b, spec_k, dtype=torch.int64)
        self.room = z(b, dtype=torch.bool)
        self.out_emitted = z(b, spec_k + 1, dtype=torch.int64)
        self.out_nacc = z(b, dtype=torch.int64)
        self.gmode = z(b)
        self.gdepth = z(b)
        self.gbits = z(b)
        self.gactive = z(b, dtype=torch.bool)
        self.adapters = z(b)

    def carry(self) -> Tuple[torch.Tensor, ...]:
        """The buffers a step reads and advances (not token_counts)."""
        return (self.tokens, self.positions, self.context_lens, self.step,
                self.tables, self.step_idx, self.drafts, self.room,
                self.gmode, self.gdepth, self.gbits, self.gactive)

    def reset(self) -> None:
        """Every buffer back to its initial value, in place (a
        resurrection: the captured graphs keep their addresses)."""
        for t in (self.tokens, self.positions, self.step, self.tables,
                  self.temperature, self.top_k, self.presence,
                  self.frequency, self.min_p, self.bias_vals,
                  self.slot_keys, self.token_counts, self.step_idx,
                  self.out_tokens, self.out_chosen, self.out_tids,
                  self.out_tvals, self.drafts, self.room, self.out_emitted,
                  self.out_nacc, self.gmode, self.gdepth, self.gbits,
                  self.gactive, self.adapters):
            t.zero_()
        self.context_lens.fill_(1)
        self.top_p.fill_(1.0)
        self.bias_ids.fill_(-1)

    def idle(self) -> None:
        """Every slot inactive on the trash page, nothing drafted or
        guided."""
        self.tokens.zero_()
        self.positions.zero_()
        self.context_lens.fill_(1)
        self.step.zero_()
        self.tables.zero_()
        self.drafts.zero_()
        self.room.zero_()
        self.gactive.zero_()

    def sampling_state(self, gates: Gates) -> smp.SamplingState:
        return smp.SamplingState(
            self.temperature, self.top_p, self.top_k, self.presence,
            self.frequency, self.min_p, self.bias_ids, self.bias_vals,
            *gates)

    def outputs(self, want_lp: bool) -> Tuple[torch.Tensor, ...]:
        if want_lp:
            return (self.out_tokens, self.out_chosen, self.out_tids,
                    self.out_tvals)
        return (self.out_tokens,)


class Readback:
    """Host copies of a step's outputs (device buffers `sources`): on the
    card, pinned buffers filled by non-blocking copies and a CUDA event
    the host waits on; on the CPU, plain copies."""

    def __init__(self, sources: Tuple[torch.Tensor, ...]):
        self._src = sources
        self._cuda = sources[0].is_cuda
        self._host = tuple(torch.empty(t.shape, dtype=t.dtype,
                                       pin_memory=self._cuda)
                           for t in sources)
        self._event = torch.cuda.Event() if self._cuda else None
        self._k, self._n = 0, 0

    def start(self, k: int, n: int) -> None:
        """Queue the copies of the first k rows of the first n sources
        (after the step on the stream)."""
        self._k, self._n = k, n
        for host, dev in zip(self._host[:n], self._src[:n]):
            host[:k].copy_(dev[:k], non_blocking=self._cuda)
        if self._event is not None:
            self._event.record()

    def wait(self) -> Tuple[np.ndarray, ...]:
        """The first k rows of the first n sources once the copies have
        landed: a window's tokens [k, B], and with logprobs chosen [k, B],
        top ids and values [k, B, 5]."""
        if self._event is not None:
            self._event.synchronize()
        return tuple(h[:self._k].numpy().copy() for h in self._host[:self._n])


@contextlib.contextmanager
def capturing(graph, stream, pool=None) -> Iterator[Dict[str, int]]:
    """torch.cuda.graph(graph) on `stream` (in `pool`), yielding the
    kernel launches the capture records (cuda_attention.counting_capture),
    with the cycle collector off meanwhile (torch.cuda.graph collects just
    before): a collection inside the capture can free an unreachable
    engine's pinned buffers, whose events are then recorded on their
    stream, which global capture mode forbids, and the capture is
    invalidated (seen on the card after a fresh kernel build)."""
    gc_on = gc.isenabled()
    gc.disable()
    try:
        with cuda_attention.counting_capture() as launches:
            with torch.cuda.graph(graph, pool=pool, stream=stream):
                yield launches
    finally:
        if gc_on:
            gc.enable()


class CapturedStep:
    """One captured decode step and the kernel launches it holds."""

    def __init__(self, graph, launches: Dict[str, int]):
        self.graph = graph
        self.launches = launches

    def replay(self) -> None:
        self.graph.replay()
        cuda_attention.count_replay(self.launches)


class DecodeWindows:
    """Runs decode windows over a DeviceBatch: k replays of a captured step
    on the card, the same body eagerly on the CPU or with `eager`."""

    def __init__(self, batch: DeviceBatch, decode_forward: Forward,
                 eager: bool):
        self.batch = batch
        self.decode_forward = decode_forward
        self.eager = eager
        # the vocab table of guided steps (json_guide.DeviceTable), set by
        # the engine before the first one
        self.guide = None
        self.graphs: Dict[Tuple[bool, bool, Gates], CapturedStep] = {}
        # () -> context manager every capture runs in (the engine's
        # watchdog exemption)
        self.capture_guard: Callable[[], contextlib.AbstractContextManager] \
            = contextlib.nullcontext
        self._pool = None
        self._stream: Optional[torch.cuda.Stream] = None
        self.capture_s = 0.0  # seconds spent warming up and capturing
        self.replays = 0
        self.windows = 0

    def stats(self) -> dict:
        return {"eager": self.eager, "graphs": len(self.graphs),
                "capture_s": self.capture_s, "windows": self.windows,
                "replays": self.replays}

    def _body(self, forward: Forward, want_lp: bool, gates: Gates,
              guided: bool = False) -> None:
        """One decode step over the batch buffers (see the module doc)."""
        b = self.batch
        logits = forward(b.tokens, b.positions, b.tables, b.context_lens)
        if guided:
            cuda_guide.json_mask(logits, b.gmode, b.gdepth, b.gbits,
                                 b.gactive, self.guide)
        state = b.sampling_state(gates)
        keys = smp.fold_positions(b.slot_keys, b.positions)
        if want_lp:
            nxt, chosen, tids, tvals = smp.sample_with_logprobs(
                logits, state, keys, b.token_counts, num_top=NUM_TOP)
            b.out_chosen.index_copy_(0, b.step_idx, chosen[None])
            b.out_tids.index_copy_(0, b.step_idx, tids[None])
            b.out_tvals.index_copy_(0, b.step_idx, tvals[None])
        else:
            nxt = smp.sample(logits, state, keys, b.token_counts)
        # only active slots count their emission
        b.token_counts.index_put_((b.rows, nxt), b.step, accumulate=True)
        if guided:
            cuda_guide.json_advance(nxt, b.gmode, b.gdepth, b.gbits,
                                    b.gactive, self.guide)
        b.out_tokens.index_copy_(0, b.step_idx, nxt[None])
        b.tokens.copy_(nxt)
        b.positions += b.step
        b.context_lens += b.step
        b.step_idx += 1

    def run(self, k: int, want_lp: bool, gates: Gates,
            guided: bool = False) -> None:
        """Queue a k-step decode window (JSON-guided with `guided`); its
        tokens land in rows 0..k-1 of the outputs."""
        self.batch.step_idx.zero_()
        self.windows += 1
        if self.eager:
            for _ in range(k):
                self._body(self.decode_forward, want_lp, gates, guided)
            return
        step = self.graphs.get((want_lp, guided, gates))
        if step is None:
            step = self.capture(want_lp, gates, guided)
        for _ in range(k):
            step.replay()
        self.replays += k

    def run_eager(self, forward: Forward, want_lp: bool,
                  gates: Gates) -> None:
        """One step with another forward (the mixed step), always eager."""
        self.batch.step_idx.zero_()
        self._body(forward, want_lp, gates)

    def capture(self, want_lp: bool, gates: Gates,
                guided: bool = False) -> CapturedStep:
        """Warm up and capture the step for (want_lp, guided, gates)."""
        t0 = time.monotonic()
        step = self.capture_body(
            lambda: self._body(self.decode_forward, want_lp, gates, guided))
        self.graphs[(want_lp, guided, gates)] = step
        self.capture_s += time.monotonic() - t0
        return step

    def capture_body(self, body: Callable[[], None]) -> CapturedStep:
        """Capture `body` (a step over the batch buffers) into a graph of
        this batch's pool, after one warm-up pass of it on the capture
        stream over an idle batch; the live carry is restored after."""
        b = self.batch
        with self.capture_guard():
            if self._stream is None:
                self._stream = torch.cuda.Stream()
                self._pool = torch.cuda.graph_pool_handle()
            saved = [t.clone() for t in b.carry()]
            b.idle()
            self._stream.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(self._stream):
                b.step_idx.zero_()
                body()
            torch.cuda.current_stream().wait_stream(self._stream)
            graph = torch.cuda.CUDAGraph()
            with capturing(graph, self._stream, self._pool) as launches:
                body()
            for t, s in zip(b.carry(), saved):
                t.copy_(s)
        return CapturedStep(graph, launches)


class VerifySteps:
    """Runs speculative verify steps over a DeviceBatch: a replay of a
    captured step per sampling-gate tuple on the card (in the decode
    windows' memory pool), the same body eagerly on the CPU or with
    `eager`."""

    def __init__(self, windows: DecodeWindows, verify_forward: VerifyForward):
        self.windows = windows
        self.batch = windows.batch
        self.verify_forward = verify_forward
        self.eager = windows.eager
        self.graphs: Dict[Gates, CapturedStep] = {}
        self.capture_s = 0.0
        self.steps = 0
        self.replays = 0

    def stats(self) -> dict:
        return {"eager": self.eager, "graphs": len(self.graphs),
                "capture_s": self.capture_s, "steps": self.steps,
                "replays": self.replays}

    def _body(self, forward: VerifyForward, gates: Gates) -> None:
        """One verify step over the batch buffers (JAX `spec_fn` and its
        `_spec_accept` tail)."""
        b = self.batch
        k1 = b.drafts.shape[1] + 1
        tokens = torch.cat([b.tokens[:, None], b.drafts], dim=1)
        logits = forward(tokens, b.positions, b.tables, b.room)
        state = b.sampling_state(gates)
        active = b.step > 0
        eligible = ((b.presence == 0.0) & (b.frequency == 0.0) & b.room
                    & active)
        emitted, n_acc = smp.verify_accept(logits, b.drafts, state,
                                           b.slot_keys, b.positions,
                                           eligible, b.token_counts)
        j = torch.arange(k1, device=n_acc.device)
        emit = (j[None, :] <= n_acc[:, None]) & active[:, None]
        b.token_counts.index_put_(
            (b.rows.repeat_interleave(k1), emitted.reshape(-1)),
            emit.reshape(-1).to(b.token_counts.dtype), accumulate=True)
        last = emitted.gather(1, n_acc[:, None])[:, 0]
        b.tokens.copy_(torch.where(active, last, b.tokens))
        step = torch.where(active, n_acc + 1,
                           torch.zeros_like(n_acc)).to(b.positions.dtype)
        b.positions += step
        b.context_lens += step
        b.out_emitted.copy_(emitted)
        b.out_nacc.copy_(n_acc)

    def run(self, gates: Gates) -> None:
        """Queue one verify step; its outputs land in out_emitted and
        out_nacc."""
        self.steps += 1
        if self.eager:
            self._body(self.verify_forward, gates)
            return
        step = self.graphs.get(gates)
        if step is None:
            step = self.capture(gates)
        step.replay()
        self.replays += 1

    def run_eager(self, forward: VerifyForward, gates: Gates) -> None:
        """One verify step with another forward (the mixed verify step),
        always eager."""
        self.steps += 1
        self._body(forward, gates)

    def capture(self, gates: Gates) -> CapturedStep:
        """Warm up and capture the verify step for `gates`."""
        t0 = time.monotonic()
        step = self.windows.capture_body(
            lambda: self._body(self.verify_forward, gates))
        self.graphs[gates] = step
        self.capture_s += time.monotonic() - t0
        return step
