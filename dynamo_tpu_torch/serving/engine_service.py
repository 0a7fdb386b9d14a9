"""Background scheduler thread bridging the synchronous Engine to concurrent
HTTP handlers via per-request event queues.

Port of `dynamo_tpu/serving/engine_service.py`: HTTP threads enqueue
GenRequests; one scheduler thread drives Engine.step() and fans
TokenEvents out to the stream queues. The fault points
`worker.slow_prefill` (admission) and `worker.crash_mid_decode` (a stream
dies after a token was delivered) sit where the JAX service has them; a
failed step goes to the engine watchdog (`on_fatal_step`: an in-place
resurrection, or quarantine), whose teardown ends every stream through
`Engine.on_abort_all`. While the watchdog holds the engine suspect or
resurrecting, the scheduler steps nothing, so the resurrector (blocked on
the exec lock) takes it at the next step boundary.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Dict, Iterator, Optional

from dynamo_tpu_torch.engine.engine import Engine
from dynamo_tpu_torch.engine.request import GenRequest, TokenEvent
from dynamo_tpu_torch.robustness import deadline as ddl
from dynamo_tpu_torch.robustness import faults

log = logging.getLogger("dynamo_tpu_torch.service")

# health states in which the scheduler leaves the engine to the
# resurrector (the exec lock is not fair: a scheduler stepping in a loop
# could hold the resurrection off for many steps)
_HOLD_STATES = ("suspect", "resurrecting")


class EngineService:
    def __init__(self, engine: Engine):
        self.engine = engine
        # guarded_by: _lock
        self._queues: Dict[str, "queue.Queue[TokenEvent]"] = {}
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
        # resurrection (the watchdog's escalation thread) tears streams
        # down through engine.abort_all: flush their queues so waiting
        # handlers see a final event instead of polling a dead request
        engine.on_abort_all = self._flush_aborted
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="engine-scheduler")
        self._thread.start()

    def close(self) -> None:
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=10)

    def submit(self, req: GenRequest) -> "queue.Queue[TokenEvent]":
        """Validate and enqueue; raises ValueError BEFORE any output starts,
        so HTTP handlers can reject with a clean status line."""
        faults.sleep_point("worker.slow_prefill")
        q: "queue.Queue[TokenEvent]" = queue.Queue()
        with self._lock:
            self._queues[req.request_id] = q
        try:
            self.engine.add_request(req)
        except ValueError:
            with self._lock:
                self._queues.pop(req.request_id, None)
            raise
        self._wake.set()
        return q

    def abort(self, request_id: str) -> None:
        self.engine.abort_request(request_id)
        self._wake.set()

    def nudge_all(self) -> None:
        """Push a no-op event to every open stream queue. A wedged engine
        emits nothing, so handlers blocked in drain() would never see a
        drain-handoff signal; the nudge wakes them (token_id -1 with
        finished False is ignored everywhere else)."""
        with self._lock:
            for rid, q in list(self._queues.items()):
                q.put(TokenEvent(rid, -1, 0, False, None))

    def _flush_aborted(self, ids) -> None:
        """engine.on_abort_all hook: end the stream queue of every request
        torn down (idempotent: a queue already popped is absent)."""
        with self._lock:
            for rid in ids:
                q = self._queues.pop(rid, None)
                if q is not None:
                    q.put(TokenEvent(rid, -1, 0, True, "abort"))

    def sampling_state(self, request_id: str):
        """The resumable sampling state of a live request
        (`Engine.export_sampling_state`): the drain-handoff path journals
        it so a continuation on another worker resumes the same chain.
        None once the request left the engine."""
        return self.engine.export_sampling_state(request_id)

    def drain(self, req: GenRequest, q: "queue.Queue[TokenEvent]",
              timeout: Optional[float] = None) -> Iterator[TokenEvent]:
        """Yield TokenEvents for a submitted request until it finishes.

        `timeout` is the request's remaining deadline budget (from the
        client's x-deadline header); None falls back to the operator's
        DYNAMO_TPU_DEADLINE_S default."""
        if timeout is None:
            timeout = ddl.default_budget_s()
        deadline = time.monotonic() + timeout
        try:
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self.abort(req.request_id)
                    raise TimeoutError(
                        f"request {req.request_id} exceeded its "
                        f"{timeout:.1f}s deadline budget")
                try:
                    ev = q.get(timeout=min(remaining, 5.0))
                except queue.Empty:
                    continue
                yield ev
                if ev.finished:
                    return
                if faults.check("worker.crash_mid_decode") is not None:
                    # the worker "crashes" with tokens already delivered:
                    # abort the engine side and die mid-stream; the
                    # frontend resumes the journaled continuation on
                    # another worker, or truncates
                    self.abort(req.request_id)
                    raise ConnectionResetError(
                        "injected fault: worker.crash_mid_decode")
        finally:
            with self._lock:
                self._queues.pop(req.request_id, None)

    def _run(self) -> None:
        wd = self.engine.watchdog
        while not self._stop.is_set():
            if not self.engine.has_work or wd.health in _HOLD_STATES:
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                continue
            try:
                events = self.engine.step()
            except Exception as e:
                log.exception("engine step failed; aborting in-flight "
                              "requests")
                # name the failure before the teardown dumps the ring
                self.engine.flight.note("fatal_step", error=repr(e))
                # the health state machine: suspect -> in-place
                # resurrection (this thread is not wedged: it caught the
                # error), or quarantine on a repeat trip or a poisoned
                # context; the teardown ends every stream through
                # on_abort_all before the worker takes new work
                wd.on_fatal_step(e)
                time.sleep(0.5)
                continue
            if events:
                with self._lock:
                    for ev in events:
                        q = self._queues.get(ev.request_id)
                        if q is not None:
                            q.put(ev)
