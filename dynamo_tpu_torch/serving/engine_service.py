"""Background scheduler thread bridging the synchronous Engine to concurrent
HTTP handlers via per-request event queues.

Port of `dynamo_tpu/serving/engine_service.py` without the fault-injection
and watchdog seams: HTTP threads enqueue GenRequests; one scheduler thread
drives Engine.step() and fans TokenEvents out to the stream queues. A
failed step is noted in the flight recorder and ends every request
(`Engine.abort_all`, which dumps the ring to the log).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from typing import Dict, Iterator, Optional

from dynamo_tpu_torch.engine.engine import Engine
from dynamo_tpu_torch.engine.request import GenRequest, TokenEvent

log = logging.getLogger("dynamo_tpu_torch.service")

DEFAULT_TIMEOUT_S = 600.0


class EngineService:
    def __init__(self, engine: Engine):
        self.engine = engine
        # guarded_by: _lock
        self._queues: Dict[str, "queue.Queue[TokenEvent]"] = {}
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = threading.Event()
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

    def drain(self, req: GenRequest, q: "queue.Queue[TokenEvent]",
              timeout: Optional[float] = None) -> Iterator[TokenEvent]:
        """Yield TokenEvents for a submitted request until it finishes."""
        deadline = time.monotonic() + (timeout or DEFAULT_TIMEOUT_S)
        try:
            while True:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self.abort(req.request_id)
                    raise TimeoutError(
                        f"request {req.request_id} exceeded its deadline")
                try:
                    ev = q.get(timeout=min(remaining, 5.0))
                except queue.Empty:
                    continue
                yield ev
                if ev.finished:
                    return
        finally:
            with self._lock:
                self._queues.pop(req.request_id, None)

    def _run(self) -> None:
        while not self._stop.is_set():
            if not self.engine.has_work:
                self._wake.wait(timeout=0.05)
                self._wake.clear()
                continue
            try:
                events = self.engine.step()
            except Exception as e:
                # a failed step must not strand its streams: tear down
                # every request (abort_all dumps the flight ring after
                # this note) and end every stream
                log.exception("engine step failed; aborting in-flight "
                              "requests")
                self.engine.flight.note("fatal_step", error=repr(e))
                self.engine.abort_all()
                with self._lock:
                    queues, self._queues = self._queues, {}
                for rid, q in queues.items():
                    q.put(TokenEvent(rid, -1, 0, True, "abort"))
                time.sleep(0.5)
                continue
            if events:
                with self._lock:
                    for ev in events:
                        q = self._queues.get(ev.request_id)
                        if q is not None:
                            q.put(ev)
