"""Engine watchdog & device-fault quarantine (the port's own copy of
`dynamo_tpu/robustness/watchdog.py`; keep the two in step).

Every robustness plane so far (journaled recovery, drain handoff, burn-
gated rollouts) assumes the engine itself stays sane.  It does not: a
hung device dispatch wedges ``step()`` under ``_exec_lock`` forever, and
a silently-corrupted forward (NaN logits, bad chip) streams garbage with
a 200 status.  This module closes that failure domain with one
invariant: *the engine is either provably making progress or provably
out of rotation*.

Three cooperating pieces:

1. **Hung-dispatch watchdog.**  The stepline already brackets every
   device seam with ``dispatch``/``device_wait`` phases; the timeline
   mirrors those seams into :meth:`EngineWatchdog.device_enter` /
   :meth:`device_exit`.  A lazy monitor thread checks the armed seam
   against a deadline (``DYNAMO_TPU_STEP_DEADLINE_S`` override, else a
   warmup-measured seam-time EWMA x margin with a floor).  A blown
   deadline *trips* the watchdog: the worker goes ``suspect``, serving
   sheds ``/v1/*`` with 503, the flight recorder dumps the open draft,
   and the escalation ladder fires.

2. **Health state machine.** ::

       healthy -> suspect -> resurrecting -> healthy
                     |
                     +--> quarantined        (terminal)

   The escalation ladder resurrects a suspect engine in place (fresh KV
   pool, re-``device_put`` weights through the elasticity staging path,
   re-warmup) once the wedged dispatch returns control; journaled
   streams hand off through the drain-handoff plane meanwhile and
   resume byte-identically on a peer.  Repeated trips within
   ``DYNAMO_TPU_QUARANTINE_WINDOW_S`` mean the device is not coming
   back: the worker is quarantined permanently, readiness goes 503, the
   operator replaces the pod and planner capacity excludes it.

3. **Integrity sentinels** (``DYNAMO_TPU_INTEGRITY=off|logits|full``).
   A finite-check on prefill logits rides the existing first-token
   readback (no extra device sync) and a host-side sanity check covers
   decode-window readbacks; ``full`` adds KV-page checksums at the KVBM
   demote/onboard boundary.  A tripped sentinel aborts ONLY the
   poisoned streams with a typed ``integrity_fault`` flight event —
   never the process, and never the health state machine (corruption is
   per-batch; hangs are per-device).  The KV checksum (the ``kv_checksum``
   sentinel, recorded by ``kvbm/manager.py``'s ``_verify``) aborts
   nothing: the rotten host block is dropped before it reaches the
   device pools and its prefix recomputes.

Trip handling runs on the monitor thread and deliberately never touches
``_exec_lock`` — the whole point is that the scheduler thread may be
wedged under it.  Resurrection runs on a separate escalation thread
that *does* block on the lock: a simulated hang eventually returns and
resurrection proceeds; a real hang never returns, which leaves the
worker suspect and shedding until the operator replaces the pod —
exactly the "provably out of rotation" half of the invariant.

On the card (what the port adds to the JAX module):

- The engine is held by a weak reference, and the monitor thread holds
  the watchdog by one between its passes, so a monitor that has not
  parked yet never keeps a released engine (its weights, pools and
  graphs, reached also through the serving context's hooks) alive.
- Seams that are long without being hangs are not armed: the kernel
  library's first build, a CUDA graph capture and a `/debug/trace`
  capture (with a PROFILER_TAIL_S tail) run inside
  :meth:`EngineWatchdog.exempt`, and while a ``torch.profiler`` session
  is open on the scheduler's thread (and for ``PROFILER_TAIL_S`` after
  it was last seen: CUPTI's start and the windows right after it run
  seconds long) the engine's ``exempt_probe`` names the profiler. A seam
  that enters during an exemption is not armed, and an exemption that
  begins mid-seam disarms it.
- The monitor thread makes no CUDA call: it reads host clocks and the
  armed seam only, so it answers while the scheduler thread blocks in a
  readback with the exec lock held.
- A CUDA error that sticks (an illegal address, an ECC error) poisons the
  context: every later CUDA call raises, so a resurrection could only
  raise again. :meth:`on_fatal_step` probes the context once
  (``engine.device_poisoned()``) and quarantines such an engine without
  trying.

Env knobs (registered in dynalint KNOWN_ENV):

- ``DYNAMO_TPU_STEP_DEADLINE_S`` — hard per-seam deadline override;
  unset derives ``max(floor, ewma * margin)`` from observed seam times.
  The derived deadline only arms on real accelerators
  (``derive_deadline``): on the CPU fallback a mid-seam XLA recompile
  routinely dwarfs any measured EWMA (there is no AOT warmup guarantee
  off-TPU), so without an explicit override the monitor observes but
  never trips there — CI drills set the override;
- ``DYNAMO_TPU_QUARANTINE_WINDOW_S`` (default 300) — two trips inside
  this window quarantine the worker permanently;
- ``DYNAMO_TPU_INTEGRITY`` (default ``logits``) — sentinel tier.
"""

from __future__ import annotations

import collections
import contextlib
import logging
import os
import threading
import time
import weakref
from typing import Callable, Deque, Dict, Iterator, List, Optional

log = logging.getLogger("dynamo_tpu_torch.watchdog")

DEADLINE_ENV = "DYNAMO_TPU_STEP_DEADLINE_S"
QUARANTINE_WINDOW_ENV = "DYNAMO_TPU_QUARANTINE_WINDOW_S"
INTEGRITY_ENV = "DYNAMO_TPU_INTEGRITY"

DEFAULT_QUARANTINE_WINDOW_S = 300.0
# without an EWMA yet (pre-warmup) or an env override, never trip a seam
# faster than this — cold dispatches legitimately include compilation
DEFAULT_DEADLINE_FLOOR_S = 2.0
# EWMA multiplier: decode seams are milliseconds, so even 20x stays far
# below human-visible; a genuine hang overshoots by orders of magnitude
DEFAULT_DEADLINE_MARGIN = 20.0
EWMA_ALPHA = 0.2
# monitor thread parks itself after this long with no armed seam: the
# thread pins watchdog -> engine (params, KV pool) via its bound-method
# target, so an idle monitor would keep a retired engine immortal.
# device_enter restarts it on the next dispatch.
MONITOR_IDLE_EXIT_S = 5.0
# seams stay unarmed this long after a profiler session was last seen
# open: the first windows after CUPTI starts or stops run seconds long
PROFILER_TAIL_S = 5.0

# /metrics encoding of health (docs/robustness.md)
HEALTH_CODES = {"healthy": 0, "suspect": 1, "resurrecting": 2,
                "quarantined": 3}

INTEGRITY_MODES = ("off", "logits", "full")


def integrity_mode() -> str:
    """Resolved ``DYNAMO_TPU_INTEGRITY`` tier; unknown values fall back
    to the default ``logits`` (cheap, always worth it)."""
    raw = os.environ.get(INTEGRITY_ENV, "logits").strip().lower()
    return raw if raw in INTEGRITY_MODES else "logits"


def _env_deadline() -> Optional[float]:
    raw = os.environ.get(DEADLINE_ENV, "").strip()
    if not raw:
        return None
    try:
        v = float(raw)
        return v if v > 0 else None
    except ValueError:
        log.warning("bad %s=%r; deriving deadline from EWMA", DEADLINE_ENV,
                    raw)
        return None


def _env_quarantine_window() -> float:
    raw = os.environ.get(QUARANTINE_WINDOW_ENV, "").strip()
    if not raw:
        return DEFAULT_QUARANTINE_WINDOW_S
    try:
        return max(0.0, float(raw))
    except ValueError:
        return DEFAULT_QUARANTINE_WINDOW_S


def _monitor_main(ref: "weakref.ref") -> None:
    """The monitor thread's body: passes of `_monitor_tick` while the
    watchdog lives, holding it only during a pass, so the thread ends
    with a released watchdog."""
    idle: List[Optional[float]] = [None]
    while True:
        wd = ref()
        if wd is None or wd._stop.is_set():
            return
        wait = wd._monitor_tick(idle)
        stop = wd._stop
        del wd
        if wait is None or stop.wait(wait):
            return


class IntegrityFault(RuntimeError):
    """A sentinel caught device-side corruption (non-finite logits,
    out-of-range token, KV checksum mismatch).  Carries the poisoned
    request ids so callers abort exactly those streams and nothing
    else."""

    def __init__(self, sentinel: str, rids: List[str], detail: str = ""):
        self.sentinel = sentinel
        self.rids = list(rids)
        super().__init__(
            f"integrity fault [{sentinel}] rids={self.rids} {detail}".strip())


class EngineWatchdog:
    """Per-engine health state machine + hung-dispatch monitor.

    Constructed by the engine next to its StepTimeline; the timeline
    forwards device-phase enter/exit events here (``timeline.watch``),
    which keeps the seam coverage exactly equal to the stepline's
    instrumentation — any newly instrumented device seam is watched for
    free.
    """

    def __init__(self, engine: Optional[object] = None,
                 deadline_s: Optional[float] = None,
                 quarantine_window_s: Optional[float] = None,
                 margin: float = DEFAULT_DEADLINE_MARGIN,
                 floor_s: float = DEFAULT_DEADLINE_FLOOR_S,
                 derive_deadline: bool = True,
                 clock: Callable[[], float] = time.monotonic):
        self._engine_ref = (weakref.ref(engine) if engine is not None
                            else None)
        self._clock = clock
        # False = only an explicit override (env/ctor/test) ever trips
        # the monitor; the EWMA still accumulates for observability
        self.derive_deadline = derive_deadline
        self._deadline_override = (deadline_s if deadline_s is not None
                                   else _env_deadline())
        self.quarantine_window_s = (
            quarantine_window_s if quarantine_window_s is not None
            else _env_quarantine_window())
        self.margin = margin
        self.floor_s = floor_s

        self._lock = threading.Lock()
        self._state = "healthy"  # guarded_by: _lock
        self._armed: Optional[List] = None  # guarded_by: _lock — [seam, t0, tripped]
        self._ewma_s: Optional[float] = None  # guarded_by: _lock
        self._trip_times: Deque[float] = collections.deque(maxlen=32)  # guarded_by: _lock
        self.trips_total: Dict[str, int] = {}  # guarded_by: _lock — by kind
        self.integrity_faults_total: Dict[str, int] = {}  # guarded_by: _lock — by sentinel
        self.last_trip: Optional[Dict[str, object]] = None  # guarded_by: _lock

        # hooks fired OUTSIDE the lock (serving wires shed/handoff/metrics)
        self.on_trip: Optional[Callable[[str, str], None]] = None
        self.on_health: Optional[Callable[[str], None]] = None

        # seams that are long without being hangs: open exemptions (kernel
        # build, graph capture) and the quiet time after one closed
        self._exempt: Dict[str, int] = {}  # guarded_by: _lock
        self._quiet_until = 0.0  # guarded_by: _lock
        # () -> reason or None: a host-side check the engine installs (an
        # open torch.profiler session); no CUDA call
        self.exempt_probe: Optional[Callable[[], Optional[str]]] = None

        self._monitor: Optional[threading.Thread] = None  # guarded_by: _lock
        self._resurrector: Optional[threading.Thread] = None  # guarded_by: _lock
        self._stop = threading.Event()

    @property
    def engine(self):
        """The watched engine, or None once it was released."""
        ref = self._engine_ref
        return ref() if ref is not None else None

    # ------------------------------------------------------------- health --
    @property
    def health(self) -> str:
        with self._lock:
            return self._state

    @property
    def health_code(self) -> int:
        return HEALTH_CODES[self.health]

    @property
    def ok_for_traffic(self) -> bool:
        """Gate for /v1/* admission and readiness: only a healthy engine
        takes new work."""
        return self.health == "healthy"

    def _transition(self, state: str) -> bool:
        """Set health under the lock; fire on_health outside it.  A
        quarantined worker never leaves quarantine (terminal)."""
        with self._lock:
            if self._state == "quarantined" and state != "quarantined":
                return False
            if self._state == state:
                return False
            self._state = state
        log.warning("engine health -> %s", state)
        cb = self.on_health
        if cb is not None:
            try:
                cb(state)
            except Exception:
                log.exception("on_health hook failed")
        return True

    # --------------------------------------------------- seam arm / disarm --
    def device_enter(self, seam: str) -> None:
        """A device dispatch/readback seam opened (timeline hook).  Arms
        the deadline and lazily starts the monitor."""
        now = self._clock()
        reason = self._probe_exempt(now)
        with self._lock:
            if reason is not None or self._exempt or now < self._quiet_until:
                # a long seam that is not a hang: watched, never armed
                self._armed = None
                return
            self._armed = [seam, now, False]
            started = self._monitor is not None and self._monitor.is_alive()
        if not started:
            self._start_monitor()

    def _probe_exempt(self, now: float) -> Optional[str]:
        """The engine's exemption probe (an open profiler session); a hit
        keeps seams unarmed for PROFILER_TAIL_S after it was last seen."""
        probe = self.exempt_probe
        if probe is None:
            return None
        try:
            reason = probe()
        except Exception:
            log.exception("watchdog exempt probe failed")
            return None
        if reason is not None:
            with self._lock:
                self._quiet_until = max(self._quiet_until,
                                        now + PROFILER_TAIL_S)
        return reason

    def quiet(self) -> bool:
        """True while a seam entered now would not arm: an exemption is
        open or its tail has not run out."""
        with self._lock:
            return bool(self._exempt) or self._clock() < self._quiet_until

    @contextlib.contextmanager
    def exempt(self, reason: str, tail_s: float = 0.0) -> Iterator[None]:
        """A stretch that is long without being a hang (the kernel
        library's first build, a graph capture, a profiler capture): the
        seam open now is disarmed, no seam arms until the block ends, and
        none for `tail_s` after it."""
        with self._lock:
            self._exempt[reason] = self._exempt.get(reason, 0) + 1
            self._armed = None
        try:
            yield
        finally:
            with self._lock:
                n = self._exempt.get(reason, 0) - 1
                if n > 0:
                    self._exempt[reason] = n
                else:
                    self._exempt.pop(reason, None)
                self._quiet_until = max(self._quiet_until,
                                        self._clock() + tail_s)

    def device_exit(self, seam: str) -> None:
        """Seam closed in time: disarm and fold the duration into the
        EWMA the derived deadline rests on."""
        now = self._clock()
        with self._lock:
            armed = self._armed
            self._armed = None
            if armed is None or armed[2]:
                # nothing armed, or this seam already tripped — a late
                # return from a tripped seam must not poison the EWMA
                return
            dt = max(0.0, now - armed[1])
            if self._ewma_s is None:
                self._ewma_s = dt
            else:
                self._ewma_s = ((1.0 - EWMA_ALPHA) * self._ewma_s
                                + EWMA_ALPHA * dt)

    def deadline_s(self) -> float:
        """Effective per-seam deadline: env/ctor override wins, else
        EWMA x margin with a floor (pre-EWMA: just the floor)."""
        if self._deadline_override is not None:
            return self._deadline_override
        with self._lock:
            ewma = self._ewma_s
        if ewma is None:
            return self.floor_s
        return max(self.floor_s, ewma * self.margin)

    # ------------------------------------------------------------ monitor --
    def _start_monitor(self) -> None:
        with self._lock:
            if self._monitor is not None and self._monitor.is_alive():
                return
            # the thread holds the watchdog weakly: a bound-method target
            # would keep it, and through its hooks (the serving context)
            # the engine, alive until the monitor parks
            self._monitor = threading.Thread(
                target=_monitor_main, args=(weakref.ref(self),),
                name="engine-watchdog", daemon=True)
            self._monitor.start()

    def _monitor_tick(self, idle: List[Optional[float]]) -> Optional[float]:
        """One pass of the monitor: trip the armed seam once it is past
        its deadline. Returns the seconds to wait before the next pass,
        or None to park (no seam armed for MONITOR_IDLE_EXIT_S; the next
        device_enter restarts the thread). `idle` holds the time the
        monitor went idle between passes."""
        deadline = self.deadline_s()
        # derived deadlines only arm on real accelerators: a CPU
        # fallback recompiles mid-seam at will, so without an
        # explicit override the monitor observes but never trips
        armable = (self._deadline_override is not None
                   or self.derive_deadline)
        tripped_seam = None
        now = self._clock()
        with self._lock:
            armed = self._armed
            if (armable and armed is not None and not armed[2]
                    and now - armed[1] > deadline):
                armed[2] = True  # one trip per arming
                tripped_seam = armed[0]
            if armed is None:
                if idle[0] is None:
                    idle[0] = now
                elif now - idle[0] > MONITOR_IDLE_EXIT_S:
                    self._monitor = None
                    return None
            else:
                idle[0] = None
        if tripped_seam is not None:
            self.trip("hung_dispatch", seam=tripped_seam,
                      deadline_s=deadline)
        # poll an order of magnitude finer than the deadline so
        # detection latency stays << the deadline itself
        return max(0.01, min(0.25, deadline / 10.0))

    def stop(self) -> None:
        """Engine shutdown: stop the monitor thread."""
        self._stop.set()

    # --------------------------------------------------------------- trips --
    def trip(self, kind: str, seam: str = "", escalate: bool = True,
             **fields) -> None:
        """A blown deadline or fatal step.  Runs on the monitor (or
        scheduler) thread and NEVER takes the engine exec lock — the
        scheduler may be wedged under it.  Marks the worker suspect,
        flight-dumps, fires on_trip, and launches the escalation ladder
        (or quarantines on repeat trips inside the window)."""
        now = self._clock()
        with self._lock:
            recent = [t for t in self._trip_times
                      if now - t <= self.quarantine_window_s]
            self._trip_times.append(now)
            self.trips_total[kind] = self.trips_total.get(kind, 0) + 1
            self.last_trip = {"kind": kind, "seam": seam, "t": now, **fields}
            quarantine = len(recent) >= 1  # this trip is the 2nd in window
        eng = self.engine
        if eng is not None and getattr(eng, "flight", None) is not None:
            try:
                eng.flight.note("watchdog_trip", kind=kind, seam=seam,
                                **fields)
                eng.flight.dump(f"watchdog_{kind}")
            except Exception:
                log.exception("watchdog flight dump failed")
        if quarantine:
            log.error("watchdog trip kind=%s seam=%s — repeat inside "
                      "%.1fs window, quarantining permanently",
                      kind, seam, self.quarantine_window_s)
            self._transition("quarantined")
        else:
            log.error("watchdog trip kind=%s seam=%s deadline=%s",
                      kind, seam, fields.get("deadline_s"))
            self._transition("suspect")
        cb = self.on_trip
        if cb is not None:
            try:
                cb(kind, seam)
            except Exception:
                log.exception("on_trip hook failed")
        if not quarantine and escalate:
            self._start_resurrector()

    def on_fatal_step(self, err: BaseException) -> None:
        """engine_service's fatal-step path: the scheduler thread itself
        caught the error, so it is NOT wedged — trip, then resurrect
        inline on this thread (deterministic: no escalation thread, no
        window where a broken engine takes another step)."""
        eng = self.engine
        poisoned = False
        if eng is not None and hasattr(eng, "device_poisoned"):
            # one probe of the context: a CUDA error that sticks makes
            # every later call raise, so resurrection is not attempted
            poisoned = bool(eng.device_poisoned())
        self.trip("fatal_step", seam="step", escalate=False,
                  error=repr(err), **({"sticky": True} if poisoned else {}))
        if poisoned:
            log.error("the device context is poisoned (%r): quarantining "
                      "without a resurrection attempt", err)
            self._transition("quarantined")
        if self.health == "suspect":
            self._resurrect()
        elif self.health == "quarantined" and eng is not None:
            # permanently out of rotation — still tear down the streams
            # so every waiting handler sees a final event
            try:
                eng.abort_all()
            except Exception:
                log.exception("quarantine teardown failed")

    def record_integrity_fault(self, sentinel: str, rids: List[str],
                               **fields) -> None:
        """A sentinel caught corruption.  Counted and flight-noted, but
        health does NOT change: the poisoned streams are aborted and the
        engine keeps serving co-batched tenants."""
        with self._lock:
            self.integrity_faults_total[sentinel] = (
                self.integrity_faults_total.get(sentinel, 0) + 1)
        eng = self.engine
        if eng is not None and getattr(eng, "flight", None) is not None:
            try:
                eng.flight.note("integrity_fault", sentinel=sentinel,
                                rids=list(rids), **fields)
            except Exception:
                log.exception("integrity flight note failed")
        log.error("integrity fault sentinel=%s rids=%s", sentinel,
                  list(rids))

    # --------------------------------------------------------- escalation --
    def _start_resurrector(self) -> None:
        with self._lock:
            if self._resurrector is not None and self._resurrector.is_alive():
                return
            self._resurrector = threading.Thread(
                target=self._resurrect, name="engine-resurrector",
                daemon=True)
            self._resurrector.start()

    def _resurrect(self) -> None:
        """Escalation ladder tail: block until the wedged dispatch
        returns control (RLock), then rebuild device state in place.  A
        real device hang never returns the lock — the worker stays
        suspect and shedding until the operator replaces the pod."""
        eng = self.engine
        if eng is None:
            return
        lock = getattr(eng, "_exec_lock", None)
        try:
            if lock is not None:
                lock.acquire()
            try:
                if self.health == "quarantined":
                    return
                self._transition("resurrecting")
                eng.resurrect()
            finally:
                if lock is not None:
                    lock.release()
        except Exception:
            log.exception("engine resurrection failed — quarantining")
            self._transition("quarantined")
            return
        if self._transition("healthy"):
            log.warning("engine resurrected in place; serving again")

    # ----------------------------------------------------------- snapshot --
    def summary(self) -> Dict[str, object]:
        """Rides /worker/stats and the heartbeat (frontend health gauge,
        router filter)."""
        with self._lock:
            if self._deadline_override is not None:
                deadline = self._deadline_override
            elif self._ewma_s is None:
                deadline = self.floor_s
            else:
                deadline = max(self.floor_s, self._ewma_s * self.margin)
            return {
                "state": self._state,
                "code": HEALTH_CODES[self._state],
                "trips_total": dict(self.trips_total),
                "integrity_faults_total": dict(self.integrity_faults_total),
                "ewma_s": self._ewma_s,
                "deadline_s": deadline,
                "last_trip": dict(self.last_trip) if self.last_trip else None,
            }
