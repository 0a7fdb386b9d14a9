"""Hot weight swap: a double buffer of device weights and a version label
(the port of `dynamo_tpu/elasticity/weights.py`).

The JAX engine's jitted programs take ``params`` as a per-call operand, so
its flip swaps a pointer. The port's decode windows and verify steps are
CUDA graphs that hold the live weights' device addresses: a new tree at
new addresses would leave every replayed graph reading v1. So the flip
here moves CONTENTS, not pointers: v2 is staged as a second set of device
tensors in the live layout (bf16, int8 column-major q with f32 scales,
w8a8), and the flip swaps the two sets' bytes storage by storage through
one storage-sized scratch buffer, under ``engine._exec_lock``. Every
captured graph stays valid and reads the active version; a rollback is
the same swap back, and the buffer that held v2 holds v1 afterwards.

  stage     load v2 through the normal weight path (`models/loader.py`:
            a checkpoint under ``model_path``, else seeded random init, at
            the live quantization) straight onto the card, after a
            headroom check of ``torch.cuda.mem_get_info`` (or
            ``DYNAMO_TPU_ROLLOUT_HEADROOM_BYTES``) against the live tree's
            bytes (a hitless swap needs an identical tree, so the incoming
            bytes are the live bytes) plus the margin and the scratch;
            the staged tree must match the live one leaf for leaf (names,
            shapes, dtypes, strides, storages), else it is dropped.
  flip      swap contents under ``engine._exec_lock``: the lock serialises
            every step, so no step ever mixes versions. In ``finish`` mode
            a busy engine arms the flip instead: admissions hold, in-flight
            v1 streams run to completion, and the scheduler applies the
            swap at the first step boundary with no live sequence.
  rollback  the previous version stays on the card (in the staging
            buffer) until ``commit`` or the next ``stage``, so a rollback
            is the same swap.

The swap writes the live storage itself, so every engine or model view
sharing those tensors (`llama.with_config`, `quant.with_mode`) sees the
flip too.

KV isolation across the flip is namespace-based: the engine seeds every
prefix-cache hash chain with the active version (``Engine._kv_namespace``),
so v1 blocks never verify against v2 weights.
"""

from __future__ import annotations

import itertools
import logging
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

log = logging.getLogger("dynamo_tpu_torch.elasticity")

# the free device bytes the stage budget check uses, overriding what
# torch.cuda.mem_get_info reports (bytes); on the CPU the check is
# skipped unless this forces a limit (the stage-abort drills)
HEADROOM_ENV = "DYNAMO_TPU_ROLLOUT_HEADROOM_BYTES"

# fraction of the incoming tree's bytes demanded ON TOP of its own size
# before staging proceeds (allocator slack). Default 0.05.
MARGIN_ENV = "DYNAMO_TPU_ROLLOUT_HEADROOM_MARGIN"

BASE_VERSION = "v0"


class StageError(RuntimeError):
    """Staging refused or aborted; the live version is untouched."""


def _named_tensors(model) -> List[Tuple[str, torch.Tensor]]:
    """Every weight tensor of a model (parameters and QTensor buffers),
    tied ones listed under each name."""
    return list(itertools.chain(
        model.named_parameters(remove_duplicate=False),
        model.named_buffers(remove_duplicate=False)))


class _Tree:
    """A model's weights as the swap sees them: its distinct storages as
    byte tensors, in first-use order, and each named tensor's layout
    (shape, dtype, stride, offset and storage index), which must be equal
    for two trees to swap."""

    def __init__(self, model):
        self.model = model
        self.storages: List[torch.Tensor] = []
        self.layout: Dict[str, tuple] = {}
        index: Dict[int, int] = {}
        for name, t in _named_tensors(model):
            s = t.untyped_storage()
            key = s.data_ptr()
            if key not in index:
                index[key] = len(self.storages)
                self.storages.append(
                    torch.empty(0, dtype=torch.uint8,
                                device=t.device).set_(s))
            self.layout[name] = (tuple(t.shape), t.dtype, tuple(t.stride()),
                                 t.storage_offset(), index[key])

    @property
    def nbytes(self) -> int:
        return sum(s.numel() for s in self.storages)

    @property
    def largest(self) -> int:
        return max((s.numel() for s in self.storages), default=0)

    def mismatch(self, other: "_Tree") -> Optional[str]:
        """Why `other` cannot swap with this tree, or None."""
        missing = set(self.layout) - set(other.layout)
        extra = set(other.layout) - set(self.layout)
        if missing or extra:
            return (f"tree_mismatch: missing={sorted(missing)[:3]}, "
                    f"extra={sorted(extra)[:3]}")
        for name, lay in self.layout.items():
            if other.layout[name] != lay:
                return (f"leaf_mismatch: {name!r} is {other.layout[name]} "
                        f"against the live {lay}")
        if [s.numel() for s in self.storages] != \
                [s.numel() for s in other.storages]:
            return "leaf_mismatch: the storages differ in size"
        return None


class WeightManager:
    """Owns the engine's weight version label and the staging buffer.

    Thread model: ``stage``/``flip``/``rollback``/``commit`` are called
    from HTTP threads; everything that writes the live weights runs under
    ``engine._exec_lock`` (an RLock, so an armed flip applied from inside
    ``step()`` re-enters cleanly). ``self._lock`` guards the manager's own
    host-side bookkeeping against concurrent rollout requests.
    """

    def __init__(self, engine, version: str = BASE_VERSION):
        self.engine = engine
        self.version = version or BASE_VERSION
        self._lock = threading.Lock()
        # staged-but-not-flipped buffer: (version, _Tree)
        self._staged: Optional[tuple] = None  # guarded_by: _lock
        # previous version retained for rollback: (version, the staging
        # buffer's _Tree, which holds that version's bytes since the flip)
        self._previous: Optional[tuple] = None  # guarded_by: _lock
        # armed flip waiting for in-flight v1 streams to finish
        self._armed: Optional[str] = None  # guarded_by: _lock
        self.flips_total = 0
        self.rollbacks_total = 0
        self.stage_aborts_total = 0
        self.last_stage_s = 0.0
        self.last_swap_ms = 0.0  # the last flip's or rollback's swap

    # ------------------------------------------------------------ queries --

    @property
    def namespace(self) -> str:
        """KV-hash namespace component for the ACTIVE version. The base
        version maps to "" so a never-rolled engine hashes as before."""
        return "" if self.version == BASE_VERSION else self.version

    @property
    def admission_held(self) -> bool:
        """True while a ``finish``-mode flip is armed: new admissions wait
        in the pending queue so they land on the NEW version, while live
        v1 sequences run to completion."""
        return self._armed is not None

    @property
    def staged_version(self) -> Optional[str]:
        s = self._staged
        return s[0] if s else None

    @property
    def staged_nbytes(self) -> int:
        """Device bytes held by the staging buffer (the memory plane's
        double-buffer row)."""
        s = self._staged
        return s[1].nbytes if s else 0

    @property
    def previous_version(self) -> Optional[str]:
        p = self._previous
        return p[0] if p else None

    @property
    def previous_nbytes(self) -> int:
        p = self._previous
        return p[1].nbytes if p else 0

    def stats(self) -> dict:
        return {
            "version": self.version,
            "staged": self.staged_version,
            "staged_bytes": self.staged_nbytes,
            "previous": self.previous_version,
            "previous_bytes": self.previous_nbytes,
            "armed": self._armed,
            "flips_total": self.flips_total,
            "rollbacks_total": self.rollbacks_total,
            "stage_aborts_total": self.stage_aborts_total,
            "last_stage_s": round(self.last_stage_s, 3),
            "last_swap_ms": round(self.last_swap_ms, 3),
        }

    # ------------------------------------------------------------- budget --

    def _headroom_bytes(self) -> Optional[int]:
        """Free device bytes for the staging buffer, or None on the CPU
        when no override forces a figure."""
        env = os.environ.get(HEADROOM_ENV, "")
        if env:
            return int(env)
        dev = self.engine.device
        if dev.type != "cuda":
            return None
        free, _ = torch.cuda.mem_get_info(dev)
        return int(free)

    # -------------------------------------------------------------- stage --

    def stage(self, version: str, model_path: Optional[str] = None,
              seed: Optional[int] = None,
              quantization: Optional[str] = None) -> dict:
        """Load `version` onto the card beside the live weights while they
        keep serving. Raises StageError, with the live weights untouched
        and nothing staged, on version conflicts, a tree mismatch or
        insufficient headroom."""
        from dynamo_tpu_torch.models import loader, quant

        eng = self.engine
        cfg = eng.cfg
        t0 = time.monotonic()
        with self._lock:
            if not version:
                raise StageError("stage needs a non-empty version label")
            if version == self.version:
                raise StageError(f"version {version!r} is already live")
            if self._staged is not None:
                raise StageError(
                    f"a stage for {self._staged[0]!r} is already resident; "
                    "flip or abort it first")
            # staging claims the double buffer: the rollback window for
            # any PREVIOUS flip closes here (at most two trees resident)
            self._previous = None

        live = _Tree(eng.model)
        incoming = live.nbytes
        margin = float(os.environ.get(MARGIN_ENV, "0.05") or 0.05)
        need = int(incoming * (1.0 + margin)) + live.largest
        headroom = self._headroom_bytes()
        if headroom is not None and need > headroom:
            self._abort(version, "insufficient_hbm",
                        need=need, headroom=headroom)
            raise StageError(
                f"staging {version!r} needs {need} bytes ({incoming} tree "
                f"+ {margin:.0%} margin + a {live.largest}-byte swap "
                f"scratch) but the card reports {headroom} free: aborting "
                f"with the live version untouched")
        mode = quant.mode_name(quantization if quantization is not None
                               else cfg.quantization)
        try:
            with torch.inference_mode():
                model = loader.load_or_init(
                    eng.model_cfg,
                    model_path if model_path is not None else cfg.model_path,
                    seed=seed if seed is not None else cfg.seed,
                    quantization=mode, device=eng.device, dtype=eng.dtype)
        except Exception as e:
            self._abort(version, "load_failed", error=str(e))
            raise StageError(
                f"staging {version!r} failed while loading: {e}") from e
        staged = _Tree(model)
        why = live.mismatch(staged)
        if why is not None:
            del model, staged
            self._abort(version, why.split(":")[0])
            raise StageError(
                f"checkpoint for {version!r} does not match the live model "
                f"({why}): a hitless swap needs an identical tree")
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)
        self.last_stage_s = time.monotonic() - t0
        with self._lock:
            self._staged = (version, staged)
        eng.flight.note("rollout_staged", version=version,
                        bytes=incoming, seconds=round(self.last_stage_s, 3))
        log.info("staged weights %s: %.1f MiB in %.2fs (live %s untouched)",
                 version, incoming / 2**20, self.last_stage_s, self.version)
        return {"version": version, "bytes": incoming,
                "seconds": self.last_stage_s}

    def _abort(self, version: str, reason: str, **attrs) -> None:
        self.stage_aborts_total += 1
        self.engine.flight.note("rollout_stage_abort", version=version,
                                reason=reason, **attrs)
        log.warning("stage %s aborted (%s): live %s keeps serving",
                    version, reason, self.version)

    def restage_live(self) -> float:
        """Round-trip the LIVE weights through host memory back into their
        own storage, storage by storage through one pinned buffer: the
        engine-resurrection path (robustness/watchdog.py). The storage,
        and so every captured graph's address, stays; every byte crosses
        the bus both ways, so a device that cannot move the weights fails
        here and the resurrection quarantines. Caller holds
        ``engine._exec_lock``. Any retained rollback or staging buffer is
        dropped: it is device-resident and equally suspect. Returns the
        transfer seconds."""
        eng = self.engine
        t0 = time.monotonic()
        with self._lock:
            self._staged = None
            self._previous = None
            self._armed = None
        live = _Tree(eng.model)
        cuda = eng.device.type == "cuda"
        with torch.inference_mode():
            host = torch.empty(live.largest, dtype=torch.uint8,
                               pin_memory=cuda)
            for s in live.storages:
                n = s.numel()
                host[:n].copy_(s)
                s.copy_(host[:n])
            if cuda:
                torch.cuda.synchronize(eng.device)
        dt = time.monotonic() - t0
        eng.flight.note("restage_live", version=self.version,
                        seconds=round(dt, 3))
        log.info("restaged live weights %s through host memory in %.2fs",
                 self.version, dt)
        return dt

    def abort_stage(self) -> bool:
        """Drop a resident staging buffer without flipping."""
        with self._lock:
            if self._staged is None:
                return False
            version = self._staged[0]
            self._staged = None
            self._armed = None
        self._abort(version, "operator_abort")
        return True

    # --------------------------------------------------------------- flip --

    def flip(self, mode: str = "finish") -> dict:
        """Make the staged version live. With no in-flight sequences the
        contents swap immediately (under ``_exec_lock``, between steps).
        Otherwise:

        - ``finish``: arm the flip: admissions hold so new work queues for
          the new version, in-flight streams finish on the old one, and the
          scheduler applies the swap at the first step boundary with no
          live sequence (``maybe_flip_locked``).
        - ``now``: swap immediately anyway. The caller has already moved
          in-flight streams elsewhere (drain-handoff), so no live sequence
          crosses the flip.
        """
        if mode not in ("finish", "now"):
            raise ValueError(f"flip mode {mode!r} not in ('finish', 'now')")
        eng = self.engine
        with self._lock:
            if self._staged is None:
                raise StageError("no staged version to flip to")
            version = self._staged[0]
        with eng._exec_lock:
            if mode == "finish" and eng.seqs:
                with self._lock:
                    self._armed = version
                eng.flight.note("rollout_flip_armed", version=version,
                                live_seqs=len(eng.seqs))
                log.info("flip to %s armed: %d in-flight streams finish on "
                         "%s first (admissions held)",
                         version, len(eng.seqs), self.version)
                return {"version": version, "state": "armed",
                        "live_seqs": len(eng.seqs)}
            return self._flip_locked()

    def maybe_flip_locked(self) -> None:
        """Step-boundary hook (Engine._step_locked, under _exec_lock):
        apply an armed flip once the last old-version stream is done."""
        if self._armed is None:
            return
        if self.engine.seqs:
            return
        self._flip_locked()

    def _swap_locked(self, other: _Tree) -> float:
        """Swap the live weights' bytes with `other`'s, storage by storage
        through one scratch buffer of the largest storage; caller holds
        ``engine._exec_lock``. Any window dispatched before runs first on
        the stream. Returns the milliseconds until the card finished."""
        eng = self.engine
        live = _Tree(eng.model)
        cuda = eng.device.type == "cuda"
        t0 = time.monotonic()
        with torch.inference_mode():
            scratch = torch.empty(live.largest, dtype=torch.uint8,
                                  device=eng.device)
            for a, b in zip(live.storages, other.storages):
                n = a.numel()
                scratch[:n].copy_(a)
                a.copy_(b)
                b.copy_(scratch[:n])
            del scratch
            if cuda:
                torch.cuda.synchronize(eng.device)
        # the decode batch's device state is rebuilt from the host mirrors
        # before the next window (it holds no weights, but a fresh
        # version starts from a clean batch)
        eng._invalidate_dev()
        ms = (time.monotonic() - t0) * 1e3
        self.last_swap_ms = ms
        return ms

    def _flip_locked(self) -> dict:
        """The actual swap. Caller holds ``engine._exec_lock``."""
        eng = self.engine
        with self._lock:
            version, tree = self._staged
        ms = self._swap_locked(tree)
        with self._lock:
            old = self.version
            # the staging buffer now holds the old version's bytes
            self._previous = (old, tree)
            self.version = version
            self._staged = None
            self._armed = None
            self.flips_total += 1
        eng.flight.note("rollout_flip", version=version, previous=old,
                        swap_ms=round(ms, 3))
        log.info("weight flip: %s -> %s in %.1f ms (previous retained for "
                 "rollback)", old, version, ms)
        return {"version": version, "state": "live", "previous": old}

    # ----------------------------------------------------------- rollback --

    def rollback(self) -> dict:
        """Swap back to the retained previous version (the burn-gated
        fleet rollback path): the same swap as the flip."""
        eng = self.engine
        with eng._exec_lock:
            with self._lock:
                if self._previous is None:
                    raise StageError(
                        "no previous version resident (already committed "
                        "or never flipped)")
                version, tree = self._previous
            ms = self._swap_locked(tree)
            with self._lock:
                bad = self.version
                self.version = version
                self._previous = None
                self._staged = None
                self._armed = None
                self.rollbacks_total += 1
        eng.flight.note("rollout_rollback", version=version, rolled_back=bad,
                        swap_ms=round(ms, 3))
        log.warning("weight rollback: %s -> %s in %.1f ms", bad, version, ms)
        return {"version": version, "state": "rolled_back",
                "rolled_back": bad}

    def commit(self) -> dict:
        """Drop the retained previous version: frees the double buffer's
        device bytes and closes the rollback window."""
        with self._lock:
            dropped = self._previous[0] if self._previous else None
            self._previous = None
        if dropped is not None:
            self.engine.flight.note("rollout_commit", version=self.version,
                                    dropped=dropped)
            log.info("rollout committed at %s: dropped %s buffer",
                     self.version, dropped)
        return {"version": self.version, "dropped": dropped}
