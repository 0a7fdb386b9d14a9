"""OpenAI-compatible HTTP API over the port's engine.

Port of the serving core of `dynamo_tpu/serving/api.py`:
`GET /v1/models`, `/v1/models/{id}`, `/health`, `/ready`, `/live`,
`/worker/stats`; `POST /v1/chat/completions` and `/v1/completions`, each
streamed (SSE) or not, with `usage`, `n` choices, stop strings, logprobs,
auto and forced tool calls and `response_format` json_object (JSON-guided
decoding, on both routes); multi-LoRA model ids `<base>:<adapter>`, listed
by `/v1/models`, and `GET`/`POST /v1/adapters` to register, load, unload
and remove adapters. Request shaping is the copied `serving/protocol.py`,
so the wire format is the JAX worker's.

The observability plane is the JAX worker's: `GET /metrics` (Prometheus
text, or OpenMetrics with exemplars by `Accept`: the dynamo_frontend_*
request histograms observed here, the dynamo_engine_* phase, host-gap,
occupancy, spec and live MFU/MBU series, the dynamo_memory_* KV books and
device bytes, the cost counters, the SLO gauges, the LoRA counters),
request spans (`worker.request`, `worker.queue`, `worker.prefill`,
`worker.decode`) joined to an inbound `traceparent` or `x-request-id`,
and `GET /debug` with `/debug/spans`, `/debug/slo`, `/debug/flight`,
`/debug/timeline`, `/debug/costs` and `/debug/trace?duration_s=` (a
torch.profiler capture, CPU and CUDA, as a zip of its chrome trace).

The worker's lifecycle is the JAX worker's:
- `x-deadline`: the request's remaining budget (capped by
  DYNAMO_TPU_DEADLINE_S) bounds its stream; a spent one sheds with 504
  before it takes a slot.
- `GET`/`POST /internal/faults`: the fault plane (`robustness/faults.py`);
  the inference routes carry `worker.read_stall` and
  `worker.reset_after_headers`.
- The engine watchdog's health drives `/ready` and `/health` (503 unless
  healthy; `/live` stays 200) and sheds `/v1/*` with 503 while the engine
  is suspect, resurrecting or quarantined; a trip hands journaled streams
  off. The series `dynamo_engine_health`,
  `dynamo_engine_watchdog_trips_total` and
  `dynamo_engine_integrity_faults_total`.
- Drain: SIGTERM (the worker CLI) or `POST /internal/drain` sheds new
  `/v1/*` requests with 503 and Retry-After while in-flight streams
  finish or hand off; `POST /internal/reclaim` runs the same drain under a
  spot notice's deadline.
- `POST /internal/rollout`: stage, flip, rollback, commit, abort and
  status of a second weight version (`elasticity/weights.py`), with
  `dynamo_engine_weight_version` and `dynamo_memory_staged_weights_bytes`.
- The recovery journal (`serving/recovery.py`): a stream the frontend asks
  to journal (`x-recovery-journal`) carries `: dynr` comment frames, and a
  `dynamo_recovery` continuation resumes one on this worker byte for byte.

Per-tenant QoS is the JAX worker's: each inference request's tenant is
resolved from its headers (the frontend's `x-dynamo-tenant` trusted,
else `x-tenant-id`, an API key or a bearer token, against the engine's
`TenantRegistry`), rides into the engine's weighted-fair scheduler, and
is observed on `dynamo_tenant_requests_total` and the tenant TTFT and ITL
histograms; `/worker/stats` has `qos`, and the cost ledger prices the
batch class as its own tier.

The KVBM host tier is the JAX worker's: the `dynamo_kvbm_*` counters and
`dynamo_kvbm_host_blocks`, `kvbm` in `/worker/stats`, the `kvbm.offload`
and `kvbm.onboard` spans and the drain's demote of every sole-owned
prefix page (`drain_demote`).

Not ported yet: disaggregation, the KVBM's cross-worker pull (its
`HostTierSource` needs the transfer plane), and the KV event plane's
wiring to NATS (the frontend tier's; `Engine.set_kv_event_sink` attaches
a `kvbm/events.py` publisher meanwhile).
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
import urllib.parse
from typing import Any, Dict, List, Optional

from dynamo_tpu_torch.engine.engine import Engine
from dynamo_tpu_torch.engine.kv_cache import OutOfPages
from dynamo_tpu_torch.engine.request import GenRequest
from dynamo_tpu_torch.engine.tokenizer import get_tokenizer
from dynamo_tpu_torch.lora.registry import NoFreeAdapterSlot
from dynamo_tpu_torch.observability import context as obs_context
from dynamo_tpu_torch.observability import slo as obs_slo
from dynamo_tpu_torch.observability import tracing as obs_tracing
from dynamo_tpu_torch.observability.engine_metrics import (
    attach_engine_metrics)
from dynamo_tpu_torch.observability.flight import debug_flight_payload
from dynamo_tpu_torch.observability.memory import attach_memory_metrics
from dynamo_tpu_torch.observability.timeline import timeline_debug_payload
from dynamo_tpu_torch.robustness import faults
from dynamo_tpu_torch.robustness.deadline import Deadline
from dynamo_tpu_torch.robustness.watchdog import HEALTH_CODES, PROFILER_TAIL_S
from dynamo_tpu_torch.serving import protocol as proto
from dynamo_tpu_torch.serving import recovery
from dynamo_tpu_torch.serving.engine_service import EngineService
from dynamo_tpu_torch.serving.http_base import (JsonHTTPHandler,
                                                 make_http_server)
from dynamo_tpu_torch.serving.metrics import (CallbackCounter,
                                               CallbackCounterVec, Counter,
                                               FrontendMetrics, Gauge)

log = logging.getLogger("dynamo_tpu_torch.api")


class TraceBusy(RuntimeError):
    """A profiler capture is already in progress on this worker."""


# one-line descriptions behind GET /debug: the worker's debug surface
WORKER_DEBUG_INDEX = {
    "/debug/spans": "recent request/engine spans (?trace_id=&n=)",
    "/debug/slo": "SLO attainment windows and violation breakdown",
    "/debug/flight": "engine flight recorder: per-step records with "
                     "batch composition, decisions, phase timings "
                     "(?n=&rid=&tenant=&kind=)",
    "/debug/costs": "per-tenant chip-seconds and HBM byte-seconds "
                    "attributed by the engine cost ledger",
    "/debug/timeline": "engine step timeline: exact phase intervals, "
                       "host-gap/bubble attribution "
                       "(?steps=&format=perfetto|summary|json&trace_id=)",
    "/debug/trace": "capture a torch.profiler trace (CPU and CUDA) as a "
                    "zip of its chrome trace (?duration_s=; 409 while "
                    "another capture runs)",
}


class IncrementalDetokenizer:
    """Streaming detokenization with bounded re-decode: each push decodes
    only the tokens since the last emitted boundary, holding back trailing
    bytes that don't yet form complete UTF-8."""

    def __init__(self, tokenizer):
        self.tok = tokenizer
        self.ids: List[int] = []
        self.prefix_offset = 0
        self.read_offset = 0

    def push(self, token_id: int) -> str:
        self.ids.append(token_id)
        prefix_text = self.tok.decode(
            self.ids[self.prefix_offset:self.read_offset])
        new_text = self.tok.decode(self.ids[self.prefix_offset:])
        if new_text.endswith("�"):
            return ""
        delta = new_text[len(prefix_text):]
        self.prefix_offset = self.read_offset
        self.read_offset = len(self.ids)
        return delta


class StopStringMatcher:
    """Holds back the longest possible partial stop-string match so a stop
    string split across tokens never reaches the client, and truncates the
    output at the match."""

    def __init__(self, stops: List[str]):
        self.stops = stops
        self.hold = max((len(s) for s in stops), default=1) - 1
        self.buf = ""
        self.stopped = False

    def push(self, delta: str) -> tuple:
        """Returns (text_to_emit, stopped)."""
        if self.stopped:
            return "", True
        self.buf += delta
        hits = [i for i in (self.buf.find(s) for s in self.stops) if i >= 0]
        if hits:
            self.stopped = True
            emit, self.buf = self.buf[:min(hits)], ""
            return emit, True
        if self.hold <= 0:
            emit, self.buf = self.buf, ""
            return emit, False
        if len(self.buf) <= self.hold:
            return "", False
        cut = len(self.buf) - self.hold
        emit, self.buf = self.buf[:cut], self.buf[cut:]
        return emit, False

    def flush(self) -> str:
        emit, self.buf = self.buf, ""
        return emit


class GenerationHandle:
    """A submitted request plus its event stream: submission (and its
    validation errors) happens strictly before any response bytes."""

    def __init__(self, ctx: "ServingContext", rid: str, prompt_ids: List[int],
                 params: dict, index: int = 0, trace_span=None,
                 deadline: Optional[Deadline] = None):
        self.ctx = ctx
        self.rid = rid
        self.index = index
        self.span = (trace_span if trace_span is not None
                     else obs_tracing.NOOP_SPAN)
        self.deadline = deadline
        self.stops: List[str] = params.get("stop") or []
        self.want_logprobs = params.get("logprobs") is not None
        # a recovery continuation (serving/recovery.py): the tokens the
        # original worker already emitted become extra prefill (prompt +
        # emitted) with the remaining budget; prior_output_token_ids keeps
        # penalties and the grammar honest and resume_key restores the
        # sampling chain, as a preemption by recompute does
        self.journal_sink = None  # set by the handler on journaled streams
        rec = params.get("_recovery") if index == 0 else None
        self.recovery = rec
        prior = list(rec["prior_tokens"]) if rec else []
        self.prior_count = len(prior)
        max_tokens = params["max_tokens"]
        if prior:
            prompt_ids = list(prompt_ids) + prior
            max_tokens = max(1, max_tokens - len(prior))
        self.prompt_ids = prompt_ids
        seed = params.get("seed")
        self.req = GenRequest(
            rid, list(prompt_ids),
            max_tokens=max_tokens,
            temperature=params["temperature"],
            top_p=params["top_p"],
            top_k=params["top_k"],
            presence_penalty=params.get("presence_penalty", 0.0),
            frequency_penalty=params.get("frequency_penalty", 0.0),
            min_p=params.get("min_p", 0.0),
            logit_bias=params.get("logit_bias"),
            # each choice of an n>1 request gets its own chain
            seed=None if seed is None else seed + index,
            logprobs=params.get("logprobs"),
            ignore_eos=params.get("ignore_eos", False),
            priority=params.get("priority", 0),
            guided_json=params.get("guided_json", False),
            stop_token_ids=list(params.get("stop_token_ids") or []),
            prior_output_token_ids=prior,
            resume_key=(rec or {}).get("resume_key"),
            adapter=params.get("adapter"),
            # per-tenant QoS: the identity the handler resolved from the
            # request headers rides into the engine's weighted-fair
            # scheduler (and across preemption/recovery continuations)
            tenant=params.get("tenant"),
        )
        self.tenant = self.req.tenant or "default"
        ctx.metrics.tenant_requests.inc(tenant=self.tenant)
        if self.req.adapter and ctx.lora_requests_total is not None:
            ctx.lora_requests_total.inc(adapter=self.req.adapter)
            ctx.engine.lora.note_request(self.req.adapter)
        self.queue = ctx.service.submit(self.req)  # raises ValueError early
        ctx.metrics.requests_total.inc(model=ctx.served_model)
        ctx.metrics.isl.observe(len(prompt_ids), model=ctx.served_model)
        self.lp_entries: List[dict] = []

    def _lp_entry(self, ev) -> Optional[dict]:
        if not (self.want_logprobs and ev.logprob is not None):
            return None
        tok = self.ctx.tokenizer
        return proto.chat_logprob_entry(
            tok.decode([ev.token_id]), ev.logprob,
            [(tok.decode([tid]), lp) for tid, lp in (ev.top_logprobs or [])])

    def _first_token_spans(self, ev, ttft_s: float):
        """The engine's per-request phase timings (TokenEvent.phase, from
        the prefill paths that feed the phase timers) as back-dated
        worker.queue and worker.prefill child spans, then the
        worker.decode span; the engine's prefill quantiles ride as
        attributes, the context a slow trace is judged against."""
        if not self.span.recording:
            return None
        tracer = self.ctx.tracer
        eng = self.ctx.engine
        if self.req.adapter and eng.lora is not None:
            self.span.set_attributes({
                "lora.adapter": self.req.adapter,
                "lora.slot": eng.lora.slot_of(self.req.adapter) or 0,
            })
        eng_ph = eng.metrics.phases
        t_first_ns = time.time_ns()
        phase = ev.phase or {}
        queue_ns = int(phase.get("queue_s", 0.0) * 1e9)
        prefill_ns = int(phase.get("prefill_s", 0.0) * 1e9)
        pf_start_ns = t_first_ns - prefill_ns
        if queue_ns or prefill_ns:
            tracer.start_span(
                "worker.queue", parent=self.span,
                start_ns=pf_start_ns - queue_ns).end(end_ns=pf_start_ns)
            tracer.start_span(
                "worker.prefill", parent=self.span, start_ns=pf_start_ns,
                attributes={
                    "prompt_tokens": len(self.prompt_ids),
                    "engine.prefill.p50_ms":
                        round(eng_ph["prefill"].quantile_ms(0.5), 3),
                    "engine.prefill.p95_ms":
                        round(eng_ph["prefill"].quantile_ms(0.95), 3),
                }).end(end_ns=t_first_ns)
        return tracer.start_span(
            "worker.decode", parent=self.span, start_ns=t_first_ns,
            attributes={"ttft_s": round(ttft_s, 6)})

    def run(self, emit) -> tuple:
        """Drive the stream; emit(delta, finish|None, lp_entry|None) -> bool
        keeps going while True (False = client gone: abort). Observes TTFT,
        ITL (each with the request's trace id as its exemplar), duration
        and OSL. Returns (text, finish_reason, completion_tokens)."""
        ctx, m = self.ctx, self.ctx.metrics
        model = ctx.served_model
        t0 = time.monotonic()
        t_prev: Optional[float] = None
        decode_span = None
        detok = IncrementalDetokenizer(ctx.tokenizer)
        matcher = StopStringMatcher(self.stops) if self.stops else None
        text_parts: List[str] = []
        n_out = 0
        finish = "stop"
        # the recovery journal's books (serving/recovery.py)
        consumed = self.prior_count  # tokens the journal covers
        content_total = 0  # cumulative content chars (primed text too)
        pending_journal: List[int] = []  # tokens since the last checkpoint

        def checkpoint(extra: Optional[dict] = None) -> None:
            """A journal checkpoint, written BEFORE the delta it covers:
            the journal may run ahead of delivery, never behind (the
            exactly-once seam)."""
            nonlocal pending_journal
            entry = {"n": consumed, "c": content_total, "t": pending_journal}
            if extra:
                entry.update(extra)
            pending_journal = []
            self.journal_sink(entry)

        if self.recovery is not None:
            # continuation: replay the journaled tokens through a fresh
            # detok/matcher pipeline (deterministic, so byte-identical to
            # what the original worker delivered) and emit exactly the
            # chars past delivered_chars
            primed_parts: List[str] = []
            stopped_in_prior = False
            for t in self.recovery["prior_tokens"]:
                d = detok.push(t)
                if matcher is not None and not stopped_in_prior:
                    d, stopped_in_prior = matcher.push(d)
                primed_parts.append(d)
            primed = "".join(primed_parts)
            content_total = len(primed)
            catch_up = primed[self.recovery["delivered_chars"]:]
            if self.journal_sink is not None:
                checkpoint()
            if stopped_in_prior:
                # the stop string had fully arrived before the original
                # stream died: nothing is left to generate
                text_parts.append(catch_up)
                emit(catch_up, "stop", None)
                ctx.service.abort(self.rid)
                m.duration.observe(time.monotonic() - t0, model=model)
                m.osl.observe(0, model=model)
                return catch_up, "stop", 0
            if catch_up:
                text_parts.append(catch_up)
                emit(catch_up, None, None)
        # the drain timeout is the request's REMAINING deadline budget
        drain_timeout = (self.deadline.remaining()
                         if self.deadline is not None else None)
        for ev in ctx.service.drain(self.req, self.queue,
                                    timeout=drain_timeout):
            if (self.journal_sink is not None and not ev.finished
                    and ctx.drain_handoff.is_set()):
                # drain or watchdog handoff: snapshot the sampling chain,
                # push the journal tail to the frontend as the final
                # comment and abort; the frontend splices a continuation
                # onto the same client stream elsewhere
                st = ctx.service.sampling_state(self.rid)
                checkpoint({"handoff": 1,
                            **({"key": st["key"]} if st else {})})
                ctx.service.abort(self.rid)
                finish = "handoff"
                break
            if ev.token_id < 0 and not ev.finished:
                continue  # a nudge (EngineService.nudge_all)
            now = time.monotonic()
            # exemplar: the request's trace id rides the latency buckets,
            # so a p99 bucket resolves at /debug/spans?trace_id=...
            ex = self.span.trace_id if self.span.recording else None
            if t_prev is None:
                m.ttft.observe(now - t0, exemplar=ex, model=model)
                m.tenant_ttft.observe(now - t0, tenant=self.tenant)
                decode_span = self._first_token_spans(ev, now - t0)
            else:
                m.itl.observe(now - t_prev, exemplar=ex, model=model)
                m.tenant_itl.observe(now - t_prev, tenant=self.tenant)
            t_prev = now
            delta, lp_entry = "", None
            if ev.token_id >= 0:
                n_out += 1
                consumed += 1
                pending_journal.append(ev.token_id)
                # the finishing stop TOKEN is not content (the byte
                # tokenizer would leak a stop id < 256 as a control byte)
                if not (ev.finished and ev.finish_reason == "stop"):
                    delta = detok.push(ev.token_id)
                    lp_entry = self._lp_entry(ev)
            stopped = False
            if matcher is not None and (delta or ev.finished):
                delta, stopped = matcher.push(delta)
                if not stopped and ev.finished:
                    delta += matcher.flush()
            if stopped:
                text_parts.append(delta)
                if self.journal_sink is not None and pending_journal:
                    content_total += len(delta)
                    checkpoint()
                emit(delta, "stop", None)
                if not ev.finished:
                    ctx.service.abort(self.rid)
                finish = "stop"
                break
            if lp_entry is not None:
                self.lp_entries.append(lp_entry)
            fr = proto.map_finish_reason(ev.finish_reason) if ev.finished \
                else None
            if ev.finished:
                finish = fr or "stop"
            text_parts.append(delta)
            if self.journal_sink is not None and pending_journal:
                # checkpoint EVERY consumed token, content or not: a held
                # back one is still state a continuation must not redraw
                content_total += len(delta)
                checkpoint()
            if delta or ev.finished or lp_entry is not None:
                if not emit(delta, fr, lp_entry) and not ev.finished:
                    log.info("client disconnected; aborting %s", self.rid)
                    ctx.service.abort(self.rid)
                    finish = "abort"
                    break
        dur = time.monotonic() - t0
        m.duration.observe(
            dur, exemplar=(self.span.trace_id if self.span.recording
                           else None), model=model)
        m.osl.observe(n_out, model=model)
        ctx.kv_gauge.set(ctx.engine.allocator.free_pages)
        if decode_span is not None:
            eng_ph = ctx.engine.metrics.phases
            decode_span.set_attributes({
                "completion_tokens": n_out,
                "finish_reason": finish,
                "engine.decode_step.p50_ms":
                    round(eng_ph["decode_step"].quantile_ms(0.5), 3),
                "engine.decode_step.p95_ms":
                    round(eng_ph["decode_step"].quantile_ms(0.95), 3),
            })
            decode_span.end()
        if (self.span.recording
                and dur >= obs_tracing.slow_request_threshold_s()):
            log.warning(
                "slow request %s: %.2fs model=%s trace_id=%s: "
                "GET /debug/spans?trace_id=%s", self.rid, dur, model,
                self.span.trace_id, self.span.trace_id)
        return "".join(text_parts), finish, n_out


# spot reclamation: the drain deadline of a /internal/reclaim notice that
# names none (cloud maintenance notices are typically 30-120 s)
RECLAIM_DEADLINE_ENV = "DYNAMO_TPU_RECLAIM_DEADLINE_S"
DEFAULT_RECLAIM_DEADLINE_S = 60.0

# hitless weight rollout: how /internal/rollout flips a busy engine when
# the request names no mode: `finish` arms the flip (in-flight streams
# complete on the old version, admissions hold), `handoff` pushes
# journaled streams to the frontend for a peer still on the old version
# and flips once the engine empties (bounded by the grace below, then an
# armed finish flip for the stragglers)
ROLLOUT_DRAIN_MODE_ENV = "DYNAMO_TPU_ROLLOUT_DRAIN_MODE"
ROLLOUT_HANDOFF_GRACE_S = 5.0


def _env_reclaim_deadline_s() -> float:
    try:
        return max(1.0, float(os.environ.get(RECLAIM_DEADLINE_ENV,
                                             DEFAULT_RECLAIM_DEADLINE_S)))
    except ValueError:
        return DEFAULT_RECLAIM_DEADLINE_S


class ServingContext:
    """Everything the request handlers need, bundled for the handler."""

    def __init__(self, engine: Engine, served_model: str):
        self.engine = engine
        self.service = EngineService(engine)
        self.served_model = served_model
        self.tokenizer = get_tokenizer(engine.cfg.model, engine.cfg.model_path)
        self.metrics = FrontendMetrics()
        r = self.metrics.registry
        # per-tenant QoS identity: the engine built the registry from
        # cfg.tenants / DYNAMO_TPU_TENANTS; handlers resolve every
        # inference request's tenant against the same classes the
        # weighted-fair scheduler budgets with
        self.tenants = engine.tenant_registry
        self.kv_gauge = Gauge(
            "dynamo_worker_kv_free_pages", "Free KV pages", r)
        # multi-LoRA adapter serving
        self.lora_requests_total = None
        self.lora_loaded_gauge = None
        if engine.lora is not None:
            self.lora_requests_total = Counter(
                "dynamo_lora_requests_total",
                "Requests served under a LoRA adapter, by adapter", r,
                labelnames=("adapter",))
            CallbackCounter(
                "dynamo_lora_swaps_total",
                "Adapter loads into a device slot (incl. LRU swap reloads)",
                r, lambda: engine.lora.swaps_total)
            self.lora_loaded_gauge = Gauge(
                "dynamo_lora_loaded",
                "Adapters resident in device slots right now", r)
        # the KVBM tiered block manager: its counters and the host pool's
        # occupancy
        self.kvbm_blocks_gauge = None
        kvbm = engine.kvbm
        if kvbm is not None:
            for name, help_, attr in (
                ("dynamo_kvbm_host_hits_total",
                 "Prefix lookups served from the KVBM host/disk tier",
                 "host_hits_total"),
                ("dynamo_kvbm_host_misses_total",
                 "Prefix lookup tails the KVBM tiers could not serve",
                 "host_misses_total"),
                ("dynamo_kvbm_demoted_blocks_total",
                 "KV blocks demoted from device to the host tier",
                 "demoted_blocks_total"),
                ("dynamo_kvbm_onboarded_blocks_total",
                 "KV blocks onboarded back onto the device",
                 "onboarded_blocks_total"),
                ("dynamo_kvbm_peer_onboarded_blocks_total",
                 "KV blocks onboarded from a peer worker's host tier",
                 "peer_onboarded_blocks_total"),
                ("dynamo_kvbm_removed_blocks_total",
                 "KV blocks dropped from every tier",
                 "removed_blocks_total"),
                ("dynamo_kvbm_gate_recompute_total",
                 "Onboards skipped because recompute beat restore",
                 "gate_recompute_total"),
            ):
                CallbackCounter(name, help_, r,
                                (lambda k=kvbm, a=attr: getattr(k, a)))
            self.kvbm_blocks_gauge = Gauge(
                "dynamo_kvbm_host_blocks",
                "KVBM host-pool occupancy by state", r,
                labelnames=("state",))
        self.preempt_gauge = Gauge(
            "dynamo_worker_preempted_sequences",
            "Sequences preempted (recompute) under KV page pressure", r)
        self.start_time = time.time()
        self._trace_lock = threading.Lock()  # one profiler capture at a time
        # request spans land in the process-wide ring behind /debug/spans
        self.tracer = obs_tracing.Tracer("worker-agg")
        if kvbm is not None:
            # kvbm.offload / kvbm.onboard spans land in this worker's ring
            # buffer (GET /debug/spans) like every other worker span
            kvbm.tracer = self.tracer
        # SLO burn rates from this worker's own latency histograms
        self.slo = obs_slo.SLOEngine(self.metrics, role="agg")
        # the engine's phase, host-gap, occupancy, spec and live MFU/MBU
        # series, and the KV books, device memory and cost counters
        self.engine_bridge = attach_engine_metrics(r, engine)
        self.memory_bridge = attach_memory_metrics(r, engine)
        CallbackCounter(
            "dynamo_spans_dropped_total",
            "Finished spans evicted from the ring buffer before any "
            "scrape could lift them (size: DYNAMO_TPU_TRACE_BUFFER)", r,
            lambda: self.tracer.collector.dropped_total)
        # the engine watchdog: its health drives readiness and the /v1
        # shed gate; a trip hands journaled streams off like a pre-drain
        wd = engine.watchdog
        self.health_gauge = Gauge(
            "dynamo_engine_health",
            "Engine health state machine: 0=healthy 1=suspect "
            "2=resurrecting 3=quarantined", r)
        self.health_gauge.set(wd.health_code)
        CallbackCounterVec(
            "dynamo_engine_watchdog_trips_total",
            "Watchdog trips by kind (hung_dispatch, fatal_step)", r,
            lambda: {(("kind", k),): v
                     for k, v in wd.summary()["trips_total"].items()},
            labelnames=("kind",))
        CallbackCounterVec(
            "dynamo_engine_integrity_faults_total",
            "Integrity sentinel trips by sentinel "
            "(logits, decode_tokens, kv_checksum)",
            r, lambda: {(("sentinel", s),): v for s, v in
                        wd.summary()["integrity_faults_total"].items()},
            labelnames=("sentinel",))
        wd.on_trip = self._on_watchdog_trip
        wd.on_health = self._on_engine_health
        # live elasticity: the active weight version as a labelled gauge
        # (1 on the live label), refreshed at scrape with label death so
        # a flip or rollback never leaves a stale version row
        self.weight_version_gauge = Gauge(
            "dynamo_engine_weight_version",
            "Active weight version (1 on the live `version` label; the "
            "staged/rollback buffers show in "
            "dynamo_memory_staged_weights_bytes)", r,
            labelnames=("version",))
        self._exported_weight_version: Optional[str] = None
        # graceful drain (SIGTERM): draining sheds NEW inference requests
        # with 503; drain_handoff makes journaled in-flight streams push
        # their journal to the frontend and abort
        self.draining = threading.Event()
        self.drain_handoff = threading.Event()
        # spot reclamation: a /internal/reclaim notice runs the drain
        # under a hard deadline; reclaim_cb (set by the worker CLI) also
        # deregisters and stops the server
        self.reclaiming = threading.Event()
        self.reclaim_done = threading.Event()
        self.reclaim_deadline_s: Optional[float] = None
        self.reclaim_cb = None  # (deadline_s) -> None
        # the operator's `preemptible: true` (a spot pool), advertised in
        # the heartbeat
        self.preemptible = os.environ.get(
            "DYNAMO_TPU_PREEMPTIBLE", "0").lower() not in ("", "0", "false")

    def close(self) -> None:
        self.service.close()

    def scrape(self, accept: Optional[str]):
        """The /metrics page: the scrape-time gauges refreshed, then the
        registry exposed as the client's Accept asks. Counters are read
        lock-free from the scheduler thread's books; the memory snapshot
        reads the allocator's host-side books and never the device."""
        eng = self.engine
        self.preempt_gauge.set(eng.metrics.num_preempted)
        self.kv_gauge.set(eng.allocator.free_pages)
        if self.lora_loaded_gauge is not None:
            self.lora_loaded_gauge.set(len(eng.lora.resident()))
        if self.kvbm_blocks_gauge is not None:
            pool = eng.kvbm.pool.stats()
            self.kvbm_blocks_gauge.set(pool["used_blocks"], state="used")
            self.kvbm_blocks_gauge.set(pool["capacity_blocks"],
                                       state="capacity")
        self.slo.refresh_gauges()
        self.engine_bridge.refresh()  # live MFU/MBU + warmup gauges
        self.memory_bridge.refresh()  # KV pool / device / cost books
        self.refresh_weight_gauge()  # the active weight version's label
        self.health_gauge.set(eng.watchdog.health_code)
        return self.metrics.registry.scrape(accept)

    def refresh_weight_gauge(self) -> None:
        v = self.engine.weights.version
        prev = self._exported_weight_version
        if prev is not None and prev != v:
            self.weight_version_gauge.remove(version=prev)
        self.weight_version_gauge.set(1, version=v)
        self._exported_weight_version = v

    def capture_trace(self, duration_s: float) -> bytes:
        """Capture torch.profiler (CPU and CUDA activities) for
        `duration_s` and return its chrome trace as a zip. One capture at
        a time: a second one raises TraceBusy (the route answers 409)
        instead of waiting. The window opens once the profiler has
        started: the first start in a process takes seconds (CUPTI's
        initialization). The profiler starts and stops between two engine
        steps (`Engine.between_steps`), so the scheduler waits out both;
        the steps in the window run as they would."""
        if not self._trace_lock.acquire(blocking=False):
            raise TraceBusy("a profiler capture is already running")
        try:
            # CUPTI's start and the windows after it run seconds long: no
            # watchdog seam arms during the capture or for a tail after it
            with self.engine.watchdog.exempt("profiler",
                                             tail_s=PROFILER_TAIL_S):
                return self._capture(duration_s)
        finally:
            self._trace_lock.release()

    def _capture(self, duration_s: float) -> bytes:
        import io
        import os
        import tempfile
        import zipfile

        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.engine.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with tempfile.TemporaryDirectory(prefix="dtt-trace-") as d:
            prof = profile(activities=activities)
            with self.engine.between_steps():
                prof.start()
            try:
                time.sleep(min(max(duration_s, 0.05), 30.0))
            finally:
                with self.engine.between_steps():
                    prof.stop()
            path = os.path.join(d, "trace.json")
            prof.export_chrome_trace(path)
            buf = io.BytesIO()
            with zipfile.ZipFile(buf, "w", zipfile.ZIP_DEFLATED) as z:
                z.write(path, "trace.json")
            return buf.getvalue()

    # ------------------------------------------------- drain and lifecycle

    def begin_drain(self) -> None:
        """Stop admission NOW: new /v1 requests shed 503 (+ Retry-After)
        so a retrying client or the frontend's failover lands them on
        another replica. In-flight requests run until they finish or hand
        off."""
        self.draining.set()

    def _on_watchdog_trip(self, kind: str, seam: str) -> None:
        """Watchdog trip (monitor or scheduler thread): hand journaled
        in-flight streams off to a peer exactly like a pre-drain. The
        nudge matters: a wedged engine emits no TokenEvents, so blocked
        handlers would never see drain_handoff without it."""
        self.request_handoff()
        self.service.nudge_all()

    def _on_engine_health(self, state: str) -> None:
        self.health_gauge.set(HEALTH_CODES.get(state, 0))
        if state == "healthy" and not self.draining.is_set():
            # resurrection done: stop asking streams to hand off, but
            # never un-drain a worker draining for its own reasons
            self.drain_handoff.clear()

    def request_handoff(self) -> None:
        """Ask journaled in-flight streams to hand off: each pushes its
        journal tail (token seam and sampling-key snapshot) to the
        frontend as the final stream comment and aborts; the frontend
        splices a continuation on another worker. Streams that are not
        journaled finish or time out under the drain bound."""
        self.drain_handoff.set()

    def drain_demote(self) -> int:
        """Demote every sole-owned prefix-cache page to the KVBM host tier
        (one batched device gather), so the departing worker's prefixes
        stay in host memory for their `demoted` events' readers. No-op
        without a KVBM tier. Returns pages demoted."""
        eng = self.engine
        if eng.prefix_cache is None or eng.kvbm is None:
            return 0
        with eng._exec_lock:
            return eng.kvbm.demote_all(eng.prefix_cache)

    def drain(self, drain_s: float = 30.0,
              handoff_grace_s: float = 5.0) -> bool:
        """The drain state machine (worker SIGTERM, reclaim, tests):
        draining -> (grace: finish naturally) -> handoff -> quiesce ->
        demote. Returns True when the engine emptied within the budget."""
        eng = self.engine
        self.begin_drain()
        t0 = time.monotonic()
        deadline = t0 + max(0.0, drain_s)
        grace_end = min(deadline, t0 + max(0.0, handoff_grace_s))
        while time.monotonic() < grace_end and (eng.num_active
                                                or eng.pending):
            time.sleep(0.05)
        if eng.num_active or eng.pending:
            self.request_handoff()
            self.service.nudge_all()
        while time.monotonic() < deadline and (eng.num_active
                                               or eng.pending):
            time.sleep(0.1)
        demoted = self.drain_demote()
        if demoted:
            log.info("drain: demoted %d prefix pages", demoted)
        return not (eng.num_active or eng.pending)

    def reclaim(self, deadline_s: float) -> Dict[str, Any]:
        """Spot/maintenance reclamation notice: this worker's capacity
        disappears in `deadline_s` seconds, hard. Runs the drain state
        machine with the deadline as its bound (the natural-finish grace
        is at most a quarter of the notice), and the worker CLI's
        reclaim_cb (when wired) deregisters and stops the server.
        Idempotent: a second notice reports the drain in progress."""
        eng = self.engine
        first = not self.reclaiming.is_set()
        if first:
            self.reclaiming.set()
            self.reclaim_deadline_s = deadline_s
            eng.flight.note(
                "reclaim", deadline_s=round(deadline_s, 3),
                active=eng.num_active, pending=len(eng.pending))
            log.warning("reclamation notice: %.1fs to drain %d active / "
                        "%d pending", deadline_s, eng.num_active,
                        len(eng.pending))
            self.begin_drain()
            cb = self.reclaim_cb

            def _run():
                try:
                    if cb is not None:
                        cb(deadline_s)
                    else:
                        self.drain(drain_s=deadline_s,
                                   handoff_grace_s=min(5.0,
                                                       deadline_s / 4.0))
                finally:
                    self.reclaim_done.set()

            threading.Thread(target=_run, daemon=True,
                             name="reclaim").start()
        return {"reclaiming": True, "first_notice": first,
                "deadline_s": self.reclaim_deadline_s,
                "active_seqs": eng.num_active,
                "pending": len(eng.pending)}

    def rollout(self, body: Dict[str, Any]) -> Dict[str, Any]:
        """POST /internal/rollout: the per-pod weight swap surface the
        operator's progressive rollout drives (one action per request;
        `stage_flip` is the controller's single round trip). StageError
        maps to the handler's RuntimeError -> 503 path, so a refused stage
        is retry-later and never touches the live weights."""
        eng = self.engine
        wm = eng.weights
        action = (body.get("action") or "status").lower()
        if action == "status":
            out = wm.stats()
            out.update(active_seqs=eng.num_active,
                       pending=len(eng.pending))
            return out
        if action == "stage":
            return wm.stage(
                body.get("version") or "",
                model_path=body.get("model_path"),
                seed=body.get("seed"),
                quantization=body.get("quantization"))
        if action in ("flip", "stage_flip"):
            if action == "stage_flip":
                want = body.get("version") or ""
                if want and want == wm.version:
                    # idempotent: a controller retry after a timed-out
                    # round trip lands on an already-flipped pod
                    return {"version": wm.version, "state": "live",
                            "already": True}
                if wm.staged_version != want:
                    wm.stage(
                        want,
                        model_path=body.get("model_path"),
                        seed=body.get("seed"),
                        quantization=body.get("quantization"))
            mode = (body.get("mode")
                    or os.environ.get(ROLLOUT_DRAIN_MODE_ENV, "finish")
                    or "finish").lower()
            if mode not in ("finish", "handoff"):
                raise proto.BadRequest(
                    f"mode {mode!r} not in ('finish', 'handoff')")
            if mode == "handoff" and eng.num_active:
                return self._flip_with_handoff(wm)
            return wm.flip(mode="finish")
        if action == "rollback":
            if wm.previous_version is None and wm.staged_version:
                # never flipped (staged, or a flip armed): dropping the
                # staged weights IS the rollback
                wm.abort_stage()
                return {"version": wm.version, "state": "rolled_back",
                        "rolled_back": None}
            return wm.rollback()
        if action == "commit":
            return wm.commit()
        if action == "abort":
            return {"aborted": wm.abort_stage(), "version": wm.version}
        raise proto.BadRequest(
            f"action {action!r} not in (status, stage, flip, stage_flip, "
            "rollback, commit, abort)")

    def _flip_with_handoff(self, wm) -> Dict[str, Any]:
        """Handoff-mode flip: journaled in-flight streams push their seams
        to the frontend (resumed on a peer still on the old version) and
        the weights flip the moment the engine empties. The worker STAYS
        in service: admission never closes."""
        eng = self.engine
        self.drain_handoff.set()
        self.service.nudge_all()
        deadline = time.monotonic() + ROLLOUT_HANDOFF_GRACE_S
        try:
            while time.monotonic() < deadline and eng.num_active:
                time.sleep(0.05)
        finally:
            self.drain_handoff.clear()
        if eng.num_active:
            # streams that are not journaled: never flip under them
            eng.flight.note("rollout_handoff_stragglers",
                            active=eng.num_active)
            return wm.flip(mode="finish")
        return wm.flip(mode="now")

    def start_choices(self, rid, prompt_ids, params, trace_span=None,
                      deadline=None) -> List[GenerationHandle]:
        """Submit all n choices (choice i streams as '<rid>-i');
        all-or-nothing: a rejection aborts the choices already submitted."""
        n = params.get("n", 1)
        handles: List[GenerationHandle] = []
        try:
            for i in range(n):
                handles.append(GenerationHandle(
                    self, f"{rid}-{i}" if n > 1 else rid, prompt_ids, params,
                    index=i, trace_span=trace_span, deadline=deadline))
        except Exception:
            for h in handles:
                self.service.abort(h.rid)
            raise
        return handles


def run_choices(handles: List[GenerationHandle], emit_for) -> List[tuple]:
    """Drive n choice streams concurrently; emit_for(handle) returns that
    choice's (thread-safe) emit callback. The first failure propagates
    after every thread settled."""
    if len(handles) == 1:
        return [handles[0].run(emit_for(handles[0]))]
    results: List[Optional[tuple]] = [None] * len(handles)
    errors: List[Optional[BaseException]] = [None] * len(handles)

    def drive(i: int):
        try:
            results[i] = handles[i].run(emit_for(handles[i]))
        except BaseException as e:  # noqa: BLE001 - reported to the client
            errors[i] = e

    threads = [threading.Thread(target=drive, args=(i,), daemon=True)
               for i in range(len(handles))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for e in errors:
        if e is not None:
            raise e
    return results  # type: ignore[return-value]


def spec_stats(eng) -> dict:
    """The `spec` section of /worker/stats, with the JAX worker's keys:
    acceptance_rate is accepted / drafted tokens, mean_accept_len the
    per-window histogram's mean, by_drafter the same per drafter (with its
    mean); then the demotions by reason, the verify step's graphs and the
    draft engine's books and the adaptive windows."""
    m = eng.metrics
    snap = m.snapshot()
    out = {
        "mode": eng.cfg.speculative_mode,
        "drafter": eng.drafter_name,
        "num_speculative_tokens": eng.cfg.num_speculative_tokens,
        "ngram_lookup": eng.cfg.ngram_lookup,
        "draft_tokens": m.spec_draft_tokens,
        "accepted_tokens": m.spec_accepted_tokens,
        "acceptance_rate": (
            round(m.spec_accepted_tokens / m.spec_draft_tokens, 4)
            if m.spec_draft_tokens else 0.0),
        "mean_accept_len": snap["spec_accept_mean"],
        "by_drafter": snap["spec_by_drafter"],
        "demotions": snap["spec_demotions"],
        "verify_graphs": eng.verify.stats(),
    }
    if eng.draft is not None:
        out["draft_engine"] = eng.draft.stats()
    if eng._adaptive is not None:
        out["adaptive_k"] = {"k_max": eng._adaptive.k_max,
                             "slots": eng._adaptive.snapshot()}
    return out


class _Handler(JsonHTTPHandler):
    ctx: ServingContext  # bound by make_server
    _span = obs_tracing.NOOP_SPAN  # set per request in do_POST

    def _model_ids(self) -> List[str]:
        """Served model ids: the base plus one '<base>:<adapter>' entry per
        registered adapter (multi-LoRA addressing)."""
        ids = [self.ctx.served_model]
        lora = self.ctx.engine.lora
        if lora is not None:
            ids += [f"{self.ctx.served_model}:{n}" for n in lora.names()]
        return ids

    def do_GET(self):
        path = self.path.split("?")[0]
        ctx = self.ctx
        if path == "/v1/models":
            self._json(200, proto.models_response(self._model_ids()))
        elif path.startswith("/v1/models/"):
            mid = path[len("/v1/models/"):]
            if mid in self._model_ids():
                self._json(200, proto.model_response(mid))
            else:
                self._error(404, f"model {mid!r} not found", "not_found")
        elif path == "/v1/adapters":
            lora = ctx.engine.lora
            if lora is None:
                self._error(400, "this worker serves no adapters "
                            "(--lora-slots is 0)")
                return
            st = lora.stats()
            self._json(200, {"object": "list", "data": lora.describe(),
                             "slots": {"total": st["slots_total"],
                                       "free": st["slots_free"]}})
        elif path == "/live":
            # liveness stays 200 through suspect and resurrecting: killing
            # the pod mid-resurrection would turn every recoverable trip
            # into a replacement; quarantine rides readiness
            self._json(200, {"status": "ok", "uptime_s": round(
                time.time() - ctx.start_time, 1)})
        elif path in ("/health", "/ready"):
            wd = ctx.engine.watchdog
            if not wd.ok_for_traffic:
                # a worker that cannot prove progress is out of rotation:
                # readiness 503 pulls it from the endpoints
                self._error(503, f"engine {wd.health}",
                            "service_unavailable",
                            headers={"Retry-After": "5"})
                return
            self._json(200, {"status": "ok", "uptime_s": round(
                time.time() - ctx.start_time, 1)})
        elif path == "/internal/faults":
            self._json(200, faults.http_payload())
        elif path == "/metrics":
            body, ctype = ctx.scrape(self.headers.get("Accept"))
            self._raw(200, body, ctype)
        elif path in ("/debug", "/debug/"):
            self._json(200, {"endpoints": WORKER_DEBUG_INDEX})
        elif path == "/debug/spans":
            self._json(200, obs_tracing.spans_debug_payload(
                self._query(), ctx.tracer.collector))
        elif path == "/debug/slo":
            self._json(200, obs_slo.debug_slo_payload(ctx.slo,
                                                      self._query()))
        elif path == "/debug/flight":
            self._json(200, debug_flight_payload(ctx.engine.flight,
                                                 self._query()))
        elif path == "/debug/timeline":
            self._json(200, timeline_debug_payload(
                ctx.engine.timeline, self._query(),
                collector=ctx.tracer.collector))
        elif path == "/debug/costs":
            self._json(200, ctx.engine.cost.rollup())
        elif path == "/debug/trace":
            self._debug_trace()
        elif path == "/worker/stats":
            eng = ctx.engine
            out = {
                "model": ctx.served_model,
                "device": str(eng.device),
                "active_seqs": eng.num_active,
                "pending": len(eng.pending),
                "free_pages": eng.allocator.free_pages,
                "total_pages": eng.cfg.num_pages,
                "max_num_seqs": eng.cfg.max_num_seqs,
                "kv_cache": {"dtype": eng.kv_spec.dtype,
                             "lane_width": eng.kv_spec.lane_width,
                             "bytes": eng.kv_spec.pool_bytes},
                "metrics": eng.metrics.snapshot(),
                "decode_graphs": eng.windows.stats(),
                # the watchdog's state and counters (the heartbeat's too)
                "health": eng.watchdog.summary(),
                # the weight versions and the double buffer's bytes
                "weights": eng.weights.stats(),
                "draining": ctx.draining.is_set(),
            }
            if eng.prefix_cache is not None:
                out["prefix_cache"] = eng.prefix_cache.stats()
            if eng.verify is not None:
                out["spec"] = spec_stats(eng)
            if eng.lora is not None:
                out["lora"] = eng.lora.stats()
            if eng.qos is not None:
                # per-tenant QoS: budget balances, token totals, and the
                # defer/preempt counters
                out["qos"] = eng.qos.stats()
            if eng.kvbm is not None:
                out["kvbm"] = eng.kvbm.stats()
            # the exact KV books (the dynamo_memory_* series in one read),
            # the cost rollup and the step timeline's bubble attribution
            try:
                out["memory"] = ctx.memory_bridge.accountant.snapshot()
            except Exception:
                log.exception("memory snapshot failed in /worker/stats")
            out["costs"] = eng.cost.rollup()
            out["timeline"] = eng.timeline.summary()
            self._json(200, out)
        else:
            self._error(404, f"no route {path}")

    def _query(self) -> dict:
        return urllib.parse.parse_qs(urllib.parse.urlsplit(self.path).query)

    def _debug_trace(self) -> None:
        try:
            dur = float((self._query().get("duration_s") or ["1.0"])[0])
        except ValueError:
            self._error(400, "duration_s must be a number")
            return
        try:
            data = self.ctx.capture_trace(dur)
        except TraceBusy as e:
            # another capture holds the profiler: say when to come back
            # instead of parking this thread on the lock
            self._error(409, str(e), "conflict",
                        headers={"Retry-After": str(int(dur) + 1)})
            return
        except Exception as e:
            log.exception("trace capture failed")
            self._error(503, f"trace capture failed: {e}",
                        "service_unavailable")
            return
        self._raw(200, data, "application/zip")

    def _optional_body(self) -> dict:
        try:
            return self._read_json_body()
        except Exception:  # noqa: BLE001 - the body is optional
            return {}

    def do_POST(self):
        path = self.path.split("?")[0]
        ctx = self.ctx
        if ctx.draining.is_set() and path.startswith("/v1/"):
            # graceful drain: admission is OFF before anything else; a 503
            # here is retry-safe (nothing ran) and the frontend fails it
            # over to another replica
            self._error(503, "worker draining; retry another replica",
                        "service_unavailable")
            return
        wd = ctx.engine.watchdog
        if not wd.ok_for_traffic and path.startswith("/v1/"):
            # watchdog shed: a suspect, resurrecting or quarantined engine
            # takes no new inference work
            self._error(503, f"engine {wd.health}; retry another replica",
                        "service_unavailable", headers={"Retry-After": "5"})
            return
        # the read-stall / reset-after-headers fault points (no-ops unless
        # armed; control-plane routes are exempt)
        self._fault_gate()
        # request span: a child of the caller's span when a traceparent
        # arrived, else a fresh root seeded by x-request-id
        span = obs_tracing.NOOP_SPAN
        self._deadline = None
        self._tenant = "default"
        if path in ("/v1/chat/completions", "/v1/completions"):
            parent = obs_context.extract_context(self.headers)
            inbound_rid = ((self.headers.get("x-request-id") or "").strip()
                           or None)
            # per-tenant QoS: trust the frontend's resolved identity
            # (x-dynamo-tenant) when present, else resolve from the
            # client's own headers (a worker alone is the edge)
            self._tenant = ctx.tenants.resolve(self.headers, trusted=True)
            # the propagated budget keeps counting down on this hop; a
            # request that arrives spent sheds with 504 before a slot
            self._deadline = Deadline.from_headers(self.headers)
            span = ctx.tracer.start_span(
                "worker.request", parent=parent, kind="server",
                trace_seed=inbound_rid,
                attributes={"http.path": path, "worker.mode": "agg",
                            "deadline_s": round(self._deadline.budget_s, 3),
                            "model": ctx.served_model,
                            "tenant.id": self._tenant})
            rid = inbound_rid or (span.trace_id if span.recording else None)
            if rid:
                self.set_request_id(rid)
        self._span = span
        try:
            try:
                if self._deadline is not None and self._deadline.expired:
                    raise TimeoutError(
                        "deadline budget exhausted before processing; "
                        "request shed")
                if path == "/v1/chat/completions":
                    self._chat(self._read_json_body())
                elif path == "/v1/completions":
                    self._completion(self._read_json_body())
                elif path == "/v1/adapters":
                    self._adapters_post(self._read_json_body())
                elif path == "/internal/faults":
                    try:
                        self._json(200, faults.http_configure(
                            self._read_json_body()))
                    except ValueError as e:
                        raise proto.BadRequest(str(e))
                elif path == "/internal/drain":
                    # the operator's pre-drain of a scale-down victim
                    # (SIGTERM runs the same, idempotent drain)
                    body = self._optional_body()
                    ctx.begin_drain()
                    if body.get("handoff"):
                        ctx.request_handoff()
                        ctx.service.nudge_all()
                    self._json(200, {"draining": True,
                                     "active_seqs": ctx.engine.num_active,
                                     "pending": len(ctx.engine.pending)})
                elif path == "/internal/rollout":
                    # reachable while draining (not a /v1 route), so a
                    # fleet rollback can reach a pod mid-drain
                    body = self._optional_body()
                    if not wd.ok_for_traffic:
                        # fail fast instead of parking this thread on a
                        # wedged engine's exec lock
                        self._error(
                            503, f"engine {wd.health}; rollout refused",
                            "service_unavailable",
                            headers={"Retry-After": "5"})
                        return
                    self._json(200, ctx.rollout(body))
                elif path == "/internal/reclaim":
                    # a spot/maintenance notice: ack now, drain under the
                    # hard deadline in the background
                    body = self._optional_body()
                    qs = self._query()
                    raw = (qs["deadline_s"][0] if qs.get("deadline_s")
                           else body.get("deadline_s"))
                    try:
                        deadline_s = (float(raw) if raw is not None
                                      else _env_reclaim_deadline_s())
                    except (TypeError, ValueError):
                        raise proto.BadRequest(
                            f"invalid deadline_s {raw!r}")
                    if deadline_s <= 0:
                        raise proto.BadRequest("deadline_s must be > 0")
                    self._json(200, ctx.reclaim(deadline_s))
                else:
                    self._error(404, f"no route {path}")
            except Exception as e:
                span.set_status("ERROR", f"{type(e).__name__}: {e}")
                raise
        except proto.BadRequest as e:
            self._fail(400, str(e))
        except OutOfPages as e:  # transient capacity: client should retry
            self._fail(503, str(e), "service_unavailable")
        except RuntimeError as e:  # a refused stage: retry later
            self._fail(503, str(e), "service_unavailable")
        except ValueError as e:  # engine-level rejection (over-length, ...)
            self._fail(400, str(e))
        except TimeoutError as e:
            self._fail(504, str(e), "timeout")
        except Exception:
            log.exception("request failed")
            self._fail(500, "internal error", "internal_error")
        finally:
            span.end()

    def _fail(self, code: int, msg: str, etype: str = "invalid_request_error"):
        if code >= 500:
            # the error-rate SLO's source; 4xx never burn budget
            self.ctx.metrics.errors_total.inc(
                model=self.ctx.served_model, code=str(code))
        if self.sse_started:
            self._sse_error(msg)
        else:
            self._error(code, msg, etype)

    def _adapters_post(self, body):
        """Runtime adapter management (POST /v1/adapters):
        {"name": n, "path": p}                 register (device lazily)
        {"name": n, "path": p, "load": true}   register + load into a slot
        {"name": n, "unload": true}            drop the device slot
        {"name": n, "remove": true}            unregister entirely
        """
        lora = self.ctx.engine.lora
        if lora is None:
            raise proto.BadRequest(
                "this worker serves no adapters (--lora-slots is 0)")
        name = body.get("name")
        if not isinstance(name, str) or not name:
            raise proto.BadRequest("'name' is required")
        try:
            if body.get("remove"):
                lora.unregister(name)
                self._json(200, {"name": name, "removed": True})
                return
            if body.get("unload"):
                was = lora.unload(name)
                self._json(200, {"name": name, "unloaded": was})
                return
            if body.get("path"):
                lora.register(name, path=str(body["path"]))
            elif not lora.known(name):
                raise proto.BadRequest(
                    f"unknown adapter {name!r} (give 'path' to register)")
            slot = None
            if body.get("load"):
                slot = lora.acquire_slot(name)
        except NoFreeAdapterSlot as e:
            self._error(503, str(e), "service_unavailable")
            return
        except (ValueError, KeyError) as e:
            raise proto.BadRequest(str(e))
        self._json(200, {"name": name, "registered": True,
                         "resident": lora.slot_of(name) is not None,
                         **({"slot": slot} if slot is not None else {})})

    def _check_model(self, model: str) -> Optional[str]:
        """Validate the request's model id; returns the adapter name when
        the id uses '<base>:<adapter>' addressing (multi-LoRA), else
        None."""
        bases = (self.ctx.served_model, self.ctx.engine.cfg.model)
        if model in bases:
            return None
        adapter = None
        for b in bases:
            if model.startswith(b + ":"):
                adapter = model[len(b) + 1:]
                break
        lora = self.ctx.engine.lora
        if adapter and lora is not None and lora.known(adapter):
            return adapter
        raise proto.BadRequest(
            f"model {model!r} not served (serving {self.ctx.served_model!r}"
            + (f" + adapters {lora.names()}" if lora is not None else "")
            + ")")

    # ------------------------------------------- mid-stream recovery ----
    def _journal_comment(self, obj) -> None:
        """One recovery-journal record as an SSE comment frame: it rides
        the response stream, so the journal dies with the connection
        exactly when the frontend stops needing it."""
        self._write_chunk(recovery.comment_frame(obj))

    def _setup_recovery(self, body, p, stream_gated: bool = False):
        """Continuation and journaling plumbing (serving/recovery.py).

        Returns (rec, journaling): `rec` the validated inbound
        ``dynamo_recovery`` continuation (streaming only), `journaling`
        whether this stream emits journal comments. A journaled UNSEEDED
        sampled stream gets its effective seed pinned here and journaled,
        so a continuation resumes the same chain. `stream_gated` streams
        (auto tool choice) hold text back, so their delivered chars are
        not a function of the tokens: they are not journaled."""
        rec = body.get(recovery.RECOVERY_BODY_KEY)
        if rec is not None:
            try:
                rec = recovery.normalize_continuation(rec)
            except ValueError as e:
                raise proto.BadRequest(str(e))
        journaling = bool(self.headers.get(recovery.JOURNAL_HEADER)
                          and p["stream"] and p.get("n", 1) == 1
                          and not stream_gated)
        if rec is not None and p["stream"]:
            p["_recovery"] = rec
            if p["seed"] is None and rec.get("seed") is not None:
                p["seed"] = rec["seed"]
        if journaling and p["seed"] is None and p["temperature"] > 0:
            p["seed"] = random.getrandbits(31)
        return (rec if p["stream"] else None), journaling

    def _chat(self, body):
        p = proto.parse_chat_request(body)
        p["adapter"] = self._check_model(p["model"])
        p["tenant"] = self._tenant
        tools, tc = p["tools"], p["tool_choice"]
        if isinstance(tc, tuple):  # ("function", name)
            if p["stream"]:
                raise proto.BadRequest(
                    "streaming is not supported with a forced tool_choice")
            # the forced call's arguments are produced by the JSON-guided
            # decoder: one complete JSON object
            p["guided_json"] = True
        prompt_text = self.ctx.tokenizer.apply_chat_template(
            p["messages"], tools=tools if tc != "none" else None)
        prompt_ids = self.ctx.tokenizer.encode(prompt_text)
        # a recovery continuation reuses the ORIGINAL response id so the
        # spliced stream's chunks stay consistent for the client
        rec, journaling = self._setup_recovery(
            body, p, stream_gated=(tools is not None and tc == "auto"))
        rid = (rec or {}).get("response_id") or proto.new_id("chatcmpl")
        self._span.set_attribute("request.id", rid)
        handles = self.ctx.start_choices(  # may raise 400
            rid, prompt_ids, p, trace_span=self._span,
            deadline=self._deadline)
        if not p["stream"]:
            results = run_choices(handles, lambda h: (lambda d, f, lp: True))
            choices = [
                proto.chat_choice(
                    h.index, text, finish,
                    h.lp_entries if h.want_logprobs else None,
                    tool_call=(proto.extract_tool_call(text, tools, tc)
                               if tools is not None else None))
                for h, (text, finish, _) in zip(handles, results)]
            self._json(200, proto.chat_completion_response(
                rid, p["model"], choices, len(prompt_ids),
                sum(r[2] for r in results)))
            return
        with_null = p.get("include_usage", False)
        self._start_sse()
        lock = threading.Lock()
        if journaling:
            handles[0].journal_sink = self._journal_comment
            self._journal_comment({"start": {"id": rid,
                                             "seed": p.get("seed")}})
        if rec is None or not rec.get("role_sent"):
            # a continuation skips the role preamble the original stream
            # already delivered
            for h in handles:
                self._sse_chunk(proto.chat_chunk(
                    rid, p["model"], {"role": "assistant"}, None,
                    with_usage_null=with_null, index=h.index))
        # tool_choice "auto": a leading '{' buffers until finish and can
        # become ONE tool_calls delta; anything else streams as before
        gating = tools is not None and tc == "auto"

        def emit_for(h):
            gate = proto.AutoToolStreamGate() if gating else None

            def emit(delta, finish, lp_entry) -> bool:
                with lock:
                    ok = True
                    entries = [lp_entry] if lp_entry is not None else []
                    if gate is not None:
                        delta, entries = gate.feed(delta, lp_entry)
                        if finish is not None:
                            call, held, held_lp = gate.finish(tools, tc)
                            if call is not None:
                                finish = "tool_calls"
                                ok = self._sse_chunk(proto.chat_chunk(
                                    rid, p["model"],
                                    proto.tool_call_chunk_delta(call), None,
                                    with_usage_null=with_null,
                                    index=h.index)) and ok
                            else:
                                delta += held
                                entries = entries + held_lp
                    if delta or entries:
                        ok = self._sse_chunk(proto.chat_chunk(
                            rid, p["model"], {"content": delta}, None,
                            with_usage_null=with_null, index=h.index,
                            logprob_entries=(
                                entries if entries
                                else (None if not h.want_logprobs else [])),
                        )) and ok
                    if finish is not None:
                        ok = self._sse_chunk(proto.chat_chunk(
                            rid, p["model"], {}, finish,
                            with_usage_null=with_null, index=h.index)) and ok
                    return ok
            return emit

        results = run_choices(handles, emit_for)
        if any(r[1] == "handoff" for r in results):
            # handoff: end the body WITHOUT [DONE]; the frontend reads it
            # as a mid-stream failure and splices the continuation
            self._end_sse()
            return
        if with_null:
            # usage describes the LOGICAL request: the original prompt
            # and the completion tokens across the recovery seam
            self._sse_chunk(proto.usage_chunk(
                rid, p["model"], "chat.completion.chunk", len(prompt_ids),
                sum(r[2] for r in results)
                + sum(h.prior_count for h in handles)))
        self._sse_chunk("[DONE]")
        self._end_sse()

    def _completion(self, body):
        p = proto.parse_completion_request(body)
        p["adapter"] = self._check_model(p["model"])
        p["tenant"] = self._tenant
        prompt_ids = self.ctx.tokenizer.encode(p["prompt"])
        rec, journaling = self._setup_recovery(body, p)
        rid = (rec or {}).get("response_id") or proto.new_id("cmpl")
        self._span.set_attribute("request.id", rid)
        handles = self.ctx.start_choices(rid, prompt_ids, p,
                                         trace_span=self._span,
                                         deadline=self._deadline)

        def lp_block(h):
            if not h.want_logprobs:
                return None
            return proto.completion_logprobs(
                [e["token"] for e in h.lp_entries],
                [e["logprob"] for e in h.lp_entries],
                [[(a["token"], a["logprob"]) for a in e["top_logprobs"]]
                 for e in h.lp_entries])

        if not p["stream"]:
            results = run_choices(handles, lambda h: (lambda d, f, lp: True))
            choices = [proto.completion_choice(h.index, text, finish,
                                               lp_block(h))
                       for h, (text, finish, _) in zip(handles, results)]
            self._json(200, proto.completion_response(
                rid, p["model"], choices, len(prompt_ids),
                sum(r[2] for r in results)))
            return
        self._start_sse()
        lock = threading.Lock()
        if journaling:
            handles[0].journal_sink = self._journal_comment
            self._journal_comment({"start": {"id": rid,
                                             "seed": p.get("seed")}})

        def emit_for(h):
            def emit(delta, finish, lp_entry) -> bool:
                if not (delta or finish is not None or lp_entry is not None):
                    return True
                with lock:
                    choice = {"index": h.index, "text": delta,
                              "finish_reason": finish}
                    if lp_entry is not None:
                        choice["logprobs"] = proto.completion_logprobs(
                            [lp_entry["token"]], [lp_entry["logprob"]],
                            [[(a["token"], a["logprob"])
                              for a in lp_entry["top_logprobs"]]])
                    chunk = {"id": rid, "object": "text_completion",
                             "created": int(time.time()), "model": p["model"],
                             "choices": [choice]}
                    if p.get("include_usage"):
                        chunk["usage"] = None
                    return self._sse_chunk(chunk)
            return emit

        results = run_choices(handles, emit_for)
        if any(r[1] == "handoff" for r in results):
            self._end_sse()  # handoff: no [DONE], the frontend splices on
            return
        if p.get("include_usage"):
            self._sse_chunk(proto.usage_chunk(
                rid, p["model"], "text_completion", len(prompt_ids),
                sum(r[2] for r in results)
                + sum(h.prior_count for h in handles)))
        self._sse_chunk("[DONE]")
        self._end_sse()


def make_server(ctx: ServingContext, host: str = "0.0.0.0", port: int = 8000):
    return make_http_server(_Handler, {"ctx": ctx}, host, port)

