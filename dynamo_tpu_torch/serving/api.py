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
Not ported yet: recovery journaling, tenants, deadlines, drain, the
watchdog and its health series, the KVBM and disaggregation.
"""

from __future__ import annotations

import logging
import threading
import time
import urllib.parse
from typing import List, Optional

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
from dynamo_tpu_torch.serving import protocol as proto
from dynamo_tpu_torch.serving.engine_service import EngineService
from dynamo_tpu_torch.serving.http_base import (JsonHTTPHandler,
                                                 make_http_server)
from dynamo_tpu_torch.serving.metrics import (CallbackCounter, Counter,
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
                 params: dict, index: int = 0, trace_span=None):
        self.ctx = ctx
        self.rid = rid
        self.index = index
        self.span = (trace_span if trace_span is not None
                     else obs_tracing.NOOP_SPAN)
        self.stops: List[str] = params.get("stop") or []
        self.want_logprobs = params.get("logprobs") is not None
        self.prompt_ids = prompt_ids
        seed = params.get("seed")
        self.req = GenRequest(
            rid, list(prompt_ids),
            max_tokens=params["max_tokens"],
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
            adapter=params.get("adapter"),
        )
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
        for ev in ctx.service.drain(self.req, self.queue):
            now = time.monotonic()
            # exemplar: the request's trace id rides the latency buckets,
            # so a p99 bucket resolves at /debug/spans?trace_id=...
            ex = self.span.trace_id if self.span.recording else None
            if t_prev is None:
                m.ttft.observe(now - t0, exemplar=ex, model=model)
                decode_span = self._first_token_spans(ev, now - t0)
            else:
                m.itl.observe(now - t_prev, exemplar=ex, model=model)
            t_prev = now
            delta, lp_entry = "", None
            if ev.token_id >= 0:
                n_out += 1
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


class ServingContext:
    """Everything the request handlers need, bundled for the handler."""

    def __init__(self, engine: Engine, served_model: str):
        self.engine = engine
        self.service = EngineService(engine)
        self.served_model = served_model
        self.tokenizer = get_tokenizer(engine.cfg.model, engine.cfg.model_path)
        self.metrics = FrontendMetrics()
        r = self.metrics.registry
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
        self.preempt_gauge = Gauge(
            "dynamo_worker_preempted_sequences",
            "Sequences preempted (recompute) under KV page pressure", r)
        self.start_time = time.time()
        self._trace_lock = threading.Lock()  # one profiler capture at a time
        # request spans land in the process-wide ring behind /debug/spans
        self.tracer = obs_tracing.Tracer("worker-agg")
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
        self.slo.refresh_gauges()
        self.engine_bridge.refresh()  # live MFU/MBU + warmup gauges
        self.memory_bridge.refresh()  # KV pool / device / cost books
        return self.metrics.registry.scrape(accept)

    def capture_trace(self, duration_s: float) -> bytes:
        """Capture torch.profiler (CPU and CUDA activities) for
        `duration_s` and return its chrome trace as a zip. One capture at
        a time: a second one raises TraceBusy (the route answers 409)
        instead of waiting. The window opens once the profiler has
        started: the first start in a process takes seconds (CUPTI's
        initialization). The profiler starts and stops between two engine
        steps (`Engine.between_steps`), so the scheduler waits out both;
        the steps in the window run as they would."""
        import io
        import os
        import tempfile
        import zipfile

        from torch.profiler import ProfilerActivity, profile

        if not self._trace_lock.acquire(blocking=False):
            raise TraceBusy("a profiler capture is already running")
        try:
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
        finally:
            self._trace_lock.release()

    def start_choices(self, rid, prompt_ids, params,
                      trace_span=None) -> List[GenerationHandle]:
        """Submit all n choices (choice i streams as '<rid>-i');
        all-or-nothing: a rejection aborts the choices already submitted."""
        n = params.get("n", 1)
        handles: List[GenerationHandle] = []
        try:
            for i in range(n):
                handles.append(GenerationHandle(
                    self, f"{rid}-{i}" if n > 1 else rid, prompt_ids, params,
                    index=i, trace_span=trace_span))
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
        elif path in ("/health", "/ready", "/live"):
            self._json(200, {"status": "ok", "uptime_s": round(
                time.time() - ctx.start_time, 1)})
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
            }
            if eng.prefix_cache is not None:
                out["prefix_cache"] = eng.prefix_cache.stats()
            if eng.verify is not None:
                out["spec"] = spec_stats(eng)
            if eng.lora is not None:
                out["lora"] = eng.lora.stats()
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

    def do_POST(self):
        path = self.path.split("?")[0]
        # request span: a child of the caller's span when a traceparent
        # arrived, else a fresh root seeded by x-request-id
        span = obs_tracing.NOOP_SPAN
        if path in ("/v1/chat/completions", "/v1/completions"):
            parent = obs_context.extract_context(self.headers)
            inbound_rid = ((self.headers.get("x-request-id") or "").strip()
                           or None)
            span = self.ctx.tracer.start_span(
                "worker.request", parent=parent, kind="server",
                trace_seed=inbound_rid,
                attributes={"http.path": path, "worker.mode": "agg",
                            "model": self.ctx.served_model})
            rid = inbound_rid or (span.trace_id if span.recording else None)
            if rid:
                self.set_request_id(rid)
        self._span = span
        try:
            try:
                if path == "/v1/chat/completions":
                    self._chat(self._read_json_body())
                elif path == "/v1/completions":
                    self._completion(self._read_json_body())
                elif path == "/v1/adapters":
                    self._adapters_post(self._read_json_body())
                else:
                    self._error(404, f"no route {path}")
            except Exception as e:
                span.set_status("ERROR", f"{type(e).__name__}: {e}")
                raise
        except proto.BadRequest as e:
            self._fail(400, str(e))
        except OutOfPages as e:  # transient capacity: client should retry
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

    def _chat(self, body):
        p = proto.parse_chat_request(body)
        p["adapter"] = self._check_model(p["model"])
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
        rid = proto.new_id("chatcmpl")
        self._span.set_attribute("request.id", rid)
        handles = self.ctx.start_choices(  # may raise 400
            rid, prompt_ids, p, trace_span=self._span)
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
        if with_null:
            self._sse_chunk(proto.usage_chunk(
                rid, p["model"], "chat.completion.chunk", len(prompt_ids),
                sum(r[2] for r in results)))
        self._sse_chunk("[DONE]")
        self._end_sse()

    def _completion(self, body):
        p = proto.parse_completion_request(body)
        p["adapter"] = self._check_model(p["model"])
        prompt_ids = self.ctx.tokenizer.encode(p["prompt"])
        rid = proto.new_id("cmpl")
        self._span.set_attribute("request.id", rid)
        handles = self.ctx.start_choices(rid, prompt_ids, p,
                                         trace_span=self._span)

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
        if p.get("include_usage"):
            self._sse_chunk(proto.usage_chunk(
                rid, p["model"], "text_completion", len(prompt_ids),
                sum(r[2] for r in results)))
        self._sse_chunk("[DONE]")
        self._end_sse()


def make_server(ctx: ServingContext, host: str = "0.0.0.0", port: int = 8000):
    return make_http_server(_Handler, {"ctx": ctx}, host, port)

