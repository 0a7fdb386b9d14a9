"""OpenAI-compatible HTTP API over the port's engine.

Port of the serving core of `dynamo_tpu/serving/api.py`:
`GET /v1/models`, `/v1/models/{id}`, `/health`, `/ready`, `/live`,
`/worker/stats`; `POST /v1/chat/completions` and `/v1/completions`, each
streamed (SSE) or not, with `usage`, `n` choices, stop strings, logprobs,
auto and forced tool calls and `response_format` json_object (JSON-guided
decoding, on both routes); multi-LoRA model ids `<base>:<adapter>`, listed
by `/v1/models`, and `GET`/`POST /v1/adapters` to register, load, unload
and remove adapters. Request shaping is the copied `serving/protocol.py`,
so the wire format is the JAX worker's. Not ported yet: recovery
journaling, tracing spans, metrics exposition (and with it the LoRA
counters), tenants, drain and disaggregation.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import List, Optional

from dynamo_tpu_torch.engine.engine import Engine
from dynamo_tpu_torch.engine.kv_cache import OutOfPages
from dynamo_tpu_torch.engine.request import GenRequest
from dynamo_tpu_torch.engine.tokenizer import get_tokenizer
from dynamo_tpu_torch.lora.registry import NoFreeAdapterSlot
from dynamo_tpu_torch.serving import protocol as proto
from dynamo_tpu_torch.serving.engine_service import EngineService
from dynamo_tpu_torch.serving.http_base import (JsonHTTPHandler,
                                                 make_http_server)

log = logging.getLogger("dynamo_tpu_torch.api")


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
                 params: dict, index: int = 0):
        self.ctx = ctx
        self.rid = rid
        self.index = index
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
        self.queue = ctx.service.submit(self.req)  # raises ValueError early
        if self.req.adapter and ctx.engine.lora is not None:
            ctx.engine.lora.note_request(self.req.adapter)
        self.lp_entries: List[dict] = []

    def _lp_entry(self, ev) -> Optional[dict]:
        if not (self.want_logprobs and ev.logprob is not None):
            return None
        tok = self.ctx.tokenizer
        return proto.chat_logprob_entry(
            tok.decode([ev.token_id]), ev.logprob,
            [(tok.decode([tid]), lp) for tid, lp in (ev.top_logprobs or [])])

    def run(self, emit) -> tuple:
        """Drive the stream; emit(delta, finish|None, lp_entry|None) -> bool
        keeps going while True (False = client gone: abort). Returns
        (text, finish_reason, completion_tokens)."""
        ctx = self.ctx
        detok = IncrementalDetokenizer(ctx.tokenizer)
        matcher = StopStringMatcher(self.stops) if self.stops else None
        text_parts: List[str] = []
        n_out = 0
        finish = "stop"
        for ev in ctx.service.drain(self.req, self.queue):
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
        return "".join(text_parts), finish, n_out


class ServingContext:
    """Everything the request handlers need, bundled for the handler."""

    def __init__(self, engine: Engine, served_model: str):
        self.engine = engine
        self.service = EngineService(engine)
        self.served_model = served_model
        self.tokenizer = get_tokenizer(engine.cfg.model, engine.cfg.model_path)
        self.start_time = time.time()

    def close(self) -> None:
        self.service.close()

    def start_choices(self, rid, prompt_ids, params) -> List[GenerationHandle]:
        """Submit all n choices (choice i streams as '<rid>-i');
        all-or-nothing: a rejection aborts the choices already submitted."""
        n = params.get("n", 1)
        handles: List[GenerationHandle] = []
        try:
            for i in range(n):
                handles.append(GenerationHandle(
                    self, f"{rid}-{i}" if n > 1 else rid, prompt_ids, params,
                    index=i))
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
            self._json(200, out)
        else:
            self._error(404, f"no route {path}")

    def do_POST(self):
        path = self.path.split("?")[0]
        try:
            if path == "/v1/chat/completions":
                self._chat(self._read_json_body())
            elif path == "/v1/completions":
                self._completion(self._read_json_body())
            elif path == "/v1/adapters":
                self._adapters_post(self._read_json_body())
            else:
                self._error(404, f"no route {path}")
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

    def _fail(self, code: int, msg: str, etype: str = "invalid_request_error"):
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
        handles = self.ctx.start_choices(rid, prompt_ids, p)  # may raise 400
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
        handles = self.ctx.start_choices(rid, prompt_ids, p)

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

