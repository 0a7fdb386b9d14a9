"""OpenAI-compatible request/response shaping (dict-level, stdlib-only).

API surface contract: /v1/models and /v1/chat/completions (+ /v1/completions)
exactly as the reference exposes them (reference README.md:277-292,
reference deploy-incluster.sh:497-501), including SSE streaming chunks.

The port's own copy of `dynamo_tpu/serving/protocol.py` (it imports nothing of the
JAX package); keep the two in step.
"""

from __future__ import annotations

import time
import uuid
from typing import Any, Dict, List, Optional, Tuple


class BadRequest(Exception):
    pass


def new_id(prefix: str = "chatcmpl") -> str:
    return f"{prefix}-{uuid.uuid4().hex[:24]}"


MAX_N = 8  # choices per request; bounded so one request can't hog the batch
MAX_TOP_LOGPROBS = 5  # engine computes top-5 alternatives per step
# request `priority` bounds (vLLM semantics: lower admits sooner). Bounded
# so a client's raw JSON can never dominate the engine's preemption-victim
# ranking — the tenant QoS plane reserves the space above this range for
# its over-budget penalty (dynamo_tpu.qos.tenancy.OVER_BUDGET_PENALTY).
PRIORITY_MIN, PRIORITY_MAX = -100, 100


def _common_sampling(body: Dict[str, Any]) -> Dict[str, Any]:
    """Fields shared by chat + completions: sampling, penalties, seed, stop,
    n, stream/stream_options."""
    temperature = _num(body, "temperature", 1.0)
    if temperature < 0:
        raise BadRequest("'temperature' must be >= 0")
    for key in ("presence_penalty", "frequency_penalty"):
        v = _num(body, key, 0.0)
        if not -2.0 <= v <= 2.0:
            raise BadRequest(f"'{key}' must be in [-2, 2]")
    seed = body.get("seed")
    if seed is not None and (isinstance(seed, bool) or not isinstance(seed, int)):
        raise BadRequest("'seed' must be an integer")
    n = body.get("n", 1)
    if isinstance(n, bool) or not isinstance(n, int) or not 1 <= n <= MAX_N:
        raise BadRequest(f"'n' must be an integer in [1, {MAX_N}]")
    priority = body.get("priority", 0)
    if isinstance(priority, bool) or not isinstance(priority, int) \
            or not PRIORITY_MIN <= priority <= PRIORITY_MAX:
        raise BadRequest(
            f"'priority' must be an integer in "
            f"[{PRIORITY_MIN}, {PRIORITY_MAX}]")
    min_p = _num(body, "min_p", 0.0)
    if not 0.0 <= min_p < 1.0:
        raise BadRequest("'min_p' must be in [0, 1)")
    return {
        "temperature": temperature,
        "top_p": _num(body, "top_p", 1.0),
        "top_k": int(_num(body, "top_k", 0)),
        "presence_penalty": _num(body, "presence_penalty", 0.0),
        "frequency_penalty": _num(body, "frequency_penalty", 0.0),
        "min_p": min_p,
        "logit_bias": _parse_logit_bias(body),
        "seed": seed,
        "n": n,
        # admission-priority extension (vLLM semantics: lower = sooner)
        "priority": priority,
        "stop": _parse_stop(body),
        "stop_token_ids": _parse_stop_token_ids(body),
        "stream": bool(body.get("stream", False)),
        "include_usage": _include_usage(body),
        "ignore_eos": bool(body.get("ignore_eos", False)),
    }


def _parse_stop_token_ids(body: Dict[str, Any]) -> List[int]:
    """vLLM extension: stop on exact token ids (no detokenize round trip);
    model EOS ids still stop generation as usual."""
    ids = body.get("stop_token_ids")
    if ids is None:
        return []
    if (not isinstance(ids, list) or len(ids) > 16
            or not all(isinstance(i, int) and not isinstance(i, bool)
                       and i >= 0 for i in ids)):
        raise BadRequest(
            "'stop_token_ids' must be up to 16 non-negative integers")
    return ids


def _parse_logit_bias(body: Dict[str, Any]):
    """OpenAI logit_bias: {"<token_id>": bias in [-100, 100]}. The engine
    packs at most BIAS_K entries into fixed lanes — reject larger maps
    rather than silently dropping biases. {} is a no-op, per OpenAI."""
    from dynamo_tpu_torch.engine.request import BIAS_K

    lb = body.get("logit_bias")
    if lb is None or lb == {}:
        return None
    if not isinstance(lb, dict):
        raise BadRequest("'logit_bias' must be an object")
    if len(lb) > BIAS_K:
        raise BadRequest(
            f"'logit_bias' supports at most {BIAS_K} entries")
    out = {}
    for k, v in lb.items():
        try:
            tok = int(k)
        except (TypeError, ValueError):
            raise BadRequest("'logit_bias' keys must be token ids")
        if isinstance(v, bool) or not isinstance(v, (int, float)) \
                or not -100.0 <= float(v) <= 100.0:
            raise BadRequest("'logit_bias' values must be in [-100, 100]")
        if tok < 0:
            raise BadRequest("'logit_bias' token ids must be >= 0")
        out[tok] = float(v)
    return out


def _parse_stop(body: Dict[str, Any]) -> List[str]:
    stop = body.get("stop")
    if stop is None:
        return []
    if isinstance(stop, str):
        stop = [stop]
    if (not isinstance(stop, list) or len(stop) > 4
            or not all(isinstance(s, str) and s for s in stop)):
        raise BadRequest(
            "'stop' must be a non-empty string or up to 4 non-empty strings"
        )
    return stop


def parse_chat_request(body: Dict[str, Any]) -> Dict[str, Any]:
    if not isinstance(body, dict):
        raise BadRequest("body must be a JSON object")
    messages = body.get("messages")
    if not isinstance(messages, list) or not messages:
        raise BadRequest("'messages' must be a non-empty array")
    for m in messages:
        if not isinstance(m, dict) or "role" not in m:
            raise BadRequest("each message needs 'role'")
        # content is optional exactly when the assistant turn carries
        # tool_calls (OpenAI multi-turn tool conversations)
        if "content" not in m and not m.get("tool_calls"):
            raise BadRequest("each message needs 'content' (or "
                             "'tool_calls' on assistant turns)")
    model = body.get("model")
    if not isinstance(model, str) or not model:
        raise BadRequest("'model' is required")
    # max_completion_tokens is the current OpenAI name; max_tokens the legacy
    # alias — accept both; explicit null means absent (OpenAI semantics)
    mt = body.get("max_tokens")
    if mt is None:
        mt = body.get("max_completion_tokens")
    if mt is None:
        mt = 512
    if isinstance(mt, bool) or not isinstance(mt, int) or mt < 1:
        raise BadRequest("'max_tokens' must be a positive integer")
    lp = body.get("logprobs", False)
    if not isinstance(lp, bool):
        raise BadRequest("'logprobs' must be a boolean for chat completions")
    top_lp = body.get("top_logprobs", 0)
    if (isinstance(top_lp, bool) or not isinstance(top_lp, int)
            or not 0 <= top_lp <= MAX_TOP_LOGPROBS):
        raise BadRequest(
            f"'top_logprobs' must be an integer in [0, {MAX_TOP_LOGPROBS}]"
        )
    if top_lp and not lp:
        raise BadRequest("'top_logprobs' requires 'logprobs': true")
    tools, tool_choice = _parse_tools(body)
    return {
        "model": model,
        "messages": messages,
        "max_tokens": mt,
        # engine logprobs: None = off; N = chosen + top-N alternatives
        "logprobs": top_lp if lp else None,
        "guided_json": _parse_response_format(body),
        "tools": tools,
        "tool_choice": tool_choice,
        **_common_sampling(body),
    }


def _parse_tools(body: Dict[str, Any]):
    """OpenAI `tools` + `tool_choice`. Returns (tools, tool_choice) where
    tool_choice is "none", "auto", or the tagged tuple
    ("function", name) for a forced function (tagged so a tool literally
    named "auto"/"none" can still be forced).

    A forced function rides the JSON-guided decoder: the completion is
    constrained to one JSON object, returned as the call's arguments.
    "auto" serves text and surfaces a tool call only when the model emits
    the canonical {"name": ..., "arguments": {...}} object (the reference
    stack's engines likewise need a model-specific parser for free-form
    tool syntax)."""
    tools = body.get("tools")
    if tools is None:
        if body.get("tool_choice") not in (None, "none"):
            raise BadRequest("'tool_choice' requires 'tools'")
        return None, "none"
    if not isinstance(tools, list) or not tools:
        raise BadRequest("'tools' must be a non-empty array")
    names = []
    for t in tools:
        fn = t.get("function") if isinstance(t, dict) else None
        if (not isinstance(t, dict) or t.get("type") != "function"
                or not isinstance(fn, dict)
                or not isinstance(fn.get("name"), str)):
            raise BadRequest(
                "each tool must be {'type': 'function', 'function': "
                "{'name': ..., ...}}")
        names.append(fn["name"])
    tc = body.get("tool_choice")
    if tc is None:  # explicit null == absent (OpenAI default)
        tc = "auto"
    if tc in ("auto", "none"):
        return tools, tc
    if (isinstance(tc, dict) and tc.get("type") == "function"
            and isinstance(tc.get("function"), dict)):
        name = tc["function"].get("name")
        if name not in names:
            raise BadRequest(f"tool_choice names unknown function {name!r}")
        # tagged so a tool literally named "auto"/"none" can be forced
        return tools, ("function", name)
    raise BadRequest(
        "'tool_choice' must be 'auto', 'none', or "
        "{'type': 'function', 'function': {'name': ...}}")


class AutoToolStreamGate:
    """Streaming gate for tool_choice "auto": decide per choice whether
    the stream is a tool call without giving up streaming for plain text.

    The only auto shape this stack surfaces is the canonical
    {"name", "arguments"} object, which must START with '{' — so the
    gate probes the first non-whitespace character: anything else flushes
    the held text (verbatim, leading whitespace included) and streams
    normally from then on; a '{' buffers the whole choice and, at
    finish, either emits one tool_calls delta (the text parsed as a
    canonical call) or flushes the buffered text. Logprob entries ride
    WITH their text: held entries are released on flush so token/logprob
    alignment survives, and dropped only when the text itself becomes a
    tool call (content is null there).

    feed(delta, lp_entry) -> (text to emit now, lp entries to emit now).
    finish(tools, tool_choice) -> (tool_call | None, leftover_text,
    leftover lp entries)."""

    def __init__(self):
        self._mode = "probe"  # probe -> buffer | stream
        self._parts: List[str] = []
        self._lp: List[Dict] = []

    def feed(self, delta: str, lp_entry: Optional[Dict] = None):
        if self._mode == "stream":
            return delta, ([lp_entry] if lp_entry is not None else [])
        self._parts.append(delta)
        if lp_entry is not None:
            self._lp.append(lp_entry)
        if self._mode == "probe":
            stripped = "".join(self._parts).lstrip()
            if stripped:
                if stripped[0] == "{":
                    self._mode = "buffer"
                else:
                    self._mode = "stream"
                    held, entries = "".join(self._parts), self._lp
                    self._parts, self._lp = [], []
                    return held, entries
        return "", []

    def finish(self, tools, tool_choice):
        held, entries = "".join(self._parts), self._lp
        self._parts, self._lp = [], []
        if self._mode != "buffer":
            self._mode = "stream"
            return None, held, entries  # whitespace-only probe flushes too
        self._mode = "stream"
        call = extract_tool_call(held, tools, tool_choice)
        if call is not None:
            return call, "", []  # content is null: entries describe nothing
        return None, held, entries


def tool_call_chunk_delta(call: Dict[str, Any]) -> Dict[str, Any]:
    """delta payload carrying a complete streamed tool call (index 0)."""
    return {"tool_calls": [{"index": 0, **call}]}


def extract_tool_call(text: str, tools, tool_choice):
    """Map generated text to an OpenAI tool_calls entry, or None.

    Forced choice (("function", name) tag): the guided decoder produced
    one JSON object — it IS the arguments, re-validated here so a
    stop-string truncation can never ship unparseable arguments under
    the grammar guarantee. Auto: accept only the canonical
    {"name": <known tool>, "arguments": <object>} shape."""
    import json as _json

    if tool_choice == "none" or not tools:
        return None
    if isinstance(tool_choice, tuple):  # ("function", name)
        try:
            if not isinstance(_json.loads(text), dict):
                return None
        except Exception:
            return None
        return {"id": new_id("call"), "type": "function",
                "function": {"name": tool_choice[1], "arguments": text}}
    try:
        obj = _json.loads(text)
    except Exception:
        return None
    if not isinstance(obj, dict) or set(obj) != {"name", "arguments"}:
        return None
    known = {t["function"]["name"] for t in tools}
    if obj["name"] not in known:
        return None
    args = obj["arguments"]
    if isinstance(args, str):
        # string arguments must themselves parse to an object, or a
        # client's json.loads(arguments) would crash on our output
        try:
            if not isinstance(_json.loads(args), dict):
                return None
        except Exception:
            return None
    elif not isinstance(args, dict):
        return None  # scalar arguments are not a canonical call
    return {"id": new_id("call"), "type": "function",
            "function": {"name": obj["name"],
                         "arguments": (args if isinstance(args, str)
                                       else _json.dumps(args))}}


def _parse_response_format(body: Dict[str, Any]) -> bool:
    """OpenAI response_format: {"type": "json_object"} constrains the
    completion to one JSON object (device-side grammar —
    ops/json_guide.py); "text"/absent is unconstrained; "json_schema" is
    explicitly unsupported (schema-level constraints are not wired)."""
    rf = body.get("response_format")
    if rf is None:
        return False
    if not isinstance(rf, dict) or "type" not in rf:
        raise BadRequest("'response_format' must be an object with 'type'")
    kind = rf["type"]
    if kind == "text":
        return False
    if kind == "json_object":
        return True
    if kind == "json_schema":
        raise BadRequest(
            "response_format type 'json_schema' is not supported; use "
            "'json_object'")
    raise BadRequest(f"unknown response_format type {kind!r}")


def _include_usage(body: Dict[str, Any]) -> bool:
    so_raw = body.get("stream_options")
    if so_raw is None:
        return False
    if not isinstance(so_raw, dict):
        raise BadRequest("'stream_options' must be an object")
    if not body.get("stream", False):
        # OpenAI returns 400 for stream_options without stream=true
        raise BadRequest("'stream_options' requires 'stream': true")
    return bool(so_raw.get("include_usage", False))


def _usage(prompt_tokens: int, completion_tokens: int) -> Dict[str, int]:
    return {
        "prompt_tokens": prompt_tokens,
        "completion_tokens": completion_tokens,
        "total_tokens": prompt_tokens + completion_tokens,
    }


def _num(body: Dict[str, Any], key: str, default: float) -> float:
    v = body.get(key, default)
    if isinstance(v, bool) or not isinstance(v, (int, float)):
        raise BadRequest(f"'{key}' must be a number")
    return float(v)


def parse_completion_request(body: Dict[str, Any]) -> Dict[str, Any]:
    if not isinstance(body, dict):
        raise BadRequest("body must be a JSON object")
    prompt = body.get("prompt")
    if isinstance(prompt, list):
        if not prompt or not all(isinstance(p, str) for p in prompt):
            raise BadRequest("'prompt' array must contain strings")
        prompt = prompt[0]
    if not isinstance(prompt, str):
        raise BadRequest("'prompt' must be a string")
    model = body.get("model")
    if not isinstance(model, str) or not model:
        raise BadRequest("'model' is required")
    mt = body.get("max_tokens", 16)
    if isinstance(mt, bool) or not isinstance(mt, int) or mt < 1:
        raise BadRequest("'max_tokens' must be a positive integer")
    # legacy completions logprobs: an integer count of alternatives
    lp = body.get("logprobs")
    if lp is not None and (
        isinstance(lp, bool) or not isinstance(lp, int)
        or not 0 <= lp <= MAX_TOP_LOGPROBS
    ):
        raise BadRequest(
            f"'logprobs' must be an integer in [0, {MAX_TOP_LOGPROBS}]"
        )
    return {
        "model": model,
        "prompt": prompt,
        "max_tokens": mt,
        "logprobs": lp,
        # vLLM's OpenAI server accepts response_format on completions
        # too; same device-side grammar as chat
        "guided_json": _parse_response_format(body),
        **_common_sampling(body),
    }


def models_response(models: List[str]) -> Dict[str, Any]:
    now = int(time.time())
    return {
        "object": "list",
        "data": [model_response(m, now) for m in models],
    }


def model_response(model: str, now: Optional[int] = None) -> Dict[str, Any]:
    """One model card (GET /v1/models/{id}, OpenAI retrieve-model)."""
    return {"id": model, "object": "model",
            "created": now or int(time.time()), "owned_by": "dynamo_tpu"}


def _token_bytes(token_text: str) -> List[int]:
    return list(token_text.encode("utf-8"))


def chat_logprob_entry(token_text: str, logprob: float,
                       top: List[tuple]) -> Dict[str, Any]:
    """One content entry of a chat choice's logprobs; `top` is
    [(token_text, logprob)] best-first."""
    return {
        "token": token_text,
        "logprob": logprob,
        "bytes": _token_bytes(token_text),
        "top_logprobs": [
            {"token": t, "logprob": lp, "bytes": _token_bytes(t)}
            for t, lp in top
        ],
    }


def chat_choice(index: int, text: str, finish_reason: str,
                logprob_entries: Optional[List[Dict]] = None,
                tool_call: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    out = {
        "index": index,
        "message": {"role": "assistant", "content": text},
        "finish_reason": finish_reason,
    }
    if tool_call is not None:
        out["message"] = {"role": "assistant", "content": None,
                          "tool_calls": [tool_call]}
        out["finish_reason"] = "tool_calls"
    if logprob_entries is not None:
        out["logprobs"] = {"content": logprob_entries}
    return out


def chat_completion_response(
    rid: str, model: str, choices: List[Dict[str, Any]],
    prompt_tokens: int, completion_tokens: int,
) -> Dict[str, Any]:
    return {
        "id": rid,
        "object": "chat.completion",
        "created": int(time.time()),
        "model": model,
        "choices": choices,
        "usage": _usage(prompt_tokens, completion_tokens),
    }


def chat_chunk(
    rid: str, model: str, delta: Dict[str, Any], finish_reason: Optional[str],
    with_usage_null: bool = False, index: int = 0,
    logprob_entries: Optional[List[Dict]] = None,
) -> Dict[str, Any]:
    choice: Dict[str, Any] = {
        "index": index, "delta": delta, "finish_reason": finish_reason,
    }
    if logprob_entries is not None:
        choice["logprobs"] = {"content": logprob_entries}
    out = {
        "id": rid,
        "object": "chat.completion.chunk",
        "created": int(time.time()),
        "model": model,
        "choices": [choice],
    }
    if with_usage_null:
        # with stream_options.include_usage, every non-final chunk carries
        # an explicit "usage": null per the OpenAI streaming contract
        out["usage"] = None
    return out


def completion_logprobs(tokens: List[str], token_logprobs: List[float],
                        top: List[List[tuple]]) -> Dict[str, Any]:
    """Legacy completions logprobs block; `top[i]` is [(text, lp)]."""
    offsets, pos = [], 0
    for t in tokens:
        offsets.append(pos)
        pos += len(t)
    return {
        "tokens": tokens,
        "token_logprobs": token_logprobs,
        "top_logprobs": [{t: lp for t, lp in alts} for alts in top],
        "text_offset": offsets,
    }


def completion_choice(index: int, text: str, finish_reason: str,
                      logprobs: Optional[Dict] = None) -> Dict[str, Any]:
    return {"index": index, "text": text, "finish_reason": finish_reason,
            "logprobs": logprobs}


def completion_response(
    rid: str, model: str, choices: List[Dict[str, Any]],
    prompt_tokens: int, completion_tokens: int,
) -> Dict[str, Any]:
    return {
        "id": rid,
        "object": "text_completion",
        "created": int(time.time()),
        "model": model,
        "choices": choices,
        "usage": _usage(prompt_tokens, completion_tokens),
    }


def usage_chunk(
    rid: str, model: str, object_: str, prompt_tokens: int, completion_tokens: int
) -> Dict[str, Any]:
    """Final SSE chunk carrying usage, per stream_options.include_usage."""
    return {
        "id": rid,
        "object": object_,
        "created": int(time.time()),
        "model": model,
        "choices": [],
        "usage": _usage(prompt_tokens, completion_tokens),
    }


def map_finish_reason(reason: Optional[str]) -> str:
    # integrity_fault (watchdog sentinel tripped on this stream's device
    # output) surfaces as "error": the content is not trustworthy and
    # the client should retry — it must never look like a clean "stop"
    return {"stop": "stop", "length": "length", "abort": "stop",
            "kv_oom": "length", "integrity_fault": "error",
            }.get(reason or "stop", "stop")
