"""Tokenizer layer: HF tokenizers when available locally, byte-level fallback.

The byte fallback keeps every test and the CPU fake-engine path fully offline
(the environment has zero egress), mirroring the reference's
`--skip-tokenizer-init` escape hatch
(reference examples/deploy/sglang/agg.yaml:42-43).

The port's own copy of `dynamo_tpu/engine/tokenizer.py` (it imports nothing of the
JAX package); keep the two in step.
"""

from __future__ import annotations

import os
from typing import List, Optional


class ByteTokenizer:
    """Reversible byte-level tokenizer: ids 0-255 are bytes; specials above."""

    BOS = 256
    EOS = 257
    PAD = 258

    vocab_size = 259
    bos_token_id = BOS
    eos_token_id = EOS

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        ids = list(text.encode("utf-8"))
        return ([self.BOS] if add_bos else []) + ids

    def decode(self, ids: List[int]) -> str:
        return bytes(i for i in ids if i < 256).decode("utf-8", errors="replace")

    def apply_chat_template(self, messages: List[dict],
                            tools: Optional[List[dict]] = None) -> str:
        import json as _json

        parts = []
        if tools:
            # tool schemas ride a leading system-style block (the byte
            # template's analogue of HF templates' tools rendering)
            parts.append("<|tools|>\n"
                         + _json.dumps(tools, sort_keys=True) + "\n")
        for m in messages:
            content = m.get("content")
            if content is None and m.get("tool_calls"):
                content = _json.dumps(m["tool_calls"])
            parts.append(f"<|{m['role']}|>\n{content or ''}\n")
        parts.append("<|assistant|>\n")
        return "".join(parts)


def _hf_template_messages(messages: List[dict]) -> List[dict]:
    """OpenAI wire format -> HF template convention: tool-call arguments
    arrive as JSON STRINGS on the wire, but HF chat templates `tojson`
    dict arguments — passing the wire form through would double-encode
    them in the rendered prompt."""
    import json as _json

    out = []
    for m in messages:
        calls = m.get("tool_calls")
        if not calls:
            out.append(m)
            continue
        fixed = []
        for c in calls:
            fn = dict(c.get("function") or {})
            args = fn.get("arguments")
            if isinstance(args, str):
                try:
                    fn["arguments"] = _json.loads(args)
                except Exception:
                    pass  # leave malformed strings as-is
            fixed.append({**c, "function": fn})
        out.append({**m, "tool_calls": fixed})
    return out


class HFTokenizer:
    """transformers AutoTokenizer wrapper (local files only)."""

    def __init__(self, path: str):
        from transformers import AutoTokenizer

        self.tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        self.vocab_size = len(self.tok)
        self.bos_token_id = self.tok.bos_token_id
        self.eos_token_id = self.tok.eos_token_id

    def encode(self, text: str, add_bos: bool = True) -> List[int]:
        return self.tok.encode(text, add_special_tokens=add_bos)

    def decode(self, ids: List[int]) -> str:
        return self.tok.decode(ids, skip_special_tokens=True)

    def apply_chat_template(self, messages: List[dict],
                            tools: Optional[List[dict]] = None) -> str:
        try:
            return self.tok.apply_chat_template(
                _hf_template_messages(messages), tools=tools,
                tokenize=False, add_generation_prompt=True
            )
        except Exception:
            import logging

            logging.getLogger("dynamo_tpu_torch.engine").warning(
                "HF chat template failed%s; falling back to the byte "
                "template — the model will see a prompt format it was "
                "not trained on", " (with tools)" if tools else "",
                exc_info=True)
            return ByteTokenizer.apply_chat_template(  # type: ignore
                self, messages, tools=tools)


def get_tokenizer(model: str, model_path: Optional[str] = None):
    """HF tokenizer if a local checkpoint dir carries tokenizer files, else bytes."""
    for cand in (model_path, model):
        if cand and os.path.isdir(cand):
            for f in ("tokenizer.json", "tokenizer.model", "tokenizer_config.json"):
                if os.path.exists(os.path.join(cand, f)):
                    try:
                        return HFTokenizer(cand)
                    except Exception:
                        break
    return ByteTokenizer()
