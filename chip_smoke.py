#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`dynamo_tpu_torch`).

    python3 chip_smoke.py

Needs one NVIDIA GPU (Hopper: the kernels build for sm_90a) and runs from
the root of a checkout; it exits non-zero, printing no result, without a
CUDA device or without the package beside it. Phases, each of which raises
on failure:

1. The card's name and power limit (nvidia-smi).
2. Build the attention kernels from dynamo_tpu_torch/csrc (nvcc, one per
   source in parallel).
3. Each kernel at the shapes the main path gives it for Llama-3.1-8B
   (bf16, H=32, KV=8, D=128, page size 16) against its plain PyTorch
   version on the same bf16 inputs (computed in f32, stored bf16), within
   atol=rtol=2e-2 and, per output row, a max error within 5e-2 of the
   plain row's RMS (see disagreement); with its time, the plain version's,
   one PyTorch scaled_dot_product_attention call's over the same K/V
   gathered dense (the gather not timed; a yardstick the port never
   calls), and the bound max(bytes / 3.35 TB/s, FLOPs / 989 TFLOP/s)
   worked out from the bytes and FLOPs this run's inputs need. This is the
   numerical check of the kernels on random inputs.
4. The engine for llama-3.1-8b-instruct at full width and depth, random
   bf16 weights from seed 0: a full prefill, a decode step and a chunked
   prefill through the kernels, every attention call of every layer held
   against the plain version on the same inputs, and the full-depth logits
   against the same forwards through the plain attention. q is scaled down
   before attention so that softmax is not one-hot (see forward_checks).
5. The OpenAI server on 127.0.0.1:0 with the launch counts zeroed: four
   concurrent greedy requests of 32 tokens (chat, chat streamed, a
   completion, and a ~600-token prompt that takes the chunked path), then
   one request twice, which must give identical tokens. Every kernel must
   have launched.
6. Where a steady decode step's time goes (8 slots, torch.profiler device
   time by kernel family, idle share against the host clock).
7. A `kernels` JSON line (launches from phase 5), the card line, and last
   the {"ok": true, ...} line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
import urllib.request

import torch
import torch.nn.functional as F

from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.engine import Engine
from dynamo_tpu_torch.engine.request import GenRequest
from dynamo_tpu_torch.models import llama
from dynamo_tpu_torch.ops import attention as att
from dynamo_tpu_torch.ops import cuda_attention as ca
from dynamo_tpu_torch.serving.api import ServingContext, make_server

MODEL = "llama-3.1-8b-instruct"
H, KV, D, PS = 32, 8, 128, 16
NUM_PAGES, MAX_SEQS, MAX_SEQ_LEN, CHUNK = 1024, 8, 2048, 256
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS_PER_S = 989e12  # dense bf16 tensor-core peak, same source
TOL = 2e-2
ROW_TOL = 5e-2  # max |error| of an output row over the plain row's RMS
LOGIT_REL_TOL = 5e-2  # relative L2 of full-depth logits, kernels vs plain
Q_SCALE = 2 ** -4  # q scaling of phase 4's forwards (exact in bf16)
MAX_TOKENS = 32
SOURCES = {
    "decode": ("dynamo_tpu_torch/csrc/decode.cu",
               "dynamo_tpu/ops/pallas_attention.py:181 (_decode_kernel)"),
    "prefill": ("dynamo_tpu_torch/csrc/prefill.cu",
                "dynamo_tpu/ops/pallas_attention.py:421 (_prefill_kernel)"),
    "chunk": ("dynamo_tpu_torch/csrc/chunk.cu",
              "dynamo_tpu/ops/pallas_attention.py:554 (_chunk_kernel)"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int) -> float:
    fn()  # warm up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(nbytes: float, flops: float) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return {"bytes": int(nbytes), "flops": int(flops),
            "bytes_ms": t_bytes, "flops_ms": t_ops,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def sdpa(q, k, v, mask) -> torch.Tensor:
    """One library attention call over dense [N, H, Q|S, D] tensors."""
    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def disagreement(out: torch.Tensor, ref: torch.Tensor):
    """(max_abs_err, max_row_rel_err, ok) of a kernel's output against its
    plain version's. ok: finite, allclose within atol=rtol=TOL, and every
    output row (the last dim, one head of one query) off by at most ROW_TOL
    times the plain row's RMS; a row the plain version leaves at zero must
    be exact zeros. The per-row bound catches a slip on rows whose values
    are small next to TOL, as a long context's averages are."""
    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    row_err = err.amax(-1)
    rms = ref.pow(2).mean(-1).sqrt()
    rel = torch.where(rms > 0, row_err / rms.clamp_min(1e-30),
                      torch.where(row_err > 0, float("inf"), 0.0))
    max_rel = float(rel.max())
    ok = (bool(torch.isfinite(out).all())
          and torch.allclose(out, ref, atol=TOL, rtol=TOL)
          and max_rel <= ROW_TOL)
    return float(err.max()), max_rel, ok


def check(name, kernel, plain, library, cost, shapes) -> dict:
    """Kernel vs plain on the same inputs; raises on disagreement."""
    out_k = kernel()
    out_p = plain()
    torch.cuda.synchronize()
    max_abs, max_rel, ok = disagreement(out_k, out_p)
    row = {"name": name, "shapes": shapes, "max_abs_err": max_abs,
           "max_row_rel_err": max_rel,
           "tolerance": f"atol=rtol={TOL}, row max/RMS <= {ROW_TOL}",
           "kernel_ms": time_ms(kernel, 20), "plain_ms": time_ms(plain, 3),
           "library_ms": time_ms(library, 20), **cost}
    emit({"kernel_check": row})
    if not ok:
        raise AssertionError(f"{name} kernel disagrees with its plain "
                             f"version: max_abs_err {max_abs}, max row "
                             f"error / RMS {max_rel}")
    return row


def kernel_checks(dev) -> dict:
    g = torch.Generator(device=dev)
    g.manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    rows = {}
    kp, vp = rnd(NUM_PAGES, PS, KV * D), rnd(NUM_PAGES, PS, KV * D)

    # decode: the engine's batch of 8 slots, ragged contexts incl. ctx 0
    pmax = MAX_SEQ_LEN // PS
    ctx = torch.tensor([0, 1, 17, 100, 255, 600, 1024, 2048],
                       dtype=torch.int32)
    perm = torch.randperm(NUM_PAGES - 1,
                          generator=torch.Generator().manual_seed(1))
    table = torch.zeros((MAX_SEQS, pmax), dtype=torch.int32)
    used = 0  # distinct pages for every sequence (256 of 1023 in all)
    for b, c in enumerate(ctx.tolist()):
        n = -(-c // PS)
        table[b, :n] = perm[used:used + n] + 1
        used += n
    table, ctx_d = table.to(dev), ctx.to(dev)
    q = rnd(MAX_SEQS, H, D)
    kd = kp[table.long()].reshape(MAX_SEQS, -1, KV, D).permute(0, 2, 1, 3)
    vd = vp[table.long()].reshape(MAX_SEQS, -1, KV, D).permute(0, 2, 1, 3)
    kd = kd.repeat_interleave(H // KV, 1).contiguous()
    vd = vd.repeat_interleave(H // KV, 1).contiguous()
    dmask = (torch.arange(pmax * PS, device=dev)[None, :]
             < ctx_d[:, None])[:, None, None, :]
    tok = int(ctx.sum())
    rows["decode"] = check(
        "decode",
        lambda: ca.paged_attention_decode(q, kp, vp, table, ctx_d,
                                          page_size=PS),
        lambda: att.paged_attention_decode_ref(q, kp, vp, table, ctx_d,
                                               page_size=PS),
        lambda: sdpa(q[:, :, None], kd, vd, dmask),
        bound(2 * q.numel() * 2 + 2 * tok * KV * D * 2
              + 4 * (sum(-(-c // PS) for c in ctx.tolist()) + MAX_SEQS),
              4 * tok * H * D),
        {"q": [MAX_SEQS, H, D], "pools": [NUM_PAGES, PS, KV * D],
         "block_table": [MAX_SEQS, pmax], "context_lens": ctx.tolist()})

    # prefill: a batch of same-bucket prompts, one below its bucket
    n, s = 4, 256
    lens = torch.tensor([256, 200, 37, 1], dtype=torch.int32)
    qp, kk, vv = rnd(n, s, H, D), rnd(n, s, KV, D), rnd(n, s, KV, D)
    lens_d = lens.to(dev)
    i = torch.arange(s, device=dev)
    pmask = ((i[None, :] <= i[:, None])[None]
             & (i[None, None, :] < lens_d[:, None, None]))[:, None]
    qt = qp.transpose(1, 2).contiguous()
    kt = kk.repeat_interleave(H // KV, 2).transpose(1, 2).contiguous()
    vt = vv.repeat_interleave(H // KV, 2).transpose(1, 2).contiguous()
    pairs = sum(min(r + 1, int(L)) for L in lens.tolist() for r in range(s))
    # q read and out written in full (padded rows are part of the output);
    # K/V only below seq_len, the rows the mask lets any query see
    rows["prefill"] = check(
        "prefill",
        lambda: ca.prefill_attention(qp, kk, vv, lens_d),
        lambda: att.prefill_attention_ref(qp, kk, vv, lens_d),
        lambda: sdpa(qt, kt, vt, pmask),
        bound(2 * 2 * qp.numel() + 2 * int(lens.sum()) * KV * D * 2 + 4 * n,
              4 * pairs * H * D),
        {"q": [n, s, H, D], "kv": [n, s, KV, D], "seq_lens": lens.tolist()})

    # chunk: the third 256-token chunk of a 600-token prompt (start 512) on
    # its trash-padded page list
    start, c = 512, CHUNK
    width = 1024 // PS + CHUNK // PS - 1
    pages = torch.zeros((width,), dtype=torch.int32)
    pages[:-(-600 // PS)] = perm[:-(-600 // PS)] + 1
    pages = pages.to(dev)
    qc = rnd(c, H, D)
    horizon = start + c
    kc = kp[pages.long()].reshape(-1, KV, D)[:horizon].permute(1, 0, 2)
    vc = vp[pages.long()].reshape(-1, KV, D)[:horizon].permute(1, 0, 2)
    kc = kc.repeat_interleave(H // KV, 0).contiguous()[None]
    vc = vc.repeat_interleave(H // KV, 0).contiguous()[None]
    cmask = (torch.arange(horizon, device=dev)[None, :]
             <= start + torch.arange(c, device=dev)[:, None])[None, None]
    qct = qc.transpose(0, 1).contiguous()[None]
    cpairs = sum(start + r + 1 for r in range(c))
    # K/V bytes: each distinct page below the horizon once (the trash tail
    # repeats page 0); page ids: one int32 per page walked
    walked = pages[:-(-horizon // PS)]
    cpages = int(torch.unique(walked).numel())
    rows["chunk"] = check(
        "chunk",
        lambda: ca.chunk_prefill_attention(qc, kp, vp, pages, start,
                                           page_size=PS),
        lambda: att.chunk_attention_ref(qc, kp, vp, pages, start,
                                        page_size=PS),
        lambda: sdpa(qct, kc, vc, cmask),
        bound(2 * 2 * qc.numel() + 2 * cpages * PS * KV * D * 2
              + 4 * walked.numel(), 4 * cpairs * H * D),
        {"q": [c, H, D], "start": start, "pages": width,
         "pools": [NUM_PAGES, PS, KV * D]})
    return rows


class HeldAgainstPlain:
    """Attention functions that launch the kernels and hold every call's
    output against the plain version on the same inputs (the layer's own
    q/k/v and pool state), so a forward through the kernels checks each of
    its attention calls at every layer."""

    def __init__(self):
        self.calls, self.failed = 0, []
        self.max_abs_err = self.max_row_rel_err = 0.0
        self.fns = att.AttentionFns(
            *(self._wrap(name, getattr(att.DISPATCH, name),
                         getattr(att.PLAIN, name))
              for name in att.AttentionFns._fields))

    def _wrap(self, name, kernel, plain):
        def fn(*args, **kw):
            out = kernel(*args, **kw)
            max_abs, max_rel, ok = disagreement(out, plain(*args, **kw))
            self.calls += 1
            self.max_abs_err = max(self.max_abs_err, max_abs)
            self.max_row_rel_err = max(self.max_row_rel_err, max_rel)
            if not ok:
                self.failed.append((name, self.calls, max_abs, max_rel))
            return out
        return fn


def q_scaled(fns: att.AttentionFns, factor: float) -> att.AttentionFns:
    """`fns` with q multiplied by `factor` before attention."""
    def wrap(fn):
        def scaled(q, *args, **kw):
            return fn(q * factor, *args, **kw)
        return scaled
    return att.AttentionFns(*(wrap(f) for f in fns))


def three_paths(engine: Engine, attn) -> dict:
    """Logits of a full prefill (100 tokens in a 128 bucket), one decode
    step after it (slot 0 live, seven slots on the trash page) and a
    chunked prefill (600 tokens in 256-token chunks), with `attn`."""
    model, dev, out = engine.model, engine.device, {}
    prompt = torch.randint(0, 256, (600,),
                           generator=torch.Generator().manual_seed(2))
    pages = engine.allocator.alloc(600 // PS + 1)
    try:
        page_t = torch.tensor(pages, dtype=torch.int32, device=dev)
        tokens = torch.zeros((128,), dtype=torch.long)
        tokens[:100] = prompt[:100]
        out["prefill"] = llama.prefill(
            model, tokens.to(dev), 100, engine.k_pages, engine.v_pages,
            page_t[:8], page_size=PS, attn=attn)
        tok = torch.zeros((MAX_SEQS,), dtype=torch.long, device=dev)
        pos = torch.zeros((MAX_SEQS,), dtype=torch.int32, device=dev)
        ctx = torch.ones((MAX_SEQS,), dtype=torch.int32, device=dev)
        table = torch.zeros((MAX_SEQS, MAX_SEQ_LEN // PS), dtype=torch.int32,
                            device=dev)
        tok[0], pos[0], ctx[0] = int(prompt[100]), 100, 101
        table[0, :8] = page_t[:8]
        out["decode"] = llama.decode_step(
            model, tok, pos, table, ctx, engine.k_pages, engine.v_pages,
            page_size=PS, attn=attn)[0]
        width = 1024 // PS + CHUNK // PS - 1  # trash-padded page list
        plist = torch.zeros((width,), dtype=torch.int32, device=dev)
        plist[:len(pages)] = page_t
        for start in range(0, 600, CHUNK):
            take = min(CHUNK, 600 - start)
            chunk = torch.zeros((CHUNK,), dtype=torch.long)
            chunk[:take] = prompt[start:start + take]
            out["chunked_prefill"] = llama.prefill_chunk(
                model, chunk.to(dev), start, take, engine.k_pages,
                engine.v_pages, plist, page_size=PS, attn=attn)
    finally:
        engine.allocator.free(pages)
    return out


def rel_l2(got: dict, ref: dict) -> dict:
    return {path: float((got[path].float() - ref[path].float()).norm()
                        / ref[path].float().norm()) for path in ref}


def forward_checks(engine: Engine) -> dict:
    """The three forwards through the kernels against the plain attention,
    at full depth.

    With the random weights, wq's sigma 1/sqrt(head_dim) over 4096 inputs
    gives attention scores of standard deviation near 30: softmax is close
    to one-hot, and a forward at that scale cannot tell a kernel that
    weighs keys wrongly from a right one. So every forward here scales q
    by Q_SCALE before attention (the same shapes, pools and wrappers),
    which brings the scores' deviation near 2 and spreads softmax over
    many keys. Then:
    - every attention call of the kernel forward is held against the plain
      version on the same inputs (HeldAgainstPlain);
    - its logits must be within LOGIT_REL_TOL (relative L2) of the plain
      forward's;
    - the plain forward with the 1/sqrt(D) scale left out (q scaled by
      Q_SCALE * sqrt(D)) must be farther than LOGIT_REL_TOL from it: the
      logits check can fail."""
    held = HeldAgainstPlain()
    plain = three_paths(engine, q_scaled(att.PLAIN, Q_SCALE))
    kernels = three_paths(engine, q_scaled(held.fns, Q_SCALE))
    unscaled = three_paths(engine, q_scaled(att.PLAIN, Q_SCALE * D ** 0.5))
    row = {"q_scale": Q_SCALE,
           "attention_calls_held": held.calls,
           "attention_max_abs_err": held.max_abs_err,
           "attention_max_row_rel_err": held.max_row_rel_err,
           "attention_tolerance": f"atol=rtol={TOL}, row max/RMS <= "
                                  f"{ROW_TOL}",
           "failed_calls": held.failed[:5],
           "logits_rel_l2": rel_l2(kernels, plain),
           "logits_finite": all(bool(torch.isfinite(t).all())
                                for t in kernels.values()),
           "logits_tolerance": f"rel_l2 < {LOGIT_REL_TOL}",
           "logits_rel_l2_without_softmax_scale": rel_l2(unscaled, plain)}
    emit({"forward_check": row})
    expected = len(engine.model.layers) * (2 + -(-600 // CHUNK))
    if held.failed or held.calls != expected:
        raise AssertionError(f"attention calls in the forward disagree with "
                             f"the plain version: {held.failed[:5]} "
                             f"({held.calls} calls)")
    if not row["logits_finite"] or any(
            e >= LOGIT_REL_TOL for e in row["logits_rel_l2"].values()):
        raise AssertionError(f"logits through the kernels differ from the "
                             f"plain forward: {row['logits_rel_l2']}")
    if any(e < LOGIT_REL_TOL for e in
           row["logits_rel_l2_without_softmax_scale"].values()):
        raise AssertionError("the logits check cannot tell a wrong softmax "
                             "scale: " + str(row))
    return row


def post(url: str, body: dict, stream: bool):
    """POST; returns (status, payload, arrival times of the SSE events in
    seconds after the request, total seconds)."""
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    t0 = time.monotonic()
    with urllib.request.urlopen(req, timeout=600) as r:
        if not stream:
            return r.status, json.loads(r.read()), [], time.monotonic() - t0
        events, stamps = [], []
        for raw in r:
            line = raw.decode().strip()
            if line.startswith("data: "):
                events.append(line[len("data: "):])
                stamps.append(time.monotonic() - t0)
        return r.status, events, stamps, time.monotonic() - t0


def serve_checks(engine: Engine) -> dict:
    ctx = ServingContext(engine, MODEL)
    srv = make_server(ctx, host="127.0.0.1", port=0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    common = {"model": MODEL, "max_tokens": MAX_TOKENS, "temperature": 0.0,
              "ignore_eos": True}
    chat = dict(common, messages=[{"role": "user",
                                   "content": "Port this kernel to Hopper."}])
    long_text = ("The paged KV cache keeps page zero as trash. " * 14)[:596]
    jobs = {
        "chat": (base + "/v1/chat/completions", chat, False),
        # logprobs: every token gets its own SSE chunk, even one the byte
        # tokenizer decodes to no text (random weights emit ids >= 256)
        "chat_stream": (base + "/v1/chat/completions",
                        dict(chat, stream=True, logprobs=True,
                             stream_options={"include_usage": True}), True),
        "completion": (base + "/v1/completions",
                       dict(common, prompt="Hopper has 132 SMs and",
                            logprobs=1), False),
        "long_prompt": (base + "/v1/completions",
                        dict(common, prompt=long_text), False),
    }
    results = {}
    try:
        ca.reset_launch_counts()

        def run(name):
            results[name] = post(*jobs[name])

        threads = [threading.Thread(target=run, args=(n,)) for n in jobs]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        again = [post(*jobs["completion"]) for _ in range(2)]
        launches = dict(ca.LAUNCHES)
        stats = json.loads(urllib.request.urlopen(
            base + "/worker/stats", timeout=30).read())
    finally:
        srv.shutdown()
        ctx.close()
        thread.join(timeout=30)

    summary = {}
    for name, (status, payload, stamps, total) in results.items():
        if status != 200:
            raise AssertionError(f"{name}: HTTP {status}")
        if jobs[name][2]:
            if payload[-1] != "[DONE]":
                raise AssertionError(f"{name}: SSE did not end with [DONE]")
            chunks = [json.loads(e) for e in payload[:-1]]
            usage = chunks[-1]["usage"]
        else:
            usage = payload["usage"]
        if usage["completion_tokens"] != MAX_TOKENS:
            raise AssertionError(f"{name}: usage {usage}")
        summary[name] = {"prompt_tokens": usage["prompt_tokens"],
                         "completion_tokens": usage["completion_tokens"],
                         "total_s": total}
        if stamps:
            # events: role, one per token, finish, usage, [DONE]
            tok = stamps[1:1 + MAX_TOKENS]
            gaps = [b - a for a, b in zip(tok, tok[1:])]
            summary[name].update(ttft_s=tok[0],
                                 itl_mean_s=sum(gaps) / len(gaps),
                                 itl_max_s=max(gaps))
    if summary["long_prompt"]["prompt_tokens"] <= CHUNK:
        raise AssertionError("the long prompt did not take the chunked path")
    lp = [r[1]["choices"][0]["logprobs"] for r in again]
    if (lp[0]["token_logprobs"] != lp[1]["token_logprobs"]
            or lp[0]["tokens"] != lp[1]["tokens"]):
        raise AssertionError("a repeated greedy request gave other tokens")
    summary["repeat_identical"] = True
    summary["repeat_matches_concurrent_run"] = (
        results["completion"][1]["choices"][0]["logprobs"]["token_logprobs"]
        == lp[0]["token_logprobs"])
    summary["engine_metrics"] = stats["metrics"]
    missing = [k for k, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main path: "
                             f"{missing} ({launches})")
    return {"requests": summary, "launches": launches}


def kernel_family(name: str) -> str:
    low = name.lower()
    if "dtt::" in name:
        return "attention (port kernels)"
    if any(k in low for k in ("gemm", "cutlass", "xmma", "nvjet", "cublas")):
        return "matmul (cuBLAS)"
    if "memcpy" in low or "memset" in low:
        return "copies"
    return "other (elementwise, norms, rope, sampling, KV writes)"


def profile_decode(engine: Engine, steps: int = 10) -> dict:
    """Where a steady decode step's time goes: all 8 slots decoding after
    100-token prompts; `steps` steps timed on the host clock, then the same
    number under torch.profiler for device time by kernel family."""
    for i in range(MAX_SEQS):
        engine.add_request(GenRequest(f"profile-{i}", list(range(1, 101)),
                                      max_tokens=2 * steps + 8,
                                      ignore_eos=True))
    while engine.pending:
        engine.step()
    engine.step()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(steps):
        engine.step()
    torch.cuda.synchronize()
    wall_ms = (time.monotonic() - t0) / steps * 1e3
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            engine.step()
        torch.cuda.synchronize()
    while engine.has_work:
        engine.step()
    families, kernels = {}, {}
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = ev.time_range.elapsed_us() / 1e3 / steps
        fam = kernel_family(ev.name)
        families[fam] = families.get(fam, 0.0) + ms
        kernels[ev.name] = kernels.get(ev.name, 0.0) + ms
    busy = sum(families.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:8]
    return {"slots": MAX_SEQS, "steps": steps,
            "wall_ms_per_step": wall_ms,
            "device_busy_ms_per_step": busy if busy else "not measured",
            "idle_share": 1 - busy / wall_ms if busy else "not measured",
            "by_family_ms_per_step": families,
            "top_kernels_ms_per_step": [[n[:80], t] for n, t in top]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU",
              file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    t_all = time.monotonic()
    card = card_line()
    emit({"phase": "card", "nvidia_smi": card})

    t0 = time.monotonic()
    ca.build()
    ptxas = [ln.strip() for ln in ca.build_log.splitlines()
             if "registers" in ln or "spill" in ln or ln.startswith("==")]
    emit({"phase": "build", "seconds": time.monotonic() - t0,
          "ptxas": ptxas})

    rows = kernel_checks(dev)

    t0 = time.monotonic()
    engine = Engine(EngineConfig(
        model=MODEL, page_size=PS, num_pages=NUM_PAGES, max_num_seqs=MAX_SEQS,
        max_seq_len=MAX_SEQ_LEN, prefill_chunk_tokens=CHUNK,
        enable_prefix_caching=False, seed=0))
    emit({"phase": "engine", "model": MODEL, "seconds": time.monotonic() - t0,
          "layers": engine.model_cfg.num_layers,
          "hidden": engine.model_cfg.hidden_size,
          "weights_gib": sum(p.numel() * p.element_size()
                             for p in engine.model.parameters()) / 2**30,
          "kv_pool_gib": 2 * engine.k_pages.numel()
          * engine.k_pages.element_size() / 2**30})
    with torch.inference_mode():
        forward_checks(engine)

    served = serve_checks(engine)
    emit({"phase": "serve", **served["requests"]})
    with torch.inference_mode():
        emit({"phase": "profile", **profile_decode(engine)})

    kernels = []
    for name, row in rows.items():
        source, replaces = SOURCES[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": served["launches"][name],
            "max_abs_err": row["max_abs_err"], "ms": row["kernel_ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]})
    emit({"kernels": kernels})
    emit({"phase": "done", "seconds": time.monotonic() - t_all,
          "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
