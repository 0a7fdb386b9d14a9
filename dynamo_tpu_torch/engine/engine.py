"""The PyTorch engine: paged KV cache, continuous batching, chunked prefill,
multi-step decode windows on CUDA graphs, async scheduling and automatic
prefix caching.

Port of the aggregated-serving core of `dynamo_tpu/engine/engine.py`:

- Admission with power-of-two prefill buckets (`_next_bucket`), batched
  prefill of same-bucket prompts (up to `max_prefill_batch`) and the
  single-prompt prefill.
- Chunked prefill, one chunk per step, interleaved with decode, on a
  trash-padded page list (`KVCacheSpec.page_table_width`), for prompts
  longer than `prefill_chunk_tokens`, for prefix-cache hits (the suffix
  only) and, with `mixed_batch_tokens`, for every prompt that arrives
  while streams decode.
- Decode windows of up to `num_scheduler_steps` steps over all
  `max_num_seqs` slots (`_window_steps`: k steps only when every live
  sequence has k tokens of headroom and nothing is pending), with the
  batch carried on the device (`engine/decode_graphs.py`: static buffers
  rebuilt from the host mirrors only when membership, pages or sampling
  change; inactive slots on the trash page at context 1) and each window
  k replays of a CUDA-graph-captured step on the card. Tokens past a stop
  are discarded when the window is read back (`_materialize_window`).
- `async_scheduling`: window k+1 is dispatched before window k is read
  back (a non-blocking copy into pinned memory and an event); admissions,
  aborts, finishes, preemptions and mixed steps drain the pipeline, so the
  streams are those of synchronous stepping.
- The mixed step (`mixed_batch_tokens > 0`): while a chunked prefill is in
  flight and decode slots are live, one eager forward (`llama.mixed_step`,
  one ragged attention launch per layer) advances every slot by a token
  AND the prefill by up to `mixed_batch_tokens`.
- Automatic prefix caching (`enable_prefix_caching`, with chunked
  prefill): `PrefixCache` lookup before the page gate, the cached pages
  shared, the suffix prefilled, every completed prompt's full pages
  published, and eviction of unshared cached pages as the pressure valve
  (`_ensure_pages`).
- The KVBM host tier behind it (`kvbm_host_blocks > 0`, `kvbm_gate`,
  `kvbm_disk_dir`, `kvbm_disk_blocks`; `kvbm/manager.py`): evicted prefix
  pages demote into pinned host arenas (and a disk tier) and a lookup's
  miss onboards them back into the live pools in place, gated by the
  restore-vs-recompute roofline; `set_kv_event_sink` attaches the KV event
  plane (stored, demoted and removed blocks).
- Per-tenant QoS (`tenants` or `DYNAMO_TPU_TENANTS`, `qos_burst_tokens`;
  `qos/tenancy.py`): queue priority offsets per tenant class, fair decode
  slot caps, deferral of over-budget tenants, one preemption (by
  recompute) per step of an over-budget or batch-class sequence for a
  starved tenant, and each step's tokens banked into the weighted-fair
  budgets, as in the JAX engine.
- int8 KV pools (`kv_cache_dtype="int8"`: packed values and per-head
  scales, about half the bf16 pool's bytes).
- Weights from a local safetensors checkpoint (`model_path`, whose
  config.json also gives the ModelConfig) or seeded random init, float or
  int8 (`quantization`: "int8" weight-only or "w8a8"; `models.quant`).
- Speculative decoding (`speculative_mode` "ngram" or "model"): each
  decode step becomes one verify step (`llama.decode_verify`, a CUDA
  graph on the card: `decode_graphs.VerifySteps`) over every slot's
  current token and K drafts, from prompt lookup (`_propose_ngram`) or a
  draft model (`speculation.DraftEngine`), with an optional per-slot
  `AdaptiveK`; `sampling.verify_accept` keeps the longest prefix of drafts
  the sampling chain draws, so each slot emits 1 to K+1 tokens and the
  streams are those of spec-off decoding. With a chunk in flight in mixed
  mode the verify windows ride the ragged step (`llama.mixed_verify_step`,
  eager). Logprobs requests demote the step to plain decode; penalized
  slots and slots without room for the window emit one token, each
  demotion counted by reason.
- JSON-guided decoding (`guided_json`: OpenAI response_format
  json_object and forced tool calls): the grammar kernel
  (`ops/cuda_guide.py`) masks the prefill logits of a guided request's
  first token, and every decode step of a batch with a guided sequence
  masks the logits and advances the grammar state on the device (inside
  the captured step), with a host mirror per sequence replayed at
  admission and advanced at readback; guided sequences keep the classic
  paths (no mixed step) and demote speculation (reason "guided"), as in
  JAX.
- Multi-LoRA serving (`lora_slots`, `lora_rank`, `lora_adapters`): a
  `lora.registry.LoRARegistry` of device slots whose stacks every forward
  reads with each sequence's slot (`DeviceBatch.adapters` in the captured
  steps); admission acquires the adapter's slot (a request waits while
  every slot serves live sequences) and the prefix cache keys pages by
  adapter.
- Disaggregated serving (`disaggregation_mode` "prefill" or "decode"):
  the prefill role's `prefill_only` runs a whole prompt at its bucket,
  samples the first token and parks the pages until `export_kv` (host
  tensors, the TCP plane) or `export_kv_device` (a fresh device gather,
  the in-process and CUDA IPC planes) hands them over and
  `release_parked` or the TTL sweep (`expire_parked`) frees them; the
  decode role's `import_kv` scatters them into its pools in place (the
  captured graphs keep their addresses) and installs the sequence, whose
  chain root is the prefill's, so seeded sampling and the grammar state
  continue exactly (`serving/disagg.py`, `transfer/kv_transfer.py`).
- Stops (stop ids, model eos unless `ignore_eos`, `max_tokens`,
  `max_seq_len`), aborts, logprobs, OutOfPages deferral at admission and
  preemption by recompute when decode runs out of pages.
- The lifecycle hooks of the JAX engine: the watchdog
  (`robustness/watchdog.py`, fed by the timeline's device seams; the
  kernel library's first build and graph captures run exempt, and an open
  profiler session keeps seams unarmed), the integrity sentinels
  (`DYNAMO_TPU_INTEGRITY`: a prefill lane's `isfinite(...).all` flag read
  back with its first token, and the decode readbacks' token-range check,
  each aborting exactly the poisoned stream with `integrity_fault`), the
  fault points `engine.device_nan`, `engine.device_hang` (a device-side
  spin on the card) and `engine.device_slow`, `resurrect` (the pools and
  the batch buffers zeroed and the weights restaged in their own storage,
  so every captured graph stays valid), `device_poisoned` (one probe of
  the CUDA context), the weight manager (`elasticity/weights.py`: its
  armed flip applies at the step boundary, admissions hold meanwhile, and
  the active version seeds the prefix cache's namespace), and resumable
  sampling state (`resume_key`, `export_sampling_state`).

Runs on the card by default (`device=None` means CUDA and raises without
it; the tests pass `device="cpu"`), in bf16 there and float32 on the CPU,
the JAX engine's choice. The prefills and the mixed step run eagerly, the
decode windows on CUDA graphs (eagerly on the CPU and with
`enforce_eager`), as the JAX engine's windows are its only fused programs.
Settings this port does not serve yet are refused at construction with
NotImplementedError naming the field.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import logging
import threading
import time
from typing import ClassVar, Dict, List, Optional, Tuple

import numpy as np
import torch

from dynamo_tpu_torch.engine import sampling as smp
from dynamo_tpu_torch.engine.config import EngineConfig
from dynamo_tpu_torch.engine.decode_graphs import (
    DecodeWindows,
    DeviceBatch,
    Readback,
    VerifySteps,
    upload,
)
from dynamo_tpu_torch.engine.kv_cache import (
    KVCacheSpec,
    OutOfPages,
    PageAllocator,
    PrefixCache,
    SeqState,
    alloc_kv_pages,
)
from dynamo_tpu_torch.engine.request import GenRequest, TokenEvent
from dynamo_tpu_torch.engine.tokenizer import get_tokenizer
from dynamo_tpu_torch.elasticity.weights import WeightManager
from dynamo_tpu_torch.kvbm.manager import KVBM
from dynamo_tpu_torch.lora.registry import (LoRARegistry, NoFreeAdapterSlot,
                                            parse_adapter_list)
from dynamo_tpu_torch.models import llama, loader, quant
from dynamo_tpu_torch.models.config import ModelConfig
from dynamo_tpu_torch.observability.cost import CostLedger
from dynamo_tpu_torch.observability.flight import FlightRecorder
from dynamo_tpu_torch.observability.timeline import StepTimeline
from dynamo_tpu_torch.ops import cuda_attention, cuda_guide, json_guide
from dynamo_tpu_torch.qos.tenancy import (BATCH_PRIORITY_PENALTY,
                                          BATCH_VICTIM_PENALTY,
                                          OVER_BUDGET_PENALTY,
                                          TenantAccountant, TenantRegistry)
from dynamo_tpu_torch.robustness import faults
from dynamo_tpu_torch.robustness.watchdog import (EngineWatchdog,
                                                  integrity_mode)
from dynamo_tpu_torch.speculation import AdaptiveK, DraftEngine

log = logging.getLogger("dynamo_tpu_torch.engine")


def resolve_device(device=None) -> torch.device:
    """The engine's device: CUDA unless the caller names another; never a
    silent fall back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the engine runs on the GPU unless "
            "device='cpu' is passed explicitly")
    return dev


def unported_settings(cfg: EngineConfig) -> List[str]:
    """EngineConfig fields set to something the port does not serve."""
    checks = [
        ("tensor_parallel", cfg.tensor_parallel > 1),
        ("data_parallel", cfg.data_parallel > 1),
        ("expert_parallel", cfg.expert_parallel > 1),
        ("sequence_parallel", cfg.sequence_parallel > 1),
    ]
    return [name for name, bad in checks if bad]


def _profiler_open() -> Optional[str]:
    """The watchdog's exemption probe: "profiler" while a torch.profiler
    session is open (CUPTI's start and the windows right after it run
    seconds long); a host-side flag, no CUDA call."""
    return "profiler" if torch._C._autograd._profiler_enabled() else None


def _pack_logit_bias(req: GenRequest):
    """A request's {token_id: bias} map as fixed [BIAS_K] lanes (-1 =
    empty). Oversized maps raise rather than drop biases."""
    ids = np.full((smp.BIAS_K,), -1, np.int64)
    vals = np.zeros((smp.BIAS_K,), np.float32)
    if req.logit_bias:
        if len(req.logit_bias) > smp.BIAS_K:
            raise ValueError(
                f"logit_bias has {len(req.logit_bias)} entries; the engine "
                f"supports at most {smp.BIAS_K}")
        for i, (tok, b) in enumerate(req.logit_bias.items()):
            ids[i] = int(tok)
            vals[i] = float(b)
    return ids, vals


def check_spec_config(cfg: EngineConfig) -> None:
    """The JAX engine's speculative-decoding gates, with its messages: K
    bounds the verify window (K+1 queries must fit one KV page and one
    ragged query block), the proposer needs a pattern token, and a draft
    pool must hold one window."""
    if cfg.speculative_mode == "off":
        return
    k = cfg.num_speculative_tokens
    if k <= 0:
        raise ValueError(
            f"--num-speculative-tokens must be >= 1 when "
            f"--speculative-mode is on (got {k})")
    if k >= cfg.page_size:
        raise ValueError(
            f"--num-speculative-tokens ({k}) must be < --page-size "
            f"({cfg.page_size}): the K+1-token verify window must "
            f"fit one KV page / ragged query block")
    if cfg.ngram_lookup < 1:
        raise ValueError(
            f"--ngram-lookup must be >= 1 (got {cfg.ngram_lookup})")
    if cfg.drafter not in ("ngram", "model"):
        raise ValueError(
            f"--drafter must be 'ngram' or 'model' (got "
            f"{cfg.drafter!r})")
    if ("model" in (cfg.speculative_mode, cfg.drafter)
            and cfg.resolved_draft_pages() < k + 1):
        raise ValueError(
            f"--draft-num-pages ({cfg.resolved_draft_pages()}) must "
            f"be >= K+1 ({k + 1}): one verify window drafts K "
            f"tokens plus the bonus position and must fit the "
            f"draft pool even before its LRU arm can shed slots")


def _next_bucket(n: int, page_size: int, max_len: int) -> int:
    """Smallest power-of-two multiple of page_size >= n (capped at max_len
    rounded up to a page multiple)."""
    cap = -(-max_len // page_size) * page_size
    b = page_size
    while b < n:
        b *= 2
    return min(b, cap)


# accepted drafts per speculating slot per verify step: the JAX engine's
# histogram edges (K < page_size keeps them small)
SPEC_EDGES = (0, 1, 2, 3, 4, 6, 8)
# decode-window batch occupancy (active slots / max_num_seqs) and the mixed
# step's prefill-token fraction share these edges, as in the JAX engine
OCC_EDGES = (0.125, 0.25, 0.375, 0.5, 0.625, 0.75, 0.875, 1.0)
# the JAX engine's phase timers
PHASES = ("prefill", "prefill_chunk", "decode_window", "decode_step",
          "mixed_step")


def _bucketize(buckets: List[int], n, edges=SPEC_EDGES) -> None:
    for i, edge in enumerate(edges):
        if n <= edge:
            buckets[i] += 1
            return
    buckets[-1] += 1


class PhaseTimer:
    """Bucketed per-phase latency histogram (quarter-octave log buckets,
    0.25ms..8s), the JAX engine's: cheap enough to run always-on in the
    hot loop, and bridged onto /metrics as
    `dynamo_engine_phase_seconds` (observability/engine_metrics.py)."""

    _EDGES_MS = [0.25 * 2 ** (i / 4) for i in range(61)]  # 0.25ms .. ~8.2s

    def __init__(self):
        self.count = 0
        self.sum_s = 0.0
        self.max_s = 0.0
        self.buckets = [0] * (len(self._EDGES_MS) + 1)

    def observe(self, seconds: float, weight: int = 1) -> None:
        """Record `weight` observations of `seconds` (a window's per-step
        time counts once PER STEP, so a tail of 1-step windows cannot
        outvote the steady-state windows in the quantiles)."""
        self.count += weight
        self.sum_s += seconds * weight
        if seconds > self.max_s:
            self.max_s = seconds
        ms = seconds * 1e3
        lo, hi = 0, len(self._EDGES_MS)
        while lo < hi:  # first edge >= ms (binary search; 61 edges)
            mid = (lo + hi) // 2
            if ms <= self._EDGES_MS[mid]:
                hi = mid
            else:
                lo = mid + 1
        self.buckets[lo] += weight

    def quantile_ms(self, q: float) -> float:
        """Geometric-midpoint estimate of the q-quantile from the buckets."""
        if self.count == 0:
            return 0.0
        target = q * self.count
        seen = 0
        for i, n in enumerate(self.buckets):
            seen += n
            if seen >= target:
                if i >= len(self._EDGES_MS):
                    # overflow bucket: the top edge is a LOWER bound here
                    return self._EDGES_MS[-1]
                hi = self._EDGES_MS[i]
                lo_edge = self._EDGES_MS[i - 1] if i > 0 else hi / 2 ** 0.25
                return (lo_edge * hi) ** 0.5
        return self._EDGES_MS[-1]

    def snapshot(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "sum_s": round(self.sum_s, 6),
            "mean_ms": round(1e3 * self.sum_s / self.count, 3)
            if self.count else 0.0,
            "p50_ms": round(self.quantile_ms(0.5), 3),
            "p95_ms": round(self.quantile_ms(0.95), 3),
            "max_ms": round(self.max_s * 1e3, 3),
        }


def _zeros(n: int):
    return dataclasses.field(default_factory=lambda: [0] * n)


@dataclasses.dataclass
class EngineMetrics:
    # the edges the /metrics bridge reads (the JAX engine's class names)
    _OCC_EDGES: ClassVar[Tuple[float, ...]] = OCC_EDGES
    _SPEC_EDGES: ClassVar[Tuple[int, ...]] = SPEC_EDGES

    num_requests: int = 0
    num_finished: int = 0
    prompt_tokens: int = 0
    output_tokens: int = 0
    decode_steps: int = 0  # a verify step counts as one
    prefill_time_s: float = 0.0
    decode_time_s: float = 0.0
    kv_oom: int = 0
    num_preempted: int = 0
    mixed_count: int = 0  # mixed steps (each also counts as a decode step)
    # speculative decoding, as the JAX engine books it: drafts offered and
    # accepted (the bonus token counts in neither), accepted drafts per
    # speculating slot per verify step (SPEC_EDGES buckets), the same per
    # drafter, verify steps, those that rode the mixed step, and the
    # demotions to one token per step by reason
    spec_draft_tokens: int = 0
    spec_accepted_tokens: int = 0
    spec_accept_buckets: List[int] = _zeros(len(SPEC_EDGES) + 1)
    spec_accept_sum: int = 0
    spec_accept_count: int = 0
    spec_draft_by: Dict[str, int] = dataclasses.field(default_factory=dict)
    spec_accepted_by: Dict[str, int] = dataclasses.field(
        default_factory=dict)
    spec_hist_by: Dict[str, List[int]] = dataclasses.field(
        default_factory=dict)
    spec_sum_by: Dict[str, int] = dataclasses.field(default_factory=dict)
    spec_count_by: Dict[str, int] = dataclasses.field(default_factory=dict)
    spec_verify_steps: int = 0
    mixed_spec_count: int = 0
    spec_demotions: Dict[str, int] = dataclasses.field(default_factory=dict)
    # decode-window batch occupancy and the mixed steps' prefill-token
    # fraction (OCC_EDGES buckets), and the per-phase timers
    occupancy_buckets: List[int] = _zeros(len(OCC_EDGES) + 1)
    occupancy_sum: float = 0.0
    occupancy_count: int = 0
    mixed_buckets: List[int] = _zeros(len(OCC_EDGES) + 1)
    mixed_sum: float = 0.0
    mixed_prefill_tokens: int = 0
    phases: Dict[str, PhaseTimer] = dataclasses.field(
        default_factory=lambda: {p: PhaseTimer() for p in PHASES})

    def observe_phase(self, phase: str, seconds: float,
                      weight: int = 1) -> None:
        self.phases[phase].observe(seconds, weight)

    def observe_occupancy(self, active: int, capacity: int) -> None:
        """One decode window's batch occupancy fraction."""
        frac = active / max(capacity, 1)
        _bucketize(self.occupancy_buckets, frac, OCC_EDGES)
        self.occupancy_sum += frac
        self.occupancy_count += 1

    def observe_mixed(self, prefill_tokens: int, decode_rows: int) -> None:
        """One mixed step's composition: the prefill-token fraction of its
        rows."""
        frac = prefill_tokens / max(prefill_tokens + decode_rows, 1)
        _bucketize(self.mixed_buckets, frac, OCC_EDGES)
        self.mixed_sum += frac
        self.mixed_count += 1
        self.mixed_prefill_tokens += prefill_tokens

    def observe_spec_accept(self, n_acc: int,
                            drafter: Optional[str] = None) -> None:
        """One speculating slot's accepted-draft count for one verify
        step, also filed under its drafter."""
        _bucketize(self.spec_accept_buckets, n_acc)
        self.spec_accept_sum += n_acc
        self.spec_accept_count += 1
        if drafter is not None:
            _bucketize(self.spec_hist_by.setdefault(
                drafter, [0] * (len(SPEC_EDGES) + 1)), n_acc)
            self.spec_sum_by[drafter] = (
                self.spec_sum_by.get(drafter, 0) + n_acc)
            self.spec_count_by[drafter] = (
                self.spec_count_by.get(drafter, 0) + 1)

    def add_spec_tokens(self, drafted: int, accepted: int,
                        drafter: Optional[str] = None) -> None:
        """One verify step's draft and accept totals."""
        self.spec_draft_tokens += drafted
        self.spec_accepted_tokens += accepted
        if drafter is not None:
            self.spec_draft_by[drafter] = (
                self.spec_draft_by.get(drafter, 0) + drafted)
            self.spec_accepted_by[drafter] = (
                self.spec_accepted_by.get(drafter, 0) + accepted)

    def demote(self, reason: str) -> None:
        self.spec_demotions[reason] = self.spec_demotions.get(reason, 0) + 1

    def snapshot(self) -> Dict[str, object]:
        """/worker/stats' `metrics`: the counters, the phase timers'
        digests and the histograms' means (the buckets ride /metrics)."""
        skip = ("spec_accept_buckets", "spec_draft_by", "spec_accepted_by",
                "spec_hist_by", "spec_sum_by", "spec_count_by",
                "occupancy_buckets", "mixed_buckets", "phases")
        out = {f.name: getattr(self, f.name)
               for f in dataclasses.fields(self) if f.name not in skip}
        out["spec_demotions"] = dict(self.spec_demotions)
        out["phases"] = {p: t.snapshot() for p, t in self.phases.items()}
        out["spec_accept_mean"] = (
            round(self.spec_accept_sum / self.spec_accept_count, 4)
            if self.spec_accept_count else 0.0)
        out["spec_by_drafter"] = {
            d: {"draft_tokens": self.spec_draft_by.get(d, 0),
                "accepted_tokens": self.spec_accepted_by.get(d, 0),
                "acceptance_rate": (
                    round(self.spec_accepted_by.get(d, 0)
                          / self.spec_draft_by[d], 4)
                    if self.spec_draft_by.get(d) else 0.0),
                "accept_mean": (
                    round(self.spec_sum_by.get(d, 0) / self.spec_count_by[d],
                          4) if self.spec_count_by.get(d) else 0.0)}
            for d in sorted(set(self.spec_draft_by)
                            | set(self.spec_count_by))}
        out["occupancy_mean"] = (
            round(self.occupancy_sum / self.occupancy_count, 4)
            if self.occupancy_count else 0.0)
        out["mixed_frac_mean"] = (
            round(self.mixed_sum / self.mixed_count, 4)
            if self.mixed_count else 0.0)
        return out


class InflightPrefill:
    """A long prompt being prefilled chunk by chunk between decode steps."""

    __slots__ = ("req", "pages", "pages_dev", "prompt_len", "done", "slot",
                 "aslot", "t_start")

    def __init__(self, req: GenRequest, pages, pages_dev, prompt_len: int,
                 slot: int, aslot: int = 0):
        self.req = req
        self.pages = pages  # real page ids (allocator-owned)
        self.pages_dev = pages_dev  # trash-padded page list on the device
        self.prompt_len = prompt_len
        self.done = 0  # tokens whose KV is cached so far
        self.slot = slot  # decode slot reserved at admission
        self.aslot = aslot  # LoRA slot (0 = base), pinned while in flight
        self.t_start = time.monotonic()  # admission (TTFT accounting)


class Engine:
    """Single-replica engine: owns the model, the KV pools and the batch."""

    def __init__(self, cfg: EngineConfig,
                 model_cfg: Optional[ModelConfig] = None, params=None,
                 device=None, draft_params=None):
        """`params`: None (the checkpoint under cfg.model_path, else random
        init from cfg.seed; `models.loader.load_or_init`), a
        `models.llama.Llama` on `device` whose quantization mode is
        cfg.quantization's, or a JAX parameter tree of numpy arrays, float
        or quantized (carried across by `models.loader.from_jax_params`,
        which quantizes a float tree when cfg.quantization asks).
        `draft_params`: the draft model's weights for the model drafter,
        the same kinds (None: `speculation.DraftEngine` loads them)."""
        bad = unported_settings(cfg)
        if bad:
            raise NotImplementedError(
                f"EngineConfig field(s) {bad} are not ported to "
                f"dynamo_tpu_torch yet (see ROADMAP.md)")
        check_spec_config(cfg)
        self.device = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        default_dtype = "float32" if self.device.type == "cpu" else "bfloat16"
        if model_cfg is None:
            model_cfg = ModelConfig.from_model_name(
                cfg.model_path or cfg.model, dtype=cfg.dtype or default_dtype)
        bad = llama.unported_model_features(model_cfg)
        if bad:
            raise NotImplementedError(
                f"ModelConfig feature(s) {bad} of {model_cfg.name} are not "
                f"ported to dynamo_tpu_torch yet (see ROADMAP.md)")
        if cfg.moe_capacity_factor > 0:
            # the prefills' MoE capacity path (models/llama.py `_mlp`)
            model_cfg = dataclasses.replace(
                model_cfg, moe_capacity_factor=cfg.moe_capacity_factor)
        self.model_cfg = model_cfg
        self.dtype = getattr(torch, model_cfg.dtype)
        self.kv_spec = KVCacheSpec.from_model(
            model_cfg, cfg.num_pages, cfg.page_size, cfg.kv_cache_dtype)
        if cfg.mixed_batch_tokens > 0:
            # the mixed step writes the chunk's KV in whole pages, so its
            # budget is a page multiple; it implies chunked prefill, and an
            # unset chunk size takes the same value
            mixed = -(-cfg.mixed_batch_tokens // cfg.page_size) * cfg.page_size
            cfg = dataclasses.replace(
                cfg, mixed_batch_tokens=mixed,
                prefill_chunk_tokens=cfg.prefill_chunk_tokens or mixed)
        if cfg.prefill_chunk_tokens > 0:
            # chunks scatter whole pages: round up to a page multiple
            rounded = -(-cfg.prefill_chunk_tokens
                        // cfg.page_size) * cfg.page_size
            if rounded != cfg.prefill_chunk_tokens:
                cfg = dataclasses.replace(cfg, prefill_chunk_tokens=rounded)
        self.cfg = cfg
        self.metrics = EngineMetrics()
        self._lock = threading.Lock()  # guards pending + _aborted
        self._exec_lock = threading.RLock()  # serialises step()
        # the observability plane, as in the JAX engine: one flight record
        # per step (DYNAMO_TPU_FLIGHT_RECORDS, 0 disables), one cost-ledger
        # entry per executed segment, the step timeline's phase intervals
        # and host gaps (DYNAMO_TPU_TIMELINE); all read their switches here
        self.flight = FlightRecorder()
        self.cost = CostLedger()
        self.timeline = StepTimeline()
        # per-tenant QoS: weighted-fair token budgets over the tenant each
        # request carries (resolved by the serving layer). Over-budget
        # tenants defer admission, lose group widening and rank first as
        # preemption victims. None without configured tenants: the
        # scheduler then behaves as without QoS.
        self.tenant_registry = (TenantRegistry.from_json(cfg.tenants)
                                if cfg.tenants else TenantRegistry.from_env())
        self.qos: Optional[TenantAccountant] = None
        if self.tenant_registry.enabled:
            self.qos = TenantAccountant(
                self.tenant_registry, burst_tokens=cfg.qos_burst_tokens)
            log.info("per-tenant QoS: %d classes, burst %d tokens",
                     len(self.tenant_registry.classes), self.qos.burst)
            # the preemptible batch tier prices as its own rollup row
            reg = self.tenant_registry
            self.cost.tier_of = (
                lambda t: "batch" if reg.is_batch(t) else "interactive")
        # request_id -> tenant, for budget accounting of TokenEvents whose
        # sequence may already be gone by the time step() returns them
        # (kept with QoS on only)
        self._rid_tenant: Dict[str, str] = {}
        # the engine watchdog: every device seam of the timeline arms a
        # hang deadline, derived from the seams' own times on the card
        # (the CPU path only trips on an explicit override, as the JAX
        # engine's CPU fallback); the sentinel tier is a boot knob
        self.watchdog = EngineWatchdog(
            self, derive_deadline=self.device.type == "cuda")
        self.watchdog.exempt_probe = _profiler_open
        self.timeline.watch = self.watchdog
        self.integrity = integrity_mode()
        self.last_resurrect_s: Optional[float] = None
        # called with the request ids abort_all tore down (the serving
        # layer ends their streams)
        self.on_abort_all = None
        # Engine.warmup's kernel build and captures (the warmup gauge)
        self.warmup_info: Optional[Dict[str, float]] = None

        mode = quant.mode_name(cfg.quantization)
        if params is None:
            self.model = loader.load_or_init(
                model_cfg, cfg.model_path, seed=cfg.seed, quantization=mode,
                device=self.device, dtype=self.dtype)
        elif isinstance(params, llama.Llama):
            # the engine's ModelConfig, not the one the weights were made
            # under (llama.with_config raises where the shapes differ)
            self.model = llama.with_config(params, model_cfg)
        else:
            self.model = loader.from_jax_params(model_cfg, params,
                                                device=self.device,
                                                dtype=self.dtype,
                                                quantization=mode)
        if quant.mode_of(self.model) != mode:
            raise ValueError(f"the weights are {quant.mode_of(self.model)!r}"
                             f" but quantization={cfg.quantization!r}")
        log.info("weights: %s (quantization %s), %d bytes", model_cfg.name,
                 mode, quant.param_bytes(self.model))
        # live elasticity: the weight version and its double buffer; a
        # flip swaps contents in the live storage, so the captured steps
        # read the active version (elasticity/weights.py)
        self.weights = WeightManager(self, version=cfg.model_version)

        self.k_pages, self.v_pages = alloc_kv_pages(self.kv_spec,
                                                    self.device)
        log.info("KV pools: %s, %d pages of %d tokens, %d lanes per row, "
                 "%d bytes", self.kv_spec.dtype, cfg.num_pages,
                 cfg.page_size, self.kv_spec.lane_width,
                 self.kv_spec.pool_bytes)
        self.allocator = PageAllocator(cfg.num_pages)
        self._page_nbytes = self.kv_spec.bytes_per_token() * cfg.page_size
        # prefix hits re-enter as mid-prompt chunks, so the cache needs a
        # chunked path (classic or mixed), as in the JAX engine
        self.prefix_cache: Optional[PrefixCache] = None
        if cfg.enable_prefix_caching and cfg.prefill_chunk_tokens > 0:
            self.prefix_cache = PrefixCache(self.allocator, cfg.page_size)
        # the KVBM host tier: evicted prefix pages demote to pinned host
        # arenas (and optionally disk) instead of dying; lookups onboard
        # them back, cost-gated (kvbm/manager.py)
        self.kvbm: Optional[KVBM] = None
        self._kv_event_sink = None  # set_kv_event_sink's
        if self.prefix_cache is not None and cfg.kvbm_host_blocks > 0:
            self.kvbm = KVBM(self)
            self.prefix_cache.kvbm = self.kvbm
            log.info(
                "kvbm host tier: %d blocks x %d bytes (%.1f MiB host RAM%s),"
                " gate=%s%s", cfg.kvbm_host_blocks,
                self.kvbm.pool.block_nbytes,
                cfg.kvbm_host_blocks * self.kvbm.pool.block_nbytes / 2**20,
                ", pinned" if self.kvbm.pool.pinned else "", cfg.kvbm_gate,
                f", disk tier at {cfg.kvbm_disk_dir}"
                if cfg.kvbm_disk_dir else "")

        b, pmax = cfg.max_num_seqs, cfg.max_pages_per_seq
        # host mirrors of the batch; the device copies in self.batch are
        # rebuilt from them when marked stale (_ensure_dev_state)
        self.block_tables = np.zeros((b, pmax), dtype=np.int32)
        self.temperature = np.zeros((b,), np.float32)
        self.top_p = np.ones((b,), np.float32)
        self.top_k = np.zeros((b,), np.int64)
        self.presence = np.zeros((b,), np.float32)
        self.frequency = np.zeros((b,), np.float32)
        self.min_p = np.zeros((b,), np.float32)
        self.bias_ids = np.full((b, smp.BIAS_K), -1, np.int64)
        self.bias_vals = np.zeros((b, smp.BIAS_K), np.float32)
        self.slot_keys = np.zeros((b,), np.int64)  # sampling chain roots
        self.adapter_slots = np.zeros((b,), np.int32)  # LoRA slots, 0 = base
        spec_k = (cfg.num_speculative_tokens
                  if cfg.speculative_mode != "off" else 0)
        self.batch = DeviceBatch(b, pmax, model_cfg.vocab_size,
                                 max(1, cfg.num_scheduler_steps), self.device,
                                 spec_k=spec_k)
        # output-token counts for presence/frequency penalties [B, V]
        self.token_counts = self.batch.token_counts
        self.windows = DecodeWindows(
            self.batch, self._decode_forward,
            eager=self.device.type != "cuda" or cfg.enforce_eager)
        # a lazy capture runs inside a dispatch seam: seconds, not a hang
        self.windows.capture_guard = (
            lambda: self.watchdog.exempt("graph_capture"))
        # speculative decoding: the verify step, its readback, the
        # proposer (drafter_name labels the spec metrics) and the adaptive
        # window controller
        self.verify: Optional[VerifySteps] = None
        self.drafter_name: Optional[str] = None
        self.draft = None
        self._adaptive = None
        if spec_k:
            self.verify = VerifySteps(self.windows, self._verify_forward)
            self._spec_readback = Readback((self.batch.out_emitted,
                                            self.batch.out_nacc))
            self.drafter_name = ("model" if "model" in (cfg.speculative_mode,
                                                        cfg.drafter)
                                 else "ngram")
            if self.drafter_name == "model":
                self.draft = DraftEngine(self, draft_params)
            if cfg.spec_adaptive_k:
                self._adaptive = AdaptiveK(spec_k)
        self._dev_state_ok = False  # tokens, positions, contexts, step
        self._dev_tables_ok = False
        self._dev_sampling_ok = False
        self._gates = smp.gates(self.temperature, self.top_p, self.top_k,
                                self.presence, self.frequency, self.min_p,
                                self.bias_ids)
        # dispatched but unread decode window (async scheduling): (window,
        # readback, want_lp, dispatch seconds, slots at dispatch)
        self._pending_win = None
        self._readbacks = (Readback(self.batch.outputs(True)),
                           Readback(self.batch.outputs(True)))
        self._next_readback = 0
        self.seqs: Dict[int, SeqState] = {}
        self._free_slots = list(range(b - 1, -1, -1))
        # guarded_by: _lock (both)
        self.pending: collections.deque = collections.deque()
        self._aborted: set = set()
        self._inflight: Optional[InflightPrefill] = None
        # disagg prefill role: request_id -> (pages, n_tokens, parked at)
        # held for export (guarded_by: _lock)
        self._parked: Dict[str, tuple] = {}
        # disagg decode role: events of a window an import drained, handed
        # out by the next step
        self._deferred: List[TokenEvent] = []
        self._rng = np.random.default_rng(cfg.seed)  # unseeded chain roots
        # JSON-guided decoding: the vocab byte table (host; its device copy
        # is windows.guide), built at first use
        self._guide_table: Optional[json_guide.VocabTable] = None
        # multi-LoRA serving: the adapter registry and its device stacks,
        # with the boot adapters registered (loaded into slots at first use)
        self.lora: Optional[LoRARegistry] = None
        if cfg.lora_slots > 0:
            self.lora = LoRARegistry(self)
            for name, path in parse_adapter_list(cfg.lora_adapters or ""):
                self.lora.register(name, path=path)
            log.info("multi-LoRA serving: %d device slots x rank <= %d "
                     "(%d bytes of stacks; boot adapters: %s)",
                     cfg.lora_slots, cfg.lora_rank, self.lora.stacks.nbytes,
                     self.lora.names() or "none")

    # ------------------------------------------------------------- intake --

    def warmup(self) -> None:
        """Build the kernels and capture the greedy decode steps (with and
        without logprobs, plain and JSON-guided: any request may ask for
        response_format json_object), and with speculation the greedy
        verify step and the draft model's step, before serving, on the
        card; the eager prefills have nothing to compile. A disagg prefill
        role captures nothing (it never decodes) and runs one
        prefill_only; a decode role also runs the import's scatter once.
        Needs an idle engine. `warmup_info` keeps the graphs captured and the seconds
        outside the captures (the kernel build), which the warmup gauge
        adds to every capture's time."""
        if self.device.type != "cuda":
            return
        if self.has_work:
            raise RuntimeError("warmup() requires an idle engine")
        from dynamo_tpu_torch.ops import cuda_attention

        t0 = time.monotonic()
        captured = self.capture_seconds()
        cuda_attention.build()
        role = self.cfg.disaggregation_mode
        if role == "prefill":
            # the prefill role serves prompts through prefill_only alone
            # and never decodes: one whole-prompt prefill warms its path
            # (JAX runs prefill_only at every bucket: its programs compile)
            self.prefill_only(GenRequest(
                "__warm_prefill", [1, 2, 3], max_tokens=1, temperature=0.0,
                ignore_eos=True))
            self.release_parked("__warm_prefill")
        elif not self.windows.eager:
            with self._exec_lock, torch.inference_mode():
                self._ensure_dev_state()
                self._ensure_guide_table()
                greedy = smp.gates([0.0], [1.0], [0], [0.0], [0.0], [0.0],
                                   [-1])
                for want_lp in (False, True):
                    for guided in (False, True):
                        if (want_lp, guided, greedy) not in \
                                self.windows.graphs:
                            self.windows.capture(want_lp, greedy, guided)
                if (self.verify is not None
                        and greedy not in self.verify.graphs):
                    self.verify.capture(greedy)
                if self.draft is not None and self.draft._graph is None:
                    self.draft.capture()
                if role == "decode":
                    # the import's in-place scatter, once, onto the trash
                    # page (JAX compiles its import program here)
                    zero = torch.zeros_like(self.k_pages[:, :1])
                    page0 = self._tensor([0], torch.long)
                    for pool in (self.k_pages, self.v_pages):
                        pool.transpose(0, 1).index_copy_(
                            0, page0, zero.transpose(0, 1))
                torch.cuda.synchronize(self.device)
        wall = time.monotonic() - t0
        self.warmup_info = {
            "programs": self.compiled_program_count(),
            "seconds": wall - (self.capture_seconds() - captured)}
        log.info("warmup complete: %s", self.warmup_info)

    def compiled_program_count(self) -> int:
        """CUDA graphs captured so far: decode windows, verify steps and
        the draft model's step (the JAX engine counts its jit caches)."""
        n = len(self.windows.graphs)
        if self.verify is not None:
            n += len(self.verify.graphs)
        if self.draft is not None and self.draft._graph is not None:
            n += 1
        return n

    def capture_seconds(self) -> float:
        """Seconds spent capturing CUDA graphs so far."""
        s = self.windows.capture_s
        if self.verify is not None:
            s += self.verify.capture_s
        if self.draft is not None:
            s += self.draft.capture_s
        return s

    @property
    def params(self):
        """The engine's weights (a `models.llama.Llama`), which another
        Engine takes as `params`: the JAX engine's attribute, so a prefill
        and a decode role share one set of weights the same way."""
        return self.model

    @property
    def lora_stacks(self):
        """The LoRA stacks every forward reads (None: no adapters)."""
        return self.lora.stacks if self.lora is not None else None

    def _decode_forward(self, tokens, positions, tables, ctx):
        return llama.decode_step(self.model, tokens, positions, tables, ctx,
                                 self.k_pages, self.v_pages,
                                 page_size=self.cfg.page_size,
                                 lora=self.lora_stacks,
                                 adapter_slots=self.batch.adapters)

    def _verify_forward(self, tokens, positions, tables, room):
        return llama.decode_verify(self.model, tokens, positions, tables,
                                   room, self.k_pages, self.v_pages,
                                   page_size=self.cfg.page_size,
                                   lora=self.lora_stacks,
                                   adapter_slots=self.batch.adapters)

    def validate_request(self, req: GenRequest) -> None:
        """Raise ValueError if the request can never be served here."""
        if req.adapter:
            if self.lora is None:
                raise ValueError(
                    "adapter requests need --lora-slots > 0 on this worker")
            if not self.lora.known(req.adapter):
                raise ValueError(f"unknown adapter {req.adapter!r}")
        if req.resume_key is not None:
            key = list(req.resume_key)
            if (len(key) != 2 or not all(isinstance(k, int) and 0 <= k
                                         < (1 << 32) for k in key)
                    or key[0] >= (1 << 31)):
                raise ValueError("resume_key must be a chain root as two "
                                 "uint32 values [high < 2**31, low]")
        if len(req.prompt_token_ids) >= self.cfg.max_seq_len:
            raise ValueError(
                f"prompt of {len(req.prompt_token_ids)} tokens exceeds "
                f"max_seq_len={self.cfg.max_seq_len}")
        n_pages = max(1, -(-len(req.prompt_token_ids) // self.cfg.page_size))
        if n_pages > self.cfg.num_pages - 1:
            raise ValueError(f"prompt needs {n_pages} KV pages; pool only has "
                             f"{self.cfg.num_pages - 1}")
        _pack_logit_bias(req)

    def set_kv_event_sink(self, sink) -> None:
        """Attach the cluster KV event plane: `sink(kind, [hash bytes],
        tier)` receives stored/demoted/removed block events from both the
        prefix cache and the KVBM tiers (kvbm/events.py publishes them)."""
        self._kv_event_sink = sink
        if self.prefix_cache is not None:
            self.prefix_cache.event_sink = sink
        if self.kvbm is not None:
            self.kvbm.events = sink

    def _insert_pending(self, req: GenRequest, requeue: bool = False) -> None:
        """Priority insertion (caller holds _lock): lower values admit
        sooner, FIFO within a level; requeued continuations go before their
        level's existing entries. With QoS on the key is the request's
        priority plus its tenant class's offset (`_queue_priority`)."""
        p = self._queue_priority(req)
        if requeue:
            idx = next((i for i, r in enumerate(self.pending)
                        if self._queue_priority(r) >= p), None)
        else:
            idx = next((i for i, r in enumerate(self.pending)
                        if self._queue_priority(r) > p), None)
        if idx is None:
            self.pending.append(req)
        else:
            self.pending.insert(idx, req)

    def add_request(self, req: GenRequest) -> None:
        """Enqueue a request (raises like validate_request)."""
        self.validate_request(req)
        with self._lock:
            self._insert_pending(req)
            if self.qos is not None:  # _qos_account drops it when done
                self._rid_tenant[req.request_id] = self._tenant_of(req)
            self.metrics.num_requests += 1
        if req.resume_key is not None or req.prior_output_token_ids:
            # recovery seam: a continuation of a preempted request or of
            # one handed over from another worker; the flight ring ties it
            # back to the failure
            self.flight.note(
                "resume", rid=req.request_id, tenant=self._tenant_of(req),
                n_prior=len(req.prior_output_token_ids),
                seeded=req.resume_key is not None)

    @contextlib.contextmanager
    def between_steps(self):
        """Hold the scheduler between two steps: no step, and so no CUDA
        graph launch, runs on another thread until the block ends. The
        profiler's start and stop need it (`ServingContext.capture_trace`):
        its stop, run beside a graph replay on the scheduler thread, hung
        both threads on the card."""
        with self._exec_lock:
            yield

    def abort_request(self, request_id: str) -> None:
        """Mark a request aborted; step() applies it."""
        with self._lock:
            self._aborted.add(request_id)

    def abort_all(self) -> List[str]:
        """Tear down every pending and running request (a failed step's
        recovery), releasing slots and KV pages, and dump the flight ring
        to the log. Returns the affected request ids."""
        with self._exec_lock:
            with self._lock:
                ids = [r.request_id for r in self.pending]
                self.pending.clear()
                self._aborted.clear()
                self._rid_tenant.clear()
            self._pending_win = None  # unread tokens die with their slots
            self._deferred = []
            inf, self._inflight = self._inflight, None
            if inf is not None:
                ids.append(inf.req.request_id)
                self.allocator.free(inf.pages)
                self._free_slots.append(inf.slot)
            for slot, seq in list(self.seqs.items()):
                ids.append(seq.request_id)
                self._finish_slot(slot, "abort")
            self.flight.dump("abort_all", rids=ids)
        cb = self.on_abort_all
        if cb is not None:
            try:
                cb(ids)
            except Exception:
                log.exception("on_abort_all hook failed")
        return ids

    def resurrect(self) -> None:
        """Rebuild device state in place after a watchdog trip: every
        stream dies (journaled ones already handed off), the KV pools and
        the decode batch's buffers are zeroed in their own storage, the
        page allocator and prefix cache start empty, and the weights
        round-trip through host memory back into their storage
        (`WeightManager.restage_live`). Nothing moves, so every captured
        decode and verify graph stays valid and replays (the JAX engine
        allocates a fresh pool and re-uploads the weights: new addresses,
        which a captured graph would not follow). The KVBM's host tier
        survives (its blocks are host copies) and re-attaches to the new
        prefix cache, as in the JAX engine, so its blocks re-onboard into
        the zeroed pools; so does the KV event sink. A CUDA error here
        propagates and the watchdog quarantines. Callers hold _exec_lock
        (the escalation ladder)."""
        with self._exec_lock, torch.inference_mode():
            t0 = time.monotonic()
            self.flight.note("resurrect_begin")
            self.abort_all()
            for pool in (self.k_pages, self.v_pages):
                pool.zero_()
            # parked disagg KV dies with the pools: its pages belong to the
            # old allocator, and a late release must not free them into
            # the new one (the JAX engine keeps them: ROADMAP queue 3)
            with self._lock:
                self._parked.clear()
            self.allocator = PageAllocator(self.cfg.num_pages)
            if self.prefix_cache is not None:
                self.prefix_cache = PrefixCache(self.allocator,
                                                self.cfg.page_size)
                self.prefix_cache.kvbm = self.kvbm
                self.prefix_cache.event_sink = self._kv_event_sink
            self.batch.reset()
            self._invalidate_dev()
            self.weights.restage_live()
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            if self.warmup_info is not None and not self.has_work:
                # captures only the keys warmup takes that are missing
                self.warmup()
            dt = time.monotonic() - t0
            self.last_resurrect_s = dt
            self.flight.note("resurrect_done", seconds=round(dt, 3))
            log.warning("engine resurrected: device state rebuilt in place "
                        "in %.2fs", dt)

    def device_poisoned(self) -> bool:
        """One probe of the device context (the watchdog's fatal-step
        path): True when a synchronize or a one-element op raises, as
        every CUDA call does after an error that sticks (an illegal
        address, an ECC error, a device-side assert). Host-only engines
        are never poisoned."""
        if self.device.type != "cuda":
            return False
        try:
            torch.cuda.synchronize(self.device)
            torch.ones(1, device=self.device).add_(1).item()
            return False
        except RuntimeError:
            return True

    # ---------------------------------------------------- per-tenant QoS --

    @staticmethod
    def _tenant_of(req: GenRequest) -> str:
        return req.tenant or "default"

    def _queue_priority(self, req: GenRequest) -> int:
        """STATIC queue-order priority: the request's own priority plus
        its tenant class's offset. Static by construction (no budget term)
        so the pending queue's order cannot rot as balances move.
        Batch-class requests carry a constant penalty that dominates any
        legal priority sum: the offline lane never queues ahead of
        interactive work."""
        if self.qos is None:
            return req.priority
        c = self.qos.registry.cls(self._tenant_of(req))
        p = req.priority + c.priority
        if c.batch:
            p += BATCH_PRIORITY_PENALTY
        return p

    def _is_batch(self, tenant: str) -> bool:
        return self.qos is not None and self.qos.registry.is_batch(tenant)

    def _class_of(self, tenant: str) -> str:
        """Flight-recorder taxonomy for preemption victims/beneficiaries."""
        return "batch" if self._is_batch(tenant) else "interactive"

    def _rank_priority(self, req: GenRequest) -> int:
        """Preemption-victim rank: queue priority plus the over-budget
        penalty (an over-budget tenant's sequences are the preferred
        victims, whatever their nominal class), plus a larger one still for
        the batch class (evicted before even a misbehaving interactive
        tenant)."""
        p = self._queue_priority(req)
        if self.qos is not None:
            t = self._tenant_of(req)
            if self.qos.over_budget(t):
                p += OVER_BUDGET_PENALTY
            if self.qos.registry.is_batch(t):
                p += BATCH_VICTIM_PENALTY
        return p

    def _qos_slot_state(self, pend) -> tuple:
        """(held slots per tenant, demanding tenants, fair caps) over the
        running set + `pend` (a snapshot of the pending queue)."""
        held: Dict[str, int] = {}
        for s in self.seqs.values():
            t = self._tenant_of(s.req)
            held[t] = held.get(t, 0) + 1
        if self._inflight is not None:
            t = self._tenant_of(self._inflight.req)
            held[t] = held.get(t, 0) + 1
        demand = set(held) | {self._tenant_of(r) for r in pend}
        cap = {t: self.qos.slot_cap(t, self.cfg.max_num_seqs, demand)
               for t in demand}
        return held, demand, cap

    def _qos_pick_index(self) -> int:
        """Index of the next pending request to admit (caller holds
        _lock). With QoS on, requests whose tenant is over budget or
        already holds its fair slot share are passed over while an
        admissible tenant waits behind them; when EVERY pending tenant is
        blocked the head admits anyway (work conservation: fairness must
        never idle the card)."""
        if self.qos is None or len(self.pending) <= 1:
            return 0
        held, _, cap = self._qos_slot_state(self.pending)
        deferred: set = set()
        for i, r in enumerate(self.pending):
            t = self._tenant_of(r)
            if held.get(t, 0) >= cap[t] or self.qos.over_budget(t):
                deferred.add(t)
                continue
            if i:
                for t2 in deferred:
                    self.qos.note_defer(t2)
                self.flight.note("defer", tenants=sorted(deferred),
                                 reason="qos_share_or_budget",
                                 beneficiary_rid=r.request_id,
                                 beneficiary_tenant=t)
            return i
        return 0

    def _qos_admissible(self, req: GenRequest) -> bool:
        """Group-widening gate: may `req` take a slot right now? (caller
        holds _lock)."""
        if self.qos is None:
            return True
        t = self._tenant_of(req)
        if self.qos.over_budget(t):
            return False
        held, _, cap = self._qos_slot_state(self.pending)
        return held.get(t, 0) < cap[t]

    def _pending_remove(self, req: GenRequest) -> None:
        """Remove `req` from the pending queue by identity (caller holds
        _lock): the QoS pick may admit from the middle of the queue."""
        for i, r in enumerate(self.pending):
            if r is req:
                del self.pending[i]
                return

    def _qos_evict_batch_for_admission(self) -> List[TokenEvent]:
        """Class-wide batch eviction: interactive traffic returning to a
        trough-filled engine drains EVERY batch-held slot it needs within
        this one step (the offline lane's contract is instant yield, not
        fair contention). Each victim requeues as a recompute
        continuation; the interactive admissions then land in this same
        _admit pass. Batch-vs-batch contention stays on the WFQ
        single-victim path."""
        if (self.qos is None or self._inflight is not None
                or not self.seqs):
            return []
        if not any(self._is_batch(self._tenant_of(s.req))
                   for s in self.seqs.values()):
            return []
        with self._lock:
            interactive = [r for r in self.pending
                           if not self._is_batch(self._tenant_of(r))]
        need = len(interactive) - len(self._free_slots)
        if need <= 0:
            return []
        # preemption frees pages a window in flight may still touch: drain
        # the pipeline first (this can also finish sequences, so victims
        # are picked after)
        events = self._materialize_pending()
        victims = sorted(
            ((slot, s) for slot, s in self.seqs.items()
             if self._is_batch(self._tenant_of(s.req))),
            key=lambda kv: (self._rank_priority(kv[1].req),
                            kv[1].req.arrival_time),
            reverse=True)
        head = interactive[0]
        for slot, seq in victims[:max(0, need)]:
            self.flight.note(
                "qos_preempt", victim_rid=seq.request_id, victim_slot=slot,
                victim_tenant=self._tenant_of(seq.req),
                victim_class="batch", reason="interactive_return",
                beneficiary_rid=head.request_id,
                beneficiary_tenant=self._tenant_of(head),
                n_out=len(seq.output_tokens))
            self._preempt_slot(slot)
        return events

    def _qos_preempt_for_admission(self) -> List[TokenEvent]:
        """WFQ slot reallocation: when every decode slot is taken and a
        well-behaved tenant queues below its fair share, preempt ONE
        sequence (worst rank, then youngest) of an over-budget tenant
        holding more than its share. At most one preemption per step
        bounds recompute thrash; the freed slot admits the waiting request
        in this same _admit pass."""
        if (self.qos is None or self._free_slots
                or self._inflight is not None or not self.seqs):
            return []
        with self._lock:
            if not self.pending:
                return []
            pend = list(self.pending)
        held, _, cap = self._qos_slot_state(pend)
        cand = next(
            (r for r in pend
             if not self.qos.over_budget(self._tenant_of(r))
             and held.get(self._tenant_of(r), 0) < cap[self._tenant_of(r)]),
            None)
        if cand is None:
            return []
        cand_t = self._tenant_of(cand)
        victims = [
            (slot, s) for slot, s in self.seqs.items()
            if self._tenant_of(s.req) != cand_t
            and self.qos.over_budget(self._tenant_of(s.req))
            and held.get(self._tenant_of(s.req), 0)
            > cap.get(self._tenant_of(s.req), 0)
        ]
        if not victims:
            return []
        # preemption frees pages a window in flight may still touch: drain
        # the pipeline first
        events = self._materialize_pending()
        slot, seq = max(victims, key=lambda kv: (
            self._rank_priority(kv[1].req), kv[1].req.arrival_time))
        if self.seqs.get(slot) is seq:  # materializing may have finished it
            self.flight.note(
                "qos_preempt", victim_rid=seq.request_id, victim_slot=slot,
                victim_tenant=self._tenant_of(seq.req),
                victim_class=self._class_of(self._tenant_of(seq.req)),
                reason="wfq_share",
                beneficiary_rid=cand.request_id, beneficiary_tenant=cand_t)
            self._preempt_slot(slot)
        return events

    def _qos_account(self, events: List[TokenEvent]) -> None:
        """Bank one step's decoded tokens into the tenant budgets."""
        if self.qos is None or not events:
            return
        produced: Dict[str, int] = {}
        done: List[str] = []
        for ev in events:
            if ev.token_id >= 0:
                t = self._rid_tenant.get(ev.request_id, "default")
                produced[t] = produced.get(t, 0) + 1
            if ev.finished:
                done.append(ev.request_id)
        if produced:
            demand = {self._tenant_of(s.req) for s in self.seqs.values()}
            with self._lock:
                demand.update(self._tenant_of(r) for r in self.pending)
            if self._inflight is not None:
                demand.add(self._tenant_of(self._inflight.req))
            demand.update(produced)
            self.qos.account(produced, demand)
        if done:
            with self._lock:
                for rid in done:
                    self._rid_tenant.pop(rid, None)

    @property
    def num_active(self) -> int:
        return len(self.seqs)

    @property
    def has_work(self) -> bool:
        return (bool(self.seqs) or bool(self.pending)
                or self._inflight is not None or bool(self._deferred))

    # --------------------------------------------------------- scheduling --

    def step(self) -> List[TokenEvent]:
        """One scheduler iteration: apply aborts, then either one mixed
        step (a chunked prefill in flight, decode slots live and
        mixed_batch_tokens set) or admit (prefill) or run one chunk,
        followed by one decode window (pipelined under async_scheduling).
        Single consumer: one thread calls step(); add_request and
        abort_request synchronise through _lock."""
        self._ensure_kernels()
        with self._exec_lock, torch.inference_mode():
            # one flight record and one timeline record per step: the
            # segments executed fill their phases, decisions attach as
            # events, and the commit stamps the closing batch; a step
            # that did nothing commits nothing
            self.flight.begin()
            self.timeline.begin_step()
            try:
                return self._step_locked()
            finally:
                if self.flight.enabled:
                    self.flight.commit(
                        active=len(self.seqs), pending=len(self.pending),
                        free_pages=self.allocator.free_pages,
                        batch=self._flight_batch())
                self.timeline.commit_step(
                    active=len(self.seqs), pending=len(self.pending))

    def _step_locked(self) -> List[TokenEvent]:
        # an armed finish-mode weight flip applies here, at the step
        # boundary, once the last old-version stream has finished: we hold
        # _exec_lock, so no step ever mixes versions
        self.weights.maybe_flip_locked()
        with self.timeline.phase("admit"):
            events = self._deferred + self._apply_aborts()
            self._deferred = []
        spec = self.verify is not None
        if self._mixed_eligible():
            # with speculation the verify windows ride the mixed step,
            # unless a logprobs request demotes it to the plain one
            if spec and not self._any_logprobs():
                events.extend(self._mixed_spec_step())
            else:
                if spec:
                    self._demote("logprobs")
                events.extend(self._mixed_step())
            with self.timeline.phase("bank"):
                self._qos_account(events)
            return events
        if self._inflight is not None:
            events.extend(self._advance_chunk())
        else:
            with self.timeline.phase("admit"):
                events.extend(self._admit())
        if self.seqs:
            if spec:
                events.extend(self._decode_spec())
            elif self.cfg.async_scheduling:
                events.extend(self._decode_async())
            else:
                events.extend(self._decode_once())
        # per-tenant QoS: bank this step's decoded tokens into the
        # weighted-fair budgets (no-op without configured tenants)
        with self.timeline.phase("bank"):
            self._qos_account(events)
        return events

    # ------------------------------------------------- flight/cost hooks --

    def _flight_batch(self) -> List[dict]:
        """Batch composition stamped on each flight record: who holds the
        decode slots (and the inflight chunk) as the step closes."""
        out: List[dict] = []
        for slot in sorted(self.seqs):
            seq = self.seqs.get(slot)
            if seq is None:
                continue
            req = seq.req
            out.append({
                "slot": slot, "rid": seq.request_id,
                "tenant": self._tenant_of(req),
                "adapter": req.adapter or "",
                "n_out": len(seq.output_tokens)})
        inf = self._inflight
        if inf is not None:
            out.append({
                "slot": inf.slot, "rid": inf.req.request_id,
                "tenant": self._tenant_of(inf.req),
                "adapter": inf.req.adapter or "",
                "chunk_done": inf.done, "prompt_len": inf.prompt_len})
        return out

    def _step_obs(self, kind: str, dur_s: float, take: int = 0,
                  shares: Optional[Dict[str, float]] = None) -> None:
        """Record one executed segment (a dispatch) in the flight draft and
        attribute its wall time and KV residency to tenants: `shares`
        (tenant -> work units), else one unit per decode slot and `take`
        (the chunk's tokens this segment) for the inflight prefill; the
        holdings (KV bytes on the device) from the live holders, parked
        disagg pages included."""
        pb = self._page_nbytes
        holdings: Dict[str, float] = {}
        computed: Dict[str, float] = {}
        for seq in list(self.seqs.values()):
            t = self._tenant_of(seq.req)
            computed[t] = computed.get(t, 0.0) + 1.0
            holdings[t] = holdings.get(t, 0.0) + len(seq.pages) * pb
        inf = self._inflight
        if inf is not None:
            t = self._tenant_of(inf.req)
            if take > 0:
                computed[t] = computed.get(t, 0.0) + float(take)
            holdings[t] = holdings.get(t, 0.0) + len(inf.pages) * pb
        for rid, parked in list(self._parked.items()):
            t = self._rid_tenant.get(rid, "default")
            holdings[t] = holdings.get(t, 0.0) + len(parked[0]) * pb
        self.cost.account(dur_s, shares if shares is not None else computed,
                          holdings)
        if self.flight.enabled:
            self.flight.phase(kind, dur_s, **({"take": take} if take else {}))

    def _demote(self, reason: str) -> None:
        """A speculative step (or one slot's window) demoted to plain
        decode: counted by reason, and noted in the flight record."""
        self.metrics.demote(reason)
        self.flight.note("spec_demote", reason=reason)

    def generate(self, req: GenRequest) -> List[int]:
        """Blocking single-request generation (tests, CLI)."""
        self.add_request(req)
        out: List[int] = []
        while self.has_work:
            for ev in self.step():
                if ev.request_id == req.request_id and ev.token_id >= 0:
                    out.append(ev.token_id)
        return out

    def _apply_aborts(self) -> List[TokenEvent]:
        with self._lock:
            aborted, self._aborted = self._aborted, set()
        if not aborted:
            return []
        # finishing slots frees pages a window in flight still touches:
        # drain the pipeline before any teardown
        events = self._materialize_pending()
        with self._lock:
            kept = collections.deque()
            for r in self.pending:
                if r.request_id in aborted:
                    events.append(TokenEvent(r.request_id, -1, 0, True,
                                             "abort"))
                    self.flight.note("abort", rid=r.request_id,
                                     tenant=self._tenant_of(r),
                                     where="queued")
                else:
                    kept.append(r)
            self.pending = kept
        inf = self._inflight
        if inf is not None and inf.req.request_id in aborted:
            self.allocator.free(inf.pages)
            self._free_slots.append(inf.slot)
            self._inflight = None
            events.append(TokenEvent(inf.req.request_id, -1, 0, True, "abort"))
            self.flight.note("abort", rid=inf.req.request_id,
                             tenant=self._tenant_of(inf.req), where="chunk",
                             slot=inf.slot)
        for slot, seq in list(self.seqs.items()):
            if seq.request_id in aborted:
                events.append(TokenEvent(seq.request_id, -1,
                                         len(seq.output_tokens), True,
                                         "abort"))
                self._finish_slot(slot, "abort")
        return events

    def _admit(self) -> List[TokenEvent]:
        events: List[TokenEvent] = []
        if self.weights.admission_held:
            # finish-mode flip armed: new admissions wait in the pending
            # queue so they land on the NEW version; in-flight streams
            # keep decoding on the old one until the flip applies
            return events
        # per-tenant QoS: interactive arrivals drain the batch class first
        # (every slot they need, this step), then slots full + a well-
        # behaved tenant below its share -> preempt ONE over-share
        # over-budget sequence
        events.extend(self._qos_evict_batch_for_admission())
        events.extend(self._qos_preempt_for_admission())
        chunk = self.cfg.prefill_chunk_tokens
        while self._free_slots:
            with self._lock:
                if not self.pending:
                    break
                # QoS-aware pick: pass over tenants over budget or at their
                # fair slot share while others wait (the head without
                # configured tenants)
                req = self.pending[self._qos_pick_index()]
            if req.adapter:
                # resolve (and lazily load) the adapter BEFORE any
                # allocation: from here to installation nothing else can
                # evict its slot (group widening only admits adapters
                # that are already resident)
                try:
                    self._adapter_slot(req)
                except NoFreeAdapterSlot:
                    self.flight.note("defer", rid=req.request_id,
                                     tenant=self._tenant_of(req),
                                     reason="no_adapter_slot",
                                     adapter=req.adapter)
                    break  # every slot serves live sequences: wait
                except KeyError:  # unregistered since it was submitted
                    with self._lock:
                        self._pending_remove(req)
                    events.append(TokenEvent(req.request_id, -1, 0, True,
                                             "abort"))
                    self.flight.note("abort", rid=req.request_id,
                                     tenant=self._tenant_of(req),
                                     reason="unknown_adapter",
                                     adapter=req.adapter)
                    continue
            # prefix lookup BEFORE the page gate: only the suffix needs
            # fresh pages, and gating on the whole prompt could evict this
            # very request's cached prefix for pages it never allocates
            cached_pages, n_cached = [], 0
            if self.prefix_cache is not None:
                cached_pages, n_cached = self.prefix_cache.lookup(
                    req.prompt_token_ids,
                    namespace=self._kv_namespace(req.adapter))
            n_pages = max(1, -(-len(req.prompt_token_ids)
                               // self.cfg.page_size))
            if not self._ensure_pages(n_pages - len(cached_pages)):
                if cached_pages:
                    self.allocator.free(cached_pages)  # drop our refs
                self.flight.note("defer", rid=req.request_id,
                                 tenant=self._tenant_of(req),
                                 reason="no_pages",
                                 need_pages=n_pages - len(cached_pages),
                                 free_pages=self.allocator.free_pages)
                break  # OutOfPages deferral: running sequences free pages
            with self._lock:
                self._pending_remove(req)
            # installing a slot changes the batch: drain the window in
            # flight first
            events.extend(self._materialize_pending())
            if chunk > 0 and (n_cached > 0
                              or len(req.prompt_token_ids) > chunk
                              or (self.cfg.mixed_batch_tokens > 0
                                  and bool(self.seqs))):
                # a long or partly cached prompt, or any prompt while
                # streams decode in mixed mode: prefill the rest in chunks
                # across later step()s (riding the mixed step when it
                # serves) instead of stalling every active stream
                self._start_inflight(req, cached_pages, n_cached)
                break
            group = self._widen_group(req, chunk)
            if len(group) > 1:
                got = self._prefill_group(group)
                if got is None:
                    break
                events.extend(got)
                continue
            try:
                events.append(self._prefill_request(req))
            except OutOfPages:
                self.metrics.kv_oom += 1
                events.append(TokenEvent(req.request_id, -1, 0, True,
                                         "kv_oom"))
                self.flight.note("kv_oom", rid=req.request_id,
                                 tenant=self._tenant_of(req),
                                 where="prefill")
        return events

    def _widen_group(self, req: GenRequest, chunk: int) -> List[GenRequest]:
        """Pull further pending same-bucket full-prefill requests into one
        batched admission (up to max_prefill_batch, bounded by free slots
        and pages, counted cumulatively). Requests for the chunked path
        (long or cached prompts) stay queued for the normal loop."""
        cfg = self.cfg
        group = [req]
        if cfg.max_prefill_batch <= 1:
            return group
        bucket = _next_bucket(len(req.prompt_token_ids), cfg.page_size,
                              cfg.max_seq_len)
        need = max(1, -(-len(req.prompt_token_ids) // cfg.page_size))
        while (len(group) < cfg.max_prefill_batch
               and len(self._free_slots) > len(group)):
            with self._lock:
                if not self.pending:
                    break
                nxt = self.pending[0]
                if not self._qos_admissible(nxt):
                    break  # over-budget/over-share tenant: own pass later
            plen = len(nxt.prompt_token_ids)
            if chunk > 0 and plen > chunk:
                break  # chunked path
            if _next_bucket(plen, cfg.page_size, cfg.max_seq_len) != bucket:
                break
            if nxt.adapter and (self.lora is None
                                or self.lora.slot_of(nxt.adapter) is None):
                # a non-resident adapter loads on its own pass, so that
                # the load (which may evict a slot an earlier member just
                # resolved) never runs mid-group
                break
            if (self.prefix_cache is not None
                    and self.prefix_cache.has_prefix(
                        nxt.prompt_token_ids,
                        namespace=self._kv_namespace(nxt.adapter))):
                break  # cached prefix: chunked path
            n_pg = max(1, -(-plen // cfg.page_size))
            if not self._ensure_pages(need + n_pg):
                break
            need += n_pg
            with self._lock:
                self._pending_remove(nxt)
            group.append(nxt)
        return group

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype).to(self.device)

    def _adapter_slot(self, req: GenRequest) -> int:
        """A request's LoRA slot, loading its adapter into one if it is
        not resident (LRU-evicting an idle one). 0 = base."""
        if self.lora is None or not req.adapter:
            return 0
        return self.lora.acquire_slot(req.adapter)

    def _kv_namespace(self, adapter: Optional[str]) -> str:
        """The prefix cache's namespace of a request: the active weight
        version composed with its LoRA adapter (JAX `_kv_namespace`), so
        an adapter and the base never share a page, and v1 pages never
        match under v2. The base version contributes nothing."""
        ver = self.weights.namespace
        a = adapter or ""
        if not ver:
            return a
        return f"{ver}#{a}"

    def _prefill_group(self, reqs: List[GenRequest]
                       ) -> Optional[List[TokenEvent]]:
        """One batched prefill for same-bucket admissions."""
        cfg = self.cfg
        t0 = time.monotonic()
        bucket = _next_bucket(len(reqs[0].prompt_token_ids), cfg.page_size,
                              cfg.max_seq_len)
        n, w = len(reqs), bucket // cfg.page_size
        tokens = np.zeros((n, bucket), np.int64)
        seq_lens = np.ones((n,), np.int32)
        pages_arr = np.zeros((n, w), np.int32)
        page_lists: List[List[int]] = []
        try:
            for i, r in enumerate(reqs):
                plen = len(r.prompt_token_ids)
                pages = self.allocator.alloc(max(1, -(-plen // cfg.page_size)))
                page_lists.append(pages)
                tokens[i, :plen] = r.prompt_token_ids
                seq_lens[i] = plen
                pages_arr[i, :len(pages)] = pages
        except OutOfPages:
            for pl in page_lists:
                self.allocator.free(pl)
            with self._lock:
                for r in reversed(reqs):
                    self._insert_pending(r, requeue=True)
            return None
        # every lane's adapter is resident (_admit resolved the first,
        # _widen_group pulls only resident ones): these are LRU bumps
        aslots = [self._adapter_slot(r) for r in reqs]
        with self.timeline.phase("dispatch"):
            logits = llama.prefill_batch(
                self.model, self._tensor(tokens), self._tensor(seq_lens),
                self.k_pages, self.v_pages, self._tensor(pages_arr),
                page_size=cfg.page_size, lora=self.lora_stacks,
                adapter_slots=self._tensor(aslots, torch.int32))
        keys = [self._request_key(r) for r in reqs]
        with self.timeline.phase("device_wait"):
            toks, chosen, tids, tvals, finite = self._sample_first(
                logits, reqs, keys, [int(s) - 1 for s in seq_lens])
        dt = time.monotonic() - t0
        self.metrics.prefill_time_s += dt
        self.metrics.observe_phase("prefill", dt, weight=len(reqs))
        shares: Dict[str, float] = {}
        for i, r in enumerate(reqs):
            t = self._tenant_of(r)
            shares[t] = shares.get(t, 0.0) + float(seq_lens[i])
        self._step_obs("prefill", dt, shares=shares)
        events = []
        for i, r in enumerate(reqs):
            if not finite[i]:
                # poisoned lane: this stream aborts, its pages go back,
                # the co-batched lanes admit untouched
                self.allocator.free(page_lists[i])
                events.append(self._integrity_abort(r, "prefill_group"))
                continue
            self.metrics.prompt_tokens += int(seq_lens[i])
            events.append(self._finalize_admission(
                r, page_lists[i], int(seq_lens[i]), int(toks[i]), keys[i],
                (float(chosen[i]), tids[i], tvals[i]), t_prefill_start=t0))
        return events

    def _integrity_abort(self, req: GenRequest, where: str) -> TokenEvent:
        """A prefill lane's logits were not finite: count the sentinel and
        end exactly this stream (its pages are the caller's to free)."""
        self.watchdog.record_integrity_fault("logits", [req.request_id],
                                             where=where)
        return TokenEvent(req.request_id, -1, 0, True, "integrity_fault")

    def _request_key(self, req: GenRequest) -> int:
        """Per-request sampling chain root: a resume_key (a recovery or
        drain-handoff continuation) restores the original worker's root
        exactly, else the seed when given, else a draw."""
        if req.resume_key is not None:
            hi, lo = req.resume_key
            return (int(hi) << 32) | int(lo)
        if req.seed is not None:
            return int(req.seed) & ((1 << 63) - 1)
        return int(self._rng.integers(0, 1 << 63))

    def export_sampling_state(self, request_id: str) -> Optional[Dict]:
        """The resumable sampling state of a LIVE sequence: its chain root
        as two uint32 values [high, low] (what `recovery`'s resume_key
        check takes) and its output position. A continuation elsewhere
        with this key, the prompt and the tokens so far samples the same
        noise: the port's noise is keyed by (root, position)."""
        for slot, seq in list(self.seqs.items()):
            if seq.request_id == request_id:
                root = int(self.slot_keys[slot])
                return {"key": [root >> 32, root & 0xFFFFFFFF],
                        "n_output": len(seq.output_tokens)}
        return None

    def _penalty_row(self, req: GenRequest) -> Optional[np.ndarray]:
        """Presence/frequency penalties for a preempted continuation's first
        token: its prior output rides in the prompt but is still output."""
        if not req.prior_output_token_ids or not (req.presence_penalty
                                                  or req.frequency_penalty):
            return None
        row = np.zeros((self.model_cfg.vocab_size,), np.float32)
        np.add.at(row, np.asarray(req.prior_output_token_ids, np.int64), 1.0)
        return (req.presence_penalty * (row > 0).astype(np.float32)
                + req.frequency_penalty * row)

    def _ensure_guide_table(self) -> json_guide.VocabTable:
        """The vocab byte table of JSON-guided decoding, built once per
        engine and sized to the model vocab (JAX `_ensure_guide_table`): a
        local HF tokenizer's pieces, else the byte vocab (ids < 256 are
        bytes); its device copy goes to the decode windows."""
        if self._guide_table is None:
            mcfg = self.model_cfg
            eos = [mcfg.eos_token_id, *mcfg.extra_stop_token_ids]
            tok = get_tokenizer(self.cfg.model, self.cfg.model_path)
            if hasattr(tok, "tok"):
                table = json_guide.VocabTable.for_tokenizer(
                    tok, eos, vocab_size=mcfg.vocab_size)
            else:
                table = json_guide.VocabTable.for_byte_vocab(
                    mcfg.vocab_size, eos)
            self.windows.guide = json_guide.DeviceTable(table, self.device)
            self._guide_table = table
        return self._guide_table

    def _guide_first(self, logits, reqs) -> torch.Tensor:
        """The prefill logits [N, V] as float32 with each guided request's
        grammar mask applied on the logits' device (`cuda_guide.json_mask`:
        -1e9 on disallowed tokens), from the state its prior output (a
        preempted continuation's) replays to."""
        t = self._ensure_guide_table()
        states = [json_guide.replay_scalar(t, r.prior_output_token_ids)
                  if r.guided_json else (json_guide.START, 0, 0)
                  for r in reqs]
        mode, depth, bits = (self._tensor([s[k] for s in states],
                                          torch.int32) for k in range(3))
        active = self._tensor([bool(r.guided_json) for r in reqs],
                              torch.bool)
        masked = logits.to(torch.float32, copy=True).contiguous()
        return cuda_guide.json_mask(masked, mode, depth, bits, active,
                                    self.windows.guide)

    def _sample_first(self, logits, reqs, keys, positions):
        """First tokens from prefill logits [N, V]: per-request sampling
        params and chains, a guided request's grammar mask; logprobs
        always computed, from the logits before penalties (a guided
        request's masked by its grammar, as its decode steps' are, unless
        it carries a penalty row: JAX `_first_token`)."""
        n = len(reqs)
        if faults.check("engine.device_nan") is not None:
            # chaos drill: a corrupted forward poisons ONE lane (the
            # lead request); the sentinel must end exactly that stream
            logits = logits.clone()
            logits[0] = float("nan")
        bias = [_pack_logit_bias(r) for r in reqs]
        state = smp.make_state(
            [r.temperature for r in reqs], [r.top_p for r in reqs],
            [r.top_k for r in reqs], min_p=[r.min_p for r in reqs],
            bias_ids=np.stack([b[0] for b in bias]),
            bias_vals=np.stack([b[1] for b in bias]), device=self.device)
        pen = [self._penalty_row(r) for r in reqs]
        sample_logits = lp_logits = logits
        if any(r.guided_json for r in reqs):
            sample_logits = lp_logits = self._guide_first(logits, reqs)
        if any(p is not None for p in pen):
            rows = np.zeros((n, self.model_cfg.vocab_size), np.float32)
            for i, p in enumerate(pen):
                if p is not None:
                    rows[i] = p
            has_pen = self._tensor([p is not None for p in pen], torch.bool)
            lp_logits = torch.where(has_pen[:, None], logits.float(),
                                    sample_logits.float())
            sample_logits = sample_logits.float() - self._tensor(rows)
        toks = smp.sample(sample_logits, state,
                          smp.fold_positions(keys, positions))
        logp = torch.log_softmax(lp_logits.float(), dim=-1)
        chosen = logp.gather(1, toks[:, None])[:, 0]
        tvals, tids = logp.topk(min(5, logp.shape[-1]), dim=-1)
        if self.integrity != "off":
            # each lane's finite flag, computed on the device and read
            # back in the tokens' own copy: no extra sync
            finite = torch.isfinite(logits).reshape(n, -1).all(1)
            packed = torch.stack([toks, finite.to(toks.dtype)]).cpu().numpy()
            toks_np, finite_np = packed[0], packed[1].astype(bool)
        else:
            toks_np = toks.cpu().numpy()
            finite_np = np.ones((n,), np.bool_)
        return (toks_np, chosen.cpu().numpy(), tids.cpu().numpy(),
                tvals.cpu().numpy(), finite_np)

    def _finalize_admission(self, req: GenRequest, pages, prompt_len: int,
                            first: int, req_key: int, lp,
                            slot: Optional[int] = None,
                            t_prefill_start: Optional[float] = None
                            ) -> TokenEvent:
        """Publish the prompt's full pages to the prefix cache, install the
        slot, stop-check the first token, decorate logprobs. With
        `t_prefill_start` (monotonic) the event's `phase` splits admission
        to first token into queue and prefill seconds (the serving layer's
        worker.queue and worker.prefill spans)."""
        if self.prefix_cache is not None:
            self.prefix_cache.insert(req.prompt_token_ids, pages,
                                     namespace=self._kv_namespace(req.adapter))
        if slot is None:
            slot = self._free_slots.pop()
        seq = self._install_slot(req, slot, pages, prompt_len, first, req_key)
        finished, reason = self._check_stop(seq, first)
        ev = TokenEvent(req.request_id, first, 0, finished, reason)
        if t_prefill_start is not None:
            ev.phase = {
                "queue_s": max(0.0, t_prefill_start - req.arrival_time),
                "prefill_s": max(0.0, time.monotonic() - t_prefill_start),
            }
        if req.logprobs is not None:
            self._decorate_lp(ev, seq, *lp)
        if finished:
            self._finish_slot(slot, reason)
        return ev

    def _run_prefill(self, req: GenRequest, where: str = "prefill"):
        """The bucketed single-prompt prefill and its first token, shared
        by the aggregated admission path and the disagg prefill role (JAX
        `_run_prefill`). Returns (first, pages, prompt_len, key, lp, t0)
        with lp = (chosen logprob, top ids, top logprobs), or the
        integrity abort's TokenEvent when the logits were not finite (the
        pages already given back)."""
        cfg = self.cfg
        t0 = time.monotonic()
        prompt = req.prompt_token_ids
        prompt_len = len(prompt)
        bucket = _next_bucket(prompt_len, cfg.page_size, cfg.max_seq_len)
        pages = self.allocator.alloc(max(1, -(-prompt_len // cfg.page_size)))
        pages_arr = np.zeros((bucket // cfg.page_size,), np.int32)
        pages_arr[:len(pages)] = pages
        tokens = np.zeros((bucket,), np.int64)
        tokens[:prompt_len] = prompt
        with self.timeline.phase("dispatch"):
            logits = llama.prefill(
                self.model, self._tensor(tokens), prompt_len, self.k_pages,
                self.v_pages, self._tensor(pages_arr),
                page_size=cfg.page_size, lora=self.lora_stacks,
                adapter_slots=self._adapter_slot(req))
        key = self._request_key(req)
        with self.timeline.phase("device_wait"):
            toks, chosen, tids, tvals, finite = self._sample_first(
                logits[None], [req], [key], [prompt_len - 1])
        if not finite[0]:
            # poisoned stream: its pages go back, the engine keeps serving
            self.allocator.free(pages)
            return self._integrity_abort(req, where)
        dt = time.monotonic() - t0
        self.metrics.prefill_time_s += dt
        self.metrics.observe_phase("prefill", dt)
        self.metrics.prompt_tokens += prompt_len
        self._step_obs("prefill", dt,
                       shares={self._tenant_of(req): float(prompt_len)})
        return (int(toks[0]), pages, prompt_len, key,
                (float(chosen[0]), tids[0], tvals[0]), t0)

    def _prefill_request(self, req: GenRequest) -> TokenEvent:
        """Bucketed single-prompt prefill + first token."""
        got = self._run_prefill(req)
        if isinstance(got, TokenEvent):
            return got
        first, pages, prompt_len, key, lp, t0 = got
        return self._finalize_admission(req, pages, prompt_len, first, key,
                                        lp, t_prefill_start=t0)

    def _start_inflight(self, req: GenRequest, cached_pages=(),
                        n_cached: int = 0) -> None:
        """Reserve a slot and the prompt's pages (after the cached prefix's
        shared pages) for a chunked prefill starting at token n_cached."""
        cfg = self.cfg
        prompt_len = len(req.prompt_token_ids)
        bucket = _next_bucket(prompt_len, cfg.page_size, cfg.max_seq_len)
        total = max(1, -(-prompt_len // cfg.page_size))
        pages = list(cached_pages)
        pages += self.allocator.alloc(total - len(pages))
        # trailing TRASH slots: the final padded chunk's page slice (of a
        # classic chunk or of a mixed step, whichever is wider) lands on
        # page 0 instead of running off the list
        width = self.kv_spec.page_table_width(
            bucket, max(cfg.prefill_chunk_tokens, cfg.mixed_batch_tokens))
        pages_arr = np.zeros((width,), np.int32)
        pages_arr[:len(pages)] = pages
        slot = self._free_slots.pop()
        self._inflight = InflightPrefill(req, pages, self._tensor(pages_arr),
                                         prompt_len, slot,
                                         self._adapter_slot(req))
        self._inflight.done = n_cached  # a cached prefix skips to the suffix
        self.flight.note("chunk_start", rid=req.request_id, slot=slot,
                         tenant=self._tenant_of(req),
                         adapter=req.adapter or "", prompt_len=prompt_len,
                         cached_tokens=n_cached)

    def _advance_chunk(self) -> List[TokenEvent]:
        """Run ONE chunk of the inflight prefill; on the last chunk sample
        the first token and install the sequence in its reserved slot."""
        inf = self._inflight
        cfg = self.cfg
        t0 = time.monotonic()
        c = cfg.prefill_chunk_tokens
        start = inf.done
        take = min(c, inf.prompt_len - start)
        tokens = np.zeros((c,), np.int64)
        tokens[:take] = inf.req.prompt_token_ids[start:start + take]
        with self.timeline.phase("dispatch"):
            logits = llama.prefill_chunk(
                self.model, self._tensor(tokens), start, take, self.k_pages,
                self.v_pages, inf.pages_dev, page_size=cfg.page_size,
                lora=self.lora_stacks, adapter_slots=inf.aslot)
        inf.done += take
        dt = time.monotonic() - t0
        self.metrics.prefill_time_s += dt
        self.metrics.observe_phase("prefill_chunk", dt)
        # this dispatch ran the chunk alone: its tenant owns the segment
        self._step_obs("prefill_chunk", dt, take=take,
                       shares={self._tenant_of(inf.req): float(take)})
        if inf.done < inf.prompt_len:
            return []
        # the last chunk installs a slot: drain the window in flight first
        events = self._materialize_pending()
        events.append(self._install_inflight(logits))
        return events

    def _install_inflight(self, logits) -> TokenEvent:
        """The inflight prefill's last chunk ran: sample its first token
        from the chunk's last-row logits [V], publish the prompt's full
        pages and install the sequence in its reserved slot."""
        inf = self._inflight
        self._inflight = None
        req = inf.req
        key = self._request_key(req)
        with self.timeline.phase("device_wait"):
            toks, chosen, tids, tvals, finite = self._sample_first(
                logits[None], [req], [key], [inf.prompt_len - 1])
        if not finite[0]:
            # poisoned chunked prefill: release its pages and its reserved
            # slot; nothing of it reaches the prefix cache
            self.allocator.free(inf.pages)
            self._free_slots.append(inf.slot)
            return self._integrity_abort(req, "prefill_chunk")
        self.metrics.prompt_tokens += inf.prompt_len
        ev = self._finalize_admission(
            req, inf.pages, inf.prompt_len, int(toks[0]), key,
            (float(chosen[0]), tids[0], tvals[0]), slot=inf.slot,
            t_prefill_start=inf.t_start)
        # "prefill" times admission to first token on both paths (the
        # TTFT phase); the chunks' own times are "prefill_chunk"
        self.metrics.observe_phase("prefill", ev.phase["prefill_s"])
        return ev

    def _mixed_eligible(self) -> bool:
        """The mixed step serves this iteration iff a chunked prefill is in
        flight AND decode slots are live AND none of them is JSON-guided
        (the mixed step carries no grammar; the inflight request's own
        first token is masked all the same: `_guide_first`); otherwise the
        classic paths (full or batched prefill when idle, plain decode
        when nothing is admitting) do the work."""
        return (self.cfg.mixed_batch_tokens > 0
                and self._inflight is not None and bool(self.seqs)
                and not self._any_guided())

    def _mixed_step(self) -> List[TokenEvent]:
        """One mixed step: a single forward advances every decode slot by
        one token (sampled exactly as _decode_once samples) AND the
        inflight prefill by up to mixed_batch_tokens; on the final chunk
        the first token comes from the same forward's last-row logits."""
        inf = self._inflight
        cfg = self.cfg
        # the mixed step extends the device carry like a 1-step window:
        # drain the window in flight, then give every slot its page
        events = self._materialize_pending()
        with self.timeline.phase("page_alloc"):
            self._grow_pages(1, events)
        if not self.seqs:
            # page pressure emptied the batch: the chunk still has its
            # reserved pages, so it advances on the classic path
            events.extend(self._advance_chunk())
            return events
        c = cfg.mixed_batch_tokens
        start = inf.done
        take = min(c, inf.prompt_len - start)
        chunk = np.zeros((c,), np.int64)
        chunk[:take] = inf.req.prompt_token_ids[start:start + take]
        chunk_dev = self._tensor(chunk)
        chunk_logits = []

        def forward(tokens, positions, tables, ctx):
            logits, last = llama.mixed_step(
                self.model, tokens, positions, tables, ctx, chunk_dev, start,
                take, inf.pages_dev, self.k_pages, self.v_pages,
                page_size=cfg.page_size, lora=self.lora_stacks,
                adapter_slots=self.batch.adapters,
                chunk_adapter_slot=inf.aslot)
            chunk_logits.append(last)
            return logits

        self._dispatch_window(1, forward=forward)
        events.extend(self._materialize_window(self._pending_win, "mixed",
                                               take))
        inf.done += take
        if inf.done < inf.prompt_len:
            return events
        events.append(self._install_inflight(chunk_logits[0]))
        return events

    def _stop_ids_for(self, req: GenRequest) -> List[int]:
        """User stop ids plus the model's eos ids, unless ignore_eos (which
        exempts only the model's)."""
        if req.ignore_eos:
            return list(req.stop_token_ids or [])
        return list(dict.fromkeys(
            [*(req.stop_token_ids or []), self.model_cfg.eos_token_id,
             *self.model_cfg.extra_stop_token_ids]))

    def _install_slot(self, req: GenRequest, slot: int, pages,
                      prompt_len: int, first: int, req_key: int) -> SeqState:
        seq = SeqState(req.request_id, slot, pages, prompt_len,
                       max_tokens=req.max_tokens,
                       temperature=req.temperature, top_p=req.top_p,
                       top_k=req.top_k,
                       stop_token_ids=self._stop_ids_for(req),
                       logprobs=req.logprobs)
        seq.prompt_ids = list(req.prompt_token_ids)
        seq.req = req
        seq.adapter_slot = self._adapter_slot(req)  # resident: an LRU bump
        self.adapter_slots[slot] = seq.adapter_slot
        seq.output_tokens.append(first)
        if req.guided_json:
            # a preempted continuation resumes mid-object
            seq.guide = json_guide.replay_scalar(
                self._ensure_guide_table(),
                [*req.prior_output_token_ids, first])
        self.seqs[slot] = seq
        self.block_tables[slot, :] = 0
        self.block_tables[slot, :len(pages)] = pages
        self._invalidate_dev()  # new membership: rebuild the device batch
        self.temperature[slot] = req.temperature
        self.top_p[slot] = req.top_p
        self.top_k[slot] = req.top_k
        self.presence[slot] = req.presence_penalty
        self.frequency[slot] = req.frequency_penalty
        self.min_p[slot] = req.min_p
        self.bias_ids[slot], self.bias_vals[slot] = _pack_logit_bias(req)
        self.slot_keys[slot] = req_key
        self.token_counts[slot].zero_()
        self.token_counts[slot, first] += 1
        if req.prior_output_token_ids and (req.presence_penalty
                                           or req.frequency_penalty):
            # preempted continuation: its earlier output is still output
            row = np.zeros((self.model_cfg.vocab_size,), np.int32)
            np.add.at(row, np.asarray(req.prior_output_token_ids,
                                      np.int64), 1)
            self.token_counts[slot] += self._tensor(row)
        self.metrics.output_tokens += 1
        self.flight.note("admit", rid=req.request_id, slot=slot,
                         tenant=self._tenant_of(req),
                         adapter=req.adapter or "", prompt_len=prompt_len,
                         pages=len(pages))
        return seq

    @staticmethod
    def _decorate_lp(ev: TokenEvent, seq: SeqState, chosen: float, tids,
                     tvals) -> None:
        ev.logprob = float(chosen)
        n = min(int(seq.logprobs or 0), len(tids))
        ev.top_logprobs = [(int(tids[i]), float(tvals[i])) for i in range(n)]

    # ------------------------------------------------------------- decode --

    def _ensure_pages(self, n: int) -> bool:
        """can_alloc, with eviction of unshared prefix-cache pages as the
        pressure valve."""
        if self.allocator.can_alloc(n):
            return True
        # only the pressure path is timeline-worthy: eviction walks the
        # prefix cache, the happy path above is one compare
        with self.timeline.phase("page_alloc"):
            if self.prefix_cache is None:
                return False
            self.prefix_cache.evict(n - self.allocator.free_pages)
            return self.allocator.can_alloc(n)

    def _window_steps(self, extra: int = 0) -> int:
        """How many decode steps the next window may take (1 = classic).

        k = num_scheduler_steps only when every live sequence has k tokens
        of headroom (max_tokens, max_seq_len, block-table columns), so no
        stop or table overflow can happen inside the window, and nothing
        is pending (admission latency beats batching). `extra`: tokens of
        a window in flight (async), which the headroom must cover too.
        Returns 0 when not even one step fits on top of it (the caller
        drains the pipeline and steps synchronously)."""
        k = self.cfg.num_scheduler_steps
        small = k <= 1 or self.pending or not self.seqs
        pmax_tokens = self.cfg.max_pages_per_seq * self.cfg.page_size
        want = 1 if small else k
        for seq in self.seqs.values():
            n_out = len(seq.output_tokens)
            headroom = min(
                seq.max_tokens - n_out,
                self.cfg.max_seq_len - (seq.prompt_len + n_out),
                pmax_tokens - seq.num_tokens,
            ) - extra
            if headroom < want:
                want = 1 if headroom >= 1 else 0
                if want == 0:
                    return 0
        return want

    def _grow_pages(self, window: int, events: List[TokenEvent],
                    offset: int = 0, allow_kill: bool = True) -> int:
        """Give every active sequence the pages for its next `window`
        tokens (positions num_tokens + offset onwards; `offset`: tokens of
        a window in flight). Falls back to a 1-token window when the pool
        cannot cover the whole one; preempts (recompute) under pressure and
        finishes with kv_oom only when the pool could never hold the
        sequence, unless allow_kill is False (a window is in flight over
        those pages), where it returns 0 for the caller to drain first."""
        cfg = self.cfg
        pcap = cfg.max_pages_per_seq - 1
        if window > 1:
            need_total = 0
            for seq in self.seqs.values():
                last_page = min((seq.num_tokens + offset + window - 1)
                                // cfg.page_size, pcap)
                need_total += max(0, last_page + 1 - len(seq.pages))
            if not self._ensure_pages(need_total):
                window = 1
        for slot, seq in list(self.seqs.items()):
            if self.seqs.get(slot) is not seq:
                continue  # preempted by an earlier iteration
            last_page = min((seq.num_tokens + offset + window - 1)
                            // cfg.page_size, pcap)
            need = max(0, last_page + 1 - len(seq.pages))
            if need == 0:
                continue
            if not self._ensure_pages(need):
                if not allow_kill:
                    return 0
                self._preempt_for(need, protect=slot)
                if not self._ensure_pages(need):
                    if (len(self.seqs) > 1 and len(seq.pages) + need
                            <= cfg.num_pages - 1):
                        self._preempt_slot(slot)
                        continue
                    self.metrics.kv_oom += 1
                    events.append(TokenEvent(seq.request_id, -1,
                                             len(seq.output_tokens), True,
                                             "kv_oom"))
                    self.flight.note("kv_oom", rid=seq.request_id,
                                     slot=slot,
                                     tenant=self._tenant_of(seq.req),
                                     where="decode", need_pages=need)
                    self._finish_slot(slot, "kv_oom")
                    continue
            for page in self.allocator.alloc(need):
                seq.pages.append(page)
                self.block_tables[slot, len(seq.pages) - 1] = page
            self._dev_tables_ok = False
        return window

    def _preempt_for(self, need: int, protect: int) -> None:
        """Free >= `need` pages by preempting victims (worst priority, then
        youngest), never the protected slot nor a better-priority one. With
        QoS on the priority is `_rank_priority`: the tenant class's offset
        and the over-budget and batch penalties make an over-budget or
        batch tenant's sequences the first victims."""
        def rank(seq):
            return (self._rank_priority(seq.req), seq.req.arrival_time)

        protected = self.seqs.get(protect)
        floor = rank(protected) if protected is not None else (-(1 << 30),)
        while not self.allocator.can_alloc(need):
            victims = [(s, q) for s, q in self.seqs.items()
                       if s != protect and rank(q) >= floor]
            if not victims:
                return
            slot, _ = max(victims, key=lambda kv: rank(kv[1]))
            self._preempt_slot(slot)

    def _preempt_slot(self, slot: int) -> None:
        """Preempt one sequence by recompute: free its pages and requeue a
        continuation (prompt + output so far) at the front of its level."""
        seq = self.seqs.get(slot)
        if seq is None:
            return
        old = seq.req
        cont = dataclasses.replace(
            old,
            prompt_token_ids=list(seq.prompt_ids) + list(seq.output_tokens),
            max_tokens=seq.max_tokens - len(seq.output_tokens),
            prior_output_token_ids=(list(old.prior_output_token_ids)
                                    + list(seq.output_tokens)),
        )
        log.info("preempting %s under page pressure (%d output tokens "
                 "recompute)", seq.request_id, len(seq.output_tokens))
        self.flight.note("preempt", rid=seq.request_id, slot=slot,
                         tenant=self._tenant_of(old),
                         n_out=len(seq.output_tokens),
                         pages_freed=len(seq.pages))
        self._finish_slot(slot, None)
        self.metrics.num_finished -= 1  # preempted, not finished
        self.metrics.num_preempted += 1
        if self.qos is not None:
            self.qos.note_preempt(self._tenant_of(old))
        with self._lock:
            self._insert_pending(cont, requeue=True)

    def _decode_once(self) -> List[TokenEvent]:
        """Synchronous decode: dispatch one window and read it back."""
        events: List[TokenEvent] = []
        with self.timeline.phase("page_alloc"):
            window = self._grow_pages(self._window_steps(), events)
        if not self.seqs:
            return events
        self._dispatch_window(window)
        events.extend(self._materialize_pending())
        return events

    def _decode_async(self) -> List[TokenEvent]:
        """Pipelined decode: dispatch window k+1, THEN read window k back,
        so the host's wait overlaps the new window's device work. A finish
        read from window k drains the pipeline (window k+1's tokens for the
        surviving sequences are processed in the same step, the finished
        slot's discarded)."""
        events: List[TokenEvent] = []
        prev = self._pending_win
        lag = prev[0] if prev is not None else 0
        window = self._window_steps(extra=lag)
        if window > 0:
            with self.timeline.phase("page_alloc"):
                window = self._grow_pages(window, events, offset=lag,
                                          allow_kill=prev is None)
        if not self.seqs:
            events.extend(self._materialize_pending())
            return events
        if window <= 0:
            # no headroom or pages to run ahead of the window in flight:
            # drain it and step synchronously
            events.extend(self._materialize_pending())
            if self.seqs:
                events.extend(self._decode_once())
            return events
        self._dispatch_window(window, offset=lag)
        if prev is not None:
            events.extend(self._materialize_window(prev))
            if any(ev.finished for ev in events):
                # a finish frees pages the new window still touches: drain
                # it before an admission can reuse them
                events.extend(self._materialize_pending())
        return events

    def _invalidate_dev(self, tables_only: bool = False) -> None:
        self._dev_tables_ok = False
        if not tables_only:
            self._dev_state_ok = False
            self._dev_sampling_ok = False

    def _ensure_dev_state(self) -> None:
        """Rebuild the stale parts of the device batch from the host
        mirrors, in place (a captured graph keeps its buffers)."""
        b = self.batch
        if not self._dev_state_ok:
            n = self.cfg.max_num_seqs
            tokens = np.zeros((n,), np.int64)
            positions = np.zeros((n,), np.int32)
            ctx = np.ones((n,), np.int32)  # inactive: trash page, context 1
            step = np.zeros((n,), np.int32)
            # the guided slots' grammar state from their host mirrors
            guide = np.zeros((3, n), np.int32)
            gactive = np.zeros((n,), np.bool_)
            for slot in range(n):
                seq = self.seqs.get(slot)
                if seq is None:
                    self.block_tables[slot, :] = 0
                    continue
                tokens[slot] = seq.output_tokens[-1]
                positions[slot] = seq.num_tokens
                ctx[slot] = seq.num_tokens + 1
                step[slot] = 1
                if seq.guide is not None:
                    guide[:, slot] = seq.guide
                    gactive[slot] = True
            for dst, arr in ((b.tokens, tokens), (b.positions, positions),
                             (b.context_lens, ctx), (b.step, step),
                             (b.gmode, guide[0]), (b.gdepth, guide[1]),
                             (b.gbits, guide[2]), (b.gactive, gactive),
                             (b.adapters, self.adapter_slots)):
                upload(dst, arr)
            self._dev_state_ok = True
            self._dev_tables_ok = False
        if not self._dev_tables_ok:
            upload(b.tables, self.block_tables)
            self._dev_tables_ok = True
        if not self._dev_sampling_ok:
            for dst, arr in ((b.temperature, self.temperature),
                             (b.top_p, self.top_p), (b.top_k, self.top_k),
                             (b.presence, self.presence),
                             (b.frequency, self.frequency),
                             (b.min_p, self.min_p),
                             (b.bias_ids, self.bias_ids),
                             (b.bias_vals, self.bias_vals),
                             (b.slot_keys, self.slot_keys)):
                upload(dst, arr)
            self._gates = smp.gates(self.temperature, self.top_p, self.top_k,
                                    self.presence, self.frequency,
                                    self.min_p, self.bias_ids)
            self._dev_sampling_ok = True

    def _check_window_pages(self, window: int, offset: int,
                            room=None) -> None:
        """A window writes only pages its sequence owns alone: shared
        (prefix-cached) pages hold full prompt pages before every write.
        With `room` [B] (a verify step), a slot without room writes one
        token."""
        ps = self.cfg.page_size
        for slot, seq in self.seqs.items():
            first = seq.num_tokens + offset
            span = window if room is None or room[slot] else 1
            for idx in range(first // ps, (first + span - 1) // ps + 1):
                page = seq.pages[idx]
                if self.allocator.refs(page) != 1:
                    raise AssertionError(
                        f"{seq.request_id}: a decode window would write "
                        f"shared page {page} (refcount "
                        f"{self.allocator.refs(page)})")

    def _dispatch_window(self, window: int, offset: int = 0,
                         forward=None) -> None:
        """Queue a decode window (or, with `forward`, one eager step of the
        mixed forward) and the copy of its outputs to the host."""
        t0 = time.monotonic()
        with self.timeline.phase("dispatch"):
            # chaos: a wedged device program. On the card a spin queued
            # ahead of the window, so the hang shows in the device_wait
            # readback with _exec_lock held, where a real one would; on
            # the CPU the host sleeps inside this armed seam
            spec = faults.check("engine.device_hang")
            if spec is not None:
                self._device_hang(spec.delay_s)
            self._ensure_dev_state()
            self._check_window_pages(window, offset)
            want_lp = any(s.logprobs is not None
                          for s in self.seqs.values())
            if forward is None:
                self.windows.run(window, want_lp, self._gates,
                                 self._any_guided())
            else:
                self.windows.run_eager(forward, want_lp, self._gates)
            rb = self._readbacks[self._next_readback]
            self._next_readback ^= 1
            rb.start(window, 4 if want_lp else 1)
        # membership at dispatch: a slot installed later does not consume
        # this window's rows
        self._pending_win = (window, rb, want_lp, time.monotonic() - t0,
                             list(self.seqs))

    def _device_hang(self, seconds: float) -> None:
        """engine.device_hang's effect: `seconds` of device-side spin on
        the engine's stream (torch.cuda._sleep counts SM clock cycles, at
        the card's reported clock, else 1.98 GHz) or, on the CPU, of host
        sleep."""
        if seconds <= 0:
            return
        if self.device.type != "cuda":
            time.sleep(seconds)
            return
        props = torch.cuda.get_device_properties(self.device)
        khz = getattr(props, "clock_rate", 0) or 1_980_000
        torch.cuda._sleep(int(seconds * khz * 1e3))

    def _materialize_pending(self) -> List[TokenEvent]:
        if self._pending_win is None:
            return []
        return self._materialize_window(self._pending_win)

    def _bad_token_slots(self, tokens: np.ndarray) -> set:
        """The decode sentinel: slots whose readback [k, B] holds a token
        id outside [0, vocab), a corrupted device result that would poison
        detok and the KV it indexes (JAX `_materialize_window`); none with
        DYNAMO_TPU_INTEGRITY=off."""
        if self.integrity == "off":
            return set()
        oob = ((tokens < 0) | (tokens >= self.model_cfg.vocab_size))
        return set(np.flatnonzero(oob.reshape(tokens.shape[0], -1)
                                  .any(axis=0)).tolist())

    def _token_integrity_abort(self, seq: SeqState, slot: int,
                               events: List[TokenEvent]) -> None:
        """End exactly this slot's stream on a corrupted readback."""
        self.watchdog.record_integrity_fault(
            "decode_tokens", [seq.request_id], slot=slot)
        events.append(TokenEvent(seq.request_id, -1,
                                 len(seq.output_tokens), True,
                                 "integrity_fault"))
        self._finish_slot(slot, "integrity_fault")

    def _materialize_window(self, pw, kind: str = "decode",
                            take: int = 0) -> List[TokenEvent]:
        """Read a dispatched window back and stop-check its tokens; a
        slot's tokens after its stop are discarded. The window's time is
        its host dispatch plus the wait for its readback (work between
        the two, as under async scheduling, is not counted). `kind`
        "mixed": the mixed step's one step beside `take` chunk tokens."""
        if self._pending_win is pw:
            self._pending_win = None
        window, rb, want_lp, dispatch_s, slots = pw
        t_wait = time.monotonic()
        with self.timeline.phase("device_wait"):
            # chaos: a slow but live readback, which must NOT trip the
            # watchdog while it stays under the deadline
            faults.sleep_point("engine.device_slow")
            out = rb.wait()
        next_np = out[0]  # [window, B]
        bad = self._bad_token_slots(next_np)
        dt = dispatch_s + time.monotonic() - t_wait
        m = self.metrics
        m.decode_steps += window
        m.decode_time_s += dt
        if kind == "mixed":
            m.observe_phase("mixed_step", dt)
            m.observe_mixed(take, len(slots))
        m.observe_phase("decode_window", dt)
        m.observe_phase("decode_step", dt / window, weight=window)
        m.observe_occupancy(len(slots), self.cfg.max_num_seqs)
        self._step_obs(kind, dt, take=take)
        events: List[TokenEvent] = []
        with self.timeline.phase("detok"):
            for slot in slots:
                seq = self.seqs.get(slot)
                if seq is None:  # finished or aborted since dispatch
                    continue
                if slot in bad:
                    self._token_integrity_abort(seq, slot, events)
                    continue
                for k in range(window):
                    ev = self._emit_token(seq, int(next_np[k, slot]))
                    if want_lp and seq.logprobs is not None:
                        self._decorate_lp(ev, seq, out[1][k, slot],
                                          out[2][k, slot], out[3][k, slot])
                    events.append(ev)
                    if ev.finished:
                        self._finish_slot(slot, ev.finish_reason)
                        break
        return events

    def _emit_token(self, seq: SeqState, tok: int) -> TokenEvent:
        """A decoded token: the token it attended is now cached; append it
        and stop-check it."""
        seq.num_tokens += 1
        seq.output_tokens.append(tok)
        if seq.guide is not None:
            # the host mirror keeps up with the device state, so a
            # rebuild of the batch resumes mid-object
            seq.guide = json_guide.advance_scalar(self._guide_table,
                                                  seq.guide, tok)
        self.metrics.output_tokens += 1
        finished, reason = self._check_stop(seq, tok)
        return TokenEvent(seq.request_id, tok, len(seq.output_tokens) - 1,
                          finished, reason)

    def _check_stop(self, seq: SeqState, token: int):
        if token in seq.stop_token_ids:
            return True, "stop"
        if len(seq.output_tokens) >= seq.max_tokens:
            return True, "length"
        if seq.prompt_len + len(seq.output_tokens) >= self.cfg.max_seq_len:
            return True, "length"
        return False, None

    def _finish_slot(self, slot: int, reason: Optional[str]) -> None:
        seq = self.seqs.pop(slot, None)
        if seq is None:
            return
        if reason is not None:  # None: a preemption, noted by its caller
            self.flight.note("finish", rid=seq.request_id, slot=slot,
                             tenant=self._tenant_of(seq.req), reason=reason,
                             n_out=len(seq.output_tokens))
        self.allocator.free(seq.pages)
        self.block_tables[slot, :] = 0
        self._invalidate_dev()
        # reset the slot's sampling mirrors so the host-side gates see an
        # all-greedy batch again once sampled requests leave
        self.temperature[slot] = 0.0
        self.top_p[slot] = 1.0
        self.top_k[slot] = 0
        self.presence[slot] = 0.0
        self.frequency[slot] = 0.0
        self.min_p[slot] = 0.0
        self.bias_ids[slot] = -1
        self.bias_vals[slot] = 0.0
        self.adapter_slots[slot] = 0  # unpins the LoRA slot
        # the draft pool's pages and the adaptive window key on the decode
        # slot: every way out clears them before the slot's next tenant
        if self.draft is not None:
            self.draft.release(slot)
        if self._adaptive is not None:
            self._adaptive.reset(slot)
        self._free_slots.append(slot)
        self.metrics.num_finished += 1

    # ------------------------------------------------- disaggregation API --

    def _ensure_kernels(self) -> None:
        """The kernel library's first build takes tens of seconds: never
        inside a watched seam."""
        if self.device.type == "cuda" and cuda_attention._lib is None:
            with self.watchdog.exempt("kernel_build"):
                cuda_attention.build()

    def prefill_only(self, req: GenRequest):
        """Prefill-worker role: run the prompt (the whole prompt at its
        bucket, prefill.cu on the card), sample the first token, and PARK
        the sequence (no decode slot) until its KV is exported (JAX
        `prefill_only`; the reference's `--disaggregation-mode prefill`).
        Returns (first_token, n_prompt_tokens, extras), extras carrying
        the first token's logprob fields when requested. The KV stays
        resident until export_kv*/release_parked or the TTL sweep."""
        if req.adapter and (self.lora is None
                            or not self.lora.known(req.adapter)):
            raise ValueError(f"unknown adapter {req.adapter!r} on this "
                             f"prefill worker")
        if len(req.prompt_token_ids) >= self.cfg.max_seq_len:
            raise ValueError("prompt exceeds max_seq_len")
        n_pages = max(1, -(-len(req.prompt_token_ids) // self.cfg.page_size))
        if n_pages > self.cfg.num_pages - 1:
            raise ValueError(
                f"prompt needs {n_pages} KV pages; pool only has "
                f"{self.cfg.num_pages - 1}")
        self._ensure_kernels()
        with self._exec_lock, torch.inference_mode():
            got = self._run_prefill(req, where="prefill_only")
        if isinstance(got, TokenEvent):
            raise RuntimeError(
                f"{req.request_id}: prefill logits not finite "
                f"(integrity fault); nothing parked")
        first, pages, prompt_len, _, lp, _ = got
        with self._lock:
            stale = self._parked.pop(req.request_id, None)
            self._parked[req.request_id] = (pages, prompt_len,
                                            time.monotonic())
        if stale is not None:
            with self._exec_lock:
                self.allocator.free(stale[0])
        extras = {}
        if req.logprobs is not None:
            n = min(int(req.logprobs), len(lp[1]))
            extras = {"logprob": lp[0],
                      "top_logprobs": [(int(lp[1][i]), float(lp[2][i]))
                                       for i in range(n)]}
        return first, prompt_len, extras

    def _gather_parked(self, request_id: str):
        """A parked sequence's K and V pages as fresh device tensors
        [L, n_pages, page_size, lanes] (the pools' layout, page-major),
        gathered on the stream the steps use, under the exec lock."""
        with self._lock:
            pages, n_tokens, _ = self._parked[request_id]
        idx = self._tensor(pages, torch.long)
        with self._exec_lock, torch.inference_mode():
            return (self.k_pages.index_select(1, idx),
                    self.v_pages.index_select(1, idx), n_tokens)

    def export_kv(self, request_id: str):
        """A parked sequence's KV for the TCP plane: (k, v, n_tokens) as
        host tensors [L, n_pages, page_size, lanes] (KeyError for an
        unknown id)."""
        k, v, n_tokens = self._gather_parked(request_id)
        return k.cpu(), v.cpu(), n_tokens

    def export_kv_device(self, request_id: str):
        """Device-resident twin of export_kv: the gathered pages stay on
        the card, a fresh allocation each (never a view of the pools), so
        a same-process decode engine scatters them without a host bounce
        and the cross-process plane can export them over CUDA IPC."""
        return self._gather_parked(request_id)

    def release_parked(self, request_id: str) -> None:
        """Free a parked sequence's pages (idempotent). The allocator's
        books change under the exec lock, as every prefill_only's do."""
        with self._lock:
            parked = self._parked.pop(request_id, None)
        if parked:
            with self._exec_lock:
                self.allocator.free(parked[0])

    def expire_parked(self, ttl_s: float = 120.0) -> int:
        """Free parked sequences never pulled by a decode worker (a
        crashed peer or a lost ack). Returns the number expired."""
        cutoff = time.monotonic() - ttl_s
        with self._lock:
            stale = [rid for rid, (_, _, ts) in self._parked.items()
                     if ts < cutoff]
        for rid in stale:
            log.warning("expiring parked KV for %s (never pulled)", rid)
            self.release_parked(rid)
        return len(stale)

    def import_kv(self, req: GenRequest, first_token: int, k, v):
        """Decode-worker role: install transferred KV (host or device
        tensors [L, n_pages, page_size, lanes]) and the first token as a
        live sequence, which the normal batch loop then decodes. Returns
        (finished, reason): finished when the first (prefill-sampled)
        token already ends the request, and then nothing is installed."""
        n_prompt = len(req.prompt_token_ids)
        spec = self.kv_spec
        dtype = str(k.dtype).replace("torch.", "")
        if k.shape[-1] != spec.lane_width or dtype != spec.dtype:
            # fail the handshake loudly: a prefill/decode kv_cache_dtype
            # mismatch must not surface as a shape error in the scatter
            raise ValueError(
                f"transferred KV (dtype={dtype}, lanes={k.shape[-1]}) "
                f"does not match this decode worker's pool "
                f"(dtype={spec.dtype}, lanes={spec.lane_width}) — prefill "
                f"and decode roles must use the same --kv-cache-dtype (and, "
                f"for int8 KV, the same --tensor-parallel: the rows are "
                f"lane-blocked per TP shard)")
        if (tuple(k.shape) != tuple(v.shape) or k.shape[0] != spec.num_layers
                or k.shape[2] != spec.page_size):
            raise ValueError(
                f"transferred KV of shape {tuple(k.shape)} / "
                f"{tuple(v.shape)} does not match this decode worker's "
                f"pool ({spec.num_layers} layers, page size "
                f"{spec.page_size}): the roles must serve the same model "
                f"at the same --page-size")
        if req.adapter and (self.lora is None
                            or not self.lora.known(req.adapter)):
            raise ValueError(f"unknown adapter {req.adapter!r} on this "
                             f"decode worker")
        if first_token in self._stop_ids_for(req):
            return True, "stop"
        if req.max_tokens <= 1 or n_prompt + 1 >= self.cfg.max_seq_len:
            return True, "length"
        self._ensure_kernels()
        with self._exec_lock, torch.inference_mode():
            return self._import_kv_locked(req, first_token, k, v, n_prompt)

    def _import_kv_locked(self, req, first_token, k, v, n_prompt):
        if not self._free_slots:
            raise OutOfPages("no free decode slot for imported sequence")
        # resolve (and lazily load) the adapter BEFORE any allocation so an
        # unknown or slotless adapter leaks no page or slot
        self._adapter_slot(req)
        n_pages = k.shape[1]
        if not self._ensure_pages(n_pages):  # evicts cached pages
            raise OutOfPages(f"need {n_pages} pages for the imported "
                             f"sequence, {self.allocator.free_pages} free")
        # a new slot changes the batch: drain a window in flight first;
        # its tokens go out with the next step's events
        self._deferred.extend(self._materialize_pending())
        pages = self.allocator.alloc(n_pages)
        idx = self._tensor(pages, torch.long)
        # in place: the captured decode graphs hold the pools' addresses
        self.k_pages.transpose(0, 1).index_copy_(
            0, idx, k.to(self.device).transpose(0, 1))
        self.v_pages.transpose(0, 1).index_copy_(
            0, idx, v.to(self.device).transpose(0, 1))
        slot = self._free_slots.pop()
        # a seeded request continues the chain the prefill worker started
        # (the noise is keyed by root and position), so disagg == agg
        self._install_slot(req, slot, pages, n_prompt, first_token,
                           self._request_key(req))
        if self.qos is not None:
            with self._lock:
                self._rid_tenant[req.request_id] = self._tenant_of(req)
        self.metrics.num_requests += 1
        return False, None

    # -------------------------------------------------------- speculation --

    def _any_logprobs(self) -> bool:
        return any(s.logprobs is not None for s in self.seqs.values())

    def _any_guided(self) -> bool:
        return any(s.guide is not None for s in self.seqs.values())

    def _propose_ngram(self, seq: SeqState) -> List[int]:
        """Prompt-lookup drafts: match the last `ngram_lookup` tokens of
        the history (prompt + output) against earlier history and propose
        the continuation of the most recent match, else repeat the last
        token."""
        cfg = self.cfg
        k = cfg.num_speculative_tokens
        hist = seq.prompt_ids + seq.output_tokens
        n = max(1, cfg.ngram_lookup)
        if len(hist) > n:
            pat = hist[-n:]
            for i in range(len(hist) - n - 1, -1, -1):
                if hist[i:i + n] == pat:
                    cont = hist[i + n:i + n + k]
                    if cont:
                        return (cont + [hist[-1]] * k)[:k]
                    break
        return [hist[-1] if hist else 0] * k

    def _spec_demoted(self) -> bool:
        """Batch-wide demotion of a verify step to the plain decode path,
        counted by reason: a JSON-guided sequence (the verify step samples
        unmasked logits, so drafts could escape the grammar) or a logprobs
        request (per-position logprobs are not read out of the verify
        step)."""
        if self._any_guided():
            self._demote("guided")
            return True
        if self._any_logprobs():
            self._demote("logprobs")
            return True
        return False

    def _spec_drafts(self, got: int):
        """Drafts for every slot whose acceptance can be nonzero: not
        penalized (its counts would go stale mid-window), with pages and
        limits for K+1 tokens ahead (`got` == K+1 from _grow_pages), and
        served by the draft pool; each demotion counted by reason.
        -> (drafts [B, K], room [B], nreal [B]): nreal real drafts per
        slot (< K under adaptive K; the row is padded by repeating the
        last real draft)."""
        cfg = self.cfg
        k = cfg.num_speculative_tokens
        k1 = k + 1
        limit = min(cfg.max_seq_len, cfg.max_pages_per_seq * cfg.page_size)
        drafts = np.zeros((cfg.max_num_seqs, k), np.int64)
        room = np.zeros((cfg.max_num_seqs,), np.bool_)
        nreal = np.zeros((cfg.max_num_seqs,), np.int64)
        for slot, seq in self.seqs.items():
            if self.presence[slot] != 0.0 or self.frequency[slot] != 0.0:
                self._demote("penalties")
                continue
            if not (got == k1 and seq.num_tokens + k1 <= limit
                    and len(seq.pages) * cfg.page_size
                    >= seq.num_tokens + k1):
                self._demote("page_shortfall")
                continue
            k_s = (self._adaptive.k(slot) if self._adaptive is not None
                   else k)
            if self.draft is not None:
                prop = self.draft.propose(seq, k_s)
                if prop is None:
                    self._demote("draft_pool")
                    continue
            else:
                prop = self._propose_ngram(seq)[:k_s]
            room[slot] = True
            nreal[slot] = len(prop)
            drafts[slot] = (prop + [prop[-1]] * k)[:k]
        return drafts, room, nreal

    def _spec_feedback(self, slots, room, nreal, nacc) -> None:
        """Drafter-labelled draft and accept books, acceptance lengths and
        the adaptive controller's feedback; acceptances are clamped to
        each slot's real drafts."""
        drafted = accepted = 0
        for s in slots:
            if not room[s]:
                continue
            n_real = int(nreal[s])
            acc = min(int(nacc[s]), n_real)
            drafted += n_real
            accepted += acc
            self.metrics.observe_spec_accept(acc, drafter=self.drafter_name)
            if self._adaptive is not None:
                self._adaptive.update(s, acc, n_real)
        self.metrics.add_spec_tokens(drafted, accepted,
                                     drafter=self.drafter_name)
        if drafted:
            self.flight.note("spec_verify", drafter=self.drafter_name,
                             windows=int(room[slots].sum()),
                             drafted=drafted, accepted=accepted)

    def _run_verify(self, drafts, room, slots, forward=None, take: int = 0):
        """Dispatch one verify step over the device batch (the captured
        one, or with `forward` the mixed verify forward, eagerly, beside
        `take` chunk tokens) and read back what it emitted: (emitted
        [B, K1], n_acc [B]). `slots`: the live slots at dispatch."""
        t0 = time.monotonic()
        with self.timeline.phase("dispatch"):
            self._ensure_dev_state()
            self._check_window_pages(self.cfg.num_speculative_tokens + 1, 0,
                                     room)
            upload(self.batch.drafts, drafts)
            upload(self.batch.room, room)
            if forward is None:
                self.verify.run(self._gates)
            else:
                self.verify.run_eager(forward, self._gates)
            rb = self._spec_readback
            rb.start(self.cfg.max_num_seqs, 2)
        with self.timeline.phase("device_wait"):
            emitted, nacc = rb.wait()
        dt = time.monotonic() - t0
        m = self.metrics
        m.decode_steps += 1
        m.spec_verify_steps += 1
        m.decode_time_s += dt
        if forward is not None:
            m.observe_phase("mixed_step", dt)
            m.observe_mixed(take, len(slots))
        m.observe_phase("decode_window", dt)
        m.observe_occupancy(len(slots), self.cfg.max_num_seqs)
        # weighted by the steps this verify advanced (tokens per slot), so
        # verify steps and windows carry proportional votes
        total = sum(int(nacc[s]) + 1 for s in slots)
        eff_steps = max(1, -(-total // max(len(slots), 1)))
        m.observe_phase("decode_step", dt / eff_steps, weight=eff_steps)
        self._step_obs("decode_spec" if forward is None else "mixed_spec",
                       dt, take=take)
        return emitted, nacc

    def _emit_verified(self, slots, emitted, nacc) -> List[TokenEvent]:
        """Stop-check the tokens each slot emitted: a slot's tokens after
        its stop are discarded (finishing the slot invalidates the
        advanced device carry)."""
        events: List[TokenEvent] = []
        for slot in slots:
            seq = self.seqs.get(slot)
            if seq is None:
                continue
            if self._bad_token_slots(emitted[slot, :int(nacc[slot]) + 1,
                                             None]):
                self._token_integrity_abort(seq, slot, events)
                continue
            for j in range(int(nacc[slot]) + 1):
                ev = self._emit_token(seq, int(emitted[slot, j]))
                events.append(ev)
                if ev.finished:
                    self._finish_slot(slot, ev.finish_reason)
                    break
        return events

    def _decode_spec(self) -> List[TokenEvent]:
        """One speculative decode step: a verify step emits 1..K+1 tokens
        per speculating slot. A logprobs request demotes the step to the
        plain decode path, and so does a batch where nothing drafted (the
        verify forward would cost K+1 rows per slot for one token each)."""
        if self._spec_demoted():
            return self._decode_once()
        # the verify step extends the device carry: drain a window in
        # flight first
        events = self._materialize_pending()
        k1 = self.cfg.num_speculative_tokens + 1
        with self.timeline.phase("page_alloc"):
            got = self._grow_pages(k1, events)
        if not self.seqs:
            return events
        drafts, room, nreal = self._spec_drafts(got)
        if not room.any():
            events.extend(self._decode_once())
            return events
        slots = list(self.seqs)
        emitted, nacc = self._run_verify(drafts, room, slots)
        self._spec_feedback(slots, room, nreal, nacc)
        with self.timeline.phase("detok"):
            events.extend(self._emit_verified(slots, emitted, nacc))
        return events

    def _mixed_spec_step(self) -> List[TokenEvent]:
        """One mixed step with speculation: every decode slot runs its
        verify window and the inflight prefill's next chunk rides the same
        forward (`llama.mixed_verify_step`, eager like _mixed_step), run
        even when no slot drafted; on the final chunk the first token
        comes from the same forward's last-row logits."""
        inf = self._inflight
        cfg = self.cfg
        events = self._materialize_pending()
        with self.timeline.phase("page_alloc"):
            got = self._grow_pages(cfg.num_speculative_tokens + 1, events)
        if not self.seqs:
            # page pressure emptied the batch: the chunk still has its
            # reserved pages, so it advances on the classic path
            events.extend(self._advance_chunk())
            return events
        drafts, room, nreal = self._spec_drafts(got)
        c = cfg.mixed_batch_tokens
        start = inf.done
        take = min(c, inf.prompt_len - start)
        chunk = np.zeros((c,), np.int64)
        chunk[:take] = inf.req.prompt_token_ids[start:start + take]
        chunk_dev = self._tensor(chunk)
        chunk_logits = []

        def forward(tokens, positions, tables, room_dev):
            logits, last = llama.mixed_verify_step(
                self.model, tokens, positions, tables, room_dev, chunk_dev,
                start, take, inf.pages_dev, self.k_pages, self.v_pages,
                page_size=cfg.page_size, lora=self.lora_stacks,
                adapter_slots=self.batch.adapters,
                chunk_adapter_slot=inf.aslot)
            chunk_logits.append(last)
            return logits

        slots = list(self.seqs)
        emitted, nacc = self._run_verify(drafts, room, slots, forward, take)
        self._spec_feedback(slots, room, nreal, nacc)
        with self.timeline.phase("detok"):
            events.extend(self._emit_verified(slots, emitted, nacc))
        inf.done += take
        self.metrics.mixed_spec_count += 1
        if inf.done < inf.prompt_len:
            return events
        events.append(self._install_inflight(chunk_logits[0]))
        return events
