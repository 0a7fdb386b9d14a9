"""Prometheus metrics, stdlib-only.

The metric names ARE the compatibility contract: the reference's Grafana
dashboard queries these exact series
(reference examples/dgdr/trtllm/grafana-dynamo-dashboard-configmap.yaml:
121 requests_total, 214 time_to_first_token, 307 inter_token_latency,
400 request_duration, 493/504 input/output_sequence_tokens), so the dashboard
ports to this stack unchanged. Implemented in-process (counter/gauge/histogram
with _sum/_count/_bucket text exposition) to avoid a prometheus_client
dependency.

Exposition formats: the classic Prometheus text format
(`text/plain; version=0.0.4`) by default; when the scraper's Accept header
asks for `application/openmetrics-text`, histograms additionally emit their
stored trace **exemplars** in OpenMetrics exemplar syntax
(`name_bucket{le="..."} N # {trace_id="..."} value ts`) and the page ends
with `# EOF` — the bridge from a p99 latency bucket straight to its span
tree at `/debug/spans?trace_id=...` (docs/observability.md).

Labeled metrics declare their label names (`labelnames=("model",)`) so a
fresh scrape emits no phantom *unlabeled* zero sample for them; only truly
label-less metrics default to `name 0`.

The port's own copy of `dynamo_tpu/serving/metrics.py`
(it imports nothing of the JAX package); keep the two in step.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

_DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
    5.0, 10.0, 30.0, 60.0,
)
_TOKEN_BUCKETS = (1, 8, 32, 128, 512, 1024, 2048, 4096, 8192, 16384)

PROM_CONTENT_TYPE = "text/plain; version=0.0.4"
OPENMETRICS_CONTENT_TYPE = (
    "application/openmetrics-text; version=1.0.0; charset=utf-8")


def _escape_label_value(v) -> str:
    """Exposition-format label escaping: backslash first (or the other two
    escapes would be double-escaped), then quote and newline. Without this,
    one adversarial label value corrupts the whole /metrics scrape."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _fmt_labels(labels: Tuple[Tuple[str, str], ...], extra: str = "") -> str:
    parts = [f'{k}="{_escape_label_value(v)}"' for k, v in labels]
    if extra:
        parts.append(extra)
    return "{" + ",".join(parts) + "}" if parts else ""


class _Metric:
    def __init__(self, name: str, help_: str, registry: "Registry",
                 labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help_
        # declared label names: a labeled metric with no children yet emits
        # HELP/TYPE only — never a synthetic UNLABELED zero sample that
        # dashboards would read as a phantom series
        self.labelnames = tuple(labelnames)
        self._lock = threading.Lock()
        registry._register(self)

    def _default_items(self):
        """The synthetic sample for an empty metric: `name 0` only when the
        metric is label-less by declaration."""
        return [] if self.labelnames else [((), 0.0)]


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name, help_, registry, labelnames: Sequence[str] = ()):
        super().__init__(name, help_, registry, labelnames)
        self._values: Dict[Tuple[Tuple[str, str], ...], float] = {}

    def labels(self, **labels) -> "_CounterChild":
        return _CounterChild(self, tuple(sorted(labels.items())))

    def inc(self, amount: float = 1.0, **labels):
        self.labels(**labels).inc(amount)

    def values(self) -> Dict[Tuple[Tuple[str, str], ...], float]:
        """Point-in-time copy of every child's cumulative value (consumed by
        the SLO engine's delta bucketing, observability/slo.py)."""
        with self._lock:
            return dict(self._values)

    def expose(self, openmetrics: bool = False) -> List[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} counter"]
        with self._lock:
            items = list(self._values.items()) or self._default_items()
            for lbl, v in items:
                out.append(f"{self.name}{_fmt_labels(lbl)} {v}")
        return out


class _CounterChild:
    def __init__(self, parent: Counter, labels):
        self.parent, self.lbl = parent, labels

    def inc(self, amount: float = 1.0):
        with self.parent._lock:
            self.parent._values[self.lbl] = (
                self.parent._values.get(self.lbl, 0.0) + amount
            )


class CallbackCounter(_Metric):
    """Counter whose value is read from a callback at scrape time — for
    monotonic counts that live in another subsystem's own bookkeeping
    (e.g. the engine KVBM's block counters) without double-counting or
    cross-thread increment plumbing."""

    kind = "counter"

    def __init__(self, name, help_, registry, fn):
        super().__init__(name, help_, registry)
        self._fn = fn

    def expose(self, openmetrics: bool = False) -> List[str]:
        try:
            v = float(self._fn())
        except Exception:
            v = 0.0
        return [f"# HELP {self.name} {self.help}",
                f"# TYPE {self.name} counter", f"{self.name} {v}"]


class CallbackCounterVec(_Metric):
    """Labeled CallbackCounter: the callback returns a mapping from a
    label tuple (or dict) to a cumulative value, read at scrape time —
    for per-label-set counts kept in another subsystem's own bookkeeping
    (e.g. the attention dispatch's Pallas→XLA demotion counts by
    op/reason, ops/attention.pallas_fallback_counts)."""

    kind = "counter"

    def __init__(self, name, help_, registry, fn,
                 labelnames: Sequence[str] = ()):
        super().__init__(name, help_, registry, labelnames)
        self._fn = fn

    def expose(self, openmetrics: bool = False) -> List[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} counter"]
        try:
            items = self._fn() or {}
        except Exception:
            items = {}
        rows = []
        for lbl, v in items.items():
            if isinstance(lbl, dict):
                lbl = tuple(sorted(lbl.items()))
            rows.append((tuple(lbl), float(v)))
        for lbl, v in sorted(rows) or self._default_items():
            out.append(f"{self.name}{_fmt_labels(lbl)} {v}")
        return out


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name, help_, registry, labelnames: Sequence[str] = ()):
        super().__init__(name, help_, registry, labelnames)
        self._values: Dict[Tuple[Tuple[str, str], ...], float] = {}

    def set(self, value: float, **labels):
        with self._lock:
            self._values[tuple(sorted(labels.items()))] = value

    def remove(self, **labels):
        """Drop one label-set's series (e.g. a device's stale variant after a
        label value flips) so it doesn't stay frozen at its last value."""
        with self._lock:
            self._values.pop(tuple(sorted(labels.items())), None)

    def expose(self, openmetrics: bool = False) -> List[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} gauge"]
        with self._lock:
            items = list(self._values.items()) or self._default_items()
            for lbl, v in items:
                out.append(f"{self.name}{_fmt_labels(lbl)} {v}")
        return out


class Histogram(_Metric):
    kind = "histogram"

    def __init__(self, name, help_, registry,
                 buckets: Sequence[float] = _DEFAULT_BUCKETS,
                 labelnames: Sequence[str] = ()):
        super().__init__(name, help_, registry, labelnames)
        self.buckets = tuple(buckets)
        self._counts: Dict[Tuple[Tuple[str, str], ...], List[int]] = {}
        self._sum: Dict[Tuple[Tuple[str, str], ...], float] = {}
        self._n: Dict[Tuple[Tuple[str, str], ...], int] = {}
        # one exemplar per (label-set, bucket): the newest observation wins,
        # so a hot p99 bucket always links to a RECENT trace
        self._exemplars: Dict[Tuple[Tuple[Tuple[str, str], ...], int],
                              Tuple[str, float, float]] = {}

    def observe(self, value: float, exemplar: Optional[str] = None, **labels):
        """Record an observation; `exemplar` (a trace id) attaches to the
        bucket the value falls in and is emitted in OpenMetrics scrapes."""
        lbl = tuple(sorted(labels.items()))
        with self._lock:
            counts = self._counts.setdefault(lbl, [0] * (len(self.buckets) + 1))
            idx = len(self.buckets)  # +Inf unless a finite bucket matches
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
                    if i < idx:
                        idx = i
            counts[-1] += 1  # +Inf
            self._sum[lbl] = self._sum.get(lbl, 0.0) + value
            self._n[lbl] = self._n.get(lbl, 0) + 1
            if exemplar:
                self._exemplars[(lbl, idx)] = (
                    str(exemplar), float(value), time.time())

    def snapshot(self) -> Dict[Tuple[Tuple[str, str], ...],
                               Tuple[List[int], int, float]]:
        """Per-label-set (cumulative bucket counts, count, sum) copy — the
        SLO engine diffs consecutive snapshots into time buckets."""
        with self._lock:
            return {lbl: (list(c), self._n.get(lbl, 0),
                          self._sum.get(lbl, 0.0))
                    for lbl, c in self._counts.items()}

    def good_total(self, threshold: float
                   ) -> Dict[Tuple[Tuple[str, str], ...], Tuple[int, int]]:
        """Per-label-set (observations <= threshold, total observations).

        The threshold snaps DOWN to the largest bucket edge <= threshold
        (values between that edge and the threshold count as breaches —
        conservative). SLO targets should sit on bucket boundaries."""
        i = -1
        for j, b in enumerate(self.buckets):
            if b <= threshold:
                i = j
        out: Dict[Tuple[Tuple[str, str], ...], Tuple[int, int]] = {}
        with self._lock:
            for lbl, counts in self._counts.items():
                good = counts[i] if i >= 0 else 0
                out[lbl] = (good, self._n.get(lbl, 0))
        return out

    def _exemplar_suffix(self, lbl, idx) -> str:
        ex = self._exemplars.get((lbl, idx))
        if ex is None:
            return ""
        trace_id, value, ts = ex
        return (f' # {{trace_id="{_escape_label_value(trace_id)}"}} '
                f"{value} {round(ts, 3)}")

    def expose(self, openmetrics: bool = False) -> List[str]:
        out = [f"# HELP {self.name} {self.help}", f"# TYPE {self.name} histogram"]
        with self._lock:
            lbls = list(self._counts) or ([] if self.labelnames else [()])
            for lbl in lbls:
                counts = self._counts.get(lbl, [0] * (len(self.buckets) + 1))
                # note: pre-built le= pairs — a backslash escape inside an
                # f-string EXPRESSION is a SyntaxError before Python 3.12
                for i, b in enumerate(self.buckets):
                    le = f'le="{b}"'
                    line = (f"{self.name}_bucket{_fmt_labels(lbl, le)} "
                            f"{counts[i]}")
                    if openmetrics:
                        line += self._exemplar_suffix(lbl, i)
                    out.append(line)
                inf_le = 'le="+Inf"'
                line = f"{self.name}_bucket{_fmt_labels(lbl, inf_le)} {counts[-1]}"
                if openmetrics:
                    line += self._exemplar_suffix(lbl, len(self.buckets))
                out.append(line)
                out.append(
                    f"{self.name}_sum{_fmt_labels(lbl)} {self._sum.get(lbl, 0.0)}"
                )
                out.append(f"{self.name}_count{_fmt_labels(lbl)} {self._n.get(lbl, 0)}")
        return out


class CallbackHistogram(_Metric):
    """Histogram whose buckets are read from a callback at scrape time —
    the bridge that exposes the engine's in-loop PhaseTimer distributions
    (engine.EngineMetrics) as real Prometheus histograms without a second
    observation path in the hot loop.

    `fn()` returns an iterable of
    ``(labels_dict, edges_seconds, cumulative_counts, sum_seconds, count)``
    where ``cumulative_counts`` has ``len(edges) + 1`` entries (the last is
    +Inf and must equal ``count``)."""

    kind = "histogram"

    def __init__(self, name, help_, registry, fn):
        super().__init__(name, help_, registry)
        self._fn = fn

    def expose(self, openmetrics: bool = False) -> List[str]:
        out = [f"# HELP {self.name} {self.help}",
               f"# TYPE {self.name} histogram"]
        try:
            series = list(self._fn())
        except Exception:
            series = []
        for labels, edges, cum, sum_s, count in series:
            lbl = tuple(sorted(labels.items()))
            for i, edge in enumerate(edges):
                le = f'le="{edge}"'
                out.append(f"{self.name}_bucket{_fmt_labels(lbl, le)} {cum[i]}")
            inf_le = 'le="+Inf"'
            out.append(f"{self.name}_bucket{_fmt_labels(lbl, inf_le)} "
                       f"{cum[len(edges)]}")
            out.append(f"{self.name}_sum{_fmt_labels(lbl)} {sum_s}")
            out.append(f"{self.name}_count{_fmt_labels(lbl)} {count}")
        return out


class Registry:
    def __init__(self):
        self._metrics: List[_Metric] = []
        self._lock = threading.Lock()

    def _register(self, m: _Metric):
        with self._lock:
            self._metrics.append(m)

    def expose(self, openmetrics: bool = False) -> str:
        lines: List[str] = []
        with self._lock:
            metrics = list(self._metrics)
        for m in metrics:
            lines.extend(m.expose(openmetrics=openmetrics))
        if openmetrics:
            lines.append("# EOF")
        return "\n".join(lines) + "\n"

    def scrape(self, accept: Optional[str]) -> Tuple[bytes, str]:
        """Content negotiation for a /metrics handler: OpenMetrics (with
        exemplars) when the scraper asks for it, classic text otherwise."""
        om = bool(accept and "application/openmetrics-text" in accept)
        body = self.expose(openmetrics=om).encode()
        return body, (OPENMETRICS_CONTENT_TYPE if om else PROM_CONTENT_TYPE)


class FrontendMetrics:
    """The dynamo_frontend_* serving-metric contract (SURVEY.md §5)."""

    def __init__(self, registry: Optional[Registry] = None):
        self.registry = registry or Registry()
        r = self.registry
        self.requests_total = Counter(
            "dynamo_frontend_requests_total", "Total LLM requests", r,
            labelnames=("model",),
        )
        self.errors_total = Counter(
            "dynamo_frontend_errors_total",
            "Requests answered with a 5xx by this process (the error-rate "
            "SLO source, observability/slo.py)", r,
            labelnames=("model", "code"),
        )
        self.ttft = Histogram(
            "dynamo_frontend_time_to_first_token_seconds",
            "Time to first token", r, labelnames=("model",),
        )
        self.itl = Histogram(
            "dynamo_frontend_inter_token_latency_seconds",
            "Inter-token latency", r, labelnames=("model",),
        )
        self.duration = Histogram(
            "dynamo_frontend_request_duration_seconds",
            "End-to-end request duration", r, labelnames=("model",),
        )
        self.isl = Histogram(
            "dynamo_frontend_input_sequence_tokens",
            "Input sequence length (tokens)", r, buckets=_TOKEN_BUCKETS,
            labelnames=("model",),
        )
        self.osl = Histogram(
            "dynamo_frontend_output_sequence_tokens",
            "Output sequence length (tokens)", r, buckets=_TOKEN_BUCKETS,
            labelnames=("model",),
        )
        self.queued = Gauge(
            "dynamo_frontend_queued_requests", "Requests queued or in flight", r
        )
        # --- per-tenant QoS (dynamo_tpu.qos; docs/robustness.md) ---
        # tenant-labeled latency series: the per-tenant SLO selectors
        # (observability/slo.py SLOTarget.tenant) and the QoS isolation
        # acceptance tests read THESE, so an aggressive tenant's tail
        # can't hide inside the model-labeled aggregate. Labelnames are
        # declared, so an untenanted deployment emits no phantom samples.
        self.tenant_requests = Counter(
            "dynamo_tenant_requests_total",
            "Requests by resolved tenant identity", r,
            labelnames=("tenant",),
        )
        self.tenant_ttft = Histogram(
            "dynamo_tenant_time_to_first_token_seconds",
            "Time to first token by tenant", r, labelnames=("tenant",),
        )
        self.tenant_itl = Histogram(
            "dynamo_tenant_inter_token_latency_seconds",
            "Inter-token latency by tenant", r, labelnames=("tenant",),
        )
