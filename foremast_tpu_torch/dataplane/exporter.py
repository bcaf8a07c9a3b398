"""Verdict exporter: the foremastbrain:* Prometheus series.

The reference brain exports its model bounds, anomaly markers and HPA score
back into Prometheus (series consumed by the dashboard at
foremast-dashboard/src/config/metrics.js:21-29, by the custom-metrics
adapter at deploy/custom-metrics/custom-metrics-config-map.yaml:27-37, and
scraped from :8000/metrics per foremast-brain.yaml:88,110-122):

    foremastbrain:<metric>_upper / _lower / _anomaly    {app, namespace}
    foremastbrain:namespace_app_per_pod:hpa_score       {app, namespace}

This registry renders the Prometheus text exposition format; the service
mounts it at /metrics. A Wavefront mirror (custom.iks.foremast.* per
foremast-trigger/pkg/foremasttrigger/trigger.go:166-168) can subscribe to
the same registry via `samples()`.

A copy of the reference's `VerdictExporter`; its OTLP trace exporter is not
ported (the port has no trace export yet).
"""
from __future__ import annotations

import bisect
import time

from ..utils.locks import make_lock
from ..utils.promtext import escape_label_value as _esc
from ..utils.promtext import sanitize_metric_name as _sanitize_name

# default latency buckets (seconds) for record_histogram: spans the
# engine's dynamic range from sub-ms memo-hit fetches to multi-minute
# cold-compile cycles; p50/p99 of anything in between interpolates sanely
DEFAULT_TIME_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0,
)


class VerdictExporter:
    # counter key-set ceiling: counter labels derive from job-submitted
    # query-URL hosts, so without a cap a create flood with unique
    # endpoints grows process memory and /metrics output without bound
    # (same flood the BreakerBoard caps with max_keys)
    MAX_COUNTER_KEYS = 4096

    def __init__(self, stale_seconds: float = 3600.0):
        self._lock = make_lock("dataplane.exporter")
        self._gauges: dict[tuple, tuple[float, float]] = {}  # key -> (value, at)
        # counters are monotone and never TIME-staled: a counter that
        # vanishes mid-scrape makes rate() windows lie. They are bounded
        # by KEY COUNT instead — at the ceiling, the oldest-inserted key
        # is dropped (a reset rate() window on a hostile flood beats
        # unbounded growth).
        self._counters: dict[tuple, float] = {}
        # histograms: key -> [bucket_counts (+Inf implicit last), sum,
        # count]; bucket EDGES are per metric NAME (first registration
        # wins — one le= grid per series family, a Prometheus requirement)
        self._hists: dict[tuple, list] = {}
        self._hist_buckets: dict[str, tuple] = {}
        # metric name -> (prom type, help text); only metrics registered
        # here get `# HELP`/`# TYPE` exposition lines (the legacy verdict
        # gauges stay bare — their scrape contract predates the metadata)
        self._meta: dict[str, tuple[str, str]] = {}
        self.stale_seconds = stale_seconds

    def _set(self, name: str, labels: dict, value: float):
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            self._gauges[key] = (float(value), time.time())

    def record_gauge(self, name: str, labels: dict, value: float,
                     help: str = ""):
        """Public gauge with optional metadata (renders # HELP/# TYPE)."""
        if help:
            with self._lock:
                self._meta.setdefault(name, ("gauge", help))
        self._set(name, labels, value)

    def record_counter(self, name: str, labels: dict, inc: float = 1.0,
                       help: str = ""):
        """Monotone counter sample; rendered with `# TYPE <name> counter`
        so foremastbrain:*_total series are well-formed exposition."""
        key = (name, tuple(sorted(labels.items())))
        with self._lock:
            if key not in self._counters \
                    and len(self._counters) >= self.MAX_COUNTER_KEYS:
                del self._counters[next(iter(self._counters))]
            self._counters[key] = self._counters.get(key, 0.0) + float(inc)
            if help:
                self._meta.setdefault(name, ("counter", help))
            else:
                self._meta.setdefault(name, ("counter", ""))

    def record_histogram(self, name: str, labels: dict, value: float,
                         help: str = "",
                         buckets: tuple = DEFAULT_TIME_BUCKETS):
        """One histogram observation; rendered as the Prometheus
        `_bucket`/`_sum`/`_count` triplet so p50/p99 are a PromQL
        histogram_quantile away instead of only a running max. Bounded by
        the same key ceiling as counters (label sets can derive from
        user-submitted jobs)."""
        key = (name, tuple(sorted(labels.items())))
        v = float(value)
        with self._lock:
            edges = self._hist_buckets.setdefault(name, tuple(buckets))
            h = self._hists.get(key)
            if h is None:
                if len(self._hists) >= self.MAX_COUNTER_KEYS:
                    del self._hists[next(iter(self._hists))]
                h = self._hists[key] = [[0] * (len(edges) + 1), 0.0, 0]
            h[0][bisect.bisect_left(edges, v)] += 1
            h[1] += v
            h[2] += 1
            if help:
                self._meta.setdefault(name, ("histogram", help))
            else:
                self._meta.setdefault(name, ("histogram", ""))

    def record_bounds(self, app: str, namespace: str, metric: str,
                      upper: float, lower: float, anomaly: float):
        labels = {"app": app, "namespace": namespace}
        metric = _sanitize_name(metric)
        self._set(f"foremastbrain:{metric}_upper", labels, upper)
        self._set(f"foremastbrain:{metric}_lower", labels, lower)
        self._set(f"foremastbrain:{metric}_anomaly", labels, anomaly)

    def record_cycle_stages(self, stages: dict, families: dict):
        """Per-stage cycle timing gauges, fed from the engine's tracing
        stage accumulators every cycle: how the last cycle's wall time
        split across preprocess (fetch wait), dispatch (pack + async
        launch), collect (device wait + merge) and fold (verdict
        writing), plus per-model-family scoring seconds. The overlap
        story in two series: at full pipeline efficiency
        sum(cycle_stage_seconds) is well under the cycle wall clock."""
        for stage, secs in stages.items():
            self.record_gauge(
                "foremastbrain:cycle_stage_seconds", {"stage": stage},
                round(float(secs), 6),
                help="Seconds spent per engine-cycle stage (last cycle).")
            # distribution companion to the last-cycle gauge: p50/p99 per
            # stage instead of only the latest sample
            self.record_histogram(
                "foremastbrain:cycle_stage_duration_seconds",
                {"stage": stage}, float(secs),
                help="Per-stage engine-cycle seconds (histogram).")
        for family, secs in families.items():
            self.record_gauge(
                "foremastbrain:cycle_family_score_seconds",
                {"family": family}, round(float(secs), 6),
                help="Per-model-family scoring seconds (last cycle).")

    def record_triage(self, family: str, screened: int, cleared: int,
                      escalated: int):
        """Per-cycle tier-0 triage increments for one family (engine
        calls this after each cycle; zero increments are skipped so the
        counter families only materialize once triage actually runs)."""
        if screened:
            self.record_counter(
                "foremastbrain:triage_screened_total", {"family": family},
                screened,
                help="rows screened by the tier-0 triage kernel")
        if cleared:
            self.record_counter(
                "foremastbrain:triage_cleared_total", {"family": family},
                cleared,
                help="screened rows cleared straight to a healthy verdict")
        if escalated:
            self.record_counter(
                "foremastbrain:triage_escalated_total", {"family": family},
                escalated,
                help="screened rows escalated to the full family scorers")

    def record_hpa_score(self, app: str, namespace: str, score: float):
        self._set(
            "foremastbrain:namespace_app_per_pod:hpa_score",
            {"app": app, "namespace": namespace},
            score,
        )

    def samples(self):
        """[(name, labels-dict, value)] for alternate sinks (Wavefront)."""
        now = time.time()
        with self._lock:
            # evict, don't just filter: label sets come from user-submitted
            # jobs, so unexpired-but-unevicted keys are an unbounded leak
            dead = [k for k, (_, at) in self._gauges.items()
                    if now - at > self.stale_seconds]
            for k in dead:
                del self._gauges[k]
            return [
                (name, dict(labels), value)
                for (name, labels), (value, at) in self._gauges.items()
            ]

    def counter_samples(self):
        """[(name, labels-dict, value)] for the counter family (separate
        from samples(): the Wavefront mirror forwards gauges only)."""
        with self._lock:
            return [
                (name, dict(labels), value)
                for (name, labels), value in self._counters.items()
            ]

    def histogram_samples(self):
        """Point-in-time snapshot: [(name, labels, edges, counts, sum,
        count)] — counts copied under the lock (scrape threads race the
        cycle thread's observations)."""
        with self._lock:
            return [
                (name, dict(labels), self._hist_buckets[name],
                 list(h[0]), h[1], h[2])
                for (name, labels), h in self._hists.items()
            ]

    def render(self) -> str:
        """Prometheus text exposition (0.0.4). Samples are grouped per
        metric name (an exposition requirement once metadata lines exist),
        with `# HELP`/`# TYPE` emitted for metrics that registered them."""
        by_name: dict[str, list] = {}
        for name, labels, value in self.samples() + self.counter_samples():
            by_name.setdefault(name, []).append((labels, value))
        with self._lock:
            meta = dict(self._meta)
        lines = []
        for name in sorted(by_name):
            kind_help = meta.get(name)
            if kind_help is not None:
                kind, help_text = kind_help
                if help_text:
                    lines.append(f"# HELP {name} {help_text}")
                lines.append(f"# TYPE {name} {kind}")
            for labels, value in sorted(
                by_name[name], key=lambda s: sorted(s[0].items())
            ):
                lab = ",".join(
                    f'{k}="{_esc(v)}"' for k, v in sorted(labels.items()))
                # ':' is legal in prometheus metric names (recording-rule
                # style); label-less samples omit the braces — `name{}` is
                # not part of the 0.0.4 exposition grammar (the scrape-
                # compat test in tests/test_fleet_plane.py parses every
                # line against it)
                lines.append(f"{name}{{{lab}}} {value}" if lab
                             else f"{name} {value}")
        hists = sorted(self.histogram_samples(),
                       key=lambda s: (s[0], sorted(s[1].items())))
        seen_meta: set[str] = set()
        for name, labels, edges, counts, total, n in hists:
            if name not in seen_meta:
                seen_meta.add(name)
                kind_help = meta.get(name)
                if kind_help is not None and kind_help[1]:
                    lines.append(f"# HELP {name} {kind_help[1]}")
                lines.append(f"# TYPE {name} histogram")
            base = ",".join(
                f'{k}="{_esc(v)}"' for k, v in sorted(labels.items()))
            sep = "," if base else ""
            cum = 0
            for edge, c in zip(edges, counts):
                cum += c
                lines.append(
                    f'{name}_bucket{{{base}{sep}le="{edge:g}"}} {cum}')
            cum += counts[-1]
            lines.append(f'{name}_bucket{{{base}{sep}le="+Inf"}} {cum}')
            if base:
                lines.append(f"{name}_sum{{{base}}} {round(total, 6)}")
                lines.append(f"{name}_count{{{base}}} {n}")
            else:
                lines.append(f"{name}_sum {round(total, 6)}")
                lines.append(f"{name}_count {n}")
        return "\n".join(lines) + "\n"
