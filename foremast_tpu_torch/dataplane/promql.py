"""Metric query construction: the reference's window/URL semantics.

Re-implements the behavior of foremast-barrelman's query builder
(pkg/client/metrics/metricsquery.go) and foremast-service's URL helpers
(pkg/prometheus/prometheushelper.go:13-43, pkg/wavefront/wavefronthelper.go:14-52):

  * step = 60 s, boundary-aligned (metricsquery.go:63-65).
  * current window  — pod-level series over [start+step, end] (start shifted
    one step for scrape lag, metricsquery.go:72-84); app-level for
    continuous/hpa strategies.
  * baseline window — the window immediately BEFORE current, same length
    (metricsquery.go:85-92).
  * historical      — app-level over the trailing 7 days (metricsquery.go:93-99).
  * continuous/hpa jobs carry START_TIME/END_TIME placeholders, materialized
    by the engine each cycle (foremast-service/cmd/manager/main.go:59-63).
  * priority = position of the metric in the metadata list (metricsquery.go:37-44).
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from urllib.parse import quote

from ..ops.windowing import DEFAULT_STEP, align_step

START_PLACEHOLDER = "START_TIME"
END_PLACEHOLDER = "END_TIME"

STRATEGY_ROLLING_UPDATE = "rollingUpdate"
STRATEGY_CANARY = "canary"
STRATEGY_CONTINUOUS = "continuous"
STRATEGY_HPA = "hpa"
STRATEGY_ROLLOVER = "rollover"

CONTINUOUS_STRATEGIES = (STRATEGY_CONTINUOUS, STRATEGY_HPA)

HISTORICAL_DAYS = 7


@dataclass
class MetricQuerySpec:
    """One metric to monitor, as named by DeploymentMetadata."""

    name: str  # short name, e.g. "error5xx" or full series name
    data_source_type: str = "prometheus"  # or "wavefront"
    query: str = ""  # explicit query override (wavefront / custom)
    priority: int = 0
    is_increase: bool = True
    is_absolute: bool = False


def pod_level_query(metric: str, namespace: str, pods: list[str]) -> str:
    sel = "|".join(pods)
    return f'namespace_pod_{metric}{{namespace="{namespace}",pod=~"{sel}"}}'


def app_level_query(metric: str, namespace: str, app: str) -> str:
    return f'namespace_app_pod_{metric}{{namespace="{namespace}",app="{app}"}}'


def prometheus_range_url(endpoint: str, query: str, start, end, step: int = DEFAULT_STEP) -> str:
    if not endpoint.endswith("/"):
        endpoint += "/"
    return (
        f"{endpoint}query_range?query={quote(query, safe='')}"
        f"&start={start}&end={end}&step={step}"
    )


def wavefront_url(endpoint: str, query: str, start, end, step: int = DEFAULT_STEP) -> str:
    """Wavefront chart-API style: query && start && granularity && end
    (granularity letter from the step: s/m/h/d)."""
    if step < 60:
        gran = "s"
    elif step < 3600:
        gran = "m"
    elif step < 86400:
        gran = "h"
    else:
        gran = "d"
    return f"{endpoint}?q={quote(query, safe='')}&s={start}&g={gran}&e={end}"


def placeholderize(url: str, historical: bool) -> str:
    """Swap concrete start/end params for START_TIME/END_TIME placeholders.

    The single home of URL-dialect knowledge: prometheus uses start=/end=,
    wavefront s=/e=. Historical URLs get the _H marker so the engine
    re-materializes them onto the 7-day window instead of the 30-min one.
    """
    if not url:
        return url
    start = f"{START_PLACEHOLDER}_H" if historical else START_PLACEHOLDER
    url = re.sub(r"([?&])(start|s)=[^&]*", rf"\g<1>\g<2>={start}", url)
    return re.sub(r"([?&])(end|e)=[^&]*", rf"\g<1>\g<2>={END_PLACEHOLDER}", url)


@dataclass
class MetricWindows:
    """The three query URLs for one metric."""

    name: str
    current: str = ""
    baseline: str = ""
    historical: str = ""
    priority: int = 0
    is_increase: bool = True
    is_absolute: bool = False


def build_metric_windows(
    endpoint: str,
    specs: list[MetricQuerySpec],
    strategy: str,
    start: float,
    end: float,
    namespace: str,
    app: str,
    current_pods: list[str] | None = None,
    baseline_pods: list[str] | None = None,
    step: int = DEFAULT_STEP,
) -> list[MetricWindows]:
    """Materialize current/baseline/historical query URLs for each metric."""
    start_a = align_step(start, step) + step  # +1 step: scrape lag
    end_a = align_step(end, step)
    length = max(end_a - start_a, step)
    out = []
    for i, spec in enumerate(specs):
        continuous = strategy in CONTINUOUS_STRATEGIES
        if spec.query:
            cur_q = base_q = hist_q = spec.query
        elif continuous or not current_pods:
            cur_q = base_q = hist_q = app_level_query(spec.name, namespace, app)
        else:
            cur_q = pod_level_query(spec.name, namespace, current_pods)
            base_q = pod_level_query(spec.name, namespace, baseline_pods or current_pods)
            hist_q = app_level_query(spec.name, namespace, app)

        def url(q, s, e):
            if spec.data_source_type == "wavefront":
                return wavefront_url(endpoint, q, s, e, step)
            return prometheus_range_url(endpoint, q, s, e, step)

        if continuous:
            # windows re-materialized every cycle by the engine
            cur = placeholderize(url(cur_q, 0, 0), historical=False)
            base = ""
            hist = placeholderize(url(hist_q, 0, 0), historical=True)
        else:
            cur = url(cur_q, start_a, end_a)
            base = url(base_q, start_a - length, start_a)
            hist = url(hist_q, end_a - HISTORICAL_DAYS * 86400, end_a)
        out.append(
            MetricWindows(
                name=spec.name,
                current=cur,
                baseline=base,
                historical=hist,
                priority=spec.priority or i,
                is_increase=spec.is_increase,
                is_absolute=spec.is_absolute,
            )
        )
    return out


def materialize_placeholders(url: str, now: float, window_seconds: int = 1800,
                             step: int = DEFAULT_STEP) -> str:
    """Swap START_TIME/END_TIME for a concrete trailing window at `now`.

    START_TIME_H (historical variant) expands to the 7-day window.
    """
    end = align_step(now, step)
    start = end - window_seconds
    hist_start = end - HISTORICAL_DAYS * 86400
    return (
        url.replace(f"start={START_PLACEHOLDER}_H", f"start={hist_start}")
        .replace(f"start={START_PLACEHOLDER}", f"start={start}")
        .replace(f"end={END_PLACEHOLDER}", f"end={end}")
        .replace(f"s={START_PLACEHOLDER}_H", f"s={hist_start}")
        .replace(f"s={START_PLACEHOLDER}", f"s={start}")
        .replace(f"e={END_PLACEHOLDER}", f"e={end}")
    )


def pod_count_url(endpoint: str, namespace: str, app: str, start, end,
                  step: int = DEFAULT_STEP) -> str:
    """Ready-pod-count query (metricsquery.go:149-169 'count' alias)."""
    q = app_level_query("ready_count", namespace, app)
    return prometheus_range_url(endpoint, q, start, end, step)
