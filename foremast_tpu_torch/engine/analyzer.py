"""The analysis engine: jobs -> card batches -> verdicts.

The port's counterpart of the reference's ``engine/analyzer.py``: a batched
cycle in which every runnable job's windows are fetched, packed into dense
(B, T) buckets and scored by one kernel launch per bucket rung, then folded
into job statuses. Verdict semantics are the reference's:

  * two judgment modes: pairwise baseline-vs-current (the pair family,
    kernel A through ``parallel.fleet.score_pairs``), and the forecast band
    over history ++ current (the band family, ``ops.forecast.forecast_band``:
    kernel B under moving_average*, the seasonal kernels under the other
    univariate algorithms, kernel J under seasonal_trend* / prophet*; jobs
    with exactly two judgeable metrics go to the bivariate-normal ellipse,
    kernel H through ``ops.bivariate``);
  * jobs with three or more judgeable metrics go to the LSTM autoencoder:
    each app's model is trained on its standardized history the first time
    the engine sees it (kernels L and M through ``models.lstm_ae``, under a
    per-cycle budget, same-shape jobs as one fleet), kept in an LRU of
    MAX_CACHE_SIZE models, and the current windows are z-scored against the
    healthy errors (kernel K);
  * hpa jobs are scored, never judged: kernel C's SES predictions of the
    traffic and kernel I's score (``ops.hpa.hpa_from_preds``), gated by the
    breath cooldowns, go out as an hpalog and the
    ``namespace_app_per_pod:hpa_score`` series each cycle;
  * fail-fast: completed_unhealth the moment an anomaly is seen; otherwise
    healthy jobs re-queue each cycle until endTime;
  * insufficient data by endTime -> completed_unknown;
  * continuous jobs re-materialize START_TIME/END_TIME windows per cycle.

The engine's own layers ride the cycle as in the reference: verdict
provenance (``engine/provenance.py``), detection-latency SLOs and their
waterfall (``engine/slo.py``), the flight recorder (``engine/flightrec.py``)
and the health state machine (``engine/health.py``); and the degraded-mode
rules: load shedding under CYCLE_DEADLINE_S, stale-verdict serving under
MAX_STALE_S, poison-job quarantine under QUARANTINE_AFTER and the collect
watchdog under WATCHDOG_S. ``run_cycle(job_ids=..., partial=True)`` is the
seam of the event-driven scheduler (``engine/scheduler.py``).

Entry: ``Analyzer(config, source, store, exporter=None, device=None)`` runs
on the card ("cuda") unless the caller passes device="cpu", where every
family runs its plain twin; without a card it raises. A CUDA launch either
runs its kernel or raises, and a failure goes to the per-job retry path on
the same device, never to the CPU. On the card the kernel library is
loaded (built, on a fresh machine) before a cycle's deadline budget starts.

Not in this slice (ROADMAP.md): sharding, delta fetch, retries and
breakers.
"""
from __future__ import annotations

import hashlib
import json
import os
import tempfile
import threading
import time
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field

import numpy as np
import torch

from .._device import resolve_device
from ..dataplane.exporter import VerdictExporter
from ..dataplane.fetch import FetchError, grid_from_series
from ..dataplane.promql import (
    CONTINUOUS_STRATEGIES,
    STRATEGY_HPA,
    materialize_placeholders,
)
from ..models import lstm_ae
from ..ops import bivariate as bv
from ..ops import forecast as fc
from ..ops import hpa as hpa_ops
from ..ops.windowing import MAX_WINDOW_STEPS, Window, bucket_length
from ..parallel import fleet as fl
from ..kernels import build as kernel_build
from ..resilience.policy import Deadline
from ..utils import knobs
from ..utils import tracing
from ..utils.locks import make_lock
from ..utils.timeutils import from_rfc3339
from . import flightrec
from . import jobs as J
from . import provenance as prov
from . import slo as slo_mod
from .config import EngineConfig, MetricPolicy
from .health import HealthMonitor
from .staging import Staging


class WatchdogTimeout(Exception):
    """A card materialization (or its per-job retry) overran WATCHDOG_S.

    Raised by Analyzer._watchdog_call; the pipeline's collect phase treats
    it like any collect failure — the bucket fails over to the sync
    per-job path — so one hung launch costs one bucket's timeout, not the
    whole cycle."""


# shed marker carried through the preprocess stream in the `failed` slot:
# distinguishable from every real FetchError string (which the analyzer
# stamps into job reasons) by identity, never shown to users directly
_SHED = "__cycle_deadline_shed__"

# poison-job quarantine re-admission backoff: first parking sits out
# QUARANTINE_BASE_S, doubling per subsequent parking up to the cap.
# QUARANTINE_AFTER is the operator-facing control.
QUARANTINE_BASE_S = 30.0
QUARANTINE_MAX_S = 3600.0


@dataclass
class _PairItem:
    job_id: str
    metric: str
    baseline: Window
    current: Window
    policy: MetricPolicy


@dataclass
class _BandItem:
    job_id: str
    metric: str
    historical: Window
    current: Window
    policy: MetricPolicy


@dataclass
class _BiItem:
    """Two-metric joint job (ML_ALGORITHM=bivariate_normal)."""

    job_id: str
    metrics: tuple  # (name1, name2)
    hist: tuple  # (Window, Window)
    cur: tuple  # (Window, Window)
    policies: tuple  # (MetricPolicy, MetricPolicy)


@dataclass
class _MultiItem:
    """3+-metric LSTM-autoencoder job."""

    job_id: str
    cache_key: str  # app/namespace identity for the model cache
    metrics: list
    hist: list  # [Window]
    cur: list  # [Window]


@dataclass
class _HpaItem:
    job_id: str
    metric: str
    historical: Window
    current: Window
    is_increase: bool = True
    priority: int = 0
    is_absolute: bool = False
    pod_window: object = None


def _fp(*parts) -> bytes:
    """Order-sensitive fingerprint of scorer inputs (SCORE_MEMO).

    Windows hash their full identity (start, step, length, values, mask);
    ndarrays their bytes; everything else its repr. blake2b-128 — the memo
    only ever compares fingerprints of the SAME key, so 128 bits is far
    past accidental-collision territory."""
    h = hashlib.blake2b(digest_size=16)
    for p in parts:
        if p is None:
            h.update(b"\xffN")
        elif isinstance(p, Window):
            h.update(np.float64(
                (p.start, p.step, p.values.shape[0])).tobytes())
            h.update(p.values.tobytes())
            h.update(p.mask.tobytes())
        elif isinstance(p, np.ndarray):
            h.update(np.int64(p.shape).tobytes())
            h.update(p.tobytes())
        else:
            h.update(repr(p).encode())
        h.update(b"|")
    return h.digest()


def _concat_trimmed(hist: Window, cur: Window):
    """(values, mask, n_h) of hist+current, hist left-trimmed so the concat
    fits the largest bucket."""
    n_c = cur.values.shape[0]
    max_h = max(MAX_WINDOW_STEPS - n_c, 0)
    h_vals = hist.values[-max_h:] if max_h else hist.values[:0]
    h_mask = hist.mask[-max_h:] if max_h else hist.mask[:0]
    vals = np.concatenate([h_vals, cur.values[: MAX_WINDOW_STEPS]])
    mask = np.concatenate([h_mask, cur.mask[: MAX_WINDOW_STEPS]])
    return vals, mask, h_vals.shape[0]


def _joint_grid(hists: list, curs: list):
    """Stack a job's metrics onto one shared concat grid.

    Residual length skew between the metrics is resolved by trimming every
    series to the common length: current windows are HEAD-trimmed, so
    concat index n_h + j maps to each current window's own index j, and
    history keeps its tail. Returns (values (F, T), masks (F, T), n_h,
    n_c)."""
    n_c = min(c.values.shape[0] for c in curs)
    n_c = min(n_c, MAX_WINDOW_STEPS)
    n_h = min(h.values.shape[0] for h in hists)
    n_h = min(n_h, MAX_WINDOW_STEPS - n_c)
    vals, masks = [], []
    for h, c in zip(hists, curs):
        hv = h.values[-n_h:] if n_h else h.values[:0]
        hm = h.mask[-n_h:] if n_h else h.mask[:0]
        vals.append(np.concatenate([hv, c.values[:n_c]]))
        masks.append(np.concatenate([hm, c.mask[:n_c]]))
    return np.stack(vals), np.stack(masks), n_h, n_c


def _pod_count_stats(win, split_ts: float):
    """(pods_now, pods_hist) from a ready-pod-count Window, or None.

    `split_ts` is the start of the job's current window, so the recent /
    older split is the region / history split of the score. Single-sided
    data falls back to the other side."""
    if win is None or win.n_valid == 0:
        return None
    t = win.start + np.arange(win.values.shape[0]) * win.step
    recent = win.mask & (t >= split_ts)
    older = win.mask & ~recent
    n_now = float(win.values[recent].mean()) if recent.any() else None
    n_hist = float(win.values[older].mean()) if older.any() else None
    if n_now is None and n_hist is None:
        return None
    n_now = n_hist if n_now is None else n_now
    n_hist = n_now if n_hist is None else n_hist
    return (max(n_now, 1e-6), max(n_hist, 1e-6))


def _concat_ts(cur: Window, n_h: int, j: int) -> float:
    """Translate a concat-grid index onto the CURRENT window's own time grid
    (history is tail-kept, current head-kept, so concat index n_h + k is
    current index k)."""
    return float(cur.start + (j - n_h) * cur.step)


def _put_row(vals: np.ndarray, mask: np.ndarray, j: int, v: np.ndarray, m: np.ndarray):
    """Row j of a packed (R, T) pair of buffers: the window, then zeros and
    False to the right (pack_windows' padding; buffers are reused)."""
    L = v.shape[0]
    vals[j, :L] = v
    vals[j, L:] = 0.0
    mask[j, :L] = m
    mask[j, L:] = False


# launch argument layouts: (name, dtype, columns) for Staging.pack
_F32, _I32, _BOOL = torch.float32, torch.int32, torch.bool
PAIR_SPECS = (("baseline", _F32, "T"), ("b_mask", _BOOL, "T"), ("current", _F32, "T"),
              ("c_mask", _BOOL, "T"), ("pvalue_threshold", _F32, None),
              ("test_mask", _I32, None), ("combine", _I32, None), ("ma_window", _I32, None),
              ("band_threshold", _F32, None), ("bound_mode", _I32, None),
              ("min_lower_bound", _F32, None), ("min_points", _I32, 4))
BAND_SPECS = (("x", _F32, "T"), ("mask", _BOOL, "T"), ("region", _BOOL, "T"),
              ("threshold", _F32, None), ("bound_mode", _I32, None),
              ("min_lower_bound", _F32, None))
BI_SPECS = (("x1", _F32, "T"), ("m1", _BOOL, "T"), ("x2", _F32, "T"), ("m2", _BOOL, "T"),
            ("region", _BOOL, "T"), ("threshold", _F32, None), ("mlb1", _F32, None),
            ("mlb2", _F32, None), ("bm1", _I32, None), ("bm2", _I32, None))
# the HPA launch: kernel C's SES on `hist` (tps_mask & ~region, packed on the
# host so that no torch op runs between the two kernels), then kernel I
HPA_SPECS = (("tps", _F32, "T"), ("tps_mask", _BOOL, "T"), ("hist", _BOOL, "T"),
             ("region", _BOOL, "T"), ("sla", _F32, "T"), ("sla_mask", _BOOL, "T"),
             ("alpha", _F32, None), ("sla_static_limit", _F32, None), ("sla_mode", _I32, None),
             ("threshold", _F32, None), ("safe", _F32, None), ("pods_now", _F32, None),
             ("pods_hist", _F32, None), ("sla_absolute", _BOOL, None))
PAIR_OUTPUTS = ("unhealthy", "min_p", "pairwise_unhealthy", "band_unhealthy", "band_count")
BAND_OUTPUTS = ("count", "first_index", "checked", "upper", "lower", "flags")
BI_OUTPUTS = ("count", "first_index", "checked", "flags", "upper1", "lower1", "upper2",
              "lower2")
HPA_OUTPUTS = ("score", "reason", "current_tps", "tps_upper", "tps_lower", "sla_current",
               "sla_limit", "pods_now", "demand_per_pod")
HPA_REASONS = {hpa_ops.REASON_PREDICTED_TREND: "predicted trend",
               hpa_ops.REASON_ANOMALY_TREND: "anomaly trend",
               hpa_ops.REASON_SLA_VIOLATION: "SLA violation",
               hpa_ops.REASON_SLA_HEADROOM: "SLA headroom"}


@dataclass
class _JobState:
    doc: J.Document
    unhealthy: list = field(default_factory=list)  # (metric, detail, anomaly pairs)
    judged_any: bool = False
    failed: str = ""
    # per-job fetch accounting from the preprocess thread's trace notes
    # (fetches, points, seconds) — provenance's "fetch" block
    fetch: dict = field(default_factory=dict)
    # ingest marker (monotonic): set as the job's preprocess result streams
    # in (0 = shed before fetch / quarantined: no latency observation)
    ingest_at: float = 0.0
    # window-advance stamp: the newest VALID sample timestamp across the
    # job's judged current windows (Analyzer._observe_latency)
    newest_ts: float = 0.0


class Analyzer:
    def __init__(self, config: EngineConfig, data_source, store: J.JobStore,
                 exporter: VerdictExporter | None = None, device=None):
        self.config = config
        self.source = data_source
        self.store = store
        self.exporter = exporter or VerdictExporter()
        self.device = resolve_device(device)
        # restart-safe cooldowns: armed breath timers come back from the
        # store's snapshot, written at every cycle's end
        self.breath = hpa_ops.BreathState()
        self.breath.load(store.get_state("breath") or {})
        # pinned host buffers and the one stream the engine's copies and
        # launches run on (engine/staging.py)
        self.staging = Staging(self.device)
        # last cycle's stage/family timing decomposition — empty until the
        # first cycle
        self.last_cycle_stages: dict = {}
        # -- fingerprint score memoization (SCORE_MEMO) --
        # (family, result_key) -> (fingerprint, result dict). Survives
        # across cycles on the analyzer; the per-cycle CyclePipeline
        # consults it so unchanged rows skip their launch entirely.
        # LRU-bounded at 4x WINDOW_CACHE_MAX (~one entry per job window).
        self._score_memo: OrderedDict = OrderedDict()
        self.score_memo_hits: dict[str, int] = {}    # family -> cumulative
        self.score_memo_misses: dict[str, int] = {}
        # total kernel launches (chunk launches across every family and the
        # tier-0 triage screen) — the steady-state no-change gate asserts
        # this stays flat over a memo-hit cycle
        self.device_launches = 0
        # -- single-dispatch mega-batching (MEGABATCH) cumulative counters:
        # launches through the mega path, real rows carried and padding
        # rows added. Per-cycle deltas land in last_cycle_stages.
        self.megabatch_launches_total = 0
        self.megabatch_real_rows_total = 0
        self.megabatch_pad_rows_total = 0
        # -- tier-0 triage (TRIAGE; engine/triage.py) cumulative counters:
        # rows screened / cleared / escalated per family, and screen
        # launches. Per-cycle deltas land in last_cycle_stages.
        self.triage_screened_total: dict[str, int] = {}
        self.triage_cleared_total: dict[str, int] = {}
        self.triage_escalated_total: dict[str, int] = {}
        self.triage_launches_total = 0
        self._cycle_seq = 0
        self.current_cycle_id = ""
        # LSTM-AE model cache (MAX_CACHE_SIZE semantics): (app key, metrics,
        # W) -> (params (P,) on the device, err_mu, err_sigma, version); the
        # insertion-ordered dict is the LRU eviction queue
        self._lstm_cache: dict = {}
        # fleet scoring: every trained entry gets a version, and stacked
        # parameter rows are kept per (shape, members) while they hold
        self._lstm_param_version = 0
        self._lstm_stack_cache: dict = {}
        # per-CYCLE train-on-miss counter (reset in _run_cycle); on the
        # instance so the _isolate per-job retry path cannot reset it
        self._lstm_trained_this_cycle = 0
        # jobs left unjudged because the cycle's train budget was spent, as
        # a per-cycle id set (a retry must not count a job twice)
        self.lstm_budget_skips = 0
        self._lstm_budget_skipped_ids: set = set()
        # deterministic-training reuse (train-window fingerprint -> trained
        # entry) and verdict reuse ((job, metrics) -> (score fp, z))
        self._lstm_train_memo: OrderedDict = OrderedDict()
        self._lstm_z_memo: OrderedDict = OrderedDict()
        self.lstm_rescore_skips = 0
        # hung-launch watchdog (WATCHDOG_S): fires counter + the live count
        # of abandoned sacrificial threads (each still parked on a hung
        # card call); bounded by _WATCHDOG_MAX_ABANDONED
        self.watchdog_fires_total = 0
        self._wd_lock = make_lock("engine.analyzer.watchdog")
        self._watchdog_abandoned = 0
        # seconds the first cycle on the card spent loading (or building)
        # the kernel library, before its deadline budget started; on the
        # CPU there is no library to load
        self.library_load_seconds = 0.0
        self._library_pending = self.device.type == "cuda"
        # -- observability: provenance + flight recorder --
        # per-(job, cycle) verdict attribution (engine/provenance.py);
        # enabled=False (the PROVENANCE=0 A/B leg) turns every call into a
        # no-op
        self.provenance = prov.ProvenanceRecorder(enabled=config.provenance)
        # incident flight recorder (engine/flightrec.py): bounded ring of
        # structured engine events, auto-dumped on the transition into
        # OVERLOADED/STALLED
        self.flight = flightrec.FlightRecorder(
            dump_dir=config.flight_dump_dir,
            tracer=tracing.tracer, provenance=self.provenance,
            knobs_fn=self._dump_knobs)
        # monotonic stamp of the current cycle's start: the in-cycle half
        # of each detection-latency observation (_observe_latency)
        self._cycle_mono0 = 0.0
        # jobs whose lstm verdict was served from the z-memo this cycle
        # (provenance memo-hit classification); reset per cycle
        self._lstm_memo_jobs: set = set()
        # -- degraded-mode operation state --
        # health state machine; the flight recorder hears its transitions
        # (and dumps on OVERLOADED/STALLED)
        self.health = HealthMonitor(exporter=self.exporter,
                                    recorder=self.flight)
        self.flight.health_fn = self.health.state
        # detection-latency SLOs (engine/slo.py): ingest->verdict latency
        # per job class, with per-class targets and error-budget burn. Pure
        # observation; burn rides the health detail.
        self.slo = slo_mod.DetectionSLO(
            exporter=self.exporter,
            targets={
                "canary": config.slo_canary_seconds,
                "continuous": config.slo_continuous_seconds,
                "hpa": config.slo_hpa_seconds,
            },
            objective=config.slo_objective)
        self.health.configure(slo_fn=self.slo.burn_summary)
        # detection-latency waterfall: the per-stage decomposition of each
        # SLO observation, closed at verdict fold (_observe_latency)
        self.waterfall = slo_mod.DetectionWaterfall(exporter=self.exporter)
        # monotonic stamp of the current cycle's fold start: splits the
        # in-cycle tail into the waterfall's score and fold stages
        self._cycle_fold_mono = 0.0
        # once-per-window-advance SLO dedupe: job_id -> newest judged
        # sample ts already observed. Entries die with the job.
        self._slo_seen: dict[str, float] = {}
        # load shedding (CYCLE_DEADLINE_S): cumulative shed count + the
        # consecutive-shed streak per open job (a shed job sorts ahead of
        # its priority class next cycle)
        self.jobs_shed_total = 0
        self._shed_streak: dict[str, int] = {}
        # stale-verdict serving (MAX_STALE_S): job_id -> last cycle
        # timestamp at which the job was judged healthy on FRESH data
        self.stale_verdicts_served_total = 0
        self._stale_state: dict[str, float] = {}
        # poison-job quarantine (QUARANTINE_AFTER): job_id ->
        # [consecutive_failures, quarantined_until, times_quarantined]
        self.jobs_quarantined_total = 0
        self._quarantine: dict[str, list] = {}

    def _memo_put(self, table: OrderedDict, key, val):
        """Insert-and-bound for the memo table (LRU)."""
        table[key] = val
        table.move_to_end(key)
        bound = max(4 * self.config.window_cache_max, 64)
        while len(table) > bound:
            table.popitem(last=False)

    def _memo_key_fp(self, family: str, entry, T: int):
        """(result_key, fingerprint) for one routed accumulator entry.

        The fingerprint covers everything the family's launch+collect reads
        from the entry: every window's full identity, the policy, and the T
        bucket. Config is absent — it is frozen for the analyzer's lifetime,
        and the memo dies with the analyzer."""
        if family == "pair":
            it = entry
            return ((it.job_id, it.metric, "pair"),
                    _fp(b"pair", T, it.metric, it.baseline, it.current,
                        it.policy))
        if family == "band":
            it = entry
            return ((it.job_id, it.metric, "band"),
                    _fp(b"band", T, it.metric, it.historical, it.current,
                        it.policy))
        if family == "bivariate":
            it = entry[0]  # (item, joint-grid prep)
            return ((it.job_id, "&".join(it.metrics), "bivariate"),
                    _fp(b"bi", T, it.metrics, *it.hist, *it.cur,
                        *it.policies))
        job_id, t, s = entry  # hpa row
        return (job_id,
                _fp(b"hpa", T, t.metric, t.historical, t.current,
                    t.is_increase, t.priority, t.is_absolute, t.pod_window,
                    s.metric, s.historical, s.current, s.is_increase,
                    s.priority, s.is_absolute))

    def _dump_knobs(self) -> dict:
        """Knob values folded into flight-recorder dumps: the degraded-mode
        and observability controls an incident post-mortem needs, and the
        port's process-wide knobs."""
        cfg = self.config
        return {
            "engine": {
                "cycle_deadline_seconds": cfg.cycle_deadline_seconds,
                "max_stale_seconds": cfg.max_stale_seconds,
                "quarantine_after": cfg.quarantine_after,
                "watchdog_seconds": cfg.watchdog_seconds,
                "fetch_cycle_deadline_seconds":
                    cfg.fetch_cycle_deadline_seconds,
                "score_pipeline": cfg.score_pipeline,
                "score_memo": cfg.score_memo,
                "provenance": cfg.provenance,
                "max_claim_per_cycle": cfg.max_claim_per_cycle,
                "fetch_concurrency": cfg.fetch_concurrency,
                "device": str(self.device),
            },
            "env": {name: knobs.read(name) for name in knobs.names()},
        }

    def status_digest(self) -> dict:
        """Compact JSON-safe status digest: health state, job counts,
        last-cycle golden signals, lease and triage counters, and per-class
        detection-latency SLO attainment. Dicts mutated by the cycle thread
        are snapshotted before summing."""
        state, _detail = self.health.state()
        stats = self.last_cycle_stages or {}
        store = self.store
        return {
            "v": 1,
            "health": state,
            "cycle_id": self.current_cycle_id,
            "jobs": store.status_counts(),
            "cycle": {
                "jobs": stats.get("jobs", 0),
                "device_launches": stats.get("device_launches", 0),
                "shed": stats.get("jobs_shed", 0),
                "stale_served": stats.get("stale_verdicts_served", 0),
                "watchdog_fires": stats.get("watchdog_fires", 0),
                "quarantined": stats.get("quarantined_jobs", 0),
            },
            "lease": {
                "claims": store.lease_claims_total,
                "steals": store.lease_steals_total,
            },
            "triage": {
                "screened": sum(dict(self.triage_screened_total).values()),
                "cleared": sum(dict(self.triage_cleared_total).values()),
                "escalated": sum(dict(self.triage_escalated_total).values()),
            },
            "slo": self.slo.digest(),
        }

    # ------------------------------------------------------------------ fetch
    def _fetch_window(self, url: str, now: float) -> Window | None:
        if not url:
            return None
        url = materialize_placeholders(url, now)
        t0 = time.perf_counter()
        try:
            # byte-level sources expose fetch_window: body -> grid Window
            # in one fused native call; series-level sources (fixture
            # dicts) go through fetch() + grid_from_series
            fw = getattr(self.source, "fetch_window", None)
            win = fw(url) if fw is not None else None
            if win is None:
                ts, vals = self.source.fetch(url)
                win = grid_from_series(ts, vals)
            if win is not None:
                tracing.tracer.add_note("points", int(win.values.shape[0]))
            return win
        finally:
            dt = time.perf_counter() - t0
            tracing.tracer.add_note("fetches", 1)
            tracing.tracer.add_note("fetch_seconds", dt)
            self.exporter.record_histogram(
                "foremastbrain:fetch_seconds", {}, dt,
                help="Per-window metric fetch latency (seconds).")

    def _preprocess(self, doc: J.Document, now: float):
        """Fetch all windows for a job; returns (pair, band, bi, multi, hpa)
        item lists. Band candidates route by the configured model family and
        metric count: bivariate_normal pairs 2-metric jobs, lstm_autoencoder
        pools 3+-metric jobs; everything else scores univariate bands."""
        pairs, bands, bis, multis, hpas = [], [], [], [], []
        candidates = []  # (name, hist, cur, policy) judgeable by history
        pod_window = None
        if doc.strategy == STRATEGY_HPA and doc.pod_count_url:
            try:
                pod_window = self._fetch_window(doc.pod_count_url, now)
            except Exception:  # noqa: BLE001 - optional signal, never fatal
                pod_window = None
        for name, mq in doc.metrics.items():
            policy = self.config.policy_for(name)
            cur = self._fetch_window(mq.current, now)
            base = self._fetch_window(mq.baseline, now)
            hist = self._fetch_window(mq.historical, now)
            if cur is None or cur.n_valid == 0:
                # no current data -> nothing judgeable for this metric; the
                # job ends COMPLETED_UNKNOWN at endTime, never "healthy"
                continue
            if doc.strategy == STRATEGY_HPA:
                if hist is not None:
                    hpas.append(
                        _HpaItem(doc.id, name, hist, cur, mq.is_increase,
                                 mq.priority, mq.is_absolute, pod_window)
                    )
                continue
            if base is not None and base.n_valid > 0:
                pairs.append(_PairItem(doc.id, name, base, cur, policy))
            if hist is not None and hist.n_valid >= self.config.min_historical_points:
                candidates.append((name, hist, cur, policy))
        algo = self.config.algorithm
        # the reference dispatches the historical model by METRIC COUNT
        # (one metric -> a univariate forecaster, two -> bivariate normal,
        # 3+ -> LSTM); multimetric_auto=False routes multivariate families
        # only when ML_ALGORITHM names them explicitly
        auto = self.config.multimetric_auto
        if (auto or algo.startswith("bivariate")) and len(candidates) == 2:
            (n1, h1, c1, p1), (n2, h2, c2, p2) = candidates
            bis.append(_BiItem(doc.id, (n1, n2), (h1, h2), (c1, c2), (p1, p2)))
        elif (auto or algo.startswith("lstm")) and len(candidates) >= 3:
            multis.append(
                _MultiItem(
                    doc.id,
                    f"{doc.app_name}/{doc.namespace}",
                    [c[0] for c in candidates],
                    [c[1] for c in candidates],
                    [c[2] for c in candidates],
                )
            )
        else:
            for name, hist, cur, policy in candidates:
                bands.append(_BandItem(doc.id, name, hist, cur, policy))
        return pairs, bands, bis, multis, hpas

    # ------------------------------------------------------------- scoring
    def _isolate(self, score_fn, items):
        """Run a batch scorer with per-job blast-radius containment: on batch
        failure, retry per JOB and report {job_id: error} for the offenders
        only (on the same device: a failure never moves work to the CPU)."""
        try:
            return score_fn(items), {}
        except Exception:  # noqa: BLE001 - fall back to per-job isolation
            results, bad = {}, {}
            by_job: dict[str, list] = {}
            for it in items:
                by_job.setdefault(it.job_id, []).append(it)
            for job_id, group in by_job.items():
                try:
                    results.update(score_fn(group))
                except Exception as e:  # noqa: BLE001
                    bad[job_id] = f"{type(e).__name__}: {e}"
            return results, bad

    def _watchdog_call(self, fn, *args):
        """Run a collect-phase materialization bounded by WATCHDOG_S.

        A wait on the card has no timeout parameter, so the bound comes
        from outside: the call runs on a sacrificial daemon thread and the
        caller waits at most the budget. On expiry the thread is ABANDONED
        and WatchdogTimeout raised — the pipeline fails the bucket over to
        the sync per-job path, which is wrapped too. Disabled (WATCHDOG_S=0)
        this is a plain call with zero overhead.
        """
        timeout = self.config.watchdog_seconds
        if timeout <= 0:
            return fn(*args)
        with self._wd_lock:
            if self._watchdog_abandoned >= self._WATCHDOG_MAX_ABANDONED:
                # a persistently wedged card would otherwise accumulate
                # abandoned threads without bound across cycles; at the cap,
                # new guarded calls fast-fail as watchdog fires
                self._record_watchdog_fire()
                raise WatchdogTimeout(
                    f"{self._watchdog_abandoned} abandoned watchdog "
                    "threads (device wedged); call skipped")
        out: list = []
        err: list = []
        done = threading.Event()
        abandoned = {"flag": False}
        ctx = tracing.tracer.context()

        def run():
            try:
                with tracing.tracer.attach(ctx):
                    out.append(fn(*args))
            except BaseException as e:  # noqa: BLE001 - relayed to caller
                err.append(e)
            finally:
                done.set()
                # flag read UNDER the lock, pairing with the timed-out main
                # thread's locked {is_set check -> flag set}
                with self._wd_lock:
                    if abandoned["flag"]:
                        # the hung call eventually returned: free its slot
                        self._watchdog_abandoned -= 1

        t = threading.Thread(target=run, name="collect-watchdog", daemon=True)
        t.start()
        if not done.wait(timeout):
            with self._wd_lock:
                if not done.is_set():
                    abandoned["flag"] = True
                    self._watchdog_abandoned += 1
            if abandoned["flag"]:
                self._record_watchdog_fire()
                raise WatchdogTimeout(
                    f"device materialization exceeded {timeout:g}s "
                    "(watchdog)")
        if err:
            raise err[0]
        return out[0]

    # abandoned-thread ceiling: past this many never-returned card calls
    # the watchdog stops spawning and fast-fails instead
    _WATCHDOG_MAX_ABANDONED = 8

    def _record_watchdog_fire(self):
        self.watchdog_fires_total += 1
        self.flight.record_event(flightrec.EVENT_WATCHDOG,
                                 abandoned=self._watchdog_abandoned)
        self.exporter.record_counter(
            "foremastbrain:watchdog_fires_total", {},
            help="device materializations timed out by the collect "
                 "watchdog (WATCHDOG_S)")

    @staticmethod
    def _newest_sample_ts(items) -> float:
        """Newest VALID sample timestamp across a job's judged current
        windows — the moment the job's window last ADVANCED, on the data's
        own clock. 0.0 when nothing is judgeable."""
        pairs, bands, bis, multis, hpas = items
        curs = ([it.current for it in pairs]
                + [it.current for it in bands]
                + [w for it in bis for w in it.cur]
                + [w for it in multis for w in it.cur]
                + [it.current for it in hpas])
        newest = 0.0
        for w in curs:
            if w is None or w.n_valid == 0:
                continue
            idx = int(np.flatnonzero(w.mask)[-1])
            newest = max(newest, float(w.start + idx * w.step))
        return newest

    def _observe_latency(self, st: _JobState, now: float):
        """One window-advance -> verdict detection-latency observation for a
        judged job (engine/slo.py), annotated onto its provenance record
        BEFORE the terminal transition attaches the summary to the
        Document.

        Two addends, each in a self-consistent clock domain: the poll wait
        (cycle `now` minus the newest judged sample's own timestamp) and
        the in-cycle tail (monotonic fold time minus the cycle start). Each
        WINDOW ADVANCE is observed once: a cycle that re-judges a job on the
        same newest sample re-confirms an already-detected state. Jobs with
        no judgeable samples (newest_ts == 0) keep the per-cycle
        observation. No-op for jobs that ingested nothing this cycle (shed,
        quarantined, stale-served)."""
        if not st.ingest_at:
            return
        tail0 = self._cycle_mono0 or st.ingest_at
        mono_now = time.monotonic()
        lat = max(mono_now - tail0, 0.0)
        if st.newest_ts > 0:
            if self._slo_seen.get(st.doc.id, 0.0) >= st.newest_ts:
                st.ingest_at = 0.0
                # a re-confirmation consumes nothing: drop any waterfall
                # record opened for it, or its stages would leak into the
                # job's NEXT genuine observation
                self.waterfall.discard(st.doc.id)
                return  # this advance was already observed
            self._slo_seen[st.doc.id] = st.newest_ts
            lat += max(now - st.newest_ts, 0.0)
        st.ingest_at = 0.0  # at most one observation per cycle
        self.slo.observe(slo_mod.classify(st.doc.strategy), lat)
        # waterfall: split the in-cycle tail at the fold boundary and close
        # this job's stage record
        fold0 = self._cycle_fold_mono or mono_now
        wf = self.waterfall.observe(
            st.doc.id, now=now, newest_ts=st.newest_ts,
            score_s=max(fold0 - tail0, 0.0),
            fold_s=max(mono_now - fold0, 0.0))
        ann = {"detection_latency_s": round(lat, 6)}
        if wf["stages"]:
            ann["detection_stages"] = {
                k: round(v, 6) for k, v in wf["stages"].items()}
        if wf["trace_id"]:
            # a pushed job's trace beats the cycle's own
            ann["trace_id"] = wf["trace_id"]
        self.provenance.annotate(st.doc.id, **ann)
        ctx = wf["ctx"]
        if ctx is not None and ctx.sampled:
            # close the push's distributed trace AT the verdict: a
            # remote-parented span carrying the waterfall
            with tracing.tracer.span(
                    tracing.SPAN_ENGINE_VERDICT, _remote=ctx,
                    job_id=st.doc.id, status=st.doc.status,
                    detection_latency_s=round(lat, 4),
                    waterfall={k: round(v, 6)
                               for k, v in wf["stages"].items()}):
                pass

    def reset_slo(self):
        """Clear SLO observations AND the once-per-advance dedupe map
        (resetting the histograms without the map would mute the first
        post-reset observation per job). The waterfall follows."""
        self._slo_seen.clear()
        self.slo.reset()
        self.waterfall.reset()

    def _prov_content(self, job_id: str) -> str | None:
        """Compact provenance JSON for a terminal Document's
        processing_content (None keeps the field untouched when provenance
        is off)."""
        if not self.provenance.enabled:
            return None
        return self.provenance.summary_json(job_id) or None

    def quarantined_count(self, now: float | None = None) -> int:
        """Jobs currently parked in poison quarantine. Snapshot first
        (list() is atomic under the GIL): readers on other threads call
        this while the cycle thread inserts/pops entries."""
        now = time.time() if now is None else now
        return sum(1 for q in list(self._quarantine.values()) if q[1] > now)

    # the batch-rung ladder: chunks pad to the smallest rung that fits, so
    # a launch's shape (and its pinned staging buffers) come from a small
    # fixed set at any fleet size
    _BATCH_BUCKETS = (16, 64, 256, 512, 1024, 4096, 16384, 65536)

    @classmethod
    def _rung_for(cls, n: int, cap: int) -> int:
        """Smallest batch rung >= n from the ladder, capped at `cap`. The
        ONE ladder walk — the family chunker and the triage screen both
        route through it."""
        for b in cls._BATCH_BUCKETS:
            if b >= cap:
                break
            if n <= b:
                return b
        return cap

    def _bucket_rows(self, n: int) -> int:
        """Smallest batch rung >= n, capped at the configured chunk."""
        return self._rung_for(n, max(16, self.config.score_batch))

    # mega padding classes (MEGABATCH): below this the classic rung ladder
    # applies; above it classes are mantissa-quantized so a big fleet pads
    # by at most 1/16
    _MEGA_MANTISSA_FLOOR = 512

    @classmethod
    def _mega_rows(cls, n: int) -> int:
        """Smallest mega padding class >= n: rung-ladder snapped up to
        _MEGA_MANTISSA_FLOOR, then ceil to 5-bit-mantissa granularity
        (m * 2^e with m in [16, 32)) — waste <= 6.25%."""
        n = max(int(n), 1)
        if n <= cls._MEGA_MANTISSA_FLOOR:
            for b in cls._BATCH_BUCKETS:
                if n <= b:
                    return b
        e = max(n.bit_length() - 5, 0)  # keeps the mantissa in [16, 32)
        return -(-n // (1 << e)) << e

    def _mega_cap(self, T: int) -> int:
        """Mega-launch row ceiling for a T bucket: MEGABATCH_MAX_ROWS at
        T <= 1024, scaled ~1/T beyond (floor 1024)."""
        max_rows = max(int(self.config.megabatch_max_rows), 1024)
        budget = max_rows * 1024  # row-steps at the base T
        return int(min(max_rows, max(budget // max(int(T), 1024), 1024)))

    def _launch_chunks(self, family: str, T: int, B: int, specs, pack, launch,
                       outputs) -> list:
        """Row-chunk a family's B rows into batch rungs and launch one
        kernel call per chunk WITHOUT waiting for it.

        For each chunk, `pack(host, lo, hi)` writes rows lo..hi of the
        family's entries straight into pinned staging buffers (rows 0..n-1);
        padded rows repeat the last real row (always valid inputs, trimmed
        at collect). The buffers go to the card without blocking, `launch`
        queues the kernels on the engine's stream, and the device copies of
        the inputs are dropped at once. Partial chunks pad to the smallest
        rung that fits (or, under MEGABATCH, one launch per memory-aware cap
        padded to its fine mega class). Returns [(staging key, outputs,
        n_valid_rows)] in row order; nothing blocks until `_collect_chunks`.
        """
        mega = self.config.megabatch
        C = self._mega_cap(T) if mega else self._bucket_rows(B)
        launches = []
        for lo in range(0, B, C):
            n = min(C, B - lo)
            target = (min(self._mega_rows(n), C) if mega
                      else self._bucket_rows(n))
            key = (family, T, target)
            slot = self.staging.pack(key, specs, target, T)
            pack(slot.host, lo, lo + n)
            if n < target:
                for a in slot.host.values():
                    a[n:target] = a[n - 1]
            self.device_launches += 1
            if mega:
                self.megabatch_launches_total += 1
                self.megabatch_real_rows_total += n
                self.megabatch_pad_rows_total += target - n
            with self.staging.on_stream():
                out = launch(self.staging.to_device(slot))
            launches.append((key, {k: out[k] for k in outputs}, n))
        return launches

    def _collect_chunks(self, launches: list) -> dict:
        """Materialize `_launch_chunks` output: copy every chunk's outputs
        back to pinned host buffers, wait once, trim padded rows and
        concatenate chunks into one (B, ...) dict. A single chunk's arrays
        are views of the pinned buffers, valid until the next collect."""
        st = self.staging
        st.begin_collect()
        with st.on_stream():
            host = [st.fetch(key, outs) for key, outs, _ in launches]
        st.sync()
        outs = [{k: v[:n] for k, v in h.items()} for h, (_, _, n) in zip(host, launches)]
        if len(outs) == 1:
            return outs[0]
        return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}

    # ------------------------------------------------ family launch/collect
    # Each batch family is split into a `_launch_*` half (pack + queued
    # launch; returns an opaque state tuple whose [0] is the claim-ordered
    # entry list) and a `_collect_*` half (materialize + per-item
    # postprocess). The synchronous `_score_*` entry points — the barriered
    # cycle and the per-job retry path of the `_isolate` fallback — are
    # launch + immediate collect over the same code.

    @staticmethod
    def _pair_T(it: _PairItem) -> int:
        return bucket_length(
            max(it.baseline.values.shape[0], it.current.values.shape[0])
        )

    @staticmethod
    def _by_bucket(items, key) -> dict:
        by: dict[int, list] = {}
        for it in items:
            by.setdefault(key(it), []).append(it)
        return by

    def _launch_pairs(self, group: list, T: int):
        cfg = self.config
        combine = fl.COMBINE_ALL if cfg.pairwise_combine_all else fl.COMBINE_ANY
        tests = cfg.enabled_tests()
        min_points = (cfg.min_mann_whitney_points, cfg.min_wilcoxon_points,
                      cfg.min_kruskal_points, cfg.min_friedman_points)

        def pack(h, lo, hi):
            for j, it in enumerate(group[lo:hi]):
                _put_row(h["baseline"], h["b_mask"], j, it.baseline.values, it.baseline.mask)
                _put_row(h["current"], h["c_mask"], j, it.current.values, it.current.mask)
                h["band_threshold"][j] = it.policy.threshold
                h["bound_mode"][j] = it.policy.bound
                h["min_lower_bound"][j] = it.policy.min_lower_bound
            n = hi - lo
            h["pvalue_threshold"][:n] = cfg.pairwise_threshold
            h["test_mask"][:n] = tests
            h["combine"][:n] = combine
            h["ma_window"][:n] = cfg.ma_window
            h["min_points"][:n] = min_points

        def launch(d):
            return fl.score_pairs(*(d[name] for name, _, _ in PAIR_SPECS), device=self.device)

        launches = self._launch_chunks("pair", T, len(group), PAIR_SPECS, pack, launch,
                                       PAIR_OUTPUTS)
        return (group, launches)

    def _collect_pairs(self, state) -> dict:
        group, launches = state
        out = self._collect_chunks(launches)
        results = {}
        # one bulk .tolist() per field instead of boxed numpy scalar reads
        unhealthy = out["unhealthy"].tolist()
        min_p = out["min_p"].tolist()
        pw = out["pairwise_unhealthy"].tolist()
        band = out["band_unhealthy"].tolist()
        band_count = out["band_count"].tolist()
        for i, it in enumerate(group):
            results[(it.job_id, it.metric, "pair")] = {
                "unhealthy": unhealthy[i],
                "min_p": min_p[i],
                "pairwise_unhealthy": pw[i],
                "band_unhealthy": band[i],
                "band_count": band_count[i],
            }
        return results

    def _score_pairs(self, items: list[_PairItem]):
        """Batch all pairwise items (bucketed by window length)."""
        results = {}
        for T, group in self._by_bucket(items, self._pair_T).items():
            results.update(self._collect_pairs(self._launch_pairs(group, T)))
        return results

    @staticmethod
    def _band_T(it: _BandItem) -> int:
        return bucket_length(
            min(
                it.historical.values.shape[0] + it.current.values.shape[0],
                MAX_WINDOW_STEPS,
            )
        )

    def _launch_bands(self, group: list, T: int):
        """Pack history ++ current per row and queue `forecast_band` for the
        configured algorithm: one kernel B launch per chunk under
        moving_average*, the seasonal kernels (with each row's own period
        under holt_winters and seasonal_trend) otherwise. The long-window
        gate and the period fallback are functions of the bucket T, as in
        the reference, so a row's forecaster never depends on its
        chunk-mates."""
        cfg = self.config
        n_hs, lens = [], []

        def pack(h, lo, hi):
            for j, it in enumerate(group[lo:hi]):
                vals, mask, n_h = _concat_trimmed(it.historical, it.current)
                _put_row(h["x"], h["mask"], j, vals, mask)
                h["region"][j] = False
                h["region"][j, n_h:vals.shape[0]] = True
                h["threshold"][j] = it.policy.threshold
                h["bound_mode"][j] = it.policy.bound
                h["min_lower_bound"][j] = it.policy.min_lower_bound
                n_hs.append(n_h)
                lens.append(vals.shape[0])

        def launch(d):
            return fc.forecast_band(
                d["x"], d["mask"], d["region"], d["threshold"], d["bound_mode"],
                d["min_lower_bound"], algorithm=cfg.algorithm, ma_window=cfg.ma_window,
                long_window_steps=cfg.long_window_steps, hw_period=cfg.hw_period,
                hw_period_auto=cfg.hw_period_auto,
                hw_period_candidates=cfg.hw_period_candidates,
                hw_min_seasonal_acf=cfg.hw_min_seasonal_acf,
                hw_alias_margin=cfg.hw_alias_margin,
                hw_contrast_margin=cfg.hw_contrast_margin, st_order=cfg.st_order,
                st_changepoints=cfg.st_changepoints, device=self.device)

        launches = self._launch_chunks("band", T, len(group), BAND_SPECS, pack, launch,
                                       BAND_OUTPUTS)
        return (group, launches, n_hs, lens)

    def _collect_bands(self, state) -> dict:
        group, launches, n_hs, lens = state
        out = self._collect_chunks(launches)
        results = {}
        counts = out["count"].tolist()
        firsts = out["first_index"].tolist()
        uppers = out["upper"]
        lowers = out["lower"]
        flags = out["flags"]
        checked = out["checked"].tolist()
        for i, it in enumerate(group):
            n_h, L = n_hs[i], lens[i]
            anomalous_idx = np.nonzero(flags[i])[0]
            anomaly_pairs = []
            for j in anomalous_idx[:50]:
                # a flagged slot lies in the region: concat index j is the
                # current window's index j - n_h
                anomaly_pairs += [_concat_ts(it.current, n_h, int(j)),
                                  float(it.current.values[int(j) - n_h])]
            first = firsts[i]
            results[(it.job_id, it.metric, "band")] = {
                "count": counts[i],
                "unhealthy": counts[i] >= self._gate(checked[i]),
                "first_ts": (
                    _concat_ts(it.current, n_h, first) if first >= 0 else -1.0
                ),
                "upper": float(np.mean(uppers[i][n_h:L])),
                "lower": float(np.mean(lowers[i][n_h:L])),
                "anomaly_pairs": anomaly_pairs,
            }
        return results

    def _score_bands(self, items: list[_BandItem]):
        results = {}
        for T, group in self._by_bucket(items, self._band_T).items():
            results.update(self._collect_bands(self._launch_bands(group, T)))
        return results

    def _gate(self, checked) -> float:
        """Unhealthy-verdict gate: min anomalous points for a band-style
        scorer to condemn a window (see EngineConfig.band_min_points)."""
        return max(
            self.config.band_min_points,
            self.config.band_violation_fraction * float(checked),
        )

    # ---------------------------------------------------- bivariate family
    @staticmethod
    def _bi_prep(it: _BiItem):
        """((x, m, n_h, n_c) joint grid, T bucket) for one bivariate item."""
        pre = _joint_grid(list(it.hist), list(it.cur))
        return pre, bucket_length(pre[0].shape[1])

    def _launch_bivariate(self, entries: list, T: int):
        """entries: [(item, joint-grid prep)]. Packs each pair's joint grid
        and queues one kernel H launch per chunk."""

        def pack(h, lo, hi):
            for j, (it, (x, m, n_h, _n_c)) in enumerate(entries[lo:hi]):
                _put_row(h["x1"], h["m1"], j, x[0], m[0])
                _put_row(h["x2"], h["m2"], j, x[1], m[1])
                h["region"][j] = False
                h["region"][j, n_h:x.shape[1]] = True
                p1, p2 = it.policies
                # the pair shares one ellipse: the stricter (smaller) radius
                h["threshold"][j] = min(p1.threshold, p2.threshold)
                h["mlb1"][j], h["mlb2"][j] = p1.min_lower_bound, p2.min_lower_bound
                h["bm1"][j], h["bm2"][j] = p1.bound, p2.bound

        def launch(d):
            return bv.bivariate_rows(*(d[name] for name, _, _ in BI_SPECS), device=self.device)

        launches = self._launch_chunks("bivariate", T, len(entries), BI_SPECS, pack, launch,
                                       BI_OUTPUTS)
        return (entries, launches)

    def _collect_bivariate(self, state) -> dict:
        entries, launches = state
        out = self._collect_chunks(launches)
        results = {}
        counts = out["count"].tolist()
        firsts = out["first_index"].tolist()
        checked = out["checked"].tolist()
        flags = out["flags"]
        bands = {k: out[k] for k in ("upper1", "lower1", "upper2", "lower2")}
        for i, (it, (x, m, n_h, n_c)) in enumerate(entries):
            cur0 = it.cur[0]
            first = firsts[i]
            anomaly_pairs = []
            for j in np.nonzero(flags[i])[0][:50]:
                # values from the job's joint grid, not the packed buffer
                anomaly_pairs += [_concat_ts(cur0, n_h, int(j)), float(x[0, int(j)])]

            def region_mean(k):
                # the band is one value per row: its mean over the region,
                # as the reference averages its (B, T) broadcast there
                return float(np.mean(np.full(x.shape[1] - n_h, bands[k][i], np.float32)))

            results[(it.job_id, "&".join(it.metrics), "bivariate")] = {
                "count": counts[i],
                "unhealthy": counts[i] >= self._gate(checked[i]),
                "first_ts": _concat_ts(cur0, n_h, first) if first >= 0 else -1.0,
                "anomaly_pairs": anomaly_pairs,
                "bounds": {
                    it.metrics[0]: (region_mean("upper1"), region_mean("lower1")),
                    it.metrics[1]: (region_mean("upper2"), region_mean("lower2")),
                },
            }
        return results

    def _score_bivariate(self, items: list[_BiItem]):
        """Joint 2-metric scoring: one kernel H launch per bucket rung."""
        results = {}
        by_bucket: dict[int, list] = {}
        for it in items:
            pre, T = self._bi_prep(it)
            by_bucket.setdefault(T, []).append((it, pre))
        for T, entries in by_bucket.items():
            results.update(self._collect_bivariate(self._launch_bivariate(entries, T)))
        return results

    # ------------------------------------------------------ lstm family
    def _score_multi(self, items: list[_MultiItem]):
        """LSTM-autoencoder scoring for 3+-metric jobs (faq.md:8-10).

        Per job: standardize each metric on its history, train the AE on
        non-overlapping historical subwindows (cached per app, LRU-bounded by
        MAX_CACHE_SIZE), then z-score the current window's reconstruction
        error against the healthy-error distribution."""
        cfg = self.config
        results = {}
        memo_on = cfg.score_memo
        memo_zs: list = []   # (item, z) reused without a launch
        zfp_by_job: dict = {}  # (job_id, metrics) -> score-input fp
        # (item, params, err_mu, err_sd, version, cwin, cmask)
        scoreable: list = []
        # (item, cache_key, hwin, hmask, cwin, cmask, train_fp): budgeted
        # misses
        pending: list = []
        pending_keys: set = set()
        # same-cycle duplicates of a pending cache_key ride the leader's
        # training (one budget slot, one model) and resolve from the cache
        followers: list = []
        budget = cfg.lstm_max_train_per_cycle
        for it in items:
            x, m, n_h, n_c = _joint_grid(it.hist, it.cur)
            F, T = x.shape
            W = min(cfg.lstm_window, max(n_h // 2, 1))
            if W < 4 or n_h < 2 * W:
                # not enough history to learn from: the job stays unjudged
                continue
            hist_m = m[:, :n_h]
            hw = hist_m.astype(np.float64)
            n = np.maximum(hw.sum(axis=1), 1.0)
            # float64 reductions: any float32-finite history squares and
            # sums without overflow
            xh = x[:, :n_h].astype(np.float64)
            mu = (xh * hw).sum(axis=1) / n
            sd = np.sqrt((((xh - mu[:, None]) * hw) ** 2).sum(axis=1) / n)
            sd = np.maximum(sd, 1e-6)
            xs = ((x - mu[:, None]) / sd[:, None]).T.astype(np.float32)  # (T, F)
            ms = m.T  # (T, F)

            k = n_h // W
            h0 = n_h - k * W
            hwin = xs[h0:n_h].reshape(k, W, F)
            hmask = ms[h0:n_h].reshape(k, W, F)
            # score windows tile the WHOLE current region; a final tail
            # window may dip into history, its history steps masked out so
            # they add no error and cannot dilute the z-score
            starts = list(range(n_h, T - W + 1, W))
            if not starts or starts[-1] + W < T:
                starts.append(max(T - W, 0))
            cwin = np.stack([xs[s:s + W] for s in starts])
            cmask = np.stack([ms[s:s + W] for s in starts])
            for k_i, s in enumerate(starts):
                if s < n_h:
                    cmask[k_i, :n_h - s] = False

            cache_key = (it.cache_key, tuple(it.metrics), W)
            entry = self._lstm_cache.pop(cache_key, None)
            train_fp = _fp(b"lstm-train", hwin, hmask, cfg.lstm_epochs,
                           cfg.lstm_hidden, cfg.lstm_latent) if memo_on else None
            if entry is None and memo_on:
                # training is deterministic (the reference's initial
                # parameters, fixed epochs, no float atomics in kernels L
                # and M), so identical train windows give identical params
                entry = self._lstm_train_memo.get(train_fp)
                if entry is not None:
                    self._lstm_train_memo.move_to_end(train_fp)
            if entry is None:
                if cache_key in pending_keys:
                    followers.append((it, cache_key, cwin, cmask))
                    continue
                if budget > 0 and self._lstm_trained_this_cycle >= budget:
                    # the cycle's train budget is spent: the job stays in
                    # progress and warms up on a later cycle
                    self._lstm_budget_skipped_ids.add(it.job_id)
                    continue
                self._lstm_trained_this_cycle += 1
                pending.append((it, cache_key, hwin, hmask, cwin, cmask, train_fp))
                pending_keys.add(cache_key)
                continue
            self._lstm_cache[cache_key] = entry  # re-insert = mark recent
            while len(self._lstm_cache) > cfg.max_cache_size:
                self._lstm_cache.pop(next(iter(self._lstm_cache)))
            params, err_mu, err_sd, version = entry
            if memo_on:
                # unchanged score windows against unchanged params (the
                # version pins them) reuse the previous z without a launch
                jkey = (it.job_id, tuple(it.metrics))
                zfp = _fp(b"lstm-z", cwin, cmask, err_mu, err_sd, version)
                prev = self._lstm_z_memo.get(jkey)
                if prev is not None and prev[0] == zfp:
                    self._lstm_z_memo.move_to_end(jkey)
                    self.lstm_rescore_skips += 1
                    self._lstm_memo_jobs.add(it.job_id)
                    memo_zs.append((it, prev[1]))
                    continue
                zfp_by_job[jkey] = zfp
            scoreable.append((it, params, err_mu, err_sd, version, cwin, cmask))

        scoreable.extend(self._train_pending(pending))
        for it, cache_key, cwin, cmask in followers:
            entry = self._lstm_cache.get(cache_key)
            if entry is None:
                continue  # the leader's training failed: the follower waits too
            params, err_mu, err_sd, version = entry
            scoreable.append((it, params, err_mu, err_sd, version, cwin, cmask))
        if memo_on:
            for it, _p, mu_, sd_, version, cwin, cmask in scoreable:
                jkey = (it.job_id, tuple(it.metrics))
                zfp_by_job.setdefault(jkey, _fp(b"lstm-z", cwin, cmask, mu_, sd_, version))
        for it, z in [*memo_zs, *self._score_multi_fleet(scoreable)]:
            results[(it.job_id, "+".join(it.metrics), "lstm")] = {
                "unhealthy": z > cfg.lstm_threshold,
                "z": z,
            }
            if memo_on:
                jkey = (it.job_id, tuple(it.metrics))
                zfp = zfp_by_job.get(jkey)
                if zfp is not None:
                    self._memo_put(self._lstm_z_memo, jkey, (zfp, z))
        return results

    def _cache_trained(self, cache_key, params, mu_: float, sd_: float, train_fp):
        """Put a trained model in the LRU (and the train memo); returns its
        entry."""
        cfg = self.config
        self._lstm_param_version += 1
        entry = (params, mu_, sd_, self._lstm_param_version)
        self._lstm_cache[cache_key] = entry
        while len(self._lstm_cache) > cfg.max_cache_size:
            self._lstm_cache.pop(next(iter(self._lstm_cache)))
        if train_fp is not None:
            # params are shared with the LRU cache, so this index adds no
            # parameter memory; bounded like the cache
            self._lstm_train_memo[train_fp] = entry
            self._lstm_train_memo.move_to_end(train_fp)
            while len(self._lstm_train_memo) > cfg.max_cache_size:
                self._lstm_train_memo.popitem(last=False)
        return entry

    def _train_pending(self, pending):
        """Train this cycle's budgeted cache misses, jobs of one (K, W, F)
        shape as one fleet (lstm_ae.train_fleet: kernels L and M every
        epoch, the plateau on the group's mean loss, the normalizer by
        kernel K). A group that fails retries job by job, so the healthy
        majority still trains; a job that fails alone is skipped (its budget
        slot is spent, it retries on a later cycle). Yields scoreable
        tuples."""
        cfg = self.config
        groups: dict[tuple, list] = {}
        for rec in pending:
            groups.setdefault(rec[2].shape, []).append(rec)

        def train(recs):
            self.device_launches += 1
            params, mus, sds = lstm_ae.train_fleet(
                np.stack([r[2] for r in recs]), np.stack([r[3] for r in recs]),
                hidden=cfg.lstm_hidden, latent=cfg.lstm_latent, epochs=cfg.lstm_epochs,
                device=self.device)
            return [(params[j], mu_, sd_)
                    for j, (mu_, sd_) in enumerate(zip(mus.tolist(), sds.tolist()))]

        def train_alone(rec):
            try:
                return train([rec])[0]
            except Exception:  # noqa: BLE001 - this job alone waits
                return None

        for (_k, W, F), recs in groups.items():
            with tracing.span(tracing.SPAN_ENGINE_LSTM_TRAIN, jobs=len(recs), features=F,
                              window=W):
                try:
                    trained = train(recs)
                except Exception:  # noqa: BLE001 - blast radius per job
                    trained = [None] if len(recs) == 1 else [train_alone(r) for r in recs]
            for rec, result in zip(recs, trained):
                if result is None:
                    continue
                it, cache_key, _hw, _hm, cwin, cmask, train_fp = rec
                entry = self._cache_trained(cache_key, *result, train_fp)
                yield (it, entry[0], entry[1], entry[2], entry[3], cwin, cmask)

    # fleet scoring engages from this group size; smaller groups score job
    # by job, as the reference counts its launches
    _LSTM_FLEET_MIN = 4

    def _score_multi_fleet(self, scoreable):
        """Score the collected multi-metric jobs: jobs whose score windows
        share an (F, W, K) shape run as one kernel K launch per chunk of
        SCORE_BATCH jobs over their stacked parameter rows (kept while the
        members and versions hold); z is the max over a job's windows.
        Returns [(item, z)]."""
        cfg = self.config
        H, Z = cfg.lstm_hidden, cfg.lstm_latent
        groups: dict[tuple, list] = {}
        for rec in scoreable:
            cwin = rec[5]
            groups.setdefault((cwin.shape[2], cwin.shape[1], cwin.shape[0]), []).append(rec)
        chunk_cap = self._bucket_rows(cfg.score_batch)
        out = []
        for (F, W, K), recs in groups.items():
            single = len(recs) < self._LSTM_FLEET_MIN
            chunks = ([[r] for r in recs] if single
                      else [recs[lo:lo + chunk_cap] for lo in range(0, len(recs), chunk_cap)])
            for chunk in chunks:
                stack_key = (F, W, K, tuple(r[4] for r in chunk))
                pstack = self._lstm_stack_cache.pop(stack_key, None)
                if pstack is None:
                    pstack = torch.stack([r[1] for r in chunk]).to(self.device).contiguous()
                self._lstm_stack_cache[stack_key] = pstack  # mark recent
                while len(self._lstm_stack_cache) > 32:
                    self._lstm_stack_cache.pop(next(iter(self._lstm_stack_cache)))
                self.device_launches += 1
                zs = lstm_ae.anomaly_scores_fleet(
                    pstack, np.stack([r[5] for r in chunk]), np.stack([r[6] for r in chunk]),
                    np.asarray([r[2] for r in chunk], np.float32),
                    np.asarray([r[3] for r in chunk], np.float32), hidden=H, latent=Z,
                    device=self.device)
                for (it, *_), z in zip(chunk, zs.max(dim=1).values.tolist()):
                    out.append((it, float(z)))
        return out

    # ------------------------------------------- LSTM model-cache persistence
    _LSTM_CACHE_FORMAT = "foremast_tpu_torch.lstm_cache/1"

    def save_lstm_cache(self, path: str, max_entries: int | None = None) -> int:
        """Persist the trained LSTM models (parameter rows and normalizers)
        so a restarted engine warm-starts instead of training every known
        app again. One numpy .npz (the flat rows as one float32 (N, P)
        array, the keys as JSON, the architecture beside them), written to
        a temporary file of its own in `path`'s directory, synced to the
        disk and renamed over `path`. max_entries keeps the most
        recent entries (LRU order); None keeps the whole cache. Returns the
        number of entries written. The reference's flax msgpack files are
        another format: this engine loads none of them."""
        items = list(self._lstm_cache.items())
        if max_entries is not None and len(items) > max_entries:
            items = items[-max_entries:]
        cfg = self.config
        rows = [e[0].detach().to("cpu", torch.float32).reshape(-1).numpy() for _, e in items]
        sizes = {r.shape[0] for r in rows}
        payload = {
            "format": np.array(self._LSTM_CACHE_FORMAT),
            # architecture fingerprint: rows of another geometry must never
            # reach this engine's kernels
            "arch": np.array(json.dumps({"hidden": cfg.lstm_hidden, "latent": cfg.lstm_latent,
                                         "lstm_window": cfg.lstm_window})),
            "keys": np.array(json.dumps([[k[0], list(k[1]), int(k[2])] for k, _ in items])),
            "mu": np.asarray([e[1] for _, e in items], np.float64),
            "sd": np.asarray([e[2] for _, e in items], np.float64),
        }
        # one array a row length (the feature count sets P)
        for n in sorted(sizes):
            payload[f"params_{n}"] = np.stack([r for r in rows if r.shape[0] == n])
        # a temporary file of this writer's own beside `path`, flushed to the
        # disk before the rename: two engines saving to one path at once
        # each rename a whole file into place, never the other's half
        fd, tmp = tempfile.mkstemp(prefix=os.path.basename(path) + ".",
                                   suffix=".tmp", dir=os.path.dirname(path) or ".")
        try:
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **payload)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        return len(items)

    def load_lstm_cache(self, path: str) -> int:
        """Load a save_lstm_cache file into the warm cache. An absent,
        corrupt or architecture-mismatched file (the reference's msgpack
        files among them) loads 0 entries and never raises. Returns the
        entries loaded."""
        cfg = self.config
        try:
            with np.load(path, allow_pickle=False) as d:
                if str(d["format"]) != self._LSTM_CACHE_FORMAT:
                    return 0
                arch = json.loads(str(d["arch"]))
                if (int(arch.get("hidden", -1)) != cfg.lstm_hidden
                        or int(arch.get("latent", -1)) != cfg.lstm_latent
                        or int(arch.get("lstm_window", -1)) != cfg.lstm_window):
                    return 0
                keys = json.loads(str(d["keys"]))
                mu, sd = d["mu"], d["sd"]
                stacks = {int(k.split("_")[1]): d[k] for k in d.files
                          if k.startswith("params_")}
            at = {n: 0 for n in stacks}
            loaded = []
            for idx, k in enumerate(keys):
                metrics = tuple(str(m) for m in k[1])
                n = lstm_ae.param_count(len(metrics), cfg.lstm_hidden, cfg.lstm_latent)
                row = stacks[n][at[n]]
                at[n] += 1
                loaded.append(((str(k[0]), metrics, int(k[2])),
                               torch.from_numpy(np.array(row, np.float32)).to(self.device),
                               float(mu[idx]), float(sd[idx])))
        except Exception:  # noqa: BLE001 - a bad cache file means a cold start
            return 0
        for key, row, mu_, sd_ in loaded:
            self._lstm_param_version += 1
            self._lstm_cache[key] = (row, mu_, sd_, self._lstm_param_version)
        while len(self._lstm_cache) > cfg.max_cache_size:
            self._lstm_cache.pop(next(iter(self._lstm_cache)))
        return len(loaded)

    # ---------------------------------------------------------- hpa family
    @staticmethod
    def _hpa_rows(items: list[_HpaItem]) -> list:
        """[(job_id, tps_item, sla_item)]: the primary (lowest priority)
        metric drives the traffic model; an SLA metric (is_increase and
        priority > 0) the reward, else any secondary, else the primary."""
        by_job: dict[str, list[_HpaItem]] = {}
        for it in items:
            by_job.setdefault(it.job_id, []).append(it)
        rows = []
        for job_id, group in by_job.items():
            group.sort(key=lambda it: it.priority)
            tps_it = group[0]
            sla_candidates = [it for it in group[1:] if it.is_increase]
            if sla_candidates:
                sla_it = sla_candidates[0]
            else:
                sla_it = group[1] if len(group) > 1 else group[0]
            rows.append((job_id, tps_it, sla_it))
        return rows

    @staticmethod
    def _hpa_row_T(row) -> int:
        """Pack-length bucket of one HPA row: the larger of its own tps and
        sla concat lengths."""
        return max(
            bucket_length(min(it.historical.values.shape[0] + it.current.values.shape[0],
                              MAX_WINDOW_STEPS))
            for it in (row[1], row[2])
        )

    def _score_hpa(self, items: list[_HpaItem]):
        out = {}
        by_bucket: dict[int, list] = {}
        for row in self._hpa_rows(items):
            by_bucket.setdefault(self._hpa_row_T(row), []).append(row)
        for T, bucket_rows in by_bucket.items():
            out.update(self._collect_hpa(self._launch_hpa(bucket_rows, T)))
        return out

    def _launch_hpa(self, rows, T: int):
        """Pack one bucket of HPA rows and queue, per chunk, kernel C's SES
        of the traffic over its history (alpha 0.3) and kernel I's score
        from those predictions, with no torch op between them."""
        cfg = self.config
        # per-job SLA criteria: the mode from ML_SLA_MODE, the limit from the
        # SLA metric's policy (sla_limit{N}), else ML_SLA_LIMIT; a static or
        # min mode with no limit configured degrades to dynamic
        mode_cfg = {"static": hpa_ops.SLA_STATIC, "min": hpa_ops.SLA_MIN}.get(
            cfg.sla_mode, hpa_ops.SLA_DYNAMIC)
        n = len(rows)
        limits, modes = [0.0] * n, [0] * n
        absolutes, pods = [True] * n, [(1.0, 1.0)] * n
        had_pods = [False] * n
        for i, (_job_id, tps_it, sla_it) in enumerate(rows):
            lim = cfg.policy_for(sla_it.metric).sla_limit
            if lim <= 0.0:
                lim = cfg.sla_limit
            if lim <= 0.0:
                limits[i], modes[i] = 1e9, hpa_ops.SLA_DYNAMIC
            else:
                limits[i], modes[i] = lim, mode_cfg
            # absolute unless the fleet opts into relative limits; a wire
            # isAbsolute=true pins the metric absolute either way
            absolutes[i] = sla_it.is_absolute or not cfg.sla_limit_relative
            # pod counts split at the job's own current-window start
            pc = _pod_count_stats(tps_it.pod_window, tps_it.current.start)
            if pc is not None:
                pods[i] = pc
                had_pods[i] = True

        def pack(h, lo, hi):
            for j, (_job_id, tps_it, sla_it) in enumerate(rows[lo:hi]):
                tv, tm, n_h = _concat_trimmed(tps_it.historical, tps_it.current)
                sv, sm, _ = _concat_trimmed(sla_it.historical, sla_it.current)
                _put_row(h["tps"], h["tps_mask"], j, tv, tm)
                _put_row(h["sla"], h["sla_mask"], j, sv, sm)
                # one region for both series: the traffic's current window
                h["region"][j] = False
                h["region"][j, n_h:tv.shape[0]] = True
                np.logical_and(h["tps_mask"][j], ~h["region"][j], out=h["hist"][j])
                i = lo + j
                h["sla_static_limit"][j] = limits[i]
                h["sla_mode"][j] = modes[i]
                h["sla_absolute"][j] = absolutes[i]
                h["pods_now"][j], h["pods_hist"][j] = pods[i]
            m = hi - lo
            h["alpha"][:m] = 0.3
            h["threshold"][:m] = cfg.threshold
            h["safe"][:m] = cfg.sla_headroom_safe

        def launch(d):
            preds = fc._smooth(fc.ALGO_SES, d["tps"], d["hist"], d["alpha"])
            return hpa_ops.hpa_from_preds(
                d["tps"], d["tps_mask"], d["region"], preds, d["sla"], d["sla_mask"],
                d["sla_static_limit"], d["sla_mode"], d["threshold"], d["safe"],
                d["pods_now"], d["pods_hist"], d["sla_absolute"], device=self.device)

        launches = self._launch_chunks("hpa", T, n, HPA_SPECS, pack, launch, HPA_OUTPUTS)
        return (rows, launches, had_pods)

    def _collect_hpa(self, state) -> dict:
        rows, launches, had_pods = state
        res = self._collect_chunks(launches)
        lists = {k: res[k].tolist() for k in HPA_OUTPUTS}
        out: dict = {}
        for i, (job_id, tps_it, sla_it) in enumerate(rows):
            out[job_id] = {
                "raw_score": float(lists["score"][i]),
                "reason_code": int(lists["reason"][i]),
                "tps_metric": tps_it.metric,
                "sla_metric": sla_it.metric,
                "current_tps": float(lists["current_tps"][i]),
                "upper": float(lists["tps_upper"][i]),
                "lower": float(lists["tps_lower"][i]),
                "sla_current": float(lists["sla_current"][i]),
                "sla_limit": float(lists["sla_limit"][i]),
                "pods_now": float(lists["pods_now"][i]),
                "demand_per_pod": float(lists["demand_per_pod"][i]),
                "has_pod_data": had_pods[i],
            }
        return out

    def _finish_hpa(self, st: _JobState, res, worker: str, now: float,
                    path_info: tuple | None = None) -> str:
        """One hpa job's cycle end: the breath-gated score as an hpalog and
        the hpa_score series, then requeue (hpa jobs never terminate)."""
        doc = st.doc
        if res is None:
            # no scoreable hpa window this cycle
            self.provenance.record(
                doc.id, prov.PATH_NO_DATA, status=J.INITIAL,
                detail="no scoreable hpa window", fetch=st.fetch)
            self.store.requeue(doc.id, worker=worker)
            return J.INITIAL
        self._stale_state[doc.id] = now  # scored on fresh data this cycle
        gated = self.breath.apply(doc.id, res["raw_score"], now=now)
        reason = (
            f"hpa score {gated:.1f} (raw {res['raw_score']:.1f}) via "
            f"{HPA_REASONS.get(res['reason_code'], '?')} on {res['tps_metric']}"
        )
        if self.provenance.enabled:
            path, detail = path_info if path_info is not None \
                else (prov.PATH_SCORED, "")
            self.provenance.record(
                doc.id, path, status=J.INITIAL, detail=detail,
                reason=reason, fetch=st.fetch,
                families=[{
                    "family": "hpa", "metric": res["tps_metric"],
                    "raw_score": round(float(res["raw_score"]), 2),
                    "gated_score": round(float(gated), 2),
                    "sla_metric": res["sla_metric"],
                    "sla_current": round(float(res["sla_current"]), 4),
                    "sla_limit": round(float(res["sla_limit"]), 4),
                }])
        if res.get("has_pod_data"):
            # per-pod context rides the free-form reason; details stay
            # {current, upper, lower} band entries
            reason += (
                f" [per-pod: {res['pods_now']:.1f} pods, "
                f"demand/pod {res['demand_per_pod']:.1f}]"
            )
        self.store.add_hpalog(
            J.HpaLog(
                job_id=doc.id,
                hpascore=gated,
                reason=reason,
                details=[
                    {"metricType": res["tps_metric"], "current": res["current_tps"],
                     "upper": res["upper"], "lower": res["lower"]},
                    {"metricType": res["sla_metric"], "current": res["sla_current"],
                     "upper": res["sla_limit"], "lower": 0.0},
                ],
                timestamp=now,
            )
        )
        self.exporter.record_hpa_score(doc.app_name, doc.namespace, gated)
        self.store.requeue(doc.id, worker=worker)
        return J.INITIAL

    # ------------------------------------------------------------- verdict
    def _serve_stale(self, doc: J.Document, failure: str, worker: str,
                     now: float, in_postprocess: bool = False) -> str | None:
        """Re-serve a warm job's last fresh verdict during a source outage.

        A job is warm when it was judged healthy on FRESH data at most
        MAX_STALE_S ago. Serving means: mid-window, requeue with the
        staleness age stamped in the reason (no PREPROCESS_FAILED flap);
        past endTime, complete COMPLETED_HEALTH on the last fresh verdict
        instead of flipping COMPLETED_UNKNOWN. Unhealthy verdicts are never
        stale-served — they complete terminally the cycle they are seen, so
        a live job's last verdict is always "healthy so far". Returns the
        applied status, or None when the job is not warm (callers fall
        through to the behavior without stale serving).
        """
        max_stale = self.config.max_stale_seconds
        at = self._stale_state.get(doc.id)
        if max_stale <= 0 or at is None or now - at > max_stale:
            return None
        age = now - at
        self.stale_verdicts_served_total += 1
        self.exporter.record_counter(
            "foremastbrain:stale_verdicts_served_total", {},
            help="verdicts re-served from warm state during source "
                 "outages (bounded by MAX_STALE_S)")
        reason = (f"stale verdict served (age {age:.0f}s, last judged "
                  f"healthy): {failure}")
        self.flight.record_event(flightrec.EVENT_STALE_SERVE,
                                 job_id=doc.id, age=round(age, 1))
        try:
            end_time = from_rfc3339(doc.end_time)
        except (ValueError, TypeError):
            end_time = (float("inf")
                        if doc.strategy in CONTINUOUS_STRATEGIES else now)
        if doc.strategy not in CONTINUOUS_STRATEGIES and now >= end_time:
            # the watch window closed during the outage: the job watched
            # healthy right up to the blackout, and the last fresh verdict
            # is younger than MAX_STALE_S — complete on it
            if not in_postprocess:
                self.store.advance(doc.id, J.PREPROCESS_COMPLETED,
                                   J.POSTPROCESS_INPROGRESS, worker=worker)
            self._stale_state.pop(doc.id, None)
            self.provenance.record(
                doc.id, prov.PATH_STALE_SERVED, status=J.COMPLETED_HEALTH,
                detail=f"age {age:.0f}s", reason=reason)
            self.store.transition(doc.id, J.COMPLETED_HEALTH, reason=reason,
                                  worker=worker,
                                  processing_content=self._prov_content(doc.id))
            return J.COMPLETED_HEALTH
        self.provenance.record(
            doc.id, prov.PATH_STALE_SERVED, status=J.INITIAL,
            detail=f"age {age:.0f}s", reason=reason)
        self.store.transition(doc.id, J.INITIAL, reason=reason, worker=worker)
        return J.INITIAL

    def _record_scoring_failure(self, job_id: str, now: float):
        """Quarantine bookkeeping for one per-job retry failure.

        QUARANTINE_AFTER consecutive failures park the job; each parking
        doubles the re-admission backoff (QUARANTINE_BASE_S..MAX). A job
        that was quarantined before re-parks on its FIRST post-probe
        failure — the probe answered the only open question."""
        qa = self.config.quarantine_after
        if qa <= 0:
            return
        q = self._quarantine.setdefault(job_id, [0, 0.0, 0])
        q[0] += 1
        if q[2] > 0 or q[0] >= qa:
            q[2] += 1
            q[0] = 0
            delay = min(QUARANTINE_BASE_S * (2.0 ** (q[2] - 1)),
                        QUARANTINE_MAX_S)
            q[1] = now + delay
            self.jobs_quarantined_total += 1
            self.flight.record_event(flightrec.EVENT_QUARANTINE,
                                     job_id=job_id, delay_s=delay,
                                     times=q[2])
            self.exporter.record_counter(
                "foremastbrain:jobs_quarantined_total", {},
                help="poison-job quarantine parkings (QUARANTINE_AFTER "
                     "consecutive scoring failures)")

    def _load_library(self):
        """On the card, load the kernel library (building it on a fresh
        machine) once, before any cycle budget is armed: a first cycle that
        paid the build inside CYCLE_DEADLINE_S would shed a whole cold
        cycle. A failed build raises out of run_cycle."""
        if not self._library_pending:
            return
        t0 = time.perf_counter()
        kernel_build.library()
        self.library_load_seconds = time.perf_counter() - t0
        self._library_pending = False

    def run_cycle(self, worker: str = "worker-0", now: float | None = None,
                  job_ids=None, partial: bool = False) -> dict:
        """One engine cycle. Returns {job_id: new_status} for observability.

        ``job_ids``/``partial`` are the event-driven scheduler's seam
        (engine/scheduler.py StreamScheduler): a PARTIAL cycle claims only
        the named jobs and runs them through the identical pipeline rungs,
        so a partial cycle's verdicts are exactly the ones the next full
        sweep would have produced, just earlier. Partial and full cycles
        share this entry point and must never run concurrently (the
        scheduler serializes them on one thread)."""
        self._load_library()
        # cycle correlation id, bound into the tracer BEFORE the cycle span
        # opens; partial cycles mint `-p` ids
        self._cycle_seq += 1
        cycle_id = f"{worker}-{'p' if partial else 'c'}{self._cycle_seq}"
        self.current_cycle_id = cycle_id
        t_cycle0 = time.perf_counter()
        self._cycle_mono0 = time.monotonic()
        self._cycle_fold_mono = 0.0
        # a partial cycle triggered by ONE push adopts that push's W3C
        # context: its engine.cycle span continues the push's trace
        remote_ctx = (self.waterfall.single_context(job_ids)
                      if partial and job_ids else None)
        with tracing.tracer.bind(cycle_id=cycle_id), \
                tracing.tracer.adopt_remote(remote_ctx), \
                tracing.span(tracing.SPAN_ENGINE_CYCLE, worker=worker):
            now = time.time() if now is None else now
            self.provenance.begin_cycle(cycle_id, worker=worker)
            # degraded mode: the whole-cycle deadline budget
            # (CYCLE_DEADLINE_S). Burns down through fetch -> preprocess ->
            # dispatch; once expired, un-preprocessed monitor jobs are shed
            # and carried to the next cycle.
            cd = self.config.cycle_deadline_seconds
            cycle_dl = Deadline.after(cd) if cd > 0 else None
            # arm a per-cycle fetch deadline so retry/backoff trains inside
            # a resilient source can never overrun the cycle budget (plain
            # sources have no set_cycle_deadline and skip this)
            sd = getattr(self.source, "set_cycle_deadline", None)
            budget = self.config.fetch_cycle_deadline_seconds
            fetch_dl = Deadline.after(budget) if budget > 0 else None
            if cycle_dl is not None:
                # the fetch retry train must never outlive the CYCLE budget
                fetch_dl = (cycle_dl if fetch_dl is None
                            else Deadline(min(fetch_dl.at, cycle_dl.at)))
            if sd is not None:
                sd(fetch_dl)
            self.health.begin_cycle()
            try:
                outcomes = self._run_cycle(worker, now, cycle_dl,
                                           job_ids=job_ids, partial=partial)
            finally:
                if sd is not None:
                    sd(None)
            # end_cycle only on SUCCESS: a raising cycle must not refresh
            # the liveness reference, so a crash-looping engine ages into
            # STALLED. The deltas come from the stats _run_cycle published.
            stats = self.last_cycle_stages
            self.health.end_cycle(
                shed=stats.get("jobs_shed", 0),
                stale_served=stats.get("stale_verdicts_served", 0),
                watchdog_fires=stats.get("watchdog_fires", 0),
                quarantined=self.quarantined_count(now),
                deadline_overrun=(cycle_dl is not None
                                  and cycle_dl.expired()),
            )
            self.exporter.record_histogram(
                "foremastbrain:cycle_seconds", {},
                time.perf_counter() - t_cycle0,
                help="End-to-end engine cycle duration (seconds).")
            return outcomes

    def _job_priority(self, doc: J.Document) -> tuple:
        """Load-shedding sort key: lower scores FIRST.

        New-deployment analyses (rollingUpdate/canary/rollover) lead and
        are exempt from shedding (_stream_prep's class gate); steady-state
        monitors (continuous/hpa) can carry a cycle. Within the monitor
        class, a job shed on recent cycles sorts ahead, so a permanently
        blown budget round-robins the fleet instead of starving the tail.
        """
        return (1 if doc.strategy in CONTINUOUS_STRATEGIES else 0,
                -self._shed_streak.get(doc.id, 0))

    def _stream_prep(self, claimed: list, now: float,
                     deadline: Deadline | None = None):
        """Yield (doc_id, items, failed, fetch_notes) per job, in claim
        order, as the fetch pool completes chunks. `fetch_notes` is the
        tracer's per-job fetch accounting for the provenance record; shed
        jobs yield `(doc.id, None, _SHED, {})`.

        Per-job fetches overlap on a bounded pool (fetch is network-bound in
        production, and the native parser releases the GIL during its scan).
        Jobs are mapped in CHUNKS in claim order and ex.map preserves
        submission order, so the yielded stream — and with it bucket packing
        and verdict folding — stays deterministic; consuming it
        incrementally is what lets the pipeline launch bucket N while
        bucket N+1 is still fetching.

        `deadline` is the cycle budget (CYCLE_DEADLINE_S): once expired,
        STEADY-STATE jobs (continuous/hpa) not yet fetched yield the _SHED
        marker WITHOUT touching the network. New-deployment analyses are
        never shed (a class gate is the only one that holds under the
        pool's interleaving). The first MONITOR-class job of the cycle is
        exempt too — the guaranteed-progress floor; the sort puts the
        longest-shed monitor there, so the floor round-robins the fleet.
        """
        guaranteed = next(
            (d.id for d in claimed if d.strategy in CONTINUOUS_STRATEGIES),
            None)
        ctx = tracing.tracer.context()

        def prep_many(chunk):
            out = []
            with tracing.tracer.attach(ctx):
                for doc in chunk:
                    if (deadline is not None and doc.id != guaranteed
                            and doc.strategy in CONTINUOUS_STRATEGIES
                            and deadline.expired()):
                        out.append((doc.id, None, _SHED, {}))
                        continue
                    with tracing.tracer.bind(job_id=doc.id):
                        tracing.tracer.begin_notes()
                        try:
                            items = self._preprocess(doc, now)
                            out.append((doc.id, items, "",
                                        tracing.tracer.take_notes()))
                        except FetchError as e:
                            out.append((doc.id, None, str(e),
                                        tracing.tracer.take_notes()))
            return out

        workers = min(max(self.config.fetch_concurrency, 1), len(claimed) or 1)
        if workers <= 1:
            yield from prep_many(claimed)
            return
        step = max(1, -(-len(claimed) // (workers * 8)))
        chunks = [claimed[i:i + step]
                  for i in range(0, len(claimed), step)]
        with ThreadPoolExecutor(max_workers=workers) as ex:
            for rs in ex.map(prep_many, chunks):
                yield from rs

    def _run_cycle(self, worker: str, now: float,
                   cycle_dl: Deadline | None = None, job_ids=None,
                   partial: bool = False) -> dict:
        from .pipeline import CyclePipeline

        with tracing.span(tracing.SPAN_ENGINE_CLAIM):
            claimed = self.store.claim_open_jobs(
                worker,
                limit=self.config.max_claim_per_cycle,
                max_stuck_seconds=self.config.max_stuck_seconds,
                only_ids=set(job_ids) if job_ids is not None else None,
            )
        outcomes: dict[str, str] = {}
        if self._quarantine:
            # poison-job quarantine gate: parked jobs requeue untouched —
            # not one fetch, not one per-job retry — until their
            # re-admission time; everyone else proceeds normally
            admitted = []
            for doc in claimed:
                q = self._quarantine.get(doc.id)
                if q is not None and now < q[1]:
                    self.provenance.record(
                        doc.id, prov.PATH_QUARANTINED, status=J.INITIAL,
                        detail=(f"re-admission in {q[1] - now:.0f}s, "
                                f"parked {q[2]}x"))
                    self.store.transition(
                        doc.id, J.INITIAL, worker=worker,
                        reason=(f"quarantined: scoring poisoned; "
                                f"re-admission in {q[1] - now:.0f}s"))
                    outcomes[doc.id] = J.INITIAL
                else:
                    admitted.append(doc)
            claimed = admitted
        # priority order (stable, so claim order breaks ties): deployment
        # canaries score first; steady-state monitors shed first when the
        # cycle deadline burns down
        if cycle_dl is not None:
            claimed.sort(key=self._job_priority)
        states: dict[str, _JobState] = {}
        all_pairs: list[_PairItem] = []
        all_bands: list[_BandItem] = []
        all_bis: list[_BiItem] = []
        all_multis: list[_MultiItem] = []
        all_hpas: list[_HpaItem] = []
        self._lstm_trained_this_cycle = 0
        self._lstm_budget_skipped_ids = set()
        self._lstm_memo_jobs = set()
        launches0 = self.device_launches
        rescore_skips0 = self.lstm_rescore_skips
        mega_l0 = self.megabatch_launches_total
        mega_r0 = self.megabatch_real_rows_total
        mega_p0 = self.megabatch_pad_rows_total
        shed_cycle0 = self.jobs_shed_total
        stale_cycle0 = self.stale_verdicts_served_total
        wd_cycle0 = self.watchdog_fires_total
        pipe = CyclePipeline(self) if self.config.score_pipeline else None
        stages = {"preprocess": 0.0, "dispatch": 0.0, "collect": 0.0,
                  "fold": 0.0}
        with tracing.span(tracing.SPAN_ENGINE_PREPROCESS, jobs=len(claimed)):
            for doc in claimed:
                states[doc.id] = _JobState(doc)
            t_wait = time.perf_counter()
            for doc_id, items, failed, fetch_notes in self._stream_prep(
                    claimed, now, cycle_dl):
                stages["preprocess"] += time.perf_counter() - t_wait
                if fetch_notes:
                    states[doc_id].fetch = fetch_notes
                if failed:
                    states[doc_id].failed = failed
                else:
                    # detection-latency stamps: the job was freshly
                    # ingested this cycle, and its window last advanced at
                    # the newest judged sample's own timestamp
                    states[doc_id].ingest_at = time.monotonic()
                    states[doc_id].newest_ts = self._newest_sample_ts(items)
                    pairs, bands, bis, multis, hpas = items
                    all_pairs += pairs
                    all_bands += bands
                    all_bis += bis
                    all_multis += multis
                    all_hpas += hpas
                    if pipe is not None:
                        # streamed dispatch: full bucket rungs launch here,
                        # overlapping the remaining fetches (the pipeline
                        # accounts its own dispatch time)
                        pipe.feed(pairs, bands, bis, multis, hpas,
                                  strategy=states[doc_id].doc.strategy)
                t_wait = time.perf_counter()
        shed_ids: list = []
        for doc_id, st in states.items():
            if not st.failed:
                self._shed_streak.pop(doc_id, None)
                self.store.advance(doc_id, J.PREPROCESS_COMPLETED,
                                   J.POSTPROCESS_INPROGRESS, worker=worker)
                continue
            doc = st.doc
            if st.failed == _SHED:
                # load shedding (CYCLE_DEADLINE_S): the budget burned down
                # before this job's fetch started. Carry it to the next
                # cycle — the shed streak promotes it within its class, so
                # it completes with the verdict it would have had unshed.
                self.jobs_shed_total += 1
                self._shed_streak[doc_id] = self._shed_streak.get(doc_id, 0) + 1
                shed_ids.append(doc_id)
                self.provenance.record(
                    doc_id, prov.PATH_SHED_CARRYOVER, status=J.INITIAL,
                    detail=f"streak {self._shed_streak[doc_id]}")
                self.exporter.record_counter(
                    "foremastbrain:jobs_shed_total", {},
                    help="jobs shed by the cycle deadline budget and "
                         "carried to the next cycle")
                self.store.transition(
                    doc_id, J.INITIAL, worker=worker,
                    reason="shed: cycle deadline budget exhausted; "
                           "carried over")
                outcomes[doc_id] = J.INITIAL
                continue
            # real fetch failure: a warm job re-serves its last fresh
            # verdict instead of flapping (stale-verdict serving)
            served = self._serve_stale(doc, st.failed, worker, now)
            if served is not None:
                outcomes[doc_id] = served
            elif doc.strategy in CONTINUOUS_STRATEGIES:
                # perpetual jobs survive transient fetch errors: requeue
                # instead of dying terminally on one network blip
                self.provenance.record(
                    doc_id, prov.PATH_FETCH_RETRY, status=J.INITIAL,
                    reason=st.failed, fetch=st.fetch)
                self.store.transition(
                    doc_id, J.INITIAL, reason=f"fetch retry: {st.failed}",
                    worker=worker,
                )
                outcomes[doc_id] = J.INITIAL
            else:
                self.provenance.record(
                    doc_id, prov.PATH_NO_DATA, status=J.PREPROCESS_FAILED,
                    reason=st.failed, fetch=st.fetch)
                self.store.transition(
                    doc_id, J.PREPROCESS_FAILED, reason=st.failed,
                    worker=worker,
                    processing_content=self._prov_content(doc_id))
                outcomes[doc_id] = J.PREPROCESS_FAILED
        if shed_ids:
            self.flight.record_event(flightrec.EVENT_SHED,
                                     count=len(shed_ids),
                                     jobs=shed_ids[:16])

        live = {k: v for k, v in states.items() if not v.failed}
        fam_seconds: dict[str, float] = {}
        with tracing.span(tracing.SPAN_ENGINE_SCORE, pairs=len(all_pairs),
                          bands=len(all_bands), bis=len(all_bis),
                          multis=len(all_multis), hpas=len(all_hpas)):
            if pipe is not None:
                (pair_res, band_res, bi_res, multi_res, hpa_res,
                 scoring_failed) = pipe.finish()
                for k, v in pipe.stage_seconds.items():
                    stages[k] += v
                fam_seconds = pipe.family_seconds
                for fam in ("pair", "band", "bivariate", "hpa"):
                    tracing.tracer.add_timing(
                        tracing.SCORE_SPANS[fam], fam_seconds.get(fam, 0.0))
            else:
                # barriered path (SCORE_PIPELINE=0): one child span per
                # model family, families strictly sequential
                def timed(fam, score_fn, items, attrs_fn=None):
                    with tracing.span(tracing.SCORE_SPANS[fam], n=len(items)) as sp:
                        t0 = time.perf_counter()
                        res = self._isolate(score_fn, items)
                        fam_seconds[fam] = time.perf_counter() - t0
                        if attrs_fn is not None:
                            attrs_fn(sp)
                        return res

                pair_res, pair_bad = timed("pair", self._score_pairs, all_pairs)
                band_res, band_bad = timed("band", self._score_bands, all_bands)
                bi_res, bi_bad = timed("bivariate", self._score_bivariate, all_bis)
                multi_res, multi_bad = timed(
                    "lstm", self._score_multi, all_multis,
                    attrs_fn=lambda sp: sp.attrs.__setitem__(
                        "budget_skips", len(self._lstm_budget_skipped_ids)))
                hpa_res, hpa_bad = timed("hpa", self._score_hpa, all_hpas)
                scoring_failed = {**pair_bad, **band_bad, **bi_bad,
                                  **multi_bad, **hpa_bad}
                stages["collect"] += sum(fam_seconds.values())
            self.lstm_budget_skips += len(self._lstm_budget_skipped_ids)

        t_fold = time.perf_counter()
        # waterfall boundary: everything before this instant is the `score`
        # stage, everything after is `fold` (_observe_latency)
        self._cycle_fold_mono = time.monotonic()
        # -- provenance collection (zero work when recording is off) --
        # per-family score-vs-threshold entries and judged-result counts per
        # job; counts vs the pipeline's memo-hit map classify each verdict
        # as fresh-scored or memo-served
        prov_on = self.provenance.enabled
        fam_entries: dict[str, list] = {}
        judged_items: dict[str, int] = {}
        memo_job_hits = pipe.memo_job_hits if pipe is not None else {}
        triage_gate = pipe.triage if pipe is not None else None
        triage_job_hits = triage_gate.job_hits if triage_gate is not None \
            else {}
        # per-result screen statistics for cleared rows, keyed by the family
        # result key, folded into the provenance family entries
        triage_stats = triage_gate.stats if triage_gate is not None else {}
        # a partial (event-driven) cycle's fresh scores carry their own
        # path tag
        scored_path = prov.PATH_STREAM_SCORED if partial \
            else prov.PATH_SCORED

        def _vpath(job_id: str) -> tuple:
            """(path, detail) for a judged job: memo-hit when EVERY result
            came from the fingerprint memo, triaged when the tier-0 screen
            cleared the rest, scored otherwise."""
            n = judged_items.get(job_id, 0)
            m = memo_job_hits.get(job_id, 0) + (
                1 if job_id in self._lstm_memo_jobs else 0)
            t = triage_job_hits.get(job_id, 0)
            if n and m >= n:
                return prov.PATH_MEMO_HIT, f"{m}/{n} results from memo"
            if n and t and m + t >= n:
                detail = f"{t}/{n} screened clear"
                if m:
                    detail += f", {m} memo"
                return prov.PATH_TRIAGED, detail
            if t:
                return (scored_path,
                        f"{n - m - t}/{n} fresh, {m} memo, {t} triaged")
            if m:
                return scored_path, f"{n - m}/{n} fresh, {m} memo"
            return scored_path, ""

        # fold per-metric results into per-job verdicts
        for it in all_pairs:
            r = pair_res.get((it.job_id, it.metric, "pair"))
            if r is None:
                continue
            st = live[it.job_id]
            st.judged_any = True
            if prov_on:
                judged_items[it.job_id] = judged_items.get(it.job_id, 0) + 1
                entry = {
                    "family": "pair", "metric": it.metric,
                    "min_p": round(r["min_p"], 8),
                    "alpha": self.config.pairwise_threshold,
                    "unhealthy": bool(r["unhealthy"])}
                entry.update(triage_stats.get(
                    (it.job_id, it.metric, "pair"), {}))
                fam_entries.setdefault(it.job_id, []).append(entry)
            if r["unhealthy"]:
                causes = []
                if r["pairwise_unhealthy"]:
                    causes.append(f"pairwise rejection p={r['min_p']:.2e}")
                if r["band_unhealthy"]:
                    causes.append(
                        f"{r['band_count']} points outside the baseline band"
                    )
                st.unhealthy.append((it.metric, "; ".join(causes), []))
        for it in all_bands:
            r = band_res.get((it.job_id, it.metric, "band"))
            if r is None:
                continue
            st = live[it.job_id]
            st.judged_any = True
            if prov_on:
                judged_items[it.job_id] = judged_items.get(it.job_id, 0) + 1
                entry = {
                    "family": "band", "metric": it.metric,
                    "anomalous_points": int(r["count"]),
                    "band": [round(r["lower"], 4), round(r["upper"], 4)],
                    "unhealthy": bool(r["unhealthy"])}
                entry.update(triage_stats.get(
                    (it.job_id, it.metric, "band"), {}))
                fam_entries.setdefault(it.job_id, []).append(entry)
            self.exporter.record_bounds(
                st.doc.app_name, st.doc.namespace, it.metric,
                r["upper"], r["lower"], float(r["unhealthy"]),
            )
            if r["unhealthy"]:
                st.unhealthy.append(
                    (
                        it.metric,
                        f"{r['count']} points outside "
                        f"[{r['lower']:.4g},{r['upper']:.4g}] from ts {r['first_ts']:.0f}",
                        r["anomaly_pairs"],
                    )
                )
        for it in all_bis:
            r = bi_res.get((it.job_id, "&".join(it.metrics), "bivariate"))
            if r is None:
                continue
            st = live[it.job_id]
            st.judged_any = True
            if prov_on:
                judged_items[it.job_id] = judged_items.get(it.job_id, 0) + 1
                entry = {
                    "family": "bivariate", "metric": "&".join(it.metrics),
                    "anomalous_points": int(r["count"]),
                    "unhealthy": bool(r["unhealthy"])}
                entry.update(triage_stats.get(
                    (it.job_id, "&".join(it.metrics), "bivariate"), {}))
                fam_entries.setdefault(it.job_id, []).append(entry)
            for metric, (upper, lower) in r["bounds"].items():
                self.exporter.record_bounds(
                    st.doc.app_name, st.doc.namespace, metric,
                    upper, lower, float(r["unhealthy"]),
                )
            if r["unhealthy"]:
                st.unhealthy.append(
                    (
                        "&".join(it.metrics),
                        f"{r['count']} points outside the joint "
                        f"bivariate-normal ellipse from ts {r['first_ts']:.0f}",
                        r["anomaly_pairs"],
                    )
                )

        for it in all_multis:
            r = multi_res.get((it.job_id, "+".join(it.metrics), "lstm"))
            if r is None:
                continue
            st = live[it.job_id]
            st.judged_any = True
            if prov_on:
                judged_items[it.job_id] = judged_items.get(it.job_id, 0) + 1
                fam_entries.setdefault(it.job_id, []).append({
                    "family": "lstm", "metric": "+".join(it.metrics),
                    "z": round(float(r["z"]), 4),
                    "threshold": self.config.lstm_threshold,
                    "unhealthy": bool(r["unhealthy"])})
            if r["unhealthy"]:
                st.unhealthy.append(
                    (
                        "+".join(it.metrics),
                        f"LSTM-AE reconstruction z={r['z']:.2f} exceeds "
                        f"{self.config.lstm_threshold:.1f}",
                        [],
                    )
                )
        if prov_on:
            # hpa results fold inside _finish_hpa; count them here so the
            # memo-vs-fresh classification sees them like every family
            for job_id in hpa_res:
                if job_id in live:
                    judged_items[job_id] = judged_items.get(job_id, 0) + 1

        for job_id, st in live.items():
            doc = st.doc
            if job_id in scoring_failed:
                reason = f"scoring failed: {scoring_failed[job_id]}"
                if scoring_failed[job_id].startswith("WatchdogTimeout"):
                    # watchdog fires are INFRASTRUCTURE evidence (a hung or
                    # wedged card), not job poison: every strategy requeues
                    # for the next cycle
                    self.provenance.record(
                        job_id, prov.PATH_WATCHDOG_FAILOVER,
                        status=J.INITIAL, reason=reason, fetch=st.fetch)
                    self.store.transition(
                        job_id, J.INITIAL, reason=reason, worker=worker)
                    outcomes[job_id] = J.INITIAL
                    continue
                if doc.strategy in CONTINUOUS_STRATEGIES:
                    # perpetual jobs retry next cycle (data may heal) — but
                    # a job that keeps poisoning its per-job retry is
                    # parked (quarantine)
                    self._record_scoring_failure(job_id, now)
                    self.provenance.record(
                        job_id, prov.PATH_BLAST_RADIUS, status=J.INITIAL,
                        reason=reason, fetch=st.fetch)
                    self.store.transition(job_id, J.INITIAL, reason=reason, worker=worker)
                    outcomes[job_id] = J.INITIAL
                else:
                    self._quarantine.pop(job_id, None)  # terminal: moot
                    self.provenance.record(
                        job_id, prov.PATH_BLAST_RADIUS, status=J.ABORT,
                        reason=reason, fetch=st.fetch)
                    self.store.transition(
                        job_id, J.ABORT, reason=reason, worker=worker,
                        processing_content=self._prov_content(job_id))
                    outcomes[job_id] = J.ABORT
                continue
            # scored cleanly: full quarantine reset (consecutive = 0)
            self._quarantine.pop(job_id, None)
            if doc.strategy == STRATEGY_HPA:
                res = hpa_res.get(job_id)
                outcomes[job_id] = self._finish_hpa(
                    st, res, worker, now,
                    path_info=_vpath(job_id) if prov_on else None)
                if res is not None:
                    # a scored hpa cycle IS the detection; annotates the
                    # record _finish_hpa just wrote
                    self._observe_latency(st, now)
                continue
            try:
                end_time = from_rfc3339(doc.end_time)
            except (ValueError, TypeError):
                # continuous jobs carry END_TIME placeholders: never expire
                end_time = float("inf") if doc.strategy in CONTINUOUS_STRATEGIES else now
            if st.unhealthy:
                metrics = ", ".join(dict.fromkeys(m for m, _, _ in st.unhealthy))
                reason = "; ".join(f"{m}: {d}" for m, d, _ in st.unhealthy)
                anomaly = {m: pairs for m, _, pairs in st.unhealthy if pairs}
                self._stale_state.pop(job_id, None)
                reason = f"anomaly detected on {metrics} :: {reason}"
                if prov_on:
                    path, detail = _vpath(job_id)
                    self.provenance.record(
                        job_id, path, status=J.COMPLETED_UNHEALTH,
                        detail=detail, reason=reason,
                        families=fam_entries.get(job_id),
                        fetch=st.fetch)
                # observed between record and transition: the latency
                # annotation must land before the summary is attached
                self._observe_latency(st, now)
                self.store.transition(
                    job_id, J.COMPLETED_UNHEALTH,
                    reason=reason,
                    anomaly=anomaly, worker=worker,
                    processing_content=self._prov_content(job_id),
                )
                outcomes[job_id] = J.COMPLETED_UNHEALTH
            elif now < end_time:
                # healthy so far; keep watching until endTime (fail-fast
                # rule); continuous jobs loop here forever. A judged cycle
                # refreshes the job's warm stale-serving state.
                if st.judged_any:
                    self._stale_state[job_id] = now
                    if prov_on:
                        path, detail = _vpath(job_id)
                        self.provenance.record(
                            job_id, path, status=J.INITIAL, detail=detail,
                            families=fam_entries.get(job_id), fetch=st.fetch)
                    # "healthy so far" is a verdict too: the monitor fleet's
                    # steady-state latency is exactly this path
                    self._observe_latency(st, now)
                self.store.requeue(job_id, worker=worker)
                outcomes[job_id] = J.INITIAL
            elif st.judged_any:
                self._stale_state.pop(job_id, None)
                if prov_on:
                    path, detail = _vpath(job_id)
                    self.provenance.record(
                        job_id, path, status=J.COMPLETED_HEALTH,
                        detail=detail, families=fam_entries.get(job_id),
                        fetch=st.fetch)
                self._observe_latency(st, now)
                self.store.transition(
                    job_id, J.COMPLETED_HEALTH, worker=worker,
                    processing_content=self._prov_content(job_id))
                outcomes[job_id] = J.COMPLETED_HEALTH
            else:
                # no judgeable data at endTime: a warm job re-serves its
                # last fresh verdict; cold jobs end unknown
                served = self._serve_stale(
                    doc, "insufficient data points to judge", worker, now,
                    in_postprocess=True)
                if served is not None:
                    outcomes[job_id] = served
                    continue
                self.provenance.record(
                    job_id, prov.PATH_NO_DATA, status=J.COMPLETED_UNKNOWN,
                    reason="insufficient data points to judge",
                    fetch=st.fetch)
                self.store.transition(
                    job_id, J.COMPLETED_UNKNOWN,
                    reason="insufficient data points to judge", worker=worker,
                    processing_content=self._prov_content(job_id),
                )
                outcomes[job_id] = J.COMPLETED_UNKNOWN
        stages["fold"] = time.perf_counter() - t_fold
        for name, secs in stages.items():
            tracing.tracer.add_timing(tracing.STAGE_SPANS[name], secs)
        self.exporter.record_cycle_stages(stages, fam_seconds)
        triage_cycle = None
        if triage_gate is not None and triage_gate.active:
            tg = triage_gate
            tracing.tracer.add_timing(tracing.SPAN_ENGINE_TRIAGE, tg.seconds)
            screened = sum(tg.screened.values())
            cleared = sum(tg.cleared.values())
            escalated = sum(tg.escalated.values())
            for fam in sorted(set(tg.screened) | set(tg.cleared)
                              | set(tg.escalated)):
                self.triage_screened_total[fam] = (
                    self.triage_screened_total.get(fam, 0)
                    + tg.screened.get(fam, 0))
                self.triage_cleared_total[fam] = (
                    self.triage_cleared_total.get(fam, 0)
                    + tg.cleared.get(fam, 0))
                self.triage_escalated_total[fam] = (
                    self.triage_escalated_total.get(fam, 0)
                    + tg.escalated.get(fam, 0))
                self.exporter.record_triage(
                    fam, tg.screened.get(fam, 0), tg.cleared.get(fam, 0),
                    tg.escalated.get(fam, 0))
            self.triage_launches_total += tg.launches
            self.exporter.record_gauge(
                "foremastbrain:triage_escalation_ratio", {},
                round(escalated / screened, 6) if screened else 0.0,
                help="Fraction of screened rows escalated to the "
                     "full scorers (last cycle).")
            self.exporter.record_gauge(
                "foremastbrain:triage_seconds", {},
                round(tg.seconds, 6),
                help="Tier-0 triage screen stage seconds (last cycle).")
            triage_cycle = {
                "screened": screened,
                "cleared": cleared,
                "escalated": escalated,
                "escalation_ratio": (round(escalated / screened, 6)
                                     if screened else 0.0),
                "launches": tg.launches,
                "seconds": round(tg.seconds, 6),
            }
        mega_cycle = None
        if self.config.megabatch:
            real = self.megabatch_real_rows_total - mega_r0
            padded = self.megabatch_pad_rows_total - mega_p0
            mega_launches = self.megabatch_launches_total - mega_l0
            waste = round(padded / real, 6) if real else 0.0
            mega_cycle = {
                "launches": mega_launches,
                "real_rows": real,
                "padded_rows": padded,
                "padding_waste_ratio": waste,
            }
            self.exporter.record_gauge(
                "foremastbrain:megabatch_padding_waste_ratio", {}, waste,
                help="Mega-batch padding rows per real row (last cycle).")
            if mega_launches:
                self.exporter.record_counter(
                    "foremastbrain:megabatch_launches_total", {},
                    inc=mega_launches,
                    help="device launches through the single-dispatch "
                         "mega-batch path (MEGABATCH)")
                self.exporter.record_counter(
                    "foremastbrain:megabatch_real_rows_total", {},
                    inc=real,
                    help="real rows carried by mega-batch launches")
                self.exporter.record_counter(
                    "foremastbrain:megabatch_padded_rows_total", {},
                    inc=padded,
                    help="padding rows added to reach mega padding "
                         "classes (waste = padded/real)")
        self.provenance.finish_cycle(
            stage_seconds=stages,
            device_launches=self.device_launches - launches0,
            jobs=len(claimed))
        self.last_cycle_stages = {
            "cycle_id": self.current_cycle_id,
            "jobs": len(claimed),
            "partial": partial,
            "pipelined": pipe is not None,
            "stage_seconds": {k: round(v, 6) for k, v in stages.items()},
            "family_score_seconds": {
                k: round(v, 6) for k, v in fam_seconds.items()},
            "device_launches": self.device_launches - launches0,
            "family_launches": dict(pipe.family_launches)
            if pipe is not None else {},
            "score_memo_hits": dict(pipe.memo_hits) if pipe is not None
            else {},
            "triage": triage_cycle,
            "megabatch": mega_cycle,
            "lstm_rescore_skips": self.lstm_rescore_skips - rescore_skips0,
            # degraded-mode signals: this cycle's contribution + the live
            # park count (cumulative totals ride the exporter)
            "jobs_shed": self.jobs_shed_total - shed_cycle0,
            "stale_verdicts_served":
            self.stale_verdicts_served_total - stale_cycle0,
            "watchdog_fires": self.watchdog_fires_total - wd_cycle0,
            "quarantined_jobs": self.quarantined_count(now),
        }
        self._prune_degraded_state(outcomes, orphan_sweep=not partial)
        self.store.put_state("breath", self.breath.export())
        self.store.flush()
        return outcomes

    def _prune_degraded_state(self, outcomes: dict,
                              orphan_sweep: bool = True):
        """Drop per-job degraded-mode state for jobs that can never come
        back: terminal outcomes this cycle, plus jobs deleted out from under
        the analyzer. Partial cycles skip the orphan sweep (they would
        re-scan fleet-sized maps per notify burst); the next full sweep
        covers it."""
        for jid, status in outcomes.items():
            if status in J.TERMINAL_STATUSES:
                self._stale_state.pop(jid, None)
                self._quarantine.pop(jid, None)
                self._shed_streak.pop(jid, None)
                self._slo_seen.pop(jid, None)
        if not orphan_sweep:
            return
        for table in (self._stale_state, self._quarantine,
                      self._shed_streak, self._slo_seen):
            for jid in [j for j in table
                        if j not in outcomes and self.store.get(j) is None]:
                table.pop(jid, None)
