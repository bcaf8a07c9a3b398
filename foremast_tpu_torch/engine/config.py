"""Engine configuration: the reference brain's ML_* env surface.

Re-implements the config contract documented in foremast-brain/README.md
(:22-38, :49-55) and deployed at deploy/foremast/3_brain/foremast-brain.yaml
(:24-81): global algorithm/threshold/bound plus indexed per-metric-type
overrides (metric_type{N} / threshold{N} / bound{N} / min_lower_bound{N}),
min-data-point gates per pairwise test, and the stuck-job takeover limit.

A copy of the reference's ``engine/config.py`` cut to the fields the port
reads, with the same environment variables and defaults. The knobs of
layers the port has not taken over yet (delta fetch, retries and breakers,
the compile cache, prewarming) are not fields here: `from_env` raises
NotImplementedError, naming the ROADMAP item, when one of them is set to
anything but the reference's default, so no deployment silently runs
without a layer it asked for.

LSTM_HIDDEN or LSTM_LATENT below 1 is refused when the config is built
(`EngineConfig` and so `from_env` raise ValueError naming the knob): the
reference fails on it when it builds the model. A negative ST_ORDER or
ST_CHANGEPOINTS is taken as 0, as the reference's fit takes it.
"""
from __future__ import annotations

import os
from dataclasses import dataclass, field



@dataclass(frozen=True)
class MetricPolicy:
    """Per-metric-type judgment knobs."""

    threshold: float = 2.0  # band half-width in sigmas
    bound: int = 1  # bitmask: 1 upper, 2 lower, 3 both
    min_lower_bound: float = 0.0
    # static SLA limit when this metric plays the HPA reward role; 0 =
    # unset, inherit ML_SLA_LIMIT. Absolute on the metric's scale or a
    # multiple of the healthy historical mean, per the wire isAbsolute flag
    # and ML_SLA_LIMIT_RELATIVE.
    sla_limit: float = 0.0


# deployed defaults (foremast-brain.yaml:34-73)
DEFAULT_POLICIES = {
    "error5xx": MetricPolicy(2.0, 1, 0.0),
    "error4xx": MetricPolicy(3.0, 1, 0.0),
    "latency": MetricPolicy(10.0, 3, 0.0),
    "cpu": MetricPolicy(5.0, 1, 0.0),
    "memory": MetricPolicy(5.0, 1, 0.0),
}

PAIRWISE_TESTS = ("mann_whitney", "wilcoxon", "kruskal", "ks")


@dataclass(frozen=True)
class EngineConfig:
    algorithm: str = "moving_average_all"  # ML_ALGORITHM
    pairwise_algorithm: str = "mann_whitney_all"  # ML_PAIRWISE_ALGORITHM
    pairwise_threshold: float = 0.01  # ML_PAIRWISE_THRESHOLD (p-value alpha)
    threshold: float = 2.0  # ML_THRESHOLD (band sigmas)
    bound: int = 1  # ML_BOUND bitmask
    min_lower_bound: float = 0.0
    min_historical_points: int = 10  # MIN_HISTORICAL_DATA_POINT_TO_MEASURE
    min_mann_whitney_points: int = 20  # MIN_MANN_WHITE_DATA_POINTS
    min_wilcoxon_points: int = 20  # MIN_WILCOXON_DATA_POINTS
    min_kruskal_points: int = 5  # MIN_KRUSKAL_DATA_POINTS
    min_friedman_points: int = 5  # MIN_FRIEDMAN_DATA_POINTS (paired blocks)
    max_stuck_seconds: float = 90.0  # MAX_STUCK_IN_SECONDS
    # jobs leased per cycle (MAX_CLAIM_PER_CYCLE). The batched cycle scores
    # every claimed job in one device program per bucket, so this is the
    # fleet batch size, not a per-worker work-queue depth; at 100k-fleet
    # scale the default must not silently cap the cycle.
    max_claim_per_cycle: int = 100_000
    # device-launch row chunk: the fleet-batched scorers (pairs, bands,
    # bivariate, hpa) split their packed batches into fixed rungs so XLA
    # compiles ONE program per (rung, T) bucket instead of re-specializing
    # on every fleet size (analyzer._launch_chunks; the LSTM family's
    # fleet scoring chunks its jobs at it too)
    score_batch: int = 8192
    # per-job window fetches run on a bounded thread pool
    # (FETCH_CONCURRENCY; 1 = serial). In production the fetch stage is
    # network-bound against the metric store, so overlap is the difference
    # between cycle time scaling with fleet size and with store latency.
    fetch_concurrency: int = 16
    # streaming scoring pipeline (SCORE_PIPELINE; engine/pipeline.py):
    # preprocess->dispatch overlap + async device launches collected in a
    # final phase. Verdicts are byte-identical to the barriered path
    # (enforced by tests/test_pipeline.py); 0 restores the full-barrier
    # cycle for A/B or debugging.
    score_pipeline: bool = True
    # streamed-launch fire threshold (PIPELINE_FIRE_ROWS): a family/T
    # accumulator launches as soon as it holds this many rows, overlapping
    # device execution with the remaining fetches. Clamped to
    # [16, score_batch]; values are snapped to the batch-rung ladder so
    # mid-stream launches reuse the same compiled programs as the flush.
    # Scorers are row-wise, so earlier launch boundaries cannot change
    # verdicts. score_batch-sized = fire only on full chunks.
    pipeline_fire_rows: int = 1024
    # delta window-cache entries (WINDOW_CACHE_MAX) in the reference; the
    # port has no delta cache (ROADMAP queue 1, item 8) and reads it only
    # as the score-memo table's bound, 4x this value.
    window_cache_max: int = 8192
    # fingerprint score memoization (SCORE_MEMO; engine/pipeline.py):
    # hash each job's packed scorer inputs per (job, family, T-bucket) and
    # reuse the previous verdict when unchanged — the common steady-state
    # case for baseline/historical-driven families. Pipeline buckets then
    # hold only changed rows and fire fewer, smaller programs. Effective
    # with SCORE_PIPELINE=1 (the default); verdicts stay byte-identical
    # (scorers are deterministic row-wise functions of the fingerprinted
    # inputs — pinned by tests/test_delta.py's identity test).
    score_memo: bool = True
    # tier-0 triage screen (TRIAGE; engine/triage.py + ops/triage.py):
    # before the family scorers launch, changed rows of steady-state
    # (continuous/hpa-class) jobs ride one fused robust-z + smoother-
    # residual screen; rows the screen clears short-circuit to the
    # healthy verdict the full path would produce, suspects escalate to
    # the full scorers unchanged. Verdict-safe by construction (see
    # engine/triage.py: shrunk-band dominance for the moving-average
    # band family; canary-class jobs, the hpa family, and
    # non-moving-average band algorithms always escalate) and by test
    # (the escalation-threshold sweep in tests/test_triage.py). Effective
    # with SCORE_PIPELINE=1 (the gate lives in the pipeline); 0 restores
    # the screen-free path exactly.
    triage: bool = True
    # robust z-band escalation guard (TRIAGE_Z): rows whose max
    # |x - median(hist)| / robust-scale over the current region exceeds
    # this always escalate, whatever the residual band says. Escalation-
    # only defense in depth — lowering it cannot change verdicts, only
    # shrink the launch savings (0 = screen nothing).
    triage_z: float = 8.0
    # one-sided CLEAR margin in sigmas (TRIAGE_MARGIN): a row clears only
    # while its violation count of the policy band SHRUNK by this much
    # stays under the family's verdict gate. The shrunk band is strictly
    # narrower, so its count dominates the real one (sub-gate shrunk
    # count => sub-gate real count => healthy), and any point the full
    # scorer could count differently sits within float ulps of the real
    # boundary — i.e. a macroscopic margin*sigma outside the shrunk band,
    # so drift flips cannot change the CLEAR decision. 0 removes the
    # drift guard (NOT recommended); >= the policy threshold disables
    # clearing.
    triage_margin: float = 0.25
    # minimum valid history points for a row to be screenable
    # (TRIAGE_MIN_POINTS); thinner rows always take the full path
    triage_min_points: int = 24
    # screen batch coarseness (TRIAGE_FIRE_ROWS): rows per fused screen
    # launch at T<=1024 (scaled down ~1/T past that for bounded launch
    # memory). An order of magnitude coarser than PIPELINE_FIRE_ROWS on
    # purpose: the screen is one cheap pass, so fewer, bigger launches
    # are the point.
    triage_fire_rows: int = 16384
    # families the screen may clear (TRIAGE_FAMILIES, comma list). The
    # default is the provably one-sided set: band (under moving_average*
    # algorithms only). pair/bivariate opt-in is NOT verdict-safe: the
    # screen cannot bound rank-test p-values or ellipse correlation, so
    # a sustained sub-band distribution shift the full scorer would
    # convict can clear (docs/performance.md §5); hpa is never screened.
    triage_families: tuple = ("band",)
    # single-dispatch mega-batching (MEGABATCH; engine/pipeline.py):
    # instead of firing per-(family, T-bucket) rung launches mid-stream,
    # each family's accumulator holds the WHOLE cycle's rows and flushes
    # as one padded launch per (family, T) — the rung ladder becomes
    # padding classes (mantissa-quantized above 512 rows, <= 1/16 waste;
    # analyzer._mega_rows), so a family costs ONE program launch per
    # cycle up to the MEGABATCH_MAX_ROWS ceiling (a 100k-row family
    # chunks at the ceiling into ~4 launches — vs ~13 rung chunks).
    # Trades the pipeline's
    # fetch/score overlap for launch count — the right trade once
    # dispatch overhead dominates (100k+ fleets; docs/performance.md §6).
    # Verdicts are byte-identical either way (scorers are row-wise;
    # pinned by tests/test_megabatch.py). Off by default: small fleets
    # keep the overlap, and the prewarm grid covers the rung programs.
    megabatch: bool = False
    # mega-launch row ceiling at T<=1024 (MEGABATCH_MAX_ROWS; scaled
    # down ~1/T beyond, floor 1024, for bounded launch memory). Fleets
    # past the cap chunk at it — still ~8x fewer launches than the rung
    # path's score_batch chunks.
    megabatch_max_rows: int = 32768
    ma_window: int = 30  # moving-average lookback (steps)
    # windows at/above this length use the time-parallel associative-scan
    # SES smoother (ops/seqscan.py) instead of sequential lax.scan; DES
    # always stays sequential (f32 drift — see seqscan.py docstring)
    long_window_steps: int = 4096  # LONG_WINDOW_STEPS
    hw_period: int = 1440  # Holt-Winters / seasonal-trend period (steps; 1 day at 60s)
    # seasonality auto-detection (ops/forecast.py:detect_period): when on,
    # each band job's history votes among the candidate periods by masked
    # detrended autocorrelation; hw_period is only the fallback for series
    # with no supported/confident candidate. Candidates are operational
    # cycles in steps at 60 s: hour / shift / day.
    hw_period_auto: bool = True  # HW_PERIOD_AUTO
    hw_period_candidates: tuple = (60, 480, 720, 1440)  # HW_PERIOD_CANDIDATES
    hw_min_seasonal_acf: float = 0.2  # HW_MIN_SEASONAL_ACF
    # harmonic-alias margin: a shorter (fundamental-first) candidate wins
    # when its ACF score sits within this of the best candidate's. Larger
    # = stronger preference for the fundamental over its multiples, at
    # the cost of letting a noisier short candidate beat a genuinely
    # better long one (ops/forecast.py:detect_period).
    hw_alias_margin: float = 0.05  # HW_ALIAS_MARGIN
    # half-lag contrast slack: a candidate fails only when its half-lag
    # ACF beats its lag-p ACF by MORE than this (ties within noise are
    # harmonically valid picks — see ops/forecast.py:detect_period)
    hw_contrast_margin: float = 0.01  # HW_CONTRAST_MARGIN
    st_order: int = 3  # seasonal-trend (prophet) Fourier order, ST_ORDER
    # Prophet piecewise-linear trend: hinge changepoints on a uniform grid
    # over the first 80% of the window, L1-ish shrunk (iterated ridge) so
    # the trend stays piecewise-sparse (ops/forecast.py:fit_seasonal_trend).
    # 0 restores the single linear trend.
    st_changepoints: int = 12  # ST_CHANGEPOINTS
    # LSTM-autoencoder multivariate mode (3+ metrics; faq.md:8-10)
    lstm_window: int = 32  # subwindow length (steps) per training sample
    lstm_epochs: int = 30
    lstm_hidden: int = 32
    lstm_latent: int = 16
    lstm_threshold: float = 3.0  # recon-error z-score gate
    # train-on-miss budget per cycle: a cold multi-metric fleet must warm
    # up across cycles instead of blowing one cycle's budget on unbounded
    # AE training (jobs beyond the budget stay in progress and train on a
    # later cycle). <= 0 removes the cap.
    lstm_max_train_per_cycle: int = 8  # LSTM_MAX_TRAIN_PER_CYCLE
    max_cache_size: int = 1024  # MAX_CACHE_SIZE (trained LSTM models kept)
    # reference model dispatch by metric count (design.md:53-88): 2-metric
    # jobs -> bivariate normal, 3+ -> LSTM-AE, regardless of ML_ALGORITHM
    # (which names the univariate forecaster). False = route multivariate
    # families only when ML_ALGORITHM names them explicitly.
    multimetric_auto: bool = True  # ML_MULTIMETRIC_AUTO
    # band verdict gate: a window is unhealthy when
    # count >= max(band_min_points, band_violation_fraction * checked).
    # A single k-sigma excursion in a 30-point window is expected Gaussian
    # noise (~4.5% of points at 2 sigma); the per-metric thresholds assume
    # near-zero-variance error metrics, so noisy metrics need the gate.
    band_min_points: int = 2
    band_violation_fraction: float = 0.1
    # HPA reward shaping (SLA_HEADROOM_SAFE): below this SLA-budget
    # utilization scale-down is fully model-driven; between it and 1.0 the
    # reward ramps scale-down off (ops/hpa.py)
    sla_headroom_safe: float = 0.7
    # SLA criteria of the HPA reward (ML_SLA_MODE): "static" fixed limit,
    # "dynamic" mean + 3 sigma of the healthy history, "min" the smaller.
    # A static or min mode with no limit configured (ML_SLA_LIMIT or the
    # metric's sla_limit{N}) degrades to dynamic for that job.
    sla_mode: str = "dynamic"  # ML_SLA_MODE
    sla_limit: float = 0.0  # ML_SLA_LIMIT (0 = unset)
    # False: limits are absolute values on the metric's scale (latency
    # ms); True: metrics the wire does not flag isAbsolute read the limit
    # as a multiple of the healthy historical mean (ML_SLA_LIMIT_RELATIVE)
    sla_limit_relative: bool = False
    # per-cycle fetch deadline: retries (and their backoff sleeps) must
    # finish inside this budget so a flapping backend cannot stretch the
    # cycle past its cadence. 0 disables.
    fetch_cycle_deadline_seconds: float = 8.0  # FETCH_CYCLE_DEADLINE
    # -- degraded-mode operation --
    # whole-cycle deadline budget (CYCLE_DEADLINE_S): once it burns down,
    # STEADY-STATE monitor jobs (continuous/hpa) not yet preprocessed are
    # SHED and carry over to the next cycle; new-deployment analyses are
    # exempt (their verdict gates a live rollout). The first monitor-class
    # job is always let through per cycle (the floor), and a shed job sorts
    # to the head of the monitor class next cycle. 0 disables. On the card
    # the budget is armed only after the kernel library has loaded, so a
    # first cycle that builds the library does not spend the build inside
    # it (Analyzer.run_cycle).
    cycle_deadline_seconds: float = 0.0  # CYCLE_DEADLINE_S
    # stale-verdict serving bound (MAX_STALE_S): when a warm job's fetch
    # fails or returns no data, its last healthy verdict (at most this old)
    # is re-served — stamped with its staleness age — instead of flapping
    # the job to PREPROCESS_FAILED or COMPLETED_UNKNOWN. 0 disables.
    max_stale_seconds: float = 300.0  # MAX_STALE_S
    # poison-job quarantine (QUARANTINE_AFTER): a job whose per-job retry
    # fails this many CONSECUTIVE cycles is parked with exponential
    # re-admission backoff (30 s doubling, capped 3600 s). 0 disables.
    quarantine_after: int = 3  # QUARANTINE_AFTER
    # hung-launch watchdog (WATCHDOG_S): bound on one bucket's device
    # materialization in the pipeline collect phase; a stuck launch times
    # out, fails over to the sync per-job path, and is counted on
    # foremastbrain:watchdog_fires_total. 0 disables (the safe default:
    # big first-cycle CPU executions can legitimately run long — enable
    # it once the fleet's shapes are prewarmed/compile-cached).
    watchdog_seconds: float = 0.0  # WATCHDOG_S
    # -- observability --
    # verdict provenance recording (PROVENANCE): per-(job, cycle)
    # attribution records — which verdict path fired, per-family scores vs
    # thresholds, fetch mode — attached to terminal Documents. Recording
    # only observes the cycle (verdicts are identical either way); 0
    # disables it for the A/B leg.
    provenance: bool = True  # PROVENANCE
    # flight-recorder dump directory (FLIGHT_DUMP_DIR): incident JSON
    # snapshots written on the transition into OVERLOADED/STALLED. Empty =
    # the system temp dir.
    flight_dump_dir: str = ""  # FLIGHT_DUMP_DIR
    # detection-latency SLO targets per job class (engine/slo.py), in
    # seconds; 0 disables the target for that class (latency is still
    # measured). SLO_OBJECTIVE is the attainment goal the error budget
    # derives from.
    slo_canary_seconds: float = 30.0  # SLO_CANARY_S
    slo_continuous_seconds: float = 60.0  # SLO_CONTINUOUS_S
    slo_hpa_seconds: float = 60.0  # SLO_HPA_S
    slo_objective: float = 0.99  # SLO_OBJECTIVE
    policies: dict = field(default_factory=lambda: dict(DEFAULT_POLICIES))

    def __post_init__(self):
        """Refuse, by knob, an LSTM width below 1 (the reference fails on
        it: a layer of no units)."""
        for knob, v in (("LSTM_HIDDEN", self.lstm_hidden), ("LSTM_LATENT", self.lstm_latent)):
            if v < 1:
                raise ValueError(f"{knob}={v}: the LSTM autoencoder takes widths of 1 or more")

    def policy_for(self, metric_name: str) -> MetricPolicy:
        """Longest-substring match of configured metric types in the name
        (metric names arrive as e.g. namespace_app_pod_http_errors_5xx)."""
        best = None
        for key, pol in self.policies.items():
            norm = key.replace("error", "").lower()
            if key.lower() in metric_name.lower() or (
                norm and norm in metric_name.lower()
            ):
                if best is None or len(key) > len(best[0]):
                    best = (key, pol)
        if best:
            return best[1]
        return MetricPolicy(self.threshold, self.bound, self.min_lower_bound)

    @property
    def pairwise_combine_all(self) -> bool:
        return self.pairwise_algorithm.endswith("_all") or self.pairwise_algorithm == "all"

    def enabled_tests(self) -> int:
        """Bitmask of enabled pairwise tests (parallel.fleet TEST_* bits)."""
        from ..parallel import fleet as fl

        name = self.pairwise_algorithm
        table = {
            "mann_whitney": fl.TEST_MANN_WHITNEY,
            "wilcoxon": fl.TEST_WILCOXON,
            "kruskal": fl.TEST_KRUSKAL,
            "ks": fl.TEST_KS,
            "friedman": fl.TEST_FRIEDMAN,
        }
        for key, bit in table.items():
            if name.startswith(key):
                return bit
        # "all"/"any" composite modes enable the full family
        return (
            fl.TEST_MANN_WHITNEY | fl.TEST_WILCOXON | fl.TEST_KRUSKAL
            | fl.TEST_KS | fl.TEST_FRIEDMAN
        )


def _env_float(env, key, default):
    try:
        return float(env[key])
    except (KeyError, ValueError):
        return default


def _env_int(env, key, default):
    try:
        return int(env[key])
    except (KeyError, ValueError):
        return default


def _env_bool(env, key, default):
    """One definition of env truthiness for every boolean knob (operators
    write 0/1, true/false, yes/no, on/off in any case)."""
    raw = env.get(key)
    if raw is None:
        return default
    return raw.strip().lower() not in ("0", "false", "no", "off", "")


def _env_str(env, key, default):
    return env.get(key, default).strip().lower()


_NOT_PORTED_WHY = {
    8: "this layer of the engine is not ported yet (ROADMAP queue 1, item 8)",
}
# The reference's knobs of layers the port has not taken over: variable ->
# (parse, the reference's default, the item of _NOT_PORTED_WHY).
_NOT_PORTED = {
    "DELTA_FETCH": (_env_bool, True, 8),
    "COMPILE_CACHE_PATH": (_env_str, "", 8),
    "PREWARM_ON_START": (_env_bool, False, 8),
    "RETRY_MAX_ATTEMPTS": (_env_int, 3, 8),
    "RETRY_BASE_DELAY": (_env_float, 0.2, 8),
    "RETRY_MAX_DELAY": (_env_float, 5.0, 8),
    "RETRY_BUDGET": (_env_int, 64, 8),
    "RETRY_BUDGET_WINDOW": (_env_float, 60.0, 8),
    "BREAKER_FAILURE_THRESHOLD": (_env_int, 5, 8),
    "BREAKER_RECOVERY_SECONDS": (_env_float, 30.0, 8),
}


def from_env(env=None) -> EngineConfig:
    """Build an EngineConfig from the ML_* env-var family. A knob of a
    layer the port has not taken over, set to anything but the reference's
    default, raises NotImplementedError naming its ROADMAP item; an LSTM
    width below 1 raises ValueError naming the knob."""
    env = dict(os.environ) if env is None else env
    policies = dict(DEFAULT_POLICIES)
    base = MetricPolicy(
        threshold=_env_float(env, "threshold", 2.0),
        bound=_env_int(env, "bound", 1),
        min_lower_bound=_env_float(env, "min_lower_bound", 0.0),
    )
    n = _env_int(env, "metric_type_threshold_count", 0)
    for i in range(n):
        name = env.get(f"metric_type{i}")
        if not name:
            continue
        policies[name] = MetricPolicy(
            threshold=_env_float(env, f"threshold{i}", base.threshold),
            bound=_env_int(env, f"bound{i}", base.bound),
            min_lower_bound=_env_float(env, f"min_lower_bound{i}", base.min_lower_bound),
            sla_limit=_env_float(env, f"sla_limit{i}", 0.0),
        )
    for key, (parse, default, item) in _NOT_PORTED.items():
        if parse(env, key, default) != default:
            raise NotImplementedError(f"{key}: {_NOT_PORTED_WHY[item]}")
    return EngineConfig(
        algorithm=env.get("ML_ALGORITHM", "moving_average_all"),
        pairwise_algorithm=env.get("ML_PAIRWISE_ALGORITHM", "mann_whitney_all"),
        pairwise_threshold=_env_float(env, "ML_PAIRWISE_THRESHOLD", 0.01),
        threshold=base.threshold,
        bound=base.bound,
        min_lower_bound=base.min_lower_bound,
        min_historical_points=_env_int(env, "MIN_HISTORICAL_DATA_POINT_TO_MEASURE", 10),
        min_mann_whitney_points=_env_int(env, "MIN_MANN_WHITE_DATA_POINTS", 20),
        min_wilcoxon_points=_env_int(env, "MIN_WILCOXON_DATA_POINTS", 20),
        min_kruskal_points=_env_int(env, "MIN_KRUSKAL_DATA_POINTS", 5),
        min_friedman_points=_env_int(env, "MIN_FRIEDMAN_DATA_POINTS", 5),
        max_stuck_seconds=_env_float(env, "MAX_STUCK_IN_SECONDS", 90.0),
        max_claim_per_cycle=_env_int(env, "MAX_CLAIM_PER_CYCLE", 100_000),
        score_batch=_env_int(env, "SCORE_BATCH", 8192),
        fetch_concurrency=_env_int(env, "FETCH_CONCURRENCY", 16),
        score_pipeline=_env_bool(env, "SCORE_PIPELINE", True),
        pipeline_fire_rows=_env_int(env, "PIPELINE_FIRE_ROWS", 1024),
        window_cache_max=_env_int(env, "WINDOW_CACHE_MAX", 8192),
        score_memo=_env_bool(env, "SCORE_MEMO", True),
        triage=_env_bool(env, "TRIAGE", True),
        triage_z=_env_float(env, "TRIAGE_Z", 8.0),
        triage_margin=_env_float(env, "TRIAGE_MARGIN", 0.25),
        triage_min_points=_env_int(env, "TRIAGE_MIN_POINTS", 24),
        triage_fire_rows=_env_int(env, "TRIAGE_FIRE_ROWS", 16384),
        triage_families=tuple(
            f.strip() for f in env.get("TRIAGE_FAMILIES", "band").split(",")
            if f.strip()
        ),
        megabatch=_env_bool(env, "MEGABATCH", False),
        megabatch_max_rows=_env_int(env, "MEGABATCH_MAX_ROWS", 32768),
        ma_window=_env_int(env, "MA_WINDOW", 30),
        long_window_steps=_env_int(env, "LONG_WINDOW_STEPS", 4096),
        hw_period=_env_int(env, "HW_PERIOD", 1440),
        hw_period_auto=_env_bool(env, "HW_PERIOD_AUTO", True),
        hw_period_candidates=tuple(
            int(p) for p in env.get("HW_PERIOD_CANDIDATES", "60,480,720,1440").split(",")
            if p.strip()
        ),
        hw_min_seasonal_acf=_env_float(env, "HW_MIN_SEASONAL_ACF", 0.2),
        hw_alias_margin=_env_float(env, "HW_ALIAS_MARGIN", 0.05),
        hw_contrast_margin=_env_float(env, "HW_CONTRAST_MARGIN", 0.01),
        st_order=_env_int(env, "ST_ORDER", 3),
        st_changepoints=_env_int(env, "ST_CHANGEPOINTS", 12),
        lstm_window=_env_int(env, "LSTM_WINDOW", 32),
        lstm_epochs=_env_int(env, "LSTM_EPOCHS", 30),
        lstm_hidden=_env_int(env, "LSTM_HIDDEN", 32),
        lstm_latent=_env_int(env, "LSTM_LATENT", 16),
        lstm_threshold=_env_float(env, "LSTM_THRESHOLD", 3.0),
        lstm_max_train_per_cycle=_env_int(env, "LSTM_MAX_TRAIN_PER_CYCLE", 8),
        max_cache_size=_env_int(env, "MAX_CACHE_SIZE", 1024),
        multimetric_auto=_env_bool(env, "ML_MULTIMETRIC_AUTO", True),
        sla_headroom_safe=_env_float(env, "SLA_HEADROOM_SAFE", 0.7),
        sla_mode=env.get("ML_SLA_MODE", "dynamic").strip().lower(),
        sla_limit=_env_float(env, "ML_SLA_LIMIT", 0.0),
        sla_limit_relative=_env_bool(env, "ML_SLA_LIMIT_RELATIVE", False),
        fetch_cycle_deadline_seconds=_env_float(env, "FETCH_CYCLE_DEADLINE", 8.0),
        cycle_deadline_seconds=_env_float(env, "CYCLE_DEADLINE_S", 0.0),
        max_stale_seconds=_env_float(env, "MAX_STALE_S", 300.0),
        quarantine_after=_env_int(env, "QUARANTINE_AFTER", 3),
        watchdog_seconds=_env_float(env, "WATCHDOG_S", 0.0),
        provenance=_env_bool(env, "PROVENANCE", True),
        flight_dump_dir=env.get("FLIGHT_DUMP_DIR", ""),
        slo_canary_seconds=_env_float(env, "SLO_CANARY_S", 30.0),
        slo_continuous_seconds=_env_float(env, "SLO_CONTINUOUS_S", 60.0),
        slo_hpa_seconds=_env_float(env, "SLO_HPA_S", 60.0),
        slo_objective=_env_float(env, "SLO_OBJECTIVE", 0.99),
        policies=policies,
    )
