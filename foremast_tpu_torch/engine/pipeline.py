"""Bucket-granular scoring pipeline: stream, dispatch, collect.

The port's counterpart of the reference's ``engine/pipeline.py``. It turns
the cycle's chain of barriers into a pipeline at three levels:

  1. **streaming preprocess -> dispatch** — `Analyzer._run_cycle` feeds
     each job's preprocessed items into `CyclePipeline` the moment its
     fetch-pool chunk completes. Items route into per-family /
     per-T-bucket accumulators, and a launch is queued as soon as an
     accumulator fills a full batch rung (partials flush at stream end),
     so the card works on bucket N while bucket N+1 is fetched and packed.
  2. **queued launches** — launches go through the analyzer's `_launch_*`
     halves, which stage their inputs in pinned buffers, copy them to the
     card without blocking and queue the kernels on the engine's stream
     (``engine/staging.py``); nothing waits until the final collect phase.
  3. **a built kernel library + prewarm** — the CUDA kernels build once per
     source hash into ``build/foremast_tpu_torch/`` (``kernels/build.py``);
     ``kernels.build.builds`` counts builds, and `prewarm` builds the
     library and launches each kernel of the enabled families once. In
     steady state a cycle builds nothing.

Two contracts are preserved exactly:

  * **deterministic folding** — accumulators fill in claim order, fire at
    the same chunk boundaries the barriered `_score_*` would cut (full
    rungs mid-stream, rung-padded partials at flush), and results are keyed
    dicts folded in claim order, so verdicts are byte-identical to the
    sequential path regardless of completion order.
  * **`_isolate` blast radius** — a launch- or collect-time failure
    retries that group per JOB through the family's synchronous scorer, on
    the same device; only the offending jobs report errors, everyone
    else's results stand.
"""
from __future__ import annotations

import time

import torch

from ..kernels import build as kernel_build
from ..utils import tracing

__all__ = ["CyclePipeline", "prewarm"]


class CyclePipeline:
    """One engine cycle's streaming dispatch state. Not thread-safe by
    design: `feed` is called from the single consumer of the (ordered)
    preprocess stream, which is what keeps launches deterministic."""

    FAMILIES = ("pair", "band", "bivariate", "hpa")

    def __init__(self, analyzer):
        self.an = analyzer
        # fire threshold: an accumulator launches the moment it holds a
        # full batch rung, so device execution overlaps the remaining
        # fetches. Snapped to the rung ladder (and capped at the chunk
        # size) so streamed launches reuse the flush's staging shapes;
        # scorers are row-wise, so launch boundaries cannot change
        # verdicts (the determinism test pins pipeline == barriered).
        cap = max(16, analyzer.config.score_batch)
        fire = min(max(analyzer.config.pipeline_fire_rows, 16), cap)
        self.cap = analyzer._bucket_rows(fire)
        # single-dispatch mega-batching: accumulators hold the WHOLE
        # cycle's rows and flush as one padded launch per (family, T) at
        # finish — trading the mid-stream fetch/score overlap for launch
        # count, which is the winning trade once dispatch overhead
        # dominates. The fire threshold is the PER-T memory-aware
        # _mega_cap, not the global row ceiling, so a long-window bucket
        # never stages more rows than one launch takes. Firing at
        # _mega_cap(T) partitions rows exactly as the launch-time chunking
        # would (chunks of C + padded remainder), so launch counts and
        # verdicts are unchanged.
        self._mega = bool(analyzer.config.megabatch)
        self._mega_caps: dict = {}  # T -> analyzer._mega_cap(T)
        self.acc: dict = {f: {} for f in self.FAMILIES}  # family -> T -> []
        self.pending: list = []  # (family, entries, launch_state)
        self.failed: list = []   # (family, entries) awaiting per-job retry
        self.multis: list = []   # lstm items score at collect (train+cache)
        self.stage_seconds = {"dispatch": 0.0, "collect": 0.0}
        self.family_seconds: dict = {}
        self.launches = 0
        # device launches per family this cycle (from the analyzer's
        # device_launches delta around each _fire, so chunk-level splits
        # and the band family's period-detection launches count) — the
        # mega-batch "one launch per family per cycle" claim reads this
        self.family_launches: dict = {}
        # fingerprint score memo (SCORE_MEMO): unchanged rows resolve
        # straight from the analyzer's cross-cycle memo and never enter an
        # accumulator — buckets hold only changed rows, so steady-state
        # cycles fire fewer, smaller programs (and a no-change cycle fires
        # none at all). Routing/bucketing is unchanged for the rows that
        # do score, so launch boundaries — and verdicts — stay identical
        # to the memo-off path.
        self.memo = analyzer._score_memo if analyzer.config.score_memo \
            else None
        self.memo_results: dict = {f: {} for f in self.FAMILIES}
        # tier-0 triage gate (TRIAGE; engine/triage.py): composes after
        # the memo check — memo skips unchanged rows, triage screens the
        # changed-but-unremarkable ones in one fused kernel and
        # short-circuits CLEAR rows to synthesized healthy results;
        # SUSPECT rows fall through to the family accumulators unchanged.
        self.triage = None
        if analyzer.config.triage:
            from .triage import TriageGate

            gate = TriageGate(analyzer)
            if gate.active:
                self.triage = gate
        self.memo_hits: dict = {}  # family -> hits this cycle
        # provenance: which JOBS had items served from the memo this cycle
        # (job_id -> hit count) — lets /jobs/<id>/explain attribute a
        # verdict to the memo-hit path instead of a fresh device score
        self.memo_job_hits: dict = {}
        self._fps: dict = {}       # (family, result_key) -> fingerprint

    def _memo_check(self, family: str, entry, T: int) -> bool:
        """True when this entry's verdict was served from the memo."""
        if self.memo is None:
            return False
        key, fp = self.an._memo_key_fp(family, entry, T)
        hit = self.memo.get((family, key))
        if hit is not None and hit[0] == fp:
            self.memo.move_to_end((family, key))
            self.memo_results[family][key] = hit[1]
            self.memo_hits[family] = self.memo_hits.get(family, 0) + 1
            self.an.score_memo_hits[family] = (
                self.an.score_memo_hits.get(family, 0) + 1)
            job_id = key[0] if isinstance(key, tuple) else key
            self.memo_job_hits[job_id] = self.memo_job_hits.get(job_id, 0) + 1
            return True
        self._fps[(family, key)] = fp
        self.an.score_memo_misses[family] = (
            self.an.score_memo_misses.get(family, 0) + 1)
        return False

    # ------------------------------------------------------------- feeding
    def feed(self, pairs, bands, bis, multis, hpas, strategy: str = ""):
        """Route one job's preprocessed items (claim order) into the
        accumulators; launch any bucket that filled its rung.

        `strategy` is the owning job's strategy: the triage gate screens
        only steady-state (continuous/hpa-class) jobs — canary-class
        verdicts gate live rollouts and always take the full path.

        Routing (bucket keys, joint-grid prep, hpa row building, triage
        screening) is guarded per item like every scoring step: a
        malformed item lands in the per-job retry list instead of
        aborting the whole cycle — the `_isolate` blast-radius contract
        starts here, not at launch.
        """
        an = self.an
        tg = self.triage
        self.multis += multis
        for it in pairs:
            try:
                T = an._pair_T(it)
                if not self._memo_check("pair", it, T):
                    if tg is not None and tg.accepts("pair", strategy):
                        tg.add("pair", T, it, self)
                    else:
                        self._add("pair", T, it)
            except Exception:  # noqa: BLE001 - retried per job at collect
                self.failed.append(("pair", [it]))
        for it in bands:
            try:
                T = an._band_T(it)
                if not self._memo_check("band", it, T):
                    if tg is not None and tg.accepts("band", strategy):
                        tg.add("band", T, it, self)
                    else:
                        self._add("band", T, it)
            except Exception:  # noqa: BLE001
                self.failed.append(("band", [it]))
        for it in bis:
            try:
                pre, T = an._bi_prep(it)
                if not self._memo_check("bivariate", (it, pre), T):
                    if tg is not None and tg.accepts("bivariate", strategy):
                        tg.add("bivariate", T, (it, pre), self)
                    else:
                        self._add("bivariate", T, (it, pre))
            except Exception:  # noqa: BLE001
                self.failed.append(("bivariate", [it]))
        if hpas:
            try:
                rows = an._hpa_rows(hpas)
            except Exception:  # noqa: BLE001
                self.failed.append(("hpa", list(hpas)))
                rows = []
            for row in rows:
                try:
                    T = an._hpa_row_T(row)
                    if not self._memo_check("hpa", row, T):
                        self._add("hpa", T, row)
                except Exception:  # noqa: BLE001
                    self.failed.append(("hpa", [row]))

    def _add(self, family: str, T: int, entry):
        bucket = self.acc[family].setdefault(T, [])
        bucket.append(entry)
        if self._mega:
            cap = self._mega_caps.get(T)
            if cap is None:
                cap = self._mega_caps[T] = self.an._mega_cap(T)
        else:
            cap = self.cap
        if len(bucket) >= cap:
            self.acc[family][T] = []
            self._fire(family, T, bucket)

    def _fire(self, family: str, T: int, entries: list):
        t0 = time.perf_counter()
        d0 = self.an.device_launches
        try:
            if family == "pair":
                st = self.an._launch_pairs(entries, T)
            elif family == "band":
                st = self.an._launch_bands(entries, T)
            elif family == "bivariate":
                st = self.an._launch_bivariate(entries, T)
            else:
                st = self.an._launch_hpa(entries, T)
            self.pending.append((family, entries, st))
        except Exception:  # noqa: BLE001 - blast radius: retry per job later
            self.failed.append((family, entries))
        dt = time.perf_counter() - t0
        self.stage_seconds["dispatch"] += dt
        self.family_seconds[family] = self.family_seconds.get(family, 0.0) + dt
        self.launches += 1
        self.family_launches[family] = (
            self.family_launches.get(family, 0)
            + (self.an.device_launches - d0))

    @staticmethod
    def _entry_items(entries: list) -> list:
        """Flatten accumulator entries back to scorer items (for the
        per-job retry path): pair/band entries ARE items, bivariate
        entries are (item, prep), hpa entries are (job_id, tps, sla)."""
        items = []
        for e in entries:
            if hasattr(e, "job_id"):
                items.append(e)
            elif len(e) == 2:
                items.append(e[0])
            else:
                items.append(e[1])
                if e[2] is not e[1]:
                    items.append(e[2])
        return items

    # ----------------------------------------------------------- collecting
    def finish(self):
        """Flush partial buckets, materialize every launch, retry failures
        per job, and score the lstm family. Returns
        (pair_res, band_res, bi_res, multi_res, hpa_res, scoring_failed)."""
        an = self.an
        if self.triage is not None:
            # screen the remaining partial triage buckets FIRST: suspects
            # route into the family accumulators below and flush with
            # everyone else; cleared rows land in triage.results
            self.triage.flush(self)
        for family in self.FAMILIES:
            buckets, self.acc[family] = self.acc[family], {}
            for T, bucket in buckets.items():
                if bucket:
                    self._fire(family, T, bucket)
        results: dict = {f: {} for f in self.FAMILIES}
        bad: dict = {}
        collect = {"pair": an._collect_pairs, "band": an._collect_bands,
                   "bivariate": an._collect_bivariate, "hpa": an._collect_hpa}
        sync = {"pair": an._score_pairs, "band": an._score_bands,
                "bivariate": an._score_bivariate, "hpa": an._score_hpa}
        from .analyzer import WatchdogTimeout

        t0 = time.perf_counter()
        # Hung-launch watchdog budget: each materialization (and each
        # per-job retry below) runs under WATCHDOG_S (no-op when 0), and
        # the cycle pays for at most TWO timeouts total. One timeout can
        # be a single poisoned program; a second — from another bucket or
        # from a fresh sync retry — is device-level evidence, after which
        # every remaining watchdog-guarded wait is skipped instantly
        # (buckets fall through to the requeue path). Without the cap, a
        # wedged device would serialize one full WATCHDOG_S per pending
        # bucket plus one per retried job into a single cycle.
        wd0 = an.watchdog_fires_total

        def wedged() -> bool:
            return an.watchdog_fires_total - wd0 >= 2

        # materialize in launch order: completion order is the device's
        # business; claim-order folding happens downstream off keyed dicts
        for family, entries, st in self.pending:
            t1 = time.perf_counter()
            try:
                if wedged():
                    raise WatchdogTimeout(
                        "device wedged (2+ watchdog timeouts this cycle); "
                        "bucket skipped")
                results[family].update(an._watchdog_call(collect[family], st))
            except Exception:  # noqa: BLE001 - deferred device error
                self.failed.append((family, entries))
            dt = time.perf_counter() - t1
            self.family_seconds[family] = (
                self.family_seconds.get(family, 0.0) + dt)
        # blast-radius fallback: a failed group retries per JOB through the
        # family's synchronous scorer (same launch/collect code, barriered;
        # watchdog-bounded under the same two-timeout cycle budget)
        for family, entries in self.failed:
            by_job: dict[str, list] = {}
            for it in self._entry_items(entries):
                by_job.setdefault(it.job_id, []).append(it)
            for job_id, group in by_job.items():
                if wedged():
                    bad[job_id] = ("WatchdogTimeout: device wedged "
                                   "(2+ watchdog timeouts this cycle); "
                                   "retry skipped")
                    continue
                try:
                    results[family].update(
                        an._watchdog_call(sync[family], group))
                except Exception as e:  # noqa: BLE001
                    bad[job_id] = f"{type(e).__name__}: {e}"
        if self.triage is not None:
            # fold triage-cleared rows in BEFORE memoization: a cleared
            # row's synthesized result is the healthy result the scorer
            # would have produced, so memoizing it keeps the steady chain
            # (unchanged next cycle -> memo hit, no re-screen)
            for family, cleared in self.triage.results.items():
                results[family].update(cleared)
        if self.memo is not None:
            # memoize every freshly scored verdict (collect + retries) for
            # the next cycle, then fold the memo-served ones back in
            for family in self.FAMILIES:
                for key, res in results[family].items():
                    fp = self._fps.get((family, key))
                    if fp is not None:
                        an._memo_put(self.memo, (family, key), (fp, res))
                results[family].update(self.memo_results[family])
        # lstm scores here, not in the stream: training mutates the model
        # cache under a per-cycle budget whose order must match claim order
        with tracing.span(tracing.SCORE_SPANS["lstm"], n=len(self.multis)) as lsp:
            t1 = time.perf_counter()
            multi_res, multi_bad = an._isolate(an._score_multi, self.multis)
            lsp.attrs["budget_skips"] = len(an._lstm_budget_skipped_ids)
            self.family_seconds["lstm"] = time.perf_counter() - t1
        # collect = everything after the stream: device wait + merge +
        # retries + the lstm family — the same work the barriered mode
        # books under collect, so SCORE_PIPELINE A/Bs compare like stages
        self.stage_seconds["collect"] += time.perf_counter() - t0
        bad.update(multi_bad)
        return (results["pair"], results["band"], results["bivariate"],
                multi_res, results["hpa"], bad)


# ---------------------------------------------------------------- prewarm
def prewarm(config=None, families=("pair", "band", "bivariate", "hpa", "triage"),
            device=None) -> dict:
    """Build the kernel library and launch each kernel of the enabled
    families once, at a small shape, through the real entry points — so the
    first live cycle neither builds nor pays a first launch. Returns the
    families, builds of the kernel library (``kernels.build.builds``, the
    counterpart of the reference's XLA compile count), launches and
    seconds."""
    from .. import kernels
    from .._device import resolve_device
    from ..ops import bivariate as bv
    from ..ops import forecast as fc
    from ..ops import hpa as hpa_ops
    from ..ops import triage as triage_ops
    from ..parallel import fleet as fl
    from .config import EngineConfig, from_env

    cfg = config if config is not None else from_env()
    if not isinstance(cfg, EngineConfig):
        raise TypeError(f"prewarm wants an EngineConfig, got {type(cfg)!r}")
    dev = resolve_device(device)
    t0 = time.perf_counter()
    before = dict(kernels.launches)
    builds = kernel_build.builds
    if dev.type == "cuda":
        kernel_build.library()
    T = 64
    if "pair" in families:
        fl.score_pairs(*fl.pair_arg_spec(16, T), device=dev)
    x, m, region, thr, bnd, mlb, mg = triage_ops.triage_arg_spec(16, T)
    m[:] = True
    region[:, T // 2:] = True
    if "band" in families:
        fc.forecast_band(x, m, region, thr, bnd, mlb, algorithm=cfg.algorithm,
                         ma_window=cfg.ma_window, st_order=cfg.st_order,
                         st_changepoints=cfg.st_changepoints, device=dev)
    if "bivariate" in families:
        bv.bivariate_rows(x, m, x, m, region, thr, mlb, mlb, bnd, bnd, device=dev)
    if "hpa" in families:
        # the engine's HPA launch: kernel C's SES, then kernel I
        xt, mt, rt, tt = (torch.from_numpy(a).to(dev) for a in (x, m, region, thr))
        preds = fc.ses_predictions(xt, mt & ~rt, 0.3, device=dev)
        mode = torch.full((16,), hpa_ops.SLA_DYNAMIC, dtype=torch.int32, device=dev)
        hpa_ops.hpa_from_preds(xt, mt, rt, preds, xt, mt, tt, mode, tt, device=dev)
    if "triage" in families:
        triage_ops.screen_rows(x, m, region, thr, bnd, mlb, mg, cfg.ma_window, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {
        "families": list(families),
        "builds": kernel_build.builds - builds,
        "launches": {k: v - before[k] for k, v in kernels.launches.items() if v > before[k]},
        "seconds": round(time.perf_counter() - t0, 3),
    }
