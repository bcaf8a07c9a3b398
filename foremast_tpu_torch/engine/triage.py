"""Tier-0 triage gate: clear the boring rows before family scoring.

The port's copy of the reference's ``engine/triage.py``: the same gate,
rule and counters, with the screen on kernel G (``ops/triage.py``,
``csrc/triage.cu``) through the engine's pinned staging. The fingerprint
memo skips rows whose bytes didn't move; in a live steady fleet most rows DO move every cycle (one new sample) yet remain
unremarkable, and each still paid a full per-family device launch. The
gate composes directly after `CyclePipeline._memo_check`: memo skips
unchanged rows, this tier skips changed-but-unremarkable ones. Rows are
batched into the fused `ops.triage.screen_rows` program (one launch
shared by every screened family per T bucket, an order of magnitude
coarser than the family fire rungs because the screen is one cheap
pass), classified host-side as CLEAR or SUSPECT, and:

  * CLEAR rows short-circuit to a healthy result through the existing
    verdict machinery — the synthesized result dict is exactly what the
    family's collect would produce for a zero-violation row (count 0,
    first_ts -1, the screen's band means for the exported bounds), so
    folding, stale-state refresh, memoization and `/metrics` all behave
    identically; provenance tags the job `triaged` with the screen
    statistics vs thresholds.
  * SUSPECT rows flow unchanged into the family rung accumulators and
    are scored by the full path — escalation can never change a verdict,
    only cost a launch.

Verdict safety is by construction, not just by test:

  * the CLEAR rule for the band family requires the violation count of
    the policy band SHRUNK by `TRIAGE_MARGIN` sigmas to stay under the
    family's verdict gate, computed with the band scorer's own
    smoother/sigma math (see ops/triage.py for the one-sided dominance
    argument: shrunk count >= real count, so a sub-gate shrunk count
    implies the full scorer's count is sub-gate — healthy; in the port
    the screen's moving average and sigma are kernel B's to the bit) —
    and the band family is screened ONLY under `moving_average*`
    algorithms, where that replica argument holds. Seasonal/HW/SES bands
    always escalate.
  * canary-class jobs (anything not continuous/hpa) always escalate:
    their verdict gates a live rollout.
  * the hpa family always escalates — its per-cycle score and hpalog
    emission ARE the verdict; there is nothing sound to short-circuit.
  * pair and bivariate rows always escalate by default: rank-test
    p-values (pair) and ellipse correlation breaks (bivariate) are not
    bounded by any cheap marginal statistic, so the screen is not
    provably one-sided there. Opting them in via `TRIAGE_FAMILIES`
    TRADES VERDICT FIDELITY FOR LAUNCHES: a sustained sub-band
    distribution shift (e.g. a uniform ~1.5-sigma level drift stays
    inside the band and under TRIAGE_Z, yet a rank test over a full
    window condemns it) will be cleared that the full pair scorer would
    convict. Only for fleets where band-style violations are the signal
    of record; hpa opt-in is ignored.

The CLEAR/SUSPECT thresholds (`TRIAGE_Z`, `TRIAGE_MARGIN`,
`TRIAGE_MIN_POINTS`) are applied host-side from the kernel's outputs, so
threshold sweeps — including the verdict-safety sweep test — change no
launch.
"""
from __future__ import annotations

import time

import torch

from ..dataplane.promql import CONTINUOUS_STRATEGIES
from ..ops import triage as triage_ops
from ..ops.windowing import bucket_length
from .analyzer import _concat_trimmed, _put_row

__all__ = ["TriageGate", "screen_cap", "SCREENABLE_FAMILIES"]

# families the generic screen can represent as packed rows at all; hpa is
# deliberately absent (see module docstring), lstm never enters the
# accumulators in the first place
SCREENABLE_FAMILIES = ("pair", "band", "bivariate")

# memory budget for one screen launch, in row-steps: the row cap scales
# down for long T buckets so a 16k-row screen of 1k-step windows and a
# 1k-row screen of 16k-step windows cost the same peak bytes
_SCREEN_BUDGET_STEPS = 1024

# the screen's launch arguments, for the engine's pinned staging
_SCREEN_SPECS = (("x", torch.float32, "T"), ("mask", torch.bool, "T"),
                 ("region", torch.bool, "T"), ("threshold", torch.float32, None),
                 ("bound_mode", torch.int32, None), ("min_lower_bound", torch.float32, None),
                 ("margin", torch.float32, None))


def screen_cap(fire_rows: int, T: int) -> int:
    """Max rows per screen launch for a T bucket (memory-aware)."""
    fire_rows = max(int(fire_rows), 16)
    budget = fire_rows * _SCREEN_BUDGET_STEPS
    return int(min(fire_rows, max(budget // max(int(T), 1), 1024)))


class TriageGate:
    """One cycle's screen state. Single-threaded like CyclePipeline: fed
    from the ordered preprocess stream, so routing stays deterministic."""

    def __init__(self, analyzer):
        cfg = analyzer.config
        self.an = analyzer
        fams = set(cfg.triage_families) & set(SCREENABLE_FAMILIES)
        if not cfg.algorithm.startswith("moving_average"):
            # the one-sided replica argument only covers the MA band;
            # other forecasters' bands always take the full path
            fams.discard("band")
        self.families = frozenset(fams)
        self.z = float(cfg.triage_z)
        self.margin = float(cfg.triage_margin)
        self.min_points = int(cfg.triage_min_points)
        self.fire_rows = max(int(cfg.triage_fire_rows), 16)
        self.acc: dict[int, list] = {}        # screen T bucket -> [unit]
        self._rows_in: dict[int, int] = {}    # screen T bucket -> row count
        self.results: dict[str, dict] = {f: {} for f in SCREENABLE_FAMILIES}
        self.stats: dict = {}                 # result key -> screen stats
        self.job_hits: dict[str, int] = {}    # job -> cleared results
        self.screened: dict[str, int] = {}    # per-family row counts
        self.cleared: dict[str, int] = {}
        self.escalated: dict[str, int] = {}
        self.launches = 0
        self.seconds = 0.0

    @property
    def active(self) -> bool:
        return bool(self.families)

    def accepts(self, family: str, strategy: str) -> bool:
        """Does this (family, job-class) row enter the screen at all?"""
        return family in self.families and strategy in CONTINUOUS_STRATEGIES

    # --------------------------------------------------------------- feeding
    def add(self, family: str, fam_T: int, entry, pipe) -> None:
        """Route one accumulator entry into the screen; fire full buckets.

        Called inside `CyclePipeline.feed`'s per-item guard: a malformed
        entry raises out to the pipeline's per-job retry list, same blast
        radius as every scoring step."""
        unit = self._unit(family, fam_T, entry)
        T = unit["T"]
        self.acc.setdefault(T, []).append(unit)
        self._rows_in[T] = self._rows_in.get(T, 0) + len(unit["rows"])
        # counters are in ROWS (a bivariate unit is 2 channel rows) so the
        # exported "rows screened/cleared/escalated" totals stay honest
        self.screened[family] = (self.screened.get(family, 0)
                                 + len(unit["rows"]))
        if self._rows_in[T] >= screen_cap(self.fire_rows, T):
            units = self.acc[T]
            self.acc[T] = []
            self._rows_in[T] = 0
            self._fire(T, units, pipe)

    def flush(self, pipe) -> None:
        """Screen every remaining partial bucket (pipeline stream end)."""
        buckets, self.acc = self.acc, {}
        self._rows_in = {}
        for T, units in buckets.items():
            if units:
                self._fire(T, units, pipe)

    def _unit(self, family: str, fam_T: int, entry) -> dict:
        """One logical screen unit: 1 row (pair/band) or 2 channel rows
        (bivariate), in the exact packed layout the family scorer uses.
        `rows` entries are (values, mask, n_h, policy)."""
        if family == "band":
            it = entry
            vals, mask, n_h = _concat_trimmed(it.historical, it.current)
            rows = [(vals, mask, n_h, it.policy)]
            key = (it.job_id, it.metric, "band")
            T = fam_T  # _band_T buckets the same concat length
        elif family == "pair":
            it = entry
            vals, mask, n_h = _concat_trimmed(it.baseline, it.current)
            rows = [(vals, mask, n_h, it.policy)]
            key = (it.job_id, it.metric, "pair")
            T = bucket_length(vals.shape[0])
        else:  # bivariate: entry is (item, joint-grid prep)
            it, (x, m, n_h, _n_c) = entry
            rows = [(x[0], m[0], n_h, it.policies[0]),
                    (x[1], m[1], n_h, it.policies[1])]
            key = (it.job_id, "&".join(it.metrics), "bivariate")
            T = bucket_length(x.shape[1])
        return {"family": family, "fam_T": fam_T, "entry": entry,
                "key": key, "T": T, "rows": rows}

    # --------------------------------------------------------------- firing
    def _fire(self, T: int, units: list, pipe) -> None:
        t0 = time.perf_counter()
        rows = [(u, r) for u in units for r in u["rows"]]
        try:
            outs = self._screen(T, rows)
        except Exception:  # noqa: BLE001 - screen failure must never fail a
            # cycle: a wedged/hung screen (WatchdogTimeout included) or a
            # packing surprise escalates the whole bucket to the full
            # path, which carries its own watchdog + per-job isolation
            outs = None
        suspects: list = []
        if outs is None:
            suspects = units
        else:
            i = 0
            for u in units:
                u_outs = outs[i:i + len(u["rows"])]
                i += len(u["rows"])
                if all(self._row_clear(u["family"], o) for o in u_outs):
                    self._clear(u, u_outs)
                else:
                    suspects.append(u)
        # the triage clock stops BEFORE suspects route into the family
        # accumulators: pipe._add can fire full family rungs, and that
        # dispatch time belongs to the pipeline's dispatch stage — booking
        # it here would double-count it into foremastbrain:triage_seconds
        self.seconds += time.perf_counter() - t0
        for u in suspects:
            self._escalate(u, pipe)

    def _screen(self, T: int, rows: list) -> list[dict]:
        """Pack + launch kernel G (rung-chunked) through the engine's pinned
        staging, materialize under the analyzer's watchdog, return per-row
        output dicts."""
        an = self.an
        st = an.staging
        cap = screen_cap(self.fire_rows, T)
        window = an.config.ma_window
        out_rows: list[dict] = []
        for i in range(0, len(rows), cap):
            chunk = rows[i:i + cap]
            n = len(chunk)
            R = self._rung(n, cap)
            key = ("triage", T, R)
            slot = st.pack(key, _SCREEN_SPECS, R, T)
            h = slot.host
            # padding rows: empty (masked) rows, the reference's zero pack
            h["x"][n:] = 0.0
            h["mask"][n:] = False
            h["region"][n:] = False
            h["threshold"][n:] = 0.0
            h["bound_mode"][n:] = 1
            h["min_lower_bound"][n:] = 0.0
            h["margin"][:] = self.margin
            for j, (_, (vals, mask, n_h, pol)) in enumerate(chunk):
                _put_row(h["x"], h["mask"], j, vals, mask)
                h["region"][j] = False
                h["region"][j, n_h:vals.shape[0]] = True
                h["threshold"][j] = pol.threshold
                h["bound_mode"][j] = pol.bound
                h["min_lower_bound"][j] = pol.min_lower_bound
            an.device_launches += 1
            self.launches += 1
            with st.on_stream():
                d = st.to_device(slot)
                out = triage_ops.screen_rows(
                    d["x"], d["mask"], d["region"], d["threshold"], d["bound_mode"],
                    d["min_lower_bound"], d["margin"], window, device=an.device)

            def collect(o=out, m=n, k=key):
                # materialize straight to Python lists, real rows only: the
                # per-row classification below touches every field of every
                # row, and 10k+ boxed numpy scalar reads per cycle cost more
                # host time than the screen saves in launches
                st.begin_collect()
                with st.on_stream():
                    host = st.fetch(k, o)
                st.sync()
                return {f: v[:m].tolist() for f, v in host.items()}

            out = an._watchdog_call(collect)
            out_rows += [{k: out[k][j] for k in out} for j in range(n)]
        return out_rows

    def _rung(self, n: int, cap: int) -> int:
        """Smallest screen batch rung >= n (the family chunker's ladder
        walk, capped at the screen's own memory-aware cap)."""
        return type(self.an)._rung_for(n, cap)

    # ------------------------------------------------------- classification
    def _row_clear(self, family: str, o: dict) -> bool:
        """CLEAR iff the full path provably returns healthy for this row.

        The load-bearing check is `shrunk_count` vs the family's verdict
        gate: shrunk_count counts violations of the band NARROWED by
        `margin` sigmas, a superset of the real band's violations AND of
        any float-drift flips (a point the scorer's program could count
        differently sits within ulps of the real boundary, i.e. well
        outside the shrunk band), so shrunk_count below the gate implies
        the scorer's count is below the gate — healthy. Comparing against
        the gate rather than zero is what lets tight-threshold policies
        (a 2-sigma error band over ordinary noise always has a few
        outliers, which the scorer's gate exists to tolerate) still
        clear. The robust-z guard is escalation-only on top."""
        if int(o["n_hist"]) < self.min_points:
            return False  # too thin a floor: let the full path decide
        shrunk = int(o["shrunk_count"])
        checked = int(o["checked"])
        if family == "pair":
            # the pair kernel's internal band condemns at a fixed 0.3
            # violation fraction (parallel/fleet.py _pair_verdict)
            if shrunk > 0.3 * max(checked, 1):
                return False
        else:
            # band/bivariate gate: count >= max(band_min_points,
            # band_violation_fraction * checked) is unhealthy. A
            # non-positive gate (operator forced band_min_points to 0 on
            # an empty region) can never clear: 0 < 0 is false.
            if not shrunk < self.an._gate(checked):
                return False
        if float(o["robust_z"]) >= self.z:
            # defense-in-depth guard: suspicious, escalate. >= (not >) so
            # TRIAGE_Z=0 really does screen nothing — a constant series'
            # robust_z is exactly 0.0 and must escalate at z=0 too
            return False
        return True

    def _escalate(self, u: dict, pipe) -> None:
        self.escalated[u["family"]] = (self.escalated.get(u["family"], 0)
                                       + len(u["rows"]))
        pipe._add(u["family"], u["fam_T"], u["entry"])

    def _clear(self, u: dict, outs: list[dict]) -> None:
        family, key = u["family"], u["key"]
        o = outs[0]
        # synthesized healthy results: verdict-bearing fields (unhealthy,
        # count vs gate, exported bounds) match the full path; sub-gate
        # cosmetics the healthy fold never reads (first_ts/anomaly_pairs
        # of tolerated outliers, pair p-values) are zeroed
        if family == "pair":
            res = {"unhealthy": False, "min_p": 1.0,
                   "pairwise_unhealthy": False, "band_unhealthy": False,
                   "band_count": int(o["count"])}
        elif family == "band":
            res = {"count": int(o["count"]), "unhealthy": False,
                   "first_ts": -1.0,
                   "upper": float(o["upper_mean"]),
                   "lower": float(o["lower_mean"]),
                   "anomaly_pairs": []}
        else:
            it = u["entry"][0]
            res = {"count": 0, "unhealthy": False, "first_ts": -1.0,
                   "anomaly_pairs": [],
                   "bounds": {
                       it.metrics[0]: (float(outs[0]["upper_mean"]),
                                       float(outs[0]["lower_mean"])),
                       it.metrics[1]: (float(outs[1]["upper_mean"]),
                                       float(outs[1]["lower_mean"])),
                   }}
        self.results[family][key] = res
        self.stats[key] = {
            "triaged": True,
            "robust_z": round(max(float(x["robust_z"]) for x in outs), 4),
            "resid_z": round(max(float(x["resid_z"]) for x in outs), 4),
            "z_threshold": self.z,
            "margin": self.margin,
            "checked": sum(int(x["checked"]) for x in outs),
        }
        job_id = key[0]
        self.job_hits[job_id] = self.job_hits.get(job_id, 0) + 1
        self.cleared[family] = self.cleared.get(family, 0) + len(u["rows"])
