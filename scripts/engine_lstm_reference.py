#!/usr/bin/env python3
"""Does the reference engine flag the same LSTM jobs as the port?

    JAX_PLATFORMS=cpu python scripts/engine_lstm_reference.py [--out FILE]

Runs chip_smoke.py's engine_lstm fleet (575 three-metric jobs over 32 apps,
made by chip_smoke.engine_lstm_fleet from numpy's default_rng(chip_smoke.SEED),
the fleet of `time_torch_kernels.py --engine-lstm-epochs`) through the
reference's Analyzer (foremast_tpu, JAX on the CPU, its
RawFixtureDataSource) and through the port's (foremast_tpu_torch with
device="cpu", the plain twins), both under the default EngineConfig, cycle
after cycle until one trains no model. Then it compares, job by job, the
verdict (z > lstm_threshold) and z, and stage by stage where they differ:
each app's trained parameter row (the cache entry), its normalizer (mu,
sigma), then z. It prints each arm's flag rates and the first stage that
differs, and writes the per-job z of both arms to FILE (npz).

Not part of the port: it imports both packages.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

MAX_CYCLES = 8


def _status(store):
    from foremast_tpu_torch.engine import jobs as J

    return {d.id: d.status for d in store.by_status(*J.OPEN_STATUSES, *J.TERMINAL_STATUSES)}


def reference_arm(fleet):
    """The fleet through the reference's Analyzer: the same loop as
    chip_smoke.engine_lstm_arm. Returns (status, z, cache, cycles)."""
    from foremast_tpu.dataplane.fetch import RawFixtureDataSource
    from foremast_tpu.engine import Analyzer, Document, EngineConfig, JobStore, MetricQueries

    store = JobStore()
    for d in fleet["docs"]():
        store.create(Document(
            id=d.id, app_name=d.app_name, namespace=d.namespace, strategy=d.strategy,
            start_time=d.start_time, end_time=d.end_time,
            metrics={k: MetricQueries(current=q.current, historical=q.historical)
                     for k, q in d.metrics.items()}))
    an = Analyzer(EngineConfig(), RawFixtureDataSource(fleet["pages"], keep_urls=False), store)
    zs = {}
    score_multi = an._score_multi

    def record(items):
        res = score_multi(items)
        for (jid, _m, _f), r in res.items():
            zs[jid] = float(r["z"])
        return res

    an._score_multi = record
    cycles = []
    for _ in range(MAX_CYCLES):
        t0 = time.perf_counter()
        an.run_cycle(worker="reference", now=fleet["now"])
        cycles.append({"wall_s": time.perf_counter() - t0,
                       "trained": an._lstm_trained_this_cycle,
                       "skips": len(an._lstm_budget_skipped_ids)})
        print(f"  reference cycle {len(cycles)}: {cycles[-1]}", flush=True)
        if an._lstm_trained_this_cycle == 0:
            break
    return _status(store), zs, dict(an._lstm_cache), cycles


def port_arm(fleet):
    """The fleet through the port's Analyzer on the CPU twins
    (chip_smoke.engine_lstm_arm). Returns (status, z, cycles)."""
    import chip_smoke as cs

    t0 = time.perf_counter()
    store, cycles, zs, _judged = cs.engine_lstm_arm(fleet, "cpu")
    for c, rec in enumerate(cycles):
        print(f"  port cycle {c + 1}: trained {rec['trained']}, skips {rec['skips']}, "
              f"{rec['wall_s']:.1f} s", flush=True)
    print(f"  port arm: {time.perf_counter() - t0:.1f} s", flush=True)
    return _status(store), {j: float(z) for j, z in zs.items()}, cycles


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "engine_lstm_reference.npz"))
    opt = ap.parse_args()
    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch

    import chip_smoke as cs
    from foremast_tpu_torch.engine import Analyzer as PortAnalyzer
    from foremast_tpu_torch.engine import EngineConfig
    from foremast_tpu_torch.engine import jobs as J
    from foremast_tpu_torch.models import lstm_ae as tl

    torch.set_num_threads(max(1, min(8, os.cpu_count() or 1)))
    fleet = cs.engine_lstm_fleet(np.random.default_rng(cs.SEED))
    anom = fleet["anomalous"]
    thr = EngineConfig().lstm_threshold

    # the port's arm keeps its analyzer's cache for the stage comparison
    caches = []
    init = PortAnalyzer.__init__

    def keep(self, *a, **kw):
        init(self, *a, **kw)
        caches.append(self)

    PortAnalyzer.__init__ = keep
    t0 = time.perf_counter()
    try:
        st_p, z_p, cyc_p = port_arm(fleet)
    finally:
        PortAnalyzer.__init__ = init
    cache_p = dict(caches[-1]._lstm_cache)
    t1 = time.perf_counter()
    st_r, z_r, cache_r, cyc_r = reference_arm(fleet)
    print(f"  port (CPU twins) {t1 - t0:.1f} s, reference (JAX, CPU) "
          f"{time.perf_counter() - t1:.1f} s", flush=True)

    def rates(status, name, cycles):
        healthy = [j for j in status if j not in anom]
        flagged = sum(status[j] == J.COMPLETED_UNHEALTH for j in healthy)
        caught = sum(status[j] == J.COMPLETED_UNHEALTH for j in anom)
        print(f"  {name}: healthy jobs flagged {flagged} of {len(healthy)} "
              f"({flagged / len(healthy):.4f}); anomalous flagged {caught} of {len(anom)}; "
              f"{len(cycles)} cycles", flush=True)
        return flagged / len(healthy), caught / max(len(anom), 1)

    fr_p, rc_p = rates(st_p, "port", cyc_p)
    fr_r, rc_r = rates(st_r, "reference", cyc_r)

    # stage 1: the trained rows, stage 2: the normalizers, per cache key
    keys = sorted(set(cache_p) & set(cache_r), key=str)
    d_row, d_mu, d_sd = [], [], []
    for k in keys:
        rp, mp, sp = cache_p[k][:3]
        rr, mr, sr = cache_r[k][:3]
        rr = tl.flat_params(tl.params_from_flax(jax.device_get(rr))).numpy()
        rp = rp.detach().cpu().numpy() if hasattr(rp, "detach") else np.asarray(rp)
        d_row.append(float(np.abs(rp - rr).max() / max(np.abs(rr).max(), 1e-30)))
        d_mu.append(abs(float(mp) - float(mr)) / max(abs(float(mr)), 1e-30))
        d_sd.append(abs(float(sp) - float(sr)) / max(abs(float(sr)), 1e-30))
    print(f"  cache keys: port {len(cache_p)}, reference {len(cache_r)}, shared {len(keys)}; "
          f"trained rows max relative |d| {max(d_row, default=0):.3g}; normalizer mu "
          f"{max(d_mu, default=0):.3g}, sigma {max(d_sd, default=0):.3g} relative", flush=True)

    # stage 3: z and the verdicts
    jobs = sorted(set(z_p) & set(z_r))
    dz = np.array([abs(z_p[j] - z_r[j]) for j in jobs])
    differ = [j for j in st_p if st_p[j] != st_r.get(j)]
    edge = [j for j in differ if min(abs(z_p.get(j, 0) - thr), abs(z_r.get(j, 0) - thr)) <= 1e-2]
    print(f"  z: {len(jobs)} jobs scored by both (port {len(z_p)}, reference {len(z_r)}); "
          f"max |d z| {dz.max() if dz.size else 0:.3g}, median {np.median(dz) if dz.size else 0:.3g}; "
          f"verdicts differ on {len(differ)} of {len(st_p)} jobs ({len(edge)} within 0.01 of "
          f"the threshold): {[(j, round(z_p.get(j, np.nan), 4), round(z_r.get(j, np.nan), 4)) for j in differ[:10]]}",
          flush=True)
    if differ or (dz.size and dz.max() > 1e-2):
        first = ("trained rows" if max(d_row, default=0) > 1e-3 else
                 "normalizer" if max(d_mu + d_sd, default=0) > 1e-3 else "z")
        print(f"  the first stage that differs: {first}", flush=True)
    else:
        print("  the port agrees with the reference job by job", flush=True)
    os.makedirs(os.path.dirname(opt.out), exist_ok=True)
    np.savez(opt.out, jobs=np.array(jobs), z_port=np.array([z_p[j] for j in jobs]),
             z_reference=np.array([z_r[j] for j in jobs]),
             rates=np.array([fr_p, rc_p, fr_r, rc_r]))
    print(f"  written {opt.out}", flush=True)


if __name__ == "__main__":
    main()
