#!/usr/bin/env python3
"""Which shifted rows does seasonal_trend miss, and does the reference miss them too?

    python scripts/seasonal_misses.py card [--out chiprun_out/seasonal_misses.npz]
    python scripts/seasonal_misses.py reference [--inp chiprun_out/seasonal_misses.npz]

`card` (on a machine with the card) makes chip_smoke.season_inputs' 100,000
rows of bucket 16384 from a generator seeded with chip_smoke.SEED, runs the
port's forecast_band under seasonal_trend on the card, and keeps every
shifted row it does not flag, with the first 50 shifted rows it does flag,
in an npz: the rows, the port's period / count / checked / sigma on them and
the flag gate of chip_smoke's seasonal phase.

`reference` (on the CPU, with JAX) runs the reference engine's band launch
under seasonal_trend (Analyzer._detect_periods, Analyzer._predict,
residual_sigma, band_anomalies, rows partitioned by period, as
tests/test_torch_forecast_band.py drives it) and the port's twin
(device="cpu") on the kept rows, and prints which of them each flags.
"""
from __future__ import annotations

import argparse
import os
import sys
import types

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
DEFAULT = os.path.join(REPO, "chiprun_out", "seasonal_misses.npz")
CAUGHT_KEPT = 50


def flagged(count, checked, fraction, min_points):
    return count >= np.maximum(fraction * checked, min_points)


def card(out: str) -> None:
    import torch

    import chip_smoke as cs
    from foremast_tpu_torch.ops import forecast as fc

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED)
    args, kind, shifted = cs.season_inputs(gen)
    res = fc.forecast_band(*args, algorithm="seasonal_trend", device="cuda")
    torch.cuda.synchronize()
    count, checked = res["count"].cpu().numpy(), res["checked"].cpu().numpy()
    flag = flagged(count.astype(np.float32), checked.astype(np.float32),
                   np.float32(cs.BAND_VIOLATION_FRACTION), cs.BAND_MIN_POINTS)
    sh = shifted.cpu().numpy()
    missed = np.nonzero(sh & ~flag)[0]
    caught = np.nonzero(sh & flag)[0][:CAUGHT_KEPT]
    keep = np.concatenate([missed, caught])
    idx = torch.from_numpy(keep).cuda()
    x, mask, region, thr, mode, mlb = (a[idx].cpu().numpy() for a in args)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    np.savez_compressed(
        out, rows=keep, n_missed=len(missed), n_shifted=int(sh.sum()), x=x, mask=mask,
        region=region, thr=thr, mode=mode, mlb=mlb, kind=kind[idx].cpu().numpy(),
        period=res["period"][idx].cpu().numpy(), count=count[keep], checked=checked[keep],
        sigma=res["sigma"][idx].cpu().numpy(), fraction=cs.BAND_VIOLATION_FRACTION,
        min_points=cs.BAND_MIN_POINTS, device=torch.cuda.get_device_name(0))
    print(f"{torch.cuda.get_device_name(0)}: {len(missed)} of {int(sh.sum())} shifted rows "
          f"missed by seasonal_trend on the card; kept them and {len(caught)} caught rows "
          f"in {out}", flush=True)


def reference_band(x, m, region, thr, mode, mlb, algorithm="seasonal_trend"):
    """The reference engine's band launch under `algorithm`: (count, checked,
    period) per row."""
    from foremast_tpu.engine.analyzer import Analyzer
    from foremast_tpu.engine.config import EngineConfig
    from foremast_tpu.ops import forecast as jfc

    fake = types.SimpleNamespace(config=EngineConfig(algorithm=algorithm))
    fake._needs_period = lambda: Analyzer._needs_period(fake)
    fake._score_chunks = lambda fn, arrays: {k: np.asarray(v) for k, v in fn(*arrays).items()}
    T = x.shape[1]
    chosen = Analyzer._detect_periods(fake, x, m, region)
    count = np.zeros(x.shape[0], np.int64)
    checked = np.zeros(x.shape[0], np.int64)
    for p in np.unique(chosen):
        idx = np.nonzero(chosen == p)[0]
        xv, xm, reg = x[idx], m[idx], region[idx]
        preds, hist = Analyzer._predict(fake, xv, xm, reg, T, period_override=int(p))
        sigma = np.asarray(jfc.residual_sigma(xv, preds, hist, ~reg))
        out = jfc.band_anomalies(xv, xm, reg, preds, sigma, thr[idx], mode[idx], mlb[idx])
        count[idx], checked[idx] = np.asarray(out["count"]), np.asarray(out["checked"])
    return count, checked, np.asarray(chosen)


def reference(inp: str) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from foremast_tpu_torch.ops import forecast as fc

    d = np.load(inp)
    n_missed = int(d["n_missed"])
    args = tuple(d[k] for k in ("x", "mask", "region", "thr", "mode", "mlb"))
    rc, rchk, rper = reference_band(*args)
    twin = fc.forecast_band(*args, algorithm="seasonal_trend", device="cpu")
    tc, tchk = twin["count"].numpy(), twin["checked"].numpy()
    frac, mp = np.float32(d["fraction"]), int(d["min_points"])
    ref_flag = flagged(rc.astype(np.float32), rchk.astype(np.float32), frac, mp)
    twin_flag = flagged(tc.astype(np.float32), tchk.astype(np.float32), frac, mp)
    card_flag = flagged(d["count"].astype(np.float32), d["checked"].astype(np.float32), frac, mp)
    miss = slice(0, n_missed)
    caught = slice(n_missed, None)
    print(f"rows from {d['device']}: {n_missed} of {int(d['n_shifted'])} shifted rows "
          f"missed on the card; {len(d['rows']) - n_missed} caught rows beside them")
    for name, f in (("card", card_flag), ("port's twin (CPU)", twin_flag),
                    ("reference (CPU)", ref_flag)):
        print(f"  {name}: flags {int(f[miss].sum())} of the {n_missed} missed rows and "
              f"{int(f[caught].sum())} of the {len(d['rows']) - n_missed} caught rows")
    print(f"  periods: reference equal to the card's on {int((rper == d['period']).sum())} of "
          f"{len(rper)} rows; counts equal on {int((rc == d['count']).sum())}")
    for i in range(n_missed):
        print(f"  row {int(d['rows'][i])}: kind {int(d['kind'][i])}, period card "
              f"{int(d['period'][i])} / reference {int(rper[i])}, count card "
              f"{int(d['count'][i])} / twin {int(tc[i])} / reference {int(rc[i])} of "
              f"{int(d['checked'][i])} checked")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("mode", choices=("card", "reference"))
    ap.add_argument("--out", default=DEFAULT)
    ap.add_argument("--inp", default=DEFAULT)
    a = ap.parse_args()
    if a.mode == "card":
        card(a.out)
    else:
        reference(a.inp)
    return 0


if __name__ == "__main__":
    sys.exit(main())
