"""Kernel G's plain twin (foremast_tpu_torch.ops.triage.screen_rows_plain)
against the reference's JAX screen_rows and against a float64 numpy
reference, on the CPU.

Tolerances: integer outputs exact, except rows with a point within float
noise of a band edge, bracketed as tests/test_triage.py brackets them (the
band edges moved by 1e-3 of the band's scale); float statistics to rtol
2e-3, the tolerances used there. The reference's float32 moving average
leaves a constant history a sigma of float noise (ROADMAP queue 3): rows
whose reference sigma is under 1e-5 of the row's scale are bracketed as that
known fault, and the port must keep sigma exactly 0 on them.
"""
import jax
import numpy as np
import pytest
import torch

from foremast_tpu.ops import triage as jax_triage
from foremast_tpu_torch import kernels
from foremast_tpu_torch.engine.triage import TriageGate, screen_cap
from foremast_tpu_torch.ops import triage as tr

jax.config.update("jax_platforms", "cpu")

SEED = 20261017
WINDOW = 30
MARGIN = 0.25


# ---------------------------------------------------------------------------
# a float64 numpy reference of the screen (a copy of tests/test_triage.py's
# independent loop implementation, not imported)
# ---------------------------------------------------------------------------
def _ref_ma_preds(x, mask, window):
    """Causal rolling mean over the valid points of the last `window` time
    slots; undefined slots freeze at the rolling mean evaluated just after
    the most recent observation (slots before the first observation see
    the first valid value), by loop."""
    T = x.shape[0]
    x = x.astype(np.float32)
    ma = np.full(T, np.nan, np.float32)
    for t in range(T):
        lo = max(t - window, 0)
        sel = mask[lo:t]
        if sel.any():
            ma[t] = np.float32(x[lo:t][sel].mean())
    first = np.float32(x[mask][0]) if mask.any() else x[0]
    preds = np.empty(T, np.float32)
    hold = np.nan
    prev = -1  # last valid index <= t-1
    for t in range(T):
        if t == 0 or mask[t - 1]:
            hold = ma[t]
        if not np.isnan(ma[t]):
            preds[t] = ma[t]
        else:
            preds[t] = hold if prev >= 0 else first
        if mask[t]:
            prev = t
    return preds


def _ref_screen(x, mask, region, thr, bound, mlb, margin, window):
    """Reference screen statistics for one row (float64 reductions)."""
    x = x.astype(np.float32)
    hist = mask & ~region
    checked = mask & region
    n_h = int(hist.sum())
    preds = _ref_ma_preds(x, hist, window)
    r = np.where(hist, x - preds, 0.0).astype(np.float64)
    sigma = float(np.sqrt((r ** 2).sum() / max(n_h, 1)))
    if n_h < 2:
        sigma = float("inf")
    mode = bound if bound != 0 else 3

    def band(width_sigmas, eps=0.0):
        with np.errstate(invalid="ignore"):
            w = width_sigmas * sigma
            upper = preds + w + eps
            lower = np.maximum(preds - w, mlb) - eps
            viol = ((x > upper) & bool(mode & 1)) | (
                (x < lower) & bool(mode & 2))
        return int((viol & checked).sum()), upper, lower

    count, upper, lower = band(thr)
    dev = np.abs(x - preds)
    resid_z = float(np.where(checked, dev, 0.0).max()
                    / max(sigma, 1e-30)) if np.isfinite(sigma) else 0.0
    hv = np.sort(x[hist].astype(np.float64))
    if n_h:
        med = 0.5 * (hv[(n_h - 1) // 2] + hv[n_h // 2])
        ad = np.sort(np.abs(x[hist].astype(np.float64) - med))
        mad = 0.5 * (ad[(n_h - 1) // 2] + ad[n_h // 2])
        scale = max(1.4826 * mad, sigma if np.isfinite(sigma) else 0.0)
        robust_z = float(np.where(checked, np.abs(x - med), 0.0).max()
                         / max(scale, 1e-30))
    else:
        robust_z = 0.0
    n_r = max(int(region.sum()), 1)
    return {
        "count": count,
        "checked": int(checked.sum()),
        "n_hist": n_h,
        "sigma": sigma,
        "resid_z": resid_z,
        "robust_z": robust_z,
        "upper_mean": float(np.where(region, upper, 0.0).sum() / n_r),
        "lower_mean": float(np.where(region, lower, 0.0).sum() / n_r),
        "band": band,
        "thr": thr,
    }


def _rand_row(rng, T):
    """One randomized packed row: varied level/noise, gaps, NaN runs at
    masked slots, occasional quantized (integer) or constant series, and
    occasionally a too-short history (tests/test_triage.py's generator)."""
    kind = rng.integers(0, 5)
    level = float(rng.uniform(0.5, 100.0))
    noise = float(rng.uniform(0.01, 0.3)) * level
    x = rng.normal(level, noise, T).astype(np.float32)
    if kind == 1:
        x = np.round(x).astype(np.float32)
    elif kind == 2:
        x = np.full(T, np.float32(level))
    mask = rng.random(T) > 0.12
    if kind == 3:
        run = slice(T // 4, T // 4 + max(T // 8, 1))
        x[run] = np.nan
        mask[run] = False
    L = T if kind != 4 else int(rng.integers(3, max(T // 8, 4)))
    mask[L:] = False
    x[~mask] = np.where(rng.random((~mask).sum()) < 0.3, np.nan,
                        0.0).astype(np.float32)
    n_h = int(L * rng.uniform(0.5, 0.9))
    region = np.zeros(T, bool)
    region[n_h:L] = True
    thr = float(rng.choice([2.0, 3.0, 5.0, 10.0]))
    bound = int(rng.choice([0, 1, 2, 3]))
    mlb = float(rng.choice([0.0, 0.0, level * 0.5]))
    return x, mask, region, thr, bound, mlb


def _batch(rng, T, B=16):
    rows = [_rand_row(rng, T) for _ in range(B)]
    return (np.stack([r[0] for r in rows]), np.stack([r[1] for r in rows]),
            np.stack([r[2] for r in rows]), np.asarray([r[3] for r in rows], np.float32),
            np.asarray([r[4] for r in rows], np.int32), np.asarray([r[5] for r in rows], np.float32),
            np.full(B, MARGIN, np.float32))


def _port(args):
    out = tr.screen_rows(*args, WINDOW, device="cpu")
    return {k: v.numpy() for k, v in out.items()}


def _jax(args):
    return {k: np.asarray(v) for k, v in jax_triage.screen_rows(*args, WINDOW).items()}


def _bracket(ref, width):
    eps = 1e-3 * max(abs(ref["upper_mean"]), abs(ref["lower_mean"]), 1e-3)
    lo, _, _ = ref["band"](width, eps)
    hi, _, _ = ref["band"](width, -eps)
    return lo, hi


def _ref_constant(ref) -> bool:
    scale = max(abs(ref["upper_mean"]), abs(ref["lower_mean"]), 1.0)
    return np.isfinite(ref["sigma"]) and ref["sigma"] <= 1e-5 * scale


@pytest.mark.parametrize("T", [32, 64, 128, 1024])
def test_twin_matches_jax_screen_rows(T):
    rng = np.random.default_rng(SEED + T)
    args = _batch(rng, T, 24 if T < 1024 else 12)
    port, ref_jax = _port(args), _jax(args)
    bracketed = 0
    for i in range(args[0].shape[0]):
        ctx = f"T={T} row {i}"
        ref = _ref_screen(args[0][i], args[1][i], args[2][i], float(args[3][i]),
                          int(args[4][i]), float(args[5][i]), MARGIN, WINDOW)
        for k in ("checked", "n_hist"):
            assert port[k][i] == ref_jax[k][i], ctx
        if ref["n_hist"] == 0:
            continue  # unscreenable either way (the min-points floor)
        jax_sigma = float(ref_jax["sigma"][i])
        scale = max(abs(ref["upper_mean"]), abs(ref["lower_mean"]), 1.0)
        if np.isfinite(jax_sigma) and jax_sigma <= 1e-5 * scale:
            # the reference's constant-history fault: the port keeps 0
            bracketed += 1
            assert port["sigma"][i] <= 1e-5 * scale, ctx
            continue
        for k, width in (("count", ref["thr"]), ("shrunk_count", ref["thr"] - MARGIN)):
            if port[k][i] != ref_jax[k][i]:
                lo, hi = _bracket(ref, width)
                assert lo <= port[k][i] <= hi and lo <= ref_jax[k][i] <= hi, ctx
                bracketed += 1
        assert port["shrunk_count"][i] >= port["count"][i], ctx
        if np.isfinite(jax_sigma):
            np.testing.assert_allclose(port["sigma"][i], jax_sigma, rtol=2e-3, atol=1e-5,
                                       err_msg=ctx)
            np.testing.assert_allclose(port["resid_z"][i], ref_jax["resid_z"][i], rtol=2e-3,
                                       atol=1e-4, err_msg=ctx)
            btol = 5e-3 * (ref["thr"] * ref["sigma"] + abs(ref["upper_mean"])) + 1e-4
            for k in ("upper_mean", "lower_mean"):
                assert abs(port[k][i] - ref_jax[k][i]) <= btol, ctx
        else:
            assert not np.isfinite(port["sigma"][i]), ctx
        if ref_jax["robust_z"][i] < 1e6:
            np.testing.assert_allclose(port["robust_z"][i], ref_jax["robust_z"][i], rtol=2e-3,
                                       atol=1e-4, err_msg=ctx)
    assert bracketed <= args[0].shape[0] // 2


@pytest.mark.parametrize("round_i", range(8))
def test_twin_passes_the_numpy_reference_checks(round_i):
    """The checks of tests/test_triage.py's property test, sigma check
    included, held to the port's twin: a constant history keeps sigma 0
    here, where the reference's float32 algebra leaves float noise."""
    rng = np.random.default_rng(SEED * 10 + round_i)
    T = int(rng.choice([32, 64, 128]))
    args = _batch(rng, T)
    out = _port(args)
    for i in range(args[0].shape[0]):
        ref = _ref_screen(args[0][i], args[1][i], args[2][i], float(args[3][i]),
                          int(args[4][i]), float(args[5][i]), MARGIN, WINDOW)
        ctx = f"round {round_i} row {i}"
        assert int(out["checked"][i]) == ref["checked"], ctx
        assert int(out["n_hist"][i]) == ref["n_hist"], ctx
        for k in ("count", "shrunk_count", "robust_z", "resid_z"):
            assert not np.isnan(float(out[k][i])), f"{ctx}: {k} NaN"
        if ref["n_hist"] == 0:
            continue
        sg = float(out["sigma"][i])
        if np.isfinite(ref["sigma"]):
            np.testing.assert_allclose(sg, ref["sigma"], rtol=2e-3, atol=1e-5, err_msg=ctx)
        else:
            assert not np.isfinite(sg), ctx
        lo, hi = _bracket(ref, ref["thr"])
        assert lo <= int(out["count"][i]) <= hi, ctx
        s_lo, s_hi = _bracket(ref, ref["thr"] - MARGIN)
        assert s_lo <= int(out["shrunk_count"][i]) <= s_hi, ctx
        assert int(out["shrunk_count"][i]) >= int(out["count"][i]), ctx
        scale = max(abs(ref["upper_mean"]), abs(ref["lower_mean"]), 1.0)
        if np.isfinite(ref["sigma"]) and ref["sigma"] > 1e-5 * scale:
            np.testing.assert_allclose(float(out["resid_z"][i]), ref["resid_z"], rtol=2e-3,
                                       atol=1e-4, err_msg=ctx)
            btol = 5e-3 * (ref["thr"] * ref["sigma"] + abs(ref["upper_mean"])) + 1e-4
            assert abs(float(out["upper_mean"][i]) - ref["upper_mean"]) <= btol, ctx
            assert abs(float(out["lower_mean"][i]) - ref["lower_mean"]) <= btol, ctx
        if ref["robust_z"] < 1e6:
            np.testing.assert_allclose(float(out["robust_z"][i]), ref["robust_z"], rtol=2e-3,
                                       atol=1e-4, err_msg=ctx)


def test_constant_history_keeps_sigma_zero_and_a_spike_escalates():
    T = 128
    x = np.full((3, T), np.float32(60.42))
    m = np.ones((3, T), bool)
    region = np.zeros((3, T), bool)
    region[:, 96:] = True
    x[1, 100] = 1000.0
    x[2] = np.round(np.random.default_rng(3).normal(10, 0.3, T)).astype(np.float32)
    args = (x, m, region, np.full(3, 2.0, np.float32), np.ones(3, np.int32),
            np.zeros(3, np.float32), np.full(3, MARGIN, np.float32))
    out = _port(args)
    assert out["sigma"][0] == 0.0 and out["count"][0] == 0 and out["shrunk_count"][0] == 0
    assert out["robust_z"][0] == 0.0
    assert out["shrunk_count"][1] >= 1 and out["robust_z"][1] > 8.0
    # a quantized series: MAD may be 0, the sigma floor keeps robust_z finite
    assert np.isfinite(out["robust_z"][2])
    ref = _jax(args)
    assert ref["sigma"][0] > 0.0  # the reference's float noise (ROADMAP queue 3)


def test_nan_in_a_valid_history_slot_orders_after_inf():
    """jnp.sort puts NaN after +inf, so a NaN among the valid history reads
    as the largest value; masked slots (+inf) sort before it."""
    rng = np.random.default_rng(7)
    B, T = 6, 64
    x = rng.normal(20, 2, (B, T)).astype(np.float32)
    m = np.ones((B, T), bool)
    m[:3, 40:48] = False  # masked slots: +inf in the sort
    x[:, 5] = np.nan      # a NaN in a valid history slot
    x[1, 6] = np.nan
    region = np.zeros((B, T), bool)
    region[:, 48:] = True
    args = (x, m, region, np.full(B, 3.0, np.float32), np.full(B, 3, np.int32),
            np.zeros(B, np.float32), np.full(B, MARGIN, np.float32))
    port, ref = _port(args), _jax(args)
    np.testing.assert_array_equal(port["n_hist"], ref["n_hist"])
    np.testing.assert_allclose(port["robust_z"], ref["robust_z"], rtol=2e-3)
    for i in range(B):
        hv = x[i][m[i] & ~region[i]].astype(np.float64)
        n = hv.size
        s = np.sort(np.where(np.isnan(hv), np.inf, hv))  # NaN as the largest
        med = 0.5 * (s[(n - 1) // 2] + s[n // 2])
        assert np.isfinite(med)


def test_entry_point_runs_the_twin_on_cpu_and_refuses_without_cuda(monkeypatch):
    args = tr.triage_arg_spec(16, 64)
    out = tr.screen_rows(*args, WINDOW, device="cpu")
    assert set(out) == set(kernels.SCREEN_INT_OUTPUTS + kernels.SCREEN_FLOAT_OUTPUTS)
    assert out["count"].dtype == torch.int32 and out["sigma"].dtype == torch.float32
    assert tuple(out["robust_z"].shape) == (16,)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tr.screen_rows(*args, WINDOW)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.triage_screen(*(torch.from_numpy(a) for a in args[:3]), WINDOW,
                              *(torch.from_numpy(a) for a in args[3:]))


def test_plain_twin_chunks_rows_without_changing_them(monkeypatch):
    args = [torch.from_numpy(a) for a in _batch(np.random.default_rng(11), 64, 10)]
    whole = tr.screen_rows_plain(*args, WINDOW)
    monkeypatch.setattr(tr, "_PLAIN_CHUNK_SLOTS", 64 * 3)  # chunks of 3 rows
    parts = tr.screen_rows_plain(*args, WINDOW)
    for k in whole:
        assert torch.equal(torch.nan_to_num(whole[k]), torch.nan_to_num(parts[k])), k


def test_screen_cap_and_clear_rule_match_the_reference():
    from foremast_tpu.engine import triage as jax_gate

    for fire, T in ((16384, 128), (16384, 1024), (16384, 4096), (16384, 16384), (4, 128),
                    (100, 2048)):
        assert screen_cap(fire, T) == jax_gate.screen_cap(fire, T)
    g = TriageGate.__new__(TriageGate)
    g.z, g.margin, g.min_points = 0.0, 0.25, 1

    class _An:
        @staticmethod
        def _gate(checked):
            return 2.0

    g.an = _An()
    o = {"n_hist": 100, "shrunk_count": 0, "checked": 32, "robust_z": 0.0}
    assert g._row_clear("band", o) is False  # TRIAGE_Z=0 screens nothing
    g.z = 8.0
    assert g._row_clear("band", o) is True
    assert g._row_clear("band", {**o, "shrunk_count": 2}) is False
    assert g._row_clear("band", {**o, "n_hist": 0}) is False


def test_arg_spec_matches_the_reference():
    ours, theirs = tr.triage_arg_spec(16, 64), jax_triage.triage_arg_spec(16, 64)
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
