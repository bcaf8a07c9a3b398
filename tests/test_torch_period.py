"""Port parity: foremast_tpu_torch.ops.forecast.detect_period (with
device="cpu", the plain twin of kernel F) against the JAX reference.

The port sums in float64 and solves the trend from centred sums, the
reference sums in float32, so scores agree to float32 rounding:
|port - ref| <= 1e-5 (scores are correlations, scale 1), with the same
-inf pattern. The chosen period must match exactly except on rows whose
decision sits within 1e-5 of a margin (bracketed, as
tests/test_triage.py:197-206 brackets band edges, by
chip_smoke.near_decision): a half-lag contrast r_p + contrast_margin -
r_{p//2}, or a score's distance to the alias cut
max(best - alias_margin, min_acf). A constant row is not compared: the
reference detrends it to float32 rounding noise, the port to exactly 0
(its scores are -inf and it keeps its fallback).

The scenarios of tests/test_forecast.py:285-456 are reproduced on both
packages.
"""
import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import chip_smoke as cs  # noqa: E402
from foremast_tpu.ops import forecast as jfc  # noqa: E402
from foremast_tpu_torch.ops import forecast as tfc  # noqa: E402

SCORE_ATOL = 1e-5


def _both(x, mask, cands, fallback, min_acf, **kw):
    jp, js = jfc.detect_period(x, mask, cands, np.int32(fallback), np.float32(min_acf),
                               **{k: np.float32(v) for k, v in kw.items()})
    tp, ts = tfc.detect_period(x, mask, cands, fallback, min_acf, device="cpu", **kw)
    return np.asarray(jp), np.asarray(js), tp.numpy(), ts.numpy()


def _scores_close(got, ref):
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    fin = np.isfinite(ref)
    assert np.all(np.abs(got[fin] - ref[fin]) <= SCORE_ATOL)


def test_recovers_true_period_with_trend_and_gaps():
    B, T = 6, 512
    rng = np.random.default_rng(0)
    t = np.arange(T)
    periods = [24, 24, 96, 96, 24, 96]
    x = np.stack([5.0 + 0.01 * t + 2.0 * np.sin(2 * np.pi * t / p) + rng.normal(0, 0.2, T)
                  for p in periods]).astype(np.float32)
    mask = rng.random((B, T)) > 0.15
    jp, js, tp, ts = _both(x, mask, (24, 96, 384), 1440, 0.2)
    assert tp.tolist() == periods == jp.tolist()
    assert np.all(ts[np.arange(B), [0, 0, 1, 1, 0, 1]] > 0.8)
    _scores_close(ts, js)


def test_aperiodic_falls_back():
    x = np.random.default_rng(1).normal(10, 1, (3, 256)).astype(np.float32)
    mask = np.ones((3, 256), bool)
    jp, js, tp, ts = _both(x, mask, (24, 96), 777, 0.2)
    assert np.all(tp == 777) and np.all(jp == 777)
    _scores_close(ts, js)


def test_unsupported_candidates_fall_back():
    T = 100
    t = np.arange(T)
    x = (np.sin(2 * np.pi * t / 80) + 1.0).astype(np.float32)[None]
    jp, js, tp, ts = _both(x, np.ones((1, T), bool), (80, 120), 55, 0.2)
    # lag 80 leaves 20 overlap pairs (< 80): unsupported; 120 >= T
    assert ts.max() == -np.inf and int(tp[0]) == 55 == int(jp[0])
    _scores_close(ts, js)


def test_alias_margin_boundary():
    T = 2048
    t = np.arange(T)
    x = ((t % 97) < 8).astype(np.float32)[None] * 3.0
    mask = np.ones((1, T), bool)
    _, js, _, ts = _both(x, mask, (96, 97), 7, 0.05)
    _scores_close(ts, js)
    gap = float(ts[0, 1] - ts[0, 0])
    assert 0.02 < gap < 0.5
    for margin, want in ((gap + 0.01, 96), (max(gap - 0.01, 0.0), 97)):
        jp, _, tp, _ = _both(x, mask, (96, 97), 7, 0.05, alias_margin=margin)
        assert int(tp[0]) == want == int(jp[0])


def test_multi_period_fundamental_wins():
    T = 4096
    t = np.arange(T)
    rng = np.random.default_rng(3)
    both = (1.5 * np.sin(2 * np.pi * t / 60) + 1.5 * np.sin(2 * np.pi * t / 1440)
            + rng.normal(0, 0.1, T)).astype(np.float32)
    day_only = (2.0 * np.sin(2 * np.pi * t / 1440) + rng.normal(0, 0.1, T)).astype(np.float32)
    jp, js, tp, ts = _both(np.stack([both, day_only]), np.ones((2, T), bool), (60, 1440), 7, 0.2)
    assert tp.tolist() == [60, 1440] == jp.tolist()
    _scores_close(ts, js)


def test_sub_candidate_period_elects_valid_multiple():
    T = 4096
    t = np.arange(T)
    rng = np.random.default_rng(11)
    x = (2.0 * np.sin(2 * np.pi * t / 30) + rng.normal(0, 0.3, T)).astype(np.float32)[None]
    jp, js, tp, ts = _both(x, np.ones((1, T), bool), (60, 480, 1440), 7, 0.2)
    assert int(tp[0]) == 60 == int(jp[0])
    _scores_close(ts, js)


def _fleet(seed, B=24, T=1024):
    """Rows of several periods, amplitudes near the noise (so that some
    decisions are close), trends, gaps, short histories."""
    rng = np.random.default_rng(seed)
    t = np.arange(T)
    per = rng.choice([6, 12, 24, 50, 90, 200], B)
    amp = rng.uniform(0.0, 2.0, B)
    x = (rng.uniform(-5, 50, (B, 1)) + rng.normal(0, 0.05, (B, 1)) * t
         + amp[:, None] * np.sin(2 * np.pi * t[None] / per[:, None] + rng.uniform(0, 6, (B, 1)))
         + rng.normal(0, 1, (B, T))).astype(np.float32)
    mask = rng.random((B, T)) > rng.uniform(0, 0.4, (B, 1))
    mask[0, T // 3:] = False  # history too short for the long lags
    mask[1] = False
    return x, mask


@pytest.mark.parametrize("seed", range(3))
def test_random_fleet_matches_reference(seed):
    cands = (3, 6, 12, 24, 48, 90, 200, 600, 2000)
    x, mask = _fleet(seed)
    T = x.shape[1]
    fallback = 17
    jp, js, tp, ts = _both(x, mask, cands, fallback, 0.2)
    _scores_close(ts, js)
    # the reference's scores at each candidate's half lag, for the bracket
    halves = tuple(p // 2 if p >= 4 else 2 for p in cands)
    _, jh = jfc.detect_period(x, mask, halves, np.int32(fallback), np.float32(0.2))
    near = cs.near_decision(torch.from_numpy(js), torch.from_numpy(np.asarray(jh)), cands,
                            T).numpy()
    assert near.mean() < 0.2
    np.testing.assert_array_equal(tp[~near], jp[~near])
    assert int(tp[1]) == fallback  # no history at all


def test_per_row_fallback_and_out_of_range_candidates():
    x, mask = _fleet(5, B=6, T=128)
    fallback = np.array([2, 3, 5, 7, 11, 13], np.int32)
    tp, ts = tfc.detect_period(x, mask, (1, 128, 500), fallback, 0.2, device="cpu")
    # p < 2 and p >= T score -inf and are never eligible
    assert np.all(ts.numpy() == -np.inf)
    np.testing.assert_array_equal(tp.numpy(), fallback)
    tp, ts = tfc.detect_period(x, mask, (), fallback, 0.2, device="cpu")
    assert ts.shape == (6, 0)
    np.testing.assert_array_equal(tp.numpy(), fallback)


def test_constant_row_detrends_to_zero_and_keeps_its_fallback():
    T = 600
    x = np.full((2, T), 60.42, np.float32)
    x[1] = np.float32(-1234.5678)
    mask = np.ones((2, T), bool)
    mask[:, ::7] = False
    tp, ts = tfc.detect_period(x, mask, (12, 24, 48), 99, 0.2, device="cpu")
    assert np.all(ts.numpy() == -np.inf)
    np.testing.assert_array_equal(tp.numpy(), [99, 99])
    assert torch.is_tensor(tp) and tp.dtype == torch.int32


def test_plain_twin_in_row_chunks_equals_one_pass(monkeypatch):
    x, mask = _fleet(6, B=10, T=256)
    fb = torch.full((10,), 9, dtype=torch.int32)
    args = (torch.from_numpy(x), torch.from_numpy(mask), (12, 24, 50), fb, 0.2)
    whole = tfc.detect_period_plain(*args)
    monkeypatch.setattr(tfc, "_PLAIN_CHUNK_SLOTS", 3 * 256)  # chunks of 3 rows
    parts = tfc.detect_period_plain(*args)
    assert torch.equal(whole[0], parts[0]) and torch.equal(whole[1], parts[1])


@pytest.mark.parametrize("C", [1025, 2048])
def test_more_candidates_than_a_tile_match_reference(C):
    """1,025 and 2,048 candidates (past kernel F's 1,024 a lag table): valid
    lags spread over both tiles of the card's tiled path, one in the last
    slot of the first tile and one in the first of the second, a duplicate
    of an earlier candidate late in the list (the first eligible wins),
    the rest out of range (p >= T or p < 2), which the reference scores
    -inf without computing them (its compile time grows with each lag it
    computes: 1,025 valid lags take minutes)."""
    x, mask = _fleet(11, B=24, T=1024)
    T = x.shape[1]
    cands = [T + i if i % 2 else i % 2 for i in range(C)]  # out of range: >= T or < 2
    valid = {5: 3, 300: 6, 900: 12, 1023: 24, 1024: 48, C - 600: 90, C - 300: 200,
             C - 2: 24, C - 1: 600}
    for at, p in valid.items():
        cands[at] = p
    cands = tuple(cands)
    fallback = 17
    jp, js, tp, ts = _both(x, mask, cands, fallback, 0.2)
    _scores_close(ts, js)
    assert np.isneginf(ts[:, [i for i in range(C) if i not in valid]]).all()
    # the half lags of the valid candidates alone (an out-of-range one's
    # half would be a lag to compute)
    halves = tuple((p // 2 if p >= 4 else 2) if 2 <= p < T else T for p in cands)
    _, jh = jfc.detect_period(x, mask, halves, np.int32(fallback), np.float32(0.2))
    near = cs.near_decision(torch.from_numpy(js), torch.from_numpy(np.asarray(jh)), cands,
                            T).numpy()
    assert near.mean() < 0.3
    np.testing.assert_array_equal(tp[~near], jp[~near])
    assert int(tp[1]) == fallback
