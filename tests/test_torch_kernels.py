"""Kernels A to P against their plain twins, on the card.

These need a CUDA device and nvcc; without them they skip. Run them on the
card with `python -m pytest --noconftest tests/test_torch_kernels.py`. The
comparisons and their tolerances are chip_smoke.py's: p-values to 1e-5,
booleans and counts exact except rows bracketed at a threshold or a band
edge; the smoothers to 4 eps32 of a row's scale (the scans to the
reference's own 1e-5 / 1e-4); the fit's errors to 1e-9 and its choice
exactly; period scores to 1e-6 and periods exactly except within 1e-5 of a
margin; the triage screen's counts exact except rows bracketed at a band
edge, its statistics to 1e-5 (1e-4 for the z scores) relative; kernel H's
d2 to chip_smoke's bivariate_tolerance, its flags and counts exact but on
rows bracketed at the ellipse's edge, its bands to 1e-5 relative plus the
statistics' float32 noise; kernel I's reason codes exact and scores to
1e-3 but on rows bracketed at a decision edge, its means to 1e-5 relative,
the demand to 1e-4; kernel J's preds to 1e-5 of a row's scale (1e-3 on
ill-posed rows) and beta to 1e-4 of its largest entry; kernel K's errors to
1e-4 relative and its z-scores on the reference-trained fixture to 1e-3;
kernel L's loss to 1e-5 relative and its gradient to 1e-4 of a job's
largest entry against torch autograd, NaN jobs alike; kernel M bit for bit
against the written-out Adam; five training steps on the card within 1e-5
relative (losses) and 1e-4 (rows: Adam's step is lr times the sign of a
gradient near 0, so float noise there moves a row by up to lr) of the twin's;
the reference's training fixture as chip_smoke.py holds it; kernel N's
p-values to 1e-5 and its statistics to 1e-6 relative; kernel O's ranks, tie
terms and counts exactly, its H and chi2 to 1e-6 relative and p to 1e-5;
kernel P's count, values (bit for bit) and indices exactly; the fleet
scorer in a world of one over NCCL as score_pairs and P's twin.
"""
import numpy as np
import pytest
import torch

import chip_smoke as cs
from foremast_tpu_torch import kernels
from foremast_tpu_torch.ops import forecast as fc
from foremast_tpu_torch.parallel import fleet as fl

pytestmark = pytest.mark.gpu


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    kernels.build.library()
    return torch.device("cuda")


@pytest.mark.parametrize("T", [16, 128, 1024, 4096])
def test_pair_verdict_matches_twin(card, T):
    args = cs.adversarial_pairs(512, T, np.random.default_rng(T))
    t = fl.pair_args_from_numpy(args, card)
    before = kernels.launches["pair_verdict"]
    kern = fl.score_pairs(*t)
    assert kernels.launches["pair_verdict"] == before + 1
    plain = fl.pair_verdict_plain(*t)
    torch.cuda.synchronize()
    err, _ = cs.compare_pair_verdict(t, kern, plain)
    assert err <= cs.P_ATOL


def test_pair_verdict_phase_clocks(card):
    args = cs.adversarial_pairs(256, 128, np.random.default_rng(7))
    t = fl.pair_args_from_numpy(args, card)
    clocks = torch.zeros((256, len(kernels.PAIR_PHASES) + 1), dtype=torch.int64, device=card)
    stamped = kernels.pair_verdict(
        *t, wilcoxon_table=fl.wilcoxon_pmf_table(card), ks_exact_max=fl.KS_EXACT_MAX_T,
        wilcoxon_exact_max_n=fl.WILCOXON_EXACT_MAX_N, phase_clocks=clocks)
    plain = fl.score_pairs(*t)
    torch.cuda.synchronize()
    assert bool((clocks[:, 0] > 0).all())
    assert bool((clocks.diff(dim=1) >= 0).all())
    for key in stamped:
        assert torch.equal(stamped[key], plain[key]), key


@pytest.mark.parametrize("T", [128, 1024, 16384])
def test_ma_band_matches_twin(card, T):
    gen = torch.Generator(device=card).manual_seed(T)
    args = cs.adversarial_bands(256, T, gen)
    before = kernels.launches["ma_band"]
    kern = fc.moving_average_band(*args[:3], 30, *args[3:])
    assert kernels.launches["ma_band"] == before + 1
    plain = fc.moving_average_band_plain(*args[:3], 30, *args[3:])
    torch.cuda.synchronize()
    cs.compare_ma_band(args, 30, kern, plain)
    const = torch.arange(256, device=card) % 8 == 4
    assert bool((kern["sigma"][const] == 0).all())
    assert bool((kern["count"][const] == 0).all())


@pytest.mark.parametrize("T", [8192, 16384])
def test_pair_verdict_from_device_scratch_matches_twin(card, T, monkeypatch):
    # a small scratch budget makes the CTAs walk the pairs grid-stride
    monkeypatch.setattr(kernels, "SCRATCH_BYTES", 40 * (1 << 20))
    args = cs.adversarial_pairs(96, T, np.random.default_rng(T))
    t = fl.pair_args_from_numpy(args, card)
    kern = fl.score_pairs(*t)
    plain = fl.pair_verdict_plain(*t)
    torch.cuda.synchronize()
    err, _ = cs.compare_pair_verdict(t, kern, plain)
    assert err <= cs.P_ATOL


def _series(card, T, B=256):
    gen = torch.Generator(device=card).manual_seed(T)
    return cs.adversarial_series(B, T, gen)


@pytest.mark.parametrize("T", [128, 4096, 16384])
@pytest.mark.parametrize("kind", [kernels.SMOOTH_SES, kernels.SMOOTH_DES, kernels.SMOOTH_HW])
def test_smooth_matches_twin(card, T, kind):
    x, m, region, al, be, ga, period = _series(card, T, 64)[:7]
    params = ((al,), (al, be), (al, be, ga, period))[kind - 1]
    before = kernels.launches["smooth"]
    kern = kernels.smooth(kind, x, m & ~region, *params)
    assert kernels.launches["smooth"] == before + 1
    cs.compare_smooth(kind, x, m & ~region, params, kern)


@pytest.mark.parametrize("T", [128, 4096, 16384])
@pytest.mark.parametrize("kind", [kernels.SMOOTH_SES, kernels.SMOOTH_DES])
def test_affine_scan_matches_twin(card, T, kind):
    x, m, region, al, be = _series(card, T)[:5]
    params = (al,) if kind == kernels.SMOOTH_SES else (al, be)
    kern = kernels.affine_scan(kind, x, m & ~region, *params)
    cs.compare_scan(kind, x, m & ~region, params, kern)


@pytest.mark.parametrize("T", [128, 4096])
def test_hw_fit_matches_twin(card, T, monkeypatch):
    monkeypatch.setattr(kernels, "SCRATCH_BYTES", 8 * (1 << 20))  # grid-stride warps
    x, m, region, _, _, _, period = _series(card, T, 48)[:7]
    hist = m & ~region
    fit = hist & (torch.arange(T, device=card) >= 2 * period[:, None])
    grid = torch.tensor(fc.DEFAULT_GRID, dtype=torch.float32, device=card)
    before = kernels.launches["hw_fit"]
    kern = kernels.hw_fit(x, hist, fit, period, grid)
    assert kernels.launches["hw_fit"] == before + 1
    cs.compare_hw_fit(x, hist, fit, period, grid, kern)


@pytest.mark.parametrize("T", [128, 1024, 16384])
def test_detect_period_matches_twin(card, T):
    x, m, region = _series(card, T, 512)[:3]
    hist = m & ~region
    cands = (2, 3, 24) + cs.PERIOD_CANDIDATES
    fb = torch.full((512,), 7, dtype=torch.int32, device=card)
    kern = kernels.detect_period(x, hist, torch.tensor(cands, dtype=torch.int32, device=card),
                                 fb, 0.2, 0.05, 0.01)
    cs.compare_detect_period(x, hist, cands, fb, kern)


@pytest.mark.parametrize("T", [128, 16384])
def test_band_from_preds_matches_twin(card, T):
    x, m, region, *_, thr, mode, mlb = _series(card, T)
    preds = torch.where(torch.isfinite(x), x, 30.0) + 1.0
    kern = kernels.band_from_preds(x, m, region, preds, thr, mode, mlb)
    cs.compare_band_from_preds(x, m, region, preds, thr, mode, mlb, kern)


def test_forecast_band_launches_its_kernels(card):
    x, m, region, *_, thr, mode, mlb = _series(card, 4096, 64)
    for algorithm, names in cs.SEASON_KERNELS.items():
        kernels.reset_launches()
        out = fc.forecast_band(x, m, region, thr, mode, mlb, algorithm=algorithm)
        torch.cuda.synchronize()
        assert {k for k, v in kernels.launches.items() if v} == set(names), algorithm
        plain = fc.forecast_band(x.cpu(), m.cpu(), region.cpu(), thr.cpu(), mode.cpu(),
                                 mlb.cpu(), algorithm=algorithm, device="cpu")
        assert torch.equal(out["checked"].cpu(), plain["checked"])


def test_launchers_refuse_what_the_kernels_do_not_take(card):
    args = [torch.from_numpy(a).to(card) for a in fl.pair_arg_spec(2, kernels.MAX_PAIR_T + 1)]
    with pytest.raises(ValueError, match="16384"):
        fl.score_pairs(*args)
    x = torch.zeros((4, 64), device=card)[:, ::2]
    m = torch.ones((4, 32), dtype=torch.bool, device=card)
    pol = (torch.ones(4, device=card), torch.full((4,), 3, dtype=torch.int32, device=card),
           torch.zeros(4, device=card))
    with pytest.raises(ValueError, match="contiguous"):
        kernels.ma_band(x, m, ~m, 5, *pol)
    with pytest.raises(TypeError):
        kernels.ma_band(x.contiguous().double(), m, ~m, 5, *pol)


@pytest.mark.parametrize("T", [128, 1024, 4096, 16384])
def test_triage_screen_matches_twin(card, T):
    from foremast_tpu_torch.ops import triage as tr

    gen = torch.Generator(device=card).manual_seed(T)
    args = cs.adversarial_screen(256 if T < 16384 else 64, T, gen)
    before = kernels.launches["triage_screen"]
    kern = tr.screen_rows(*args, cs.TRIAGE_WINDOW)
    assert kernels.launches["triage_screen"] == before + 1
    plain = tr.screen_rows_plain(*args, cs.TRIAGE_WINDOW)
    torch.cuda.synchronize()
    cs.compare_triage(args, kern, plain)
    kind = torch.arange(args[0].shape[0], device=card) % 10
    assert bool((kern["sigma"][kind == 3] == 0).all())       # constant history
    assert bool((kern["n_hist"][kind == 1] == 0).all())      # all masked
    assert bool((kern["robust_z"][kind == 1] == 0).all())
    assert bool((kern["checked"][kind == 6] == 0).all())     # empty region
    assert bool(torch.isfinite(kern["robust_z"][kind == 5]).all())  # NaN in history


@pytest.mark.parametrize("optional", [True, False], ids=["optional", "core"])
@pytest.mark.parametrize("T", [128, 1024, 2048, 16384])
def test_bivariate_matches_twin(card, T, optional):
    from foremast_tpu_torch.ops import bivariate as bv

    gen = torch.Generator(device=card).manual_seed(T)
    args = cs.adversarial_bivariate(384 if T < 16384 else 96, T, gen)
    if not optional:
        args = args[:6]
    before = kernels.launches["bivariate"]
    kern = bv.bivariate_normal_anomalies(*args)
    assert kernels.launches["bivariate"] == before + 1
    assert kern["upper1"].shape == (args[0].shape[0], T)
    rows = {k: (v[:, 0].contiguous() if k in ("upper1", "lower1", "upper2", "lower2") else v)
            for k, v in kern.items()}
    plain = bv.bivariate_normal_anomalies_plain(*args)
    torch.cuda.synchronize()
    cs.compare_bivariate(args, rows, plain)


@pytest.mark.parametrize("sigma", [True, False], ids=["sigma-given", "sigma-computed"])
@pytest.mark.parametrize("T", [128, 1024, 2048, 16384])
def test_hpa_score_matches_twin(card, T, sigma):
    from foremast_tpu_torch.ops import hpa as hp

    gen = torch.Generator(device=card).manual_seed(T)
    a = cs.adversarial_hpa(384 if T < 16384 else 96, T, gen)
    before = kernels.launches["hpa_score"]
    s = cs.hpa_series(a)
    opt = [a[k] for k in cs.HPA_OPTIONAL]
    if sigma:
        kern = hp.hpa_scores(*s[:4], a["tps_sigma"], *s[4:], *opt)
    else:
        kern = hp.hpa_from_preds(*s, *opt)
    assert kernels.launches["hpa_score"] == before + 1
    torch.cuda.synchronize()
    errs, _ = cs.compare_hpa(a, kern, sigma)
    assert errs["score"] <= 1e-3


def _card_fleet(monkeypatch):
    """A small chip_smoke engine fleet: 300 canaries, 200 band monitors, 100
    two-metric monitors and 60 hpa jobs."""
    monkeypatch.setattr(cs, "ENGINE_CANARIES", 300)
    monkeypatch.setattr(cs, "ENGINE_CONTINUOUS", 200)
    monkeypatch.setattr(cs, "ENGINE_BIVARIATE", 100)
    monkeypatch.setattr(cs, "ENGINE_HPA", 60)
    return cs.engine_fleet(np.random.default_rng(7))


def _run_fleet(fleet, device, **cfg):
    """The fleet through the port's Analyzer for chip_smoke's cycles: the
    digest of each cycle, the documents and the hpalogs."""
    from foremast_tpu_torch.dataplane.fetch import RawFixtureDataSource
    from foremast_tpu_torch.engine import Analyzer, EngineConfig, JobStore
    from foremast_tpu_torch.engine import jobs as J

    store = JobStore()
    for d in fleet["docs"]():
        store.create(d)
    src = RawFixtureDataSource(keep_urls=False)
    an = Analyzer(EngineConfig(**cfg), src, store, device=device)
    digests = []
    for c in range(cs.ENGINE_CYCLES):
        src.pages = fleet["pages"][c]
        an.run_cycle(worker="t", now=fleet["now"] + cs.STEP * c)
        digests.append(J.verdict_digest(store))
    logs = {jid: sorted(store.hpalogs_for(jid), key=lambda log: log.timestamp)
            for jid in fleet["hpa_class"]}
    return digests, {d.id: d for d in store.by_status(*J.OPEN_STATUSES,
                                                      *J.TERMINAL_STATUSES)}, logs


def _same_verdicts(docs, twin):
    """The same status and anomaly for every job, reasons equal but for
    printed numbers within float noise."""
    import re

    num = re.compile(r"-?\d+(?:\.\d+)?(?:e[+-]?\d+)?")
    for jid, d in docs.items():
        t = twin[jid]
        assert (d.status, d.anomaly) == (t.status, t.anomaly), jid
        assert num.split(d.reason) == num.split(t.reason), jid
        for a, b in zip(num.findall(d.reason), num.findall(t.reason)):
            assert abs(float(a) - float(b)) <= 2e-3 * max(abs(float(a)), abs(float(b))) + 1e-4


def test_engine_cycle_on_the_card_keeps_one_verdict_state(card, monkeypatch):
    """A small chip_smoke engine fleet (canaries, band monitors, two-metric
    monitors and hpa jobs) through the port's Analyzer on the card: the
    pinned staging and pipelined launches must not change a verdict. Every
    configuration on the card gives one digest per cycle (triage off, memo
    off, the barriered path, megabatch, 16-row rungs), and the card's
    verdicts are the twins': the same status and anomaly for every job,
    reasons equal but for printed numbers within float noise; the hpalogs
    the same gated scores and reason codes, raw scores as printed (.1f)
    equal or one digit apart at a rounding edge."""
    import re

    fleet = _card_fleet(monkeypatch)
    on_card, docs, logs = _run_fleet(fleet, card)
    for cfg in ({"triage": False}, {"score_memo": False}, {"score_pipeline": False},
                {"megabatch": True}, {"pipeline_fire_rows": 16}):
        assert _run_fleet(fleet, card, **cfg)[0] == on_card, cfg
    _, twin, twin_logs = _run_fleet(fleet, "cpu")
    raw = re.compile(r"raw (-?[0-9.]+|nan)\) via (.+?) on")
    for jid, mine in logs.items():
        theirs = twin_logs[jid]
        assert len(mine) == len(theirs) == cs.ENGINE_CYCLES, jid
        for a, b in zip(mine, theirs):
            (ra, wa), (rb, wb) = raw.search(a.reason).groups(), raw.search(b.reason).groups()
            assert a.hpascore == b.hpascore and wa == wb, (jid, a.reason, b.reason)
            # printed to .1f: equal, or one digit apart at a rounding edge
            assert abs(float(ra) - float(rb)) <= 0.1 + 1e-9, (jid, a.reason, b.reason)
    _same_verdicts(docs, twin)


def test_engine_cycle_on_the_card_under_seasonal_trend(card, monkeypatch):
    """The same fleet under ML_ALGORITHM=seasonal_trend: the band family
    runs kernels F, J and band_from_preds on the card, one digest with the
    pipeline on and off, and the card's verdicts are the twins'."""
    fleet = _card_fleet(monkeypatch)
    before = dict(kernels.launches)
    on_card, docs, _ = _run_fleet(fleet, card, algorithm="seasonal_trend")
    for k in ("detect_period", "st_fit", "band_from_preds"):
        assert kernels.launches[k] > before[k], k
    assert _run_fleet(fleet, card, algorithm="seasonal_trend", score_pipeline=False)[0] == on_card
    _, twin, _ = _run_fleet(fleet, "cpu", algorithm="seasonal_trend")
    _same_verdicts(docs, twin)
    assert all(docs[j].status == "completed_unhealth" for j in fleet["shifted"])


@pytest.mark.parametrize("C", [0, cs.ST_CHANGEPOINTS])
@pytest.mark.parametrize("T", [128, 2048, 16384])
def test_st_fit_matches_twin(card, T, C):
    from foremast_tpu_torch.ops import forecast as fcast

    gen = torch.Generator(device=card).manual_seed(T + C)
    args = cs.adversarial_st(256 if T == 16384 else 1024, T, gen)
    before = kernels.launches["st_fit"]
    kern = fcast.fit_seasonal_trend(*args, cs.ST_ORDER, n_changepoints=C)
    assert kernels.launches["st_fit"] == before + 1
    plain = fcast.fit_seasonal_trend_plain(*args, cs.ST_ORDER, 1e-4, C, 3e-3, 3)
    torch.cuda.synchronize()
    cs.compare_st_fit(args, kern, plain, 2 + C + 2 * cs.ST_ORDER)


@pytest.mark.parametrize("F,H,Z", cs.LSTM_WIDTHS)
def test_lstm_ae_matches_twin(card, F, H, Z):
    from foremast_tpu_torch.models import lstm_ae as tl

    gen = torch.Generator(device=card).manual_seed(F * H + Z)
    p, x, m, mu, sigma = cs.adversarial_lstm(128, 11, F, H, Z, gen)
    before = kernels.launches["lstm_ae"]
    z = tl.anomaly_scores_fleet(p, x, m, mu, sigma, hidden=H, latent=Z)
    assert kernels.launches["lstm_ae"] == before + 1
    kern = kernels.lstm_ae(p, x, m, H, Z, mu, sigma)
    assert torch.equal(kern[1], z)
    cs.compare_lstm(kern, tl.reconstruction_errors_plain(p, x, m, H, Z, mu, sigma), sigma)


def test_lstm_ae_scores_the_reference_trained_fixture_as_the_reference(card):
    from foremast_tpu_torch.models import lstm_ae as tl

    d = np.load(cs.LSTM_FIXTURE)
    F, H, Z, W = (int(v) for v in d["dims"])
    z = tl.anomaly_scores_fleet(d["params"], d["x"], d["mask"], d["mu"], d["sigma"],
                                hidden=H, latent=Z).cpu().numpy()
    np.testing.assert_allclose(z, d["z"], rtol=0, atol=1e-3)
    edge = np.abs(d["z"] - 3.0) <= 1e-3
    np.testing.assert_array_equal((z > 3)[~edge], (d["z"] > 3)[~edge])


@pytest.mark.parametrize("W", cs.LSTM_TRAIN_WS)
@pytest.mark.parametrize("F,H,Z", cs.LSTM_WIDTHS)
def test_lstm_train_matches_autograd_through_the_twin(card, F, H, Z, W):
    from foremast_tpu_torch.models import lstm_ae as tl

    gen = torch.Generator(device=card).manual_seed(F * H + Z + W)
    p, x, m = cs.adversarial_lstm_train(32, 11, W, F, H, Z, gen)
    before = (kernels.launches["lstm_train_forward"], kernels.launches["lstm_train_backward"])
    kern = tl.loss_and_grad(p, x, m, hidden=H, latent=Z)
    assert (kernels.launches["lstm_train_forward"],
            kernels.launches["lstm_train_backward"]) == (before[0] + 1, before[1] + 1)
    q = p.clone().requires_grad_(True)
    loss = tl.loss_plain(q, x, m, H, Z)
    grad, = torch.autograd.grad(loss.sum(), q)
    cs.compare_lstm_train(kern, (loss.detach(), grad))


def test_adam_equals_the_written_out_adam_bit_for_bit(card):
    from foremast_tpu_torch.models import lstm_ae as tl

    gen = torch.Generator(device=card).manual_seed(11)
    p, x, m = cs.adversarial_lstm_train(48, 19, 32, 4, 32, 16, gen)
    num, cnt, act = kernels.lstm_train_forward(p, x, m, 32, 16)
    gpart = kernels.lstm_train_backward(p, x, m, act, 32, 16)
    step = torch.randint(1, 3000, (48,), generator=gen, device=card, dtype=torch.int32)
    mu = 1e-3 * torch.randn(p.shape, generator=gen, device=card)
    nu = 1e-6 * torch.rand(p.shape, generator=gen, device=card)
    before = kernels.launches["adam"]
    assert cs.compare_adam(p, mu, nu, step, gpart, num, cnt) == 0.0
    assert kernels.launches["adam"] == before + 1


def test_train_step_on_the_card_follows_the_twin(card):
    """Five steps from the reference's initial rows: the card's train_step
    (L, then M) against train_step_plain on the card, the losses within
    1e-5 relative and the rows within 1e-4."""
    from foremast_tpu_torch.models import lstm_ae as tl

    gen = torch.Generator(device=card).manual_seed(5)
    _, x, m = cs.adversarial_lstm_train(16, 9, 32, 4, 32, 16, gen)
    x[1, 0, 0, 0] = 0.0
    states = [[t.to(card) for t in tl.init_state(4, 32, 16, 16)] for _ in range(2)]
    for _ in range(5):
        lk = tl.train_step(*states[0], x, m, hidden=32, latent=16)
        lp = tl.train_step_plain(*states[1], x, m, 32, 16)
        torch.testing.assert_close(lk, lp, rtol=1e-5, atol=1e-7)
    assert torch.equal(states[0][1], states[1][1])
    torch.testing.assert_close(states[0][0], states[1][0], rtol=0, atol=1e-4)


def test_train_fleet_on_the_card_reproduces_the_reference_s_training(card):
    from foremast_tpu_torch.models import lstm_ae as tl

    cs.lstm_train_reference(tl)


def test_detect_period_takes_forty_candidates(card):
    gen = torch.Generator(device=card).manual_seed(40)
    x, m, region = cs.adversarial_series(256, 4096, gen)[:3]
    hist = m & ~region
    fb = torch.full((256,), 7, dtype=torch.int32, device=card)
    cand = torch.tensor(cs.MANY_CANDIDATES, dtype=torch.int32, device=card)
    kern = kernels.detect_period(x, hist, cand, fb, 0.2, 0.05, 0.01)
    torch.cuda.synchronize()
    cs.compare_detect_period(x, hist, cs.MANY_CANDIDATES, fb, kern)


@pytest.mark.parametrize("T", [8, 128, 1024, 8192])
def test_pair_tests_match_twin(card, T):
    from foremast_tpu_torch.ops import pairwise as pw

    B = 256 if T <= 1024 else 32
    x, xm, y, ym = (torch.from_numpy(a).to(card)
                    for a in cs.adversarial_tests(B, T, np.random.default_rng(T)))
    plain = pw.two_sample_tests_plain(x, xm, y, ym)
    names = pw.TWO_SAMPLE_TESTS
    before = kernels.launches["pair_tests"]
    kern = kernels.pair_tests(x, xm, y, ym, 15, wilcoxon_table=pw.wilcoxon_pmf_table(card),
                              ks_exact_max=pw.KS_EXACT_MAX_T,
                              wilcoxon_exact_max_n=pw.WILCOXON_EXACT_MAX_N)
    cs.compare_pair_tests(kern, plain, names)
    for name, fn in (("mann_whitney", pw.mann_whitney_u_batch), ("wilcoxon", pw.wilcoxon_batch),
                     ("ks", pw.ks_2samp_batch)):
        st, p = fn(x, xm, y, ym, device=card)
        cs.close(p, plain[name][1], 0.0, cs.P_ATOL, name)
        cs.close(st, plain[name][0], cs.STAT_RTOL, 1e-6, name)
    n, p = pw.sign_test_batch(x, y, xm & ym, device=card)
    pn, pp = pw.sign_test_exact_plain(x, y, xm & ym)
    cs.close(p, pp, 0.0, cs.P_ATOL, "sign")
    assert torch.equal(n, pn)
    assert kernels.launches["pair_tests"] == before + 5


@pytest.mark.parametrize("T", [8, 256, 16384])
def test_rank_and_ties_matches_twin(card, T):
    from foremast_tpu_torch.ops import ranks as rk

    v, m = (torch.from_numpy(a).to(card)
            for a in cs.adversarial_ranks(24, T, np.random.default_rng(T)))
    cs.compare_ranks(rk.rank_and_ties(v, m, device=card), rk.rank_and_ties_plain(v, m))
    r, tie, n = rk.rank_and_ties(v[0], m[0], device=card)
    assert r.shape == (T,) and tie.shape == () and n.shape == ()


@pytest.mark.parametrize("k,T", [(2, 64), (3, 128), (5, 64), (3, 16384)])
def test_kruskal_groups_match_twin(card, k, T):
    from foremast_tpu_torch.ops import pairwise as pw

    g, gm = (torch.from_numpy(a).to(card)
             for a in cs.adversarial_groups(16, k, T, np.random.default_rng(k * T)))
    H, p = pw.kruskal_batch(g, gm, device=card)
    pH, pp = pw.kruskal_plain(g, gm)
    cs.close(H, pH, cs.STAT_RTOL, 1e-6, "H")
    cs.close(p, pp, 0.0, cs.P_ATOL, "p")


@pytest.mark.parametrize("n,k", cs.FRIEDMAN_CHECK)
def test_friedman_matches_twin(card, n, k):
    from foremast_tpu_torch.ops import pairwise as pw

    d, bm = (torch.from_numpy(a).to(card)
             for a in cs.adversarial_friedman(64, n, k, np.random.default_rng(n * k)))
    chi, p = pw.friedman_batch(d, bm, device=card)
    pc, pp = pw.friedman_plain(d, bm)
    cs.close(chi, pc, cs.STAT_RTOL, 1e-5, "chi2")
    cs.close(p, pp, 0.0, cs.P_ATOL, "p")


@pytest.mark.parametrize("n", [5, 4096, 20_000])
def test_fleet_topk_matches_twin(card, n):
    rng = np.random.default_rng(n)
    u, s = (torch.from_numpy(a).to(card) for a in cs.adversarial_topk(n, rng))
    for k in cs.TOPK_CHECK_K + (n + 5,):
        cs.compare_topk(kernels.fleet_topk(s, k, u, base=11),
                        fl.fleet_topk_plain(s, k, u, base=11), f"k={k}")
        cs.compare_topk(kernels.fleet_topk(s, k), fl.fleet_topk_plain(s, k), f"k={k} unmasked")


def test_fleet_scorer_in_a_world_of_one_over_nccl(card):
    import torch.distributed as dist

    from foremast_tpu_torch.parallel import mesh as pm

    args = cs.adversarial_pairs(2048, 128, np.random.default_rng(5))
    t = fl.pair_args_from_numpy(args, card)
    started = pm.world_of_one(card)
    try:
        mesh = pm.fleet_mesh(device=card)
        out, total, v, i = fl.make_fleet_scorer(mesh, k=8)(*t[:4], dict(zip(cs.CFG_KEYS, t[4:])))
        ref = fl.score_pairs(*t, device=card)
        for key in ref:
            assert torch.equal(out[key], ref[key]), key
        cs.compare_topk((torch.tensor(total), v, i),
                        fl.fleet_topk_plain(ref["severity"], 8, ref["unhealthy"]), "scorer")
    finally:
        if started:
            dist.destroy_process_group()
