"""Kernels A to P against their plain twins, on the card.

These need a CUDA device and nvcc; without them they skip. Run them on the
card with `python -m pytest --noconftest tests/test_torch_kernels.py`. The
comparisons and their tolerances are chip_smoke.py's: p-values to 1e-5,
booleans and counts exact except rows bracketed at a threshold or a band
edge; the smoothers to 4 eps32 of a row's scale, and kernel C's two
Holt-Winters paths to each other bit for bit (the scans to the
reference's own 1e-5 / 1e-4); the fit's errors to 1e-9 and its choice
exactly; period scores to 1e-6 and periods exactly except within 1e-5 of a
margin; the triage screen's counts exact except rows bracketed at a band
edge, its statistics to 1e-5 (1e-4 for the z scores) relative; kernel H's
d2 to chip_smoke's bivariate_tolerance on each of its paths, its flags and
counts exact but on rows bracketed at the ellipse's edge, its bands to 1e-5
relative plus the
statistics' float32 noise; kernel I's reason codes exact and scores to
1e-3 but on rows bracketed at a decision edge, its means to 1e-5 relative,
the demand to 1e-4; kernel J's preds to 1e-5 of a row's scale (1e-3 on
ill-posed rows) and beta to 1e-4 of its largest entry; kernel K's errors to
1e-4 relative and its z-scores on the reference-trained fixture to 1e-3;
kernel L's loss to 1e-5 relative and its gradient to 1e-4 of a job's
largest entry against torch autograd, NaN jobs alike, its backward equal
bit for bit on a second run, its weight-gradient entry to 1e-4 of a job's
largest entry against its twin; kernel M bit for bit against the written-out
Adam; five training steps on the card within 1e-5
relative (losses) and 1e-4 (rows: Adam's step is lr times the sign of a
gradient near 0, so float noise there moves a row by up to lr) of the twin's;
the reference's training fixture as chip_smoke.py holds it; kernel N's
p-values to 1e-5 and its statistics to 1e-6 relative; kernel O's ranks, tie
terms and counts exactly, its H and chi2 to 1e-6 relative and p to 1e-5
(kruskal_groups' and rank_and_ties' paths to one another bit for bit;
ma_band's three paths likewise);
kernel P's count, values (bit for bit) and indices exactly; the fleet
scorer in a world of one over NCCL as score_pairs and P's twin. Kernel O's
friedman and kernel P each on every path, equal bit for bit; kernel E's DES
at T = 16384 within half of compare_scan's limit on 16 seeded draws on its
scan path, and equal to its twin bit for bit on its walk path; kernels A,
N, O and P past their first designs' limits as chip_smoke.py holds them.
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


@pytest.mark.parametrize("cap", [None, 1440], ids=["periods", "periods-to-1440"])
@pytest.mark.parametrize("T", [128, 1024, 4096, 16384])
def test_smooth_hw_matches_twin_at_every_ring_length(card, T, cap):
    """Kernel C's Holt-Winters kind at the rows' periods (up to T + 5) and
    cut to 1440, against the twin, one launch each; rings longer than the
    largest period (max_period = T) give the same bits."""
    x, m, region, al, be, ga, period = _series(card, T, 96)[:7]
    if cap is not None:
        period = period.clamp(max=cap)
    hist = m & ~region
    args = (x, hist, al, be, ga, period)
    before = kernels.launches["smooth"]
    got = kernels.smooth(kernels.SMOOTH_HW, *args)
    assert kernels.launches["smooth"] == before + 1
    cs.compare_smooth(kernels.SMOOTH_HW, x, hist, args[2:], got)
    longer = kernels.smooth(kernels.SMOOTH_HW, *args, max_period=T)
    assert torch.equal(got.view(torch.int32), longer.view(torch.int32))


def test_smooth_hw_on_the_seasonal_rows(card):
    """The refit's inputs of the seasonal path (7 days of history in bucket
    16384, periods 480 and 1440, the trailing padding masked): against the
    twin, and with max_period given (1440) or read from the card, the same
    bits."""
    gen = torch.Generator(device=card).manual_seed(11)
    args, _, _ = cs.season_inputs(gen, rows=640, dev=card)
    x, mask, region = args[:3]
    B = x.shape[0]
    g = torch.Generator(device=card).manual_seed(12)
    al, be, ga = (torch.rand(B, generator=g, device=card) * s for s in (0.9, 0.3, 0.5))
    period = torch.where(torch.arange(B, device=card) % 3 == 0, 480, 1440).to(torch.int32)
    hist = mask & ~region
    got = kernels.smooth(kernels.SMOOTH_HW, x, hist, al, be, ga, period, max_period=1440)
    cs.compare_smooth(kernels.SMOOTH_HW, x, hist, (al, be, ga, period), got)
    read = kernels.smooth(kernels.SMOOTH_HW, x, hist, al, be, ga, period)
    assert torch.equal(got.view(torch.int32), read.view(torch.int32))


def test_smooth_hw_phase_clocks(card):
    """Kernel C's Holt-Winters cycle counts a group: every phase
    non-negative (the stamps monotone), some cycles in every group, and the
    stamped launch's predictions equal the unstamped ones."""
    x, m, region, al, be, ga, period = _series(card, 4096, 100)[:7]
    args = (x, m & ~region, al, be, ga, period.clamp(max=1440))
    clocks = torch.full((4, len(kernels.SMOOTH_HW_PHASES)), -1, dtype=torch.int64, device=card)
    plain = kernels.smooth(kernels.SMOOTH_HW, *args)
    timed = kernels.smooth(kernels.SMOOTH_HW, *args, phase_clocks=clocks)
    torch.cuda.synchronize()
    assert torch.equal(plain.view(torch.int32), timed.view(torch.int32))
    assert bool((clocks >= 0).all()) and bool((clocks.sum(1) > 0).all())


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


def _fit_rows(card, T, B=52):
    """Kernel D's rows with their last fit slots all over the row: none at
    all, the first slot, mid-row, the row's end; periods below and above
    2 kTile = 64 (each path of the walk) and past T."""
    x, m, region = _series(card, T, B)[:3]
    hist = m & ~region
    periods = torch.tensor([2, 3, 24, 31, 32, 33, 60, 63, 64, 65, 100, 480, T + 5],
                           dtype=torch.int32, device=card)
    period = periods[torch.arange(B, device=card) % len(periods)]
    t = torch.arange(T, device=card)
    gen = torch.Generator(device=card).manual_seed(T + 1)
    ends = torch.randint(0, T + 1, (B,), generator=gen, device=card)
    ends[-4:] = T
    fit = hist & (t >= 2 * period[:, None]) & (t < ends[:, None])
    fit[0] = False
    fit[1] = False
    fit[1, 0] = hist[1, 0] = True
    return x, hist, fit.contiguous(), period


@pytest.mark.parametrize("T", [1000, 4096])
def test_hw_fit_stops_each_row_after_its_last_fit_slot(card, T, monkeypatch):
    monkeypatch.setattr(kernels, "SCRATCH_BYTES", 8 * (1 << 20))  # grid-stride warps
    x, hist, fit, period = _fit_rows(card, T)
    grid = torch.tensor(fc.DEFAULT_GRID, dtype=torch.float32, device=card)
    kern = kernels.hw_fit(x, hist, fit, period, grid)
    cs.compare_hw_fit(x, hist, fit, period, grid, kern)
    assert not kern["mse"][0].any() and int(kern["best"][0]) == 0  # no fit slot
    # slots after each row's last fit slot and its first period enter
    # nothing: scrambled, the outputs keep their bits
    t = torch.arange(T, device=card)
    last = torch.where(fit & hist, t, -1).amax(1)
    after = t[None] > torch.maximum(last, period.clamp(max=T) - 1)[:, None]
    gen = torch.Generator(device=card).manual_seed(T + 2)
    noise = torch.randn(x.shape, generator=gen, device=card) * 1e4
    x2 = torch.where(after, torch.where(noise > 1.5e4, torch.inf, noise), x).contiguous()
    h2 = torch.where(after, noise > 0, hist).contiguous()
    moved = kernels.hw_fit(x2, h2, fit, period, grid)
    for k in kern:
        assert torch.equal(moved[k], kern[k]), k


@pytest.mark.parametrize("T", [1000, 2048, 16384])
def test_triage_screen_sigma_is_ma_band_sigma(card, T):
    gen = torch.Generator(device=card).manual_seed(T + 3)
    x, m, region, thr, mode, mlb, margin = cs.adversarial_screen(256 if T < 16384 else 64, T, gen)
    kind = torch.arange(x.shape[0], device=card) % 10
    inf_row = kind == 0  # +-inf in a valid history slot
    x[inf_row, T // 7], m[inf_row, T // 7] = torch.inf, True
    x[inf_row, T // 9], m[inf_row, T // 9] = -torch.inf, True
    args = (x, m, region, thr, mode, mlb, margin)
    kern = kernels.triage_screen(x, m, region, cs.TRIAGE_WINDOW, thr, mode, mlb, margin)
    band = kernels.ma_band(x, m, region, cs.TRIAGE_WINDOW, thr, mode, mlb)
    torch.cuda.synchronize()
    cs.check_band_sigma(kern["sigma"], band["sigma"], f"T={T}")
    # the same predictions and sigma: the same counts
    assert torch.equal(kern["count"], band["count"])
    assert torch.equal(kern["checked"], band["checked"])
    assert bool((kern["n_hist"][kind == 1] == 0).all())  # an empty history
    assert bool((kern["sigma"][kind == 3] == 0).all())  # a constant one
    assert not bool(torch.isfinite(kern["sigma"][inf_row]).any())  # NaN: +inf - inf in S
    from foremast_tpu_torch.ops import triage as tr
    finite = ~inf_row
    cs.compare_triage(tuple(a[finite] for a in args), {k: v[finite] for k, v in kern.items()},
                      tr.screen_rows_plain(*(a[finite] for a in args), cs.TRIAGE_WINDOW))


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
    # windows past kernel A's sort index (PAIR_SORT_T) are refused by name
    # before a tensor is read; 16385, past the largest bucket, is served
    T = kernels.PAIR_SORT_T + 1
    args = [torch.from_numpy(a).to(card) for a in fl.pair_arg_spec(2, 16)]
    meta = [torch.empty((2, T), dtype=a.dtype, device="meta") for a in args[:4]]
    with pytest.raises(ValueError, match="PAIR_SORT_T"):
        kernels.pair_verdict(*meta, *args[4:], wilcoxon_table=fl.wilcoxon_pmf_table(card),
                             ks_exact_max=fl.KS_EXACT_MAX_T,
                             wilcoxon_exact_max_n=fl.WILCOXON_EXACT_MAX_N)
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


@pytest.mark.parametrize("path", ["cta", "cluster"])
@pytest.mark.parametrize("T", [128, 2048, 4096, 4100, 4112, 16384])
def test_bivariate_paths_match_twin(card, T, path, monkeypatch):
    """Kernel H on each path forced, across its boundary (4096: one CTA;
    4112: a cluster of two; 4100, no multiple of 16: a slot at a time),
    against the twin with the optional arguments given and left out."""
    from foremast_tpu_torch.ops import bivariate as bv

    monkeypatch.setattr(kernels, "BIVARIATE_FORCE", path)
    gen = torch.Generator(device=card).manual_seed(T + 1)
    args = cs.adversarial_bivariate(192 if T < 16384 else 96, T, gen)
    for a in (args, args[:6]):
        before = kernels.bivariate_path_launches[path]
        kern = kernels.bivariate(*a)
        assert kernels.bivariate_path_launches[path] == before + 1
        cs.compare_bivariate(a, kern, bv.bivariate_normal_anomalies_plain(*a))


def test_bivariate_takes_its_path_by_shape(card):
    from foremast_tpu_torch.ops import bivariate as bv

    gen = torch.Generator(device=card).manual_seed(3)
    for T, path in ((4096, "cta"), (4112, "cluster")):
        args = cs.adversarial_bivariate(24, T, gen)
        kernels.reset_launches()
        bv.bivariate_normal_anomalies(*args)
        assert kernels.bivariate_path_launches == {p: int(p == path) for p in
                                                   kernels.BIVARIATE_PATHS}


def test_bivariate_size_functions_mirror_the_library(card):
    lib = kernels.build.library()
    for T in (1, 15, 16, 100, 2048, 4095, 4096, 4097, 4112, 8192, 8193, 16384):
        for cl in (1, 2, 3, 4, 8):
            assert lib.fm_bivariate_smem_bytes(T, cl) == kernels.bivariate_smem_bytes(T, cl)


@pytest.mark.parametrize("T", [2048, 16384])
def test_bivariate_phase_clocks(card, T):
    """Kernel H's cycle counts a row (rank 0's first thread on the cluster
    path): every phase non-negative (the stamps monotone), some cycles in
    every row, and the stamped launch's outputs equal the unstamped ones."""
    gen = torch.Generator(device=card).manual_seed(9)
    args = cs.adversarial_bivariate(96, T, gen)
    clocks = torch.full((96, len(kernels.BI_PHASES)), -1, dtype=torch.int64, device=card)
    plain = kernels.bivariate(*args)
    timed = kernels.bivariate(*args, phase_clocks=clocks)
    torch.cuda.synchronize()
    for k in plain:
        nan = torch.isnan(plain[k].float()) & torch.isnan(timed[k].float())
        assert torch.equal(plain[k][~nan], timed[k][~nan]), k
    assert bool((clocks >= 0).all()) and bool((clocks.sum(1) > 0).all())


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


@pytest.mark.parametrize("T,C,order", [(301, 24, 3), (1027, 0, 0), (301, 0, 3), (4099, 12, 3)])
def test_st_fit_matches_twin_at_its_edges(card, T, C, order):
    """D = 32 (24 hinges), D = 2 (no hinge, no Fourier order), T no multiple
    of 4 or of a warp's 32 slots, a row with no selected slot; two runs
    equal bit for bit."""
    gen = torch.Generator(device=card).manual_seed(T + C)
    x, m, fit, period = cs.adversarial_st(288, T, gen)
    fit[5] = False
    args = (x, m, fit, period)
    kern = kernels.st_fit(*args, order, C, 1e-4, 3e-3, 3)
    again = kernels.st_fit(*args, order, C, 1e-4, 3e-3, 3)
    plain = fc.fit_seasonal_trend_plain(*args, order, 1e-4, C, 3e-3, 3)
    torch.cuda.synchronize()
    cs.compare_st_fit(args, kern, plain, 2 + C + 2 * order)
    assert torch.equal(kern[0], again[0]) and torch.equal(kern[1], again[1])


def test_st_fit_sincosf_rounds_as_sinf_and_cosf(card):
    """Kernel J takes a Fourier pair's sine and cosine from one sincosf: on
    every float32 argument it must give sinf's and cosf's bits."""
    assert kernels.st_sincos_check() == 0


@pytest.mark.parametrize("F,H,Z,K", [(4, 32, 16, 1), (4, 32, 16, 11), (3, 32, 16, 45),
                                     (32, 256, 256, 3)])
def test_lstm_train_forward_matches_the_twin(card, F, H, Z, K):
    """K = 1, K no whole number of a CTA's windows, the engine's 45 and the
    widest the launcher takes: the loss from num and cnt within 1e-5
    relative of the twin's, NaN jobs alike; two runs equal bit for bit."""
    from foremast_tpu_torch.models import lstm_ae as tl

    gen = torch.Generator(device=card).manual_seed(F + H + K)
    p, x, m = cs.adversarial_lstm_train(16, max(K, 2), 16, F, H, Z, gen)
    x, m = x[:, :K].contiguous(), m[:, :K].contiguous()
    out = kernels.lstm_train_forward(p, x, m, H, Z)
    again = kernels.lstm_train_forward(p, x, m, H, Z)
    loss = out[0].sum(1).float() / out[1].sum(1).float().clamp(min=1.0)
    want = tl.loss_plain(p, x, m, H, Z)
    torch.cuda.synchronize()
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(loss), nan)
    torch.testing.assert_close(loss[~nan], want[~nan], rtol=1e-5, atol=1e-7)
    for a, b in zip(out, again):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


@pytest.mark.parametrize("K", [1, 11, 45])
def test_lstm_train_forward_tile_path_equals_the_wide_path(card, K, monkeypatch):
    """The tile path (a job's windows a CTA) gives the wide path's (eight
    windows a CTA) act, num and cnt bit for bit."""
    gen = torch.Generator(device=card).manual_seed(K)
    p, x, m = cs.adversarial_lstm_train(24, max(K, 2), 32, 4, 32, 16, gen)
    x, m = x[:, :K].contiguous(), m[:, :K].contiguous()
    assert kernels.lstm_train_forward_path(K, 4, 32, 16) == "tile"
    tile = kernels.lstm_train_forward(p, x, m, 32, 16)
    monkeypatch.setattr(kernels, "LSTM_FORWARD_SMEM_BYTES", 0)
    wide = kernels.lstm_train_forward(p, x, m, 32, 16)
    for a, b in zip(tile, wide):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))


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


@pytest.mark.parametrize("J,K,F,H,Z", cs.LSTM_AE_PATH_CASES + ((96, 6, 4, 128, 64),
                                                          (48, 3, 4, 40, 8)))
def test_lstm_ae_paths_match_the_twin_and_one_another(card, J, K, F, H, Z):
    """Each of kernel K's paths that serves a shape (forced by
    kernels.LSTM_AE_FORCE) against the twin, and the paths equal to the wide
    path's bits; J = 1 over 3,000 windows; fully masked windows score 0."""
    gen = torch.Generator(device=card).manual_seed(J * K + F * H + Z)
    p, x, m, mu, sigma = cs.adversarial_lstm(J, max(K, 2), F, H, Z, gen)
    x, m = x[:, :K].contiguous(), m[:, :K].contiguous()
    _, paths = cs.lstm_ae_paths_agree(p, x, m, H, Z, mu, sigma)
    chosen = "wide" if H <= 32 and F > 16 else "warp" if H <= 32 else "cluster"
    assert kernels.lstm_ae_path(K, F, H, Z) == chosen
    assert paths == ((chosen, "wide") if chosen != "wide" else ("wide",))


def test_lstm_ae_counts_its_launches_by_path(card, monkeypatch):
    """One launch a call, counted under lstm_ae and under the path taken."""
    gen = torch.Generator(device=card).manual_seed(5)
    for F, H, Z, path in ((4, 32, 16, "warp"), (4, 128, 64, "cluster"), (4, 32, 16, "wide")):
        monkeypatch.setattr(kernels, "LSTM_AE_FORCE", path if path == "wide" else None)
        p, x, m, mu, sigma = cs.adversarial_lstm(8, 2, F, H, Z, gen)
        before, by_path = kernels.launches["lstm_ae"], dict(kernels.lstm_ae_path_launches)
        kernels.lstm_ae(p, x, m, H, Z, mu, sigma)
        assert kernels.launches["lstm_ae"] == before + 1
        assert kernels.lstm_ae_path_launches[path] == by_path[path] + 1


def test_lstm_ae_size_functions_mirror_the_library(card):
    """The path chooser's pure-Python sizes equal the library's."""
    lib = kernels.build.library()
    for J, K, NW in ((1, 3000, 4), (100_000, 2, 2), (10_000, 45, 4), (3, 7, 2)):
        assert kernels.lstm_ae_chunk_windows(J, K, NW) == lib.fm_lstm_ae_chunk_windows(J, K, NW)
    for F, H, Z, NW, KW in ((4, 32, 16, 4, 16), (9, 10, 6, 2, 8), (32, 32, 256, 2, 2)):
        assert kernels.lstm_ae_warp_smem_bytes(F, H, Z, NW, KW) == \
            lib.fm_lstm_ae_warp_smem_bytes(F, H, Z, NW, KW)
    for W, F, H, Z, NW, KW in ((32, 4, 128, 64, 2, 2), (7, 3, 33, 5, 4, 16),
                               (32, 4, 256, 256, 2, 4)):
        assert kernels.lstm_ae_cluster_smem_bytes(W, F, H, Z, NW, KW) == \
            lib.fm_lstm_ae_cluster_smem_bytes(W, F, H, Z, NW, KW)


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
@pytest.mark.parametrize("F,H,Z", cs.LSTM_TRAIN_WIDTHS)
def test_lstm_train_matches_autograd_through_the_twin(card, F, H, Z, W):
    """From kernel K's widths to the widest the launchers take (H = Z =
    256), on K = 11 windows a job: no whole number of the recurrence
    entry's window blocks."""
    from foremast_tpu_torch.models import lstm_ae as tl

    K = 11
    assert K % kernels.lstm_bptt_blocks(K, H)[0] != 0
    gen = torch.Generator(device=card).manual_seed(F * H + Z + W)
    p, x, m = cs.adversarial_lstm_train(32, K, W, F, H, Z, gen)
    names = ("lstm_train_forward", "lstm_train_recurrence", "lstm_train_wgrad")
    before = [kernels.launches[k] for k in names]
    kern = tl.loss_and_grad(p, x, m, hidden=H, latent=Z)
    assert [kernels.launches[k] for k in names] == [n + 1 for n in before]
    q = p.clone().requires_grad_(True)
    loss = tl.loss_plain(q, x, m, H, Z)
    grad, = torch.autograd.grad(loss.sum(), q)
    cs.compare_lstm_train(kern, (loss.detach(), grad))


@pytest.mark.parametrize("F,H,Z", [(4, 32, 16), (4, 128, 64)])
def test_lstm_train_backward_gives_the_same_bits_twice(card, F, H, Z):
    gen = torch.Generator(device=card).manual_seed(H + 1)
    p, x, m = cs.adversarial_lstm_train(24, 19, 32, F, H, Z, gen)
    act = kernels.lstm_train_forward(p, x, m, H, Z)[2]
    cs.lstm_backward_twice(p, x, m, act, H, Z)


@pytest.mark.parametrize("F,H,Z", cs.LSTM_TRAIN_WIDTHS)
def test_lstm_train_wgrad_matches_its_twin(card, F, H, Z):
    """The weight-gradient entry against wgrad_plain on what the recurrence
    entry leaves, on K = 11 windows a job."""
    gen = torch.Generator(device=card).manual_seed(F * H + Z)
    p, x, m = cs.adversarial_lstm_train(32, 11, 32, F, H, Z, gen)
    act = kernels.lstm_train_forward(p, x, m, H, Z)[2]
    cs.compare_lstm_wgrad(p, x, m, act, H, Z)


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


def test_lstm_ae_loss_refuses_a_second_backward_over_consumed_activations(card):
    from foremast_tpu_torch.models import lstm_ae as tl

    gen = torch.Generator(device=card).manual_seed(2)
    p, x, m = cs.adversarial_lstm_train(4, 3, 8, 4, 32, 16, gen)
    loss = tl.LstmAeLoss.apply(p.clone().requires_grad_(True), x, m, 32, 16).sum()
    loss.backward(retain_graph=True)
    with pytest.raises(RuntimeError, match="consumed"):
        loss.backward()


def test_adam_is_bit_for_bit_on_one_gradient_block_and_six_count_blocks(card):
    """The engine's shape: K = 45 windows give the forward six count blocks
    (num, cnt (J, 6)), the backward one gradient row a job (J, 1, P)."""
    gen = torch.Generator(device=card).manual_seed(45)
    p, x, m = cs.adversarial_lstm_train(40, 45, 32, 4, 32, 16, gen)
    num, cnt, act = kernels.lstm_train_forward(p, x, m, 32, 16)
    gpart = kernels.lstm_train_backward(p, x, m, act, 32, 16)
    assert gpart.shape[1] == 1 and cnt.shape[1] == 6
    step = torch.randint(1, 3000, (40,), generator=gen, device=card, dtype=torch.int32)
    mu = 1e-3 * torch.randn(p.shape, generator=gen, device=card)
    nu = 1e-6 * torch.rand(p.shape, generator=gen, device=card)
    assert cs.compare_adam(p, mu, nu, step, gpart, num, cnt) == 0.0


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


@pytest.mark.parametrize("T", [100, 2048, 16384])
def test_detect_period_edge_rows_match_twin(card, T):
    """Kernel F on chip_smoke.period_edge_rows: spans ending early, all
    padding, a span shorter than every lag, NaN and +inf under and outside
    the mask, constant spans, candidates past the spans and past T."""
    gen = torch.Generator(device=card).manual_seed(T)
    x, hist, cands = cs.period_edge_rows(256 if T < 16384 else 64, T, gen)
    B = x.shape[0]
    fb = torch.full((B,), 7, dtype=torch.int32, device=card)
    kern = kernels.detect_period(x, hist, torch.tensor(cands, dtype=torch.int32, device=card),
                                 fb, 0.2, 0.05, 0.01)
    torch.cuda.synchronize()
    cs.compare_detect_period(x, hist, cands, fb, kern)
    kind = torch.arange(B, device=card) % 8
    assert bool((kern[0][kind == 6] == 7).all())  # constant spans keep their fallback


def test_detect_period_takes_max_candidates(card):
    """TILE_CANDIDATES candidates, 2 to 1025: 1,536 distinct lags, in batches."""
    gen = torch.Generator(device=card).manual_seed(1024)
    x, m, region = cs.adversarial_series(64, 4096, gen)[:3]
    hist = m & ~region
    cands = tuple(range(2, 2 + kernels.TILE_CANDIDATES))
    fb = torch.full((64,), 7, dtype=torch.int32, device=card)
    kern = kernels.detect_period(x, hist, torch.tensor(cands, dtype=torch.int32, device=card),
                                 fb, 0.2, 0.05, 0.01)
    torch.cuda.synchronize()
    cs.compare_detect_period(x, hist, cands, fb, kern)


def _same_bits(a, b):
    return a.shape == b.shape and bool((a.view(torch.int32) == b.view(torch.int32)).all())


def test_detect_period_phase_clocks(card):
    """Kernel F's per-row cycle counts: non-negative, some cycles in every
    row, and the outputs of a stamped launch equal the unstamped ones."""
    gen = torch.Generator(device=card).manual_seed(5)
    args, _, _ = cs.season_inputs(gen, rows=512, dev=card)
    x, mask, region = args[:3]
    hist = mask & ~region
    B = x.shape[0]
    cand = torch.tensor(cs.PERIOD_CANDIDATES, dtype=torch.int32, device=card)
    fb = torch.full((B,), 1440, dtype=torch.int32, device=card)
    clocks = torch.full((B, len(kernels.PERIOD_PHASES)), -1, dtype=torch.int64, device=card)
    plain = kernels.detect_period(x, hist, cand, fb, 0.2, 0.05, 0.01)
    timed = kernels.detect_period(x, hist, cand, fb, 0.2, 0.05, 0.01, phase_clocks=clocks)
    torch.cuda.synchronize()
    assert torch.equal(plain[0], timed[0]) and _same_bits(plain[1], timed[1])
    assert bool((clocks >= 0).all()) and bool((clocks.sum(1) > 0).all())


@pytest.mark.parametrize("sigma", [True, False], ids=["sigma-given", "sigma-computed"])
@pytest.mark.parametrize("T", [100, 2048, 16384])
def test_hpa_score_edge_rows_match_twin(card, T, sigma):
    """Kernel I on chip_smoke.hpa_edge_rows: NaN at a valid history slot,
    +inf at a region slot, x - xm overflowing outside the selection, NaN at
    masked and padding slots; at 16384 the engine's 10,080 + 30 layout."""
    gen = torch.Generator(device=card).manual_seed(T + sigma)
    a = cs.hpa_edge_rows(256 if T < 16384 else 64, T, gen)
    kw = {k: a[k] for k in cs.HPA_OPTIONAL}
    if sigma:
        kw["tps_sigma"] = a["tps_sigma"]
    kern = kernels.hpa_score(*cs.hpa_series(a), **kw)
    torch.cuda.synchronize()
    cs.compare_hpa(a, kern, sigma)


def test_hpa_score_phase_clocks(card):
    """Kernel I's per-row cycle counts, both entries: non-negative, some
    cycles in every row, the outputs of a stamped launch equal the
    unstamped ones (NaN where they are NaN)."""
    gen = torch.Generator(device=card).manual_seed(6)
    a = cs.adversarial_hpa(256, 16384, gen)
    B = a["tps"].shape[0]
    for extra in ({}, {"tps_sigma": a["tps_sigma"]}):
        clocks = torch.full((B, len(kernels.HPA_PHASES)), -1, dtype=torch.int64, device=card)
        plain = kernels.hpa_score(*cs.hpa_series(a), **extra)
        timed = kernels.hpa_score(*cs.hpa_series(a), **extra, phase_clocks=clocks)
        torch.cuda.synchronize()
        for k in plain:
            nan = torch.isnan(plain[k].float()) & torch.isnan(timed[k].float())
            assert torch.equal(plain[k][~nan], timed[k][~nan]), k
        assert bool((clocks >= 0).all()) and bool((clocks.sum(1) > 0).all())


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


def _a_kw(card):
    return dict(wilcoxon_table=fl.wilcoxon_pmf_table(card), ks_exact_max=fl.KS_EXACT_MAX_T,
                wilcoxon_exact_max_n=fl.WILCOXON_EXACT_MAX_N)


@pytest.mark.parametrize("path", kernels.PAIR_PATHS)
@pytest.mark.parametrize("T", [16, 128, 256])
def test_pair_verdict_paths_match_twin(card, T, path):
    t = fl.pair_args_from_numpy(cs.adversarial_pairs(512, T, np.random.default_rng(T + 1)), card)
    kernels.reset_launches()
    kern = kernels.pair_verdict(*t, **_a_kw(card), path=path)
    assert kernels.pair_path_launches[path] == 1 and kernels.launches["pair_verdict"] == 1
    plain = fl.pair_verdict_plain(*t)
    torch.cuda.synchronize()
    err, _ = cs.compare_pair_verdict(t, kern, plain)
    assert err <= cs.P_ATOL


@pytest.mark.parametrize("path", kernels.PAIR_PATHS)
@pytest.mark.parametrize("T", [16, 128, 256])
def test_pair_tests_paths_match_twin(card, T, path):
    from foremast_tpu_torch.ops import pairwise as pw

    x, xm, y, ym = (torch.from_numpy(a).to(card)
                    for a in cs.adversarial_tests(512, T, np.random.default_rng(T + 2)))
    plain = pw.two_sample_tests_plain(x, xm, y, ym)
    plain["sign"] = pw.sign_test_exact_plain(x, y, xm & ym)
    kernels.reset_launches()
    kern = kernels.pair_tests(x, xm, y, ym, 31, **_a_kw(card), path=path)
    assert kernels.pair_tests_path_launches[path] == 1
    cs.compare_pair_tests(kern, plain, pw.TWO_SAMPLE_TESTS + ("sign",))


@pytest.mark.parametrize("T", [16, 128, 256])
def test_pair_verdict_warp_path_equals_cta_path_bit_for_bit(card, T):
    # 2,047 pairs: the last of the warp path's CTAs holds three
    t = fl.pair_args_from_numpy(cs.adversarial_pairs(2047, T, np.random.default_rng(T + 3)),
                                card)
    warp = kernels.pair_verdict(*t, **_a_kw(card), path="warp")
    cta = kernels.pair_verdict(*t, **_a_kw(card), path="cta")
    torch.cuda.synchronize()
    assert set(warp) == set(cta) and len(warp) == 7
    for key in cta:
        assert cs.same_bits(warp[key], cta[key]), key


@pytest.mark.parametrize("T", [16, 128, 256])
def test_pair_tests_warp_path_equals_cta_path_bit_for_bit(card, T):
    x, xm, y, ym = (torch.from_numpy(a).to(card)
                    for a in cs.adversarial_tests(1023, T, np.random.default_rng(T + 4)))
    for mask in range(1, 32):
        ws, wp = kernels.pair_tests(x, xm, y, ym, mask, **_a_kw(card), path="warp")
        cs_, cp = kernels.pair_tests(x, xm, y, ym, mask, **_a_kw(card), path="cta")
        assert cs.same_bits(ws, cs_) and cs.same_bits(wp, cp), mask


@pytest.mark.parametrize("B", [1, kernels.PAIR_WARPS - 1, kernels.PAIR_WARPS + 1, 1001])
def test_pair_warp_path_takes_any_number_of_pairs(card, B):
    t = fl.pair_args_from_numpy(cs.adversarial_pairs(B, 128, np.random.default_rng(B)), card)
    warp = kernels.pair_verdict(*t, **_a_kw(card), path="warp")
    cta = kernels.pair_verdict(*t, **_a_kw(card), path="cta")
    ws, wp = kernels.pair_tests(*t[:4], 31, **_a_kw(card), path="warp")
    cs_, cp = kernels.pair_tests(*t[:4], 31, **_a_kw(card), path="cta")
    torch.cuda.synchronize()
    for key in cta:
        assert cs.same_bits(warp[key], cta[key]), key
    assert cs.same_bits(ws, cs_) and cs.same_bits(wp, cp)


def test_ks_division_equals_ieee_division_where_the_lattice_takes_it(card):
    res = kernels.ks_division_check()
    assert res["above"] == 0, res


def test_pair_warp_path_phase_clocks(card):
    from foremast_tpu_torch.ops import pairwise as pw

    B = 257
    t = fl.pair_args_from_numpy(cs.adversarial_pairs(B, 128, np.random.default_rng(8)), card)
    clocks = torch.zeros((B, len(kernels.PAIR_PHASES) + 1), dtype=torch.int64, device=card)
    stamped = kernels.pair_verdict(*t, **_a_kw(card), phase_clocks=clocks, path="warp")
    plain = kernels.pair_verdict(*t, **_a_kw(card), path="warp")
    tclocks = torch.zeros((B, len(kernels.TESTS_PHASES) + 1), dtype=torch.int64, device=card)
    n_stamped = kernels.pair_tests(*t[:4], 31, **_a_kw(card), phase_clocks=tclocks)
    n_plain = kernels.pair_tests(*t[:4], 31, **_a_kw(card))
    torch.cuda.synchronize()
    for c in (clocks, tclocks):
        assert bool((c[:, 0] > 0).all())
        assert bool((c.diff(dim=1) >= 0).all())
    for key in plain:
        assert cs.same_bits(stamped[key], plain[key]), key
    assert all(cs.same_bits(u, v) for u, v in zip(n_stamped, n_plain))
    assert kernels.PAIR_WARPS == kernels.build.library().fm_pair_warps()


@pytest.mark.parametrize("T", [8, 256, 16384])
def test_rank_and_ties_matches_twin(card, T):
    from foremast_tpu_torch.ops import ranks as rk

    v, m = (torch.from_numpy(a).to(card)
            for a in cs.adversarial_ranks(24, T, np.random.default_rng(T)))
    cs.compare_ranks(rk.rank_and_ties(v, m, device=card), rk.rank_and_ties_plain(v, m))
    r, tie, n = rk.rank_and_ties(v[0], m[0], device=card)
    assert r.shape == (T,) and tie.shape == () and n.shape == ()


@pytest.mark.parametrize("T", [8, 100, 256, 512])
def test_rank_and_ties_warp_path_gives_the_cta_path_s_bits(card, T):
    """rank_and_ties' warp path (its default up to WARP_RANK_KEYS) against
    the CTA path and the scratch path bit for bit, and against the twin, on
    adversarial rows (ties, +-0, NaN and +inf, all masked, all tied, one
    valid point), in whole CTAs of rows and a ragged last one."""
    from foremast_tpu_torch.ops import ranks as rk

    B = 8 * kernels.KRUSKAL_WARPS + 3
    v, m = (torch.from_numpy(a).to(card)
            for a in cs.adversarial_ranks(B, T, np.random.default_rng(T + 5)))
    kernels.reset_launches()
    got = kernels.rank_and_ties(v, m)
    assert kernels.rank_path(T) == "warp" and kernels.rank_path_launches["warp"] == 1
    for path in ("cta", "scratch"):
        other = kernels.rank_and_ties(v, m, path=path)
        torch.cuda.synchronize()
        assert all(cs.same_bits(a, b) for a, b in zip(got, other)), path
    cs.compare_ranks(got, rk.rank_and_ties_plain(v, m))
    # rows of T - 1 slots, not whole float4s: the warp path's scalar loads
    v1, m1 = v[:, 1:].contiguous(), m[:, 1:].contiguous()
    warp1, cta1 = kernels.rank_and_ties(v1, m1), kernels.rank_and_ties(v1, m1, path="cta")
    torch.cuda.synchronize()
    assert all(cs.same_bits(a, b) for a, b in zip(warp1, cta1))


@pytest.mark.parametrize("path", kernels.RANK_PATHS)
def test_rank_and_ties_phase_clocks(card, path):
    """The warp path's stamps; the cta and scratch paths refuse them."""
    B, T = 257, 256
    v, m = (torch.from_numpy(a).to(card)
            for a in cs.adversarial_ranks(B, T, np.random.default_rng(12)))
    clocks = torch.zeros((B, len(kernels.RANK_PHASES) + 1), dtype=torch.int64, device=card)
    if path != "warp":
        with pytest.raises(ValueError, match="warp path alone"):
            kernels.rank_and_ties(v, m, phase_clocks=clocks, path=path)
        return
    stamped = kernels.rank_and_ties(v, m, phase_clocks=clocks, path=path)
    plain = kernels.rank_and_ties(v, m, path=path)
    torch.cuda.synchronize()
    assert bool((clocks[:, 0] > 0).all())
    assert bool((clocks.diff(dim=1) >= 0).all())
    assert all(cs.same_bits(u, w) for u, w in zip(stamped, plain))


@pytest.mark.parametrize("k,T", [(2, 64), (3, 128), (5, 64), (3, 16384)])
def test_kruskal_groups_match_twin(card, k, T):
    from foremast_tpu_torch.ops import pairwise as pw

    g, gm = (torch.from_numpy(a).to(card)
             for a in cs.adversarial_groups(16, k, T, np.random.default_rng(k * T)))
    H, p = pw.kruskal_batch(g, gm, device=card)
    pH, pp = pw.kruskal_plain(g, gm)
    cs.close(H, pH, cs.STAT_RTOL, 1e-6, "H")
    cs.close(p, pp, 0.0, cs.P_ATOL, "p")


KRUSKAL_WARP_SHAPES = [(k, T) for k, T in cs.KRUSKAL_CHECK if k * T <= 512] + [(4, 128)]


@pytest.mark.parametrize("path", kernels.KRUSKAL_PATHS)
@pytest.mark.parametrize("k,T", cs.KRUSKAL_CHECK + ((4, 128), (1, 128), (1, 4096), (1, 16384)))
def test_kruskal_groups_paths_match_twin(card, k, T, path):
    from foremast_tpu_torch.ops import pairwise as pw

    if not kernels.kruskal_serves(path, k, T):
        with pytest.raises(ValueError, match="k T <="):
            kernels.kruskal_groups(torch.zeros(2, k, T, device=card),
                                   torch.ones(2, k, T, dtype=torch.bool, device=card), path=path)
        return
    g, gm = (torch.from_numpy(a).to(card)
             for a in cs.adversarial_groups(48, k, T, np.random.default_rng(k * T + 1)))
    kernels.reset_launches()
    H, p = kernels.kruskal_groups(g, gm, path=path)
    assert kernels.kruskal_path_launches[path] == 1 and kernels.launches["kruskal_groups"] == 1
    pH, pp = pw.kruskal_plain(g, gm)
    cs.close(H, pH, cs.STAT_RTOL, 1e-6, "H")
    cs.close(p, pp, 0.0, cs.P_ATOL, "p")


@pytest.mark.parametrize("k,T", KRUSKAL_WARP_SHAPES)
def test_kruskal_warp_path_equals_cta_path_bit_for_bit(card, k, T):
    # adversarial_groups' rows: ties with +-0, NaN and +inf in valid slots,
    # fully masked groups and rows; 1,023 rows: the last CTA holds three
    g, gm = (torch.from_numpy(a).to(card)
             for a in cs.adversarial_groups(1023, k, T, np.random.default_rng(k * T + 2)))
    gm[5] = False  # a fully masked row
    gm[7, 1] = False  # a fully masked group
    warp = kernels.kruskal_groups(g, gm, path="warp")
    cta = kernels.kruskal_groups(g, gm, path="cta")
    torch.cuda.synchronize()
    assert cs.same_bits(warp[0], cta[0]) and cs.same_bits(warp[1], cta[1])
    assert float(warp[1][5]) == 1.0 and float(warp[0][5]) == 0.0


@pytest.mark.parametrize("B", [1, kernels.KRUSKAL_WARPS - 1, kernels.KRUSKAL_WARPS + 1, 1001])
def test_kruskal_warp_path_takes_any_number_of_rows(card, B):
    g, gm = (torch.from_numpy(a).to(card)
             for a in cs.adversarial_groups(B, 3, 128, np.random.default_rng(B)))
    warp = kernels.kruskal_groups(g, gm, path="warp")
    cta = kernels.kruskal_groups(g, gm, path="cta")
    torch.cuda.synchronize()
    assert cs.same_bits(warp[0], cta[0]) and cs.same_bits(warp[1], cta[1])


@pytest.mark.parametrize("path", kernels.KRUSKAL_PATHS)
def test_kruskal_groups_phase_clocks(card, path):
    B, k, T = 257, 3, 128
    g, gm = (torch.from_numpy(a).to(card)
             for a in cs.adversarial_groups(B, k, T, np.random.default_rng(9)))
    clocks = torch.zeros((B, len(kernels.KRUSKAL_PHASES) + 1), dtype=torch.int64, device=card)
    stamped = kernels.kruskal_groups(g, gm, phase_clocks=clocks, path=path)
    plain = kernels.kruskal_groups(g, gm, path=path)
    torch.cuda.synchronize()
    assert bool((clocks[:, 0] > 0).all())
    assert bool((clocks.diff(dim=1) >= 0).all())
    assert all(cs.same_bits(u, v) for u, v in zip(stamped, plain))
    lib = kernels.build.library()
    assert kernels.KRUSKAL_WARPS == lib.fm_kruskal_warps()
    assert kernels.WARP_RANK_KEYS == lib.fm_warp_rank_keys()


@pytest.mark.parametrize("T", [128, 1000, 1024, 2048, 4096, 16384])
def test_ma_band_paths_give_the_first_design_s_bits(card, T):
    """ma_band's path for T against the first design (the unstaged path)
    bit for bit on adversarial rows, and against the twin."""
    gen = torch.Generator(device=card).manual_seed(T + 11)
    args = cs.adversarial_bands(512 if T <= 4096 else 128, T, gen)
    kernels.reset_launches()
    got = kernels.ma_band(*args[:3], 30, *args[3:])
    assert kernels.band_path_launches[kernels.band_path(T)] == 1
    first = kernels.ma_band(*args[:3], 30, *args[3:], path="unstaged")
    torch.cuda.synchronize()
    assert set(got) == set(first) and len(got) == 8
    for key in first:
        assert cs.same_bits(got[key], first[key]), key
    cs.compare_ma_band(args, 30, got, fc.moving_average_band_plain(*args[:3], 30, *args[3:]))
    for window in (0, 1, 7, 5000):
        a = kernels.ma_band(*args[:3], window, *args[3:])
        b = kernels.ma_band(*args[:3], window, *args[3:], path="unstaged")
        assert all(cs.same_bits(a[key], b[key]) for key in b), window


@pytest.mark.parametrize("T", [4097, 5000, 8192, 16384])
@pytest.mark.parametrize("window", [1, 30, 300])
def test_ma_band_long_path_gives_the_first_design_s_bits(card, T, window):
    """ma_band's long path (its default above STAGED_BAND_T) against the
    first design (the unstaged path) bit for bit on adversarial rows
    (all-masked, a leading gap, gaps longer than the window, one point,
    constant, NaN and +inf, shifted), all 8 outputs, and against the twin."""
    gen = torch.Generator(device=card).manual_seed(T + window)
    args = cs.adversarial_bands(96, T, gen)
    kernels.reset_launches()
    got = kernels.ma_band(*args[:3], window, *args[3:])
    assert kernels.band_path(T) == "long" and kernels.band_path_launches["long"] == 1
    first = kernels.ma_band(*args[:3], window, *args[3:], path="unstaged")
    torch.cuda.synchronize()
    assert set(got) == set(first) and len(got) == 8
    for key in first:
        assert cs.same_bits(got[key], first[key]), key
    cs.compare_ma_band(args, window, got,
                       fc.moving_average_band_plain(*args[:3], window, *args[3:]))


@pytest.mark.parametrize("path", kernels.BAND_PATHS)
def test_ma_band_phase_clocks(card, path):
    gen = torch.Generator(device=card).manual_seed(5)
    # each path at a T it serves
    args = cs.adversarial_bands(257, 8192 if path == "long" else 1024, gen)
    clocks = torch.zeros((257, len(kernels.BAND_PHASES) + 1), dtype=torch.int64, device=card)
    stamped = kernels.ma_band(*args[:3], 30, *args[3:], phase_clocks=clocks, path=path)
    plain = kernels.ma_band(*args[:3], 30, *args[3:], path=path)
    torch.cuda.synchronize()
    assert bool((clocks[:, 0] > 0).all())
    assert bool((clocks.diff(dim=1) >= 0).all())
    assert all(cs.same_bits(stamped[k], plain[k]) for k in plain)
    assert kernels.STAGED_BAND_T == kernels.build.library().fm_staged_band_t()
    assert kernels.build.library().fm_long_band_bytes(kernels.MAX_BAND_T) <= 76_800


@pytest.mark.parametrize("n,k", cs.FRIEDMAN_CHECK)
def test_friedman_matches_twin(card, n, k):
    from foremast_tpu_torch.ops import pairwise as pw

    d, bm = (torch.from_numpy(a).to(card)
             for a in cs.adversarial_friedman(64, n, k, np.random.default_rng(n * k)))
    chi, p = pw.friedman_batch(d, bm, device=card)
    pc, pp = pw.friedman_plain(d, bm)
    cs.close(chi, pc, cs.STAT_RTOL, 1e-5, "chi2")
    cs.close(p, pp, 0.0, cs.P_ATOL, "p")


@pytest.mark.parametrize("n,k", [(128, 3), (20, 6), (7, 16), (300, 2), (33, 4), (9, 8),
                                 (1, 5), (40, 1), (200, 3), (7, 17)])
def test_friedman_warp_path_gives_the_cta_path_s_bits(card, n, k):
    """friedman's default path against the cta path bit for bit on
    adversarial tables (ties with +-0, NaN, masked-out blocks, rows with no
    block and with one), 1,027 rows (a ragged last warp and CTA), and
    against the twin; each path counted."""
    from foremast_tpu_torch.ops import pairwise as pw

    d, bm = (torch.from_numpy(a).to(card)
             for a in cs.adversarial_friedman(1027, n, k, np.random.default_rng(n + k)))
    kernels.reset_launches()
    got = kernels.friedman(d, bm)
    path = kernels.friedman_path(n, k)
    assert kernels.friedman_path_launches[path] == 1 and kernels.launches["friedman"] == 1
    cta = kernels.friedman(d, bm, path="cta")
    torch.cuda.synchronize()
    assert cs.same_bits(got[0], cta[0]) and cs.same_bits(got[1], cta[1])
    pc, pp = pw.friedman_plain(d, bm)
    cs.close(got[0], pc, cs.STAT_RTOL, 1e-5, "chi2")
    cs.close(got[1], pp, 0.0, cs.P_ATOL, "p")
    if k == 1:  # df = 0: p = 0 wherever the statistic is defined
        assert bool((cta[1] == pp).all()) and bool(((pp == 0) | (pp == 1)).all())
    lib = kernels.build.library()
    assert kernels.WARP_FRIEDMAN_K == lib.fm_warp_friedman_k()
    assert kernels.WARP_FRIEDMAN_N == lib.fm_warp_friedman_n()
    assert kernels.FRIEDMAN_WARPS == lib.fm_friedman_warps()
    assert kernels.FRIEDMAN_ROWS == lib.fm_friedman_rows()


@pytest.mark.parametrize("n", [5, 4096, 100_000])
@pytest.mark.parametrize("k", [0, 1, 8, 32])
def test_fleet_topk_select_path_gives_the_chunked_path_s_outputs(card, n, k):
    rng = np.random.default_rng(n + k)
    u, s = (torch.from_numpy(a).to(card) for a in cs.adversarial_topk(n, rng))
    kernels.reset_launches()
    got = kernels.fleet_topk(s, k, u, base=5)
    assert kernels.fleet_topk_path_launches["select"] == 1
    cs.compare_topk(got, kernels.fleet_topk(s, k, u, base=5, path="chunked"), "chunked")
    cs.compare_topk(got, fl.fleet_topk_plain(s, k, u, base=5), "twin")
    assert kernels.FLEET_SELECT_K == kernels.build.library().fm_fleet_select_k()


def test_fleet_topk_twice_and_on_two_streams(card):
    """Kernel P called twice back to back, and on two streams at once,
    gives the same outputs: it keeps no state between launches."""
    rng = np.random.default_rng(3)
    u, s = (torch.from_numpy(a).to(card) for a in cs.adversarial_topk(100_000, rng))
    want = fl.fleet_topk_plain(s, 8, u)
    for path in kernels.FLEET_TOPK_PATHS:
        first = kernels.fleet_topk(s, 8, u, path=path)
        second = kernels.fleet_topk(s, 8, u, path=path)
        streams = [torch.cuda.Stream(), torch.cuda.Stream()]
        outs = []
        torch.cuda.synchronize()
        for st in streams:
            with torch.cuda.stream(st):
                outs.append(kernels.fleet_topk(s, 8, u, path=path))
        torch.cuda.synchronize()
        for got in [first, second] + outs:
            cs.compare_topk(got, want, path)


def test_des_scan_margin_on_sixteen_draws_at_16384(card):
    """Kernel E's DES against its twin (the same maps stepped in float64)
    on 16 seeded draws of 1,024 adversarial rows at T = 16384: the scan
    path, forced, every row within half of compare_scan's limit (P4); the
    walk, which 16,384 rows take by default, the twin's bits."""
    from foremast_tpu_torch.ops import seqscan as sq

    draws = [cs.adversarial_series(1024, 16384, torch.Generator(device=card).manual_seed(
        cs.SEED + 1000 + d))[:5] for d in range(16)]
    x = torch.cat([a[0] for a in draws])
    hist = torch.cat([a[1] & ~a[2] for a in draws])
    al, be = torch.cat([a[3] for a in draws]), torch.cat([a[4] for a in draws])
    del draws
    kern = kernels.affine_scan(kernels.SMOOTH_DES, x, hist, al, be, path="scan")
    twin = sq.des_predictions_assoc_plain(x, hist, al, be)
    assert bool((torch.isnan(kern) == torch.isnan(twin)).all())
    assert float(cs.scan_limit_share(kern, twin, x, hist).max()) <= 0.5
    assert kernels.scan_path(kernels.SMOOTH_DES, x.shape[0], 16384) == "walk"
    assert cs.same_bits_nan(kernels.affine_scan(kernels.SMOOTH_DES, x, hist, al, be), twin)


@pytest.mark.parametrize("T", cs.WALK_CHECK_T)
def test_affine_scan_des_walk_gives_the_twin_s_bits(card, T):
    """Kernel E's walk path at T a multiple of 16 (tiles staged by
    cp.async) and not (element loads), on 1,000 rows (not a multiple of
    32): all-masked rows, masked prefixes, NaN and inf at masked slots,
    alpha and beta at 0 and 1. The scan path, default at this many rows,
    within compare_scan's limit."""
    from foremast_tpu_torch.ops import seqscan as sq

    x, hist, al, be = cs.walk_rows(cs.WALK_CHECK_ROWS, T,
                                   torch.Generator(device=card).manual_seed(T))
    twin = sq.des_predictions_assoc_plain(x, hist, al, be)
    walk = kernels.affine_scan(kernels.SMOOTH_DES, x, hist, al, be, path="walk")
    assert cs.same_bits_nan(walk, twin), cs.max_abs_err(walk, twin)
    cs.compare_scan(kernels.SMOOTH_DES, x, hist, (al, be),
                    kernels.affine_scan(kernels.SMOOTH_DES, x, hist, al, be))


def test_affine_scan_takes_the_walk_from_walk_rows(card):
    x, hist, al, be = cs.walk_rows(kernels.WALK_ROWS, 256,
                                   torch.Generator(device=card).manual_seed(5))
    for B, path in ((kernels.WALK_ROWS - 1, "scan"), (kernels.WALK_ROWS, "walk")):
        kernels.reset_launches()
        kernels.affine_scan(kernels.SMOOTH_DES, x[:B], hist[:B], al[:B], be[:B])
        kernels.affine_scan(kernels.SMOOTH_SES, x[:B], hist[:B], al[:B])
        assert kernels.scan_path_launches == {"scan": 1 + (path == "scan"),
                                              "walk": int(path == "walk")}
    with pytest.raises(ValueError, match="DES"):
        kernels.affine_scan(kernels.SMOOTH_SES, x, hist, al, path="walk")


def test_pairs_past_the_largest_bucket_match_twins(card):
    """Kernels A and N at T = 43,200 (a 30-day window at 60 s) on 64
    adversarial pairs, on their scratch path."""
    from foremast_tpu_torch.ops import pairwise as pw

    args = cs.adversarial_pairs(64, cs.LONG_PAIR_T, np.random.default_rng(43))
    t = fl.pair_args_from_numpy(args, card)
    kernels.reset_launches()
    cs.compare_pair_verdict(t, fl.score_pairs(*t), fl.pair_verdict_plain(*t))
    x, xm, y, ym = t[:4]
    names = pw.TWO_SAMPLE_TESTS
    got = pw.all_pairwise_tests(x, xm, y, ym)
    cs.compare_pair_tests((torch.stack([got[n][0] for n in names], 1),
                           torch.stack([got[n][1] for n in names], 1)),
                          pw.two_sample_tests_plain(x, xm, y, ym), names)
    assert kernels.pair_path_launches["scratch"] == kernels.pair_tests_path_launches["scratch"] == 1


def test_kernel_o_past_two_to_the_20_keys(card):
    """Kruskal-Wallis at 8 groups of 172,800 and the same rows' ranks (the
    scratch path), and a fully tied row of 2^21 + 1 keys, whose tie term
    leaves a signed 64-bit t^3: equal to the float32 of the exact integer."""
    from foremast_tpu_torch.ops import pairwise as pw
    from foremast_tpu_torch.ops import ranks as rk

    k, T, _ = cs.KRUSKAL_LONG
    g, gm = (torch.from_numpy(a).to(card) for a in cs.adversarial_groups(
        2, k, T, np.random.default_rng(k)))
    H, p = kernels.kruskal_groups(g, gm)
    pH, pp = pw.kruskal_plain(g, gm)
    cs.close(H, pH, cs.STAT_RTOL, 1e-6, "H")
    cs.close(p, pp, 0.0, cs.P_ATOL, "p")
    v, m = g.reshape(2, k * T), gm.reshape(2, k * T)
    cs.compare_ranks(kernels.rank_and_ties(v, m), rk.rank_and_ties_plain(v, m))
    n = cs.TIED_KEYS
    r, tie, nv = kernels.rank_and_ties(torch.full((1, n), -1.5, device=card),
                                       torch.ones((1, n), dtype=torch.bool, device=card))
    assert float(tie[0]) == float(np.float32(n ** 3 - n)) and float(nv[0]) == n
    assert bool((r == (n + 1) / 2).all())


def test_fleet_topk_past_one_launch(card, monkeypatch):
    """Kernel P in slices of 1,000 rows (MAX_FLEET_SLICE cut here), keyed
    past 2^32, against the twin on the whole."""
    monkeypatch.setattr(kernels, "MAX_FLEET_SLICE", 1000)
    u, s = (torch.from_numpy(a).to(card) for a in cs.adversarial_topk(
        5003, np.random.default_rng(5003)))
    for k, base in ((8, 0), (33, 7), (500, (1 << 32) + 9)):
        kernels.reset_launches()
        cs.compare_topk(kernels.fleet_topk(s, k, u, base=base),
                        fl.fleet_topk_plain(s, k, u, base=base), f"k={k}")
        assert kernels.launches["fleet_topk"] >= 7


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


# ---------------------------------------------------------------------------
# the paths past the first designs' limits (kernels J, F, K, L)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("C,order", cs.ST_WIDE_CHECK + ((cs.ST_CHANGEPOINTS, cs.ST_ORDER),))
@pytest.mark.parametrize("T", [301, 2048])
def test_st_fit_cta_path_matches_twin(card, T, C, order):
    """Kernel J's cta path at D = 33, 47, 64 and 160 (the gram in device
    scratch), where st_path sends it, and forced at the engine's D = 20;
    a row with no selected slot; two runs equal bit for bit."""
    D = 2 + C + 2 * order
    gen = torch.Generator(device=card).manual_seed(T + D)
    x, m, fit, period = cs.adversarial_st(160, T, gen)
    fit[5] = False
    args = (x, m, fit, period)
    kernels.reset_launches()
    kern = kernels.st_fit(*args, order, C, 1e-4, 3e-3, 3, path="cta")
    assert kernels.st_path_launches == {"warp": 0, "cta": 1}
    assert kernels.st_path(D) == ("cta" if D > kernels.WARP_ST_D else "warp")
    again = kernels.st_fit(*args, order, C, 1e-4, 3e-3, 3, path="cta")
    plain = fc.fit_seasonal_trend_plain(*args, order, 1e-4, C, 3e-3, 3)
    torch.cuda.synchronize()
    cs.compare_st_fit(args, kern, plain, D)
    assert torch.equal(kern[0], again[0]) and torch.equal(kern[1], again[1])
    # G in device scratch from D = 137 (the gram's (8 NB)^2 doubles beside
    # the tile no longer fit a CTA)
    scratch = kernels.build.library().fm_st_cta_scratch_doubles(order, C)
    assert (scratch > 0) == (D > 136)


def test_st_fit_warp_path_refuses_past_its_columns(card):
    x, m, fit, period = cs.adversarial_st(8, 64, torch.Generator(device=card).manual_seed(1))
    with pytest.raises(ValueError, match="WARP_ST_D"):
        kernels.st_fit(x, m, fit, period, 3, 25, 1e-4, 3e-3, 3, path="warp")


@pytest.mark.parametrize("C", [1025, 2048, 3000])
def test_detect_period_tiled_path_matches_twin(card, C):
    """Past TILE_CANDIDATES, the tiled path: candidates ascending (1,025,
    2,048) and descending with duplicates across tiles (3,000), against the
    twin."""
    gen = torch.Generator(device=card).manual_seed(C)
    x, m, region = cs.adversarial_series(64, 4096, gen)[:3]
    hist = m & ~region
    cands = (tuple(range(2, 2 + C)) if C < 3000 else
             tuple(range(2 + 2048, 2, -1)) + tuple(range(2, 2 + C - 2048)))
    fb = torch.full((64,), 7, dtype=torch.int32, device=card)
    kernels.reset_launches()
    kern = kernels.detect_period(x, hist, torch.tensor(cands, dtype=torch.int32, device=card),
                                 fb, 0.2, 0.05, 0.01)
    assert kernels.period_path_launches == {"table": 0, "tiled": 1}
    torch.cuda.synchronize()
    cs.compare_detect_period(x, hist, cands, fb, kern)


@pytest.mark.parametrize("T", [1024, 16384])
def test_detect_period_tiled_path_gives_the_table_path_s_bits(card, T):
    """Up to TILE_CANDIDATES the tiled path forced (a lag table a row)
    gives the table path's periods and scores bit for bit: a lag's score
    does not depend on the lags swept beside it."""
    gen = torch.Generator(device=card).manual_seed(T + 7)
    x, m, region = cs.adversarial_series(256, T, gen)[:3]
    hist = m & ~region
    fb = torch.full((256,), 7, dtype=torch.int32, device=card)
    for cands in ((2, 3, 24) + cs.PERIOD_CANDIDATES, cs.MANY_CANDIDATES):
        ct = torch.tensor(cands, dtype=torch.int32, device=card)
        table = kernels.detect_period(x, hist, ct, fb, 0.2, 0.05, 0.01)
        tiled = kernels.detect_period(x, hist, ct, fb, 0.2, 0.05, 0.01, path="tiled")
        torch.cuda.synchronize()
        assert torch.equal(table[0], tiled[0]) and _same_bits(table[1], tiled[1])
    with pytest.raises(ValueError, match="TILE_CANDIDATES"):
        kernels.detect_period(x, hist, torch.arange(2, 2 + 1025, dtype=torch.int32,
                                                    device=card), fb, 0.2, 0.05, 0.01,
                              path="table")
    assert kernels.TILE_CANDIDATES == kernels.build.library().fm_period_tile_candidates()


@pytest.mark.parametrize("J,K,F,H,Z", cs.LSTM_LIMIT_CASES + ((3, 2, 300, 8, 4),))
def test_lstm_ae_past_the_first_design_s_limits(card, J, K, F, H, Z):
    """Kernel K past 32 metrics a job (F = 33, 40; 300: the head over
    chunks of features) and 256 units (H = 257, 320): the wide path alone
    serves, against the twin."""
    gen = torch.Generator(device=card).manual_seed(F * H + Z)
    p, x, m, mu, sigma = cs.adversarial_lstm(J, K, F, H, Z, gen)
    e, paths = cs.lstm_ae_paths_agree(p, x, m, H, Z, mu, sigma)
    assert paths == ("wide",)


@pytest.mark.parametrize("F,H,Z", [(33, 32, 16), (40, 32, 16), (4, 257, 16), (4, 320, 64),
                                   (3, 8, 4)])
def test_lstm_train_recurrence_wide_path_matches_autograd_through_the_twin(card, F, H, Z):
    """Kernel L past the group path's limits (F = 33, 40; H = 257, 320),
    and its wide recurrence forced at a width the group path serves (F = 3,
    H = 8): loss and gradient against torch autograd through the twin, the
    weight-gradient entry against its twin, two backward runs equal."""
    from foremast_tpu_torch.models import lstm_ae as tl

    gen = torch.Generator(device=card).manual_seed(F * H + Z + 1)
    J, K, W = 16, 11, 8
    p, x, m = cs.adversarial_lstm_train(J, K, W, F, H, Z, gen)
    num, cnt, act = kernels.lstm_train_forward(p, x, m, H, Z)
    kernels.reset_launches()
    rec = kernels.lstm_train_recurrence(p, x, m, act.clone(), H, Z, path="wide")
    assert kernels.bptt_path_launches == {"group": 0, "wide": 1}
    assert rec.shape[:2] == (J, K)
    if kernels.lstm_bptt_path(F, H) == "wide":
        kern = tl.loss_and_grad(p, x, m, hidden=H, latent=Z)
        q = p.clone().requires_grad_(True)
        loss = tl.loss_plain(q, x, m, H, Z)
        grad, = torch.autograd.grad(loss.sum(), q)
        cs.compare_lstm_train(kern, (loss.detach(), grad))
        cs.compare_lstm_wgrad(p, x, m, act, H, Z)
        cs.lstm_backward_twice(p, x, m, act, H, Z)
    else:
        # the wide path's gradient against the group path's, both against
        # the twin's sums (other orders: compare_lstm_wgrad's tolerance)
        group = kernels.lstm_train_backward(p, x, m, act.clone(), H, Z)
        act_w = act.clone()
        rec_w = kernels.lstm_train_recurrence(p, x, m, act_w, H, Z, path="wide")
        wide = kernels.lstm_train_wgrad(p, x, m, act_w, rec_w, H, Z)
        torch.cuda.synchronize()
        scale = group.abs().amax(-1, keepdim=True).clamp(min=1e-30)
        ok = torch.isfinite(group).all(-1, keepdim=True)
        assert bool((((wide - group).abs() / scale)[ok.expand_as(group)] <= 1e-4).all())
    if kernels.lstm_bptt_path(F, H) == "wide":
        with pytest.raises(ValueError, match="GROUP_BPTT"):
            kernels.lstm_train_recurrence(p, x, m, act.clone(), H, Z, path="group")
