"""Batched, mask-aware rank and distribution tests.

Counterpart of the reference's ``ops/pairwise.py``: Mann-Whitney U,
two-group Kruskal-Wallis, two-sample KS and Wilcoxon signed-rank, fused in
`two_sample_tests`, the exact paired sign test, the k-group Kruskal-Wallis
and the Friedman chi-square.

- The plain twins (`mann_whitney_u_plain`, `wilcoxon_signed_rank_plain`,
  `ks_2samp_plain`, `two_sample_tests_plain`, `sign_test_exact_plain`,
  `kruskal_plain`, `friedman_plain`) take (B, T) value tensors and bool
  masks, one window pair per row, and return (B,) float32 tensors on the
  inputs' device. Kernel A (``csrc/pair_verdict.cu``) computes the same
  p-values inside one launch, and ``parallel.fleet`` holds the two
  together.
- The batch entry points (`mann_whitney_u_batch`, `wilcoxon_batch`,
  `ks_2samp_batch`, `kruskal_batch`, `friedman_batch`,
  `all_pairwise_tests`) take numpy or tensors and run kernel N
  (``csrc/pair_tests.cu``) or kernel O (``csrc/rank_groups.cu``) on the
  card, or the twins for device="cpu".
- The reference's single forms (`mann_whitney_u`, `wilcoxon_signed_rank`,
  `ks_2samp`, `two_sample_tests`, `sign_test_exact`, `kruskal_wallis`,
  `friedman_chi_square`) run one pair or table as a batch of one through
  those entry points (the sign test through kernel N's sign entry) and
  return 0-d tensors.

Numerics follow the reference in float32, with deliberate differences
where the reference's float32 drifts from the exact value: rank sums and
tie terms are summed exactly (ranks.py), the Kruskal-Wallis H is
evaluated in float64, and the sign test's binomial tail is summed through
float64 lgamma (the reference's float32 lgamma drifts up to ~5e-5 at
T = 128). Kernel A computes the same integers exactly.
"""
from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

from . import ranks as rk
from .stats import chi2_sf, kolmogorov_sf, norm_sf
from .. import kernels
from .._device import as_tensor, resolve_device
from ..utils import knobs

__all__ = [
    "mann_whitney_u",
    "two_sample_tests",
    "wilcoxon_signed_rank",
    "kruskal_wallis",
    "friedman_chi_square",
    "sign_test_exact",
    "ks_2samp",
    "mann_whitney_u_batch",
    "wilcoxon_batch",
    "kruskal_batch",
    "friedman_batch",
    "ks_2samp_batch",
    "all_pairwise_tests",
    "sign_test_batch",
    "TWO_SAMPLE_TESTS",
    "mann_whitney_u_plain",
    "wilcoxon_signed_rank_plain",
    "ks_2samp_plain",
    "two_sample_tests_plain",
    "sign_test_exact_plain",
    "kruskal_plain",
    "friedman_plain",
    "wilcoxon_pmf_table",
]

_F = torch.float32


def _safe_div(a, b):
    return a / torch.where(b == 0, 1.0, b)


def _squeeze(out):
    if isinstance(out, dict):
        return {k: _squeeze(v) for k, v in out.items()}
    if isinstance(out, tuple):
        return tuple(_squeeze(v) for v in out)
    return out[0]


def _one(batch_fn, *args, device):
    """The reference's single form of a batch entry point: each argument
    (numpy or a tensor) gains a leading batch axis of one, and each output
    loses it."""
    batch = [a[None] if isinstance(a, torch.Tensor) else np.asarray(a)[None] for a in args]
    return _squeeze(batch_fn(*batch, device=device))


# Pairs whose valid counts both fit this bound get the exact finite-n KS
# null; larger samples use the Stephens-corrected asymptotic.
KS_EXACT_MAX_T = knobs.read("FOREMAST_KS_EXACT_MAX_T")


def _ks_exact_sf(t, n1, n2, Ti: int):
    """Exact two-sample KS survival P(D >= t/(n1*n2)), (B,) each.

    The probability-space lattice-path DP of the reference, swept along
    anti-diagonals d = i + j:
        B[i][j] = inside(i,j) * (B[i-1][j] * i + B[i][j-1] * j) / (i + j)
    with the integer band test |i*n2 - j*n1| < t - 0.5. Rows stop mattering
    once d passes n1 + n2; the sweep ends at the largest n1 + n2 of the
    batch, and each row reads B[n1][n2] on its own diagonal. Valid only for
    n1 <= Ti; the caller selects Stephens otherwise.
    """
    dev = t.device
    i = torch.arange(Ti + 1, dtype=_F, device=dev)
    isel = (i[None, :] == n1[:, None]).to(_F)
    diag = torch.where(i[None, :] == 0.0, (t[:, None] > 0.5).to(_F), 0.0)
    zero = torch.zeros((t.shape[0], 1), dtype=_F, device=dev)
    inside_prob = torch.zeros_like(t)
    d_end = int(torch.max(n1 + n2).item()) if t.numel() else 0
    for d in range(1, d_end + 1):
        jd = d - i[None, :]
        inside = (jd >= 0.0) & (
            torch.abs(i[None, :] * n2[:, None] - jd * n1[:, None]) < t[:, None] - 0.5
        )
        up = torch.cat([zero, diag[:, :-1]], dim=1)
        diag = inside.to(_F) * (up * i + diag * jd) / float(d)
        pick = torch.sum(diag * isel, dim=-1)
        inside_prob = torch.where(n1 + n2 == d, pick, inside_prob)
    return torch.clamp(1.0 - inside_prob, 0.0, 1.0)


def _ks_sup(cx, cy, n1, n2, valid):
    """The integer KS statistic t = max |cx n2 - cy n1| over valid points,
    exact (float64 products of integer counts) and rounded once to float32,
    as kernels A and N round their exact integer. The reference's float32
    products round once n1 n2 passes 2^24 (T > 4096 a side); at T = 16384
    that moved a Stephens p by 1.07e-5 against kernel N on the card."""
    stat = torch.abs(cx.double() * n2.double()[:, None] - cy.double() * n1.double()[:, None])
    return torch.amax(torch.where(valid, stat, 0.0), dim=-1).to(_F)


def _ks_pvalue(t, n1, n2, Ti: int, Tj: int):
    """Two-sided KS p-value from the integer sup statistic t.

    Exact when both valid counts fit KS_EXACT_MAX_T (chosen by sample count,
    not by buffer length), else Stephens' asymptotic.
    """
    K = KS_EXACT_MAX_T
    exact = (n1 <= K) & (n2 <= K)
    p_exact = _ks_exact_sf(t, torch.where(exact, n1, 0.0),
                           torch.where(exact, n2, 0.0), min(Ti, K))
    D = _safe_div(t, n1 * n2)
    en = torch.sqrt(_safe_div(n1 * n2, n1 + n2))
    p_asym = kolmogorov_sf((en + 0.12 + _safe_div(torch.full_like(en, 0.11), en)) * D)
    p = torch.where(exact, p_exact, p_asym)
    return torch.where((n1 > 0) & (n2 > 0), p, 1.0)


def _concat_pair(x, x_mask, y, y_mask):
    comb = torch.cat([x, y], dim=1).to(_F)
    cmask = torch.cat([x_mask, y_mask], dim=1)
    from_x = torch.cat([torch.ones_like(x, dtype=_F), torch.zeros_like(y, dtype=_F)], dim=1)
    return comb, cmask, from_x


def _count(mask):
    return torch.sum(mask.to(_F), dim=-1)


def _mw_p(R1, tie, n1, n2, N):
    """(U1, p) of the two-sided Mann-Whitney U with tie and continuity
    corrections, from the rank sum of x."""
    U1 = R1 - n1 * (n1 + 1.0) / 2.0
    U = torch.maximum(U1, n1 * n2 - U1)
    mu = n1 * n2 / 2.0
    s2 = n1 * n2 / 12.0 * ((N + 1.0) - _safe_div(tie, N * (N - 1.0)))
    s = torch.sqrt(torch.clamp(s2, min=0.0))
    z = _safe_div(U - mu - 0.5, s)
    p = torch.where(s > 0.0, torch.clamp(2.0 * norm_sf(z), 0.0, 1.0), 1.0)
    return U1, p


def _kruskal_h(R1, tie, n1, n2):
    """Two-group Kruskal-Wallis H with tie correction, and whether it is
    defined, from the exact float64 rank sum and tie term. Evaluated in
    float64: H is a difference of terms ~N/4 times larger than itself,
    whose float32 rounding moves p by up to ~2e-5 near H = 0 at T = 64
    (the reference's own drift from scipy), and an all-tied sample must
    give a correction of exactly 0."""
    n1, n2 = n1.double(), n2.double()
    N = n1 + n2
    R2 = N * (N + 1.0) / 2.0 - R1
    H = _safe_div(torch.full_like(N, 12.0), N * (N + 1.0)) * (
        _safe_div(R1**2, n1) + _safe_div(R2**2, n2)
    ) - 3.0 * (N + 1.0)
    correction = 1.0 - _safe_div(tie, N**3 - N)
    H = _safe_div(H, correction)
    ok = (correction > 0.0) & (N > 0.0)
    return torch.where(ok, H, 0.0).to(_F), ok


def mann_whitney_u_plain(x, x_mask, y, y_mask):
    """Two-sided Mann-Whitney U (scipy method="asymptotic"): (U1, p)."""
    comb, cmask, from_x = _concat_pair(x, x_mask, y, y_mask)
    R1, tie, _ = rk.rank_sum_stats(comb, cmask, from_x)
    n1, n2 = _count(x_mask), _count(y_mask)
    return _mw_p(R1, tie, n1, n2, n1 + n2)


# The exact signed-rank null serves untied, zero-free samples up to this n.
WILCOXON_EXACT_MAX_N = knobs.read("FOREMAST_WILCOXON_EXACT_MAX_N")


@lru_cache(maxsize=None)
def _wilcoxon_table_cpu(n_max: int) -> torch.Tensor:
    # row k-1 is the pmf of T+ over ranks 1..k: P <- P/2 + (P shifted by k)/2,
    # the reference's float32 subset-sum DP
    W = n_max * (n_max + 1) // 2 + 1
    w = torch.arange(W, dtype=_F)
    P = (w == 0.0).to(_F)
    rows = [torch.zeros((0, W), dtype=_F)] if n_max < 1 else []
    for k in range(1, n_max + 1):
        shifted = torch.where(w >= k, torch.roll(P, k), 0.0)
        P = 0.5 * P + 0.5 * shifted
        rows.append(P[None])
    return torch.cat(rows)


def wilcoxon_pmf_table(device) -> torch.Tensor:
    """(N, N(N+1)/2 + 1) float32 table of the exact signed-rank pmf, row n-1
    for sample size n, N = WILCOXON_EXACT_MAX_N. Built once per process."""
    return _wilcoxon_table_device(torch.device(device))


@lru_cache(maxsize=None)
def _wilcoxon_table_device(device: torch.device) -> torch.Tensor:
    return _wilcoxon_table_cpu(WILCOXON_EXACT_MAX_N).to(device).contiguous()


def _wilcoxon_exact_p(r_plus, n):
    """Exact two-sided signed-rank p: min(1, 2 min(P(T+ <= t), P(T+ >= t))).
    Rows outside 1 <= n <= N read row 0; the caller discards them."""
    table = wilcoxon_pmf_table(r_plus.device)
    if table.shape[0] == 0:
        return torch.ones_like(r_plus)
    W = table.shape[1]
    row = torch.clamp(n.to(torch.int64) - 1, 0, table.shape[0] - 1)
    P = table[row]  # (B, W)
    w = torch.arange(W, dtype=_F, device=r_plus.device)
    cdf = torch.sum(torch.where(w <= r_plus[:, None] + 0.5, P, 0.0), dim=-1)
    sf = torch.sum(torch.where(w >= r_plus[:, None] - 0.5, P, 0.0), dim=-1)
    return torch.clamp(2.0 * torch.minimum(cdf, sf), 0.0, 1.0)


def wilcoxon_signed_rank_plain(x, x_mask, y, y_mask):
    """Paired two-sided Wilcoxon signed-rank: (W = min(T+, T-), p).

    Pairs count where both masks hold; zero differences are dropped. The
    exact null serves untied, zero-free samples with n <= WILCOXON_EXACT_MAX_N;
    every other sample gets the tie-corrected normal approximation.
    """
    both = x_mask & y_mask
    d = torch.where(both, x.to(_F) - y.to(_F), 0.0)
    nonzero = both & (d != 0.0)
    r_plus, tie, n = rk.rank_sum_stats(torch.abs(d), nonzero, (d > 0.0).to(_F))
    total = n * (n + 1.0) / 2.0
    W = torch.minimum(r_plus, total - r_plus)

    mn = n * (n + 1.0) / 4.0
    var = n * (n + 1.0) * (2.0 * n + 1.0) / 24.0 - tie / 48.0
    se = torch.sqrt(torch.clamp(var, min=0.0))
    z = _safe_div(r_plus - mn, se)
    p_approx = torch.where(se > 0.0, torch.clamp(2.0 * norm_sf(torch.abs(z)), 0.0, 1.0), 1.0)

    has_zero = _count(both) > n
    exact_ok = ((tie == 0.0) & ~has_zero & (n >= 1.0)
                & (n <= float(WILCOXON_EXACT_MAX_N)))
    p = torch.where(exact_ok, _wilcoxon_exact_p(r_plus, n), p_approx)
    return W, p


def sign_test_exact_plain(x, y, pair_mask):
    """Exact two-sided paired sign test: (n_untied, p).

    p = min(1, 2 P(X <= min(wins, losses))), X ~ Binom(n, 1/2), summed
    through float64 lgamma over k = 0..T.
    """
    T = x.shape[-1]
    xv, yv = x.to(_F), y.to(_F)
    pos = _count((yv > xv) & pair_mask)
    neg = _count((yv < xv) & pair_mask)
    n = pos + neg
    s = torch.minimum(pos, neg)
    n64, s64 = n.double()[:, None], s.double()[:, None]
    k = torch.arange(T + 1, dtype=torch.float64, device=x.device)
    in_tail = (k <= s64) & (k <= n64)
    nk = torch.clamp(n64 - k + 1.0, min=1.0)
    log_pmf = (torch.lgamma(n64 + 1.0) - torch.lgamma(k + 1.0) - torch.lgamma(nk)
               - n64 * math.log(2.0))
    cdf = torch.sum(torch.where(in_tail, torch.exp(log_pmf), 0.0), dim=-1).to(_F)
    p = torch.clamp(2.0 * cdf, 0.0, 1.0)
    return n, torch.where(n > 0, p, 1.0)


def _le_counts(v, w, pts):
    """(B, P) float32: the weight w (0/1) of the entries of v that are <=
    each point, by direct comparison as the reference counts them, P points
    at a time so that the (B, P, T) comparison stays near 2^24 entries."""
    B, T = v.shape
    if pts.shape[1] == 0:
        return pts.new_zeros(pts.shape)
    step = max(1, (1 << 24) // max(1, B * T))
    return torch.cat([torch.sum((v[:, None, :] <= c[:, :, None]).to(_F) * w[:, None, :], dim=-1)
                      for c in torch.split(pts, step, dim=1)], dim=1)


def ks_2samp_plain(x, x_mask, y, y_mask):
    """Two-sided two-sample KS: (D, p), D = t / (n1 n2) with the integer sup
    statistic t = max |cx n2 - cy n1| over valid points (<= counts)."""
    xv, yv = x.to(_F), y.to(_F)
    xm, ym = x_mask.to(_F), y_mask.to(_F)
    n1, n2 = xm.sum(-1), ym.sum(-1)
    pts = torch.cat([xv, yv], dim=1)
    pts_valid = torch.cat([x_mask, y_mask], dim=1)
    t = _ks_sup(_le_counts(xv, xm, pts), _le_counts(yv, ym, pts), n1, n2, pts_valid)
    return _safe_div(t, n1 * n2), _ks_pvalue(t, n1, n2, x.shape[-1], y.shape[-1])


def two_sample_tests_plain(x, x_mask, y, y_mask):
    """Mann-Whitney + 2-group Kruskal + Wilcoxon + KS from one sorted view.

    Returns {test: (stat (B,), p (B,))}, as the reference's fused family.
    """
    Tx = x.shape[-1]
    comb, cmask, from_x = _concat_pair(x, x_mask, y, y_mask)
    view = rk._sorted_rank_view(comb, cmask, extras=(from_x * cmask.to(_F),))
    (sw,) = view.extras
    R1_exact, tie_exact = rk._exact_sum(view.avg * sw), rk._tie_term(view)
    R1, tie = R1_exact.to(_F), tie_exact.to(_F)
    N = view.n_valid
    n1, n2 = _count(x_mask), _count(y_mask)
    U1, p_mw = _mw_p(R1, tie, n1, n2, N)

    H, ok = _kruskal_h(R1_exact, tie_exact, n1, n2)
    p_k = torch.where(ok, chi2_sf(H, 1.0), 1.0)

    # group-end cumulative counts give #{x <= v} and #{y <= v}
    cx_inc = torch.cumsum(sw, dim=-1)
    cx_end = rk._cummin_rev(torch.where(view.group_end, cx_inc, torch.inf))
    cy_end = view.g1 - cx_end
    t_ks = _ks_sup(cx_end, cy_end, n1, n2, view.sv > 0.0)
    D = _safe_div(t_ks, n1 * n2)
    p_ks = _ks_pvalue(t_ks, n1, n2, Tx, y.shape[-1])

    W, p_w = wilcoxon_signed_rank_plain(x, x_mask, y, y_mask)
    return {
        "mann_whitney": (U1, p_mw),
        "kruskal": (H, p_k),
        "wilcoxon": (W, p_w),
        "ks": (D, p_ks),
    }


def kruskal_plain(groups, masks):
    """Kruskal-Wallis H over k masked groups, tie-corrected, and its
    chi-square p at df = k - 1: (B, k, T) values and bool masks, one set
    of groups per row; (H, p) as (B,) float32. The rank sums and the tie
    term are exact and H is evaluated in float64 (the reference's float32
    H drifts, R2); an undefined H (no valid point, or every point tied) is
    0 with p = 1."""
    B, k, T = groups.shape
    ranks, tie, N = rk.rank_and_ties_exact(groups.reshape(B, k * T).to(_F),
                                           masks.reshape(B, k * T))
    R = ranks.reshape(B, k, T).double().sum(-1)
    n_i = masks.double().sum(-1)
    N = N.double()
    H = (_safe_div(torch.full_like(N, 12.0), N * (N + 1.0))
         * torch.sum(_safe_div(R**2, n_i), dim=-1) - 3.0 * (N + 1.0))
    correction = 1.0 - _safe_div(tie, N**3 - N)
    H = _safe_div(H, correction)
    ok = (correction > 0.0) & (N > 0.0)
    p = torch.where(ok, chi2_sf(H, k - 1.0), 1.0)
    return torch.where(ok, H, 0.0).to(_F), p.to(_F)


def friedman_plain(data, block_mask):
    """Friedman chi-square over n blocks x k treatments, tie-corrected, and
    its p at df = k - 1: (B, n, k) data and (B, n) bool block masks; (chi2,
    p) as (B,) float32. Each block is ranked across its k treatments as
    rank_and_ties ranks a fully valid row (NaN highest, -0.0 == +0.0); only
    the blocks the mask holds count. Sums exact, chi2 in float64."""
    B, n, k = data.shape
    full = torch.ones((B * n, k), dtype=torch.bool, device=data.device)
    ranks, ties, _ = rk.rank_and_ties_exact(data.reshape(B * n, k).to(_F), full)
    bm = block_mask.double()
    Rj = torch.sum(ranks.reshape(B, n, k).double() * bm[..., None], dim=1)
    nb = bm.sum(-1)
    c = 1.0 - _safe_div(torch.sum(ties.reshape(B, n) * bm, dim=-1), nb * k * (k * k - 1.0))
    chisq = (_safe_div(torch.full_like(nb, 12.0), nb * k * (k + 1.0)) * torch.sum(Rj**2, dim=-1)
             - 3.0 * nb * (k + 1.0))
    chisq = _safe_div(chisq, c)
    ok = (c > 0.0) & (nb > 0.0)
    p = torch.where(ok, chi2_sf(chisq, k - 1.0), 1.0)
    return torch.where(ok, chisq, 0.0).to(_F), p.to(_F)


# all_pairwise_tests' family, in kernel N's column order
TWO_SAMPLE_TESTS = ("mann_whitney", "kruskal", "wilcoxon", "ks")


def _pair_batch(x, x_mask, y, y_mask, dev):
    xt = as_tensor(x, _F, dev, "x")
    B, T = xt.shape
    return (xt, as_tensor(x_mask, torch.bool, dev, "x_mask", (B, T)),
            as_tensor(y, _F, dev, "y", (B, T)),
            as_tensor(y_mask, torch.bool, dev, "y_mask", (B, T)))


def _pair_tests(names, x, x_mask, y, y_mask, device):
    """{name: (stat, p)} of the tests `names` on a batch of window pairs:
    kernel N on the card, None for device="cpu" (the caller's twin)."""
    dev = resolve_device(device)
    t = _pair_batch(x, x_mask, y, y_mask, dev)
    if dev.type == "cpu":
        return None, t
    bits = sum(kernels.PAIR_TEST_BITS[n] for n in names)
    stat, p = kernels.pair_tests(*t, bits, wilcoxon_table=wilcoxon_pmf_table(dev),
                                 ks_exact_max=KS_EXACT_MAX_T,
                                 wilcoxon_exact_max_n=WILCOXON_EXACT_MAX_N)
    cols = list(kernels.PAIR_TEST_BITS)
    return {n: (stat[:, cols.index(n)], p[:, cols.index(n)]) for n in names}, t


def mann_whitney_u_batch(x, x_mask, y, y_mask, device=None):
    """Two-sided Mann-Whitney U of B window pairs ((B, T) values, bool
    masks; numpy or tensors): (U1, p), (B,) float32. Kernel N on `device`
    (default "cuda"), the twin for device="cpu"."""
    out, t = _pair_tests(("mann_whitney",), x, x_mask, y, y_mask, device)
    return mann_whitney_u_plain(*t) if out is None else out["mann_whitney"]


def wilcoxon_batch(x, x_mask, y, y_mask, device=None):
    """Paired two-sided Wilcoxon signed-rank of B window pairs: (W, p)."""
    out, t = _pair_tests(("wilcoxon",), x, x_mask, y, y_mask, device)
    return wilcoxon_signed_rank_plain(*t) if out is None else out["wilcoxon"]


def ks_2samp_batch(x, x_mask, y, y_mask, device=None):
    """Two-sided two-sample KS of B window pairs: (D, p)."""
    out, t = _pair_tests(("ks",), x, x_mask, y, y_mask, device)
    return ks_2samp_plain(*t) if out is None else out["ks"]


def all_pairwise_tests(x, x_mask, y, y_mask, device=None):
    """The full two-sample family on B window pairs ((B, T) values, bool
    masks; numpy or tensors): {"mann_whitney", "kruskal", "wilcoxon",
    "ks"} -> (stat, p), (B,) float32 each, Kruskal-Wallis on the two-group
    arrangement (see `two_sample_tests_plain`). Kernel N on `device`
    (default "cuda"), the twin for device="cpu"."""
    out, t = _pair_tests(TWO_SAMPLE_TESTS, x, x_mask, y, y_mask, device)
    return two_sample_tests_plain(*t) if out is None else out


def sign_test_batch(x, y, pair_mask, device=None):
    """Exact paired sign test of B window pairs: (n_untied, p). Kernel N's
    sign entry on `device` (default "cuda"), the twin for device="cpu"."""
    out, t = _pair_tests(("sign",), x, pair_mask, y, pair_mask, device)
    return sign_test_exact_plain(t[0], t[2], t[1]) if out is None else out["sign"]


def kruskal_batch(groups, masks, device=None):
    """Kruskal-Wallis of B sets of k masked groups ((B, k, T) values, bool
    masks; numpy or tensors): (H, p), (B,) float32, df = k - 1. Kernel O on
    `device` (default "cuda"), the twin for device="cpu"."""
    dev = resolve_device(device)
    g = as_tensor(groups, _F, dev, "groups", tuple(np.shape(groups)))
    if g.dim() != 3:
        raise ValueError(f"groups must be (B, k, T), got shape {tuple(g.shape)}")
    m = as_tensor(masks, torch.bool, dev, "masks", tuple(g.shape))
    return kruskal_plain(g, m) if dev.type == "cpu" else kernels.kruskal_groups(g, m)


def friedman_batch(data, block_mask, device=None):
    """Friedman chi-square of B tables of n blocks x k treatments ((B, n, k)
    values, (B, n) bool block masks; numpy or tensors): (chi2, p), (B,)
    float32, df = k - 1. Kernel O on `device` (default "cuda"), the twin
    for device="cpu"."""
    dev = resolve_device(device)
    d = as_tensor(data, _F, dev, "data", tuple(np.shape(data)))
    if d.dim() != 3:
        raise ValueError(f"data must be (B, n, k), got shape {tuple(d.shape)}")
    m = as_tensor(block_mask, torch.bool, dev, "block_mask", tuple(d.shape[:2]))
    return friedman_plain(d, m) if dev.type == "cpu" else kernels.friedman(d, m)


def mann_whitney_u(x, x_mask, y, y_mask, device=None):
    """The reference's single form: one pair of (T,) windows and bool masks
    (numpy or tensors) -> (U1, p), 0-d float32 tensors. Kernel N on
    `device` (default "cuda"), the twin for device="cpu"."""
    return _one(mann_whitney_u_batch, x, x_mask, y, y_mask, device=device)


def wilcoxon_signed_rank(x, x_mask, y, y_mask, device=None):
    """The reference's single form of `wilcoxon_batch`: (W, p), 0-d."""
    return _one(wilcoxon_batch, x, x_mask, y, y_mask, device=device)


def ks_2samp(x, x_mask, y, y_mask, device=None):
    """The reference's single form of `ks_2samp_batch`: (D, p), 0-d."""
    return _one(ks_2samp_batch, x, x_mask, y, y_mask, device=device)


def two_sample_tests(x, x_mask, y, y_mask, device=None):
    """The reference's single form of `all_pairwise_tests`: {test: (stat,
    p)}, 0-d each."""
    return _one(all_pairwise_tests, x, x_mask, y, y_mask, device=device)


def sign_test_exact(x, y, pair_mask, device=None):
    """The reference's exact paired sign test on one pair of (T,) windows
    and a (T,) bool pair mask: (n_untied, p), 0-d float32 tensors."""
    return _one(sign_test_batch, x, y, pair_mask, device=device)


def kruskal_wallis(groups, masks, device=None):
    """The reference's single form of `kruskal_batch`: (k, T) groups and
    masks -> (H, p), 0-d float32 tensors."""
    return _one(kruskal_batch, groups, masks, device=device)


def friedman_chi_square(data, block_mask, device=None):
    """The reference's single form of `friedman_batch`: (n, k) data and (n,)
    block mask -> (chi2, p), 0-d float32 tensors."""
    return _one(friedman_batch, data, block_mask, device=device)
