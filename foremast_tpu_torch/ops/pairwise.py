"""Batched, mask-aware two-sample tests (plain PyTorch).

Counterpart of the reference's ``ops/pairwise.py`` on the scoring path:
Mann-Whitney U, two-group Kruskal-Wallis, two-sample KS and Wilcoxon
signed-rank, fused in `two_sample_tests`, plus the exact paired sign test.
Every function takes (B, T) value tensors and bool masks, one window pair
per row, and returns (B,) float32 tensors on the inputs' device. These are
the plain twins: kernel A (``csrc/pair_verdict.cu``) computes the same
p-values inside one launch, and ``parallel.fleet`` holds the two together.

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

import torch

from . import ranks as rk
from .stats import chi2_sf, kolmogorov_sf, norm_sf
from ..utils import knobs

__all__ = [
    "mann_whitney_u",
    "two_sample_tests",
    "wilcoxon_signed_rank",
    "sign_test_exact",
    "ks_2samp",
    "all_pairwise_tests",
    "wilcoxon_pmf_table",
]

_F = torch.float32


def _safe_div(a, b):
    return a / torch.where(b == 0, 1.0, b)


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


def mann_whitney_u(x, x_mask, y, y_mask):
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


def wilcoxon_signed_rank(x, x_mask, y, y_mask):
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


def sign_test_exact(x, y, pair_mask):
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


def ks_2samp(x, x_mask, y, y_mask):
    """Two-sided two-sample KS: (D, p), D = t / (n1 n2) with the integer sup
    statistic t = max |cx n2 - cy n1| over valid points (<= counts)."""
    xv, yv = x.to(_F), y.to(_F)
    xm, ym = x_mask.to(_F), y_mask.to(_F)
    n1, n2 = xm.sum(-1), ym.sum(-1)
    pts = torch.cat([xv, yv], dim=1)
    pts_valid = torch.cat([x_mask, y_mask], dim=1)
    cx = torch.sum((xv[:, None, :] <= pts[:, :, None]).to(_F) * xm[:, None, :], dim=-1)
    cy = torch.sum((yv[:, None, :] <= pts[:, :, None]).to(_F) * ym[:, None, :], dim=-1)
    stat = torch.abs(cx * n2[:, None] - cy * n1[:, None])
    t = torch.amax(torch.where(pts_valid, stat, 0.0), dim=-1)
    return _safe_div(t, n1 * n2), _ks_pvalue(t, n1, n2, x.shape[-1], y.shape[-1])


def two_sample_tests(x, x_mask, y, y_mask):
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
    stat = torch.abs(cx_end * n2[:, None] - cy_end * n1[:, None])
    t_ks = torch.amax(torch.where(view.sv > 0.0, stat, 0.0), dim=-1)
    D = _safe_div(t_ks, n1 * n2)
    p_ks = _ks_pvalue(t_ks, n1, n2, Tx, y.shape[-1])

    W, p_w = wilcoxon_signed_rank(x, x_mask, y, y_mask)
    return {
        "mann_whitney": (U1, p_mw),
        "kruskal": (H, p_k),
        "wilcoxon": (W, p_w),
        "ks": (D, p_ks),
    }


def all_pairwise_tests(x, x_mask, y, y_mask):
    """The full two-sample family on a batch of window pairs (see
    `two_sample_tests`)."""
    return two_sample_tests(x, x_mask, y, y_mask)
