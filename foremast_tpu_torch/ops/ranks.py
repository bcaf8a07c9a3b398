"""Masked, tie-averaged ranking in sorted space.

Counterpart of the reference's ``ops/ranks.py``. The public `rank_and_ties`
and `masked_rankdata` take the reference's shapes, one row (T,) or a batch
(B, T), as numpy or tensors, and run kernel O's rank entry
(``csrc/rank_groups.cu``) on the card, or the plain twin for
device="cpu". Every other function is plain PyTorch on (B, T) tensors, one
series per row, on the tensors' own device. Masked
slots sort last and get rank 0; valid slots get scipy.rankdata's average
ranks. A valid NaN ranks highest, tied with the other NaNs; a valid +inf
ranks just below the NaNs; neither shares a tie group with a masked slot.
-0.0 and +0.0 are one tie group.

The statistics read only group-level quantities (average rank, group-end
counts, the tie term), so the order of equal keys inside a sort never
matters. Kernel A (``csrc/pair_verdict.cu``) relies on that to use an
unstable bitonic sort.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from .._device import as_tensor, resolve_device

__all__ = ["masked_rankdata", "rank_and_ties", "rank_and_ties_plain", "rank_sum_stats"]

_F = torch.float32


def _cummax(x: torch.Tensor) -> torch.Tensor:
    return torch.cummax(x, dim=-1).values


def _cummin_rev(x: torch.Tensor) -> torch.Tensor:
    return torch.flip(torch.cummin(torch.flip(x, (-1,)), dim=-1).values, (-1,))


class SortedRankView(NamedTuple):
    """Sorted-space view of masked rows; every (B, T) field is in sorted order.

    sv:        1.0 at valid positions, 0.0 at masked ones.
    extras:    the caller's payloads, co-sorted.
    avg:       tie-averaged 1-based rank (garbage at masked positions).
    t_valid:   valid-member count of each position's tie group.
    g1:        inclusive cumulative valid count at the position's group end.
    group_end: bool marker of tie-group ends.
    n_valid:   (B,) valid count.
    """

    sv: torch.Tensor
    extras: tuple
    avg: torch.Tensor
    t_valid: torch.Tensor
    g1: torch.Tensor
    group_end: torch.Tensor
    n_valid: torch.Tensor


def _sorted_rank_view(values, mask, extras=()) -> SortedRankView:
    """Sort each row by (key, class) and derive the tie-group machinery.

    key is the value with masked slots and valid NaNs mapped to +inf; class
    orders equal keys valid (0) < valid NaN (1) < masked (2). Two stable
    passes (class, then key) give the lexicographic order. Group boundaries
    split on a key or class change; float equality puts -0.0 and +0.0 in one
    group.
    """
    B, T = values.shape
    vf = values.to(_F)
    is_nan = torch.isnan(vf)
    keys = torch.where(mask & ~is_nan, vf, torch.inf)
    cls = torch.where(mask, is_nan.to(_F), 2.0)
    o1 = torch.argsort(cls, dim=-1, stable=True)
    o2 = torch.argsort(torch.gather(keys, 1, o1), dim=-1, stable=True)
    order = torch.gather(o1, 1, o2)
    sk = torch.gather(keys, 1, order)
    scls = torch.gather(cls, 1, order)
    sextras = tuple(torch.gather(e, 1, order) for e in extras)
    sv = (scls < 1.5).to(_F)
    pos = torch.arange(1, T + 1, dtype=_F, device=values.device).expand(B, T)
    neq = (sk[:, 1:] != sk[:, :-1]) | (scls[:, 1:] != scls[:, :-1])
    ones = torch.ones((B, 1), dtype=torch.bool, device=values.device)
    new_group = torch.cat([ones, neq], dim=1)
    group_end = torch.cat([neq, ones], dim=1)
    first = _cummax(torch.where(new_group, pos, 0.0))
    last = _cummin_rev(torch.where(group_end, pos, torch.inf))
    avg = (first + last) * 0.5
    cv_inc = torch.cumsum(sv, dim=-1)
    cv_exc = cv_inc - sv
    g0 = _cummax(torch.where(new_group, cv_exc, -torch.inf))
    g1 = _cummin_rev(torch.where(group_end, cv_inc, torch.inf))
    return SortedRankView(
        sv=sv, extras=sextras, avg=avg, t_valid=g1 - g0, g1=g1,
        group_end=group_end, n_valid=cv_inc[:, -1],
    )


def _exact_sum(x: torch.Tensor) -> torch.Tensor:
    """(B,) float64 row sums of integer or half-integer terms: exact. The
    reference's float32 sums agree while they stay below 2^23; past that
    (rank sums at T >= 4096, tie terms of heavily tied long rows) they
    round at every step."""
    return torch.sum(x.double(), dim=-1)


def _tie_term(view: SortedRankView) -> torch.Tensor:
    """(B,) float64 sum over tie groups of t^3 - t, t counting valid
    members only; exact."""
    t = view.t_valid.double()
    return _exact_sum(view.sv * (t * t - 1.0))


def rank_sum_stats(values, mask, weight):
    """(B,) weighted rank sum, tie term and valid count, without ranks.

    wsum = sum_i weight_i * rank_i over valid entries (rank as in
    scipy.rankdata among the valid subset). All float32, each the exact
    value rounded once.
    """
    w = weight.to(_F) * mask.to(_F)
    view = _sorted_rank_view(values, mask, extras=(w,))
    (sw,) = view.extras
    return _exact_sum(view.avg * sw).to(_F), _tie_term(view).to(_F), view.n_valid


def rank_and_ties_exact(values, mask):
    """Ranks in input order (0 at masked slots), the exact float64 tie term
    and the valid count, (B, T) rows."""
    B, T = values.shape
    idx = torch.arange(T, device=values.device).expand(B, T).contiguous()
    view = _sorted_rank_view(values, mask, extras=(idx,))
    (si,) = view.extras
    ranks = torch.empty_like(view.avg).scatter_(1, si, view.avg)
    ranks = torch.where(mask, ranks, 0.0)
    return ranks, _tie_term(view), view.n_valid


def rank_and_ties_plain(values, mask):
    """Plain twin of kernel O's rank entry on (B, T) tensors: ranks in input
    order (0 at masked slots), tie term and valid count, float32."""
    ranks, tie, n = rank_and_ties_exact(values, mask)
    return ranks, tie.to(_F), n


def rank_and_ties(values, mask, device=None):
    """Rank `values` where `mask` holds, averaging ties (the reference's
    rank_and_ties): one row (T,) or a batch (B, T), numpy or tensors.

    Returns ranks (1-based average ranks among the valid entries, 0.0 at
    masked ones), the tie term sum(t^3 - t) over tie groups of valid
    entries and the valid count, float32: (T,), (), () for one row, (B, T),
    (B,), (B,) for a batch. Kernel O on `device` (default "cuda"), the plain
    twin for device="cpu".
    """
    dev = resolve_device(device)
    one = getattr(values, "ndim", None) == 1
    shape = None if not one else (1, values.shape[0])
    v = as_tensor(values[None] if one else values, torch.float32, dev, "values", shape)
    m = as_tensor(mask[None] if one else mask, torch.bool, dev, "mask", tuple(v.shape))
    out = rank_and_ties_plain(v, m) if dev.type == "cpu" else kernels.rank_and_ties(v, m)
    return tuple(o[0] for o in out) if one else out


def masked_rankdata(values, mask, device=None):
    """scipy.stats.rankdata over the masked subset; 0 at masked positions."""
    return rank_and_ties(values, mask, device=device)[0]
