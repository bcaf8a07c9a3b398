"""Distribution tails for the pairwise tests (plain PyTorch, elementwise)."""
from __future__ import annotations

import torch

__all__ = ["norm_sf", "chi2_sf", "kolmogorov_sf"]

_SQRT2 = 1.4142135623730951


def norm_sf(z: torch.Tensor) -> torch.Tensor:
    """Standard normal survival function P(Z > z)."""
    return 0.5 * torch.special.erfc(z / _SQRT2)


def chi2_sf(x: torch.Tensor, df) -> torch.Tensor:
    """Chi-squared survival function: gammaincc(df/2, x/2), x clamped at 0.

    At df = 0 the distribution is a point mass at 0, so sf is 0 for every
    x >= 0 (NaN stays NaN); gammaincc itself gives NaN at a = 0."""
    x = torch.clamp(x, min=0.0)
    df = torch.as_tensor(df, dtype=x.dtype, device=x.device)
    q = torch.special.gammaincc(df / 2.0, x / 2.0)
    return torch.where(df == 0, torch.where(torch.isnan(x), x, 0.0), q)


def kolmogorov_sf(x: torch.Tensor, terms: int = 64) -> torch.Tensor:
    """Kolmogorov distribution tail, 2 * sum_k (-1)^(k-1) exp(-2 k^2 x^2).

    Below x = 0.2 the truncated series is meaningless and sf is 1 to beyond
    float32 precision, so it returns exactly 1 there.
    """
    k = torch.arange(1, terms + 1, dtype=x.dtype, device=x.device)
    signs = torch.where(k % 2 == 1, 1.0, -1.0).to(x.dtype)
    xc = torch.clamp(x, min=0.2)
    expo = torch.exp(-2.0 * (k**2) * (xc[..., None] ** 2))
    s = 2.0 * torch.sum(signs * expo, dim=-1)
    s = torch.where(x < 0.2, torch.ones_like(s), s)
    return torch.clamp(s, 0.0, 1.0)
