"""Port parity: foremast_tpu_torch.ops.ranks against the JAX reference and
scipy.stats.rankdata, the public entry points run with device="cpu" (the
plain twin of kernel O's rank entry).

Ranks are half-integers and the tie term an integer sum, both exact in
float32 at these sizes, so every comparison is exact.
"""
import numpy as np
import pytest
import scipy.stats as sps
import torch

jax = pytest.importorskip("jax")

from foremast_tpu.ops import ranks as jranks  # noqa: E402
from foremast_tpu_torch.ops import ranks as tranks  # noqa: E402


def _rows(seed, B=24, T=40):
    """Rows with heavy ties, signed zeros, valid NaN and +inf, masked slots,
    and one all-masked row."""
    rng = np.random.default_rng(seed)
    v = np.round(rng.normal(size=(B, T)) * 2).astype(np.float32) / 2
    m = rng.random((B, T)) > 0.25
    zeros = rng.random((B, T)) < 0.15
    v[zeros] = np.where(rng.random(zeros.sum()) < 0.5, 0.0, -0.0)
    v[rng.random((B, T)) < 0.05] = np.nan
    v[rng.random((B, T)) < 0.05] = np.inf
    m[0] = False
    return v, m


def _jax_rank_and_ties(v, m):
    out = jax.vmap(jranks.rank_and_ties)(v, m)
    return tuple(np.asarray(a) for a in out)


@pytest.mark.parametrize("seed", range(4))
def test_rank_and_ties_matches_reference(seed):
    v, m = _rows(seed)
    r, tie, n = tranks.rank_and_ties(torch.from_numpy(v), torch.from_numpy(m), device="cpu")
    jr, jtie, jn = _jax_rank_and_ties(v, m)
    np.testing.assert_array_equal(r.numpy(), jr)
    np.testing.assert_array_equal(tie.numpy(), jtie)
    np.testing.assert_array_equal(n.numpy(), jn)


@pytest.mark.parametrize("seed", range(4))
def test_rank_and_ties_matches_scipy_on_valid_subset(seed):
    v, m = _rows(seed)
    v = np.where(np.isnan(v), 7.0, v).astype(np.float32)  # scipy propagates NaN
    r, tie, n = tranks.rank_and_ties(torch.from_numpy(v), torch.from_numpy(m), device="cpu")
    for i in range(v.shape[0]):
        sel = m[i]
        assert n[i].item() == sel.sum()
        if not sel.any():
            assert np.all(r[i].numpy() == 0.0) and tie[i].item() == 0.0
            continue
        np.testing.assert_array_equal(r[i].numpy()[sel], sps.rankdata(v[i][sel]))
        assert np.all(r[i].numpy()[~sel] == 0.0)
        _, counts = np.unique(v[i][sel], return_counts=True)
        assert tie[i].item() == float(np.sum(counts**3 - counts))


def test_signed_zeros_share_one_tie_group():
    v = torch.tensor([[0.0, -0.0, 1.0, -0.0, 0.0]])
    r, tie, n = tranks.rank_and_ties(v, torch.ones_like(v, dtype=torch.bool), device="cpu")
    np.testing.assert_array_equal(r.numpy()[0], [2.5, 2.5, 5.0, 2.5, 2.5])
    assert tie.item() == 4**3 - 4 and n.item() == 5


def test_nan_ranks_highest_and_inf_below_it_clear_of_masked():
    v = torch.tensor([[np.nan, np.inf, 1.0, np.nan, np.inf, 5.0]])
    m = torch.tensor([[True, True, True, True, True, False]])
    r, tie, n = tranks.rank_and_ties(v, m, device="cpu")
    # 1.0 -> 1, +inf x2 -> 2.5, NaN x2 -> 4.5; the masked slot gets 0
    np.testing.assert_array_equal(r.numpy()[0], [4.5, 2.5, 1.0, 4.5, 2.5, 0.0])
    assert tie.item() == 12.0 and n.item() == 5


@pytest.mark.parametrize("seed", range(3))
def test_rank_sum_stats_matches_reference(seed):
    v, m = _rows(seed)
    w = (np.random.default_rng(seed + 9).random(v.shape) < 0.5).astype(np.float32)
    got = tranks.rank_sum_stats(torch.from_numpy(v), torch.from_numpy(m), torch.from_numpy(w))
    want = jax.vmap(jranks.rank_sum_stats)(v, m, w)
    for g, j in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j))


def test_masked_rankdata_is_rank_and_ties_ranks():
    v, m = _rows(11)
    tv, tm = torch.from_numpy(v), torch.from_numpy(m)
    np.testing.assert_array_equal(tranks.masked_rankdata(tv, tm, device="cpu").numpy(),
                                  tranks.rank_and_ties(tv, tm, device="cpu")[0].numpy())
