"""Port parity: the distribution tails of foremast_tpu_torch.ops.stats
against the JAX reference and scipy (float64 truth).

Tolerances: 1e-6 absolute against both on [0, 1]-valued tails, which is a
few float32 ulps; the two float32 implementations round differently.
"""
import numpy as np
import pytest
import scipy.special as ssp
import scipy.stats as sps
import torch

jax = pytest.importorskip("jax")

from foremast_tpu.ops import stats as jstats  # noqa: E402
from foremast_tpu_torch.ops import stats as tstats  # noqa: E402

ATOL = 1e-6

Z = np.concatenate([np.linspace(-8, 8, 161), [-40.0, 12.0, 40.0, 1e4]]).astype(np.float32)
X = np.concatenate([np.linspace(0, 60, 241), [1e-7, 0.5, 200.0]]).astype(np.float32)
K = np.concatenate([np.linspace(0, 3, 121), [0.05, 0.1999, 0.2, 0.2001, 10.0]]).astype(np.float32)


def test_norm_sf_vs_jax_and_scipy():
    got = tstats.norm_sf(torch.from_numpy(Z)).numpy()
    np.testing.assert_allclose(got, np.asarray(jstats.norm_sf(Z)), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, sps.norm.sf(Z.astype(np.float64)), atol=ATOL, rtol=0)
    # huge z: the tail underflows to 0 cleanly, never NaN
    assert got[-1] == 0.0 and not np.isnan(got).any()


@pytest.mark.parametrize("df", [1.0, 2.0, 3.0, 7.0])
def test_chi2_sf_vs_jax_and_scipy(df):
    got = tstats.chi2_sf(torch.from_numpy(X), df).numpy()
    np.testing.assert_allclose(got, np.asarray(jstats.chi2_sf(X, np.float32(df))),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, sps.chi2.sf(X.astype(np.float64), df), atol=ATOL, rtol=0)


def test_chi2_sf_clamps_negative_statistic():
    got = tstats.chi2_sf(torch.tensor([-3.0, 0.0]), 1.0).numpy()
    np.testing.assert_array_equal(got, [1.0, 1.0])


def test_chi2_df1_equals_erfc_of_sqrt():
    # kernel A evaluates chi2 df=1 as erfc(sqrt(x/2)); the identity holds
    x = torch.from_numpy(X)
    np.testing.assert_allclose(tstats.chi2_sf(x, 1.0).numpy(),
                               torch.special.erfc(torch.sqrt(x / 2)).numpy(), atol=ATOL)


def test_kolmogorov_sf_vs_jax_and_scipy():
    got = tstats.kolmogorov_sf(torch.from_numpy(K)).numpy()
    np.testing.assert_allclose(got, np.asarray(jstats.kolmogorov_sf(K)), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got, ssp.kolmogorov(K.astype(np.float64)), atol=ATOL, rtol=0)
    # below the 0.2 cutoff the tail is exactly 1
    assert np.all(got[K < 0.2] == 1.0)
