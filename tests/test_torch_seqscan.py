"""Port parity: the long-window smoothers of foremast_tpu_torch.ops.seqscan
(ses/des_predictions_assoc; with device="cpu", the plain twin of kernel E)
against the JAX reference's associative scans on the same numpy inputs.

Tolerances are the reference's own for its scan forms against its
sequential smoothers (tests/test_seqscan.py), taken relative to the row's
scale (max |x| over valid slots; ~10 here, so the absolute parts equal the
reference's 1e-4 and 1e-3):
  * SES: rtol 1e-5, atol 1e-5 * scale;
  * DES: rtol 1e-4, atol 1e-4 * scale (its 2 x 2 products compound
    float32 rounding differently in each combine order).
"""
import numpy as np
import pytest

jax = pytest.importorskip("jax")

from foremast_tpu.ops import seqscan as jsq  # noqa: E402
from foremast_tpu_torch.ops import forecast as tfc  # noqa: E402
from foremast_tpu_torch.ops import seqscan as tsq  # noqa: E402


def _series(B=4, T=512, gap_frac=0.1, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(10.0, 2.0, (B, T)).astype(np.float32)
    m = rng.random((B, T)) > gap_frac
    m[:, 0] = True
    return x, m


def _scale(x, m):
    return float(np.abs(np.where(m, x, 0.0)).max())


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("T", [256, 1024])
def test_ses_assoc_matches_reference(seed, T):
    x, m = _series(T=T, seed=seed)
    alpha = np.random.default_rng(seed).uniform(0.1, 0.9, 4).astype(np.float32)
    got = tsq.ses_predictions_assoc(x, m, alpha, device="cpu").numpy()
    ref = np.asarray(jsq.ses_predictions_assoc(x, m, alpha))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * _scale(x, m))


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("T", [256, 1024])
def test_des_assoc_matches_reference(seed, T):
    x, m = _series(T=T, seed=seed + 3)
    alpha = np.full(4, 0.5, np.float32)
    beta = np.random.default_rng(seed).uniform(0.0, 0.3, 4).astype(np.float32)
    got = tsq.des_predictions_assoc(x, m, alpha, beta, device="cpu").numpy()
    ref = np.asarray(jsq.des_predictions_assoc(x, m, alpha, beta))
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4 * _scale(x, m))


def test_assoc_matches_the_sequential_smoothers():
    x, m = _series(T=512, seed=9)
    a, b = np.full(4, 0.3, np.float32), np.full(4, 0.1, np.float32)
    s = _scale(x, m)
    np.testing.assert_allclose(tsq.ses_predictions_assoc(x, m, a, device="cpu").numpy(),
                               tfc.ses_predictions(x, m, a, device="cpu").numpy(),
                               rtol=1e-5, atol=1e-5 * s)
    np.testing.assert_allclose(tsq.des_predictions_assoc(x, m, a, b, device="cpu").numpy(),
                               tfc.des_predictions(x, m, a, b, device="cpu").numpy(),
                               rtol=1e-4, atol=1e-4 * s)


def test_assoc_handles_an_all_gap_tail_and_a_leading_gap():
    x, m = _series(B=3, T=64, gap_frac=0.0, seed=1)
    m[:, 40:] = False  # the forecaster free-runs over the gap
    m[2, :10] = False  # the state starts at the first valid value
    a, b = np.full(3, 0.5, np.float32), np.full(3, 0.1, np.float32)
    s = _scale(x, m)
    np.testing.assert_allclose(tsq.des_predictions_assoc(x, m, a, b, device="cpu").numpy(),
                               np.asarray(jsq.des_predictions_assoc(x, m, a, b)),
                               rtol=1e-4, atol=1e-4 * s)
    np.testing.assert_allclose(tsq.ses_predictions_assoc(x, m, a, device="cpu").numpy(),
                               np.asarray(jsq.ses_predictions_assoc(x, m, a)),
                               rtol=1e-5, atol=1e-5 * s)
    got = tsq.ses_predictions_assoc(x, m, a, device="cpu").numpy()
    np.testing.assert_array_equal(got[2, :11], x[2, 10])


def test_assoc_on_an_all_masked_row_predicts_zero():
    x, m = _series(B=2, T=32)
    m[1] = False
    got = tsq.ses_predictions_assoc(x, m, 0.3, device="cpu").numpy()
    np.testing.assert_array_equal(got[1], 0.0)
    ref = np.asarray(jsq.ses_predictions_assoc(x, m, np.full(2, 0.3, np.float32)))
    np.testing.assert_array_equal(ref[1], 0.0)
