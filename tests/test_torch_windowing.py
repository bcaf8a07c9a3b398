"""Port parity: the copied host packers of foremast_tpu_torch.ops.windowing
give byte-equal output to the reference's."""
import numpy as np
import pytest

pytest.importorskip("jax")

from foremast_tpu.ops import windowing as jwin  # noqa: E402
from foremast_tpu_torch.ops import windowing as twin  # noqa: E402


def _ragged(seed, n):
    rng = np.random.default_rng(seed)
    start = 1_700_000_000 + int(rng.integers(0, 59))
    ts = start + np.sort(rng.uniform(-120, n * 60 + 120, n))
    vals = rng.normal(5, 2, n)
    vals[rng.random(n) < 0.05] = np.nan
    vals[rng.random(n) < 0.02] = np.inf
    vals[rng.random(n) < 0.02] = 1e39  # finite in float64, inf in float32
    return ts, vals, start, start + n * 60


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("n", [0, 1, 10, 128, 700])
def test_resample_to_grid_byte_equal(seed, n):
    ts, vals, start, end = _ragged(seed, n)
    a = twin.resample_to_grid(ts, vals, start, end)
    b = jwin.resample_to_grid(ts, vals, start, end)
    assert a.values.tobytes() == b.values.tobytes()
    assert a.mask.tobytes() == b.mask.tobytes()
    assert (a.start, a.step, a.n_valid) == (b.start, b.step, b.n_valid)


def test_resample_mismatched_lengths_use_the_prefix():
    ts, vals, start, end = _ragged(4, 30)
    a = twin.resample_to_grid(ts, vals[:20], start, end)
    b = jwin.resample_to_grid(ts, vals[:20], start, end)
    assert a.values.tobytes() == b.values.tobytes() and a.mask.tobytes() == b.mask.tobytes()


@pytest.mark.parametrize("pad_to", [None, 256])
def test_pack_windows_byte_equal(pad_to):
    wins_t, wins_j = [], []
    for seed, n in enumerate([5, 17, 128, 130, 0]):
        ts, vals, start, end = _ragged(seed, n)
        wins_t.append(twin.resample_to_grid(ts, vals, start, end))
        wins_j.append(jwin.resample_to_grid(ts, vals, start, end))
    a = twin.pack_windows(wins_t, pad_to=pad_to)
    b = jwin.pack_windows(wins_j, pad_to=pad_to)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes()


def test_bucket_length_and_limits_match():
    assert twin.MAX_WINDOW_STEPS == jwin.MAX_WINDOW_STEPS
    for T in list(range(1, 300)) + [1000, 4096, 4097, 10_080, 16_384]:
        assert twin.bucket_length(T) == jwin.bucket_length(T)
    for mod in (twin, jwin):
        with pytest.raises(ValueError):
            mod.bucket_length(16_385)
        with pytest.raises(ValueError):
            mod.pack_windows([])
        w = mod.Window(np.zeros(40, np.float32), np.ones(40, bool), 0)
        with pytest.raises(ValueError):
            mod.pack_windows([w], pad_to=32)


def test_align_step_matches():
    for t in (0, 59, 60, 61, 1_700_000_123.7):
        assert twin.align_step(t) == jwin.align_step(t)
        assert twin.align_step(t, 15) == jwin.align_step(t, 15)
