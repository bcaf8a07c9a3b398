"""Port parity: foremast_tpu_torch.models.lstm_ae (with device="cpu", the
plain twin of kernel K) against the reference's flax LstmAutoencoder, with
parameters carried across by params_from_flax.

Tolerances:
  * reconstructions: 1e-5 absolute (values of order 1; float32 products
    summed in another order through 2W recurrent steps, ~1.5e-7 measured);
  * errors, mu and sigma: 1e-5 relative;
  * z: 1e-3 absolute where sigma >= 1e-3 (an error's 1e-5 relative noise
    over sigma), and not compared where sigma < 1e-3: the reference's 1e-6
    floor on sigma multiplies float noise by up to 1e6 there;
  * the reference-trained fixture (tests/data/lstm_ae_ref.npz, made by
    scripts/make_lstm_ae_fixture.py): z within 1e-3, verdicts (z > 3) equal
    outside windows within 1e-3 of the threshold.
"""
import functools
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from foremast_tpu.models import lstm_ae as jl  # noqa: E402
from foremast_tpu_torch.models import lstm_ae as tl  # noqa: E402

FIXTURE = os.path.join(os.path.dirname(__file__), "data", "lstm_ae_ref.npz")
WIDTHS = [(3, 32, 16), (4, 32, 16), (8, 32, 16), (4, 128, 64)]


def _windows(seed, B, W, F):
    """Random windows with gaps, a fully masked window and one with a
    masked head (the engine's tail window)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (B, W, F)).astype(np.float32)
    m = rng.random((B, W, F)) > 0.15
    m[0] = False
    m[1, :W // 3] = False
    return x, m


@functools.lru_cache(maxsize=None)
def _trained(F, H, Z, steps):
    """The reference's init, then `steps` of its train_step on windows of 8
    steps (the parameters' shapes do not depend on W; one compile a width)."""
    model = jl.LstmAutoencoder(hidden=H, latent=Z, features=F)
    state, tx = jl.init_state(model, jax.random.PRNGKey(F + H), 8)
    params, opt_state = state.params, state.opt_state
    x, m = _windows(99, 6, 8, F)
    for _ in range(steps):
        params, opt_state, _ = jl.train_step(params, opt_state, jnp.asarray(x),
                                             jnp.asarray(m), model.apply, tx)
    return model, params


@pytest.mark.parametrize("W", [8, 32])
@pytest.mark.parametrize("F,H,Z", WIDTHS)
def test_twin_reconstructs_as_the_reference(F, H, Z, W):
    for steps in (0, 3):
        model, params = _trained(F, H, Z, steps)
        x, m = _windows(F * W + steps, 5, W, F)
        ref = np.asarray(model.apply({"params": params}, x, m))
        p = tl.params_from_flax(jax.device_get(params))
        assert tuple(p) == tl.PARAM_NAMES
        assert tl.flat_params(p).numel() == tl.param_count(F, H, Z)
        twin = tl.LstmAutoencoder(hidden=H, latent=Z, features=F)
        twin.load_state_dict(p)
        got = twin(torch.from_numpy(x), torch.from_numpy(m)).detach().numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_parameter_counts_and_the_flat_layout_round_trip():
    assert tl.param_count(4, 32, 16) == 12_180
    assert tl.param_count(4, 128, 64) == 177_732
    _, params = _trained(4, 32, 16, 0)
    p = tl.params_from_flax({"params": jax.device_get(params)})
    flat = tl.flat_params(p)
    back = tl.unflatten_params(flat, 4, 32, 16)
    for k in tl.PARAM_NAMES:
        assert torch.equal(back[k], p[k]), k
    # the gate blocks sit side by side in flax's order i, f, g, o
    host = jax.device_get(params)["LSTMCell_0"]
    for j, g in enumerate("ifgo"):
        np.testing.assert_array_equal(p["LSTMCell_0.wi"][:, 32 * j:32 * (j + 1)].numpy(),
                                      host["i" + g]["kernel"])
        np.testing.assert_array_equal(p["LSTMCell_0.b"][32 * j:32 * (j + 1)].numpy(),
                                      host["h" + g]["bias"])
    module = tl.LstmAutoencoder(hidden=32, latent=16, features=4)
    module.load_state_dict(p)
    stack = tl.stack_params([p, flat, module])
    assert stack.shape == (3, 12_180) and torch.equal(stack[0], stack[2])
    with pytest.raises(ValueError, match="F, H, Z"):
        tl.unflatten_params(flat, 4, 32, 8)


# past the first design's limits: 40 metrics a job, 320 units
@pytest.mark.parametrize("F,H,Z", WIDTHS + [(40, 32, 16), (4, 320, 64)])
def test_scoring_entry_points_match_the_reference(F, H, Z):
    W = 32
    model, params = _trained(F, H, Z, 3)
    p = tl.params_from_flax(jax.device_get(params))
    x, m = _windows(7 + F, 9, W, F)
    ref_err = np.asarray(jl.reconstruction_errors(params, x, m, model.apply))
    err = tl.reconstruction_errors(p, x, m, device="cpu").numpy()
    np.testing.assert_allclose(err, ref_err, rtol=1e-5)
    assert err[0] == 0.0  # a fully masked window scores 0
    ref_mu, ref_sd = jl.fit_score_normalizer(params, x, m, model.apply)
    mu, sd = tl.fit_score_normalizer(p, x, m, device="cpu")
    np.testing.assert_allclose([float(mu), float(sd)], [float(ref_mu), float(ref_sd)],
                               rtol=1e-5)
    ref_z = np.asarray(jl.anomaly_scores(params, x, m, ref_mu, ref_sd, model.apply))
    z = tl.anomaly_scores(p, x, m, mu, sd, device="cpu").numpy()
    if float(ref_sd) >= 1e-3:
        np.testing.assert_allclose(z, ref_z, rtol=0, atol=1e-3)


def test_fleet_scoring_matches_the_reference():
    """Per-job stacked parameters, one call; a job with sigma at the 1e-6
    floor (identical windows) has its z compared only through err."""
    F, H, Z, W, K = 4, 32, 16, 16, 5
    model = jl.LstmAutoencoder(hidden=H, latent=Z, features=F)
    params = [_trained(F, H, Z, s)[1] for s in (0, 2, 4)]
    stacked = jax.tree.map(lambda *a: jnp.stack(a), *params)
    x = np.stack([_windows(s, K, W, F)[0] for s in range(3)])
    m = np.stack([_windows(s, K, W, F)[1] for s in range(3)])
    x[2] = x[2, 2]
    m[2] = m[2, 2]
    mus, sds = jax.vmap(lambda p, xx, mm: jl.fit_score_normalizer(p, xx, mm, model.apply))(
        stacked, x, m)
    ref_z = np.asarray(jl.anomaly_scores_fleet(stacked, x, m, mus, sds, model.apply))
    mine = [tl.params_from_flax(jax.device_get(p)) for p in params]
    stack = tl.stack_params(mine)
    norms = [tl.fit_score_normalizer(p, x[j], m[j], device="cpu") for j, p in enumerate(mine)]
    mu, sd = torch.stack([n[0] for n in norms]), torch.stack([n[1] for n in norms])
    np.testing.assert_allclose(mu.numpy(), np.asarray(mus), rtol=1e-5)
    assert float(sd[2]) == pytest.approx(1e-6)
    assert float(np.asarray(sds)[2]) == pytest.approx(1e-6)
    np.testing.assert_allclose(sd.numpy()[:2], np.asarray(sds)[:2], rtol=1e-5)
    z = tl.anomaly_scores_fleet(stack, x, m, mu, sd, hidden=H, latent=Z, device="cpu").numpy()
    assert z.shape == (3, K)
    np.testing.assert_allclose(z[:2], ref_z[:2], rtol=0, atol=1e-3)


def test_reference_trained_fixture_scores_as_the_reference():
    d = np.load(FIXTURE)
    F, H, Z, W = (int(v) for v in d["dims"])
    J, K = d["z"].shape
    assert d["params"].shape == (J, tl.param_count(F, H, Z)) and d["x"].shape == (J, K, W, F)
    z = tl.anomaly_scores_fleet(d["params"], d["x"], d["mask"], d["mu"], d["sigma"],
                                hidden=H, latent=Z, device="cpu").numpy()
    np.testing.assert_allclose(z, d["z"], rtol=0, atol=1e-3)
    edge = np.abs(d["z"] - 3.0) <= 1e-3
    np.testing.assert_array_equal((z > 3)[~edge], (d["z"] > 3)[~edge])
    # the fixture separates: healthy windows under 3, most anomalous ones over
    assert (d["z"][:, ~d["anomalous"]] < 3).all()
    assert (d["z"][:, d["anomalous"]] > 3).mean() > 0.6


def test_entry_points_check_their_inputs_and_need_the_card():
    _, params = _trained(4, 32, 16, 0)
    p = tl.params_from_flax(jax.device_get(params))
    x, m = _windows(0, 3, 8, 4)
    with pytest.raises(ValueError, match="mask"):
        tl.reconstruction_errors(p, x, m[:, :4], device="cpu")
    with pytest.raises(ValueError, match="expected"):
        tl.reconstruction_errors(p, x[..., :3], m[..., :3], device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tl.reconstruction_errors(p, x, m)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tl.anomaly_scores_fleet(tl.flat_params(p)[None], x[None], m[None], [0.0], [1.0],
                                    hidden=32, latent=16)


# kernel K's path chooser (kernels.lstm_ae_path): plain Python on the
# library's own size formulas, so these need no card
@pytest.mark.parametrize("K,F,H,Z,W,path", [
    (2, 4, 32, 16, 32, "warp"),  # the engine's scoring pass (100,000 jobs x 2)
    (45, 4, 32, 16, 32, "warp"),  # the normalizer (10,000 jobs x a day of 45)
    (2, 4, 128, 64, 32, "cluster"),  # the module's default width (10,000 x 2)
    (1, 1, 1, 1, 1, "warp"),
    (3000, 4, 32, 16, 32, "warp"),  # one job of many windows
    (3, 16, 32, 16, 32, "warp"),  # two windows a group: 16 (window, feature) pairs each
    (3, 17, 32, 16, 32, "wide"),  # more pairs than a warp's lanes
    (2, 4, 33, 16, 32, "cluster"),  # the first width past a warp's 32 units
    (2, 32, 256, 256, 32, "cluster"),  # the widest: a cluster of eight CTAs
    (45, 32, 256, 256, 32, "wide"),  # its chunk's latents past a CTA's shared memory
    (2, 4, 128, 64, 172, "cluster"),  # the longest window whose history fits
    (2, 4, 128, 64, 173, "wide"),
])
def test_kernel_k_path_chooser_at_its_shapes_and_edges(K, F, H, Z, W, path):
    from foremast_tpu_torch import kernels

    assert kernels.lstm_ae_path(K, F, H, Z, W) == path
    assert kernels.lstm_ae_serves("wide", K, F, H, Z, W)
    assert all(kernels.lstm_ae_serves(p, K, F, H, Z, W) == (p in (path, "wide"))
               for p in kernels.LSTM_AE_PATHS)


def test_kernel_k_chunks_and_forced_paths(monkeypatch):
    """A chunk is at most four groups a warp or cluster, fewer when the jobs
    alone fill the card; a forced path is taken where it serves and refused
    by name where it does not."""
    from foremast_tpu_torch import kernels

    assert kernels.lstm_ae_chunk_windows(100_000, 2, 2) == 2
    assert kernels.lstm_ae_chunk_windows(10_000, 45, 4) == 16
    assert kernels.lstm_ae_chunk_windows(1, 3000, 4) == 4
    assert kernels.lstm_ae_chunk_windows(8, 3, 4) == 4
    monkeypatch.setattr(kernels, "LSTM_AE_FORCE", "wide")
    assert kernels.lstm_ae_path(2, 4, 32, 16) == "wide"
    monkeypatch.setattr(kernels, "LSTM_AE_FORCE", "warp")
    with pytest.raises(ValueError, match="the warp path does not take"):
        kernels.lstm_ae_path(2, 4, 128, 64)
    monkeypatch.setattr(kernels, "LSTM_AE_FORCE", "tile")
    with pytest.raises(ValueError, match="no path 'tile'"):
        kernels.lstm_ae_path(2, 4, 32, 16)
