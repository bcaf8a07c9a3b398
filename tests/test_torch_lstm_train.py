"""Port parity of LSTM-autoencoder training: foremast_tpu_torch's initial
parameters (models/lstm_init.py), its training twins (models/lstm_ae.py
with device="cpu": torch autograd for kernel L, Adam written out for kernel
M) and train / train_fleet, against the reference's flax / optax code on
the same numpy inputs.

Tolerances:
  * the random draws (threefry, fold_in, uniform, XLA's float32 erf_inv and
    log1p, truncated and plain normals): bit for bit;
  * the initial parameters: the input kernels and both Dense kernels
    (truncated normals) bit for bit, the biases zero; the orthogonal
    recurrent kernels within 3e-6: the reference takes the QR in float32
    (LAPACK, summing in its BLAS's order), the port in float64, rounded
    (1.6e-6 measured at H = 128, 9e-7 at H = 32);
  * one train_step from carried parameters and Adam state: the loss within
    1e-5 relative, the gradient within 1e-5 of its largest entry (float32
    sums in another order through 2W recurrent steps; ~1e-7 measured), the
    moments within 1e-5 of their largest entry, the parameters within
    1e-6 (a step moves an entry by at most lr = 1e-3);
  * wgrad_plain (kernel L's weight-gradient twin) on slots built by
    autograd: the reference's gradient within 1e-5 of its largest entry;
  * adam_plain against optax's update on the same gradient: within 2
    float32 ulps (XLA may fuse a multiply-add of the moment updates);
  * training: each epoch's fleet-mean loss within 1e-5 relative of the
    reference's, the same stop epoch, mu and sigma within 1e-4 relative,
    z within 1e-3 and verdicts (z > 3) equal outside 1e-3 of the
    threshold.
"""
import functools
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from foremast_tpu.models import lstm_ae as jl  # noqa: E402
from foremast_tpu_torch.models import lstm_ae as tl  # noqa: E402
from foremast_tpu_torch.models import lstm_init as li  # noqa: E402

DATA = os.path.join(os.path.dirname(__file__), "data")
TRAIN_FIXTURE = os.path.join(DATA, "lstm_ae_train_ref.npz")
SCORE_FIXTURE = os.path.join(DATA, "lstm_ae_ref.npz")
INIT_WIDTHS = [(3, 32, 16), (4, 32, 16), (8, 32, 16), (4, 128, 64), (5, 8, 4)]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The twins' training is thousands of small operations: one torch
    thread runs it faster than a pool, and keeps it fast when test workers
    share the CPUs."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _windows(seed, J, K, W, F):
    """Random windows with gaps, a fully masked window and a masked head."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (J, K, W, F)).astype(np.float32)
    m = rng.random((J, K, W, F)) > 0.15
    m[0, 0] = False
    m[:, 1, :W // 4] = False
    return x, m


def _flat(tree) -> np.ndarray:
    return tl.flat_params(tl.params_from_flax(jax.device_get(tree))).numpy()


def test_threefry_fold_in_and_random_bits_equal_jax():
    for seed in (0, 3, 2**31 - 1):
        key = jax.random.PRNGKey(seed)
        mine = (0, seed)
        for data in (0, 1, 12345, 2**32 - 1):
            assert li.fold_in(mine, data) == tuple(
                int(v) for v in jax.random.key_data(jax.random.fold_in(key, data)))
        np.testing.assert_array_equal(li.random_bits(mine, 1000),
                                      np.asarray(jax.random.bits(key, (1000,))))
    from flax.core.scope import _fold_in_static

    for path in (("LSTMCell_0", "hi", 1), ("LSTMCell_1", "ig", 1), ("Dense_1", 1)):
        assert li.fold_in_static((0, 0), path) == tuple(
            int(v) for v in jax.random.key_data(_fold_in_static(jax.random.PRNGKey(0), path)))


def test_erf_inv_and_the_normal_draws_equal_xla_bit_for_bit():
    rng = np.random.default_rng(0)
    u = np.concatenate([rng.uniform(-1, 1, 100_000), rng.uniform(-1, -0.999, 5_000),
                        rng.uniform(-1e-4, 1e-4, 5_000), [-1.0, 1.0, 0.0]]).astype(np.float32)
    want = np.asarray(jax.jit(jax.lax.erf_inv)(jnp.asarray(u)))
    np.testing.assert_array_equal(li.erf_inv(u), want)
    for seed in (0, 7):
        key = jax.random.PRNGKey(seed)
        np.testing.assert_array_equal(li.truncated_normal((0, seed), (64, 128)), np.asarray(
            jax.random.truncated_normal(key, -2.0, 2.0, (64, 128), jnp.float32)))
        np.testing.assert_array_equal(li.normal((0, seed), (96, 33)),
                                      np.asarray(jax.random.normal(key, (96, 33), jnp.float32)))


@pytest.mark.parametrize("F,H,Z", INIT_WIDTHS)
def test_init_params_equal_the_reference_init_state(F, H, Z):
    state, _ = jl.init_state(jl.LstmAutoencoder(hidden=H, latent=Z, features=F),
                             jax.random.PRNGKey(0), T=8)
    ref = _flat(state.params)
    mine = li.init_params(F, H, Z).numpy()
    assert mine.shape == ref.shape == (tl.param_count(F, H, Z),)
    ortho = np.concatenate([np.full(int(np.prod(s)), k.endswith(".wh"))
                            for k, s in tl.param_shapes(F, H, Z).items()])
    np.testing.assert_array_equal(mine[~ortho], ref[~ortho])
    np.testing.assert_allclose(mine[ortho], ref[ortho], rtol=0, atol=3e-6)
    wh = tl.unflatten_params(torch.from_numpy(mine), F, H, Z)["LSTMCell_1.wh"].double()
    for g in range(4):  # each gate's recurrent kernel is orthogonal
        q = wh[:, g * H:(g + 1) * H]
        torch.testing.assert_close(q.T @ q, torch.eye(H, dtype=torch.float64), rtol=0,
                                   atol=1e-5)


@functools.lru_cache(maxsize=None)
def _carried(F, H, Z, W):
    """The reference three steps into training on job 0 of _windows: its
    model, params, opt_state and tx."""
    model = jl.LstmAutoencoder(hidden=H, latent=Z, features=F)
    state, tx = jl.init_state(model, jax.random.PRNGKey(0), T=W)
    params, opt_state = state.params, state.opt_state
    x, m = _windows(1, 1, 5, W, F)
    for _ in range(3):
        params, opt_state, _ = jl.train_step(params, opt_state, jnp.asarray(x[0]),
                                             jnp.asarray(m[0]), model.apply, tx)
    return model, jax.device_get(params), jax.device_get(opt_state), tx


@pytest.mark.parametrize("F,H,Z", [(3, 8, 4), (4, 32, 16), (40, 32, 16), (4, 320, 64)])
def test_one_train_step_from_carried_state_matches_the_reference(F, H, Z):
    W = 16
    model, params, opt_state, tx = _carried(F, H, Z, W)
    x, m = _windows(2, 1, 5, W, F)
    loss_fn = lambda p: jl._loss_fn(p, None, jnp.asarray(x[0]), jnp.asarray(m[0]),  # noqa: E731
                                    model.apply)
    ref_loss, ref_grad = jax.value_and_grad(loss_fn)(params)
    new_params, new_opt, _ = jl.train_step(jax.tree.map(jnp.asarray, params),
                                           jax.tree.map(jnp.asarray, opt_state),
                                           jnp.asarray(x[0]), jnp.asarray(m[0]), model.apply, tx)
    count, mu, nu = tl.adam_state_from_optax(opt_state)
    stack = torch.from_numpy(_flat(params))[None].clone()
    loss, grad = tl.loss_and_grad(stack, x, m, hidden=H, latent=Z, device="cpu")
    np.testing.assert_allclose(float(loss[0]), float(ref_loss), rtol=1e-5)
    g_ref = _flat(ref_grad)
    np.testing.assert_allclose(grad[0].numpy(), g_ref, rtol=0, atol=1e-5 * np.abs(g_ref).max())
    step = torch.tensor([count], dtype=torch.int32)
    mu, nu = mu[None].clone(), nu[None].clone()
    got = tl.train_step(stack, step, mu, nu, torch.from_numpy(x), torch.from_numpy(m),
                        hidden=H, latent=Z)
    np.testing.assert_allclose(float(got[0]), float(ref_loss), rtol=1e-5)
    c2, mu2, nu2 = tl.adam_state_from_optax(jax.device_get(new_opt))
    assert int(step[0]) == c2 == count + 1
    np.testing.assert_allclose(stack[0].numpy(), _flat(new_params), rtol=0, atol=1e-6)
    np.testing.assert_allclose(mu[0].numpy(), mu2.numpy(), rtol=0,
                               atol=1e-5 * float(mu2.abs().max()))
    np.testing.assert_allclose(nu[0].numpy(), nu2.numpy(), rtol=1e-4,
                               atol=1e-5 * float(nu2.abs().max()))


def _rewritten_slots(stack, x, m, H, Z):
    """What kernel L's recurrence entry leaves for its weight-gradient
    entry, built by torch autograd through the recurrences written out on
    the CPU: act (J, K, 2, W, 5H), each step's slot (da_t, h_{t-1}) with
    da_t the gradient of the job's sum of squared errors in the gates'
    pre-activations, and the window records rec (J, K, S)."""
    J, K, W, F = x.shape
    stack = stack.clone().requires_grad_(True)
    p = tl.unflatten_params(stack, F, H, Z)
    inp = torch.cat([x, m.to(x.dtype)], dim=-1)
    pre, prev = ([], []), ([], [])

    def run(lstm, proj):
        h = c = torch.zeros((J, K, H))
        hs = []
        for t in range(W):
            g = proj(t) + torch.bmm(h, p[f"LSTMCell_{lstm}.wh"]) + p[f"LSTMCell_{lstm}.b"][:, None]
            g.retain_grad()
            pre[lstm].append(g)
            prev[lstm].append(h)
            i, f, gg, o = g.split(H, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(gg)
            h = torch.sigmoid(o) * torch.tanh(c)
            hs.append(h)
        return hs

    enc = run(0, lambda t: torch.bmm(inp[:, :, t], p["LSTMCell_0.wi"]))
    z = torch.bmm(enc[-1], p["Dense_0.kernel"]) + p["Dense_0.bias"][:, None]
    z.retain_grad()
    dz = torch.bmm(z, p["LSTMCell_1.wi"])
    hd = torch.stack(run(1, lambda t: dz), dim=2)
    recon = torch.einsum("jkwh,jhf->jkwf", hd, p["Dense_1.kernel"]) + p["Dense_1.bias"][:, None,
                                                                                      None]
    recon.retain_grad()
    torch.where(m, (recon - x) ** 2, 0.0).sum().backward()
    act = torch.stack([torch.cat([torch.stack([g.grad for g in pre[n]], 2),
                                  torch.stack(prev[n], 2)], -1) for n in (0, 1)], 2)
    dy = recon.grad
    rec = torch.cat([z, act[:, :, 1, :, :4 * H].sum(2), enc[-1], z.grad,
                     torch.einsum("jkwh,jkwf->jkhf", hd, dy).reshape(J, K, H * F), dy.sum(2),
                     inp.reshape(J, K, W * 2 * F)], -1)
    return act.detach(), rec.detach(), stack.grad


@pytest.mark.parametrize("F,H,Z", [(3, 8, 4), (4, 32, 16)])
def test_wgrad_plain_sums_the_rewritten_slots_into_the_reference_s_gradient(F, H, Z):
    """Kernel L's weight-gradient twin on the slots and records its
    recurrence entry leaves (built by autograd here): the reference's
    gradient of the job's sum of squared errors (value_and_grad of _loss_fn
    times max(sum m, 1)), within 1e-5 of its largest entry."""
    W = 16
    model, params, _opt, _tx = _carried(F, H, Z, W)
    x, m = _windows(2, 1, 5, W, F)
    loss_fn = lambda p: jl._loss_fn(p, None, jnp.asarray(x[0]), jnp.asarray(m[0]),  # noqa: E731
                                    model.apply)
    _loss, ref_grad = jax.value_and_grad(loss_fn)(params)
    g_ref = _flat(ref_grad) * max(int(m.sum()), 1)
    stack = torch.from_numpy(_flat(params))[None]
    act, rec, autograd = _rewritten_slots(stack, torch.from_numpy(x), torch.from_numpy(m), H, Z)
    got = tl.wgrad_plain(act, rec, F, H, Z)
    assert got.shape == (1, 1, tl.param_count(F, H, Z))
    lim = 1e-5 * np.abs(g_ref).max()
    np.testing.assert_allclose(got[0, 0].numpy(), g_ref, rtol=0, atol=lim)
    np.testing.assert_allclose(autograd[0].numpy(), g_ref, rtol=0, atol=lim)


def test_adam_plain_is_optax_adam_written_out():
    rng = np.random.default_rng(3)
    P = 4_000
    p = rng.normal(0, 0.3, P).astype(np.float32)
    g = (rng.normal(0, 1, P) * 10.0 ** rng.uniform(-9, 0, P)).astype(np.float32)
    tx = optax.adam(tl.LEARNING_RATE)
    state = tx.init(jnp.asarray(p))
    params = torch.from_numpy(p.copy())[None]
    mu, nu = torch.zeros((1, P)), torch.zeros((1, P))
    step = torch.zeros(1, dtype=torch.int32)
    ref = jnp.asarray(p)
    for k in range(4):
        gk = jnp.asarray(g * (1 + k))
        upd, state = tx.update(gk, state, ref)
        ref = optax.apply_updates(ref, upd)
        step += 1
        tl.adam_plain(params, torch.from_numpy(np.array(gk))[None], mu, nu, step)
        ulp = np.spacing(np.abs(np.asarray(ref)))
        assert np.all(np.abs(params[0].numpy() - np.asarray(ref)) <= 2 * ulp), k
        np.testing.assert_allclose(nu[0].numpy(), np.asarray(state[0].nu), rtol=1e-6)


def _reference_fleet(x, m, H, Z, epochs):
    """The reference's train_fleet loop (models/lstm_ae.py:202) with each
    epoch's fleet-mean loss kept."""
    F = x.shape[-1]
    model = jl.LstmAutoencoder(hidden=H, latent=Z, features=F)
    params, mus, sds = jl.train_fleet(model, jax.random.PRNGKey(0), jnp.asarray(x),
                                      jnp.asarray(m), epochs=epochs)
    state, tx = jl.init_state(model, jax.random.PRNGKey(0), T=x.shape[2])
    J = x.shape[0]
    p = jax.tree.map(lambda a: jnp.array(jnp.broadcast_to(a[None], (J,) + a.shape)),
                     state.params)
    o = jax.tree.map(lambda a: jnp.array(jnp.broadcast_to(a[None], (J,) + a.shape)),
                     state.opt_state)
    plateau, losses = jl._Plateau(), []
    for e in range(epochs):
        p, o, loss = jl._train_step_fleet(p, o, jnp.asarray(x), jnp.asarray(m), model.apply, tx)
        losses.append(float(jnp.mean(loss)))
        if plateau.stop(e + 1, losses[-1]):
            break
    return np.asarray(mus), np.asarray(sds), np.asarray(losses)


@pytest.mark.parametrize("J,seed", [(3, 5), (1, 6)])
def test_train_fleet_stops_at_the_reference_s_epoch(J, seed):
    """The plateau reads the fleet-mean loss: the port's twin stops at the
    reference's epoch and ends with its normalizers (one job: the reference's
    single-job train, which the engine uses for a group of one, is the same
    loop)."""
    F, H, Z, W, K = 3, 8, 4, 16, 5
    x, m = _windows(seed, J, K, W, F)
    mus, sds, losses = _reference_fleet(x, m, H, Z, 30)
    hist = []
    params, mu, sd = tl.train_fleet(x, m, hidden=H, latent=Z, epochs=30, device="cpu",
                                    history=hist)
    assert len(hist) == len(losses) < 30  # the plateau stopped both
    np.testing.assert_allclose([float(h) for h in hist], losses, rtol=1e-5)
    np.testing.assert_allclose(mu.numpy(), mus, rtol=1e-4)
    np.testing.assert_allclose(sd.numpy(), sds, rtol=1e-4)
    assert params.shape == (J, tl.param_count(F, H, Z))
    if J == 1:
        (row, step, _, _), last = tl.train(x[0], m[0], hidden=H, latent=Z, epochs=30,
                                           device="cpu")
        assert int(step) == len(losses)
        torch.testing.assert_close(row, params[0], rtol=0, atol=0)
        np.testing.assert_allclose(float(last), losses[-1], rtol=1e-5)


def test_the_training_fixture_is_the_reference_s():
    """tests/data/lstm_ae_train_ref.npz against JAX here: the initial row
    bit for bit, the first epochs' losses, and the trained rows equal to the
    scoring fixture's (one training made both)."""
    d = np.load(TRAIN_FIXTURE)
    F, H, Z, W, E = (int(v) for v in d["dims"])
    model = jl.LstmAutoencoder(hidden=H, latent=Z, features=F)
    state, tx = jl.init_state(model, jax.random.PRNGKey(0), T=W)
    np.testing.assert_array_equal(_flat(state.params), d["init"])
    s = np.load(SCORE_FIXTURE)
    np.testing.assert_array_equal(d["params"], s["params"])
    np.testing.assert_array_equal(d["mu"], s["mu"])
    np.testing.assert_array_equal(d["sigma"], s["sigma"])
    J = d["x_train"].shape[0]
    p = jax.tree.map(lambda a: jnp.array(jnp.broadcast_to(a[None], (J,) + a.shape)),
                     state.params)
    o = jax.tree.map(lambda a: jnp.array(jnp.broadcast_to(a[None], (J,) + a.shape)),
                     state.opt_state)
    x, m = jnp.asarray(d["x_train"]), jnp.asarray(d["m_train"])
    for e in range(2):
        p, o, loss = jl._train_step_fleet(p, o, x, m, model.apply, tx)
        np.testing.assert_allclose(float(jnp.mean(loss)), d["losses"][e], rtol=1e-6)
    assert len(d["losses"]) <= E


def test_the_port_trains_the_fixture_as_the_reference():
    """The twin's train_fleet on the fixture's 8 jobs x 45 windows at the
    engine's width: the same 30 epochs, each fleet-mean loss, mu, sigma,
    and the scoring fixture's z as the reference's."""
    d = np.load(TRAIN_FIXTURE)
    s = np.load(SCORE_FIXTURE)
    F, H, Z, W, E = (int(v) for v in d["dims"])
    hist = []
    params, mu, sd = tl.train_fleet(d["x_train"], d["m_train"], hidden=H, latent=Z, epochs=E,
                                    device="cpu", history=hist)
    assert len(hist) == len(d["losses"])
    np.testing.assert_allclose([float(h) for h in hist], d["losses"], rtol=1e-5)
    np.testing.assert_allclose(mu.numpy(), d["mu"], rtol=1e-4)
    np.testing.assert_allclose(sd.numpy(), d["sigma"], rtol=1e-4)
    z = tl.anomaly_scores_fleet(params, s["x"], s["mask"], mu, sd, hidden=H, latent=Z,
                                device="cpu").numpy()
    np.testing.assert_allclose(z, s["z"], rtol=0, atol=1e-3)
    edge = np.abs(s["z"] - 3.0) <= 1e-3
    np.testing.assert_array_equal((z > 3)[~edge], (s["z"] > 3)[~edge])


def test_plateau_is_the_reference_s_rule():
    for losses in ([1.0] * 30, list(np.linspace(1.0, 0.1, 30)), [1.0, 0.5] * 15,
                   list(1.0 / np.arange(1, 31))):
        ref, mine = jl._Plateau(), tl._Plateau()
        stops = [(ref.stop(e + 1, v), mine.stop(e + 1, v)) for e, v in enumerate(losses)]
        assert all(a == b for a, b in stops)
        assert all(tl._Plateau.due(e + 1) == (e + 1 >= 10 and (e + 1) % 5 == 0)
                   for e in range(30))
