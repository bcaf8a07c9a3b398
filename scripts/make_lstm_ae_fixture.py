#!/usr/bin/env python3
"""Write tests/data/lstm_ae_ref.npz (LSTM-autoencoder parameters trained by
the JAX reference, and the reference's z-scores on evaluation windows) and
tests/data/lstm_ae_train_ref.npz (the same training, recorded: the
reference's initial parameters, the training windows, each epoch's loss).

    JAX_PLATFORMS=cpu python scripts/make_lstm_ae_fixture.py [--train-only]

--train-only leaves lstm_ae_ref.npz as it is and writes the training file
alone (both come from the same seeded data and the same training run).

Runs the reference (foremast_tpu) on the CPU; never on the card. Eight
jobs, each a seeded synthetic service of four metrics (latency, error rate,
cpu, tps: a shared daily load cycle, correlated noise, 3% lost samples),
standardized per metric on its history as the engine does. The reference's
train_fleet fits the jobs' autoencoders at F = 4, H = 32, Z = 16 (the
engine's LSTM_HIDDEN and LSTM_LATENT), W = 32, 30 epochs, on the 45
windows of one day of history; its fit_score_normalizer gives each job's
mu and sigma. Each job then has 12 evaluation windows: 6 healthy ones (the
last with the engine's masked head, the history part of a tail window), 6
anomalous ones (a +4 sigma latency shift, an error burst, cpu decoupled
from traffic, a traffic drop, a frozen metric, a gap-riddled shift).

The file holds, for J = 8 jobs and K = 12 windows: params (J, P) float32 in
foremast_tpu_torch.models.lstm_ae's flat layout (P = 12,180), mu and sigma
(J,), x (J, K, W, F) float32, mask (J, K, W, F) bool, anomalous (K,) bool,
z (J, K) float32 (the reference's anomaly_scores_fleet) and err (J, K)
(its reconstruction_errors). The port's tests and chip_smoke.py read it
with numpy alone.

The training file holds init (P,) float32, the reference's init_state
parameters at PRNGKey(0) in the flat layout; x_train, m_train (J, 45, W,
F), the training windows; losses (E,) float64, the fleet-mean loss of each
epoch train_fleet ran (its plateau stop included: E is the stop epoch); and
params (J, P), mu, sigma (J,), what it returned (equal to lstm_ae_ref.npz's).
The loop is the reference's train_fleet written out with its own
_train_step_fleet and _Plateau, so that each epoch's loss can be kept; the
script checks that it ends with train_fleet's parameters, bit for bit.
"""
from __future__ import annotations

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
OUT = os.path.join(REPO, "tests", "data", "lstm_ae_ref.npz")
TRAIN_OUT = os.path.join(REPO, "tests", "data", "lstm_ae_train_ref.npz")

SEED = 20261017
J, F, H, Z, W, EPOCHS = 8, 4, 32, 16, 32, 30
DAY = 1440
K_HEALTHY, K_ANOMALOUS = 6, 6


def service(rng, n):
    """(n, F) raw metrics of one service at 60 s steps, and its mask."""
    t = np.arange(n)
    load = 1.0 + 0.5 * np.sin(2 * np.pi * t / DAY + rng.uniform(0, 2 * np.pi))
    tps = rng.uniform(100, 500) * load * (1 + 0.03 * rng.standard_normal(n))
    cpu = rng.uniform(10, 40) * load * (1 + 0.05 * rng.standard_normal(n))
    lat = rng.uniform(20, 80) * (1 + 0.3 * (load - 1)) * (1 + 0.06 * rng.standard_normal(n))
    err = np.abs(rng.uniform(0.1, 1.0) * load + 0.1 * rng.standard_normal(n))
    x = np.stack([lat, err, cpu, tps], -1)
    mask = rng.random((n, F)) > 0.03
    return x, mask


def anomalies(rng, x, m, sd):
    """The six anomalous variants of a healthy (W, F) window (raw units)."""
    out = []
    a = x.copy()
    a[:, 0] += 4 * sd[0]
    out.append((a, m))
    a = x.copy()
    a[W // 2:, 1] += 6 * sd[1]
    out.append((a, m))
    a = x.copy()
    a[:, 2] = a[:, 2].mean() + 3 * sd[2] * rng.standard_normal(W)
    out.append((a, m))
    a = x.copy()
    a[:, 3] *= 0.3
    out.append((a, m))
    a = x.copy()
    a[:, :] = a[0]
    out.append((a, m))
    a = x.copy()
    a[:, 0] += 3 * sd[0]
    a[:, 2] -= 3 * sd[2]
    mm = m & (rng.random(m.shape) > 0.3)
    out.append((a, mm))
    return out


def train_recorded(jl, model, x, m, epochs):
    """The reference's train_fleet, written out with its own pieces so that
    each epoch's fleet-mean loss is kept. Returns (params, mu, sigma,
    losses)."""
    import jax
    import jax.numpy as jnp

    n_jobs, _, w, _ = x.shape
    state, tx = jl.init_state(model, jax.random.PRNGKey(0), T=w)
    params = jax.tree.map(lambda a: jnp.array(jnp.broadcast_to(a[None], (n_jobs,) + a.shape)),
                          state.params)
    opt_state = jax.tree.map(
        lambda a: jnp.array(jnp.broadcast_to(a[None], (n_jobs,) + a.shape)), state.opt_state)
    plateau = jl._Plateau()
    losses = []
    for e in range(epochs):
        params, opt_state, loss = jl._train_step_fleet(params, opt_state, x, m, model.apply, tx)
        losses.append(float(jnp.mean(loss)))
        if plateau.stop(e + 1, losses[-1]):
            break
    mus, sds = jax.vmap(lambda p, xx, mm: jl.fit_score_normalizer(p, xx, mm, model.apply))(
        params, x, m)
    return params, mus, sds, losses


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from foremast_tpu.models import lstm_ae as jl
    from foremast_tpu_torch.models.lstm_ae import flat_params, params_from_flax

    rng = np.random.default_rng(SEED)
    n_h = DAY
    k_train = n_h // W
    xs_train, ms_train, xs_eval, ms_eval = [], [], [], []
    for _ in range(J):
        raw, mask = service(rng, n_h + 2 * W * K_HEALTHY)
        mu = (raw[:n_h] * mask[:n_h]).sum(0) / mask[:n_h].sum(0)
        sd = np.sqrt((((raw[:n_h] - mu) * mask[:n_h]) ** 2).sum(0) / mask[:n_h].sum(0))
        std = ((raw - mu) / sd).astype(np.float32)
        xs_train.append(std[:n_h].reshape(k_train, W, F))
        ms_train.append(mask[:n_h].reshape(k_train, W, F))
        ev_x, ev_m = [], []
        for k in range(K_HEALTHY):
            s = n_h + W * k
            ev_x.append(std[s:s + W])
            m = mask[s:s + W].copy()
            if k == K_HEALTHY - 1:
                s = n_h - W // 4  # a tail window: its history part is masked
                ev_x[-1] = std[s:s + W]
                m = mask[s:s + W].copy()
                m[:W // 4] = False
            ev_m.append(m)
        base = raw[n_h + W * K_HEALTHY:n_h + W * (K_HEALTHY + 1)]
        for a, m in anomalies(rng, base, mask[n_h + W * K_HEALTHY:n_h + W * (K_HEALTHY + 1)], sd):
            ev_x.append(((a - mu) / sd).astype(np.float32))
            ev_m.append(m)
        xs_eval.append(np.stack(ev_x))
        ms_eval.append(np.stack(ev_m))
    x_train, m_train = np.stack(xs_train), np.stack(ms_train)
    x_eval, m_eval = np.stack(xs_eval), np.stack(ms_eval)

    model = jl.LstmAutoencoder(hidden=H, latent=Z, features=F)
    params, mu, sigma = jl.train_fleet(model, jax.random.PRNGKey(0), jnp.asarray(x_train),
                                       jnp.asarray(m_train), epochs=EPOCHS)
    rec_params, rec_mu, rec_sigma, losses = train_recorded(
        jl, model, jnp.asarray(x_train), jnp.asarray(m_train), EPOCHS)
    for a, b in zip(jax.tree.leaves((params, mu, sigma)),
                    jax.tree.leaves((rec_params, rec_mu, rec_sigma))):
        if not np.array_equal(np.asarray(a), np.asarray(b)):
            raise SystemExit("the recorded loop did not reproduce train_fleet")
    state, _ = jl.init_state(model, jax.random.PRNGKey(0), T=W)
    init = flat_params(params_from_flax(jax.device_get(state.params))).numpy()
    z = np.asarray(jl.anomaly_scores_fleet(params, x_eval, m_eval, mu, sigma, model.apply))
    err = np.asarray(jax.vmap(lambda p, xx, mm: jl.reconstruction_errors(
        p, xx, mm, model.apply))(params, x_eval, m_eval))
    host = jax.device_get(params)
    flat = np.stack([flat_params(params_from_flax(jax.tree.map(lambda a: a[j], host))).numpy()
                     for j in range(J)])
    anomalous = np.array([False] * K_HEALTHY + [True] * K_ANOMALOUS)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    if "--train-only" not in sys.argv[1:]:
        np.savez_compressed(OUT, params=flat, mu=np.asarray(mu, np.float32),
                            sigma=np.asarray(sigma, np.float32), x=x_eval, mask=m_eval,
                            anomalous=anomalous, z=z.astype(np.float32),
                            err=err.astype(np.float32), dims=np.array([F, H, Z, W]))
        print(f"wrote {OUT}: {J} jobs, {x_eval.shape[1]} windows each; healthy z "
              f"max {z[:, ~anomalous].max():.2f}, anomalous z min "
              f"{z[:, anomalous].min():.2f}")
    np.savez_compressed(TRAIN_OUT, init=init, x_train=x_train.astype(np.float32),
                        m_train=m_train, losses=np.asarray(losses, np.float64), params=flat,
                        mu=np.asarray(mu, np.float32), sigma=np.asarray(sigma, np.float32),
                        dims=np.array([F, H, Z, W, EPOCHS]))
    print(f"wrote {TRAIN_OUT}: {J} jobs x {k_train} windows; stopped after {len(losses)} of "
          f"{EPOCHS} epochs, fleet-mean loss {losses[0]:.5f} -> {losses[-1]:.5f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
