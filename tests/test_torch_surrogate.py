"""The port's MLP error surrogate (bayesianinferencedl_tpu_torch.models)
against the JAX reference: predictions with converted weights and one Adam
step on the same batch, each to 1e-6 in float32, and the whole training loop
with replayed minibatch draws in float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bayesianinferencedl_tpu.models import surrogate as js
from bayesianinferencedl_tpu_torch.models import surrogate as ts

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs

SIZES = (5, 16, 16, 5)


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(21)
    x = rng.normal(0.0, 0.6, (48, 5)).astype(np.float32)
    y = (1e-3 * np.tanh(x @ rng.normal(size=(5, 5)))).astype(np.float32)
    mlp_j = js.MLP(sizes=SIZES, activation="tanh")
    params_j = mlp_j.init(jax.random.PRNGKey(3), dtype=jnp.float32)
    return x, y, mlp_j, params_j


def _to_torch(params_j):
    return [(torch.tensor(np.asarray(W)), torch.tensor(np.asarray(b))) for W, b in params_j]


def test_predict_with_converted_weights(setup):
    x, y, mlp_j, params_j = setup
    norm_j = js.Normalizer.fit(jnp.asarray(x), jnp.asarray(y))
    yj = np.asarray(js.TrainedSurrogate(mlp_j, params_j, norm_j).predict(jnp.asarray(x)))
    norm_t = ts.Normalizer(*(torch.tensor(np.asarray(a)) for a in norm_j))
    sur_t = ts.TrainedSurrogate(ts.MLP.from_params(_to_torch(params_j), "tanh"), norm_t)
    yt = sur_t.predict(torch.tensor(x)).numpy()
    assert yt.dtype == np.float32
    np.testing.assert_allclose(yt, yj, rtol=1e-6, atol=1e-6 * np.abs(yj).max())
    # Normalizer.fit agrees too (population std, +1e-8)
    nt = ts.Normalizer.fit(torch.tensor(x), torch.tensor(y))
    for a, b in zip(nt, norm_j):
        b = np.asarray(b)
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-6 * np.abs(b).max())


def test_one_adam_step_matches_reference(setup):
    x, y, mlp_j, params_j = setup
    xb, yb = x[:32], y[:32] * 1e3
    lr = 1e-3

    def loss_j(p):
        return jnp.mean((mlp_j.apply(p, jnp.asarray(xb)) - jnp.asarray(yb)) ** 2)

    # each of the reference's functions as one compiled program
    g = jax.jit(jax.grad(loss_j))(params_j)
    new_j, st_j = jax.jit(js.adam_update)(params_j, g, js.adam_init(params_j), jnp.asarray(lr, jnp.float32))

    mlp_t = ts.MLP.from_params(_to_torch(params_j), "tanh")
    params_t = mlp_t.params()
    loss = torch.mean((mlp_t(torch.tensor(xb)) - torch.tensor(yb)) ** 2)
    grads = torch.autograd.grad(loss, params_t)
    st_t = ts.adam_update(params_t, grads, ts.adam_init(params_t), lr)
    assert st_t.step == int(st_j.step) == 1
    flat_j = [a for W, b in new_j for a in (W, b)]
    for pt, pj in zip(params_t, flat_j):
        pj = np.asarray(pj)
        np.testing.assert_allclose(pt.detach().numpy(), pj, rtol=1e-6, atol=1e-6 * np.abs(pj).max())
    for mt, (mW, mb) in zip(st_t.mu[::2], st_j.mu):
        np.testing.assert_allclose(mt.numpy(), np.asarray(mW), rtol=1e-6, atol=1e-9)


def test_train_loop_replayed_draws_match_reference():
    """The whole training loop (Adam, minibatches, best-validation snapshot)
    from JAX's initial weights with JAX's minibatch rows replayed: the
    selected parameters, the loss curve and the best validation loss equal
    the reference's in float64 to 1e-7. Both sides form Adam's bias
    correction in float32 (the reference's ``step.astype(float32)``), and
    XLA's and torch's float32 ``pow`` differ by an ulp at some steps: the
    run is exact to 1e-15 until then and then differs by ~3e-9."""
    rng = np.random.default_rng(5)
    x = rng.uniform(np.log(0.1), np.log(10.0), (96, 5))
    y = 1e-4 * np.tanh(x @ rng.normal(size=(5, 5))) + 1e-5 * rng.normal(size=(96, 5))
    batch, steps, n_val, lr = 16, 80, 10, 1e-2
    mlp_j = js.MLP(sizes=(5, 16, 16, 5), activation="tanh")
    key, init_key = jax.random.split(jax.random.PRNGKey(4))
    params_j = mlp_j.init(init_key, dtype=jnp.float64)
    xj, yj = jnp.asarray(x, jnp.float64), jnp.asarray(y, jnp.float64)
    norm_j = js.Normalizer.fit(xj, yj)
    best_j, losses_j, val_j = js._train_loop(mlp_j, params_j, norm_j, xj, yj, key,
                                             jnp.asarray(lr, jnp.float64), batch, steps, n_val)
    # the rows js._train_loop draws: one randint per step from split(key, steps)
    keys = jax.random.split(key, steps)
    idx = np.stack([np.asarray(jax.random.randint(k, (batch,), 0, x.shape[0] - n_val)) for k in keys])

    mlp_t = ts.MLP.from_params(_to_torch(params_j), "tanh")
    norm_t = ts.Normalizer.fit(torch.from_numpy(x), torch.from_numpy(y))
    best_t, losses_t, val_t = ts._train_loop(
        mlp_t, norm_t, torch.from_numpy(x), torch.from_numpy(y), None, lr, batch, steps, n_val,
        idx=torch.from_numpy(idx))
    assert losses_t.dtype == torch.float64
    np.testing.assert_allclose(losses_t.numpy(), np.asarray(losses_j), rtol=1e-7)
    np.testing.assert_allclose(float(val_t), float(val_j), rtol=1e-7)
    assert float(val_t) < float(jnp.mean(((yj[-n_val:] - norm_j.y_mean) / norm_j.y_std) ** 2))
    flat_j = [a for W, b in best_j for a in (W, b)]
    for pt, pj in zip(best_t, flat_j):
        pj = np.asarray(pj)
        np.testing.assert_allclose(pt.numpy(), pj, rtol=1e-7, atol=1e-7 * np.abs(pj).max())


def test_train_surrogate_keeps_best_validation_state(setup):
    x, y, _, _ = setup
    sur, losses = ts.train_surrogate(torch.tensor(x), torch.tensor(y), hidden=(16, 16),
                                     batch_size=16, steps=60, seed=1)
    assert losses.shape == (60,) and torch.isfinite(losses).all()
    # the best-validation snapshot never validates worse than the constant-mean anchor
    n_val = int(0.1 * x.shape[0])
    xv, yv = torch.tensor(x[-n_val:]), torch.tensor(y[-n_val:])
    err = torch.mean(((sur.predict(xv) - yv) / sur.norm.y_std) ** 2)
    anchor = torch.mean(((sur.norm.y_mean - yv) / sur.norm.y_std) ** 2)
    assert err <= anchor * (1 + 1e-5)


def test_mlp_defaults_to_the_card():
    """The card is the default; absent, MLP raises, no CPU fallback.
    from_params keeps the params' device."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            ts.MLP(SIZES)
    mlp = ts.MLP(SIZES, device="cpu")
    assert all(p.device.type == "cpu" for p in mlp.params())
    again = ts.MLP.from_params([(W.detach(), b.detach()) for W, b in zip(mlp.weights, mlp.biases)])
    assert all(p.device.type == "cpu" for p in again.params())
