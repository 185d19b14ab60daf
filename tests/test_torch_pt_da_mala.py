"""Tempered delayed acceptance with MALA subchains in the port
(infer/tempering.py run_pt_da, inner="mala") against the JAX reference.

1. Replay, in float64 on a mildly nonlinear forward with a correlated prior:
   run_pt_da_segmented with inner="mala" (three segments, an adaptive
   ladder, the outer-acceptance EMA that adapts the inner step) is fed the
   draws of JAX's key schedule, regenerated here from the reference's
   splits, and must give every field of JAX's result to 1e-10.
2. tests/test_tempering.py's case on the port's own torch.Generator, at
   its tolerances: the fine model's bimodal masses from subchains on the
   biased, equal-well coarse model (4x its chains for a quarter of its
   kept steps: the same kept draws)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from bayesianinferencedl_tpu.infer import tempering as jt
from bayesianinferencedl_tpu_torch.infer import tempering as tt
from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior as TPrior
from test_torch_pt_mala import D, PT_FIELDS, _bimodal, _close, _hops, _problem, _run_keys, _same_rate

torch.set_num_threads(1)  # one intra-op thread a process: the test workers share the CPUs


def _pt_da_draws(key, n_steps, n_burn, subchain, K, G):
    """JAX's run_pt_da(key) draws: per outer step the subchain's normals and
    uniforms, the outer uniforms and the swap uniforms."""
    nrm, uni, outer, swap = [], [], [], []
    for k in _run_keys(key, n_steps, n_burn):
        k_sub, k_acc, k_swap = jax.random.split(k, 3)
        pairs = [jax.random.split(ki) for ki in jax.random.split(k_sub, subchain)]
        nrm.append(np.stack([np.array(jax.random.normal(a, (K, G, D), jnp.float64)) for a, _ in pairs]))
        uni.append(np.stack([np.array(jax.random.uniform(b, (K, G), jnp.float64)) for _, b in pairs]))
        outer.append(np.array(jax.random.uniform(k_acc, (K, G), jnp.float64)))
        swap.append(np.array(jax.random.uniform(k_swap, (K, G), jnp.float64)))
    return tuple(torch.from_numpy(np.stack(a)) for a in (nrm, uni, outer, swap))


def test_run_pt_da_mala_inner_replays_reference_over_three_segments():
    j, t = _problem()
    K, G, S, n_steps, n_burn, segment = 3, 8, 3, 10, 6, 4  # segments 4 (burn-in), 4 (2), 2 (0)
    theta0 = np.random.default_rng(4).normal(0.0, 0.7, (G, D))
    key = jax.random.PRNGKey(9)
    kw = dict(n_steps=n_steps, n_burn=n_burn, beta=0.2, subchain=S, n_temps=K, lambda_min=0.1,
              segment=segment, adapt_ladder=True, inner="mala")
    rj = jt.run_pt_da_segmented(j["misfit"], j["coarse"], j["prior"], jnp.asarray(theta0), key,
                                batched=True, **kw)
    parts, done, k = [], 0, key
    while done < n_steps:
        this = min(segment, n_steps - done)
        k, sub = jax.random.split(k)
        parts.append(_pt_da_draws(sub, this, min(max(n_burn - done, 0), this), S, K, G))
        done += this
    nrm, uni, outer, sw = (torch.cat([p[i] for p in parts]) for i in range(4))
    rt = tt.run_pt_da_segmented(t["misfit"], t["coarse"], t["prior"], torch.from_numpy(theta0),
                                normals=nrm, uniforms=uni, outer_uniforms=outer, swap_uniforms=sw, **kw)
    assert rt.samples.shape == (n_steps - n_burn, G, D)
    for f in PT_FIELDS + ("beta",):
        _close(getattr(rt, f), getattr(rj, f))
    _same_rate(rt.accept_rate, rj.accept_rate)
    _same_rate(rt.inner_accept_rate, rj.inner_accept_rate)
    assert rt.n_fine_evals == rj.n_fine_evals == n_steps + 3
    assert 0 < float(rt.inner_accept_rate.mean()) < 1


def test_pt_da_mala_inner_exact_bimodal_masses():
    """Tempered DA with MALA subchains on the equal-well coarse model: the
    tempered MALA kernel is reversible with respect to each level's coarse
    target, so the fine correction recovers the fine masses."""
    misfit_f, mass_right, mean = _bimodal(0.5)
    misfit_c, _, _ = _bimodal(0.0)
    prior = TPrior.iid(1, mean=0.0, sigma=1.0, dtype=torch.float64, device="cpu")
    gen = torch.Generator().manual_seed(2)
    res = tt.run_pt_da(misfit_f, misfit_c, prior, prior.sample(gen, (256,)), gen, n_steps=1000,
                       n_burn=250, beta=0.05, subchain=4, n_temps=5, lambda_min=0.02, inner="mala")
    s = res.samples.reshape(-1).numpy()
    assert abs(float((s > 0).mean()) - mass_right) < 0.05
    assert abs(s.mean() - mean) < 0.1
    assert _hops(res.samples) > 1e-3
    assert 0.15 < float(res.accept_rate.mean()) < 0.9999
