"""The reference's degenerate-population flow case (tests/test_flow.py:252)
over seeds, for the JAX package's fit_flow_mle and the port's, on the CPU.

    python tests/sweep_torch_flow_degenerate.py jax 0 26
    python tests/sweep_torch_flow_degenerate.py torch 0 26

Each seed draws 32 float32 rows around the case's mean and sd, tiles them
128 times, fits a flow of 6 couplings of width 32 by 3,000 MLE steps and
prints the sd ratio of 8,192 flow draws to the rows' and whether the
case's gate (every ratio in (0.5, 2), the means within 0.3) holds; the last
line counts the seeds that fail it. A measurement script, not a test: one
seed takes 8-30 s on one thread."""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the repository's root

MEAN = [0.5845, -0.4843, -0.1081, -0.0761, -0.5730]
SD = [0.0118, 0.1007, 0.3028, 0.5778, 0.0664]


def jax_ratio(seed):
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from bayesianinferencedl_tpu.infer.flow import fit_flow_mle, flow_sample
    from bayesianinferencedl_tpu.infer.priors import GaussianPrior

    mean, sd = jnp.asarray(MEAN, jnp.float32), jnp.asarray(SD, jnp.float32)
    uniq = mean + sd * jax.random.normal(jax.random.PRNGKey(10 * seed), (32, 5), jnp.float32)
    res = fit_flow_mle(jnp.tile(uniq, (128, 1)), GaussianPrior.iid(5, sigma=0.6, dtype=jnp.float32),
                       jax.random.PRNGKey(10 * seed + 1), n_couplings=6, hidden=32, n_steps=3000,
                       n_batch=256, lr=0.01)
    th = np.asarray(flow_sample(res, jax.random.PRNGKey(10 * seed + 2), (8192,)))
    return th, np.asarray(uniq)


def torch_ratio(seed):
    import torch

    from bayesianinferencedl_tpu_torch.infer.flow import fit_flow_mle, flow_sample
    from bayesianinferencedl_tpu_torch.infer.priors import GaussianPrior

    torch.set_num_threads(1)
    g = torch.Generator().manual_seed(seed)
    uniq = torch.tensor(MEAN) + torch.tensor(SD) * torch.randn((32, 5), generator=g)
    res = fit_flow_mle(torch.tile(uniq, (128, 1)), GaussianPrior.iid(5, sigma=0.6, device="cpu"), g,
                       n_couplings=6, hidden=32, n_steps=3000, n_batch=256, lr=0.01)
    return flow_sample(res, g, (8192,)).numpy(), uniq.numpy()


def main(argv):
    side, lo, hi = argv[0], int(argv[1]), int(argv[2])
    fit = {"jax": jax_ratio, "torch": torch_ratio}[side]
    fails = 0
    for seed in range(lo, hi):
        th, uniq = fit(seed)
        ratio = th.std(0) / uniq.std(0)
        ok = bool(np.all(ratio > 0.5) and np.all(ratio < 2.0)
                  and np.abs(th.mean(0) - uniq.mean(0)).max() < 0.3)
        fails += not ok
        print(f"{side} seed {seed}: sd ratios {[round(float(r), 3) for r in ratio]} {'pass' if ok else 'FAIL'}",
              flush=True)
    print(f"{side}: {fails} of {hi - lo} seeds fail the gate")


if __name__ == "__main__":
    main(sys.argv[1:])
