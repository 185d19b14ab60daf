"""The spread of SVGD's moment-matched PSIS k-hat over seeds, on the card.
From the root of a checkout:

    python -m bayesianinferencedl_tpu_torch.experimental.svgd_khat [--fits 6] [--data-seeds 4]

SVGD (512 particles x 800 steps, annealed: the bench's svgd block, bench.py
`b_svgd`) on rom_nn, then PSIS of the terminal ensemble's moment-matched
Gaussian with 4,096 draws, as `chip_smoke.py` phase 13 (c) runs it once.
The pipeline and data are phase 3's: res4, 256 snapshots, a 40-mode basis,
a 64 x 64 surrogate on 1,024 samples, noise 1e-2, MCMCConfig's seed; its
pcn run (1,024 chains x 4,000 steps) is the reference posterior.

1. Phase 3's data, --fits SVGD fits (generator seeds MCMCConfig's seed,
   the one phase 13 (c) uses, then the next ones), each certified with the
   default PSIS seed; the first fit also with three other
   PSIS seeds, which separates the draw noise of the certificate from the
   fit's.
2. --data-seeds other observation sets: theta_true and the noise drawn from
   a generator seeded 101, 102, ... (run_inversion's data contract), the
   SVGD ensemble from the same generator.

Prints one line per certificate (k-hat, ESS, the mean's error against pcn
where pcn ran) and a summary line of k-hat's range per block. Needs a card.
"""

from __future__ import annotations

import argparse
import subprocess
import time

import numpy as np
import torch

from bayesianinferencedl_tpu_torch.api import (
    build_pipeline, psis_certify, run_inversion, run_svgd_inversion,
)
from bayesianinferencedl_tpu_torch.config import (
    FEMConfig, MCMCConfig, MeshConfig, PipelineConfig, ROMConfig, SurrogateConfig,
)

SVGD = dict(n_particles=512, n_steps=800)
N_DRAWS = 4096


def _moment_q(ens: torch.Tensor):
    e = ens.double()
    cov = torch.cov(e.T) + 1e-12 * torch.eye(e.shape[1], dtype=e.dtype, device=e.device)
    return e.mean(0).float(), torch.linalg.cholesky(cov).float()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fits", type=int, default=6, help="SVGD seeds on phase 3's data")
    ap.add_argument("--data-seeds", type=int, default=4, help="other observation sets")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}", flush=True)

    cfg = PipelineConfig(
        mesh=MeshConfig(resolution=4),
        fem=FEMConfig(biot=0.1, cg_tol=1e-7, cg_maxiter=1500),
        rom=ROMConfig(n_snapshots=256, basis_size=40, online_precision="highest"),
        surrogate=SurrogateConfig(hidden=(64, 64), n_train=1024, epochs=300),
        mcmc=MCMCConfig(n_chains=1024, n_steps=4000, n_burn=1000, beta=0.25, noise_sigma=1e-2,
                        likelihood="rom_nn", sampler="pcn"),
    )
    t0 = time.perf_counter()
    pipe = build_pipeline(cfg, device="cuda")
    inv = run_inversion(pipe)
    ref = inv.result.samples.double()
    pcn_mean = ref.mean(dim=(0, 1)).cpu().numpy()
    print(f"build + pcn {time.perf_counter() - t0:.1f} s; pcn mean {np.round(pcn_mean, 4).tolist()}",
          flush=True)

    def certify(tag, sv, data, psis_seed=None, with_err=True):
        q_mean, q_chol = _moment_q(sv.particles)
        gen = None if psis_seed is None else torch.Generator(device="cuda").manual_seed(psis_seed)
        cert = psis_certify(pipe, q_mean, q_chol, data, n_draws=N_DRAWS, generator=gen)
        err = (f"; mean_abs_err_vs_pcn {np.abs(sv.mean.double().cpu().numpy() - pcn_mean).mean():.4f}"
               if with_err else "")
        print(f"{tag}: k-hat {cert.k_hat:.4f} ESS {cert.ess:.1f} reliable {cert.reliable}{err}",
              flush=True)
        return cert.k_hat

    fit_khats, draw_khats, data_khats = [], [], []
    for s in range(cfg.mcmc.seed, cfg.mcmc.seed + args.fits):
        t = time.perf_counter()
        sv, _, _, _ = run_svgd_inversion(pipe, "rom_nn", data=inv.data, theta_true=inv.theta_true,
                                         generator=torch.Generator(device="cuda").manual_seed(s),
                                         **SVGD)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        fit_khats.append(certify(f"phase 3's data, SVGD seed {s} ({wall:.2f} s), PSIS default seed",
                                 sv, inv.data))
        if s == cfg.mcmc.seed:
            for p in (1, 2, 3):
                draw_khats.append(certify(f"phase 3's data, SVGD seed {s}, PSIS seed {p}", sv, inv.data,
                                          psis_seed=p, with_err=False))
    for s in range(101, 101 + args.data_seeds):
        sv, _, data, _ = run_svgd_inversion(pipe, "rom_nn",
                                            generator=torch.Generator(device="cuda").manual_seed(s),
                                            **SVGD)
        data_khats.append(certify(f"data seed {s}, PSIS default seed", sv, data, with_err=False))

    def span(x):
        return f"{min(x):.4f}-{max(x):.4f} (mean {np.mean(x):.4f}, n {len(x)})" if x else "none"

    print(f"k-hat over SVGD seeds on phase 3's data: {span(fit_khats)}; over PSIS seeds of fit 0 "
          f"(with its default): {span(draw_khats + fit_khats[:1])}; over other data: "
          f"{span(data_khats)}; the reference's BENCH_r05: 0.771", flush=True)


if __name__ == "__main__":
    main()
