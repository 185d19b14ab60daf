"""Bayesian inversion layer: Gaussian prior, pCN, delayed acceptance, parallel
tempering and the evidence, the MAP and Laplace approximation with the
samplers it seeds, MALA and HMC, the approximation layer (EKI, ADVI, SVGD,
tempered SMC and the PSIS certificate) and the diagnostics."""
