"""Bayesian inversion layer: Gaussian prior, batched pCN, rank-normalised
diagnostics."""
