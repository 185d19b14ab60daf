"""Auxiliary subsystems: metrics and the posterior predictive check."""
