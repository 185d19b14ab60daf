"""MCMC diagnostics: the rank-normalised split estimators (Vehtari, Gelman,
Simpson, Carpenter, Bürkner 2021) split-R-hat, bulk ESS and tail ESS, the
production gates; the reference's plain per-chain ESS and Gelman-Rubin
R-hat; and the two-sample KS distance.

Like the JAX reference, the rank normalisation and the autocorrelation
work in float32 (these are diagnostics), and one parameter dimension is
processed at a time so the pooled sorts stay bounded in memory.
"""

from __future__ import annotations

import torch

_TINY32 = torch.finfo(torch.float32).tiny


def _autocorr_fft(x: torch.Tensor) -> torch.Tensor:
    """Normalised autocorrelation of each column of x (n, c), via FFT, in
    float32."""
    n = x.shape[0]
    x = x.to(torch.float32)
    x = x - x.mean(0)
    f = torch.fft.rfft(x, n=2 * n, dim=0)
    acf = torch.fft.irfft(f * f.conj(), n=2 * n, dim=0)[:n]
    return acf / torch.clamp(acf[0], min=_TINY32)


def effective_sample_size(chains: torch.Tensor) -> torch.Tensor:
    """Per-chain ESS summed over chains, Geyer's truncated positive-pair
    rule on each chain's own autocorrelation (no splitting, no rank
    normalisation: ``ess_bulk`` is the production gate; this is the
    reference's older estimator, which a multimodal posterior flatters).
    chains (n, c, d) -> (d,); (n, c) -> (1,). The autocorrelation is taken
    in float32, the sums in the chains' dtype, as the reference does."""
    if chains.dim() == 2:
        chains = chains[..., None]
    n, c, d = chains.shape
    n_pairs = (n - 1) // 2
    out = []
    for j in range(d):  # one dimension's spectra at a time
        rho = _autocorr_fft(chains[:, :, j])  # (n, c)
        pair = rho[1 : 1 + 2 * n_pairs].reshape(n_pairs, 2, c).sum(1)
        keep = torch.cumprod((pair > 0).to(chains.dtype), 0)
        tau = 1.0 + 2.0 * torch.sum(pair * keep, 0)
        out.append(torch.sum(n / torch.clamp(tau, min=1.0)))
    return torch.stack(out)


def ks_distance(samples_a: torch.Tensor, samples_b: torch.Tensor) -> torch.Tensor:
    """Two-sample Kolmogorov-Smirnov distance per marginal: the largest
    difference of the two empirical CDFs over the pooled sample points.
    samples (..., d), flattened to (N, d). Returns (d,) in float32, the
    reference's dtype for the count ratios."""
    a = samples_a.reshape(-1, samples_a.shape[-1])
    b = samples_b.reshape(-1, samples_b.shape[-1])
    out = []
    for j in range(a.shape[1]):
        xs, ys = torch.sort(a[:, j]).values, torch.sort(b[:, j]).values
        grid = torch.cat([xs, ys])
        Fa = torch.searchsorted(xs, grid, right=True).to(torch.float32) / xs.shape[0]
        Fb = torch.searchsorted(ys, grid, right=True).to(torch.float32) / ys.shape[0]
        out.append(torch.max(torch.abs(Fa - Fb)))
    return torch.stack(out)


def rhat(chains: torch.Tensor) -> torch.Tensor:
    """Plain Gelman-Rubin potential scale reduction (unsplit, not rank
    normalised: ``split_rhat`` is the production gate). chains (n, c, d)
    -> (d,)."""
    if chains.dim() == 2:
        chains = chains[..., None]
    if chains.shape[1] < 2:
        raise ValueError(
            f"rhat needs >= 2 chains (cross-chain variance is undefined for one); got shape "
            f"{tuple(chains.shape)}"
        )
    n = chains.shape[0]
    W = torch.mean(torch.var(chains, 0, correction=1), 0)
    B = n * torch.var(torch.mean(chains, 0), 0, correction=1)
    var_plus = (n - 1) / n * W + B / n
    return torch.sqrt(var_plus / torch.clamp(W, min=torch.finfo(chains.dtype).tiny))


def _quantile(x: torch.Tensor, q: float) -> torch.Tensor:
    """Linear-interpolation quantile over all elements (numpy's default),
    without torch.quantile's input-size limit."""
    s = torch.sort(x.reshape(-1)).values
    pos = q * (s.numel() - 1)
    lo = int(pos)
    hi = min(lo + 1, s.numel() - 1)
    w = pos - lo
    return s[lo] * (1.0 - w) + s[hi] * w


def _split_chains(chains: torch.Tensor) -> torch.Tensor:
    """(n, c, d) -> (n//2, 2c, d): each chain split into halves (a trailing
    odd step is dropped)."""
    if chains.dim() == 2:
        chains = chains[..., None]
    n, c, d = chains.shape
    n2 = n // 2
    return chains[: 2 * n2].reshape(2, n2, c, d).permute(1, 0, 2, 3).reshape(n2, 2 * c, d)


def _rank_normalize_2d(x: torch.Tensor) -> torch.Tensor:
    """Pooled fractional ranks -> normal scores for one dimension, x (n, c).
    Blom offset u = (r + 0.625)/(N + 0.25); the upper half goes through the
    complementary rank and ndtri's antisymmetry so u never rounds to 1 in
    float32 at large N."""
    n, c = x.shape
    flat = x.reshape(-1).to(torch.float32)
    N = n * c
    r = torch.argsort(torch.argsort(flat, stable=True), stable=True)
    q = (N - 1) - r
    lo = r <= q
    u_small = (torch.where(lo, r, q).to(torch.float32) + 0.625) / (N + 0.25)
    z = torch.special.ndtri(u_small)
    return torch.where(lo, z, -z).reshape(n, c)


def _rhat_2d(z: torch.Tensor) -> torch.Tensor:
    n = z.shape[0]
    W = torch.mean(torch.var(z, 0, correction=1))
    B = n * torch.var(torch.mean(z, 0), correction=1)
    var_plus = (n - 1) / n * W + B / n
    return torch.sqrt(var_plus / torch.clamp(W, min=torch.finfo(z.dtype).tiny))


def split_rhat(chains: torch.Tensor) -> torch.Tensor:
    """Rank-normalised split-R-hat, the max of the bulk and tail (folded)
    statistics. chains (n, c, d) -> (d,)."""
    s = _split_chains(chains)
    out = []
    for j in range(s.shape[2]):
        sd = s[:, :, j]
        bulk = _rhat_2d(_rank_normalize_2d(sd))
        folded = torch.abs(sd - _quantile(sd, 0.5))
        tail = _rhat_2d(_rank_normalize_2d(folded))
        out.append(torch.maximum(bulk, tail))
    return torch.stack(out)


def _combined_tau(z: torch.Tensor) -> torch.Tensor:
    """Integrated autocorrelation time of (n, c) split draws with the
    between-chain combined estimator and Geyer's initial positive +
    monotone sequence."""
    n, c = z.shape
    s2 = torch.var(z, 0, correction=1)
    W = torch.mean(s2)
    Bv = n * torch.var(torch.mean(z, 0), correction=1) if c > 1 else 0.0
    var_plus = (n - 1) / n * W + Bv / n
    rho_c = _autocorr_fft(z)
    mean_rho = torch.mean(s2[None, :] * rho_c * (n - 1) / n, 1)
    rho = 1.0 - (W - mean_rho) / torch.clamp(var_plus, min=torch.finfo(z.dtype).tiny)
    n_pairs = n // 2
    pair = rho[: 2 * n_pairs].reshape(n_pairs, 2).sum(1)
    keep = torch.cumprod((pair > 0).to(z.dtype), 0)
    pair_mono = torch.cummin(torch.where(keep > 0, pair, torch.inf), 0).values
    tau = -1.0 + 2.0 * torch.sum(torch.where(keep > 0, pair_mono, 0.0))
    return torch.clamp(tau, min=1.0 / (n * c))


def _cap(ess: torch.Tensor, n_draws: int) -> torch.Tensor:
    """Stan's optimistic iid-plus cap (antithetic chains)."""
    lim = n_draws * torch.log10(torch.tensor(float(n_draws), dtype=torch.float32))
    return torch.minimum(ess, lim.to(ess.device))


def ess_bulk(chains: torch.Tensor) -> torch.Tensor:
    """Bulk ESS on rank-normalised split chains with the combined
    between-chain autocorrelation estimator. (n, c, d) -> (d,);
    (n, c) -> scalar."""
    squeeze = chains.dim() == 2
    s = _split_chains(chains)
    n2, c2, d = s.shape
    tau = torch.stack([_combined_tau(_rank_normalize_2d(s[:, :, j])) for j in range(d)])
    ess = _cap((n2 * c2) / tau, n2 * c2)
    return ess[0] if squeeze else ess


def ess_tail(chains: torch.Tensor) -> torch.Tensor:
    """Tail ESS: the smaller ESS of the 5% and 95% pooled-quantile
    exceedance indicators on split chains. (n, c, d) -> (d,)."""
    squeeze = chains.dim() == 2
    s = _split_chains(chains)
    n2, c2, d = s.shape
    out = []
    for j in range(d):
        sd = s[:, :, j]
        e = [
            (n2 * c2) / _combined_tau((sd <= _quantile(sd, q)).to(torch.float32))
            for q in (0.05, 0.95)
        ]
        out.append(torch.minimum(e[0], e[1]))
    ess = _cap(torch.stack(out), n2 * c2)
    return ess[0] if squeeze else ess
