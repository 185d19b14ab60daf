"""Segmented dispatch of a chain run.

A run is split into fixed-size segments, with the chain state and the adapted
per-chain step sizes carried across segments, so the result has the law of
one long run. The port keeps the segmentation of the JAX package (there it
kept each device program under a runtime watchdog) so that the two run the
same sequence of segments and can be held against each other step for step.

The easy-to-get-wrong part is the accept accounting: each segment reports
rates over its own post-burn steps only, so the driver turns each rate back
into a count with the segment runner's own denominator, sums the counts and
divides by the denominator of the whole post-burn run. Samples stay on the
device and are concatenated with ``torch.cat``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

import torch

# name -> (extract_rate(res), count_factor(kept), denominator(total_kept));
# count_factor must be the exact denominator the segment runner used, so
# rate * count_factor recovers the raw count.
RateSpec = Tuple[Callable[[Any], Any], Callable[[int], float], Callable[[int], float]]


def drive_segments(
    run_segment: Callable,
    carry: Any,
    *,
    n_steps: int,
    n_burn: int,
    segment: int,
    rates: Dict[str, RateSpec],
):
    """Run ``run_segment(carry, n_steps, n_burn, start) -> (res, carry)`` in
    chunks of at most ``segment`` steps. ``start`` is the global index of
    the segment's first step, so a runner can keep its Robbins-Monro clock
    running across segments (pass it as ``adapt_t0``). ``res`` must expose
    ``.samples`` (kept-major) and ``.phi_trace``.

    Returns (last_res, carry, samples, phis, rates_out, total_kept), with
    samples and phis concatenated over the post-burn segments and rates_out
    covering the whole post-burn run."""
    if n_steps <= 0:
        raise ValueError(f"drive_segments needs n_steps >= 1, got {n_steps}")
    done = 0
    total_kept = 0
    counts: Dict[str, Any] = {name: None for name in rates}
    s_chunks, p_chunks = [], []
    res = None
    while done < n_steps:
        this = min(segment, n_steps - done)
        burn = min(max(n_burn - done, 0), this)
        res, carry = run_segment(carry, this, burn, done)
        kept = this - burn
        if kept > 0:
            for name, (get, count_factor, _) in rates.items():
                c = get(res) * count_factor(kept)
                counts[name] = c if counts[name] is None else counts[name] + c
            total_kept += kept
            s_chunks.append(res.samples)
            p_chunks.append(res.phi_trace)
        done += this
    samples = torch.cat(s_chunks) if s_chunks else res.samples
    phis = torch.cat(p_chunks) if p_chunks else res.phi_trace
    rates_out = {}
    for name, (get, _, denominator) in rates.items():
        rates_out[name] = (
            counts[name] / denominator(total_kept) if counts[name] is not None else get(res)
        )
    return res, carry, samples, phis, rates_out, total_kept


# the accounting conventions of the ported samplers


def accept_rate_spec() -> RateSpec:
    """Per-step acceptance: segment rate = count / kept."""
    return (lambda r: r.accept_rate, lambda kept: kept, lambda total: max(total, 1))


def inner_accept_rate_spec(subchain: int) -> RateSpec:
    """Subchain acceptance: segment rate = count / (kept * subchain)."""
    return (
        lambda r: r.inner_accept_rate,
        lambda kept: kept * subchain,
        lambda total: max(total * subchain, 1),
    )


def swap_rate_spec() -> RateSpec:
    """Adjacent-pair swaps are proposed every other step: segment rate =
    count / max(kept / 2, 1), the denominator the tempered samplers use."""
    return (
        lambda r: r.swap_rate,
        lambda kept: max(kept / 2, 1),
        lambda total: max(total / 2, 1),
    )
