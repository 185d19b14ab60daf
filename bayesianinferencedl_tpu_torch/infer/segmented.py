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

Everything the driver accumulates lives in one ``SegmentProgress``, so a
disk-checkpointed run (``infer/checkpointed.py``) can save it after each
segment and hand a restored one back to resume the run where it stopped.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

# name -> (extract_rate(res), count_factor(kept), denominator(total_kept));
# count_factor must be the exact denominator the segment runner used, so
# rate * count_factor recovers the raw count.
RateSpec = Tuple[Callable[[Any], Any], Callable[[int], float], Callable[[int], float]]


@dataclass
class SegmentProgress:
    """Where a segmented run stands: steps done, segments run, post-burn
    steps kept, the raw counts behind each rate (None until a segment keeps
    a step) and the kept samples and misfits, one chunk per segment that
    kept any."""

    done: int = 0
    n_segments: int = 0
    total_kept: int = 0
    counts: Dict[str, Any] = field(default_factory=dict)
    s_chunks: List[Any] = field(default_factory=list)
    p_chunks: List[Any] = field(default_factory=list)


def drive_segments(
    run_segment: Callable,
    carry: Any,
    *,
    n_steps: int,
    n_burn: int,
    segment: int,
    rates: Dict[str, RateSpec],
    progress: Optional[SegmentProgress] = None,
    on_segment: Optional[Callable[[SegmentProgress, Any, Any], None]] = None,
):
    """Run ``run_segment(carry, n_steps, n_burn, start) -> (res, carry)`` in
    chunks of at most ``segment`` steps. ``start`` is the global index of
    the segment's first step, so a runner can keep its Robbins-Monro clock
    running across segments (pass it as ``adapt_t0``). ``res`` must expose
    ``.samples`` (kept-major) and ``.phi_trace``.

    progress: a run to continue (its carry is ``carry``), else a fresh one.
    on_segment(progress, carry, res): called after each segment's
    accounting (a checkpoint's hook).

    Returns (last_res, carry, samples, phis, rates_out, total_kept), with
    samples and phis concatenated over the post-burn segments and rates_out
    covering the whole post-burn run; last_res is None when a continued run
    had no step left."""
    if n_steps <= 0:
        raise ValueError(f"drive_segments needs n_steps >= 1, got {n_steps}")
    pr = progress if progress is not None else SegmentProgress()
    counts = pr.counts
    for name in rates:
        counts.setdefault(name, None)
    res = None
    while pr.done < n_steps:
        this = min(segment, n_steps - pr.done)
        burn = min(max(n_burn - pr.done, 0), this)
        res, carry = run_segment(carry, this, burn, pr.done)
        kept = this - burn
        if kept > 0:
            for name, (get, count_factor, _) in rates.items():
                c = get(res) * count_factor(kept)
                counts[name] = c if counts[name] is None else counts[name] + c
            pr.total_kept += kept
            pr.s_chunks.append(res.samples)
            pr.p_chunks.append(res.phi_trace)
        pr.done += this
        pr.n_segments += 1
        if on_segment is not None:
            on_segment(pr, carry, res)
    samples = torch.cat(pr.s_chunks) if pr.s_chunks else res.samples
    phis = torch.cat(pr.p_chunks) if pr.p_chunks else res.phi_trace
    rates_out = {}
    for name, (get, _, denominator) in rates.items():
        rates_out[name] = (
            counts[name] / denominator(pr.total_kept) if counts[name] is not None else get(res)
        )
    return res, carry, samples, phis, rates_out, pr.total_kept


# the accounting conventions of the ported samplers


def per_kept_spec(get: Callable[[Any], Any]) -> RateSpec:
    """A mean over the kept steps (a rate, a level mean), read by ``get``:
    segment value = sum / kept."""
    return (get, lambda kept: kept, lambda total: max(total, 1))


def accept_rate_spec() -> RateSpec:
    """Per-step acceptance: segment rate = count / kept."""
    return per_kept_spec(lambda r: r.accept_rate)


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
