"""k4r_roofline: K4r's share of its roofline (%): the least time the card
could take for the window's K4r solves (the frozen counts on the fin's own
nodes, at the iteration counts each solve reports and the H100's published
peaks) over K4r's device time in the trace, found by kernel name."""

from portbench.harness import say
from portbench.yardstick import roofline as rl

KERNEL = "pcg_stencil_grid_resident_kernel"


def read(run):
    solves = [r for r in run.solves if r["kernel"] == "K4r" and r.get("traced")]
    if not solves or run.trace_data is None:
        return None
    kernel_ms = 1e3 * run.trace_data.kernel_s(KERNEL)
    if kernel_ms <= 0:
        return None
    bound_ms, by, its = 0.0, set(), 0.0
    for r in solves:
        b, what = rl.k4_bound(r["B"], rl.fin_nodes(r["resolution"]), r["iters"])
        bound_ms += b
        by.add(what)
        its += float((r["iters"] + 1).sum())
    say(f"[roofline] K4r: {len(solves)} launches, {kernel_ms:.3f} ms on the card, bound {bound_ms:.4f} ms "
        f"(by {'/'.join(sorted(by))}), {1e3 * kernel_ms / its:.3f} us a sample-iteration")
    return 100.0 * bound_ms / kernel_ms
