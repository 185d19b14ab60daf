"""k3r_roofline: K3r's share of its roofline (%): the least time the card
could take for the traced steps' K3r solves (the frozen counts on the fin's
own nodes, at the iteration counts each solve reports and the H100's
published peaks) over K3r's device time in the trace, found by kernel name."""

from portbench.harness import say
from portbench.yardstick import roofline as rl

KERNEL = "pcg_stencil_tile_mma_kernel"


def read(run):
    solves = [r for r in run.solves if r["kernel"] == "K3r" and r.get("traced")]
    if not solves or run.trace_data is None:
        return None
    kernel_ms = 1e3 * run.trace_data.kernel_s(KERNEL)
    if kernel_ms <= 0:
        return None
    bound_ms, by, floor_ms = 0.0, set(), 0.0
    for r in solves:
        n = rl.fin_nodes(r["resolution"])
        b, what = rl.k3r_bound(r["B"], n, r["m"], r["iters"])
        bound_ms += b
        by.add(what)
        floor_ms += rl.stream_floor(rl.K3R_BYTES, n, r["iters"])
    say(f"[roofline] K3r: {len(solves)} launches, {kernel_ms:.3f} ms on the card, bound {bound_ms:.4f} ms "
        f"(by {'/'.join(sorted(by))}), streaming floor on the fin's nodes {floor_ms:.3f} ms "
        f"({100 * floor_ms / kernel_ms:.2f}% of the kernel time)")
    return 100.0 * bound_ms / kernel_ms
