"""Run one cell of the benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. It names the card, builds the cell's inputs
and the system under test from the seed, warms up the cell's own shapes
(set-up), measures for ``--seconds`` (the window), checks what the window
produced against the plain reference, and prints one JSON object as the last
line of standard output: the end-to-end metrics with ``--trace 0``, the
per-layer metrics from a profiler trace of the window with ``--trace 1``.
Without a card, or with fewer cards than the cell asks for, it exits 2 and
prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness  # noqa: E402


def card_line(torch) -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    limit = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else (
        f"nvidia-smi failed ({smi.returncode})")
    return (f"[card] {torch.cuda.get_device_name(0)} | devices {torch.cuda.device_count()} | "
            f"{limit} | torch {torch.__version__} cuda {torch.version.cuda}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    harness.cache_dirs()
    cell = harness.find_cell(harness.load_spec(), args.workload)

    import torch

    if not torch.cuda.is_available():
        harness.say("FAIL: torch.cuda.is_available() is False; the benchmark runs only on a card")
        return 2
    if torch.cuda.device_count() < cell.chips:
        harness.say(f"FAIL: {cell.name} asks for {cell.chips} cards, {torch.cuda.device_count()} seen")
        return 2
    harness.say(card_line(torch))
    run = harness.Run(cell=cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                      device=torch.device("cuda", 0), t_start=T_START)
    driver = harness.load_module(harness.BENCH / "drivers" / f"{cell.mix['driver']}.py")
    out = harness.execute(run, driver)
    for name, chk in out["checks"].items():
        harness.say(f"[check] {name} {chk['value']!r} limit {chk['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
