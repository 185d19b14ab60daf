"""The control of a cell's correctness check: the plain reference put in the
package's place, computed one precision below what the configuration states
(each driver's ``control``), run through the cell's own set-up, window and
check on several seeds in one process. Every check it prints must come out
above its limit for at least one number; a sound run's must not.

    python3 portbench/control.py --workload <name> --seeds 3 --seconds 8

The benchmark's own runs never run it. It prints one JSON line a seed, and a
last line with each number's smallest reading over the seeds.
"""

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench import harness, trace  # noqa: E402


def run_control(cell, seed: int, seconds: float, device):
    run = harness.Run(cell=cell, seed=seed, seconds=seconds, trace=False, device=device)
    run.tracer = trace.Tracer(False)
    driver = harness.load_module(harness.BENCH / "drivers" / f"{cell.mix['driver']}.py")
    st = driver.setup(run)
    driver.control(run, st)
    driver.window(run, st)
    driver.check(run, st)
    return run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=9001)
    p.add_argument("--seconds", type=float, default=8.0)
    args = p.parse_args(argv)
    harness.cache_dirs()
    import torch

    cell = harness.find_cell(harness.load_spec(), args.workload)
    low = {}
    for seed in range(args.first_seed, args.first_seed + args.seeds):
        run = run_control(cell, seed, args.seconds, torch.device("cuda", 0))
        line = {"seed": seed, "correct": harness.correct(run.checks), "steps": run.steps,
                "checks": {n: {"value": v, "limit": lim} for n, v, lim in run.checks}}
        print(json.dumps(line), flush=True)
        for n, v, _ in run.checks:
            low[n] = min(low.get(n, float("inf")), v)
        torch.cuda.empty_cache()
    print(json.dumps({"control_smallest": low}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
