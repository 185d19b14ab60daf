"""A later change adds a configuration, a traffic mix and a per-layer metric
as new files and BENCHMARK.json entries, and the harness picks them up with
no other edit: shown on a copy of the benchmark in a temporary folder."""

import json
import shutil

import torch

from portbench import harness


def test_new_files_are_picked_up_by_name(tmp_path):
    shutil.copytree(harness.BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    bench = tmp_path / "portbench"
    before = {p.relative_to(bench): p.read_bytes() for p in bench.rglob("*") if p.is_file()}

    cfg = json.loads((bench / "configs" / "fin5_res32.json").read_text())
    cfg.update(name="fin5_res2", resolution=2, cg_maxiter=480, changed_from_source={"resolution": "32 -> 2"},
               reduced=["resolution"])
    (bench / "configs" / "fin5_res2.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "workloads" / "fin5_res32.fom_sweep.json").read_text())
    mix.update(config="fin5_res2")
    mix["params"].update(batch=8)
    (bench / "workloads" / "fin5_res2.fom_sweep.json").write_text(json.dumps(mix))
    (bench / "metrics" / "fom.iters_max.py").write_text(
        "def read(run):\n"
        "    its = [int(r['iters'].max()) for r in run.solves]\n"
        "    return max(its) if its else None\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "fin5_res2", "source": "https://example.org/fin", "reduced": ["resolution"],
                            "file": "portbench/configs/fin5_res2.json", "why": "a tiny fin"})
    spec["workloads"].append({"name": "fin5_res2.fom_sweep", "config": "fin5_res2", "traffic": "fom_sweep",
                              "chips": 1, "why": "a tiny sweep"})
    e2e = next(m for m in spec["end_to_end"] if m["name"] == "fom_solves_per_s")
    e2e["workloads"].append("fin5_res2.fom_sweep")
    spec["per_layer"].append({"name": "fom.iters_max", "unit": "iters", "better": "lower",
                              "source": "program_counter", "layer": "batched FOM solve",
                              "moves": "fom_solves_per_s", "workloads": ["fin5_res2.fom_sweep"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    after = {p.relative_to(bench): p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    assert all(after[p] == before[p] for p in before)  # nothing that was there changed

    cell = harness.find_cell(harness.load_spec(tmp_path), "fin5_res2.fom_sweep", bench)
    assert cell.per_layer == ["fom.iters_max"] and cell.end_to_end == ["fom_solves_per_s", "setup_s"]
    driver = harness.load_module(bench / "drivers" / "fom_sweep.py")
    for trace in (False, True):
        run = harness.Run(cell=cell, seed=3, seconds=0.3, trace=trace, device=torch.device("cpu"))
        out = harness.execute(run, driver)
        assert out["correct"], out["checks"]
        if trace:
            assert out["metrics"]["fom.iters_max"]["value"] > 0
        else:
            assert out["metrics"]["fom_solves_per_s"]["value"] > 0
