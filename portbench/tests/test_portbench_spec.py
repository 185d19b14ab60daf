"""BENCHMARK.json against the benchmark's contract: keys, names, units,
bounds, run length, and each cell's files found by name."""

import json
import re

import pytest

from portbench import harness

SPEC = harness.load_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def test_top_level_keys_and_size():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                         "per_layer"}
    assert (harness.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(SPEC["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in SPEC["paths"])
    assert 1 <= len(SPEC["command"]) <= 32
    for word in SPEC["command"]:
        assert 1 <= len(word) <= 200 and "\n" not in word and "\t" not in word
        if "/" in word:
            assert not word.startswith("/") and ".." not in word
            assert any(word.startswith(p + "/") for p in SPEC["paths"])
            assert (harness.ROOT / word).exists()


def _one_line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


@pytest.mark.parametrize("entry", SPEC["configs"], ids=lambda e: e["name"])
def test_config_entries(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and _one_line(entry["source"]) and _one_line(entry["why"])
    assert entry["file"].startswith("portbench/") and (harness.ROOT / entry["file"]).is_file()
    assert len(entry["reduced"]) <= 16 and all(NAME.match(k) for k in entry["reduced"])
    cfg = json.loads((harness.ROOT / entry["file"]).read_text())
    assert cfg["name"] == entry["name"]
    assert sorted(cfg["reduced"]) == sorted(entry["reduced"])
    assert set(entry["reduced"]) <= set(cfg["changed_from_source"])
    assert (harness.ROOT / cfg["reference"]).is_file()
    assert any(w["config"] == entry["name"] for w in SPEC["workloads"])


@pytest.mark.parametrize("entry", SPEC["workloads"], ids=lambda e: e["name"])
def test_cells_find_their_files(entry):
    assert set(entry) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(entry["name"]) and NAME.match(entry["config"]) and NAME.match(entry["traffic"])
    assert entry["chips"] == 1 and _one_line(entry["why"])
    cell = harness.find_cell(SPEC, entry["name"])
    assert (harness.BENCH / "drivers" / f"{cell.mix['driver']}.py").is_file()
    assert "setup_s" in cell.end_to_end and len(cell.end_to_end) >= 2
    assert cell.per_layer
    for name in cell.per_layer:
        assert (harness.BENCH / "metrics" / f"{name}.py").is_file()
    assert set(cell.mix["limits"]) and all(v >= 0 for v in cell.mix["limits"].values())


def test_pairs_and_names_unique():
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    for group in ("configs", "workloads"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(metrics) == len(set(metrics))
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"], ids=lambda m: m["name"])
def test_metric_entries(metric):
    e2e = metric in SPEC["end_to_end"]
    allowed = {"name", "unit", "better", "bound", "source"} if e2e else {
        "name", "unit", "better", "source", "layer", "moves"}
    assert set(metric) - {"workloads"} == allowed
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    cells = {w["name"] for w in SPEC["workloads"]}
    if e2e:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _one_line(metric["layer"])
        moved = [m for m in SPEC["end_to_end"] if m["name"] == metric["moves"]]
        assert len(moved) == 1
        for cell in metric["workloads"]:
            assert cell in cells
            assert cell in moved[0].get("workloads", [cell])
        if metric["name"].endswith("_roofline") or "roofline" in metric["name"] or "mfu" in metric["name"]:
            assert metric["unit"] == "%"
    if "workloads" in metric:
        assert metric["workloads"] and set(metric["workloads"]) <= cells


def test_layers_named_as_in_perf():
    perf = (harness.ROOT / "PERF.md").read_text()
    for metric in SPEC["per_layer"]:
        assert f"| {metric['layer']} |" in perf


def test_run_seconds_fits_the_check():
    rs = SPEC["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    setup = next(m for m in SPEC["end_to_end"] if m["name"] == "setup_s")
    assert setup["bound"] <= 0.25
