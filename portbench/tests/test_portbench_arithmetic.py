"""The window, rate, roofline and idle arithmetic on synthetic numbers and a
synthetic trace, against values worked out by hand."""

import numpy as np
import pytest

from portbench import harness, trace
from portbench.yardstick import roofline as rl


def _rows(dev, host=(), window=(0, 1000)):
    rows = [(trace.WINDOW, "DeviceType.CPU", "user_annotation", *window),
            (trace.WINDOW, "DeviceType.CUDA", "gpu_user_annotation", *window)]
    rows += [(n, "DeviceType.CUDA", "kernel", s, e) for n, s, e in dev]
    rows += [(n, "DeviceType.CPU", "cuda_runtime" if n.startswith("cuda") else
              "user_annotation" if n.startswith("portbench") else "cpu_op", s, e) for n, s, e in host]
    return rows


def test_busy_is_the_union_of_device_intervals():
    t = trace.trace_from_rows(_rows([("k1", 100, 300), ("k2", 200, 400), ("copy", 600, 700),
                                     ("k3", 650, 680), ("late", 950, 1200), ("early", -50, 20)]))
    assert np.array_equal(t.busy_intervals(), [[0, 20], [100, 400], [600, 700], [950, 1000]])
    assert t.busy_s == pytest.approx((20 + 300 + 100 + 50) / 1e9)
    assert t.window_s == pytest.approx(1e-6)
    assert t.idle_pct() == pytest.approx(100 * (1 - 470 / 1000))


def test_kernel_time_top_ops_and_gaps():
    t = trace.trace_from_rows(_rows(
        [("void pcg_stencil_tile_mma_kernel<8>(float*)", 100, 400), ("gemm", 500, 520),
         ("void pcg_stencil_tile_mma_kernel<8>(float*)", 600, 650)],
        host=[("aten::mm", 410, 500), ("portbench.da_step", 0, 1000), ("cudaLaunchKernel", 420, 430)]))
    assert "portbench.window" not in t.dev_name
    assert "portbench.window" not in list(t.host_name)
    assert t.kernel_s("pcg_stencil_tile_mma_kernel") == pytest.approx(350e-9)
    assert t.top_ops()[0] == ["void pcg_stencil_tile_mma_kernel<8>(float*)", pytest.approx(350e-9)]
    gaps = t.idle_gaps()
    assert gaps[0] == ["portbench.da_step", pytest.approx(350e-9)]  # 650..1000
    assert gaps[1] == ["portbench.da_step", pytest.approx(100e-9)]  # 0..100
    assert ["aten::mm", pytest.approx(100e-9)] in gaps  # 400..500: the mm was running


def test_a_trace_without_a_window_is_refused():
    with pytest.raises(RuntimeError):
        trace.trace_from_rows([("k", "DeviceType.CUDA", "kernel", 0, 1)])


def test_k3r_bound_matches_the_hand_count():
    # res8 (the fin's n = 10,017), m = 128, B = 1,024, every sample 63
    # iterations: 64 iterations a sample with the setup residual
    n, m, B = 10_017, 128, 1024
    its = np.full(B, 63)
    ms, by = rl.k3r_bound(B, n, m, its)
    f32 = 64 * B * (26 * n + 2 * m * m)
    bf16 = 64 * B * 4 * m * n
    assert by == "operations"
    assert ms == pytest.approx((f32 / 67e12 + bf16 / 989e12) * 1e3)
    assert rl.stream_floor(64, n, its) == pytest.approx(64 * n * 64 * B / 3.35e12 * 1e3)


def test_k4_bound_and_the_fins_nodes():
    # the reference's own node count, and the lattice the kernels sweep beside it
    assert rl.fin_nodes(8) == 10_017 and rl.fin_nodes(16) == 38_465 and rl.fin_nodes(32) == 150_657
    assert rl.fin_nodes(32) < 0.4 * 769 * 513
    its = np.full(256, 2827)
    n = rl.fin_nodes(32)
    ms, by = rl.k4_bound(256, n, its)
    assert by == "operations"
    assert ms == pytest.approx(2828 * 256 * 26 * n / 67e12 * 1e3)
    assert 40 < ms < 45  # 42.4 ms at res32, B = 256, 2,827 iterations a sample
    small, by = rl.bound(3.35e12, 1.0)
    assert by == "bytes" and small == pytest.approx(1e3)


def test_the_fins_nodes_are_the_references():
    from portbench.reference import fin5

    assert rl.fin_nodes(2) == fin5.Fin.build(2, 0.1).N
    assert rl.fin_nodes(5) == fin5.Fin.build(5, 0.1).N


def _run_with(solves, kernel_s=None, window=(0, 2_000_000_000), steps=4, first=3, fine_ms=None,
              step_ms=None):
    spec = harness.load_spec()
    cell = harness.find_cell(spec, "fin5_res8.da_fom")
    run = harness.Run(cell=cell, seed=0, seconds=1.0, trace=True)
    run.solves, run.window_s = solves, (window[1] - window[0]) / 1e9 + 5
    run.traced_steps, run.traced_first = steps, first
    if fine_ms is not None:
        run.spans["fine_ms"] = fine_ms
    if step_ms is not None:
        run.spans["step_ms"] = step_ms
        run.steps = len(step_ms)
    if kernel_s is not None:
        run.trace_data = trace.trace_from_rows(_rows(
            [("pcg_stencil_tile_mma_kernel", 0, int(kernel_s * 1e9))], window=window))
    return run


def test_metric_readers():
    its = np.full(1024, 99)
    solves = [{"kernel": "K3r", "B": 1024, "resolution": 8, "m": 128, "iters": its, "traced": True}] * 2
    solves += [{"kernel": "K3r", "B": 1024, "resolution": 8, "m": 128, "iters": its, "traced": False}]
    # 3 untraced steps, then 4 traced steps (2 s of traced window, 1 s of it
    # busy), then the one whose interval holds the profiler's stop
    fine = [80.0, 82.0, 84.0, 90.0, 91.0, 92.0, 93.0, 500.0]
    step = [500.0, 510.0, 520.0, 600.0, 610.0, 620.0, 630.0, 9000.0]
    run = _run_with(solves, kernel_s=1.0, fine_ms=fine, step_ms=step)
    read = lambda name: harness.load_module(harness.BENCH / "metrics" / f"{name}.py").read(run)
    bound = 2 * rl.k3r_bound(1024, 10_017, 128, its)[0]
    assert read("k3r_roofline") == pytest.approx(100 * bound / 1e3)
    assert read("da.fine_ms") == pytest.approx(82.0)
    assert read("da.coarse_ms") == pytest.approx(510.0 - 82.0)
    assert read("fom.iters_mean") == pytest.approx(99.0)
    # busy 1 s over 4 traced steps is 250 ms a step, of an untraced step of 510 ms
    assert read("idle_pct.da") == pytest.approx(100 * (1 - 250.0 / 510.0))
    assert read("k4r_roofline") is None  # no K4r solve: nothing to read
    run.trace_data = None
    assert read("k3r_roofline") is None and read("idle_pct.da") is None
    short = _run_with(solves, kernel_s=1.0, first=0, fine_ms=fine[3:], step_ms=step[3:])
    for name in ("da.fine_ms", "da.coarse_ms", "idle_pct.da"):  # no untraced step: nothing to read
        assert harness.load_module(harness.BENCH / "metrics" / f"{name}.py").read(short) is None
    assert _run_with(solves).spans == {}


def test_correct_needs_every_number_within_its_limit():
    assert harness.correct([("a", 0.1, 0.2), ("b", 0.0, 0.0)])
    assert not harness.correct([("a", 0.3, 0.2)])
    assert not harness.correct([("a", float("nan"), 0.2)])
    assert not harness.correct([])
