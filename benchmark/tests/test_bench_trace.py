"""The trace reduction on a synthetic timeline (microseconds)."""

import pytest

from benchmark.harness import trace


def test_busy_gaps_and_host_attribution():
    kernels = [(10, 20, "k1"), (15, 25, "k2"), (40, 50, "k1"), (100, 110, "k3")]
    host = [(0, 30, "aten::mul"), (5, 8, "aten::empty"), (30, 45, "aten::index"), (60, 70, "aten::add")]
    s = trace.summarize(kernels, host, 0, 110)
    assert s["kernels"] == 4
    assert s["busy_s"] == pytest.approx(35e-6)  # 10-25, 40-50, 100-110
    assert s["window_s"] == pytest.approx(110e-6)
    assert s["by_kernel"]["k1"] == (2, pytest.approx(20e-6))
    gaps = dict(s["idle_gaps"])
    assert gaps["aten::index"] == pytest.approx(15e-6)  # 25-40, middle 32.5
    assert gaps["_no_host_operation_"] == pytest.approx(50e-6)  # 50-100, middle 75
    assert s["device_ops"][0][0] == "k1"


def test_empty_trace():
    s = trace.summarize([], [], float("inf"), float("-inf"))
    assert s["kernels"] == 0 and s["busy_s"] == 0 and s["window_s"] == 0
