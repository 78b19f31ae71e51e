"""The yardstick's arithmetic at hand-computed values: the fused solves'
operations and bytes at the rodent's and the fly's shapes, the least time,
the dense layers' operations, a training step's count, and the readers that
turn them into roofline and MFU shares."""

import pytest

from benchmark.harness import roofline
from benchmark.harness.manifest import Manifest
from benchmark.tests.test_bench_manifest import ROOT


def test_solve_flops_small_by_hand():
    # n 2, one limit row, one contact (4 rows): e 5; qm 36, jb 90, factor 5, applies 32,
    # J and J^T products 120, M products 16, linesearch 60
    assert roofline.solve_flops(2, 1, 1, 4, 1, 1) == 36 + 90 + 5 + 32 + 120 + 16 + 60


def test_solve_flops_rodent():
    # K2 at rodent-sps-per-actor: n 73, 67 limit rows, 30 contacts, CG 4/4; e 187
    qm, jb, factor, applies = 6 * 73 * 74, 30 * 73 * 44 + 67 * 73, 2 * 73**3 // 3, 7 * 2 * 73 * 73
    products = 2 * 187 * 73 * (6 + 6) + 2 * 73 * 73 * 5
    linesearch = 4 * (5 * 6 * 187)
    assert qm + jb + factor + applies + products + linesearch == 870967
    assert roofline.solve_flops(73, 67, 30, 4, 4, 4) == 870967


def test_solve_flops_fly():
    # K3 at fly-mc-intention: n 42, 36 limit rows, 27 cone blocks, CG 4/4; e 117
    qm, jb, factor, applies = 6 * 42 * 43, 27 * 42 * 36 + 36 * 42, 2 * 42**3 // 3, 7 * 2 * 42 * 42
    products = 2 * 117 * 42 * (10 + 6) + 2 * 42 * 42 * 9
    linesearch = 4 * (7 * (6 * 36 + 60 * 27))
    assert qm + jb + factor + applies + products + linesearch == 367668
    assert roofline.solve_flops(42, 36, 27, 3, 4, 4) == 367668


def test_solve_bytes_rodent():
    per_env = 3 * 73 * 6 + 30 * 18 + 67 + 60 + 2 * 187 + 3 * 73 + 1 + 4 * 73 + 187
    shared = 73 * 73 + 73 + 30 * 73 + 67 * 73
    assert roofline.solve_bytes(65536, 73, 67, 30, 4) == 4 * (65536 * per_env + shared)


def test_least_seconds_takes_the_larger_bound():
    t, by = roofline.least_seconds(3.35e12, 1)
    assert by == "bytes" and t == pytest.approx(1.0)
    t, by = roofline.least_seconds(1, 67e12 * 2)
    assert by == "operations" and t == pytest.approx(2.0)


def test_mlp_and_training_step_flops():
    assert roofline.mlp_flops([3, 4, 5]) == 2 * (12 + 20)
    got = roofline.training_step_flops(envs=2, unroll=3, passes=4, policy_fwd=10, value_fwd=7,
                                       solve_per_env_substep=100, substeps=5)
    rollout = 2 * 3 * (10 + 5 * 100)
    learn = 4 * (3 * 2 * 3 * (10 + 7) + 2 * 7)
    assert got == rollout + learn


def _run(profile, shapes):
    return {"profile": profile, "solve_shapes": shapes, "flops": {"policy_fwd": 1000, "value_fwd": 500},
            "window_steps": 2, "window_s": 4.0, "num_envs": 65536, "unroll_length": 20,
            "control_steps_per_step": 20, "passes": 4, "substeps": 5, "phase_ms": {}, "memory_peak_window": 2**31}


def test_roofline_reader_at_the_rodent():
    read = Manifest(ROOT).reader("cg_solve_roofline")
    shapes = {"cg_solve": (65536, 73, 67, 30, 4, 4)}
    prof = {"kernels": 10, "busy_s": 0.1, "window_s": 0.5,
            "by_kernel": {"(anonymous namespace)::cg_solve_kernel(float const*)": (5, 0.05),
                          "(anonymous namespace)::ell_cg_solve_kernel(float const*)": (3, 9.0)}}
    least, _ = roofline.least_seconds(roofline.solve_bytes(65536, 73, 67, 30, 4), 65536 * 870967)
    assert read(_run(prof, shapes)) == pytest.approx(100 * least / 0.01)
    assert read(_run(None, shapes)) is None
    assert read(_run(dict(prof, by_kernel={}), shapes)) is None


def test_mfu_reader():
    read = Manifest(ROOT).reader("train.mfu_pct")
    shapes = {"cg_solve": (65536, 73, 67, 30, 4, 4)}
    step = roofline.training_step_flops(envs=65536, unroll=20, passes=4, policy_fwd=1000, value_fwd=500,
                                        solve_per_env_substep=870967, substeps=5)
    assert read(_run(None, shapes)) == pytest.approx(100 * 2 * step / 4.0 / 67e12)


def test_device_readers():
    m = Manifest(ROOT)
    prof = {"kernels": 43244, "busy_s": 0.25, "window_s": 1.0, "by_kernel": {}}
    assert m.reader("device.idle_pct")(_run(prof, {})) == pytest.approx(75.0)
    assert m.reader("rollout.launches_per_control_step")(_run(prof, {})) == 43244
    assert m.reader("device.peak_mem_gib")(_run(prof, {})) == pytest.approx(2.0)
    assert m.reader("device.idle_pct")(_run(None, {})) is None
