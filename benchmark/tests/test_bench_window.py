"""The window's arithmetic on synthetic series of callback times."""

import pytest

from benchmark.harness.window import Window


def _drive(times, seconds, start_at=2, min_callbacks=4):
    w = Window(seconds, start_at=start_at, min_callbacks=min_callbacks)
    for k, t in enumerate(times, start=1):
        stop = w.callback(t)
        if k == start_at:
            w.open(t)
        if stop:
            return w
    return w


def test_steady_steps():
    w = _drive([0, 10, 20, 30, 40, 50], seconds=25)
    assert w.end == 40 and w.steps == 3 and w.span == 30
    assert w.rate(1000) == pytest.approx(100.0)


def test_a_stall_inside_the_window_lowers_the_rate():
    steady = _drive([0, 10, 20, 30, 40], seconds=25)
    stalled = _drive([0, 10, 20, 45, 55], seconds=25)
    assert steady.steps == 3 and stalled.steps == 2
    assert stalled.rate(1000) < steady.rate(1000)
    assert stalled.rate(1000) == pytest.approx(2000 / 35)


def test_the_window_waits_for_the_checked_steps():
    w = _drive([0, 10, 100, 110, 120], seconds=5, min_callbacks=4)
    assert w.end == 110 and w.steps == 2


def test_no_whole_step_raises():
    w = Window(5)
    w.callback(0.0)
    w.callback(1.0)
    w.open(1.0)
    with pytest.raises(RuntimeError):
        w.rate(10)


def test_bad_window_raises():
    with pytest.raises(ValueError):
        Window(5, start_at=3, min_callbacks=2)
