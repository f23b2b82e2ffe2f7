"""The yardstick's arithmetic on known inputs: the percentile, the window's
rate, the busy and idle share of synthetic intervals, the reduction of a
trace and the roofline of known counts."""

import dataclasses
import math

import pytest

from rtbench import core, measure


def test_p95_nearest_rank():
    assert measure.p95(range(1, 101)) == 95
    assert measure.p95([5.0]) == 5.0
    assert measure.p95(list(range(20, 0, -1))) == 19
    with pytest.raises(ValueError):
        measure.p95([])


def test_window_rate():
    assert measure.per_call_ms(20.0, 200) == pytest.approx(100.0)
    with pytest.raises(ValueError):
        measure.per_call_ms(1.0, 0)


def test_busy_and_idle_from_intervals():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (10.0, 11.0)]
    assert measure.union_s(iv, 0.0, 5.0) == pytest.approx(3.0)
    assert measure.union_s(iv, 1.5, 3.5) == pytest.approx(1.0)
    assert measure.gaps(iv, 0.0, 5.0) == [(2.0, 3.0), (4.0, 5.0)]
    t = measure.Trace(device=[("k", 0.0, 1.0), ("k", 0.5, 2.0),
                              ("nccl_x", 3.0, 4.0)],
                      host=[("aten::copy_", 2.0, 3.0), ("outer", 1.0, 5.0)],
                      lo=0.0, hi=5.0, calls=2)
    assert t.busy_s == pytest.approx(3.0)
    assert t.window_s == 5.0
    assert t.device_s(lambda n: "nccl" in n) == pytest.approx(1.0)
    assert t.top_ops() == [["k", 2.5], ["nccl_x", 1.0]]
    # the idle 2-3 s falls in copy_ (the innermost), 4-5 s in outer
    assert t.idle_gaps() == [["aten::copy_", 1.0], ["outer", 1.0]]


def test_roofline_of_known_counts():
    work = measure.work(1000, 2000, 100, {"spheres": "all", "boxes": 8},
                        12000, backward=True)
    ops = 2000 * (100 * 18 + 8 * 24 + 50) + 1000 * 30
    assert measure.forward_ops(1000, 2000, 100, 8) == ops
    assert measure.forward_bound_s(work) == pytest.approx(ops / 67e12)
    assert measure.backward_bound_s(work) == pytest.approx(
        2000 * 223 / 67e12)
    assert measure.call_bound_s(work) == pytest.approx(
        (ops + 2000 * 223) / 67e12)
    # a frame runs no backward: its bound is the forward's
    frame = dict(work, backward_steps=0)
    assert measure.call_bound_s(frame) == measure.forward_bound_s(frame)
    # a byte-bound call
    assert measure.bound_s(1.0, 3.35e12) == pytest.approx(1.0)
    trace = measure.Trace([("render_fwd_kernel<1>", 0.0, 0.004)], [],
                          0.0, 0.01, calls=2)
    run = core.Run(setup_s=1.0, window_s=1.0, calls=[],
                   traces=[trace], work=work)
    share = measure.kernel_roofline(run, "render_fwd_kernel",
                                    measure.forward_bound_s)
    assert share == pytest.approx(100 * measure.forward_bound_s(work)
                                  / 0.002)
    assert measure.kernel_roofline(run, "render_vjp",
                                   measure.backward_bound_s) is None


def test_readers_on_a_synthetic_run():
    calls = [(k * 0.1, k * 0.1 + 0.01, k * 0.1 + 0.09) for k in range(40)]
    run = core.Run(setup_s=3.5, window_s=4.0,
                   calls=calls, traced=10)
    assert core.reader("frame_ms").read(run) == pytest.approx(100.0)
    assert core.reader("frame_p95_ms").read(run) == pytest.approx(90.0)
    assert core.reader("host_ms.frames").read(run) == pytest.approx(10.0)
    assert core.reader("setup_s").read(run) == 3.5
    # a metric is read by the reader of its quantity, its name up to the
    # first dot, whatever cell reports it
    assert core.reader("step_ms.fit4").read(run) == pytest.approx(100.0)
    assert core.reader("host_ms.fit4").__file__.endswith("host_ms.py")
    # nothing to read without a trace
    assert core.reader("device_idle_pct.frames").read(run) is None
    assert core.reader("fwd_roofline.frames").read(run) is None
    assert core.reader("allreduce_ms.fit4").read(run) is None
    work = measure.work(1, 0, 0, {"spheres": 0, "boxes": 0},
                        3.35e12 * 0.05)
    assert math.isclose(core.reader("mfu.frames").read(dataclasses.replace(
        run, work=work)), 50.0)

