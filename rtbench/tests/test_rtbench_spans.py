"""The readers of the program's spans on synthetic traces: the idle
stretches inside and outside a span, a sync inside a wrapper span, four
ranks whose all-reduces start apart, and a trace without spans."""

import pytest

from rtbench import core
from rtbench.measure import Trace


def _run(*traces):
    return core.Run(setup_s=1.0, window_s=1.0, calls=[],
                    traces=list(traces))


def _read(name, run):
    return core.reader(name).read(run)


# two calls over 0-10 s: the card busy 0-2, 4-6 and 9-10; the host in the
# program's spans 1-5 (a refit 1-2, a wrapper's pack 2-3 and launch 3-3.5,
# a sync 3.1-3.3 in the launch) and 7-9.5 (a scatter 7-8)
CALL = Trace(
    device=[("render_fwd_kernel", 0.0, 2.0), ("render_vjp", 4.0, 6.0),
            ("elementwise", 9.0, 10.0)],
    host=[("raytpu.train_step", 1.0, 5.0), ("raytpu.refit", 1.0, 2.0),
          ("raytpu.pack", 2.0, 3.0), ("raytpu.launch", 3.0, 3.5),
          ("cudaStreamSynchronize", 3.1, 3.3),
          ("raytpu.train_step", 7.0, 9.5), ("raytpu.scatter", 7.0, 8.0),
          ("cudaStreamSynchronize", 8.5, 8.6),
          ("cudaDeviceSynchronize", 6.2, 6.4), ("aten::copy_", 6.0, 7.0)],
    lo=0.0, hi=10.0, calls=2)


def test_idle_inside_and_outside_the_program():
    # idle 2-4 (middle 3, in a span) and 6-9 (middle 7.5, in a span);
    # were the second stretch's middle outside, it would not count
    assert _read("program_idle_ms.fit", _run(CALL)) == pytest.approx(
        1e3 * (2.0 + 3.0) / 2)
    late = Trace(CALL.device, [h for h in CALL.host if h[1] < 6.0], 0.0,
                 10.0, 2)
    assert _read("program_idle_ms.fit", _run(late)) == pytest.approx(
        1e3 * 2.0 / 2)


def test_sync_in_a_wrapper_span():
    # pack 1 s + launch 0.5 s + scatter 1 s, less the 0.2 s sync in the
    # launch, over one launch span
    assert _read("wrapper_ms.fit", _run(CALL)) == pytest.approx(
        1e3 * (2.5 - 0.2))
    # two syncs start inside a span, the one at 6.2 s outside: 2 over 2
    # calls
    assert _read("host_syncs.fit", _run(CALL)) == pytest.approx(1.0)
    assert _read("refit_ms.fit", _run(CALL)) == pytest.approx(1e3 / 2)


def test_four_ranks_wait_for_the_last():
    # each rank's clock starts at its own offset; in every step the
    # all-reduce ends together (2 s, 12 s, 22 s on rank 0's clock); in the
    # last two rank k starts it k s after rank 0 (3 s is the last), in the
    # first rank 0 starts 10 s early, as it does while the other ranks'
    # profilers start
    offsets = (0.0, 5.0, -2.0, 0.5)
    traces = []
    for k, off in enumerate(offsets):
        dev, host = [], []
        for end in (2.0, 12.0, 22.0):
            start = end - 6.0 + k - (10.0 if end == 2.0 and k == 0 else 0.0)
            host.append(("raytpu.reduce", start - 0.5 + off,
                         start - 0.4 + off))
            dev.append(("ncclDevKernel_AllReduce_Sum_f64_RING_LL",
                        start + off, end + off))
        # the episode's broadcast is no all-reduce
        dev.append(("ncclDevKernel_Broadcast_RING_LL", 23.0 + off,
                    23.1 + off))
        traces.append(Trace(dev, host, off - 20.0, 24.0 + off, 3))
    # the waits a step: 3, 2, 1, 0 s; the first step's 13, 2, 1, 0 s
    # (a mean of 4 s, against 1.5 s) is left out
    assert _read("rank_wait_ms.fit4", _run(*traces)) == pytest.approx(
        1e3 * 6.0 / 4)
    # a rank whose spans outnumber its kernels gives nothing
    short = Trace(traces[2].device[:1], traces[2].host, traces[2].lo,
                  traces[2].hi, 2)
    assert _read("rank_wait_ms.fit4",
                 _run(traces[0], traces[1], short, traces[3])) is None
    assert _read("rank_wait_ms.fit4", _run(traces[0])) is None


@pytest.mark.parametrize("name", ["refit_ms.fit", "wrapper_ms.frames",
                                  "host_syncs.frames", "program_idle_ms.fit4",
                                  "rank_wait_ms.fit4"])
def test_nothing_without_spans(name):
    bare = Trace(CALL.device, [h for h in CALL.host
                               if not h[0].startswith("raytpu.")],
                 0.0, 10.0, 2)
    assert _read(name, _run(bare, bare)) is None
    assert _read(name, _run()) is None
