"""rank_wait_ms.*: milliseconds a train step that a rank's all-reduce
kernel waits for the last rank to reach it: the median over the traced
steps of the mean over the ranks (profiler traces of every rank).  The
median leaves out the first traced step, which also waits for the
ranks' profilers to start (they start up to a second apart).

Each rank's ``raytpu.reduce`` spans, in order, take the first NCCL
all-reduce kernel that starts after each of them.  The ranks' profiler
clocks start apart, so each rank's clock is set against rank 0's by the
median difference of the all-reduces' ends, which every rank reaches
within a hop of the others.  A rank's wait in a step is the latest rank's
kernel start less its own; ``allreduce_ms`` less this is the collective's
own time.  None on one rank, without the spans or the kernels, or where
a rank's count of spans or matched kernels differs from another's."""

import statistics


def _matched(trace) -> list | None:
    """(start, end) of the all-reduce kernel of each ``raytpu.reduce``
    span of one rank, in order; None where a span has none."""
    spans = sorted(s for n, s, _ in trace.host if n == "raytpu.reduce")
    kernels = sorted((s, e) for n, s, e in trace.device
                     if "allreduce" in n.lower().replace("_", ""))
    out, k = [], 0
    for s in spans:
        while k < len(kernels) and kernels[k][0] < s:
            k += 1
        if k == len(kernels):
            return None
        out.append(kernels[k])
        k += 1
    return out


def read(run):
    if len(run.traces) < 2:
        return None
    ranks = [_matched(t) for t in run.traces]
    if (any(r is None for r in ranks) or not ranks[0]
            or len({len(r) for r in ranks}) != 1):
        return None
    offsets = [statistics.median(e - e0 for (_, e), (_, e0)
                                 in zip(r, ranks[0])) for r in ranks]
    waits = []
    for k in range(len(ranks[0])):
        starts = [r[k][0] - off for r, off in zip(ranks, offsets)]
        waits.append(max(starts) - sum(starts) / len(starts))
    return 1e3 * statistics.median(waits)
