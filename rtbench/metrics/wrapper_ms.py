"""wrapper_ms.*: the kernel wrappers' host milliseconds a launch on rank
0: the time in the program's ``raytpu.pack``, ``raytpu.launch`` and
``raytpu.scatter`` spans (their union), net of the CUDA runtime's
synchronising calls inside them, which wait on the card, over the number
of ``raytpu.launch`` spans, one a kernel launch (profiler trace).  None
where the trace holds no launch span.  The other readers of the
program's spans take ``spans``, ``net_host_s`` and ``SYNCS`` from here."""

from rtbench import measure

SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
         "cudaEventSynchronize")
WRAPPER = ("raytpu.pack", "raytpu.launch", "raytpu.scatter")


def spans(trace, names=None) -> list[tuple[float, float]]:
    """(start, end) of the trace's program spans named in ``names``, or
    of every ``raytpu.`` span."""
    return [(s, e) for n, s, e in trace.host
            if (n in names if names else n.startswith("raytpu."))]


def net_host_s(trace, names) -> float:
    """Host seconds of the trace's window in the spans named in
    ``names`` (their union), less the synchronising calls' time."""
    syncs = [(s, e) for n, s, e in trace.host if n in SYNCS]
    return (measure.union_s(spans(trace, names) + syncs, trace.lo, trace.hi)
            - measure.union_s(syncs, trace.lo, trace.hi))


def read(run):
    if not run.traces:
        return None
    t = run.traces[0]
    launches = len(spans(t, ("raytpu.launch",)))
    if not launches:
        return None
    return 1e3 * net_host_s(t, WRAPPER) / launches
