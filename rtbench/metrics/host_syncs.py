"""host_syncs.*: the CUDA runtime's synchronising calls a call on rank 0
that start inside one of the program's ``raytpu.`` spans: each one holds
the host until the card has run what was queued (profiler trace).  None
where the trace holds no program span."""

from rtbench.metrics.wrapper_ms import SYNCS, spans


def read(run):
    if not run.traces:
        return None
    t = run.traces[0]
    program = spans(t)
    if not program:
        return None
    inside = sum(any(a <= s <= b for a, b in program)
                 for n, s, _ in t.host if n in SYNCS)
    return inside / t.calls
