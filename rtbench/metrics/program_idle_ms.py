"""program_idle_ms.*: rank 0's milliseconds a call in which the card ran
nothing while the host was inside one of the program's ``raytpu.`` spans
(each idle stretch of the traced window counted whole where its middle
lies in such a span): the part of ``device_idle_pct`` that the program's
own host turn causes; the rest falls in the benchmark's loop and copy
(profiler trace).  None without a traced card or without program
spans."""

from rtbench import measure
from rtbench.metrics.wrapper_ms import spans


def read(run):
    if not run.traces or not run.traces[0].device:
        return None
    t = run.traces[0]
    program = spans(t)
    if not program:
        return None
    idle = measure.gaps([(s, e) for _, s, e in t.device], t.lo, t.hi)
    inside = sum(e - s for s, e in idle
                 if any(a <= (s + e) / 2 <= b for a, b in program))
    return 1e3 * inside / t.calls
