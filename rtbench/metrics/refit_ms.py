"""refit_ms.*: rank 0's host milliseconds a train step in the program's
``raytpu.refit`` span (``bvh.refit`` of the step's scene), net of the CUDA
runtime's synchronising calls inside it, which wait on the card (profiler
trace).  None where the trace holds no such span: a program without
spans, or a step that does not refit."""

from rtbench.metrics.wrapper_ms import net_host_s, spans

REFIT = ("raytpu.refit",)


def read(run):
    if not run.traces or not spans(run.traces[0], REFIT):
        return None
    t = run.traces[0]
    return 1e3 * net_host_s(t, REFIT) / t.calls
