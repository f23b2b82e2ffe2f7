"""refit_nodes_ms.*: rank 0's host milliseconds a train step in the
program's ``raytpu.refit_nodes`` span (the interior pass of ``bvh.refit``:
each node's box the union of the leaf boxes under it), net of the CUDA
runtime's synchronising calls inside it, which wait on the card (profiler
trace).  None where the trace holds no such span: a program without it, or
a step that does not refit."""

from rtbench.metrics.wrapper_ms import net_host_s, spans

REFIT_NODES = ("raytpu.refit_nodes",)


def read(run):
    if not run.traces or not spans(run.traces[0], REFIT_NODES):
        return None
    t = run.traces[0]
    return 1e3 * net_host_s(t, REFIT_NODES) / t.calls
