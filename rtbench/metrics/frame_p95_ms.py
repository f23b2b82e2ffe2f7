"""frame_p95_ms: the 95th percentile of every frame's time in the window,
from its dispatch to its image in host memory (host clock)."""

from rtbench import measure


def read(run):
    return measure.p95([(done - t0) * 1e3 for t0, _, done in run.calls])
