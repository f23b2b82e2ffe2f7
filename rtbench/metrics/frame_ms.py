"""frame_ms: the window's milliseconds over the frames it completed, each
frame ending with its image in host memory (host clock)."""

from rtbench import measure


def read(run):
    return measure.per_call_ms(run.window_s, len(run.calls))
