"""step_ms, step_ms.fit4: the window's milliseconds over the
train steps it completed, on rank 0 (host clock; over several cards the
steps are collective, so every rank agrees)."""

from rtbench import measure


def read(run):
    return measure.per_call_ms(run.window_s, len(run.calls))
