"""device_idle_pct.*: the share of the traced stretch of the window in
which no kernel, copy or fill runs on rank 0's card (profiler trace)."""

from rtbench import measure


def read(run):
    return measure.idle_pct(run)
