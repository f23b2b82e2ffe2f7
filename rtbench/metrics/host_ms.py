"""host_ms.*: rank 0's host milliseconds of the entry call (``render`` of
a frame, before the image's copy or any sync; a train step), from
dispatch until it returns; the mean over the window's untraced calls
(host clock)."""

from rtbench import measure


def read(run):
    return measure.host_ms(run)
