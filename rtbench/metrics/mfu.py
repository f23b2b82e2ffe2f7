"""mfu.*: the whole call's share of the f32 peak of the cards it runs on:
the bound of a call's counted work (its forward, and a train step's taped
backward) over the window's time a call times the cards (host clock)."""

from rtbench import measure


def read(run):
    return measure.mfu(run)
