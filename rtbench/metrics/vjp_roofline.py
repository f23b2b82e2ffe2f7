"""vjp_roofline.*: the backward kernel's share of its roofline: the floor
of a call's taped backward (each bounce step's reverse and its winner's
root) over the device time a call of the kernels named ``render_vjp``,
summed over the ranks (profiler trace)."""

from rtbench import measure


def read(run):
    return measure.kernel_roofline(run, "render_vjp",
                                   measure.backward_bound_s)
