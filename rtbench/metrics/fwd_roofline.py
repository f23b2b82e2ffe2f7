"""fwd_roofline.*: the forward megakernel's share of its roofline: the
bound of a call's counted forward work over the device time a call of the
kernels named ``render_fwd_kernel``, summed over the ranks (profiler
trace).  The work is counted by the benchmark (rtbench/measure.py), not by
the program."""

from rtbench import measure


def read(run):
    return measure.kernel_roofline(run, "render_fwd_kernel",
                                   measure.forward_bound_s)
