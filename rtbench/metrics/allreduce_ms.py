"""allreduce_ms.*: device milliseconds of the NCCL kernels a train step,
the mean over the ranks; it holds the wait for the slowest rank (profiler
trace; the collective's own span on the card is left out).  None where no
NCCL kernel ran."""


def read(run):
    per = [t.device_s(lambda n: "nccl" in n.lower()) / t.calls
           for t in run.traces]
    return 1e3 * sum(per) / len(per) if any(per) else None
