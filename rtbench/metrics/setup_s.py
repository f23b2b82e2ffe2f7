"""setup_s: seconds from the process's start to the first timed call: the
imports, the CUDA libraries' load (their build in a fresh checkout), the
scene, BVH and target, every rank's start and NCCL's, and the warm-up
(host clock)."""


def read(run):
    return run.setup_s
