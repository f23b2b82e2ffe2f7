"""The benchmark's yardstick: percentiles and rates, the counted work of a
frame and its bound on the card, and the reduction of a profiler trace.

Nothing here reads the program: the work is counted from the frame's size,
the bounce steps the reference took and the closest-hit charge that the
configuration declares; the trace is reduced from the profiler's events.
"""

from __future__ import annotations

import math

# The f32 operations of the work, frozen from chip_smoke.py's hand count of
# csrc/render_common.cuh and gradkernel.cu.  A sphere test counts what a
# miss needs, so each bound is a floor.
OPS_SPHERE_TEST = 18   # 3 sub, half_b 5, c 6, disc 3, its sign 1
OPS_SPHERE_ROOT = 23   # a hit: + sqrt, 2 roots
OPS_BOX_TEST = 24      # 6 sub, 6 mul, 6 min/max, 3 max, 3 min
OPS_STEP = 50          # hit point, normal, the material's new direction
OPS_SAMPLE = 30        # raygen, the sample's sum
OPS_STEP_REVERSE = 200  # the reverse of one scattering step

# NVIDIA H100 SXM, published at 700 W: 67 TFLOP/s f32 outside the tensor
# cores (an FMA counted as two operations), 3.35 TB/s of HBM3.  The counts
# above are operations in that sense, so the bound holds however the
# kernels are built: with FMA contraction or without (-fmad=false, which
# leaves the card half that rate).
PEAK_OPS = 67e12
PEAK_BYTES = 3.35e12


def p95(values) -> float:
    """The nearest-rank 95th percentile: the smallest value that at least
    95% of ``values`` do not exceed."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    return v[max(math.ceil(0.95 * len(v)) - 1, 0)]


def per_call_ms(window_s: float, calls: int) -> float:
    """The window's milliseconds over the calls it completed."""
    if calls < 1:
        raise ValueError("the window completed no call")
    return window_s * 1e3 / calls


def forward_ops(samples: float, steps: float, spheres_per_step: float,
                boxes_per_step: float) -> float:
    """f32 operations of a forward: the closest hit of every bounce step
    (its sphere and box tests), the scatter of every step, the raygen of
    every sample."""
    return (steps * (spheres_per_step * OPS_SPHERE_TEST
                     + boxes_per_step * OPS_BOX_TEST + OPS_STEP)
            + samples * OPS_SAMPLE)


def backward_ops(steps: float) -> float:
    """The floor of a taped backward: each step's reverse and the winner's
    root that a replay recomputes."""
    return steps * (OPS_STEP_REVERSE + OPS_SPHERE_ROOT)


def bound_s(ops: float, nbytes: float) -> float:
    """The least seconds the card could take: the larger of the operations
    over the f32 peak and the bytes over the HBM peak."""
    return max(ops / PEAK_OPS, nbytes / PEAK_BYTES)


def work(samples: float, steps: float, spheres: int, charge: dict,
         nbytes: float, backward: bool = False) -> dict:
    """A call's counted work for the rooflines: its samples and bounce
    steps, the closest-hit charge a step that the configuration declares
    (``"spheres": "all"`` charges every one of the scene's ``spheres``),
    the bytes it must move, and, for a call that also runs the taped
    backward, its bounce steps again as ``backward_steps``."""
    return {"samples": samples, "steps": steps,
            "spheres_per_step": (spheres if charge["spheres"] == "all"
                                 else charge["spheres"]),
            "boxes_per_step": charge["boxes"], "bytes": nbytes,
            "backward_steps": steps if backward else 0}


def profiler(device):
    """A started ``torch.profiler`` of the host and, on a card, the
    device."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    prof = profile(activities=acts)
    prof.start()
    return prof


def union_s(intervals, lo: float, hi: float) -> float:
    """Seconds of [lo, hi] that the (start, end) ``intervals`` cover."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(intervals, lo: float, hi: float) -> list[tuple[float, float]]:
    """The stretches of [lo, hi] that no interval covers."""
    out, t = [], lo
    for s, e in sorted(intervals):
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


class Trace:
    """A profiler trace of a stretch of the window, reduced to what the
    readers need.  ``device``: (name, start s, end s) of every kernel, copy
    and fill the card ran; ``host``: (name, start s, end s) of every host
    op; ``lo`` / ``hi``: the traced stretch; ``calls``: the timed calls in
    it."""

    def __init__(self, device, host, lo: float, hi: float, calls: int):
        self.device, self.host = device, host
        self.lo, self.hi, self.calls = lo, hi, calls

    @classmethod
    def from_profiler(cls, prof, call_name: str) -> "Trace":
        import torch
        dev, host = [], []
        for e in prof.events():
            rng = (e.name, e.time_range.start / 1e6, e.time_range.end / 1e6)
            if e.device_type == torch.autograd.DeviceType.CUDA:
                # a span's mirror on the card (ours, or a collective's
                # "nccl:all_reduce") is no work of the card's
                if not (getattr(e, "is_user_annotation", False)
                        or e.name == call_name):
                    dev.append(rng)
            else:
                host.append(rng)
        spans = [h for h in host if h[0] == call_name]
        if not spans:
            raise RuntimeError("the trace holds none of the timed calls")
        lo = min(s for _, s, _ in spans)
        hi = max([e for _, _, e in spans] + [e for _, _, e in dev])
        return cls(dev, [h for h in host if h[0] != call_name], lo, hi,
                   len(spans))

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    @property
    def busy_s(self) -> float:
        return union_s([(s, e) for _, s, e in self.device], self.lo, self.hi)

    def device_s(self, match) -> float:
        """Device seconds of the events whose name ``match`` accepts."""
        return sum(min(e, self.hi) - max(s, self.lo)
                   for n, s, e in self.device
                   if match(n) and min(e, self.hi) > max(s, self.lo))

    def top_ops(self, k: int = 10) -> list:
        """[name, seconds] of the device ops that took most time."""
        tot: dict[str, float] = {}
        for n, s, e in self.device:
            tot[n] = tot.get(n, 0.0) + (e - s)
        return [[n, v] for n, v in sorted(tot.items(), key=lambda x: -x[1])
                [:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """[what the host was doing, seconds] of the card's idle
        stretches, summed by the innermost host op at each gap's middle."""
        tot: dict[str, float] = {}
        for s, e in gaps([(a, b) for _, a, b in self.device], self.lo,
                         self.hi):
            mid = (s + e) / 2
            inner = [h for h in self.host if h[1] <= mid <= h[2]]
            name = (min(inner, key=lambda h: h[2] - h[1])[0] if inner
                    else "(no host op)")
            tot[name] = tot.get(name, 0.0) + (e - s)
        return [[n, v] for n, v in sorted(tot.items(), key=lambda x: -x[1])
                [:k]]


def forward_bound_s(work: dict) -> float:
    """The bound of one call's counted forward work (``Run.work``)."""
    return bound_s(forward_ops(work["samples"], work["steps"],
                               work["spheres_per_step"],
                               work["boxes_per_step"]), work["bytes"])


def backward_bound_s(work: dict) -> float:
    """The bound of one call's taped backward floor."""
    return bound_s(backward_ops(work["backward_steps"]), work["bytes"])


def call_bound_s(work: dict) -> float:
    """The bound of a whole call: its forward and any backward
    together."""
    return bound_s(forward_ops(work["samples"], work["steps"],
                               work["spheres_per_step"],
                               work["boxes_per_step"])
                   + backward_ops(work["backward_steps"]), work["bytes"])


def host_ms(run) -> float | None:
    """The mean host milliseconds from a call's dispatch to its return,
    over the window's calls outside the traced stretch."""
    spans = [(t1 - t0) * 1e3 for t0, t1, _ in run.calls[run.traced:]]
    return sum(spans) / len(spans) if spans else None


def kernel_roofline(run, name: str, bound) -> float | None:
    """The share, in %, of ``bound(run.work)``, the bound of a call's
    work, in the device time a call of the kernels whose name holds
    ``name``, summed over the ranks' traces; None where no trace holds
    such a kernel."""
    dev = sum(t.device_s(lambda n: name in n) / t.calls for t in run.traces)
    return 100.0 * bound(run.work) / dev if dev > 0 else None


def idle_pct(run) -> float | None:
    """The share, in %, of rank 0's traced stretch in which the card ran
    nothing; None without a traced card."""
    if not run.traces or not run.traces[0].device:
        return None
    t = run.traces[0]
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def mfu(run) -> float:
    """The whole call's share, in %, of the peak of the cards it runs on:
    the bound of its counted work over the window's time a call."""
    call_s = per_call_ms(run.window_s, len(run.calls)) / 1e3
    return 100.0 * call_bound_s(run.work) / (call_s * run.world)
