"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Needs a CUDA card and nvcc; builds the port's CUDA kernels from
``raytpu_torch/csrc/`` (the forward megakernels K1a / K1b / K1c / K1d / K1e /
K1' / K2 / K4-write, the fused VJP kernel K3 on both PASS 2 schedules (the
per-sample pass and the windowed refill) with its BVH (flat and walk),
tape-replay and slab variants and the wavefront's segment kernels K5 / K6,
one nvcc a source, in parallel) and the host BVH builder (g++), and drives
``raytpu_torch``'s paths: the forward render and the gradient path
(autograd through ``render``, ``render_grad``, ``optim.optimize``), brute,
dense and over a BVH, taped and not, the progressive render with its
checkpoints, the sharded render and train step over a
``torch.distributed`` group and the sorted wavefront.  It imports nothing of JAX or of
``raytpu``, and uses one card (the first that CUDA_VISIBLE_DEVICES names,
card 0 without it).  Phases, one JSON line each:

1.  setup: the card (nvidia-smi name and power limit) and the kernel builds;
2.  K1a against its plain PyTorch version on the card, case by case;
2b. K3 against its plain version (the adjoint's VJP) on the same CUDA
    tensors, case by case: K3's image bit-equal to K1a's, every leaf's
    cotangent within the budget below;
2c. ``python -m raytpu_torch.cli gradcheck --device cuda`` in a subprocess;
3.  the forward path: ``render`` at the full REFERENCE_V2 frame (1024x576,
    60 spp, depth 50, random_world: 327 spheres, so the dense stage K1e)
    with the launches by variant checked, then the same frame through the
    CLI in a subprocess;
3b. the gradient path at full CONFIG3 (400x200, 20 spp, depth 12) on the
    config-3 inverse-rendering problem: one ``render_grad`` with silhouette
    gradients, then 20 Adam steps of ``optim.optimize`` on the hero
    sphere's centre, each step one K1a and one K3 launch;
4.  K1a times from CUDA events, kernel and plain version;
4b. fwd+bwd and K3 times, beside the plain adjoint's; REFERENCE_V2's
    parallel ``render_grad`` (a full tape: K4/brute, then K3's refill
    replaying it) with its launches by variant and its kernels' times,
    both kernels held at that shape (spp cut to 2) against the plain taping
    forward and the plain VJP replaying the same tape, and at full spp
    K4's image to ``render()``'s and the taped refill to the untaped one
    (``brute_main_path_vs_plain``);
4d. brute_redesign: the brute sweep's main paths beside their bounds
    (config 2's ``render()``, K4/brute and the taped refill on REFERENCE_V2
    in parallel RNG, K3 brute on its sequential ``render_grad``), the
    counted warp efficiencies of K1a on config 2 and of K4/brute on
    REFERENCE_V2 beside the per-sample loop's (estimated from a K4 tape),
    ptxas's registers and spills of every brute instantiation (staged rows
    and scene pack), the bytes staged and K3's refill lanes at 327, 4096
    and 4097 spheres (fails below two refill blocks an SM at 4096);
4c. taped against untaped ``render_grad`` in alternating pairs at the
    config-2 frame over 4 to 500 spheres (where the tape starts to pay);
5.  config 4 (BASELINE: ``final_world()``, 500 spheres, 800x400, 100 spp,
    depth 12) over a BVH:
    5a. bvh_build: the native builder ran, its arrays equal the numpy
        builder's; leaves per copy, outliers, build ms;
    5b. K1c against its plain version at 2 spp, and against K1a at full
        size (pixels that differ: only exact ties of t may);
    5c. the census K1' at full size (leaves entered per step, steps per
        sample, sphere tests per frame) and against its plain version;
    5d. K3's BVH variant against K3 brute (both RNG modes, ``vis_w`` 0 and
        0.005) and against the plain adjoint;
    5e. K4: the taping forward's image against K1a's and K1c's, taped K3
        against untaped K3 on each PASS 2 schedule (brute and BVH, full and
        partial tapes), both schedules against the plain version, and
        ``tape_plan``'s decisions;
    5f. the main path at full size: ``render(..., bvh=)``, ``render_grad``
        with the BVH in both RNG modes and brute in parallel RNG (the
        parallel ones also on K3's per-sample pass), each with its launches
        by variant checked, and ``cli render --bvh``;
    5g. times at full size (forward, fwd+bwd, K3 with and without the
        tape, K3 over the BVH on the sequential per-sample pass alone) and
        the tape's coverage rule on REFERENCE_V2;
6.  config 5 (BASELINE: ``final_world()``, 1920x1080, 500 spp, depth 12,
    sequential RNG) progressive and sharded:
    6a. K2, the carry-state kernel, against its plain version at 480x270,
        4 spp (both RNG modes, brute and BVH): batches 1+2+1 bit-equal to
        the plain version's and to one batch, the image of the state equal
        to ``render()``'s;
    6b. slab mode at the config-5 frame, 2 spp, BVH: K1b, K2, K4 and K3 on
        three uneven slabs and one past the frame, stitched against the
        full frame, and each against its plain version on the last slab;
    6c. the main path: ``render_progressive`` at full CONFIG5 in batches of
        50 (ms per batch), interrupted after 5 batches and resumed from its
        checkpoint, against the one-shot ``render``; K2 on the full frame
        from the state after 5 batches (s0 = 250, 2 spp, both RNG modes)
        against its plain version; then ``cli render --progressive 100
        --checkpoint``;
    6d. the sharded path on one card, a world-size-1 NCCL group:
        ``render_sharded``, ``accumulate(group=)`` and three
        ``make_train_step`` steps at 1920x1080, 20 spp, parallel RNG, BVH
        with refit, taped, against ``render`` and ``render_grad``, and the
        same steps on K3's per-sample pass; then three steps of raytpu's
        falling-loss problem at the same frame; then K1b, K2, K4 and K3
        (both schedules) on that path's slab (rows 0-1079) against their
        plain versions at 2 spp, and the step's time on each schedule;
    6e. flat_forward_redesign: the flat sweep's warp counters (the census
        kernel's bounce-loop and sphere-test iterations a warp runs) and
        both efficiencies on config 5's batch frame (50 spp, sequential),
        on 6d's slab (20 spp, parallel) and on config 4 at 2 spp, whose
        census must equal the plain census exactly; K2/bvh's, K4/bvh+slab's
        and K1c's main-path times beside their bounds; ptxas's registers
        and spills of the flat instantiations; the shared memory they
        stage at config 4 and the blocks an SM holds.
7.  raytpu's 10,000-sphere scene (scripts/probe_10k_r5.py's recipe, built
    here with numpy, written with ``scene_io.save_scene`` and loaded from
    that file), 800x400, 20 spp, depth 12, over the skip-pointer walk K1d:
    7a. ``build_bvh`` at leaf 64: 157 leaves a copy, past the flat sweep's
        64, so raytpu's rule picks the walk;
    7b. K1d, K1b/walk (a slab of all 400 rows), K2/walk (1 + 1 batches),
        K1'/walk (the four census counts) and K4/walk bit-equal to their
        plain versions on the whole frame at 2 spp, both RNG modes,
        K3/walk and K3/walk+tape (both schedules) within the gradient
        budget; K1d against its plain
        version on config 4's unpadded BVH;
    7c. at full size, both RNG modes: K1d against K1c forced on the same
        BVH and against K1a (pixels that differ: exact ties only), K3/walk
        against K3 over the flat sweep (f64 sums), the progressive render
        in 4 batches of 5 against the one-shot render;
    7d. the main path: ``cli render --scene-file --bvh --log`` (PNG
        byte-equal to ``render()``'s, one log line naming the card),
        ``render``, ``render_sharded`` and ``render_grad`` (parallel RNG:
        taped, untaped and on K3's per-sample pass) with their launches by
        variant, the taped ``render_grad``'s K3 sums against K3/walk
        untaped on the same operands (f64);
    7e. ``cli validate --scene-file --bvh --device cuda`` and ``cli info``;
    7f. times: K1d, K1c forced (with its staging and the blocks an SM
        holds), K1a, fwd+bwd taped and untaped, the walk's
        census (nodes and leaves a step), and the walk forced on config 4's
        8-leaf BVH against K1c there (where raytpu's 64-leaf rule stands);
        end to end, ``render()`` and the progressive frame in 4 batches of
        5;
    7g. walk_redesign: the walk's counted warp efficiencies on the 10k
        frame (loop, sweep, node walk; K1'/walk) beside the per-sample
        loop's loop efficiency estimated from a K4 tape (the schedule the
        refill replaced); K1d's and the taped K3's own device time (a
        profiler trace) beside their launches', and the time of the sphere
        rows the wrappers build each launch; ptxas's registers and spills
        of every walk instantiation (the forward's, K3's, K5's and K6's).
8.  the dense stage K1e and the sorted wavefront (K5, K6):
    8a. K1e (K1a's kernel: the brute sweep over staged rows) against phase
        3's ``render()`` (bit-equal) and against its plain version at 2
        spp; its warp counters
        and efficiencies there (the census kernel K1'/dense, counting
        K1'/brute's steps and samples) and on 4x the pixels at a quarter
        of the spp (the launch's tail), beside the loop efficiency of the
        per-sample loop it replaced (from the frame's K4 tape); ptxas's
        registers and spills of the dense instantiations;
    8b. every K5 launch of a ``render(backend="wavefront")`` frame and
        every K6 launch of a ``refill=2`` frame against its plain version,
        bit for bit, brute (config 2's scene), dense (REFERENCE_V2's), flat
        BVH (config 4's) and walk (the 10k scene), each at its main path's
        full frame and RNG mode (8c) at 2 spp (the slots do not depend on
        spp); K5 in the other RNG mode at frames a few hundred pixels
        wide, and both over 4097 spheres (the brute sweep's pack
        instantiations); K5/dense's launches at REFERENCE_V2 also summed
        by segment (the cases: ``segment_cases()``);
    8c. the main path at full width: ``render(backend="wavefront")`` at
        REFERENCE_V2, config 2, config 4 (sequential; parallel with
        ``refill=2`` at 1 and 4 samples in flight), the 10k scene, and
        with ``refill=2`` (parallel) at config 2, REFERENCE_V2 and the
        10k scene (K6 under the other policies), against ``render()``
        (bit-equal at one slot a pixel), with their launches by variant;
        ``render_grad(backend="wavefront")`` and a
        wavefront image's K3 gradients against the megakernel path's, in
        sequential RNG and in parallel RNG (``refill=2``; K3 on its windowed
        refill); ``cli render --backend wavefront --refill 2`` (PNG
        byte-equal);
    8d. times (CUDA events, a warm-up call, then each call's time): K1e,
        the wavefront against the megakernel per frame, and
        where a traced wavefront frame's device time goes (segments, sorts,
        gathers, the rest) with the device's idle share of that call;
    8e. segment_redesign: ptxas's registers and spills of every K5 and K6
        instantiation (flat sweep, walk, staged rows, pack) and what the
        flat segments stage of config 4's BVH.
9.  K3's windowed refill (raytpu's parallel-RNG backward):
    9a. the refill against the per-sample pass on the same operands (image
        bit-equal, every leaf within raytpu's 3e-5) and against the plain
        version (within the gradient budget): config 2 and config 3's
        thin lens with ``vis_w`` at 2 spp; config 4 over the BVH with a
        window of depth steps (the budget set to 0: every lane parks after
        each sample), untaped and taped against untaped for every g_cap of
        5e (the BVH, walk, tape and slab variants against their plain
        versions: phases 5e, 6b / 6d and 7b);
    9b. the main paths in parallel RNG through the entry points, on the
        refill and on the per-sample pass (launches by variant, gradients
        within 3e-5, each call's time in turns): config 4 ``render_grad``
        taped and with ``vis_w`` (untaped), config 2 ``render_grad``, the
        wavefront at config 4 (``render_grad(backend="wavefront")`` and the
        autograd of a ``refill=2`` frame); config 5's train step is timed
        in 6d, the 10k scene's in 7f; K3's bound on the ``vis_w`` path
        with its near-miss sweep (every sphere at every step that misses,
        the misses counted from the frame's K4 tape), and the sweep's
        share of its time (the same launch with ``vis_w`` 0, in turns);
    9c. k3_flat_redesign: K3 over the flat BVH on its main paths beside
        their bounds, ptxas's registers and spills of every K3
        instantiation, what K3 stages of config 4's BVH in shared memory
        within this card's limits, and the refill's lanes with it.
10. v1_fractsin: the v1 fract-sin RNG mode (forward-only and golden-only,
    as in raytpu: the plain PyTorch renderer on CUDA tensors, no kernel)
    at its full frame, REFERENCE_V1_FAITHFUL (640x480, 1 spp, depth 25,
    gamma 2) on ``v1_world()`` with ``reference_camera_v1()`` through
    ``render(..., device="cuda")``: every pixel's post-jitter float2 state
    and its Schlick draw bit-equal on the card and on the CPU, the image
    within the cross-context budget of the CPU's (only the mappings'
    acos / pow / sin / cos, rsqrt and the gamma may round apart), no
    kernel launched, the frame's time and device time, a progressive
    render at 4 spp in 2 + 2 batches on the card bit-equal to the
    one-shot render, and ``megakernel.check_inputs`` still refusing the
    mode; then ``profiling.device_events`` of config 2's ``render()``.
    The frame's device time and the events are traced in processes of
    their own (``own_process``).

``compare_trees.py`` compares two checkouts on one card (their outputs,
K5's and K6's times) with this file's helpers and tables.

It exits non-zero at the first failure.  The line before the last is the
card's name and power limit, the line before it the kernel table as JSON
(the flat rows, the walk's forward rows, K1a, K1e and K4/brute with their
warp efficiencies; each bound the larger
of the bytes over 3.35 TB/s and the f32 operations over the card's f32
rate, ``ops_peak()``), the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import inspect
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

# one card: the first visible one, set before torch sees CUDA
os.environ["CUDA_VISIBLE_DEVICES"] = os.environ.get(
    "CUDA_VISIBLE_DEVICES", "0").split(",")[0]

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
T0 = time.perf_counter()
BUDGET_DELTA = 3e-4    # cross-context image budget (post-gamma)
BUDGET_SHARE = 1e-3    # share of pixels allowed above it (path flips)
DEPTH1_TOL = 1e-6      # depth-1 spp-1: jitter, primary hit and sky only
TIE_SHARE = 1e-4       # K1c vs K1a: pixels an exact tie of t may change
PLAIN_CHUNK = 1 << 16  # plain version's pixels per chunk on the card
# ... on config 5's full frame (8 chunks): on an H100 its time went with
# the number of (chunk, bounce step) pairs, about 16 ms each, not with
# their pixels
FRAME_CHUNK = 1 << 18
# K3 vs its plain version, per leaf: max|a - b| / max(max|b|, floor), floor
# 1e-8 for scene leaves and 1e-6 for camera leaves.  Both sides run the same
# f32 op order per bounce, but K3 sums the cotangents of up to 5.9e7
# (pixel, sample, bounce) terms in f64, while the plain version sums them in
# f32, through index_add_ (atomics on the card, in no fixed order) and
# autograd's reductions; an f32 sum of n terms is off by up to ~sqrt(n) ulp
# of its largest partial, and the camera origin's sum cancels ~800x.  So the
# disagreement grows with the frame: measured on an H100, <= 1e-4 in the
# five smaller cases and 8.9e-4 (mat_param) on random_world at 1024x576,
# 2 spp, depth 50.  The budget is the port's cross-package gradient budget
# (tests/test_torch_adjoint.py), 5x the largest measured; each case also
# prints the plain version's own spread between two runs.  (raytpu holds
# its TPU kernel to 1e-4 against autodiff at 32x16, 5e-4 for defocus with
# parallel RNG.)
GRAD_BUDGET = 5e-3
# K3's windowed refill against its per-sample pass on the same operands, per
# leaf (as GRAD_BUDGET): raytpu's bound for its refill (tests/test_gradkernel.py
# :155-225).  Both schedules sum the same f32 terms in f64, in another
# order, so they differ by little more than the f32 cast.
REFILL_TOL = 3e-5
VIS_W = 0.005          # the config-3 problem's silhouette weight
ADAM_STEPS = 20
ADAM_LR = 0.005        # at 0.01 the loss bottomed at step 14 and rose again
LEAF = 64              # build_bvh's default leaf size (raytpu's)
TAPE_PAIRS = 10        # taped / untaped pairs a scene in phase 4c
TIMED_FRAMES = 3       # wavefront and megakernel frames timed a run (8d)
# The least time the card could take (the roofline bound): the larger
# of the bytes a kernel must move over 3.35 TB/s (the H100 SXM's published
# rate at 700 W) and its f32 operations over the rate the card runs them
# (ops_peak(): 128 FP32 lanes an SM at the SM's top clock).  The kernels are
# built with -fmad=false, so each counted operation is one instruction; the
# published 67 TFLOP/s counts an FMA as two and is out of reach here.
# Operations are counted by hand from csrc/render_common.cuh and
# gradkernel.cu, each no more than the work needs: a sphere test counts
# what a miss needs, since a miss may end at the discriminant's sign (the
# flat forward's does), and the census of this run's data gives how many
# of each.
FP32_LANES_PER_SM = 128  # Hopper
PEAK_OPS = None          # ops_peak()'s rate, read at the first bound()
PEAK_BYTES = 3.35e12
OPS_SPHERE_TEST = 18   # a miss: 3 sub, half_b 5, c 6 (r^2 once a sphere),
#                        disc 3, its sign 1
OPS_SPHERE_ROOT = 23   # a hit (the tape replay's winner): + sqrt, 2 roots 4
OPS_BOX_TEST = 24      # 6 sub, 6 mul, 6 min/max, 3 max (tnear), 3 min (tfar)
OPS_STEP = 50          # hit point, normal, the material's new direction
OPS_SAMPLE = 30        # raygen, the sample's sum (the gamma is per pixel)
OPS_STEP_REVERSE = 200  # bounce_vjp of one scattering step (K3's reverse)


# the slab kernels' cell in the kernel table (phases 6b and 6d)
SLAB_CELL = ("config 5 frame spp2 parallel, rows 0-1079 (6d's slab); error "
             "also on rows 1021-1140 (6b)")


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(name: str, **kv) -> None:
    """One JSON line; ``t_s`` the seconds since the script started."""
    print(json.dumps({"phase": name, "t_s": time.perf_counter() - T0, **kv}),
          flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms_each(fn, iters: int) -> list[float]:
    """Each call's ms from CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, stop in events:
        start.record()
        fn()
        stop.record()
    torch.cuda.synchronize()
    return [start.elapsed_time(stop) for start, stop in events]


def kernel_ms(fn, kernel: str) -> float:
    """The device time, in ms, of the kernels whose name holds ``kernel``
    in one ``fn()`` call, from a ``torch.profiler`` trace after a warm-up
    call (the other kernels the call launches are left out)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and kernel in e.key)
    if us <= 0:
        fail(f"the profiler trace holds no device time of {kernel}")
    return us / 1e3


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call from CUDA events, after one warm-up call."""
    each = cuda_ms_each(fn, iters)
    return sum(each) / iters


PACK_SPHERES = 4097    # one past the brute sweep's stage: it reads the pack


def spheres_scene(n: int, dev, seed: int = 5):
    """``n`` spheres of every material at random in a 20-unit box, from a
    seed."""
    import raytpu_torch as rt
    g = torch.Generator().manual_seed(seed)
    return rt.Scene(
        (torch.rand(n, 3, generator=g) * 20 - 10).to(dev),
        (torch.rand(n, generator=g) * 0.3 + 0.05).to(dev),
        torch.randint(0, 3, (n,), generator=g, dtype=torch.int32).to(dev),
        torch.rand(n, 3, generator=g).to(dev),
        (torch.rand(n, generator=g) + 1.0).to(dev))


def compare(got: torch.Tensor, want: torch.Tensor) -> dict:
    d = (got - want).abs().amax(dim=-1)  # per pixel, worst channel
    return {"max_abs_err": float(d.max()),
            "share_above_budget": float((d > BUDGET_DELTA).float().mean()),
            "share_bit_equal": float((got == want).all(dim=-1).float().mean())}


def leaf_errors(got, want, cam_fields) -> tuple[dict, float]:
    """(relative max error per leaf, largest absolute error) of two
    (img, d_scene, d_cam) triples."""
    rel, worst_abs = {}, 0.0
    pairs = [(k, getattr(got[1], k), getattr(want[1], k), 1e-8)
             for k in ("center", "radius", "albedo", "mat_param")]
    pairs += [(k, a, b, 1e-6) for k, a, b in zip(cam_fields, got[2], want[2])]
    for k, a, b, floor in pairs:
        if not bool(torch.isfinite(a).all()):
            fail(f"the {k} cotangent is not finite")
        d = float((a - b).abs().max())
        worst_abs = max(worst_abs, d)
        rel[k] = d / max(float(b.abs().max()), floor)
    return rel, worst_abs


def once_ms(fn):
    """(result, ms) of one call, from CUDA events (the plain versions: a
    second call would double a run of seconds)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    stop.synchronize()
    return out, start.elapsed_time(stop)


def ops_peak() -> float:
    """f32 operations a second the card can run: its SMs x
    FP32_LANES_PER_SM x its top SM clock (``nvidia-smi`` clocks.max.sm)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True)
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * FP32_LANES_PER_SM * mhz * 1e6


def bound(ops: float, nbytes: float) -> dict:
    """bound_ms and bound_by for ``ops`` f32 operations and ``nbytes``
    bytes (PEAK_OPS, PEAK_BYTES)."""
    global PEAK_OPS
    if PEAK_OPS is None:
        PEAK_OPS = ops_peak()
    t_ops = ops / PEAK_OPS * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def forward_ops(c: dict) -> float:
    """f32 operations of one forward over the census ``c``: the sweep's
    sphere and leaf-box tests, the scatter of every step, the raygen of
    every sample."""
    return (c["sphere_tests"] * OPS_SPHERE_TEST
            + c["box_tests"] * OPS_BOX_TEST
            + c["bounce_steps"] * OPS_STEP + c["samples"] * OPS_SAMPLE)


def k3_ops(c: dict, sweeps: int, taped_steps: int = 0,
           near_miss_tests: int = 0) -> float:
    """K3's f32 operations over the census ``c``: ``sweeps`` forwards
    (PASS 2's, and PASS 1's in sequential RNG), less the sweep of each of
    the ``taped_steps`` a tape holds (the winner's root each instead), plus
    the reverse of every step, plus with ``vis_w > 0`` the near-miss sweep
    (gradkernel.cu ``near_miss``): ``near_miss_tests`` sphere tests, every
    sphere at every step that misses (:func:`near_miss_tests`)."""
    sweep = (c["sphere_tests"] * OPS_SPHERE_TEST
             + c["box_tests"] * OPS_BOX_TEST)
    saved = sweep * taped_steps / max(c["bounce_steps"], 1)
    return (sweeps * forward_ops(c) - saved
            + taped_steps * OPS_SPHERE_ROOT
            + c["bounce_steps"] * OPS_STEP_REVERSE
            + near_miss_tests * OPS_SPHERE_TEST)


def kernel_pack(scene, bvh=None) -> torch.Tensor:
    """``scene``'s pack as the kernels read it: in leaf order under a
    BVH."""
    from raytpu_torch import bvh as tbvh
    from raytpu_torch.kernels import megakernel
    return megakernel.pack_scene(scene if bvh is None
                                 else tbvh.permute_scene(scene, bvh.perm))


def frame_tape(scene, cam, cfg, bvh=None) -> torch.Tensor:
    """The frame's full winner-index tape from K4's taping forward, (spp x
    depth, H x W), filled with ``golden.TAPE_UNWRITTEN`` first: a pixel's
    steps in order across its samples, -1 for a miss, unwritten past its
    last step.  Its launch counts as a K4 launch."""
    from raytpu_torch.kernels import megakernel
    sp = kernel_pack(scene, bvh)
    tape = marked_tape(cfg, sp.shape[1], cfg.spp * cfg.depth,
                       scene.center.device)
    megakernel.launch(megakernel.pack_camera(cam), sp, cfg, bvh, tape=tape)
    return tape


def near_miss_tests(scene, cam, cfg, bvh=None) -> int:
    """The sphere tests of K3's near-miss sweep on this frame with ``vis_w
    > 0``: every sphere at every step that misses, the misses counted from
    the frame's tape (:func:`frame_tape`)."""
    return int((frame_tape(scene, cam, cfg, bvh) == -1).sum()) * scene.count


def per_sample_efficiency(tape: torch.Tensor, mat_type: torch.Tensor,
                          cfg) -> dict:
    """An estimate, not a count: the loop efficiency the per-sample loop
    (one thread a pixel, its samples one by one; a warp is 32 pixels of a
    row; no kernel runs it under the dense stage) would have on a frame,
    modelled as the bounce steps over 32 x the warp's bounce-loop
    iterations, which are, sample by sample, its longest lane's steps (the
    lanes reconverge after each sample).  Each sample's length comes from
    the frame's ``tape`` (:func:`frame_tape`): it ends at a miss, an
    absorption (a winner whose ``mat_type`` is not 0-2) or the depth cap.
    Under the dense stage the sweep efficiency is the same share (every
    step of a warp sweeps every sphere)."""
    from raytpu_torch import golden
    pixels, dev = tape.shape[1], tape.device
    absorbs = ~((mat_type >= 0) & (mat_type <= 2))
    length = torch.zeros(pixels, dtype=torch.int32, device=dev)
    smp = torch.zeros(pixels, dtype=torch.int64, device=dev)
    lengths = torch.zeros(pixels * cfg.spp, dtype=torch.int32, device=dev)
    base = torch.arange(pixels, device=dev) * cfg.spp
    for k in range(tape.shape[0]):
        w = tape[k].to(torch.int64)
        written = w != golden.TAPE_UNWRITTEN
        length += written.to(torch.int32)
        end = written & ((w == -1) | absorbs[w.clamp(min=0)]
                         | (length == cfg.depth))
        lengths[base[end] + smp[end]] = length[end]
        smp += end.to(torch.int64)
        length[end] = 0
    wp = -(-cfg.width // 32) * 32
    per = torch.zeros((cfg.height, wp, cfg.spp), dtype=torch.int32,
                      device=dev)
    per[:, :cfg.width] = lengths.reshape(cfg.height, cfg.width, cfg.spp)
    steps = int(per.sum())
    warp_steps = int(per.reshape(cfg.height, wp // 32, 32, cfg.spp)
                     .amax(dim=2).sum())
    return {"bounce_steps": steps, "warp_steps": warp_steps,
            "samples_ended": int(smp.sum()),
            "loop_efficiency": steps / max(32 * warp_steps, 1)}


def frame_bytes(cfg, spheres: int, images: int) -> int:
    """Bytes every kernel moves at least: the scene pack (9 f32 a sphere)
    read once and ``images`` f32 (H, W, 3) planes read or written once."""
    return 9 * 4 * spheres + images * cfg.height * cfg.width * 3 * 4


def flat_grads(out) -> list:
    """The f32 outputs of a VJP (img, d_scene, d_cam) as one list: image,
    the four scene leaves, the seven camera leaves."""
    return [out[0], *[getattr(out[1], k) for k in
                      ("center", "radius", "albedo", "mat_param")], *out[2]]


def k3_sums(out) -> torch.Tensor:
    """K3's f64 sums from ``gradkernel.launch``'s (image, sphere sums,
    camera sums) as one row: the sphere rows cx cy cz | rad | ar ag ab |
    mp, then the 18 camera sums (``gradkernel.camera_grads``)."""
    return torch.cat([out[1].reshape(-1), out[2]])


def k3_sums_rel(got: torch.Tensor, want: torch.Tensor, n: int) -> dict:
    """Per leaf, max |got - want| over the largest |want| of two rows of
    K3's f64 sums (:func:`k3_sums`) over ``n`` kernel-side spheres."""
    rel, i = {}, 0
    for k, size in (("center", 3 * n), ("radius", n), ("albedo", 3 * n),
                    ("mat_param", n), ("cam_origin", 3),
                    ("cam_lower_left", 3), ("cam_horizontal", 3),
                    ("cam_vertical", 3), ("cam_lens", 6)):
        # rows cx cy cz | rad | ar ag ab | mp, then the 18 camera sums
        # (gradkernel.camera_grads)
        a, b = got[i:i + size], want[i:i + size]
        rel[k] = float((a - b).abs().max()) / max(float(b.abs().max()),
                                                  1e-12)
        i += size
    return rel


def marked_tape(cfg, rows: int, g_cap: int, dev) -> torch.Tensor:
    """A tape for ``megakernel.launch(..., tape=)`` filled with
    ``golden.TAPE_UNWRITTEN``, so that the slots the taping forward writes
    can be told from the rest (``render_tape_fwd`` leaves those as
    allocated: the replay never reads them)."""
    from raytpu_torch import golden
    return torch.full((g_cap, cfg.height * cfg.width), golden.TAPE_UNWRITTEN,
                      dtype=golden.tape_dtype(rows), device=dev)


@contextlib.contextmanager
def recording(module, name: str, calls: list):
    """``module.name`` replaced, inside the block, by a wrapper that appends
    each call's (bound arguments, result) to ``calls``."""
    fn = getattr(module, name)
    sig = inspect.signature(fn)

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append((sig.bind(*args, **kwargs), out))
        return out
    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, fn)


def reset_counts(*modules) -> None:
    """Zero the launch counts of the kernel wrapper ``modules``."""
    for m in modules:
        for k in m.variants:
            m.variants[k] = 0


def variant_counts(*modules) -> dict:
    """The launches by variant since the last reset_counts, nonzero only."""
    return {k: v for m in modules for k, v in m.variants.items() if v}


def launch_count(module) -> int:
    """The launches of one kernel wrapper ``module`` since the last
    reset_counts, every variant summed."""
    return sum(module.variants.values())


def k3_plan(cfg, scene_pack, bvh) -> dict:
    """K3's windowed-refill plan of a full-frame launch on ``scene_pack``
    (:func:`kernel_pack`; lanes, pixels a lane, window, scratch bytes) and
    the bytes it stages, the brute sweep's rows or a flat BVH's
    (``gradkernel.launch_plan``: the lanes count them)."""
    from raytpu_torch.kernels import gradkernel
    stage, plan = gradkernel.launch_plan(cfg, cfg.height, scene_pack, bvh,
                                         True)
    return {**plan, "stage_bytes": stage["bytes"]}


@contextlib.contextmanager
def per_sample():
    """K3's per-sample PASS 2 on every path inside the block (the
    wrapper's P2_REFILL off), where the windowed refill runs by default."""
    from raytpu_torch.kernels import gradkernel
    gradkernel.P2_REFILL = False
    try:
        yield
    finally:
        gradkernel.P2_REFILL = True


def schedule_times(fn, iters: int = 3) -> dict:
    """``fn``'s ms on the windowed refill and on the per-sample pass, in
    turns (refill, per-sample, per-sample, refill): each turn a warm-up
    call, then ``iters`` calls timed one by one from CUDA events."""
    refill = cuda_ms_each(fn, iters)
    with per_sample():
        each = cuda_ms_each(fn, iters)
        each += cuda_ms_each(fn, iters)
    refill += cuda_ms_each(fn, iters)
    return {"refill_ms": sum(refill) / len(refill), "refill_each_ms": refill,
            "per_sample_ms": sum(each) / len(each), "per_sample_each_ms": each}


def tape_pairs(dev, card: str) -> dict:
    """Phase 4c: where the tape starts to pay (``tape_plan``'s
    TAPE_MIN_SPHERES).  ``render_grad`` at the config-2 frame in parallel
    RNG (brute sweep), untaped (TAPE_BUDGET 0) and taped (the floor set to
    0), in TAPE_PAIRS pairs whose order alternates, over scenes of 4 to 500
    spheres; each time the mean of 5 calls from CUDA events."""
    import raytpu_torch as rt
    from raytpu_torch.config import CONFIG2
    from raytpu_torch.kernels import gradkernel

    cfg = CONFIG2.replace(rng_mode="parallel")
    cam = rt.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0,
                         aspect=cfg.aspect, device=dev)
    target = torch.full((cfg.height, cfg.width, 3), 0.5, device=dev)
    budget, floor = gradkernel.TAPE_BUDGET, gradkernel.TAPE_MIN_SPHERES
    scenes = [("config2_world", rt.config2_world(device=dev))]
    scenes += [(f"final_world_n{n}", rt.final_world(n=n, device=dev))
               for n in (8, 16, 32, 64, 500)]
    out = {}
    for label, scene in scenes:
        def run(taped):
            gradkernel.TAPE_BUDGET = budget if taped else 0
            gradkernel.TAPE_MIN_SPHERES = 0
            try:
                return cuda_ms(lambda: rt.render_grad(scene, cam, cfg,
                                                      target), 5)
            finally:
                gradkernel.TAPE_BUDGET = budget
                gradkernel.TAPE_MIN_SPHERES = floor
        untaped, taped = [], []
        for i in range(TAPE_PAIRS):
            first = bool(i % 2)  # taped first in odd pairs
            a, b = run(first), run(not first)
            (taped if first else untaped).append(a)
            (untaped if first else taped).append(b)
        row = {"spheres": scene.count,
               "tapes_by_default": scene.count >= floor,
               "untaped_median_ms": float(np.median(untaped)),
               "taped_median_ms": float(np.median(taped)),
               "taped_faster_pairs": sum(t < u for t, u in
                                         zip(taped, untaped)),
               "untaped_ms": untaped, "taped_ms": taped}
        out[label] = row
        phase("tape_pairs", scene=label,
              frame=f"{cfg.width}x{cfg.height} spp{cfg.spp} d{cfg.depth} "
                    "parallel", card=card, pairs=TAPE_PAIRS, **row)
    return out


def taped_vs_untaped(scene, cam, cfg, ct, img, bvh, tape, label: str,
                     p2_refill=None) -> dict:
    """Taped K3 against untaped on the same operands (parallel RNG, the
    image given) for g_cap in (full, 0, 1, 2, depth + 3), by phase 5's
    rule: the image (output 0) and the camera cotangents (5-11), summed in
    a fixed order, bit-equal; a sphere leaf (1-4) within untaped K3's own
    spread over three runs (f64 atomics add in no fixed order) -> {g_cap:
    what differed}; fails otherwise."""
    from raytpu_torch.kernels import gradkernel
    full = cfg.spp * cfg.depth
    untaped = [flat_grads(gradkernel.render_vjp(
        scene, cam, cfg, ct, img=img, bvh=bvh, p2_refill=p2_refill))
        for _ in range(3)]
    spread = [max(float((r[i] - untaped[0][i]).abs().max())
                  for r in untaped[1:]) for i in range(len(untaped[0]))]
    caps = {}
    for g_cap in (full, 0, 1, 2, cfg.depth + 3):
        taped = flat_grads(gradkernel.render_vjp(
            scene, cam, cfg, ct, img=img, bvh=bvh, tape=tape[:g_cap],
            tape_partial=g_cap < full, p2_refill=p2_refill))
        diffs = {i: float((a - u).abs().max()) for i, (a, u) in
                 enumerate(zip(taped, untaped[0])) if not torch.equal(a, u)}
        bad = {i: d for i, d in diffs.items()
               if not 1 <= i <= 4 or d > spread[i]}
        caps[g_cap] = {"bit_equal": not diffs, "differing": diffs,
                       "untaped_spread": {i: spread[i] for i in diffs}}
        if bad:
            phase("k4_taped_vs_untaped", ok=False, schedule=label,
                  g_cap=g_cap, differing=diffs, untaped_spread=spread)
            fail(f"taped K3 ({label}, g_cap {g_cap}) differs from untaped")
    return caps


def config4_phases(dev, card: str) -> list:
    """Phases 5a-5g (see the module docstring) -> the kernel table's
    entries of K1c, K1', K4 (write, brute and BVH) and K3's BVH and
    tape-replay variants."""
    import raytpu_torch as rt
    from raytpu_torch import bvh as tbvh, golden, io, native, profiling
    from raytpu_torch.config import CONFIG4, REFERENCE_V2
    from raytpu_torch.kernels import gradkernel, megakernel

    cfg4 = CONFIG4                        # sequential RNG, BASELINE's
    cfg4p = CONFIG4.replace(rng_mode="parallel")
    cfg2 = CONFIG4.replace(spp=2)         # the cell the plain versions run
    cfg2p = cfg2.replace(rng_mode="parallel")
    full2 = cfg2.spp * cfg2.depth
    npix = cfg4.width * cfg4.height
    scene = rt.final_world(device=dev)
    cam = rt.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0,
                         aspect=cfg4.aspect, device=dev)
    cp, sp = megakernel.pack_camera(cam), megakernel.pack_scene(scene)
    gen = torch.Generator().manual_seed(7)
    target = torch.rand((cfg4.height, cfg4.width, 3), generator=gen).to(dev)
    plain = {"chunk_pixels": PLAIN_CHUNK}

    # -- 5a: the BVH, built on the host by the native builder
    t0 = time.perf_counter()
    bvh = rt.build_bvh(scene, leaf_size=LEAF)
    first_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    bvh = rt.build_bvh(scene, leaf_size=LEAF)
    build_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    ref = rt.build_bvh(scene, leaf_size=LEAF, use_native=False)
    numpy_ms = (time.perf_counter() - t0) * 1e3
    equal = all(torch.equal(a, b) for a, b in (
        (bvh.nodes, ref.nodes), (bvh.perm, ref.perm), (bvh.flat, ref.flat)))
    phase("bvh_build", scene=f"final_world(), {scene.count} spheres",
          leaf_size=LEAF, built_by=bvh.built_by,
          native_build_error=native.build_error,
          array_equal_numpy_builder=equal, leaves_per_copy=bvh.n_leaves,
          outliers=bvh.n_outliers, permuted_rows=int(bvh.perm.shape[0]),
          first_build_ms_with_gxx=first_ms, build_ms=build_ms,
          numpy_build_ms=numpy_ms)
    if bvh.built_by != "native median" or not equal:
        fail(f"the BVH build: {bvh.built_by}, equal to numpy: {equal}, "
             f"{native.build_error}")
    spv = megakernel.pack_scene(tbvh.permute_scene(scene, bvh.perm))
    rows = spv.shape[1]
    tape_elt = torch.empty((), dtype=golden.tape_dtype(rows)).element_size()
    flat_bytes = bvh.flat.numel() * 4

    # -- 5b: K1c against its plain version (2 spp) and against K1a (full)
    k1c2 = megakernel.launch(cp, spv, cfg2, bvh)
    want, k1c_plain_ms = once_ms(lambda: golden.render_golden(
        scene, cam, cfg2.replace(**plain), bvh))
    res = compare(k1c2, want)
    k1a4 = megakernel.launch(cp, sp, cfg4)
    k1c4 = megakernel.launch(cp, spv, cfg4, bvh)
    differ = int((k1a4 != k1c4).any(dim=-1).sum())
    ok = res["share_above_budget"] <= BUDGET_SHARE and differ <= TIE_SHARE * npix
    phase("k1c_vs_plain", frame="800x400 spp2 d12 sequential", ok=ok,
          tolerance=f"share |d| > {BUDGET_DELTA} <= {BUDGET_SHARE}",
          plain_ms=k1c_plain_ms, **res,
          k1c_vs_k1a_full_config4_pixels_differ=differ,
          allowed_exact_t_ties=int(TIE_SHARE * npix))
    if not ok:
        fail("K1c disagrees with its plain version or with K1a")
    del want, k1a4

    # -- 5c: the census K1' (full size), and against its plain version
    c4 = profiling.census(scene, cam, cfg4, bvh)
    c4_brute = profiling.census(scene, cam, cfg4)
    c2 = profiling.census(scene, cam, cfg2, bvh)
    c2p = profiling.census(scene, cam, cfg2p, bvh)
    c2p_brute = profiling.census(scene, cam, cfg2p)
    img_cen, _ = megakernel.launch(cp, spv, cfg2, bvh, count=True)
    plain_c = dict.fromkeys(golden.CENSUS, 0)
    _, cen_plain_ms = once_ms(lambda: golden.render_golden(
        scene, cam, cfg2.replace(**plain), bvh, census=plain_c))
    census_rel = max(abs(c2[k] - plain_c[k]) / max(plain_c[k], 1)
                     for k in golden.CENSUS)
    steps_rel = (abs(c4["bounce_steps"] - c4_brute["bounce_steps"])
                 / c4_brute["bounce_steps"])
    ok = (torch.equal(img_cen, k1c2) and census_rel <= 1e-3
          and steps_rel <= TIE_SHARE)
    phase("census", frame="800x400 spp100 d12 sequential", card=card,
          ok=ok, bvh=c4, brute=c4_brute,
          leaves_entered_per_step=c4["leaves_entered"] / c4["bounce_steps"],
          steps_per_sample=c4["bounce_steps"] / c4["samples"],
          sphere_tests_per_frame=c4["sphere_tests"],
          brute_sphere_tests_per_frame=c4_brute["sphere_tests"],
          sphere_test_cut=c4_brute["sphere_tests"] / c4["sphere_tests"],
          spp2_kernel=c2, spp2_plain=plain_c, spp2_max_rel_diff=census_rel,
          image_bit_equal_k1c=torch.equal(img_cen, k1c2))
    if not ok:
        fail("the census disagrees with its plain version or the brute one")

    # -- 5d: K3's BVH variant against K3 brute and the plain adjoint
    k3bvh_err = k3bvh_plain_ms = None
    for cfg in (cfg2, cfg2p):
        img = megakernel.launch(cp, spv, cfg, bvh)
        ct = 2.0 * (img - target) / img.numel()
        for vis_w in (0.0, VIS_W):
            got = gradkernel.render_vjp(scene, cam, cfg, ct, vis_w=vis_w,
                                        bvh=bvh)
            brute = gradkernel.render_vjp(scene, cam, cfg, ct, vis_w=vis_w)
            rel, _ = leaf_errors(got, brute, rt.Camera._fields)
            worst = max(rel, key=rel.get)
            row = {"frame": f"800x400 spp2 d12 {cfg.rng_mode}",
                   "vis_w": vis_w,
                   "img_bit_equal_brute": torch.equal(got[0], brute[0]),
                   "img_bit_equal_k1c": torch.equal(got[0], img),
                   "worst_leaf": worst, "rel_err": rel[worst],
                   "budget": GRAD_BUDGET}
            if cfg is cfg2 and vis_w == 0.0:  # and the plain adjoint
                want, k3bvh_plain_ms = once_ms(
                    lambda: gradkernel.render_vjp_plain(
                        scene, cam, cfg.replace(**plain), ct, 0.0, bvh))
                prel, k3bvh_err = leaf_errors(got, want, rt.Camera._fields)
                row.update(vs_plain_worst_rel=max(prel.values()),
                           vs_plain_max_abs=k3bvh_err,
                           plain_ms=k3bvh_plain_ms)
                ok_plain = max(prel.values()) <= GRAD_BUDGET
                del want
            else:
                ok_plain = True
            ok = (row["img_bit_equal_brute"] and row["img_bit_equal_k1c"]
                  and rel[worst] <= GRAD_BUDGET and ok_plain)
            phase("k3_bvh_vs_brute", ok=ok, **row)
            if not ok:
                fail(f"K3's BVH variant disagrees: {row}")
            del got, brute
    ct2 = 2.0 * (k1c2 - target) / k1c2.numel()
    k3bvh_ms = cuda_ms(lambda: gradkernel.launch(cp, spv, cfg2, ct2, None,
                                                 0.0, bvh), 3)

    # -- 5e: K4, the taping forward and K3's tape replay
    n_rv2 = rt.random_world(device=dev).count
    plan4 = gradkernel.tape_plan(cfg4p, scene.count, bvh)
    plan_rv2 = gradkernel.tape_plan(REFERENCE_V2.replace(rng_mode="parallel"),
                                    n_rv2)
    plan_vis = gradkernel.tape_plan(cfg4p, scene.count, bvh, vis_w=VIS_W)
    plan_seq = gradkernel.tape_plan(cfg4, scene.count, bvh)
    plan_few = gradkernel.tape_plan(cfg4p, 4)  # config 2's sphere count
    ok = (plan4 == {"g_cap": cfg4.spp * cfg4.depth, "partial": False,
                    "bytes": cfg4.spp * cfg4.depth * npix * tape_elt}
          and plan_vis is None and plan_seq is None and plan_few is None)
    phase("tape_plan", ok=ok, config4_parallel=plan4,
          reference_v2_parallel=plan_rv2, config4_parallel_vis_w=plan_vis,
          config4_sequential=plan_seq, four_spheres_parallel=plan_few,
          budget=gradkernel.TAPE_BUDGET,
          partial_min_coverage=gradkernel.PARTIAL_MIN_COVERAGE,
          tape_min_spheres=gradkernel.TAPE_MIN_SPHERES)
    if not ok:
        fail("tape_plan's decisions for config 4 are not the expected ones")
    tape4 = marked_tape(cfg4p, rows, plan4["g_cap"], dev)
    tape4_b = marked_tape(cfg4p, scene.count, plan4["g_cap"], dev)
    img_tb = megakernel.launch(cp, spv, cfg4p, bvh, tape=tape4)
    img_ta = megakernel.launch(cp, sp, cfg4p, tape=tape4_b)
    k1c4p = megakernel.launch(cp, spv, cfg4p, bvh)
    k1a4p = megakernel.launch(cp, sp, cfg4p)
    row = {"frame": "800x400 spp100 d12 parallel",
           "tape_bvh_img_bit_equal_k1c": torch.equal(img_tb, k1c4p),
           "tape_brute_img_bit_equal_k1a": torch.equal(img_ta, k1a4p),
           "k1a_vs_k1c_pixels_differ": int((k1a4p != k1c4p).any(-1).sum()),
           "tapes_equal_through_perm": float(
               (torch.where(tape4 >= 0, bvh.perm.long()[tape4.long().clamp(
                   min=0)], tape4.long()) == tape4_b.long()).float().mean()),
           "tape_bytes": tape4.numel() * tape_elt,
           "steps_logged": int((tape4 != golden.TAPE_UNWRITTEN).sum())}
    row["census_steps"] = profiling.census(scene, cam, cfg4p,
                                           bvh)["bounce_steps"]
    ok = (row["tape_bvh_img_bit_equal_k1c"]
          and row["tape_brute_img_bit_equal_k1a"]
          and row["k1a_vs_k1c_pixels_differ"] <= TIE_SHARE * npix
          and row["steps_logged"] == row["census_steps"])
    phase("k4_taping_forward", ok=ok, **row)
    if not ok:
        fail(f"the taping forward's image or tape is wrong: {row}")
    del tape4_b, img_ta

    entries = {}
    for sweep, b, pack, c in (("brute", None, sp, c2p_brute),
                              ("bvh", bvh, spv, c2p)):
        img2, tape2 = gradkernel.render_tape_fwd(scene, cam, cfg2p, full2, b)
        ct = 2.0 * (img2 - target) / img2.numel()
        # taped against untaped K3 on each PASS 2 schedule: the per-sample
        # pass and the windowed refill
        caps, k3t_ms, k3u_ms = {}, {}, {}
        for sched, p2 in (("per_sample", False), ("refill", True)):
            caps[sched] = taped_vs_untaped(scene, cam, cfg2p, ct, img2, b,
                                           tape2, f"{sweep}, {sched}", p2)
            k3t_ms[sched] = cuda_ms(lambda: gradkernel.launch(
                cp, pack, cfg2p, ct, img2, 0.0, b, tape2, p2_refill=p2), 3)
            k3u_ms[sched] = cuda_ms(lambda: gradkernel.launch(
                cp, pack, cfg2p, ct, img2, 0.0, b, p2_refill=p2), 3)
        k4_ms = cuda_ms(lambda: megakernel.launch(cp, pack, cfg2p, b,
                                                  tape=tape2), 5)
        (pimg, ptape), k4_plain_ms = once_ms(lambda: golden.render_golden_tape(
            scene, cam, cfg2p.replace(**plain), full2, b))
        k4_err = float((pimg - img2).abs().max())
        written = ptape != golden.TAPE_UNWRITTEN  # the rest is never read
        tape_share = float((ptape == tape2)[written].float().mean())
        want, k3t_plain_ms = once_ms(lambda: gradkernel.render_vjp_plain(
            scene, cam, cfg2p.replace(**plain), ct, 0.0, b, tape2))
        # both schedules against the one plain version (the same function)
        prel, k3t_err = {}, {}
        for sched, p2 in (("per_sample", False), ("refill", True)):
            got = gradkernel.render_vjp(scene, cam, cfg2p, ct, img=img2,
                                        bvh=b, tape=tape2, p2_refill=p2)
            prel[sched], k3t_err[sched] = leaf_errors(got, want,
                                                      rt.Camera._fields)
        worst_rel = max(max(r.values()) for r in prel.values())
        ok = (tape_share >= 1 - BUDGET_SHARE and worst_rel <= GRAD_BUDGET
              and compare(img2, pimg)["share_above_budget"] <= BUDGET_SHARE)
        phase("k4_taped_vs_untaped", ok=ok, sweep=sweep,
              frame="800x400 spp2 d12 parallel", g_caps=caps,
              plain_tape_share_equal=tape_share, write_vs_plain_img=k4_err,
              replay_vs_plain_rel=prel, k4_write_ms=k4_ms,
              k3_taped_ms=k3t_ms, k3_untaped_ms=k3u_ms,
              plain_write_ms=k4_plain_ms, plain_replay_ms=k3t_plain_ms,
              card=card)
        if not ok:
            fail(f"K4 or taped K3 ({sweep}) disagrees with its plain version")
        # the tape bytes moved: one slot a step this run took, written by
        # K4 and read by the replay (the slots past a pixel's last step
        # are neither)
        tbytes = c["bounce_steps"] * tape_elt
        nk = pack.shape[1]
        entries[f"K4/{sweep}"] = dict(
            max_abs_err=k4_err, ms=k4_ms, plain_ms=k4_plain_ms,
            **bound(forward_ops(c), frame_bytes(cfg2p, nk, 1) + tbytes
                    + (flat_bytes if b is not None else 0)))
        k3t_bound = bound(k3_ops(c, 1, c["bounce_steps"]),
                          frame_bytes(cfg2p, nk, 3) + tbytes + 8 * 8 * nk)
        keys = ({"per_sample": "K3/bvh+tape", "refill": "K3/bvh+refill+tape"}
                if b is not None else
                {"per_sample": "K3/tape", "refill": "K3/refill+tape"})
        for sched, key in keys.items():
            entries[key] = dict(
                max_abs_err=k3t_err[sched], max_rel_err=max(
                    prel[sched].values()), ms=k3t_ms[sched],
                plain_ms=k3t_plain_ms, untaped_ms=k3u_ms[sched], **k3t_bound)
        if b is not None:  # the untaped refill against the untaped plain
            want_u, k3u_plain_ms = once_ms(lambda: gradkernel.render_vjp_plain(
                scene, cam, cfg2p.replace(**plain), ct, 0.0, b))
            got = gradkernel.render_vjp(scene, cam, cfg2p, ct, img=img2,
                                        bvh=b)
            urel, uerr = leaf_errors(got, want_u, rt.Camera._fields)
            phase("k3_bvh_refill_vs_plain", ok=max(urel.values())
                  <= GRAD_BUDGET, frame="800x400 spp2 d12 parallel",
                  rel_err=urel, budget=GRAD_BUDGET, plain_ms=k3u_plain_ms)
            if max(urel.values()) > GRAD_BUDGET:
                fail("K3's untaped refill over the BVH disagrees with its "
                     "plain version")
            entries["K3/bvh+refill"] = dict(
                max_abs_err=uerr, max_rel_err=max(urel.values()),
                ms=k3u_ms["refill"], plain_ms=k3u_plain_ms,
                **bound(k3_ops(c, 1), frame_bytes(cfg2p, nk, 3) + flat_bytes
                        + 8 * 8 * nk))
            del want_u
        del want, got, tape2, ptape

    entries["K1c"] = dict(max_abs_err=res["max_abs_err"],
                          ms=cuda_ms(lambda: megakernel.launch(
                              cp, spv, cfg2, bvh), 5),
                          plain_ms=k1c_plain_ms,
                          **bound(forward_ops(c2), frame_bytes(cfg2, rows, 1)
                                  + flat_bytes))
    entries["K1'"] = dict(max_abs_err=float((img_cen - k1c2).abs().max()),
                          census_max_rel_diff=census_rel,
                          ms=cuda_ms(lambda: megakernel.launch(
                              cp, spv, cfg2, bvh, count=True), 5),
                          plain_ms=cen_plain_ms,
                          **bound(forward_ops(c2), frame_bytes(cfg2, rows, 1)
                                  + flat_bytes))
    entries["K3/bvh"] = dict(max_abs_err=k3bvh_err, ms=k3bvh_ms,
                             plain_ms=k3bvh_plain_ms,
                             **bound(k3_ops(c2, 2),
                                     frame_bytes(cfg2, rows, 2) + flat_bytes
                                     + 8 * 8 * rows))

    # -- 5f: the main path at full config 4, through the entry points
    launches = {}
    reset_counts(megakernel, gradkernel)
    img = rt.render(scene, cam, cfg4, bvh=bvh)
    torch.cuda.synchronize()
    launches["render"] = variant_counts(megakernel, gradkernel)
    mean = float(img.mean())
    runs = {}
    # parallel RNG: K3 on the windowed refill, and on the per-sample pass
    # where the label says so (P2_REFILL off)
    for label, cfg, b in (("parallel_bvh", cfg4p, bvh),
                          ("sequential_bvh", cfg4, bvh),
                          ("parallel_brute", cfg4p, None),
                          ("parallel_bvh_per_sample", cfg4p, bvh),
                          ("parallel_brute_per_sample", cfg4p, None)):
        reset_counts(megakernel, gradkernel)
        with (per_sample() if label.endswith("per_sample")
              else contextlib.nullcontext()):
            runs[label] = rt.render_grad(scene, cam, cfg, target, bvh=b)
        torch.cuda.synchronize()
        launches[label] = variant_counts(megakernel, gradkernel)
    reset_counts(megakernel, gradkernel)
    profiling.census(scene, cam, cfg4, bvh)
    launches["census"] = variant_counts(megakernel, gradkernel)
    want_launches = {"render": {"K1c": 1},
                     "parallel_bvh": {"K4/bvh": 1, "K3/bvh+refill+tape": 1},
                     "sequential_bvh": {"K1c": 1, "K3/bvh": 1},
                     "parallel_brute": {"K4/brute": 1, "K3/refill+tape": 1},
                     "parallel_bvh_per_sample": {"K4/bvh": 1,
                                                 "K3/bvh+tape": 1},
                     "parallel_brute_per_sample": {"K4/brute": 1,
                                                   "K3/tape": 1},
                     "census": {"K1'/bvh": 1}}
    finite = {k: all(bool(torch.isfinite(g).all()) for g in
                     flat_grads((r[1], *r[2]))) for k, r in runs.items()}
    band = (0.45, 0.75)  # mean of this frame (plain version, 100x50 4 spp: 0.61)
    phase("main_path_config4", frame="800x400 spp100 d12",
          spheres=scene.count, launches=launches, mean=mean,
          mean_band=band, min=float(img.min()), max=float(img.max()),
          losses={k: float(r[0]) for k, r in runs.items()},
          grads_finite=finite,
          sphere0_center_grad=runs["parallel_bvh"][2][0].center[0].tolist(),
          taped_img_bit_equal_k1c=torch.equal(runs["parallel_bvh"][1],
                                              k1c4p),
          seq_img_bit_equal_render=torch.equal(runs["sequential_bvh"][1],
                                               img))
    if launches != want_launches:
        fail(f"config-4 launches by variant {launches}, want {want_launches}")
    if (tuple(img.shape) != (cfg4.height, cfg4.width, 3)
            or not bool(torch.isfinite(img).all()) or float(img.min()) < 0
            or not band[0] <= mean <= band[1]):
        fail(f"config-4 image implausible: mean {mean}")
    if not all(finite.values()) or not all(
            np.isfinite(float(r[0])) for r in runs.values()):
        fail(f"config-4 gradients not finite: {finite}")
    if not (torch.equal(runs["parallel_bvh"][1], k1c4p)
            and torch.equal(runs["sequential_bvh"][1], img)):
        fail("render_grad's image is not the forward kernel's")
    # the two schedules' gradients at full size (f32, within 3e-5 of each
    # leaf's largest entry: raytpu's bound for its refill)
    sched_rel = {}
    for label in ("parallel_bvh", "parallel_brute"):
        rel, _ = leaf_errors((None, *runs[label][2]),
                             (None, *runs[label + "_per_sample"][2]),
                             rt.Camera._fields)
        sched_rel[label] = max(rel.values())
    phase("config4_refill_vs_per_sample", frame="800x400 spp100 d12 "
          "parallel, render_grad", ok=max(sched_rel.values()) <= REFILL_TOL,
          worst_rel=sched_rel, tolerance=REFILL_TOL)
    if max(sched_rel.values()) > REFILL_TOL:
        fail(f"config 4's refill gradients differ from the per-sample "
             f"pass's: {sched_rel}")
    del runs

    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "config4.png")
        cmd = [sys.executable, "-m", "raytpu_torch.cli", "render", "--bvh",
               "--scene", "final", "--width", str(cfg4.width), "--height",
               str(cfg4.height), "--spp", str(cfg4.spp), "--depth",
               str(cfg4.depth), "--device", "cuda", "--out", png]
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            fail(f"CLI --bvh exited {proc.returncode}: {proc.stderr[-2000:]}")
        ref = os.path.join(tmp, "in_process.png")
        io.save_png(ref, img.cpu().numpy())
        with open(png, "rb") as f, open(ref, "rb") as g:
            same = f.read() == g.read()
        phase("cli_bvh", command=" ".join(cmd[1:-1]),
              stdout=proc.stdout.strip(), identical_to_render=same)
        if not same:
            fail("the CLI's --bvh PNG differs from render(..., bvh=)'s image")

    # -- 5g: times at full config 4 (CUDA events, after a warm-up call)
    t = {"card": card}
    t["fwd_k1a_ms"] = cuda_ms(lambda: megakernel.launch(cp, sp, cfg4), 3)
    t["fwd_k1c_ms"] = cuda_ms(lambda: megakernel.launch(cp, spv, cfg4, bvh),
                              3)
    t["census_k1prime_ms"] = cuda_ms(lambda: megakernel.launch(
        cp, spv, cfg4, bvh, count=True), 3)
    t["taping_fwd_bvh_ms"] = cuda_ms(lambda: megakernel.launch(
        cp, spv, cfg4p, bvh, tape=tape4), 3)
    budget = gradkernel.TAPE_BUDGET
    for label, cfg, b in (("brute", cfg4p, None), ("bvh", cfg4p, bvh),
                          ("seq_brute", cfg4, None), ("seq_bvh", cfg4, bvh)):
        gradkernel.TAPE_BUDGET = 0  # untaped
        t[f"fwd_bwd_{label}_ms"] = cuda_ms(lambda: rt.render_grad(
            scene, cam, cfg, target, bvh=b), 2)
        gradkernel.TAPE_BUDGET = budget
        if cfg is cfg4p:
            t[f"fwd_bwd_{label}_tape_ms"] = cuda_ms(lambda: rt.render_grad(
                scene, cam, cfg, target, bvh=b), 2)
    _, tape4_b = gradkernel.render_tape_fwd(scene, cam, cfg4p,
                                            plan4["g_cap"])
    for label, pack, b, img_f, tp in (("brute", sp, None, k1a4p, tape4_b),
                                      ("bvh", spv, bvh, k1c4p, tape4)):
        ct = 2.0 * (img_f - target) / img_f.numel()
        t[f"k3_{label}_ms"] = cuda_ms(lambda: gradkernel.launch(
            cp, pack, cfg4p, ct, img_f, 0.0, b), 2)
        t[f"k3_{label}_tape_ms"] = cuda_ms(lambda: gradkernel.launch(
            cp, pack, cfg4p, ct, img_f, 0.0, b, tp), 2)
    # K3 over the flat BVH on the sequential per-sample pass alone: the
    # launch config 4's own render_grad makes (PASS 1 and PASS 2)
    ct_seq = 2.0 * (img - target) / img.numel()
    t["k3_seq_bvh_ms"] = cuda_ms(lambda: gradkernel.launch(
        cp, spv, cfg4, ct_seq, None, 0.0, bvh), 3)
    b3 = bound(k3_ops(c4, 2), frame_bytes(cfg4, rows, 2) + flat_bytes
               + 8 * 8 * rows)
    t["bound_k3_seq_bvh_ms"] = b3["bound_ms"]
    entries["K3/bvh"].update(main_path_ms=t["k3_seq_bvh_ms"],
                             main_path_bound_ms=b3["bound_ms"],
                             main_path_bound_by=b3["bound_by"])
    t["tape_bytes"] = tape4.numel() * tape_elt
    rays = cfg4.width * cfg4.height * cfg4.spp
    t["fwd_k1c_mrays_s"] = rays / t["fwd_k1c_ms"] / 1e3
    t["fwd_bwd_bvh_tape_mrays_s"] = rays / t["fwd_bwd_bvh_tape_ms"] / 1e3
    t["k3_over_k1a"] = t["k3_brute_ms"] / t["fwd_k1a_ms"]
    t["k3_bvh_tape_over_k1c"] = t["k3_bvh_tape_ms"] / t["fwd_k1c_ms"]
    t.update(bound_k1a_ms=bound(forward_ops(c4_brute), 0)["bound_ms"],
             bound_k1c_ms=bound(forward_ops(c4), 0)["bound_ms"])
    phase("timing_config4", frame="800x400 spp100 d12", **t)
    b4 = bound(forward_ops(c4), frame_bytes(cfg4, rows, 1) + flat_bytes)
    entries["K1c"].update(main_path_ms=t["fwd_k1c_ms"],
                          main_path_bound_ms=b4["bound_ms"],
                          main_path_bound_by=b4["bound_by"])
    del tape4, tape4_b

    # the tape's coverage rule: REFERENCE_V2 in parallel RNG at 8 spp, K3
    # with tapes holding about 25%, 50%, 75% and 90% of the frame's steps
    cfg_r = REFERENCE_V2.replace(spp=8, rng_mode="parallel")
    scene_r = rt.random_world(device=dev)
    cam_r = rt.reference_camera_v2(cfg_r.aspect, device=dev)
    cp_r, sp_r = megakernel.pack_camera(cam_r), megakernel.pack_scene(scene_r)
    worst = cfg_r.spp * cfg_r.depth
    tape_r = marked_tape(cfg_r, scene_r.count, worst, dev)
    img_r = megakernel.launch(cp_r, sp_r, cfg_r, tape=tape_r)
    per_pix = (tape_r != golden.TAPE_UNWRITTEN).sum(dim=0)
    total = int(per_pix.sum())

    def coverage(g):
        return int(per_pix.clamp(max=g).sum()) / total

    def cap_for(share):
        lo, hi = 0, worst
        while lo < hi:
            mid = (lo + hi) // 2
            lo, hi = (mid + 1, hi) if coverage(mid) < share else (lo, mid)
        return lo

    ct_r = 2.0 * (img_r - 0.5) / img_r.numel()
    untaped_ms = cuda_ms(lambda: gradkernel.launch(cp_r, sp_r, cfg_r, ct_r,
                                                   img_r), 3)
    full_ms = cuda_ms(lambda: gradkernel.launch(cp_r, sp_r, cfg_r, ct_r,
                                                img_r, 0.0, None, tape_r), 3)
    rows_cov = []
    for share in (0.25, 0.5, 0.75, 0.9):
        g = cap_for(share)
        ms = cuda_ms(lambda: gradkernel.launch(cp_r, sp_r, cfg_r, ct_r, img_r,
                                               0.0, None, tape_r[:g]), 3)
        cov = coverage(g)
        rows_cov.append({"g_cap": g, "coverage": cov,
                         "of_worst_case": g / worst, "k3_ms": ms,
                         "proportional_ms": untaped_ms
                         - cov * (untaped_ms - full_ms)})
    phase("tape_coverage", frame="1024x576 spp8 d50 parallel random_world",
          card=card, steps_per_pixel=total / per_pix.numel(),
          k3_untaped_ms=untaped_ms, k3_full_tape_ms=full_ms,
          full_tape_bytes=tape_r.numel() * tape_elt, partial=rows_cov,
          rule=f"partial when g_cap >= {gradkernel.PARTIAL_MIN_COVERAGE} "
               "x spp x depth")
    del tape_r

    for k, n in (("K1c", launches["render"]["K1c"]
                  + launches["sequential_bvh"]["K1c"]),
                 ("K1'", launches["census"]["K1'/bvh"]),
                 ("K4/bvh", launches["parallel_bvh"]["K4/bvh"]),
                 ("K4/brute", launches["parallel_brute"]["K4/brute"]),
                 ("K3/bvh", launches["sequential_bvh"]["K3/bvh"]),
                 ("K3/bvh+tape",
                  launches["parallel_bvh_per_sample"]["K3/bvh+tape"]),
                 ("K3/tape",
                  launches["parallel_brute_per_sample"]["K3/tape"]),
                 ("K3/bvh+refill+tape",
                  launches["parallel_bvh"]["K3/bvh+refill+tape"]),
                 ("K3/refill+tape",
                  launches["parallel_brute"]["K3/refill+tape"])):
        entries[k]["launches"] = n
    return entries


def slab_census(scene, cam, cfg, bvh, row0=0, rows=None) -> dict:
    """The census of a row slab (the whole frame without ``rows``)."""
    from raytpu_torch import profiling
    return profiling.census(scene, cam, cfg, bvh, row0=row0, rows=rows)


def state_bytes(cfg, rows: int) -> int:
    """K2's carried state of ``rows`` rows, read once and written once:
    f32 sums (3 a pixel) and u32 seeds."""
    return 2 * rows * cfg.width * (3 * 4 + 4)


# the flat sweep's forward instantiations and the dense stage's, by their
# template arguments in the mangled names: render_fwd_kernel<kHit (kFlat 1,
# kDense 3), kTape, kCount, kCarry>, render_segment_kernel<kHit> (K5) and
# render_refill_kernel<kHit> (K6; under the dense stage, and the brute
# sweep's segments up to 4096 spheres)
FLAT_KERNELS = {"K1c, K1b/bvh": "render_fwd_kernelILi1ELi0ELb0ELb0E",
                "K1'/bvh": "render_fwd_kernelILi1ELi0ELb1ELb0E",
                "K2/bvh": "render_fwd_kernelILi1ELi0ELb0ELb1E",
                "K4/bvh": "render_fwd_kernelILi1ELi1ELb0ELb0E"}
DENSE_KERNELS = {"K1e, K1b/dense": "render_fwd_kernelILi3ELi0ELb0ELb0E",
                 "K1'/dense": "render_fwd_kernelILi3ELi0ELb1ELb0E",
                 "K5/dense, K5/brute (staged)":
                     "render_segment_kernelILi3EE",
                 "K6/dense, K6/brute (staged)":
                     "render_refill_kernelILi3EE"}


def flat_ptxas(lines: list, kernels: dict = FLAT_KERNELS) -> dict:
    """{kernel: {"registers", "spill_store_bytes", "spill_load_bytes"}} of
    the instantiations ``kernels`` names (by default the flat sweep's
    forward), from ptxas -v's lines
    (``_build.build_log[source]["ptxas"]``)."""
    out, name = {}, None
    for ln in lines:
        m = re.search(r"entry function '(\S+)'", ln)
        if m:
            name = next((k for k, v in kernels.items() if v in m.group(1)),
                        None)
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m:
            out.setdefault(name, {}).update(
                spill_store_bytes=int(m.group(1)),
                spill_load_bytes=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out.setdefault(name, {})["registers"] = int(m.group(1))
            name = None
    return out


def stage_info(bvh, dev) -> dict:
    """What the flat sweep's forward stages of ``bvh`` in shared memory on
    this card (``megakernel.flat_stage_on``), the card's opt-in limit and
    the blocks of K1c an SM holds with it (the persistent grid's)."""
    from raytpu_torch.kernels import megakernel
    st = megakernel.flat_stage_on(bvh, dev)
    optin, blocks = megakernel.flat_device(dev, st["bytes"])
    return {"n_leaves": bvh.n_leaves, **st, "optin_bytes": optin,
            "blocks_per_sm": blocks}


def flat_phase(dev, card: str, entries4: dict, entries5: dict) -> None:
    """The flat sweep's forward on its main paths (flat_forward_redesign):
    the warp counters and both efficiencies of K1'/bvh on config 5's batch
    frame (1920x1080, 50 spp, sequential), on the train step's 1080-row
    slab (20 spp, parallel) and on config 4 at 2 spp (both RNG modes; the
    sequential census held to the plain census exactly); the K2/bvh,
    K4/bvh+slab and K1c times of this run beside their bounds; ptxas's
    registers and spills; the shared memory staged and the blocks an SM
    holds.  Adds the efficiencies to the flat rows of the
    kernel table."""
    import raytpu_torch as rt
    from raytpu_torch import bvh as tbvh, golden
    from raytpu_torch.config import CONFIG4, CONFIG5
    from raytpu_torch.kernels import _build, megakernel

    scene = rt.final_world(device=dev)
    bvh = rt.build_bvh(scene, leaf_size=LEAF)
    spv = megakernel.pack_scene(tbvh.permute_scene(scene, bvh.perm))

    def cp(cfg):
        return megakernel.pack_camera(rt.make_camera(
            (13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0, aspect=cfg.aspect,
            device=dev))

    cfg_b = CONFIG5.replace(spp=50)
    cfg_s = CONFIG5.replace(spp=20, rng_mode="parallel")
    cfg4 = CONFIG4.replace(spp=2)
    cfg4p = cfg4.replace(rng_mode="parallel")
    warps = {
        "config5_batch": megakernel.warp_census(cp(cfg_b), spv, cfg_b, bvh),
        "config5_slab": megakernel.warp_census(cp(cfg_s), spv, cfg_s, bvh, 0,
                                               cfg_s.height),
        "config4_spp2": megakernel.warp_census(cp(cfg4), spv, cfg4, bvh),
        "config4_spp2_parallel": megakernel.warp_census(cp(cfg4p), spv,
                                                        cfg4p, bvh)}
    plain = dict.fromkeys(golden.CENSUS, 0)
    golden.render_golden(scene, rt.make_camera(
        (13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0, aspect=cfg4.aspect,
        device=dev), cfg4.replace(chunk_pixels=PLAIN_CHUNK), bvh,
        census=plain)
    counted = ("leaves_entered", "bounce_steps", "samples")
    census_equal = all(warps["config4_spp2"][k] == plain[k] for k in counted)
    times = {key: {"ms": e[ms], "bound_ms": e[b]} for key, e, ms, b in (
        ("K2/bvh", entries5["K2/bvh"], "main_path_ms", "main_path_bound_ms"),
        ("K4/bvh+slab", entries5["K4/bvh+slab"], "main_path_ms",
         "main_path_bound_ms"),
        ("K1c", entries4["K1c"], "main_path_ms", "main_path_bound_ms"))}
    ptxas = flat_ptxas(_build.build_log[megakernel.SOURCE]["ptxas"])
    phase("flat_forward_redesign", ok=census_equal, card=card,
          frames={"config5_batch": "1920x1080 spp50 d12 sequential",
                  "config5_slab": "1920x1080 rows 0-1079 spp20 d12 parallel",
                  "config4_spp2": "800x400 spp2 d12 sequential",
                  "config4_spp2_parallel": "800x400 spp2 d12 parallel"},
          warps=warps, census_plain_config4_spp2=plain,
          census_equal_plain=census_equal,
          times_main_path=times, ptxas=ptxas, stage=stage_info(bvh, dev))
    if not census_equal:
        fail(f"K1'/bvh's census on config 4 at 2 spp {warps['config4_spp2']}"
             f" differs from the plain census {plain}")
    for key, entry, cell in (
            ("K1c", entries4["K1c"], "config4_spp2"),
            ("K1'", entries4["K1'"], "config4_spp2"),
            ("K4/bvh", entries4["K4/bvh"], "config4_spp2_parallel"),
            ("K2/bvh", entries5["K2/bvh"], "config5_batch"),
            ("K2/bvh+slab", entries5["K2/bvh+slab"], "config5_slab"),
            ("K1b/bvh", entries5["K1b/bvh"], "config5_slab"),
            ("K4/bvh+slab", entries5["K4/bvh+slab"], "config5_slab")):
        entry.update(loop_efficiency=warps[cell]["loop_efficiency"],
                     sweep_efficiency=warps[cell]["sweep_efficiency"],
                     efficiency_cell=cell)


def k2_phase(dev, card: str) -> dict:
    """Phase 6a: K2 against its plain version at 480x270, 4 spp, depth 12,
    ``final_world()`` -> the kernel table's K2/brute and K2/bvh entries."""
    import raytpu_torch as rt
    from raytpu_torch import bvh as tbvh, golden, progressive
    from raytpu_torch.kernels import gradkernel, megakernel

    cfg0 = rt.RenderConfig(width=480, height=270, spp=4, depth=12)
    scene = rt.final_world(device=dev)
    cam = rt.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0,
                         aspect=cfg0.aspect, device=dev)
    bvh = rt.build_bvh(scene, leaf_size=LEAF)
    entries = {}
    for rng_mode in ("sequential", "parallel"):
        cfg = cfg0.replace(rng_mode=rng_mode, chunk_pixels=PLAIN_CHUNK)
        for sweep, b in (("brute", None), ("bvh", bvh)):
            init = progressive.init_state(cfg, device=dev)
            reset_counts(megakernel, gradkernel)
            st = plain = init
            for k in (1, 2, 1):
                st = progressive.accumulate(scene, cam, cfg, st, k, bvh=b)
                plain = progressive.accumulate(scene, cam, cfg, plain, k,
                                               backend="golden", bvh=b)
            one = progressive.accumulate(scene, cam, cfg, init, 4, bvh=b)
            torch.cuda.synchronize()
            counts = variant_counts(megakernel, gradkernel)
            img = rt.render(scene, cam, cfg, bvh=b)
            shown = progressive.image(st, cfg)
            img_err = float((shown - img).abs().max())
            row = {"acc_bit_equal_plain": torch.equal(st.acc, plain.acc),
                   "seed_bit_equal_plain": torch.equal(st.seed, plain.seed),
                   "acc_max_abs_vs_plain": float(
                       (st.acc - plain.acc).abs().max()),
                   "batched_bit_equal_one_shot": torch.equal(
                       st.acc, one.acc) and torch.equal(st.seed, one.seed),
                   "image_bit_equal_render": torch.equal(shown, img),
                   "image_max_abs_vs_render": img_err,
                   "launches": counts}
            ok = (row["acc_bit_equal_plain"] and row["seed_bit_equal_plain"]
                  and row["batched_bit_equal_one_shot"] and img_err <= 2e-7
                  and counts == {f"K2/{sweep}": 4})
            phase("k2_vs_plain", frame=f"480x270 spp4 d12 {rng_mode}",
                  sweep=sweep, batches=[1, 2, 1], ok=ok, **row,
                  tolerance="acc and seed bit-equal; image vs render() "
                            "bit-equal or within 2e-7")
            if not ok:
                fail(f"K2 ({rng_mode}, {sweep}) disagrees: {row}")
            if rng_mode != "sequential":
                continue
            cp = megakernel.pack_camera(cam)
            sp = megakernel.pack_scene(
                scene if b is None else tbvh.permute_scene(scene, b.perm))
            acc0 = init.acc.contiguous()
            seed0 = megakernel._u32_bits(init.seed).contiguous()
            ms = cuda_ms(lambda: megakernel.launch_accumulate(
                cp, sp, cfg, acc0, seed0, 0, cfg.spp, b), 5)
            _, plain_ms = once_ms(lambda: golden.accumulate_golden(
                scene, cam, cfg, init.acc, init.seed, 0, cfg.spp, b))
            c = slab_census(scene, cam, cfg, b)
            extra = 0 if b is None else b.flat.numel() * 4
            entries[f"K2/{sweep}"] = dict(
                max_abs_err=row["acc_max_abs_vs_plain"], ms=ms,
                plain_ms=plain_ms, launches=counts[f"K2/{sweep}"],
                **bound(forward_ops(c), frame_bytes(cfg, sp.shape[1], 0)
                        + state_bytes(cfg, cfg.height) + extra))
    return entries


def slab_phase(dev, card: str, bvh, scene, cam) -> dict:
    """Phase 6b: slab mode at the config-5 frame (1920x1080, 2 spp, BVH):
    K1b, K2's slab, the slab taping forward and K3's slab on three uneven
    slabs and one past the frame, stitched against the full frame, and each
    against its plain version on the slab past the frame -> those slab
    kernels' entries (:func:`slab_vs_plain`)."""
    from raytpu_torch import bvh as tbvh, progressive, shard
    from raytpu_torch.config import CONFIG5
    from raytpu_torch.kernels import gradkernel, megakernel

    h, w = CONFIG5.height, CONFIG5.width
    slabs = ((0, 301), (301, 420), (721, 300), (1021, 120))
    last = slabs[-1]
    cp = megakernel.pack_camera(cam)
    spv = megakernel.pack_scene(tbvh.permute_scene(scene, bvh.perm))
    n = spv.shape[1]
    gen = torch.Generator().manual_seed(11)
    for rng_mode in ("sequential", "parallel"):
        cfg = CONFIG5.replace(spp=2, rng_mode=rng_mode,
                              chunk_pixels=PLAIN_CHUNK)
        full = megakernel.launch(cp, spv, cfg, bvh)
        init = progressive.init_state(cfg, device=dev)
        acc0 = init.acc.contiguous()
        seed0 = megakernel._u32_bits(init.seed).contiguous()
        facc, fseed = megakernel.launch_accumulate(cp, spv, cfg, acc0, seed0,
                                                   0, 2, bvh)
        target = torch.rand((h, w, 3), generator=gen).to(dev)
        ct = 2.0 * (full - target) / full.numel()
        img_in = full if rng_mode == "parallel" else None
        want = k3_sums(gradkernel.launch(cp, spv, cfg, ct, img_in, 0.0, bvh))
        imgs, accs, seeds, sums, k3imgs = [], [], [], 0.0, []
        for row0, rows in slabs:
            live = min(rows, h - row0)
            imgs.append(megakernel.launch(cp, spv, cfg, bvh, row0=row0,
                                          rows=rows))
            a, s = megakernel.launch_accumulate(
                cp, spv, cfg, shard.slab_of(acc0, row0, rows),
                shard.slab_of(seed0, row0, rows), 0, 2, bvh, row0, rows)
            accs.append(a)
            seeds.append(s)
            ct_s = shard.slab_of(ct, row0, rows)
            ct_s[live:] = 1.0  # ignored
            img_s = (None if img_in is None
                     else shard.slab_of(img_in, row0, rows))
            out = gradkernel.launch(cp, spv, cfg, ct_s, img_s, 0.0, bvh,
                                    row0=row0, rows=rows)
            k3imgs.append(out[0])
            sums = sums + k3_sums(out)
        pads_zero = all(not bool(t[h - last[0]:].any()) for t in
                        (imgs[-1], accs[-1], seeds[-1], k3imgs[-1]))
        stitch = {
            "k1b_bit_equal_full": torch.equal(torch.cat(imgs)[:h], full),
            "k2_acc_bit_equal_full": torch.equal(torch.cat(accs)[:h], facc),
            "k2_seed_bit_equal_full": torch.equal(torch.cat(seeds)[:h],
                                                  fseed),
            "k3_img_bit_equal_full": torch.equal(torch.cat(k3imgs)[:h],
                                                 full),
            "rows_past_frame_zero": pads_zero}
        leaf_rel = k3_sums_rel(sums, want, n)
        stitch["k3_sums_rel"] = leaf_rel
        ok = all(v for k, v in stitch.items() if k != "k3_sums_rel") and \
            max(leaf_rel.values()) <= 1e-6
        if rng_mode == "parallel":
            g = cfg.spp * cfg.depth
            tape = marked_tape(cfg, n, g, dev)
            img_t = megakernel.launch(cp, spv, cfg, bvh, tape=tape)
            tapes_ok = True
            for row0, rows in slabs:
                live = min(rows, h - row0)
                tape_s = marked_tape(cfg.replace(height=rows), n, g, dev)
                img_s = megakernel.launch(cp, spv, cfg, bvh, tape=tape_s,
                                          row0=row0, rows=rows)
                tapes_ok &= (torch.equal(img_s[:live],
                                         img_t[row0:row0 + live])
                             and torch.equal(tape_s[:, :live * w],
                                             tape[:, row0 * w:
                                                  (row0 + live) * w]))
            stitch["k4_tape_and_image_bit_equal_full"] = tapes_ok
            ok &= tapes_ok
        phase("slab_mode", frame=f"1920x1080 spp2 d12 {rng_mode} bvh",
              slabs=slabs, ok=ok, **stitch,
              tolerance="bit-equal; K3 sums (f64) within 1e-6 of each "
                        "leaf's largest entry")
        if not ok:
            fail(f"slab mode ({rng_mode}) disagrees with the full frame: "
                 f"{stitch}")
        del target, ct

    # each slab kernel against its plain version on the slab past the frame
    return slab_vs_plain(card, bvh, scene, cam, CONFIG5.replace(
        spp=2, rng_mode="parallel", chunk_pixels=PLAIN_CHUNK), *last)


def slab_vs_plain(card: str, bvh, scene, cam, cfg, row0: int,
                  rows: int) -> dict:
    """K1b, K2's slab, the slab taping forward (image and tape) and K3's
    slab replaying that tape, on rows ``[row0, row0 + rows)`` of ``cfg``'s
    frame (parallel RNG, BVH), each against its plain version on the same
    inputs -> {kernel: max_abs_err, ms and plain_ms (CUDA events), the
    bound of this slab's census}."""
    import raytpu_torch as rt
    from raytpu_torch import bvh as tbvh, golden, progressive, shard
    from raytpu_torch.kernels import gradkernel, megakernel

    live = min(rows, cfg.height - row0)
    cp = megakernel.pack_camera(cam)
    spv = megakernel.pack_scene(tbvh.permute_scene(scene, bvh.perm))
    n = spv.shape[1]
    flat_bytes = bvh.flat.numel() * 4
    c = slab_census(scene, cam, cfg, bvh, row0, rows)
    fwd_bytes = frame_bytes(cfg.replace(height=rows), n, 1) + flat_bytes
    entries = {}
    got = megakernel.launch(cp, spv, cfg, bvh, row0=row0, rows=rows)
    want, plain_ms = once_ms(lambda: golden.render_golden(
        scene, cam, cfg, bvh, row0=row0, rows=rows))
    res = compare(got, want)
    entries["K1b/bvh"] = dict(
        max_abs_err=res["max_abs_err"], plain_ms=plain_ms,
        ms=cuda_ms(lambda: megakernel.launch(cp, spv, cfg, bvh, row0=row0,
                                             rows=rows), 3),
        **bound(forward_ops(c), fwd_bytes))
    del got, want
    init = progressive.init_state(cfg, device=spv.device)
    acc_s, seed_s = (shard.slab_of(init.acc, row0, rows),
                     shard.slab_of(init.seed, row0, rows))
    bits = megakernel._u32_bits(seed_s).contiguous()
    k2 = megakernel.launch_accumulate(cp, spv, cfg, acc_s, bits, 0, cfg.spp,
                                      bvh, row0, rows)
    (pacc, pseed), k2_plain_ms = once_ms(lambda: golden.accumulate_golden(
        scene, cam, cfg, acc_s, seed_s, 0, cfg.spp, bvh, row0, rows))
    k2_bit = (torch.equal(k2[0], pacc)
              and torch.equal(k2[1].long() & 0xFFFFFFFF, pseed))
    entries["K2/bvh+slab"] = dict(
        max_abs_err=float((k2[0] - pacc).abs().max()), plain_ms=k2_plain_ms,
        ms=cuda_ms(lambda: megakernel.launch_accumulate(
            cp, spv, cfg, acc_s, bits, 0, cfg.spp, bvh, row0, rows), 3),
        **bound(forward_ops(c), frame_bytes(cfg, n, 0) + flat_bytes
                + state_bytes(cfg, rows)))
    del k2, pacc, pseed
    g = cfg.spp * cfg.depth
    tape_s = marked_tape(cfg.replace(height=rows), n, g, spv.device)
    img_t = megakernel.launch(cp, spv, cfg, bvh, tape=tape_s, row0=row0,
                              rows=rows)
    (pimg, ptape), k4_plain_ms = once_ms(lambda: golden.render_golden_tape(
        scene, cam, cfg, g, bvh, row0, rows))
    written = ptape != golden.TAPE_UNWRITTEN
    tape_share = float((ptape == tape_s)[written].float().mean())
    tape_elt = tape_s.element_size()
    entries["K4/bvh+slab"] = dict(
        max_abs_err=float((img_t - pimg).abs().max()),
        plain_ms=k4_plain_ms, plain_tape_share_equal=tape_share,
        ms=cuda_ms(lambda: megakernel.launch(cp, spv, cfg, bvh, tape=tape_s,
                                             row0=row0, rows=rows), 3),
        **bound(forward_ops(c), fwd_bytes + c["bounce_steps"] * tape_elt))
    del pimg, ptape, written
    ct_s = 2.0 * (img_t - 0.5) / (cfg.height * cfg.width * 3)
    ct_s[live:] = 0.0
    want3, k3_plain_ms = once_ms(lambda: gradkernel.render_vjp_plain(
        scene, cam, cfg, ct_s, 0.0, bvh, tape_s, row0, rows))
    # the per-sample pass and the windowed refill against the one plain
    # version (the same function)
    prel = {}
    for key, p2 in (("K3/bvh+tape+slab", False),
                    ("K3/bvh+refill+tape+slab", True)):
        got3 = gradkernel.render_vjp(scene, cam, cfg, ct_s, img=img_t,
                                     bvh=bvh, tape=tape_s, row0=row0,
                                     rows=rows, p2_refill=p2)
        prel[key], k3_err = leaf_errors(got3, want3, rt.Camera._fields)
        entries[key] = dict(
            max_abs_err=k3_err, max_rel_err=max(prel[key].values()),
            plain_ms=k3_plain_ms,
            ms=cuda_ms(lambda: gradkernel.launch(
                cp, spv, cfg, ct_s, img_t, 0.0, bvh, tape_s, row0, rows,
                p2_refill=p2), 3),
            **bound(k3_ops(c, 1, c["bounce_steps"]),
                    frame_bytes(cfg.replace(height=rows), n, 3) + flat_bytes
                    + c["bounce_steps"] * tape_elt + 8 * 8 * n))
        del got3
    ok = (res["share_above_budget"] <= BUDGET_SHARE and k2_bit
          and tape_share >= 1 - BUDGET_SHARE
          and max(max(r.values()) for r in prel.values()) <= GRAD_BUDGET)
    phase("slab_vs_plain", frame=f"{cfg.width}x{cfg.height} spp{cfg.spp} "
          f"d{cfg.depth} {cfg.rng_mode} bvh", slab=[row0, rows],
          live_rows=live, ok=ok, k1b=res, k2_bit_equal_plain=k2_bit,
          k4_plain_tape_share_equal=tape_share, k3_vs_plain_rel=prel,
          card=card, tolerance=f"images: share |d| > {BUDGET_DELTA} <= "
          f"{BUDGET_SHARE}; K2 bit-equal; tape slots equal on >= "
          f"{1 - BUDGET_SHARE}; K3 {GRAD_BUDGET} of each leaf's largest "
          "entry", times={k: {"ms": e["ms"], "plain_ms": e["plain_ms"]}
                          for k, e in entries.items()})
    if not ok:
        fail(f"a slab kernel disagrees with its plain version on rows "
             f"{row0}-{row0 + rows - 1}")
    return entries


def train_steps(cfg, group, bvh, scene, cam, target, lr: float):
    """Three steps of ``shard.make_train_step`` -> (losses, ms per step
    from CUDA events, launches by variant per step, (the first step's
    gradients, its image))."""
    from raytpu_torch import shard
    from raytpu_torch.kernels import gradkernel, megakernel
    step = shard.make_train_step(cfg, group=group, lr=lr, bvh=bvh)
    losses, step_ms, launches, first = [], [], [], None
    for _ in range(3):
        reset_counts(megakernel, gradkernel)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        scene, cam, loss = step(scene, cam, target)
        stop.record()
        stop.synchronize()
        step_ms.append(start.elapsed_time(stop))
        launches.append(variant_counts(megakernel, gradkernel))
        losses.append(float(loss))
        first = first or (step.last_grads, step.last_image)
    return losses, step_ms, launches, first


def slab_main_times(cfg, scene, cam, bvh, card: str) -> dict:
    """Each slab kernel at the main path's shape (phase 6d: the one slab of
    a world of one, 1920x1080, 20 spp, parallel, BVH, full tape) -> {key:
    (ms, bound)}, the bound from this frame's census."""
    from raytpu_torch import bvh as tbvh, golden, progressive
    from raytpu_torch.kernels import gradkernel, megakernel
    h = cfg.height
    c = slab_census(scene, cam, cfg, bvh)
    cp = megakernel.pack_camera(cam)
    spv = megakernel.pack_scene(tbvh.permute_scene(scene, bvh.perm))
    n, extra = spv.shape[1], bvh.flat.numel() * 4
    g = cfg.spp * cfg.depth
    tape = torch.empty((g, h * cfg.width), dtype=golden.tape_dtype(n),
                       device=spv.device)
    elt = tape.element_size()
    init = progressive.init_state(cfg, device=spv.device)
    bits = megakernel._u32_bits(init.seed).contiguous()
    img = megakernel.launch(cp, spv, cfg, bvh, tape=tape, row0=0, rows=h)
    ct = 2.0 * (img - 0.5) / img.numel()
    fwd = frame_bytes(cfg, n, 1) + extra
    out = {
        "K1b/bvh": (cuda_ms(lambda: megakernel.launch(
            cp, spv, cfg, bvh, row0=0, rows=h), 3),
            bound(forward_ops(c), fwd)),
        "K2/bvh+slab": (cuda_ms(lambda: megakernel.launch_accumulate(
            cp, spv, cfg, init.acc, bits, 0, cfg.spp, bvh, 0, h), 3),
            bound(forward_ops(c), frame_bytes(cfg, n, 0) + extra
                  + state_bytes(cfg, h))),
        "K4/bvh+slab": (cuda_ms(lambda: megakernel.launch(
            cp, spv, cfg, bvh, tape=tape, row0=0, rows=h), 3),
            bound(forward_ops(c), fwd + c["bounce_steps"] * elt)),
        **{key: (cuda_ms(lambda: gradkernel.launch(
            cp, spv, cfg, ct, img, 0.0, bvh, tape, 0, h, p2_refill=p2), 3),
            bound(k3_ops(c, 1, c["bounce_steps"]),
                  frame_bytes(cfg, n, 3) + extra + c["bounce_steps"] * elt
                  + 8 * 8 * n))
           for key, p2 in (("K3/bvh+tape+slab", False),
                           ("K3/bvh+refill+tape+slab", True))}}
    phase("slab_kernels_main_path", frame="1920x1080 spp20 d12 parallel "
          "bvh, one slab of 1080 rows", card=card, census=c,
          times={k: {"ms": ms, **b} for k, (ms, b) in out.items()})
    return out


def k2_main_shape(scene, cam, bvh, state, card: str) -> float:
    """Phase 6c's check of K2 at the main path's shape: one 2-spp batch on
    the full config-5 frame from ``state``, the main path's state after 5
    batches of 50 (s0 = 250), against its plain version on the same
    inputs, acc and seed bit for bit.  Sequential RNG (the main path's)
    resumes the state's seed chains; parallel RNG takes the same sums with
    the base seeds, so that s0 picks the streams -> the largest |acc -
    plain|."""
    from raytpu_torch import progressive
    from raytpu_torch.config import CONFIG5
    spp, rows, worst = 2, {}, 0.0
    for rng_mode in ("sequential", "parallel"):
        cfg = CONFIG5.replace(rng_mode=rng_mode, chunk_pixels=FRAME_CHUNK)
        st = state if rng_mode == "sequential" else state._replace(
            seed=progressive.init_state(cfg, device=state.acc.device).seed)
        got, ms = once_ms(lambda: progressive.accumulate(
            scene, cam, cfg, st, spp, bvh=bvh))
        want, plain_ms = once_ms(lambda: progressive.accumulate(
            scene, cam, cfg, st, spp, backend="golden", bvh=bvh))
        err = float((got.acc - want.acc).abs().max())
        worst = max(worst, err)
        rows[rng_mode] = {
            "acc_bit_equal_plain": torch.equal(got.acc, want.acc),
            "seed_bit_equal_plain": torch.equal(got.seed, want.seed),
            "acc_max_abs_vs_plain": err, "ms": ms, "plain_ms": plain_ms}
    ok = all(r["acc_bit_equal_plain"] and r["seed_bit_equal_plain"]
             for r in rows.values())
    phase("k2_vs_plain_main_shape", frame="1920x1080 d12 bvh",
          s0=state.samples, spp=spp, ok=ok, card=card,
          tolerance="acc and seed bit-equal", **rows)
    if not ok:
        fail(f"K2 on the config-5 frame disagrees with its plain version: "
             f"{rows}")
    return worst


def config5_phases(dev, card: str) -> dict:
    """Phases 6a-6d (see the module docstring) -> the kernel table's K2
    and slab entries, each with its launches on its path."""
    import raytpu_torch as rt
    from raytpu_torch import io, progressive, shard
    from raytpu_torch.config import CONFIG5
    from raytpu_torch.kernels import gradkernel, megakernel

    entries = k2_phase(dev, card)
    scene = rt.final_world(device=dev)
    cam = rt.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0,
                         aspect=CONFIG5.aspect, device=dev)
    bvh = rt.build_bvh(scene, leaf_size=LEAF)
    entries.update(slab_phase(dev, card, bvh, scene, cam))

    # -- 6c: the main path, config 5 progressive over the BVH
    cfg = CONFIG5
    batch = 50
    rays = cfg.width * cfg.height * cfg.spp
    reset_counts(megakernel, gradkernel)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    batch_ms = []
    gen = progressive.render_progressive(scene, cam, cfg, batch=batch,
                                         bvh=bvh)
    while True:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        item = next(gen, None)
        stop.record()
        if item is None:
            break
        stop.synchronize()
        batch_ms.append(start.elapsed_time(stop))
        state, img = item
    total_s = time.perf_counter() - t0
    main_launches = variant_counts(megakernel, gradkernel)
    # the work of one batch: the census of the first 50 samples (a batch
    # time above also holds image(), a few elementwise passes)
    c50 = slab_census(scene, cam, cfg.replace(spp=batch), bvh)
    b50 = bound(forward_ops(c50), frame_bytes(cfg, int(bvh.perm.shape[0]), 0)
                + bvh.flat.numel() * 4 + state_bytes(cfg, cfg.height))
    entries["K2/bvh"].update(
        launches=main_launches.get("K2/bvh", 0),
        main_path_ms=float(np.median(batch_ms)),
        main_path_bound_ms=b50["bound_ms"], main_path_bound_by=b50["bound_by"])
    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "config5.npz")
        t0 = time.perf_counter()
        gen = progressive.render_progressive(scene, cam, cfg, batch=batch,
                                             checkpoint_path=ck, bvh=bvh)
        for _ in range(5):
            first = next(gen)
        gen.close()
        rest = list(progressive.render_progressive(
            scene, cam, cfg, batch=batch, checkpoint_path=ck, resume=True,
            bvh=bvh))
        torch.cuda.synchronize()
        ck_total_s = time.perf_counter() - t0
        resumed = rest[-1][1]
        oneshot, oneshot_ms = once_ms(lambda: rt.render(scene, cam, cfg,
                                                        bvh=bvh))
        mean = float(img.mean())
        row = {"samples": [first[0].samples, len(rest), rest[-1][0].samples],
               "resumed_bit_equal_uninterrupted": torch.equal(resumed, img),
               "bit_equal_one_shot_render": torch.equal(img, oneshot),
               "max_abs_vs_one_shot": float((img - oneshot).abs().max()),
               "mean": mean, "finite": bool(torch.isfinite(img).all())}
        band = (0.45, 0.75)  # config 4's band: the same scene and camera
        ok = (row["resumed_bit_equal_uninterrupted"]
              and row["max_abs_vs_one_shot"] <= 2e-7 and row["finite"]
              and band[0] <= mean <= band[1]
              and main_launches == {"K2/bvh": cfg.spp // batch})
        phase("main_path_config5_progressive",
              frame="1920x1080 spp500 d12 sequential bvh", batch=batch,
              spheres=scene.count, launches=main_launches, ok=ok,
              ms_per_batch=batch_ms, total_s=total_s,
              mrays_s=rays / total_s / 1e6,
              kernel_mrays_s=rays / sum(batch_ms) * 1e-3,
              with_checkpoints_total_s=ck_total_s,
              one_shot_render_ms=oneshot_ms,
              one_shot_mrays_s=rays / oneshot_ms * 1e-3, mean_band=band,
              card=card, **row)
        if not ok:
            fail(f"config-5 progressive: {row}, launches {main_launches}")
        entries["K2/bvh"]["max_abs_err"] = max(
            entries["K2/bvh"]["max_abs_err"],
            k2_main_shape(scene, cam, bvh, first[0], card))

        png = os.path.join(tmp, "config5.png")
        ck2 = os.path.join(tmp, "cli.npz")
        cmd = [sys.executable, "-m", "raytpu_torch.cli", "render", "--scene",
               "final", "--bvh", "--progressive", "100", "--checkpoint", ck2,
               "--width", str(cfg.width), "--height", str(cfg.height),
               "--spp", str(cfg.spp), "--depth", str(cfg.depth), "--device",
               "cuda", "--out", png]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=600)
        cli_s = time.perf_counter() - t0
        if proc.returncode != 0:
            fail(f"CLI --progressive exited {proc.returncode}: "
                 f"{proc.stderr[-2000:]}")
        ref = os.path.join(tmp, "in_process.png")
        io.save_png(ref, img.cpu().numpy())
        with open(png, "rb") as f, open(ref, "rb") as g:
            same = f.read() == g.read()
        saved, _ = progressive.load_checkpoint(ck2, device=dev)
        phase("cli_progressive", command=" ".join(cmd[1:]).replace(
            tmp, "<tmp>"), seconds=cli_s, stderr=proc.stderr.strip()[-400:],
            checkpoint_samples=saved.samples, identical_to_render=same)
        if not same or saved.samples != cfg.spp:
            fail("the CLI's --progressive PNG differs from the in-process "
                 "progressive image")
    del state, img, resumed, oneshot, rest

    # -- 6d: the sharded path on one card, a world-size-1 NCCL group
    import torch.distributed as dist
    with tempfile.TemporaryDirectory() as tmp:
        group = shard.init_distributed(
            device=dev, init_method="file://" + os.path.join(tmp, "init"),
            world_size=1, rank=0)
        try:
            cfg = CONFIG5.replace(spp=20, rng_mode="parallel")
            reset_counts(megakernel, gradkernel)
            img = shard.render_sharded(scene, cam, cfg, group=group, bvh=bvh)
            torch.cuda.synchronize()
            render_launches = variant_counts(megakernel, gradkernel)
            ref = rt.render(scene, cam, cfg, bvh=bvh)
            reset_counts(megakernel, gradkernel)
            st = progressive.init_state(cfg, device=dev)
            for _ in range(2):
                st = progressive.accumulate(scene, cam, cfg, st, 10, bvh=bvh,
                                            group=group)
            torch.cuda.synchronize()
            acc_launches = variant_counts(megakernel, gradkernel)
            shown = progressive.image(st, cfg)
            # config 5's scene against itself with the albedo scaled by 0.7
            target = rt.render(scene._replace(albedo=scene.albedo * 0.7),
                               cam, cfg, bvh=bvh)
            losses, step_ms, step_launches, first = train_steps(
                cfg, group, bvh, scene, cam, target, 1e-2)
            grads0, img0 = first
            rloss, rimg, (rsg, rcg) = rt.render_grad(scene, cam, cfg, target,
                                                     bvh=bvh)
            rel, _ = leaf_errors((None, *grads0), (None, rsg, rcg),
                                 rt.Camera._fields)
            # raytpu's falling-loss problem (tests/test_shard.py
            # test_train_step_reduces_loss): the hero sphere's albedo
            # perturbed, lr 2.0; six spheres buried in the ground (never
            # hit) bring it to the tape's 8-sphere floor
            spheres = [((0.0, -100.5, -1.0), 100.0, 0, (0.5, 0.5, 0.5), 0.0),
                       ((0.0, 0.0, -1.0), 0.5, 0, (0.7, 0.3, 0.3), 0.0)]
            spheres += [((-3.0 + k, -110.0, -1.0), 0.5, 0, (0.5, 0.5, 0.5),
                         0.0) for k in range(6)]
            hero = rt.make_scene(spheres, dev)
            hcam = rt.make_camera((0.0, 0.3, 1.5), (0.0, 0.0, -1.0),
                                  vfov=45.0, aspect=cfg.aspect, device=dev)
            hbvh = rt.build_bvh(hero)
            htarget = rt.render(hero, hcam, cfg, bvh=hbvh)
            alb = hero.albedo.clone()
            alb[1] = torch.tensor([0.3, 0.6, 0.5], device=dev)
            hlosses, hstep_ms, hlaunches, _ = train_steps(
                cfg, group, hbvh, hero._replace(albedo=alb), hcam, htarget,
                2.0)
            want_step = {"K4/bvh+slab": 1, "K3/bvh+refill+tape+slab": 1}
            # the same steps with K3's per-sample pass
            with per_sample():
                ps_losses, _, ps_launches, ps_first = train_steps(
                    cfg, group, bvh, scene, cam, target, 1e-2)
            ps_rel, _ = leaf_errors((None, *grads0), (None, *ps_first[0]),
                                    rt.Camera._fields)
            row = {"render_sharded_bit_equal_render": torch.equal(img, ref),
                   "render_launches": render_launches,
                   "accumulate_image_bit_equal_render": torch.equal(shown,
                                                                    ref),
                   "accumulate_launches": acc_launches,
                   "final_world_losses": losses,
                   "render_grad_loss": float(rloss),
                   "step_image_bit_equal_render_grad": torch.equal(img0,
                                                                   rimg),
                   "grad_rel_vs_render_grad": rel,
                   "step_launches": step_launches, "step_ms": step_ms,
                   "hero_losses": hlosses, "hero_step_ms": hstep_ms,
                   "hero_step_launches": hlaunches,
                   "per_sample_losses": ps_losses,
                   "per_sample_step_launches": ps_launches,
                   "refill_vs_per_sample_rel": ps_rel,
                   "backend": dist.get_backend(group)}
            ok = (row["render_sharded_bit_equal_render"]
                  and row["accumulate_image_bit_equal_render"]
                  and render_launches == {"K1b/bvh": 1}
                  and acc_launches == {"K2/bvh+slab": 2}
                  and all(x == want_step for x in step_launches + hlaunches)
                  and all(x == {"K4/bvh+slab": 1, "K3/bvh+tape+slab": 1}
                          for x in ps_launches)
                  and max(ps_rel.values()) <= REFILL_TOL
                  and max(rel.values()) <= GRAD_BUDGET
                  and np.isfinite(losses + hlosses).all()
                  and hlosses[-1] < hlosses[0]
                  and row["backend"] == "nccl")
            phase("sharded_world1_nccl",
                  frame="1920x1080 spp20 d12 parallel bvh (refit, taped)",
                  final_world="lr 0.01, target: albedo x 0.7 (its loss is "
                              "not held to fall: the step has no silhouette "
                              "terms and 500 spheres' edges move)",
                  hero="lr 2.0, the hero sphere's albedo perturbed",
                  ok=ok, budget=GRAD_BUDGET, card=card, **row)
            if not ok:
                fail(f"the sharded path on one card: {row}")
            main_times = slab_main_times(cfg, scene, cam, bvh, card)
            # the main path's step on each PASS 2 schedule (phase 9's
            # record of the refill's main paths)
            step = shard.make_train_step(cfg, group=group, lr=1e-2, bvh=bvh)
            step_times = dict(schedule_times(
                lambda: step(scene, cam, target)),
                plan=k3_plan(cfg, kernel_pack(scene, bvh), bvh))
            phase("main_path_refill", path="config 5 train step",
                  frame="1920x1080 spp20 d12 parallel bvh, world-1 NCCL, "
                        "taped", card=card, **step_times)
            dist.barrier()  # every rank done before the teardown
        finally:
            dist.destroy_process_group()
    # each slab kernel on the main path's slab (a world of one: rows
    # 0-1079) against its plain version, cut to 2 spp; the table keeps
    # these times and the worse error of this slab and 6b's
    on_main = slab_vs_plain(card, bvh, scene, cam, cfg.replace(
        spp=2, chunk_pixels=FRAME_CHUNK), 0, shard.slab_rows(cfg, 1))
    for key, (ms, b) in main_times.items():
        e = on_main[key]
        for k in ("max_abs_err", "max_rel_err"):
            if k in e:
                e[k] = max(e[k], entries[key][k])
        entries[key] = dict(e, main_path_ms=ms,
                            main_path_bound_ms=b["bound_ms"],
                            main_path_bound_by=b["bound_by"])
    entries["K1b/bvh"]["launches"] = render_launches["K1b/bvh"]
    entries["K2/bvh+slab"]["launches"] = acc_launches["K2/bvh+slab"]
    entries["K4/bvh+slab"]["launches"] = sum(
        x["K4/bvh+slab"] for x in step_launches + hlaunches)
    entries["K3/bvh+tape+slab"]["launches"] = sum(
        x["K3/bvh+tape+slab"] for x in ps_launches)
    entries["K3/bvh+refill+tape+slab"]["launches"] = sum(
        x["K3/bvh+refill+tape+slab"] for x in step_launches + hlaunches)
    entries["K3/bvh+refill+tape+slab"]["main_path_schedules"] = step_times
    return entries


# Phase 7: raytpu's 10,000-sphere scene, past 64 leaves a copy: the walk
BIG_SPHERES = 10_000


def big_world(n: int, seed: int = 0, extent: float = 60.0) -> list:
    """raytpu's large-scene recipe (scripts/probe_10k_r5.py big_world):
    ground, three heroes and n - 4 spheres of radius 0.2 scattered over
    [-extent, extent]^2 with final_world's material mix, as
    ``(center, radius, mat_type, albedo, mat_param)`` tuples."""
    rg = np.random.default_rng(seed)
    spheres = [((0.0, -1000.0, 0.0), 1000.0, 0, (0.5, 0.5, 0.5), 0.0),
               ((0.0, 1.0, 0.0), 1.0, 2, (1.0, 1.0, 1.0), 1.5),
               ((-4.0, 1.0, 0.0), 1.0, 0, (0.4, 0.2, 0.1), 0.0),
               ((4.0, 1.0, 0.0), 1.0, 1, (0.7, 0.6, 0.5), 0.0)]
    while len(spheres) < n:
        center = (rg.uniform(-extent, extent), 0.2,
                  rg.uniform(-extent, extent))
        m = rg.random()
        if m < 0.8:
            mat, alb, mp = 0, tuple(rg.random(3) * rg.random(3)), 0.0
        elif m < 0.95:
            mat, alb, mp = 1, tuple(0.5 + 0.5 * rg.random(3)), \
                0.5 * rg.random()
        else:
            mat, alb, mp = 2, (1.0, 1.0, 1.0), 1.5
        spheres.append((center, 0.2, mat, alb, mp))
    return spheres[:n]


def walk_vs_plain(scene, cam, cfg, bvh, card: str) -> dict:
    """Phase 7b: each walk kernel against its plain version on ``cfg``'s
    whole frame at 2 spp, both RNG modes: K1d, K1b/walk (the slab of all
    rows), K2/walk (batches 1 + 1 from s0 = 0), K1'/walk (image and counts)
    and K4/walk (image and tape) bit for bit, K3/walk and (parallel)
    K3/walk+tape within GRAD_BUDGET -> the table's entries (times and
    bounds in parallel RNG, K3/walk's in sequential)."""
    from raytpu_torch import bvh as tbvh, golden, progressive, shard
    from raytpu_torch.kernels import gradkernel, megakernel
    import raytpu_torch as rt
    row0, rows = 0, cfg.height  # K1b, K2, K4 and K3 as a slab of all rows
    cp = megakernel.pack_camera(cam)
    spv = megakernel.pack_scene(tbvh.permute_scene(scene, bvh.perm))
    n = spv.shape[1]
    node_bytes = bvh.nodes.numel() * 4
    entries, worst, worst_rel = {}, {}, {}
    for rng_mode in ("sequential", "parallel"):
        cfg2 = cfg.replace(spp=2, rng_mode=rng_mode, chunk_pixels=FRAME_CHUNK)
        c = slab_census(scene, cam, cfg2, bvh, row0, rows)
        fwd_bytes = frame_bytes(cfg2, n, 1) + node_bytes
        row = {}
        got = megakernel.launch(cp, spv, cfg2, bvh, row0=row0, rows=rows)
        img_c, cen = megakernel.launch(cp, spv, cfg2, bvh, count=True,
                                       row0=row0, rows=rows)
        plain_c = dict.fromkeys(golden.CENSUS, 0)
        want, census_plain_ms = once_ms(lambda: golden.render_golden(
            scene, cam, cfg2, bvh, census=plain_c, row0=row0, rows=rows))
        row["k1b_bit_equal"] = torch.equal(got, want)
        worst["K1b/walk"] = max(worst.get("K1b/walk", 0.0),
                                float((got - want).abs().max()))
        row["k1prime_counts"] = cen.tolist()
        row["k1prime_bit_equal"] = (torch.equal(img_c, want) and cen.tolist()
                                    == [plain_c[k] for k in golden.CENSUS])
        init = progressive.init_state(cfg2, device=spv.device)
        acc_s = shard.slab_of(init.acc, row0, rows)
        seed_s = shard.slab_of(init.seed, row0, rows)
        bits = megakernel._u32_bits(seed_s).contiguous()
        k2 = megakernel.launch_accumulate(cp, spv, cfg2, acc_s, bits, 0, 1,
                                          bvh, row0, rows)
        k2 = megakernel.launch_accumulate(cp, spv, cfg2, k2[0], k2[1], 1, 1,
                                          bvh, row0, rows)

        def k2_plain():
            a, sd = golden.accumulate_golden(scene, cam, cfg2, acc_s, seed_s,
                                             0, 1, bvh, row0, rows)
            return golden.accumulate_golden(scene, cam, cfg2, a, sd, 1, 1,
                                            bvh, row0, rows)
        (pacc, pseed), k2_plain_ms = once_ms(k2_plain)
        row["k2_bit_equal"] = (torch.equal(k2[0], pacc) and torch.equal(
            k2[1].long() & 0xFFFFFFFF, pseed))
        worst["K2/walk"] = max(worst.get("K2/walk", 0.0),
                               float((k2[0] - pacc).abs().max()))
        del k2, pacc, pseed, acc_s, seed_s, init
        g = cfg2.spp * cfg2.depth
        tape = marked_tape(cfg2, n, g, spv.device)
        img_t = megakernel.launch(cp, spv, cfg2, bvh, tape=tape, row0=row0,
                                  rows=rows)
        (pimg, ptape), k4_plain_ms = once_ms(lambda: golden.render_golden_tape(
            scene, cam, cfg2, g, bvh, row0, rows))
        row["k4_bit_equal"] = torch.equal(img_t, pimg) and torch.equal(
            tape, ptape)
        worst["K4/walk"] = max(worst.get("K4/walk", 0.0),
                               float((img_t - pimg).abs().max()))
        del pimg, ptape
        ct = 2.0 * (got - 0.5) / (cfg2.height * cfg2.width * 3)
        k3 = gradkernel.render_vjp(scene, cam, cfg2, ct, bvh=bvh, row0=row0,
                                   rows=rows)
        want3, k3_plain_ms = once_ms(lambda: gradkernel.render_vjp_plain(
            scene, cam, cfg2, ct, 0.0, bvh, None, row0, rows))
        rel, err = leaf_errors(k3, want3, rt.Camera._fields)
        if rng_mode == "parallel":  # the untaped refill, the same function
            k3r = gradkernel.render_vjp(scene, cam, cfg2, ct, img=got,
                                        bvh=bvh, row0=row0, rows=rows)
            relr, worst["K3/walk+refill"] = leaf_errors(k3r, want3,
                                                        rt.Camera._fields)
            worst_rel["K3/walk+refill"] = max(relr.values())
            row["k3_refill_rel"] = relr
            del k3r
        del want3
        row["k3_rel"] = rel
        row["k3_img_bit_equal"] = torch.equal(k3[0], got)
        worst["K3/walk"] = max(worst.get("K3/walk", 0.0), err)
        worst_rel["K3/walk"] = max(worst_rel.get("K3/walk", 0.0),
                                   max(rel.values()))
        ok_par = True
        if rng_mode == "parallel":
            # K1d: the same frame launched whole; its plain version (and
            # K1b's) timed without the census
            k1d = megakernel.launch(cp, spv, cfg2, bvh)
            want_k1d, k1_plain_ms = once_ms(lambda: golden.render_golden(
                scene, cam, cfg2, bvh))
            row["k1d_bit_equal"] = (torch.equal(k1d, want_k1d)
                                    and torch.equal(want_k1d, want))
            worst["K1d"] = float((k1d - want_k1d).abs().max())
            del k1d, want_k1d
            want3t, k3t_plain_ms = once_ms(lambda: gradkernel.render_vjp_plain(
                scene, cam, cfg2, ct, 0.0, bvh, tape, row0, rows))
            tb = c["bounce_steps"] * tape.element_size()
            # the per-sample pass and the windowed refill against the one
            # plain version (the same function)
            for key, p2 in (("K3/walk+tape", False),
                            ("K3/walk+refill+tape", True)):
                k3t = gradkernel.render_vjp(scene, cam, cfg2, ct, img=got,
                                            bvh=bvh, tape=tape, row0=row0,
                                            rows=rows, p2_refill=p2)
                relt, worst[key] = leaf_errors(k3t, want3t,
                                               rt.Camera._fields)
                del k3t
                row[f"{key}_rel"] = relt
                worst_rel[key] = max(relt.values())
                entries[key] = dict(
                    plain_ms=k3t_plain_ms,
                    ms=cuda_ms(lambda: gradkernel.launch(
                        cp, spv, cfg2, ct, got, 0.0, bvh, tape, row0, rows,
                        p2_refill=p2), 3),
                    **bound(k3_ops(c, 1, c["bounce_steps"]),
                            frame_bytes(cfg2, n, 3) + node_bytes + tb
                            + 8 * 8 * n))
            del want3t
            entries["K3/walk+refill"] = dict(
                plain_ms=k3_plain_ms,
                ms=cuda_ms(lambda: gradkernel.launch(
                    cp, spv, cfg2, ct, got, 0.0, bvh, None, row0, rows), 3),
                **bound(k3_ops(c, 1), frame_bytes(cfg2, n, 3) + node_bytes
                        + 8 * 8 * n))
            ok_par = (row["k1d_bit_equal"] and max(
                worst_rel[k] for k in ("K3/walk+tape", "K3/walk+refill+tape",
                                       "K3/walk+refill")) <= GRAD_BUDGET)
            acc2 = torch.zeros((rows, cfg2.width, 3), device=spv.device)
            times = {
                "K1d": (k1_plain_ms, lambda: megakernel.launch(
                    cp, spv, cfg2, bvh), fwd_bytes),
                "K1b/walk": (k1_plain_ms, lambda: megakernel.launch(
                    cp, spv, cfg2, bvh, row0=row0, rows=rows), fwd_bytes),
                "K2/walk": (k2_plain_ms, lambda: megakernel.launch_accumulate(
                    cp, spv, cfg2, acc2, bits, 0, 2, bvh, row0, rows),
                    frame_bytes(cfg2, n, 0) + node_bytes
                    + state_bytes(cfg2, rows)),
                "K4/walk": (k4_plain_ms, lambda: megakernel.launch(
                    cp, spv, cfg2, bvh, tape=tape, row0=row0, rows=rows),
                    fwd_bytes + tb)}
            for key, (pms, fn, nbytes) in times.items():
                entries[key] = dict(plain_ms=pms, ms=cuda_ms(fn, 3),
                                    **bound(forward_ops(c), nbytes))
            row["plain_census_render_ms"] = census_plain_ms
        else:
            entries["K3/walk"] = dict(
                plain_ms=k3_plain_ms,
                ms=cuda_ms(lambda: gradkernel.launch(
                    cp, spv, cfg2, ct, None, 0.0, bvh, None, row0, rows), 3),
                **bound(k3_ops(c, 2), frame_bytes(cfg2, n, 2) + node_bytes
                        + 8 * 8 * n))
        ok = (row["k1b_bit_equal"] and row["k1prime_bit_equal"]
              and row["k2_bit_equal"] and row["k4_bit_equal"]
              and row["k3_img_bit_equal"] and max(rel.values()) <= GRAD_BUDGET
              and ok_par)
        phase("walk_vs_plain", frame=f"{cfg.width}x{cfg.height} (all rows) "
              f"spp2 d12 {rng_mode}, {scene.count} spheres", ok=ok,
              census=c, card=card,
              tolerance=f"bit-equal; K3 {GRAD_BUDGET} of each leaf's largest "
                        "entry", **row)
        if not ok:
            fail(f"a walk kernel disagrees with its plain version "
                 f"({rng_mode}): {row}")
        del got, want, tape, img_t, k3, ct
        torch.cuda.empty_cache()
    for key, e in entries.items():
        e["max_abs_err"] = worst[key]
        if key in worst_rel:
            e["max_rel_err"] = worst_rel[key]
    return entries


# the walk's instantiations, by their template arguments in the mangled
# names (kWalk 2): the forward's render_fwd_kernel<kHit, kTape, kCount,
# kCarry>, K3's (K3_KERNELS), K5's and K6's
WALK_KERNELS = {"K1d": "render_fwd_kernelILi2ELi0ELb0ELb0E",
                "K1'/walk": "render_fwd_kernelILi2ELi0ELb1ELb0E",
                "K2/walk": "render_fwd_kernelILi2ELi0ELb0ELb1E",
                "K4/walk": "render_fwd_kernelILi2ELi1ELb0ELb0E",
                "K5/walk": "render_segment_kernelILi2EE",
                "K6/walk": "render_refill_kernelILi2EE"}


def walk_phase(dev, card: str, scene, cam, cfg, bvh, img, ct) -> dict:
    """Phase 7g (walk_redesign): the walk's forward and K3 on the 10k frame
    (``cfg``, parallel RNG, 20 spp): the counted warp efficiencies of
    K1'/walk (loop, sweep, node walk) beside the per-sample loop's loop
    efficiency, estimated from the frame's K4 tape (the schedule the
    refill replaced); the kernel's own device time beside its launch's for
    K1d and the taped K3 (a full tape: no sweep), and what the sphere rows
    the wrappers build each launch (``megakernel.sphere_rows``) take of
    it; ptxas's registers and spills of every walk instantiation ->
    {"warps", "ptxas"}."""
    from raytpu_torch import bvh as tbvh, golden
    from raytpu_torch.kernels import _build, gradkernel, megakernel
    from raytpu_torch.kernels import wavefront as kwf
    sp = megakernel.pack_scene(tbvh.permute_scene(scene, bvh.perm))
    cp = megakernel.pack_camera(cam)
    warps = megakernel.warp_census(cp, sp, cfg, bvh)
    # the tape holds permuted rows: their materials (a dummy's is 0)
    per_sample = per_sample_efficiency(
        frame_tape(scene, cam, cfg, bvh),
        tbvh.permute_scene(scene, bvh.perm).mat_type, cfg)
    # the kernel's own device time beside its launch's (the wrapper's
    # packing and the gaps between them included): the taped replay
    # sweeps no step of a full tape
    tape = torch.empty((cfg.spp * cfg.depth, cfg.height * cfg.width),
                       dtype=golden.tape_dtype(sp.shape[1]), device=dev)
    megakernel.launch(cp, sp, cfg, bvh, tape=tape)
    own = {}
    for key, kernel, fn in (
            ("K1d", "render_fwd_kernel", lambda: megakernel.launch(
                cp, sp, cfg, bvh)),
            ("K3/walk+tape", "render_vjp_kernel", lambda: gradkernel.launch(
                cp, sp, cfg, ct, img, 0.0, bvh, tape, p2_refill=False)),
            ("K3/walk+refill+tape", "render_vjp_refill_kernel",
             lambda: gradkernel.launch(cp, sp, cfg, ct, img, 0.0, bvh,
                                       tape))):
        own[key] = {"kernel_ms": kernel_ms(fn, kernel),
                    "launch_ms": cuda_ms(fn, 3)}
    del tape
    sphere_rows_ms = cuda_ms(lambda: megakernel.sphere_rows(sp), 20)
    ptxas = {**flat_ptxas(_build.build_log[megakernel.SOURCE]["ptxas"],
                          {k: v for k, v in WALK_KERNELS.items()
                           if v.startswith("render_fwd")}),
             **flat_ptxas(_build.build_log[kwf.SOURCE]["ptxas"],
                          {k: v for k, v in WALK_KERNELS.items()
                           if not v.startswith("render_fwd")}),
             **flat_ptxas(_build.build_log[gradkernel.SOURCE]["ptxas"],
                          {k: v for k, v in K3_KERNELS.items()
                           if "walk" in k})}
    ptxas["K1b/walk"] = ptxas.get("K1d")  # the same instantiation
    ok = (len([k for k in ptxas if ptxas[k]]) == 11
          and 0 < warps["walk_efficiency"] <= 1.0)
    phase("walk_redesign", ok=ok, card=card, frame="800x400 spp20 d12 "
          f"parallel, {scene.count} spheres, BVH leaf {LEAF}",
          warps=warps, per_sample_loop_estimate=per_sample, ptxas=ptxas,
          kernel_vs_launch=own, sphere_rows_ms=sphere_rows_ms)
    if not ok:
        fail(f"the walk's redesign phase: ptxas={ptxas}, warps={warps}")
    return {"warps": warps, "ptxas": ptxas}


def large_scene_phases(dev, card: str) -> dict:
    """Phases 7a-7g (see the module docstring) -> the kernel table's
    entries K1d, K1b/walk, K2/walk, K4/walk, K3/walk and K3/walk+tape,
    each with its launches on its main path."""
    import raytpu_torch as rt
    from raytpu_torch import (bvh as tbvh, golden, io, profiling,
                              progressive, scene_io, shard)
    from raytpu_torch.config import CONFIG4, RenderConfig
    from raytpu_torch.kernels import gradkernel, megakernel

    # raytpu's 10k protocol (scripts/probe_10k_r5.py)
    cfg = RenderConfig(width=800, height=400, spp=20, depth=12)
    cfgp = cfg.replace(rng_mode="parallel")
    npix = cfg.width * cfg.height
    tmp = tempfile.mkdtemp()
    try:
        path = os.path.join(tmp, "big_world_10k.json")
        scene_io.save_scene(path, rt.make_scene(big_world(BIG_SPHERES),
                                                "cpu"))
        scene = scene_io.load_scene(path, device=dev)
        cam = rt.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0,
                             aspect=cfg.aspect, device=dev)

        # -- 7a: the BVH, leaf 64: past the flat sweep's 64 leaves a copy
        rt.build_bvh(scene, leaf_size=LEAF)  # the native builder, warm
        t0 = time.perf_counter()
        bvh = rt.build_bvh(scene, leaf_size=LEAF)
        build_ms = (time.perf_counter() - t0) * 1e3
        sweep = tbvh.sweep_of(bvh)
        row = {"spheres": scene.count, "scene_file_bytes":
               os.path.getsize(path), "leaf_size": LEAF,
               "leaves_per_copy": bvh.n_leaves, "nodes_per_copy": bvh.n_trav,
               "outliers": bvh.n_outliers,
               "permuted_rows": int(bvh.perm.shape[0]),
               "built_by": bvh.built_by, "build_ms": build_ms,
               "sweep": sweep, "flat_max_leaves": tbvh.FLAT_MAX_LEAVES}
        ok = (bvh.n_leaves, bvh.n_trav, bvh.n_outliers, sweep) == (
            157, 313, 1, "walk")
        phase("large_scene_build", ok=ok, **row)
        if not ok:
            fail(f"the 10k scene's BVH is not the expected one: {row}")
        cp = megakernel.pack_camera(cam)
        spv = megakernel.pack_scene(tbvh.permute_scene(scene, bvh.perm))
        sp = megakernel.pack_scene(scene)
        n = spv.shape[1]
        flat = tbvh.with_sweep(bvh, "flat")  # K1c / K3/bvh forced

        # -- 7b: each walk kernel against its plain version
        entries = walk_vs_plain(scene, cam, cfg, bvh, card)
        k1d_err = entries["K1d"]["max_abs_err"]
        # and on config 4's unpadded BVH (one copy, variable leaves)
        s4 = rt.final_world(device=dev)
        c4p = CONFIG4.replace(spp=2, rng_mode="parallel",
                              chunk_pixels=FRAME_CHUNK)
        loose = rt.build_bvh(s4, pad_leaves=False)
        cam4 = rt.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0,
                              aspect=CONFIG4.aspect, device=dev)
        cp4 = megakernel.pack_camera(cam4)
        sp4 = megakernel.pack_scene(tbvh.permute_scene(s4, loose.perm))
        same = {}
        for c in (c4p, c4p.replace(rng_mode="sequential")):
            got = megakernel.launch(cp4, sp4, c, loose)
            want = golden.render_golden(s4, cam4, c, loose)
            same[c.rng_mode] = torch.equal(got, want)
            k1d_err = max(k1d_err, float((got - want).abs().max()))
        ok = all(same.values())
        phase("k1d_unpadded_vs_plain", frame="800x400 spp2 d12, "
              "final_world() unpadded (leaf 64)", ok=ok,
              nodes=loose.n_trav, copies=loose.copies, bit_equal=same,
              census=slab_census(s4, cam4, c4p, loose), card=card)
        if not ok:
            fail("K1d on an unpadded BVH disagrees with its plain version")
        entries["K1d"]["max_abs_err"] = k1d_err
        del got, want

        # -- 7c: against the other sweeps at the full frame
        gen = torch.Generator().manual_seed(13)
        target = torch.rand((cfg.height, cfg.width, 3), generator=gen).to(dev)
        band = (0.45, 0.75)  # mean (plain version, 80x40 2 spp: 0.60)
        k2_launches = 0
        for c in (cfgp, cfg):
            k1d = megakernel.launch(cp, spv, c, bvh)
            k1c = megakernel.launch(cp, spv, c, flat)
            k1a = megakernel.launch(cp, sp, c)
            ct = 2.0 * (k1d - target) / k1d.numel()
            img_in = k1d if c.rng_mode == "parallel" else None
            kw = gradkernel.launch(cp, spv, c, ct, img_in, 0.0, bvh)
            kf = gradkernel.launch(cp, spv, c, ct, img_in, 0.0, flat)
            reset_counts(megakernel, gradkernel)
            st, img_p = None, None
            for st, img_p in progressive.render_progressive(
                    scene, cam, c, batch=5, bvh=bvh):
                pass
            torch.cuda.synchronize()
            k2_launches += megakernel.variants["K2/walk"]
            rel = k3_sums_rel(k3_sums(kw), k3_sums(kf), n)
            r = {"k1d_vs_k1c_pixels_differ": int((k1d != k1c).any(-1).sum()),
                 "k1d_vs_k1a_pixels_differ": int((k1d != k1a).any(-1).sum()),
                 "k3_walk_img_bit_equal_k1d": torch.equal(kw[0], k1d),
                 "k3_walk_vs_flat_sums_rel": rel,
                 "progressive_batches": st.samples // 5,
                 "progressive_launches": dict(
                     variant_counts(megakernel, gradkernel)),
                 "progressive_bit_equal_one_shot": torch.equal(img_p, k1d),
                 "progressive_max_abs": float((img_p - k1d).abs().max()),
                 "mean": float(k1d.mean())}
            ok = (r["k1d_vs_k1c_pixels_differ"] <= TIE_SHARE * npix
                  and r["k1d_vs_k1a_pixels_differ"] <= TIE_SHARE * npix
                  and r["k3_walk_img_bit_equal_k1d"]
                  and max(rel.values()) <= 1e-9
                  and r["progressive_launches"] == {"K2/walk": 4}
                  and r["progressive_max_abs"] <= 2e-7
                  and bool(torch.isfinite(k1d).all())
                  and band[0] <= r["mean"] <= band[1])
            phase("walk_vs_sweeps", frame=f"800x400 spp20 d12 {c.rng_mode}, "
                  f"{scene.count} spheres", ok=ok, card=card,
                  allowed_exact_t_ties=int(TIE_SHARE * npix),
                  tolerance="K1d vs K1c and K1a: pixels differ <= TIE_SHARE; "
                            "K3 sums within 1e-9 of each leaf's largest; "
                            "progressive image within 2e-7 (the gamma "
                            "epilogue, as phase 6a)", **r)
            if not ok:
                fail(f"the walk disagrees with the other sweeps "
                     f"({c.rng_mode}): {r}")
            del k1d, k1c, k1a, kw, kf, img_p, st

        # -- 7d: the main path through the entry points
        launches = {}
        reset_counts(megakernel, gradkernel)
        img = rt.render(scene, cam, cfgp, bvh=bvh)
        torch.cuda.synchronize()
        launches["render"] = variant_counts(megakernel, gradkernel)
        reset_counts(megakernel, gradkernel)
        sharded = shard.render_sharded(scene, cam, cfgp, bvh=bvh)
        torch.cuda.synchronize()
        launches["render_sharded"] = variant_counts(megakernel, gradkernel)
        runs, k3_calls = {}, []
        for label, c in (("parallel", cfgp), ("sequential", cfg)):
            reset_counts(megakernel, gradkernel)
            with recording(gradkernel, "launch",
                           k3_calls if label == "parallel" else []):
                runs[label] = rt.render_grad(scene, cam, c, target, bvh=bvh)
            torch.cuda.synchronize()
            launches[label] = variant_counts(megakernel, gradkernel)
        # the taped render_grad's K3 sums against K3/walk untaped on the
        # same operands (its cotangent and forward image), both f64
        (k3_args, taped), = k3_calls
        k3_args.arguments["tape"] = None
        untaped = gradkernel.launch(*k3_args.args, **k3_args.kwargs)
        taped_rel = k3_sums_rel(k3_sums(untaped), k3_sums(taped), n)
        taped_img_equal = torch.equal(untaped[0], taped[0])
        del k3_calls, k3_args, taped, untaped
        # parallel RNG untaped (a tape that does not fit its budget) and
        # on K3's per-sample pass
        budget = gradkernel.TAPE_BUDGET
        for label in ("parallel_untaped", "parallel_per_sample"):
            reset_counts(megakernel, gradkernel)
            try:
                if label == "parallel_untaped":
                    gradkernel.TAPE_BUDGET = 0
                with (per_sample() if label == "parallel_per_sample"
                      else contextlib.nullcontext()):
                    runs[label] = rt.render_grad(scene, cam, cfgp, target,
                                                 bvh=bvh)
            finally:
                gradkernel.TAPE_BUDGET = budget
            torch.cuda.synchronize()
            launches[label] = variant_counts(megakernel, gradkernel)
        sched_rel = {}
        for label in ("parallel_untaped", "parallel_per_sample"):
            rel, _ = leaf_errors((None, *runs[label][2]),
                                 (None, *runs["parallel"][2]),
                                 rt.Camera._fields)
            sched_rel[label] = max(rel.values())
        want_launches = {"render": {"K1d": 1}, "render_sharded": {
            "K1b/walk": 1}, "parallel": {"K4/walk": 1,
                                         "K3/walk+refill+tape": 1},
            "sequential": {"K1d": 1, "K3/walk": 1},
            "parallel_untaped": {"K1d": 1, "K3/walk+refill": 1},
            "parallel_per_sample": {"K4/walk": 1, "K3/walk+tape": 1}}
        finite = {k: all(bool(torch.isfinite(g).all()) for g in
                         flat_grads((r[1], *r[2]))) for k, r in runs.items()}
        log = os.path.join(tmp, "runs.jsonl")
        png = os.path.join(tmp, "big.png")
        cmd = [sys.executable, "-m", "raytpu_torch.cli", "render",
               "--scene-file", path, "--bvh", "--width", str(cfg.width),
               "--height", str(cfg.height), "--spp", str(cfg.spp),
               "--depth", str(cfg.depth), "--rng-mode", "parallel",
               "--device", "cuda", "--log", log, "--out", png]
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            fail(f"CLI --scene-file exited {proc.returncode}: "
                 f"{proc.stderr[-2000:]}")
        ref = os.path.join(tmp, "in_process.png")
        io.save_png(ref, img.cpu().numpy())
        with open(png, "rb") as f, open(ref, "rb") as g:
            same = f.read() == g.read()
        with open(log) as f:
            logged = [json.loads(x) for x in f.read().splitlines()]
        row = {"launches": launches, "grads_finite": finite,
               "losses": {k: float(r[0]) for k, r in runs.items()},
               "render_sharded_bit_equal_render": torch.equal(sharded, img),
               "render_grad_img_bit_equal_render": torch.equal(
                   runs["parallel"][1], img),
               "render_grad_taped_k3_vs_untaped_sums_rel": taped_rel,
               "render_grad_taped_k3_img_bit_equal_untaped": taped_img_equal,
               "refill_taped_vs_others_rel": sched_rel,
               "cli_png_identical_to_render": same, "cli_log": logged,
               "cli_stdout": proc.stdout.strip(),
               "command": " ".join(cmd[1:]).replace(tmp, "<tmp>")}
        ok = (launches == want_launches and all(finite.values()) and same
              and row["render_sharded_bit_equal_render"]
              and row["render_grad_img_bit_equal_render"]
              and max(taped_rel.values()) <= 1e-9 and taped_img_equal
              and max(sched_rel.values()) <= REFILL_TOL
              and len(logged) == 1
              and logged[0]["device"] == torch.cuda.get_device_name(0)
              and logged[0]["sweep"] == "walk")
        phase("main_path_10k", frame="800x400 spp20 d12", ok=ok, card=card,
              spheres=scene.count, **row)
        if not ok:
            fail(f"the 10k main path: {row}")
        entries["K1d"]["launches"] = (launches["render"]["K1d"]
                                      + launches["sequential"]["K1d"])
        entries["K1b/walk"]["launches"] = launches["render_sharded"][
            "K1b/walk"]
        entries["K2/walk"]["launches"] = k2_launches
        entries["K4/walk"]["launches"] = launches["parallel"]["K4/walk"]
        entries["K3/walk"]["launches"] = launches["sequential"]["K3/walk"]
        entries["K3/walk+tape"]["launches"] = launches["parallel_per_sample"][
            "K3/walk+tape"]
        entries["K3/walk+refill+tape"]["launches"] = launches["parallel"][
            "K3/walk+refill+tape"]
        entries["K3/walk+refill"]["launches"] = launches["parallel_untaped"][
            "K3/walk+refill"]
        del runs, sharded

        # -- 7e: the tools
        cmd = [sys.executable, "-m", "raytpu_torch.cli", "validate",
               "--scene-file", path, "--bvh", "--device", "cuda"]
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=600)
        try:
            rep = json.loads(proc.stdout.strip().splitlines()[-1])
        except (IndexError, json.JSONDecodeError):
            rep = {}
        info = subprocess.run([sys.executable, "-m", "raytpu_torch.cli",
                               "info"], cwd=ROOT, capture_output=True,
                              text=True, timeout=300)
        try:
            info_rep = json.loads(info.stdout.strip().splitlines()[-1])
        except (IndexError, json.JSONDecodeError):
            info_rep = {}
        ok = (proc.returncode == 0 and rep.get("kernel_bit_identical") is True
              and rep.get("sweep") == "walk" and info.returncode == 0
              and info_rep.get("platform") == "gpu"
              and info_rep.get("device_kind") == torch.cuda.get_device_name(0))
        phase("tools", ok=ok, validate_rc=proc.returncode,
              validate=rep, info_rc=info.returncode, info=info_rep,
              command=" ".join(cmd[1:]).replace(tmp, "<tmp>"))
        if not ok:
            fail(f"cli validate / info on the card: {proc.stderr[-2000:]} "
                 f"{info.stderr[-1000:]}")

        # -- 7f: times at the full frame (CUDA events, after a warm-up)
        c20p = slab_census(scene, cam, cfgp, bvh)
        c20 = slab_census(scene, cam, cfg, bvh)
        c20f = slab_census(scene, cam, cfgp, flat)
        c20b = slab_census(scene, cam, cfgp, None)
        t = {"card": card}
        t["k1d_ms"] = cuda_ms(lambda: megakernel.launch(cp, spv, cfgp, bvh),
                              3)
        t["k1d_profiler_ms"] = profiling.device_ms(
            lambda: megakernel.launch(cp, spv, cfgp, bvh))
        t["k1c_forced_ms"] = cuda_ms(lambda: megakernel.launch(
            cp, spv, cfgp, flat), 3)
        t["k1a_ms"] = cuda_ms(lambda: megakernel.launch(cp, sp, cfgp), 2)
        t["k1b_walk_ms"] = cuda_ms(lambda: megakernel.launch(
            cp, spv, cfgp, bvh, row0=0, rows=cfg.height), 3)
        budget = gradkernel.TAPE_BUDGET
        try:
            gradkernel.TAPE_BUDGET = 0  # untaped
            t["fwd_bwd_untaped_ms"] = cuda_ms(lambda: rt.render_grad(
                scene, cam, cfgp, target, bvh=bvh), 2)
        finally:
            gradkernel.TAPE_BUDGET = budget
        t["fwd_bwd_taped_ms"] = cuda_ms(lambda: rt.render_grad(
            scene, cam, cfgp, target, bvh=bvh), 2)
        t["fwd_bwd_sequential_ms"] = cuda_ms(lambda: rt.render_grad(
            scene, cam, cfg, target, bvh=bvh), 2)
        g = cfg.spp * cfg.depth
        tape = torch.empty((g, npix), dtype=golden.tape_dtype(n), device=dev)
        img_t = megakernel.launch(cp, spv, cfgp, bvh, tape=tape)
        ct = 2.0 * (img_t - target) / img_t.numel()
        t["k4_walk_ms"] = cuda_ms(lambda: megakernel.launch(
            cp, spv, cfgp, bvh, tape=tape), 3)
        t["k3_walk_tape_ms"] = cuda_ms(lambda: gradkernel.launch(
            cp, spv, cfgp, ct, img_t, 0.0, bvh, tape, p2_refill=False), 3)
        t["k3_walk_refill_tape_ms"] = cuda_ms(lambda: gradkernel.launch(
            cp, spv, cfgp, ct, img_t, 0.0, bvh, tape), 3)
        t["k3_walk_refill_ms"] = cuda_ms(lambda: gradkernel.launch(
            cp, spv, cfgp, ct, img_t, 0.0, bvh), 3)
        t["k3_walk_seq_ms"] = cuda_ms(lambda: gradkernel.launch(
            cp, spv, cfg, ct, None, 0.0, bvh), 2)
        init = progressive.init_state(cfgp, device=dev)
        bits = megakernel._u32_bits(init.seed).contiguous()
        t["k2_walk_batch5_ms"] = cuda_ms(lambda: megakernel.launch_accumulate(
            cp, spv, cfgp, init.acc, bits, 0, 5, bvh), 3)
        rays = npix * cfg.spp
        t["k1d_mrays_s"] = rays / t["k1d_ms"] / 1e3
        t["fwd_bwd_taped_mrays_s"] = rays / t["fwd_bwd_taped_ms"] / 1e3
        t["census_walk"] = c20p
        t["nodes_per_step"] = c20p["nodes_visited"] / c20p["bounce_steps"]
        t["leaves_per_step"] = c20p["leaves_entered"] / c20p["bounce_steps"]
        t["census_flat_forced"] = c20f
        t["k1c_forced_stage"] = stage_info(flat, dev)
        t.update(bound_k1d_ms=bound(forward_ops(c20p), 0)["bound_ms"],
                 bound_k1c_forced_ms=bound(forward_ops(c20f), 0)["bound_ms"],
                 bound_k1a_ms=bound(forward_ops(c20b), 0)["bound_ms"])
        # where raytpu's 64-leaf rule stands on this card: the walk forced
        # on config 4's BVH (8 leaves a copy, the flat sweep by the rule)
        b4 = rt.build_bvh(s4, leaf_size=LEAF)
        c4 = CONFIG4.replace(rng_mode="parallel")
        spv4 = megakernel.pack_scene(tbvh.permute_scene(s4, b4.perm))
        cp4f = megakernel.pack_camera(cam4)
        ka = megakernel.launch(cp4f, spv4, c4, b4)
        b4w = tbvh.with_sweep(b4, "walk")
        kb = megakernel.launch(cp4f, spv4, c4, b4w)
        t["config4_leaves"] = b4.n_leaves
        t["config4_walk_bit_equal_flat"] = torch.equal(ka, kb)
        t["config4_k1c_ms"] = cuda_ms(lambda: megakernel.launch(
            cp4f, spv4, c4, b4), 3)
        t["config4_k1d_forced_ms"] = cuda_ms(lambda: megakernel.launch(
            cp4f, spv4, c4, b4w), 3)
        # end to end: render(), the progressive frame in 4 batches of 5
        t["render_ms"] = cuda_ms(lambda: rt.render(scene, cam, cfgp,
                                                   bvh=bvh), 3)

        def progressive_frame():
            for _ in progressive.render_progressive(scene, cam, cfgp,
                                                    batch=5, bvh=bvh):
                pass
        t["progressive_frame_ms"] = cuda_ms(progressive_frame, 2)
        phase("timing_10k", frame="800x400 spp20 d12 parallel (sequential "
              "where named)", **t)
        if not t["config4_walk_bit_equal_flat"]:
            fail("the walk forced on config 4's BVH differs from K1c")
        walk = walk_phase(dev, card, scene, cam, cfgp, bvh, img_t, ct)
        del tape, img_t

        # the table's main-path times and bounds (full frame, 20 spp)
        nb = bvh.nodes.numel() * 4
        fwd = frame_bytes(cfgp, n, 1) + nb
        tbytes = c20p["bounce_steps"] * golden.tape_dtype(n).itemsize
        main = {
            "K1d": (t["k1d_ms"], bound(forward_ops(c20p), fwd)),
            "K1b/walk": (t["k1b_walk_ms"], bound(forward_ops(c20p), fwd)),
            "K2/walk": (t["k2_walk_batch5_ms"], bound(
                forward_ops(c20p) / 4, frame_bytes(cfgp, n, 0) + nb
                + state_bytes(cfgp, cfg.height))),
            "K4/walk": (t["k4_walk_ms"], bound(forward_ops(c20p),
                                               fwd + tbytes)),
            "K3/walk": (t["k3_walk_seq_ms"], bound(
                k3_ops(c20, 2), frame_bytes(cfg, n, 2) + nb + 8 * 8 * n)),
            "K3/walk+tape": (t["k3_walk_tape_ms"], bound(
                k3_ops(c20p, 1, c20p["bounce_steps"]),
                frame_bytes(cfgp, n, 3) + nb + tbytes + 8 * 8 * n)),
            "K3/walk+refill+tape": (t["k3_walk_refill_tape_ms"], bound(
                k3_ops(c20p, 1, c20p["bounce_steps"]),
                frame_bytes(cfgp, n, 3) + nb + tbytes + 8 * 8 * n)),
            "K3/walk+refill": (t["k3_walk_refill_ms"], bound(
                k3_ops(c20p, 1), frame_bytes(cfgp, n, 3) + nb + 8 * 8 * n))}
        for key, (ms, b) in main.items():
            entries[key].update(main_path_ms=ms,
                                main_path_bound_ms=b["bound_ms"],
                                main_path_bound_by=b["bound_by"])
        # counted by K1'/walk on K1d's own frame; the other rows' launches
        # were not counted
        entries["K1d"].update(
            {k: walk["warps"][k] for k in ("loop_efficiency",
                                           "sweep_efficiency",
                                           "walk_efficiency")},
            efficiency_cell="800x400 spp20 d12 parallel, K1'/walk")
        for key in ("K1d", "K1b/walk", "K2/walk", "K4/walk", "K3/walk",
                    "K3/walk+tape", "K3/walk+refill", "K3/walk+refill+tape"):
            entries[key].update(registers=walk["ptxas"][key]["registers"])
        return entries
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# Phase 8: the sorted wavefront (K5, K6) and the dense stage K1e
# the planes a launch reads and writes, bytes a slot: K5 14 in, 14 + the
# key out; K6 16 ride + 3 aux in, 16 out
PLANE_BYTES = {"K5": (14 + 15) * 4, "K6": (16 + 3 + 16) * 4}
SEED_PLANE = {"K5": 13, "K6": 12}  # the u32 bits, compared bit for bit


def planes_vs_plain(kernel: str, got: torch.Tensor,
                    want: torch.Tensor) -> tuple[bool, float]:
    """(bit-equal, max |d| over the float planes) of a segment kernel's
    planes against its plain version's; the seed plane compares bits."""
    i = SEED_PLANE[kernel]
    bits = torch.equal(got[i].view(torch.int32), want[i].view(torch.int32))
    rest = [k for k in range(got.shape[0]) if k != i]
    a, b = got[rest], want[rest]
    same = bits and bool((a == b).all())
    return same, float((a - b).abs().max())


def ten_k_frame():
    """The 10k scene's wavefront frame: 800x400, 20 spp, depth 12, parallel
    RNG."""
    from raytpu_torch.config import RenderConfig
    return RenderConfig(width=800, height=400, spp=20, depth=12,
                        rng_mode="parallel")


def wavefront_scenes(dev) -> dict:
    """The wavefront's scenes by the policy each takes -> {policy: (scene,
    camera, bvh)}: config 2's 4 spheres ("brute"), REFERENCE_V2's 327
    ("dense"), config 4's 500 over its flat BVH ("bvh"), the 10k scene over
    its walk ("walk", config 4's camera) and PACK_SPHERES spheres ("pack",
    the brute sweep's pack instantiations, config 2's camera)."""
    import raytpu_torch as rt
    from raytpu_torch import bvh as tbvh
    from raytpu_torch.config import CONFIG2, CONFIG4, REFERENCE_V2
    cam2 = rt.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0,
                          aspect=CONFIG2.aspect, device=dev)
    cam4 = rt.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0,
                          aspect=CONFIG4.aspect, device=dev)
    s4 = rt.final_world(device=dev)
    b4 = rt.build_bvh(s4, leaf_size=LEAF)
    s10 = rt.make_scene(big_world(BIG_SPHERES), dev)
    b10 = rt.build_bvh(s10, leaf_size=LEAF)
    if (tbvh.sweep_of(b4), tbvh.sweep_of(b10)) != ("flat", "walk"):
        fail("config 4's BVH must take the flat sweep, the 10k scene's the "
             "walk")
    return {"brute": (rt.config2_world(device=dev), cam2, None),
            "dense": (rt.random_world(device=dev), rt.reference_camera_v2(
                REFERENCE_V2.aspect, device=dev), None),
            "bvh": (s4, cam4, b4), "walk": (s10, cam4, b10),
            "pack": (spheres_scene(PACK_SPHERES, dev), cam2, None)}


def segment_cases() -> tuple:
    """Phase 8b's cases, (scene's policy, frame, RNG mode, refill): K5 and
    K6 (``refill=2``) under every policy at its main path's full frame
    (:func:`wavefront_runs`), K5 in the other RNG mode at a frame a few
    hundred pixels wide, and both over the pack.  Run at 2 spp: the slots
    do not depend on spp."""
    from raytpu_torch.config import CONFIG2, CONFIG4, REFERENCE_V2
    seq, par = "sequential", "parallel"
    c10, small = ten_k_frame(), CONFIG2.replace(width=200, height=100)
    return (("brute", CONFIG2, seq, 0), ("brute", CONFIG2, par, 2),
            ("dense", REFERENCE_V2, seq, 0), ("dense", REFERENCE_V2, par, 2),
            ("bvh", CONFIG4, seq, 0), ("bvh", CONFIG4, par, 2),
            ("walk", c10, par, 0), ("walk", c10, par, 2),
            ("brute", small, par, 0),
            ("dense", REFERENCE_V2.replace(width=256, height=144), par, 0),
            ("bvh", CONFIG4.replace(width=200, height=100), par, 0),
            ("walk", c10.replace(width=128, height=64), seq, 0),
            ("pack", small, seq, 0), ("pack", small, par, 2))


def wavefront_runs() -> tuple:
    """Phases 8c's and 8d's main paths at full width, (name, scene's
    policy, frame, ``render()`` options): REFERENCE_V2, config 2, config 4
    (sequential RNG; parallel with ``refill=2`` at 1 and 4 samples in
    flight) and the 10k scene, each policy also with ``refill=2``."""
    from raytpu_torch.config import CONFIG2, CONFIG4, REFERENCE_V2
    par, c10 = "parallel", ten_k_frame()
    r2 = {"refill": 2}
    return (("reference_v2", "dense", REFERENCE_V2, {}),
            ("config2", "brute", CONFIG2, {}),
            ("config4", "bvh", CONFIG4, {}),
            ("config4_refill2", "bvh", CONFIG4.replace(rng_mode=par), r2),
            ("config4_refill2_spp_batch4", "bvh",
             CONFIG4.replace(rng_mode=par), {"refill": 2, "spp_batch": 4}),
            ("10k", "walk", c10, {}),
            ("config2_refill2", "brute", CONFIG2.replace(rng_mode=par), r2),
            ("reference_v2_refill2", "dense",
             REFERENCE_V2.replace(rng_mode=par), r2),
            ("10k_refill2", "walk", c10, r2))


def segment_launches(scene, cam, cfg, bvh, refill: int):
    """One ``render(backend="wavefront")`` frame with its K5 (or, with
    ``refill``, K6) launches recorded -> (image, the wrapper, [(bound
    arguments, planes out), ...])."""
    import raytpu_torch as rt
    from raytpu_torch.kernels import wavefront as kwf
    name = "launch_refill_segment" if refill else "launch_segment"
    calls = []
    with recording(kwf, name, calls):
        img = rt.render(scene, cam, cfg, backend="wavefront", bvh=bvh,
                        refill=refill)
    torch.cuda.synchronize()
    return img, getattr(kwf, name), calls


def segments_vs_plain(label, scene, cam, cfg, bvh, refill: int,
                      card: str, by_segment: bool = False) -> dict:
    """Phase 8b, one case: every K5 (or, with ``refill``, K6) launch of
    ``render(backend="wavefront")`` against its plain version on the same
    planes; the image against ``render()``'s -> a row with the launches'
    summed kernel and plain times and their bound (the frame's census, the
    planes' bytes).  ``by_segment`` (K5 under the dense stage): the
    launches' times also summed by segment (``n_bounces``)."""
    import raytpu_torch as rt
    from raytpu_torch import profiling, wavefront as wf
    kernel = "K6" if refill else "K5"
    plain = wf.refill_segment_plain if refill else wf.segment_plain
    img, fn, calls = segment_launches(scene, cam, cfg, bvh, refill)
    ref = rt.render(scene, cam, cfg, bvh=bvh)
    same, worst, k_ms, p_ms, by = True, 0.0, 0.0, 0.0, {}
    for b, out in calls:
        want, ms = once_ms(lambda: plain(*b.args))
        eq, err = planes_vs_plain(kernel, out, want)
        same, worst, p_ms = same and eq, max(worst, err), p_ms + ms
        ms = cuda_ms(lambda: fn(*b.args), 2)
        k_ms += ms
        if by_segment:
            by[str(b.args[3])] = by.get(str(b.args[3]), 0.0) + ms
        del want
    c = profiling.census(scene, cam, cfg, bvh)
    slots = calls[0][0].args[1].shape[1]
    ops = (c["sphere_tests"] * OPS_SPHERE_TEST + c["box_tests"] * OPS_BOX_TEST
           + c["bounce_steps"] * OPS_STEP
           + (c["samples"] * OPS_SAMPLE if refill else 0))
    nbytes = (len(calls) * slots * PLANE_BYTES[kernel] + 9 * 4 * scene.count
              + (0 if bvh is None else max(bvh.nodes.numel(),
                                           bvh.flat.numel()) * 4))
    row = {"case": label, "kernel": kernel, "frame": f"{cfg.width}x"
           f"{cfg.height} spp{cfg.spp} d{cfg.depth} {cfg.rng_mode}",
           "policy": calls[0][0].args[0].policy, "launches": len(calls),
           "slots": slots, "bit_equal_plain": same, "max_abs_err": worst,
           "image_bit_equal_render": torch.equal(img, ref), "ms": k_ms,
           "plain_ms": p_ms, "card": card, **bound(ops, nbytes)}
    if by:
        row["ms_by_segment"] = by
    ok = same and row["image_bit_equal_render"]
    phase("segment_vs_plain", ok=ok, tolerance="bit-equal planes and keys "
          "(the seed plane's bits); image bit-equal to render()", **row)
    if not ok:
        fail(f"{kernel} disagrees with its plain version ({label}): {row}")
    del calls
    return row


def wavefront_breakdown(fn) -> dict:
    """Where one wavefront frame's device time goes, from a torch.profiler
    trace of ``fn()``: the segment kernels, the sorts (torch.sort's radix
    kernels), the gathers and scatters of the planes, the rest (raygen,
    keys' bounds, gamma: elementwise kernels); the traced call's wall time
    and the device's idle share of it.  Only the device is traced: host
    tracing slowed a REFERENCE_V2 frame 2.8x, so the share would measure
    the profiler; what is left of its cost still makes the share an upper
    bound on the untraced frame's."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    parts = {"segments_ms": 0.0, "sorts_ms": 0.0, "gathers_ms": 0.0,
             "other_ms": 0.0}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms, k = e.self_device_time_total / 1e3, e.key.lower()
        if "segment_kernel" in k or "refill_kernel" in k:
            parts["segments_ms"] += ms
        elif "sort" in k or "radix" in k or "scan" in k:
            parts["sorts_ms"] += ms
        elif "index" in k or "gather" in k or "scatter" in k:
            parts["gathers_ms"] += ms
        else:
            parts["other_ms"] += ms
    busy = sum(parts.values())
    if busy <= 0:
        fail("the profiler saw no device time in a wavefront frame")
    return dict(parts, device_ms=busy, traced_wall_ms=wall,
                idle_share=1.0 - busy / wall)


def frame_times(scenes: dict, runs, engines=("wavefront", "megakernel"),
                **t) -> dict:
    """Phase 8d: each of ``runs`` (:func:`wavefront_runs`) through each of
    ``engines`` (``render(backend="wavefront")`` with the run's options;
    ``render()``), the mean of TIMED_FRAMES calls after a warm-up with each
    call's time, the wavefront's over the megakernel's; then where a traced
    wavefront frame's device time goes (:func:`wavefront_breakdown`; one
    sample in flight) -> ``t`` with those entries."""
    import raytpu_torch as rt
    for label, policy, c, kw in runs:
        scene, cam, b = scenes[policy]
        for engine in engines:
            extra = dict(backend="wavefront", **kw) \
                if engine == "wavefront" else {}
            each = cuda_ms_each(lambda: rt.render(scene, cam, c, bvh=b,
                                                  **extra), TIMED_FRAMES)
            t[f"{label}_{engine}_ms"] = sum(each) / TIMED_FRAMES
            t[f"{label}_{engine}_ms_each"] = each
        if "megakernel" in engines:
            t[f"{label}_ratio"] = (t[f"{label}_wavefront_ms"]
                                   / t[f"{label}_megakernel_ms"])
    for label, policy, c, kw in runs:
        if "spp_batch" in kw:
            continue
        scene, cam, b = scenes[policy]
        t[f"{label}_breakdown"] = wavefront_breakdown(lambda: rt.render(
            scene, cam, c, backend="wavefront", bvh=b, **kw))
    return t


def wavefront_phases(dev, card: str, rv2_img: torch.Tensor) -> dict:
    """Phases 8a-8d (see the module docstring) -> the kernel table's
    entries K1e, K5/{brute,dense,bvh,walk} and K6/{brute,dense,bvh,walk},
    each with its launches on its main path.  ``rv2_img``: phase 3's
    REFERENCE_V2 render()."""
    import raytpu_torch as rt
    from raytpu_torch import golden, io
    from raytpu_torch.config import CONFIG2, CONFIG4, REFERENCE_V2
    from raytpu_torch.kernels import _build, gradkernel, megakernel
    from raytpu_torch.kernels import wavefront as kwf
    mods = (megakernel, gradkernel, kwf)
    entries = {}
    scenes = wavefront_scenes(dev)

    # -- 8a: K1e (the brute sweep's kernel) against phase 3's render() and
    # its plain version, REFERENCE_V2
    cfg = REFERENCE_V2
    rv2, cam_rv2, _ = scenes["dense"]
    cp, sp = megakernel.pack_camera(cam_rv2), megakernel.pack_scene(rv2)
    k1e = megakernel.launch(cp, sp, cfg)
    cfg2 = cfg.replace(spp=2, chunk_pixels=PLAIN_CHUNK)
    k1e2 = megakernel.launch(cp, sp, cfg2)
    want, plain_ms = once_ms(lambda: golden.render_golden(rv2, cam_rv2,
                                                          cfg2))
    res = compare(k1e2, want)
    t = {"k1e_ms": cuda_ms(lambda: megakernel.launch(cp, sp, cfg), 3),
         "k1e_spp2_ms": cuda_ms(lambda: megakernel.launch(cp, sp, cfg2), 5)}
    c2, cf = slab_census(rv2, cam_rv2, cfg2, None), \
        slab_census(rv2, cam_rv2, cfg, None)
    # the warps of the dense stage's refill (its census kernel, K1'/dense)
    # and an estimate, from the frame's tape, of the per-sample loop's
    warps = megakernel.warp_census(cp, sp, cfg, None)
    before = per_sample_efficiency(frame_tape(rv2, cam_rv2, cfg),
                                   rv2.mat_type, cfg)
    # the launch's tail: the same samples over 4x the pixels (the aspect
    # and camera unchanged), 4x the pixels a thread of the persistent grid
    wide = megakernel.warp_census(cp, sp, cfg.replace(
        width=2 * cfg.width, height=2 * cfg.height, spp=cfg.spp // 4), None)
    counted = ("leaves_entered", "bounce_steps", "samples")
    row = {"k1e_bit_equal_render": torch.equal(k1e, rv2_img), **res,
        "plain_ms": plain_ms, "card": card, **t,
        "bound_full_ms": bound(forward_ops(cf), frame_bytes(cfg, rv2.count,
                                                            1))["bound_ms"],
        "warp_census": warps, "per_sample_loop": before,
        "warp_census_4x_pixels_quarter_spp": wide,
        "ptxas": {**flat_ptxas(_build.build_log[megakernel.SOURCE]["ptxas"],
                               DENSE_KERNELS),
                  **flat_ptxas(_build.build_log[kwf.SOURCE]["ptxas"],
                               DENSE_KERNELS)},
        "census_equal_k1_brute": all(warps[k] == cf[k] for k in counted)
        and before["bounce_steps"] == cf["bounce_steps"]}
    ok = (row["k1e_bit_equal_render"] and row["census_equal_k1_brute"]
          and res["share_above_budget"] <= BUDGET_SHARE)
    phase("k1e_vs_plain", frame="1024x576 spp60 d50 random_world (plain: "
          "spp2)", ok=ok, tolerance="bit-equal to phase 3's render(); "
          f"plain: share |d| > {BUDGET_DELTA} <= {BUDGET_SHARE}; K1'/dense's "
          "and the tape's counts equal K1'/brute's", **row)
    if not ok:
        fail(f"K1e disagrees with render() or its plain version: {row}")
    entries["K1e"] = dict(
        max_abs_err=res["max_abs_err"], ms=t["k1e_spp2_ms"],
        plain_ms=plain_ms,
        **bound(forward_ops(c2), frame_bytes(cfg2, rv2.count, 1)),
        main_path_ms=t["k1e_ms"],
        main_path_bound_ms=row["bound_full_ms"],
        loop_efficiency=warps["loop_efficiency"],
        sweep_efficiency=warps["sweep_efficiency"],
        efficiency_cell="REFERENCE_V2, the main path's frame")
    del k1e, k1e2, want

    # -- 8b: K5 and K6 against their plain versions, launch by launch
    seg_rows = {}
    for policy, c, mode, refill in segment_cases():
        scene, cam, b = scenes[policy]
        cm = c.replace(spp=2, rng_mode=mode, chunk_pixels=PLAIN_CHUNK)
        seg_rows[(policy, mode, refill)] = segments_vs_plain(
            policy, scene, cam, cm, b, refill, card,
            by_segment=policy == "dense" and c is cfg and not refill)

    # -- 8c: the main path at full width, through the entry points
    runs = wavefront_runs()
    launches, main, frames = {}, {}, {}
    for label, policy, c, kw in runs:
        scene, cam, b = scenes[policy]
        reset_counts(*mods)
        img = rt.render(scene, cam, c, backend="wavefront", bvh=b, **kw)
        torch.cuda.synchronize()
        launches[label] = variant_counts(*mods)
        ref = rv2_img if label == "reference_v2" else rt.render(
            scene, cam, c, bvh=b)
        d = float((img - ref).abs().max())
        main[label] = {"bit_equal_render": torch.equal(img, ref),
                       "max_abs_vs_render": d, "mean": float(img.mean()),
                       "finite": bool(torch.isfinite(img).all())}
        frames[label] = img
    # render_grad through the wavefront backend: the kernel path (K3, on
    # its windowed refill in parallel RNG), against render_grad's
    s4, cam4, b4 = scenes["bvh"]
    cfg4, cfg4p = CONFIG4, CONFIG4.replace(rng_mode="parallel")
    gen = torch.Generator().manual_seed(7)
    target = torch.rand((cfg4.height, cfg4.width, 3), generator=gen).to(dev)
    rg_rel, rg_img_equal, grad_rel = {}, {}, {}
    for label, c in (("render_grad", cfg4), ("render_grad_parallel", cfg4p)):
        reset_counts(*mods)
        got = rt.render_grad(s4, cam4, c, target, backend="wavefront",
                             bvh=b4)
        torch.cuda.synchronize()
        launches[label] = variant_counts(*mods)
        want = rt.render_grad(s4, cam4, c, target, bvh=b4)
        # the same kernels twice: K3's f64 atomics add in no fixed order
        rg_rel[label] = max(
            float((a - b).abs().max()) / max(float(b.abs().max()), 1e-12)
            for a, b in zip(flat_grads((got[1], *got[2])),
                            flat_grads((want[1], *want[2]))))
        rg_img_equal[label] = torch.equal(got[1], want[1])
    del got, want
    # a wavefront image under autograd: its backward is K3 (the windowed
    # refill in parallel RNG, against the megakernel path's taped refill)
    for label, c, kw in (("wavefront_autograd", cfg4.replace(spp=2), {}),
                         ("wavefront_autograd_parallel", cfg4p.replace(spp=2),
                          {"refill": 2})):
        leaves = [x.detach().requires_grad_() for x in
                  (s4.center, s4.radius, s4.albedo, s4.mat_param, *cam4)]
        ws = rt.Scene(leaves[0], leaves[1], s4.mat_type, leaves[2],
                      leaves[3])
        reset_counts(*mods)
        wimg = rt.render(ws, rt.Camera(*leaves[4:]), c, backend="wavefront",
                         bvh=b4, **kw)
        ct = 2.0 * (wimg.detach() - target) / wimg.numel()
        wg = torch.autograd.grad(wimg, leaves, ct)
        torch.cuda.synchronize()
        launches[label] = variant_counts(*mods)
        fimg = megakernel.render_fwd(ws, rt.Camera(*leaves[4:]), c, bvh=b4)
        fg = torch.autograd.grad(fimg, leaves, ct)
        grad_rel[label] = max(
            float((a - b).abs().max()) / max(float(b.abs().max()), 1e-12)
            for a, b in zip(wg, fg))
        del leaves, ws, wg, fg, wimg, fimg
    tmp = tempfile.mkdtemp()
    try:
        png = os.path.join(tmp, "wavefront.png")
        cmd = [sys.executable, "-m", "raytpu_torch.cli", "render", "--scene",
               "final", "--bvh", "--width", str(cfg4p.width), "--height",
               str(cfg4p.height), "--spp", str(cfg4p.spp), "--depth",
               str(cfg4p.depth), "--rng-mode", "parallel", "--backend",
               "wavefront", "--refill", "2", "--device", "cuda", "--out", png]
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            fail(f"CLI --backend wavefront exited {proc.returncode}: "
                 f"{proc.stderr[-2000:]}")
        ref = os.path.join(tmp, "in_process.png")
        io.save_png(ref, frames["config4_refill2"].cpu().numpy())
        with open(png, "rb") as f, open(ref, "rb") as g:
            cli_same = f.read() == g.read()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    want_launches = {
        "reference_v2": {"K5/dense": cfg.spp * 3},
        "config2": {"K5/brute": CONFIG2.spp * 2},
        "config4": {"K5/bvh": cfg4.spp * 2},
        "10k": {"K5/walk": ten_k_frame().spp * 2},
        "render_grad": {"K1c": 1, "K3/bvh": 1},
        "render_grad_parallel": {"K4/bvh": 1, "K3/bvh+refill+tape": 1},
        "wavefront_autograd": {"K5/bvh": 2 * 2, "K3/bvh": 1}}
    refill_runs = {"config4_refill2": "bvh", "config4_refill2_spp_batch4":
                   "bvh", "config2_refill2": "brute",
                   "reference_v2_refill2": "dense", "10k_refill2": "walk"}
    rounds = {k: launches[k].get(f"K6/{p}", 0)
              for k, p in refill_runs.items()}
    wf_par = launches["wavefront_autograd_parallel"]
    row = {"launches": launches, "runs": main,
           "render_grad_vs_auto_rel": rg_rel,
           "render_grad_img_bit_equal": rg_img_equal,
           "wavefront_autograd_vs_render_fwd_grads_rel": grad_rel,
           "cli_png_identical_to_render": cli_same,
           "command": " ".join(cmd[1:-1])}
    ok = (all(launches[k] == v for k, v in want_launches.items())
          and all(launches[k] == {f"K6/{p}": rounds[k]} and rounds[k] > 0
                  for k, p in refill_runs.items())
          and all(r["finite"] for r in main.values())
          and all(main[k]["bit_equal_render"] for k in main
                  if "spp_batch" not in k)
          and main["config4_refill2_spp_batch4"]["max_abs_vs_render"] <= 1e-6
          and all(rg_img_equal.values()) and max(rg_rel.values()) <= 1e-6
          and max(grad_rel.values()) <= 1e-6 and cli_same
          and wf_par.get("K6/bvh", 0) > 0
          and wf_par == {"K6/bvh": wf_par["K6/bvh"], "K3/bvh+refill": 1})
    phase("main_path_wavefront", ok=ok, card=card,
          tolerance="images bit-equal to render() at one slot a pixel, "
                    "within 1e-6 with 4; render_grad(backend='wavefront') "
                    "and a wavefront image's K3 gradients (sequential RNG; "
                    "parallel RNG, refill=2, on K3's windowed refill) within "
                    "1e-6 of each leaf's largest against the kernel path's",
          **row)
    if not ok:
        fail(f"the wavefront's main path: {row}")
    del frames

    # -- 8d: times, the wavefront against the megakernel
    t = frame_times(scenes, runs, card=card,
                    k1e_ms=entries["K1e"]["main_path_ms"])
    phase("timing_wavefront", frame="REFERENCE_V2, config 2, config 4 "
          "(sequential; parallel for refill), the 10k scene (parallel)", **t)

    for policy, main_run, mode in (
            ("brute", "config2", "sequential"),
            ("dense", "reference_v2", "sequential"),
            ("bvh", "config4", "sequential"), ("walk", "10k", "parallel")):
        r = seg_rows[(policy, mode, 0)]
        err = max(seg_rows[(policy, m, 0)]["max_abs_err"]
                  for m in ("sequential", "parallel"))
        entries[f"K5/{policy}"] = dict(
            cell=f"{r['frame']}, all {r['launches']} launches of a frame "
                 f"summed (error: also the other RNG mode); main path: "
                 f"{main_run}",
            launches=launches[main_run][f"K5/{policy}"], max_abs_err=err,
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"],
            main_path_frame_ms=t[f"{main_run}_wavefront_ms"],
            main_path_segments_ms=t[f"{main_run}_breakdown"]["segments_ms"])
        if "ms_by_segment" in r:
            entries[f"K5/{policy}"]["ms_by_segment"] = r["ms_by_segment"]
    for policy, main_run in (("bvh", "config4_refill2"),
                             ("brute", "config2_refill2"),
                             ("dense", "reference_v2_refill2"),
                             ("walk", "10k_refill2")):
        r = seg_rows[(policy, "parallel", 2)]
        entries[f"K6/{policy}"] = dict(
            cell=f"{r['frame']}, refill 2, all {r['launches']} launches of "
                 f"a frame summed; main path: {main_run} (parallel, refill "
                 "2)",
            launches=rounds[main_run], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"],
            main_path_frame_ms=t[f"{main_run}_wavefront_ms"],
            main_path_segments_ms=t[f"{main_run}_breakdown"]["segments_ms"])
    pack = seg_rows[("pack", "sequential", 0)]
    entries["K5/brute"]["pack_4097"] = {
        k: pack[k] for k in ("frame", "launches", "ms", "plain_ms",
                             "bound_ms", "bit_equal_plain")}
    entries["K6/brute"]["pack_4097"] = {
        k: seg_rows[("pack", "parallel", 2)][k]
        for k in ("frame", "launches", "ms", "plain_ms", "bound_ms",
                  "bit_equal_plain")}
    return entries


# K5's and K6's instantiations, by their template argument kHit in the
# mangled names: the flat sweep (1), the walk (2), the brute sweep over
# staged rows (3: the dense stage, and brute segments up to 4096 spheres)
# and over the pack (0)
SEGMENT_KERNELS = {f"{k}/{form}": f"render_{fn}_kernelILi{hit}EE"
                   for k, fn in (("K5", "segment"), ("K6", "refill"))
                   for form, hit in (("bvh", 1), ("walk", 2),
                                     ("staged", 3), ("pack", 0))}


def segment_phase(dev, card: str) -> None:
    """Phase 8e (segment_redesign): ptxas's registers and spills of every
    K5 and K6 instantiation, and what K5/bvh and K6/bvh stage of config
    4's BVH in shared memory (the forward's plan, ``stage_info``: its
    blocks an SM are K1c's) beside the brute sweep's staged rows at
    REFERENCE_V2's 327 spheres."""
    import raytpu_torch as rt
    from raytpu_torch.kernels import _build, megakernel
    from raytpu_torch.kernels import wavefront as kwf
    ptxas = flat_ptxas(_build.build_log[kwf.SOURCE]["ptxas"], SEGMENT_KERNELS)
    bvh = rt.build_bvh(rt.final_world(device=dev), leaf_size=LEAF)
    ok = len([k for k in ptxas if ptxas[k]]) == len(SEGMENT_KERNELS)
    phase("segment_redesign", ok=ok, card=card, ptxas=ptxas,
          config4_stage=stage_info(bvh, dev),
          reference_v2_staged_bytes=megakernel.brute_stage_bytes(327))
    if not ok:
        fail(f"ptxas reported {sorted(ptxas)} of K5's and K6's "
             "instantiations")


# Phase 9: K3's windowed refill (raytpu's parallel-RNG backward)
def refill_vs(label, card, scene, cam, cfg, bvh, vis_w, target,
              plain=True):
    """K3 given the forward image in parallel RNG, on the windowed refill
    and on the per-sample pass, and (``plain``) the plain version, all on
    the same CUDA tensors -> the phase line's row: the images bit-equal to
    the given one, every leaf of the refill within REFILL_TOL of the
    per-sample pass's and within GRAD_BUDGET of the plain version's, with
    the refill's plan (lanes, pixels a lane, window, scratch bytes)."""
    import raytpu_torch as rt
    from raytpu_torch.kernels import gradkernel
    img = rt.render(scene, cam, cfg, bvh=bvh)
    ct = 2.0 * (img - target) / img.numel()
    kw = dict(img=img, vis_w=vis_w, bvh=bvh)
    got = gradkernel.render_vjp(scene, cam, cfg, ct, **kw)
    ref = gradkernel.render_vjp(scene, cam, cfg, ct, p2_refill=False, **kw)
    rel, _ = leaf_errors(got, ref, rt.Camera._fields)
    row = {"case": label, "frame": f"{cfg.width}x{cfg.height} spp{cfg.spp} "
           f"d{cfg.depth} parallel", "spheres": scene.count, "vis_w": vis_w,
           "plan": k3_plan(cfg, kernel_pack(scene, bvh), bvh),
           "img_bit_equal": torch.equal(got[0], img)
           and torch.equal(ref[0], img),
           "vs_per_sample_rel": rel, "vs_per_sample_worst": max(rel.values())}
    ok = row["img_bit_equal"] and row["vs_per_sample_worst"] <= REFILL_TOL
    if plain:
        want, row["plain_ms"] = once_ms(lambda: gradkernel.render_vjp_plain(
            scene, cam, cfg.replace(chunk_pixels=PLAIN_CHUNK), ct, vis_w,
            bvh))
        prel, row["max_abs_err"] = leaf_errors(got, want, rt.Camera._fields)
        row["vs_plain_rel"] = prel
        row["vs_plain_worst"] = max(prel.values())
        ok = ok and row["vs_plain_worst"] <= GRAD_BUDGET
        row["ms"] = cuda_ms(lambda: gradkernel.render_vjp(
            scene, cam, cfg, ct, **kw), 3)
    phase("k3_refill_vs", ok=ok, card=card, tolerance=(
        f"images bit-equal; per leaf {REFILL_TOL} of the per-sample pass's "
        f"largest entry, {GRAD_BUDGET} of the plain version's"), **row)
    if not ok:
        fail(f"K3's windowed refill disagrees ({label}): {row}")
    return row


# K3's instantiations by their template arguments in the mangled names:
# render_vjp_kernel<kHit (kBrute 0, kFlat 1, kWalk 2), kTape> (the
# per-sample pass) and render_vjp_refill_kernel<kHit, kTape>
K3_KERNELS = {f"K3/{sweep}{'+refill' if r else ''}{'+tape' if t else ''}":
              f"render_vjp{'_refill' if r else ''}_kernelILi{h}ELb{int(t)}E"
              for h, sweep in ((0, "brute"), (1, "bvh"), (2, "walk"),
                               (3, "brute_staged"))
              for r in (False, True) for t in (False, True)}


def k3_phase(dev, card: str, entries: dict, vis: dict) -> None:
    """Phase 9c (k3_flat_redesign): K3 over the flat BVH on its main paths
    (config 4: the sequential per-sample pass, the refill with ``vis_w``
    and the near-miss sweep's share of it, beside their bounds), ptxas's
    registers and spills of every K3 instantiation, what K3 stages of
    config 4's BVH in shared memory within this card's limits and the
    refill's lanes with and without it.  Adds the staged bytes to the K3
    flat rows of the kernel table."""
    import raytpu_torch as rt
    from raytpu_torch.kernels import _build, gradkernel
    bvh = rt.build_bvh(rt.final_world(device=dev), leaf_size=LEAF)
    stage = gradkernel.k3_stage(bvh, dev)
    limits = dict(zip(("optin", "per_sm", "reserved", "blocks_per_sm",
                       "refill_static"), gradkernel.device_limits(dev)))
    ptxas = flat_ptxas(_build.build_log[gradkernel.SOURCE]["ptxas"],
                       K3_KERNELS)
    k3 = entries["K3/bvh"]
    phase("k3_flat_redesign", card=card, ok=len(ptxas) == len(K3_KERNELS),
          frame="800x400 spp100 d12 final_world, BVH leaf 64",
          seq_bvh={"ms": k3["main_path_ms"],
                   "bound_ms": k3["main_path_bound_ms"]},
          refill_bvh_vis_w={"ms": vis["k3"]["refill_ms"],
                            "bound_ms": vis["k3_bound"]["bound_ms"]},
          near_miss=vis["k3"]["near_miss"], ptxas=ptxas, stage=stage,
          stage_limit=gradkernel.stage_limit(*gradkernel.device_limits(dev)),
          limits=limits, refill_lanes_staged=gradkernel.refill_lanes(
              dev, stage["bytes"]),
          refill_lanes_unstaged=gradkernel.refill_lanes(dev))
    if len(ptxas) != len(K3_KERNELS):
        fail(f"ptxas reported {sorted(ptxas)} of K3's instantiations")
    for key in ("K3/bvh", "K3/bvh+tape", "K3/bvh+refill",
                "K3/bvh+refill+tape"):
        entries[key].update(stage_bytes=stage["bytes"],
                            registers=ptxas[key]["registers"])


# the brute sweep's instantiations, by their template arguments in the
# mangled names: render_fwd_kernel<kHit (kDense 3: the rows staged; kBrute
# 0: the scene pack), kTape, kCount, kCarry>, K3's (K3_KERNELS), and K5's
# and K6's brute segments past 4096 spheres (the pack; the staged ones
# are DENSE_KERNELS')
BRUTE_KERNELS = {
    **{f"{k} ({form})": f"render_fwd_kernelILi{h}E{args}"
       for h, form in ((3, "staged"), (0, "pack"))
       for k, args in (("K1a, K1e, K1b", "Li0ELb0ELb0E"),
                       ("K1'", "Li0ELb1ELb0E"), ("K2", "Li0ELb0ELb1E"),
                       ("K4", "Li1ELb0ELb0E"))},
    **{k: v for k, v in K3_KERNELS.items() if k.startswith("K3/brute")},
    "K5/brute (pack)": "render_segment_kernelILi0EE",
    "K6/brute (pack)": "render_refill_kernelILi0EE"}


def brute_phase(dev, card: str, scene, cam, target,
                grad_timings: dict) -> dict:
    """Phase 4d (brute_redesign), with 4b's last case: REFERENCE_V2's
    parallel ``render_grad`` (``scene``, ``cam``; tape_plan takes a full
    tape), its launches by variant and its time, then its kernels' (K4/brute,
    then K3's refill replaying the tape) beside their bounds, both held
    (``brute_main_path_vs_plain``) against the plain taping forward and the
    plain VJP at that shape with the spp cut to 2, and at full spp to
    render()'s image and the untaped refill's; K3 brute's on
    the sequential ``render_grad`` (4b's ``reference_v2``) beside its bound;
    config 2's ``render()`` (K1a); the counted warp efficiencies of K1a on
    config 2 and of K4/brute on REFERENCE_V2 (warp_census: the census kernel
    on the same schedule) beside the per-sample loop's loop efficiency
    estimated from each frame's K4 tape; ptxas's registers and spills of
    every brute instantiation; the bytes the brute sweep stages and K3's
    refill lanes with them at 327, 4096 and 4097 spheres -> the main-path
    fields of the kernel table's brute rows."""
    import raytpu_torch as rt
    from raytpu_torch import golden, profiling
    from raytpu_torch.config import CONFIG2, REFERENCE_V2
    from raytpu_torch.kernels import _build, gradkernel, megakernel
    from raytpu_torch.kernels import wavefront as kwf

    cfg_s, cfg_p = REFERENCE_V2, REFERENCE_V2.replace(rng_mode="parallel")
    n = scene.count
    cp, sp = megakernel.pack_camera(cam), megakernel.pack_scene(scene)
    plan = gradkernel.tape_plan(cfg_p, n)
    reset_counts(megakernel, gradkernel)
    rt.render_grad(scene, cam, cfg_p, target)
    torch.cuda.synchronize()
    launches = variant_counts(megakernel, gradkernel)
    fwd_bwd_ms = cuda_ms(lambda: rt.render_grad(scene, cam, cfg_p, target), 3)
    tape = marked_tape(cfg_p, n, cfg_p.spp * cfg_p.depth, dev)
    img = megakernel.launch(cp, sp, cfg_p, tape=tape)
    k4_ms = cuda_ms(lambda: megakernel.launch(cp, sp, cfg_p, tape=tape), 3)
    ct = 2.0 * (img - target) / img.numel()
    k3_tape_ms = cuda_ms(lambda: gradkernel.launch(cp, sp, cfg_p, ct, img,
                                                   tape=tape), 3)
    before = per_sample_efficiency(tape, scene.mat_type, cfg_p)
    # at full spp: K4's image is render()'s, and the taped refill's image
    # and camera sums are the untaped refill's (its sphere sums within
    # REFILL_TOL: f64 atomics add in no fixed order)
    taped = gradkernel.launch(cp, sp, cfg_p, ct, img, tape=tape)
    untaped = gradkernel.launch(cp, sp, cfg_p, ct, img)
    sums_rel = k3_sums_rel(k3_sums(taped), k3_sums(untaped), n)
    full = {"k4_img_bit_equal_render": torch.equal(
                img, rt.render(scene, cam, cfg_p)),
            "k3_tape_img_bit_equal_untaped": torch.equal(taped[0],
                                                         untaped[0]),
            "k3_tape_cam_sums_bit_equal_untaped": torch.equal(taped[2],
                                                              untaped[2]),
            "k3_tape_vs_untaped_rel": sums_rel}
    ok_full = (full["k4_img_bit_equal_render"]
               and full["k3_tape_img_bit_equal_untaped"]
               and full["k3_tape_cam_sums_bit_equal_untaped"]
               and max(sums_rel.values()) <= REFILL_TOL)
    del tape, img, taped, untaped
    # the same kernels at the main path's shape with the spp cut to 2 (the
    # plain adjoint keeps every bounce's residuals, as in phase 2b): K4's
    # image and tape against the plain taping forward, the taped refill
    # against the plain VJP replaying the same tape
    cfg_c = cfg_p.replace(spp=2)
    plain_c = cfg_c.replace(chunk_pixels=PLAIN_CHUNK)
    g_c = cfg_c.spp * cfg_c.depth
    tape_c = marked_tape(cfg_c, n, g_c, dev)
    reset_counts(megakernel, gradkernel)
    img_c = megakernel.launch(cp, sp, cfg_c, tape=tape_c)
    ct_c = 2.0 * (img_c - target) / img_c.numel()
    got = gradkernel.render_vjp(scene, cam, cfg_c, ct_c, img=img_c,
                                tape=tape_c)
    torch.cuda.synchronize()
    cut_launches = variant_counts(megakernel, gradkernel)
    pimg, ptape = golden.render_golden_tape(scene, cam, plain_c, g_c)
    written = ptape != golden.TAPE_UNWRITTEN  # the rest is never read
    tape_share = float((ptape == tape_c)[written].float().mean())
    k4_vs_plain = compare(img_c, pimg)
    want = gradkernel.render_vjp_plain(scene, cam, plain_c, ct_c, 0.0, None,
                                       tape_c)
    rel, abs_err = leaf_errors(got, want, rt.Camera._fields)
    ok_cut = (cut_launches == {"K4/brute": 1, "K3/refill+tape": 1}
              and k4_vs_plain["share_above_budget"] <= BUDGET_SHARE
              and tape_share >= 1 - BUDGET_SHARE
              and torch.equal(got[0], img_c)
              and max(rel.values()) <= GRAD_BUDGET)
    phase("brute_main_path_vs_plain", ok=ok_cut and ok_full, card=card,
          frame=f"{cfg_c.width}x{cfg_c.height} spp{cfg_c.spp} d{cfg_c.depth} "
                f"parallel, {n} spheres (REFERENCE_V2's spp cut to 2); full "
                f"spp {cfg_p.spp}", tolerance=(
              f"K4 image: share |d| > {BUDGET_DELTA} <= {BUDGET_SHARE}; tape "
              f"slots equal >= {1 - BUDGET_SHARE}; K3 image bit-equal, "
              f"{GRAD_BUDGET} of each leaf's largest; at full spp bit-equal, "
              f"the sphere sums {REFILL_TOL}"),
          launches=cut_launches, k4_vs_plain=k4_vs_plain,
          k4_tape_share_equal=tape_share,
          k3_img_bit_equal=torch.equal(got[0], img_c), k3_rel_err=rel,
          k3_abs_err=abs_err, full_spp=full)
    if not (ok_cut and ok_full):
        fail("K4/brute or the taped K3 refill on REFERENCE_V2's parallel "
             "render_grad disagrees with its plain version or its own "
             "untaped or render() output")
    del tape_c, img_c, got, want, pimg, ptape
    rays = cfg_p.width * cfg_p.height * cfg_p.spp
    ok_launches = (plan is not None and not plan["partial"]
                   and launches == {"K4/brute": 1, "K3/refill+tape": 1})
    phase("grad_timing", case="reference_v2_parallel", ok=ok_launches,
          frame=f"{cfg_p.width}x{cfg_p.height} spp{cfg_p.spp} "
                f"d{cfg_p.depth} parallel", card=card, tape_plan=plan,
          launches=launches, fwd_bwd_ms=fwd_bwd_ms,
          fwd_bwd_mrays_s=rays / fwd_bwd_ms / 1e3, k4_ms=k4_ms,
          k3_tape_ms=k3_tape_ms)
    if not ok_launches:
        fail(f"REFERENCE_V2's parallel render_grad made {launches} with "
             f"the tape plan {plan}: want one K4/brute and one "
             "K3/refill+tape (a full tape)")

    c_s = profiling.census(scene, cam, cfg_s)
    c_p = profiling.census(scene, cam, cfg_p)
    elt = torch.empty((), dtype=golden.tape_dtype(n)).element_size()
    tbytes = c_p["bounce_steps"] * elt
    b_k4 = bound(forward_ops(c_p), frame_bytes(cfg_p, n, 1) + tbytes)
    b_k3 = bound(k3_ops(c_s, 2), frame_bytes(cfg_s, n, 2) + 64 * n)
    b_k3t = bound(k3_ops(c_p, 1, c_p["bounce_steps"]),
                  frame_bytes(cfg_p, n, 3) + tbytes + 8 * 8 * n)
    c2_scene = rt.config2_world(device=dev)
    c2_cam = rt.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0,
                            aspect=CONFIG2.aspect, device=dev)
    config2_render_ms = cuda_ms(lambda: rt.render(c2_scene, c2_cam, CONFIG2),
                                20)
    cp2, sp2 = megakernel.pack_camera(c2_cam), megakernel.pack_scene(c2_scene)
    config2_k1a_ms = cuda_ms(lambda: megakernel.launch(cp2, sp2, CONFIG2), 20)
    warps_k1a = megakernel.warp_census(cp2, sp2, CONFIG2, None)
    before_c2 = per_sample_efficiency(frame_tape(c2_scene, c2_cam, CONFIG2),
                                      c2_scene.mat_type, CONFIG2)
    warps_k4 = megakernel.warp_census(cp, sp, cfg_p, None)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stage = {}
    for k in (n, megakernel.DENSE_MAX, megakernel.DENSE_MAX + 1):
        staged = megakernel.brute_stage_bytes(k)
        lanes = gradkernel.refill_lanes(dev, staged)
        stage[k] = {"bytes": staged, "refill_lanes": lanes,
                    "blocks_per_sm": lanes / (sms * gradkernel.REFILL_BLOCK)}
    ptxas = {}
    for src in (megakernel.SOURCE, gradkernel.SOURCE, kwf.SOURCE):
        ptxas.update(flat_ptxas(_build.build_log[src]["ptxas"],
                                BRUTE_KERNELS))
    k3_ms = grad_timings["reference_v2"]["k3_ms"]
    ok = (len(ptxas) == len(BRUTE_KERNELS)
          and stage[megakernel.DENSE_MAX]["blocks_per_sm"] >= 2)
    phase("brute_redesign", ok=ok, card=card,
          frames={"reference_v2": "1024x576 spp60 d50 sequential "
                                  "random_world",
                  "reference_v2_parallel": "the same, parallel RNG",
                  "config2": "400x200 spp20 d12 sequential"},
          main_paths={
              "config2_render": {"ms": config2_render_ms},
              "config2_k1a": {"ms": config2_k1a_ms},
              "k4_brute_reference_v2_parallel": {"ms": k4_ms, **b_k4},
              "k3_refill_tape_reference_v2_parallel": {"ms": k3_tape_ms,
                                                       **b_k3t},
              "k3_brute_reference_v2_sequential": {"ms": k3_ms, **b_k3}},
          census_reference_v2=c_s, census_reference_v2_parallel=c_p,
          warps={"k1a_config2": warps_k1a,
                 "k4_brute_reference_v2_parallel": warps_k4},
          per_sample_loop_reference_v2_parallel=before,
          per_sample_loop_config2=before_c2, ptxas=ptxas,
          stage=stage)
    if not ok:
        fail(f"ptxas reported {sorted(ptxas)} of the brute instantiations; "
             f"K3's refill keeps {stage[megakernel.DENSE_MAX]} at 4096 "
             "spheres (two blocks an SM wanted)")
    main = "REFERENCE_V2 parallel render_grad (a full tape)"
    return {
        "config2_render_ms": config2_render_ms,
        "warps_k1a_config2": warps_k1a,
        "k3_main_path": dict(
            main_path="REFERENCE_V2 sequential render_grad",
            main_path_ms=k3_ms, main_path_bound_ms=b_k3["bound_ms"],
            main_path_bound_by=b_k3["bound_by"]),
        "k4_main_path": dict(
            main_path=main, main_path_ms=k4_ms,
            main_path_bound_ms=b_k4["bound_ms"],
            main_path_bound_by=b_k4["bound_by"],
            loop_efficiency=warps_k4["loop_efficiency"],
            sweep_efficiency=warps_k4["sweep_efficiency"],
            efficiency_cell="REFERENCE_V2 parallel"),
        "k3_tape_main_path": dict(
            main_path=main, main_path_ms=k3_tape_ms,
            main_path_bound_ms=b_k3t["bound_ms"],
            main_path_bound_by=b_k3t["bound_by"])}


def own_process(code: str) -> object:
    """The last line of ``code``'s standard output, as JSON, run by a
    Python process of its own from the repository's root.  A
    ``torch.profiler`` trace taken after other GPU work in a process that
    has traced before may lose its device events (none for a short call;
    measured on an H100, PERF.md section 7); a process's first trace holds
    them."""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        fail(f"a traced process exited {proc.returncode}: "
             f"{proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


# one traced call of a preset on card 0, after a warm-up call
TRACED_RENDER = """
import json
import raytpu_torch as rt
from raytpu_torch import config, profiling
cfg = config.{preset}
scene, cam = rt.{world}(device="cuda"), {camera}
rt.render(scene, cam, cfg)
print(json.dumps(profiling.{fn}(lambda: rt.render(scene, cam, cfg))))
"""


def fractsin_phase(dev, card: str) -> None:
    """Phase 10 (see the module docstring); fails on any check."""
    import raytpu_torch as rt
    from raytpu_torch import golden, progressive
    from raytpu_torch.config import REFERENCE_V1_FAITHFUL
    from raytpu_torch.kernels import gradkernel, megakernel
    cfg = REFERENCE_V1_FAITHFUL
    planes = {}
    for d in ("cpu", dev):
        cam = rt.reference_camera_v1(device=d)
        flat = torch.arange(cfg.width * cfg.height, device=d)
        fx, fy = (flat % cfg.width).float(), (flat // cfg.width).float()
        sx, sy = golden.fractsin_state(cfg, fx, fy)
        _, _, draws, (sx, sy) = golden.fractsin_sample(cam, cfg, fx, fy, sx,
                                                       sy)
        planes[d] = [t.cpu() for t in (sx, sy, draws[3])]
    states_equal = all(torch.equal(a, b)
                       for a, b in zip(planes["cpu"], planes[dev]))
    scene, cam = rt.v1_world(device="cpu"), rt.reference_camera_v1(
        device="cpu")
    t0 = time.perf_counter()
    want = rt.render(scene, cam, cfg)
    cpu_s = time.perf_counter() - t0
    reset_counts(megakernel, gradkernel)

    def frame():
        return rt.render(scene, cam, cfg, device=dev)

    got, first_ms = once_ms(frame)
    _, frame_ms = once_ms(frame)
    launches = launch_count(megakernel) + launch_count(gradkernel)
    dev_ms = own_process(TRACED_RENDER.format(
        preset="REFERENCE_V1_FAITHFUL", world="v1_world",
        camera='rt.reference_camera_v1(device="cuda")', fn="device_ms"))
    res = compare(got.cpu(), want)
    cfg4 = cfg.replace(spp=4)
    scene_d, cam_d = rt.v1_world(device=dev), rt.reference_camera_v1(
        device=dev)
    one = rt.render(scene_d, cam_d, cfg4)
    st = progressive.init_state(cfg4, device=dev)
    for _ in range(2):
        st = progressive.accumulate(scene_d, cam_d, cfg4, st, 2)
    batches_equal = bool(torch.equal(progressive.image(st, cfg4), one))
    try:
        megakernel.check_inputs(scene_d, cam_d, cfg)
        refused = False
    except ValueError as e:
        refused = "golden-only" in str(e)
    ok = (states_equal and res["share_above_budget"] <= BUDGET_SHARE
          and launches == 0 and batches_equal and refused
          and tuple(got.shape) == (cfg.height, cfg.width, 3)
          and bool(torch.isfinite(got).all()))
    phase("v1_fractsin", ok=ok, card=card,
          frame="REFERENCE_V1_FAITHFUL 640x480 spp1 d25 gamma 2 v1_world",
          post_jitter_state_bit_equal_cpu=states_equal,
          tolerance=f"share |d| > {BUDGET_DELTA} <= {BUDGET_SHARE} against "
                    "the CPU's image", **res, kernel_launches=launches,
          frame_ms=frame_ms, first_frame_ms=first_ms, frame_device_ms=dev_ms,
          cpu_frame_s=cpu_s, mean=float(got.mean()),
          progressive_2_plus_2_bit_equal=batches_equal,
          check_inputs_refuses=refused)
    if not ok:
        fail("the v1 fract-sin mode failed a check on the card")
    events = own_process(TRACED_RENDER.format(
        preset="CONFIG2", world="config2_world", camera=(
            "rt.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0, "
            'aspect=cfg.aspect, device="cuda")'), fn="device_events"))
    phase("device_events", card=card, call="config 2 render()",
          events=events)


def near_miss_share(args: dict) -> dict:
    """K3's ``vis_w`` launch ``args`` (``gradkernel.launch``'s arguments)
    less the same launch with ``vis_w`` 0, on each PASS 2 schedule, in
    turns (with, without, without, with; a warm-up call and 3 timed calls
    each): the near-miss sweep's share, with the hit side's silhouette
    terms (small beside it)."""
    from raytpu_torch.kernels import gradkernel
    off_args = {**args, "vis_w": 0.0}
    out = {}
    for sched in ("refill", "per_sample"):
        with (per_sample() if sched == "per_sample"
              else contextlib.nullcontext()):
            on = cuda_ms_each(lambda: gradkernel.launch(**args), 3)
            off = cuda_ms_each(lambda: gradkernel.launch(**off_args), 3)
            off += cuda_ms_each(lambda: gradkernel.launch(**off_args), 3)
            on += cuda_ms_each(lambda: gradkernel.launch(**args), 3)
        on_ms, off_ms = sum(on) / len(on), sum(off) / len(off)
        out[sched] = {"vis_w_ms": on_ms, "vis_w_0_ms": off_ms,
                      "share_ms": on_ms - off_ms, "vis_w_each_ms": on,
                      "vis_w_0_each_ms": off}
    return out


def refill_phases(dev, card: str) -> dict:
    """Phase 9 (see the module docstring) -> the kernel table's entry of
    K3/refill, and the launches of K3/bvh+refill on its main path."""
    import raytpu_torch as rt
    from raytpu_torch import optim, profiling
    from raytpu_torch.config import CONFIG2, CONFIG3, CONFIG4
    from raytpu_torch.kernels import gradkernel, megakernel
    from raytpu_torch.kernels import wavefront as kwf

    mods = (megakernel, gradkernel, kwf)
    c2p = CONFIG2.replace(rng_mode="parallel")
    c4p = CONFIG4.replace(rng_mode="parallel")
    scene2 = rt.config2_world(device=dev)
    cam2 = rt.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0,
                          aspect=c2p.aspect, device=dev)
    scene4 = rt.final_world(device=dev)
    bvh4 = rt.build_bvh(scene4, leaf_size=LEAF)
    cam4 = rt.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0,
                          aspect=c4p.aspect, device=dev)
    _, scene3, cam3, target3, _ = optim.inverse_render_problem(
        CONFIG3, device=dev)
    gen = torch.Generator().manual_seed(17)

    def target(cfg):
        return torch.rand((cfg.height, cfg.width, 3), generator=gen).to(dev)

    # -- 9a: against the plain version and the per-sample pass (2 spp),
    # then a window of depth steps (every lane parks after each sample)
    rows = [refill_vs("config2", card, scene2, cam2, c2p.replace(spp=2), None,
                      0.0, target(c2p)),
            refill_vs("config3_defocus_vis_w", card, scene3, cam3,
                      CONFIG3.replace(spp=2, rng_mode="parallel"), None,
                      VIS_W, target3)]
    budget = gradkernel.REFILL_BUDGET
    gradkernel.REFILL_BUDGET = 0
    try:
        c4s = c4p.replace(spp=2)
        refill_vs("config4_window_of_depth", card, scene4, cam4, c4s, bvh4,
                  0.0, target(c4p), plain=False)
        # and replaying tapes, taped against untaped under phase 5's rule
        full = c4s.spp * c4s.depth
        img, tape = gradkernel.render_tape_fwd(scene4, cam4, c4s, full, bvh4)
        ct = 2.0 * (img - target(c4p)) / img.numel()
        caps = taped_vs_untaped(scene4, cam4, c4s, ct, img, bvh4, tape,
                                "refill, window of depth")
        phase("k4_taped_vs_untaped", ok=True, sweep="bvh",
              schedule="refill, window of depth",
              frame="800x400 spp2 d12 parallel", g_caps=caps,
              plan=k3_plan(c4s, kernel_pack(scene4, bvh4), bvh4))
        del img, tape
    finally:
        gradkernel.REFILL_BUDGET = budget

    # -- 9b: the main paths, through the entry points, on the refill and
    # on the per-sample pass: launches by variant (counts reset just before
    # each, read just after), gradients, each call's time
    from raytpu_torch.render import render_grad
    t4, t2 = target(c4p), target(c2p)

    def wf_autograd():
        leaves = [x.detach().requires_grad_() for x in
                  (scene4.center, scene4.radius, scene4.albedo,
                   scene4.mat_param, *cam4)]
        img = rt.render(rt.Scene(leaves[0], leaves[1], scene4.mat_type,
                                 leaves[2], leaves[3]),
                        rt.Camera(*leaves[4:]), c4p, backend="wavefront",
                        bvh=bvh4, refill=2)
        grads = torch.autograd.grad(torch.mean((img - t4) ** 2), leaves)
        return (None, img.detach(), (rt.Scene(grads[0], grads[1], None,
                                              grads[2], grads[3]),
                                     rt.Camera(*grads[4:])))

    paths = (
        ("config4_taped", c4p, lambda: render_grad(scene4, cam4, c4p, t4,
                                                   bvh=bvh4)),
        ("config4_vis_w", c4p, lambda: render_grad(
            scene4, cam4, c4p, t4, vis_w=VIS_W, bvh=bvh4)),
        ("config2", c2p, lambda: render_grad(scene2, cam2, c2p, t2)),
        ("wavefront_config4_render_grad", c4p, lambda: render_grad(
            scene4, cam4, c4p, t4, backend="wavefront", bvh=bvh4)),
        ("wavefront_config4_refill2_autograd", c4p, wf_autograd))
    main, launches = {}, {}
    for label, cfg, fn in paths:
        out, calls = {}, []
        for sched in ("refill", "per_sample"):
            reset_counts(*mods)
            with (per_sample() if sched == "per_sample"
                  else recording(gradkernel, "launch", calls)):
                out[sched] = fn()
            torch.cuda.synchronize()
            launches[f"{label}/{sched}"] = variant_counts(*mods)
        rel, _ = leaf_errors((None, *out["refill"][2]),
                             (None, *out["per_sample"][2]), rt.Camera._fields)
        (k3_args, _), = calls  # K3 alone, on the path's own operands
        k3 = schedule_times(lambda: gradkernel.launch(*k3_args.args,
                                                      **k3_args.kwargs))
        if label == "config4_taped":  # the refill's machinery without its
            # schedule: a window of depth steps, one sample a lane a window
            budget = gradkernel.REFILL_BUDGET
            gradkernel.REFILL_BUDGET = 0
            try:
                k3["refill_window_of_depth_each_ms"] = cuda_ms_each(
                    lambda: gradkernel.launch(*k3_args.args,
                                              **k3_args.kwargs), 3)
            finally:
                gradkernel.REFILL_BUDGET = budget
        if label == "config4_vis_w":  # the near-miss sweep's share
            k3["near_miss"] = near_miss_share(k3_args.arguments)
        row = dict(schedule_times(fn), k3=k3,
                   plan=k3_plan(cfg, k3_args.arguments["scene_pack"],
                                k3_args.arguments.get("bvh")),
                   launches={s: launches[f"{label}/{s}"]
                             for s in ("refill", "per_sample")},
                   refill_vs_per_sample_worst=max(rel.values()),
                   img_bit_equal=torch.equal(out["refill"][1],
                                             out["per_sample"][1]))
        main[label] = row
        phase("main_path_refill", path=label,
              frame=f"{cfg.width}x{cfg.height} spp{cfg.spp} d{cfg.depth} "
                    "parallel", card=card, **row)
        del out
    k3 = {s: {p: [k for k in launches[f"{p}/{s}"] if k.startswith("K3")]
              for p, _, _ in paths} for s in ("refill", "per_sample")}
    want = {"refill": {"config4_taped": ["K3/bvh+refill+tape"],
                       "config4_vis_w": ["K3/bvh+refill"],
                       "config2": ["K3/refill"],
                       "wavefront_config4_render_grad": ["K3/bvh+refill+tape"],
                       "wavefront_config4_refill2_autograd": [
                           "K3/bvh+refill"]},
            "per_sample": {"config4_taped": ["K3/bvh+tape"],
                           "config4_vis_w": ["K3/bvh"], "config2": ["K3"],
                           "wavefront_config4_render_grad": ["K3/bvh+tape"],
                           "wavefront_config4_refill2_autograd": ["K3/bvh"]}}
    ok = (k3 == want
          and all(r["refill_vs_per_sample_worst"] <= REFILL_TOL
                  and r["img_bit_equal"] for r in main.values()))
    # K3's bound on the vis_w path: its census, and the near-miss sweep at
    # every step that misses (counted from the frame's tape)
    c4 = profiling.census(scene4, cam4, c4p, bvh4)
    nm = near_miss_tests(scene4, cam4, c4p, bvh4)
    nbytes = (frame_bytes(c4p, scene4.count, 3) + bvh4.flat.numel() * 4
              + 8 * 8 * scene4.count)
    vis = main["config4_vis_w"]
    vis.update(near_miss_tests=nm, k3_bound=bound(
        k3_ops(c4, 1, near_miss_tests=nm), nbytes),
        k3_bound_without_near_miss=bound(k3_ops(c4, 1), nbytes))
    phase("main_path_refill_checks", ok=ok, k3_launches=k3,
          tolerance=f"per leaf {REFILL_TOL} of the per-sample pass's largest",
          config4_vis_w_k3_ms=vis["k3"]["refill_ms"],
          config4_vis_w_near_miss=vis["k3"]["near_miss"], census=c4,
          near_miss_tests=nm, k3_bound=vis["k3_bound"],
          k3_bound_without_near_miss=vis["k3_bound_without_near_miss"])
    if not ok:
        fail(f"the refill's main paths: {k3}")
    c2 = profiling.census(scene2, cam2, c2p.replace(spp=2))
    r2 = rows[0]
    entries = {"K3/refill": dict(
        max_abs_err=max(r["max_abs_err"] for r in rows),
        max_rel_err=max(r["vs_plain_worst"] for r in rows),
        ms=r2["ms"], plain_ms=r2["plain_ms"],
        launches=launches["config2/refill"]["K3/refill"],
        main_path_schedules=main["config2"],
        **bound(k3_ops(c2, 1), frame_bytes(c2p, scene2.count, 3)
                + 8 * 8 * scene2.count))}
    bvh_refill = sum(launches[f"{p}/refill"].get("K3/bvh+refill", 0)
                     for p in ("config4_vis_w",
                               "wavefront_config4_refill2_autograd"))
    return entries, bvh_refill, main


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a card")
    sys.path.insert(0, ROOT)
    import raytpu_torch as rt
    from raytpu_torch import golden, io, optim
    from raytpu_torch.config import CONFIG2, CONFIG3, REFERENCE_V1, \
        REFERENCE_V2, RenderConfig
    from raytpu_torch.kernels import _build, gradkernel, megakernel
    from raytpu_torch.kernels import wavefront as kwf

    dev = torch.device("cuda", 0)
    card = card_line()
    global PEAK_OPS
    PEAK_OPS = ops_peak()
    phase("setup", card=card, torch=torch.__version__,
          cuda=torch.version.cuda, capability=torch.cuda.get_device_capability(0),
          ops_peak=PEAK_OPS, bytes_peak=PEAK_BYTES)
    t0 = time.perf_counter()
    sources = [megakernel.SOURCE, gradkernel.SOURCE, kwf.SOURCE]
    _build.load_all(sources)
    phase("build", seconds=time.perf_counter() - t0,
          ptxas={src: _build.build_log[src]["ptxas"] for src in sources},
          refill_lanes=gradkernel.refill_lanes(dev))

    def v2_cam(cfg):
        return rt.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0,
                              aspect=cfg.aspect, device=dev)

    # -- phase 2: K1a vs plain version on the card
    cfg_ref2 = REFERENCE_V2.replace(spp=2)
    cfg_odd = RenderConfig(width=50, height=21, spp=4, depth=12)
    odd_cam = rt.make_camera((0.0, 0.2, 1.0), (0.0, 0.0, -1.0), vfov=60.0,
                             aspect=cfg_odd.aspect, device=dev)
    cases = [
        ("config2", CONFIG2, rt.config2_world(device=dev), v2_cam(CONFIG2),
         BUDGET_DELTA),
        ("reference_v2_spp2", cfg_ref2, rt.random_world(device=dev),
         rt.reference_camera_v2(cfg_ref2.aspect, device=dev), BUDGET_DELTA),
        ("reference_v1", REFERENCE_V1, rt.v1_world(device=dev),
         rt.reference_camera_v1(device=dev), BUDGET_DELTA),
        ("config2_parallel", CONFIG2.replace(rng_mode="parallel"),
         rt.config2_world(device=dev), v2_cam(CONFIG2), BUDGET_DELTA),
        ("unaligned_50x21", cfg_odd, rt.config1_world(device=dev), odd_cam,
         BUDGET_DELTA),
        ("depth1_spp1_reference_v2", REFERENCE_V2.replace(spp=1, depth=1),
         rt.random_world(device=dev),
         rt.reference_camera_v2(REFERENCE_V2.aspect, device=dev), DEPTH1_TOL),
        ("depth1_spp1_reference_v1", REFERENCE_V1.replace(depth=1),
         rt.v1_world(device=dev), rt.reference_camera_v1(device=dev),
         DEPTH1_TOL),
    ]
    worst = 0.0
    for name, cfg, scene, cam, tol in cases:
        got = megakernel.launch(megakernel.pack_camera(cam),
                                megakernel.pack_scene(scene), cfg)
        want = golden.render_golden(scene, cam,
                                    cfg.replace(chunk_pixels=PLAIN_CHUNK))
        torch.cuda.synchronize()
        res = compare(got, want)
        worst = max(worst, res["max_abs_err"])
        ok = (res["max_abs_err"] <= tol if tol < BUDGET_DELTA
              else res["share_above_budget"] <= BUDGET_SHARE)
        phase("kernel_vs_plain", case=name,
              frame=f"{cfg.width}x{cfg.height} spp{cfg.spp} d{cfg.depth} "
                    f"{cfg.rng_mode} {cfg.scatter_mode}",
              tolerance=(f"max |d| <= {tol}" if tol < BUDGET_DELTA else
                         f"share |d| > {BUDGET_DELTA} <= {BUDGET_SHARE}"),
              ok=ok, **res)
        if not ok:
            fail(f"kernel disagrees with the plain version on {name}")

    # -- phase 2b: K3 vs its plain version on the same CUDA tensors
    _, c3_scene, c3_cam, c3_target, _ = optim.inverse_render_problem(
        CONFIG3, device=dev)
    cfg_par = RenderConfig(width=200, height=100, spp=4, depth=8,
                           rng_mode="parallel")
    cfg_v1 = REFERENCE_V1.replace(width=160, height=120)
    # the plain adjoint keeps every bounce's residuals of the whole frame:
    # at 60 spp REFERENCE_V2 would need ~90 GB, so the spp is cut to 2
    cfg_rv2 = REFERENCE_V2.replace(spp=2)
    vjp_cases = [
        ("config3", CONFIG3, c3_scene, c3_cam, 0.0, c3_target),
        ("config3_vis_w", CONFIG3, c3_scene, c3_cam, VIS_W, c3_target),
        ("test_world_parallel", cfg_par, rt.test_world(device=dev),
         v2_cam(cfg_par), 0.0, None),
        ("reference_v1_160x120", cfg_v1, rt.v1_world(device=dev),
         rt.reference_camera_v1(device=dev), 0.0, None),
        ("unaligned_50x21", cfg_odd, rt.config1_world(device=dev), odd_cam,
         0.0, None),
        ("random_world_reference_v2_spp2", cfg_rv2,
         rt.random_world(device=dev),
         rt.reference_camera_v2(cfg_rv2.aspect, device=dev), 0.0, None),
    ]
    k3_worst_rel, k3_worst_abs = 0.0, 0.0
    for name, cfg, scene, cam, vis_w, target in vjp_cases:
        img = megakernel.launch(megakernel.pack_camera(cam),
                                megakernel.pack_scene(scene), cfg)
        if target is None:  # a fixed target from a seed
            gen = torch.Generator().manual_seed(7)
            target = torch.rand(img.shape, generator=gen).to(dev)
        ct = 2.0 * (img - target) / img.numel()
        got = gradkernel.render_vjp(scene, cam, cfg, ct, vis_w=vis_w)
        t1 = time.perf_counter()
        want = gradkernel.render_vjp_plain(
            scene, cam, cfg.replace(chunk_pixels=PLAIN_CHUNK), ct, vis_w)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t1
        rel, abs_err = leaf_errors(got, want, rt.Camera._fields)
        worst_leaf = max(rel, key=rel.get)
        again = gradkernel.render_vjp_plain(
            scene, cam, cfg.replace(chunk_pixels=PLAIN_CHUNK), ct, vis_w)
        self_rel, _ = leaf_errors(again, want, rt.Camera._fields)
        del again
        row = {"case": name,
               "frame": f"{cfg.width}x{cfg.height} spp{cfg.spp} d{cfg.depth} "
                        f"{cfg.rng_mode} {cfg.scatter_mode}",
               "spheres": scene.count, "vis_w": vis_w,
               "img_bit_equal_k1a": bool(torch.equal(got[0], img)),
               "img_max_abs_vs_plain": float((got[0] - want[0]).abs().max()),
               "rel_err": rel, "worst_leaf": worst_leaf,
               "budget": GRAD_BUDGET, "plain_s": plain_s,
               "plain_vs_plain_worst": max(self_rel.values())}
        if cfg.rng_mode == "parallel":  # PASS 1 elided: bit-equal grads
            # (p2_refill=False isolates the elision: the image alone also
            # engages the windowed refill, phase 9)
            elided = gradkernel.render_vjp(scene, cam, cfg, ct, img=img,
                                           vis_w=vis_w, p2_refill=False)
            row["pass1_elision_bit_equal"] = all(
                torch.equal(a, b) for a, b in
                zip((got[0], *[getattr(got[1], k) for k in
                               ("center", "radius", "albedo", "mat_param")],
                     *got[2]),
                    (elided[0], *[getattr(elided[1], k) for k in
                                  ("center", "radius", "albedo",
                                   "mat_param")], *elided[2])))
        ok = (row["img_bit_equal_k1a"] and rel[worst_leaf] <= GRAD_BUDGET
              and row.get("pass1_elision_bit_equal", True))
        phase("vjp_kernel_vs_plain", ok=ok, **row)
        if not ok:
            fail(f"K3 disagrees with its plain version on {name}")
        k3_worst_rel = max(k3_worst_rel, rel[worst_leaf])
        k3_worst_abs = max(k3_worst_abs, abs_err)
        del got, want

    # -- phase 2c: finite differences on the card, through the CLI
    cmd = [sys.executable, "-m", "raytpu_torch.cli", "gradcheck",
           "--device", "cuda"]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    try:
        result = json.loads(proc.stdout.strip().splitlines()[-1])
    except (IndexError, json.JSONDecodeError):
        result = {}
    phase("gradcheck", command=" ".join(cmd[1:]), rc=proc.returncode,
          result=result)
    if proc.returncode != 0 or result.get("pass") is not True:
        fail(f"gradcheck --device cuda: rc {proc.returncode}, "
             f"{proc.stdout[-1000:]} {proc.stderr[-2000:]}")

    # -- phase 3: the forward path, through the entry points a user calls
    cfg = REFERENCE_V2
    scene = rt.random_world(device=dev)
    cam = rt.reference_camera_v2(cfg.aspect, device=dev)
    reset_counts(megakernel, gradkernel)
    img = rt.render(scene, cam, cfg, backend="auto")
    torch.cuda.synchronize()
    fwd_launches = (launch_count(megakernel), launch_count(gradkernel))
    fwd_variants = variant_counts(megakernel, gradkernel)
    rv2_img = img
    band = (0.45, 0.75)  # mean of this frame (plain version, 128x72 4 spp: 0.61)
    mean = float(img.mean())
    share_over_1 = float((img > 1).float().mean())
    phase("main_path", frame="1024x576 spp60 d50 random_world",
          spheres=scene.count, launches=fwd_launches[0],
          vjp_launches=fwd_launches[1], variants=fwd_variants, mean=mean,
          mean_band=band,
          min=float(img.min()), max=float(img.max()),
          share_above_1=share_over_1)
    if fwd_launches != (1, 0) or fwd_variants != {"K1e": 1}:
        fail(f"render(backend='auto') on CUDA tensors made {fwd_launches} "
             f"(forward, K3) launches, {fwd_variants}, want (1, 0), one K1e "
             "(327 spheres, no BVH: the dense stage)")
    if tuple(img.shape) != (cfg.height, cfg.width, 3) or not img.is_cuda:
        fail(f"main path image has shape {tuple(img.shape)} on {img.device}")
    if not bool(torch.isfinite(img).all()) or float(img.min()) < 0:
        fail("main path image has non-finite or negative values")
    # random_world's metals have albedo > 1 (the reference's quirk), so a
    # few pixels may exceed 1; a broad share means broken radiance
    if share_over_1 > 0.05 or not band[0] <= mean <= band[1]:
        fail(f"main path image implausible: mean {mean}, "
             f"share > 1 {share_over_1}")

    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "reference_v2.png")
        cmd = [sys.executable, "-m", "raytpu_torch.cli", "render",
               "--scene", "random", "--width", str(cfg.width),
               "--height", str(cfg.height), "--spp", str(cfg.spp),
               "--depth", str(cfg.depth), "--device", "cuda", "--out", png]
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            fail(f"CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
        with open(png, "rb") as f:
            data = f.read()
        w, h = int.from_bytes(data[16:20], "big"), int.from_bytes(data[20:24],
                                                                   "big")
        if data[:8] != b"\x89PNG\r\n\x1a\n" or (w, h) != (cfg.width,
                                                          cfg.height):
            fail(f"CLI wrote no {cfg.width}x{cfg.height} PNG")
        # the CLI renders the same scene and camera: the files must agree
        ref = os.path.join(tmp, "in_process.png")
        io.save_png(ref, img.cpu().numpy())
        with open(ref, "rb") as f:
            same = f.read() == data
        phase("cli", command=" ".join(cmd[1:4] + cmd[4:-1]),
              stdout=proc.stdout.strip(), png=f"{w}x{h}",
              identical_to_render=same)
        if not same:
            fail("the CLI's PNG differs from render()'s image")

    # -- phase 3b: the gradient path at full CONFIG3, the config-3 problem
    cfg = CONFIG3
    truth, scene0, cam3, target3, loss_fn = optim.inverse_render_problem(
        cfg, device=dev, vis_w=VIS_W)
    reset_counts(megakernel, gradkernel)
    loss, img, (sg, cg) = rt.render_grad(scene0, cam3, cfg, target3,
                                         vis_w=VIS_W)
    torch.cuda.synchronize()
    per_step = []

    def count_step(step, _loss):
        per_step.append((launch_count(megakernel), launch_count(gradkernel)))

    params, losses = optim.optimize(loss_fn, {"center": scene0.center[1]},
                                    steps=ADAM_STEPS, lr=ADAM_LR,
                                    callback=count_step)
    torch.cuda.synchronize()
    grad_launches = (launch_count(megakernel), launch_count(gradkernel))
    grads = [sg.center, sg.radius, sg.albedo, sg.mat_param, *cg]
    err0 = float((scene0.center[1] - truth.center[1]).norm())
    err1 = float((params["center"] - truth.center[1]).norm())
    phase("gradient_path", frame=f"{cfg.width}x{cfg.height} spp{cfg.spp} "
          f"d{cfg.depth} {cfg.rng_mode}", vis_w=VIS_W,
          render_grad_loss=float(loss), hero_center_grad=sg.center[1].tolist(),
          adam_lr=ADAM_LR, losses=losses, center_err_before=err0,
          center_err_after=err1, launches_k1a=grad_launches[0],
          launches_k3=grad_launches[1])
    want_counts = [(2 + i, 2 + i) for i in range(ADAM_STEPS)]
    if per_step != want_counts:
        fail(f"launch counts per step {per_step}, want {want_counts}: "
             "each step must run K1a once and K3 once")
    if not all(bool(torch.isfinite(g).all()) for g in grads):
        fail("render_grad returned non-finite gradients")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"the Adam losses are not finite and falling: {losses}")

    # -- phase 4: K1a times (CUDA events, after a warm-up call)
    timings = {}
    cfg_ref_plain = REFERENCE_V2.replace(spp=2, chunk_pixels=PLAIN_CHUNK)
    for label, cfg_t, scene_t, cam_t, iters_k, iters_p in (
            ("config2", CONFIG2, rt.config2_world(device=dev),
             v2_cam(CONFIG2), 20, 2),
            ("reference_v2", REFERENCE_V2, scene, cam, 5, None),
            ("reference_v2_spp2", cfg_ref_plain, scene, cam, 5, 1)):
        cp, sp = megakernel.pack_camera(cam_t), megakernel.pack_scene(scene_t)
        rays = cfg_t.width * cfg_t.height * cfg_t.spp
        row = {"frame": f"{cfg_t.width}x{cfg_t.height} spp{cfg_t.spp} "
                        f"d{cfg_t.depth}", "card": card}
        ms = cuda_ms(lambda: megakernel.launch(cp, sp, cfg_t),
                     iters_k)
        row.update(kernel_ms=ms, kernel_mrays_s=rays / ms / 1e3)
        if iters_p:
            pms = cuda_ms(lambda: golden.render_golden(
                scene_t, cam_t, cfg_t.replace(chunk_pixels=PLAIN_CHUNK)),
                iters_p)
            row.update(plain_ms=pms, plain_mrays_s=rays / pms / 1e3)
        timings[label] = row
        phase("timing", case=label, **row)

    # -- phase 4b: fwd+bwd (render_grad: K1a + K3) and K3 alone, beside
    # the plain versions (render_grad on the adjoint; the adjoint's VJP)
    c2_target = torch.full((CONFIG2.height, CONFIG2.width, 3), 0.5,
                           device=dev)
    rv2_target = torch.full((REFERENCE_V2.height, REFERENCE_V2.width, 3),
                            0.5, device=dev)
    cfg_c2p = CONFIG2.replace(rng_mode="parallel")
    c2_scene, c2_cam = rt.config2_world(device=dev), v2_cam(CONFIG2)
    grad_timings = {}
    for label, cfg_t, scene_t, cam_t, tgt, vis_w, iters, iters_p in (
            ("config3", CONFIG3, scene0, cam3, target3, 0.0, 10, 1),
            ("config3_vis_w", CONFIG3, scene0, cam3, target3, VIS_W, 10, 1),
            ("config2_parallel", cfg_c2p, c2_scene, c2_cam, c2_target, 0.0,
             10, 1),
            ("reference_v2_spp2", cfg_rv2, scene, cam, rv2_target, 0.0, 3,
             1),
            ("reference_v2", REFERENCE_V2, scene, cam, rv2_target, 0.0, 3,
             None)):
        rays = cfg_t.width * cfg_t.height * cfg_t.spp
        row = {"frame": f"{cfg_t.width}x{cfg_t.height} spp{cfg_t.spp} "
                        f"d{cfg_t.depth} {cfg_t.rng_mode}",
               "vis_w": vis_w, "card": card}
        fb = cuda_ms(lambda: rt.render_grad(scene_t, cam_t, cfg_t, tgt,
                                            vis_w=vis_w), iters)
        cp, sp = megakernel.pack_camera(cam_t), megakernel.pack_scene(scene_t)
        img_t = megakernel.launch(cp, sp, cfg_t)
        ct = 2.0 * (img_t - tgt) / img_t.numel()
        # the backward as render_grad runs it: parallel RNG elides PASS 1
        img_arg = img_t if cfg_t.rng_mode == "parallel" else None
        k3 = cuda_ms(lambda: gradkernel.launch(cp, sp, cfg_t, ct, img_arg,
                                               vis_w), iters)
        row.update(fwd_bwd_ms=fb, fwd_bwd_mrays_s=rays / fb / 1e3,
                   k3_ms=k3, k3_mrays_s=rays / k3 / 1e3)
        if iters_p:
            cfg_p = cfg_t.replace(chunk_pixels=PLAIN_CHUNK)
            pfb = cuda_ms(lambda: rt.render_grad(
                scene_t, cam_t, cfg_p, tgt, backend="golden", vis_w=vis_w),
                iters_p)
            pk3 = cuda_ms(lambda: gradkernel.render_vjp_plain(
                scene_t, cam_t, cfg_p, ct, vis_w), iters_p)
            row.update(plain_fwd_bwd_ms=pfb, plain_vjp_ms=pk3,
                       plain_vjp_mrays_s=rays / pk3 / 1e3)
        grad_timings[label] = row
        phase("grad_timing", case=label, **row)
    brute = brute_phase(dev, card, scene, cam, rv2_target, grad_timings)

    tape_pairs(dev, card)

    # -- phase 5: config 4 over a BVH, the tape
    entries = config4_phases(dev, card)

    # -- phase 6: config 5, progressive (K2) and sharded (slab mode)
    entries5 = config5_phases(dev, card)

    # -- phase 6e: the flat sweep's forward, warp counters and efficiencies
    flat_phase(dev, card, entries, entries5)

    # -- phase 7: the 10,000-sphere scene over the skip-pointer walk
    entries7 = large_scene_phases(dev, card)

    # -- phase 8: the dense stage K1e and the sorted wavefront (K5, K6)
    entries8 = wavefront_phases(dev, card, rv2_img)
    segment_phase(dev, card)

    # -- phase 9: K3's windowed refill
    entries9, entries["K3/bvh+refill"]["launches"], main9 = refill_phases(
        dev, card)
    vis = main9["config4_vis_w"]
    entries["K3/bvh+refill"].update(
        main_path_vis_w_ms=vis["k3"]["refill_ms"],
        main_path_vis_w_near_miss_ms=vis["k3"]["near_miss"]["refill"][
            "share_ms"],
        main_path_vis_w_bound_ms=vis["k3_bound"]["bound_ms"],
        main_path_vis_w_bound_by=vis["k3_bound"]["bound_by"])

    # -- phase 9c: K3 over the flat BVH redesigned, registers and staging
    k3_phase(dev, card, entries, vis)

    # -- phase 10: the v1 fract-sin mode at REFERENCE_V1_FAITHFUL
    fractsin_phase(dev, card)

    # bounds of K1a and K3 in the cells their times come from
    from raytpu_torch import profiling
    c_k1a = profiling.census(c2_scene, c2_cam, CONFIG2)
    c_k3 = profiling.census(scene0, cam3, CONFIG3)
    n3 = scene0.count
    src = "raytpu_torch/csrc/"
    fwd_src, grad_src = src + "megakernel.cu", src + "gradkernel.cu"
    k1a_bound = bound(forward_ops(c_k1a), frame_bytes(CONFIG2, 4, 1))
    table = [dict(
        name="render_fwd_kernel (K1a, brute sweep)", route="cuda",
        source=fwd_src, replaces="raytpu/kernels/megakernel.py:1456",
        cell="config 2", launches=grad_launches[0], max_abs_err=worst,
        ms=timings["config2"]["kernel_ms"],
        plain_ms=timings["config2"]["plain_ms"], **k1a_bound,
        main_path="config 2 render()",
        main_path_ms=brute["config2_render_ms"],
        main_path_bound_ms=k1a_bound["bound_ms"],
        loop_efficiency=brute["warps_k1a_config2"]["loop_efficiency"],
        sweep_efficiency=brute["warps_k1a_config2"]["sweep_efficiency"],
        efficiency_cell="config 2", library_ms=None), dict(
        name="render_vjp_kernel (K3, brute sweep)", route="cuda",
        source=grad_src, replaces="raytpu/kernels/gradkernel.py:1519",
        cell="config 3, vis_w 0.005", launches=grad_launches[1],
        max_abs_err=k3_worst_abs, max_rel_err=k3_worst_rel,
        ms=grad_timings["config3_vis_w"]["k3_ms"],
        plain_ms=grad_timings["config3_vis_w"]["plain_vjp_ms"],
        **bound(k3_ops(c_k3, 2, near_miss_tests=near_miss_tests(
            scene0, cam3, CONFIG3)), frame_bytes(CONFIG3, n3, 2) + 64 * n3),
        **brute["k3_main_path"], library_ms=None)]
    entries["K4/brute"].update(brute["k4_main_path"])
    entries["K3/refill+tape"].update(brute["k3_tape_main_path"])
    for key, name, source, replaces, cell in (
            ("K1c", "render_fwd_kernel<bvh> (K1c, flat BVH sweep)", fwd_src,
             "raytpu/kernels/megakernel.py:1456 (_flat_sweep_ti :246)",
             "config 4 at 2 spp, sequential"),
            ("K1'", "render_fwd_kernel<bvh, count> (K1', census)", fwd_src,
             "raytpu/kernels/megakernel.py:1456 (count_leaves :1554)",
             "config 4 at 2 spp, sequential"),
            ("K4/bvh", "render_fwd_kernel<bvh, tape write> (K4 write, BVH)",
             fwd_src, "raytpu/kernels/gradkernel.py:1873",
             "config 4 at 2 spp, parallel, full tape"),
            ("K4/brute", "render_fwd_kernel<tape write> (K4 write, brute)",
             fwd_src, "raytpu/kernels/gradkernel.py:1873",
             "config 4 at 2 spp, parallel, full tape"),
            ("K3/bvh", "render_vjp_kernel<bvh> (K3, flat BVH sweep)",
             grad_src, "raytpu/kernels/gradkernel.py:1519 (bvh=)",
             "config 4 at 2 spp, sequential"),
            ("K3/bvh+tape", "render_vjp_kernel<bvh, tape read> (K3 replay "
             "of K4, BVH)", grad_src,
             "raytpu/kernels/gradkernel.py:1519 (tape_mode='read' :1668)",
             "config 4 at 2 spp, parallel, full tape"),
            ("K3/tape", "render_vjp_kernel<tape read> (K3 replay of K4, "
             "brute)", grad_src,
             "raytpu/kernels/gradkernel.py:1519 (tape_mode='read' :1668)",
             "config 4 at 2 spp, parallel, full tape")):
        e = entries[key]
        table.append(dict(name=name, route="cuda", source=source,
                          replaces=replaces, cell=cell,
                          launches=e.pop("launches"), library_ms=None, **e))
    for key, name, source, replaces, cell in (
            ("K2/brute", "render_fwd_kernel<carry> (K2, brute)", fwd_src,
             "raytpu/kernels/megakernel.py:1742 (accumulate_pallas)",
             "480x270 spp4 d12 sequential final_world (launches: phase 6a)"),
            ("K2/bvh", "render_fwd_kernel<bvh, carry> (K2, flat BVH)",
             fwd_src,
             "raytpu/kernels/megakernel.py:1742 (accumulate_pallas, bvh=)",
             "480x270 spp4 d12 sequential final_world; error also on the "
             "config 5 frame, s0 250 (launches: config 5 progressive)"),
            ("K2/bvh+slab", "render_fwd_kernel<bvh, carry> on a row slab "
             "(K2 slab)", fwd_src,
             "raytpu/kernels/megakernel.py:1742 (row0/rows)",
             SLAB_CELL),
            ("K1b/bvh", "render_fwd_kernel<bvh> on a row slab (K1b)", fwd_src,
             "raytpu/kernels/megakernel.py:1456 (row0/rows)",
             SLAB_CELL),
            ("K4/bvh+slab", "render_fwd_kernel<bvh, tape write> on a row "
             "slab (K4 slab)", fwd_src,
             "raytpu/kernels/gradkernel.py:1873 (row0/rows)",
             SLAB_CELL + ", full tape"),
            ("K3/bvh+tape+slab", "render_vjp_kernel<bvh, tape read> on a row "
             "slab (K3 slab)", grad_src,
             "raytpu/kernels/gradkernel.py:1519 (row0/rows)",
             SLAB_CELL + ", full tape")):
        e = entries5[key]
        table.append(dict(name=name, route="cuda", source=source,
                          replaces=replaces, cell=cell,
                          launches=e.pop("launches"), library_ms=None, **e))
    big = (f"raytpu's {BIG_SPHERES}-sphere scene (scene file), 800x400 d12, "
           "all 400 rows as a slab at 2 spp")
    walk_ref = "raytpu/kernels/megakernel.py:1456 (the walk :640-696)"
    for key, name, source, replaces, cell in (
            ("K1d", "render_fwd_kernel<walk> (K1d, skip-pointer walk)",
             fwd_src, walk_ref, f"raytpu's {BIG_SPHERES}-sphere scene (scene "
             "file), 800x400 spp2 d12 parallel (plain: the same call as "
             "K1b's); error also on config 4's unpadded BVH"),
            ("K1b/walk", "render_fwd_kernel<walk> on a row slab (K1b walk)",
             fwd_src, walk_ref + " (row0/rows)", big + ", parallel"),
            ("K2/walk", "render_fwd_kernel<walk, carry> (K2 walk)", fwd_src,
             "raytpu/kernels/megakernel.py:1742 (accumulate_pallas, the "
             "walk :1786-1789)", big + ", parallel, 2 batches of 1"),
            ("K4/walk", "render_fwd_kernel<walk, tape write> (K4 write, "
             "walk)", fwd_src, "raytpu/kernels/gradkernel.py:1873 (the walk "
             ":1903-1905)", big + ", parallel, full tape"),
            ("K3/walk", "render_vjp_kernel<walk> (K3, skip-pointer walk)",
             grad_src, "raytpu/kernels/gradkernel.py:1519 (the walk "
             ":544-594)", big + ", sequential"),
            ("K3/walk+tape", "render_vjp_kernel<walk, tape read> (K3 replay "
             "of K4, walk)", grad_src, "raytpu/kernels/gradkernel.py:1519 "
             "(tape_mode='read', the walk past g_cap)",
             big + ", parallel, full tape")):
        e = entries7[key]
        table.append(dict(name=name, route="cuda", source=source,
                          replaces=replaces, cell=cell,
                          launches=e.pop("launches"), library_ms=None, **e))
    wf_src = src + "wavefront.cu"
    e = entries8["K1e"]
    table.append(dict(
        name="render_fwd_kernel<dense> (K1e, the dense stage: K1a's kernel)",
        route="cuda",
        source=fwd_src, replaces="raytpu/kernels/megakernel.py:1456 (dense "
        "branch :1497-1506, body :462-527)",
        cell="REFERENCE_V2 at 2 spp (plain version); main path: "
             "REFERENCE_V2 render(), phase 3",
        launches=fwd_variants.get("K1e", 0), library_ms=None, **e))
    for key in ("K5/brute", "K5/dense", "K5/bvh", "K5/walk"):
        table.append(dict(
            name=f"render_segment_kernel<{key[3:]}> (K5, wavefront segment)",
            route="cuda", source=wf_src,
            replaces="raytpu/wavefront.py:94 (_make_segment_kernel; "
                     "pallas_call :465)", library_ms=None, **entries8[key]))
    for key in ("K6/brute", "K6/dense", "K6/bvh", "K6/walk"):
        table.append(dict(
            name=f"render_refill_kernel<{key[3:]}> (K6, refill segment)",
            route="cuda", source=wf_src,
            replaces="raytpu/wavefront.py:192 (_make_refill_segment_kernel; "
                     "pallas_call :546)", library_ms=None, **entries8[key]))
    refill_ref = ("raytpu/kernels/gradkernel.py:1519 (p2_refill: PASS 2 "
                  ":999-1518, engaged :1557-1563)")
    c4_cell = "config 4 at 2 spp, parallel"
    for key, name, found, cell in (
            ("K3/refill", "render_vjp_kernel<refill> (K3 windowed refill, "
             "brute)", entries9, "config 2 at 2 spp, parallel (error also "
             "config 3's thin lens with vis_w 0.005); main path: config 2 "
             "render_grad"),
            ("K3/refill+tape", "render_vjp_kernel<tape read, refill> (K3 "
             "windowed refill replaying K4, brute)", entries,
             c4_cell + ", full tape; main path: config 4 render_grad, brute"),
            ("K3/bvh+refill", "render_vjp_kernel<bvh, refill> (K3 windowed "
             "refill, flat BVH)", entries, c4_cell + ", untaped; main path: "
             "config 4 render_grad with vis_w, the wavefront's autograd"),
            ("K3/bvh+refill+tape", "render_vjp_kernel<bvh, tape read, "
             "refill> (K3 windowed refill replaying K4, BVH)", entries,
             c4_cell + ", full tape; main path: config 4 render_grad"),
            ("K3/bvh+refill+tape+slab", "render_vjp_kernel<bvh, tape read, "
             "refill> on a row slab (K3 windowed refill, slab)", entries5,
             SLAB_CELL + ", full tape; main path: the config 5 train step"),
            ("K3/walk+refill", "render_vjp_kernel<walk, refill> (K3 "
             "windowed refill, skip-pointer walk)", entries7,
             big + ", parallel, untaped"),
            ("K3/walk+refill+tape", "render_vjp_kernel<walk, tape read, "
             "refill> (K3 windowed refill replaying K4, walk)", entries7,
             big + ", parallel, full tape")):
        e = found[key]
        table.append(dict(name=name, route="cuda", source=grad_src,
                          replaces=refill_ref, cell=cell,
                          launches=e.pop("launches"), library_ms=None, **e))
    missing = [e["name"] for e in table if not e["launches"]]
    if missing:
        fail(f"kernels not launched on their main path: {missing}")
    print(json.dumps({"kernels": table}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
