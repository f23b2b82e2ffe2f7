"""Fused image + VJP kernel K3 and the winner-index tape K4: wrapper of
``csrc/gradkernel.cu`` (and of the taping forward in ``csrc/megakernel.cu``).

Counterpart of ``raytpu/kernels/gradkernel.py::render_pallas_vjp`` with both
of its PASS 2 schedules, the per-sample pass and the windowed refill, the
brute-force sweep, the flat BVH sweep or the skip-pointer walk (by raytpu's
rule, :func:`raytpu_torch.bvh.sweep_of`), the tape replay and the slab mode
``row0`` / ``rows``, and of its ``tape_plan`` and ``render_tape_fwd``.  See
the notes at the top of the ``.cu`` files.

:func:`render_vjp` takes the scene and camera as the package's NamedTuples
and an image cotangent ``ct``.  For CPU tensors it runs the plain PyTorch
version (:func:`render_vjp_plain`, a VJP of
:func:`raytpu_torch.adjoint.render_golden_adjoint`, as raytpu's
``megakernel._golden_bwd``); for CUDA tensors it launches the kernel or
raises, never falling back.  :func:`launch` is the kernel wrapper proper, on
packed operands.  ``variants`` counts the kernel launches made through it
by variant.  The wrappers mark the host's preparation of a launch, the
launch and the scatter of its cotangents as the spans ``raytpu.pack``,
``raytpu.launch`` and ``raytpu.scatter``
(:func:`raytpu_torch.profiling.span`).

The windowed refill (raytpu's ``p2_refill``).  Given the forward image in
parallel RNG, PASS 2 runs on raytpu's refill schedule by raytpu's rule
(:func:`uses_refill`): persistent lanes, each taking its pixels in turn, a
finished sample's lane spawning the next one at once, one residual row per
bounce step in a window of steps that is reversed whole.  Its image is the
given one and its cotangents those of the per-sample pass, summed in
another order (allclose, not bit-equal).  :func:`refill_plan` sizes the
lanes and the window from :data:`REFILL_BUDGET`; ``p2_refill=False`` (or
:data:`P2_REFILL` set to False) forces the per-sample pass.

Without a BVH every K3 sweep is the forward's brute sweep, over the
scene's rows staged in shared memory up to :data:`megakernel.DENSE_MAX`
spheres (:func:`megakernel.brute_stage_bytes`), else over the scene pack.
Over a flat BVH every K3 sweep is the forward's K1c sweep, over the rows
:func:`k3_stage` plans to stage in shared memory (within what keeps the
kernel's blocks resident beside the refill's camera sums: a large BVH may
stage part of itself, the rest read from the scene pack).  The refill's
lanes count the staged bytes (:func:`refill_lanes`), the same for a taped
and an untaped launch of one scene.  Over the walk every K3 sweep is the
forward's K1d sweep, over the node rows ``BVH.walk_rows`` and the sphere
rows :func:`megakernel.sphere_rows` in device memory.

The tape (K4).  The taping forward (:func:`render_tape_fwd`) renders the
forward's image and logs, per pixel, the closest-hit winner of each bounce
step, counted across the pixel's samples in order: ``tape[k, pix]``, int16
below 32767 kernel-side spheres, else int32, -1 for a miss.  K3 replays it
in parallel RNG (the image given, so PASS 1 is elided), on either schedule:
each of the first ``g_cap`` steps takes its winner from the tape and
recomputes that one sphere's t, and the steps past the cap sweep.  The
winner alone decides a bounce, so taped gradients are bit-equal to untaped
ones for every ``g_cap`` from 0 to ``spp * depth``.  :func:`tape_plan`
decides when the gradient route (:mod:`raytpu_torch.autodiff`) tapes.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from raytpu_torch import adjoint, golden, profiling
from raytpu_torch.bvh import BVH, perm_rows, sweep_of
from raytpu_torch.camera import Camera
from raytpu_torch.config import RenderConfig
from raytpu_torch.kernels import _build, megakernel
from raytpu_torch.scene import Scene

SOURCE = "gradkernel.cu"
MAX_DEPTH = 64  # the kernel's per-thread residual rows (kMaxDepth)
LEAVES = 8      # sphere cotangent rows: cx cy cz rad ar ag ab mp
CAM_SUMS = 18   # raygen cotangent sums (raytpu gradkernel.py:960-969)


def _variant(sweep: str | None, refill: bool, tape: bool, slab: bool) -> str:
    """A launch's key in ``variants``: the sweep ("bvh" for the flat one,
    "walk"), "+refill" for the windowed refill, "+tape" for the tape
    replay, "+slab" for a launch given rows."""
    tags = "+".join(t for t, on in ((sweep, sweep is not None),
                                    ("refill", refill), ("tape", tape),
                                    ("slab", slab)) if on)
    return "K3/" + tags if tags else "K3"


# the launches by variant; a run resets and reads them
variants = dict.fromkeys(
    (_variant(sweep, refill, tape, slab) for sweep in (None, "bvh", "walk")
     for refill in (False, True) for tape in (False, True)
     for slab in (False, True)), 0)

# The tape's device-memory budget in bytes; a module constant (tests may
# monkeypatch it).  raytpu's default, 4 GiB: CONFIG4's full tape takes
# 768 MB (int16), REFERENCE_V2's 3.54 GB.
TAPE_BUDGET = 4 * 2**30
# A partial tape engages when it holds at least this share of the frame's
# worst-case steps (spp * depth a pixel).  On this card a covered step saves
# its sweep and an uncovered step costs what the untaped kernel pays, while
# the write side adds one 2- or 4-byte store per step, so any coverage pays
# in time; the floor only keeps the plan from holding gigabytes for a
# sliver of the steps.  (raytpu's 0.15 / 0.5 thresholds are TPU
# measurements of its windowed schedule and do not carry over.)
PARTIAL_MIN_COVERAGE = 0.05
# The fewest spheres at which the gradient route tapes.  Below it a step's
# sweep is too cheap to outweigh the tape's stores and reads: on an H100,
# render_grad at the config-2 frame in parallel RNG lost 7 of 10 pairs
# taped at 4 spheres (median +3.5%) and won 8 of 10 at 8 spheres (-5.5%),
# 10 of 10 from 32 (chip_smoke.py phase 4c).
TAPE_MIN_SPHERES = 8

# The windowed refill's residual scratch in bytes, the counterpart of
# raytpu's _P2_VMEM_BUDGET; a module constant (tests may monkeypatch it).
# It sizes the window (refill_plan).  The lanes are what the card keeps
# resident and do not grow with the frame (a lane hops over pixels), so the
# scratch stays within the budget on every frame: on an NVIDIA H100 80GB
# HBM3 (700.00 W power limit) 67584 lanes at most, and config 4 (64000
# lanes) gets a window of 174 steps, 14 samples of depth 12 (chip_smoke.py
# phase 9).
REFILL_BUDGET = 512 * 2**20
ROW_BYTES = 48       # a residual row: o, d, c, winner, seed, flags | sample
REFILL_BLOCK = 256   # threads a block of the refill grid (kRefillBlock)
# Whether p2_refill=None engages the refill where raytpu's rule does; False
# forces the per-sample pass on every path (raytpu's RAYTPU_GRAD_REFILL=0).
P2_REFILL = True


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.raytpu_render_vjp
    fn.argtypes = [ptr, ptr, i, ptr, i, i, ptr, i, i, i, i, i, i, i, i,
                   ptr, i, i, ptr, ptr, ptr, ptr, ptr,
                   i, i, i, i, i, i, f, f, f, f, f, f, i, i, i, i, i, ptr,
                   ptr, ptr]
    fn.restype = ctypes.c_int
    lib.raytpu_render_vjp_warps.argtypes = [i, i]
    lib.raytpu_render_vjp_warps.restype = ctypes.c_int
    lib.raytpu_render_vjp_refill_lanes.argtypes = [i]
    lib.raytpu_render_vjp_refill_lanes.restype = ctypes.c_int
    pi = ctypes.POINTER(ctypes.c_int)
    lib.raytpu_render_vjp_device.argtypes = [pi] * 5
    lib.raytpu_render_vjp_device.restype = ctypes.c_int
    return lib


def _index(device) -> int:
    index = torch.device(device).index
    return torch.cuda.current_device() if index is None else index


_lanes_cap: dict[tuple, int] = {}  # (device index, shmem) -> refill_lanes()


def refill_lanes(device, shmem: int = 0) -> int:
    """The refill's lane cap on a CUDA device: its SMs times the threads
    one SM keeps resident of the refill instantiation that keeps the
    fewest, the flat sweep's and the staged brute sweep's with ``shmem``
    bytes staged (the same for a taped and an untaped launch of one
    stage)."""
    key = (_index(device), int(shmem))
    if key not in _lanes_cap:
        with torch.cuda.device(key[0]):
            cap = _lib().raytpu_render_vjp_refill_lanes(key[1])
        if cap < REFILL_BLOCK:
            raise RuntimeError("the refill kernel keeps no block resident "
                               f"on cuda:{key[0]} with {key[1]} bytes staged")
        _lanes_cap[key] = cap
    return _lanes_cap[key]


_limits: dict[int, tuple] = {}  # device index -> device_limits()


def device_limits(device) -> tuple[int, int, int, int, int]:
    """(opt-in shared memory a block, an SM's shared memory, what a block
    reserves of it, blocks of K3's flat instantiations an SM keeps resident
    with nothing staged, the refill's static shared memory a block) on a
    CUDA device: what bounds K3's stage (:func:`stage_limit`)."""
    index = _index(device)
    if index not in _limits:
        vals = [ctypes.c_int() for _ in range(5)]
        with torch.cuda.device(index):
            err = _lib().raytpu_render_vjp_device(*map(ctypes.byref, vals))
        if err != 0:
            raise RuntimeError(f"raytpu_render_vjp_device failed: CUDA error "
                               f"{err}")
        _limits[index] = tuple(v.value for v in vals)
    return _limits[index]


def stage_limit(optin: int, per_sm: int, reserved: int, blocks: int,
                fixed: int) -> int:
    """The bytes K3 stages a block at most: within the opt-in limit and
    small enough that ``blocks`` blocks an SM (what K3's registers allow)
    stay resident, each beside ``fixed`` static bytes (the refill's camera
    sums, 18 f64 a thread).  On an H100: min(232448, 233472 // 2 - 1024) -
    36864 = 78848."""
    return max(0, min(optin, per_sm // blocks - reserved) - fixed)


def k3_stage(bvh: BVH, device) -> dict:
    """What K3 stages of the flat ``bvh`` in shared memory on a CUDA
    device (:func:`megakernel.flat_stage` within :func:`stage_limit`)."""
    return megakernel.flat_stage(bvh, stage_limit(*device_limits(device)))


_NO_STAGE = {"leaves": 0, "outliers": 0, "boxes": 0, "bytes": 0}


def launch_plan(cfg: RenderConfig, rows: int, scene_pack: torch.Tensor,
                bvh: BVH | None, refill: bool) -> tuple[dict, dict | None]:
    """A launch's (stage, refill plan) on ``scene_pack``'s device: over a
    flat BVH its :func:`k3_stage`, without a BVH the brute sweep's
    :func:`megakernel.brute_stage_bytes` of the pack's spheres (nothing
    else staged), over the walk nothing; and on the refill
    :func:`refill_plan` of the lanes with those bytes staged, so a taped
    and an untaped launch of one scene get the same lanes."""
    device = scene_pack.device
    if bvh is None:
        stage = {**_NO_STAGE,
                 "bytes": megakernel.brute_stage_bytes(scene_pack.shape[1])}
    elif sweep_of(bvh) == "flat":
        stage = k3_stage(bvh, device)
    else:
        stage = _NO_STAGE
    plan = (refill_plan(cfg, rows, refill_lanes(device, stage["bytes"]))
            if refill else None)
    return stage, plan


def uses_refill(cfg: RenderConfig, img, p2_refill: bool | None = None
                ) -> bool:
    """raytpu's rule (gradkernel.py:1557-1563): PASS 2 runs on the windowed
    refill when the forward image is given in parallel RNG (PASS 1 elided)
    and ``p2_refill`` is True, or None and :data:`P2_REFILL` holds;
    otherwise on the per-sample pass (sequential RNG always)."""
    skip_p1 = img is not None and cfg.rng_mode == "parallel"
    return bool(P2_REFILL if p2_refill is None else p2_refill) and skip_p1


def refill_plan(cfg: RenderConfig, rows: int, lanes_cap: int) -> dict:
    """The windowed refill's layout for a launch of ``rows`` rows (raytpu's
    ``_p2_plan``) -> ``{"lanes", "hops", "window", "bytes"}``.

    ``lanes_cap`` (a multiple of :data:`REFILL_BLOCK`): the lanes the card
    keeps resident (:func:`refill_lanes`).  A lane takes ``hops`` pixels,
    lane ``l``'s pixel of hop ``m`` being ``l + m * lanes``: ``hops =
    ceil(pixels / lanes_cap)`` and ``lanes`` = ``ceil(pixels / hops)``
    rounded up to a block, so every lane has ``hops`` pixels or one fewer
    and no block waits for a free SM.  ``window`` = ``max(depth, min(spp *
    depth, REFILL_BUDGET // (lanes * ROW_BYTES)))`` steps (raytpu's
    ``p2_steps``); ``bytes``, the residual scratch, exceeds the budget only
    where one full-depth sample a lane does not fit it."""
    pixels = rows * cfg.width
    hops = -(-pixels // lanes_cap)
    lanes = -(-pixels // hops)
    lanes = -(-lanes // REFILL_BLOCK) * REFILL_BLOCK
    window = max(cfg.depth, min(cfg.spp * cfg.depth,
                                REFILL_BUDGET // (lanes * ROW_BYTES)))
    return {"lanes": lanes, "hops": hops, "window": window,
            "bytes": lanes * window * ROW_BYTES}


def _scene_grads(center, radius, albedo, mat_param) -> Scene:
    """A gradient Scene: the continuous leaves, ``mat_type`` None."""
    return Scene(center=center, radius=radius, mat_type=None, albedo=albedo,
                 mat_param=mat_param)


def camera_grads(sums: torch.Tensor, cam: Camera) -> Camera:
    """The Camera cotangent from the kernel's 18 raygen sums, the host
    assembly of raytpu's gradkernel.py:1745-1766: effective origin (d_o -
    d_d), d_d, u * d_d, v * d_d, ldx * eo and ldy * eo, each summed over
    pixels and samples.  A pinhole camera never consumes its lens offset,
    so its lens cotangents are exactly zero (the ``live`` mask)."""
    sum_eo, sum_dd = sums[0:3], sums[3:6]
    sum_udd, sum_vdd = sums[6:9], sums[9:12]
    sum_ldx_eo, sum_ldy_eo = sums[12:15], sums[15:18]
    lens_r = cam.lens_radius
    live = torch.where(lens_r > 0, 1.0, 0.0)
    return Camera(
        origin=sum_eo,
        horizontal=sum_udd,
        vertical=sum_vdd,
        lower_left=sum_dd,
        u=live * lens_r * sum_ldx_eo,
        v=live * lens_r * sum_ldy_eo,
        lens_radius=live * (torch.dot(cam.u, sum_ldx_eo)
                            + torch.dot(cam.v, sum_ldy_eo)),
    )


def _check_frame(cfg: RenderConfig, ct: torch.Tensor, img, device,
                 rows: int | None = None):
    shape = (cfg.height if rows is None else rows, cfg.width, 3)
    for name, t in (("ct", ct), ("img", img)):
        if t is None:
            continue
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want torch.float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, the scene on {device}")


def launch(cam_pack: torch.Tensor, scene_pack: torch.Tensor,
           cfg: RenderConfig, ct: torch.Tensor, img=None, vis_w: float = 0.0,
           bvh: BVH | None = None, tape: torch.Tensor | None = None,
           row0: int = 0, rows: int | None = None,
           p2_refill: bool | None = None):
    """Launch K3 on packed operands -> (image, (8, P) sphere cotangents,
    (18,) camera sums), the sums in f64 as the kernel accumulates them
    (the caller casts them to f32, after a sharded step's all-reduce).

    ``img`` (parallel RNG only) is the forward image: it elides PASS 1, and
    PASS 2 then runs on the windowed refill unless ``p2_refill`` says
    otherwise (:func:`uses_refill`, :func:`refill_plan`).
    Sequential RNG chains each pixel's seed through its samples, so PASS 1
    must run and ``img`` is ignored there, as in raytpu.  ``bvh``: the flat
    BVH sweep or the walk (:func:`raytpu_torch.bvh.sweep_of`);
    ``scene_pack`` is then in leaf order (P permuted rows) and the
    cotangents in that order.  ``tape`` (g_cap, rows*W), a winner-index
    tape of this frame from :func:`render_tape_fwd` with the same ``bvh``
    and slab: the replay; it needs parallel RNG and ``img``.  ``row0`` /
    ``rows``: the slab (:func:`megakernel.slab`); ``ct`` and ``img`` are
    then (rows, W, 3).  Runs on the current stream of the operands' device
    and does not synchronise."""
    megakernel.check_packs(cam_pack, scene_pack)
    if cfg.depth > MAX_DEPTH:
        raise ValueError(f"depth {cfg.depth}: the VJP kernel keeps at most "
                         f"{MAX_DEPTH} bounces of residuals per thread")
    slabbed = rows is not None
    row0, rows = megakernel.slab(cfg, row0, rows)
    device = scene_pack.device
    n = scene_pack.shape[1]
    skip_p1 = img is not None and cfg.rng_mode == "parallel"
    refill = uses_refill(cfg, img, p2_refill)
    img_in = img if skip_p1 else None
    _check_frame(cfg, ct, img_in, device, rows)
    if bvh is not None:
        megakernel.check_bvh(bvh, n, device)
    if tape is not None:
        if not skip_p1:
            raise ValueError("the tape replay needs parallel RNG and the "
                             "forward image (img=)")
        megakernel.check_tape(tape, cfg, n, device, rows)
    # the operands and outputs, the stage and refill plans
    with profiling.span("raytpu.pack"):
        ct = ct.contiguous()
        img_in = None if img_in is None else img_in.detach().contiguous()
        lib = _lib()
        out = torch.empty((rows, cfg.width, 3), dtype=torch.float32,
                          device=device)
        gsc = torch.zeros((LEAVES, n), dtype=torch.float64, device=device)
        stage, plan = launch_plan(cfg, rows, scene_pack, bvh, refill)
        walk = bvh is not None and sweep_of(bvh) == "walk"
        node_rows = bvh.walk_rows if walk else None
        spheres = megakernel.sphere_rows(scene_pack) if walk else None
        scratch = None
        if refill:
            if plan["hops"] * cfg.spp >= 2**28:
                raise ValueError(f"{plan['hops']} pixels a lane at "
                                 f"{cfg.spp} spp: the refill numbers a "
                                 "lane's samples below 2^28")
            scratch = torch.empty(plan["bytes"] // 4, dtype=torch.int32,
                                  device=device)
        # one row of camera sums per warp, summed below in a fixed order
        n_warps = (plan["lanes"] // 32 if refill
                   else lib.raytpu_render_vjp_warps(cfg.width, rows))
        gcam = torch.empty((n_warps, CAM_SUMS), dtype=torch.float64,
                           device=device)
    with torch.cuda.device(device), profiling.span("raytpu.launch"):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.raytpu_render_vjp(
            cam_pack.data_ptr(), scene_pack.data_ptr(), n,
            *megakernel.bvh_args(bvh, node_rows), stage["leaves"],
            stage["outliers"], stage["boxes"], int(tape is not None),
            None if tape is None or tape.numel() == 0 else tape.data_ptr(),
            0 if tape is None else tape.shape[0],
            int(tape is not None and tape.dtype == torch.int32),
            ct.data_ptr(), None if img_in is None else img_in.data_ptr(),
            out.data_ptr(), gsc.data_ptr(), gcam.data_ptr(),
            cfg.width, cfg.height, row0, rows, cfg.spp, cfg.depth,
            float(np.float32(cfg.t_min)),
            float(np.float32(1.0 / (cfg.width - 1))),
            float(np.float32(1.0 / (cfg.height - 1))),
            float(np.float32(1.0 / cfg.spp)),
            float(np.float32(cfg.gamma)), float(np.float32(vis_w)),
            int(cfg.rng_mode == "parallel"), int(cfg.scatter_mode == "v1"),
            int(refill), plan["lanes"] if refill else 0,
            plan["window"] if refill else 0,
            None if scratch is None else scratch.data_ptr(),
            None if spheres is None else spheres.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"render_vjp_kernel launch failed: CUDA error {err}")
    variants[_variant(None if bvh is None else megakernel.sweep_tag(bvh),
                      refill, tape is not None, slabbed)] += 1
    return out, gsc, gcam.sum(dim=0)


def _reduced(grads: list, reduce) -> list:
    """``grads`` (tensors of one dtype) summed in place across processes
    by ``reduce``, as one 1-D tensor of that dtype, and split back."""
    flat = torch.cat([g.reshape(-1) for g in grads])
    reduce(flat)
    out, i = [], 0
    for g in grads:
        out.append(flat[i:i + g.numel()].reshape(g.shape))
        i += g.numel()
    return out


def render_vjp_plain(scene: Scene, cam: Camera, cfg: RenderConfig, ct,
                     vis_w: float = 0.0, bvh: BVH | None = None, tape=None,
                     row0: int = 0, rows: int | None = None, reduce=None):
    """The plain version of K3 on any device: the VJP of the adjoint
    renderer for the image cotangent ``ct`` -> (img, d_scene, d_cam).
    It is the plain version of both PASS 2 schedules, the per-sample pass
    and the windowed refill: they compute this one function and differ only
    in the order their cotangent terms are summed.
    ``bvh`` sweeps the BVH by its sweep; ``tape`` replays a winner-index tape
    (the plain version of K3's tape read); ``row0`` / ``rows`` take the
    slab; ``reduce`` sums the f32 cotangents across processes (see
    :func:`render_vjp`)."""
    leaves = [t.detach().requires_grad_()
              for t in (scene.center, scene.radius, scene.albedo,
                        scene.mat_param, *cam)]
    with torch.enable_grad():
        img = adjoint.render_golden_adjoint(
            Scene(leaves[0], leaves[1], scene.mat_type, leaves[2],
                  leaves[3]), Camera(*leaves[4:]), cfg, vis_w, bvh=bvh,
            tape=tape, row0=row0, rows=rows)
        # a slab wholly past the frame renders nothing: no graph
        grads = (torch.autograd.grad(img, leaves, ct, allow_unused=True)
                 if img.requires_grad else [None] * len(leaves))
    grads = [torch.zeros_like(x) if g is None else g
             for g, x in zip(grads, leaves)]
    if reduce is not None:
        grads = _reduced(grads, reduce)
    return img.detach(), _scene_grads(*grads[:4]), Camera(*grads[4:])


def _kernel_rows(scene: Scene, bvh: BVH | None) -> int:
    """Spheres the kernels see: the permuted rows, dummies included."""
    return scene.count if bvh is None else int(bvh.perm.shape[0])


def render_vjp(scene: Scene, cam: Camera, cfg: RenderConfig, ct, img=None,
               vis_w: float = 0.0, bvh: BVH | None = None, tape=None,
               tape_partial: bool = False, row0: int = 0,
               rows: int | None = None, reduce=None,
               p2_refill: bool | None = None):
    """Fused image + VJP -> (img, d_scene, d_cam) for the image cotangent
    ``ct`` (H, W, 3), the counterpart of raytpu's ``render_pallas_vjp``.
    ``row0`` / ``rows``: the slab (``ct``, ``img`` and the tape of its
    rows); rows past the frame add nothing.  ``reduce``, a callable, is
    given the cotangents as one 1-D tensor (sphere sums, then camera sums)
    to sum in place across the processes of a sharded step: the kernel's
    f64 sums before their cast to f32, the plain version's f32 cotangents.

    ``d_scene.mat_type`` is None (a discrete leaf); ``d_scene`` is in the
    input order of the spheres, also with ``bvh`` (the kernel accumulates
    in leaf order and the cotangents are gathered back by ``perm``,
    dummies dropped: :func:`input_order`).  ``img`` (parallel RNG) elides
    the kernel's PASS 1, and its PASS 2 then runs on the windowed refill
    by raytpu's rule (:func:`uses_refill`; ``p2_refill=False`` forces the
    per-sample pass); the plain version ignores both.  ``vis_w > 0`` adds
    raytpu's silhouette (boundary) gradients.  ``tape`` (from
    :func:`render_tape_fwd` with the same ``bvh``, parallel RNG, ``img``
    given) is replayed instead of sweeping its steps; ``tape_partial``
    says whether it holds fewer than ``spp * depth`` steps a pixel, and a
    tape that disagrees is refused.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    adjoint.check_cfg(cfg)
    device = megakernel.check_inputs(scene, cam, cfg)
    slabbed = rows is not None
    row0, rows = megakernel.slab(cfg, row0, rows)
    ct = torch.as_tensor(ct, dtype=torch.float32, device=device)
    _check_frame(cfg, ct, img, device, rows)
    n = _kernel_rows(scene, bvh)
    if bvh is not None:
        megakernel.check_bvh(bvh, n, device)
    if tape is not None:
        if cfg.rng_mode != "parallel" or img is None:
            raise ValueError("the tape replay needs parallel RNG and the "
                             "forward image (img=)")
        megakernel.check_tape(tape, cfg, n, device, rows)
        if (tape.shape[0] < cfg.spp * cfg.depth) != bool(tape_partial):
            raise ValueError(
                f"tape of {tape.shape[0]} steps a pixel passed as "
                f"{'partial' if tape_partial else 'full'} for a frame of "
                f"{cfg.spp * cfg.depth}")
    if device.type == "cpu":
        return render_vjp_plain(scene, cam, cfg, ct, vis_w, bvh, tape, row0,
                                rows, reduce)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    with profiling.span("raytpu.pack"):
        cam_pack, packed = megakernel.pack(scene, cam, bvh)
    out, gsc, gcam = launch(cam_pack, packed, cfg, ct, img, vis_w, bvh, tape,
                            row0, rows if slabbed else None, p2_refill)
    if reduce is not None:
        gsc, gcam = _reduced([gsc, gcam], reduce)
    with profiling.span("raytpu.scatter"):
        gsc, gcam = gsc.to(torch.float32), gcam.to(torch.float32)
        if bvh is not None:
            gsc = input_order(gsc, bvh.perm, scene.count)
        d_scene = _scene_grads(gsc[0:3].T.contiguous(), gsc[3],
                               gsc[4:7].T.contiguous(), gsc[7])
        return out, d_scene, camera_grads(gcam, cam)


def input_order(gsc: torch.Tensor, perm, n: int) -> torch.Tensor:
    """(8, P) sphere cotangents in leaf order -> (8, n) in the spheres'
    input order: each sphere takes its row's column (:func:`perm_rows`),
    one gather of fixed shape, so nothing waits on the device; the
    dummies' columns drop out, and a sphere with no row reads the zero
    column padded on: its cotangent is 0."""
    leaf_row = perm_rows(perm, n, gsc.device).leaf_row
    return torch.nn.functional.pad(gsc, (0, 1))[:, leaf_row]


def tape_plan(cfg: RenderConfig, n: int, bvh: BVH | None = None,
              vis_w: float = 0.0, rows: int | None = None):
    """-> ``{"g_cap", "bytes", "partial"}`` when the gradient route tapes,
    else None (raytpu's ``tape_plan`` gate, with the port's sizing).

    Tapes in parallel RNG only (K3 elides PASS 1 there, so the replay has
    the forward's per-sample streams), with ``vis_w == 0`` (the
    silhouette terms' near-miss sweep keeps the sweeping kernel) and from
    :data:`TAPE_MIN_SPHERES` spheres (raytpu's scene-size gate).  A full
    tape, ``g_cap = spp * depth`` steps a pixel, when it fits
    :data:`TAPE_BUDGET`; else a partial tape of as many steps as fit, when
    that is at least :data:`PARTIAL_MIN_COVERAGE` of ``spp * depth``; else
    None.  ``n`` is the scene's sphere count; the element type follows the
    kernel-side rows (``bvh.perm``'s length with a BVH).  ``rows``: the
    tape of a ``rows``-row slab (raytpu's ``rows=slab``)."""
    if (cfg.rng_mode != "parallel" or vis_w != 0.0
            or n < TAPE_MIN_SPHERES):
        return None
    kernel_rows = n if bvh is None else int(bvh.perm.shape[0])
    elt = torch.empty((), dtype=golden.tape_dtype(kernel_rows)).element_size()
    # one step of every pixel
    plane = (cfg.height if rows is None else rows) * cfg.width * elt
    worst = cfg.spp * cfg.depth
    g_fit = TAPE_BUDGET // plane
    if worst <= g_fit:
        return {"g_cap": worst, "bytes": worst * plane, "partial": False}
    if g_fit < 1 or g_fit < PARTIAL_MIN_COVERAGE * worst:
        return None
    return {"g_cap": int(g_fit), "bytes": int(g_fit) * plane, "partial": True}


def render_tape_fwd(scene: Scene, cam: Camera, cfg: RenderConfig,
                    g_cap: int, bvh: BVH | None = None, row0: int = 0,
                    rows: int | None = None):
    """The taping forward -> (img, tape): the forward's image (K1a's, or
    K1c's or K1d's with ``bvh``, bit for bit: the same device function
    traces it)
    and the winner-index tape, (g_cap, H*W) of :func:`golden.tape_dtype`,
    ``tape[k, pix]`` the winner (a permuted index under a BVH, -1 for a
    miss) of pixel ``pix``'s k-th bounce step across its samples in order.
    Slots no step reached are left as allocated: the replay never reads
    them, since it takes the forward's steps again (the plain version marks
    them ``golden.TAPE_UNWRITTEN``; ``profiling.census`` counts the steps).
    ``row0`` / ``rows``: the slab, image (rows, W, 3) and tape (g_cap,
    rows*W).  CPU tensors take the plain version (:func:`golden.render_golden_tape`);
    CUDA tensors launch the taping forward kernel."""
    device = megakernel.check_inputs(scene, cam, cfg)
    slabbed = rows is not None
    row0, rows = megakernel.slab(cfg, row0, rows)
    n = _kernel_rows(scene, bvh)
    if bvh is not None:
        megakernel.check_bvh(bvh, n, device)
    if not 0 <= g_cap <= cfg.spp * cfg.depth:
        raise ValueError(f"g_cap {g_cap}: a frame of {cfg.spp} samples and "
                         f"depth {cfg.depth} has at most "
                         f"{cfg.spp * cfg.depth} steps a pixel")
    if device.type == "cpu":
        return golden.render_golden_tape(scene, cam, cfg, g_cap, bvh, row0,
                                         rows)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    with profiling.span("raytpu.pack"):
        tape = torch.empty((g_cap, rows * cfg.width),
                           dtype=golden.tape_dtype(n), device=device)
        cam_pack, packed = megakernel.pack(scene, cam, bvh)
    img = megakernel.launch(cam_pack, packed, cfg, bvh, tape=tape, row0=row0,
                            rows=rows if slabbed else None)
    return img, tape
