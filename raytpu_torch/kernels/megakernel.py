"""Forward render megakernels: wrapper of ``csrc/megakernel.cu``.

Counterpart of ``raytpu/kernels/megakernel.py::render_pallas`` and
``_render_pallas_fwd_impl``, of ``accumulate_pallas`` and of the write side
of ``raytpu/kernels/gradkernel.py::render_tape_fwd``.  One kernel
template, variants by operand: K1a (the brute-force sphere sweep, over the
scene's rows staged in shared memory up to :data:`DENSE_MAX` spheres,
:func:`brute_stage_bytes`), K1e (the dense stage: raytpu's name for the
same launch where its rule, :func:`use_dense`, takes the scene), K1c and K1d
(``bvh=``: over the scene in leaf order, the flat
leaf-list sweep or the skip-pointer walk by raytpu's rule,
:func:`raytpu_torch.bvh.sweep_of`: the walk past
:data:`raytpu_torch.bvh.FLAT_MAX_LEAVES` leaves a copy and for unpadded
BVHs), K1' (``count=True``: the census of leaves entered, bounce steps,
samples and nodes visited), K4's write side (``tape=``: the taping forward,
the same image plus each step's winner) and K2 (:func:`accumulate`: one
progressive batch on carried linear sums and seeds).  Every variant takes
raytpu's slab mode, ``row0`` / ``rows``: rows ``[row0, row0 + rows)`` of
the cfg-sized frame, with the image, the tape and the carried state
``(rows, W, ...)`` (K1b is the forward in slab mode).  A slab may run
past the frame's last row; those rows trace nothing and come out 0.  Every
variant runs on a persistent grid whose lanes take their next pixel from
a counter the C entry point zeroes each launch (one a device and stream,
:func:`slot_counter`); see the note at the top of the ``.cu`` file.
The walk reads its node rows in the 16-byte layout of
:func:`raytpu_torch.bvh.pack_walk_rows` (``BVH.walk_rows``) and the
spheres as 16-byte rows (:func:`sphere_rows`).

:func:`render_fwd` and :func:`accumulate` take the scene and camera as the
package's NamedTuples.  For CPU tensors they run the plain PyTorch versions
(:func:`raytpu_torch.golden.render_golden` and
:func:`raytpu_torch.golden.accumulate_golden`, with a BVH their sweep by the
same rule, :func:`raytpu_torch.golden.hit_bvh`); for CUDA tensors they
launch the kernel or raise — they never fall back, and a walk BVH always
launches a walk variant.  :func:`launch` and :func:`launch_accumulate` are
the kernel wrappers proper, on the packed operands the kernel reads (a
BVH from :func:`raytpu_torch.bvh.with_sweep` forces a sweep, for
``chip_smoke.py`` and the tests).  ``variants`` counts the kernel
launches made through them by variant; a launch given ``rows`` (the
sharded paths pass it, a world of one included) counts as a slab
launch.  The wrappers mark the host's preparation of a launch and the
launch itself as the spans ``raytpu.pack`` and ``raytpu.launch``
(:func:`raytpu_torch.profiling.span`).

Under autograd (any continuous leaf requires grad) :func:`render_fwd` goes
through :class:`_Render`, the counterpart of raytpu's ``custom_vjp``s
around ``_render_pallas`` and ``_render_pallas_bvh``
(raytpu/kernels/megakernel.py:1634-1739), with or without a BVH: the
forward is this kernel, the backward the fused VJP kernel K3
(``raytpu_torch/kernels/gradkernel.py``), which takes the forward image in
parallel RNG mode so as to skip its own PASS 1.  Where
:func:`raytpu_torch.kernels.gradkernel.tape_plan` applies (parallel RNG,
``vis_w == 0``, the tape within its budget) the forward is the taping one
and K3 replays its tape instead of sweeping.  The taping forward traces
through the same device function as K1a / K1c / K1d, so the image under
grad is the image without it, bit for bit (raytpu's taping forward runs another
schedule and may differ by FMA contraction; here that cannot arise).  On
CPU tensors the same Functions run the plain versions of every piece
(golden forward, golden taping forward, the adjoint's VJP and its tape
replay).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from raytpu_torch import golden, profiling
from raytpu_torch.bvh import BVH, outlier_tail, permute_scene, sweep_of
from raytpu_torch.camera import Camera
from raytpu_torch.config import RenderConfig
from raytpu_torch.kernels import _build
from raytpu_torch.scene import Scene

SOURCE = "megakernel.cu"
CAM_PACK = 19   # origin, horizontal, vertical, lower_left, u, v, lens_radius
SCENE_ROWS = 9  # cx, cy, cz, radius, mat_type, ar, ag, ab, mat_param
# the dense stage's scene sizes (raytpu's _DENSE_MIN / _DENSE_MAX), which
# name a brute launch K1e here; the brute sweep stages its rows up to 4096
# spheres, 64 KB of shared memory a block (csrc/render_common.cuh
# kDenseMax)
DENSE_MIN = 96
DENSE_MAX = 4096

# the kernel launches by variant: K1a brute, K1c flat BVH, K1d the walk,
# K1e the dense stage, K1b a slab (by sweep), K1' census (K1'/dense:
# warp_census over the dense stage), K2 carry-state batch and K4 taping
# forward (by sweep, "+slab" for a slab); the sweeps are "brute", "bvh"
# (flat) and "walk"; a run resets and reads them
SWEEP_TAGS = ("brute", "bvh", "walk")
# the counters the census kernel adds after golden.CENSUS's counts (see
# warp_census)
WARP_CENSUS = ("warp_steps", "warp_sphere_tests", "warp_node_steps",
               "lane_sphere_tests")
variants = dict.fromkeys(
    ("K1a", "K1c", "K1d", "K1e", "K1b/dense", "K1'/dense")
    + tuple(f"{k}/{sweep}" for k in ("K1b", "K1'") for sweep in SWEEP_TAGS)
    + tuple(f"{k}/{sweep}{slab}" for k in ("K2", "K4")
            for sweep in SWEEP_TAGS for slab in ("", "+slab")), 0)

_SCENE_SPEC = {"center": (torch.float32, 2), "radius": (torch.float32, 1),
               "mat_type": (torch.int32, 1), "albedo": (torch.float32, 2),
               "mat_param": (torch.float32, 1)}


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.raytpu_render_fwd
    fn.argtypes = [ptr, ptr, i, ptr, i, i, ptr, i, i, i, i, i, i, i, i,
                   ptr, i, i, ptr, i, ptr, ptr, ptr, ptr, ctypes.c_uint, ptr,
                   i, i, i, i, i, i, f, f, f, f, f, i, i, ptr, ptr]
    fn.restype = ctypes.c_int
    pi = ctypes.POINTER(ctypes.c_int)
    lib.raytpu_flat_device.argtypes = [i, pi, pi]
    lib.raytpu_flat_device.restype = ctypes.c_int
    return lib


def use_dense(n: int, bvh: BVH | None) -> bool:
    """The dense stage's policy, raytpu's ``_use_dense(n, interpret=False,
    has_bvh)`` (raytpu/kernels/megakernel.py:1415-1430): no BVH and
    ``DENSE_MIN <= n <= DENSE_MAX`` spheres.  It names the plain forward
    (K1e, ``K1b/dense`` on a slab) and :func:`warp_census`'s launch
    (``K1'/dense``), which run the brute sweep's kernel, and it picks the
    wavefront's dense segment kernels; K2, K4, the census K1' and K3 keep
    raytpu's brute names."""
    return bvh is None and DENSE_MIN <= n <= DENSE_MAX


def brute_stage_bytes(n: int) -> int:
    """The shared memory a block of the brute sweep (the forward and K3
    without a BVH) stages: the rows (cx, cy, cz, rad * rad) of a scene of
    ``n`` spheres, 16 bytes a sphere, up to :data:`DENSE_MAX` spheres (64
    KB); 0 past it, where the sweep reads the scene pack.  The C entry
    points pick the form by ``n`` themselves (csrc/render_common.cuh
    ``kDenseMax``, ``stage_dense``); K3's refill plan counts these bytes
    for its lanes (``gradkernel.launch_plan``)."""
    return 16 * n if n <= DENSE_MAX else 0


def slab(cfg: RenderConfig, row0: int = 0,
         rows: int | None = None) -> tuple[int, int]:
    """``(row0, rows)`` checked: the whole frame when ``rows`` is None,
    else ``rows >= 1`` rows from absolute row ``row0 >= 0`` (a slab may run
    past the frame's last row, as the last slab of an uneven split does)."""
    if rows is None:
        if row0:
            raise ValueError("row0 needs rows")
        return 0, cfg.height
    row0, rows = int(row0), int(rows)
    if row0 < 0 or rows < 1:
        raise ValueError(f"slab: want row0 >= 0 and rows >= 1, got row0 "
                         f"{row0}, rows {rows}")
    return row0, rows


def _u32_bits(seed: torch.Tensor) -> torch.Tensor:
    """The int64 carrier of u32 seeds (:mod:`raytpu_torch.rng`) as int32
    tensors with the same 32 bits, the kernel's ``uint32_t`` layout."""
    return torch.where(seed >= 2**31, seed - 2**32, seed).to(torch.int32)


def check_inputs(scene: Scene, cam: Camera, cfg: RenderConfig) -> torch.device:
    """Raise on anything the kernel (or its plain version) does not take;
    return the one device every input lies on."""
    if cfg.rng_mode == "v1_fractsin":
        raise ValueError(
            "rng_mode='v1_fractsin' is golden-only, as in raytpu: no kernel "
            "takes it; render() and progressive run the plain version "
            "(golden.render_golden) for it on any device")
    if cfg.rng_mode not in ("sequential", "parallel"):
        raise ValueError(f"unknown rng_mode: {cfg.rng_mode!r}")
    if cfg.scatter_mode not in ("v2", "v1"):
        raise ValueError(f"unknown scatter_mode: {cfg.scatter_mode!r}")
    if cfg.width < 2 or cfg.height < 2 or cfg.spp < 1 or cfg.depth < 0:
        raise ValueError(f"unsupported frame: {cfg.width}x{cfg.height}, "
                         f"spp {cfg.spp}, depth {cfg.depth}")
    n = scene.center.shape[0] if scene.center.dim() == 2 else -1
    if n < 1:
        raise ValueError("the scene needs at least one sphere, center (N, 3)")
    tensors = []
    for name, (dtype, dim) in _SCENE_SPEC.items():
        t = getattr(scene, name)
        shape = (n, 3) if dim == 2 else (n,)
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"scene.{name}: want {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        tensors.append((f"scene.{name}", t))
    for name in Camera._fields:
        t = getattr(cam, name)
        shape = () if name == "lens_radius" else (3,)
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"cam.{name}: want torch.float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        tensors.append((f"cam.{name}", t))
    device = scene.center.device
    for name, t in tensors:
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, scene.center on "
                             f"{device}")
    return device


def pack_camera(cam: Camera) -> torch.Tensor:
    """(19,) f32 on the camera's device, in the kernel's CamPack order."""
    return torch.cat([cam.origin, cam.horizontal, cam.vertical, cam.lower_left,
                      cam.u, cam.v, cam.lens_radius.reshape(1)]).contiguous()


def pack_scene(scene: Scene) -> torch.Tensor:
    """(9, N) f32 on the scene's device: cx, cy, cz, radius, mat_type,
    ar, ag, ab, mat_param (raytpu's ``_pack_scene`` rows)."""
    return torch.stack([
        scene.center[:, 0], scene.center[:, 1], scene.center[:, 2],
        scene.radius, scene.mat_type.to(torch.float32),
        scene.albedo[:, 0], scene.albedo[:, 1], scene.albedo[:, 2],
        scene.mat_param]).contiguous()


def check_packs(cam_pack: torch.Tensor, scene_pack: torch.Tensor) -> None:
    """Raise unless both packs are contiguous f32 CUDA tensors of the
    kernels' shapes on one device, carrying no autograd history: only
    :class:`_Render` may run a kernel under autograd, because only it
    supplies the backward."""
    for name, t, shape in (("cam_pack", cam_pack, (CAM_PACK,)),
                           ("scene_pack", scene_pack,
                            (SCENE_ROWS, scene_pack.shape[-1]))):
        if t.requires_grad:
            raise ValueError(f"{name} requires grad: a kernel launched "
                             "directly has no backward; go through "
                             "render_fwd (or render), whose autograd "
                             "Function runs K3 backward")
        if not t.is_cuda:
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want torch.float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if cam_pack.device != scene_pack.device:
        raise ValueError("cam_pack and scene_pack lie on different devices")
    if scene_pack.shape[1] < 1:
        raise ValueError("the scene needs at least one sphere")


def check_bvh(bvh: BVH, rows: int | None, device) -> None:
    """Raise unless ``bvh`` is one its sweep (:func:`sweep_of`) takes for a
    scene of ``rows`` permuted rows (None: as many as ``perm`` has) on
    ``device``, ``perm`` one entry per row.  The flat sweep: padded leaves
    with a flat leaf list of f32 contiguous rows.  The walk: ``nodes`` f32
    contiguous, (8 n_trav, 9) with padded leaves or (n_trav, 9) without,
    fewer than 2^24 nodes a copy (integers stored as f32 are exact)."""
    if not isinstance(bvh, BVH):
        raise ValueError(f"bvh: want a raytpu_torch.bvh.BVH, got "
                         f"{type(bvh).__name__}")
    sweep = sweep_of(bvh)
    if rows is None:
        rows = bvh.perm.shape[0] if bvh.perm.dim() == 1 else -1
    if bvh.perm.dim() != 1 or bvh.perm.shape[0] != rows:
        raise ValueError(f"bvh.perm has {tuple(bvh.perm.shape)} entries, the "
                         f"scene pack {rows} rows")
    if sweep == "flat":
        if bvh.flat is None or not bvh.leaf_size:
            raise ValueError("bvh: the flat sweep needs padded leaves and a "
                             "flat leaf list (build_bvh(pad_leaves=True))")
        arr, name = bvh.flat, "bvh.flat"
        if (arr.dtype != torch.float32 or arr.dim() != 2
                or arr.shape[1] != 9 or arr.shape[0] < 8 or arr.shape[0] % 8
                or not arr.is_contiguous()):
            raise ValueError(f"bvh.flat: want contiguous torch.float32 (8L, "
                             f"9), got {arr.dtype} {tuple(arr.shape)}")
    else:
        if bvh.leaf_size and bvh.flat is None:
            raise ValueError("bvh: padded leaves need the flat leaf list, "
                             "which locates the outlier tail")
        arr, name = bvh.nodes, "bvh.nodes"
        copies = bvh.copies
        if (arr.dtype != torch.float32 or arr.dim() != 2
                or arr.shape[1] != 9 or arr.shape[0] < copies
                or arr.shape[0] % copies or arr.shape[0] // copies >= 2**24
                or not arr.is_contiguous()):
            raise ValueError(f"bvh.nodes: want contiguous torch.float32 "
                             f"({'8M' if copies == 8 else 'M'}, 9) for the "
                             f"walk, got {arr.dtype} {tuple(arr.shape)}")
    if bvh.leaf_size and bvh.n_leaves * bvh.leaf_size > rows:
        raise ValueError("bvh: more leaf entries than permuted rows")
    for n, t in ((name, arr), ("bvh.perm", bvh.perm)):
        if t.device != device:
            raise ValueError(f"{n} is on {t.device}, the scene on {device}")


def check_tape(tape: torch.Tensor, cfg: RenderConfig, n: int, device,
               rows: int | None = None) -> None:
    """Raise unless ``tape`` is a winner-index tape of this frame (of its
    ``rows``-row slab when given): (g_cap, rows*W) contiguous, ``g_cap <=
    spp * depth``, of :func:`golden.tape_dtype` for ``n`` kernel-side
    spheres, on ``device``."""
    want = golden.tape_dtype(n)
    pixels = (cfg.height if rows is None else rows) * cfg.width
    if (tape.dtype != want or tape.dim() != 2 or tape.shape[1] != pixels
            or tape.shape[0] > cfg.spp * cfg.depth
            or not tape.is_contiguous()):
        raise ValueError(
            f"tape: want contiguous {want} (g_cap <= {cfg.spp * cfg.depth}, "
            f"{pixels}) for this frame, got {tape.dtype} "
            f"{tuple(tape.shape)}")
    if tape.device != device:
        raise ValueError(f"tape is on {tape.device}, the scene on {device}")


def _check_state(cfg: RenderConfig, rows: int, acc: torch.Tensor,
                 seed: torch.Tensor, device,
                 seed_dtype: torch.dtype = torch.int64) -> None:
    """Raise unless ``acc`` (rows, W, 3) f32 and ``seed`` (rows, W) are
    carried state of a ``rows``-row slab on ``device``: ``seed`` int64
    (the u32 carrier) for :func:`accumulate`, int32 (the u32 bits) and
    both contiguous for :func:`launch_accumulate`."""
    bits = seed_dtype == torch.int32
    for name, t, dtype, shape in (
            ("acc", acc, torch.float32, (rows, cfg.width, 3)),
            ("seed", seed, seed_dtype, (rows, cfg.width))):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {dtype} {shape}, got {t.dtype} "
                             f"{tuple(t.shape)}")
        if bits and not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, the scene on {device}")


def bvh_args(bvh: BVH | None, walk_rows: torch.Tensor | None) -> tuple:
    """The C entry points' BVH operands: (flat, n_leaves, leaf_size, nodes,
    n_trav, copies, out_base, out_cnt), ``flat`` set for the flat sweep,
    ``nodes`` for the walk (``walk_rows``, the node rows in the 16-byte
    layout: ``bvh.walk_rows``), neither for the brute sweep."""
    if bvh is None:
        return (None, 0, 0, None, 0, 0, 0, 0)
    tail = outlier_tail(bvh.perm, bvh.flat, bvh.leaf_size) or (0, 0)
    if sweep_of(bvh) == "flat":
        return (bvh.flat.data_ptr(), bvh.n_leaves, int(bvh.leaf_size), None,
                0, 0, *tail)
    if walk_rows is None:
        raise ValueError("the walk needs its node rows in the 16-byte "
                         "layout (BVH.walk_rows)")
    return (None, 0, 0, walk_rows.data_ptr(), bvh.n_trav, bvh.copies, *tail)


def sphere_rows(scene_pack: torch.Tensor) -> torch.Tensor:
    """The walk's sphere rows: (n, 4) f32 (cx, cy, cz, rad * rad) of a
    (9, n) scene pack, rad * rad the f32 product the sweeps form."""
    return torch.stack([scene_pack[0], scene_pack[1], scene_pack[2],
                        scene_pack[3] * scene_pack[3]], dim=1).contiguous()


def flat_stage(bvh: BVH, limit: int) -> dict:
    """What the flat sweep's forward stages of ``bvh`` in shared memory
    within ``limit`` bytes a block (csrc/render_common.cuh ``FlatStage``,
    ``stage_flat``), in 16-byte rows: the 8 octant copies' leaf boxes, two
    rows each, if they fit (``boxes`` rows, else 0); then the outliers'
    rows if they fit (``outliers``); then leaves ``[0, leaves)``, leaf_size
    rows and one unused row each.  The kernel reads what is not staged from
    the scene pack and ``bvh.flat`` with the same arithmetic.  ``bytes``:
    the launch's shared memory."""
    n_leaves, ls = bvh.n_leaves, int(bvh.leaf_size)
    cap = limit // 16
    boxes = 16 * n_leaves if 16 * n_leaves <= cap else 0
    outliers = bvh.n_outliers if bvh.n_outliers <= cap - boxes else 0
    leaves = min(n_leaves, (cap - boxes - outliers) // (ls + 1))
    return {"leaves": leaves, "outliers": outliers, "boxes": boxes,
            "bytes": 16 * (leaves * (ls + 1) + outliers + boxes)}


_smem_optin: dict = {}  # device index -> its opt-in shared memory a block


def flat_device(device, shmem: int = 0) -> tuple[int, int]:
    """(the CUDA ``device``'s opt-in shared memory a block, the blocks of
    K1c's instantiation an SM holds with ``shmem`` bytes staged: the flat
    sweep's persistent grid has that many a SM)."""
    optin, blocks = ctypes.c_int(), ctypes.c_int()
    with torch.cuda.device(device):
        err = _lib().raytpu_flat_device(int(shmem), ctypes.byref(optin),
                                        ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"raytpu_flat_device failed: CUDA error {err}")
    return optin.value, blocks.value


def smem_optin(device) -> int:
    """The opt-in shared memory a block of the CUDA ``device`` (the flat
    sweep's staging limit), read from the card once a device."""
    device = torch.device(device)
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    if index not in _smem_optin:
        _smem_optin[index] = flat_device(torch.device("cuda", index))[0]
    return _smem_optin[index]


def flat_stage_on(bvh: BVH, device) -> dict:
    """:func:`flat_stage` of ``bvh`` within the opt-in limit of the CUDA
    ``device``."""
    return flat_stage(bvh, smem_optin(device))


_counters: dict[tuple, torch.Tensor] = {}  # (device, stream) -> counter


def slot_counter(device, stream: int) -> torch.Tensor:
    """The counter from which a persistent grid's lanes take their next
    pixel or slot, for every kernel launched on ``stream`` of ``device``
    (the forward's here, K5's and K6's in ``kernels/wavefront.py``): one
    int32 a device and stream, kept across launches, so a launch allocates
    and zeroes nothing here.  The rule that makes the sharing safe: a C
    entry point zeroes the counter on the launch's stream before any launch
    that reads it (the forward's every launch; K5's and K6's where the grid
    has fewer threads than slots), and launches on one stream run in
    order."""
    key = (device, stream)
    if key not in _counters:
        _counters[key] = torch.zeros(1, dtype=torch.int32, device=device)
    return _counters[key]


def _launch(cam_pack, scene_pack, cfg: RenderConfig, bvh, row0: int,
            rows: int, spp: int, out: torch.Tensor, *, tape=None,
            census=None, carry=None) -> None:
    """Run the C entry point once; ``carry`` = (acc_in, seed_in, seed_out,
    s0) for K2, the seeds as int32 bits."""
    n = scene_pack.shape[1]
    sweep = None if bvh is None else sweep_of(bvh)
    acc_in, seed_in, seed_out, s0 = carry if carry else (None,) * 3 + (0,)
    lib = _lib()
    device = scene_pack.device
    # the flat sweep's staging, the walk's node and sphere rows (the brute
    # sweep stages by n in the C entry point)
    with profiling.span("raytpu.pack"):
        stage = (flat_stage_on(bvh, device) if sweep == "flat"
                 else dict.fromkeys(("leaves", "outliers", "boxes"), 0))
        node_rows = spheres = None
        if sweep == "walk":
            node_rows, spheres = bvh.walk_rows, sphere_rows(scene_pack)
    with torch.cuda.device(device), profiling.span("raytpu.launch"):
        stream = torch.cuda.current_stream(device).cuda_stream
        # the counter the persistent grid takes its pixels from
        pixel_next = slot_counter(device, stream)
        err = lib.raytpu_render_fwd(
            cam_pack.data_ptr(), scene_pack.data_ptr(), n, *bvh_args(bvh, node_rows), stage["leaves"], stage["outliers"],
            stage["boxes"], int(tape is not None),
            None if tape is None or tape.numel() == 0 else tape.data_ptr(),
            0 if tape is None else tape.shape[0],
            int(tape is not None and tape.dtype == torch.int32),
            None if census is None else census.data_ptr(),
            int(carry is not None),
            None if acc_in is None else acc_in.data_ptr(),
            None if seed_in is None else seed_in.data_ptr(),
            None if seed_out is None else seed_out.data_ptr(),
            pixel_next.data_ptr(),
            int(s0) & 0xFFFFFFFF, out.data_ptr(),
            cfg.width, cfg.height, row0, rows, spp, cfg.depth,
            float(np.float32(cfg.t_min)),
            float(np.float32(1.0 / (cfg.width - 1))),
            float(np.float32(1.0 / (cfg.height - 1))),
            float(np.float32(1.0 / cfg.spp)),
            float(np.float32(cfg.gamma)),
            int(cfg.rng_mode == "parallel"), int(cfg.scatter_mode == "v1"),
            None if spheres is None else spheres.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"render_fwd_kernel launch failed: CUDA error {err}")


def sweep_tag(bvh: BVH | None) -> str:
    """The sweep's name in :data:`variants`: "brute", "bvh" (the flat
    sweep) or "walk"."""
    if bvh is None:
        return "brute"
    return "bvh" if sweep_of(bvh) == "flat" else "walk"


def launch(cam_pack: torch.Tensor, scene_pack: torch.Tensor,
           cfg: RenderConfig, bvh: BVH | None = None,
           tape: torch.Tensor | None = None, count: bool = False,
           row0: int = 0, rows: int | None = None):
    """Launch the kernel on the packed operands -> (rows, W, 3) f32 image
    (rows = H without a slab), or (image, census) with ``count``:
    ``census`` (4,) int64 on the device, the frame's ``golden.CENSUS``
    counts.

    ``bvh``: the flat BVH sweep (K1c) or the skip-pointer walk (K1d), by
    :func:`raytpu_torch.bvh.sweep_of`; ``scene_pack`` is then the scene in leaf order
    (``pack_scene(permute_scene(scene, bvh.perm))``).  ``tape``
    (g_cap, rows*W): the taping forward (K4's write side) writes each
    pixel's first g_cap winners (-1 for a miss) into it; other slots keep
    their value.  ``row0`` / ``rows``: the slab (K1b; see :func:`slab`).
    A plain forward (no tape, no census) of a scene :func:`use_dense`
    takes counts as the dense stage's (K1e, or ``K1b/dense`` on a slab),
    the others without a BVH as K1a / ``K1b/brute``: one kernel, the brute
    sweep.  The census counts as K1'/brute there, as raytpu's census runs
    its brute sweep.  Runs on the current stream of the operands' device
    and does not synchronise.  ``inv_w``, ``inv_h`` and ``inv_spp`` are
    computed in f64 here and rounded to f32, as raytpu's kernel and both
    goldens do."""
    dense = (tape is None and not count
             and use_dense(scene_pack.shape[-1], bvh))
    out, census = _launch_fwd(cam_pack, scene_pack, cfg, bvh, tape, count,
                              row0, rows, dense)
    return (out, census[:len(golden.CENSUS)]) if count else out


def _launch_fwd(cam_pack, scene_pack, cfg, bvh, tape, count, row0, rows,
                dense):
    """:func:`launch`'s body -> (image, the census buffer: the
    ``golden.CENSUS`` counts, then :data:`WARP_CENSUS`'s, or None);
    ``dense``: count the launch as the dense stage's."""
    check_packs(cam_pack, scene_pack)
    slabbed = rows is not None
    row0, rows = slab(cfg, row0, rows)
    n = scene_pack.shape[1]
    device = scene_pack.device
    if bvh is not None:
        check_bvh(bvh, n, device)
    if tape is not None:
        check_tape(tape, cfg, n, device, rows)
        if count:
            raise ValueError("the census does not count a taping forward")
    with profiling.span("raytpu.pack"):
        out = torch.empty((rows, cfg.width, 3), dtype=torch.float32,
                          device=device)
        census = (torch.zeros(len(golden.CENSUS) + len(WARP_CENSUS),
                              dtype=torch.int64, device=device)
                  if count else None)
    _launch(cam_pack, scene_pack, cfg, bvh, row0, rows, cfg.spp, out,
            tape=tape, census=census)
    tag = "dense" if dense else sweep_tag(bvh)
    if tape is not None:
        variants[f"K4/{tag}" + ("+slab" if slabbed else "")] += 1
    elif count:
        variants[f"K1'/{tag}"] += 1
    elif slabbed:
        variants[f"K1b/{tag}"] += 1
    else:
        variants[{"brute": "K1a", "bvh": "K1c", "walk": "K1d",
                  "dense": "K1e"}[tag]] += 1
    return out, census


def warp_census(cam_pack: torch.Tensor, scene_pack: torch.Tensor,
                cfg: RenderConfig, bvh: BVH | None, row0: int = 0,
                rows: int | None = None) -> dict:
    """K1' over a BVH (the flat sweep or the walk) or the brute sweep
    (``bvh`` None: K1'/dense for a scene :func:`use_dense` takes, else
    K1'/brute) with its warp counters -> the frame's ``golden.CENSUS``
    counts, :data:`WARP_CENSUS`'s and the shares ``loop_efficiency``,
    bounce steps over (warp_steps x 32), and ``sweep_efficiency``, the
    lanes' sphere tests over (warp_sphere_tests x 32); over the walk also
    ``walk_efficiency``, the nodes visited over (warp_node_steps x 32).
    ``warp_steps`` counts one for each iteration of the bounce loop that any
    lane of a warp runs, ``warp_sphere_tests`` and ``warp_node_steps`` one
    for each sphere-test and node-loop iteration likewise: what a warp runs,
    whichever of its lanes take part.  ``lane_sphere_tests`` counts each
    lane's own tests (the walk's unpadded leaves hold different counts).
    Warps exist on the card only: CUDA tensors only."""
    _, census = _launch_fwd(cam_pack, scene_pack, cfg, bvh, None, True,
                            row0, rows, use_dense(scene_pack.shape[-1], bvh))
    c = dict(zip(golden.CENSUS + WARP_CENSUS, map(int, census.tolist())))
    c["loop_efficiency"] = c["bounce_steps"] / max(32 * c["warp_steps"], 1)
    c["sweep_efficiency"] = (c["lane_sphere_tests"]
                             / max(32 * c["warp_sphere_tests"], 1))
    if bvh is not None and sweep_of(bvh) == "walk":
        c["walk_efficiency"] = (c["nodes_visited"]
                                / max(32 * c["warp_node_steps"], 1))
    return c


def launch_accumulate(cam_pack: torch.Tensor, scene_pack: torch.Tensor,
                      cfg: RenderConfig, acc: torch.Tensor,
                      seed: torch.Tensor, s0: int, spp: int,
                      bvh: BVH | None = None, row0: int = 0,
                      rows: int | None = None):
    """Launch K2 on the packed operands: add ``spp`` samples, from sample
    index ``s0`` on, to the carried state -> ``(acc', seed')`` in fresh
    buffers (the kernel could update in place; the state stays
    immutable, as raytpu's is).

    ``acc`` (rows, W, 3) f32 linear sums and ``seed`` (rows, W) int32, the
    bits of the u32 seeds.  Sequential RNG resumes each pixel's seed chain;
    parallel RNG draws sample ``s`` from ``fold_in(base_hash(x, y), s0 +
    s)`` and writes the base seed back.  ``bvh`` and ``row0`` / ``rows``
    as in :func:`launch`; rows past the frame come out 0, sums and
    seeds."""
    check_packs(cam_pack, scene_pack)
    slabbed = rows is not None
    row0, rows = slab(cfg, row0, rows)
    n = scene_pack.shape[1]
    device = scene_pack.device
    if bvh is not None:
        check_bvh(bvh, n, device)
    if spp < 1 or s0 < 0:
        raise ValueError(f"a batch needs spp >= 1 and s0 >= 0, got spp {spp}, "
                         f"s0 {s0}")
    _check_state(cfg, rows, acc, seed, device, torch.int32)
    out = (torch.empty_like(acc), torch.empty_like(seed))
    _launch(cam_pack, scene_pack, cfg, bvh, row0, rows, spp, out[0],
            carry=(acc, seed, out[1], s0))
    variants[f"K2/{sweep_tag(bvh)}" + ("+slab" if slabbed else "")] += 1
    return out


def _forward(scene: Scene, cam: Camera, cfg: RenderConfig,
             bvh: BVH | None = None, row0: int = 0,
             rows: int | None = None) -> torch.Tensor:
    device = scene.center.device
    if device.type == "cpu":
        return golden.render_golden(scene, cam, cfg, bvh, row0=row0,
                                    rows=rows)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    with profiling.span("raytpu.pack"):
        packed = pack_scene(scene if bvh is None else
                            permute_scene(scene, bvh.perm))
        cam_pack = pack_camera(cam)
    return launch(cam_pack, packed, cfg, bvh, row0=row0, rows=rows)


def _grad_forward(ctx, scene: Scene, cam: Camera, cfg: RenderConfig,
                  vis_w: float, bvh: BVH | None, row0: int,
                  rows: int | None) -> torch.Tensor:
    """The forward under autograd: the taping forward where the tape plan
    applies (raytpu's ``_fwd`` / ``_fwd_bvh`` gate), else the plain
    forward kernel.  Keeps on ``ctx`` what the backward needs."""
    from raytpu_torch.kernels import gradkernel
    plan = gradkernel.tape_plan(cfg, scene.count, bvh, vis_w, rows)
    if plan is None:
        img, tape = _forward(scene, cam, cfg, bvh, row0, rows), None
    else:
        img, tape = gradkernel.render_tape_fwd(scene, cam, cfg,
                                               plan["g_cap"], bvh, row0, rows)
    ctx.cfg, ctx.vis_w, ctx.bvh, ctx.plan, ctx.tape = cfg, vis_w, bvh, plan, \
        tape
    ctx.row0, ctx.rows = row0, rows
    return img


def _grad_backward(ctx, ct, scene: Scene, cam: Camera, img):
    from raytpu_torch.kernels import gradkernel
    cfg, plan = ctx.cfg, ctx.plan
    # parallel RNG: the forward image elides K3's PASS 1; a tape also its
    # PASS-2 sweep for the steps it holds
    _, ds, dc = gradkernel.render_vjp(
        scene, cam, cfg, ct, img=img if cfg.rng_mode == "parallel" else None,
        vis_w=ctx.vis_w, bvh=ctx.bvh, tape=ctx.tape,
        tape_partial=plan is not None and plan["partial"], row0=ctx.row0,
        rows=ctx.rows)
    return ds, dc


class _Render(torch.autograd.Function):
    """The forward kernel (K1a, K1c or K1d with a BVH, K1b on a slab, or
    K4's taping forward) with K3 (its BVH variant with a BVH, its slab mode
    on a slab) as its backward: raytpu's ``_fwd`` / ``_bwd`` and ``_fwd_bvh``
    / ``_bwd_bvh``.

    apply(cfg, vis_w, bvh, (row0, rows), mat_type, center, radius, albedo,
    mat_param, *camera) -> image.  ``bvh`` (or None), the slab and
    ``mat_type`` are derived or discrete data and get no gradient; ``vis_w
    > 0`` adds silhouette terms to the backward only."""

    @staticmethod
    def forward(ctx, cfg, vis_w, bvh, slab_rows, mat_type, center, radius,
                albedo, mat_param, *cam_leaves):
        scene = Scene(center, radius, mat_type, albedo, mat_param)
        img = _grad_forward(ctx, scene, Camera(*cam_leaves), cfg, vis_w, bvh,
                            *slab_rows)
        ctx.save_for_backward(mat_type, center, radius, albedo, mat_param,
                              img, *cam_leaves)
        return img

    @staticmethod
    def backward(ctx, ct):
        mat_type, center, radius, albedo, mat_param, img, *cam_leaves = \
            ctx.saved_tensors
        ds, dc = _grad_backward(
            ctx, ct, Scene(center, radius, mat_type, albedo, mat_param),
            Camera(*cam_leaves), img)
        return (None, None, None, None, None, ds.center, ds.radius,
                ds.albedo, ds.mat_param, *dc)


def _check_scene_bvh(scene: Scene, cam: Camera, cfg: RenderConfig,
                     bvh: BVH | None) -> torch.device:
    device = check_inputs(scene, cam, cfg)
    if bvh is not None:
        check_bvh(bvh, None, device)
        if bvh.spheres and bvh.spheres != scene.count:
            raise ValueError(f"bvh was built for {bvh.spheres} spheres, the "
                             f"scene has {scene.count}")
    return device


def render_fwd(scene: Scene, cam: Camera, cfg: RenderConfig,
               vis_w: float = 0.0, bvh: BVH | None = None, row0: int = 0,
               rows: int | None = None) -> torch.Tensor:
    """Forward render -> (H, W, 3) f32 image in [0, 1] on the inputs'
    device (row 0 = bottom scanline), or with ``rows`` the (rows, W, 3)
    slab from absolute row ``row0`` (K1b; rows past the frame are 0).  CPU
    tensors take the plain PyTorch version; CUDA tensors launch the kernel
    (K1a, or K1e by :func:`use_dense`, or with ``bvh``, a
    :func:`raytpu_torch.bvh.build_bvh` of this scene on its device, K1c or
    K1d by raytpu's rule).  When autograd is
    on and a continuous leaf of the scene or camera requires grad, the
    image carries a backward: K3 on CUDA tensors, the adjoint on CPU
    tensors (``vis_w > 0`` adds silhouette gradients)."""
    _check_scene_bvh(scene, cam, cfg, bvh)
    slab(cfg, row0, rows)
    leaves = (scene.center, scene.radius, scene.albedo, scene.mat_param,
              *cam)
    if torch.is_grad_enabled() and any(t.requires_grad for t in leaves):
        return _Render.apply(cfg, float(vis_w), bvh, (row0, rows),
                             scene.mat_type, scene.center, scene.radius,
                             scene.albedo, scene.mat_param, *cam)
    return _forward(scene, cam, cfg, bvh, row0, rows)


def accumulate(scene: Scene, cam: Camera, cfg: RenderConfig,
               acc: torch.Tensor, seed: torch.Tensor, s0: int, spp: int,
               bvh: BVH | None = None, row0: int = 0,
               rows: int | None = None):
    """One progressive batch (K2, raytpu's ``accumulate_pallas``) ->
    ``(acc', seed')``: ``spp`` more samples, from sample index ``s0`` on,
    added to the carried ``acc`` (rows, W, 3) f32 linear sums and ``seed``
    (rows, W) int64 (the u32 carrier of :mod:`raytpu_torch.rng`); rows = H
    without a slab.  Sequential RNG resumes each pixel's seed chain;
    parallel RNG draws fresh, globally indexed streams from ``s0`` and
    passes the base seed through.  K batches give one batch of their
    summed spp bit for bit.  CPU tensors take the plain version
    (:func:`raytpu_torch.golden.accumulate_golden`); CUDA tensors launch K2
    into fresh buffers.  No autograd: the carried state is not
    differentiated."""
    device = _check_scene_bvh(scene, cam, cfg, bvh)
    slabbed = rows is not None
    row0, rows = slab(cfg, row0, rows)
    _check_state(cfg, rows, acc, seed, device)
    if device.type == "cpu":
        return golden.accumulate_golden(scene, cam, cfg, acc, seed, s0, spp,
                                        bvh, row0, rows)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    with torch.no_grad():
        packed = pack_scene(scene if bvh is None else
                            permute_scene(scene, bvh.perm))
        acc2, seed2 = launch_accumulate(
            pack_camera(cam), packed, cfg, acc.contiguous(),
            _u32_bits(seed).contiguous(), s0, spp, bvh, row0,
            rows if slabbed else None)
    return acc2, seed2.to(torch.int64) & 0xFFFFFFFF
