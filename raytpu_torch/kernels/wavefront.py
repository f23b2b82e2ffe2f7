"""The wavefront's segment kernels K5 and K6: wrapper of ``csrc/wavefront.cu``.

Counterpart of the two ``pallas_call`` sites of
``raytpu/wavefront.py::_render_wavefront_impl``: the segment kernel K5
(``_make_segment_kernel``) and the refill segment kernel K6
(``_make_refill_segment_kernel``).  Both run over SoA planes of R ray slots
on a persistent slot grid, its lanes taking their next slot from the
counter of the launch's device and stream (``megakernel.slot_counter``,
shared with the forward, and its rule), and take their bounces
through the forward's closest hit under the policy the scene takes: the
brute sweep (its rows staged up to ``megakernel.DENSE_MAX`` spheres,
named "dense" where :func:`raytpu_torch.kernels.megakernel.use_dense`
says so, "brute" otherwise), the flat BVH sweep over the stage
``megakernel.flat_stage`` plans or the skip-pointer walk over
``BVH.walk_rows`` and the scene's sphere rows
(:func:`raytpu_torch.bvh.sweep_of`).

:func:`prepare` packs a render's operands once (:class:`SceneOps`; the
kernels' own by :func:`kernel_operands`), :func:`hit_args` gives the C
entry points' closest-hit operands from them;
:func:`launch_segment` and :func:`launch_refill_segment` check the planes,
launch on the current stream of their device and do not synchronise; they
take CUDA tensors only.  The plain versions, which the wavefront runs on
CPU tensors, are :func:`raytpu_torch.wavefront.segment_plain` and
:func:`raytpu_torch.wavefront.refill_segment_plain`.  ``variants`` counts
the launches by kernel and policy ("K5/dense", "K6/bvh", ...).
"""

from __future__ import annotations

import ctypes
from typing import Callable, NamedTuple

import numpy as np
import torch

from raytpu_torch.bvh import BVH
from raytpu_torch.camera import Camera
from raytpu_torch.config import RenderConfig
from raytpu_torch.kernels import _build, megakernel
from raytpu_torch.scene import Scene

SOURCE = "wavefront.cu"
SEG_PLANES = 14   # ox oy oz dx dy dz cr cg cb rr rg rb alive seed
RIDE_PLANES = 16  # key pid sdpk ox oy oz dx dy dz cr cg cb seed ar ag ab
AUX_PLANES = 3    # px py bidx
MAX_SLOTS = 1 << 24  # slot ids ride an f32 plane: exact below 2^24

# the kernel launches through the wrappers by kernel and closest-hit
# policy; a run resets and reads them
POLICIES = ("brute", "dense", "bvh", "walk")
variants = dict.fromkeys(
    (f"{k}/{p}" for k in ("K5", "K6") for p in POLICIES), 0)


class SceneOps(NamedTuple):
    """A render's operands, packed once (:func:`prepare`)."""
    scene: Scene            # as given (the plain versions permute it)
    pack: torch.Tensor      # its (9, N) f32 pack, leaf order with a BVH
    bvh: BVH | None
    policy: str             # one of POLICIES
    box: torch.Tensor       # (6,) f32 the key's box: lo xyz, bins / extent xyz
    cam: Camera
    cam_pack: torch.Tensor  # (19,) f32
    stage: dict | None      # the flat sweep's stage (megakernel.flat_stage)
    walk_rows: torch.Tensor | None  # the walk's node rows, BVH.walk_rows
    spheres: torch.Tensor | None    # the walk's (N, 4) sphere rows


def kernel_operands(policy: str, bvh: BVH | None, pack: torch.Tensor,
                    limit: Callable[[], int]) -> tuple:
    """The kernels' own operands of a render under ``policy`` (SceneOps'
    ``stage``, ``walk_rows``, ``spheres``): the flat sweep's stage planned
    within ``limit()`` bytes a block (``megakernel.flat_stage``; the limit
    is asked for under that policy only), the walk's node rows
    (``BVH.walk_rows``) and the sphere rows of the scene ``pack``
    (``megakernel.sphere_rows``); None where the policy reads none."""
    if policy == "bvh":
        return megakernel.flat_stage(bvh, limit()), None, None
    if policy == "walk":
        return None, bvh.walk_rows, megakernel.sphere_rows(pack)
    return None, None, None


def prepare(scene: Scene, cam: Camera, bvh: BVH | None,
            box: torch.Tensor) -> SceneOps:
    """The operands of a wavefront render of ``scene`` (checked by the
    caller) with ``bvh`` and the key's ``box``, made once a render; on a
    CUDA scene also the kernels' own (:func:`kernel_operands`, the stage
    within the device's opt-in limit), which the plain versions on the CPU
    do not read."""
    n = scene.count
    if megakernel.use_dense(n, bvh):
        policy = "dense"
    else:
        policy = megakernel.sweep_tag(bvh)
    dev = scene.center.device
    with torch.no_grad():
        cam_pack, pack = megakernel.pack(scene, cam, bvh)
        own = (kernel_operands(policy, bvh, pack,
                               lambda: megakernel.smem_optin(dev))
               if dev.type == "cuda" else (None, None, None))
        return SceneOps(scene, pack, bvh, policy,
                        box.to(torch.float32).contiguous(), cam, cam_pack,
                        *own)


_ptr, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the C entry points' closest-hit operands (:func:`hit_args`): scene, n,
# flat, n_leaves, leaf_size, nodes, n_trav, copies, out_base, out_cnt, the
# stage's leaves, outliers and boxes, spheres, box
HIT_ARGTYPES = (_ptr, _i, _ptr, _i, _i, _ptr, _i, _i, _i, _i, _i, _i, _i,
                _ptr, _ptr)


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    hit = list(HIT_ARGTYPES)
    lib.raytpu_wavefront_segment.argtypes = hit + [
        _ptr, _ptr, _i, _i, _f, _i, _ptr, _ptr]
    lib.raytpu_wavefront_segment.restype = ctypes.c_int
    lib.raytpu_wavefront_refill.argtypes = [_ptr] + hit + [
        _ptr, _ptr, _ptr, _i, _i, _i, _i, _i, _f, _f, _f, _i, _ptr, _ptr]
    lib.raytpu_wavefront_refill.restype = ctypes.c_int
    return lib


def _check_planes(name: str, t: torch.Tensor, planes: int,
                  ops: SceneOps) -> int:
    """Raise unless ``t`` is (planes, R) contiguous f32 on the scene's
    device with 1 <= R < MAX_SLOTS; return R."""
    if (t.dtype != torch.float32 or t.dim() != 2 or t.shape[0] != planes
            or not 1 <= t.shape[1] < MAX_SLOTS or not t.is_contiguous()):
        raise ValueError(f"{name}: want contiguous torch.float32 ({planes}, R) "
                         f"with 1 <= R < {MAX_SLOTS}, got {t.dtype} "
                         f"{tuple(t.shape)}")
    if t.device != ops.pack.device:
        raise ValueError(f"{name} is on {t.device}, the scene on "
                         f"{ops.pack.device}")
    return t.shape[1]


def hit_args(ops: SceneOps) -> tuple:
    """The C entry points' closest-hit operands (:data:`HIT_ARGTYPES`), the
    forward's for the same scene and BVH: the scene pack, the BVH's
    (``megakernel.bvh_args`` over ``BVH.walk_rows`` for the walk), the flat
    sweep's stage plan (0 0 0 under the other policies), the walk's sphere
    rows, the key's box.  The brute sweep stages its rows by the sphere
    count in the C entry point: no operand says so."""
    if ops.policy == "bvh" and ops.stage is None:
        raise ValueError("the flat sweep's stage was not planned: prepare() "
                         "the operands on the planes' CUDA device")
    if ops.policy == "walk" and ops.spheres is None:
        raise ValueError("the walk's sphere rows were not made: prepare() "
                         "the operands on the planes' CUDA device")
    st = ops.stage or dict.fromkeys(("leaves", "outliers", "boxes"), 0)
    return (ops.pack.data_ptr(), ops.pack.shape[1],
            *megakernel.bvh_args(ops.bvh, ops.walk_rows), st["leaves"],
            st["outliers"], st["boxes"],
            None if ops.spheres is None else ops.spheres.data_ptr(),
            ops.box.data_ptr())


def _count(kernel: str, err: int, ops: SceneOps) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")
    variants[f"{kernel}/{ops.policy}"] += 1


def launch_segment(ops: SceneOps, planes: torch.Tensor, cfg: RenderConfig,
                   n_bounces: int) -> torch.Tensor:
    """K5: up to ``n_bounces`` bounces of every live slot of ``planes``
    (14, R): ox oy oz dx dy dz, throughput, radiance (a miss adds
    throughput x sky to it), alive (1 or 0) and the seed's u32 bits ->
    (15, R): the 14 planes after the segment, then the sort key (the
    cell of a live slot, ``DEAD_KEY`` of a dead one)."""
    R = _check_planes("planes", planes, SEG_PLANES, ops)
    if n_bounces < 0:
        raise ValueError(f"n_bounces {n_bounces} < 0")
    if planes.device.type != "cuda":
        raise ValueError(f"K5 runs on CUDA tensors, got {planes.device}")
    out = torch.empty((SEG_PLANES + 1, R), dtype=torch.float32,
                      device=planes.device)
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        err = _lib().raytpu_wavefront_segment(
            *hit_args(ops), planes.data_ptr(), out.data_ptr(), R,
            int(n_bounces), float(np.float32(cfg.t_min)),
            int(cfg.scatter_mode == "v1"),
            megakernel.slot_counter(planes.device, stream).data_ptr(), stream)
    _count("K5", err, ops)
    return out


def launch_refill_segment(ops: SceneOps, ride: torch.Tensor,
                          aux: torch.Tensor, cfg: RenderConfig,
                          n_bounces: int, spp_batch: int) -> torch.Tensor:
    """K6: up to ``n_bounces`` refill steps of every live slot (key below
    ``DEAD_KEY``) of ``ride`` (16, R): key, pid, s * 256 + d, ox oy oz dx
    dy dz, throughput, the seed's u32 bits, the slot's radiance sums; with
    ``aux`` (3, R): px, py (absolute rows), bidx of the same slots ->
    (16, R), the key first.  A sample that ends adds its radiance to the
    sums and, while ``s + 1 < cfg.spp / spp_batch``, the slot casts its
    pixel's next sample (parallel RNG; sample ``(s + 1) * spp_batch +
    bidx``)."""
    R = _check_planes("ride", ride, RIDE_PLANES, ops)
    if _check_planes("aux", aux, AUX_PLANES, ops) != R:
        raise ValueError(f"aux has {aux.shape[1]} slots, ride {R}")
    spp_slot = cfg.spp // spp_batch
    if (n_bounces < 0 or cfg.rng_mode != "parallel" or cfg.spp % spp_batch
            or not 1 <= cfg.depth <= 256 or not 1 <= spp_slot <= 65535):
        raise ValueError(
            "the refill segment needs parallel RNG, n_bounces >= 0, "
            "1 <= depth <= 256 and 1 <= spp / spp_batch <= 65535 (got "
            f"{cfg.rng_mode}, {n_bounces}, depth {cfg.depth}, spp "
            f"{cfg.spp} / {spp_batch})")
    if ride.device.type != "cuda":
        raise ValueError(f"K6 runs on CUDA tensors, got {ride.device}")
    out = torch.empty_like(ride)
    with torch.cuda.device(ride.device):
        stream = torch.cuda.current_stream(ride.device).cuda_stream
        err = _lib().raytpu_wavefront_refill(
            ops.cam_pack.data_ptr(), *hit_args(ops), ride.data_ptr(),
            aux.data_ptr(), out.data_ptr(), R, int(n_bounces), cfg.depth,
            spp_slot, int(spp_batch), float(np.float32(cfg.t_min)),
            float(np.float32(1.0 / (cfg.width - 1))),
            float(np.float32(1.0 / (cfg.height - 1))),
            int(cfg.scatter_mode == "v1"),
            megakernel.slot_counter(ride.device, stream).data_ptr(), stream)
    _count("K6", err, ops)
    return out
