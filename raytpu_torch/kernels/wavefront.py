"""The wavefront's segment kernels K5 and K6: wrapper of ``csrc/wavefront.cu``.

Counterpart of the two ``pallas_call`` sites of
``raytpu/wavefront.py::_render_wavefront_impl``: the segment kernel K5
(``_make_segment_kernel``) and the refill segment kernel K6
(``_make_refill_segment_kernel``).  Both run over SoA planes of R ray slots,
one thread a slot, and take their bounces through the megakernels' device
function under the closest-hit policy the scene takes: the brute sweep, the
dense stage (:func:`raytpu_torch.kernels.megakernel.use_dense`), the flat
BVH sweep or the skip-pointer walk (:func:`raytpu_torch.bvh.sweep_of`).
K5 under the dense stage runs on a persistent grid instead, its lanes
taking their next slot from a counter the wrapper zeroes each launch.

:func:`prepare` packs a render's operands once (:class:`SceneOps`);
:func:`launch_segment` and :func:`launch_refill_segment` check the planes,
launch on the current stream of their device and do not synchronise.  CPU
tensors run the plain versions (:func:`raytpu_torch.wavefront.segment_plain`
and :func:`raytpu_torch.wavefront.refill_segment_plain`); CUDA tensors
launch the kernel or raise, never falling back.  ``launches`` counts the
launches, ``variants`` the same by kernel and policy ("K5/dense",
"K6/bvh", ...).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from raytpu_torch.bvh import BVH, permute_scene
from raytpu_torch.camera import Camera
from raytpu_torch.config import RenderConfig
from raytpu_torch.kernels import _build, megakernel
from raytpu_torch.scene import Scene

SOURCE = "wavefront.cu"
SEG_PLANES = 14   # ox oy oz dx dy dz cr cg cb rr rg rb alive seed
RIDE_PLANES = 16  # key pid sdpk ox oy oz dx dy dz cr cg cb seed ar ag ab
AUX_PLANES = 3    # px py bidx
MAX_SLOTS = 1 << 24  # slot ids ride an f32 plane: exact below 2^24

launches = 0    # kernel launches through the wrappers; a run resets and reads it
# the same launches by kernel and closest-hit policy
POLICIES = ("brute", "dense", "bvh", "walk")
variants = dict.fromkeys(
    (f"{k}/{p}" for k in ("K5", "K6") for p in POLICIES), 0)


class SceneOps(NamedTuple):
    """A render's operands, packed once (:func:`prepare`)."""
    scene: Scene            # as the kernels see it: leaf order with a BVH
    pack: torch.Tensor      # its (9, N) f32 pack
    bvh: BVH | None
    policy: str             # one of POLICIES
    box: torch.Tensor       # (6,) f32 the key's box: lo xyz, bins / extent xyz
    cam: Camera
    cam_pack: torch.Tensor  # (19,) f32


def prepare(scene: Scene, cam: Camera, bvh: BVH | None,
            box: torch.Tensor) -> SceneOps:
    """The operands of a wavefront render of ``scene`` (checked by the
    caller) with ``bvh`` and the key's ``box``."""
    n = scene.count
    if megakernel.use_dense(n, bvh):
        policy = "dense"
    else:
        policy = megakernel.sweep_tag(bvh)
    kscene = scene if bvh is None else permute_scene(scene, bvh.perm)
    with torch.no_grad():
        return SceneOps(kscene, megakernel.pack_scene(kscene), bvh, policy,
                        box.to(torch.float32).contiguous(), cam,
                        megakernel.pack_camera(cam))


def _lib() -> ctypes.CDLL:
    lib = _build.load(SOURCE)
    ptr, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    hit = [ptr, i, i, ptr, i, i, ptr, i, i, i, i, ptr]  # scene .. box
    lib.raytpu_wavefront_segment.argtypes = hit + [ptr, ptr, i, i, f, i, ptr,
                                                    ptr]
    lib.raytpu_wavefront_segment.restype = ctypes.c_int
    lib.raytpu_wavefront_refill.argtypes = [ptr] + hit + [
        ptr, ptr, ptr, i, i, i, i, i, f, f, f, i, ptr]
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


def _hit_args(ops: SceneOps) -> tuple:
    """The C entry points' scene, policy, BVH and box operands."""
    return (ops.pack.data_ptr(), ops.pack.shape[1],
            int(ops.policy == "dense"), *megakernel.bvh_args(ops.bvh),
            ops.box.data_ptr())


def _count(kernel: str, err: int, ops: SceneOps) -> None:
    global launches
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")
    launches += 1
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
    if planes.device.type == "cpu":
        from raytpu_torch import wavefront
        return wavefront.segment_plain(ops, planes, cfg, n_bounces)
    if planes.device.type != "cuda":
        raise ValueError(f"unsupported device {planes.device}")
    out = torch.empty((SEG_PLANES + 1, R), dtype=torch.float32,
                      device=planes.device)
    # the dense stage's persistent grid takes its slots from this counter
    slot_next = (torch.zeros(1, dtype=torch.int32, device=planes.device)
                 if ops.policy == "dense" else None)
    with torch.cuda.device(planes.device):
        stream = torch.cuda.current_stream(planes.device).cuda_stream
        err = _lib().raytpu_wavefront_segment(
            *_hit_args(ops), planes.data_ptr(), out.data_ptr(), R,
            int(n_bounces), float(np.float32(cfg.t_min)),
            int(cfg.scatter_mode == "v1"),
            None if slot_next is None else slot_next.data_ptr(), stream)
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
    if ride.device.type == "cpu":
        from raytpu_torch import wavefront
        return wavefront.refill_segment_plain(ops, ride, aux, cfg, n_bounces,
                                              spp_batch)
    if ride.device.type != "cuda":
        raise ValueError(f"unsupported device {ride.device}")
    out = torch.empty_like(ride)
    with torch.cuda.device(ride.device):
        stream = torch.cuda.current_stream(ride.device).cuda_stream
        err = _lib().raytpu_wavefront_refill(
            ops.cam_pack.data_ptr(), *_hit_args(ops), ride.data_ptr(),
            aux.data_ptr(), out.data_ptr(), R, int(n_bounces), cfg.depth,
            spp_slot, int(spp_batch), float(np.float32(cfg.t_min)),
            float(np.float32(1.0 / (cfg.width - 1))),
            float(np.float32(1.0 / (cfg.height - 1))),
            int(cfg.scatter_mode == "v1"), stream)
    _count("K6", err, ops)
    return out
