"""Thin-lens look-at camera (counterpart of ``raytpu/camera.py``).

v2 pinhole basis math (ref: CSVersion/DxCSApp.cpp:39-61, consumed at
CSVersion/ShaderCompute.hlsl:118-127) plus the v1 defocus blur (ref:
Shader_RT.fx:288-298).  ``lens_radius == 0`` is the exact v2 pinhole and
consumes no RNG draw.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from raytpu_torch import rng


class Camera(NamedTuple):
    """Packed camera basis — rows of the reference's ``viewVals`` matrix."""

    origin: torch.Tensor       # (3,) look_from
    horizontal: torch.Tensor   # (3,) focus_dist * viewport_w * u
    vertical: torch.Tensor     # (3,) focus_dist * viewport_h * v
    lower_left: torch.Tensor   # (3,) origin - horizontal/2 - vertical/2 - focus_dist*w
    u: torch.Tensor            # (3,) right basis (for lens offset)
    v: torch.Tensor            # (3,) up basis (for lens offset)
    lens_radius: torch.Tensor  # ()   aperture / 2


def _f32(x, device):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _norm(x):
    # sqrt of the left-to-right f32 sum of squares, as XLA's 3-vector norm
    return torch.sqrt(x[0] * x[0] + x[1] * x[1] + x[2] * x[2])


def _cross(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def make_camera(
    look_from,
    look_at,
    vup=(0.0, 1.0, 0.0),
    vfov: float = 20.0,
    aspect: float = 16.0 / 9.0,
    aperture: float = 0.0,
    focus_dist=None,
    *,
    device,
) -> Camera:
    """Build a camera on ``device`` (ref basis math: DxCSApp.cpp:39-61).

    ``focus_dist=None`` uses |look_from - look_at| — the v2 default
    (ref: CSVersion/DxCSApp.cpp:488-489).
    """
    look_from = _f32(look_from, device)
    look_at = _f32(look_at, device)
    vup = _f32(vup, device)

    theta = vfov * math.pi / 180.0
    h = math.tan(theta / 2.0)
    view_h = 2.0 * h
    view_w = aspect * view_h

    if focus_dist is None:
        focus_dist = _norm(look_from - look_at)
    focus_dist = _f32(focus_dist, device)

    w = look_from - look_at
    w = w / _norm(w)
    u = _cross(vup, w)
    u = u / _norm(u)
    v = _cross(w, u)

    horizontal = focus_dist * view_w * u
    vertical = focus_dist * view_h * v
    lower_left = look_from - horizontal / 2.0 - vertical / 2.0 - focus_dist * w

    return Camera(
        origin=look_from,
        horizontal=horizontal,
        vertical=vertical,
        lower_left=lower_left,
        u=u,
        v=v,
        lens_radius=_f32(aperture / 2.0, device),
    )


def reference_camera_v2(aspect: float = 16.0 / 9.0, *, device) -> Camera:
    """The v2 compute-shader camera: lookFrom (13,2,3) -> origin, vfov 20,
    pinhole (the reference passes aperture=2.0 but its kernel ignores it —
    ref: CSVersion/DxCSApp.cpp:176-179,488-489; ShaderCompute.hlsl:118-127).
    """
    return make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0,
                       aspect=aspect, aperture=0.0, device=device)


def reference_camera_v1(*, device) -> Camera:
    """The v1 pixel-shader thin-lens camera: vfov 20, 4:3, aperture 0.1,
    focus dist 10 (ref: DXRayTrace.cpp:196-223)."""
    return make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0,
                       aspect=4.0 / 3.0, aperture=0.1, focus_dist=10.0,
                       device=device)


def get_ray(cam: Camera, s, t, seed):
    """Generate one ray per (s, t); returns ((ox,oy,oz), (dx,dy,dz), seed).

    SoA form: s / t / seed are tensors of any common shape.  With
    ``lens_radius == 0`` this is the v2 pinhole ray and the seed is
    untouched; otherwise the v1 thin-lens offset draws one disk sample
    (advancing the seed by one hash2 step).  Directions are NOT normalized
    (the reference traces unnormalized rays, ShaderCompute.hlsl:160-170).
    """
    defocus = cam.lens_radius > 0
    (dx_disk, dy_disk), seed_lens = rng.random_in_unit_disk(seed)
    seed = torch.where(defocus, seed_lens, seed)
    rdx = cam.lens_radius * dx_disk
    rdy = cam.lens_radius * dy_disk
    # offset = u * rd.x + v * rd.y, zero when pinhole
    offx = torch.where(defocus, cam.u[0] * rdx + cam.v[0] * rdy, 0.0)
    offy = torch.where(defocus, cam.u[1] * rdx + cam.v[1] * rdy, 0.0)
    offz = torch.where(defocus, cam.u[2] * rdx + cam.v[2] * rdy, 0.0)

    ox = cam.origin[0] + offx
    oy = cam.origin[1] + offy
    oz = cam.origin[2] + offz
    dx = cam.lower_left[0] + s * cam.horizontal[0] + t * cam.vertical[0] - ox
    dy = cam.lower_left[1] + s * cam.horizontal[1] + t * cam.vertical[1] - oy
    dz = cam.lower_left[2] + s * cam.horizontal[2] + t * cam.vertical[2] - oz
    return (ox, oy, oz), (dx, dy, dz), seed
