"""Scene representation and builders (counterpart of ``raytpu/scene.py``).

The scene is a SoA NamedTuple of tensors with the JAX package's field names
and layouts — the analogue of the reference's ``WorldDef`` cbuffer (ref:
CSVersion/ShaderCompute.hlsl:12-19, CSVersion/DxCSApp.cpp:64-70):
``center`` (N, 3) f32, ``radius`` (N,) f32, ``mat_type`` (N,) i32,
``albedo`` (N, 3) f32 and ``mat_param`` (N,) f32 (metal fuzz or glass IOR).

The builders draw from the same seeded ``numpy.random.Generator`` calls in
the same order as raytpu's, so every scene comes out array-identical; only
the final step differs: the arrays become tensors on the ``device`` the
caller names.  There is no default device: every builder takes
``device=`` explicitly.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

DIFFUSE = 0
METAL = 1
DIELECTRIC = 2


class Scene(NamedTuple):
    """SoA sphere scene. All fields are tensors with leading dim N."""

    center: torch.Tensor     # (N, 3) f32 sphere centers
    radius: torch.Tensor     # (N,)   f32 sphere radii
    mat_type: torch.Tensor   # (N,)   i32 0=diffuse 1=metal 2=dielectric
    albedo: torch.Tensor     # (N, 3) f32 material color (unused by dielectric)
    mat_param: torch.Tensor  # (N,)   f32 metal fuzz OR dielectric IOR

    @property
    def count(self) -> int:
        return self.center.shape[0]


def make_scene(spheres, device) -> Scene:
    """Build a Scene on ``device`` from a list of
    ``(center_xyz, radius, mat_type, albedo_rgb, mat_param)`` tuples."""
    center = np.array([s[0] for s in spheres], np.float32).reshape(-1, 3)
    radius = np.array([s[1] for s in spheres], np.float32)
    mat_type = np.array([s[2] for s in spheres], np.int32)
    albedo = np.array([s[3] for s in spheres], np.float32).reshape(-1, 3)
    mat_param = np.array([s[4] for s in spheres], np.float32)
    return Scene(*(torch.from_numpy(a).to(device)
                   for a in (center, radius, mat_type, albedo, mat_param)))


def test_world(*, device) -> Scene:
    """4-sphere book scene (ref: CSVersion/DxCSApp.cpp:136-157)."""
    return make_scene([
        ((0.0, -1000.5, -1.0), 1000.0, DIFFUSE, (0.5, 0.5, 0.5), 1.0),
        ((0.0, 0.0, -1.0), 0.5, DIFFUSE, (0.2, 0.4, 0.8), 1.0),
        ((1.0, 0.0, -1.0), 0.5, METAL, (0.8, 0.4, 0.2), 0.0),
        ((-1.0, 0.0, -1.0), 0.5, DIELECTRIC, (0.5, 0.5, 0.5), 1.5),
    ], device)


def v1_world(*, device) -> Scene:
    """The v1 pixel-shader generation's fixed seven-sphere scene
    (ref: Shader_RT.fx:300-335), in the reference's build order."""
    return make_scene([
        ((0.0, -1000.0, 0.0), 1000.0, DIFFUSE, (0.5, 0.5, 0.5), 0.0),
        ((3.0, 0.2, 1.5), 0.2, DIFFUSE, (0.2, 0.2, 0.8), 0.0),
        ((4.5, 0.2, 1.0), 0.2, DIFFUSE, (0.2, 0.8, 0.2), 0.0),
        ((4.5, 0.2, 2.0), 0.2, DIFFUSE, (0.8, 0.3, 0.2), 0.0),
        ((0.0, 1.0, 0.0), 1.0, DIELECTRIC, (1.0, 1.0, 1.0), 1.5),
        ((-4.0, 1.0, 0.0), 1.0, DIFFUSE, (0.4, 0.2, 0.1), 0.0),
        ((4.0, 1.0, 0.0), 1.0, METAL, (0.7, 0.6, 0.5), 0.0),
    ], device)


def config1_world(*, device) -> Scene:
    """BASELINE config 1: one Lambertian sphere + ground sphere."""
    return make_scene([
        ((0.0, -100.5, -1.0), 100.0, DIFFUSE, (0.5, 0.5, 0.5), 1.0),
        ((0.0, 0.0, -1.0), 0.5, DIFFUSE, (0.7, 0.3, 0.3), 1.0),
    ], device)


def config2_world(*, device) -> Scene:
    """BASELINE config 2: Lambertian + metal + dielectric (+ ground)."""
    return test_world(device=device)


def _random_world_spheres(seed: int, half_extent: int) -> list:
    rg = np.random.default_rng(seed)
    spheres = [
        ((0.0, -1000.0, 0.0), 1000.0, DIFFUSE, (0.5, 0.5, 0.5), 1.0),
        ((0.0, 1.0, 0.0), 1.0, DIELECTRIC, (0.0, 0.0, 0.0), 1.5),
        ((-4.0, 1.0, 0.0), 1.0, DIFFUSE, (0.4, 0.2, 0.1), 1.0),
        ((4.0, 1.0, 0.0), 1.0, METAL, (0.7, 0.6, 0.5), 0.0),
    ]
    for a in range(-half_extent, half_extent):
        for b in range(-half_extent, half_extent):
            mat_choice = rg.random()
            center = (a + 0.9 * rg.random(), 0.2, b + 0.9 * rg.random())
            if np.linalg.norm(np.subtract(center, (4.0, 0.2, 0.0))) <= 0.9:
                continue
            if mat_choice < 0.8:
                albedo = tuple(rg.random(3) * rg.random(3))
                spheres.append((center, 0.2, DIFFUSE, albedo, 0.0))
            elif mat_choice < 0.95:
                albedo = tuple(rg.random(3) / 2 + 1)
                spheres.append((center, 0.2, METAL, albedo, 0.0))
            else:
                spheres.append((center, 0.2, DIELECTRIC, (0.0, 0.0, 0.0), 1.5))
    return spheres


def random_world(seed: int = 0, half_extent: int = 9, *, device) -> Scene:
    """Random hero + grid scene (ref: CSVersion/DxCSApp.cpp:72-134).

    Ground r=1000 + 3 hero spheres (glass / lambert / metal) + a jittered
    ``(2*half_extent)^2`` grid of r=0.2 spheres: 80% diffuse (albedo =
    rand*rand), 15% metal (albedo = rand/2 + 1 — the reference's
    energy-amplifying quirk, ref: DxCSApp.cpp:118, kept unclamped), 5%
    glass (IOR 1.5).  Grid spheres within 0.9 of (4, 0.2, 0) are skipped.
    """
    return make_scene(_random_world_spheres(seed, half_extent), device)


def final_world(seed: int = 0, n: int = 500, *, device) -> Scene:
    """BASELINE config 4/5: exactly ``n`` spheres (grid scene, topped up or
    truncated to ``n`` with extra random r=0.2 diffuse spheres).

    The grid part goes through f32 first, as raytpu's does (it reads its
    spheres back from the f32 ``random_world`` arrays)."""
    base = make_scene(_random_world_spheres(seed, 11), "cpu")
    spheres = list(zip(
        base.center.numpy().tolist(),
        base.radius.numpy().tolist(),
        base.mat_type.numpy().tolist(),
        base.albedo.numpy().tolist(),
        base.mat_param.numpy().tolist(),
    ))
    rg = np.random.default_rng(seed + 1)
    while len(spheres) < n:
        center = (rg.uniform(-11, 11), 0.2, rg.uniform(-11, 11))
        if np.linalg.norm(np.subtract(center, (4.0, 0.2, 0.0))) <= 0.9:
            continue
        albedo = tuple(rg.random(3) * rg.random(3))
        spheres.append((center, 0.2, DIFFUSE, albedo, 0.0))
    return make_scene(spheres[:n], device)
