"""Scenes of the benchmark's configurations, made by the benchmark itself.

The builders are frozen copies of the book scenes the configurations name
(the reference's ``random_world``, CSVersion/DxCSApp.cpp:72-134, and
BASELINE's 500-sphere final scene), drawn from the seed the configuration
file states, so every run of a configuration renders one scene.  The run's
``--seed`` permutes the spheres' order, on the card: the same set of
spheres and the same work in another order, which moves every sphere's
index in the program's tables.
"""

from __future__ import annotations

import numpy as np
import torch

from rtbench.reference import Spheres

DIFFUSE, METAL, GLASS = 0, 1, 2


def _grid(seed: int, half_extent: int) -> list:
    rg = np.random.default_rng(seed)
    spheres = [
        ((0.0, -1000.0, 0.0), 1000.0, DIFFUSE, (0.5, 0.5, 0.5), 1.0),
        ((0.0, 1.0, 0.0), 1.0, GLASS, (0.0, 0.0, 0.0), 1.5),
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
                spheres.append((center, 0.2, DIFFUSE,
                                tuple(rg.random(3) * rg.random(3)), 0.0))
            elif mat_choice < 0.95:
                spheres.append((center, 0.2, METAL,
                                tuple(rg.random(3) / 2 + 1), 0.0))
            else:
                spheres.append((center, 0.2, GLASS, (0.0, 0.0, 0.0), 1.5))
    return spheres


def _arrays(spheres) -> tuple:
    return (np.array([s[0] for s in spheres], np.float32).reshape(-1, 3),
            np.array([s[1] for s in spheres], np.float32),
            np.array([s[2] for s in spheres], np.int64),
            np.array([s[3] for s in spheres], np.float32).reshape(-1, 3),
            np.array([s[4] for s in spheres], np.float32))


def random_world(seed: int, half_extent: int) -> tuple:
    """Ground, three heroes and a jittered grid of r = 0.2 spheres: 80%
    diffuse (albedo rand * rand), 15% metal (rand / 2 + 1, unclamped), 5%
    glass; grid spheres within 0.9 of (4, 0.2, 0) are skipped."""
    return _arrays(_grid(seed, half_extent))


def final_world(seed: int, n: int) -> tuple:
    """BASELINE configs 4 and 5: the half-extent-11 grid scene, read back
    through f32, topped up to exactly ``n`` spheres with random r = 0.2
    diffuse ones (or cut to ``n``)."""
    c, r, m, a, p = random_world(seed, 11)
    spheres = list(zip(c.tolist(), r.tolist(), m.tolist(), a.tolist(),
                       p.tolist()))
    rg = np.random.default_rng(seed + 1)
    while len(spheres) < n:
        center = (rg.uniform(-11, 11), 0.2, rg.uniform(-11, 11))
        if np.linalg.norm(np.subtract(center, (4.0, 0.2, 0.0))) <= 0.9:
            continue
        spheres.append((center, 0.2, DIFFUSE,
                        tuple(rg.random(3) * rg.random(3)), 0.0))
    return _arrays(spheres[:n])


def listed(spheres) -> tuple:
    """A scene the configuration file lists sphere by sphere:
    ``[[cx, cy, cz], r, material, [ar, ag, ab], param]`` each."""
    return _arrays([(tuple(s[0]), s[1], s[2], tuple(s[3]), s[4])
                    for s in spheres])


BUILDERS = {"random_world": random_world, "final_world": final_world,
            "listed": listed}


def build(spec: dict) -> tuple:
    """The numpy arrays of the scene a configuration's ``scene`` entry
    names: ``{"builder": name, **arguments}``."""
    args = {k: v for k, v in spec.items() if k != "builder"}
    return BUILDERS[spec["builder"]](**args)


def generator(seed: int, device) -> torch.Generator:
    """A torch generator on ``device`` from a run's seed (any whole number
    below 2**64)."""
    return torch.Generator(device=device).manual_seed(int(seed) % 2**64)


def on_device(arrays: tuple, seed: int, device) -> Spheres:
    """The scene on ``device`` in the order a random permutation drawn from
    ``seed`` gives."""
    c, r, m, a, p = (torch.from_numpy(x).to(device) for x in arrays)
    perm = torch.randperm(r.shape[0], generator=generator(seed, device),
                          device=device)
    return Spheres(c[perm], r[perm], m[perm], a[perm], p[perm])
