"""Scene files: JSON scene descriptions for the CLI and tools (counterpart
of ``raytpu/scene_io.py``, with its schema).

Schema::

    {"spheres": [
        {"center": [x, y, z], "radius": r,
         "material": "diffuse" | "metal" | "dielectric",
         "albedo": [r, g, b],        # optional, default [0.5, 0.5, 0.5]
         "param": f}                 # metal fuzz or dielectric IOR
    ]}

Unknown top-level keys are ignored (forward compatibility); unknown
material names raise.  A file written by either package loads in the other
with equal arrays: both write each f32 as the exact Python float and read
it back to the same f32.  Loaders take the device the scene is built on
(``device=``, required), as the scene builders do.
"""

from __future__ import annotations

import json

from raytpu_torch.scene import DIELECTRIC, DIFFUSE, METAL, Scene, make_scene

_MAT_NAMES = {"diffuse": DIFFUSE, "metal": METAL, "dielectric": DIELECTRIC}
_MAT_IDS = {v: k for k, v in _MAT_NAMES.items()}


def scene_to_dict(scene: Scene) -> dict:
    """The scene as the schema's dict (host copies of its arrays)."""
    center, radius, mat, albedo, param = (
        t.detach().cpu().numpy() for t in scene)
    return {"spheres": [{
        "center": [float(v) for v in center[i]],
        "radius": float(radius[i]),
        "material": _MAT_IDS[int(mat[i])],
        "albedo": [float(v) for v in albedo[i]],
        "param": float(param[i]),
    } for i in range(len(radius))]}


def scene_from_dict(d: dict, *, device) -> Scene:
    """A Scene on ``device`` from the schema's dict; raises on an unknown
    material or no spheres, with raytpu's messages."""
    spheres = []
    for i, s in enumerate(d["spheres"]):
        name = s.get("material", "diffuse")
        if name not in _MAT_NAMES:
            raise ValueError(
                f"sphere {i}: unknown material {name!r} "
                f"(expected one of {sorted(_MAT_NAMES)})")
        spheres.append((
            tuple(float(v) for v in s["center"]),
            float(s["radius"]),
            _MAT_NAMES[name],
            tuple(float(v) for v in s.get("albedo", (0.5, 0.5, 0.5))),
            float(s.get("param", 0.0)),
        ))
    if not spheres:
        raise ValueError("scene has no spheres")
    return make_scene(spheres, device)


def save_scene(path: str, scene: Scene) -> None:
    """Write the scene to ``path`` as JSON, as raytpu's ``save_scene``."""
    with open(path, "w") as f:
        json.dump(scene_to_dict(scene), f, indent=1)
        f.write("\n")


def load_scene(path: str, *, device) -> Scene:
    """The scene in the JSON file ``path``, on ``device``."""
    with open(path) as f:
        return scene_from_dict(json.load(f), device=device)

