"""State carried across from the JAX package, as numpy arrays.

raytpu's ``Scene`` and ``Camera`` are NamedTuples of arrays with the same
field names as this package's.  These helpers take or give a dict of numpy
arrays keyed by those names (``raytpu_obj._asdict()`` mapped through
``np.asarray`` is one), so both packages can be fed bit-identical inputs
without this package importing jax.

Gradients are Scenes and Cameras too, with ``mat_type`` None (a discrete
leaf has no cotangent; raytpu gives a float0 array there):
:func:`grads_to_numpy` and :func:`scene_grads_from_numpy` carry them across,
so the tests compare both packages' gradients leaf by leaf.
"""

from __future__ import annotations

import numpy as np
import torch

from raytpu_torch.camera import Camera
from raytpu_torch.scene import Scene

_SCENE_DTYPES = {"center": np.float32, "radius": np.float32,
                 "mat_type": np.int32, "albedo": np.float32,
                 "mat_param": np.float32}


def _fields(d) -> dict:
    return d._asdict() if hasattr(d, "_asdict") else dict(d)


def scene_from_numpy(d, device) -> Scene:
    """Scene on ``device`` from a dict (or NamedTuple) of arrays."""
    d = _fields(d)
    return Scene(**{k: torch.from_numpy(np.array(d[k], dt)).to(device)
                    for k, dt in _SCENE_DTYPES.items()})


def camera_from_numpy(d, device) -> Camera:
    """Camera on ``device`` from a dict (or NamedTuple) of arrays."""
    d = _fields(d)
    return Camera(**{k: torch.from_numpy(np.array(d[k], np.float32)).to(device)
                     for k in Camera._fields})


def scene_to_numpy(scene: Scene) -> dict:
    """dict of numpy arrays (host copies) keyed by the Scene field names."""
    return {k: v.detach().cpu().numpy() for k, v in scene._asdict().items()}


def camera_to_numpy(cam: Camera) -> dict:
    """dict of numpy arrays (host copies) keyed by the Camera field names."""
    return {k: v.detach().cpu().numpy() for k, v in cam._asdict().items()}


def grads_to_numpy(grads) -> dict:
    """dict of numpy arrays from a gradient Scene or Camera, without the
    fields that hold None (``mat_type``) or a float0 array."""
    out = {}
    for k, v in _fields(grads).items():
        if k == "mat_type" or v is None:
            continue
        out[k] = (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                  else np.asarray(v, np.float32))
    return out


def scene_grads_from_numpy(d, device) -> Scene:
    """Gradient Scene on ``device`` (``mat_type`` None) from a dict (or
    NamedTuple) of arrays; a ``mat_type`` entry is ignored."""
    d = _fields(d)
    return Scene(**{k: (None if k == "mat_type" else
                        torch.from_numpy(np.array(d[k], np.float32)).to(device))
                    for k in Scene._fields})
