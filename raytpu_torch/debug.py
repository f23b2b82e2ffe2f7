"""Validation and debug tools (counterpart of ``raytpu/debug.py``).

- :func:`checked_render` — the plain renderer with a non-finite check after
  every bounce: it raises ``FloatingPointError`` naming the bounce and a
  pixel where raytpu's ``checkify`` float checks raise, instead of letting
  NaN or Inf turn into black or garbage pixels;
- :func:`validate_backends` — the kernel against its plain version on the
  same card (K1a, or K1c or K1d over a BVH, by raytpu's rule), bit for bit;
  on the CPU the plain version alone, with a BVH held against the brute
  sweep;
- :func:`validate_scene` — host-side scene lint with raytpu's messages.
"""

from __future__ import annotations

import numpy as np
import torch

from raytpu_torch import golden
from raytpu_torch.bvh import BVH, sweep_of
from raytpu_torch.camera import Camera
from raytpu_torch.config import RenderConfig
from raytpu_torch.kernels import megakernel
from raytpu_torch.scene import DIELECTRIC, DIFFUSE, METAL, Scene

# share of pixels an exact tie of t between distinct spheres may change
# between two sweeps (chip_smoke.py's TIE_SHARE)
TIE_SHARE = 1e-4


def checked_render(scene: Scene, cam: Camera, cfg: RenderConfig):
    """Render with the plain version and raise ``FloatingPointError`` at
    the first non-finite value, naming the bounce and a pixel; returns the
    (H, W, 3) image otherwise.

    What raytpu's ``checkify.float_checks`` flag in its golden render, in
    the order the render meets them: a non-finite centre or radius (every
    bounce's sweep reads every sphere, so bounce 0 and the first pixel),
    then per bounce a non-finite attribute of a lane's winner (albedo,
    mat_param: gathered for every lane, a miss's too) or a non-finite t,
    normal, attenuation, direction, throughput or radiance."""
    device = megakernel.check_inputs(scene, cam, cfg)
    w, n_pix = cfg.width, cfg.width * cfg.height
    for name in ("center", "radius"):
        if not bool(torch.isfinite(getattr(scene, name)).all()):
            raise FloatingPointError(
                f"non-finite sphere {name} at bounce 0, pixel (0, 0)")
    out = torch.empty((n_pix, 3), dtype=torch.float32, device=device)
    chunk = max(min(cfg.chunk_pixels, n_pix), 1)
    for start in range(0, n_pix, chunk):
        flat = torch.arange(start, min(start + chunk, n_pix), device=device)

        def check(bounce, idx, values, start=start):
            bad = ~(torch.isfinite(scene.albedo[idx]).all(dim=-1)
                    & torch.isfinite(scene.mat_param[idx]))
            for v in values:
                bad |= ~torch.isfinite(v)
            if bool(bad.any()):
                i = start + int(bad.nonzero()[0, 0])
                raise FloatingPointError(
                    f"non-finite value at bounce {bounce}, pixel "
                    f"({i % w}, {i // w})")

        out[start:start + flat.numel()] = torch.stack(golden.render_pixels(
            scene, cam, cfg, flat % w, flat // w, check=check), dim=-1)
    return out.reshape(cfg.height, w, 3)


def validate_scene(scene: Scene) -> list[str]:
    """Host-side scene lint -> list of human-readable problems (raytpu's
    checks and strings)."""
    center, radius, mat, albedo, param = (
        t.detach().cpu().numpy() for t in scene)
    problems = []
    if not np.isfinite(center).all():
        problems.append("non-finite sphere center")
    if not np.isfinite(radius).all():
        problems.append("non-finite radius")
    if (radius == 0).any():
        problems.append("zero radius sphere (degenerate normal)")
    bad = ~np.isin(mat, (DIFFUSE, METAL, DIELECTRIC))
    if bad.any():
        problems.append(
            f"unknown material ids {sorted(set(mat[bad].tolist()))} "
            "(rays absorb to black, ref hlsl:251)")
    if ((albedo < 0) | ~np.isfinite(albedo)).any():
        problems.append("negative/non-finite albedo")
    if (albedo > 1).any():
        problems.append(
            "albedo > 1 (energy-amplifying; the reference's random_world "
            "metal quirk, DxCSApp.cpp:118 — allowed but noteworthy)")
    if (param[mat == DIELECTRIC] <= 0).any():
        problems.append("dielectric with IOR <= 0")
    return problems


def validate_backends(scene: Scene, cam: Camera, cfg: RenderConfig,
                      bvh: BVH | None = None) -> dict:
    """Cross-backend consistency -> report dict.

    Always: ``device``, ``sweep`` ("brute", or the BVH's "flat" / "walk")
    and ``plain_finite``, the plain version's image finite.  On a CUDA
    device: ``kernel_bit_identical``, the kernel (K1a, K1c or K1d) against
    the plain version on the same card, both built to round every f32
    operation alike, with ``kernel_max_diff``.  On the CPU, with a BVH:
    ``bvh_pixels_differ_brute``, pixels where the plain BVH sweep differs
    from the plain brute sweep, and ``bvh_matches_brute``, at most
    :data:`TIE_SHARE` of them (exact ties of t between spheres)."""
    device = megakernel.check_inputs(scene, cam, cfg)
    plain = golden.render_golden(scene, cam, cfg, bvh)
    report = {"device": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else str(device)),
              "sweep": "brute" if bvh is None else sweep_of(bvh),
              "plain_finite": bool(torch.isfinite(plain).all())}
    if device.type == "cuda":
        cam_pack, packed = megakernel.pack(scene, cam, bvh)
        got = megakernel.launch(cam_pack, packed, cfg, bvh)
        report["kernel_bit_identical"] = bool(torch.equal(got, plain))
        report["kernel_max_diff"] = float((got - plain).abs().max())
    elif bvh is not None:
        brute = golden.render_golden(scene, cam, cfg)
        differ = int((plain != brute).any(dim=-1).sum())
        report["bvh_pixels_differ_brute"] = differ
        report["bvh_matches_brute"] = (
            differ <= TIE_SHARE * cfg.width * cfg.height)
    return report
