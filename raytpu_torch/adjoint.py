"""Hand-structured adjoint of the bounce loop (counterpart of
``raytpu/adjoint.py``).

Generic reverse mode through :func:`raytpu_torch.golden.trace` would
differentiate the whole ``hit_world`` broadcast: the backward of every
bounce re-materializes a (pixels x spheres) sweep just to pull gradients
through the argmin gather.  The derivative of a bounce involves only the ONE
sphere the ray hit; the closest-hit selection is discrete and detached by
policy.  So :class:`_TraceAdjoint` is a ``torch.autograd.Function`` whose

- **forward** runs the plain bounce loop and keeps, per bounce, a compact
  residual: the incoming ray and throughput, the winner index, the event
  masks (scat / missed) and the pre-bounce RNG state (O(pixels x depth), no
  sphere dimension);
- **backward** walks the bounces in reverse and takes each bounce's VJP
  (``torch.autograd.grad`` of :func:`_bounce_math`) against the gathered
  winner only, adding the sphere cotangents at the stored index with
  ``index_add_``.

It is the plain version of the fused VJP kernel K3
(``raytpu_torch/kernels/gradkernel.py``): the kernel's CPU path runs it, and
``chip_smoke.py`` holds the kernel against it on the card.  The detach
policy is raytpu's: the winner, the front face, the near-root choice, the
TIR / Schlick coin, the v1 hemisphere flip and near-zero guard and every RNG
draw carry no gradient.  ``vis_w > 0`` adds raytpu's silhouette (boundary)
terms to the backward; the forward stays the exact hard render.

Winners come from a sweep — :func:`raytpu_torch.golden.hit_world`, or with a
BVH :func:`raytpu_torch.golden.hit_bvh` (the flat sweep or the skip-pointer
walk, by raytpu's rule) over the scene in leaf order —
or, for the steps a winner-index tape holds, from the tape
(:class:`_Winners`): the plain version of K3's tape replay.  The winner
alone decides the bounce (``_bounce_math`` recomputes that one sphere's t
with hit_world's formula), so a taped forward keeps the same residuals as a
swept one, and its gradients are bit-equal.
"""

from __future__ import annotations

import torch

from raytpu_torch import golden, rng
from raytpu_torch.bvh import BVH, permute_scene
from raytpu_torch.camera import Camera, get_ray
from raytpu_torch.config import RenderConfig
from raytpu_torch.golden import (_INF, _dot3, _max_c, _min_c, _normalize3,
                                 _reflect, _refract, _schlick, _sky,
                                 _sqrt_st, _to_gamma)
from raytpu_torch.scene import Scene


def _gather_leaves(scene: Scene, idx):
    return (scene.center[idx], scene.radius[idx], scene.albedo[idx],
            scene.mat_param[idx])


def _bounce_math(ro, rd, thr, gathered, mat, seed, masks, t_min,
                 scatter_mode: str = "v2"):
    """Continuous per-bounce math against the ONE gathered sphere.

    ro / rd / thr: incoming ray origin, direction and throughput (SoA
    tuples).  gathered: (center (..., 3), radius, albedo (..., 3),
    mat_param) of the winning sphere, which gradients flow to.  mat: the
    winner's material (discrete).  masks: (scat, missed), the detached
    events.  Returns (new ro, new rd, new thr, radiance contribution):
    golden.trace's body with the argmin replaced by the pre-selected sphere.
    """
    ox, oy, oz = ro
    dx, dy, dz = rd
    cr, cg, cb = thr
    center, radius, albedo, param = gathered
    scat, missed = masks
    t_min = rng.f32_like(ox, t_min)

    # t for the selected sphere; the root CHOICE is detached (a comparison)
    cx, cy, cz = center[..., 0], center[..., 1], center[..., 2]
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    a = _dot3(dx, dy, dz, dx, dy, dz)
    half_b = ocx * dx + ocy * dy + ocz * dz
    c = _dot3(ocx, ocy, ocz, ocx, ocy, ocz) - radius * radius
    disc = half_b * half_b - a * c
    sqrtd = _sqrt_st(disc, disc >= 0)
    inv_a = 1.0 / a
    root1 = (-half_b - sqrtd) * inv_a
    root2 = (-half_b + sqrtd) * inv_a
    t = torch.where(root1 >= t_min, root1, root2)
    t = torch.where(scat, t, 1.0)  # dead lanes: safe t

    px = ox + t * dx
    py = oy + t * dy
    pz = oz + t * dz
    inv_r = 1.0 / torch.where(radius == 0, 1.0, radius)
    nx = (px - cx) * inv_r
    ny = (py - cy) * inv_r
    nz = (pz - cz) * inv_r
    front = _dot3(dx, dy, dz, nx, ny, nz) < 0
    sgn = torch.where(front, 1.0, -1.0)
    nx, ny, nz = nx * sgn, ny * sgn, nz * sgn

    # scatter draws recomputed from the stored pre-bounce RNG state
    (sx, sy, sz), _ = rng.random_in_unit_sphere(seed)
    h1, _ = rng.hash1(seed)

    if scatter_mode == "v1":
        flip = _dot3(sx, sy, sz, nx, ny, nz) > 0
        hxx = torch.where(flip, sx, -sx)
        hyy = torch.where(flip, sy, -sy)
        hzz = torch.where(flip, sz, -sz)
        ldx = nx + hxx
        ldy = ny + hyy
        ldz = nz + hzz
        s_eps = 1e-8
        near0 = ((torch.abs(ldx) < s_eps) & (torch.abs(ldy) < s_eps)
                 & (torch.abs(ldz) < s_eps))
        ddx = torch.where(near0, nx, ldx)
        ddy = torch.where(near0, ny, ldy)
        ddz = torch.where(near0, nz, ldz)
        u1x, u1y, u1z = _normalize3(dx, dy, dz)
        rx, ry, rz = _reflect(u1x, u1y, u1z, nx, ny, nz)
        fz = _min_c(_max_c(param, 0.0), 1.0)
        mdx = rx + fz * hxx
        mdy = ry + fz * hyy
        mdz = rz + fz * hzz
    else:
        ddx, ddy, ddz = _normalize3(nx + sx, ny + sy, nz + sz)
        rx, ry, rz = _reflect(dx, dy, dz, nx, ny, nz)
        mdx, mdy, mdz = _normalize3(rx + param * sx, ry + param * sy,
                                    rz + param * sz)

    is_glass = mat == 2
    ior = torch.where(is_glass, _max_c(param, 1e-3), 1.5)
    ux, uy, uz = _normalize3(dx, dy, dz)
    ratio = torch.where(front, 1.0 / ior, ior)
    cosine = _min_c(_dot3(-ux, -uy, -uz, nx, ny, nz), 1.0)
    sine = torch.sqrt(_max_c(1.0 - cosine * cosine, 0.0))
    cannot = ratio * sine > 1.0
    use_reflect = cannot | (_schlick(cosine, ratio) > h1)
    rfx, rfy, rfz = _reflect(ux, uy, uz, nx, ny, nz)
    tx, ty, tz = _refract(ux, uy, uz, nx, ny, nz, ratio)
    gdx = torch.where(use_reflect, rfx, tx)
    gdy = torch.where(use_reflect, rfy, ty)
    gdz = torch.where(use_reflect, rfz, tz)

    is_d = mat == 0
    is_m = mat == 1
    atr = torch.where(is_glass, 1.0, albedo[..., 0])
    atg = torch.where(is_glass, 1.0, albedo[..., 1])
    atb = torch.where(is_glass, 1.0, albedo[..., 2])
    odx = torch.where(is_d, ddx, torch.where(is_m, mdx, gdx))
    ody = torch.where(is_d, ddy, torch.where(is_m, mdy, gdy))
    odz = torch.where(is_d, ddz, torch.where(is_m, mdz, gdz))

    skr, skg, skb = _sky(dx, dy, dz)
    out_r = torch.where(missed, cr * skr, 0.0)
    out_g = torch.where(missed, cg * skg, 0.0)
    out_b = torch.where(missed, cb * skb, 0.0)

    n_cr = torch.where(scat, cr * atr, cr)
    n_cg = torch.where(scat, cg * atg, cg)
    n_cb = torch.where(scat, cb * atb, cb)
    n_ox = torch.where(scat, px, ox)
    n_oy = torch.where(scat, py, oy)
    n_oz = torch.where(scat, pz, oz)
    n_dx = torch.where(scat, odx, dx)
    n_dy = torch.where(scat, ody, dy)
    n_dz = torch.where(scat, odz, dz)
    return ((n_ox, n_oy, n_oz), (n_dx, n_dy, n_dz),
            (n_cr, n_cg, n_cb), (out_r, out_g, out_b))


def _near_miss_sweep(scene: Scene, ro, rd):
    """Closest near-miss sphere per ray: argmax of the (negative)
    discriminant over forward-facing misses.  O(P*N); run only when
    silhouette gradients are on (vis_w > 0)."""
    rox, roy, roz = ro
    rdx, rdy, rdz = rd
    cx, cy, cz = scene.center[:, 0], scene.center[:, 1], scene.center[:, 2]
    ocx = rox[..., None] - cx
    ocy = roy[..., None] - cy
    ocz = roz[..., None] - cz
    a = _dot3(rdx, rdy, rdz, rdx, rdy, rdz)[..., None]
    half_b = (ocx * rdx[..., None] + ocy * rdy[..., None]
              + ocz * rdz[..., None])
    c = _dot3(ocx, ocy, ocz, ocx, ocy, ocz) - scene.radius * scene.radius
    disc = half_b * half_b - a * c
    score = torch.where((half_b < 0) & (disc < 0), disc, -_INF)
    best, m_idx = score.max(dim=-1)  # the first maximum, as jnp.argmax
    return m_idx, best > -_INF


def _boundary(scene, sel_idx, o, d, jump, dacc, mask, vis_w):
    """Soft-coverage straight-through term of raytpu's silhouette
    gradients: d(alpha) with alpha = sigmoid(disc / (a * vis_w)), scaled by
    the radiance jump a coverage flip would cause.  -> (d center, d radius)
    per ray, zero where ``mask`` is off."""
    ox, oy, oz = o
    dx, dy, dz = d
    C = scene.center[sel_idx]
    R = scene.radius[sel_idx]
    ocx = ox - C[..., 0]
    ocy = oy - C[..., 1]
    ocz = oz - C[..., 2]
    a = _dot3(dx, dy, dz, dx, dy, dz)
    hb = ocx * dx + ocy * dy + ocz * dz
    c = _dot3(ocx, ocy, ocz, ocx, ocy, ocz) - R * R
    disc = hb * hb - a * c
    sref = a * rng.f32_like(a, vis_w)
    sig = 1.0 / (1.0 + torch.exp(-(disc / sref)))
    dsig = sig * (1.0 - sig) / sref
    w_ct = dacc[0] * jump[0] + dacc[1] * jump[1] + dacc[2] * jump[2]
    f = torch.where(mask, dsig * w_ct, 0.0)
    # d disc / d center = 2a*oc - 2hb*d ; d disc / d radius = 2aR
    g_c = torch.stack([f * (2 * a * ocx - 2 * hb * dx),
                       f * (2 * a * ocy - 2 * hb * dy),
                       f * (2 * a * ocz - 2 * hb * dz)], dim=-1)
    return g_c, f * (2 * a * R)


def _silhouette(scene, res, v, dacc, vis_w, g_center, g_radius):
    """Adds both silhouette terms of one bounce into g_center / g_radius
    (raytpu/adjoint.py:339-420)."""
    (ox, oy, oz, dx, dy, dz, cr, cg, cb, idx, scat, missed, _,
     m_idx, nm_valid) = res
    o, d = (ox, oy, oz), (dx, dy, dz)
    skr, skg, skb = _sky(dx, dy, dz)
    # hit side: losing coverage turns this sample's value v into thr * sky
    gc, gr = _boundary(scene, idx, o, d, (v[0] - cr * skr, v[1] - cg * skg,
                                          v[2] - cb * skb), dacc, scat, vis_w)
    g_center.index_add_(0, idx, gc)
    g_radius.index_add_(0, idx, gr)
    # miss side: the nearest forward near-miss sphere gaining coverage,
    # with a one-bounce covered-radiance estimate by material at the
    # grazing boundary (diffuse: alb * sky(n); metal: alb * sky(reflect);
    # glass: sky(reflect), unit attenuation)
    C_m = scene.center[m_idx]
    alb_m = scene.albedo[m_idx]
    mat_m = scene.mat_type[m_idx]
    mocx = ox - C_m[..., 0]
    mocy = oy - C_m[..., 1]
    mocz = oz - C_m[..., 2]
    a_m = _dot3(dx, dy, dz, dx, dy, dz)
    hb_m = mocx * dx + mocy * dy + mocz * dz
    t_ca = -hb_m / a_m  # closest approach along the ray
    nbx, nby, nbz = _normalize3(mocx + t_ca * dx, mocy + t_ca * dy,
                                mocz + t_ca * dz)
    udx, udy, udz = _normalize3(dx, dy, dz)
    rfx, rfy, rfz = _reflect(udx, udy, udz, nbx, nby, nbz)
    sky_n = _sky(nbx, nby, nbz)
    sky_f = _sky(rfx, rfy, rfz)
    is_dm = mat_m == 0
    is_gm = mat_m == 2
    jump = []
    for k, thr in enumerate((cr, cg, cb)):
        alb = alb_m[..., k]
        est = torch.where(is_dm, alb * sky_n[k],
                          torch.where(is_gm, sky_f[k], alb * sky_f[k]))
        jump.append(thr * est - v[k])
    gc, gr = _boundary(scene, m_idx, o, d, jump, dacc, nm_valid, vis_w)
    g_center.index_add_(0, m_idx, gc)
    g_radius.index_add_(0, m_idx, gr)


class _Winners:
    """Closest-hit winners of one bounce step for the adjoint's forward.

    Swept (``hit_world``, or ``hit_bvh`` by the BVH's sweep, flat or walk,
    when ``bvh`` is given and the scene is in its leaf order), or read from
    a winner-index tape for the steps it holds: ``tape = (buf, pix, k)`` as
    in :func:`raytpu_torch.golden.log_winners`, ``k`` the lanes' next
    global step, advanced by one for every live lane.  Steps at or past
    the tape's cap are swept, as K3's tape replay does (by the walk past
    ``g_cap`` on a walk BVH).  A dead lane's winner is never read."""

    def __init__(self, bvh: BVH | None = None, tape=None):
        self.bvh, self.tape = bvh, tape

    def _sweep(self, scene, ro, rd, t_min, alive):
        if self.bvh is None:
            hit = golden.hit_world(scene, ro, rd, t_min)
        else:
            hit = golden.hit_bvh(scene, self.bvh, ro, rd, t_min, live=alive)
        return hit[0], hit[2]

    def __call__(self, scene, ro, rd, t_min, alive):
        """-> (hit_any, winner index) per lane."""
        if self.tape is None:
            return self._sweep(scene, ro, rd, t_min, alive)
        buf, pix, k = self.tape
        g_cap = buf.shape[0]
        taped = k < g_cap
        if g_cap == 0 or bool((alive & ~taped).any()):
            hit_any, idx = self._sweep(scene, ro, rd, t_min, alive & ~taped)
        else:
            hit_any = idx = None
        if g_cap:
            w = buf[k.clamp(max=g_cap - 1), pix].to(torch.int64)
            if idx is None:
                hit_any, idx = w >= 0, w
            else:
                hit_any = torch.where(taped, w >= 0, hit_any)
                idx = torch.where(taped, w, idx)
        k += alive.to(k.dtype)
        return hit_any, idx


class _TraceAdjoint(torch.autograd.Function):
    """golden.trace with the hand-structured backward.

    apply(center, radius, albedo, mat_param, mat_type, ox, oy, oz, dx, dy,
    dz, seed, depth, t_min, vis_w, scatter_mode, winners) -> (r, g, b,
    seed'); ``winners`` is a :class:`_Winners`."""

    @staticmethod
    def forward(ctx, center, radius, albedo, mat_param, mat_type,
                ox, oy, oz, dx, dy, dz, seed, depth, t_min, vis_w,
                scatter_mode, winners):
        scene = Scene(center, radius, mat_type, albedo, mat_param)
        cr = torch.ones_like(ox)
        cg = torch.ones_like(ox)
        cb = torch.ones_like(ox)
        rr = torch.zeros_like(ox)
        rg = torch.zeros_like(ox)
        rb = torch.zeros_like(ox)
        alive = torch.ones_like(ox, dtype=torch.bool)
        sd = seed
        residuals = []
        for _ in range(depth):
            # a dead lane's state never changes again, and its later
            # bounces pass every cotangent through unchanged: stop early
            if not bool(alive.any()):
                break
            hit_any, idx = winners(scene, (ox, oy, oz), (dx, dy, dz),
                                   t_min, alive)
            # one index for every lane that does not scatter off a
            # sphere (misses, dead lanes): their terms are masked out, so
            # swept and taped forwards keep identical residuals
            idx = torch.where(alive & hit_any, idx, 0)
            mat = mat_type[idx]
            ok = (mat == 0) | (mat == 1) | (mat == 2)
            scat = alive & hit_any & ok
            absorbed = alive & hit_any & ~ok
            missed = alive & ~hit_any
            res = (ox, oy, oz, dx, dy, dz, cr, cg, cb, idx, scat, missed, sd)
            if vis_w > 0:
                m_idx, has_nm = _near_miss_sweep(scene, (ox, oy, oz),
                                                 (dx, dy, dz))
                res = res + (m_idx, missed & has_nm)
            residuals.append(res)
            (ox, oy, oz), (dx, dy, dz), (cr, cg, cb), out = _bounce_math(
                (ox, oy, oz), (dx, dy, dz), (cr, cg, cb),
                _gather_leaves(scene, idx), mat, sd, (scat, missed), t_min,
                scatter_mode)
            _, sd_new = rng.hash1(sd)  # the scatter's one state advance
            rr = rr + out[0]
            rg = rg + out[1]
            rb = rb + out[2]
            sd = torch.where(scat, sd_new, sd)
            alive = alive & ~(missed | absorbed)
        ctx.save_for_backward(center, radius, albedo, mat_param, mat_type)
        ctx.residuals = residuals
        ctx.value = (rr, rg, rb)
        ctx.cfg = (t_min, vis_w, scatter_mode)
        ctx.mark_non_differentiable(sd)
        return rr, rg, rb, sd

    @staticmethod
    def backward(ctx, ct_r, ct_g, ct_b, _ct_seed):
        center, radius, albedo, mat_param, mat_type = ctx.saved_tensors
        scene = Scene(center, radius, mat_type, albedo, mat_param)
        t_min, vis_w, scatter_mode = ctx.cfg
        zero = torch.zeros_like(ct_r)
        dacc = (ct_r, ct_g, ct_b)
        g_center = torch.zeros_like(center)
        g_radius = torch.zeros_like(radius)
        g_albedo = torch.zeros_like(albedo)
        g_param = torch.zeros_like(mat_param)
        carry = [zero] * 9  # d origin, d direction, d throughput
        for res in reversed(ctx.residuals):
            ray_thr = res[:9]
            idx, scat, missed, sd = res[9:13]
            mat = mat_type[idx]
            with torch.enable_grad():
                ins = [t.detach().requires_grad_() for t in ray_thr]
                gath = [t.detach().requires_grad_()
                        for t in _gather_leaves(scene, idx)]
                n_ro, n_rd, n_thr, out = _bounce_math(
                    tuple(ins[0:3]), tuple(ins[3:6]), tuple(ins[6:9]),
                    tuple(gath), mat, sd, (scat, missed), t_min,
                    scatter_mode)
                grads = torch.autograd.grad(
                    (*n_ro, *n_rd, *n_thr, *out), ins + gath,
                    (*carry, *dacc), allow_unused=True)
            grads = [torch.zeros_like(x) if g is None else g
                     for g, x in zip(grads, ins + gath)]
            carry = grads[:9]
            gc, gr, ga, gp = grads[9:]
            # attribute cotangents of scattering lanes go to their winner
            m = scat
            g_center.index_add_(0, idx, torch.where(m[..., None], gc, 0.0))
            g_radius.index_add_(0, idx, torch.where(m, gr, 0.0))
            g_albedo.index_add_(0, idx, torch.where(m[..., None], ga, 0.0))
            g_param.index_add_(0, idx, torch.where(m, gp, 0.0))
            if vis_w > 0:
                _silhouette(scene, res, ctx.value, dacc, vis_w, g_center,
                            g_radius)
        d_ox, d_oy, d_oz, d_dx, d_dy, d_dz = carry[:6]
        return (g_center, g_radius, g_albedo, g_param, None,
                d_ox, d_oy, d_oz, d_dx, d_dy, d_dz,
                None, None, None, None, None, None)


def trace_adjoint(scene: Scene, ro, rd, seed, depth: int, t_min: float,
                  vis_w: float = 0.0, scatter_mode: str = "v2",
                  winners: _Winners | None = None):
    """Drop-in for golden.trace with the hand-structured backward:
    -> ((r, g, b), seed').  ``vis_w > 0`` adds silhouette gradients;
    ``winners`` (default: the brute sweep) picks each step's winner."""
    r, g, b, sd = _TraceAdjoint.apply(
        scene.center, scene.radius, scene.albedo, scene.mat_param,
        scene.mat_type, *ro, *rd, seed, depth, t_min, float(vis_w),
        scatter_mode, _Winners() if winners is None else winners)
    return (r, g, b), sd


def check_cfg(cfg: RenderConfig):
    """Raise on an RNG mode gradients do not take, with raytpu's message
    (raytpu/render.py:132-135)."""
    if cfg.rng_mode == "v1_fractsin":
        raise ValueError(
            "rng_mode='v1_fractsin' is a forward reference-parity mode; "
            "use the sequential/parallel RNG modes for gradients")
    if cfg.rng_mode not in ("sequential", "parallel"):
        raise ValueError(f"unknown rng_mode: {cfg.rng_mode!r}")


def _camera_ray(scene, cam, cfg, px, py, sd):
    fx = px.to(torch.float32)
    fy = py.to(torch.float32)
    inv_w = rng.f32_like(fx, 1.0 / (cfg.width - 1))
    inv_h = rng.f32_like(fx, 1.0 / (cfg.height - 1))
    (j1a, _), sd = rng.hash2(sd)
    (_, j2b), sd = rng.hash2(sd)
    u = (fx + j1a * 1.1) * inv_w
    v = (fy + j2b * 1.1) * inv_h
    return get_ray(cam, u, v, sd)


def render_pixels_adjoint(scene: Scene, cam: Camera, cfg: RenderConfig,
                          px, py, vis_w: float = 0.0,
                          winners: _Winners | None = None):
    """golden.render_pixels with the adjoint trace; sequential RNG chain
    (the sample loop threads each pixel's seed) -> (r, g, b)."""
    sd = rng.pixel_seed(px, py)
    acc = [torch.zeros(px.shape, dtype=torch.float32, device=px.device)] * 3
    for _ in range(cfg.spp):
        ro, rd, sd = _camera_ray(scene, cam, cfg, px, py, sd)
        (r, g, b), sd = trace_adjoint(scene, ro, rd, sd, cfg.depth,
                                      cfg.t_min, vis_w, cfg.scatter_mode,
                                      winners)
        acc = [acc[0] + r, acc[1] + g, acc[2] + b]
    inv_spp = rng.f32_like(acc[0], 1.0 / cfg.spp)
    return tuple(_to_gamma(a * inv_spp, cfg.gamma) for a in acc)


def render_golden_adjoint(scene: Scene, cam: Camera, cfg: RenderConfig,
                          vis_w: float = 0.0, bvh: BVH | None = None,
                          tape=None, row0: int = 0,
                          rows: int | None = None) -> torch.Tensor:
    """Full-frame render whose backward is the hand-structured adjoint.

    Forward values equal render_golden's; gradients equal autograd of
    golden (same detach policy) at O(P * depth) backward cost.  Sequential
    RNG runs pixel chunks, each through its samples in order; parallel RNG
    runs each sample in order over pixel chunks, so either way a pixel's
    bounce steps come in its global step order.  Differentiable through
    ordinary autograd: call ``torch.autograd.grad`` (or ``backward``) on
    its image.

    ``bvh``: the forward sweeps the BVH (flat or walk) over the scene in leaf
    order (permuted differentiably, so gradients land in input order).
    ``tape`` (g_cap, H*W), a winner-index tape of this frame (from
    :func:`raytpu_torch.golden.render_golden_tape` with the same ``bvh``):
    steps below ``g_cap`` take their winner from it instead of sweeping —
    the plain version of K3's replay; the gradients are bit-equal to the
    untaped ones.  ``row0`` / ``rows``: the (rows, W, 3) slab from absolute
    row ``row0`` (the plain version of K3's slab mode; ``tape`` is then
    (g_cap, rows*W)); rows past the frame are 0 and carry no gradient."""
    check_cfg(cfg)
    w = cfg.width
    rows, live = golden.slab_pixels(cfg, row0, rows)
    dev = scene.center.device
    if bvh is not None:
        scene = permute_scene(scene, bvh.perm)
    k = None if tape is None else torch.zeros(live, dtype=torch.int64,
                                              device=dev)
    pad = torch.zeros((rows * w - live, 3), dtype=torch.float32, device=dev)

    def winners(start, stop):
        if tape is None:
            return _Winners(bvh)
        return _Winners(bvh, (tape, torch.arange(start, stop, device=dev),
                              k[start:stop]))

    if cfg.rng_mode != "parallel":
        chunk = max(min(cfg.chunk_pixels, live), 1)
        parts = []
        for start in range(0, live, chunk):
            stop = min(start + chunk, live)
            flat = torch.arange(start, stop, device=dev)
            r, g, b = render_pixels_adjoint(scene, cam, cfg, flat % w,
                                            row0 + flat // w, vis_w,
                                            winners(start, stop))
            parts.append(torch.stack([r, g, b], dim=-1))
        return torch.cat(parts + [pad]).reshape(rows, w, 3)

    chunk = max(min(max(cfg.chunk_pixels, 131072), live), 1)
    acc = torch.zeros((live, 3), dtype=torch.float32, device=dev)
    for s in range(cfg.spp):
        parts = []
        for start in range(0, live, chunk):
            stop = min(start + chunk, live)
            flat = torch.arange(start, stop, device=dev)
            px, py = flat % w, row0 + flat // w
            sd = rng.fold_in(rng.pixel_seed(px, py), s)
            ro, rd, sd = _camera_ray(scene, cam, cfg, px, py, sd)
            (r, g, b), _ = trace_adjoint(scene, ro, rd, sd, cfg.depth,
                                         cfg.t_min, vis_w, cfg.scatter_mode,
                                         winners(start, stop))
            parts.append(torch.stack([r, g, b], dim=-1))
        if parts:
            acc = acc + torch.cat(parts)
    lin = acc * rng.f32_like(acc, 1.0 / cfg.spp)
    return torch.cat([_to_gamma(lin, cfg.gamma), pad]).reshape(rows, w, 3)
