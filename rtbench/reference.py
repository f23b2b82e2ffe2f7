"""The benchmark's plain reference: a path tracer in plain PyTorch.

A frozen copy of the v2 compute shader's semantics (Brochu/RayTrace-WE-GPU,
CSVersion/ShaderCompute.hlsl:23-66 RNG, :155-205 intersection, :207-252
materials, :255-315 the bounce loop), written for this benchmark and
importing nothing of the program under test.  It takes the scene, the
camera pose and the settings from the benchmark, and works out everything
else itself: the camera basis, the rays, the closest hit of every step by
testing every sphere, the image, the loss and the gradients.

The arithmetic follows the shader's order op for op, one torch op per f32
operation, so on the same device it rounds as a kernel built with
``-fmad=false`` does.  ``dtype`` computes every floating value in another
type; ``torch.bfloat16`` is the low-precision control that the correctness
check must reject.

Gradients come from autograd through each bounce against its closest
sphere.  The sweep that finds that sphere takes no gradient (the choice
has none), so this is autograd through the full sweep without its pixels
x spheres intermediates.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

# ---- counter-based u32 RNG (int64 carriers of u32 values) ----------------
_MASK32 = 0xFFFFFFFF
_K = 1103515245
_WEYL = 0x9E3779B9
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_FOLD = 0xBB67AE85
_MASK31 = 0x7FFFFFFF
_INV_U24 = 1.0 / 16777216.0
_INV_I31 = 1.0 / 2147483648.0
_TWO_PI = 6.28318530718
_SAFE_EPS = 1e-20
_INF = float("inf")


def _u32(x):
    return x.to(torch.int64) & _MASK32


def _mul(a, k: int):
    lo, hi = k & 0xFFFF, k >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _MASK32


def _fmix32(h):
    h = _u32(h)
    h = h ^ (h >> 16)
    h = _mul(h, _M1)
    h = h ^ (h >> 13)
    h = _mul(h, _M2)
    return h ^ (h >> 16)


def pixel_seed(px, py):
    """The shader's integer hash of the absolute pixel (hlsl:23-28)."""
    px, py = _u32(px), _u32(py)
    hx = _mul((px >> 1) ^ py, _K)
    hy = _mul((py >> 1) ^ px, _K)
    h = _mul(hx ^ (hy >> 3), _K)
    return h ^ (h >> 16)


def fold_in(state, k):
    """The parallel mode's stream of sample ``k`` of a pixel."""
    kk = (_u32(k) + 1) & _MASK32
    return _fmix32((_u32(state) + _mul(kk, _FOLD)) & _MASK32)


def _draw(state):
    state = (_u32(state) + _WEYL) & _MASK32
    return _fmix32(state), state


def _u31(n, dt):
    return ((n & _MASK31).to(torch.float32) * _INV_I31).to(dt)


def _hash1(state, dt):
    n, state = _draw(state)
    return ((n >> 8).to(torch.float32) * _INV_U24).to(dt), state


def _hash2(state, dt):
    n, state = _draw(state)
    return (_u31(n, dt), _u31(_mul(n, 48271), dt)), state


def _hash3(state, dt):
    n, state = _draw(state)
    return (_u31(n, dt), _u31(_mul(n, 16807), dt),
            _u31(_mul(n, 48271), dt)), state


def _c(x, value):
    """``value`` as a 0-dim tensor of ``x``'s type and device: a true
    division by it, never a multiply by a rounded reciprocal."""
    return _const(value, x.dtype, x.device)


@functools.lru_cache(maxsize=None)
def _const(value, dtype, device):
    # made once: a tensor made from a number on a card is a copy to it
    return torch.tensor(value, dtype=dtype, device=device)


def _unit_sphere(state, dt):
    """Cube-root-radius sample in the unit ball (hlsl:59-66)."""
    (a, b, c), state = _hash3(state, dt)
    h = a * 2.0 - 1.0
    phi = b * _TWO_PI
    r = torch.where(c > 0, torch.exp(torch.log(torch.clamp(c, min=1e-30))
                                     / _c(c, 3.0)), 0.0)
    s = torch.sqrt(torch.clamp(1.0 - h * h, min=0.0))
    return (r * s * torch.sin(phi), r * s * torch.cos(phi), r * h), state


# ---- scene and camera ----------------------------------------------------


class Spheres(NamedTuple):
    """The scene as the benchmark hands it over: ``center`` (N, 3),
    ``radius`` (N,), ``mat`` (N,) 0 diffuse / 1 metal / 2 glass, ``albedo``
    (N, 3), ``param`` (N,) the metal's fuzz or the glass's index."""

    center: torch.Tensor
    radius: torch.Tensor
    mat: torch.Tensor
    albedo: torch.Tensor
    param: torch.Tensor

    def to(self, dtype) -> "Spheres":
        return Spheres(self.center.to(dtype), self.radius.to(dtype),
                       self.mat, self.albedo.to(dtype), self.param.to(dtype))


class Camera(NamedTuple):
    """A pinhole camera's basis (each (3,), or (R, 3) a ray)."""

    origin: torch.Tensor
    horizontal: torch.Tensor
    vertical: torch.Tensor
    lower_left: torch.Tensor


def _norm(x):
    return torch.sqrt(x[..., 0] * x[..., 0] + x[..., 1] * x[..., 1]
                      + x[..., 2] * x[..., 2])


def _cross(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def camera(look_from, look_at, vfov: float, aspect: float, *, device,
           dtype=torch.float32) -> Camera:
    """The v2 look-at pinhole basis (DxCSApp.cpp:39-61), focus at the
    look-at distance."""
    f = torch.tensor(look_from, dtype=torch.float32, device=device)
    at = torch.tensor(look_at, dtype=torch.float32, device=device)
    vup = torch.tensor((0.0, 1.0, 0.0), dtype=torch.float32, device=device)
    h = math.tan(vfov * math.pi / 180.0 / 2.0)
    view_h = 2.0 * h
    view_w = aspect * view_h
    focus = _norm(f - at)
    w = f - at
    w = w / _norm(w)
    u = _cross(vup, w)
    u = u / _norm(u)
    v = _cross(w, u)
    horizontal = focus * view_w * u
    vertical = focus * view_h * v
    lower_left = f - horizontal / 2.0 - vertical / 2.0 - focus * w
    return Camera(*(x.to(dtype) for x in (f, horizontal, vertical,
                                          lower_left)))


# ---- one bounce ----------------------------------------------------------


def _dot(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _normalize(x, y, z):
    inv = torch.rsqrt(torch.maximum(_dot(x, y, z, x, y, z),
                                    _c(x, _SAFE_EPS)))
    return x * inv, y * inv, z * inv


def _reflect(vx, vy, vz, nx, ny, nz):
    d = _dot(vx, vy, vz, nx, ny, nz)
    return vx - 2 * d * nx, vy - 2 * d * ny, vz - 2 * d * nz


def _refract(ux, uy, uz, nx, ny, nz, ratio):
    cos_t = torch.minimum(_dot(-ux, -uy, -uz, nx, ny, nz), _c(ux, 1.0))
    px = ratio * (ux + cos_t * nx)
    py = ratio * (uy + cos_t * ny)
    pz = ratio * (uz + cos_t * nz)
    par = -torch.sqrt(torch.maximum(
        torch.abs(1.0 - _dot(px, py, pz, px, py, pz)), _c(px, _SAFE_EPS)))
    return px + par * nx, py + par * ny, pz + par * nz


def _schlick(cosine, ref_idx):
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    m = 1.0 - cosine
    return r0 + (1.0 - r0) * (m * m * m * m * m)


def _sqrt_st(disc, has_root):
    """sqrt of the masked discriminant, its gradient from the 1e-20-clamped
    branch (d sqrt is infinite at a tangent)."""
    safe = torch.sqrt(torch.maximum(disc, _c(disc, _SAFE_EPS)))
    exact = torch.sqrt(torch.where(has_root, disc, 1.0))
    return safe + (exact - safe).detach()


def _roots(half_b, disc, inv_a, t_min):
    has_root = disc >= 0
    sq = _sqrt_st(disc, has_root)
    root1 = (-half_b - sq) * inv_a
    root2 = (-half_b + sq) * inv_a
    root = torch.where(root1 >= t_min, root1, root2)
    return root, has_root & (root >= t_min)


# rays a sweep block tests against every sphere at once
SWEEP_BLOCK = 1 << 17


@torch.no_grad()
def closest(sp: Spheres, ro, rd, t_min: float):
    """The closest sphere of every ray, testing every sphere -> (R,) int64,
    -1 for a miss; ties to the lowest index.  The discriminant is taken for
    every pair, the roots only where it is not negative."""
    out = []
    cx, cy, cz = sp.center[:, 0], sp.center[:, 1], sp.center[:, 2]
    rr = sp.radius * sp.radius
    n = sp.radius.shape[0]
    for s in range(0, ro[0].shape[0], SWEEP_BLOCK):
        rox, roy, roz = (x[s:s + SWEEP_BLOCK, None] for x in ro)
        rdx, rdy, rdz = (x[s:s + SWEEP_BLOCK, None] for x in rd)
        ocx, ocy, ocz = rox - cx, roy - cy, roz - cz
        a = _dot(rdx, rdy, rdz, rdx, rdy, rdz)
        half_b = ocx * rdx
        half_b += ocy * rdy
        half_b += ocz * rdz
        cc = ocx * ocx
        cc += ocy * ocy
        cc += ocz * ocz
        cc -= rr
        del ocx, ocy, ocz
        cc *= a
        disc = half_b * half_b
        disc -= cc
        del cc
        ray, sph = (disc >= 0).nonzero(as_tuple=True)
        hb, dc = half_b[ray, sph], disc[ray, sph]
        del half_b, disc
        root, ok = _roots(hb, dc, 1.0 / a[ray, 0], _c(hb, t_min))
        t = torch.where(ok, root, _INF)
        rows = rdx.shape[0]
        best = torch.full((rows,), _INF, dtype=t.dtype, device=t.device)
        best = best.scatter_reduce(0, ray, t, "amin")
        first = ok & (t == best[ray])
        win = torch.full((rows,), n, dtype=torch.int64, device=t.device)
        win = win.scatter_reduce(0, ray[first], sph[first], "amin")
        out.append(torch.where(win == n, -1, win))
    return torch.cat(out)


def bounce(sp: Spheres, ro, rd, thr, seed, win, t_min: float):
    """One bounce of the rays that hit sphere ``win`` (each >= 0): the
    shader's loop body (hlsl:255-287) -> (ro', rd', thr', seed', ok), ``ok``
    False where the material does not scatter (the ray is absorbed)."""
    ox, oy, oz = ro
    dx, dy, dz = rd
    dt = ox.dtype
    tm = _c(ox, t_min)
    c = sp.center.index_select(0, win)
    cx, cy, cz = c[:, 0], c[:, 1], c[:, 2]
    rad = sp.radius.index_select(0, win)
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    a = _dot(dx, dy, dz, dx, dy, dz)
    half_b = ocx * dx + ocy * dy + ocz * dz
    cc = _dot(ocx, ocy, ocz, ocx, ocy, ocz) - rad * rad
    disc = half_b * half_b - a * cc
    t, _ = _roots(half_b, disc, 1.0 / a, tm)
    px, py, pz = ox + t * dx, oy + t * dy, oz + t * dz
    inv_r = 1.0 / torch.where(rad == 0, 1.0, rad)
    nx, ny, nz = (px - cx) * inv_r, (py - cy) * inv_r, (pz - cz) * inv_r
    front = _dot(dx, dy, dz, nx, ny, nz) < 0
    sgn = torch.where(front, 1.0, -1.0).to(dt)
    nx, ny, nz = nx * sgn, ny * sgn, nz * sgn

    mat = sp.mat[win]
    alb = sp.albedo.index_select(0, win)
    param = sp.param.index_select(0, win)
    (sx, sy, sz), seed_new = _unit_sphere(seed, dt)
    h1, _ = _hash1(seed, dt)
    ddx, ddy, ddz = _normalize(nx + sx, ny + sy, nz + sz)
    rx, ry, rz = _reflect(dx, dy, dz, nx, ny, nz)
    mdx, mdy, mdz = _normalize(rx + param * sx, ry + param * sy,
                               rz + param * sz)
    glass = mat == 2
    ior = torch.where(glass, torch.maximum(param, _c(param, 1e-3)), 1.5)
    ux, uy, uz = _normalize(dx, dy, dz)
    ratio = torch.where(front, 1.0 / ior, ior)
    cosine = torch.minimum(_dot(-ux, -uy, -uz, nx, ny, nz), _c(ux, 1.0))
    sine = torch.sqrt(torch.maximum(1.0 - cosine * cosine, _c(ux, 0.0)))
    reflect = (ratio * sine > 1.0) | (_schlick(cosine, ratio) > h1)
    rfx, rfy, rfz = _reflect(ux, uy, uz, nx, ny, nz)
    tx, ty, tz = _refract(ux, uy, uz, nx, ny, nz, ratio)
    gx = torch.where(reflect, rfx, tx)
    gy = torch.where(reflect, rfy, ty)
    gz = torch.where(reflect, rfz, tz)
    diffuse, metal = mat == 0, mat == 1
    att = tuple(torch.where(glass, 1.0, alb[:, k]).to(dt) for k in range(3))
    out = (torch.where(diffuse, ddx, torch.where(metal, mdx, gx)),
           torch.where(diffuse, ddy, torch.where(metal, mdy, gy)),
           torch.where(diffuse, ddz, torch.where(metal, mdz, gz)))
    ok = diffuse | metal | glass
    thr = tuple(thr[k] * att[k] for k in range(3))
    return (px, py, pz), out, thr, seed_new, ok


def sky(rd):
    """The background of a ray that leaves the scene (hlsl:279-283)."""
    _, uy, _ = _normalize(*rd)
    t = 0.5 * (uy + 1.0)
    return 1.0 - 0.5 * t, 1.0 - 0.3 * t, torch.ones_like(t)


def _take(v, i):
    """The rows ``i`` of each tensor of ``v``; its backward adds into the
    rows (``index_select``'s), far cheaper than a mask's or a gather's."""
    return tuple(x.index_select(0, i) for x in v)


def trace(sp: Spheres, ro, rd, seed, depth: int, t_min: float):
    """Up to ``depth`` bounces of every ray -> (radiance (R, 3), seed',
    steps).  Each step's closest sphere comes from :func:`closest`, which
    takes no gradient; the bounce against it does.  Rays that die leave
    the working set.  ``steps``: the closest-hit steps taken."""
    n = ro[0].shape[0]
    dev, dt = ro[0].device, ro[0].dtype
    ids = torch.arange(n, device=dev)
    thr = (torch.ones_like(ro[0]),) * 3
    hit_ids, hit_vals = [], []
    seed_out = seed.clone()
    steps = 0
    for _ in range(depth):
        if ids.numel() == 0:
            break
        steps += ids.numel()
        win = closest(sp, ro, rd, t_min)
        miss = (win < 0).nonzero()[:, 0]
        hit = (win >= 0).nonzero()[:, 0]
        s = sky(_take(rd, miss))
        t_m = _take(thr, miss)
        hit_ids.append(ids[miss])
        hit_vals.append(torch.stack([t_m[c] * s[c] for c in range(3)], 1))
        seed_out[ids[miss]] = seed[miss]
        ids, seed = ids[hit], seed[hit]
        ro, rd, thr, seed_new, ok = bounce(
            sp, _take(ro, hit), _take(rd, hit), _take(thr, hit), seed,
            win[hit], t_min)
        seed_out[ids[~ok]] = seed[~ok]  # an absorbed ray draws nothing
        keep = ok.nonzero()[:, 0]
        ids, seed = ids[keep], seed_new[keep]
        ro, rd, thr = _take(ro, keep), _take(rd, keep), _take(thr, keep)
    seed_out[ids] = seed
    rad = torch.zeros((n, 3), dtype=dt, device=dev).index_put(
        (torch.cat(hit_ids),), torch.cat(hit_vals))
    return rad, seed_out, steps


def primary(cam: Camera, fx, fy, inv_w, inv_h, seed, dt):
    """A sample's jittered pinhole ray (hlsl:295-310): two jitter draws;
    ``cam`` fields (3,) or one row a ray."""
    (j1, _), seed = _hash2(seed, dt)
    (_, j2), seed = _hash2(seed, dt)
    u = (fx + j1 * 1.1) * inv_w
    v = (fy + j2 * 1.1) * inv_h
    o, h, vv, ll = cam
    ro = tuple(o[..., k].expand_as(u) for k in range(3))
    rd = tuple(ll[..., k] + u * h[..., k] + v * vv[..., k] - ro[k]
               for k in range(3))
    return ro, rd, seed


def gamma(x, g: float):
    """pow(x, 1/g) as exp(log(x) / g), 0 at 0 (hlsl:99-103)."""
    safe = torch.where(x > 0, x, 1.0)
    return torch.where(x > 0, torch.exp(torch.log(safe) / _c(x, g)), 0.0)


class Settings(NamedTuple):
    """A frame's settings: the shader's resolution, samples and depth."""

    width: int
    height: int
    spp: int
    depth: int
    rng_mode: str = "sequential"
    t_min: float = 1e-3
    gamma: float = 2.2


def _inv(x, value):
    """``value`` rounded to f32, as the shader's constants are, in ``x``'s
    type."""
    return _const(value, torch.float32, x.device).to(x.dtype)


def pixels_sequential(sp: Spheres, cam: Camera, st: Settings, px, py):
    """The pixels ``(px, py)`` (row 0 the bottom) in sequential RNG: one
    seed chained through a pixel's samples -> (image (P, 3), steps)."""
    dt = sp.center.dtype
    fx, fy = px.to(torch.float32).to(dt), py.to(torch.float32).to(dt)
    inv_w = _inv(fx, 1.0 / (st.width - 1))
    inv_h = _inv(fx, 1.0 / (st.height - 1))
    seed = pixel_seed(px, py)
    acc = torch.zeros((px.shape[0], 3), dtype=dt, device=px.device)
    steps = 0
    for _ in range(st.spp):
        ro, rd, seed = primary(cam, fx, fy, inv_w, inv_h, seed, dt)
        rad, seed, n = trace(sp, ro, rd, seed, st.depth, st.t_min)
        acc = acc + rad
        steps += n
    return gamma(acc * _inv(acc, 1.0 / st.spp), st.gamma), steps


def _pixels_parallel(sp, cam, st, px, py):
    """The pixels in parallel RNG, every sample its own stream, all traced
    at once -> (image (P, 3), steps)."""
    dt = sp.center.dtype
    s = torch.arange(st.spp, device=px.device)
    fx = px.to(torch.float32).to(dt)[:, None].expand(-1, st.spp).reshape(-1)
    fy = py.to(torch.float32).to(dt)[:, None].expand(-1, st.spp).reshape(-1)
    seed = fold_in(pixel_seed(px, py)[:, None], s[None]).reshape(-1)
    inv_w = _inv(fx, 1.0 / (st.width - 1))
    inv_h = _inv(fx, 1.0 / (st.height - 1))
    ro, rd, seed = primary(cam, fx, fy, inv_w, inv_h, seed, dt)
    rad, _, steps = trace(sp, ro, rd, seed, st.depth, st.t_min)
    rad = rad.reshape(-1, st.spp, 3)
    acc = torch.zeros_like(rad[:, 0])
    for k in range(st.spp):  # the samples' sum in order
        acc = acc + rad[:, k]
    return gamma(acc * _inv(acc, 1.0 / st.spp), st.gamma), steps


def pixels(sp: Spheres, cam: Camera, st: Settings, px, py):
    """The pixels ``(px, py)`` of a frame -> (image (P, 3), steps)."""
    with torch.no_grad():
        if st.rng_mode == "sequential":
            return pixels_sequential(sp, cam, st, px, py)
        return _pixels_parallel(sp, cam, st, px, py)


# pixels a block of the loss's sweep takes, with all their samples
LOSS_RAYS = 1 << 20


def loss_and_grads(sp: Spheres, cam: Camera, st: Settings, target,
                   rows: tuple[int, int] | None = None, grad: bool = True):
    """The frame's MSE against ``target`` (H, W, 3) and its gradients, in
    parallel RNG -> (loss_sum f64, {leaf: grad f64}, image (rows, W, 3),
    steps).  ``loss_sum`` is the sum of squares (divide by H*W*3 for the
    mean); the gradients are of that mean, summed in f64 over blocks of
    pixels (all 0 with ``grad`` False, which takes the loss alone).
    ``rows`` = (row0, row1) takes those rows only, so that processes can
    split a frame and add their parts."""
    if st.rng_mode != "parallel":
        raise ValueError("the reference's gradients take parallel RNG")
    row0, row1 = rows or (0, st.height)
    dev = sp.center.device
    w = st.width
    inv_m = 1.0 / (st.height * st.width * 3)
    leaves = {"center": sp.center, "radius": sp.radius,
              "albedo": sp.albedo, "param": sp.param,
              "origin": cam.origin, "horizontal": cam.horizontal,
              "vertical": cam.vertical, "lower_left": cam.lower_left}
    grads = {k: torch.zeros(v.shape, dtype=torch.float64, device=dev)
             for k, v in leaves.items()}
    loss = torch.zeros((), dtype=torch.float64, device=dev)
    image = torch.empty(((row1 - row0) * w, 3), dtype=sp.center.dtype,
                        device=dev)
    steps = 0
    block = max(LOSS_RAYS // st.spp, 1)
    flat_target = target.reshape(-1, 3)
    for start in range(row0 * w, row1 * w, block):
        flat = torch.arange(start, min(start + block, row1 * w), device=dev)
        px, py = flat % w, flat // w
        live = {k: v.detach().requires_grad_(grad)
                for k, v in leaves.items()}
        s = Spheres(live["center"], live["radius"], sp.mat, live["albedo"],
                    live["param"])
        c = Camera(live["origin"], live["horizontal"], live["vertical"],
                   live["lower_left"])
        with torch.set_grad_enabled(grad):
            img, n = _pixels_parallel(s, c, st, px, py)
            part = torch.sum((img - flat_target[flat]).to(torch.float64)
                             ** 2)
            g = (torch.autograd.grad(part * inv_m, list(live.values()),
                                     allow_unused=True) if grad
                 else [None] * len(live))
        steps += n
        loss += part.detach()
        for k, gk in zip(live, g):
            if gk is not None:  # a block of sky pixels hits no sphere
                grads[k] += gk.to(torch.float64)
        image[start - row0 * w:start - row0 * w + flat.shape[0]] = \
            img.detach()
    return loss, grads, image.reshape(row1 - row0, w, 3), steps


def sgd(sp: Spheres, cam: Camera, grads: dict, lr: float):
    """One SGD step of the scene's continuous leaves and the camera's
    origin, horizontal, vertical and lower-left corner, f32 updates."""
    g = {k: v.to(sp.center.dtype) for k, v in grads.items()}
    return (Spheres(sp.center - lr * g["center"], sp.radius - lr * g["radius"],
                    sp.mat, sp.albedo - lr * g["albedo"],
                    sp.param - lr * g["param"]),
            Camera(cam.origin - lr * g["origin"],
                   cam.horizontal - lr * g["horizontal"],
                   cam.vertical - lr * g["vertical"],
                   cam.lower_left - lr * g["lower_left"]))
