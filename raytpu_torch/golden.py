"""Plain PyTorch renderer (counterpart of ``raytpu/golden.py``).

The executable spec of the reference's forward rendering semantics (ref:
CSVersion/ShaderCompute.hlsl:255-315 driver loop, :155-205 intersection,
:207-252 materials), written SoA over flat pixel batches in straight-line
tensor code.  It is the plain version of the CUDA megakernel
(``raytpu_torch/kernels/megakernel.py``): the wrapper runs it for CPU
tensors, and the tests and ``chip_smoke.py`` hold the kernel against it on
the same device.

It mirrors raytpu's golden op for op, so the reference quirks that file
pins hold here too: metal always scatters, diffuse directions are
normalized, jitter is ``1.1 / (dim - 1)``, the t-range is (t_min, +inf),
depth exhaustion and a failed scatter give black, one RNG advance per
scatter whatever the material, and the seed comes from absolute pixel
coordinates only.

Two habits keep it bit-compatible with the kernel on a card:
- every operation rounds on its own (one torch op per f32 operation), which
  the kernel matches by being built with ``-fmad=false``;
- divisions by a constant divide by a 0-dim f32 tensor on the data's device
  (``rng.f32_like``): a Python-scalar divisor may become a multiply by its
  reciprocal, which rounds differently from the kernel's division.

With a BVH (:mod:`raytpu_torch.bvh`) the closest hit is :func:`hit_bvh`,
over the scene in BVH leaf order: :func:`hit_world_bvh`, the plain version
of the kernels' flat-leaf sweep (K1c), or :func:`hit_world_walk`, the plain
version of their skip-pointer walk (K1d), by raytpu's rule
(:func:`raytpu_torch.bvh.sweep_of`).  :func:`render_golden_tape` is the
plain version of the taping forward (K4's write side): the image plus each
pixel's log of closest-hit winners.  :func:`accumulate_golden` is the plain
version of the carry-state kernel K2 (one progressive batch).  All three
take raytpu's slab mode, ``row0`` / ``rows`` (K1b): a slab's pixels are
their pixel list.

``rng_mode="v1_fractsin"`` (the v1 fract-sin parity mode, forward only)
runs here and nowhere else, on any device: :func:`accumulate_pixels`
threads the v1 float2 state (:func:`fractsin_state`,
:func:`fractsin_sample`) and :func:`trace` reuses one sample's draws at
every bounce (``fixed_draws``), as raytpu's golden does.
"""

from __future__ import annotations

import torch

from raytpu_torch import rng
from raytpu_torch.bvh import BVH, outlier_tail, permute_scene, sweep_of
from raytpu_torch.camera import Camera, get_ray
from raytpu_torch.config import RenderConfig
from raytpu_torch.scene import Scene

_INF = float("inf")
_SAFE_EPS = 1e-20
TAPE_UNWRITTEN = -2  # a tape slot no step reached (a miss logs -1)
# the census of a frame (K1'): leaves entered, closest-hit steps, samples,
# and the nodes the walk visits (0 for the other sweeps)
CENSUS = ("leaves_entered", "bounce_steps", "samples", "nodes_visited")


def _dot3(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _max_c(x, c):
    """max(x, c) for a constant c.  ``torch.maximum`` rather than ``clamp``:
    at a tie it splits the gradient in halves, as jnp.maximum / jnp.clip
    do (``clamp`` passes it all), so autograd agrees with jax.grad."""
    return torch.maximum(x, rng.f32_like(x, c))


def _min_c(x, c):
    """min(x, c) for a constant c, with jnp.minimum's tie gradient."""
    return torch.minimum(x, rng.f32_like(x, c))


def _normalize3(x, y, z):
    inv = torch.rsqrt(_max_c(_dot3(x, y, z, x, y, z), _SAFE_EPS))
    return x * inv, y * inv, z * inv


def _sqrt_st(disc, has_root):
    """sqrt of the masked discriminant with a straight-through gradient.

    The value is the exact ``sqrt(where(disc >= 0, disc, 1))``; the
    gradient comes from the 1e-20-clamped branch, since d sqrt blows up at
    disc == 0 (a tangent ray).  raytpu's golden, adjoint and VJP kernel
    carry the same guard (raytpu/golden.py:97-99)."""
    sqrt_safe = torch.sqrt(_max_c(disc, _SAFE_EPS))
    sqrt_exact = torch.sqrt(torch.where(has_root, disc, 1.0))
    return sqrt_safe + (sqrt_exact - sqrt_safe).detach()


def hit_world(scene: Scene, ro, rd, t_min):
    """Closest hit over all spheres (ref: ShaderCompute.hlsl:155-205).

    ro, rd: tuples of 3 tensors of common shape S (unnormalized direction).
    Returns (hit_any S bool, t S f32, idx S i64, normal SoA, front S bool).
    An argmin over per-sphere nearest valid roots; ties go to the lowest
    index (``argmin`` returns the first minimum, as the kernel's strict
    ``<`` update keeps the first winner).

    It is the plain version of both brute sweeps of the kernels, K1a's and
    the dense stage K1e's: a pixels x spheres min / argmin on the same
    ``fl(o - c)`` values, which is what raytpu's dense MXU stage computes
    op for op (tests/test_dense.py).
    """
    rox, roy, roz = ro
    rdx, rdy, rdz = rd
    cx, cy, cz = scene.center[:, 0], scene.center[:, 1], scene.center[:, 2]
    rad = scene.radius
    t_min = rng.f32_like(rox, t_min)

    # Broadcast pixels x spheres: shape S + (N,)
    ocx = rox[..., None] - cx
    ocy = roy[..., None] - cy
    ocz = roz[..., None] - cz
    a = _dot3(rdx, rdy, rdz, rdx, rdy, rdz)[..., None]
    inv_a = 1.0 / a
    half_b = ocx * rdx[..., None] + ocy * rdy[..., None] + ocz * rdz[..., None]
    c = _dot3(ocx, ocy, ocz, ocx, ocy, ocz) - rad * rad
    disc = half_b * half_b - a * c

    has_root = disc >= 0
    sqrtd = _sqrt_st(disc, has_root)
    root1 = (-half_b - sqrtd) * inv_a
    root2 = (-half_b + sqrtd) * inv_a
    # accept near root if >= t_min (reference rejects root < t_min), else far
    root = torch.where(root1 >= t_min, root1, root2)
    ok = has_root & (root >= t_min)
    t_all = torch.where(ok, root, _INF)

    t = t_all.amin(dim=-1)
    idx = t_all.argmin(dim=-1)
    hit_any = torch.isfinite(t)
    t = torch.where(hit_any, t, 1.0)  # safe t for downstream math

    # hit point and outward normal (ref: hlsl:180-183)
    px = rox + t * rdx
    py = roy + t * rdy
    pz = roz + t * rdz
    hc = scene.center[idx]
    hr = scene.radius[idx]
    inv_r = 1.0 / torch.where(hr == 0, 1.0, hr)
    nx = (px - hc[..., 0]) * inv_r
    ny = (py - hc[..., 1]) * inv_r
    nz = (pz - hc[..., 2]) * inv_r
    front = _dot3(rdx, rdy, rdz, nx, ny, nz) < 0
    sgn = torch.where(front, 1.0, -1.0)
    return hit_any, t, idx, (nx * sgn, ny * sgn, nz * sgn), front


def _sphere_ts(scene: Scene, j, ro, rd, a, inv_a, t_min):
    """t of the rays against spheres ``j`` (shape S + (k,)), +inf where a
    ray misses: hit_world's per-sphere arithmetic, op for op."""
    rox, roy, roz = (x[..., None] for x in ro)
    rdx, rdy, rdz = (x[..., None] for x in rd)
    ocx = rox - scene.center[j, 0]
    ocy = roy - scene.center[j, 1]
    ocz = roz - scene.center[j, 2]
    rad = scene.radius[j]
    half_b = ocx * rdx + ocy * rdy + ocz * rdz
    c = _dot3(ocx, ocy, ocz, ocx, ocy, ocz) - rad * rad
    disc = half_b * half_b - a[..., None] * c
    has_root = disc >= 0
    sqrtd = _sqrt_st(disc, has_root)
    root1 = (-half_b - sqrtd) * inv_a[..., None]
    root2 = (-half_b + sqrtd) * inv_a[..., None]
    root = torch.where(root1 >= t_min, root1, root2)
    return torch.where(has_root & (root >= t_min), root, _INF)


def _take_closest(t_all, j, tb, idx):
    """Fold candidates ``t_all`` / ``j`` (S + (k,)) into the running best:
    the first minimum wins, and only if it is strictly closer — the
    kernels' in-order strict ``<`` update."""
    m = t_all.amin(dim=-1)
    am = t_all.argmin(dim=-1, keepdim=True)
    win = m < tb
    return (torch.where(win, m, tb),
            torch.where(win, torch.gather(j, -1, am)[..., 0], idx))


def hit_world_bvh(scene_perm: Scene, bvh: BVH, ro, rd, t_min, census=None,
                  live=None):
    """Closest hit through the BVH's flat leaf list: the plain version of
    the kernels' flat sweep (``csrc/render_common.cuh`` closest_hit<kFlat>,
    K1c).

    ``scene_perm`` is the scene in leaf order
    (:func:`raytpu_torch.bvh.permute_scene`); the result is
    :func:`hit_world`'s, with the winner as a permuted index.  Vectorised
    over rays: the outlier tail is tested first, then each ray walks the
    leaf rows of the octant copy its own direction's signs pick (bit 2 =
    dx < 0, bit 1 = dy < 0, bit 0 = dz < 0), entering a leaf iff its slab
    test passes, ``!(tnear > tfar)`` with ``tfar`` clamped to the best t so
    far (a NaN from a ray on a padded face enters).  NaN dummies never win.
    The closest hit does not depend on the visiting order, so the winner is
    hit_world's except on exact ties of t between distinct spheres.
    ``census`` (a dict): adds the leaves the ``live`` lanes enter to
    ``census["leaves_entered"]``, as the census kernel K1' counts them.
    """
    if bvh.flat is None or not bvh.leaf_size:
        raise ValueError("the flat sweep needs a BVH with padded leaves "
                         "and a flat leaf list (build_bvh(pad_leaves=True))")
    rdx, rdy, rdz = rd
    t_min = rng.f32_like(rdx, t_min)
    a = _dot3(rdx, rdy, rdz, rdx, rdy, rdz)
    inv_a = 1.0 / a
    tb, idx = _seed_outliers(scene_perm, bvh, ro, rd, a, inv_a, t_min)
    n_leaves, ls = bvh.n_leaves, int(bvh.leaf_size)
    flat = bvh.flat
    inv_d = (1.0 / rdx, 1.0 / rdy, 1.0 / rdz)
    octant = ((rdx < 0).to(torch.int64) * 4 + (rdy < 0).to(torch.int64) * 2
              + (rdz < 0).to(torch.int64))
    lanes = torch.arange(ls, device=rdx.device)
    for k in range(n_leaves):
        row = flat[octant * n_leaves + k]                      # S + (9,)
        enter = _slab_enter(row, ro, inv_d, t_min, tb)
        if census is not None:
            census["leaves_entered"] += int((enter & live).sum())
        if not bool(enter.any()):
            continue
        sel = enter.nonzero(as_tuple=True)
        j = row[sel][:, 6].to(torch.int64)[:, None] + lanes
        t_sel, i_sel = _take_closest(
            _sphere_ts(scene_perm, j, tuple(x[sel] for x in ro),
                       tuple(x[sel] for x in rd), a[sel], inv_a[sel], t_min),
            j, tb[sel], idx[sel])
        tb = tb.index_put(sel, t_sel)
        idx = idx.index_put(sel, i_sel)
    return _hit_result(scene_perm, ro, rd, tb, idx)


def _seed_outliers(scene_perm: Scene, bvh: BVH, ro, rd, a, inv_a, t_min):
    """(tb, idx) after the outlier tail, which every BVH sweep tests
    first: a giant ground sphere seeds tb, so far leaves cull."""
    rox = ro[0]
    tb = torch.full_like(rox, _INF)
    idx = torch.zeros(rox.shape, dtype=torch.int64, device=rox.device)
    tail = outlier_tail(bvh.perm, bvh.flat, bvh.leaf_size)
    if tail is not None:
        j = torch.arange(tail[0], tail[0] + tail[1],
                         device=rox.device).expand(*rox.shape, tail[1])
        tb, idx = _take_closest(_sphere_ts(scene_perm, j, ro, rd, a, inv_a,
                                           t_min), j, tb, idx)
    return tb, idx


def _hit_result(scene_perm: Scene, ro, rd, tb, idx):
    """hit_world's result from a sweep's best t and winner."""
    rox, roy, roz = ro
    rdx, rdy, rdz = rd
    hit_any = torch.isfinite(tb)
    t = torch.where(hit_any, tb, 1.0)
    idx = torch.where(hit_any, idx, 0)
    px = rox + t * rdx
    py = roy + t * rdy
    pz = roz + t * rdz
    hc = scene_perm.center[idx]
    hr = scene_perm.radius[idx]
    inv_r = 1.0 / torch.where(hr == 0, 1.0, hr)
    nx = (px - hc[..., 0]) * inv_r
    ny = (py - hc[..., 1]) * inv_r
    nz = (pz - hc[..., 2]) * inv_r
    front = _dot3(rdx, rdy, rdz, nx, ny, nz) < 0
    sgn = torch.where(front, 1.0, -1.0)
    return hit_any, t, idx, (nx * sgn, ny * sgn, nz * sgn), front


def _slab_enter(row, ro, inv_d, t_min, tb):
    """The slab test of the rays against the boxes ``row`` (..., 9):
    ``!(tnear > tfar)`` with ``tnear`` clamped below by ``t_min`` and
    ``tfar`` above by the best t so far; a NaN (a ray on a padded face)
    enters.  The kernels' op order (render_common.cuh)."""
    rox, roy, roz = ro
    inv_dx, inv_dy, inv_dz = inv_d
    t1 = (row[..., 0] - rox) * inv_dx
    t2 = (row[..., 3] - rox) * inv_dx
    t3 = (row[..., 1] - roy) * inv_dy
    t4 = (row[..., 4] - roy) * inv_dy
    t5 = (row[..., 2] - roz) * inv_dz
    t6 = (row[..., 5] - roz) * inv_dz
    tnear = torch.maximum(
        torch.maximum(torch.minimum(t1, t2), torch.minimum(t3, t4)),
        torch.maximum(torch.minimum(t5, t6), t_min))
    tfar = torch.minimum(
        torch.minimum(torch.maximum(t1, t2), torch.maximum(t3, t4)),
        torch.minimum(torch.maximum(t5, t6), tb))
    return ~(tnear > tfar)


def hit_world_walk(scene_perm: Scene, bvh: BVH, ro, rd, t_min, census=None,
                   live=None):
    """Closest hit through the BVH's skip-pointer walk: the plain version
    of the kernels' walk (``csrc/render_common.cuh`` closest_hit<kWalk>,
    K1d) and of raytpu's (raytpu/kernels/megakernel.py:640-696,
    gradkernel.py:544-594), per ray where raytpu walks per tile.

    Arguments and result as :func:`hit_world_bvh`.  The outlier tail
    (padded BVHs) is tested first; then each ray walks ``nodes`` from the
    root of its copy (its own octant's of a padded BVH's eight, the one
    copy of an unpadded BVH), a node pointer per ray: a node is entered iff
    its slab test passes within the best t so far, an entered leaf's
    ``count`` spheres from ``start`` are tested, and the next node is ``rel
    + 1`` for an entered interior node, else the node's ``skip`` (relative
    within the copy).  Vectorised over rays: the loop runs while any ray
    still walks.  ``live`` (a mask): only those lanes walk the tree (the
    others' results are never read).  ``census``: adds
    the boxes the live lanes test to ``census["nodes_visited"]`` and the
    leaves they enter to ``census["leaves_entered"]``, as K1' counts them.
    """
    rox, roy, roz = ro
    rdx, rdy, rdz = rd
    dev = rox.device
    t_min = rng.f32_like(rox, t_min)
    a = _dot3(rdx, rdy, rdz, rdx, rdy, rdz)
    inv_a = 1.0 / a
    tb, idx = _seed_outliers(scene_perm, bvh, ro, rd, a, inv_a, t_min)
    inv_d = (1.0 / rdx, 1.0 / rdy, 1.0 / rdz)
    m = bvh.n_trav
    nodes = bvh.nodes
    if bvh.copies == 8:
        base = ((rdx < 0).to(torch.int64) * 4 + (rdy < 0).to(torch.int64) * 2
                + (rdz < 0).to(torch.int64)) * m
    else:
        base = torch.zeros(rox.shape, dtype=torch.int64, device=dev)
    lanes = torch.arange(int(nodes[:, 7].max()), device=dev)
    rel = torch.zeros(rox.shape, dtype=torch.int64, device=dev)
    if live is not None:
        rel = torch.where(live, rel, m)
    while True:
        sel = (rel < m).nonzero(as_tuple=True)
        if sel[0].numel() == 0:
            break
        r_sel = rel[sel]
        row = nodes[base[sel] + r_sel]                          # (k, 9)
        ro_s = tuple(x[sel] for x in ro)
        enter = _slab_enter(row, ro_s, tuple(x[sel] for x in inv_d), t_min,
                            tb[sel])
        count = row[:, 7].to(torch.int64)
        leaf = enter & (count > 0)
        if census is not None:
            census["nodes_visited"] += r_sel.numel()
            census["leaves_entered"] += int(leaf.sum())
        if bool(leaf.any()):
            (k,) = leaf.nonzero(as_tuple=True)
            sub = tuple(s[k] for s in sel)
            j = row[k, 6].to(torch.int64)[:, None] + lanes
            valid = lanes < count[k, None]
            j = torch.where(valid, j, 0)
            t_all = torch.where(valid, _sphere_ts(
                scene_perm, j, tuple(x[k] for x in ro_s),
                tuple(x[sub] for x in rd), a[sub], inv_a[sub], t_min), _INF)
            t_new, i_new = _take_closest(t_all, j, tb[sub], idx[sub])
            tb = tb.index_put(sub, t_new)
            idx = idx.index_put(sub, i_new)
        nxt = torch.where(enter & (count == 0), r_sel + 1,
                          row[:, 8].to(torch.int64))
        rel = rel.index_put(sel, nxt)
    return _hit_result(scene_perm, ro, rd, tb, idx)


def hit_bvh(scene_perm: Scene, bvh: BVH, ro, rd, t_min, census=None,
            live=None):
    """Closest hit over ``bvh`` by its sweep (:func:`raytpu_torch.bvh.
    sweep_of`, raytpu's rule): :func:`hit_world_bvh` (flat, K1c's) or
    :func:`hit_world_walk` (the walk, K1d's)."""
    sweep = hit_world_bvh if sweep_of(bvh) == "flat" else hit_world_walk
    return sweep(scene_perm, bvh, ro, rd, t_min, census, live)


def tape_dtype(rows: int) -> torch.dtype:
    """The tape's element type for a scene of ``rows`` kernel-side spheres
    (the permuted count under a BVH): int16 below 32767, else int32."""
    return torch.int16 if rows < 32767 else torch.int32


def log_winners(tape, alive, win) -> None:
    """Append one bounce step to each live lane's winner log.

    ``tape = (buf, pix, k)``: ``buf`` (g_cap, H*W) is the frame's tape,
    ``pix`` the lanes' flat pixel indices and ``k`` their next global step
    (updated in place).  A live lane writes ``win`` (-1 for a miss) at
    ``buf[k, pix]`` while ``k < g_cap``, and every live lane's ``k``
    advances: steps past the cap are counted, not logged."""
    buf, pix, k = tape
    w = alive & (k < buf.shape[0])
    buf[k[w], pix[w]] = win[w].to(buf.dtype)
    k += alive.to(k.dtype)


def _reflect(vx, vy, vz, nx, ny, nz):
    """v - 2*dot(v,n)*n (ref: hlsl:76-79)."""
    d = _dot3(vx, vy, vz, nx, ny, nz)
    return vx - 2 * d * nx, vy - 2 * d * ny, vz - 2 * d * nz


def _refract(ux, uy, uz, nx, ny, nz, ratio):
    """Snell refraction of a unit vector (ref: hlsl:81-88)."""
    cos_theta = _min_c(_dot3(-ux, -uy, -uz, nx, ny, nz), 1.0)
    px = ratio * (ux + cos_theta * nx)
    py = ratio * (uy + cos_theta * ny)
    pz = ratio * (uz + cos_theta * nz)
    par = -torch.sqrt(_max_c(
        torch.abs(1.0 - _dot3(px, py, pz, px, py, pz)), _SAFE_EPS))
    return px + par * nx, py + par * ny, pz + par * nz


def _schlick(cosine, ref_idx):
    """Schlick reflectance approximation (ref: hlsl:90-97)."""
    r0 = (1.0 - ref_idx) / (1.0 + ref_idx)
    r0 = r0 * r0
    m = 1.0 - cosine
    return r0 + (1.0 - r0) * (m * m * m * m * m)


def scatter(scene: Scene, rd, p, normal, front, idx, seed, mode: str = "v2",
            fixed_draws=None):
    """Material scatter (ref: ShaderCompute.hlsl:207-252).

    Returns (scatter_ok, atten SoA, new_dir SoA, new_seed).  All three
    material branches are computed and selected by mask; every branch
    consumes the SAME single hash draw.  ``mode="v1"`` selects the
    pixel-shader generation's materials (ref: Shader_RT.fx:217-243):
    hemisphere diffuse with a near-zero guard and saturated-fuzz metal on
    the normalized incoming direction, both unnormalized.
    ``fixed_draws = (sx, sy, sz, h1)`` replaces the counter-based draws
    and leaves the seed untouched: the v1 fract-sin mode, whose by-value
    state gives every bounce of a path the same draws.
    """
    rdx, rdy, rdz = rd
    nx, ny, nz = normal
    mat = scene.mat_type[idx]
    alb = scene.albedo[idx]
    param = scene.mat_param[idx]

    if fixed_draws is not None:
        sx, sy, sz, h1 = fixed_draws
        seed_new = seed
    else:
        (sx, sy, sz), seed_new = rng.random_in_unit_sphere(seed)
        h1, _ = rng.hash1(seed)  # same underlying draw, same new seed

    if mode == "v1":
        # hemisphere flip (Shader_RT.fx:151-163)
        flip = _dot3(sx, sy, sz, nx, ny, nz) > 0
        hxx = torch.where(flip, sx, -sx)
        hyy = torch.where(flip, sy, -sy)
        hzz = torch.where(flip, sz, -sz)
        # v1 lambert (Shader_RT.fx:217-229): n + hemisphere, near-zero guard
        ldx = nx + hxx
        ldy = ny + hyy
        ldz = nz + hzz
        s_eps = 1e-8
        near0 = ((torch.abs(ldx) < s_eps) & (torch.abs(ldy) < s_eps)
                 & (torch.abs(ldz) < s_eps))
        ddx = torch.where(near0, nx, ldx)
        ddy = torch.where(near0, ny, ldy)
        ddz = torch.where(near0, nz, ldz)
        # v1 metal (Shader_RT.fx:233-241): reflect(normalize(rd)) +
        # saturate(fuzz) * hemisphere, unnormalized
        u1x, u1y, u1z = _normalize3(rdx, rdy, rdz)
        rx, ry, rz = _reflect(u1x, u1y, u1z, nx, ny, nz)
        fz = _min_c(_max_c(param, 0.0), 1.0)
        mdx = rx + fz * hxx
        mdy = ry + fz * hyy
        mdz = rz + fz * hzz
    else:
        # diffuse (hlsl:209-217): dir = normalize(normal + rand_sphere)
        ddx, ddy, ddz = _normalize3(nx + sx, ny + sy, nz + sz)
        # metal (hlsl:219-227): dir = normalize(reflect(rd, n) + fuzz*rand)
        rx, ry, rz = _reflect(rdx, rdy, rdz, nx, ny, nz)
        mdx, mdy, mdz = _normalize3(rx + param * sx, ry + param * sy,
                                    rz + param * sz)

    # dielectric (hlsl:229-249); non-glass lanes get a safe IOR so the
    # unselected branch stays finite
    is_glass = mat == 2
    ior = torch.where(is_glass, _max_c(param, 1e-3), 1.5)
    ux, uy, uz = _normalize3(rdx, rdy, rdz)
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
    ok = is_d | is_m | is_glass

    atr = torch.where(is_glass, 1.0, alb[..., 0])
    atg = torch.where(is_glass, 1.0, alb[..., 1])
    atb = torch.where(is_glass, 1.0, alb[..., 2])

    ox = torch.where(is_d, ddx, torch.where(is_m, mdx, gdx))
    oy = torch.where(is_d, ddy, torch.where(is_m, mdy, gdy))
    oz = torch.where(is_d, ddz, torch.where(is_m, mdz, gdz))
    return ok, (atr, atg, atb), (ox, oy, oz), seed_new


def _sky(rdx, rdy, rdz):
    """Background gradient (ref: hlsl:279-283), of the pre-scatter ray."""
    _, uy, _ = _normalize3(rdx, rdy, rdz)
    t = 0.5 * (uy + 1.0)
    return 1.0 - 0.5 * t, 1.0 - 0.3 * t, 1.0  # lerp(white, (.5,.7,1.))


def bounce_step(scene: Scene, ro, rd, c, r, alive, sd, t_min: float,
                scatter_mode: str = "v2", bvh: BVH | None = None, tape=None,
                census=None, fixed_draws=None):
    """One bounce of a batch of ray slots (ref: the body of sample_color's
    loop, hlsl:255-287; raytpu's ``make_bounce_body``): the plain version
    of the kernels' ``bounce_step`` (csrc/render_common.cuh), which the
    megakernels and the wavefront's segment kernels K5 / K6 share.

    ``ro``, ``rd``, ``c`` (throughput) and ``r`` (radiance) are tuples of 3
    tensors of a common shape, ``alive`` a bool mask, ``sd`` the int64 u32
    seeds.  The live lanes take the closest hit (:func:`hit_world`, or
    :func:`hit_bvh` over the scene in leaf order with ``bvh``); a miss adds
    ``c * sky`` of the pre-scatter direction to ``r`` (raytpu's add-once
    rule, raytpu/kernels/megakernel.py:734: a sample misses once, so a
    radiance carried across a slot's samples sums them) and dies; the hit
    of an unknown material dies (black); the rest scatter, which moves the
    ray, multiplies the attenuation into ``c`` and advances the seed by its
    one draw.  Dead lanes keep their state.  ``tape``, ``census`` and
    ``fixed_draws`` as in :func:`trace`.  Returns ``(ro, rd, c, r, alive,
    sd, seen)``, ``seen`` = (winner, t, normal, attenuation, new direction)
    of every lane, for :func:`trace`'s ``check``."""
    ox, oy, oz = ro
    dx, dy, dz = rd
    cr, cg, cb = c
    rr, rg, rb = r
    if census is not None:
        census["bounce_steps"] += int(alive.sum())
    if bvh is None:
        hit_any, t, idx, normal, front = hit_world(scene, ro, rd, t_min)
    else:
        hit_any, t, idx, normal, front = hit_bvh(scene, bvh, ro, rd, t_min,
                                                 census, alive)
    if tape is not None:
        log_winners(tape, alive, torch.where(hit_any, idx, -1))
    px = ox + t * dx
    py = oy + t * dy
    pz = oz + t * dz
    ok, (ar, ag, ab), (sx, sy, sz), sd_new = scatter(
        scene, rd, (px, py, pz), normal, front, idx, sd, scatter_mode,
        fixed_draws)

    scat = alive & hit_any & ok
    absorbed = alive & hit_any & ~ok
    missed = alive & ~hit_any

    skr, skg, skb = _sky(dx, dy, dz)
    rr = torch.where(missed, rr + cr * skr, rr)
    rg = torch.where(missed, rg + cg * skg, rg)
    rb = torch.where(missed, rb + cb * skb, rb)

    cr = torch.where(scat, cr * ar, cr)
    cg = torch.where(scat, cg * ag, cg)
    cb = torch.where(scat, cb * ab, cb)
    ox = torch.where(scat, px, ox)
    oy = torch.where(scat, py, oy)
    oz = torch.where(scat, pz, oz)
    dx = torch.where(scat, sx, dx)
    dy = torch.where(scat, sy, dy)
    dz = torch.where(scat, sz, dz)
    sd = torch.where(scat, sd_new, sd)
    alive = alive & ~(missed | absorbed)
    return ((ox, oy, oz), (dx, dy, dz), (cr, cg, cb), (rr, rg, rb), alive,
            sd, (idx, t, normal, (ar, ag, ab), (sx, sy, sz)))


def trace(scene: Scene, ro, rd, seed, depth: int, t_min: float,
          scatter_mode: str = "v2", bvh: BVH | None = None, tape=None,
          census=None, check=None, fixed_draws=None):
    """Iterative bounce loop (ref: sample_color, hlsl:255-287): up to
    ``depth`` :func:`bounce_step` calls from throughput 1 and radiance 0.

    SoA over pixel shape S; returns ((r,g,b), seed).  Dead lanes are
    masked; the seed advances only on live scattering lanes.  The loop
    stops early once no lane is alive: a dead lane's state never changes
    again, so that is the same result as running all ``depth`` steps.
    With ``bvh`` the scene is in leaf order and the closest hit is
    :func:`hit_bvh`; ``tape`` (see :func:`log_winners`) logs each live
    lane's winner per bounce; ``census`` (a dict of :data:`CENSUS` counts)
    adds the samples, the live lanes' bounce steps and, with a BVH, the
    leaves they enter and the nodes the walk visits: the plain version of
    the census kernel K1'.  ``check(bounce, idx, values)``, when given, is
    called after each bounce with every lane's winner and a tuple of the
    bounce's values (t, normal, attenuation, new direction, throughput,
    radiance), for :func:`raytpu_torch.debug.checked_render`.
    ``fixed_draws`` (see :func:`scatter`): every bounce scatters with these
    draws and the seed is returned untouched.
    """
    ones = torch.ones_like(ro[0])
    zeros = torch.zeros_like(ro[0])
    c, r = (ones, ones, ones), (zeros, zeros, zeros)
    alive = torch.ones_like(ro[0], dtype=torch.bool)
    sd = seed
    if census is not None:
        census["samples"] += ro[0].numel()
    for bounce in range(depth):
        if not bool(alive.any()):
            break
        ro, rd, c, r, alive, sd, (idx, t, normal, att, new_dir) = \
            bounce_step(scene, ro, rd, c, r, alive, sd, t_min, scatter_mode,
                        bvh, tape, census, fixed_draws)
        if check is not None:
            check(bounce, idx, (t, *normal, *att, *new_dir, *c, *r))
    # depth exhausted while alive -> black (r is still 0)
    return r, sd


def gen_ray(cam: Camera, fx, fy, inv_w, inv_h, sd):
    """One sample's jittered camera ray (the kernels' ``gen_ray``): two
    jitter draws, then :func:`raytpu_torch.camera.get_ray` (a lens draw
    for a thin lens) -> (ro, rd, sd').  ``fx``, ``fy``: the pixels' f32
    coordinates; ``inv_w``, ``inv_h``: f32 ``1 / (W - 1)``, ``1 / (H -
    1)`` of the frame."""
    (j1a, _), sd = rng.hash2(sd)
    (_, j2b), sd = rng.hash2(sd)
    u = (fx + j1a * 1.1) * inv_w
    v = (fy + j2b * 1.1) * inv_h
    return get_ray(cam, u, v, sd)


def fractsin_state(cfg: RenderConfig, fx, fy, s0: int = 0):
    """The v1 fract-sin float2 state of the pixels ``(fx, fy)`` (f32
    coordinates) before sample ``s0``: the texcoord of the pixel centre,
    ``(fx + 0.5) / W`` and ``(fy + 0.5) / H`` (true f32 divisions; ref:
    Shader_RT.fx:422 randState = frag.tex0), advanced by the two jitter
    draws of each of the ``s0`` samples before it.  The state comes from
    absolute pixel coordinates, so batches and slabs draw what a one-shot
    render draws."""
    half = rng.f32_like(fx, 0.5)
    sx = (fx + half) / rng.f32_like(fx, cfg.width)
    sy = (fy + half) / rng.f32_like(fy, cfg.height)
    for _ in range(s0):
        _, (sx, sy) = rng.fs_rand2d(sx, sy)
        _, (sx, sy) = rng.fs_rand2d(sx, sy)
    return sx, sy


def fractsin_sample(cam: Camera, cfg: RenderConfig, fx, fy, sx, sy):
    """One v1 fract-sin sample (ref: Shader_RT.fx:419-455 PS_Main, :288-298
    get_ray) -> ``(ro, rd, draws, (sx', sy'))``.  Only the two jitter draws
    advance the state; the lens offset, the sphere draw and the Schlick
    draw ``h1`` (``draws = (x, y, z, h1)``, :func:`trace`'s
    ``fixed_draws``) are taken BY VALUE from the post-jitter state
    ``(sx', sy')``.  The jitter is over W, ``u = (fx + 0.5 + j1) / W``
    (:433-434), not the v2 generation's 1.1 / (W - 1)."""
    j1, (sx, sy) = rng.fs_rand2d(sx, sy)
    j2, (sx, sy) = rng.fs_rand2d(sx, sy)
    half = rng.f32_like(fx, 0.5)
    u = (fx + half + j1) / rng.f32_like(fx, cfg.width)
    v = (fy + half + j2) / rng.f32_like(fy, cfg.height)
    ldx, ldy = rng.fs_unit_disk(sx, sy)
    lr = cam.lens_radius
    ro = tuple(cam.origin[i] + lr * (ldx * cam.u[i] + ldy * cam.v[i])
               for i in range(3))
    rd = tuple(cam.lower_left[i] + u * cam.horizontal[i]
               + v * cam.vertical[i] - ro[i] for i in range(3))
    s3 = rng.fs_unit_sphere(sx, sy)
    h1, _ = rng.fs_rand2d(sx, sy)
    return ro, rd, (*s3, h1), (sx, sy)


def accumulate_pixels(scene: Scene, cam: Camera, cfg: RenderConfig,
                      px, py, seed, spp: int, init=None, s0: int = 0,
                      bvh: BVH | None = None, tape=None, census=None,
                      check=None):
    """Add ``spp`` LINEAR samples per pixel starting from carried RNG state.

    Returns ((sum_r, sum_g, sum_b), seed').  The sums are taken sample by
    sample, so K batches of spp/K samples (threading ``seed`` and ``init``)
    equal one spp-sample render bit for bit.  In the "parallel" RNG mode,
    ``seed`` is the per-pixel BASE state and ``s0`` the index of the first
    sample (each sample's stream is ``fold_in(seed, s0 + i)``); the
    returned seed is the unchanged base.  In the "v1_fractsin" mode (with
    ``scatter_mode="v1"`` only) each sample is :func:`fractsin_sample` from
    the float2 state :func:`fractsin_state` gives at ``s0``, and ``seed``
    is returned untouched.  ``bvh``, ``tape``, ``census`` and ``check`` go
    to :func:`trace` (the scene then in leaf order).
    """
    if cfg.rng_mode not in ("sequential", "parallel", "v1_fractsin"):
        raise ValueError(f"unknown rng_mode: {cfg.rng_mode!r}")
    fx = px.to(torch.float32)
    fy = py.to(torch.float32)
    if init is None:
        init = (torch.zeros_like(fx),) * 3
    acc_r, acc_g, acc_b = init

    if cfg.rng_mode == "v1_fractsin":
        if cfg.scatter_mode != "v1":
            raise ValueError(
                "rng_mode='v1_fractsin' is the v1 generation's RNG; "
                "pair it with scatter_mode='v1'")
        sx, sy = fractsin_state(cfg, fx, fy, s0)
        for _ in range(spp):
            ro, rd, draws, (sx, sy) = fractsin_sample(cam, cfg, fx, fy, sx,
                                                      sy)
            (r, g, b), _ = trace(scene, ro, rd, seed, cfg.depth, cfg.t_min,
                                 cfg.scatter_mode, bvh, tape, census, check,
                                 fixed_draws=draws)
            acc_r = acc_r + r
            acc_g = acc_g + g
            acc_b = acc_b + b
        return (acc_r, acc_g, acc_b), seed

    # rounded to f32 from the f64 quotient, as raytpu and the kernel do
    inv_w = rng.f32_like(fx, 1.0 / (cfg.width - 1))
    inv_h = rng.f32_like(fx, 1.0 / (cfg.height - 1))
    parallel = cfg.rng_mode == "parallel"

    sd = seed
    for s in range(spp):
        smp = rng.fold_in(seed, s + s0) if parallel else sd
        ro, rd, smp = gen_ray(cam, fx, fy, inv_w, inv_h, smp)
        (r, g, b), smp = trace(scene, ro, rd, smp, cfg.depth, cfg.t_min,
                               cfg.scatter_mode, bvh, tape, census, check)
        acc_r = acc_r + r
        acc_g = acc_g + g
        acc_b = acc_b + b
        if not parallel:
            sd = smp
    return (acc_r, acc_g, acc_b), sd


def _to_gamma(x, gamma):
    """pow(x, 1/gamma) as exp(log(x) / gamma), zero-safe (ref toGamma
    hlsl:99-103)."""
    safe = torch.where(x > 0, x, 1.0)
    return torch.where(x > 0, torch.exp(torch.log(safe) / rng.f32_like(x, gamma)),
                       0.0)


def render_pixels(scene: Scene, cam: Camera, cfg: RenderConfig, px, py,
                  bvh: BVH | None = None, tape=None, census=None,
                  check=None):
    """Render a flat SoA batch of pixels; returns (r, g, b) tensors.

    px, py: integer tensors of pixel coordinates (x = column, y = row;
    row 0 is the BOTTOM of the image, v = y/(H-1) — ShaderCompute.hlsl:306-307).
    ``bvh``, ``tape``, ``census`` and ``check`` as in :func:`trace`.
    """
    seed = rng.pixel_seed(px, py)
    (acc_r, acc_g, acc_b), _ = accumulate_pixels(
        scene, cam, cfg, px, py, seed, cfg.spp, bvh=bvh, tape=tape,
        census=census, check=check)
    inv_spp = rng.f32_like(acc_r, 1.0 / cfg.spp)
    return (_to_gamma(acc_r * inv_spp, cfg.gamma),
            _to_gamma(acc_g * inv_spp, cfg.gamma),
            _to_gamma(acc_b * inv_spp, cfg.gamma))


def slab_pixels(cfg: RenderConfig, row0: int = 0, rows: int | None = None):
    """(rows, live): the rows of the slab ``[row0, row0 + rows)`` (the
    whole frame when ``rows`` is None) and how many of its pixels, the
    first ones in row-major order, lie inside the frame.  A slab's pixel
    ``i`` is ``(i % W, row0 + i // W)``."""
    rows = cfg.height if rows is None else rows
    return rows, max(0, min(rows, cfg.height - row0)) * cfg.width


def render_golden(scene: Scene, cam: Camera, cfg: RenderConfig,
                  bvh: BVH | None = None, tape=None, census=None,
                  row0: int = 0, rows: int | None = None):
    """Full-frame render -> (H, W, 3) f32 image in [0, 1] on the scene's
    device, ``cfg.chunk_pixels`` pixels at a time (the chunk bounds the
    pixels x spheres intermediates; pixels are independent, so the chunk
    size never changes a value).

    ``bvh``: the closest hit sweeps the BVH (:func:`hit_bvh`: the flat
    leaf list, the plain version of K1c, or the skip-pointer walk, of K1d);
    the image is the brute sweep's except on exact ties of t.  ``tape``
    (g_cap, rows*W), when given, receives each pixel's winners, step by
    step across its samples in order (see :func:`render_golden_tape`).
    ``census``, a dict, receives the frame's :data:`CENSUS` counts (see
    :func:`trace`).
    ``row0`` / ``rows``: the (rows, W, 3) slab from absolute row ``row0``
    (the plain version of K1b), its rows past the frame 0."""
    w = cfg.width
    rows, live = slab_pixels(cfg, row0, rows)
    dev = scene.center.device
    if bvh is not None:
        scene = permute_scene(scene, bvh.perm)
    out = torch.zeros((rows * w, 3), dtype=torch.float32, device=dev)
    chunk = max(min(cfg.chunk_pixels, live), 1)
    for start in range(0, live, chunk):
        stop = min(start + chunk, live)
        flat = torch.arange(start, stop, device=dev)
        cursor = (None if tape is None else
                  (tape, flat, torch.zeros_like(flat)))
        r, g, b = render_pixels(scene, cam, cfg, flat % w, row0 + flat // w,
                                bvh, cursor, census)
        out[start:stop] = torch.stack([r, g, b], dim=-1)
    return out.reshape(rows, w, 3)


def render_golden_tape(scene: Scene, cam: Camera, cfg: RenderConfig,
                       g_cap: int, bvh: BVH | None = None, row0: int = 0,
                       rows: int | None = None):
    """The plain version of the taping forward (K4's write side) ->
    (image, tape).  The image is :func:`render_golden`'s; ``tape`` is
    (g_cap, rows*W), int16 or int32 (:func:`tape_dtype`): ``tape[k, pix]``
    is the closest-hit winner (-1 for a miss) of pixel ``pix``'s k-th
    bounce step, counted across its samples in order, as a permuted index
    under a BVH.  Steps past ``g_cap`` are not logged; slots no step
    reached hold ``TAPE_UNWRITTEN``.  ``row0`` / ``rows`` as in
    :func:`render_golden`."""
    n = scene.count if bvh is None else int(bvh.perm.shape[0])
    pixels = slab_pixels(cfg, row0, rows)[0] * cfg.width
    tape = torch.full((g_cap, pixels), TAPE_UNWRITTEN, dtype=tape_dtype(n),
                      device=scene.center.device)
    return render_golden(scene, cam, cfg, bvh, tape, row0=row0,
                         rows=rows), tape


def accumulate_golden(scene: Scene, cam: Camera, cfg: RenderConfig, acc,
                      seed, s0: int, spp: int, bvh: BVH | None = None,
                      row0: int = 0, rows: int | None = None):
    """One progressive batch over the frame (the plain version of K2) ->
    ``(acc', seed')``: :func:`accumulate_pixels` over ``cfg.chunk_pixels``
    pixels at a time, from the carried ``acc`` (rows, W, 3) f32 linear sums
    and ``seed`` (rows, W) int64 (u32 values), ``spp`` samples from sample
    index ``s0`` on.  ``bvh`` and ``row0`` / ``rows`` as in
    :func:`render_golden`; rows past the frame come out 0, sums and
    seeds."""
    w = cfg.width
    rows, live = slab_pixels(cfg, row0, rows)
    dev = scene.center.device
    if bvh is not None:
        scene = permute_scene(scene, bvh.perm)
    acc_in = acc.reshape(-1, 3)
    seed_in = seed.reshape(-1)
    acc_out = torch.zeros((rows * w, 3), dtype=torch.float32, device=dev)
    seed_out = torch.zeros(rows * w, dtype=torch.int64, device=dev)
    chunk = max(min(cfg.chunk_pixels, live), 1)
    for start in range(0, live, chunk):
        stop = min(start + chunk, live)
        flat = torch.arange(start, stop, device=dev)
        part = acc_in[start:stop]
        (r, g, b), sd = accumulate_pixels(
            scene, cam, cfg, flat % w, row0 + flat // w, seed_in[start:stop],
            spp, init=(part[:, 0], part[:, 1], part[:, 2]), s0=s0, bvh=bvh)
        acc_out[start:stop] = torch.stack([r, g, b], dim=-1)
        seed_out[start:stop] = sd
    return acc_out.reshape(rows, w, 3), seed_out.reshape(rows, w)
