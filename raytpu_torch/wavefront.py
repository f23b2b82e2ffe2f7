"""Sorted-wavefront renderer (counterpart of ``raytpu/wavefront.py``).

The megakernel keeps each pixel's samples in one thread for their whole
path.  The wavefront instead keeps every ray in flat SoA planes of R slots
(R = pad32(H) * pad32(W) * B, the frame laid out in 32 x 32 pixel blocks,
B = ``spp_batch`` samples of a pixel in flight) and runs the bounces in
segments: the segment kernel K5 (:func:`raytpu_torch.kernels.wavefront.
launch_segment`) runs up to k bounces of every live slot and writes a sort
key; between segments the slots are sorted by it (``torch.sort`` of the key
and a gather of every plane: raytpu's ``lax.sort``, plain torch here), so
the next segment's neighbouring threads hold rays of one direction octant
leaving one cell of the scene, and dead rays (key ``DEAD_KEY``) gather at
the end.  Radiance, throughput and seed ride in the slot through every
sort, the slot's pixel id beside them, and one scatter by pixel id
assembles the image after all samples, then the gamma.  With ``refill =
k`` the persistent-refill schedule runs instead: one pass over all samples
in which the refill segment kernel K6 respawns a slot's next sample in the
kernel, with a sort every k bounces.

raytpu demoted this engine on a TPU (raytpu/wavefront.py:3-20);
``render(backend="wavefront")`` runs it only when asked for, never under
``"auto"``.  Its speed on an H100 is measured by ``chip_smoke.py``.

Every bounce is the forward megakernel's (its closest hit, then its
shading; the plain versions :func:`segment_plain` and
:func:`refill_segment_plain` build on :func:`raytpu_torch.golden.bounce_step`)
under the closest-hit policy the scene takes: the dense stage (no BVH, 96
to 4096 spheres, as raytpu's ``_use_dense``), the brute sweep, the flat BVH
sweep or the walk.  A slot's
samples add in the order of its samples, so at ``spp_batch`` 1 the image
is the golden's and ``render()``'s bit for bit; with B > 1 a pixel's B
slots add in another order (within an ulp or so).  The sort order never
changes a value: a slot's work does not depend on its neighbours.

Sort keys and raygen between segments are plain torch on the frame's
device, as raytpu's are jnp: :func:`_key_bounds`, :func:`_cell_key`,
:func:`_primary_key`, :func:`_decode_pid`, :func:`_block_to_image`.
"""

from __future__ import annotations

import numpy as np
import torch

from raytpu_torch import autodiff, golden, rng
from raytpu_torch.bvh import BVH, permute_scene
from raytpu_torch.camera import Camera
from raytpu_torch.config import RenderConfig
from raytpu_torch.kernels import wavefront as kwf
from raytpu_torch.kernels.megakernel import check_scene_bvh, u32_bits
from raytpu_torch.scene import Scene

BLOCK = 32             # primary rays are laid out in 32 x 32 pixel blocks
LANES = BLOCK * BLOCK  # slots a pixel block holds (of one sample)
DEAD_KEY = 1.0e9       # exact in f32
QBITS_XZ = 32          # position-key cells along x and z
QBITS_Y = 8            # ... along y (height)
PRIMARY_BASE = float(1 << 20)  # fresh primaries sort above every cell
QDIR = 64              # their direction cells along x and y


def default_segments(depth: int) -> tuple[int, ...]:
    """raytpu's bounce-segment split (raytpu/wavefront.py:664-679): one
    sort boundary after bounce 3 and, past depth 12, another after bounce
    12 ((1, depth - 1) for depth 2-3, (depth,) for depth <= 1)."""
    if depth > 12:
        return (3, 9, depth - 12)
    if depth > 3:
        return (3, depth - 3)
    if depth > 1:
        return (1, depth - 1)
    return (depth,)


def _pad32(x: int) -> int:
    return -(-x // BLOCK) * BLOCK


def _median(x: torch.Tensor) -> torch.Tensor:
    """jnp.median: the midpoint (lo + hi) * 0.5 of the two middle values
    (torch.median returns the lower one)."""
    s = torch.sort(x).values
    n = s.shape[0]
    return (s[(n - 1) // 2] + s[n // 2]) * 0.5


def _key_bounds(scene: Scene):
    """raytpu's ``_key_bounds``: (lo, scale), each (3,) f32, the box of the
    position key.  Outlier-huge spheres (the r = 1000 ground) would put
    every hit in one cell, so the box covers only the spheres up to 10x the
    median radius; scale = (32, 8, 32) / extent.  Feeds the sort key only,
    never an image value."""
    center = scene.center.to(torch.float32)
    radius = torch.abs(scene.radius.to(torch.float32))
    floor = rng.f32_like(radius, 1e-6)
    keep = (radius <= 10.0 * torch.maximum(_median(radius), floor))[:, None]
    big = rng.f32_like(radius, 1e30)
    lo = torch.where(keep, center - radius[:, None], big).amin(dim=0)
    hi = torch.where(keep, center + radius[:, None], -big).amax(dim=0)
    extent = torch.clamp(hi - lo, 1e-6, 1e6)
    bins = torch.tensor([QBITS_XZ, QBITS_Y, QBITS_XZ], dtype=torch.float32,
                        device=extent.device)
    return lo, bins / extent


def _quant(x: torch.Tensor, bins: int) -> torch.Tensor:
    """raytpu's clip(x.astype(int32), 0, bins - 1) for finite x (the
    kernels' quant: clamped first, NaN to 0)."""
    x = torch.where(x > 0, x, 0.0)
    x = torch.where(x < bins - 1, x, float(bins - 1))
    return x.to(torch.int64)


def _cell_key(box: torch.Tensor, ro, rd) -> torch.Tensor:
    """raytpu's ``_cell_key``: direction octant major, then the origin's
    cell (x, z, y) over the box ``box`` = (lo xyz, scale xyz), as f32."""
    ox, oy, oz = ro
    dx, dy, dz = rd
    qx = _quant((ox - box[0]) * box[3], QBITS_XZ)
    qy = _quant((oy - box[1]) * box[4], QBITS_Y)
    qz = _quant((oz - box[2]) * box[5], QBITS_XZ)
    octant = ((dx < 0).to(torch.int64) * 4 + (dy < 0).to(torch.int64) * 2
              + (dz < 0).to(torch.int64))
    cell = ((octant * QBITS_XZ + qx) * QBITS_XZ + qz) * QBITS_Y + qy
    return cell.to(torch.float32)


def _primary_key(rd) -> torch.Tensor:
    """The refill schedule's key of a freshly respawned slot
    (raytpu/wavefront.py:292-300): PRIMARY_BASE + the unit direction's x
    and y in 64 cells each and the sign of z, as f32."""
    dx, dy, dz = rd
    inv = torch.rsqrt(torch.maximum(dx * dx + dy * dy + dz * dz,
                                    rng.f32_like(dx, 1e-20)))
    half = QDIR / 2
    qdx = _quant((dx * inv + 1.0) * half, QDIR)
    qdy = _quant((dy * inv + 1.0) * half, QDIR)
    sz = (dz < 0).to(torch.int64)
    return PRIMARY_BASE + ((sz * QDIR + qdx) * QDIR + qdy).to(torch.float32)


def _decode_pid(pid: torch.Tensor, wp: int):
    """Block-order slot index -> (px, py) pixel coordinates in the padded
    frame (rows from the slab's first)."""
    nbx = wp // BLOCK
    b = pid // LANES
    m = pid % LANES
    return (b % nbx) * BLOCK + m % BLOCK, (b // nbx) * BLOCK + m // BLOCK


def _block_to_image(lin: torch.Tensor, hp: int, wp: int) -> torch.Tensor:
    """(R, ...) block-order slots -> (hp, wp, ...) image layout."""
    tail = tuple(lin.shape[1:])
    nby, nbx = hp // BLOCK, wp // BLOCK
    return (lin.reshape(nby, nbx, BLOCK, BLOCK, *tail)
            .permute(0, 2, 1, 3, *range(4, 4 + len(tail)))
            .reshape(hp, wp, *tail))


def _seed_of(bits: torch.Tensor) -> torch.Tensor:
    """A plane of u32 bits (stored as f32) -> int64 u32 values."""
    return bits.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _bits_of(seed: torch.Tensor) -> torch.Tensor:
    """int64 u32 values -> their bits as an f32 plane."""
    return u32_bits(seed).view(torch.float32)


def _leaf_scene(ops: kwf.SceneOps) -> Scene:
    """The scene the plain versions sweep: in leaf order with a BVH."""
    bvh = ops.bvh
    return ops.scene if bvh is None else permute_scene(ops.scene, bvh.perm)


def segment_plain(ops: kwf.SceneOps, planes: torch.Tensor, cfg: RenderConfig,
                  n_bounces: int) -> torch.Tensor:
    """The plain version of K5 (:func:`raytpu_torch.kernels.wavefront.
    launch_segment`): up to ``n_bounces`` :func:`golden.bounce_step` calls
    on the live slots of ``planes`` (14, R) -> (15, R), the planes and the
    key."""
    ro, rd = tuple(planes[0:3]), tuple(planes[3:6])
    c, r = tuple(planes[6:9]), tuple(planes[9:12])
    alive = planes[12] > 0
    sd = _seed_of(planes[13])
    scene = _leaf_scene(ops)
    for _ in range(n_bounces):
        if not bool(alive.any()):
            break
        ro, rd, c, r, alive, sd, _ = golden.bounce_step(
            scene, ro, rd, c, r, alive, sd, cfg.t_min, cfg.scatter_mode,
            ops.bvh)
    key = torch.where(alive, _cell_key(ops.box, ro, rd), DEAD_KEY)
    return torch.stack([*ro, *rd, *c, *r, alive.to(torch.float32),
                        _bits_of(sd), key])


def refill_segment_plain(ops: kwf.SceneOps, ride: torch.Tensor,
                         aux: torch.Tensor, cfg: RenderConfig, n_bounces: int,
                         spp_batch: int) -> torch.Tensor:
    """The plain version of K6 (:func:`raytpu_torch.kernels.wavefront.
    launch_refill_segment`), raytpu's ``make_refill_step`` over the live
    slots (key below DEAD_KEY) of ``ride`` (16, R) with ``aux`` (3, R) ->
    (16, R)."""
    alive = ride[0] < DEAD_KEY
    pid = ride[1]
    s_f = torch.floor(ride[2] * (1.0 / 256.0))
    smp = s_f.to(torch.int64)
    d = (ride[2] - s_f * 256.0).to(torch.int64)
    ro, rd, c = tuple(ride[3:6]), tuple(ride[6:9]), tuple(ride[9:12])
    sd = _seed_of(ride[12])
    acc = tuple(ride[13:16])
    fx, fy = aux[0], aux[1]
    bidx = aux[2].to(torch.int64)
    seed0 = rng.pixel_seed(fx.to(torch.int64), fy.to(torch.int64))
    inv_w = rng.f32_like(fx, 1.0 / (cfg.width - 1))
    inv_h = rng.f32_like(fx, 1.0 / (cfg.height - 1))
    spp_slot = cfg.spp // spp_batch
    zero = torch.zeros_like(fx)
    r = (zero, zero, zero)
    one = torch.ones_like(fx)
    scene = _leaf_scene(ops)
    for _ in range(n_bounces):
        if not bool(alive.any()):
            break
        was = alive
        ro, rd, c, r, alive, sd, _ = golden.bounce_step(
            scene, ro, rd, c, r, alive, sd, cfg.t_min, cfg.scatter_mode,
            ops.bvh)
        d = torch.where(was, d + 1, d)
        fin = was & (~alive | (d >= cfg.depth))
        s_next = smp + 1
        more = fin & (s_next < spp_slot)
        acc = tuple(torch.where(fin, a + x, a) for a, x in zip(acc, r))
        nro, nrd, nsd = golden.gen_ray(
            ops.cam, fx, fy, inv_w, inv_h,
            rng.fold_in(seed0, s_next * spp_batch + bidx))
        ro = tuple(torch.where(more, n, o) for n, o in zip(nro, ro))
        rd = tuple(torch.where(more, n, o) for n, o in zip(nrd, rd))
        c = tuple(torch.where(more, one, x) for x in c)
        r = tuple(torch.where(fin, zero, x) for x in r)
        sd = torch.where(more, nsd, sd)
        smp = torch.where(fin, s_next, smp)
        d = torch.where(more, 0, d)
        alive = torch.where(fin, more, alive)
    key = torch.where(alive, torch.where(d == 0, _primary_key(rd),
                                         _cell_key(ops.box, ro, rd)),
                      DEAD_KEY)
    sdpk = smp.to(torch.float32) * 256.0 + d.to(torch.float32)
    return torch.stack([key, pid, sdpk, *ro, *rd, *c, _bits_of(sd), *acc])


def _chunks(R: int, sort_chunk: int) -> int:
    """How many independent sorts of R / n slots a sort boundary takes:
    chunks of whole 32 x 32 blocks, at most ``sort_chunk`` slots each (0:
    one sort).  raytpu chunks by its kernel tiles (raytpu/wavefront.py:485-
    493); any slot permutation gives the same image, so only the order the
    next segment sees depends on it."""
    if not sort_chunk or R <= sort_chunk:
        return 1
    blocks = R // LANES
    per = max(1, sort_chunk // LANES)
    while blocks % per:
        per -= 1
    return blocks // per


def _sort_order(key: torch.Tensor, n_chunks: int) -> torch.Tensor:
    """The slot order that sorts ``key`` within each of ``n_chunks`` equal
    chunks (stable: equal keys keep their order)."""
    if n_chunks == 1:
        return torch.sort(key, stable=True).indices
    per = key.shape[0] // n_chunks
    idx = torch.sort(key.reshape(n_chunks, per), dim=1, stable=True).indices
    base = torch.arange(n_chunks, device=key.device)[:, None] * per
    return (idx + base).reshape(-1)


def _pixels(pid: torch.Tensor, wp: int, B: int, row0: int):
    """(px, py absolute, bidx) of the slots ``pid``."""
    px, py = _decode_pid(pid // B, wp)
    return px, py + row0, pid % B


def _render(scene: Scene, cam: Camera, cfg: RenderConfig, bvh: BVH | None,
            segments: tuple, sort_every: int, spp_batch: int,
            sort_chunk: int, refill: int, row0: int = 0,
            rows: int | None = None) -> torch.Tensor:
    """Rows [row0, row0 + rows) of the frame as one wavefront -> (rows, W,
    3), no autograd.  Seeds and keys come from absolute pixel coordinates,
    so stitched slabs equal the frame bit for bit."""
    B = spp_batch
    h, w = (cfg.height if rows is None else rows), cfg.width
    hp, wp = _pad32(h), _pad32(w)
    R = hp * wp * B
    if R >= kwf.MAX_SLOTS:
        raise ValueError(f"the wavefront holds {R} slots, at most "
                         f"{kwf.MAX_SLOTS - 1} (slot ids ride an f32 plane)")
    dev = scene.center.device
    ops = kwf.prepare(scene, cam, bvh, torch.cat(_key_bounds(scene)))
    # the segment kernels on a card, their plain versions on the CPU
    cpu = dev.type == "cpu"
    segment = segment_plain if cpu else kwf.launch_segment
    refill_segment = refill_segment_plain if cpu else kwf.launch_refill_segment
    n_chunks = _chunks(R, sort_chunk)
    inv_w = torch.tensor(np.float32(1.0 / (w - 1)), device=dev)
    inv_h = torch.tensor(np.float32(1.0 / (cfg.height - 1)), device=dev)
    pid = torch.arange(R, device=dev)
    one = torch.ones(R, dtype=torch.float32, device=dev)
    zero = torch.zeros(R, dtype=torch.float32, device=dev)

    def primaries(pid, sd):
        px, py, _ = _pixels(pid, wp, B, row0)
        ro, rd, sd = golden.gen_ray(cam, px.to(torch.float32),
                                    py.to(torch.float32), inv_w, inv_h, sd)
        return ro, rd, sd, (px < w) & (py < cfg.height)

    if refill:
        px, py, bidx = _pixels(pid, wp, B, row0)
        ro, rd, sd, valid = primaries(
            pid, rng.fold_in(rng.pixel_seed(px, py), bidx))
        ride = torch.stack([torch.where(valid, 0.0, DEAD_KEY),
                            pid.to(torch.float32), zero, *ro, *rd, one, one,
                            one, _bits_of(sd), zero, zero, zero])
        while bool((ride[0] < DEAD_KEY).any()):
            ride = ride[:, _sort_order(ride[0], n_chunks)]
            px, py, bidx = _pixels(ride[1].to(torch.int64), wp, B, row0)
            aux = torch.stack([px, py, bidx]).to(torch.float32)
            ride = refill_segment(ops, ride, aux, cfg, refill, B)
        pid, rad = ride[1].to(torch.int64), ride[13:16]
    else:
        parallel = cfg.rng_mode == "parallel"
        px, py, _ = _pixels(pid, wp, B, row0)
        seed = rng.pixel_seed(px, py)
        rad = torch.stack([zero, zero, zero])
        for s in range(cfg.spp // B):
            if parallel:
                px, py, bidx = _pixels(pid, wp, B, row0)
                seed = rng.fold_in(rng.pixel_seed(px, py), s * B + bidx)
            ro, rd, sd, valid = primaries(pid, seed)
            planes = torch.cat([torch.stack([*ro, *rd, one, one, one]), rad,
                                torch.stack([valid.to(torch.float32),
                                             _bits_of(sd)])])
            # sort_every > 1: only every k-th wave sorts (raytpu :624-628)
            do_sort = s % sort_every == 0
            for i, seg in enumerate(segments):
                out = segment(ops, planes, cfg, seg)
                if do_sort and i < len(segments) - 1:
                    order = _sort_order(out[14], n_chunks)
                    out, pid = out[:, order], pid[order]
                planes = out[:14]
            rad, seed = planes[9:12], _seed_of(planes[13])
    # one scatter by pixel id, then the B slots of a pixel, the gamma
    lin = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    lin[pid] = rad.T
    if B > 1:
        lin = lin.reshape(hp * wp, B, 3).sum(dim=1)
    img = _block_to_image(lin, hp, wp)[:h, :w]
    return golden._to_gamma(img * rng.f32_like(img, 1.0 / cfg.spp),
                            cfg.gamma)


def check_options(cfg: RenderConfig, segments, tile_rows, sort_every: int,
                  spp_batch: int, sort_chunk: int, refill: int) -> tuple:
    """Raise on an option raytpu refuses (raytpu/wavefront.py:372-379,
    :523-533, :769); return the segments (``default_segments(depth)`` for
    None)."""
    if segments is None:
        segments = default_segments(cfg.depth)
    segments = tuple(int(s) for s in segments)
    if sum(segments) != cfg.depth or any(s < 0 for s in segments):
        raise ValueError(f"segments {segments} must be >= 0 and sum to the "
                         f"depth {cfg.depth}")
    if tile_rows is not None and int(tile_rows) < 1:
        raise ValueError(f"tile_rows {tile_rows} < 1")
    if sort_every < 1 or sort_chunk < 0 or refill < 0:
        raise ValueError("sort_every >= 1, sort_chunk >= 0 and refill >= 0, "
                         f"got {sort_every}, {sort_chunk}, {refill}")
    B = int(spp_batch)
    if B < 1:
        raise ValueError(f"spp_batch {B} < 1")
    if B > 1:
        if cfg.rng_mode != "parallel":
            raise ValueError(
                "spp_batch > 1 needs rng_mode='parallel' (sequential seed "
                "chains are order-dependent within a pixel)")
        if cfg.spp % B:
            raise ValueError(f"spp_batch {B} must divide spp {cfg.spp}")
    if refill:
        if cfg.rng_mode != "parallel":
            raise ValueError("refill wavefront needs rng_mode='parallel' "
                             "(respawn re-derives per-sample seeds by "
                             "fold_in)")
        if cfg.depth > 256 or cfg.spp // B > 65535:
            raise ValueError(
                "refill wavefront supports depth <= 256 and spp/spp_batch "
                f"<= 65535 (got depth={cfg.depth}, "
                f"spp_slot={cfg.spp // B})")
    return segments


def render_wavefront(scene: Scene, cam: Camera, cfg: RenderConfig,
                     bvh: BVH | None = None, segments=None,
                     tile_rows: int | None = None, vis_w: float = 0.0,
                     sort_every: int = 1, spp_batch: int = 1,
                     sort_chunk: int = 65536,
                     refill: int = 0) -> torch.Tensor:
    """Full-frame sorted-wavefront render -> (H, W, 3) f32 image on the
    inputs' device (raytpu's ``render_wavefront``, with its defaults).

    ``segments``: the bounce-segment lengths (summing to ``cfg.depth``)
    between which the slots are sorted, :func:`default_segments` for None.
    ``sort_every = k``: only every k-th wave of samples sorts.
    ``spp_batch = B``: B samples of a pixel in flight (parallel RNG, B
    divides spp).  ``sort_chunk``: the most slots one sort takes (0: one
    sort of all).  ``refill = k``: the persistent-refill schedule (parallel
    RNG) with a sort every k bounces; ``segments`` and ``sort_every`` are
    then not used.  ``tile_rows`` is raytpu's TPU tiling knob: accepted and
    checked, it changes nothing here (no value depends on the slot order).
    ``bvh``: a :func:`raytpu_torch.bvh.build_bvh` of this scene, swept by
    raytpu's rule; without one, 96 to 4096 spheres take the dense stage.
    CUDA tensors run K5 / K6, CPU tensors their plain versions; the image
    equals ``render()``'s bit for bit at ``spp_batch`` 1.  Differentiable:
    with a continuous leaf that requires grad the backward is K3 on CUDA
    tensors, its windowed refill in parallel RNG (``vis_w > 0`` adds
    silhouette gradients), the adjoint's VJP on CPU tensors."""
    check_scene_bvh(scene, cam, cfg, bvh)
    options = (check_options(cfg, segments, tile_rows, int(sort_every),
                             int(spp_batch), int(sort_chunk), int(refill)),
               int(sort_every), int(spp_batch), int(sort_chunk), int(refill))
    if autodiff.needs_grad(scene, cam):
        # K3 takes the wavefront's image as given (raytpu/wavefront.py:682)
        return autodiff.differentiable(
            scene, cam, cfg, vis_w, bvh,
            render=lambda s, c: _render(s, c, cfg, bvh, *options))
    with torch.no_grad():
        return _render(scene, cam, cfg, bvh, *options)
