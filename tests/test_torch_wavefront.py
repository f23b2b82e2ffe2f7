"""raytpu_torch.wavefront (the sorted wavefront, K5 / K6's plain versions on
the CPU) against raytpu's wavefront in interpret mode and the port's golden.

Both packages get identical inputs: scenes and cameras built by raytpu and
carried across with ``raytpu_torch.convert``, BVHs built by each package's
builder from the same arrays (the two builders give equal arrays).

Tolerances:
- against raytpu's wavefront: the budget tests/test_torch_golden.py holds
  the port's golden to against raytpu's (|d| <= 3e-4 on at least 99% of
  pixels): XLA's exp/log/sin/cos and rsqrt round apart from torch's by an
  ulp, which now and then flips a Schlick coin or a near-tie bounce.
- against the port's golden: bit for bit at ``spp_batch`` 1, standard and
  refill (every slot adds its pixel's samples in order, through the same
  bounce step); within ``assert_ulp_equal`` (tests/test_wavefront.py) at
  ``spp_batch`` > 1, where a pixel's slots add in another order.
- the sort keys against raytpu's ``_cell_key`` and ``_key_bounds`` on the
  same arrays: bit for bit.
"""

import contextlib
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import raytpu
from raytpu import wavefront as jwf
from raytpu.bvh import build_bvh as jbuild_bvh
from raytpu.config import RenderConfig as JConfig
import raytpu_torch as rt
from raytpu_torch import autodiff, bvh as tbvh, convert, golden, shard
from raytpu_torch import wavefront as wf
from raytpu_torch.config import RenderConfig
from raytpu_torch.kernels import megakernel
from raytpu_torch.kernels import wavefront as kwf

from test_wavefront import assert_ulp_equal

BUDGET, SHARE = 3e-4, 0.01
LOOK = ((13.0, 2.0, 3.0), (0.0, 0.0, 0.0))


def _np(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def _pair(jscene, cfg, **cam_kw):
    """(jax scene, jax camera, port scene, port camera) on the CPU."""
    jcam = raytpu.make_camera(*LOOK, vfov=20.0, aspect=cfg.aspect, **cam_kw)
    return (jscene, jcam, convert.scene_from_numpy(_np(jscene), "cpu"),
            convert.camera_from_numpy(_np(jcam), "cpu"))


def _jcfg(cfg):
    return JConfig(**{k: getattr(cfg, k) for k in (
        "width", "height", "spp", "depth", "rng_mode", "scatter_mode")})


def _close_to_raytpu(img, want):
    d = np.abs(img.numpy() - np.asarray(want)).max(axis=-1)
    assert (d > BUDGET).mean() <= SHARE, float(d.max())


def _check(jscene, cfg, kw=None, leaf=None, cam_kw=None, exact=True):
    """The port's wavefront against raytpu's (interpret mode) and against
    the port's golden (bit-equal when ``exact``, else within an ulp)."""
    kw, cam_kw = kw or {}, cam_kw or {}
    js, jc, ts, tc = _pair(jscene, cfg, **cam_kw)
    jb = tb = None
    if leaf:
        jb, tb = jbuild_bvh(js, leaf_size=leaf), rt.build_bvh(ts,
                                                              leaf_size=leaf)
    before = sum(kwf.variants.values())
    img = wf.render_wavefront(ts, tc, cfg, bvh=tb, **kw)
    # CPU tensors never reach the kernels
    assert sum(kwf.variants.values()) == before
    assert img.shape == (cfg.height, cfg.width, 3)
    _close_to_raytpu(img, jwf.render_wavefront(js, jc, _jcfg(cfg), bvh=jb,
                                               interpret=True, **kw))
    ref = golden.render_golden(ts, tc, cfg)
    if exact:
        assert torch.equal(img, ref)
    else:
        assert_ulp_equal(img.numpy(), ref.numpy())
    return ts, tc, tb, img


@pytest.mark.parametrize("segments", [None, (1, 1, 3), (5,)])
def test_matches_raytpu_and_golden(segments):
    cfg = RenderConfig(width=64, height=32, spp=2, depth=5)
    _check(raytpu.test_world(), cfg, {"segments": segments})


def test_bvh():
    cfg = RenderConfig(width=32, height=32, spp=2, depth=4)
    _check(raytpu.random_world(half_extent=3), cfg, leaf=8)


def test_parallel_rng():
    cfg = RenderConfig(width=64, height=32, spp=3, depth=4,
                       rng_mode="parallel")
    _check(raytpu.test_world(), cfg)


def test_defocus():
    cfg = RenderConfig(width=64, height=32, spp=2, depth=4)
    _check(raytpu.test_world(), cfg,
           cam_kw={"aperture": 0.6, "focus_dist": 10.0})


def test_spp_batch_chunked_and_monolithic():
    """B = 2 samples of a pixel in flight, R = 2048 slots: two sort chunks
    of 1024 and one sort give the same image (the sort order changes no
    value); both within an ulp of the golden."""
    cfg = RenderConfig(width=32, height=32, spp=2, depth=3,
                       rng_mode="parallel")
    ts, tc, tb, img = _check(raytpu.random_world(half_extent=3), cfg,
                             {"spp_batch": 2, "sort_chunk": 1024}, leaf=8,
                             exact=False)
    assert wf._chunks(32 * 32 * 2, 1024) == 2
    mono = wf.render_wavefront(ts, tc, cfg, bvh=tb, spp_batch=2,
                               sort_chunk=0)
    assert torch.equal(img, mono)


@pytest.mark.parametrize("refill", [1, 2])
def test_refill(refill):
    cfg = RenderConfig(width=64, height=32, spp=3, depth=4,
                       rng_mode="parallel")
    _check(raytpu.test_world(), cfg, {"refill": refill})


def test_refill_bvh_spp_batch():
    cfg = RenderConfig(width=32, height=32, spp=2, depth=3,
                       rng_mode="parallel")
    _check(raytpu.random_world(half_extent=3), cfg,
           {"refill": 2, "spp_batch": 2}, leaf=8, exact=False)


def test_nonaligned_size_and_depth1():
    cfg = RenderConfig(width=50, height=21, spp=2, depth=1)
    _check(raytpu.test_world(), cfg)


def test_v1_scatter():
    """raytpu's tests/test_v1_materials.py:77 case: v1 materials, thin
    lens."""
    cfg = RenderConfig(width=64, height=48, spp=2, depth=5,
                       scatter_mode="v1")
    _check(raytpu.make_scene([
        ((0.0, -1000.5, -1.0), 1000.0, 0, (0.5, 0.5, 0.5), 1.0),
        ((0.0, 0.0, -1.0), 0.5, 0, (0.2, 0.4, 0.8), 1.0),
        ((1.0, 0.0, -1.0), 0.5, 1, (0.8, 0.4, 0.2), 1.7),
        ((-1.0, 0.0, -1.0), 0.5, 2, (0.5, 0.5, 0.5), 1.5),
    ]), cfg, cam_kw={"aperture": 0.1, "focus_dist": 10.0})


@pytest.mark.parametrize("scene_fn", [
    raytpu.test_world, lambda: raytpu.random_world(seed=3, half_extent=4),
    lambda: raytpu.final_world(n=48)],
    ids=["test_world", "random_world", "final_world"])
def test_keys_match_raytpu(scene_fn):
    """_key_bounds and _cell_key bit for bit against raytpu's on the same
    arrays: rays from the scene's surfaces and from outside its box."""
    js = scene_fn()
    ts = convert.scene_from_numpy(_np(js), "cpu")
    jlo, jscale = jwf._key_bounds(js)
    lo, scale = wf._key_bounds(ts)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(scale.numpy(), np.asarray(jscale))
    rs = np.random.default_rng(11)
    o = rs.uniform(-40, 40, (4096, 3)).astype(np.float32)
    o[:2048] = np.asarray(js.center)[rs.integers(0, js.count, 2048)]
    d = rs.normal(size=(4096, 3)).astype(np.float32)
    scal = jnp.concatenate([jnp.zeros(3), jlo, jscale])
    want = jwf._cell_key(scal, *(jnp.asarray(o[:, i]) for i in range(3)),
                         *(jnp.asarray(d[:, i]) for i in range(3)))
    got = wf._cell_key(torch.cat([lo, scale]),
                       tuple(torch.from_numpy(o[:, i]) for i in range(3)),
                       tuple(torch.from_numpy(d[:, i]) for i in range(3)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(np.unique(got.numpy())) > 100


def test_slabs_stitch_to_the_frame():
    """Slabs of 32 rows from absolute rows give the full frame bit for bit
    (standard and refill, two samples in flight); a world of one through
    render_wavefront_sharded is the wavefront."""
    cfg = RenderConfig(width=24, height=70, spp=2, depth=2,
                       rng_mode="parallel")
    scene = rt.final_world(n=48, device="cpu")
    cam = rt.make_camera(*LOOK, vfov=20.0, aspect=cfg.aspect, device="cpu")
    for kw in ({"segments": (1, 1)}, {"refill": 2, "spp_batch": 2}):
        args = (kw.get("segments", (1, 1)), 1, kw.get("spp_batch", 1), 65536,
                kw.get("refill", 0))
        full = wf.render_wavefront(scene, cam, cfg, **kw)
        parts = [wf._render(scene, cam, cfg, None, *args, row0=r, rows=32)
                 for r in (0, 32, 64)]
        assert not bool(parts[2][6:].any())
        assert torch.equal(torch.cat(parts)[:70], full)
        assert torch.equal(shard.render_wavefront_sharded(
            scene, cam, cfg, **kw), full)


@pytest.mark.parametrize("case", ["test_world_sequential",
                                  "final_world_parallel"])
def test_gradients_equal_render_fwd(case):
    """A wavefront image's gradients (its backward is K3's plain version,
    the adjoint's VJP) equal render_fwd's bit for bit, taped (parallel
    RNG, 48 spheres) or not; render_grad(backend="wavefront") is
    render_grad's."""
    parallel = case.endswith("parallel")
    cfg = RenderConfig(width=32, height=16, spp=2, depth=3,
                       rng_mode="parallel" if parallel else "sequential")
    scene = (rt.final_world(n=48, device="cpu") if parallel
             else rt.test_world(device="cpu"))
    cam = rt.make_camera(*LOOK, vfov=20.0, aspect=cfg.aspect, device="cpu")
    ct = torch.from_numpy(np.random.default_rng(3).normal(
        size=(16, 32, 3)).astype(np.float32))
    grads = []
    for fn in (wf.render_wavefront, autodiff.render_fwd):
        leaves = [t.detach().requires_grad_() for t in
                  (scene.center, scene.radius, scene.albedo, scene.mat_param,
                   *cam)]
        s = rt.Scene(leaves[0], leaves[1], scene.mat_type, leaves[2],
                     leaves[3])
        img = fn(s, rt.Camera(*leaves[4:]), cfg)
        grads.append([img, *torch.autograd.grad(img, leaves, ct)])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    target = torch.full((16, 32, 3), 0.5)
    want = rt.render_grad(scene, cam, cfg, target)
    got = rt.render_grad(scene, cam, cfg, target, backend="wavefront")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_backward_refused_on_a_card_in_parallel_rng():
    """Once a refusal, now a run: raytpu's backward of a parallel-RNG
    wavefront image is K3's windowed refill, which the port has (its kernel
    runs on a card: tests/test_torch_cuda_kernel.py), so no check refuses
    it.  On CPU tensors the refill schedule's autograd (``refill=2``, one
    and two samples in flight, with silhouette terms) gives render_grad's
    gradients, bit for bit at one sample in flight, and
    render_grad(backend="wavefront") is render_grad's."""
    assert not hasattr(wf, "check_backward")
    cfg = RenderConfig(width=16, height=8, spp=2, depth=3,
                       rng_mode="parallel")
    scene = rt.test_world(device="cpu")
    cam = rt.make_camera(*LOOK, vfov=20.0, aspect=cfg.aspect, device="cpu")
    target = torch.from_numpy(np.random.default_rng(4).uniform(
        0, 1, (8, 16, 3)).astype(np.float32))
    loss, img, (gs, gc) = rt.render_grad(scene, cam, cfg, target,
                                         vis_w=1e-3)
    want = [img, gs.center, gs.radius, gs.albedo, gs.mat_param, *gc]
    got = rt.render_grad(scene, cam, cfg, target, backend="wavefront",
                         vis_w=1e-3)
    for a, b in zip([got[1], *got[2][0][:2], *got[2][0][3:], *got[2][1]],
                    want):
        assert torch.equal(a, b)
    for B in (1, 2):
        leaves = [t.detach().requires_grad_() for t in
                  (scene.center, scene.radius, scene.albedo, scene.mat_param,
                   *cam)]
        s = rt.Scene(leaves[0], leaves[1], scene.mat_type, leaves[2],
                     leaves[3])
        img_w = wf.render_wavefront(s, rt.Camera(*leaves[4:]), cfg,
                                    vis_w=1e-3, refill=2, spp_batch=B)
        grads = torch.autograd.grad(torch.mean((img_w - target) ** 2),
                                    leaves)
        for a, b in zip([img_w.detach(), *grads], want):
            if B == 1:
                assert torch.equal(a, b)
            else:  # a pixel's two slots add in another order
                assert float((a - b).abs().max()) <= 1e-5 * max(
                    float(b.abs().max()), 1e-6)


@pytest.mark.parametrize("case", ["flat_part_staged", "walk",
                                  "walk_unpadded", "brute", "dense"])
def test_segment_operands_match_the_forward(monkeypatch, case):
    """K5's and K6's closest-hit operands (kwf.hit_args of prepare's
    SceneOps, with the kernels' own from kwf.kernel_operands, as prepare
    makes them on a card) are the ones the forward's launch passes its C
    entry point, raytpu_render_fwd, recorded here for the same scene and
    BVH: the scene pack in leaf order, the BVH's operands (the walk's node
    rows BVH.walk_rows), the stage planned within the same byte limit (one
    that stages two leaves of the flat BVH), and sphere rows equal to the
    ones the forward builds, made once in SceneOps; no dense operand (the
    C entry points stage by the sphere count).  On the CPU prepare makes
    none of the kernels' operands and hit_args refuses the ones that need
    them."""
    cam = rt.make_camera(*LOOK, vfov=20.0, aspect=2.0, device="cpu")
    box = torch.arange(6, dtype=torch.float32)
    bvh = None
    if case == "flat_part_staged":
        scene = rt.final_world(n=48, device="cpu")
        bvh = rt.build_bvh(scene, leaf_size=8)
    elif case.startswith("walk"):
        scene = rt.final_world(n=300, device="cpu")
        bvh = rt.build_bvh(scene, leaf_size=4 if case == "walk" else 7,
                           pad_leaves=case == "walk")
    else:
        scene = (rt.test_world if case == "brute" else rt.random_world)(
            device="cpu")
    limit = 1 << 20
    if bvh is not None and tbvh.sweep_of(bvh) == "flat":
        limit = (megakernel.flat_stage(bvh, limit)["bytes"]
                 - 16 * (bvh.n_leaves - 2) * (bvh.leaf_size + 1))
    plain = kwf.prepare(scene, cam, bvh, box)
    assert plain.stage is plain.walk_rows is plain.spheres is None
    ops = plain._replace(**dict(zip(
        ("stage", "walk_rows", "spheres"),
        kwf.kernel_operands(plain.policy, bvh, plain.pack, lambda: limit))))
    assert ops.policy == {"flat_part_staged": "bvh", "walk_unpadded":
                          "walk"}.get(case, case)
    kscene = scene if bvh is None else tbvh.permute_scene(scene, bvh.perm)
    want = megakernel.pack_scene(kscene)  # NaN rows pad a leaf: the bits
    assert torch.equal(ops.pack.view(torch.int32), want.view(torch.int32))
    assert torch.equal(ops.box, box)
    if ops.policy == "bvh":
        assert ops.stage["leaves"] == 2 and ops.stage["boxes"]

    # the forward's C entry point on the same pack and BVH, recorded
    fwd, rows = [], []
    sphere_rows = megakernel.sphere_rows

    def made_rows(pack):
        rows.append(sphere_rows(pack))
        return rows[-1]

    monkeypatch.setattr(megakernel, "check_packs", lambda cp, sp: None)
    monkeypatch.setattr(megakernel, "check_bvh", lambda b, n, d: None)
    monkeypatch.setattr(megakernel, "flat_stage_on",
                        lambda b, d: megakernel.flat_stage(b, limit))
    monkeypatch.setattr(megakernel, "sphere_rows", made_rows)
    monkeypatch.setattr(megakernel, "_lib", lambda: types.SimpleNamespace(
        raytpu_render_fwd=lambda *a: fwd.append(a) or 0))
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda d=None: types.SimpleNamespace(cuda_stream=0))
    cfg = RenderConfig(width=8, height=4, spp=1, depth=2)
    megakernel.launch(megakernel.pack_camera(cam), ops.pack, cfg, bvh=bvh)
    (f,) = fwd
    args = kwf.hit_args(ops)
    assert len(args) == len(kwf.HIT_ARGTYPES) == 15
    # scene, n, the BVH's 8 operands, the stage's 3: the forward's 1-13
    assert args[:13] == f[1:14]
    assert args[14] == ops.box.data_ptr()
    if ops.policy == "walk":
        (made,) = rows
        assert f[6] == bvh.walk_rows.data_ptr() and f[-2] == made.data_ptr()
        assert torch.equal(ops.spheres.view(torch.int32),
                           made.view(torch.int32))
        assert args[13] == ops.spheres.data_ptr()
    else:
        assert not rows and args[13] is f[-2] is None
    assert kwf.hit_args(ops) == args  # the rows are made once, in prepare
    if bvh is None:
        assert kwf.hit_args(plain)[2:] == args[2:] and args[2] is args[5] \
            is None
    else:
        with pytest.raises(ValueError, match="prepare"):
            kwf.hit_args(plain)


def test_render_backend_and_refusals():
    """render(backend="wavefront") is the wavefront; "auto" never picks
    it, and its knobs elsewhere, a sequential spp_batch or refill, a
    spp_batch not dividing spp and segments not summing to the depth are
    refused with raytpu's errors."""
    cfg = RenderConfig(width=16, height=8, spp=2, depth=2,
                       rng_mode="parallel")
    scene = rt.test_world(device="cpu")
    cam = rt.make_camera(*LOOK, vfov=20.0, aspect=cfg.aspect, device="cpu")
    img = rt.render(scene, cam, cfg, backend="wavefront", spp_batch=2)
    assert torch.equal(img, wf.render_wavefront(scene, cam, cfg,
                                                 spp_batch=2))
    assert torch.equal(rt.render(scene, cam, cfg, backend="wavefront"),
                       rt.render(scene, cam, cfg))
    assert torch.equal(wf.render_wavefront(scene, cam, cfg, tile_rows=8),
                       rt.render(scene, cam, cfg))
    for backend in ("auto", "golden"):
        with pytest.raises(ValueError, match="wavefront"):
            rt.render(scene, cam, cfg, backend=backend, spp_batch=2)
        with pytest.raises(ValueError, match="wavefront"):
            rt.render(scene, cam, cfg, backend=backend, refill=1)
    seq = cfg.replace(rng_mode="sequential")
    for c, kw, match in ((seq, {"spp_batch": 2}, "parallel"),
                         (seq, {"refill": 1}, "parallel"),
                         (cfg, {"spp_batch": 3}, "divide"),
                         (cfg.replace(depth=300), {"refill": 1}, "depth"),
                         (cfg, {"segments": (1,)}, "sum"),
                         (cfg, {"tile_rows": 0}, "tile_rows")):
        with pytest.raises(ValueError, match=match):
            wf.render_wavefront(scene, cam, c, **kw)
    assert wf.default_segments(50) == jwf.default_segments(50) == (3, 9, 38)
    for depth in range(0, 14):
        assert wf.default_segments(depth) == jwf.default_segments(depth)
