"""The port's skip-pointer BVH walk (K1d's plain version,
golden.hit_world_walk, and every path that sweeps a BVH by it) on the CPU
against raytpu's walk.

raytpu takes the walk past ``_FLAT_MAX_LEAVES`` (64) leaves a copy and for
unpadded BVHs: ``final_world(n=300)`` at leaf 4 has 75 leaves a copy, so
both packages walk it by their own rule.  Elsewhere the walk is forced by
``monkeypatch`` on ``raytpu.kernels.megakernel._FLAT_MAX_LEAVES`` and
``gradkernel._FLAT_MAX_LEAVES`` (as raytpu's tests/test_dense.py does) and
on ``raytpu_torch.bvh.FLAT_MAX_LEAVES``.  raytpu's kernels run in
interpret mode.

Tolerances:
- winners: bit-exact against the scalar oracle ``closest_hit_numpy`` (f64)
  and against the flat sweep and the brute sweep (through ``perm``), t and
  normals bit-equal to the port's own sweeps;
- images: |d| <= 3e-4 on at least 99.9% of pixels against raytpu's
  ``render_pallas(..., bvh=, interpret=True)`` (the repo's cross-context
  image budget; at 2 spp the pixels above it are those where raytpu's own
  brute render differs from the port's, XLA's contraction of the ground
  sphere's discriminant: 2 of 2048, up to 3.8e-4), bit-equal to the port's
  flat-sweep and brute images (the walk enters the flat sweep's leaves in
  its order: no tie can differ); K3's image against raytpu's VJP on 99%
  (tests/test_torch_gradkernel.py's budget: at 1 spp one pixel of 512
  differs by 5.3e-4 the same way);
- gradients: 5e-3 of each leaf's largest entry against raytpu's
  ``render_pallas_vjp`` (the port's gradient budget), every leaf, both RNG
  modes, bit-equal to the port's flat-BVH gradients.  The cotangent is
  zeroed on the pixels whose image differs from raytpu's by more than
  3e-4: there XLA's and torch's rounding took another path, whose
  gradient is another path's.  On ``final_world(n=48)`` at 32x16, 1 spp,
  depth 3, sequential RNG, one pixel of 512 does (|d| 5.3e-4); with its
  cotangent kept, the leaves differ by up to 1.1e-2 (origin) with the
  cotangent of seed 4 and 1.7e-2 (radius) with seed 9, the same for the
  walk and the brute sweep in both packages; with it zeroed, by at most
  1.3e-3 (seed 4) and 9.7e-4 (seed 9).  World seeds 1 and 2 have no such
  pixel: at most 4.4e-3 and 1.5e-3 (seed 4);
- progressive batches, slabs and the tape replay: bit-equal;
- the walk's 16-byte node rows (``bvh.pack_walk_rows``, what the card's
  forward and K3 read): unpacked by their plain version, every node's box,
  start, count and skip bit for bit.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import raytpu
from raytpu import bvh as jbvh
from raytpu.config import RenderConfig
from raytpu.kernels import gradkernel as jgk, megakernel as jmk
import raytpu_torch as rt
from raytpu_torch import bvh as tbvh, convert, golden, profiling, progressive
from raytpu_torch.kernels import gradkernel as tgk, megakernel as tmk
from test_torch_adjoint import GRAD_BUDGET, cotangent, leaf_errors

LOOK = ((13.0, 2.0, 3.0), (0.0, 0.0, 0.0))


def _np(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def _world(n, cfg):
    scene = raytpu.final_world(n=n)
    cam = raytpu.make_camera(*LOOK, vfov=20.0, aspect=cfg.aspect)
    return (scene, cam, convert.scene_from_numpy(_np(scene), "cpu"),
            convert.camera_from_numpy(_np(cam), "cpu"))


def _rays(n=256, seed=3):
    rs = np.random.default_rng(seed)
    o = np.float32([13.0, 2.0, 3.0]) + rs.normal(0, 2.0, (n, 3))
    o[: n // 4] = rs.uniform(-10, 10, (n // 4, 3)) * [1, 0.1, 1] + [0, 0.3, 0]
    d = rs.normal(0, 1.0, (n, 3))
    d[n // 4:] += -o[n // 4:] / 10
    d[:4] = [[1, 0, 0], [0, -1, 0], [0, 0, 1], [-1, -1, -1]]
    return o.astype(np.float32), d.astype(np.float32)


def test_sweep_rule_and_forcing(monkeypatch):
    """raytpu's rule: the flat sweep up to FLAT_MAX_LEAVES leaves a copy,
    the walk past it and for unpadded BVHs; with_sweep forces either where
    it applies, and the rule follows a monkeypatched threshold."""
    cfg = RenderConfig(width=16, height=8, spp=1, depth=1)
    _, _, scene, _ = _world(300, cfg)
    small = tbvh.build_bvh(scene, leaf_size=16)
    big = tbvh.build_bvh(scene, leaf_size=4)
    loose = tbvh.build_bvh(scene, leaf_size=4, pad_leaves=False)
    assert (small.n_leaves, big.n_leaves) == (19, 75)
    assert [tbvh.sweep_of(b) for b in (small, big, loose)] == [
        "flat", "walk", "walk"]
    assert (big.copies, loose.copies) == (8, 1)
    assert tbvh.sweep_of(tbvh.with_sweep(big, "flat")) == "flat"
    assert tbvh.sweep_of(tbvh.with_sweep(small, "walk")) == "walk"
    with pytest.raises(ValueError, match="flat sweep needs"):
        tbvh.with_sweep(loose, "flat")
    with pytest.raises(ValueError, match="unknown sweep"):
        tbvh.with_sweep(small, "dense")
    monkeypatch.setattr(tbvh, "FLAT_MAX_LEAVES", 0)
    assert tbvh.sweep_of(small) == "walk"
    # the walk's operands are checked, and the flat list that locates the
    # outlier tail of a padded BVH
    tmk.check_bvh(small, None, small.device)
    tmk.check_bvh(loose, None, loose.device)
    with pytest.raises(ValueError, match="outlier"):
        tmk.check_bvh(dataclasses.replace(small, flat=None), None,
                      small.device)
    with pytest.raises(ValueError, match="bvh.nodes"):
        tmk.check_bvh(dataclasses.replace(small, nodes=small.nodes.double()),
                      None, small.device)
    with pytest.raises(ValueError, match="bvh.nodes"):
        tmk.check_bvh(dataclasses.replace(small, nodes=small.nodes[:-1]),
                      None, small.device)


@pytest.mark.parametrize("padded", [True, False], ids=["padded", "unpadded"])
def test_walk_winners_bit_exact(padded):
    """hit_world_walk on 256 rays (a quarter among the spheres, axis
    aligned ones among them): its winners equal the scalar oracle's, the
    flat sweep's and the brute sweep's; t and normals equal the port's own
    sweeps' bit for bit; the census counts the boxes the walk tests."""
    cfg = RenderConfig(width=16, height=8, spp=1, depth=1)
    _, _, scene, _ = _world(300, cfg)
    b = tbvh.build_bvh(scene, leaf_size=4, pad_leaves=padded)
    assert tbvh.sweep_of(b) == "walk" and b.n_outliers == (1 if padded else 0)
    ps = tbvh.permute_scene(scene, b.perm)
    o, d = _rays()
    ro = tuple(torch.from_numpy(o[:, i].copy()) for i in range(3))
    rd = tuple(torch.from_numpy(d[:, i].copy()) for i in range(3))
    counts = dict.fromkeys(golden.CENSUS, 0)
    hit, t, idx, nrm, front = golden.hit_world_walk(
        ps, b, ro, rd, 1e-3, census=counts, live=torch.ones(256, dtype=bool))
    hits = 0
    for i in range(256):
        _, j = tbvh.closest_hit_numpy(
            b.nodes.numpy()[: b.n_trav], ps.center.numpy(),
            ps.radius.numpy(), o[i].astype(np.float64),
            d[i].astype(np.float64), 1e-3, b.n_outliers)
        assert (int(idx[i]) if hit[i] else -1) == j, i
        hits += j >= 0
    assert hits > 64 and not bool(hit.all())
    want = golden.hit_world(scene, ro, rd, 1e-3)
    assert torch.equal(hit, want[0]) and torch.equal(t, want[1])
    assert torch.equal(b.perm[idx].long()[hit], want[2][hit])
    for a, w in zip(nrm, want[3]):
        assert torch.equal(a[hit], w[hit])
    if padded:
        flat = golden.hit_world_bvh(ps, b, ro, rd, 1e-3)
        assert all(torch.equal(x, y) for x, y in zip(
            (hit, t, idx, front), (flat[0], flat[1], flat[2], flat[4])))
    assert 256 <= counts["nodes_visited"] <= 256 * b.n_trav
    assert 0 < counts["leaves_entered"] < counts["nodes_visited"]
    # only the live lanes walk: theirs are the winners above
    live = torch.arange(256) % 2 == 0
    counts_live = dict.fromkeys(golden.CENSUS, 0)
    off = golden.hit_world_walk(ps, b, ro, rd, 1e-3, census=counts_live,
                                live=live)
    assert torch.equal(off[2][live], idx[live])
    assert counts_live["nodes_visited"] < counts["nodes_visited"]


@pytest.mark.parametrize("rng_mode", ["sequential", "parallel"])
def test_walk_render_matches_raytpu_walk(rng_mode):
    """render(bvh=) over a BVH of 75 leaves a copy: the walk in both
    packages.  Against raytpu's walk in interpret mode (parallel RNG; in
    sequential RNG raytpu's XLA rounding flips a few paths on its brute
    render too, tests/test_torch_bvh.py), and bit-equal to the port's flat
    sweep on the same BVH, its brute sweep and its unpadded BVH (at 32x16
    in sequential RNG, where raytpu is not called)."""
    w, h = (64, 32) if rng_mode == "parallel" else (32, 16)
    cfg = RenderConfig(width=w, height=h, spp=2, depth=3, rng_mode=rng_mode)
    scene_j, cam_j, scene, cam = _world(300, cfg)
    b = tbvh.build_bvh(scene, leaf_size=4)
    before = dict(tmk.variants)
    got = rt.render(scene, cam, cfg, bvh=b)
    assert tmk.variants == before  # CPU tensors never reach the kernel
    if rng_mode == "parallel":
        b_j = jbvh.build_bvh(scene_j, leaf_size=4)
        assert b_j.n_leaves > jmk._FLAT_MAX_LEAVES  # raytpu walks it too
        want = np.asarray(jmk.render_pallas(scene_j, cam_j, cfg, bvh=b_j,
                                            interpret=True))
        d = np.abs(got.numpy() - want).max(axis=-1)
        assert float((d > 3e-4).mean()) <= 1e-3, float(d.max())
    assert torch.equal(got, rt.render(scene, cam, cfg,
                                      bvh=tbvh.with_sweep(b, "flat")))
    assert torch.equal(got, rt.render(scene, cam, cfg))
    loose = tbvh.build_bvh(scene, leaf_size=4, pad_leaves=False)
    assert torch.equal(got, rt.render(scene, cam, cfg, bvh=loose))


@pytest.mark.parametrize("rng_mode", ["sequential", "parallel"])
def test_walk_vjp_and_render_grad_match_raytpu(rng_mode, monkeypatch):
    """The VJP over the walk (raytpu's forced by _FLAT_MAX_LEAVES = 0, the
    port's by FLAT_MAX_LEAVES = 0) against raytpu's render_pallas_vjp in
    interpret mode on the same cotangents (seeds 4 and 9, zeroed where a
    path flipped: module docstring); render_grad(bvh=) over the walk
    (in parallel RNG taped: the walk's taping forward and replay) bit-equal
    to the flat sweep's gradients on the same BVH."""
    cfg = RenderConfig(width=32, height=16, spp=1, depth=3, rng_mode=rng_mode)
    scene_j, cam_j, scene, cam = _world(48, cfg)
    b_j = jbvh.build_bvh(scene_j, leaf_size=4)
    img_j = np.asarray(raytpu.render(scene_j, cam_j, cfg, backend="golden"))
    target = np.random.default_rng(5).uniform(
        0, 1, (cfg.height, cfg.width, 3)).astype(np.float32)
    monkeypatch.setattr(jmk, "_FLAT_MAX_LEAVES", 0)
    monkeypatch.setattr(jgk, "_FLAT_MAX_LEAVES", 0)
    b = tbvh.build_bvh(scene, leaf_size=4)
    flat_grads = rt.render_grad(scene, cam, cfg, target, bvh=b)
    flipped = np.abs(flat_grads[1].numpy() - img_j).max(axis=-1) > 3e-4
    assert float(flipped.mean()) <= 0.01
    monkeypatch.setattr(tbvh, "FLAT_MAX_LEAVES", 0)
    assert tbvh.sweep_of(b) == "walk"
    for seed in (4, 9):
        ct = np.where(flipped[..., None], np.float32(0),
                      cotangent(img_j, seed=seed))
        want = jgk.render_pallas_vjp(scene_j, cam_j, cfg, jnp.asarray(ct),
                                     bvh=b_j, interpret=True)
        img, ds, dc = tgk.render_vjp(scene, cam, cfg, torch.from_numpy(ct),
                                     bvh=b)
        d = np.abs(img.numpy() - np.asarray(want[0])).max(axis=-1)
        assert float((d > 3e-4).mean()) <= 0.01, float(d.max())
        errs = leaf_errors(ds, dc, want[1], want[2])
        assert max(errs.values()) <= GRAD_BUDGET, (seed, errs)
    assert (tgk.tape_plan(cfg, scene.count, b) is None) == (
        rng_mode == "sequential")
    loss, img_w, (gs, gc) = rt.render_grad(scene, cam, cfg, target, bvh=b)
    assert float(loss) == float(flat_grads[0])
    assert torch.equal(img_w, flat_grads[1])
    for k in ("center", "radius", "albedo", "mat_param"):
        assert torch.equal(getattr(gs, k), getattr(flat_grads[2][0], k)), k
    for a, w in zip(gc, flat_grads[2][1]):
        assert torch.equal(a, w)


def test_walk_partial_tape_replay_walks_past_the_cap():
    """A partial tape over the walk: steps past g_cap are walked; the
    gradients equal the untaped ones and the taping forward's image the
    plain render's, bit for bit."""
    cfg = RenderConfig(width=24, height=12, spp=2, depth=3,
                       rng_mode="parallel")
    _, _, scene, cam = _world(300, cfg)
    b = tbvh.build_bvh(scene, leaf_size=4)
    ct = torch.from_numpy(cotangent(np.zeros((12, 24, 3), np.float32), 2))
    img, tape = tgk.render_tape_fwd(scene, cam, cfg, 2, b)
    assert torch.equal(img, rt.render(scene, cam, cfg, bvh=b))
    full = tgk.render_vjp(scene, cam, cfg, ct, img=img, bvh=b)
    part = tgk.render_vjp(scene, cam, cfg, ct, img=img, bvh=b, tape=tape,
                          tape_partial=True)
    for out in (full, part):
        assert torch.equal(out[0], img)
    for k in ("center", "radius", "albedo", "mat_param"):
        assert torch.equal(getattr(part[1], k), getattr(full[1], k)), k
    for a, w in zip(part[2], full[2]):
        assert torch.equal(a, w)


def test_walk_progressive_batches_and_slabs():
    """accumulate in 1 + 2 batches over the walk equals one batch of 3;
    a slab rendered over the walk equals the full frame's rows; the census
    counts the flat sweep's leaves and steps over the walk, and the walk's
    box tests are the nodes it visits."""
    cfg = RenderConfig(width=24, height=12, spp=3, depth=3,
                       rng_mode="sequential")
    _, _, scene, cam = _world(300, cfg)
    b = tbvh.build_bvh(scene, leaf_size=4)
    init = progressive.init_state(cfg, device="cpu")
    one = progressive.accumulate(scene, cam, cfg, init, 3, bvh=b)
    st = progressive.accumulate(scene, cam, cfg, init, 1, bvh=b)
    st = progressive.accumulate(scene, cam, cfg, st, 2, bvh=b)
    assert torch.equal(st.acc, one.acc) and torch.equal(st.seed, one.seed)
    assert torch.equal(progressive.image(st, cfg),
                       rt.render(scene, cam, cfg, bvh=b))
    full = rt.render(scene, cam, cfg, bvh=b)
    part = tmk.forward(scene, cam, cfg, bvh=b, row0=5, rows=9)
    assert torch.equal(part[:7], full[5:]) and not bool(part[7:].any())
    walk = profiling.census(scene, cam, cfg, b)
    flat = profiling.census(scene, cam, cfg, tbvh.with_sweep(b, "flat"))
    for k in ("leaves_entered", "bounce_steps", "samples", "sphere_tests"):
        assert walk[k] == flat[k], k
    assert flat["nodes_visited"] == 0
    assert walk["box_tests"] == walk["nodes_visited"] > 0
    assert walk["box_tests"] < flat["box_tests"]


def test_refit_bvh_walks_every_node():
    """After refit the walk visits the nodes it needs and no more: over a
    refit of the unmoved scene it visits the fresh tree's nodes and enters
    its leaves (the census equal, far below every node of the copy on
    every step, which a voided refit visits), and it gives the image."""
    cfg = RenderConfig(width=16, height=8, spp=1, depth=2)
    _, _, scene, cam = _world(300, cfg)
    fresh = tbvh.build_bvh(scene, leaf_size=4)
    b = tbvh.refit(fresh, scene)
    c = profiling.census(scene, cam, cfg, b)
    assert c == profiling.census(scene, cam, cfg, fresh)
    assert c["nodes_visited"] < c["bounce_steps"] * b.n_trav / 4
    assert torch.equal(rt.render(scene, cam, cfg, bvh=b),
                       rt.render(scene, cam, cfg))


def test_walk_reaches_sharded_progressive_and_train_step():
    """The walk reaches the other entry points through the wrappers:
    render_sharded and render_progressive over a BVH of 75 leaves a copy
    equal render(); a train step (refit each step: the walk then culls by
    the refit's interior boxes) equals the step over the same BVH forced
    flat, bit for bit."""
    from raytpu_torch import shard
    cfg = RenderConfig(width=24, height=12, spp=2, depth=3,
                       rng_mode="parallel")
    _, _, scene, cam = _world(300, cfg)
    b = tbvh.build_bvh(scene, leaf_size=4)
    assert tbvh.sweep_of(b) == "walk"
    img = rt.render(scene, cam, cfg, bvh=b)
    assert torch.equal(shard.render_sharded(scene, cam, cfg, bvh=b), img)
    for _, last in progressive.render_progressive(scene, cam, cfg, batch=1,
                                                  bvh=b):
        pass
    assert torch.equal(last, img)
    target = torch.from_numpy(np.random.default_rng(6).uniform(
        0, 1, (12, 24, 3)).astype(np.float32))
    runs = []
    for bvh in (b, tbvh.with_sweep(b, "flat")):
        s, c, loss = shard.make_train_step(cfg, bvh=bvh)(scene, cam, target)
        runs.append([loss, *s[:2], *s[3:], *c])
    for a, w in zip(*runs):
        assert torch.equal(a, w)


def test_walk_train_step_agrees_with_the_benchmarks_reference():
    """The train step over a walk BVH (75 leaves a copy, refit each step)
    against the benchmark's plain reference (rtbench/reference.py, every
    sphere tested): the image bit for bit, the loss to 1e-6 and every
    leaf's gradient to 1e-5 of the larger of its norm and the median
    leaf's (the benchmark's normalisation, rtbench/check.py).  The camera
    origin's gradient is a cancelling sum here: its norm is a sixth of the
    median leaf's, its gap (4.3e-8) that of the other camera leaves, 2.2e-5
    of its own norm on the brute sweep too.  The step equals the brute
    step (no BVH) bit for bit."""
    from raytpu_torch import shard
    from rtbench import reference as R
    cfg = RenderConfig(width=24, height=12, spp=3, depth=6,
                       rng_mode="parallel")
    _, _, scene, cam = _world(300, cfg)
    b = tbvh.build_bvh(scene, leaf_size=4)
    assert tbvh.sweep_of(b) == "walk" and b.n_leaves == 75
    target = torch.rand(12, 24, 3, generator=torch.Generator().manual_seed(1))
    steps = [shard.make_train_step(cfg, lr=1e-2, bvh=bvh)
             for bvh in (b, None)]
    losses = [float(step(scene, cam, target)[2]) for step in steps]
    walk, brute = steps
    assert losses[0] == losses[1]
    assert torch.equal(walk.last_image, brute.last_image)
    ports = [{"center": ds.center, "radius": ds.radius, "albedo": ds.albedo,
              "param": ds.mat_param, "origin": dc.origin,
              "horizontal": dc.horizontal, "vertical": dc.vertical,
              "lower_left": dc.lower_left}
             for ds, dc in (step.last_grads for step in steps)]
    for k in ports[0]:
        assert torch.equal(ports[0][k], ports[1][k]), k
    rc = R.camera(*LOOK, 20.0, cfg.aspect, device="cpu")
    sp = R.Spheres(scene.center, scene.radius, scene.mat_type.long(),
                   scene.albedo, scene.mat_param)
    lsum, g, img, _ = R.loss_and_grads(sp, rc,
                                       R.Settings(24, 12, 3, 6, "parallel"),
                                       target)
    assert torch.equal(img, walk.last_image)
    assert float(lsum) / (12 * 24 * 3) == pytest.approx(losses[0],
                                                        rel=1e-6)
    median = float(np.median([float(v.norm()) for v in g.values()]))
    for k, v in ports[0].items():
        err = (v.double() - g[k]).norm() / max(float(g[k].norm()), median)
        assert err < 1e-5, k


def _big_world(n=10_000, seed=0, extent=60.0):
    """raytpu's large-scene recipe (scripts/probe_10k_r5.py big_world, as
    chip_smoke.py's phase 7 builds it) on the CPU."""
    rg = np.random.default_rng(seed)
    spheres = [((0.0, -1000.0, 0.0), 1000.0, 0, (0.5, 0.5, 0.5), 0.0),
               ((0.0, 1.0, 0.0), 1.0, 2, (1.0, 1.0, 1.0), 1.5),
               ((-4.0, 1.0, 0.0), 1.0, 0, (0.4, 0.2, 0.1), 0.0),
               ((4.0, 1.0, 0.0), 1.0, 1, (0.7, 0.6, 0.5), 0.0)]
    while len(spheres) < n:
        center = (rg.uniform(-extent, extent), 0.2,
                  rg.uniform(-extent, extent))
        m = rg.random()
        if m < 0.8:
            mat, alb, mp = 0, tuple(rg.random(3) * rg.random(3)), 0.0
        elif m < 0.95:
            mat, alb, mp = 1, tuple(0.5 + 0.5 * rg.random(3)), \
                0.5 * rg.random()
        else:
            mat, alb, mp = 2, (1.0, 1.0, 1.0), 1.5
        spheres.append((center, 0.2, mat, alb, mp))
    return rt.make_scene(spheres, device="cpu")


def test_tenk_config_is_the_10k_scene():
    """The benchmark's ``tenk`` configuration (rtbench/configs/tenk.json)
    lists the 10k scene sphere by sphere: its values read as f32 are the
    recipe's bit for bit, and its BVH (median split, leaf 64) has 157
    leaves and 313 nodes a copy and 1 outlier, so the walk sweeps it."""
    import json
    import os
    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "rtbench", "configs", "tenk.json")
    with open(path) as f:
        conf = json.load(f)
    assert conf["scene"]["builder"] == "listed"
    listed = rt.make_scene([(tuple(c), r, m, tuple(a), p) for c, r, m, a, p
                            in conf["scene"]["spheres"]], device="cpu")
    want = _big_world()
    for k in ("center", "radius", "mat_type", "albedo", "mat_param"):
        got, ref = getattr(listed, k), getattr(want, k)
        assert got.dtype == ref.dtype, k
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32)), k
    b = tbvh.build_bvh(listed, **conf["bvh"])
    assert (b.n_leaves, b.n_trav, b.n_outliers) == (157, 313, 1)
    assert tbvh.sweep_of(b) == "walk"


@pytest.mark.parametrize("kind", ["padded", "unpadded"])
def test_sphere_rows(kind):
    """The walk's sphere rows: (cx, cy, cz, rad * rad) of the scene pack,
    rad * rad the f32 product, NaN dummies kept (padded leaves; an
    unpadded BVH has none)."""
    cfg = RenderConfig(width=16, height=8, spp=1, depth=1)
    _, _, scene, _ = _world(48, cfg)
    b = tbvh.build_bvh(scene, leaf_size=16, pad_leaves=kind == "padded")
    sp = tmk.pack_scene(tbvh.permute_scene(scene, b.perm))
    rows = tmk.sphere_rows(sp)
    assert tuple(rows.shape) == (sp.shape[1], 4) and rows.is_contiguous()
    assert torch.equal(rows[:, :3].contiguous().view(torch.int32),
                       sp[:3].T.contiguous().view(torch.int32))
    want = (sp[3].double() ** 2).float()  # one f32 rounding of the product
    real = ~torch.isnan(sp[3])
    assert torch.equal(rows[real, 3], want[real])
    assert bool(torch.isnan(rows[~real]).all())
    assert bool((~real).any()) == (kind == "padded")


def _walk_bvh(kind):
    """A BVH the walk sweeps: final_world(n=300) at leaf 4 padded (75
    leaves a copy), unpadded at leaf 7 (one copy, leaves of up to 7
    spheres, not all full), refit (each interior box the union of its
    leaves'), a flat BVH forced to the walk, and the 10k scene's at leaf 64
    (8 x 313 nodes)."""
    cfg = RenderConfig(width=16, height=8, spp=1, depth=1)
    if kind == "10k":
        b = tbvh.build_bvh(_big_world(), leaf_size=64)
        assert (b.n_leaves, b.n_trav, b.n_outliers) == (157, 313, 1)
        return b, 64
    if kind == "forced":
        _, _, scene, _ = _world(48, cfg)
        b = tbvh.with_sweep(tbvh.build_bvh(scene, leaf_size=16), "walk")
        return b, 16
    _, _, scene, _ = _world(300, cfg)
    leaf_size = 7 if kind == "unpadded" else 4
    b = tbvh.build_bvh(scene, leaf_size=leaf_size,
                       pad_leaves=kind != "unpadded")
    if kind == "refit":
        b = tbvh.refit(b, scene)
        # real interior boxes, each within its parent's and none voided
        inner = b.nodes[b.nodes[:, 7] == 0]
        assert bool((inner[:, :3] > -1e3).all()
                    & (inner[:, 3:6] < 1e3).all())
        assert bool((inner[:, :3] >= b.nodes[0, :3]).all()
                    & (inner[:, 3:6] <= b.nodes[0, 3:6]).all())
    return b, leaf_size


@pytest.mark.parametrize("kind", ["padded", "unpadded", "refit", "forced",
                                  "10k"])
def test_walk_rows_round_trip(kind):
    """pack_walk_rows packs every node into two 16-byte rows (the 10k
    scene's 8 x 313 nodes into 80,128 bytes); walk_nodes, the plain version
    of the kernels' unpacking, gives back each node's box (its bits),
    start, count and skip exactly."""
    b, leaf_size = _walk_bvh(kind)
    assert tbvh.sweep_of(b) == "walk"
    rows = tbvh.pack_walk_rows(b)
    assert rows.dtype == torch.int32 and rows.is_contiguous()
    assert tuple(rows.shape) == (b.copies * b.n_trav, 8)
    assert rows.numel() * 4 == 32 * b.copies * b.n_trav
    if kind == "10k":
        assert rows.numel() * 4 == 80_128
    got = tbvh.walk_nodes(rows)
    assert torch.equal(got.view(torch.int32), b.nodes.view(torch.int32))
    # what the wrappers pass: packed once a BVH, anew for a new one
    assert b.walk_rows is b.walk_rows and torch.equal(b.walk_rows, rows)
    assert tbvh.with_sweep(b, "walk").walk_rows is not b.walk_rows
    counts = b.nodes[:, 7]
    assert int(counts.max()) == leaf_size and bool((counts >= 0).all())
    if kind == "unpadded":
        assert int(counts[counts > 0].min()) < leaf_size


@pytest.mark.parametrize("padded", [True, False], ids=["padded", "unpadded"])
def test_bvh_args_pass_the_walk_rows(padded):
    """The C entry points' walk operands: the given 16-byte rows (every
    kernel's: the forward's, K3's, K5's and K6's), with the copy's node
    count, the copies and the outlier tail; without them the walk is
    refused (no kernel reads bvh.nodes)."""
    b, _ = _walk_bvh("padded" if padded else "unpadded")
    tail = (tbvh.outlier_tail(b.perm, b.flat, b.leaf_size) or (0, 0))
    assert (tail[1] > 0) == padded
    want = (b.n_trav, b.copies, *tail)
    args = tmk.bvh_args(b, b.walk_rows)
    assert args[:3] == (None, 0, 0) and args[4:] == want
    assert args[3] == b.walk_rows.data_ptr()
    with pytest.raises(ValueError, match="walk_rows"):
        tmk.bvh_args(b, None)


@pytest.mark.parametrize("case", ["rows", "skip", "edge"])
def test_walk_rows_refuses_what_they_cannot_hold(case):
    """The 16-byte rows hold a leaf's start and count in 20 bits and a skip
    in 24: a BVH of 2^20 permuted rows or more, or of 2^24 nodes a copy, is
    refused, never packed wrong; one row fewer packs, and its largest
    start, count and skip come back exactly."""
    cfg = RenderConfig(width=16, height=8, spp=1, depth=1)
    _, _, scene, _ = _world(48, cfg)
    b = tbvh.build_bvh(scene, leaf_size=4, pad_leaves=False)
    last = tbvh.WALK_MAX_ROWS - 1
    if case == "rows":
        big = dataclasses.replace(b, perm=torch.zeros(tbvh.WALK_MAX_ROWS))
        with pytest.raises(ValueError, match="permuted rows"):
            tbvh.pack_walk_rows(big)
    elif case == "skip":  # 2^24 nodes as a view of one row: no memory
        deep = dataclasses.replace(b, nodes=b.nodes[:1].expand(2**24, 9))
        assert deep.n_trav == 2**24
        with pytest.raises(ValueError, match="2\\^24"):
            tbvh.pack_walk_rows(deep)
    else:
        nodes = b.nodes.clone()
        leaf = int(torch.nonzero(nodes[:, 7] > 0)[0])
        nodes[leaf, 6:8] = torch.tensor([last - 7.0, 7.0])
        nodes[0, 8] = 2.0**24 - 1  # the largest skip the rows hold
        edge = dataclasses.replace(b, nodes=nodes, perm=torch.zeros(last))
        assert torch.equal(tbvh.walk_nodes(tbvh.pack_walk_rows(edge)), nodes)
