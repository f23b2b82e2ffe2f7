"""The port's BVH (raytpu_torch.bvh, raytpu_torch.native, the flat sweep
golden.hit_world_bvh and the BVH render and gradient paths) on the CPU
against raytpu.

Inputs are raytpu's scenes carried across with ``raytpu_torch.convert`` and
rays drawn from numpy seeds.  Tolerances:
- the build (nodes, perm, flat), ``permute_scene`` and ``refit``:
  array-equal (both builds are the same host arithmetic in f64 and f32);
- the flat sweep's winners, mapped through ``perm``: bit-exact against
  raytpu's golden ``hit_world`` (the brute sweep); its t bit-equal to the
  port's own brute ``hit_world`` and within 1e-4 of raytpu's (XLA may
  contract the ground sphere's discriminant into a multiply-add: measured
  6.8e-5 on 12 of 1311 hits);
- the BVH render: |d| <= 3e-4 on at least 99.9% of pixels against
  ``render_pallas(..., bvh=, interpret=True)`` (the cross-context image
  budget of tests/test_torch_megakernel.py) in parallel RNG.  In sequential
  RNG three of the 2048 pixels differ by up to 0.055 (0.15%): a path flip
  between XLA's and torch's rounding, carried on by the pixel's seed chain,
  the same three pixels on raytpu's brute Pallas render against the port's
  brute render.  That case holds the BVH render to exactly the brute
  render's disagreement;
- ``render_grad(bvh=)``: 5e-3 of each leaf's largest entry against raytpu's
  golden gradients (the port's gradient budget, tests/test_torch_adjoint.py)
  at depth 3; at depth 4 the sequential case's path flip moves the geometry
  cotangents by up to 0.47 of their largest entry on the brute path too.
  Against the port's own brute path the BVH gradients are bit-equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

import raytpu
from raytpu import bvh as jbvh, golden as jgolden
from raytpu.config import RenderConfig
from raytpu.kernels import megakernel as jmk
from raytpu.render import render_grad as j_render_grad
import raytpu_torch as rt
from raytpu_torch import bvh as tbvh, convert, golden, native, profiling
from raytpu_torch.kernels import gradkernel as tgk, megakernel as tmk
from test_torch_adjoint import GRAD_BUDGET, leaf_errors

CFG = RenderConfig(width=64, height=32, spp=2, depth=4)
LOOK = ((13.0, 2.0, 3.0), (0.0, 0.0, 0.0))


def _np(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def _port_scene(scene):
    return convert.scene_from_numpy(_np(scene), "cpu")


def _world(n=48, cfg=CFG):
    scene = raytpu.final_world(n=n)
    cam = raytpu.make_camera(*LOOK, vfov=20.0, aspect=cfg.aspect)
    return (scene, cam, _port_scene(scene),
            convert.camera_from_numpy(_np(cam), "cpu"))


def _assert_same_bvh(got, want):
    np.testing.assert_array_equal(got.nodes.numpy(), np.asarray(want.nodes))
    np.testing.assert_array_equal(got.perm.numpy(), np.asarray(want.perm))
    assert got.leaf_size == want.leaf_size
    if want.flat is None:
        assert got.flat is None
    else:
        np.testing.assert_array_equal(got.flat.numpy(),
                                      np.asarray(want.flat))
    assert (got.n_outliers, got.n_trav, got.n_leaves) == (
        want.n_outliers, want.n_trav, want.n_leaves)


@pytest.mark.parametrize("leaf", [1, 4, 16, 64])
@pytest.mark.parametrize("split", [True, False], ids=["split", "nosplit"])
@pytest.mark.parametrize("builder,use_native", [
    ("median", True), ("median", False), ("sah", True)],
    ids=["median_native", "median_numpy", "sah"])
def test_build_matches_raytpu(builder, use_native, split, leaf):
    scene = raytpu.final_world(n=48)
    want = jbvh.build_bvh(scene, leaf_size=leaf, use_native=use_native,
                          builder=builder, split_outliers=split)
    got = tbvh.build_bvh(_port_scene(scene), leaf_size=leaf,
                         use_native=use_native, builder=builder,
                         split_outliers=split)
    _assert_same_bvh(got, want)
    assert got.spheres == 48
    assert got.built_by == (f"native {builder}" if use_native or
                            builder == "sah" else "numpy median")
    assert got.n_outliers == (1 if split else 0)  # the ground sphere


def test_build_unpadded_matches_raytpu():
    scene = raytpu.random_world(seed=2, half_extent=3)
    want = jbvh.build_bvh(scene, leaf_size=8, pad_leaves=False)
    got = tbvh.build_bvh(_port_scene(scene), leaf_size=8, pad_leaves=False)
    _assert_same_bvh(got, want)


def test_native_builder_is_built_here_and_numpy_is_its_fallback(monkeypatch):
    """native.py compiles native/rt_native.cpp into raytpu_torch/build/ and
    records the builder that ran; without the library build_bvh falls back
    to the numpy median builder, with the same arrays."""
    scene = _port_scene(raytpu.final_world(n=40))
    lib = native.get_lib()
    assert lib is not None, native.build_error
    assert native.BUILD_DIR.name == "build"
    assert native.BUILD_DIR.parent.name == "raytpu_torch"
    assert lib.rt_native_abi_version() == native.ABI_VERSION == 2
    a = tbvh.build_bvh(scene, leaf_size=8)
    monkeypatch.setattr(native, "build_bvh_native", lambda *a, **k: None)
    b = tbvh.build_bvh(scene, leaf_size=8)
    assert (a.built_by, b.built_by) == ("native median", "numpy median")
    for x, y in ((a.nodes, b.nodes), (a.perm, b.perm), (a.flat, b.flat)):
        assert torch.equal(x, y)
    # SAH without the library falls back to median, as raytpu's does
    assert tbvh.build_bvh(scene, leaf_size=8, builder="sah").built_by == \
        "numpy median"
    with pytest.raises(ValueError, match="builder"):
        tbvh.build_bvh(scene, builder="lbvh")


def _union_of_leaves(nodes: np.ndarray) -> np.ndarray:
    """Each row of eight octant copies of ``nodes`` with its box the union
    of the leaf rows under it, recomputed from the skip pointers: node j of
    a copy lies under node i iff i <= j < skip(i); a leaf row keeps its
    own box."""
    nodes = np.asarray(nodes, np.float32)
    out = nodes.copy()
    m = len(nodes) // 8
    for o in range(8):
        copy = nodes[o * m:(o + 1) * m]
        for i in range(m):
            sub = copy[i:int(copy[i, 8])]
            leaves = sub[sub[:, 7] > 0]
            out[o * m + i, 0:3] = leaves[:, 0:3].min(axis=0)
            out[o * m + i, 3:6] = leaves[:, 3:6].max(axis=0)
    return out


# seeded random scenes of the refit tests: (spheres, leaf size, seed)
REFIT_CASES = [(48, 8, 0), (300, 4, 1), (500, 64, 2), (500, 8, 3),
               (1000, 16, 4)]


def _random_scene(n, seed):
    """``final_world`` of ``n`` spheres with every centre but the ground's
    jittered, radii drawn in [0.1, 0.4], from ``seed``."""
    scene = rt.final_world(n=n, device="cpu")
    rs = np.random.default_rng(seed)
    c = scene.center.clone()
    c[1:] += torch.from_numpy(rs.normal(0, 0.5, (n - 1, 3)).astype(
        np.float32))
    r = scene.radius.clone()
    r[1:] = torch.from_numpy(rs.uniform(0.1, 0.4, n - 1).astype(np.float32))
    return scene._replace(center=c, radius=r)


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.contiguous().view(torch.int32).long()
                - b.contiguous().view(torch.int32).long()).abs().max())


@pytest.mark.parametrize("n,leaf,seed", REFIT_CASES)
def test_refit_matches_raytpu(n, leaf, seed):
    """After the spheres move (and grow or shrink), the leaf boxes, in
    ``flat`` and in the leaf rows of ``nodes``, are raytpu's refit's bit
    for bit: the padding dummies' NaN rows skipped, ``pad`` added in f32.
    Start, count and skip are raytpu's too.  The interior rows depart from
    it: raytpu voids them to always-enter, the port gives each the union
    of the leaf boxes under it."""
    scene = _random_scene(n, seed)
    rs = np.random.default_rng(seed + 200)
    moved = scene._replace(
        center=scene.center + torch.from_numpy(
            rs.normal(0, 0.3, (n, 3)).astype(np.float32)),
        radius=scene.radius * torch.from_numpy(
            rs.uniform(0.5, 2.0, n).astype(np.float32)))
    j_scene, j_moved = (raytpu.Scene(**convert.scene_to_numpy(s))
                        for s in (scene, moved))
    bvh_j = jbvh.build_bvh(j_scene, leaf_size=leaf)
    want = jbvh.refit(bvh_j, j_moved)
    b = tbvh.build_bvh(scene, leaf_size=leaf)
    assert bool((b.perm < 0).any())  # leaves padded with dummies
    got = tbvh.refit(b, moved)
    np.testing.assert_array_equal(got.flat.numpy(), np.asarray(want.flat))
    want_nodes = np.asarray(want.nodes)
    leaf_rows = want_nodes[:, 7] > 0
    assert (want_nodes[~leaf_rows, 0] == -3.0e38).all()
    np.testing.assert_array_equal(got.nodes.numpy()[leaf_rows],
                                  want_nodes[leaf_rows])
    np.testing.assert_array_equal(got.nodes.numpy()[:, 6:],
                                  want_nodes[:, 6:])
    np.testing.assert_array_equal(got.nodes.numpy(),
                                  _union_of_leaves(want_nodes))
    with pytest.raises(ValueError, match="refit"):
        tbvh.refit(tbvh.build_bvh(scene, pad_leaves=False), moved)


@pytest.mark.parametrize("n,leaf,seed", REFIT_CASES)
def test_refit_of_an_unmoved_scene_is_the_built_tree(n, leaf, seed):
    """A refit of the scene the BVH was built for gives back the built
    tree in every octant copy: start, count and skip bit for bit, and each
    box within one f32 ulp of the build's.  The build accumulates its boxes
    in f64 and rounds once; the refit's leaf boxes are raytpu's f32
    arithmetic, which can round the other way.  The union is exact: on the
    build's own leaf rows it gives the build's interior rows bit for bit,
    and on the refit's leaf rows the refit's."""
    scene = _random_scene(n, seed)
    b = tbvh.build_bvh(scene, leaf_size=leaf)
    r = tbvh.refit(b, scene)
    assert torch.equal(r.nodes[:, 6:], b.nodes[:, 6:])
    assert torch.equal(r.flat[:, 6:], b.flat[:, 6:])
    assert _ulps(r.nodes[:, :6], b.nodes[:, :6]) <= 1
    assert _ulps(r.flat[:, :6], b.flat[:, :6]) <= 1
    np.testing.assert_array_equal(_union_of_leaves(b.nodes.numpy()),
                                  b.nodes.numpy())
    np.testing.assert_array_equal(_union_of_leaves(r.nodes.numpy()),
                                  r.nodes.numpy())
    # the leaf rows of nodes are flat's rows, copy by copy
    leaf_rows = r.nodes.reshape(8, -1, 9)
    leaf_rows = torch.cat([c[c[:, 7] > 0] for c in leaf_rows])
    assert torch.equal(leaf_rows, r.flat)
    # a refit of the refit tree is the refit tree
    again = tbvh.refit(r, scene)
    assert torch.equal(again.nodes, r.nodes)
    assert torch.equal(again.flat, r.flat)


@pytest.mark.parametrize("n,leaf,seed", REFIT_CASES)
def test_refit_after_a_move_gives_each_node_its_leaves_union(n, leaf, seed):
    """After the spheres move (and grow or shrink), every interior box of
    every copy is the union of the padded leaf boxes under it (a numpy
    recompute from the skip pointers), every leaf box holds its spheres
    with the pad, and so every box holds every sphere of its subtree."""
    scene = _random_scene(n, seed)
    b = tbvh.build_bvh(scene, leaf_size=leaf)
    rs = np.random.default_rng(seed + 100)
    moved = scene._replace(
        center=scene.center + torch.from_numpy(
            rs.normal(0, 1.0, (n, 3)).astype(np.float32)),
        radius=scene.radius * torch.from_numpy(
            rs.uniform(0.5, 2.0, n).astype(np.float32)))
    r = tbvh.refit(b, moved)
    nodes = r.nodes.numpy()
    np.testing.assert_array_equal(_union_of_leaves(nodes), nodes)
    assert not np.array_equal(nodes[:, :6], b.nodes.numpy()[:, :6])
    ps = tbvh.permute_scene(moved, b.perm)
    c, rad = ps.center.numpy(), ps.radius.numpy()[:, None]
    copy = nodes[:len(nodes) // 8]
    for i, row in enumerate(copy):
        idx = np.concatenate([np.arange(int(x[6]), int(x[6] + x[7]))
                              for x in copy[i:int(row[8])] if x[7] > 0])
        real = ~np.isnan(rad[idx, 0])
        lo = (c[idx] - rad[idx])[real].min(axis=0)
        hi = (c[idx] + rad[idx])[real].max(axis=0)
        assert (row[0:3] <= lo).all() and (hi <= row[3:6]).all()


def test_subtree_leaves_is_built_once_a_perm():
    """The subtree mask: a leaf row holds itself alone, the root of every
    copy every leaf; refit, with_sweep and BVH.to on its device reuse it,
    a rebuilt BVH builds its own."""
    scene = _random_scene(300, 1)
    b = tbvh.build_bvh(scene, leaf_size=4)
    under = tbvh.subtree_leaves(b)
    assert under.dtype == torch.bool
    assert tuple(under.shape) == (b.nodes.shape[0], b.n_leaves)
    leaf = b.nodes[:, 7] > 0
    assert bool((under[leaf].sum(dim=1) == 1).all())
    ids = (b.nodes[leaf, 6] / 4).long()
    assert torch.equal(under[leaf].float().argmax(dim=1), ids)
    assert bool(under[::b.n_trav].all())
    for same in (tbvh.refit(b, scene), tbvh.with_sweep(b, "walk"),
                 b.to("cpu")):
        assert tbvh.subtree_leaves(same) is under
    assert tbvh.subtree_leaves(tbvh.build_bvh(scene, leaf_size=4)) \
        is not under


def test_permute_scene_round_trips():
    scene = _port_scene(raytpu.final_world(n=48))
    b = tbvh.build_bvh(scene, leaf_size=16)
    ps = tbvh.permute_scene(scene, b.perm)
    want = jbvh.permute_scene(raytpu.final_world(n=48),
                              np.asarray(b.perm.numpy()))
    for k in ("center", "radius", "mat_type", "albedo", "mat_param"):
        np.testing.assert_array_equal(getattr(ps, k).numpy(),
                                      np.asarray(getattr(want, k)), err_msg=k)
    real = b.perm >= 0
    assert int(real.sum()) == 48 and bool(torch.isnan(ps.radius[~real]).all())
    back = torch.empty_like(scene.center)
    back[b.perm[real].long()] = ps.center[real]
    assert torch.equal(back, scene.center)


# BVHs with dummy rows: leaves of 8 and 64 over 48 and 500 spheres
DUMMY_CASES = [(48, 8), (48, 64), (500, 8), (500, 64)]


def _dummy_bvh(n, leaf):
    scene = rt.final_world(n=n, device="cpu")
    b = tbvh.build_bvh(scene, leaf_size=leaf)
    assert bool((b.perm < 0).any())
    return scene, b


def _bits(t: torch.Tensor) -> np.ndarray:
    a = t.detach().numpy()
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("n,leaf", DUMMY_CASES)
def test_permute_scene_bit_for_bit(n, leaf):
    """permute_scene's rows, NaN rows included, bit for bit: each row the
    sphere's own, a dummy's NaN (mat_type 0); gradients reach only the
    spheres' rows, once each."""
    scene, b = _dummy_bvh(n, leaf)
    p = b.perm.numpy().astype(np.int64)
    real = p >= 0
    src = scene._replace(center=scene.center.clone().requires_grad_())
    ps = tbvh.permute_scene(src, b.perm)
    for k in ("center", "radius", "mat_type", "albedo", "mat_param"):
        x = getattr(scene, k).detach().numpy()
        fill = np.zeros((), x.dtype) if k == "mat_type" else np.float32("nan")
        mask = real.reshape((-1,) + (1,) * (x.ndim - 1))
        want = np.where(mask, x[np.maximum(p, 0)], fill).astype(x.dtype)
        got = getattr(ps, k)
        assert got.dtype == getattr(scene, k).dtype, k
        np.testing.assert_array_equal(_bits(got),
                                      _bits(torch.from_numpy(want)), err_msg=k)
    ps.center[torch.from_numpy(real)].sum().backward()
    assert torch.equal(src.center.grad, torch.ones_like(scene.center))


@pytest.mark.parametrize("n,leaf", DUMMY_CASES)
def test_input_order_equals_masked_scatter(n, leaf):
    """The gather back to input order gives, on the same leaf-order
    cotangents, exactly what the masked scatter g[:, perm[real]] =
    gsc[:, real] gives, dummies' columns dropped."""
    scene, b = _dummy_bvh(n, leaf)
    rs = np.random.default_rng(n + leaf)
    gsc = torch.from_numpy(rs.normal(size=(tgk.LEAVES, b.perm.shape[0]))
                           .astype(np.float32))
    gsc[:, b.perm < 0] = float("nan")  # a dummy's column must not leak
    perm = b.perm.to(torch.int64)
    real = perm >= 0
    want = torch.zeros((tgk.LEAVES, n), dtype=gsc.dtype)
    want[:, perm[real]] = gsc[:, real]
    got = tgk.input_order(gsc, b.perm, n)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    # the numpy perm takes the same path, uncached
    assert torch.equal(tgk.input_order(gsc, b.perm.numpy(), n), got)


def test_perm_rows_follow_the_perm():
    """The indices are built once a perm: refit, with_sweep and BVH.to on
    its device reuse them; a rebuilt BVH (a new perm, even an equal one)
    builds its own, and a dropped perm takes its indices with it."""
    scene, b = _dummy_bvh(48, 8)
    first = tbvh.perm_rows(b.perm, 48, "cpu")
    for same in (tbvh.refit(b, scene), tbvh.with_sweep(b, "walk"),
                 b.to("cpu")):
        assert tbvh.perm_rows(same.perm, 48, "cpu") is first
    rebuilt = tbvh.build_bvh(scene, leaf_size=8)
    again = tbvh.perm_rows(rebuilt.perm, 48, "cpu")
    assert again is not first
    assert all(torch.equal(a, w) for a, w in zip(again, first))
    other = tbvh.build_bvh(scene, leaf_size=16)
    rows = tbvh.perm_rows(other.perm, 48, "cpu")
    p = other.perm.to(torch.int64)
    assert torch.equal(rows.valid, p >= 0)
    assert torch.equal(rows.rows, p.clamp(min=0))
    assert torch.equal(p[rows.leaf_row], torch.arange(48))
    ps = tbvh.permute_scene(scene, other.perm)
    assert torch.equal(ps.radius[p >= 0], scene.radius[p[p >= 0]])
    held = len(tbvh._per_perm)
    del b, same, rebuilt, first, again
    assert len(tbvh._per_perm) == held - 2


def _rays(n=2048, seed=9):
    rs = np.random.default_rng(seed)
    o = np.float32([13.0, 2.0, 3.0]) + rs.normal(0, 2.0, (n, 3))
    o[: n // 4] = rs.uniform(-10, 10, (n // 4, 3)) * [1, 0.1, 1] + [0, 0.3, 0]
    d = rs.normal(0, 1.0, (n, 3))
    d[n // 4:] += -o[n // 4:] / 10
    d[:8] = [[1, 0, 0], [0, -1, 0], [0, 0, 1], [-1, 0, 0],
             [0, 1e-9, -1], [1, -1, 0], [0, -1, 1], [-1, -1, -1]]
    return o.astype(np.float32), d.astype(np.float32)


def test_flat_sweep_winners_bit_exact_against_raytpu_hit_world():
    """hit_world_bvh on 2048 rays (a quarter starting among the spheres,
    axis-aligned and grazing directions among them): its winners mapped
    through perm, its t and its normals equal raytpu's brute golden."""
    scene_j = raytpu.final_world(n=48)
    o, d = _rays()
    ro = tuple(o[:, i] for i in range(3))
    rd = tuple(d[:, i] for i in range(3))
    hit_j, t_j, idx_j, n_j, front_j = jgolden.hit_world(
        scene_j, ro, rd, np.float32(1e-3))
    scene = _port_scene(scene_j)
    for leaf in (4, 16, 64):
        b = tbvh.build_bvh(scene, leaf_size=leaf)
        ps = tbvh.permute_scene(scene, b.perm)
        hit, t, idx, nrm, front = golden.hit_world_bvh(
            ps, b, tuple(torch.from_numpy(x) for x in ro),
            tuple(torch.from_numpy(x) for x in rd), 1e-3)
        np.testing.assert_array_equal(hit.numpy(), np.asarray(hit_j))
        h = hit.numpy()
        assert h.mean() > 0.3 and not h.all()
        np.testing.assert_array_equal(b.perm[idx].long().numpy()[h],
                                      np.asarray(idx_j)[h])
        np.testing.assert_allclose(t.numpy()[h], np.asarray(t_j)[h],
                                   rtol=0, atol=1e-4)
        np.testing.assert_array_equal(front.numpy()[h], np.asarray(front_j)[h])
        # against the port's own brute sweep: bit-equal
        want = golden.hit_world(scene, tuple(torch.from_numpy(x) for x in ro),
                                tuple(torch.from_numpy(x) for x in rd), 1e-3)
        assert torch.equal(hit, want[0]) and torch.equal(t, want[1])
        assert torch.equal(b.perm[idx].long()[hit], want[2][hit].long())
        for a, w in zip(nrm, want[3]):
            assert torch.equal(a[hit], w[hit])


def test_flat_sweep_agrees_with_the_scalar_oracle():
    """closest_hit_numpy (the skip-pointer walk over ``nodes``, f64) and
    the flat sweep pick the same sphere on 256 rays."""
    scene = _port_scene(raytpu.final_world(n=48))
    b = tbvh.build_bvh(scene, leaf_size=8)
    ps = tbvh.permute_scene(scene, b.perm)
    o, d = _rays(256, seed=3)
    _, _, idx, _, _ = golden.hit_world_bvh(
        ps, b, tuple(torch.from_numpy(o[:, i].copy()) for i in range(3)),
        tuple(torch.from_numpy(d[:, i].copy()) for i in range(3)), 1e-3)
    hit = 0
    for i in range(256):
        t, j = tbvh.closest_hit_numpy(
            b.nodes.numpy()[: b.n_trav], ps.center.numpy(),
            ps.radius.numpy(), o[i].astype(np.float64),
            d[i].astype(np.float64), 1e-3, b.n_outliers)
        if j >= 0:
            hit += 1
            assert int(idx[i]) == j, i
    assert hit > 64


@pytest.mark.parametrize("rng_mode", ["sequential", "parallel"])
def test_bvh_render_matches_pallas_interpret(rng_mode):
    cfg = CFG.replace(rng_mode=rng_mode)
    scene_j, cam_j, scene, cam = _world(cfg=cfg)
    bvh_j = jbvh.build_bvh(scene_j, leaf_size=16)
    want = np.asarray(jmk.render_pallas(scene_j, cam_j, cfg, bvh=bvh_j,
                                        interpret=True))
    b = tbvh.build_bvh(scene, leaf_size=16)
    before = dict(tmk.variants)
    got = rt.render(scene, cam, cfg, bvh=b)
    assert tmk.variants == before  # CPU tensors never reach the kernel
    d = np.abs(got.numpy() - want).max(axis=-1)
    if rng_mode == "parallel":
        assert float((d > 3e-4).mean()) <= 1e-3, float(d.max())
    else:  # the brute path's own cross-context flips, and no others
        want_brute = np.asarray(jmk.render_pallas(scene_j, cam_j, cfg,
                                                  interpret=True))
        d_brute = np.abs(rt.render(scene, cam, cfg).numpy()
                         - want_brute).max(axis=-1)
        np.testing.assert_array_equal(d > 3e-4, d_brute > 3e-4)
        assert float((d > 3e-4).mean()) <= 2e-3, float(d.max())
    # the flat sweep gives the brute sweep's image (no ties here)
    assert torch.equal(got, rt.render(scene, cam, cfg))
    assert torch.equal(got, rt.render(scene, cam, cfg, backend="golden",
                                      bvh=b))


@pytest.mark.parametrize("rng_mode", ["sequential", "parallel"])
def test_render_grad_bvh_matches_raytpu_golden(rng_mode):
    """render_grad(bvh=) on CPU tensors (the BVH autograd Function: the
    flat-sweep forward, in parallel RNG the taping one, and the adjoint's
    VJP over the scene in leaf order, replaying the tape) against raytpu's
    golden gradients; the gradients come back in input order."""
    cfg = CFG.replace(depth=3, rng_mode=rng_mode)
    scene_j, cam_j, scene, cam = _world(cfg=cfg)
    target = np.random.default_rng(2).uniform(
        0, 1, (cfg.height, cfg.width, 3)).astype(np.float32)
    loss_j, img_j, (gs_j, gc_j) = j_render_grad(scene_j, cam_j, cfg, target,
                                                backend="golden")
    b = tbvh.build_bvh(scene, leaf_size=8)
    loss, img, (gs, gc) = rt.render_grad(scene, cam, cfg, target, bvh=b)
    d = np.abs(img.numpy() - np.asarray(img_j)).max(axis=-1)
    assert float((d > 3e-4).mean()) <= 1e-3, float(d.max())
    # the image budget lets 0.1% of pixels flip: one flipped pixel of 2048
    # moves the mean squared error by up to ~1e-4 of it (measured 7.4e-5)
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=2e-4)
    errs = leaf_errors(gs, gc, convert.scene_grads_from_numpy(gs_j, "cpu"),
                       gc_j)
    assert max(errs.values()) <= GRAD_BUDGET, errs
    # against the port's own brute path (untaped): bit-equal
    _, _, (gs_b, gc_b) = rt.render_grad(scene, cam, cfg, target)
    for k in ("center", "radius", "albedo", "mat_param"):
        assert torch.equal(getattr(gs, k), getattr(gs_b, k)), k
    # golden ignores the BVH for gradients, as raytpu's does
    _, _, (gs_g, _) = rt.render_grad(scene, cam, cfg, target,
                                     backend="golden", bvh=b)
    errs_g = leaf_errors(gs_g, gc, gs, gc)
    assert max(errs_g.values()) <= GRAD_BUDGET, errs_g


def test_bvh_autograd_gives_no_gradient_to_the_bvh():
    cfg = RenderConfig(width=16, height=8, spp=1, depth=2)
    _, _, scene, cam = _world(n=24, cfg=cfg)
    b = tbvh.build_bvh(scene, leaf_size=4)
    center = scene.center.clone().requires_grad_()
    flat = b.flat.clone().requires_grad_()
    img = rt.render(scene._replace(center=center), cam, cfg,
                    bvh=dataclasses.replace(b, flat=flat))
    g_center, g_flat = torch.autograd.grad(img.sum(), (center, flat),
                                           allow_unused=True)
    assert g_flat is None and bool(torch.isfinite(g_center).all())
    assert g_center.abs().sum() > 0


def test_wrappers_refuse_a_bad_bvh_and_cpu_tensors_on_the_kernels():
    cfg = RenderConfig(width=16, height=8, spp=1, depth=2)
    _, _, scene, cam = _world(n=24, cfg=cfg)
    b = tbvh.build_bvh(scene, leaf_size=4)
    # an unpadded BVH (no flat leaf list): the walk sweeps it, to the brute
    # sweep's image
    assert torch.equal(rt.render(scene, cam, cfg, bvh=tbvh.build_bvh(
        scene, pad_leaves=False)), rt.render(scene, cam, cfg))
    with pytest.raises(ValueError, match="bvh.flat"):
        rt.render(scene, cam, cfg, bvh=dataclasses.replace(
            b, flat=b.flat.double()))
    with pytest.raises(ValueError, match="built for 24"):
        rt.render(scene._replace(**{k: getattr(scene, k)[:20] for k in (
            "center", "radius", "mat_type", "albedo", "mat_param")}),
            cam, cfg, bvh=b)
    with pytest.raises(ValueError, match="perm"):
        tmk.check_bvh(b, b.perm.shape[0] + 1, b.device)
    with pytest.raises(ValueError, match="raytpu_torch.bvh.BVH"):
        rt.render(scene, cam, cfg, bvh=(b.nodes, b.perm))
    packed = tmk.pack_scene(tbvh.permute_scene(scene, b.perm))
    with pytest.raises(ValueError, match="CUDA"):
        tmk.launch(tmk.pack_camera(cam), packed, cfg, b)
    with pytest.raises(ValueError, match="CUDA"):
        tgk.launch(tmk.pack_camera(cam), packed, cfg,
                   torch.zeros(cfg.height, cfg.width, 3), bvh=b)
    with pytest.raises(ValueError, match="CUDA"):
        rt.render(scene, cam, cfg, backend="cuda", bvh=b)


def test_census_plain_version_counts_the_frame():
    """profiling.census on CPU tensors (the plain version of K1'): samples
    are W*H*spp, the bounce steps the slots a full tape fills, the same for
    the brute and the BVH sweep; leaves entered lie between one a step
    that is not stopped by the outlier alone and every leaf; the image is
    untouched by counting."""
    cfg = CFG.replace(rng_mode="parallel")
    _, _, scene, cam = _world(cfg=cfg)
    b = tbvh.build_bvh(scene, leaf_size=16)
    got = profiling.census(scene, cam, cfg, b)
    brute = profiling.census(scene, cam, cfg)
    _, tape = golden.render_golden_tape(scene, cam, cfg,
                                        cfg.spp * cfg.depth, b)
    steps = int((tape != golden.TAPE_UNWRITTEN).sum())
    assert got["samples"] == brute["samples"] == 64 * 32 * 2
    assert got["bounce_steps"] == brute["bounce_steps"] == steps
    assert brute["leaves_entered"] == 0 and got["device"] == "cpu"
    assert 0 < got["leaves_entered"] <= steps * b.n_leaves
    assert got["sphere_tests"] == (got["leaves_entered"] * 16
                                   + steps * b.n_outliers)
    assert got["box_tests"] == steps * b.n_leaves
    assert brute["sphere_tests"] == steps * 48
    counts = dict.fromkeys(golden.CENSUS, 0)
    img = golden.render_golden(scene, cam, cfg, b, census=counts)
    assert torch.equal(img, golden.render_golden(scene, cam, cfg, b))
