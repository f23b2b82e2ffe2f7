"""The fused VJP kernel's wrapper (raytpu_torch.kernels.gradkernel), the
gradient route around the kernels (raytpu_torch.autodiff, which no kernel
wrapper imports), ``render_grad`` and the config-3 optimisation, on the CPU
against raytpu.

On CPU tensors ``render_vjp`` runs its plain version (the VJP of the
port's adjoint renderer); it is held against
``raytpu.kernels.gradkernel.render_pallas_vjp(..., interpret=True)``, the way
tests/test_gradkernel.py runs the Pallas kernel on the CPU.  The CUDA kernel
itself runs only on a card: tests/test_torch_cuda_kernel.py.

Tolerances are those of tests/test_torch_adjoint.py: images |d| <= 3e-4 on
at least 99% of pixels, gradients max|a - b| / max(max|b|, floor) <= 5e-3
per leaf (floor 1e-8 scene, 1e-6 camera).  Measured on the CPU (worst leaf
of each case, the radius in every one): sequential defocus 6.0e-4, parallel
pinhole 2.8e-4, parallel with ``img=`` 2.8e-4; ``render_grad`` against
raytpu's golden backend 3.1e-4 with either port backend, the loss within
3e-7 relative.  The camera assembly from the 18 sums is exact up to the
order of a 3-term dot product (rtol 1e-6).
"""

import ast
import glob
import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import raytpu
from raytpu import bvh as jbvh
from raytpu.config import RenderConfig
from raytpu.kernels import gradkernel as jgk
from raytpu.render import render_grad as j_render_grad
import raytpu_torch as rt
from raytpu_torch import bvh as tbvh, convert, optim
from raytpu_torch.kernels import gradkernel as tgk, megakernel as tmk
from test_torch_adjoint import GRAD_BUDGET, cotangent, leaf_errors

LOOK = ((13.0, 2.0, 3.0), (0.0, 0.0, 0.0))


def _np(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def _to_port(scene, cam):
    return (convert.scene_from_numpy(_np(scene), "cpu"),
            convert.camera_from_numpy(_np(cam), "cpu"))


def _case(name):
    cfg = RenderConfig(width=32, height=16, spp=2, depth=3)
    kw = {}
    if name == "sequential_defocus":
        kw = dict(aperture=0.3, focus_dist=12.0)
    else:
        cfg = cfg.replace(rng_mode="parallel")
    cam = raytpu.make_camera(*LOOK, vfov=20.0, aspect=cfg.aspect, **kw)
    return raytpu.test_world(), cam, cfg


@pytest.mark.parametrize("name", ["sequential_defocus", "parallel_pinhole",
                                  "parallel_pinhole_img"])
def test_render_vjp_matches_pallas_interpret(name):
    scene, cam, cfg = _case(name)
    img_ref = raytpu.render(scene, cam, cfg, backend="golden")
    ct = cotangent(img_ref, seed=1)
    use_img = name.endswith("_img")
    want = jgk.render_pallas_vjp(
        scene, cam, cfg, jnp.asarray(ct), interpret=True,
        **(dict(img=img_ref, p2_refill=False) if use_img else {}))
    s, c = _to_port(scene, cam)
    img_t = torch.from_numpy(np.array(img_ref)) if use_img else None
    before = sum(tgk.variants.values())
    img, ds, dc = tgk.render_vjp(s, c, cfg, torch.from_numpy(ct), img=img_t)
    # CPU tensors never reach the kernel
    assert sum(tgk.variants.values()) == before
    assert ds.mat_type is None
    d = np.abs(img.numpy() - np.asarray(want[0])).max(axis=-1)
    assert float((d > 3e-4).mean()) <= 0.01, float(d.max())
    errs = leaf_errors(ds, dc, want[1], want[2])
    assert max(errs.values()) <= GRAD_BUDGET, errs


@pytest.mark.parametrize("name", ["parallel_pinhole", "parking",
                                  "defocus_vis_w", "config2_bvh"])
def test_render_vjp_matches_pallas_refill(monkeypatch, name):
    """Given the image in parallel RNG, raytpu's backward runs its
    windowed-refill PASS 2: the port's render_vjp on the same inputs
    (CPU tensors: the plain version of both PASS 2 schedules) against
    ``render_pallas_vjp(..., interpret=True, img=, p2_refill=True)`` in
    tests/test_gradkernel.py:155-225's cases: a pinhole, a window of about
    one sample (lanes park and resume), defocus with silhouette terms, and
    config 2's scene over a BVH."""
    cfg = RenderConfig(width=64, height=16, spp=3, depth=4,
                       rng_mode="parallel")
    scene, cam_kw, vis_w, use_bvh = raytpu.test_world(), {}, 0.0, False
    if name == "parking":
        monkeypatch.setattr(jgk, "_P2_VMEM_BUDGET", 5 * 13 * 4096)
        cfg = cfg.replace(spp=6)
    elif name == "defocus_vis_w":
        cfg = cfg.replace(spp=2, depth=3)
        cam_kw, vis_w = dict(aperture=0.3, focus_dist=12.0), 1e-3
    elif name == "config2_bvh":
        cfg = cfg.replace(spp=2, depth=3)
        scene, use_bvh = raytpu.config2_world(), True
    cam = raytpu.make_camera(*LOOK, vfov=20.0, aspect=cfg.aspect, **cam_kw)
    img = raytpu.render(scene, cam, cfg, backend="golden")
    ct = cotangent(img, seed=5)
    want = jgk.render_pallas_vjp(
        scene, cam, cfg, jnp.asarray(ct), interpret=True, img=img,
        p2_refill=True, vis_w=vis_w,
        bvh=jbvh.build_bvh(scene) if use_bvh else None)
    s, c = _to_port(scene, cam)
    img_t = torch.from_numpy(np.array(img))
    img_p, ds, dc = tgk.render_vjp(
        s, c, cfg, torch.from_numpy(ct), img=img_t, vis_w=vis_w,
        bvh=rt.build_bvh(s) if use_bvh else None, p2_refill=True)
    d = np.abs(img_p.numpy() - np.asarray(want[0])).max(axis=-1)
    assert float((d > 3e-4).mean()) <= 0.01, float(d.max())
    errs = leaf_errors(ds, dc, want[1], want[2])
    assert max(errs.values()) <= GRAD_BUDGET, errs


def test_refill_plan_and_rule(monkeypatch):
    """raytpu's rule: the refill runs when the image is given in parallel
    RNG and p2_refill is True or None (P2_REFILL on); the plan's lanes
    split the pixels evenly in blocks no more than the cap, and its window
    lies in [depth, spp * depth] within REFILL_BUDGET."""
    par = RenderConfig(width=800, height=400, spp=100, depth=12,
                       rng_mode="parallel")
    img = torch.zeros(1)
    assert tgk.uses_refill(par, img) and tgk.uses_refill(par, img, True)
    assert not tgk.uses_refill(par, img, False)
    assert not tgk.uses_refill(par, None, True)
    assert not tgk.uses_refill(par.replace(rng_mode="sequential"), img, True)
    monkeypatch.setattr(tgk, "P2_REFILL", False)
    assert not tgk.uses_refill(par, img) and tgk.uses_refill(par, img, True)
    cap = 132 * 512
    for cfg, rows in ((par, 400), (par.replace(width=1920, height=1080,
                                               spp=20), 1080),
                      (par.replace(width=400, height=200, spp=20), 200),
                      (par.replace(width=50, height=21, spp=3), 7)):
        plan = tgk.refill_plan(cfg, rows, cap)
        lanes, hops, window = plan["lanes"], plan["hops"], plan["window"]
        pixels = rows * cfg.width
        assert lanes % tgk.REFILL_BLOCK == 0 and lanes <= cap
        assert (hops - 1) * lanes < pixels <= hops * lanes
        assert cfg.depth <= window <= cfg.spp * cfg.depth
        assert plan["bytes"] == lanes * window * tgk.ROW_BYTES
        assert plan["bytes"] <= tgk.REFILL_BUDGET
    assert tgk.refill_plan(par, 400, cap)["window"] == 174
    monkeypatch.setattr(tgk, "REFILL_BUDGET", 0)
    assert tgk.refill_plan(par, 400, cap)["window"] == par.depth


# an NVIDIA H100's shared memory (opt-in a block, an SM's, reserved a
# block), the blocks of K3's flat instantiations an SM keeps resident (two:
# 128 registers) and the refill's cam_sh (18 f64 a thread of 256)
CAM_SH = 18 * 256 * 8
H100_LIMITS = (232448, 233472, 1024, 2, CAM_SH)


@pytest.mark.parametrize("limits,want", [
    (H100_LIMITS, "full"),
    ((232448, 233472, 1024, 1, CAM_SH), "full"),
    ((49152, 233472, 1024, 2, CAM_SH), "no_boxes"),
], ids=["h100", "one_block", "small"])
def test_k3_stage_within_limit(monkeypatch, limits, want):
    """K3's stage over a flat BVH (k3_stage): within the opt-in limit less
    the refill's cam_sh, and small enough for the blocks an SM keeps
    resident (78,848 bytes on an H100); all of config 4's scene at small
    leaves (final_world(n=48), 3 leaves of 16), part of a 63-leaf BVH at
    leaf 64, whose 83 KB outgrow an H100's two-block share and whose boxes
    outgrow a 48 KB opt-in limit."""
    optin, per_sm, reserved, blocks, fixed = limits
    limit = tgk.stage_limit(*limits)
    assert limit == min(optin, per_sm // blocks - reserved) - fixed
    if limits == H100_LIMITS:
        assert limit == 78848
    monkeypatch.setattr(tgk, "device_limits", lambda device: limits)
    small = rt.build_bvh(rt.final_world(n=48, device="cpu"), leaf_size=16)
    big = rt.build_bvh(rt.final_world(n=4000, device="cpu"), leaf_size=64)
    assert (small.n_leaves, big.n_leaves) == (3, 63)
    for bvh in (small, big):
        st = tgk.k3_stage(bvh, "cpu")
        assert st == tmk.flat_stage(bvh, limit)
        assert st["bytes"] <= limit
        assert st["bytes"] + fixed <= optin
        assert blocks * (st["bytes"] + fixed + reserved) <= per_sm
    st = tgk.k3_stage(small, "cpu")
    assert (st["leaves"], st["outliers"], st["boxes"]) == (
        3, small.n_outliers, 16 * 3)
    st = tgk.k3_stage(big, "cpu")
    if want == "full":
        assert 0 < st["leaves"] <= big.n_leaves
        assert (st["leaves"] < big.n_leaves) == (blocks == 2)
        assert st["boxes"] == 16 * big.n_leaves
    else:  # the boxes do not fit: leaves from the rest
        assert st["boxes"] == 0 and 0 < st["leaves"] < big.n_leaves
    assert st["outliers"] == big.n_outliers


def test_k3_launch_plan_lanes(monkeypatch):
    """A launch's plan (launch_plan): over a flat BVH its stage, without a
    BVH the brute sweep's rows (16 bytes a sphere up to 4096 spheres, none
    above), over the walk nothing staged; the refill's lanes are those of
    the staged bytes, one plan whether or not the launch replays a tape
    (the tape is no input of it), so a taped and an untaped launch sum the
    camera terms alike."""
    monkeypatch.setattr(tgk, "device_limits", lambda device: H100_LIMITS)
    asked = []

    def lanes(device, shmem=0):
        asked.append(shmem)
        return 132 * 512 - (256 if shmem > 40000 else 0)
    monkeypatch.setattr(tgk, "refill_lanes", lanes)
    cfg = RenderConfig(width=800, height=400, spp=100, depth=12,
                       rng_mode="parallel")
    scene = rt.final_world(n=4000, device="cpu")
    bvh = rt.build_bvh(scene, leaf_size=64)
    sp = torch.zeros(tmk.SCENE_ROWS, int(bvh.perm.shape[0]))
    stage, plan = tgk.launch_plan(cfg, 400, sp, bvh, True)
    assert stage == tgk.k3_stage(bvh, "cpu") and asked == [stage["bytes"]]
    assert plan == tgk.refill_plan(cfg, 400, lanes("cpu", stage["bytes"]))
    assert tgk.launch_plan(cfg, 400, sp, bvh, True) == (stage, plan)
    assert tgk.launch_plan(cfg, 400, sp, bvh, False) == (stage, None)
    st, pl = tgk.launch_plan(cfg, 400, sp, tbvh.with_sweep(bvh, "walk"),
                             True)
    assert st["bytes"] == 0 and asked[-1] == 0
    assert pl == tgk.refill_plan(cfg, 400, 132 * 512)
    for n, staged in ((4, 64), (2600, 41600), (4096, 65536), (4097, 0)):
        sp = torch.zeros(tmk.SCENE_ROWS, n)
        st, pl = tgk.launch_plan(cfg, 400, sp, None, True)
        assert st == {"leaves": 0, "outliers": 0, "boxes": 0,
                      "bytes": staged} and asked[-1] == staged
        assert pl == tgk.refill_plan(cfg, 400, lanes("cpu", staged))
        assert tgk.launch_plan(cfg, 400, sp, None, True) == (st, pl)
        assert tgk.launch_plan(cfg, 400, sp, None, False) == (st, None)


@pytest.mark.parametrize("aperture", [0.0, 0.3], ids=["pinhole", "defocus"])
def test_camera_assembly_matches_raytpu(monkeypatch, aperture):
    """camera_grads on 18 given sums equals raytpu's host assembly
    (render_pallas_vjp's last lines) on the same sums: raytpu's function
    runs with its pallas_call replaced by one that returns those sums."""
    cfg = RenderConfig(width=16, height=8, spp=1, depth=1)
    scene = raytpu.test_world()
    cam = raytpu.make_camera(*LOOK, vfov=20.0, aspect=cfg.aspect,
                             aperture=aperture, focus_dist=10.0)
    sums = np.random.default_rng(3).normal(0, 1, 32).astype(np.float32)

    def fake_pallas_call(kernel, *, out_shape, **kw):
        def run(*operands):
            outs = [jnp.zeros(o.shape, o.dtype) for o in out_shape]
            outs[-1] = jnp.asarray(sums).reshape(out_shape[-1].shape)
            return tuple(outs)
        return run

    monkeypatch.setattr(jgk.pl, "pallas_call", fake_pallas_call)
    _, _, want = jgk.render_pallas_vjp(
        scene, cam, cfg, jnp.zeros((cfg.height, cfg.width, 3)),
        interpret=True)
    got = tgk.camera_grads(torch.from_numpy(sums[:tgk.CAM_SUMS]),
                           _to_port(scene, cam)[1])
    for k in rt.Camera._fields:
        np.testing.assert_allclose(getattr(got, k).numpy(),
                                   np.asarray(getattr(want, k)), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    if aperture == 0.0:
        for k in ("u", "v", "lens_radius"):
            assert not getattr(got, k).any(), k


@pytest.mark.parametrize("backend", ["golden", "auto"])
def test_render_grad_matches_raytpu_golden(backend):
    """render_grad on CPU tensors: ``golden`` runs the adjoint renderer,
    ``auto`` the forward kernel's autograd Function (plain golden forward,
    the VJP kernel's plain version backward); both equal raytpu's
    ``render_grad(backend="golden")``."""
    cfg = RenderConfig(width=32, height=16, spp=2, depth=3)
    scene = raytpu.test_world()
    cam = raytpu.make_camera(*LOOK, vfov=20.0, aspect=cfg.aspect)
    target = np.random.default_rng(2).uniform(
        0, 1, (cfg.height, cfg.width, 3)).astype(np.float32)
    loss_j, img_j, (gs_j, gc_j) = j_render_grad(scene, cam, cfg, target,
                                                backend="golden")
    s, c = _to_port(scene, cam)
    loss, img, (gs, gc) = rt.render_grad(s, c, cfg, target, backend=backend)
    assert gs.mat_type is None and not loss.requires_grad
    gs_j = convert.scene_grads_from_numpy(gs_j, "cpu")  # float0 -> None
    assert gs_j.mat_type is None and gs_j.center.dtype == torch.float32
    d = np.abs(img.numpy() - np.asarray(img_j)).max(axis=-1)
    assert float((d > 3e-4).mean()) <= 0.01, float(d.max())
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-5)
    errs = leaf_errors(gs, gc, gs_j, gc_j)
    assert max(errs.values()) <= GRAD_BUDGET, errs


def test_render_autograd_equals_render_vjp():
    """autograd through render() runs the VJP kernel's wrapper as its
    backward: the same cotangents as calling render_vjp directly."""
    scene, cam, cfg = _case("parallel_pinhole")
    s, c = _to_port(scene, cam)
    ct = torch.from_numpy(cotangent(np.zeros((16, 32, 3), np.float32), 4))
    leaves = [t.clone().requires_grad_() for t in (s.center, s.albedo,
                                                   c.origin)]
    img = rt.render(s._replace(center=leaves[0], albedo=leaves[1]),
                    c._replace(origin=leaves[2]), cfg, vis_w=0.005)
    assert torch.equal(img.detach(), rt.render(s, c, cfg))
    got = torch.autograd.grad(img, leaves, ct)
    _, ds, dc = tgk.render_vjp(s, c, cfg, ct, vis_w=0.005)
    for a, b in zip(got, (ds.center, ds.albedo, dc.origin)):
        assert torch.equal(a, b)


def test_wrappers_check_their_inputs():
    scene, cam, cfg = _case("parallel_pinhole")
    s, c = _to_port(scene, cam)
    with pytest.raises(ValueError, match="ct"):
        tgk.render_vjp(s, c, cfg, torch.zeros(cfg.height, cfg.width))
    with pytest.raises(ValueError, match="img"):
        tgk.render_vjp(s, c, cfg, torch.zeros(cfg.height, cfg.width, 3),
                       img=torch.zeros(cfg.height, cfg.width, 3,
                                       dtype=torch.float64))
    with pytest.raises(ValueError, match="v1_fractsin"):
        tgk.render_vjp(s, c, cfg.replace(rng_mode="v1_fractsin"),
                       torch.zeros(cfg.height, cfg.width, 3))
    with pytest.raises(ValueError, match="CUDA"):
        tgk.launch(tmk.pack_camera(c), tmk.pack_scene(s), cfg,
                   torch.zeros(cfg.height, cfg.width, 3))
    with pytest.raises(ValueError, match="v1_fractsin"):
        rt.render_grad(s, c, cfg.replace(rng_mode="v1_fractsin"),
                       np.zeros((cfg.height, cfg.width, 3), np.float32))


def test_kernel_wrappers_import_nothing_above_them():
    """The kernel wrappers sit below the gradient route: no module of
    raytpu_torch/kernels imports, at its top or inside a function, the
    route (autodiff) or an entry above it (render, shard, wavefront,
    progressive), and megakernel does not import gradkernel."""
    above = {f"raytpu_torch.{m}" for m in ("autodiff", "render", "shard",
                                            "wavefront", "progressive")}
    kernels = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "raytpu_torch", "kernels")
    paths = sorted(glob.glob(os.path.join(kernels, "*.py")))
    assert {os.path.basename(p) for p in paths} >= {
        "megakernel.py", "gradkernel.py", "wavefront.py"}
    for path in paths:
        with open(path) as f:
            tree = ast.parse(f.read())
        names = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names.update(a.name for a in node.names)
            elif isinstance(node, ast.ImportFrom):
                pkg = "raytpu_torch.kernels".split(".")
                base = (".".join(pkg[:len(pkg) + 1 - node.level]
                                 + [node.module or ""]).strip(".")
                        if node.level else node.module)
                names.add(base)
                names.update(f"{base}.{a.name}" for a in node.names)
        module = os.path.basename(path)[:-3]
        assert not names & above, (module, names & above)
        if module == "megakernel":
            assert "raytpu_torch.kernels.gradkernel" not in names


def test_config3_problem_loss_decreases():
    """The config-3 inverse-rendering problem at 48x24 on the CPU: a few
    Adam steps on the hero sphere's centre lower the loss and move the
    centre towards the truth."""
    cfg = RenderConfig(width=48, height=24, spp=4, depth=4)
    truth, scene0, _, target, loss_fn = optim.inverse_render_problem(
        cfg, device="cpu")
    assert tuple(target.shape) == (24, 48, 3)
    params, losses = optim.optimize(loss_fn, {"center": scene0.center[1]},
                                    steps=6, lr=0.02)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    err0 = float((scene0.center[1] - truth.center[1]).norm())
    err1 = float((params["center"] - truth.center[1]).norm())
    assert err1 < err0, (err0, err1)
