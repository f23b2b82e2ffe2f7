"""Slab mode and sharding over torch.distributed (raytpu_torch.shard) on
the CPU: plain versions, gloo process groups, and raytpu's golden train
step.

- Plain slabs (uneven, and one running past the frame) stitched equal the
  full frame bit for bit: the image (K1b's plain version), K2's carried
  state, the winner-index tape; the slab VJPs add up to the full VJP
  within 1e-6 of each leaf's largest entry (f32 sums of other pixel
  groupings).
- Process groups: world sizes 2 and 4 run as subprocesses over gloo, with
  a ``file://`` init_method under ``tmp_path`` (no port).  The sharded
  render, the progressive state (a checkpoint migrating 4 -> 2 -> 1
  processes) and a train step's image are bit-identical to world size 1;
  the step's loss and updated leaves agree within 1e-6 (the all-reduce
  adds the per-process sums in another order).
- ``make_train_step``'s options (``backend``, ``refit``) against its
  default step, bit for bit; the step tapes where ``tape_plan`` says.
- ``make_train_step`` (plain path, one process) against raytpu's golden
  ``make_train_step(cfg, mesh)`` on one device: the updated leaves within
  ``lr`` x 5e-3 of each leaf's largest gradient entry (the port's gradient
  budget, tests/test_torch_adjoint.py), plus the leaf's own f32 rounding.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import raytpu
from raytpu import shard as jshard
from raytpu.config import RenderConfig as JConfig
import raytpu_torch as rt
from raytpu_torch import bvh as tbvh, convert, golden, progressive, shard
from raytpu_torch.config import RenderConfig
from raytpu_torch.kernels import gradkernel, megakernel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = RenderConfig(width=40, height=21, spp=2, depth=3, chunk_pixels=128,
                   rng_mode="parallel")
SLABS = ((0, 5), (5, 9), (14, 4), (18, 6))  # uneven; the last past the frame
LOOK = ((13.0, 2.0, 3.0), (0.0, 0.0, 0.0))
LEAVES = ("center", "radius", "albedo", "mat_param")
CAM_STEP = ("origin", "horizontal", "vertical", "lower_left")


def _world(cfg=CFG):
    scene = rt.final_world(n=48, device="cpu")
    cam = rt.make_camera(*LOOK, vfov=20.0, aspect=cfg.aspect, device="cpu")
    return scene, cam, rt.build_bvh(scene, leaf_size=16)


def _live(row0, rows, h=CFG.height):
    return max(0, min(rows, h - row0))


@pytest.mark.parametrize("rng_mode", ["sequential", "parallel"])
def test_plain_slabs_stitch_to_the_frame(rng_mode):
    cfg = CFG.replace(rng_mode=rng_mode)
    w = cfg.width
    scene, cam, bvh = _world(cfg)
    g = cfg.spp * cfg.depth
    full, tape = golden.render_golden_tape(scene, cam, cfg, g, bvh)
    init = progressive.init_state(cfg, device="cpu")
    state = progressive.accumulate(scene, cam, cfg, init, 2, bvh=bvh)
    ct = torch.from_numpy(np.random.default_rng(3).uniform(
        -1e-3, 1e-3, tuple(full.shape)).astype(np.float32))
    want = gradkernel.render_vjp(scene, cam, cfg, ct, bvh=bvh)
    sums = None
    for row0, rows in SLABS:
        live = _live(row0, rows)
        img = megakernel.forward(scene, cam, cfg, bvh=bvh, row0=row0,
                                 rows=rows)
        img_t, tape_s = gradkernel.render_tape_fwd(scene, cam, cfg, g, bvh,
                                                   row0, rows)
        acc, seed = megakernel.accumulate(
            scene, cam, cfg, shard.slab_of(init.acc, row0, rows),
            shard.slab_of(init.seed, row0, rows), 0, 2, bvh, row0, rows)
        assert img.shape == (rows, w, 3) and tape_s.shape == (g, rows * w)
        assert torch.equal(img[:live], full[row0:row0 + live])
        assert torch.equal(img_t, img)
        assert torch.equal(tape_s[:, :live * w],
                           tape[:, row0 * w:(row0 + live) * w])
        assert bool((tape_s[:, live * w:] == golden.TAPE_UNWRITTEN).all())
        assert torch.equal(acc[:live], state.acc[row0:row0 + live])
        assert torch.equal(seed[:live], state.seed[row0:row0 + live])
        for t in (img, acc, seed):
            assert not bool(t[live:].any())
        ct_s = shard.slab_of(ct, row0, rows)
        ct_s[live:] = 1.0  # rows past the frame: their cotangent is ignored
        out = gradkernel.render_vjp(scene, cam, cfg, ct_s, bvh=bvh,
                                    row0=row0, rows=rows)
        assert torch.equal(out[0], img)
        part = [*(getattr(out[1], k) for k in LEAVES), *out[2]]
        sums = ([p.double() for p in part] if sums is None
                else [s + p.double() for s, p in zip(sums, part)])
    ref = [*(getattr(want[1], k) for k in LEAVES), *want[2]]
    for i, (s, r) in enumerate(zip(sums, ref)):
        r = r.double()
        assert float((s - r).abs().max()) <= 1e-6 * max(
            float(r.abs().max()), 1e-8), i


def test_slab_rows_and_world_of_one():
    assert shard.slab_rows(CFG, 1) == 21 and shard.slab_rows(CFG, 2) == 11
    assert shard.slab_rows(CFG, 4) == 6 and shard.world() == (0, 1)
    x = torch.arange(21 * 2).reshape(21, 2)
    assert torch.equal(shard.slab_of(x, 18, 6)[:3], x[18:])
    assert not bool(shard.slab_of(x, 18, 6)[3:].any())
    assert torch.equal(shard.gather_rows(x, 21), x)
    with pytest.raises(ValueError):
        shard.init_distributed(device="meta")
    with pytest.raises(ValueError, match="row0"):
        megakernel.slab(CFG, -1, 4)


# Runs one process of a gloo group: argv = rank, world, init file, output
# npz, checkpoint to resume from ("-" for none), checkpoint to write.
_WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
sys.path.insert(0, sys.argv[7])
import raytpu_torch as rt
from raytpu_torch import progressive, shard
from raytpu_torch.config import RenderConfig

torch.set_num_threads(1)
rank, world = int(sys.argv[1]), int(sys.argv[2])
group = shard.init_distributed(device="cpu", init_method="file://" + sys.argv[3],
                               world_size=world, rank=rank)
assert dist.get_backend() == "gloo" and shard.world(group) == (rank, world)
cfg = RenderConfig(width=40, height=21, spp=2, depth=3, chunk_pixels=128,
                   rng_mode="parallel")
scene = rt.final_world(n=48, device="cpu")
cam = rt.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0,
                     aspect=cfg.aspect, device="cpu")
bvh = rt.build_bvh(scene, leaf_size=16)
img = shard.render_sharded(scene, cam, cfg, group=group, bvh=bvh)
pcfg = cfg.replace(spp=6)
if sys.argv[5] == "-":
    state = progressive.init_state(pcfg, device="cpu")
else:
    state, _ = progressive.load_checkpoint(sys.argv[5], device="cpu")
state = progressive.accumulate(scene, cam, pcfg, state, 2, bvh=bvh,
                               group=group)
if rank == 0:
    progressive.save_checkpoint(sys.argv[6], state, pcfg)
target = torch.from_numpy(np.random.default_rng(5).uniform(
    0, 1, (21, 40, 3)).astype(np.float32))
step = shard.make_train_step(cfg, group=group, bvh=bvh)
s2, c2, loss = step(scene, cam, target)
step_img = shard.gather_rows(step.last_image, cfg.height, group)
if rank == 0:
    np.savez(sys.argv[4], img=img.numpy(), step_img=step_img.numpy(),
             loss=loss.numpy(), acc=state.acc.numpy(),
             **{k: getattr(s2, k).numpy() for k in s2._fields},
             **{"cam_" + k: getattr(c2, k).numpy() for k in c2._fields})
# every rank is done with the group before any tears its pairs down
dist.barrier()
dist.destroy_process_group()
"""


def _run_world(world, tmp_path, resume, write):
    init = tmp_path / f"init_{world}"
    out = tmp_path / f"result_{world}.npz"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, str(r), str(world), str(init),
         str(out), resume, str(write), ROOT], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    errs = []
    for p in procs:
        _, err = p.communicate(timeout=240)
        errs.append((p.returncode, err[-3000:]))
    assert all(rc == 0 for rc, _ in errs), errs
    return dict(np.load(out))


def test_gloo_worlds_match_world_of_one(tmp_path):
    scene, cam, bvh = _world()
    target = torch.from_numpy(np.random.default_rng(5).uniform(
        0, 1, (21, 40, 3)).astype(np.float32))
    img1 = shard.render_sharded(scene, cam, CFG, bvh=bvh)
    assert torch.equal(img1, rt.render(scene, cam, CFG, bvh=bvh))
    step = shard.make_train_step(CFG, bvh=bvh)
    s1, c1, loss1 = step(scene, cam, target)
    ck4, ck2 = tmp_path / "ck4.npz", tmp_path / "ck2.npz"
    r4 = _run_world(4, tmp_path, "-", ck4)
    r2 = _run_world(2, tmp_path, str(ck4), ck2)
    for r in (r4, r2):
        np.testing.assert_array_equal(r["img"], img1.numpy())
        np.testing.assert_array_equal(r["step_img"], step.last_image.numpy())
        np.testing.assert_allclose(r["loss"], loss1.numpy(), rtol=1e-6,
                                   atol=1e-6)
        for k in LEAVES:
            np.testing.assert_allclose(r[k], getattr(s1, k).numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
        for k in rt.Camera._fields:
            np.testing.assert_allclose(r["cam_" + k], getattr(c1, k).numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=k)
    # the progressive state: 2 samples on 4 processes, 2 on 2, 2 on 1
    pcfg = CFG.replace(spp=6)
    state, cfg = progressive.load_checkpoint(str(ck2), device="cpu")
    assert cfg == pcfg and state.samples == 4
    state = progressive.accumulate(scene, cam, pcfg, state, 2, bvh=bvh)
    one = progressive.accumulate(
        scene, cam, pcfg, progressive.init_state(pcfg, device="cpu"), 6,
        bvh=bvh)
    assert torch.equal(state.acc, one.acc) and torch.equal(state.seed,
                                                           one.seed)


@pytest.mark.parametrize("option", ["backend=golden", "refit=False"])
def test_train_step_options(option):
    """Each option of ``make_train_step`` (one process) against the default
    step (taped as the plan says, refit, ``"auto"``), two steps on the same
    inputs, bit for bit: the backend changes no value, and ``refit=False``
    sweeps the BVH it is given, so given the refit BVH each step it takes
    the default's steps."""
    scene, cam, bvh = _world()
    target = torch.from_numpy(np.random.default_rng(4).uniform(
        0, 1, (21, 40, 3)).astype(np.float32))
    key, value = option.split("=")
    runs = []
    for kw in ({}, {key: value}):
        step = shard.make_train_step(CFG, bvh=bvh, **kw)
        s, c, out = scene, cam, []
        for _ in range(2):
            if key == "refit" and kw:
                step = shard.make_train_step(CFG, bvh=tbvh.refit(bvh, s),
                                             refit=False)
            s, c, loss = step(s, c, target)
            out += [loss, *(getattr(s, k) for k in LEAVES), *c]
        runs.append(out)
    for i, (a, b) in enumerate(zip(*runs)):
        assert torch.equal(a, b), i


@pytest.mark.parametrize("rng_mode", ["parallel", "sequential"])
def test_train_step_tapes_as_the_plan_says(monkeypatch, rng_mode):
    """A step (one process, a BVH over ``TAPE_MIN_SPHERES`` or more
    spheres) tapes where ``tape_plan`` says: in parallel RNG it runs the
    taping forward once and the backward's plain replay is given that
    tape; in sequential RNG it runs no taping forward and the backward
    sweeps (no tape)."""
    cfg = CFG.replace(rng_mode=rng_mode)
    scene, cam, bvh = _world(cfg)
    assert scene.count >= gradkernel.TAPE_MIN_SPHERES
    taped, replayed = [], []
    tape_fwd, vjp_plain = (gradkernel.render_tape_fwd,
                           gradkernel.render_vjp_plain)

    def spy_tape_fwd(*args, **kw):
        out = tape_fwd(*args, **kw)
        taped.append(out[1])
        return out

    def spy_vjp_plain(*args):  # render_vjp passes its operands by position
        replayed.append(args[6])
        return vjp_plain(*args)

    monkeypatch.setattr(gradkernel, "render_tape_fwd", spy_tape_fwd)
    monkeypatch.setattr(gradkernel, "render_vjp_plain", spy_vjp_plain)
    step = shard.make_train_step(cfg, bvh=bvh)
    plan = gradkernel.tape_plan(cfg, scene.count, bvh, rows=step.rows)
    target = torch.from_numpy(np.random.default_rng(4).uniform(
        0, 1, (21, 40, 3)).astype(np.float32))
    step(scene, cam, target)
    if rng_mode == "parallel":
        assert plan is not None and len(taped) == 1
        assert len(replayed) == 1 and replayed[0] is taped[0]
    else:
        assert plan is None and taped == [] and replayed == [None]


def test_train_step_matches_raytpu_golden():
    cfg = RenderConfig(width=40, height=24, spp=2, depth=3, chunk_pixels=128)
    jcfg = JConfig(width=40, height=24, spp=2, depth=3, chunk_pixels=128)
    jscene = raytpu.test_world()
    jcam = raytpu.make_camera(*LOOK, vfov=20.0, aspect=cfg.aspect)
    scene = convert.scene_from_numpy(
        {k: np.asarray(v) for k, v in jscene._asdict().items()}, "cpu")
    cam = convert.camera_from_numpy(
        {k: np.asarray(v) for k, v in jcam._asdict().items()}, "cpu")
    target = np.random.default_rng(9).uniform(0, 1, (24, 40, 3)).astype(
        np.float32)
    lr = 1e-2
    js2, jc2, jloss = jshard.make_train_step(
        jcfg, jshard.make_mesh(jax.devices()[:1]), lr=lr)(
        jscene, jcam, target)
    s2, c2, loss = shard.make_train_step(cfg, lr=lr)(
        scene, cam, torch.from_numpy(target))
    _, _, (sg, cg) = rt.render_grad(scene, cam, cfg, torch.from_numpy(target))
    assert abs(float(loss) - float(jloss)) <= 1e-3 * float(jloss)
    pairs = [(getattr(s2, k), getattr(js2, k), getattr(scene, k),
              getattr(sg, k), k) for k in LEAVES]
    pairs += [(getattr(c2, k), getattr(jc2, k), getattr(cam, k),
               getattr(cg, k), k) for k in CAM_STEP]
    for got, want, leaf, grad, k in pairs:
        allowed = (lr * 5e-3 * float(grad.abs().max())
                   + 2 * np.finfo(np.float32).eps * float(leaf.abs().max()))
        assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= \
            allowed, k
