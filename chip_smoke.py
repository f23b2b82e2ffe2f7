"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Needs a CUDA card and nvcc; builds the port's CUDA kernels from
``raytpu_torch/csrc/`` (the forward megakernel K1a and the fused VJP kernel
K3, one nvcc each, in parallel) and drives ``raytpu_torch``'s two paths:
the forward render and the gradient path (autograd through ``render``,
``render_grad``, ``optim.optimize``).  It imports nothing of JAX or of
``raytpu``, and uses one card (the first that CUDA_VISIBLE_DEVICES names,
card 0 without it).  Phases, one JSON line each:

1.  setup: the card (nvidia-smi name and power limit) and the kernel builds;
2.  K1a against its plain PyTorch version on the card, case by case;
2b. K3 against its plain version (the adjoint's VJP) on the same CUDA
    tensors, case by case: K3's image bit-equal to K1a's, every leaf's
    cotangent within the budget below;
2c. ``python -m raytpu_torch.cli gradcheck --device cuda`` in a subprocess;
3.  the forward path: ``render`` at the full REFERENCE_V2 frame (1024x576,
    60 spp, depth 50, random_world) with the launch counter checked, then
    the same frame through the CLI in a subprocess;
3b. the gradient path at full CONFIG3 (400x200, 20 spp, depth 12) on the
    config-3 inverse-rendering problem: one ``render_grad`` with silhouette
    gradients, then 20 Adam steps of ``optim.optimize`` on the hero
    sphere's centre, each step one K1a and one K3 launch;
4.  K1a times from CUDA events, kernel and plain version;
4b. fwd+bwd and K3 times, beside the plain adjoint's.

It exits non-zero at the first failure.  The line before the last is the
kernel table as JSON, the last line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

# one card: the first visible one, set before torch sees CUDA
os.environ["CUDA_VISIBLE_DEVICES"] = os.environ.get(
    "CUDA_VISIBLE_DEVICES", "0").split(",")[0]

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
BUDGET_DELTA = 3e-4    # cross-context image budget (post-gamma)
BUDGET_SHARE = 1e-3    # share of pixels allowed above it (path flips)
DEPTH1_TOL = 1e-6      # depth-1 spp-1: jitter, primary hit and sky only
PLAIN_CHUNK = 1 << 16  # plain version's pixels per chunk on the card
# K3 vs its plain version, per leaf: max|a - b| / max(max|b|, floor), floor
# 1e-8 for scene leaves and 1e-6 for camera leaves.  Both sides run the same
# f32 op order per bounce, but K3 sums the cotangents of up to 5.9e7
# (pixel, sample, bounce) terms in f64, while the plain version sums them in
# f32, through index_add_ (atomics on the card, in no fixed order) and
# autograd's reductions; an f32 sum of n terms is off by up to ~sqrt(n) ulp
# of its largest partial, and the camera origin's sum cancels ~800x.  So the
# disagreement grows with the frame: measured on an H100, <= 1e-4 in the
# five smaller cases and 8.9e-4 (mat_param) on random_world at 1024x576,
# 2 spp, depth 50.  The budget is the port's cross-package gradient budget
# (tests/test_torch_adjoint.py), 5x the largest measured; each case also
# prints the plain version's own spread between two runs.  (raytpu holds
# its TPU kernel to 1e-4 against autodiff at 32x16, 5e-4 for defocus with
# parallel RNG.)
GRAD_BUDGET = 5e-3
VIS_W = 0.005          # the config-3 problem's silhouette weight
ADAM_STEPS = 20
ADAM_LR = 0.005        # at 0.01 the loss bottomed at step 14 and rose again


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def phase(name: str, **kv) -> None:
    print(json.dumps({"phase": name, **kv}), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int) -> float:
    """Mean ms per call from CUDA events, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def compare(got: torch.Tensor, want: torch.Tensor) -> dict:
    d = (got - want).abs().amax(dim=-1)  # per pixel, worst channel
    return {"max_abs_err": float(d.max()),
            "share_above_budget": float((d > BUDGET_DELTA).float().mean()),
            "share_bit_equal": float((got == want).all(dim=-1).float().mean())}


def leaf_errors(got, want, cam_fields) -> tuple[dict, float]:
    """(relative max error per leaf, largest absolute error) of two
    (img, d_scene, d_cam) triples."""
    rel, worst_abs = {}, 0.0
    pairs = [(k, getattr(got[1], k), getattr(want[1], k), 1e-8)
             for k in ("center", "radius", "albedo", "mat_param")]
    pairs += [(k, a, b, 1e-6) for k, a, b in zip(cam_fields, got[2], want[2])]
    for k, a, b, floor in pairs:
        if not bool(torch.isfinite(a).all()):
            fail(f"the {k} cotangent is not finite")
        d = float((a - b).abs().max())
        worst_abs = max(worst_abs, d)
        rel[k] = d / max(float(b.abs().max()), floor)
    return rel, worst_abs


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a card")
    sys.path.insert(0, ROOT)
    import raytpu_torch as rt
    from raytpu_torch import golden, io, optim
    from raytpu_torch.config import CONFIG2, CONFIG3, REFERENCE_V1, \
        REFERENCE_V2, RenderConfig
    from raytpu_torch.kernels import _build, gradkernel, megakernel

    dev = torch.device("cuda", 0)
    card = card_line()
    phase("setup", card=card, torch=torch.__version__,
          cuda=torch.version.cuda, capability=torch.cuda.get_device_capability(0))
    t0 = time.perf_counter()
    _build.load_all([megakernel.SOURCE, gradkernel.SOURCE])
    phase("build", seconds=time.perf_counter() - t0,
          ptxas={src: _build.build_log[src]["ptxas"]
                 for src in (megakernel.SOURCE, gradkernel.SOURCE)})

    def v2_cam(cfg):
        return rt.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0,
                              aspect=cfg.aspect, device=dev)

    # -- phase 2: K1a vs plain version on the card
    cfg_ref2 = REFERENCE_V2.replace(spp=2)
    cfg_odd = RenderConfig(width=50, height=21, spp=4, depth=12)
    odd_cam = rt.make_camera((0.0, 0.2, 1.0), (0.0, 0.0, -1.0), vfov=60.0,
                             aspect=cfg_odd.aspect, device=dev)
    cases = [
        ("config2", CONFIG2, rt.config2_world(device=dev), v2_cam(CONFIG2),
         BUDGET_DELTA),
        ("reference_v2_spp2", cfg_ref2, rt.random_world(device=dev),
         rt.reference_camera_v2(cfg_ref2.aspect, device=dev), BUDGET_DELTA),
        ("reference_v1", REFERENCE_V1, rt.v1_world(device=dev),
         rt.reference_camera_v1(device=dev), BUDGET_DELTA),
        ("config2_parallel", CONFIG2.replace(rng_mode="parallel"),
         rt.config2_world(device=dev), v2_cam(CONFIG2), BUDGET_DELTA),
        ("unaligned_50x21", cfg_odd, rt.config1_world(device=dev), odd_cam,
         BUDGET_DELTA),
        ("depth1_spp1_reference_v2", REFERENCE_V2.replace(spp=1, depth=1),
         rt.random_world(device=dev),
         rt.reference_camera_v2(REFERENCE_V2.aspect, device=dev), DEPTH1_TOL),
        ("depth1_spp1_reference_v1", REFERENCE_V1.replace(depth=1),
         rt.v1_world(device=dev), rt.reference_camera_v1(device=dev),
         DEPTH1_TOL),
    ]
    worst = 0.0
    for name, cfg, scene, cam, tol in cases:
        got = megakernel.launch(megakernel.pack_camera(cam),
                                megakernel.pack_scene(scene), cfg)
        want = golden.render_golden(scene, cam,
                                    cfg.replace(chunk_pixels=PLAIN_CHUNK))
        torch.cuda.synchronize()
        res = compare(got, want)
        worst = max(worst, res["max_abs_err"])
        ok = (res["max_abs_err"] <= tol if tol < BUDGET_DELTA
              else res["share_above_budget"] <= BUDGET_SHARE)
        phase("kernel_vs_plain", case=name,
              frame=f"{cfg.width}x{cfg.height} spp{cfg.spp} d{cfg.depth} "
                    f"{cfg.rng_mode} {cfg.scatter_mode}",
              tolerance=(f"max |d| <= {tol}" if tol < BUDGET_DELTA else
                         f"share |d| > {BUDGET_DELTA} <= {BUDGET_SHARE}"),
              ok=ok, **res)
        if not ok:
            fail(f"kernel disagrees with the plain version on {name}")

    # -- phase 2b: K3 vs its plain version on the same CUDA tensors
    _, c3_scene, c3_cam, c3_target, _ = optim.inverse_render_problem(
        CONFIG3, device=dev)
    cfg_par = RenderConfig(width=200, height=100, spp=4, depth=8,
                           rng_mode="parallel")
    cfg_v1 = REFERENCE_V1.replace(width=160, height=120)
    # the plain adjoint keeps every bounce's residuals of the whole frame:
    # at 60 spp REFERENCE_V2 would need ~90 GB, so the spp is cut to 2
    cfg_rv2 = REFERENCE_V2.replace(spp=2)
    vjp_cases = [
        ("config3", CONFIG3, c3_scene, c3_cam, 0.0, c3_target),
        ("config3_vis_w", CONFIG3, c3_scene, c3_cam, VIS_W, c3_target),
        ("test_world_parallel", cfg_par, rt.test_world(device=dev),
         v2_cam(cfg_par), 0.0, None),
        ("reference_v1_160x120", cfg_v1, rt.v1_world(device=dev),
         rt.reference_camera_v1(device=dev), 0.0, None),
        ("unaligned_50x21", cfg_odd, rt.config1_world(device=dev), odd_cam,
         0.0, None),
        ("random_world_reference_v2_spp2", cfg_rv2,
         rt.random_world(device=dev),
         rt.reference_camera_v2(cfg_rv2.aspect, device=dev), 0.0, None),
    ]
    k3_worst_rel, k3_worst_abs = 0.0, 0.0
    for name, cfg, scene, cam, vis_w, target in vjp_cases:
        img = megakernel.launch(megakernel.pack_camera(cam),
                                megakernel.pack_scene(scene), cfg)
        if target is None:  # a fixed target from a seed
            gen = torch.Generator().manual_seed(7)
            target = torch.rand(img.shape, generator=gen).to(dev)
        ct = 2.0 * (img - target) / img.numel()
        got = gradkernel.render_vjp(scene, cam, cfg, ct, vis_w=vis_w)
        t1 = time.perf_counter()
        want = gradkernel.render_vjp_plain(
            scene, cam, cfg.replace(chunk_pixels=PLAIN_CHUNK), ct, vis_w)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t1
        rel, abs_err = leaf_errors(got, want, rt.Camera._fields)
        worst_leaf = max(rel, key=rel.get)
        again = gradkernel.render_vjp_plain(
            scene, cam, cfg.replace(chunk_pixels=PLAIN_CHUNK), ct, vis_w)
        self_rel, _ = leaf_errors(again, want, rt.Camera._fields)
        del again
        row = {"case": name,
               "frame": f"{cfg.width}x{cfg.height} spp{cfg.spp} d{cfg.depth} "
                        f"{cfg.rng_mode} {cfg.scatter_mode}",
               "spheres": scene.count, "vis_w": vis_w,
               "img_bit_equal_k1a": bool(torch.equal(got[0], img)),
               "img_max_abs_vs_plain": float((got[0] - want[0]).abs().max()),
               "rel_err": rel, "worst_leaf": worst_leaf,
               "budget": GRAD_BUDGET, "plain_s": plain_s,
               "plain_vs_plain_worst": max(self_rel.values())}
        if cfg.rng_mode == "parallel":  # PASS 1 elided: bit-equal grads
            elided = gradkernel.render_vjp(scene, cam, cfg, ct, img=img,
                                           vis_w=vis_w)
            row["pass1_elision_bit_equal"] = all(
                torch.equal(a, b) for a, b in
                zip((got[0], *[getattr(got[1], k) for k in
                               ("center", "radius", "albedo", "mat_param")],
                     *got[2]),
                    (elided[0], *[getattr(elided[1], k) for k in
                                  ("center", "radius", "albedo",
                                   "mat_param")], *elided[2])))
        ok = (row["img_bit_equal_k1a"] and rel[worst_leaf] <= GRAD_BUDGET
              and row.get("pass1_elision_bit_equal", True))
        phase("vjp_kernel_vs_plain", ok=ok, **row)
        if not ok:
            fail(f"K3 disagrees with its plain version on {name}")
        k3_worst_rel = max(k3_worst_rel, rel[worst_leaf])
        k3_worst_abs = max(k3_worst_abs, abs_err)
        del got, want

    # -- phase 2c: finite differences on the card, through the CLI
    cmd = [sys.executable, "-m", "raytpu_torch.cli", "gradcheck",
           "--device", "cuda"]
    proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    try:
        result = json.loads(proc.stdout.strip().splitlines()[-1])
    except (IndexError, json.JSONDecodeError):
        result = {}
    phase("gradcheck", command=" ".join(cmd[1:]), rc=proc.returncode,
          result=result)
    if proc.returncode != 0 or result.get("pass") is not True:
        fail(f"gradcheck --device cuda: rc {proc.returncode}, "
             f"{proc.stdout[-1000:]} {proc.stderr[-2000:]}")

    # -- phase 3: the forward path, through the entry points a user calls
    cfg = REFERENCE_V2
    scene = rt.random_world(device=dev)
    cam = rt.reference_camera_v2(cfg.aspect, device=dev)
    megakernel.launches = 0
    gradkernel.launches = 0
    img = rt.render(scene, cam, cfg, backend="auto")
    torch.cuda.synchronize()
    fwd_launches = (megakernel.launches, gradkernel.launches)
    band = (0.45, 0.75)  # mean of this frame (plain version, 128x72 4 spp: 0.61)
    mean = float(img.mean())
    share_over_1 = float((img > 1).float().mean())
    phase("main_path", frame="1024x576 spp60 d50 random_world",
          spheres=scene.count, launches=fwd_launches[0],
          vjp_launches=fwd_launches[1], mean=mean, mean_band=band,
          min=float(img.min()), max=float(img.max()),
          share_above_1=share_over_1)
    if fwd_launches != (1, 0):
        fail(f"render(backend='auto') on CUDA tensors made {fwd_launches} "
             "(K1a, K3) launches, want (1, 0)")
    if tuple(img.shape) != (cfg.height, cfg.width, 3) or not img.is_cuda:
        fail(f"main path image has shape {tuple(img.shape)} on {img.device}")
    if not bool(torch.isfinite(img).all()) or float(img.min()) < 0:
        fail("main path image has non-finite or negative values")
    # random_world's metals have albedo > 1 (the reference's quirk), so a
    # few pixels may exceed 1; a broad share means broken radiance
    if share_over_1 > 0.05 or not band[0] <= mean <= band[1]:
        fail(f"main path image implausible: mean {mean}, "
             f"share > 1 {share_over_1}")

    with tempfile.TemporaryDirectory() as tmp:
        png = os.path.join(tmp, "reference_v2.png")
        cmd = [sys.executable, "-m", "raytpu_torch.cli", "render",
               "--scene", "random", "--width", str(cfg.width),
               "--height", str(cfg.height), "--spp", str(cfg.spp),
               "--depth", str(cfg.depth), "--device", "cuda", "--out", png]
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=600)
        if proc.returncode != 0:
            fail(f"CLI exited {proc.returncode}: {proc.stderr[-2000:]}")
        with open(png, "rb") as f:
            data = f.read()
        w, h = int.from_bytes(data[16:20], "big"), int.from_bytes(data[20:24],
                                                                   "big")
        if data[:8] != b"\x89PNG\r\n\x1a\n" or (w, h) != (cfg.width,
                                                          cfg.height):
            fail(f"CLI wrote no {cfg.width}x{cfg.height} PNG")
        # the CLI renders the same scene and camera: the files must agree
        ref = os.path.join(tmp, "in_process.png")
        io.save_png(ref, img.cpu().numpy())
        with open(ref, "rb") as f:
            same = f.read() == data
        phase("cli", command=" ".join(cmd[1:4] + cmd[4:-1]),
              stdout=proc.stdout.strip(), png=f"{w}x{h}",
              identical_to_render=same)
        if not same:
            fail("the CLI's PNG differs from render()'s image")

    # -- phase 3b: the gradient path at full CONFIG3, the config-3 problem
    cfg = CONFIG3
    truth, scene0, cam3, target3, loss_fn = optim.inverse_render_problem(
        cfg, device=dev, vis_w=VIS_W)
    megakernel.launches = 0
    gradkernel.launches = 0
    loss, img, (sg, cg) = rt.render_grad(scene0, cam3, cfg, target3,
                                         vis_w=VIS_W)
    torch.cuda.synchronize()
    per_step = []

    def count_step(step, _loss):
        per_step.append((megakernel.launches, gradkernel.launches))

    params, losses = optim.optimize(loss_fn, {"center": scene0.center[1]},
                                    steps=ADAM_STEPS, lr=ADAM_LR,
                                    callback=count_step)
    torch.cuda.synchronize()
    grad_launches = (megakernel.launches, gradkernel.launches)
    grads = [sg.center, sg.radius, sg.albedo, sg.mat_param, *cg]
    err0 = float((scene0.center[1] - truth.center[1]).norm())
    err1 = float((params["center"] - truth.center[1]).norm())
    phase("gradient_path", frame=f"{cfg.width}x{cfg.height} spp{cfg.spp} "
          f"d{cfg.depth} {cfg.rng_mode}", vis_w=VIS_W,
          render_grad_loss=float(loss), hero_center_grad=sg.center[1].tolist(),
          adam_lr=ADAM_LR, losses=losses, center_err_before=err0,
          center_err_after=err1, launches_k1a=grad_launches[0],
          launches_k3=grad_launches[1])
    want_counts = [(2 + i, 2 + i) for i in range(ADAM_STEPS)]
    if per_step != want_counts:
        fail(f"launch counts per step {per_step}, want {want_counts}: "
             "each step must run K1a once and K3 once")
    if not all(bool(torch.isfinite(g).all()) for g in grads):
        fail("render_grad returned non-finite gradients")
    if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
        fail(f"the Adam losses are not finite and falling: {losses}")

    # -- phase 4: K1a times (CUDA events, after a warm-up call)
    timings = {}
    cfg_ref_plain = REFERENCE_V2.replace(spp=2, chunk_pixels=PLAIN_CHUNK)
    for label, cfg_t, scene_t, cam_t, iters_k, iters_p in (
            ("config2", CONFIG2, rt.config2_world(device=dev),
             v2_cam(CONFIG2), 20, 2),
            ("reference_v2", REFERENCE_V2, scene, cam, 5, None),
            ("reference_v2_spp2", cfg_ref_plain, scene, cam, 5, 1)):
        cp, sp = megakernel.pack_camera(cam_t), megakernel.pack_scene(scene_t)
        rays = cfg_t.width * cfg_t.height * cfg_t.spp
        row = {"frame": f"{cfg_t.width}x{cfg_t.height} spp{cfg_t.spp} "
                        f"d{cfg_t.depth}", "card": card}
        ms = cuda_ms(lambda: megakernel.launch(cp, sp, cfg_t), iters_k)
        row.update(kernel_ms=ms, kernel_mrays_s=rays / ms / 1e3)
        if iters_p:
            pms = cuda_ms(lambda: golden.render_golden(
                scene_t, cam_t, cfg_t.replace(chunk_pixels=PLAIN_CHUNK)),
                iters_p)
            row.update(plain_ms=pms, plain_mrays_s=rays / pms / 1e3)
        timings[label] = row
        phase("timing", case=label, **row)

    # -- phase 4b: fwd+bwd (render_grad: K1a + K3) and K3 alone, beside
    # the plain versions (render_grad on the adjoint; the adjoint's VJP)
    c2_target = torch.full((CONFIG2.height, CONFIG2.width, 3), 0.5,
                           device=dev)
    rv2_target = torch.full((REFERENCE_V2.height, REFERENCE_V2.width, 3),
                            0.5, device=dev)
    cfg_c2p = CONFIG2.replace(rng_mode="parallel")
    c2_scene, c2_cam = rt.config2_world(device=dev), v2_cam(CONFIG2)
    grad_timings = {}
    for label, cfg_t, scene_t, cam_t, tgt, vis_w, iters, iters_p in (
            ("config3", CONFIG3, scene0, cam3, target3, 0.0, 10, 1),
            ("config3_vis_w", CONFIG3, scene0, cam3, target3, VIS_W, 10, 1),
            ("config2_parallel", cfg_c2p, c2_scene, c2_cam, c2_target, 0.0,
             10, 1),
            ("reference_v2_spp2", cfg_rv2, scene, cam, rv2_target, 0.0, 3,
             1),
            ("reference_v2", REFERENCE_V2, scene, cam, rv2_target, 0.0, 3,
             None)):
        rays = cfg_t.width * cfg_t.height * cfg_t.spp
        row = {"frame": f"{cfg_t.width}x{cfg_t.height} spp{cfg_t.spp} "
                        f"d{cfg_t.depth} {cfg_t.rng_mode}",
               "vis_w": vis_w, "card": card}
        fb = cuda_ms(lambda: rt.render_grad(scene_t, cam_t, cfg_t, tgt,
                                            vis_w=vis_w), iters)
        cp, sp = megakernel.pack_camera(cam_t), megakernel.pack_scene(scene_t)
        img_t = megakernel.launch(cp, sp, cfg_t)
        ct = 2.0 * (img_t - tgt) / img_t.numel()
        # the backward as render_grad runs it: parallel RNG elides PASS 1
        img_arg = img_t if cfg_t.rng_mode == "parallel" else None
        k3 = cuda_ms(lambda: gradkernel.launch(cp, sp, cfg_t, ct, img_arg,
                                               vis_w), iters)
        row.update(fwd_bwd_ms=fb, fwd_bwd_mrays_s=rays / fb / 1e3,
                   k3_ms=k3, k3_mrays_s=rays / k3 / 1e3)
        if iters_p:
            cfg_p = cfg_t.replace(chunk_pixels=PLAIN_CHUNK)
            pfb = cuda_ms(lambda: rt.render_grad(
                scene_t, cam_t, cfg_p, tgt, backend="golden", vis_w=vis_w),
                iters_p)
            pk3 = cuda_ms(lambda: gradkernel.render_vjp_plain(
                scene_t, cam_t, cfg_p, ct, vis_w), iters_p)
            row.update(plain_fwd_bwd_ms=pfb, plain_vjp_ms=pk3,
                       plain_vjp_mrays_s=rays / pk3 / 1e3)
        grad_timings[label] = row
        phase("grad_timing", case=label, **row)

    print(json.dumps({"kernels": [{
        "name": "render_fwd_kernel",
        "route": "cuda",
        "source": "raytpu_torch/csrc/megakernel.cu",
        "replaces": "raytpu/kernels/megakernel.py:1456",
        "launches": grad_launches[0],
        "launches_forward_path": fwd_launches[0],
        "max_abs_err": worst,
        "ms": timings["config2"]["kernel_ms"],
        "plain_ms": timings["config2"]["plain_ms"],
    }, {
        "name": "render_vjp_kernel",
        "route": "cuda",
        "source": "raytpu_torch/csrc/gradkernel.cu",
        "replaces": "raytpu/kernels/gradkernel.py:1519",
        "launches": grad_launches[1],
        "max_abs_err": k3_worst_abs,
        "max_rel_err": k3_worst_rel,
        "ms": grad_timings["config3_vis_w"]["k3_ms"],
        "plain_ms": grad_timings["config3_vis_w"]["plain_vjp_ms"],
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
