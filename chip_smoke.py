"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Needs a CUDA card and nvcc; builds the port's CUDA kernel from
``raytpu_torch/csrc/`` and drives ``raytpu_torch``'s forward render, the
package's main path.  It imports nothing of JAX or of ``raytpu``.  Phases,
one line each:

1. setup: the card (nvidia-smi name and power limit) and the kernel build;
2. the kernel against its plain PyTorch version on the card, case by case;
3. the main path: ``raytpu_torch.render`` at the full REFERENCE_V2 frame
   (1024x576, 60 spp, depth 50, random_world) with the launch counter
   checked, then the same frame through the CLI in a subprocess;
4. times from CUDA events, kernel and plain version.

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

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
BUDGET_DELTA = 3e-4    # cross-context image budget (post-gamma)
BUDGET_SHARE = 1e-3    # share of pixels allowed above it (path flips)
DEPTH1_TOL = 1e-6      # depth-1 spp-1: jitter, primary hit and sky only
PLAIN_CHUNK = 1 << 16  # plain version's pixels per chunk on the card


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


def main() -> None:
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs a card")
    sys.path.insert(0, ROOT)
    import raytpu_torch as rt
    from raytpu_torch import golden, io
    from raytpu_torch.config import CONFIG2, REFERENCE_V1, REFERENCE_V2, \
        RenderConfig
    from raytpu_torch.kernels import _build, megakernel

    dev = torch.device("cuda", 0)
    card = card_line()
    phase("setup", card=card, torch=torch.__version__,
          cuda=torch.version.cuda, capability=torch.cuda.get_device_capability(0))
    t0 = time.perf_counter()
    _build.load(megakernel.SOURCE)
    info = _build.build_log[megakernel.SOURCE]
    phase("build", seconds=time.perf_counter() - t0, ptxas=info["ptxas"])

    # -- phase 2: kernel vs plain version on the card
    def v2_cam(cfg):
        return rt.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0,
                              aspect=cfg.aspect, device=dev)

    cfg_ref2 = REFERENCE_V2.replace(spp=2)
    cfg_odd = RenderConfig(width=50, height=21, spp=4, depth=12)
    cases = [
        ("config2", CONFIG2, rt.config2_world(device=dev), v2_cam(CONFIG2),
         BUDGET_DELTA),
        ("reference_v2_spp2", cfg_ref2, rt.random_world(device=dev),
         rt.reference_camera_v2(cfg_ref2.aspect, device=dev), BUDGET_DELTA),
        ("reference_v1", REFERENCE_V1, rt.v1_world(device=dev),
         rt.reference_camera_v1(device=dev), BUDGET_DELTA),
        ("config2_parallel", CONFIG2.replace(rng_mode="parallel"),
         rt.config2_world(device=dev), v2_cam(CONFIG2), BUDGET_DELTA),
        ("unaligned_50x21", cfg_odd, rt.config1_world(device=dev),
         rt.make_camera((0.0, 0.2, 1.0), (0.0, 0.0, -1.0), vfov=60.0,
                        aspect=cfg_odd.aspect, device=dev), BUDGET_DELTA),
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

    # -- phase 3: the main path, through the entry points a user calls
    cfg = REFERENCE_V2
    scene = rt.random_world(device=dev)
    cam = rt.reference_camera_v2(cfg.aspect, device=dev)
    megakernel.launches = 0
    img = rt.render(scene, cam, cfg, backend="auto")
    torch.cuda.synchronize()
    main_launches = megakernel.launches
    band = (0.45, 0.75)  # mean of this frame (plain version, 128x72 4 spp: 0.61)
    mean = float(img.mean())
    share_over_1 = float((img > 1).float().mean())
    phase("main_path", frame="1024x576 spp60 d50 random_world",
          spheres=scene.count, launches=main_launches, mean=mean,
          mean_band=band, min=float(img.min()), max=float(img.max()),
          share_above_1=share_over_1)
    if main_launches < 1:
        fail("render(backend='auto') on CUDA tensors launched no kernel")
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

    # -- phase 4: times (CUDA events, after a warm-up call)
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

    print(json.dumps({"kernels": [{
        "name": "render_fwd_kernel",
        "route": "cuda",
        "source": "raytpu_torch/csrc/megakernel.cu",
        "replaces": "raytpu/kernels/megakernel.py:1456",
        "launches": main_launches,
        "max_abs_err": worst,
        "ms": timings["config2"]["kernel_ms"],
        "plain_ms": timings["config2"]["plain_ms"],
    }]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
