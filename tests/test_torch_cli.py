"""raytpu_torch's CLI, image writers and timing helper on the CPU."""

import json
import os
import struct
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

from raytpu import io as jio
import raytpu_torch as rt
from raytpu_torch import cli, io, profiling, progressive
from raytpu_torch.config import RenderConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--width", "32", "--height", "16", "--spp", "1", "--depth", "3"]


def _read_png(path):
    """(width, height, rows) of an 8-bit RGB PNG written by io.save_png."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", data[16:24])
    idat_len = struct.unpack(">I", data[33:37])[0]
    raw = zlib.decompress(data[41:41 + idat_len])
    rows = np.frombuffer(raw, np.uint8).reshape(h, 1 + 3 * w)[:, 1:]
    return w, h, rows.reshape(h, w, 3)


def test_cli_render_writes_the_rendered_png(tmp_path):
    out = tmp_path / "frame.png"
    assert cli.main(["render", "--scene", "test", *SMALL, "--device", "cpu",
                     "--out", str(out)]) == 0
    w, h, pix = _read_png(out)
    assert (w, h) == (32, 16)
    cfg = RenderConfig(width=32, height=16, spp=1, depth=3)
    img = rt.render(rt.test_world(device="cpu"),
                    rt.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0),
                                   vfov=20.0, aspect=cfg.aspect,
                                   device="cpu"), cfg)
    np.testing.assert_array_equal(pix, io.to_uint8(img.numpy()))


@pytest.mark.parametrize("scene", ["config1", "v1"])
def test_cli_render_other_scenes_and_modes(tmp_path, scene):
    out = tmp_path / "frame.ppm"
    assert cli.main(["render", "--scene", scene, *SMALL, "--device", "cpu",
                     "--rng-mode", "parallel", "--scatter-mode", "v1",
                     "--aperture", "0.1", "--focus-dist", "10",
                     "--out", str(out)]) == 0
    assert out.read_bytes().startswith(b"P6\n32 16\n255\n")


@pytest.mark.parametrize("flag", [["--bvh"], ["--progressive", "4"],
                                  ["--devices", "2"]],
                         ids=["bvh", "progressive", "devices"])
def test_cli_refuses_unported_options(tmp_path, flag):
    """Options once refused, now ported.  --bvh writes the image
    render(..., bvh=build_bvh(scene)) gives, with either builder;
    --bvh-builder without --bvh refuses.  --progressive (with --checkpoint
    and --resume) writes the one-shot render's image, also when resumed
    from its checkpoint.  --devices N outside a torchrun launch of N
    processes exits naming the launch, and renders nothing."""
    out = tmp_path / "never.png"
    cfg = RenderConfig(width=32, height=16, spp=1, depth=3)
    if flag == ["--bvh"]:
        for builder in ("median", "sah"):
            assert cli.main(["render", "--scene", "final", *SMALL,
                             "--device", "cpu", "--bvh", "--bvh-builder",
                             builder, "--out", str(out)]) == 0
            scene = rt.final_world(device="cpu")
            img = rt.render(scene, rt.make_camera(
                (13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0,
                aspect=cfg.aspect, device="cpu"), cfg,
                bvh=rt.build_bvh(scene, builder=builder))
            np.testing.assert_array_equal(_read_png(out)[2],
                                          io.to_uint8(img.numpy()))
        with pytest.raises(SystemExit, match="--bvh-builder needs --bvh"):
            cli.main(["render", *SMALL, "--device", "cpu", "--bvh-builder",
                      "sah", "--out", str(tmp_path / "never2.png")])
        return
    if flag[0] == "--progressive":
        cfg = cfg.replace(spp=5)
        ck = tmp_path / "ck.npz"
        args = ["render", "--scene", "final", "--bvh", "--width", "32",
                "--height", "16", "--spp", "5", "--depth", "3", "--device",
                "cpu", *flag, "--checkpoint", str(ck)]
        assert cli.main([*args, "--out", str(out)]) == 0
        scene = rt.final_world(device="cpu")
        img = rt.render(scene, rt.make_camera(
            (13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0, aspect=cfg.aspect,
            device="cpu"), cfg, bvh=rt.build_bvh(scene))
        want = io.to_uint8(img.numpy())
        np.testing.assert_array_equal(_read_png(out)[2], want)
        state, saved = progressive.load_checkpoint(str(ck), device="cpu")
        assert state.samples == 5 and saved == cfg
        # resumed from the completed checkpoint: nothing left to add
        again = tmp_path / "again.png"
        assert cli.main([*args, "--resume", "--out", str(again)]) == 0
        np.testing.assert_array_equal(_read_png(again)[2], want)
        return
    with pytest.raises(SystemExit, match="torchrun --nproc-per-node 2"):
        cli.main(["render", *SMALL, "--device", "cpu", *flag,
                  "--out", str(out)])
    assert not out.exists()


def test_cli_renders_the_fractsin_mode(tmp_path):
    """render --rng-mode v1_fractsin --scatter-mode v1 --gamma 2 writes
    render()'s image (the plain version under every backend), one-shot and
    with --progressive."""
    cfg = RenderConfig(width=32, height=16, spp=2, depth=3, gamma=2.0,
                       scatter_mode="v1", rng_mode="v1_fractsin")
    want = io.to_uint8(rt.render(rt.v1_world(device="cpu"), rt.make_camera(
        (13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0, aspect=cfg.aspect,
        device="cpu"), cfg).numpy())
    args = ["render", "--scene", "v1", "--width", "32", "--height", "16",
            "--spp", "2", "--depth", "3", "--rng-mode", "v1_fractsin",
            "--scatter-mode", "v1", "--gamma", "2", "--device", "cpu"]
    for extra in ([], ["--progressive", "1"], ["--backend", "cuda"]):
        out = tmp_path / "fs.png"
        assert cli.main([*args, *extra, "--out", str(out)]) == 0
        np.testing.assert_array_equal(_read_png(out)[2], want)


def test_cli_progressive_resumes_an_interrupted_render(tmp_path, capsys):
    """An interrupted progressive render (a checkpoint after 2 of 6
    samples, written by render_progressive) resumes to the uninterrupted
    image; --preview-every writes the image every K batches."""
    cfg = RenderConfig(width=32, height=16, spp=6, depth=3)
    scene = rt.test_world(device="cpu")
    cam = rt.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0,
                         aspect=cfg.aspect, device="cpu")
    ck = tmp_path / "ck.npz"
    gen = progressive.render_progressive(scene, cam, cfg, batch=2,
                                         checkpoint_path=str(ck))
    next(gen)
    gen.close()
    out = tmp_path / "out.png"
    assert cli.main(["render", "--width", "32", "--height", "16", "--spp",
                     "6", "--depth", "3", "--device", "cpu", "--progressive",
                     "2", "--checkpoint", str(ck), "--resume",
                     "--preview-every", "1", "--out", str(out)]) == 0
    err = capsys.readouterr().err
    assert "samples 4/6" in err and "samples 2/6" not in err
    assert err.count("preview @") == 2
    np.testing.assert_array_equal(_read_png(out)[2], io.to_uint8(
        rt.render(scene, cam, cfg).numpy()))


@pytest.mark.parametrize("flag", [["--refill", "2"], ["--checkpoint", "c"]],
                         ids=["refill", "checkpoint"])
def test_cli_rejects_other_raytpu_options(tmp_path, flag, capsys):
    """Usage errors (exit 2): --refill without --backend wavefront (raytpu's
    refusal of the wavefront's knobs on another backend); --checkpoint
    without --progressive would be ignored, and so are --resume without
    --checkpoint, --preview-every without --progressive and a checkpoint
    name numpy would change.  The wavefront's knobs are refused with
    --devices > 1 and with --progressive, as raytpu refuses them."""
    out = tmp_path / "never.png"
    for extra in (["--resume"], ["--preview-every", "2"],
                  ["--progressive", "2", "--checkpoint", "c"]):
        with pytest.raises(SystemExit) as e:
            cli.main(["render", *SMALL, "--device", "cpu", *extra,
                      "--out", str(out)])
        assert e.value.code == 2
    with pytest.raises(SystemExit) as e:
        cli.main(["render", *SMALL, "--device", "cpu", *flag,
                  "--out", str(out)])
    assert e.value.code == 2 and not out.exists()
    if flag[0] == "--refill":
        assert "wavefront-only knobs" in capsys.readouterr().err
        for extra in (["--devices", "2"], ["--progressive", "2"]):
            with pytest.raises(SystemExit) as e:
                cli.main(["render", *SMALL, "--device", "cpu", "--backend",
                          "wavefront", "--rng-mode", "parallel", *flag,
                          *extra, "--out", str(out)])
            assert e.value.code == 2 and not out.exists()


def test_cli_renders_the_wavefront(tmp_path):
    """render --backend wavefront --rng-mode parallel --refill 2 on the CPU
    writes the PNG of render(backend="wavefront", refill=2), byte for
    byte."""
    out = tmp_path / "wf.png"
    assert cli.main(["render", "--scene", "final", *SMALL, "--device", "cpu",
                     "--backend", "wavefront", "--rng-mode", "parallel",
                     "--refill", "2", "--out", str(out)]) == 0
    cfg = RenderConfig(width=32, height=16, spp=1, depth=3,
                       rng_mode="parallel")
    img = rt.render(rt.final_world(device="cpu"),
                    rt.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0),
                                   vfov=20.0, aspect=cfg.aspect,
                                   device="cpu"),
                    cfg, backend="wavefront", refill=2)
    ref = tmp_path / "ref.png"
    io.save_image(str(ref), img.numpy())
    assert out.read_bytes() == ref.read_bytes()


@pytest.mark.parametrize("cmd", ["gradcheck", "validate", "info"])
def test_cli_refuses_unported_subcommands(cmd, capsys):
    """Subcommands once refused, now ported.  gradcheck on the CPU passes
    (analytic vs finite difference < 1e-3); validate on the CPU checks the
    plain version (finite, and with --bvh the BVH sweep against the brute
    sweep) and exits 0 with its JSON report; info prints the platform."""
    if cmd == "gradcheck":
        assert cli.main(["gradcheck", "--device", "cpu"]) == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["pass"] is True and out["grad_max_err_vs_fd"] < 1e-3
        assert out["device"] == "cpu"
        return
    if cmd == "validate":
        assert cli.main(["validate", "--scene", "final", "--bvh", "--width",
                         "24", "--height", "12", "--device", "cpu"]) == 0
        out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert out["pass"] is True and out["plain_finite"] is True
        assert out["sweep"] == "flat" and out["bvh_matches_brute"] is True
        assert out["device"] == "cpu"
        return
    assert cli.main(["info"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["platform"] == ("gpu" if torch.cuda.is_available() else "cpu")
    assert out["version"] == rt.__version__


def test_cli_module_entry_point(tmp_path):
    out = tmp_path / "frame.png"
    proc = subprocess.run(
        [sys.executable, "-m", "raytpu_torch.cli", "render", *SMALL,
         "--device", "cpu", "--out", str(out)],
        cwd=ROOT, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    assert "on cpu" in proc.stdout and out.exists()
    out_bvh = tmp_path / "bvh.png"
    proc = subprocess.run(
        [sys.executable, "-m", "raytpu_torch.cli", "render", "--bvh",
         "--scene", "final", *SMALL, "--device", "cpu", "--out",
         str(out_bvh)], cwd=ROOT, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    assert "on cpu" in proc.stdout and out_bvh.exists()
    proc = subprocess.run(
        [sys.executable, "-m", "raytpu_torch.cli", "render", "--progressive",
         "1", *SMALL, "--device", "cpu", "--out", str(out)],
        cwd=ROOT, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    assert "samples 1/1" in proc.stderr and "wrote" in proc.stdout
    proc = subprocess.run(
        [sys.executable, "-m", "raytpu_torch.cli", "render", "--devices",
         "2", *SMALL, "--device", "cpu", "--out", str(out)],
        cwd=ROOT, capture_output=True, text=True)
    assert proc.returncode != 0 and "torchrun" in proc.stderr


def test_io_matches_raytpu(tmp_path):
    img = np.random.default_rng(0).uniform(-0.2, 1.2, (5, 7, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(io.to_uint8(img), jio.to_uint8(img))
    for ext in ("png", "ppm"):
        a, b = tmp_path / f"a.{ext}", tmp_path / f"b.{ext}"
        io.save_image(str(a), img)
        jio.save_image(str(b), img)
        assert a.read_bytes() == b.read_bytes()


def test_timed_names_the_device():
    cfg = RenderConfig(width=8, height=4, spp=3, depth=1)
    calls = []

    def fn():
        calls.append(1)
        return torch.zeros(cfg.height, cfg.width, 3)

    out, stats = profiling.timed(fn, cfg, iters=2)
    assert len(calls) == 3 and out.shape == (4, 8, 3)
    assert stats.device == "cpu" and stats.primary_rays == 96
    assert stats.wall_s > 0 and stats.rays_per_sec > 0
    assert stats.as_dict()["config"] == "8x4 spp3 d1"
