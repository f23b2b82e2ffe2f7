"""The port's tools on the CPU against raytpu's: scene files
(raytpu_torch.scene_io), the debug tools (raytpu_torch.debug), the CLI's
``render --scene-file`` / ``--log``, ``validate`` and ``info``, and the
profiler hooks.

Scene files cross both packages both ways with arrays equal and the files
byte-equal; bad files raise raytpu's errors.  ``validate_scene`` gives
raytpu's strings.  ``checked_render`` raises where raytpu's checkify float
checks raise and returns the plain render's image bit for bit otherwise.
"""

import json

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import raytpu
from raytpu import debug as jdebug, scene_io as jscene_io
from raytpu.config import RenderConfig
import raytpu_torch as rt
from raytpu_torch import cli, convert, debug, profiling, scene_io

SMALL = ["--width", "32", "--height", "16", "--spp", "1", "--depth", "3"]


def _np(nt):
    return {k: np.asarray(v) for k, v in nt._asdict().items()}


def _port(scene_j):
    return convert.scene_from_numpy(_np(scene_j), "cpu")


def _assert_same_scene(got, want):
    for k in ("center", "radius", "mat_type", "albedo", "mat_param"):
        np.testing.assert_array_equal(getattr(got, k).numpy(),
                                      np.asarray(getattr(want, k)), err_msg=k)


@pytest.mark.parametrize("name", ["test_world", "random_world",
                                  "final_world"])
def test_scene_files_cross_both_packages(tmp_path, name):
    """save_scene in either package, load_scene in the other: equal
    arrays, the same bytes on disk, and dicts that round-trip."""
    scene_j = getattr(raytpu, name)()
    scene = _port(scene_j)
    ours, theirs = tmp_path / "ours.json", tmp_path / "theirs.json"
    scene_io.save_scene(str(ours), scene)
    jscene_io.save_scene(str(theirs), scene_j)
    assert ours.read_bytes() == theirs.read_bytes()
    _assert_same_scene(scene_io.load_scene(str(theirs), device="cpu"),
                       scene_j)
    back = jscene_io.load_scene(str(ours))
    _assert_same_scene(scene, back)
    _assert_same_scene(scene_io.scene_from_dict(
        scene_io.scene_to_dict(scene), device="cpu"), scene_j)


def test_bad_scene_files_raise_raytpus_errors(tmp_path):
    """An unknown material and a file with no spheres raise raytpu's
    ValueErrors; missing albedo and param take raytpu's defaults."""
    bad = {"spheres": [{"center": [0, 0, 0], "radius": 1.0,
                        "material": "glass"}]}
    for d in (bad, {"spheres": []}):
        with pytest.raises(ValueError) as want:
            jscene_io.scene_from_dict(d)
        with pytest.raises(ValueError) as got:
            scene_io.scene_from_dict(d, device="cpu")
        assert str(got.value) == str(want.value)
    d = {"spheres": [{"center": [1, 2, 3], "radius": 0.5}], "note": "x"}
    _assert_same_scene(scene_io.scene_from_dict(d, device="cpu"),
                       jscene_io.scene_from_dict(d))


def test_validate_scene_gives_raytpus_strings():
    scene_j = raytpu.random_world(seed=0)  # metal albedo in [1, 1.5]
    assert debug.validate_scene(_port(scene_j)) == \
        jdebug.validate_scene(scene_j)
    assert debug.validate_scene(_port(raytpu.test_world())) == []
    t = raytpu.test_world()
    broken = t._replace(
        center=t.center.at[1, 0].set(jnp.nan),
        radius=t.radius.at[0].set(0.0),
        mat_type=t.mat_type.at[1].set(7),
        albedo=t.albedo.at[2, 1].set(-0.5),
        mat_param=t.mat_param.at[3].set(0.0))
    want = jdebug.validate_scene(broken)
    assert len(want) == 5
    assert debug.validate_scene(_port(broken)) == want


@pytest.mark.parametrize("field", ["albedo", "center", "mat_param"])
def test_checked_render_raises_where_raytpu_does(field):
    """A NaN in a visible sphere's albedo, centre or mat_param: raytpu's
    checkify render raises, and so does the port's, naming the bounce and a
    pixel; test_world renders clean, equal to render()."""
    cfg = RenderConfig(width=24, height=12, spp=1, depth=3)
    cam_j = raytpu.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0,
                               aspect=cfg.aspect)
    cam = convert.camera_from_numpy(_np(cam_j), "cpu")
    scene_j = raytpu.test_world()
    arr = getattr(scene_j, field)
    bad_j = scene_j._replace(**{field: arr.at[2].set(jnp.nan)})
    with pytest.raises(Exception):
        jdebug.checked_render(bad_j, cam_j, cfg)
    with pytest.raises(FloatingPointError, match=r"bounce 0, pixel \("):
        debug.checked_render(_port(bad_j), cam, cfg)
    scene = _port(scene_j)
    assert torch.equal(debug.checked_render(scene, cam, cfg),
                       rt.render(scene, cam, cfg))


def test_validate_backends_on_the_cpu():
    """On the CPU: the plain version's image is finite, and a BVH's sweep
    (flat here, the walk for an unpadded BVH) gives the brute image."""
    cfg = RenderConfig(width=24, height=12, spp=1, depth=3)
    scene = rt.final_world(n=48, device="cpu")
    cam = rt.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0,
                         aspect=cfg.aspect, device="cpu")
    rep = debug.validate_backends(scene, cam, cfg)
    assert rep == {"device": "cpu", "sweep": "brute", "plain_finite": True}
    for pad, sweep in ((True, "flat"), (False, "walk")):
        rep = debug.validate_backends(scene, cam, cfg, bvh=rt.build_bvh(
            scene, leaf_size=8, pad_leaves=pad))
        assert rep["sweep"] == sweep and rep["bvh_matches_brute"] is True
        assert rep["bvh_pixels_differ_brute"] == 0


def test_cli_scene_file_and_log(tmp_path):
    """render --scene-file writes the PNG --scene writes for the same
    scene; --log appends one JSON line a run, naming the device; --log
    with --progressive is refused."""
    path = tmp_path / "final.json"
    scene_io.save_scene(str(path), rt.final_world(device="cpu"))
    log = tmp_path / "runs.jsonl"
    a, b = tmp_path / "a.png", tmp_path / "b.png"
    assert cli.main(["render", "--scene", "final", "--bvh", *SMALL,
                     "--device", "cpu", "--out", str(a)]) == 0
    for _ in range(2):
        assert cli.main(["render", "--scene-file", str(path), "--bvh",
                         *SMALL, "--device", "cpu", "--log", str(log),
                         "--out", str(b)]) == 0
    assert a.read_bytes() == b.read_bytes()
    lines = [json.loads(x) for x in log.read_text().splitlines()]
    assert len(lines) == 2
    assert lines[0]["device"] == "cpu" and lines[0]["scene"] == str(path)
    assert lines[0]["config"] == "32x16 spp1 d3" and lines[0]["wall_s"] > 0
    assert lines[0]["sweep"] == "flat" and lines[0]["primary_rays"] == 512
    with pytest.raises(SystemExit) as e:
        cli.main(["render", *SMALL, "--device", "cpu", "--progressive", "1",
                  "--log", str(log), "--out", str(b)])
    assert e.value.code == 2 and len(log.read_text().splitlines()) == 2


def test_cli_validate_scene_file_and_info(tmp_path, capsys):
    """validate --scene-file --bvh --device cpu on a scene of 300 spheres
    (leaf 64: the flat sweep) exits 0 with its report; info prints its
    JSON."""
    path = tmp_path / "s.json"
    scene_io.save_scene(str(path), rt.final_world(n=300, device="cpu"))
    assert cli.main(["validate", "--scene-file", str(path), "--bvh",
                     "--width", "24", "--height", "12", "--device",
                     "cpu"]) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["pass"] and rep["sweep"] == "flat"
    assert rep["bvh_matches_brute"] and rep["plain_finite"]
    assert isinstance(rep["scene_warnings"], list)
    assert cli.main(["info"]) == 0
    info = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(info) >= {"version", "torch", "platform", "devices",
                         "device_kind"}
    assert info["torch"] == torch.__version__


def test_profiler_hooks_on_the_cpu(tmp_path):
    """trace() writes a Chrome trace of the block; device_ms() needs a card
    and says so on the CPU rather than timing the host."""
    with profiling.trace(str(tmp_path / "tr")):
        torch.ones(64).sum()
    trace = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert trace["traceEvents"]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            profiling.device_ms(lambda: torch.ones(8).sum())


def test_device_events_needs_a_card():
    """device_events() (raytpu's per-event list) says on the CPU that it
    needs a card, as device_ms() does, and runs nothing there."""
    calls = []
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device_events needs a CUDA"):
            profiling.device_events(lambda: calls.append(1))
        assert not calls
