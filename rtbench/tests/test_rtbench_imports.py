"""Nothing that runs on the card loads JAX or the JAX package: in a fresh
process the harness's modules and a whole CPU run of a cell leave no
module whose top-level name, compared whole, is ``jax``, ``jaxlib``,
``flax`` or ``raytpu`` (``raytpu_torch`` is the program and passes)."""

import json
import os
import subprocess
import sys
import types

from rtbench import core

SCRIPT = r"""
import json, sys, time
sys.path.insert(0, {repo!r})
sys.path.insert(0, {tests!r})
import rtbench.run, rtbench.control
from rtbench import core
from conftest import run_tiny, tiny_cell
spec = json.load(open({spec!r}))
for m in spec["end_to_end"] + spec["per_layer"]:
    core.reader(m["name"])
run_tiny(tiny_cell("ref_v2.frames"))
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def test_no_jax_in_a_fresh_process():
    tests = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT.format(
            repo=str(core.REPO), tests=tests,
            spec=str(core.REPO / "BENCHMARK.json"))],
        capture_output=True, text=True, env=env, timeout=600, check=True)
    top = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "raytpu_torch" in top and "rtbench" in top
    assert not top & set(core.FORBIDDEN), top & set(core.FORBIDDEN)


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "raytpu_torch_extra",
                        types.ModuleType("raytpu_torch_extra"))
    monkeypatch.setitem(sys.modules, "jaxlike", types.ModuleType("jaxlike"))
    assert core.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "raytpu.render",
                        types.ModuleType("raytpu.render"))
    assert core.forbidden_modules() == ["raytpu"]
