"""Compare the machine code (SASS) of two builds of the port's kernels.

    python3 sass_diff.py OTHER_ROOT

builds (or finds) the kernel libraries of the checkout that holds this
script and of the checkout at ``OTHER_ROOT`` (for example an earlier
commit unpacked with ``git archive``), disassembles both with ``cuobjdump -sass`` and prints, for each
kernel instantiation of the other build, its instruction count in both and
whether the instructions are the same; it exits 1 if any differs.  Where
a checkout's census kernel counts the flat sweep's warps
(``megakernel.warp_census``), it then prints that checkout's loop and
sweep efficiencies on config 5's 50-spp batch frame, on its train step's
1080-row slab (20 spp, parallel RNG) and on config 4 at 2 spp.
Kernel-parameter offsets (``c[0x0][...]``) are masked: a parameter struct
that grew moves them without changing the code.  A first template argument
that was a bool (``kBvh`` before the walk: 0 brute, 1 flat) is matched to
the closest-hit policy that replaced it, so a checkout from before the walk
compares too.  Needs the CUDA toolkit (``nvcc``, ``cuobjdump``).
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
from pathlib import Path

from raytpu_torch.kernels import _build  # this checkout's: sys.path[0]

ROOT = Path(__file__).resolve().parent
SOURCES = ("megakernel.cu", "gradkernel.cu", "wavefront.cu")
# builds a checkout's kernels and prints their libraries' paths
_BUILD = ("import json; from raytpu_torch.kernels import _build; "
          f"_build.load_all({list(SOURCES)!r}); "
          "print(json.dumps({s: v['path'] for s, v in "
          "_build.build_log.items()}))")
# a checkout's flat-sweep warp efficiencies (JSON), or null where its census
# kernel does not count warps
_WARPS = """
import json, raytpu_torch as rt
from raytpu_torch import bvh as tbvh
from raytpu_torch.config import CONFIG4, CONFIG5
from raytpu_torch.kernels import megakernel as mk
out = None
if hasattr(mk, "warp_census"):
    scene = rt.final_world(device="cuda")
    bvh = rt.build_bvh(scene, leaf_size=64)
    sp = mk.pack_scene(tbvh.permute_scene(scene, bvh.perm))
    out = {}
    for name, cfg, rows in (
            ("config5_batch", CONFIG5.replace(spp=50), None),
            ("config5_slab", CONFIG5.replace(spp=20, rng_mode="parallel"),
             1080),
            ("config4_spp2", CONFIG4.replace(spp=2), None)):
        cam = rt.make_camera((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), vfov=20.0,
                             aspect=cfg.aspect, device="cuda")
        c = mk.warp_census(mk.pack_camera(cam), sp, cfg, bvh, 0, rows)
        out[name] = {k: c[k] for k in ("loop_efficiency",
                                       "sweep_efficiency")}
print(json.dumps(out))
"""


def functions(lib: Path) -> dict:
    """{(kernel, template args): [instructions]} of a built library."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, check=True).stdout
    res, name = {}, None
    for ln in out.splitlines():
        m = re.search(r"Function : \S*?(render_\w+?_kernel)I(\w+?)EEvNS", ln)
        if m:
            name = (m.group(1), re.sub(r"^Lb([01])", r"Li\1", m.group(2)))
            res[name] = []
        elif name is not None:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?);", ln)
            if m:
                ins = re.sub(r"c\[0x0\]\[0x[0-9a-f]+\]", "c[0x0][P]",
                             m.group(1))
                res[name].append(" ".join(ins.split()))
    return res


def main(other_root: str) -> int:
    roots = (Path(other_root).resolve(), ROOT)
    libs = [json.loads(subprocess.run(
        [sys.executable, "-c", _BUILD], cwd=root, capture_output=True,
        text=True, check=True).stdout.splitlines()[-1]) for root in roots]
    differ = 0
    for src in SOURCES:
        old, new = (functions(Path(paths[src])) for paths in libs)
        for key, ins in sorted(old.items()):
            got = new.get(key)
            same = got == ins
            differ += not same
            print(f"{src} {key[0]}<{key[1]}>: {len(ins)} -> "
                  f"{None if got is None else len(got)} instructions, "
                  f"{'identical' if same else 'DIFFERENT'}")
        print(f"{src} new: "
              f"{sorted(f'{k[0]}<{k[1]}>' for k in set(new) - set(old))}")
    for root in roots:
        warps = subprocess.run([sys.executable, "-c", _WARPS], cwd=root,
                               capture_output=True, text=True, check=True)
        print(f"warp efficiencies {root}: "
              f"{warps.stdout.strip().splitlines()[-1]}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
