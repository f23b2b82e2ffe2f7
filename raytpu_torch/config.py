"""Render configuration (counterpart of ``raytpu/config.py``).

The reference hardcodes every knob (camera at CSVersion/DxCSApp.cpp:176-179,
resolution at :330-331, depth/spp packed in sceneValues at :133/:156).  Here
they live in one frozen, hashable dataclass, field for field the JAX
package's, so one preset means the same render in both packages.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 1024
    height: int = 576
    spp: int = 60          # samples per pixel (ref sceneValues.z)
    depth: int = 50        # max bounce depth (ref sceneValues.y)
    t_min: float = 1e-3    # ray epsilon (ref: ShaderCompute.hlsl:262)
    gamma: float = 2.2     # output gamma (ref toGamma: ShaderCompute.hlsl:99-103)
    chunk_pixels: int = 16384  # pixels per golden-renderer chunk (memory bound)
    # "v2": the compute-shader materials (normalized diffuse, sphere
    # -sample fuzz); "v1": the pixel-shader generation's materials
    # (ref: Shader_RT.fx:217-243) — hemisphere diffuse with a near-zero
    # guard, saturated fuzz on an unnormalized metal bounce
    scatter_mode: str = "v2"
    # "sequential": one seed chained through a pixel's samples (the
    # reference's inout-seed semantics, ShaderCompute.hlsl:304-310);
    # "parallel": independent per-(pixel, sample) counter streams --
    # samples are order-free, so spp folds into the batch dimension
    # (faster gradients; recommended for production)
    rng_mode: str = "sequential"

    @property
    def aspect(self) -> float:
        return self.width / self.height

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


# BASELINE.json configs
CONFIG1 = RenderConfig(width=200, height=100, spp=4, depth=4)
CONFIG2 = RenderConfig(width=400, height=200, spp=20, depth=12)
CONFIG3 = RenderConfig(width=400, height=200, spp=20, depth=12)
CONFIG4 = RenderConfig(width=800, height=400, spp=100, depth=12)
CONFIG5 = RenderConfig(width=1920, height=1080, spp=500, depth=12)
# The reference's own runs:
# v2 compute shader (ref: CSVersion/DxCSApp.cpp:133,330-331)
REFERENCE_V2 = RenderConfig(width=1024, height=576, spp=60, depth=50)
# v2 golden-image config (ref: examples/12depth20rays.png filename)
REFERENCE_GOLDEN = RenderConfig(width=1024, height=576, spp=20, depth=12)
# v1 pixel shader: 640x480, 1 spp, fixed depth 25, sqrt gamma
# (ref: main.cpp:83, Shader_RT.fx:392,430,448-450)
REFERENCE_V1 = RenderConfig(width=640, height=480, spp=1, depth=25,
                            gamma=2.0, scatter_mode="v1")
# v1 with the generation's literal fract-sin RNG (Shader_RT.fx:106-163,
# by-value randState defect included) — draw-for-draw reference parity
# on the golden path (see raytpu/rng.py fs_* helpers)
REFERENCE_V1_FAITHFUL = REFERENCE_V1.replace(rng_mode="v1_fractsin")
