"""Render configuration.

The reference scatters its knobs across compile-time constants: image size and
tile size (GLRenderer.h:34-36), spp=4 / max_depth=6 (main.cpp:108-109), GPU
maxDepth=6 (OptixBackend.cpp:1603), exposure/gamma 2.2 (OptixBackend.cpp:
1566-1567), environment intensity 0.8 / clamp 5.0 (EnvironmentManager.h:12-13),
and the default HDR path (PathTracer.cpp:24).  Here they are lifted into one
frozen dataclass, as SURVEY.md §5 prescribes.

Quirk decisions (SURVEY.md §5 "behavioral quirks"):

- quirk 1: we accumulate linear HDR and tonemap once at resolve (the GPU /
  README-intended model, device_programs.cu:854-899); the CPU per-sample
  ACES quirk is reproducible via ``tonemap="aces_per_sample"`` only in tests.
- quirk 2/3: Russian roulette after bounce 2 (wf_pt_cpu.cpp:233-242) and
  shadow rays for direct lighting (Light.cpp:16-40) are both ON — the
  wavefront design the reference planned (wf_types.h:51-63) but never shipped
  on GPU.
- quirk 5: max-depth termination contributes black by default; the GPU's
  normal-visualization debug paint (device_programs.cu:424-439) is available
  as ``depth_term_normal_vis=True`` for A/B parity runs.
- quirk 6: indirect metal uses GGX NDF half-vector sampling with the GPU
  throughput update (device_programs.cu:545-666); ``metal_mirror=True``
  reproduces the CPU megakernel's perfect-mirror fallback
  (PathTracer.cpp:170-176).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """All static knobs for one render. Hashable -> usable as a jit static arg."""

    # Image (GLRenderer.h:34-35: 800x600 fixed window)
    width: int = 800
    height: int = 600

    # Sampling (main.cpp:108-109: 4 spp, depth 6)
    spp: int = 1                 # samples per pixel per frame (progressive)
    max_depth: int = 6

    # Subpixel jitter for progressive anti-aliasing. The reference GPU shoots
    # through pixel centers (device_programs.cu:220-234, +0.5); the CPU
    # wavefront driver jitters per frame (GLRenderer.cpp:386-398). Default on.
    jitter: bool = True

    # Russian roulette: applied for diffuse bounces with index > rr_after
    # (wf_pt_cpu.cpp:233: "if (bounce > 2)").  Set rr_after >= max_depth to
    # disable (the GPU wavefront has no RR).
    rr_after: int = 2

    # Display transform at resolve (device_programs.cu:869-888)
    exposure: float = 2.2
    gamma: float = 2.2
    tonemap: str = "reinhard"    # "reinhard" | "aces" | "none"

    # Environment (EnvironmentManager.h:12-13)
    env_intensity: float = 0.8
    env_clamp: float = 5.0

    # Quirk toggles (see module docstring)
    depth_term_normal_vis: bool = False
    metal_mirror: bool = False
    # Indirect metal sampler: True = Heitz VNDF (Material::evaluateSample,
    # Material.cpp:119-234 — implemented by the reference but never called;
    # SURVEY.md §5 quirk 6 prescribes adopting it).  False = the GPU's plain
    # NDF half-vector sampling (device_programs.cu:545-666).
    metal_vndf: bool = True
    # GPU shade skips direct light on tagged dielectrics
    # (device_programs.cu:462 "matType != MATERIAL_TYPE_DIELECTRIC")
    direct_light_dielectric: bool = False
    # Quirk 7 (SURVEY.md §5): the CPU megakernel weights its dielectric
    # branches by the ior-derived transparency factor
    # (PathTracer.cpp:177-209 with Material::getTransparency(),
    # Material.h:62-73): reflection x (1 - transparency), refraction x
    # transparency, total-internal-reflection x 1.  The GPU's tagged
    # dielectric is a pure delta BSDF (throughput unchanged,
    # device_programs.cu:498-543) and is the default here; True reproduces
    # the CPU weighting for A/B, consuming DeviceMaterials.transparency.
    cpu_transparency: bool = False
    # Trace shadow rays for direct lighting (CPU semantics, Light.cpp:16-40).
    shadow_rays: bool = True

    # Next-event estimation toward emissive triangles (area lights): the
    # shadow-ray wavefront the reference planned (wf_types.h:51-63) extended
    # to emitters.  Active only when the scene has an emitter table; paths
    # then count hit emission only on camera/dielectric continuations to
    # avoid double counting.
    nee: bool = True

    # Intersection epsilons. Scale-aware offset eps * max(1, |p|_inf)
    # (PathTracer.cpp:101-111); dielectric continuation offsets along the new
    # direction by ray_offset_dir (device_programs.cu:530 "1e-3f").
    hit_eps: float = 1e-4
    ray_offset_dir: float = 1e-3

    # Anti-firefly clamp on the metal GGX throughput update
    # (device_programs.cu:648 "fminf(scale, 50.0f)")
    firefly_clamp: float = 50.0

    # Wavefront lane scheduling (see integrators/wavefront.py):
    #   "masked"  — all lanes every bounce, dead lanes masked (the default).
    #   "compact" — cumsum-compacted queues of live lanes.
    #   "regen"   — per-lane path regeneration [Novák et al. 2010]: a lane
    #               restarts with its pixel's next sample the moment its path
    #               dies, folding the whole spp budget into one depth loop.
    #   "megakernel" — the recursive per-sample tracer behind the same
    #               progressive engine (integrators/megakernel.py).
    integrator: str = "masked"

    @property
    def resolution(self) -> Tuple[int, int]:
        return (self.width, self.height)

    @property
    def num_pixels(self) -> int:
        return self.width * self.height

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


# Reference-parity preset: what OptixBackend::render hardcodes
# (OptixBackend.cpp:1566-1567,1603; no jitter, no RR, no shadow rays).
GPU_PARITY = RenderConfig(
    jitter=False,
    rr_after=10**6,
    shadow_rays=False,
    depth_term_normal_vis=True,
    metal_vndf=False,
)
