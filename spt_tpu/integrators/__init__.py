"""Integrators: one canonical transport, two orchestrations.

`transport` holds the per-bounce physics shared by both integrators — the
reference's goal of CPU/GPU-shared shading semantics
(GLRenderer.cpp:120-126 passes one material/light/env source of truth to both
backends).  `megakernel` loops bounces per pixel batch (the PathTracer.cpp
model); `wavefront` runs staged gen/trace/shade/resolve over SoA path state
(the OptixBackend.cpp:1506-1850 model) with the depth loop on device.
"""

from spt_tpu.integrators.transport import PathState, gen_primary, shade, trace_bounce
from spt_tpu.integrators.megakernel import render_megakernel, render_sample
from spt_tpu.integrators.wavefront import render_wavefront, wavefront_sample

__all__ = [
    "PathState",
    "gen_primary",
    "shade",
    "trace_bounce",
    "render_megakernel",
    "render_sample",
    "render_wavefront",
    "wavefront_sample",
]
