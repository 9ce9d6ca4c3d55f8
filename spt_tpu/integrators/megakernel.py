"""Megakernel integrator: the whole path in one fused XLA program.

A re-expression of the reference's CPU recursive tracer
(PathTracer.cpp:113-224, iteratively restated in wf_pt_cpu.cpp:94-248): the
bounce loop is unrolled at trace time over the full pixel batch, so XLA fuses
trace+shade across bounces into one kernel stream — the "megakernel" the GPU
world avoids because of warp divergence, which dense masked lanes don't pay.

This is also the differentiable path: everything here is pure jnp, so
`jax.grad` through a render works (inverse-rendering capability the reference
cannot offer).
"""

from __future__ import annotations

import jax.numpy as jnp

from spt_tpu.config import RenderConfig
from spt_tpu.camera import CameraRays
from spt_tpu.env import Environment
from spt_tpu.lights import DeviceLights
from spt_tpu.integrators import transport
from spt_tpu.scene.flatten import DeviceScene


def render_sample(
    cfg: RenderConfig,
    scene: DeviceScene,
    env: Environment,
    lights: DeviceLights,
    camera: CameraRays,
    frame_index,
    sample_index: int = 0,
) -> jnp.ndarray:
    """One sample per pixel -> (N, 3) linear radiance."""
    ps = transport.gen_primary(cfg, camera, frame_index, sample_index)
    for bounce in range(cfg.max_depth):
        hit = transport.trace_bounce(scene, ps)
        ps = transport.shade(
            cfg, scene, env, lights, ps, hit,
            bounce=bounce, is_last=(bounce == cfg.max_depth - 1),
        )
    return ps.radiance.to_array()


def render_megakernel(
    cfg: RenderConfig,
    scene: DeviceScene,
    env: Environment,
    lights: DeviceLights,
    camera: CameraRays,
    frame_index=0,
) -> jnp.ndarray:
    """cfg.spp samples averaged -> (H, W, 3) linear radiance (the spp loop of
    PathTracer::traceRay, PathTracer.cpp:280-303 — minus its per-sample
    tonemap quirk; resolve happens once downstream).

    Rolled like the wavefront's sample loop (wavefront.py render_wavefront):
    the program contains ONE sample regardless of spp — sample_index reaches
    only the RNG seeding, as a traced scalar.  With static bounds
    lax.fori_loop lowers to scan, so jax.grad through a multi-sample render
    (the inverse-rendering path, examples/inverse_albedo.py) still works."""
    import jax

    acc0 = jnp.zeros((cfg.num_pixels, 3), jnp.float32)

    def one_sample(s, acc):
        return acc + render_sample(cfg, scene, env, lights, camera,
                                   frame_index, s)

    acc = (jax.lax.fori_loop(0, cfg.spp, one_sample, acc0)
           if cfg.spp > 1 else one_sample(0, acc0))
    return (acc / cfg.spp).reshape(cfg.height, cfg.width, 3)
