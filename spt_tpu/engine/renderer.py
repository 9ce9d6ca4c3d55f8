"""Progressive headless renderer — the render-loop state machine.

Replaces GLRenderer::renderLoop (GLRenderer.cpp:111-188) minus the GL window:
per frame it (a) checks camera movement and resets accumulation
(GLRenderer.cpp:154-161), (b) runs one jit-compiled wavefront frame that
accumulates cfg.spp samples, and (c) on demand resolves the accumulation to a
display image (exposure -> Reinhard -> gamma, device_programs.cu:854-899).

The whole frame — gen/trace/shade/depth-loop/accumulate — is ONE XLA program
with donated state buffers: the only host<->device traffic is the resolved
image when the caller asks for it, versus the reference's per-frame PCIe
image copy + 2 counter syncs per bounce (OptixBackend.cpp:1677-1848).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from spt_tpu.config import RenderConfig
from spt_tpu.camera import Camera, CameraRays
from spt_tpu.engine import state as state_mod
from spt_tpu.engine.image import write_png
from spt_tpu.env import Environment, make_procedural_environment
from spt_tpu.integrators.wavefront import render_wavefront
from spt_tpu.lights import DeviceLights, default_lights
from spt_tpu.ops.tonemap import resolve
from spt_tpu.scene.desc import SceneDesc
from spt_tpu.scene.flatten import DeviceScene, flatten_scene


def _frame_step(
    cfg: RenderConfig,
    scene: DeviceScene,
    env: Environment,
    lights: DeviceLights,
    camera: CameraRays,
    rstate: state_mod.RenderState,
):
    """One progressive frame: render cfg.spp samples at the state's
    frame_index and fold them into the accumulation."""
    if cfg.integrator == "megakernel":
        # the reference's CPU-backend role (PathTracer::renderImage) behind
        # the same progressive engine; per-bounce telemetry is a wavefront
        # concept, so stats report primaries only
        from spt_tpu.integrators.megakernel import render_megakernel
        from spt_tpu.integrators.wavefront import WavefrontStats

        img = render_megakernel(cfg, scene, env, lights, camera,
                                frame_index=rstate.frame_index)
        rays = jnp.zeros((cfg.max_depth,), jnp.int32).at[0].set(
            cfg.num_pixels)
        stats = WavefrontStats(rays_per_bounce=rays,
                               bounces_run=jnp.int32(cfg.max_depth))
    else:
        img, stats = render_wavefront(cfg, scene, env, lights, camera,
                                      frame_index=rstate.frame_index)
    new_state = state_mod.accumulate(rstate, img.reshape(-1, 3), float(cfg.spp))
    return new_state, stats


def _frame_step_k(
    cfg: RenderConfig,
    k: int,
    scene: DeviceScene,
    env: Environment,
    lights: DeviceLights,
    camera: CameraRays,
    rstate: state_mod.RenderState,
):
    """`k` progressive frames in ONE XLA program (lax.fori_loop over the
    frame step): one dispatch and one host sync for the whole chain, for
    non-interactive rendering (bench, CLI with a static camera).  Stats are
    summed across the k frames.

    `k` may be a TRACED scalar: the Renderer jits this ONCE per config with
    a dynamic k and runs every chain length — including interactive k=1 —
    through the same executable, so no chain length compiles twice."""
    from spt_tpu.integrators.wavefront import WavefrontStats

    def body(_, carry):
        st, rays, bounces = carry
        st2, stats = _frame_step(cfg, scene, env, lights, camera, st)
        return (st2, rays + stats.rays_per_bounce,
                jnp.maximum(bounces, stats.bounces_run))

    st, rays, bounces = jax.lax.fori_loop(
        0, k, body,
        (rstate, jnp.zeros((cfg.max_depth,), jnp.int32), jnp.int32(0)),
    )
    return st, WavefrontStats(rays_per_bounce=rays, bounces_run=bounces)


def _resolve_image(cfg: RenderConfig, rstate: state_mod.RenderState):
    img01 = resolve(
        rstate.accum,
        rstate.sample_count,
        exposure=cfg.exposure,
        gamma=cfg.gamma,
        tonemap=cfg.tonemap,
    )
    return img01.reshape(cfg.height, cfg.width, 3)


# Process-wide jit caches keyed by the (hashable, frozen) RenderConfig: every
# Renderer with the same config shares one compiled program instead of
# retracing per instance (jax's jit cache is per function *object*, and
# functools.partial creates a fresh one each time).  Matters on the product
# surface (checkpoint-resume constructs a second Renderer) and cuts test
# wall time, where many Renderers share a config.
@functools.lru_cache(maxsize=64)
def _jitted_step(cfg: RenderConfig):
    return jax.jit(functools.partial(_frame_step, cfg), donate_argnums=(4,))


@functools.lru_cache(maxsize=64)
def _jitted_step_dyn(cfg: RenderConfig):
    # The chain length k rides as a TRACED int32 (argument 5), so one
    # executable serves every chain length including interactive k=1.  The
    # render state (argument 4) is donated: the chain updates the
    # accumulation buffer in place instead of copying it per call.
    def step_dyn(scene, env, lights, camera, rstate, k):
        return _frame_step_k(cfg, k, scene, env, lights, camera, rstate)

    return jax.jit(step_dyn, donate_argnums=(4,))


@functools.lru_cache(maxsize=64)
def _jitted_resolve(cfg: RenderConfig):
    return jax.jit(functools.partial(_resolve_image, cfg))


class Renderer:
    """Progressive renderer over one scene. Headless; the interactive viewer
    (spt_tpu.engine.display) drives this same object."""

    def __init__(
        self,
        desc: SceneDesc,
        cfg: Optional[RenderConfig] = None,
        env: Optional[Environment] = None,
        lights: Optional[DeviceLights] = None,
        camera: Optional[Camera] = None,
        multi_device: Optional[bool] = None,
    ):
        self.cfg = cfg or RenderConfig()
        self.scene = flatten_scene(desc)
        self.env = env if env is not None else make_procedural_environment()
        self.lights = lights if lights is not None else default_lights()
        self.camera = camera or Camera(aspect_ratio=self.cfg.width / self.cfg.height)
        self.state = state_mod.init_state(self.cfg.num_pixels)
        self.last_stats = None

        # Multi-chip: shard the pixel axis over all devices when there are
        # several and the image height tiles (SURVEY.md §2 parallelism).
        n_dev = jax.device_count()
        if multi_device is None:
            # megakernel is single-chip capable only: an AUTO-detected mesh
            # quietly yields to it (the user asked for a backend, not a
            # mesh); an EXPLICIT multi_device=True below is a real conflict.
            multi_device = (n_dev > 1 and self.cfg.height % n_dev == 0
                            and self.cfg.integrator != "megakernel")
        self.mesh = None
        if multi_device:
            from spt_tpu.parallel import (make_mesh, shard_pixels,
                                          sharded_frame_step_dyn)
            from spt_tpu.parallel.sharding import replicate

            if self.cfg.integrator == "megakernel":
                # The sharded step is a wavefront program; silently shading
                # with a different backend than the user asked for would be
                # a lie (render_wavefront treats unknown integrator values
                # as 'masked').
                raise ValueError(
                    "integrator='megakernel' is single-chip only; use the "
                    "wavefront integrators (masked/compact/regen) on a "
                    "device mesh"
                )
            self.mesh = make_mesh()
            # dynamic-k chain on the mesh too (round 5): render_frames
            # issues ONE dispatch whatever k, same as single-chip
            self._step = sharded_frame_step_dyn(self.cfg, self.mesh)
            self.state = shard_pixels(self.mesh, self.state)
            self.scene = replicate(self.mesh, self.scene)
            self.env = replicate(self.mesh, self.env)
            self.lights = replicate(self.mesh, self.lights)
        else:
            self._step = None
            self._step_dyn = _jitted_step_dyn(self.cfg)
        self._resolve = _jitted_resolve(self.cfg)

    def toggle_integrator(self) -> str:
        """Flip wavefront <-> megakernel and reset accumulation — the
        reference's 'G' backend toggle (GLRenderer.cpp:263-277: switching
        backends resets accumulation so images stay comparable).  Returns
        the new integrator name.  Single-chip only (the sharded step is a
        wavefront program); no-op on a device mesh."""
        if self.mesh is not None:
            return self.cfg.integrator
        if self.cfg.integrator != "megakernel":
            # remember the wavefront lane scheduling so the second toggle
            # restores what the user selected (not a hardcoded 'masked')
            self._wavefront_integrator = self.cfg.integrator
            new = "megakernel"
        else:
            new = getattr(self, "_wavefront_integrator", "masked")
        self.cfg = self.cfg.replace(integrator=new)
        self._step_dyn = _jitted_step_dyn(self.cfg)
        self._resolve = _jitted_resolve(self.cfg)
        self.state = state_mod.reset(self.state)
        return new

    def resize(self, width: int, height: int) -> None:
        """Change the render resolution in place: rebuild the jitted
        programs for the new dimensions, reset accumulation, keep
        scene/camera/lights — the reference's buffer-reallocation-on-
        dimension-change contract (OptixBackend::resize,
        OptixBackend.cpp:1508-1543, which reallocates the output and
        wavefront buffers and restarts accumulation; GLRenderer's
        framebuffer callback drives it).  The camera keeps its pose but
        adopts the new aspect ratio.  Program rebuilds hit the
        config-keyed jit caches, so toggling between two sizes recompiles
        nothing.

        On a device mesh the new height must still tile across devices —
        the same gate __init__ applies — otherwise the renderer drops to
        single-chip for the new size rather than render a lie."""
        if (width, height) == (self.cfg.width, self.cfg.height):
            return
        self.cfg = self.cfg.replace(width=width, height=height)
        self.camera.set_aspect_ratio(width / height)
        self.state = state_mod.init_state(self.cfg.num_pixels)
        self.last_stats = None
        if self.mesh is not None and height % self.mesh.devices.size == 0:
            from spt_tpu.parallel import shard_pixels, sharded_frame_step_dyn

            self._step = sharded_frame_step_dyn(self.cfg, self.mesh)
            self.state = shard_pixels(self.mesh, self.state)
        else:
            if self.mesh is not None:
                # leave the mesh: bring the replicated scene back to one
                # device, or every card would render the whole frame
                one = self.mesh.devices.flat[0]
                self.scene, self.env, self.lights = jax.device_put(
                    (self.scene, self.env, self.lights), one)
            self.mesh = None
            self._step = None
            self._step_dyn = _jitted_step_dyn(self.cfg)
        self._resolve = _jitted_resolve(self.cfg)

    # --- frame loop -----------------------------------------------------------

    def render_frame(self, check_camera: bool = True) -> None:
        """Advance the progressive render by one frame (cfg.spp samples)."""
        if check_camera and self.camera.has_moved_since_last_check():
            self.state = state_mod.reset(self.state)
        if self.mesh is not None:
            self.state, self.last_stats = self._step(
                self.scene, self.env, self.lights, self.camera.rays(),
                self.state, jnp.asarray(1, jnp.int32)
            )
            return
        self.state, self.last_stats = self._step_dyn(
            self.scene, self.env, self.lights, self.camera.rays(),
            self.state, jnp.asarray(1, jnp.int32)
        )

    def render_frames(self, k: int, check_camera: bool = False) -> None:
        """Advance by `k` frames in one device dispatch (static camera).

        This is the SAME executable as render_frame (the chain length is a
        traced scalar, _jitted_step_dyn).  On a device mesh the chain is
        one dispatch too (parallel.sharded_frame_step_dyn): the traced-k
        fori_loop rides inside the shard_map body, so a k-frame mesh
        render pays one dispatch and one telemetry psum instead of k of
        each.  Summed stats land in last_stats."""
        if check_camera and self.camera.has_moved_since_last_check():
            self.state = state_mod.reset(self.state)
        step = self._step if self.mesh is not None else self._step_dyn
        self.state, self.last_stats = step(
            self.scene, self.env, self.lights, self.camera.rays(),
            self.state, jnp.asarray(max(k, 1), jnp.int32)
        )

    def render(self, frames: int = 1) -> np.ndarray:
        """Run `frames` progressive frames and return the resolved image."""
        for _ in range(frames):
            self.render_frame()
        return self.image()

    # --- outputs ----------------------------------------------------------------

    @property
    def accumulated_samples(self) -> float:
        return float(self.state.sample_count)

    def image(self) -> np.ndarray:
        """Resolved display image, (H, W, 3) float in [0, 1]."""
        return np.asarray(self._resolve(self.state))

    def hdr_image(self) -> np.ndarray:
        """Linear HDR mean radiance, (H, W, 3) float32."""
        cnt = max(self.accumulated_samples, 1e-30)
        return np.asarray(self.state.accum).reshape(
            self.cfg.height, self.cfg.width, 3
        ) / cnt

    def save_png(self, path: str) -> None:
        write_png(path, self.image())

    # --- checkpoint / resume ---------------------------------------------------

    def save_checkpoint(self, path: str) -> None:
        state_mod.save_checkpoint(path, self.state)

    def load_checkpoint(self, path: str) -> None:
        self.state = state_mod.load_checkpoint(path)
        assert self.state.num_pixels == self.cfg.num_pixels, (
            "checkpoint resolution mismatch"
        )
