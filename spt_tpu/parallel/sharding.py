"""Multi-device scaling: image-space data parallelism over a device mesh.

The reference's parallelism is TBB tiles on one CPU and one CUDA stream on
one GPU (SURVEY.md §2 parallelism table) — no multi-device anything.  This
build scales the dimension the wavefront design already optimizes (path
count, SURVEY.md §5) across devices:

- one mesh axis "px" over all devices;
- pixel/path lanes sharded along "px": each device owns a horizontal band
  of the image and that band's full path state;
- scene, materials, lights, env replicated (small: the default scene is
  < 4 KB, an HDR env a few MB);
- zero per-bounce collectives — paths never migrate between devices.
  Cross-device traffic is one psum of the (max_depth,) telemetry counters
  per chain plus the final image gather when the host asks for the
  resolved frame,
  replacing the reference's per-frame PCIe copy (OptixBackend.cpp:1831-1848).

Lanes carry global pixel indices (gen_primary's row0/rows window), so the
sharded render is the single-device one sample for sample — the
dual-backend-oracle test pattern (SURVEY.md §4) applied to sharding.

The same code runs on several GPUs and on the CPU-simulated mesh used in
tests (XLA_FLAGS=--xla_force_host_platform_device_count=8).
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from spt_tpu.config import RenderConfig
from spt_tpu.camera import CameraRays
from spt_tpu.engine import state as state_mod
from spt_tpu.env import Environment
from spt_tpu.integrators.wavefront import WavefrontStats, render_wavefront
from spt_tpu.lights import DeviceLights
from spt_tpu.scene.flatten import DeviceScene

AXIS = "px"


def make_mesh(devices: Optional[Sequence[jax.Device]] = None) -> Mesh:
    """1-D mesh over all (or the given) devices, axis name "px"."""
    devices = list(devices) if devices is not None else jax.devices()
    return Mesh(np.array(devices), axis_names=(AXIS,))


def shard_pixels(mesh: Mesh, state: state_mod.RenderState) -> state_mod.RenderState:
    """Place accumulation state with the pixel axis sharded over the mesh."""
    lane = NamedSharding(mesh, P(AXIS, None))
    rep = NamedSharding(mesh, P())
    return state_mod.RenderState(
        accum=jax.device_put(state.accum, lane),
        sample_count=jax.device_put(state.sample_count, rep),
        frame_index=jax.device_put(state.frame_index, rep),
    )


def replicate(mesh: Mesh, tree):
    """Replicate a pytree (scene/env/lights/camera) across the mesh."""
    return jax.device_put(tree, NamedSharding(mesh, P()))


def _sharded_step_k(
    cfg: RenderConfig,
    scene: DeviceScene,
    env: Environment,
    lights: DeviceLights,
    camera: CameraRays,
    rstate: state_mod.RenderState,
    k,
):
    """Per-shard body for the dynamic-k frame chain: this device's row band
    of `k` progressive frames in ONE program (the multi-device twin of
    renderer._frame_step_k).  The chain length is a TRACED int32 driving
    a fori_loop, so one executable serves every chain length.  Telemetry
    is summed across frames INSIDE the loop and psum'd across devices once
    at the end (k-1 fewer collectives than per-frame stepping; same
    totals)."""
    n_shards = jax.lax.psum(1, AXIS)
    shard_rows = cfg.height // n_shards
    row0 = jax.lax.axis_index(AXIS) * shard_rows

    def body(_, carry):
        st, rays, bounces = carry
        img, stats = render_wavefront(
            cfg, scene, env, lights, camera,
            frame_index=st.frame_index, row0=row0, rows=shard_rows,
        )
        st2 = state_mod.accumulate(st, img.reshape(-1, 3), float(cfg.spp))
        return (st2, rays + stats.rays_per_bounce,
                jnp.maximum(bounces, stats.bounces_run))

    st, rays, bounces = jax.lax.fori_loop(
        0, k, body,
        (rstate, jnp.zeros((cfg.max_depth,), jnp.int32), jnp.int32(0)),
    )
    global_stats = WavefrontStats(
        rays_per_bounce=jax.lax.psum(rays, AXIS),
        bounces_run=jax.lax.pmax(bounces, AXIS),
    )
    return st, global_stats


def sharded_frame_step_dyn(cfg: RenderConfig, mesh: Mesh):
    """Build the jitted multi-device dynamic-k chain step:
    step(scene, env, lights, camera, rstate, k) -> (rstate, stats).
    One executable per config serves every chain length (k traced),
    mirroring renderer._jitted_step_dyn; the Renderer routes both
    render_frame (k=1) and render_frames through it on a mesh."""
    n = mesh.devices.size
    assert cfg.height % n == 0, (
        f"image height {cfg.height} must divide the mesh size {n}"
    )
    state_specs = state_mod.RenderState(
        accum=P(AXIS, None), sample_count=P(), frame_index=P()
    )
    fn = jax.shard_map(
        functools.partial(_sharded_step_k, cfg),
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), state_specs, P()),
        out_specs=(state_specs, P()),
        check_vma=False,
    )
    return jax.jit(fn, donate_argnums=(4,))


def sharded_frame_step(cfg: RenderConfig, mesh: Mesh):
    """Build the multi-device single-frame step:
    step(scene, env, lights, camera, rstate) -> (rstate, stats) — the
    dynamic-k chain at k = 1."""
    step = sharded_frame_step_dyn(cfg, mesh)
    one = jnp.asarray(1, jnp.int32)

    def frame(scene, env, lights, camera, rstate):
        return step(scene, env, lights, camera, rstate, one)

    return frame
