"""Wavefront integrator: staged pipeline with the depth loop on device.

The reference's GPU wavefront (OptixBackend.cpp:1506-1850) drives the
gen_primary -> [trace -> shade] x depth -> resolve pipeline from the HOST,
reading back queue counters twice per bounce (cudaStreamSynchronize at
:1677-1695, :1736-1748, :1780-1792 — its acknowledged hot spot, SURVEY.md §3.4).

This version keeps the whole depth loop inside one jitted program as a
`lax.while_loop` keyed on the live-path count: zero host round-trips per
frame.  Three lane schedules (cfg.integrator):

- **masked** (the default): every bounce processes all N lanes with dead
  lanes masked — the simplest correct form.
- **compact**: after the full-width primary bounce, live lanes are packed
  by a deterministic cumsum scan (ops/compaction.py — the atomicAdd ticket
  queues of device_programs.cu:268-273 without the races) and bounced in
  fixed-width chunks, so bounce k costs O(live_k) lanes instead of O(N), at
  the price of a gather and a scatter of the path state per chunk.
- **regen**: per-lane path regeneration (render_wavefront_regen).

Results match across schedules to float tolerance; which one is fastest on
a given card and scene is a measurement, not a property of the code.

Returns per-bounce live-ray counts alongside radiance: the queue-conservation
invariant the reference asserted by eyeball (frame-0 log,
OptixBackend.cpp:1690-1695) becomes a real test (SURVEY.md §4).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from spt_tpu.config import RenderConfig
from spt_tpu.camera import CameraRays
from spt_tpu.env import Environment
from spt_tpu.lights import DeviceLights
from spt_tpu.integrators import transport
from spt_tpu.ops import vec3 as v3
from spt_tpu.ops.compaction import compact_indices
from spt_tpu.ops.vec3 import Vec3
from spt_tpu.scene.flatten import DeviceScene


class WavefrontStats(NamedTuple):
    """Per-bounce telemetry (the frame-0 `rays N -> hits M -> next N'` log,
    OptixBackend.cpp:1690-1695, as device arrays)."""

    rays_per_bounce: jnp.ndarray   # (max_depth,) int32 — live rays traced
    bounces_run: jnp.ndarray       # () int32 — loop trips before early exit


def _queue_width(n: int) -> int:
    """Chunk width for the compacted bounce loop: ~1/4 of the lanes, floored
    to a lane-friendly multiple."""
    w = max(8192, n // 4)
    w = min(w, n)
    return ((w + 1023) // 1024) * 1024 if w >= 1024 else w


def _bounce(cfg, scene, env, lights, ps, bounce, is_last):
    """Full bounce with env applied inline (compacted path + simple callers)."""
    new_ps, missed = _bounce_core(cfg, scene, lights, ps, bounce, is_last)
    from spt_tpu.env import environment_color_v

    env_c = environment_color_v(env, ps.direction)
    zero3 = Vec3.full((0, 0, 0), ps.rng.shape)
    radiance = new_ps.radiance + v3.where(missed, ps.throughput * env_c, zero3)
    return new_ps._replace(radiance=radiance)


def _bounce_core(cfg, scene, lights, ps, bounce, is_last):
    """Bounce WITHOUT the environment term; returns (state, missed).

    A lane misses at most once per sample and shade_core freezes its
    direction and throughput at death, so the caller can defer the env
    lookup (a 4-tap texture gather for HDR maps — the one expensive gather
    in the pipeline) to a single evaluation after the depth loop instead of
    one per bounce.
    """
    hit = transport.trace_bounce(scene, ps)
    return transport.shade_core(cfg, scene, lights, ps, hit, bounce, is_last)


def wavefront_sample(
    cfg: RenderConfig,
    scene: DeviceScene,
    env: Environment,
    lights: DeviceLights,
    camera: CameraRays,
    frame_index,
    sample_index: int = 0,
    row0=0,
    rows: int = None,
    compact: bool = False,
) -> Tuple[jnp.ndarray, WavefrontStats]:
    """One sample per pixel -> ((N, 3) radiance, stats)."""
    n = cfg.width * (rows if rows is not None else cfg.height)
    rays0 = jnp.zeros((cfg.max_depth,), jnp.int32)
    ps = transport.gen_primary(cfg, camera, frame_index, sample_index, row0, rows)
    if not compact or cfg.max_depth == 1 or n < 16384:
        return _wavefront_masked(cfg, scene, env, lights, ps, rays0)

    # Primary bounce at full width (everything is live).
    rays0 = rays0.at[0].set(n)
    ps = _bounce(cfg, scene, env, lights, ps, 0, cfg.max_depth == 1)

    w = _queue_width(n)
    # Pad the queue so fixed-width chunk slices never clamp: an unpadded
    # dynamic_slice whose last chunk starts past n - w would slide backwards
    # and re-bounce earlier queue entries (double RNG advance + radiance).
    q_pad = (n + w - 1) // w * w - n

    def cond(carry):
        bounce, ps, _ = carry
        return (bounce < cfg.max_depth) & jnp.any(ps.alive)

    def body(carry):
        bounce, ps, rays = carry
        queue, count = compact_indices(ps.alive)
        if q_pad:
            # Padding entries point at lane n: the gather clamps them to a
            # masked-invalid lane and the scatter-home drops them.
            queue = jnp.concatenate(
                [queue, jnp.full((q_pad,), n, jnp.int32)]
            )
        rays = rays.at[bounce].set(count)
        is_last = bounce == cfg.max_depth - 1

        def chunk(ci, ps):
            start = ci * w
            idx = jax.lax.dynamic_slice(queue, (start,), (w,))
            valid = (start + jnp.arange(w, dtype=jnp.int32)) < count
            sub = jax.tree.map(lambda a: a[idx], ps)
            sub = sub._replace(alive=sub.alive & valid)
            sub = _bounce(cfg, scene, env, lights, sub, bounce, is_last)
            # Scatter valid lanes home; padding redirects OOB and is dropped.
            target = jnp.where(valid, idx, n)
            return jax.tree.map(
                lambda dst, src: dst.at[target].set(src, mode="drop"), ps, sub
            )

        n_chunks = (count + (w - 1)) // w
        ps = jax.lax.fori_loop(0, n_chunks, chunk, ps)
        return bounce + 1, ps, rays

    bounce, ps, rays = jax.lax.while_loop(cond, body, (jnp.int32(1), ps, rays0))
    return ps.radiance.to_array(), WavefrontStats(rays_per_bounce=rays, bounces_run=bounce)


def _wavefront_masked(cfg, scene, env, lights, ps, rays0):
    """All-lanes-masked depth loop (the default).

    The environment term is deferred: lanes that die by missing keep their
    miss direction and throughput frozen, so one env evaluation after the
    loop (tracked by `missed_ever`) replaces one per bounce — for HDR maps
    that is 6x fewer texture gathers per frame.
    """
    from spt_tpu.env import environment_color_v

    missed0 = jnp.zeros(ps.rng.shape, bool)

    def cond(carry):
        bounce, ps, _, _ = carry
        return (bounce < cfg.max_depth) & jnp.any(ps.alive)

    def body(carry):
        bounce, ps, rays, missed_ever = carry
        live = jnp.sum(ps.alive.astype(jnp.int32))
        rays = rays.at[bounce].set(live)
        ps, missed = _bounce_core(cfg, scene, lights, ps, bounce,
                                  bounce == cfg.max_depth - 1)
        return bounce + 1, ps, rays, missed_ever | missed

    bounce, ps, rays, missed_ever = jax.lax.while_loop(
        cond, body, (jnp.int32(0), ps, rays0, missed0)
    )
    env_c = environment_color_v(env, ps.direction)
    zero3 = Vec3.full((0, 0, 0), ps.rng.shape)
    radiance = ps.radiance + v3.where(missed_ever, ps.throughput * env_c, zero3)
    return radiance.to_array(), WavefrontStats(rays_per_bounce=rays,
                                               bounces_run=bounce)


def render_wavefront(
    cfg: RenderConfig,
    scene: DeviceScene,
    env: Environment,
    lights: DeviceLights,
    camera: CameraRays,
    frame_index=0,
    row0=0,
    rows: int = None,
    compact: bool = False,
) -> Tuple[jnp.ndarray, WavefrontStats]:
    """cfg.spp samples -> ((rows, W, 3) linear radiance, summed stats).

    Lane scheduling comes from cfg.integrator ("masked" | "compact" |
    "regen"); the `compact` argument is an explicit override kept for
    benchmarks and A/B tests.
    """
    if rows is None:
        rows = cfg.height
    if cfg.integrator == "regen":
        return render_wavefront_regen(cfg, scene, env, lights, camera,
                                      frame_index, row0, rows)
    compact = compact or cfg.integrator == "compact"
    acc = jnp.zeros((cfg.width * rows, 3), jnp.float32)
    rays = jnp.zeros((cfg.max_depth,), jnp.int32)
    bounces = jnp.int32(0)

    def one_sample(s, carry):
        acc, rays, bounces = carry
        rad, stats = wavefront_sample(
            cfg, scene, env, lights, camera, frame_index, s, row0, rows,
            compact=compact,
        )
        return (acc + rad, rays + stats.rays_per_bounce,
                jnp.maximum(bounces, stats.bounces_run))

    if cfg.spp > 1:
        # Rolled sample loop: the program contains ONE wavefront sample
        # regardless of spp (an spp-4 CLI default used to quadruple program
        # size and compile time).  sample_index reaches the RNG seeding as
        # a traced scalar; nothing else depends on it.
        acc, rays, bounces = jax.lax.fori_loop(
            0, cfg.spp, one_sample, (acc, rays, bounces))
    else:
        acc, rays, bounces = one_sample(0, (acc, rays, bounces))
    img = (acc / cfg.spp).reshape(rows, cfg.width, 3)
    return img, WavefrontStats(rays_per_bounce=rays, bounces_run=bounces)


# --- path regeneration ---------------------------------------------------------

def _gen_primary_lanes(cfg, camera, frame_index, sample_idx, row0, rows):
    """gen_primary with a per-lane sample index (for regeneration).
    Seeding matches gen_primary exactly: per-sample fold only when spp > 1."""
    from spt_tpu.ops import rng as rng_ops
    from spt_tpu.ops.vec3 import Vec3

    w, h = cfg.width, cfg.height
    if rows is None:
        rows = h
    n = w * rows
    pixel = jnp.asarray(row0, jnp.uint32) * jnp.uint32(w) + jnp.arange(n, dtype=jnp.uint32)
    px = (pixel % jnp.uint32(w)).astype(jnp.float32)
    py = (pixel // jnp.uint32(w)).astype(jnp.float32)

    state = rng_ops.seed_paths(pixel, frame_index)
    if cfg.spp > 1:
        state = rng_ops.seed_samples(state, sample_idx)

    if cfg.jitter:
        state, ju, jv = rng_ops.next_float2(state)
    else:
        ju = jv = jnp.float32(0.5)

    x = (px + ju) / jnp.float32(w)
    y = (py + jv) / jnp.float32(h)
    direction = camera.ray_directions_v(x, y)
    ones = jnp.ones((n,), jnp.float32)
    zeros = jnp.zeros((n,), jnp.float32)
    return transport.PathState(
        origin=Vec3(camera.position[0] + zeros,
                    camera.position[1] + zeros,
                    camera.position[2] + zeros),
        direction=direction,
        throughput=Vec3(ones, ones, ones),
        radiance=Vec3(zeros, zeros, zeros),
        rng=state,
        alive=jnp.ones((n,), bool),
        emission_ok=jnp.ones((n,), bool),
    )


def render_wavefront_regen(
    cfg: RenderConfig,
    scene: DeviceScene,
    env: Environment,
    lights: DeviceLights,
    camera: CameraRays,
    frame_index=0,
    row0=0,
    rows: int = None,
) -> Tuple[jnp.ndarray, WavefrontStats]:
    """Path-regeneration wavefront: the whole cfg.spp budget in one loop.

    The masked depth loop wastes lanes once paths die, and queue compaction
    pays a gather and a scatter of the path state per chunk.  Regeneration
    is the lane-local alternative: the moment a lane's path terminates, its
    radiance is retired into a per-lane accumulator and the SAME lane
    restarts with its own pixel's next sample (pure per-lane math — no
    cross-lane traffic at all).  Lanes stay near-fully live until the whole
    sample budget drains, converting the wavefront from O(spp * max_depth)
    full-width rounds to O(spp * mean_path_length) — the classic GPU
    path-regeneration idea [Novák et al. 2010].

    The sample set and its RNG streams are IDENTICAL to render_wavefront's
    (same per-(pixel, sample) seeds, same per-pixel accumulation order), so
    results match the masked integrator to float tolerance.

    """
    from spt_tpu.ops.vec3 import Vec3
    import spt_tpu.ops.vec3 as v3

    if rows is None:
        rows = cfg.height
    n = cfg.width * rows

    ps = _gen_primary_lanes(cfg, camera, frame_index,
                            jnp.zeros((n,), jnp.uint32), row0, rows)
    zeros = jnp.zeros((n,), jnp.float32)
    accum = Vec3(zeros, zeros, zeros)
    sample_idx = jnp.zeros((n,), jnp.uint32)
    bounce = jnp.zeros((n,), jnp.int32)
    rays = jnp.zeros((cfg.max_depth,), jnp.int32)
    max_iters = cfg.spp * cfg.max_depth

    def cond(carry):
        it, ps, *_ = carry
        return (it < max_iters) & jnp.any(ps.alive)

    def body(carry):
        it, ps, sample_idx, bounce, accum, rays = carry
        was_alive = ps.alive
        # telemetry: live lanes at each lane-local bounce depth
        one_hot = (bounce[None, :] == jnp.arange(cfg.max_depth)[:, None]) & was_alive[None, :]
        rays = rays + jnp.sum(one_hot, axis=1, dtype=jnp.int32)

        hit = transport.trace_bounce(scene, ps)
        ps = transport.shade(cfg, scene, env, lights, ps, hit,
                             bounce=bounce, is_last=bounce >= cfg.max_depth - 1)
        bounce = jnp.where(was_alive, bounce + 1, bounce)

        died = was_alive & ~ps.alive
        accum = accum + v3.where(died, ps.radiance,
                                 Vec3(zeros, zeros, zeros))
        sample_next = sample_idx + died.astype(jnp.uint32)
        respawn = died & (sample_next < cfg.spp)

        fresh = _gen_primary_lanes(cfg, camera, frame_index, sample_next, row0, rows)
        ps = transport.PathState(
            origin=v3.where(respawn, fresh.origin, ps.origin),
            direction=v3.where(respawn, fresh.direction, ps.direction),
            throughput=v3.where(respawn, fresh.throughput, ps.throughput),
            radiance=v3.where(respawn, fresh.radiance, ps.radiance),
            rng=jnp.where(respawn, fresh.rng, ps.rng),
            alive=ps.alive | respawn,
            emission_ok=jnp.where(respawn, True, ps.emission_ok),
        )
        bounce = jnp.where(respawn, 0, bounce)
        return it + 1, ps, sample_next, bounce, accum, rays

    it, ps, sample_idx, bounce, accum, rays = jax.lax.while_loop(
        cond, body, (jnp.int32(0), ps, sample_idx, bounce, accum, rays)
    )
    img = accum.to_array() / jnp.float32(cfg.spp)
    return img.reshape(rows, cfg.width, 3), WavefrontStats(
        rays_per_bounce=rays, bounces_run=it
    )
