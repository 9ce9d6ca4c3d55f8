"""Smoke test of the renderer on an NVIDIA GPU.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --multi    # four cards: the sharded 1080p chain only

One process drives every phase; nothing falls back to the CPU.  On a machine
where JAX finds no GPU the script exits non-zero before printing any result.

Phases on one card:

1. device  -- JAX's first device is a GPU; the card's name and power limit.
2. main    -- the 1080p default scene (spp 1, depth 6, masked wavefront) as
              a 128-frame ``Renderer.render_frames`` chain: compile seconds,
              ms/frame and Mrays/s (rays counted by ``bench.count_rays``),
              ray-count invariants, finite accumulation, bitwise-repeatable
              frames; then the CLI (``spt_tpu.cli.main``, default scene and
              ``--scene cornell``) and ``__graft_entry__.entry()``.
3. oracle  -- small renders of the default scene, Cornell with NEE, HDR glass
              and a seeded procedural mesh, each against the scalar numpy
              oracle (tests/reference_cpu.py) at the tests' gate; wavefront
              against megakernel on the default scene and on the mesh.
4. width   -- one 1920x1080 default frame on the GPU against the same frame
              on this process's CPU backend.

With ``--multi`` only the four-card path runs: the 1080p chain sharded over
four cards (270 rows each) against the same frames on one card.

Each comparison prints its error beside its limit.  The last line of
standard output is one JSON object naming the device.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# Oracle gate: relative RMSE in linear radiance, as tests/test_transport.py.
ORACLE_REL_RMSE = 0.01
# Wavefront vs megakernel: the same transport compiled as a while_loop and as
# an unrolled loop.  The CPU tests hold every pixel to |a-b| <= 5e-4+1e-3|b|.
# The GPU compiler contracts multiply-adds differently in the two programs, so
# a last-bit difference can flip one Russian-roulette, Fresnel or hit decision
# and change that pixel's whole path: a small share of pixels may fail the
# per-pixel test, and the image as a whole must stay within the oracle gate.
PARITY_ATOL, PARITY_RTOL = 5e-4, 1e-3
PARITY_PIXEL_SHARE = 0.01
PARITY_REL_RMSE = 0.01
# Full width, GPU vs CPU backend: the GPU contracts FMAs and uses its own
# transcendentals (pow in the sky, sin/cos in the samplers), so values drift
# in the last bits everywhere and a flipped decision changes a whole path.
# A pixel "differs" when a channel moves by more than 1e-3 (absolute, linear
# radiance); at most 0.5 % of pixels may.  The RMSE is taken on the resolved
# display image (tonemapped, each pixel in [0, 1]) and must stay within the
# oracle gate: in a 1-spp linear frame one flipped path can be a firefly
# whose single pixel dominates the linear RMSE, so that number is printed
# but bounds nothing the pixel share does not already bound.
WIDTH_DIFF = 1e-3
WIDTH_PIXEL_SHARE = 0.005
WIDTH_REL_RMSE = 0.01
# Four cards vs one: lanes carry global pixel indices, so the sharded frame
# is the single-card frame up to compiler differences between the two
# programs.  Per-bounce ray counts may differ by a flipped path or two; the
# images are compared as at full width, with tighter limits.
MULTI_RAYS_REL = 1e-4
MULTI_PIXEL_SHARE = 1e-3
MULTI_REL_RMSE = 1e-3

W, H = 1920, 1080
CHAIN = 128


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(name: str, value: float, limit: float) -> None:
    """Print one comparison beside its limit; fail if it is over."""
    ok = value <= limit
    print(f"  {name}: {value:.6g} (limit {limit:g}) {'ok' if ok else 'OVER'}",
          flush=True)
    if not ok:
        fail(f"{name} = {value:.6g} exceeds {limit:g}")


def rel_rmse(got, want) -> float:
    import numpy as np

    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.sqrt(np.mean((got - want) ** 2))
    return float(err / (np.sqrt(np.mean(want ** 2)) + 1e-9))


def pixel_share(got, want, atol: float, rtol: float = 0.0) -> float:
    """Share of pixels with any channel outside |got-want| <= atol+rtol|want|."""
    import numpy as np

    got, want = np.asarray(got), np.asarray(want)
    bad = np.abs(got - want) > atol + rtol * np.abs(want)
    return float(bad.reshape(-1, 3).any(axis=1).mean())


def phase(name: str) -> float:
    print(f"[{name}]", flush=True)
    return time.perf_counter()


def done(t0: float) -> None:
    print(f"  phase seconds: {time.perf_counter() - t0:.1f}", flush=True)


def default_renderer(width, height, **kw):
    from spt_tpu.camera import default_camera
    from spt_tpu.config import RenderConfig
    from spt_tpu.engine.renderer import Renderer
    from spt_tpu.scene import build_default_scene

    cfg = RenderConfig(width=width, height=height, spp=1, max_depth=6)
    return Renderer(build_default_scene(), cfg,
                    camera=default_camera(width, height), **kw)


def time_chain(r, k: int):
    """(seconds, Mrays/s) of one k-frame chain, ending in block_until_ready."""
    import jax

    from bench import count_rays, shadow_rays_per_surface_lane

    t0 = time.perf_counter()
    r.render_frames(k)
    jax.block_until_ready(r.state.accum)
    dt = time.perf_counter() - t0
    rays = count_rays(r.last_stats, r.cfg, shadow_rays_per_surface_lane(r))
    return dt, rays / dt / 1e6


def main_path(width=W, height=H, chain=CHAIN) -> None:
    import jax
    import numpy as np

    t0 = phase("main: default scene chain")
    r = default_renderer(width, height, multi_device=False)
    tc = time.perf_counter()
    r.render_frames(1)
    jax.block_until_ready(r.state.accum)
    print(f"  compile + first frame seconds: {time.perf_counter() - tc:.2f}",
          flush=True)
    dt, mrays = time_chain(r, chain)
    print(f"  {width}x{height} chain of {chain}: {dt / chain * 1e3:.3f} "
          f"ms/frame, {mrays:.2f} Mrays/s", flush=True)
    rays = np.asarray(r.last_stats.rays_per_bounce, np.int64)
    print(f"  rays per bounce (chain): {rays.tolist()}", flush=True)
    if rays[0] != width * height * chain:
        fail(f"rays_per_bounce[0] = {rays[0]} != {width * height * chain}")
    if np.any(np.diff(rays) > 0):
        fail(f"live ray counts grow across bounces: {rays.tolist()}")
    if not np.isfinite(np.asarray(r.state.accum)).all():
        fail("non-finite accumulation")

    a = default_renderer(width, height, multi_device=False)
    b = default_renderer(width, height, multi_device=False)
    a.render_frame()
    b.render_frame()
    if not np.array_equal(np.asarray(a.state.accum), np.asarray(b.state.accum)):
        fail("two renders of the same frame differ")
    print("  two renders of frame 0: bitwise equal", flush=True)
    done(t0)

    t0 = phase("main: cli")
    from spt_tpu import cli

    with tempfile.TemporaryDirectory() as tmp:
        for extra in ([], ["--scene", "cornell"]):
            png = os.path.join(tmp, "render.png")
            rc = cli.main(["--frames", "16", "-o", png] + extra)
            if rc != 0 or not os.path.getsize(png):
                fail(f"cli {extra} exited {rc}")
            os.remove(png)
    done(t0)

    t0 = phase("main: __graft_entry__.entry()")
    import __graft_entry__

    fn, args = __graft_entry__.entry()
    out, stats = jax.jit(fn)(*args)
    jax.block_until_ready(out.accum)
    n = int(stats.rays_per_bounce[0])
    if n != args[-1].num_pixels or not np.isfinite(np.asarray(out.accum)).all():
        fail(f"entry(): {n} primary rays, finite={np.isfinite(out.accum).all()}")
    done(t0)


def oracle_scenes():
    """(name, desc, cfg, lights, camera, env, env_image) for the oracle phase,
    at the sizes and settings the CPU tests gate."""
    from spt_tpu.camera import Camera, default_camera
    from spt_tpu.config import RenderConfig
    from spt_tpu.env import make_hdr_environment, synthetic_equirect
    from spt_tpu.lights import LightManager, default_lights
    from spt_tpu.scene import (build_cornell_box_scene, build_default_scene,
                               build_hdr_glass_scene, build_seeded_mesh_scene)

    cfg = RenderConfig(width=40, height=30, spp=1, max_depth=3)
    yield ("default", build_default_scene(), cfg, default_lights(),
           default_camera(cfg.width, cfg.height), None, None)

    cfg = RenderConfig(width=20, height=20, spp=1, max_depth=4)
    yield ("cornell_nee", build_cornell_box_scene(), cfg,
           LightManager().device(),
           Camera(position=(0, 2.75, 9.0), target=(0, 2.75, 0.0),
                  fov_degrees=50.0, aspect_ratio=1.0), None, None)

    img = synthetic_equirect(32)
    lm = LightManager()
    lm.add_directional_light((0.4, -1.0, -0.3), (1.0, 0.95, 0.9), 1.0)
    yield ("hdr_glass", build_hdr_glass_scene(), cfg, lm.device(),
           Camera(position=(0, 2.0, 6.0), target=(0, 1.0, 0.0),
                  fov_degrees=50.0, aspect_ratio=1.0),
           make_hdr_environment(img), img)

    cfg = RenderConfig(width=32, height=24, spp=1, max_depth=3)
    yield ("seeded_mesh", build_seeded_mesh_scene(seed=0), cfg,
           default_lights(),
           Camera(position=(0.5, 2.2, 5.0), target=(0.3, 1.0, 0.0),
                  fov_degrees=50.0, aspect_ratio=cfg.width / cfg.height),
           None, None)


def oracle() -> None:
    import reference_cpu as ref

    from spt_tpu.engine.renderer import Renderer
    from spt_tpu.ops.intersect import UNROLL_LIMIT

    for name, desc, cfg, lights, cam, env, env_img in oracle_scenes():
        t0 = phase(f"oracle: {name}")
        r = Renderer(desc, cfg, env=env, lights=lights, camera=cam,
                     multi_device=False)
        prims = r.scene.num_triangles + r.scene.num_spheres
        route = "unrolled" if prims <= UNROLL_LIMIT else "chunked"
        print(f"  {prims} primitives -> {route} intersector", flush=True)
        r.render_frame()
        got = r.hdr_image()
        want = ref.render_image(cfg, ref.NpScene(r.scene),
                                ref.lights_from_device(lights), cam, frame=0,
                                env_image=env_img)
        check(f"{name} vs oracle, relative RMSE", rel_rmse(got, want),
              ORACLE_REL_RMSE)
        if name in ("default", "seeded_mesh"):
            mk = Renderer(desc, cfg.replace(integrator="megakernel"), env=env,
                          lights=lights, camera=cam, multi_device=False)
            mk.render_frame()
            other = mk.hdr_image()
            check(f"{name} wavefront vs megakernel, share of pixels off",
                  pixel_share(got, other, PARITY_ATOL, PARITY_RTOL),
                  PARITY_PIXEL_SHARE)
            check(f"{name} wavefront vs megakernel, relative RMSE",
                  rel_rmse(got, other), PARITY_REL_RMSE)
        done(t0)


def full_width(width=W, height=H) -> None:
    import jax

    t0 = phase("width: GPU frame vs CPU frame")
    gpu = default_renderer(width, height, multi_device=False)
    gpu.render_frame()
    got, got_disp = gpu.hdr_image(), gpu.image()
    with jax.default_device(jax.devices("cpu")[0]):
        cpu = default_renderer(width, height, multi_device=False)
        tc = time.perf_counter()
        cpu.render_frame()
        want, want_disp = cpu.hdr_image(), cpu.image()
    print(f"  CPU backend frame seconds (compile included): "
          f"{time.perf_counter() - tc:.1f}", flush=True)
    print(f"  linear-radiance relative RMSE (not gated): "
          f"{rel_rmse(got, want):.6g}", flush=True)
    check(f"{width}x{height} GPU vs CPU, share of pixels off by > {WIDTH_DIFF:g}",
          pixel_share(got, want, WIDTH_DIFF), WIDTH_PIXEL_SHARE)
    check(f"{width}x{height} GPU vs CPU, display-image relative RMSE",
          rel_rmse(got_disp, want_disp), WIDTH_REL_RMSE)
    done(t0)


def multi(width=W, height=H, frames=16) -> int:
    import jax
    import numpy as np

    from spt_tpu.engine import state as state_mod

    n = len(jax.devices())
    if n != 4:
        fail(f"--multi needs four devices, JAX sees {n}")
    t0 = phase(f"multi: {width}x{height} chain over {n} cards vs one card")
    sharded = default_renderer(width, height)
    if sharded.mesh is None or sharded.mesh.devices.size != n:
        fail("the renderer did not shard over every card")
    single = default_renderer(width, height, multi_device=False)
    results = {}
    for name, r in (("4 cards", sharded), ("1 card", single)):
        r.render_frames(1)                      # compile
        # warm-up chain: on four cards the first chain after compiling ran
        # ~0.4 s longer than the ones after it
        r.render_frames(CHAIN)
        jax.block_until_ready(r.state.accum)
        dt, mrays = time_chain(r, CHAIN)
        print(f"  {name}: chain of {CHAIN}: {dt / CHAIN * 1e3:.3f} ms/frame, "
              f"{mrays:.2f} Mrays/s", flush=True)
        r.state = state_mod.reset(r.state)
        r.render_frames(frames)
        results[name] = (np.asarray(r.last_stats.rays_per_bounce, np.int64),
                         r.hdr_image(), r.image())
    (rays4, img4, disp4), (rays1, img1, disp1) = (results["4 cards"],
                                                  results["1 card"])
    print(f"  rays per bounce, 4 cards: {rays4.tolist()}", flush=True)
    print(f"  rays per bounce, 1 card:  {rays1.tolist()}", flush=True)
    check("per-bounce ray counts, max relative difference",
          float(np.max(np.abs(rays4 - rays1) / np.maximum(rays1, 1))),
          MULTI_RAYS_REL)
    check(f"{frames}-frame image, share of pixels off by > {WIDTH_DIFF:g}",
          pixel_share(img4, img1, WIDTH_DIFF), MULTI_PIXEL_SHARE)
    check(f"{frames}-frame display image, relative RMSE",
          rel_rmse(disp4, disp1), MULTI_REL_RMSE)
    done(t0)
    return n


def main(argv) -> None:
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        fail(f"no GPU: JAX's first device is {dev.platform}")
    t0 = phase("device")
    sys.path[:0] = [HERE, os.path.join(HERE, "tests")]
    from bench import card_line
    from spt_tpu.utils.cache import enable_default_cache

    card = card_line()
    if card is None:
        fail("nvidia-smi cannot read the card")
    print(card, flush=True)
    print(f"  jax {jax.__version__}, {dev.device_kind}, "
          f"{len(jax.devices())} visible", flush=True)

    enable_default_cache()
    done(t0)
    if "--multi" in argv:
        count = multi()
    else:
        main_path()
        oracle()
        full_width()
        count = 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind, "count": count}}))


if __name__ == "__main__":
    main(sys.argv[1:])
