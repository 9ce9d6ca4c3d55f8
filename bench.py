"""Benchmark harness: Mrays/s on the default scene at 1080p (BASELINE.md).

Prints ONE JSON line per scene:
  {"metric": "...", "value": N, "unit": "Mrays/s", "ms_per_frame": N, ...,
   "platform": "gpu", "device_kind": "...", "device_count": N,
   "card": "<nvidia-smi name>", "power_limit": "<nvidia-smi power.limit>"}

The headline metric is wavefront ray throughput (Mrays/s per device) on the
default scene at 1920x1080, the BASELINE.json north-star config.  Rays are
counted exactly — the per-bounce live-lane counts the wavefront integrator
reports (the reference's frame-0 telemetry, OptixBackend.cpp:1690-1695)
plus shadow rays (one per live surface lane per light when enabled).
"""

import json
import subprocess
import sys
import time

import jax
import numpy as np

from spt_tpu.camera import default_camera
from spt_tpu.config import RenderConfig
from spt_tpu.engine.renderer import Renderer
from spt_tpu.scene import build_default_scene


def card_line():
    """`nvidia-smi --query-gpu=name,power.limit` output, or None where
    there is no NVIDIA driver."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


def device_fields() -> dict:
    """What every result line says about the machine it was measured on."""
    dev = jax.devices()[0]
    line = card_line()
    name, _, limit = (line.splitlines()[0].partition(", ") if line
                      else (None, None, None))
    return {"platform": dev.platform, "device_kind": dev.device_kind,
            "device_count": jax.device_count(), "card": name,
            "power_limit": limit or None}


def shadow_rays_per_surface_lane(renderer) -> int:
    """Occlusion rays traced per surface-hit lane per bounce, derived from
    the renderer's ACTUAL light table and NEE configuration (a hardcoded
    n_lights=1 would miscount Cornell — zero analytic lights, one NEE ray —
    and undercount multi-light scenes)."""
    cfg = renderer.cfg
    if not cfg.shadow_rays:
        return 0
    kinds = np.asarray(renderer.lights.kind).reshape(-1)
    n_lights = int((kinds != 0).sum())  # KIND_NONE padding rows trace nothing real
    nee = int(cfg.nee and renderer.scene.emitters is not None)
    return n_lights + nee


def count_rays(stats, cfg, n_shadow: int) -> int:
    """Rays traced for one frame: per-bounce live lanes + shadow rays.

    Shadow rays: every live lane that hits a surface traces `n_shadow`
    occlusion rays (one per analytic light + one for NEE when emitters
    exist — see shadow_rays_per_surface_lane).  Live lanes at bounce b that
    survive to bounce b+1 all hit surfaces; lanes that terminated either
    missed (no shadow ray) or died at a surface (shadow rays traced).  We
    undercount conservatively by assuming terminated lanes missed — the
    reported Mrays/s is a lower bound.
    """
    rays = np.asarray(stats.rays_per_bounce, np.int64)
    primary_and_bounce = int(rays.sum())
    if n_shadow > 0 and rays.size > 1:
        shadow = int(rays[1:].sum()) * n_shadow  # lanes alive after bounce k hit a surface at bounce k-1
    else:
        shadow = 0
    return primary_and_bounce + shadow


def build_workload(scene_name: str, width: int, height: int):
    """The BASELINE.md benchmark configs (#1 default, #2 cornell, #3 gltf,
    #4 hdr, #5 anim)."""
    from spt_tpu.camera import Camera

    if scene_name == "hdr":
        import os
        import tempfile

        from spt_tpu.env import load_environment, synthetic_equirect
        from spt_tpu.io.hdr import write_hdr
        from spt_tpu.lights import LightManager
        from spt_tpu.scene import build_hdr_glass_scene

        # A real multi-MB .hdr file through the full IO pipeline (read_hdr
        # RGBE decode -> layout autodetect -> large-equirect gathers;
        # Cubemap.cpp:18-46,252-310 semantics).  1024x2048 deterministic
        # sun-sky, written once and cached.
        hdr_path = os.path.join(tempfile.gettempdir(),
                                "spt_bench_sunsky_1024.hdr")
        if not os.path.exists(hdr_path):
            write_hdr(hdr_path, synthetic_equirect(1024))
        lm = LightManager()
        lm.add_directional_light((0.4, -1.0, -0.3), (1.0, 0.95, 0.9), 1.0)
        cfg = RenderConfig(width=width, height=height, spp=1, max_depth=6)
        cam = Camera(position=(0, 2.0, 6.0), target=(0, 1.0, 0.0),
                     fov_degrees=50.0, aspect_ratio=width / height)
        return Renderer(build_hdr_glass_scene(), cfg,
                        env=load_environment(hdr_path),
                        lights=lm.device(), camera=cam)
    if scene_name == "cornell":
        from spt_tpu.scene import build_cornell_box_scene
        from spt_tpu.lights import LightManager

        cfg = RenderConfig(width=width, height=height, spp=1, max_depth=8)
        cam = Camera(position=(0, 2.75, 9.0), target=(0, 2.75, 0.0),
                     fov_degrees=50.0, aspect_ratio=width / height)
        return Renderer(build_cornell_box_scene(), cfg,
                        lights=LightManager().device(), camera=cam)
    if scene_name == "bigmesh":
        # Config #6: reference-scale mesh — a 4x4 chair grid (~98k tris),
        # instanced 16 times and traced as its flattened world soup.
        from spt_tpu.scene import build_chair_grid_scene

        desc, center, radius = build_chair_grid_scene()
        cfg = RenderConfig(width=width, height=height, spp=1, max_depth=4)
        cam = Camera(position=tuple(center + np.array([0.3, 0.35, 1.0])
                                    * radius),
                     target=tuple(center), fov_degrees=45.0,
                     aspect_ratio=width / height)
        return Renderer(desc, cfg, camera=cam)
    if scene_name == "stream":
        # Config #7: reference-scale UNIQUE mesh — the chair grid baked to
        # ~98k distinct triangles (the reference's any-mesh promise,
        # EmbreeBackend.cpp:181).  Same camera/rays as bigmesh.
        from spt_tpu.scene import build_unique_grid_scene

        desc, center, radius = build_unique_grid_scene()
        cfg = RenderConfig(width=width, height=height, spp=1, max_depth=4)
        cam = Camera(position=tuple(center + np.array([0.3, 0.35, 1.0])
                                    * radius),
                     target=tuple(center), fov_degrees=45.0,
                     aspect_ratio=width / height)
        return Renderer(desc, cfg, camera=cam)
    if scene_name == "gltf":
        from spt_tpu.io.gltf import bounding_box, load_gltf

        path = "/root/reference/assets/models/rattan_dining_chair/scene.gltf"
        desc = load_gltf(path)
        lo, hi = bounding_box(desc)
        center = (lo + hi) / 2
        extent = float(np.linalg.norm(hi - lo))
        cfg = RenderConfig(width=width, height=height, spp=1, max_depth=4)
        cam = Camera(position=center + np.array([0.0, 0.35, 1.1]) * extent,
                     target=center, fov_degrees=60.0,
                     aspect_ratio=width / height)
        return Renderer(desc, cfg, camera=cam)
    cfg = RenderConfig(width=width, height=height, spp=1, max_depth=6)
    return Renderer(build_default_scene(), cfg,
                    camera=default_camera(width, height))


def run_all():
    """One JSON line per BASELINE config, each in its own process, one at a
    time.  A JAX process reserves most of a card's memory when it first
    uses it, so this parent never initialises a backend itself."""
    import os
    import subprocess

    for scene in ("default", "cornell", "gltf", "hdr", "anim", "bigmesh",
                  "stream"):
        cmd = [sys.executable, os.path.abspath(__file__), "--scene", scene]
        try:
            out = subprocess.run(cmd, capture_output=True, text=True,
                                 timeout=900)
        except subprocess.TimeoutExpired:
            print(json.dumps({"metric": f"FAILED_{scene}",
                              "stderr": "timeout after 900 s"}), flush=True)
            continue
        lines = [l for l in out.stdout.splitlines() if l.startswith("{")]
        print(lines[-1] if lines else
              json.dumps({"metric": f"FAILED_{scene}",
                          "stderr": out.stderr[-500:]}), flush=True)


def main():
    from spt_tpu.utils.cache import enable_default_cache

    if "--all" in sys.argv:
        run_all()
        return
    enable_default_cache()
    # 128-frame chains: one dispatch and one host sync per chain, so their
    # fixed cost is spread over many frames (the frame step is a
    # lax.fori_loop, so chain length is free in compile).
    width, height = 1920, 1080
    warmup, iters = 2, 128
    scene_name = "default"
    if "--quick" in sys.argv:
        width, height, iters = 640, 480, 8
    if "--scene" in sys.argv:
        scene_name = sys.argv[sys.argv.index("--scene") + 1]
        if scene_name == "gltf":
            width, height = 512, 384
        if scene_name in ("bigmesh", "stream"):
            # shorter chains: these frames are ~10x the chair's
            width, height, iters = 512, 384, 32
        if scene_name == "stream":
            iters = 16
    if "--iters" in sys.argv:
        iters = int(sys.argv[sys.argv.index("--iters") + 1])

    # Config #5: the 1920x1080 progressive wavefront with an animated camera —
    # the camera orbits each frame, so every frame resets accumulation
    # (GLRenderer.cpp:145-161) and re-renders at spp 4 like the reference's
    # interactive default (main.cpp:108-109).  Uses the default scene.
    animate = scene_name == "anim"
    if animate:
        cfg = RenderConfig(width=width, height=height, spp=4, max_depth=6)
        r = Renderer(build_default_scene(), cfg,
                     camera=default_camera(width, height))
    else:
        r = build_workload(scene_name, width, height)
    cfg = r.cfg

    def advance_camera():
        if animate:
            # 2 degrees of orbit per frame (the --orbit CLI flag's math)
            r.camera.process_mouse(2.0 / r.camera.mouse_sensitivity, 0.0)

    r.camera.reset_movement_tracking()

    # Warm up with the SAME program the timed loop runs, so no compile is
    # timed.
    if animate:
        for _ in range(warmup):
            advance_camera()
            r.render_frame(check_camera=True)
    else:
        r.render_frames(iters)
    jax.block_until_ready(r.state.accum)

    # Median of several timed trials.  Static-camera configs run each chain
    # as ONE dispatch (render_frames); the animated config must step
    # per-frame for its camera-move accumulation resets.
    n_shadow = shadow_rays_per_surface_lane(r)
    trials = []
    for _ in range(3):
        t0 = time.perf_counter()
        if animate:
            frame_stats = []
            for _ in range(iters):
                advance_camera()
                r.render_frame(check_camera=True)
                frame_stats.append(r.last_stats)  # device arrays: no sync
            total = lambda: sum(count_rays(s, cfg, n_shadow)
                                for s in frame_stats)
        else:
            r.render_frames(iters)
            total = lambda: count_rays(r.last_stats, cfg, n_shadow)
        jax.block_until_ready(r.state.accum)  # one sync per chain
        dt = time.perf_counter() - t0
        trials.append((total() / dt / 1e6, dt / iters * 1e3))
    trials.sort()
    mrays, ms_per_frame = trials[len(trials) // 2]
    result = {
        "metric": f"wavefront_mrays_per_sec_{scene_name}_scene_{width}x{height}",
        "value": round(mrays, 2),
        "unit": "Mrays/s",
        # mesh scenes are miss-dominated (Mrays/s understates the work) —
        # report wall time per frame alongside.
        "ms_per_frame": round(ms_per_frame, 2),
        "spp": cfg.spp,
        "max_depth": cfg.max_depth,
        **device_fields(),
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
