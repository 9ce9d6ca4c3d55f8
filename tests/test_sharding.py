"""Multi-device scaling on the 8-device CPU-simulated mesh (SURVEY.md §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from spt_tpu.camera import default_camera
from spt_tpu.config import RenderConfig
from spt_tpu.engine import state as state_mod
from spt_tpu.env import make_procedural_environment
from spt_tpu.integrators.wavefront import render_wavefront
from spt_tpu.lights import default_lights
from spt_tpu.parallel import make_mesh, shard_pixels, sharded_frame_step
from spt_tpu.parallel.sharding import replicate
from spt_tpu.scene import build_default_scene, flatten_scene

CFG = RenderConfig(width=32, height=32, spp=1, max_depth=4)


@pytest.fixture(scope="module")
def setup():
    assert jax.device_count() >= 8, "conftest must provide 8 virtual devices"
    scene = flatten_scene(build_default_scene())
    env = make_procedural_environment()
    lights = default_lights()
    cam = default_camera(CFG.width, CFG.height).rays()
    return scene, env, lights, cam


class TestShardedRender:
    def test_matches_single_device(self, setup):
        scene, env, lights, cam = setup
        # single-device reference
        want, want_stats = render_wavefront(CFG, scene, env, lights, cam, 0)
        want = np.asarray(want)

        mesh = make_mesh(jax.devices()[:8])
        step = sharded_frame_step(CFG, mesh)
        rstate = shard_pixels(mesh, state_mod.init_state(CFG.num_pixels))
        scene_r = replicate(mesh, scene)
        env_r = replicate(mesh, env)
        lights_r = replicate(mesh, lights)
        cam_r = replicate(mesh, cam)

        new_state, stats = step(scene_r, env_r, lights_r, cam_r, rstate)
        got = np.asarray(new_state.accum).reshape(CFG.height, CFG.width, 3) / CFG.spp

        # identical rays and RNG -> exact ray counts; radiance matches to
        # float tolerance (different XLA programs schedule fma differently).
        np.testing.assert_array_equal(
            np.asarray(stats.rays_per_bounce), np.asarray(want_stats.rays_per_bounce)
        )
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=5e-4)

    def test_two_device_mesh(self, setup):
        scene, env, lights, cam = setup
        mesh = make_mesh(jax.devices()[:2])
        step = sharded_frame_step(CFG, mesh)
        rstate = shard_pixels(mesh, state_mod.init_state(CFG.num_pixels))
        new_state, stats = step(
            replicate(mesh, scene), replicate(mesh, env),
            replicate(mesh, lights), replicate(mesh, cam), rstate,
        )
        assert int(new_state.frame_index) == 1
        assert float(new_state.sample_count) == CFG.spp
        assert int(np.asarray(stats.rays_per_bounce)[0]) == CFG.num_pixels

    def test_progressive_sharded(self, setup):
        scene, env, lights, cam = setup
        mesh = make_mesh(jax.devices()[:4])
        step = sharded_frame_step(CFG, mesh)
        rstate = shard_pixels(mesh, state_mod.init_state(CFG.num_pixels))
        args = (replicate(mesh, scene), replicate(mesh, env),
                replicate(mesh, lights), replicate(mesh, cam))
        for i in range(3):
            rstate, _ = step(*args, rstate)
        assert float(rstate.sample_count) == 3 * CFG.spp
        assert int(rstate.frame_index) == 3
        img = np.asarray(rstate.accum)
        assert np.isfinite(img).all() and img.max() > 0


class TestShardedRenderer:
    def test_renderer_uses_mesh_automatically(self):
        from spt_tpu.camera import default_camera
        from spt_tpu.engine.renderer import Renderer
        from spt_tpu.scene import build_default_scene

        cfg = CFG.replace(width=32, height=32)  # 32 rows / 8 devices = 4
        r = Renderer(build_default_scene(), cfg,
                     camera=default_camera(cfg.width, cfg.height))
        assert r.mesh is not None and r.mesh.devices.size == jax.device_count()
        r.render_frame(check_camera=False)
        r.render_frame(check_camera=False)
        assert r.accumulated_samples == 2 * cfg.spp
        img = r.image()
        assert np.isfinite(img).all() and img.max() > 0

        # matches the single-device renderer
        r1 = Renderer(build_default_scene(), cfg, multi_device=False,
                      camera=default_camera(cfg.width, cfg.height))
        r1.render_frame(check_camera=False)
        r1.render_frame(check_camera=False)
        np.testing.assert_allclose(img, r1.image(), rtol=1e-3, atol=2e-3)

    def test_accel_scene_sharded_matches_single(self):
        # a mesh scene past the unrolled limit (chunked route) on a device
        # mesh: the triangle tables replicate with the rest of the scene
        # and the sharded render is radiometrically the single-device one
        from spt_tpu.camera import Camera
        from spt_tpu.engine.renderer import Renderer
        from spt_tpu.scene import SceneDesc
        from spt_tpu.scene.desc import Material, MeshData

        rng = np.random.default_rng(11)
        nv = 200
        sc = SceneDesc()
        sc.add_material(Material(base_color=(0.7, 0.5, 0.3)))
        mid = sc.add_mesh(MeshData(
            positions=rng.uniform(-1.5, 1.5, (nv, 3)).astype(np.float32),
            indices=rng.integers(0, nv, (400, 3)).astype(np.uint32)))
        sc.add_instance(mid)
        cfg = CFG.replace(width=32, height=32, max_depth=3)
        cam = Camera(position=(0, 0, 5.0), target=(0, 0, 0),
                     fov_degrees=50.0, aspect_ratio=1.0)
        r8 = Renderer(sc, cfg, camera=cam)
        assert r8.mesh is not None
        from spt_tpu.ops.intersect import UNROLL_LIMIT

        assert r8.scene.num_triangles > UNROLL_LIMIT
        r8.render_frame(check_camera=False)
        r1 = Renderer(sc, cfg, camera=cam, multi_device=False)
        r1.render_frame(check_camera=False)
        np.testing.assert_allclose(r8.image(), r1.image(),
                                   rtol=1e-3, atol=2e-3)

    def test_renderer_odd_height_falls_back(self):
        from spt_tpu.engine.renderer import Renderer
        from spt_tpu.scene import build_default_scene

        cfg = CFG.replace(width=16, height=15)  # 15 rows don't shard over 8
        r = Renderer(build_default_scene(), cfg)
        assert r.mesh is None
        r.render_frame(check_camera=False)
        assert np.isfinite(r.image()).all()


class TestShardedDynChain:
    """The mesh step is the dynamic-k chain
    (parallel.sharded_frame_step_dyn) — render_frames on a device mesh is
    ONE dispatch, equal to per-frame stepping."""

    def test_chain_equals_per_frame_stepping(self):
        from spt_tpu.camera import default_camera
        from spt_tpu.engine.renderer import Renderer
        from spt_tpu.scene import build_default_scene

        cfg = CFG.replace(width=32, height=32)
        r_chain = Renderer(build_default_scene(), cfg,
                           camera=default_camera(cfg.width, cfg.height))
        assert r_chain.mesh is not None
        r_chain.render_frames(3)
        assert r_chain.accumulated_samples == 3 * cfg.spp
        assert int(r_chain.last_stats.rays_per_bounce[0]) == 3 * cfg.num_pixels

        r_step = Renderer(build_default_scene(), cfg,
                          camera=default_camera(cfg.width, cfg.height))
        for _ in range(3):
            r_step.render_frame(check_camera=False)
        np.testing.assert_allclose(r_chain.image(), r_step.image(),
                                   rtol=1e-5, atol=1e-6)

    def test_chain_matches_single_chip_chain(self):
        from spt_tpu.camera import default_camera
        from spt_tpu.engine.renderer import Renderer
        from spt_tpu.scene import build_default_scene

        cfg = CFG.replace(width=32, height=32)
        r8 = Renderer(build_default_scene(), cfg,
                      camera=default_camera(cfg.width, cfg.height))
        assert r8.mesh is not None
        r8.render_frames(2)
        r1 = Renderer(build_default_scene(), cfg, multi_device=False,
                      camera=default_camera(cfg.width, cfg.height))
        r1.render_frames(2)
        np.testing.assert_allclose(r8.image(), r1.image(),
                                   rtol=1e-3, atol=2e-3)
