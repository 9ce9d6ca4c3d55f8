"""Whole renders through `Renderer` against the scalar oracle.

The gate is the tests' usual one: relative RMSE < 1 % in linear radiance.
Mesh fixtures past the unrolled limit take the chunked trace route; the
wavefront and the megakernel must agree on it as they do on small scenes.
"""

import numpy as np
import pytest

import fixture_scenes as fx
import reference_cpu as ref
from spt_tpu.config import RenderConfig
from spt_tpu.engine.renderer import Renderer
from spt_tpu.lights import LightManager, default_lights
from spt_tpu.ops.intersect import UNROLL_LIMIT


def _rel_rmse(got, want):
    err = np.sqrt(np.mean((np.asarray(got) - np.asarray(want)) ** 2))
    return float(err / (np.sqrt(np.mean(np.asarray(want) ** 2)) + 1e-9))


def _renderer(name, cfg, lights=None, **kw):
    desc = fx.seeded_mesh() if name == "seeded_mesh" else fx.ALL[name]()
    if lights is None:
        lights = (LightManager().device() if name == "cornell"
                  else default_lights())
    return Renderer(desc, cfg, lights=lights,
                    camera=fx.camera(name, cfg.width, cfg.height),
                    multi_device=False, **kw)


class TestRendererVsOracle:
    @pytest.mark.parametrize("name", ["soup", "smooth_sphere",
                                      "instanced_grid", "cornell", "mixed",
                                      "degenerate", "seeded_mesh"])
    def test_frame_matches_oracle(self, name):
        cfg = RenderConfig(width=24, height=18, spp=1, max_depth=3)
        r = _renderer(name, cfg)
        r.render_frame()
        got = r.hdr_image()
        want = ref.render_image(cfg, ref.NpScene(r.scene),
                                ref.lights_from_device(r.lights), r.camera,
                                frame=0)
        assert want.std() > 0.01, "the fixture must be in view"
        assert _rel_rmse(got, want) < 0.01

    def test_mesh_fixtures_take_the_chunked_route(self):
        for name in ("soup", "smooth_sphere", "instanced_grid", "mixed",
                     "seeded_mesh"):
            desc = fx.seeded_mesh() if name == "seeded_mesh" else fx.ALL[name]()
            from spt_tpu.scene import flatten_scene

            dev = flatten_scene(desc)
            assert dev.num_triangles + dev.num_spheres > UNROLL_LIMIT, name


class TestWavefrontEqualsMegakernelOnMeshes:
    @pytest.mark.parametrize("name", ["seeded_mesh", "soup",
                                      "instanced_grid"])
    def test_same_frame(self, name):
        cfg = RenderConfig(width=20, height=15, spp=1, max_depth=3)
        wf = _renderer(name, cfg)
        mk = _renderer(name, cfg.replace(integrator="megakernel"))
        wf.render_frame()
        mk.render_frame()
        np.testing.assert_allclose(wf.hdr_image(), mk.hdr_image(),
                                   rtol=1e-3, atol=5e-4)


class TestOddLaneCounts:
    @pytest.mark.parametrize("width,height", [(17, 1), (13, 11)])
    def test_small_frames_match_oracle(self, width, height):
        cfg = RenderConfig(width=width, height=height, spp=1, max_depth=3)
        r = _renderer("default", cfg)
        r.render_frame()
        stats = np.asarray(r.last_stats.rays_per_bounce)
        assert stats[0] == width * height
        want = ref.render_image(cfg, ref.NpScene(r.scene),
                                ref.lights_from_device(r.lights), r.camera,
                                frame=0)
        assert _rel_rmse(r.hdr_image(), want) < 0.01

    def test_reference_resolution(self):
        # the reference's 800x600 window (GLRenderer.h:34-35)
        cfg = RenderConfig(width=800, height=600, spp=1, max_depth=2)
        r = _renderer("default", cfg)
        r.render_frames(2)
        rays = np.asarray(r.last_stats.rays_per_bounce)
        assert rays[0] == 2 * 800 * 600 and rays[1] <= rays[0]
        img = r.image()
        assert img.shape == (600, 800, 3) and np.isfinite(img).all()
