"""Interpolated (smooth) shading normals across every intersector.

The reference loads per-vertex NORMALs (GLTFLoader.cpp:219-331) and
transforms them per instance (EmbreeBackend.cpp:60-79) — then both its
backends shade with the geometric Ng anyway.  Here the vertex normals are
carried all the way: DeviceScene.tri_ns (on a 12-bit grid), interpolated at
the winning hit with a per-lane fallback to Ng where a mesh has no NORMAL
attribute.  These tests pin (a) the interpolation against the analytic
sphere normal, (b) parity between the unrolled and chunked intersectors,
and (c) that flat scenes drop the table entirely.
"""

import jax.numpy as jnp
import numpy as np

from spt_tpu.ops import intersect as isect
from spt_tpu.ops.vec3 import Vec3
from spt_tpu.scene import SceneDesc, flatten_scene
from spt_tpu.scene.desc import Material, create_sphere_mesh


def _sphere_scene(stacks=16, slices=24):
    sc = SceneDesc()
    sc.add_material(Material(base_color=[0.8, 0.6, 0.4]))
    mid = sc.add_mesh(create_sphere_mesh(stacks, slices, radius=1.0,
                                         material_id=0))
    sc.add_instance(mid)
    return flatten_scene(sc)


def _rays_at_sphere(n=512, seed=3):
    rng = np.random.default_rng(seed)
    # rays from a shell toward the origin: all hit the unit sphere
    d = rng.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o = -3.0 * d
    return (Vec3.from_array(jnp.asarray(o.astype(np.float32))),
            Vec3.from_array(jnp.asarray(d.astype(np.float32))))


def _unit(a):
    return a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-20)


def _normals(hit):
    return np.stack([np.asarray(hit.normal.x), np.asarray(hit.normal.y),
                     np.asarray(hit.normal.z)], -1)


class TestNsPacking:
    def test_roundtrip_idempotent_and_bounded(self):
        """quantize(x) is within half a 12-bit step of clip(x), and a second
        quantize is EXACT (the grid is a fixed point)."""
        from spt_tpu.scene.flatten import NS_STEP, quantize_ns

        rng = np.random.default_rng(0)
        ns = rng.uniform(-2.3, 2.3, (4096, 9)).astype(np.float32)
        ns[:7] = 0.0  # sentinel rows
        q1 = quantize_ns(ns)
        err = np.abs(q1 - np.clip(ns, -2.0, 2.0))
        assert err[7:].max() <= 0.5001 * float(NS_STEP)
        assert (q1[:7] == 0.0).all()
        q2 = quantize_ns(q1)
        np.testing.assert_array_equal(q1, q2)

    def test_grid_values_roundtrip_exact(self):
        from spt_tpu.scene.flatten import NS_STEP, quantize_ns

        q = np.arange(1, 4096, dtype=np.float32)
        v = (q - np.float32(1.0)) * NS_STEP - np.float32(2.0)
        ns = np.zeros((v.shape[0], 9), np.float32)
        ns[:, 0] = v
        ns[:, 4] = v[::-1]
        out = quantize_ns(ns)
        np.testing.assert_array_equal(out[:, 0], ns[:, 0])
        np.testing.assert_array_equal(out[:, 4], ns[:, 4])


class TestSmoothVsAnalytic:
    def test_interpolated_beats_geometric_on_sphere(self):
        """On a coarse UV-sphere the interpolated normal must track the
        analytic normal far better than the facet normal does."""
        dev = _sphere_scene()
        assert dev.tri_ns is not None
        ov, dv = _rays_at_sphere()
        hit = isect._intersect_chunked(dev, ov, dv, np.float32(0.0),
                                       np.float32(np.inf))
        t = np.asarray(hit.t)
        hm = np.isfinite(t)
        assert hm.mean() > 0.95
        p = np.stack([np.asarray(ov.x + hit.t * dv.x),
                      np.asarray(ov.y + hit.t * dv.y),
                      np.asarray(ov.z + hit.t * dv.z)], -1)[hm]
        exact = _unit(p)
        got = _unit(_normals(hit)[hm])
        dots = (got * exact).sum(1)
        # a 16x24 sphere's FACET normals deviate by up to ~8 degrees;
        # interpolated ones stay within ~1
        assert np.quantile(dots, 0.05) > np.cos(np.deg2rad(2.0)), (
            np.quantile(dots, 0.05))

        flat = dev._replace(tri_ns=None)
        hitf = isect._intersect_chunked(flat, ov, dv, np.float32(0.0),
                                        np.float32(np.inf))
        gotf = _unit(_normals(hitf)[hm])
        assert (gotf * exact).sum(1).mean() < dots.mean()

    def test_unrolled_matches_chunked(self):
        dev = _sphere_scene(stacks=6, slices=8)  # small: unrolled-eligible
        ov, dv = _rays_at_sphere(n=128, seed=7)
        a = isect._intersect_unrolled(dev, ov, dv, np.float32(0.0),
                                      np.float32(np.inf))
        b = isect._intersect_chunked(dev, ov, dv, np.float32(0.0),
                                     np.float32(np.inf))
        hm = np.isfinite(np.asarray(a.t)) & np.isfinite(np.asarray(b.t))
        na, nb = _unit(_normals(a)[hm]), _unit(_normals(b)[hm])
        assert ((na * nb).sum(1) > 0.9999).mean() > 0.99


class TestFlatScenesPayNothing:
    def test_default_scene_has_no_ns_table(self):
        from spt_tpu.scene import build_default_scene

        dev = flatten_scene(build_default_scene())
        # plane normals == winding normal, cube has none: table dropped
        assert dev.tri_ns is None

    def test_spt_ns_0_forces_flat(self, monkeypatch):
        # SPT_NS=0: the quality/speed knob drops shading normals at
        # flatten time — no tri_ns, flat shading (the reference backends'
        # behavior).
        from spt_tpu.scene.desc import create_sphere_mesh

        sc = SceneDesc()
        sc.add_material(Material())
        sc.add_instance(sc.add_mesh(create_sphere_mesh(8, 12, radius=1.0,
                                                       material_id=0)))
        smooth = flatten_scene(sc)
        assert smooth.tri_ns is not None
        monkeypatch.setenv("SPT_NS", "0")
        flat = flatten_scene(sc)
        assert flat.tri_ns is None

    def test_soup_mesh_has_no_ns_table(self):
        rng = np.random.default_rng(5)
        from spt_tpu.scene.desc import MeshData

        sc = SceneDesc()
        sc.add_material(Material())
        nv = 50
        sc.add_instance(sc.add_mesh(MeshData(
            positions=rng.uniform(-1, 1, (nv, 3)).astype(np.float32),
            indices=rng.integers(0, nv, (80, 3)).astype(np.uint32))))
        dev = flatten_scene(sc)
        assert dev.tri_ns is None


class TestOracleParity:
    def test_megakernel_matches_oracle_on_smooth_sphere(self):
        import reference_cpu as ref
        from spt_tpu.camera import Camera
        from spt_tpu.config import RenderConfig
        from spt_tpu.env import make_procedural_environment
        from spt_tpu.integrators.megakernel import render_megakernel
        from spt_tpu.lights import default_lights

        dev = _sphere_scene(stacks=8, slices=12)
        env = make_procedural_environment()
        lights = default_lights()
        cam = Camera(position=(0, 0.5, 3.0), target=(0, 0, 0),
                     fov_degrees=50.0, aspect_ratio=4 / 3)
        cfg = RenderConfig(width=32, height=24, spp=1, max_depth=3)
        img = np.asarray(render_megakernel(cfg, dev, env, lights,
                                           cam.rays(), 0))
        want = ref.render_image(cfg, ref.NpScene(dev),
                                ref.lights_from_device(lights), cam, frame=0)
        err = float(np.sqrt(np.mean((img - want) ** 2)))
        scale = float(np.sqrt(np.mean(want ** 2))) + 1e-9
        assert err / scale < 0.01, f"relative RMSE {err/scale:.4f}"
