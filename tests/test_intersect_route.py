"""The plain-XLA trace route, ray by ray, against the scalar oracle.

`intersect_v` / `occluded_v` pick the unrolled intersector up to
UNROLL_LIMIT primitives and the chunked broadcast one beyond it.  Both are
held here to `reference_cpu.intersect` / `occluded` on the scene fixtures,
across the route boundary, over chunk sizes that do not divide the
triangle count, and at lane counts of any size.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import fixture_scenes as fx
import reference_cpu as ref
from spt_tpu.ops import intersect as isect
from spt_tpu.ops.vec3 import Vec3
from spt_tpu.scene import SceneDesc, flatten_scene
from spt_tpu.scene.desc import Material, MeshData

TMIN = 1e-4


def _vec(a):
    return Vec3.from_array(jnp.asarray(a))


def _unit(a):
    return a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-20)


def _degenerate_rays():
    """Random rays plus rays lying in the planes of the edge-on
    triangles."""
    rng = np.random.default_rng(9)
    o = rng.uniform(-1, 1, (192, 3)) + np.float32([0.0, 0.0, 1.0])
    target = rng.uniform([-2, -1, -4], [2, 1.5, -1.5], (192, 3))
    d = _unit(target - o)
    flat_o = np.stack([rng.uniform(-2, 2, 32), np.full(32, -0.5),
                       rng.uniform(-4, 0, 32)], -1)
    flat_d = np.stack([rng.normal(size=32), np.zeros(32),
                       rng.normal(size=32)], -1)
    wall_o = np.stack([np.full(32, -1.5), rng.uniform(-1, 1, 32),
                       rng.uniform(-4, 0, 32)], -1)
    wall_d = np.stack([np.zeros(32), rng.normal(size=32),
                       rng.normal(size=32)], -1)
    o = np.concatenate([o, flat_o, wall_o]).astype(np.float32)
    d = np.concatenate([d, _unit(flat_d), _unit(wall_d)]).astype(np.float32)
    return o, d


def _aimed_rays(n, seed, center=(0.0, 0.0, 0.0), spread=3.0, reach=1.0):
    """Origins in a box of half-size `spread`, aimed at points within
    `reach` of `center`, so most rays meet the content."""
    rng = np.random.default_rng(seed)
    c = np.float32(center)
    o = c + rng.uniform(-spread, spread, (n, 3))
    d = _unit(c + rng.uniform(-reach, reach, (n, 3)) - o)
    return o.astype(np.float32), d.astype(np.float32)


def _rays_for(name):
    if name == "degenerate":
        return _degenerate_rays()
    if name == "cornell":
        return _aimed_rays(256, 1, (0.0, 2.75, 0.0), spread=2.5, reach=2.5)
    return _aimed_rays(256, 2)


def check_closest(dev, hit, o, d, tmax=np.inf):
    """Every ray's hit against the oracle: at most 0.5 % of rays may
    disagree on hit/miss (a ray grazing an edge), and where both hit, t,
    material, kind and normal direction agree."""
    nps = ref.NpScene(dev)
    t = np.asarray(hit.t)
    kind = np.asarray(hit.kind)
    mat = np.asarray(hit.mat_id)
    nrm = _unit(np.asarray(hit.normal.to_array()))
    disagree = 0
    both = 0
    for i in range(len(o)):
        t_r, n_r, m_r, k_r = ref.intersect(nps, o[i], d[i], TMIN, tmax)
        if np.isfinite(t_r) != np.isfinite(t[i]):
            disagree += 1
            continue
        if not np.isfinite(t_r):
            assert kind[i] == isect.KIND_MISS
            continue
        both += 1
        assert abs(t[i] - t_r) <= 1e-4 * max(1.0, t_r), (i, t[i], t_r)
        assert kind[i] == k_r and mat[i] == m_r, (i, kind[i], k_r, mat[i], m_r)
        assert float(nrm[i] @ _unit(n_r)) > 0.999, (i, nrm[i], n_r)
    assert disagree <= 0.005 * len(o), disagree
    return both


def check_occluded(dev, blocked, o, d, tmax):
    nps = ref.NpScene(dev)
    blocked = np.asarray(blocked)
    want = np.array([ref.occluded(nps, o[i], d[i], TMIN, tmax)
                     for i in range(len(o))])
    assert (blocked != want).sum() <= 0.005 * len(o)
    return int(want.sum())


ROUTES = {
    "auto": (isect.intersect_v, isect.occluded_v),
    "chunked": (isect._intersect_chunked, isect._occluded_chunked),
}


class TestClosestHitVsOracle:
    @pytest.mark.parametrize("name", sorted(fx.ALL))
    def test_auto_route(self, name):
        dev = flatten_scene(fx.ALL[name]())
        o, d = _rays_for(name)
        hit = isect.intersect_v(dev, _vec(o), _vec(d), tmin=TMIN)
        assert check_closest(dev, hit, o, d) > 20, "fixture must be hit"

    @pytest.mark.parametrize("name", ["cornell", "degenerate", "default"])
    def test_small_scene_on_chunked_route(self, name):
        dev = flatten_scene(fx.ALL[name]())
        assert isect._use_unrolled(dev)
        o, d = _rays_for(name)
        hit = isect._intersect_chunked(dev, _vec(o), _vec(d), TMIN, isect.INF)
        assert check_closest(dev, hit, o, d) > 20


class TestAnyHitVsOracle:
    @pytest.mark.parametrize("name", sorted(fx.ALL))
    def test_auto_route(self, name):
        dev = flatten_scene(fx.ALL[name]())
        o, d = _rays_for(name)
        blocked = isect.occluded_v(dev, _vec(o), _vec(d), tmin=TMIN,
                                   tmax=3.5)
        assert check_occluded(dev, blocked, o, d, 3.5) > 10

    @pytest.mark.parametrize("name", ["cornell", "degenerate", "default"])
    def test_small_scene_on_chunked_route(self, name):
        dev = flatten_scene(fx.ALL[name]())
        o, d = _rays_for(name)
        blocked = isect._occluded_chunked(dev, _vec(o), _vec(d), TMIN, 3.5)
        assert check_occluded(dev, blocked, o, d, 3.5) > 10


class TestDegenerateTriangles:
    def test_zero_area_and_collinear_never_hit(self):
        dev = flatten_scene(fx.degenerate())
        o, d = _degenerate_rays()
        for route in ROUTES.values():
            hit = route[0](dev, _vec(o), _vec(d), TMIN, isect.INF)
            idx = np.asarray(hit.kind) == isect.KIND_TRIANGLE
            # the hit triangle is recovered by its material-free normal:
            # degenerate ones have a zero cross product
            n = np.asarray(hit.normal.to_array())[idx]
            assert (np.linalg.norm(n, axis=1) > 1e-6).all()

    def test_rays_in_an_edge_on_plane_pass_through(self):
        dev = flatten_scene(fx.degenerate())
        o, d = _degenerate_rays()
        o, d = o[192:], d[192:]        # the in-plane rays
        want = [ref.intersect(ref.NpScene(dev), o[i], d[i], TMIN)[0]
                for i in range(len(o))]
        for route in ROUTES.values():
            hit = route[0](dev, _vec(o), _vec(d), TMIN, isect.INF)
            np.testing.assert_array_equal(np.isfinite(np.asarray(hit.t)),
                                          np.isfinite(want))


class TestRouteBoundary:
    @pytest.mark.parametrize("n,unrolled", [(3, True), (191, True),
                                            (192, True), (193, False),
                                            (500, False)])
    def test_use_unrolled(self, n, unrolled):
        dev = self._scene(n)
        assert dev.num_triangles + dev.num_spheres == n
        assert isect._use_unrolled(dev) is unrolled

    @staticmethod
    def _scene(n_prims):
        """A ground quad (2 triangles) and n_prims - 2 small spheres."""
        rng = np.random.default_rng(n_prims)
        sc = SceneDesc()
        _ = [sc.add_material(Material(base_color=[0.1 * i, 0.5, 0.5]))
             for i in range(3)]
        sc.add_instance(sc.add_mesh(MeshData(
            positions=[[-4, -1, -4], [4, -1, -4], [4, -1, 4], [-4, -1, 4]],
            indices=[[0, 2, 1], [0, 3, 2]], material_id=0)))
        for i in range(n_prims - 2):
            sc.add_sphere(rng.uniform(-2.5, 2.5, 3).tolist(),
                          float(rng.uniform(0.1, 0.3)), 1 + i % 2)
        return flatten_scene(sc)

    @pytest.mark.parametrize("n_prims", [192, 193])
    def test_closest_on_both_sides(self, n_prims, monkeypatch):
        dev = self._scene(n_prims)
        taken = []
        orig = isect._intersect_unrolled
        monkeypatch.setattr(isect, "_intersect_unrolled",
                            lambda *a: taken.append(1) or orig(*a))
        o, d = fx.rays(256, seed=n_prims)
        hit = isect.intersect_v(dev, _vec(o), _vec(d), tmin=TMIN)
        assert bool(taken) == (n_prims <= isect.UNROLL_LIMIT)
        assert check_closest(dev, hit, o, d) > 50

    @pytest.mark.parametrize("n_prims", [192, 193])
    def test_any_on_both_sides(self, n_prims, monkeypatch):
        dev = self._scene(n_prims)
        taken = []
        orig = isect._occluded_unrolled
        monkeypatch.setattr(isect, "_occluded_unrolled",
                            lambda *a: taken.append(1) or orig(*a))
        o, d = fx.rays(256, seed=n_prims)
        blocked = isect.occluded_v(dev, _vec(o), _vec(d), tmin=TMIN, tmax=3.0)
        assert bool(taken) == (n_prims <= isect.UNROLL_LIMIT)
        assert check_occluded(dev, blocked, o, d, 3.0) > 20


class TestChunkSizes:
    @pytest.mark.parametrize("n,target,want", [
        (300, 128, 100), (300, 7, 6), (97, 128, 97), (97, 10, 1),
        (256, 128, 128), (1, 128, 1)])
    def test_chunk_divides(self, n, target, want):
        assert isect._chunk(n, target) == want

    @pytest.fixture(scope="class")
    def soup_case(self):
        dev = flatten_scene(fx.mixed())          # 150 tris, 60 spheres
        o, d = fx.rays(256, seed=6)
        base = isect._intersect_chunked(dev, _vec(o), _vec(d), TMIN, isect.INF)
        blocked = isect._occluded_chunked(dev, _vec(o), _vec(d), TMIN, 2.0)
        return dev, o, d, base, blocked

    @pytest.mark.parametrize("chunk", [1, 7, 13, 64, 1000])
    def test_closest_independent_of_chunk(self, soup_case, chunk):
        # the same tests in another grouping: t may move in its last bits
        # (XLA fuses each chunk shape differently), the winner may not
        dev, o, d, base, _ = soup_case
        hit = isect._intersect_chunked(dev, _vec(o), _vec(d), TMIN, isect.INF,
                                       chunk_size=chunk)
        np.testing.assert_allclose(np.asarray(hit.t), np.asarray(base.t),
                                   rtol=1e-5)
        for a, b in ((hit.kind, base.kind), (hit.mat_id, base.mat_id)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        np.testing.assert_allclose(np.asarray(hit.normal.to_array()),
                                   np.asarray(base.normal.to_array()),
                                   rtol=1e-5, atol=1e-6)

    @pytest.mark.parametrize("chunk", [1, 7, 13, 64, 1000])
    def test_any_independent_of_chunk(self, soup_case, chunk):
        dev, o, d, _, base = soup_case
        blocked = isect._occluded_chunked(dev, _vec(o), _vec(d), TMIN, 2.0,
                                          chunk_size=chunk)
        np.testing.assert_array_equal(np.asarray(blocked), np.asarray(base))


class TestLaneCounts:
    @pytest.mark.parametrize("n", [1, 17, 129])
    @pytest.mark.parametrize("name", ["default", "soup"])
    def test_any_lane_count(self, name, n):
        dev = flatten_scene(fx.ALL[name]())
        o, d = fx.rays(n, seed=n)
        o = o * 0.3                              # start near the content
        hit = isect.intersect_v(dev, _vec(o), _vec(d), tmin=TMIN)
        assert hit.t.shape == (n,)
        check_closest(dev, hit, o, d)
        blocked = isect.occluded_v(dev, _vec(o), _vec(d), tmin=TMIN, tmax=2.0)
        assert blocked.shape == (n,)
        check_occluded(dev, blocked, o, d, 2.0)


class TestTextureCoordinates:
    def test_chunked_uv_matches_unrolled(self):
        dev = flatten_scene(fx.textured_grid(cells=(2, 2)))   # 8 triangles
        assert isect._use_unrolled(dev)
        rng = np.random.default_rng(5)
        n = 512
        o = np.stack([rng.uniform(-0.95, 0.95, n), rng.uniform(-0.95, 0.95, n),
                      np.full(n, 2.0)], -1).astype(np.float32)
        d = np.tile(np.float32([[0.0, 0.0, -1.0]]), (n, 1))
        a = isect._intersect_unrolled(dev, _vec(o), _vec(d), 1e-3, isect.INF)
        b = isect._intersect_chunked(dev, _vec(o), _vec(d), 1e-3, isect.INF)
        assert np.asarray(a.hit_mask).all()
        np.testing.assert_allclose(np.asarray(a.uvx), np.asarray(b.uvx),
                                   atol=1e-5)
        np.testing.assert_allclose(np.asarray(a.uvy), np.asarray(b.uvy),
                                   atol=1e-5)

    def test_grid_uv_is_planar_map(self):
        dev = flatten_scene(fx.textured_grid())          # 256 triangles
        assert not isect._use_unrolled(dev)
        rng = np.random.default_rng(6)
        n = 512
        x, y = rng.uniform(-0.99, 0.99, n), rng.uniform(-0.99, 0.99, n)
        o = np.stack([x, y, np.full(n, 3.0)], -1).astype(np.float32)
        d = np.tile(np.float32([[0.0, 0.0, -1.0]]), (n, 1))
        hit = isect.intersect_v(dev, _vec(o), _vec(d), tmin=1e-3)
        np.testing.assert_allclose(np.asarray(hit.uvx), (x + 1) / 2, atol=1e-5)
        np.testing.assert_allclose(np.asarray(hit.uvy), (1 - y) / 2, atol=1e-5)
