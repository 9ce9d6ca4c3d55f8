"""Environment: procedural sky + equirect HDR sampling."""

import jax.numpy as jnp
import numpy as np
import pytest

from spt_tpu import env as env_mod

import reference_cpu as ref


class TestProceduralSky:
    def test_matches_scalar_formula(self, rng):
        d = rng.normal(size=(64, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        got = np.asarray(env_mod.procedural_sky(jnp.asarray(d)))
        for i in range(64):
            np.testing.assert_allclose(got[i], ref.sky_color(d[i]), rtol=1e-4, atol=1e-5)

    def test_zenith_bluer_than_horizon(self):
        up = np.asarray(env_mod.procedural_sky(jnp.array([[0.0, 1.0, 0.0]])))[0]
        # zenith: blue channel dominates
        assert up[2] > up[0]

    def test_sun_disk_bright(self):
        sun = env_mod.SUN_DIRECTION.astype(np.float32)
        c_sun = np.asarray(env_mod.procedural_sky(jnp.asarray(sun[None])))[0]
        c_away = np.asarray(env_mod.procedural_sky(jnp.array([[0.0, 0.3, 1.0]])))[0]
        assert c_sun.sum() > c_away.sum() + 0.5


class TestEquirect:
    def test_constant_image(self, rng):
        img = jnp.full((8, 16, 3), 3.0)
        d = rng.normal(size=(32, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        got = np.asarray(env_mod.sample_equirect(img, jnp.asarray(d)))
        np.testing.assert_allclose(got, 3.0, atol=1e-5)

    def test_direction_mapping(self):
        # +y must sample the top row, -y the bottom row.
        img = np.zeros((4, 8, 3), np.float32)
        img[0] = [1, 0, 0]
        img[-1] = [0, 1, 0]
        up = np.asarray(env_mod.sample_equirect(jnp.asarray(img), jnp.array([[0.0, 1.0, 0.0]])))[0]
        down = np.asarray(env_mod.sample_equirect(jnp.asarray(img), jnp.array([[0.0, -1.0, 0.0]])))[0]
        assert up[0] > 0.9 and up[1] < 0.1
        assert down[1] > 0.9 and down[0] < 0.1

    def test_clamp_and_intensity(self):
        img = np.full((2, 4, 3), 100.0, np.float32)
        e = env_mod.make_hdr_environment(img, intensity=0.8, max_clamp=5.0)
        c = np.asarray(env_mod.environment_color(e, jnp.array([[0.0, 0.0, 1.0]])))[0]
        # clamp(100, 5) * 0.8 = 4.0 (EnvironmentManager.cpp:9-28)
        np.testing.assert_allclose(c, 4.0, atol=1e-5)

    def test_disabled_env_falls_back_to_sky(self):
        e = env_mod.make_procedural_environment()
        d = jnp.array([[0.0, 1.0, 0.0]])
        got = np.asarray(env_mod.environment_color(e, d))
        want = np.asarray(env_mod.procedural_sky(d))
        np.testing.assert_allclose(got, want, atol=1e-6)


class TestPackedBilinear:
    """Neighborhood-packed one-take bilinear (Environment.packed): exact
    tap-for-tap equivalence with the four-take sampler, including the
    wrap seam and both pole rows."""

    def _dirs(self, n=4096, seed=3):
        rng = np.random.default_rng(seed)
        d = rng.normal(size=(n, 3)).astype(np.float32)
        # force some lanes straight at the poles and along the seam
        d[:8] = [0.0, 1.0, 0.0]
        d[8:16] = [0.0, -1.0, 0.0]
        d[16:24] = [-1.0, 0.0, -1e-5]
        d[24:32] = [-1.0, 0.0, 1e-5]
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return d

    def test_matches_four_take_sampler(self):
        from spt_tpu.env import (pack_bilinear, sample_equirect_packed_v,
                                 sample_equirect_v, synthetic_equirect)
        from spt_tpu.ops.vec3 import Vec3

        img = synthetic_equirect(32)
        packed = jnp.asarray(pack_bilinear(img))
        d = Vec3.from_array(jnp.asarray(self._dirs()))
        want = sample_equirect_v(jnp.asarray(img), d)
        got = sample_equirect_packed_v(img.shape[0], img.shape[1], packed, d)
        for a, b in zip(want, got):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-6, atol=1e-6)

    def test_environment_color_uses_packed(self, monkeypatch):
        """make_hdr_environment builds the packed table only on opt-in
        (SPT_ENV_PACKED=1; default off) and
        environment_color_v routes through it with identical radiometry."""
        from spt_tpu import env as env_mod
        from spt_tpu.ops.vec3 import Vec3

        img = env_mod.synthetic_equirect(32)
        monkeypatch.setenv("SPT_ENV_PACKED", "1")
        e = env_mod.make_hdr_environment(img, intensity=0.8, max_clamp=5.0)
        assert e.packed is not None
        assert e.packed.shape == (32 * 64, 12)
        monkeypatch.delenv("SPT_ENV_PACKED")
        e_off = env_mod.make_hdr_environment(img)
        assert e_off.packed is None

        d = Vec3.from_array(jnp.asarray(self._dirs(seed=9)))
        got = env_mod.environment_color_v(e, d)
        want = env_mod.environment_color_v(e._replace(packed=None), d)
        for a, b in zip(want, got):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       rtol=1e-6, atol=1e-6)


class TestSnapBilinear:
    """Half-texel prefilter one-take bilinear (Environment.snap): exact at
    grid points, bounded between them, and OPT-IN only — a
    resolution-gated default would silently deviate from the exact sampler
    on content with small bright sources."""

    def test_default_off_any_size(self, monkeypatch):
        monkeypatch.delenv("SPT_ENV_SNAP", raising=False)
        for h in (32, 512):
            e = env_mod.make_hdr_environment(env_mod.synthetic_equirect(h))
            assert e.snap is None, f"snap must be opt-in (built at H={h})"

    def test_grid_point_exactness(self):
        """snap[Y, X] == the exact texel-center bilinear of the source at
        (x=X/2, y=Y/2) under _derive_taps' wrap/clamp rules, for EVERY
        grid point — seam column 2W-1 (x = W-0.5, wraps to texel 0) and
        both pole rows included."""
        img = env_mod.synthetic_equirect(16)  # (16, 32, 3)
        h, w = img.shape[:2]
        snap = env_mod.make_snap_table(img)
        Y, X = np.meshgrid(np.arange(2 * h), np.arange(2 * w), indexing="ij")
        x = X.astype(np.float64) / 2.0
        y = Y.astype(np.float64) / 2.0
        x0 = np.floor(x); fx = (x - x0)[..., None]
        y0 = np.floor(y); fy = (y - y0)[..., None]
        x0i = np.mod(x0.astype(np.int64), w)
        x1i = np.mod(x0i + 1, w)
        y0i = np.clip(y0.astype(np.int64), 0, h - 1)
        y1i = np.clip(y0.astype(np.int64) + 1, 0, h - 1)
        top = img[y0i, x0i] * (1 - fx) + img[y0i, x1i] * fx
        bot = img[y1i, x0i] * (1 - fx) + img[y1i, x1i] * fx
        want = top * (1 - fy) + bot * fy
        np.testing.assert_allclose(snap, want, rtol=1e-6, atol=1e-6)

    def test_bounded_error_vs_exact(self):
        """Sampled through the real lookup (rounded tap), snap stays within
        the quarter-texel displacement budget of the exact sampler on the
        smooth synthetic sky — rel-L2 ~1 % at H=256 (DESIGN.md table)."""
        from spt_tpu.env import (make_snap_table, sample_equirect_snap_v,
                                 sample_equirect_v)
        from spt_tpu.ops.vec3 import Vec3

        img = env_mod.synthetic_equirect(256)
        snap = jnp.asarray(make_snap_table(img))
        rng = np.random.default_rng(11)
        d = rng.normal(size=(8192, 3)).astype(np.float32)
        d[:4] = [0.0, 1.0, 0.0]
        d[4:8] = [0.0, -1.0, 0.0]
        d[8:12] = [-1.0, 0.0, -1e-5]
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        dv = Vec3.from_array(jnp.asarray(d))
        got = np.stack([np.asarray(c) for c in
                        sample_equirect_snap_v(256, 512, snap, dv)], -1)
        want = np.stack([np.asarray(c) for c in
                         sample_equirect_v(jnp.asarray(img), dv)], -1)
        rel_l2 = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel_l2 < 0.02, rel_l2

    def test_optin_routes_at_production_size(self, monkeypatch):
        """A 512-row map (production-size; every other fixture is 32-64
        rows) with SPT_ENV_SNAP=1: the table builds at (2H, 2W, 3) and
        environment_color_v routes through it within the error budget of
        the exact default route."""
        from spt_tpu.ops.vec3 import Vec3

        img = env_mod.synthetic_equirect(512)
        monkeypatch.setenv("SPT_ENV_SNAP", "1")
        e = env_mod.make_hdr_environment(img)
        assert e.snap is not None and e.snap.shape == (1024, 2048, 3)
        rng = np.random.default_rng(5)
        d = rng.normal(size=(4096, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        dv = Vec3.from_array(jnp.asarray(d))
        got = env_mod.environment_color_v(e, dv)
        want = env_mod.environment_color_v(e._replace(snap=None), dv)
        g = np.stack([np.asarray(c) for c in got], -1)
        wt = np.stack([np.asarray(c) for c in want], -1)
        rel_l2 = np.linalg.norm(g - wt) / np.linalg.norm(wt)
        assert rel_l2 < 0.01, rel_l2


def _noise_map(h=16, seed=21):
    """A map whose every texel differs, so a wrong tap shows."""
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 8.0, (h, 2 * h, 3)).astype(np.float32)


def _unit_rows(d):
    d = np.asarray(d, np.float64)
    return (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)


# direction sets where the equirect mapping has its edge cases: the u seam
# (theta = +-pi, on the -x axis), both poles, their neighbourhoods, the
# axes, and a uniform spread
_EQUIRECT_DIRS = {
    "seam": [[-1.0, y, s * z] for y in (-0.5, 0.0, 0.5)
             for s in (-1.0, 1.0) for z in (0.0, 1e-7, 1e-4, 1e-2)],
    "north_pole": [[0.0, 1.0, 0.0], [1e-7, 1.0, 0.0], [0.0, 1.0, -1e-7]],
    "south_pole": [[0.0, -1.0, 0.0], [-1e-7, -1.0, 0.0], [0.0, -1.0, 1e-7]],
    "near_north": [[np.cos(a) * 0.02, 1.0, np.sin(a) * 0.02]
                   for a in np.linspace(0, 2 * np.pi, 24)],
    "near_south": [[np.cos(a) * 0.02, -1.0, np.sin(a) * 0.02]
                   for a in np.linspace(0, 2 * np.pi, 24)],
    "axes": [[1, 0, 0], [-1, 0, 0], [0, 0, 1], [0, 0, -1], [1, 1, 1],
             [-1, -1, -1]],
    "uniform": np.random.default_rng(8).normal(size=(256, 3)).tolist(),
}


class TestEquirectVsOracle:
    """The XLA sampler (environment_color_v, the route every render takes)
    against reference_cpu.equirect_color, direction by direction."""

    @pytest.mark.parametrize("which", sorted(_EQUIRECT_DIRS))
    @pytest.mark.parametrize("image", ["noise", "sunsky"])
    def test_matches_oracle(self, which, image):
        from spt_tpu.ops.vec3 import Vec3

        img = (_noise_map() if image == "noise"
               else env_mod.synthetic_equirect(16))
        e = env_mod.make_hdr_environment(img)
        d = _unit_rows(_EQUIRECT_DIRS[which])
        got = env_mod.environment_color_v(
            e, Vec3.from_array(jnp.asarray(d))).to_array()
        want = np.stack([ref.equirect_color(img, di) for di in d])
        np.testing.assert_allclose(np.asarray(got), want, rtol=2e-4,
                                   atol=2e-5)
