"""baseColor texture sampling — loader -> flatten -> intersect uv -> shade.

Beyond-reference capability: the reference's GLTFLoader reads TEXCOORD_0 and
texture uris but neither backend samples a texture (GLTFLoader.cpp:219-331).
"""

import numpy as np
import jax.numpy as jnp
import pytest

from spt_tpu.camera import Camera
from spt_tpu.config import RenderConfig
from spt_tpu.env import make_procedural_environment
from spt_tpu.integrators.megakernel import render_megakernel
from spt_tpu.lights import LightManager
from spt_tpu.scene import flatten_scene
from spt_tpu.scene.desc import Material, MeshData, SceneDesc


def _quad_scene(tex: np.ndarray) -> SceneDesc:
    """A unit quad in the XY plane at z=0 facing +z, uv spanning [0,1]^2."""
    sd = SceneDesc()
    sd.add_material(Material(base_color=[1.0, 1.0, 1.0], roughness=1.0,
                             ior=1.0, base_color_texture=tex))
    mesh = MeshData(
        positions=[[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
        indices=[[0, 1, 2], [0, 2, 3]],
        normals=[[0, 0, 1]] * 4,
        # glTF uv origin is top-left: v=0 at the TOP edge (y=+1)
        texcoords=[[0, 1], [1, 1], [1, 0], [0, 0]],
        material_id=0,
    )
    sd.add_instance(sd.add_mesh(mesh))
    return sd


def _checker():
    """2x2 macro-checker as a 64x64 texture: quadrant colors R, G, B, W."""
    tex = np.zeros((64, 64, 3), np.float32)
    tex[:32, :32] = [1, 0, 0]   # top-left  (u<.5, v<.5)
    tex[:32, 32:] = [0, 1, 0]   # top-right (u>.5, v<.5)
    tex[32:, :32] = [0, 0, 1]   # bottom-left
    tex[32:, 32:] = [1, 1, 1]   # bottom-right
    return tex


def _render_quad(width=64, height=64):
    sd = _quad_scene(_checker())
    cfg = RenderConfig(width=width, height=height, spp=1, max_depth=1,
                       jitter=False, shadow_rays=False)
    lm = LightManager()
    lm.add_directional_light((0.0, 0.0, -1.0), (1.0, 1.0, 1.0), 3.0)
    cam = Camera(position=(0, 0, 2.5), target=(0, 0, 0), fov_degrees=60.0,
                 aspect_ratio=width / height)
    scene = flatten_scene(sd)
    assert scene.textures is not None and scene.textures.shape[0] == 1
    img = np.asarray(render_megakernel(
        cfg, scene, make_procedural_environment(), lm.device(), cam.rays(), 0
    )).reshape(height, width, 3)
    return img


class TestTextureSampling:
    def test_quadrant_colors_reach_film(self):
        img = _render_quad()
        h, w = img.shape[:2]
        # sample the middle of each quadrant of the IMAGE; y=+1 (top of
        # image) has v=0 -> texture rows 0..31
        tl = img[h // 4, w // 4]
        tr = img[h // 4, 3 * w // 4]
        bl = img[3 * h // 4, w // 4]
        br = img[3 * h // 4, 3 * w // 4]

        def dominant(px):
            return int(np.argmax(px)) if px.max() > 1e-4 else -1

        assert dominant(tl) == 0, tl   # red
        assert dominant(tr) == 1, tr   # green
        assert dominant(bl) == 2, bl   # blue
        # white quadrant: all channels comparable
        assert br.min() > 0.5 * br.max() and br.max() > 1e-3, br

    def test_untextured_material_unchanged(self):
        # same quad, no texture: image is uniform (no quadrant structure)
        sd = _quad_scene(_checker())
        sd.materials[0].base_color_texture = None
        cfg = RenderConfig(width=32, height=32, spp=1, max_depth=1,
                           jitter=False, shadow_rays=False)
        lm = LightManager()
        lm.add_directional_light((0.0, 0.0, -1.0), (1.0, 1.0, 1.0), 3.0)
        cam = Camera(position=(0, 0, 2.5), target=(0, 0, 0), fov_degrees=60.0,
                     aspect_ratio=1.0)
        scene = flatten_scene(sd)
        assert scene.textures is None
        img = np.asarray(render_megakernel(
            cfg, scene, make_procedural_environment(), lm.device(),
            cam.rays(), 0
        )).reshape(32, 32, 3)
        c = img[16, 16]
        assert np.allclose(img[8, 8], c, atol=1e-5)
        assert np.allclose(img[24, 24], c, atol=1e-5)

    def test_gltf_loader_reads_texture(self):
        from spt_tpu.io.gltf import load_gltf

        d = load_gltf(
            "/root/reference/assets/models/rattan_dining_chair/scene.gltf"
        )
        m = d.materials[0]
        assert m.base_color_texture is not None
        assert m.base_color_texture.shape[2] == 3
        # sRGB decode happened: values in [0, 1]
        assert 0.0 <= m.base_color_texture.min()
        assert m.base_color_texture.max() <= 1.0
        scene = flatten_scene(d)
        assert scene.textures is not None
        assert scene.tri_uv is not None
        # chair uvs are inside [0, 1]
        uv0 = np.asarray(scene.tri_uv[:, :2])
        assert (uv0 >= -1e-3).all() and (uv0 <= 1 + 1e-3).all()


class TestPackedTextureTable:
    """The packed 10/10/10 + 16/16 table, bilinear taps, and the
    metallicRoughness channel path."""

    def test_color_pack_roundtrip(self):
        from spt_tpu.materials import _pack_color, unpack_color

        rng = np.random.default_rng(0)
        rgb = rng.uniform(0, 1, (256, 3)).astype(np.float32)
        p = _pack_color(rgb).astype(np.int32)
        r, g, b = unpack_color(jnp.asarray(p))
        got = np.stack([np.asarray(r), np.asarray(g), np.asarray(b)], -1)
        # sqrt-encoded 10-bit: linear error <= ~2*sqrt(v)/1023
        assert np.abs(got - rgb).max() < 3e-3

    def test_mr_pack_roundtrip(self):
        from spt_tpu.materials import _pack_mr, unpack_mr

        mr = np.array([[0.0, 1.0], [0.25, 0.5], [1.0, 0.0]], np.float32)
        p = _pack_mr(mr).astype(np.int64).astype(np.int32)  # keep bits
        ro, me = unpack_mr(jnp.asarray(p))
        np.testing.assert_allclose(np.asarray(ro), mr[:, 0], atol=2e-5)
        np.testing.assert_allclose(np.asarray(me), mr[:, 1], atol=2e-5)

    def test_mr_texture_multiplies_factors(self):
        from spt_tpu.integrators.transport import sample_texture_v
        from spt_tpu.materials import TEX_RES, build_texture_table
        from spt_tpu.scene.desc import Material

        mr = np.zeros((TEX_RES, TEX_RES, 3), np.float32)
        mr[:, : TEX_RES // 2, 1] = 0.25   # roughness left half
        mr[:, TEX_RES // 2:, 1] = 1.0
        mr[:, :, 2] = 0.5                 # metallic everywhere
        m = Material(metallic=1.0, roughness=1.0,
                     metallic_roughness_texture=mr)
        tex_id, table = build_texture_table([m])
        assert table is not None and int(tex_id[0]) == 0
        uvx = jnp.asarray([0.25, 0.75], jnp.float32)
        uvy = jnp.asarray([0.5, 0.5], jnp.float32)
        rgb, rough, metal = sample_texture_v(
            table, jnp.zeros(2, jnp.int32), uvx, uvy)
        np.testing.assert_allclose(np.asarray(rough), [0.25, 1.0], atol=1e-3)
        np.testing.assert_allclose(np.asarray(metal), [0.5, 0.5], atol=1e-3)
        # no baseColor texture on this material: color multiplier is 1
        np.testing.assert_allclose(np.asarray(rgb.x), [1.0, 1.0], atol=2e-3)

    def test_bilinear_blends_between_texels(self):
        from spt_tpu.integrators.transport import sample_texture_v
        from spt_tpu.materials import TEX_RES, build_texture_table
        from spt_tpu.scene.desc import Material

        tex = np.zeros((TEX_RES, TEX_RES, 3), np.float32)
        tex[:, 1::2] = 1.0  # alternating columns
        m = Material(base_color_texture=tex)
        _, table = build_texture_table([m])
        # exactly between texel 0 (black) and texel 1 (white): u at the
        # shared edge = 1/TEX_RES
        u_mid = jnp.asarray([1.0 / TEX_RES], jnp.float32)
        v_c = jnp.asarray([0.5], jnp.float32)
        rgb, _, _ = sample_texture_v(table, jnp.zeros(1, jnp.int32),
                                     u_mid, v_c)
        assert abs(float(rgb.x[0]) - 0.5) < 2e-2
        # dead-center of a texel: pure texel value
        u_c = jnp.asarray([0.5 / TEX_RES], jnp.float32)
        rgb2, _, _ = sample_texture_v(table, jnp.zeros(1, jnp.int32),
                                      u_c, v_c)
        assert float(rgb2.x[0]) < 1e-3

    def test_chair_has_mr_texture(self):
        import os

        path = "/root/reference/assets/models/rattan_dining_chair/scene.gltf"
        if not os.path.exists(path):
            pytest.skip("no chair asset")
        from spt_tpu.io.gltf import load_gltf

        d = load_gltf(path)
        m = d.materials[0]
        assert m.metallic_roughness_texture is not None
        g = m.metallic_roughness_texture[..., 1]
        b = m.metallic_roughness_texture[..., 2]
        # roughness/metallic actually VARY across the chair
        assert g.std() > 0.01 or b.std() > 0.01


class TestBudgetedResolution:
    """Per-scene texture resolution chosen by a byte budget: few textures
    get 256^2, crowds degrade to 64^2."""

    def test_choose_res_budget(self):
        from spt_tpu.materials import choose_tex_res

        # 2 MiB default budget: n*2*res^2*4 bytes
        assert choose_tex_res(1) == 256
        assert choose_tex_res(4) == 256    # 4 * 512 KiB = 2 MiB exactly
        assert choose_tex_res(5) == 128
        assert choose_tex_res(16) == 128   # 16 * 128 KiB = 2 MiB
        assert choose_tex_res(17) == 64
        assert choose_tex_res(64) == 64

    def test_budget_env_override(self, monkeypatch):
        from spt_tpu.materials import choose_tex_res

        monkeypatch.setenv("SPT_TEX_BUDGET", str(512 * 1024))
        assert choose_tex_res(1) == 256   # 512 KiB fits exactly
        assert choose_tex_res(2) == 128
        monkeypatch.setenv("SPT_TEX_BUDGET", "not-a-number")
        assert choose_tex_res(1) == 256   # falls back to the default

    def test_res_recovered_from_table(self):
        from spt_tpu.materials import build_texture_table, tex_res_of

        def mats(n):
            rng = np.random.default_rng(7)
            return [Material(base_color_texture=rng.uniform(
                0, 1, (32, 32, 3)).astype(np.float32)) for _ in range(n)]

        for n, want in ((1, 256), (6, 128), (20, 64)):
            _, table = build_texture_table(mats(n))
            assert table.shape[0] == n
            assert tex_res_of(table) == want
            # tiles * 1024 texels = res^2
            assert table.shape[1] * 1024 == want * want

    def test_fidelity_improves_with_res(self):
        """The packed-table sample converges to the full-res source as the
        budgeted resolution rises (the chair's 2048^2 baseColor at 256^2
        keeps detail 128^2 averaged away)."""
        from spt_tpu.integrators.transport import sample_texture_v
        from spt_tpu.materials import build_texture_table

        n = 1024
        yy, xx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
        # mid-frequency stripes (period 16 texels): resolved at 256
        # (4-texel cells), averaged to near-flat at 64 (16-texel cells)
        src = (0.5 + 0.5 * np.sin(xx * (2 * np.pi / 16))
               * np.sin(yy * (2 * np.pi / 16))).astype(np.float32)
        src3 = np.repeat(src[..., None], 3, -1)
        rng = np.random.default_rng(11)
        uv = rng.uniform(0.05, 0.95, (4096, 2)).astype(np.float32)
        ty = np.minimum((uv[:, 1] * n).astype(np.int64), n - 1)
        tx = np.minimum((uv[:, 0] * n).astype(np.int64), n - 1)
        truth = src[ty, tx]

        rmse = {}
        for res in (64, 128, 256):
            _, table = build_texture_table(
                [Material(base_color_texture=src3)], res=res)
            rgb, _, _ = sample_texture_v(
                table, jnp.zeros(4096, jnp.int32),
                jnp.asarray(uv[:, 0]), jnp.asarray(uv[:, 1]))
            rmse[res] = float(np.sqrt(np.mean(
                (np.asarray(rgb.x) - truth) ** 2)))
        assert rmse[256] < rmse[128] < rmse[64]
        assert rmse[256] < 0.5 * rmse[64]
