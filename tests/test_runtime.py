"""Run-time plumbing: the compile cache, the GPU smoke script's refusal to
run without a GPU, bench's device fields, texture decoding without Pillow,
buffer donation, the multi-device step, and the seeded mesh scene."""

import json
import os
import shutil
import subprocess
import sys
import warnings

import jax
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(code_or_args, env_extra=None, cwd=REPO, drop=()):
    env = dict(os.environ, JAX_PLATFORMS="cpu", **(env_extra or {}))
    for k in drop:
        env.pop(k, None)
    args = ([sys.executable, "-c", code_or_args]
            if isinstance(code_or_args, str) else code_or_args)
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


_CACHE_PROBE = """
import json, jax
from spt_tpu.utils.cache import cache_dir, enable_default_cache
enable_default_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.jit(lambda x: x * 3 + 1)(2.0).block_until_ready()
print(json.dumps([cache_dir(), jax.config.jax_compilation_cache_dir]))
"""


class TestCompileCache:
    def test_env_variable_wins(self, tmp_path):
        want = str(tmp_path / "cache")
        out = _run(_CACHE_PROBE, {"JAX_COMPILATION_CACHE_DIR": want})
        assert out.returncode == 0, out.stderr
        assert json.loads(out.stdout.splitlines()[-1]) == [want, want]
        assert os.listdir(want), "the program was not cached there"

    def test_default_is_the_repo_cache(self):
        from spt_tpu.utils.cache import REPO_CACHE

        out = _run(_CACHE_PROBE, drop=("JAX_COMPILATION_CACHE_DIR",))
        assert out.returncode == 0, out.stderr
        assert json.loads(out.stdout.splitlines()[-1]) == [REPO_CACHE,
                                                          REPO_CACHE]
        assert REPO_CACHE == os.path.join(REPO, ".jax_cache")
        assert os.listdir(REPO_CACHE)


class TestChipSmokeRefusesCpu:
    def test_cpu_only_run_fails(self):
        out = _run([sys.executable, "chip_smoke.py"])
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout
        assert "no GPU" in out.stderr

    def test_script_alone_fails(self, tmp_path):
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        out = _run([sys.executable, "chip_smoke.py"], cwd=tmp_path)
        assert out.returncode != 0
        assert '"ok": true' not in out.stdout

    @pytest.fixture
    def smoke(self):
        sys.path.insert(0, REPO)
        import chip_smoke

        yield chip_smoke
        sys.path.remove(REPO)

    def test_rel_rmse(self, smoke):
        a = np.ones((4, 4, 3), np.float32)
        assert smoke.rel_rmse(a, a) == 0.0
        assert abs(smoke.rel_rmse(a * 1.01, a) - 0.01) < 1e-6

    def test_pixel_share(self, smoke):
        a = np.zeros((10, 10, 3), np.float32)
        b = a.copy()
        b[0, 0, 2] = 0.5          # one channel of one pixel
        b[3, 4] = 2e-4            # under the tolerance
        assert smoke.pixel_share(b, a, 1e-3) == pytest.approx(0.01)

    def test_check_fails_over_the_limit(self, smoke, capsys):
        smoke.check("fine", 0.5, 1.0)
        with pytest.raises(SystemExit) as e:
            smoke.check("too big", 2.0, 1.0)
        assert e.value.code != 0
        out = capsys.readouterr()
        assert "limit 1" in out.out and "too big" in out.err


class TestBenchDevice:
    def test_device_fields(self, monkeypatch):
        sys.path.insert(0, REPO)
        try:
            import bench
        finally:
            sys.path.remove(REPO)
        monkeypatch.setattr(bench, "card_line", lambda: "Card X, 350.00 W")
        f = bench.device_fields()
        assert f["platform"] == "cpu" and f["device_count"] == jax.device_count()
        assert f["card"] == "Card X" and f["power_limit"] == "350.00 W"
        monkeypatch.setattr(bench, "card_line", lambda: None)
        f = bench.device_fields()
        assert f["card"] is None and f["power_limit"] is None


class TestTexturesNeedPillow:
    def test_missing_pillow_is_an_import_error(self, tmp_path, monkeypatch):
        import base64

        from spt_tpu.io.gltf import load_gltf

        pos = np.float32([[0, 0, 0], [1, 0, 0], [0, 1, 0]])
        uv = np.float32([[0, 0], [1, 0], [0, 1]])
        blob = pos.tobytes() + uv.tobytes()
        doc = {
            "asset": {"version": "2.0"}, "scenes": [{"nodes": [0]}],
            "nodes": [{"mesh": 0}],
            "meshes": [{"primitives": [{"attributes": {
                "POSITION": 0, "TEXCOORD_0": 1}, "material": 0}]}],
            "materials": [{"pbrMetallicRoughness": {
                "baseColorTexture": {"index": 0}}}],
            "textures": [{"source": 0}],
            "images": [{"uri": "tex.png"}],
            "accessors": [
                {"bufferView": 0, "componentType": 5126, "count": 3,
                 "type": "VEC3"},
                {"bufferView": 1, "componentType": 5126, "count": 3,
                 "type": "VEC2"}],
            "bufferViews": [{"buffer": 0, "byteOffset": 0, "byteLength": 36},
                            {"buffer": 0, "byteOffset": 36,
                             "byteLength": 24}],
            "buffers": [{"uri": "data:application/octet-stream;base64,"
                         + base64.b64encode(blob).decode(),
                         "byteLength": len(blob)}],
        }
        path = tmp_path / "tex.gltf"
        path.write_text(json.dumps(doc))
        monkeypatch.setitem(sys.modules, "PIL", None)
        with pytest.raises(ImportError, match="Pillow"):
            load_gltf(str(path))


class TestRendererRuntime:
    def test_chain_donates_the_render_state(self):
        from spt_tpu.config import RenderConfig
        from spt_tpu.engine.renderer import Renderer
        from spt_tpu.scene import build_default_scene

        r = Renderer(build_default_scene(),
                     RenderConfig(width=16, height=8, max_depth=2),
                     multi_device=False)
        old = r.state.accum
        r.render_frames(2)
        assert old.is_deleted()
        assert r.accumulated_samples == 2

    def test_sharded_step_builds_without_deprecation(self):
        from spt_tpu.config import RenderConfig
        from spt_tpu.parallel import make_mesh, sharded_frame_step_dyn

        with warnings.catch_warnings():
            warnings.simplefilter("error", DeprecationWarning)
            sharded_frame_step_dyn(RenderConfig(width=8, height=8),
                                   make_mesh(jax.devices()[:2]))

    def test_resize_off_the_mesh_returns_to_one_device(self):
        from spt_tpu.config import RenderConfig
        from spt_tpu.engine.renderer import Renderer
        from spt_tpu.scene import build_default_scene

        r = Renderer(build_default_scene(),
                     RenderConfig(width=16, height=16, max_depth=2))
        assert r.mesh is not None
        r.resize(16, 15)                 # 15 rows do not split over 8
        assert r.mesh is None
        for leaf in jax.tree.leaves((r.scene, r.env, r.lights)):
            assert len(leaf.devices()) == 1
        r.render_frame(check_camera=False)
        assert np.isfinite(r.image()).all()


class TestSeededMeshScene:
    def test_same_seed_same_scene(self):
        from spt_tpu.scene import build_seeded_mesh_scene

        a, b = build_seeded_mesh_scene(3), build_seeded_mesh_scene(3)
        np.testing.assert_array_equal(a.meshes[1].positions,
                                      b.meshes[1].positions)

    def test_seed_changes_the_surface(self):
        from spt_tpu.scene import build_seeded_mesh_scene

        a, b = build_seeded_mesh_scene(0), build_seeded_mesh_scene(1)
        assert not np.allclose(a.meshes[1].positions, b.meshes[1].positions)

    @pytest.mark.parametrize("stacks,slices", [(32, 48), (8, 12)])
    def test_size_and_normals(self, stacks, slices):
        from spt_tpu.scene import build_seeded_mesh_scene, flatten_scene

        desc = build_seeded_mesh_scene(0, stacks, slices)
        assert desc.total_triangles == 2 * stacks * slices + 2
        n = desc.meshes[1].normals
        np.testing.assert_allclose(np.linalg.norm(n, axis=1), 1.0, atol=1e-5)
        dev = flatten_scene(desc)
        assert dev.tri_ns is not None     # smooth shading survives flatten
