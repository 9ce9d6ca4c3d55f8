"""CLI surface: reference flag compatibility (main.cpp:21-54)."""

import pytest

from spt_tpu.cli import build_parser


class TestReferenceFlagParity:
    def test_i_and_s_flags(self):
        # the reference's exact spellings: --i/-i, --s/-s (main.cpp:30-46)
        p = build_parser()
        a = p.parse_args(["--i", "model.gltf", "--s", "env.hdr"])
        assert a.gltf == "model.gltf" and a.skybox == "env.hdr"
        a = p.parse_args(["-i", "m.gltf", "-s", "e.hdr"])
        assert a.gltf == "m.gltf" and a.skybox == "e.hdr"

    def test_help_exits_zero(self, capsys):
        with pytest.raises(SystemExit) as e:
            build_parser().parse_args(["--help"])
        assert e.value.code == 0
        out = capsys.readouterr().out
        assert "--i" in out and "--s" in out

    def test_reference_defaults(self):
        # spp 4 / depth 6 (main.cpp:108-109), 800x600 (GLRenderer.h:34-35)
        a = build_parser().parse_args([])
        assert (a.spp, a.depth, a.width, a.height) == (4, 6, 800, 600)

    def test_extended_flags(self):
        a = build_parser().parse_args(
            ["--scene", "cornell", "--tonemap", "aces", "--orbit", "3",
             "--debug-mode", "normal", "--checkpoint", "c.npz",
             "--integrator", "regen"]
        )
        assert a.scene == "cornell" and a.tonemap == "aces"
        assert a.orbit == 3.0 and a.debug_mode == "normal"
        assert a.integrator == "regen"


class TestSkyboxFallback:
    def test_bad_skybox_warns_and_continues(self, capsys, tmp_path):
        # Quirk 8 parity (main.cpp:196-202): a missing/corrupt skybox must
        # not abort — warn and render with the procedural sky.
        from spt_tpu.cli import make_renderer

        args = build_parser().parse_args(
            ["--s", str(tmp_path / "nope.hdr"), "--width", "16",
             "--height", "16", "--spp", "1"]
        )
        r = make_renderer(args)  # must not raise
        assert r.env is not None
        err = capsys.readouterr().err
        assert "warning" in err and "procedural sky" in err
