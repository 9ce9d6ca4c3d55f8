"""Differentiability: jax.grad through a full megakernel render.

The README advertises the megakernel as "differentiable end-to-end" — an
inverse-rendering capability the reference (C++/CUDA) cannot offer.  This
gates the claim (an advertised capability with zero coverage is a claim,
not a feature): analytic gradients of an image loss
w.r.t. material parameters must exist, be finite, and match central finite
differences.
"""

import jax
import jax.numpy as jnp
import numpy as np

from spt_tpu.camera import default_camera
from spt_tpu.config import RenderConfig
from spt_tpu.env import make_procedural_environment
from spt_tpu.integrators import megakernel
from spt_tpu.lights import default_lights
from spt_tpu.scene import build_default_scene, flatten_scene


def _setup():
    cfg = RenderConfig(width=32, height=16, spp=1, max_depth=3)
    scene = flatten_scene(build_default_scene())
    env = make_procedural_environment()
    lights = default_lights()
    cam = default_camera(cfg.width, cfg.height).rays()
    return cfg, scene, env, lights, cam


class TestMegakernelGrad:
    def test_albedo_grad_matches_finite_differences(self):
        cfg, scene, env, lights, cam = _setup()

        def loss(base_color):
            s = scene._replace(
                materials=scene.materials._replace(base_color=base_color))
            img = megakernel.render_sample(cfg, s, env, lights, cam, 0)
            return jnp.mean(img)

        bc = scene.materials.base_color
        g = np.asarray(jax.grad(loss)(bc))
        assert np.isfinite(g).all()
        # several materials are visible in the default scene -> several
        # albedo entries must carry gradient
        assert (np.abs(g) > 0).sum() >= 6

        # central finite differences on the 3 largest-|grad| entries
        flat = np.abs(g).ravel().argsort()[::-1][:3]
        for f in flat:
            i, j = np.unravel_index(f, g.shape)
            eps = 1e-3
            e = jnp.zeros_like(bc).at[i, j].set(eps)
            fd = float((loss(bc + e) - loss(bc - e)) / (2 * eps))
            assert abs(g[i, j] - fd) <= 0.05 * max(abs(fd), 1e-6), (
                f"entry ({i},{j}): analytic {g[i, j]:.6g} vs fd {fd:.6g}"
            )

    def test_roughness_and_metallic_grads_finite(self):
        # The GGX/Fresnel path (sqrt, pow, rsqrt chains) is where where()-
        # gradient NaNs would hide; require finite gradients there too.
        cfg, scene, env, lights, cam = _setup()

        def loss(rough, metal):
            s = scene._replace(materials=scene.materials._replace(
                roughness=rough, metallic=metal))
            img = megakernel.render_sample(cfg, s, env, lights, cam, 0)
            return jnp.mean(img)

        gr, gm = jax.grad(loss, argnums=(0, 1))(
            scene.materials.roughness, scene.materials.metallic)
        assert np.isfinite(np.asarray(gr)).all()
        assert np.isfinite(np.asarray(gm)).all()
        assert (np.abs(np.asarray(gm)) > 0).any()
