"""Inverse rendering: recover material albedos from a target image.

The megakernel integrator is pure jnp end-to-end, so a render is a
differentiable function of the scene parameters — a capability the
reference (C++17/CUDA, PathTracer.cpp:113-224) cannot offer.  This
example runs the textbook loop: render a target with the true albedos,
re-initialize every material to flat gray, and recover the originals by
Adam on the image MSE through `jax.grad` of the renderer itself.

Run from the repository root: PYTHONPATH=. python examples/inverse_albedo.py
(~30 s on CPU).
Gradient correctness vs finite differences is gated in
tests/test_grad.py; this script demonstrates the optimization workflow.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax

from spt_tpu.camera import default_camera
from spt_tpu.config import RenderConfig
from spt_tpu.env import make_procedural_environment
from spt_tpu.integrators import megakernel
from spt_tpu.lights import default_lights
from spt_tpu.scene import build_default_scene, flatten_scene


def main(steps: int = 150, lr: float = 0.05) -> float:
    cfg = RenderConfig(width=64, height=32, spp=1, max_depth=3)
    scene = flatten_scene(build_default_scene())
    env = make_procedural_environment()
    lights = default_lights()
    cam = default_camera(cfg.width, cfg.height).rays()

    def render(base_color):
        s = scene._replace(
            materials=scene.materials._replace(base_color=base_color))
        # fixed sample index -> fixed RNG: the target and the optimized
        # render see identical path noise, so the albedo is the only
        # unknown (multi-sample targets work too, just slower)
        return megakernel.render_sample(cfg, s, env, lights, cam, 0)

    true_bc = scene.materials.base_color
    target = render(true_bc)

    @jax.jit
    def loss_fn(bc):
        return jnp.mean((render(bc) - target) ** 2)

    grad_fn = jax.jit(jax.grad(loss_fn))

    bc = jnp.full_like(true_bc, 0.5)
    opt = optax.adam(lr)
    opt_state = opt.init(bc)

    for i in range(steps):
        updates, opt_state = opt.update(grad_fn(bc), opt_state)
        bc = jnp.clip(optax.apply_updates(bc, updates), 0.0, 1.0)
        if i % 25 == 0 or i == steps - 1:
            print(f"step {i:4d}  image MSE {float(loss_fn(bc)):.3e}")

    # report recovery on the materials that are actually visible (gradient
    # reached them); hidden materials can't be recovered from one view
    g = np.abs(np.asarray(jax.grad(loss_fn)(jnp.full_like(true_bc, 0.5))))
    seen = g.max(axis=1) > 1e-6
    err = np.abs(np.asarray(bc - true_bc))[seen].max()
    print(f"visible materials: {int(seen.sum())}/{len(seen)}, "
          f"max albedo error after {steps} steps: {err:.3f}")
    return float(err)


if __name__ == "__main__":
    main()
