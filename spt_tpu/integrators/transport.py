"""The canonical light transport, vectorized over component-SoA path lanes.

One per-bounce shading function shared by the megakernel and wavefront
integrators, so backend parity (the reference's dual-backend oracle,
SURVEY.md §4) holds by construction.  Semantics are the reference's GPU
wavefront shade kernel (device_programs.cu:315-690) with the fixes the
reference planned but never shipped, each a RenderConfig toggle:

- shadow rays for direct lighting (CPU semantics Light.cpp:16-40; the GPU
  skipped them, cu:455-457) — ON by default;
- emission handled (unused on GPU, LaunchParams.h:40) — always on;
- Russian roulette after bounce 2 (wf_pt_cpu.cpp:233-242) — on by default;
- direct lighting applies NdotL exactly once.  NOTE (conscious fix): the CPU
  reference multiplies cos_theta on top of evaluateBRDF's internal NdotL
  (PathTracer.cpp:158-167 + Material.cpp:116), double-counting it; the GPU
  applies it once (cu:455-496).  We follow the GPU.
- the dielectric branch is the GPU's tagged delta BSDF (throughput unchanged,
  cu:498-543); the CPU's ior-derived transparency weights (SURVEY.md §5
  quirk 7) are not reproduced.

Path state is the SoA the reference's author intended (wf_types.h:4-5):
every 3-vector is a `Vec3` of flat (N,) lane arrays (see ops/vec3.py).
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from spt_tpu.config import RenderConfig
from spt_tpu.camera import CameraRays
from spt_tpu.env import Environment, environment_color_v
from spt_tpu.lights import DeviceLights, sample_light_v
from spt_tpu.materials import gather_v
from spt_tpu.ops import intersect as isect
from spt_tpu.ops import rng as rng_ops
from spt_tpu.ops import sampling
from spt_tpu.ops import vec3 as v3
from spt_tpu.ops.vec3 import Vec3
from spt_tpu.scene.flatten import DeviceScene

# Emitter tables up to this size unroll NEE selection as masked selects;
# larger tables switch to per-lane gathers (slower per lane, but O(1) program
# size — required once emissive meshes arrive via glTF).
NEE_SELECT_UNROLL = 32


class PathState(NamedTuple):
    """SoA path state (LaunchParams.h:16-25 as component lane arrays)."""

    origin: Vec3
    direction: Vec3
    throughput: Vec3
    radiance: Vec3
    rng: jnp.ndarray         # (N,) uint32
    alive: jnp.ndarray       # (N,) bool
    # True while hit emission should be counted: camera rays and dielectric
    # continuations.  Diffuse/metal scatters clear it when NEE is active
    # (their emitter contribution arrives via the shadow ray instead).
    emission_ok: jnp.ndarray # (N,) bool

    @property
    def num_paths(self) -> int:
        return self.rng.shape[0]


def gen_primary(
    cfg: RenderConfig,
    camera: CameraRays,
    frame_index,
    sample_index: int = 0,
    row0=0,
    rows: int = None,
) -> PathState:
    """Stage 1 — primary ray generation (__raygen__gen_primary,
    device_programs.cu:239-274).

    Rays go through pixel centers (+0.5, cu:226) unless cfg.jitter, in which
    case a per-(frame, sample) subpixel offset is drawn from the path RNG
    (the CPU wavefront driver's jitter, GLRenderer.cpp:386-398).

    `row0`/`rows` select a horizontal band of the image (for pixel-axis
    sharding): lanes carry GLOBAL pixel indices, so RNG streams and ray
    directions are bitwise identical however the image is banded.
    """
    w, h = cfg.width, cfg.height
    if rows is None:
        rows = h
    n = w * rows
    pixel = jnp.asarray(row0, jnp.uint32) * jnp.uint32(w) + jnp.arange(n, dtype=jnp.uint32)
    px = (pixel % jnp.uint32(w)).astype(jnp.float32)
    py = (pixel // jnp.uint32(w)).astype(jnp.float32)

    state = rng_ops.seed_paths(pixel, frame_index)
    if cfg.spp > 1 or sample_index:
        state = rng_ops.seed_samples(state, sample_index)

    if cfg.jitter:
        state, ju, jv = rng_ops.next_float2(state)
    else:
        ju = jv = jnp.float32(0.5)

    x = (px + ju) / jnp.float32(w)
    y = (py + jv) / jnp.float32(h)
    direction = camera.ray_directions_v(x, y)
    ones = jnp.ones((n,), jnp.float32)
    zeros = jnp.zeros((n,), jnp.float32)

    return PathState(
        origin=Vec3(camera.position[0] + zeros,
                    camera.position[1] + zeros,
                    camera.position[2] + zeros),
        direction=direction,
        throughput=Vec3(ones, ones, ones),
        radiance=Vec3(zeros, zeros, zeros),
        rng=state,
        alive=jnp.ones((n,), bool),
        emission_ok=jnp.ones((n,), bool),
    )


def trace_bounce(scene: DeviceScene, ps: PathState) -> isect.HitV:
    """Stage 2 — trace (__raygen__trace, cu:279-310).  Dead lanes trace with
    tmax = 0, so every primitive test fails for them; their results are
    masked in shade either way."""
    tmax = jnp.where(ps.alive, jnp.float32(1e30), jnp.float32(0.0))
    return isect.intersect_v(scene, ps.origin, ps.direction, tmin=0.0,
                             tmax=tmax)


def shade(
    cfg: RenderConfig,
    scene: DeviceScene,
    env: Environment,
    lights: DeviceLights,
    ps: PathState,
    hit: isect.HitV,
    bounce,
    is_last,
) -> PathState:
    """Stage 3 — shade (__raygen__shade, cu:315-690), fully masked.

    Thin wrapper: shade_core does everything lane-local; the environment
    lookup (the one true gather, for HDR maps) is applied here, so the
    wavefront can defer it to one evaluation after its depth loop.
    """
    new_ps, missed = shade_core(cfg, scene, lights, ps, hit, bounce, is_last)
    env_c = environment_color_v(env, ps.direction)
    radiance = new_ps.radiance + v3.where(
        missed, ps.throughput * env_c, Vec3.full((0, 0, 0), (ps.num_paths,))
    )
    return new_ps._replace(radiance=radiance)


def _bilinear_setup(uvx, uvy, res: int):
    """Shared bilinear footprint: wrap UVs (glTF REPEAT, the only mode the
    reference's assets use), sample at texel centers.  Returns
    ((x0, x1, y0, y1) int32 texel coords, (wx, wy) fractional weights)."""
    fu = uvx - jnp.floor(uvx)
    fv = uvy - jnp.floor(uvy)
    sx = fu * res - 0.5
    sy = fv * res - 0.5
    x0 = jnp.floor(sx).astype(jnp.int32)
    y0 = jnp.floor(sy).astype(jnp.int32)
    wx = sx - x0.astype(jnp.float32)
    wy = sy - y0.astype(jnp.float32)
    # wrap (x0 can be -1, x0+1 can be res)
    x0w = jnp.where(x0 < 0, x0 + res, x0)
    y0w = jnp.where(y0 < 0, y0 + res, y0)
    x1 = jnp.where(x0 + 1 >= res, 0, x0 + 1)
    y1 = jnp.where(y0 + 1 >= res, 0, y0 + 1)
    return (x0w, x1, y0w, y1), (wx, wy)


def sample_texture_v(textures, tex_id, uvx, uvy):
    """Bilinear texture sample, XLA layout-flat gather.

    `textures` is the packed table (n_tex, tiles, 2, 8, 128) int32 of res^2
    images, res the scene's budgeted resolution recovered from the static
    shape (materials.tex_res_of): plane 0 the
    sqrt-encoded 10/10/10 baseColor, plane 1 the 16/16
    (roughness, metallic) multipliers.  Texel (ty, tx) lives at flat index
    ty * res + tx = (q << 10) | (r << 7) | c; V maps directly to image
    rows (glTF uv origin and the image array origin are both top-left).
    Returns (rgb Vec3, roughness_mult, metallic_mult); lanes without a
    texture (tex_id < 0) return all-1 multipliers so the material factors
    pass through.
    """
    from spt_tpu.materials import tex_res_of, unpack_color, unpack_mr

    res = tex_res_of(textures)
    (x0, x1, y0, y1), (wx, wy) = _bilinear_setup(uvx, uvy, res)
    tid = jnp.maximum(tex_id, 0)
    n_tex = textures.shape[0]
    # fully-flat 1-D takes over each plane
    tex_sz = res * res
    col_flat = textures[:, :, 0].reshape(n_tex * tex_sz)
    mr_flat = textures[:, :, 1].reshape(n_tex * tex_sz)

    acc = [jnp.zeros_like(uvx) for _ in range(5)]
    for xi, wxi in ((x0, 1.0 - wx), (x1, wx)):
        for yi, wyi in ((y0, 1.0 - wy), (y1, wy)):
            flat = tid * tex_sz + yi * res + xi
            w = wxi * wyi
            r, g, b = unpack_color(jnp.take(col_flat, flat))
            ro, me = unpack_mr(jnp.take(mr_flat, flat))
            for i, v in enumerate((r, g, b, ro, me)):
                acc[i] = acc[i] + w * v
    has = tex_id >= 0
    vals = [jnp.where(has, a, 1.0) for a in acc]
    return Vec3(vals[0], vals[1], vals[2]), vals[3], vals[4]


def shade_core(
    cfg: RenderConfig,
    scene: DeviceScene,
    lights: DeviceLights,
    ps: PathState,
    hit: isect.HitV,
    bounce,
    is_last,
):
    """Everything in shade except the environment color: emission, direct
    lighting with shadow rays, and the scatter branches.  Returns
    (new_state, missed_mask) — the caller owes `throughput * env(direction)`
    to every missed lane (those lanes keep their direction and die here).

    Every branch of the reference's divergent kernel is computed for every
    lane and selected: masked math replaces the SBT/queue divergence
    machinery, at the cost of evaluating each branch of the small material
    set for every lane (SURVEY.md §7 design stance).
    """
    shape = ps.rng.shape
    is_last = jnp.asarray(is_last, bool)
    alive = ps.alive
    missed = alive & ~hit.hit_mask
    surf = alive & hit.hit_mask

    radiance = ps.radiance

    # --- surface setup --------------------------------------------------------
    mat = gather_v(scene.materials, hit.mat_id)
    if scene.textures is not None and hit.uvx is not None:
        # Mask miss lanes out of the lookup (their gathered material is
        # arbitrary): a tex_id of -1 samples nothing and returns all-1
        # multipliers.
        tex_rgb, tex_rough, tex_metal = sample_texture_v(
            scene.textures, jnp.where(hit.hit_mask, mat.tex_id, -1),
            hit.uvx, hit.uvy
        )
        # glTF: texture channels MULTIPLY the material factors (baseColor *
        # baseColorFactor; roughness = G * roughnessFactor; metallic =
        # B * metallicFactor).
        mat = mat._replace(
            base_color=mat.base_color * tex_rgb,
            roughness=jnp.clip(mat.roughness * tex_rough, 0.01, 1.0),
            metallic=jnp.clip(mat.metallic * tex_metal, 0.0, 1.0),
        )
    up = Vec3.full((0.0, 1.0, 0.0), shape)
    ng = v3.normalize_or(hit.normal, up)
    n, entering = v3.faceforward(ng, ps.direction)
    t_safe = jnp.where(hit.hit_mask, hit.t, 0.0)
    p = ps.origin + ps.direction * t_safe

    diffuse_color = mat.base_color * (1.0 - mat.metallic)
    is_dielectric = mat.mat_type == 1
    is_metal = (mat.metallic > 0.5) & ~is_dielectric
    is_diffuse = ~is_metal & ~is_dielectric

    # --- emission (wf_pt_cpu.cpp:121-124; GPU never shipped it) --------------
    nee_on = cfg.nee and scene.emitters is not None
    zero3 = Vec3.full((0, 0, 0), shape)
    emit_mask = (surf & ps.emission_ok) if nee_on else surf
    radiance = radiance + v3.where(emit_mask, ps.throughput * mat.emission, zero3)

    # --- direct lighting (unrolled over the small static light table) --------
    direct_ok = surf if cfg.direct_light_dielectric else (surf & ~is_dielectric)
    view = v3.safe_normalize(-ps.direction)
    for li in range(lights.count):
        li_rad, ldir, ldist, lactive = sample_light_v(lights, li, p)
        cos_theta = jnp.maximum(v3.dot(n, ldir), 0.0)
        contrib_mask = direct_ok & lactive & (cos_theta > 0.0)
        if cfg.shadow_rays:
            shadow_o = isect.safe_origin_v(p, n, jnp.ones(shape, bool))
            # tmax = 0 for lanes that can't contribute: their occlusion
            # result is ignored (see trace_bounce).
            blocked = isect.occluded_v(
                scene, shadow_o, ldir, tmin=cfg.hit_eps,
                tmax=jnp.where(contrib_mask, ldist - cfg.hit_eps, 0.0),
            )
            contrib_mask = contrib_mask & ~blocked
        brdf_nl = sampling.evaluate_brdf_v(
            n, view, ldir, mat.base_color, mat.metallic, mat.roughness, mat.ior
        )
        radiance = radiance + v3.where(
            contrib_mask, ps.throughput * brdf_nl * li_rad, zero3
        )

    # --- NEE toward emissive triangles (area lights) --------------------------
    rng = ps.rng
    if nee_on:
        emitters = scene.emitters
        e_count = emitters.count
        rng, xe = rng_ops.next_float(rng)
        rng, xu1 = rng_ops.next_float(rng)
        rng, xu2 = rng_ops.next_float(rng)
        # uniform emitter pick.  Small tables unroll as masked selects; past
        # NEE_SELECT_UNROLL the unroll would
        # bloat the XLA program linearly in emitter count (a glTF scene can
        # carry hundreds of emissive triangles), so large tables gather.
        pick = jnp.clip((xe * e_count).astype(jnp.int32), 0, e_count - 1)
        zl = jnp.zeros(shape, jnp.float32)
        if e_count <= NEE_SELECT_UNROLL:
            ev0 = Vec3(zl, zl, zl)
            ee1 = Vec3(zl, zl, zl)
            ee2 = Vec3(zl, zl, zl)
            ele = Vec3(zl, zl, zl)
            earea = zl
            for ei in range(e_count):
                selm = pick == ei
                ev0 = v3.where(selm, Vec3(emitters.v0[ei, 0] + zl,
                                          emitters.v0[ei, 1] + zl,
                                          emitters.v0[ei, 2] + zl), ev0)
                ee1 = v3.where(selm, Vec3(emitters.e1[ei, 0] + zl,
                                          emitters.e1[ei, 1] + zl,
                                          emitters.e1[ei, 2] + zl), ee1)
                ee2 = v3.where(selm, Vec3(emitters.e2[ei, 0] + zl,
                                          emitters.e2[ei, 1] + zl,
                                          emitters.e2[ei, 2] + zl), ee2)
                ele = v3.where(selm, Vec3(emitters.le[ei, 0] + zl,
                                          emitters.le[ei, 1] + zl,
                                          emitters.le[ei, 2] + zl), ele)
                earea = jnp.where(selm, emitters.area[ei], earea)
        else:
            def g3(tab):
                return Vec3(tab[pick, 0], tab[pick, 1], tab[pick, 2])

            ev0, ee1, ee2, ele = (g3(emitters.v0), g3(emitters.e1),
                                  g3(emitters.e2), g3(emitters.le))
            earea = emitters.area[pick]
        # uniform point on the triangle
        su = sampling.safe_sqrt(xu1)
        b1 = 1.0 - su
        b2 = xu2 * su
        pe = ev0 + ee1 * b1 + ee2 * b2
        to_e = pe - p
        dist = jnp.maximum(v3.length(to_e), 1e-6)
        wi = to_e * (1.0 / dist)
        n_e = v3.safe_normalize(v3.cross(ee1, ee2))
        cos_e = jnp.abs(v3.dot(n_e, wi))          # two-sided emitters
        cos_s = v3.dot(n, wi)
        nee_mask = surf & ~is_dielectric & (cos_s > 0.0) & (cos_e > 1e-6)
        if cfg.shadow_rays:
            so = isect.safe_origin_v(p, n, jnp.ones(shape, bool))
            tmax_e = jnp.where(nee_mask, dist * (1.0 - 1e-3), 0.0)
            blocked = isect.occluded_v(scene, so, wi, tmin=cfg.hit_eps,
                                       tmax=tmax_e)
            nee_mask = nee_mask & ~blocked
        brdf_nl = sampling.evaluate_brdf_v(
            n, view, wi, mat.base_color, mat.metallic, mat.roughness, mat.ior
        )
        # pdf = 1 / (E * area); geometric term cos_e / dist^2
        weight = (cos_e / (dist * dist)) * (earea * jnp.float32(e_count))
        radiance = radiance + v3.where(
            nee_mask, ps.throughput * brdf_nl * ele * weight, zero3
        )

    # --- scatter: compute all three branches, select ---------------------------

    # Dielectric (cu:498-543): Fresnel-probabilistic reflect/refract, delta BSDF.
    rng_d, xi_d = rng_ops.next_float(rng)
    eta_i = jnp.where(entering, 1.0, mat.ior)
    eta_t = jnp.where(entering, mat.ior, 1.0)
    eta = eta_i / eta_t
    cos_i = jnp.clip(-v3.dot(ps.direction, n), -1.0, 1.0)
    fr = sampling.fresnel_schlick_eta(cos_i, eta_i, eta_t)
    refr_dir, can_refract = v3.refract(ps.direction, n, eta)
    reflect_dir = v3.safe_normalize(v3.reflect(ps.direction, n))
    d_dir = v3.where(~can_refract | (xi_d < fr), reflect_dir, refr_dir)
    d_org = p + d_dir * cfg.ray_offset_dir
    d_thr = ps.throughput  # delta BSDF, throughput unchanged (cu:537)
    if cfg.cpu_transparency:
        # quirk 7 (PathTracer.cpp:177-209): reflection x (1-transparency),
        # refraction x transparency, TIR x 1 — the CPU's conscious energy
        # loss, reproduced for A/B (cfg docstring)
        w_d = jnp.where(xi_d < fr, 1.0 - mat.transparency,
                        jnp.where(can_refract, mat.transparency,
                                  jnp.float32(1.0)))
        d_thr = d_thr * w_d

    # Metal (cu:545-666): GGX NDF half-vector sampling, D cancels in the
    # throughput; degenerate cases fall back to a mirror bounce.
    cos_nv_raw = v3.dot(n, view)
    rng_m, u1, u2 = rng_ops.next_float2(rng)
    alpha = sampling.roughness_to_alpha(mat.roughness)
    if cfg.metal_vndf and not cfg.metal_mirror:
        h = sampling.ggx_sample_vndf_v(u1, u2, alpha, n, view)
    else:
        h = sampling.ggx_sample_half_vector_v(u1, u2, alpha, n)
    cos_nh_raw = v3.dot(n, h)
    l_dir = v3.normalize_or(v3.reflect(-view, h), n)
    cos_nl_raw = v3.dot(n, l_dir)
    mirror_dir = v3.normalize_or(v3.reflect(ps.direction, n), n)

    ggx_ok = (cos_nv_raw > 0.0) & (cos_nh_raw > 0.0) & (cos_nl_raw > 0.0)
    if cfg.metal_mirror:
        # CPU megakernel quirk 6: perfect mirror, throughput *= albedo*metallic
        # (PathTracer.cpp:170-176).
        m_dir = mirror_dir
        m_thr = ps.throughput * mat.base_color * mat.metallic
        rng_m_out = rng
    elif cfg.metal_vndf:
        # Heitz VNDF estimator with Material::evaluateSample's weights
        # (Material.cpp:201-227): weight = f * NdotL / pdf where
        # f = D G F / (4 NV NL), pdf = D G1(k~0) NH / (4 VH NV) -> weight
        # reduces to F * G * VH / (G1 NH) with G1(k->0) = 1.
        cos_nv = jnp.maximum(cos_nv_raw, 1e-6)
        cos_nl = jnp.maximum(cos_nl_raw, 1e-6)
        cos_nh = jnp.maximum(cos_nh_raw, 1e-6)
        cos_vh = jnp.maximum(v3.dot(view, h), 1e-6)
        f = sampling.fresnel_schlick_v(cos_vh, mat.base_color)
        g = sampling.g_smith_cpu(cos_nv, cos_nl, alpha)  # k from r (CPU conv.)
        scale = jnp.clip(g * cos_vh / cos_nh, 0.0, cfg.firefly_clamp)
        m_dir = v3.where(ggx_ok, l_dir, mirror_dir)
        m_thr = ps.throughput * v3.where(ggx_ok, f * scale, mat.base_color)
        rng_m_out = jnp.where(cos_nv_raw > 0.0, rng_m, rng)
    else:
        cos_nv = jnp.maximum(cos_nv_raw, 1e-6)
        cos_nl = jnp.maximum(cos_nl_raw, 1e-6)
        cos_nh = jnp.maximum(cos_nh_raw, 1e-6)
        cos_vh = jnp.maximum(v3.dot(view, h), 0.0)
        f = sampling.fresnel_schlick_v(cos_vh, mat.base_color)  # metal F0 = baseColor
        g = sampling.g_smith_gpu(cos_nl, cos_nv, alpha)
        scale = jnp.clip(g * cos_vh / (cos_nv * cos_nh), 0.0, cfg.firefly_clamp)
        m_dir = v3.where(ggx_ok, l_dir, mirror_dir)
        m_thr = ps.throughput * v3.where(ggx_ok, f * scale, mat.base_color)
        # The GPU's cosNV<=0 fallback bails before drawing randoms (cu:554-576).
        rng_m_out = jnp.where(cos_nv_raw > 0.0, rng_m, rng)
    m_org = p + n * 1e-3  # offset along the normal (cu:530,608)

    # Diffuse (cu:668-690 + wf_pt_cpu.cpp:226-247): cosine sample + RR.
    rng_f, du1, du2 = rng_ops.next_float2(rng)
    f_dir = sampling.cosine_sample_v(n, du1, du2)
    f_org = isect.safe_origin_v(p, n, jnp.ones(shape, bool))
    survival = jnp.clip(v3.max_component(diffuse_color), 1e-6, 1.0)
    rng_f, xi_rr = rng_ops.next_float(rng_f)
    rr_on = jnp.asarray(bounce > cfg.rr_after)
    rr_dead = rr_on & (xi_rr >= survival)
    f_thr = ps.throughput * diffuse_color
    f_thr = v3.where(rr_on, f_thr * (1.0 / survival), f_thr)

    # --- select the branch per lane -------------------------------------------
    new_dir = v3.where(is_dielectric, d_dir, v3.where(is_metal, m_dir, f_dir))
    new_org = v3.where(is_dielectric, d_org, v3.where(is_metal, m_org, f_org))
    new_thr = v3.where(is_dielectric, d_thr, v3.where(is_metal, m_thr, f_thr))
    new_rng = jnp.where(is_dielectric, rng_d, jnp.where(is_metal, rng_m_out, rng_f))

    scatter_alive = surf & ~is_last & ~(is_diffuse & rr_dead)

    # Quirk 5 (optional): the GPU paints diffuse * normal-vis at max depth
    # (cu:420-440) instead of going black.
    if cfg.depth_term_normal_vis:
        nvis = (v3.normalize_or(ng, up) + 1.0) * 0.5
        term_c = ps.throughput * diffuse_color * nvis
        radiance = radiance + v3.where(surf & is_last, term_c, zero3)

    if nee_on:
        # dielectric continuations keep counting emission; NEE'd scatters
        # (diffuse/metal) must not double count it on the next hit.
        new_emission_ok = (scatter_alive & is_dielectric) | (
            ~scatter_alive & ps.emission_ok
        )
    else:
        new_emission_ok = ps.emission_ok

    return PathState(
        origin=v3.where(scatter_alive, new_org, ps.origin),
        direction=v3.where(scatter_alive, new_dir, ps.direction),
        throughput=v3.where(scatter_alive, new_thr, ps.throughput),
        radiance=radiance,
        rng=jnp.where(surf, new_rng, ps.rng),
        alive=scatter_alive,
        emission_ok=new_emission_ok,
    ), missed
