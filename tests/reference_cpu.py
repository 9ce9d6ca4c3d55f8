"""Scalar numpy oracle integrator.

Plays the role the Embree CPU backend plays in the reference: the independent
"known-good" implementation that the fast backends are A/B-tested against
(SURVEY.md §4: "a NumPy/JAX-CPU scalar reference integrator acting as the
Embree CPU reference").  It re-implements the canonical transport of
spt_tpu.integrators.transport with per-ray Python control flow — the natural
branchy expression — and the exact same wang-hash RNG consumption, so the
vectorized masked integrators must reproduce it to float tolerance.

Everything is float32 to track XLA CPU arithmetic closely.
"""

from __future__ import annotations

import numpy as np

F32 = np.float32
M32 = 0xFFFFFFFF


# --- RNG (wang_hash chain, wf_math.h:35-49) -----------------------------------

def wang_hash(a: int) -> int:
    a &= M32
    a = (a ^ 61) ^ (a >> 16)
    a = (a * 9) & M32
    a ^= a >> 4
    a = (a * 0x27D4EB2D) & M32
    a ^= a >> 15
    return a


def rand01(state: int):
    state = wang_hash(state)
    return state, F32(state & 0x00FFFFFF) * F32(1.0 / 16777216.0)


# --- small vector helpers (float32) -------------------------------------------

def v3(*a):
    return np.array(a, F32)


def dot(a, b):
    return F32(a @ b)


def normalize(v):
    l2 = dot(v, v)
    if l2 <= 0:
        return np.zeros(3, F32)
    return (v / np.sqrt(l2)).astype(F32)


def normalize_or(v, fb):
    l2 = dot(v, v)
    if l2 <= 0:
        return fb.astype(F32)
    return (v / np.sqrt(l2)).astype(F32)


def reflect(i, n):
    return (i - 2.0 * dot(i, n) * n).astype(F32)


def refract(i, n, eta):
    cosi = np.clip(-dot(n, i), -1.0, 1.0)
    sin2t = eta * eta * max(0.0, 1.0 - cosi * cosi)
    if sin2t > 1.0:
        return np.zeros(3, F32), False
    cost = np.sqrt(max(0.0, 1.0 - sin2t))
    t = (eta * i + (eta * cosi - cost) * n).astype(F32)
    return normalize(t), True


def make_onb(n):
    up = v3(0, 0, 1) if abs(n[2]) < 0.999 else v3(1, 0, 0)
    t = normalize(np.cross(up, n))
    b = np.cross(n, t).astype(F32)
    return t, b


# --- intersection over numpy scene --------------------------------------------

class NpScene:
    """Numpy mirror of DeviceScene (same padding included)."""

    def __init__(self, dev_scene):
        self.tri_v0 = np.asarray(dev_scene.tri_v0, F32)
        self.tri_e1 = np.asarray(dev_scene.tri_e1, F32)
        self.tri_e2 = np.asarray(dev_scene.tri_e2, F32)
        self.tri_mat = np.asarray(dev_scene.tri_mat)
        self.tri_ns = (np.asarray(dev_scene.tri_ns, F32)
                       if getattr(dev_scene, "tri_ns", None) is not None
                       else None)
        self.sph_center = np.asarray(dev_scene.sph_center, F32)
        self.sph_radius = np.asarray(dev_scene.sph_radius, F32)
        self.sph_mat = np.asarray(dev_scene.sph_mat)
        m = dev_scene.materials
        self.base_color = np.asarray(m.base_color, F32)
        self.metallic = np.asarray(m.metallic, F32)
        self.roughness = np.asarray(m.roughness, F32)
        self.ior = np.asarray(m.ior, F32)
        self.mat_type = np.asarray(m.mat_type)
        self.emission = np.asarray(m.emission, F32)
        self.transparency = np.asarray(m.transparency, F32)
        if dev_scene.emitters is not None:
            e = dev_scene.emitters
            self.em_v0 = np.asarray(e.v0, F32)
            self.em_e1 = np.asarray(e.e1, F32)
            self.em_e2 = np.asarray(e.e2, F32)
            self.em_le = np.asarray(e.le, F32)
            self.em_area = np.asarray(e.area, F32)
        else:
            self.em_v0 = None


def intersect(sc: NpScene, o, d, tmin=0.0, tmax=np.inf):
    """Closest hit: returns (t, ng, mat_id, kind) with kind 0/1/2."""
    best_t, best_i, best_kind = np.inf, -1, 0

    # triangles (Möller-Trumbore)
    h = np.cross(d, sc.tri_e2)
    a = np.einsum("ij,ij->i", sc.tri_e1, h)
    safe_a = np.where(np.abs(a) > 1e-9, a, 1.0)
    s = o - sc.tri_v0
    u = np.einsum("ij,ij->i", s, h) / safe_a
    q = np.cross(s, sc.tri_e1)
    v = (q @ d) / safe_a
    t = np.einsum("ij,ij->i", sc.tri_e2, q) / safe_a
    valid = (np.abs(a) > 1e-9) & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > tmin) & (t < tmax)
    if valid.any():
        ts = np.where(valid, t, np.inf)
        i = int(np.argmin(ts))
        if ts[i] < best_t:
            best_t, best_i, best_kind = float(ts[i]), i, 1

    # spheres
    oc = o - sc.sph_center
    b = oc @ d
    c = np.einsum("ij,ij->i", oc, oc) - sc.sph_radius**2
    disc = b * b - c
    ok = (disc > 0) & (sc.sph_radius > 0)
    sq = np.sqrt(np.maximum(disc, 0))
    t0, t1 = -b - sq, -b + sq
    t = np.where((t0 > tmin) & (t0 < tmax), t0, t1)
    valid = ok & (t > tmin) & (t < tmax)
    if valid.any():
        ts = np.where(valid, t, np.inf)
        i = int(np.argmin(ts))
        if ts[i] < best_t:
            best_t, best_i, best_kind = float(ts[i]), i, 2

    if best_kind == 1:
        ng = np.cross(sc.tri_e1[best_i], sc.tri_e2[best_i]).astype(F32)
        if sc.tri_ns is not None:
            # interpolated shading normal; zero rows keep geometric
            # (mirrors the intersectors' per-lane select)
            rn = sc.tri_ns[best_i]
            sn = (rn[0:3] + u[best_i] * rn[3:6]
                  + v[best_i] * rn[6:9]).astype(F32)
            if float(sn @ sn) > 1e-12:
                ng = sn
        return best_t, ng, int(sc.tri_mat[best_i]), 1
    if best_kind == 2:
        p = (o + F32(best_t) * d).astype(F32)
        ng = ((p - sc.sph_center[best_i]) / max(sc.sph_radius[best_i], 1e-12)).astype(F32)
        return best_t, ng, int(sc.sph_mat[best_i]), 2
    return np.inf, np.zeros(3, F32), 0, 0


def occluded(sc: NpScene, o, d, tmin, tmax):
    t, _, _, kind = intersect(sc, o, d, tmin, tmax)
    return kind != 0


def safe_origin(p, n, front=True):
    eps = 1e-4 * max(1.0, float(np.max(np.abs(p))))
    return (p + (eps if front else -eps) * n).astype(F32)


# --- environment (procedural sky only) -----------------------------------------

_SUN = None


def sky_color(d):
    global _SUN
    if _SUN is None:
        s = v3(0.3, 0.6, -0.8)
        _SUN = normalize(s)
    t = 0.5 * (d[1] + 1.0)
    t = np.clip(t, 0.0, 1.0)
    t = t * t * (3.0 - 2.0 * t)
    sky = v3(0.7, 0.8, 0.9) * (1 - t) + v3(0.2, 0.4, 0.8) * t
    sd = max(dot(d, _SUN), 0.0)
    sky = sky + v3(1.0, 0.9, 0.7) * (sd**64 + (sd**8) * 0.3)
    return (sky * 0.8).astype(F32)


def equirect_color(img, d, intensity=0.8, max_clamp=5.0):
    """Scalar mirror of env.sample_equirect + the clamp-then-scale semantics
    (EnvironmentManager.cpp:9-33, device_programs.cu:374-387): texel-center
    bilinear, wrap in u, clamp each v tap independently."""
    h, w = img.shape[0], img.shape[1]
    theta = np.arctan2(d[2], d[0])
    phi = np.arccos(np.clip(d[1], -1.0, 1.0))
    u = (theta + np.pi) / (2.0 * np.pi)
    v = phi / np.pi
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = np.floor(x)
    y0 = np.floor(y)
    fx = F32(x - x0)
    fy = F32(y - y0)
    x0i = int(x0) % w
    x1i = (x0i + 1) % w
    y0f = int(y0)
    y0i = min(max(y0f, 0), h - 1)
    y1i = min(max(y0f + 1, 0), h - 1)
    c00, c01 = img[y0i, x0i], img[y0i, x1i]
    c10, c11 = img[y1i, x0i], img[y1i, x1i]
    top = c00 * (1 - fx) + c01 * fx
    bot = c10 * (1 - fx) + c11 * fx
    tex = top * (1 - fy) + bot * fy
    return (np.minimum(tex, F32(max_clamp)) * F32(intensity)).astype(F32)


def env_color(env_image, d):
    if env_image is None:
        return sky_color(d)
    return equirect_color(env_image, d)


# --- BRDF (Material.cpp:84-117) --------------------------------------------------

PI = F32(np.pi)


def evaluate_brdf(n, v, l, base, metallic, roughness, ior):
    h = normalize(v + l)
    cos_nv = max(dot(n, v), 0.0)
    cos_nl = max(dot(n, l), 0.0)
    cos_hv = max(dot(h, v), 0.0)
    cos_nh = max(dot(n, h), 0.0)
    r = np.clip(roughness, 0.02, 1.0)
    alpha = r * r
    a2 = alpha * alpha
    denom = cos_nh * cos_nh * (a2 - 1.0) + 1.0
    d = a2 / (PI * denom * denom)
    rr = np.clip(np.sqrt(max(alpha, 0.0)), 0.02, 1.0)
    k = (rr + 1.0) ** 2 / 8.0
    g = (cos_nv / (cos_nv * (1 - k) + k)) * (cos_nl / (cos_nl * (1 - k) + k))
    f0d = ((ior - 1.0) / (ior + 1.0)) ** 2
    f0 = f0d * (1.0 - metallic) + base * metallic
    m5 = (1.0 - np.clip(cos_hv, 0.0, 1.0)) ** 5
    f = f0 + (1.0 - f0) * m5
    spec = d * g * f / (4.0 * cos_nv * cos_nl + 1e-4)
    kd = 1.0 - f
    diff = base * (1.0 - metallic) / PI
    return ((kd * diff + spec) * cos_nl).astype(F32)


def fresnel_schlick_eta(cos_i, eta_i, eta_t):
    r0 = ((eta_t - eta_i) / (eta_t + eta_i)) ** 2
    m = 1.0 - np.clip(cos_i, 0.0, 1.0)
    return r0 + (1.0 - r0) * m**5


def ggx_sample_half(u1, u2, alpha, n):
    a2 = alpha * alpha
    phi = 2.0 * PI * u1
    denom = 1.0 + (a2 - 1.0) * u2
    cos_t = np.sqrt(max(0.0, (1.0 - u2) / denom))
    sin_t = np.sqrt(max(0.0, 1.0 - cos_t * cos_t))
    local = v3(sin_t * np.cos(phi), sin_t * np.sin(phi), cos_t)
    t, b = make_onb(n)
    h = t * local[0] + b * local[1] + n * local[2]
    return normalize_or(h, n)


def ggx_sample_vndf(u1, u2, alpha, n, v):
    """Heitz VNDF half-vector sample (Material.cpp:145-199), scalar."""
    t, b = make_onb(n)
    vh = normalize(v3(dot(v, t), dot(v, b), dot(v, n)))
    vs = normalize(v3(alpha * vh[0], alpha * vh[1], vh[2]))
    if vs[2] < 0.9999:
        t1 = normalize(np.cross(v3(0, 0, 1), vs))
    else:
        t1 = v3(1, 0, 0)
    t2 = np.cross(vs, t1).astype(F32)
    r_disk = np.sqrt(u1)
    phi = 2.0 * PI * u2
    p1 = r_disk * np.cos(phi)
    p2 = r_disk * np.sin(phi)
    sfac = 0.5 * (1.0 + vs[2])
    p2 = (1.0 - sfac) * np.sqrt(max(0.0, 1.0 - p1 * p1)) + sfac * p2
    p3 = np.sqrt(max(0.0, 1.0 - p1 * p1 - p2 * p2))
    nh = (p1 * t1 + p2 * t2 + p3 * vs).astype(F32)
    h_local = normalize(v3(alpha * nh[0], alpha * nh[1], max(0.0, nh[2])))
    h = t * h_local[0] + b * h_local[1] + n * h_local[2]
    return normalize(h)


def cosine_sample(n, u1, u2):
    r = np.sqrt(u1)
    phi = 2.0 * PI * u2
    local = v3(r * np.cos(phi), r * np.sin(phi), np.sqrt(max(0.0, 1.0 - u1)))
    t, b = make_onb(n)
    return normalize(t * local[0] + b * local[1] + n * local[2])


# --- the oracle integrator -------------------------------------------------------

def trace_path(cfg, sc: NpScene, lights, camera, pixel: int, frame: int, sample: int = 0,
               env_image=None):
    """One path for one pixel -> (3,) radiance.  `lights` is a list of dicts
    {kind, vec, color_x_intensity}; camera is spt_tpu.camera.Camera."""
    w, h = cfg.width, cfg.height
    px, py = pixel % w, pixel // w

    state = wang_hash(((pixel + 1) ^ ((frame * 9781 + 1) & M32)) & M32)
    if cfg.spp > 1 or sample:
        state = wang_hash((state ^ ((sample * 9781 + 1) & M32)) & M32)
    if cfg.jitter:
        state, ju = rand01(state)
        state, jv = rand01(state)
    else:
        ju = jv = F32(0.5)

    x = F32((px + ju) / w)
    y = F32((py + jv) / h)
    nx = (x - F32(0.5)) * 2
    ny = -(y - F32(0.5)) * 2
    d = normalize(
        camera.forward.astype(F32)
        + nx * F32(camera.half_width) * camera.right.astype(F32)
        + ny * F32(camera.half_height) * camera.up.astype(F32)
    )
    o = camera.position.astype(F32)

    throughput = np.ones(3, F32)
    radiance = np.zeros(3, F32)
    emission_ok = True
    nee_on = cfg.nee and sc.em_v0 is not None

    for bounce in range(cfg.max_depth):
        t, ng, mid, kind = intersect(sc, o, d, tmin=0.0)
        if kind == 0:
            radiance += throughput * env_color(env_image, normalize(d))
            break

        ng = normalize_or(ng, v3(0, 1, 0))
        entering = dot(d, ng) < 0.0
        n = ng if entering else -ng
        p = (o + F32(t) * d).astype(F32)

        base = sc.base_color[mid]
        metallic = sc.metallic[mid]
        roughness = sc.roughness[mid]
        ior = sc.ior[mid]
        mtype = int(sc.mat_type[mid])
        diffuse_color = base * (1.0 - metallic)

        if emission_ok or not nee_on:
            radiance += throughput * sc.emission[mid]

        is_dielectric = mtype == 1
        is_metal = (metallic > 0.5) and not is_dielectric

        # direct lighting
        if cfg.direct_light_dielectric or not is_dielectric:
            vdir = normalize(-d)
            for lt in lights:
                if lt["kind"] == 1:   # directional
                    ldir, ldist, li = lt["vec"], F32(1e30), lt["li"]
                else:                  # point
                    lv = lt["vec"] - p
                    ldist = F32(np.linalg.norm(lv))
                    ldir = (lv / ldist).astype(F32)
                    att = lt["att"]
                    li = lt["li"] / max(att[0] + att[1] * ldist + att[2] * ldist**2, 1e-12)
                cos_theta = max(dot(n, ldir), 0.0)
                if cos_theta <= 0:
                    continue
                if cfg.shadow_rays:
                    so = safe_origin(p, n, True)
                    if occluded(sc, so, ldir, cfg.hit_eps, ldist - cfg.hit_eps):
                        continue
                brdf_nl = evaluate_brdf(n, vdir, ldir, base, metallic, roughness, ior)
                radiance += throughput * brdf_nl * li

        # NEE toward emissive triangles (transport.shade_core order: after
        # analytic direct light, before scatter draws)
        if nee_on:
            state, xe = rand01(state)
            state, xu1 = rand01(state)
            state, xu2 = rand01(state)
            e_count = sc.em_v0.shape[0]
            pick = min(int(xe * e_count), e_count - 1)
            ev0, ee1, ee2 = sc.em_v0[pick], sc.em_e1[pick], sc.em_e2[pick]
            su = np.sqrt(max(xu1, 0.0))
            b1, b2 = 1.0 - su, xu2 * su
            pe = (ev0 + b1 * ee1 + b2 * ee2).astype(F32)
            to_e = pe - p
            dist = max(float(np.linalg.norm(to_e)), 1e-6)
            wi = (to_e / dist).astype(F32)
            n_e = normalize(np.cross(ee1, ee2).astype(F32))
            cos_e = abs(dot(n_e, wi))
            cos_s = dot(n, wi)
            if (not is_dielectric) and cos_s > 0 and cos_e > 1e-6:
                blocked = False
                if cfg.shadow_rays:
                    so = safe_origin(p, n, True)
                    blocked = occluded(sc, so, wi, cfg.hit_eps, dist * (1.0 - 1e-3))
                if not blocked:
                    vdir = normalize(-d)
                    brdf_nl = evaluate_brdf(n, vdir, wi, base, metallic,
                                            roughness, ior)
                    w = (cos_e / (dist * dist)) * sc.em_area[pick] * e_count
                    radiance += throughput * brdf_nl * sc.em_le[pick] * F32(w)

        if bounce == cfg.max_depth - 1:
            break

        if is_dielectric:
            state, xi = rand01(state)
            eta_i = F32(1.0) if entering else ior
            eta_t = ior if entering else F32(1.0)
            eta = eta_i / eta_t
            cos_i = np.clip(-dot(d, n), -1.0, 1.0)
            fr = fresnel_schlick_eta(cos_i, eta_i, eta_t)
            refr, can = refract(d, n, eta)
            if not can or xi < fr:
                nd = normalize(reflect(d, n))
            else:
                nd = refr
            if getattr(cfg, "cpu_transparency", False):
                # quirk 7 (PathTracer.cpp:177-209): the CPU's ior-derived
                # transparency weighting, mirrored from transport.shade_core
                trans = sc.transparency[mid]
                if xi < fr:
                    throughput = throughput * F32(1.0 - trans)
                elif can:
                    throughput = throughput * F32(trans)
            o = (p + F32(cfg.ray_offset_dir) * nd).astype(F32)
            d = nd
            emission_ok = True
            continue

        if is_metal:
            vdir = normalize(-d)
            cos_nv_raw = dot(n, vdir)
            s2, u1 = rand01(state)
            s2, u2 = rand01(s2)
            alpha = np.clip(roughness, 0.02, 1.0) ** 2
            if cfg.metal_vndf:
                hh = ggx_sample_vndf(u1, u2, alpha, n, vdir)
            else:
                hh = ggx_sample_half(u1, u2, alpha, n)
            ldir = normalize_or(reflect(-vdir, hh), n)
            mirror = normalize_or(reflect(d, n), n)
            ggx_ok = cos_nv_raw > 0 and dot(n, hh) > 0 and dot(n, ldir) > 0
            if cos_nv_raw > 0:
                state = s2
            if ggx_ok:
                cos_nv = max(cos_nv_raw, 1e-6)
                cos_nl = max(dot(n, ldir), 1e-6)
                cos_nh = max(dot(n, hh), 1e-6)
                if cfg.metal_vndf:
                    cos_vh = max(dot(vdir, hh), 1e-6)
                    m5 = (1.0 - np.clip(cos_vh, 0.0, 1.0)) ** 5
                    f = base + (1.0 - base) * m5
                    rr_ = np.clip(np.sqrt(alpha), 0.02, 1.0)
                    ak = (rr_ + 1.0) ** 2 / 8.0
                    g = (max(cos_nv, 0.0) / (cos_nv * (1 - ak) + ak)) * (
                        max(cos_nl, 0.0) / (cos_nl * (1 - ak) + ak))
                    sc_ = np.clip(g * cos_vh / cos_nh, 0.0, cfg.firefly_clamp)
                else:
                    cos_vh = max(dot(vdir, hh), 0.0)
                    m5 = (1.0 - np.clip(cos_vh, 0.0, 1.0)) ** 5
                    f = base + (1.0 - base) * m5
                    ak = (alpha + 1.0) ** 2 * 0.125
                    g = (cos_nl / (cos_nl * (1 - ak) + ak)) * (cos_nv / (cos_nv * (1 - ak) + ak))
                    sc_ = np.clip(g * cos_vh / (cos_nv * cos_nh), 0.0, cfg.firefly_clamp)
                throughput = throughput * f * sc_
                d = ldir
            else:
                throughput = throughput * base
                d = mirror
            o = (p + F32(1e-3) * n).astype(F32)
            if nee_on:
                emission_ok = False
            continue

        # diffuse
        state, du1 = rand01(state)
        state, du2 = rand01(state)
        nd = cosine_sample(n, du1, du2)
        no = safe_origin(p, n, True)
        survival = float(np.clip(diffuse_color.max(), 1e-6, 1.0))
        state, xi_rr = rand01(state)
        rr_on = bounce > cfg.rr_after
        if rr_on and xi_rr >= survival:
            break
        throughput = throughput * diffuse_color
        if rr_on:
            throughput = throughput / F32(survival)
        o, d = no, nd
        if nee_on:
            emission_ok = False

    return radiance


def render_image(cfg, sc: NpScene, lights, camera, frame: int = 0, env_image=None):
    """Full (small!) image via the scalar oracle."""
    out = np.zeros((cfg.num_pixels, 3), F32)
    for pixel in range(cfg.num_pixels):
        acc = np.zeros(3, F32)
        for s in range(cfg.spp):
            acc += trace_path(cfg, sc, lights, camera, pixel, frame, s,
                              env_image=env_image)
        out[pixel] = acc / cfg.spp
    return out.reshape(cfg.height, cfg.width, 3)


def lights_from_device(dev_lights):
    """DeviceLights -> oracle light list."""
    kinds = np.asarray(dev_lights.kind)
    vecs = np.asarray(dev_lights.vec, F32)
    colors = np.asarray(dev_lights.color, F32)
    intens = np.asarray(dev_lights.intensity, F32)
    atten = np.asarray(dev_lights.attenuation, F32)
    out = []
    for i in range(len(kinds)):
        if kinds[i] == 0:
            continue
        out.append({
            "kind": int(kinds[i]),
            "vec": vecs[i],
            "li": colors[i] * intens[i],
            "att": atten[i],
        })
    return out
