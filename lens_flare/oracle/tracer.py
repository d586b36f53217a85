"""Slow NumPy reference implementations used as test oracles.

Mirrors the reference C++ semantics directly (brute force, no BVH) so the
JAX paths can be validated against it: Möller-Trumbore
(``triangle.cpp:25-68``), sphere quadratic (``sphere.cpp:11-111``), pinhole
rays (``camera.cpp:278-305``), and the direct-lighting estimator
(``pathtracer.cpp:142-232``).
"""

from __future__ import annotations

import numpy as np

EPS_F = 0.00001
INF = 1e30


def intersect_brute(scene, o, d, t_lo, t_hi):
    """Closest hit by testing every primitive. o,d: (3,). Returns dict or None."""
    best = None
    best_t = t_hi
    for i in range(scene.num_triangles):
        p0, p1, p2 = scene.tri_p[i]
        res = moller_trumbore(p0, p1, p2, o, d)
        if res is None:
            continue
        t, b1, b2 = res
        if t_lo <= t <= best_t:
            n = (
                (1 - b1 - b2) * scene.tri_n[i, 0]
                + b1 * scene.tri_n[i, 1]
                + b2 * scene.tri_n[i, 2]
            )
            n = n / np.linalg.norm(n)
            best_t = t
            best = dict(t=t, prim=i, bsdf=int(scene.tri_bsdf[i]), n=n)
    for s in range(scene.num_spheres):
        t = sphere_test(scene.sph_center[s], scene.sph_radius[s], o, d, t_lo, best_t)
        if t is not None:
            p = o + d * t
            n = p - scene.sph_center[s]
            n = n / np.linalg.norm(n)
            best_t = t
            best = dict(t=t, prim=scene.num_triangles + s, bsdf=int(scene.sph_bsdf[s]), n=n)
    return best


def closest_hits(scene, O, D, t_lo, t_hi, chunk: int = 256):
    """Closest hit of each ray by exhaustive float64 tests, for large scenes.

    O, D: (N, 3); t_lo, t_hi: (N,).  Returns dict of arrays ``hit`` (N,)
    bool, ``t`` (N,) and ``prim`` (N,) int (triangles then spheres, -1 on a
    miss).  The first of equally near primitives (lowest id) wins.

    Every primitive a ray can hit inside [t_lo, t_hi] is tested: triangles
    are grouped into ``chunk``-sized runs along a Morton curve of their
    centroids, and a run is skipped only when the ray's interval misses the
    run's (slightly padded) bounding box.  No BVH, no float32.
    """
    O = np.asarray(O, np.float64)
    D = np.asarray(D, np.float64)
    t_lo = np.broadcast_to(np.asarray(t_lo, np.float64), O.shape[:1])
    t_hi = np.broadcast_to(np.asarray(t_hi, np.float64), O.shape[:1])
    n = O.shape[0]
    best_t = np.full(n, np.inf)
    best_p = np.full(n, -1, np.int64)

    tri = np.asarray(scene.tri_p, np.float64)  # (T, 3, 3)
    if len(tri):
        cent = tri.mean(axis=1)
        lo, hi = cent.min(axis=0), cent.max(axis=0)
        q = ((cent - lo) / np.maximum(hi - lo, 1e-30) * 1023).astype(np.int64)
        code = np.zeros(len(tri), np.int64)
        for bit in range(10):
            for a in range(3):
                code |= ((q[:, a] >> bit) & 1) << (3 * bit + a)
        order = np.argsort(code, kind="stable")
        n_chunks = -(-len(tri) // chunk)
        pad = n_chunks * chunk - len(tri)
        ids = np.concatenate([order, np.full(pad, order[-1])]).reshape(n_chunks, chunk)
        box_lo = tri.min(axis=1)[ids].min(axis=1)
        box_hi = tri.max(axis=1)[ids].max(axis=1)
        slack = 1e-6 * (1.0 + np.abs(box_lo) + np.abs(box_hi))
        box_lo, box_hi = box_lo - slack, box_hi + slack
        p0 = tri[:, 0]
        e1 = tri[:, 1] - p0
        e2 = tri[:, 2] - p0
        with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
            for r in range(n):
                o, d = O[r], D[r]
                inv = 1.0 / np.where(d == 0, 1e-300, d)
                t1 = (box_lo - o) * inv
                t2 = (box_hi - o) * inv
                t_in = np.minimum(t1, t2).max(axis=1)
                t_out = np.maximum(t1, t2).min(axis=1)
                live = (t_in <= t_out) & (t_out >= t_lo[r]) & (t_in <= t_hi[r])
                cand = np.sort(ids[live].ravel())
                if cand.size == 0:
                    continue
                cand = np.unique(cand)
                s = o - p0[cand]
                s1 = np.cross(d, e2[cand])
                s2 = np.cross(s, e1[cand])
                det = (s1 * e1[cand]).sum(-1)
                safe = np.where(det != 0, det, 1.0)
                t = (s2 * e2[cand]).sum(-1) / safe
                b1 = (s1 * s).sum(-1) / safe
                b2 = (s2 * d).sum(-1) / safe
                ok = (
                    (det != 0) & (b1 >= 0) & (b1 <= 1) & (b2 >= 0) & (b2 <= 1)
                    & (b1 + b2 <= 1) & (t >= t_lo[r]) & (t <= t_hi[r])
                )
                if ok.any():
                    k = np.argmin(np.where(ok, t, np.inf))
                    best_t[r], best_p[r] = t[k], cand[k]
    for si in range(scene.num_spheres):
        c = np.asarray(scene.sph_center[si], np.float64)
        rad = float(scene.sph_radius[si])
        oc = O - c
        a = (D * D).sum(-1)
        b = 2 * (oc * D).sum(-1)
        cc = (oc * oc).sum(-1) - rad * rad
        disc = b * b - 4 * a * cc
        sq = np.sqrt(np.maximum(disc, 0.0))
        t1 = (-b - sq) / (2 * a)
        t2 = (-b + sq) / (2 * a)
        t = np.where((t1 >= t_lo) & (t1 <= t_hi), t1, t2)
        ok = (disc >= 0) & (t >= t_lo) & (t <= t_hi) & (t < best_t)
        best_t = np.where(ok, t, best_t)
        best_p = np.where(ok, len(tri) + si, best_p)
    hit = best_p >= 0
    return dict(hit=hit, t=np.where(hit, best_t, 1e30), prim=best_p)


def moller_trumbore(p0, p1, p2, o, d):
    e1 = p1 - p0
    e2 = p2 - p0
    s = o - p0
    s1 = np.cross(d, e2)
    s2 = np.cross(s, e1)
    det = np.dot(s1, e1)
    if det == 0:
        return None
    t = np.dot(s2, e2) / det
    b1 = np.dot(s1, s) / det
    b2 = np.dot(s2, d) / det
    if b1 < 0 or b1 > 1 or b2 < 0 or b2 > 1 or b1 + b2 > 1:
        return None
    return t, b1, b2


def sphere_test(c, r, o, d, t_lo, t_hi):
    oc = o - c
    a = np.dot(d, d)
    b = 2 * np.dot(oc, d)
    cc = np.dot(oc, oc) - r * r
    disc = b * b - 4 * a * cc
    if disc < 0:
        return None
    sq = np.sqrt(disc)
    t1 = (-b - sq) / (2 * a)
    t2 = (-b + sq) / (2 * a)
    if t_lo <= t1 <= t_hi:
        return t1
    if t_lo <= t2 <= t_hi:
        return t2
    return None


def make_coord_space(n):
    """Normal frame (bsdf.cpp:21-41): returns o2w with columns x,y,z(=n)."""
    z = np.array(n, dtype=np.float64)
    h = z.copy()
    ax = np.abs(h)
    if ax[0] <= ax[1] and ax[0] <= ax[2]:
        h[0] = 1.0
    elif ax[1] <= ax[0] and ax[1] <= ax[2]:
        h[1] = 1.0
    else:
        h[2] = 1.0
    z = z / np.linalg.norm(z)
    y = np.cross(h, z)
    y = y / np.linalg.norm(y)
    x = np.cross(z, y)
    x = x / np.linalg.norm(x)
    o2w = np.stack([x, y, z], axis=1)
    return o2w


def sample_light(lights, li, p, uniforms):
    """sample_L for light row li at point p (light.cpp). uniforms: (2,) in [0,1).

    Returns (radiance, wi, dist, pdf).
    """
    lt = int(lights.light_type[li])
    if lt == 1:  # directional
        wi = lights.direction[li].astype(np.float64)
        return lights.radiance[li].astype(np.float64), wi, INF, 1.0
    if lt == 2:  # point
        d = lights.position[li].astype(np.float64) - p
        dist = np.linalg.norm(d)
        return lights.radiance[li].astype(np.float64), d / dist, dist, 1.0
    if lt == 3:  # area (light.cpp:76-94)
        u, v = uniforms[0] - 0.5, uniforms[1] - 0.5
        d = (
            lights.position[li].astype(np.float64)
            + u * lights.dim_x[li]
            + v * lights.dim_y[li]
            - p
        )
        cos_theta = np.dot(d, lights.direction[li].astype(np.float64))
        sq_dist = np.dot(d, d)
        dist = np.sqrt(sq_dist)
        pdf = sq_dist / (lights.area[li] * abs(cos_theta))
        rad = lights.radiance[li].astype(np.float64) if cos_theta < 0 else np.zeros(3)
        return rad, d / dist, dist, pdf
    if lt == 0:  # infinite hemisphere (light.cpp:28-43)
        xi1, xi2 = uniforms
        theta = np.arccos(xi1)
        phi = 2 * np.pi * xi2
        dir_local = np.array(
            [np.sin(theta) * np.cos(phi), np.sin(theta) * np.sin(phi), np.cos(theta)]
        )
        s2w = np.array([[1.0, 0, 0], [0, 0, -1], [0, 1, 0]])
        wi = s2w @ dir_local
        return lights.radiance[li].astype(np.float64), wi, INF, 1.0 / (2 * np.pi)
    raise ValueError(lt)


def orient_normal(bsdfs, isect, ray_d):
    """Face-forward shading normal for reflective materials (see
    integrator.path._orient_normals)."""
    btype = int(bsdfs.bsdf_type[isect["bsdf"]])
    if btype in (4, 5):  # refraction/glass keep the raw normal
        return isect["n"]
    if np.dot(isect["n"], ray_d) > 0:
        return -isect["n"]
    return isect["n"]


def direct_lighting(scene, bsdfs, ray_o, ray_d, isect, ns_area_light, light_uniforms):
    """estimate_direct_lighting_importance (pathtracer.cpp:142-213), diffuse only.

    light_uniforms: dict (light_index, sample_index) -> (2,) uniforms.
    """
    lights = scene.lights
    o2w = make_coord_space(orient_normal(bsdfs, isect, ray_d))
    w2o = o2w.T
    hit_p = ray_o + ray_d * isect["t"]
    w_out = w2o @ (-ray_d)

    L_out = np.zeros(3)
    total_samples = 0
    for li in range(len(lights.light_type)):
        ns = 1 if lights.is_delta[li] else ns_area_light
        total_samples += ns
        for s in range(ns):
            uni = light_uniforms.get((li, s), np.zeros(2))
            emission, wi_world, dist, pdf = sample_light(lights, li, hit_p, uni)
            wi_obj = w2o @ wi_world
            if wi_obj[2] < 0:
                continue
            # f32-consistent shadow bias (integrator.path._offset_origin)
            n_sh = o2w[:, 2]
            side = np.sign(np.dot(n_sh, wi_world))
            offset = n_sh * side * 1e-4 * max(1.0, np.abs(hit_p).max())
            # relative shadow clip (integrator.path.direct_lighting): emitter
            # geometry at the sample point must not occlude its own light
            shadow = intersect_brute(
                scene, hit_p + offset, wi_world, EPS_F, dist * (1.0 - 1e-3) - EPS_F
            )
            if shadow is None:
                cos_theta = wi_obj[2] / np.linalg.norm(wi_obj)
                f = bsdf_f(bsdfs, isect["bsdf"], -wi_obj, w_out)
                L_out += f * emission * cos_theta / pdf
    return L_out / total_samples


def bsdf_f(bsdfs, b, wi, wo):
    """BSDF::f. Diffuse: albedo/pi (bsdf.cpp:52-61); emission: 0."""
    btype = int(bsdfs.bsdf_type[b])
    if btype == 0:
        return bsdfs.albedo[b].astype(np.float64) / np.pi
    if btype == 3:
        return microfacet_f(bsdfs, b, wi, wo)
    return np.zeros(3)


def bsdf_emission(bsdfs, b):
    btype = int(bsdfs.bsdf_type[b])
    if btype == 1:
        return bsdfs.radiance[b].astype(np.float64)
    return np.zeros(3)


def microfacet_f(bsdfs, b, wi, wo):
    """Beckmann microfacet with conductor Fresnel (proper implementation of
    the reference's stub MicrofacetBSDF, advanced_bsdf.cpp:55-102 TODOs)."""
    wi = np.asarray(wi, np.float64)
    wo = np.asarray(wo, np.float64)
    # NOTE: the integrator convention passes wi pointing *into* the surface
    # (reference calls f(-wi_obj, w_out)); flip to the usual convention here.
    wi = -wi
    if wi[2] <= 0 or wo[2] <= 0:
        return np.zeros(3)
    h = wi + wo
    h = h / np.linalg.norm(h)
    alpha = float(bsdfs.alpha[b])
    # Beckmann NDF
    cos_h = h[2]
    tan2 = (1 - cos_h * cos_h) / (cos_h * cos_h)
    D = np.exp(-tan2 / (alpha * alpha)) / (np.pi * alpha * alpha * cos_h ** 4)
    # Smith shadowing (Beckmann rational approx)
    G = smith_g1_beckmann(wi, alpha) * smith_g1_beckmann(wo, alpha)
    # conductor Fresnel per channel at cos(theta_i) w.r.t. half vector
    eta = bsdfs.eta[b].astype(np.float64)
    k = bsdfs.k[b].astype(np.float64)
    cos_i = wi[2]
    F = fresnel_conductor(cos_i, eta, k)
    return F * G * D / (4 * wo[2] * wi[2])


def smith_g1_beckmann(w, alpha):
    cos_t = abs(w[2])
    sin_t = np.sqrt(max(0.0, 1 - cos_t * cos_t))
    if sin_t == 0:
        return 1.0
    a = cos_t / (alpha * sin_t)
    if a >= 1.6:
        return 1.0
    return (3.535 * a + 2.181 * a * a) / (1 + 2.276 * a + 2.577 * a * a)


def fresnel_conductor(cos_i, eta, k):
    """Per-channel conductor Fresnel (CS184 approximation)."""
    c2 = cos_i * cos_i
    e2k2 = eta * eta + k * k
    rs = (e2k2 - 2 * eta * cos_i + c2) / (e2k2 + 2 * eta * cos_i + c2)
    rp = (e2k2 * c2 - 2 * eta * cos_i + 1) / (e2k2 * c2 + 2 * eta * cos_i + 1)
    return (rs + rp) / 2


def generate_ray(camera, x, y):
    """Pinhole ray for normalized (x, y) (camera.cpp:278-305)."""
    edge_x = np.tan(0.5 * np.radians(camera.h_fov))
    edge_y = np.tan(0.5 * np.radians(camera.v_fov))
    d = np.array([edge_x * (2 * x - 1), edge_y * (2 * y - 1), -1.0])
    d = d / np.linalg.norm(d)
    d_world = camera.c2w @ d
    return camera.pos.copy(), d_world


# ---------------------------------------------------------------------------
# Vectorized expectation oracle (indirect transport).
#
# Deterministic NumPy-f64 evaluation of the *expectation* of the production
# estimator: the integrator's Russian-roulette indirect loop
# (integrator/path.py:_indirect, mirroring pathtracer.cpp:234-280 with
# cpdf = 0.7) is an unbiased estimator of the path integral truncated at
# max_ray_depth, so its per-pixel mean must converge to the stratified
# quadrature computed here.  Diffuse-only transport (CS184 part 4): vertices
# with non-diffuse BSDFs terminate the chain, exactly as ``sample_f`` of an
# emission BSDF returns an invalid sample in the production path.
#
# Everything below is vectorized over rays but independent of the JAX code:
# plain NumPy, no BVH, brute force over primitives.
# ---------------------------------------------------------------------------

SHADOW_BIAS = 1e-4  # integrator/path.py:SHADOW_BIAS (f32-native acne offset)


def intersect_brute_batch(scene, O, D, t_lo, t_hi):
    """Closest hit for a batch of rays by testing every primitive.

    O, D: (N, 3); t_lo scalar; t_hi: (N,). Returns dict of arrays
    hit (N,) bool, t (N,), n (N, 3) interpolated+normalized, bsdf (N,) int.
    """
    # dead lanes carry zero directions: 0/0 -> NaN compares False (masked out)
    with np.errstate(divide="ignore", invalid="ignore"):
        return _intersect_brute_batch(scene, O, D, t_lo, t_hi)


def _intersect_brute_batch(scene, O, D, t_lo, t_hi):
    N = O.shape[0]
    best_t = np.asarray(t_hi, np.float64).copy()
    hit = np.zeros(N, bool)
    nrm = np.zeros((N, 3))
    bsdf = np.zeros(N, np.int64)
    for i in range(scene.num_triangles):
        p0, p1, p2 = scene.tri_p[i].astype(np.float64)
        e1, e2 = p1 - p0, p2 - p0
        s = O - p0
        s1 = np.cross(D, e2)
        s2 = np.cross(s, e1)
        det = s1 @ e1
        ok = det != 0
        inv = np.where(ok, det, 1.0)
        t = (s2 @ e2) / inv
        b1 = (s1 * s).sum(-1) / inv
        b2 = (s2 * D).sum(-1) / inv
        ok &= (b1 >= 0) & (b1 <= 1) & (b2 >= 0) & (b2 <= 1) & (b1 + b2 <= 1)
        ok &= (t >= t_lo) & (t <= best_t)
        if not ok.any():
            continue
        n = (
            (1 - b1 - b2)[:, None] * scene.tri_n[i, 0]
            + b1[:, None] * scene.tri_n[i, 1]
            + b2[:, None] * scene.tri_n[i, 2]
        )
        n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-30)
        best_t = np.where(ok, t, best_t)
        hit |= ok
        nrm = np.where(ok[:, None], n, nrm)
        bsdf = np.where(ok, int(scene.tri_bsdf[i]), bsdf)
    for si in range(scene.num_spheres):
        c = scene.sph_center[si].astype(np.float64)
        r = float(scene.sph_radius[si])
        oc = O - c
        a = (D * D).sum(-1)
        b = 2 * (oc * D).sum(-1)
        cc = (oc * oc).sum(-1) - r * r
        disc = b * b - 4 * a * cc
        ok0 = disc >= 0
        sq = np.sqrt(np.where(ok0, disc, 0.0))
        t1 = (-b - sq) / (2 * a)
        t2 = (-b + sq) / (2 * a)
        t = np.where((t1 >= t_lo) & (t1 <= best_t), t1, t2)
        ok = ok0 & (t >= t_lo) & (t <= best_t)
        if not ok.any():
            continue
        p = O + D * t[:, None]
        n = p - c
        n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-30)
        best_t = np.where(ok, t, best_t)
        hit |= ok
        nrm = np.where(ok[:, None], n, nrm)
        bsdf = np.where(ok, int(scene.sph_bsdf[si]), bsdf)
    return dict(hit=hit, t=best_t, n=nrm, bsdf=bsdf)


def make_coord_space_batch(n):
    """Batched normal frame; ties in the smallest-|component| pick match
    make_coord_space (first index wins, as in bsdf.cpp:21-41)."""
    n = np.asarray(n, np.float64)
    ax = np.abs(n)
    smallest = np.argmin(ax, axis=-1)
    h = np.where(np.arange(3) == smallest[:, None], 1.0, n)
    z = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-30)
    y = np.cross(h, z)
    y = y / np.maximum(np.linalg.norm(y, axis=-1, keepdims=True), 1e-30)
    x = np.cross(z, y)
    x = x / np.maximum(np.linalg.norm(x, axis=-1, keepdims=True), 1e-30)
    return np.stack([x, y, z], axis=-1)  # columns x, y, z


def orient_normals_batch(bsdfs, bsdf_ids, n, d, hit):
    """Face-forward shading normals for non-transmissive materials
    (integrator/path.py:_orient_normals)."""
    btype = np.asarray(bsdfs.bsdf_type)[bsdf_ids]
    transmissive = (btype == 4) | (btype == 5)
    flip = ((n * d).sum(-1) > 0) & ~transmissive & hit
    return np.where(flip[:, None], -n, n)


def _offset_origin_batch(p, n, w):
    side = np.sign((n * w).sum(-1, keepdims=True))
    scale = SHADOW_BIAS * np.maximum(1.0, np.abs(p).max(-1, keepdims=True))
    return p + n * side * scale


def direct_expectation_batch(scene, P, Nrm, bsdf_ids, alive, ns_area_light=1, grid_light=4):
    """Expectation of the NEE estimator at a batch of diffuse vertices.

    Stratified grid_light^2 quadrature over each area light's surface;
    delta lights evaluated exactly.  Mirrors integrator/path.py:direct_lighting
    semantics (facing test, shadow offset, relative clip, slot normalization).
    P, Nrm: (M, 3); returns (M, 3).
    """
    # grazing area-light samples give pdf = inf (cos -> 0); the contribution
    # divides back to zero, so silence the intermediate warning
    with np.errstate(divide="ignore", invalid="ignore"):
        return _direct_expectation_batch(
            scene, P, Nrm, bsdf_ids, alive, ns_area_light, grid_light
        )


def _direct_expectation_batch(scene, P, Nrm, bsdf_ids, alive, ns_area_light, grid_light):
    lights = scene.lights
    M = P.shape[0]
    o2w = make_coord_space_batch(Nrm)
    albedo = np.asarray(scene.bsdfs.albedo, np.float64)[bsdf_ids]
    diffuse = (np.asarray(scene.bsdfs.bsdf_type)[bsdf_ids] == 0) & alive
    f = albedo / np.pi  # diffuse f; non-diffuse vertices masked out below

    total_slots = 0
    L = np.zeros((M, 3))
    for li in range(len(lights.light_type)):
        lt = int(lights.light_type[li])
        if lt in (1, 2):  # directional / point: delta, one exact sample
            total_slots += 1
            if lt == 1:
                wi = np.broadcast_to(lights.direction[li].astype(np.float64), (M, 3))
                dist = np.full(M, INF)
            else:
                d = lights.position[li].astype(np.float64) - P
                dist = np.linalg.norm(d, axis=-1)
                wi = d / dist[:, None]
            rad = np.broadcast_to(lights.radiance[li].astype(np.float64), (M, 3))
            pdf = np.ones(M)
            L += _nee_term(scene, P, Nrm, o2w, f, diffuse, wi, dist, rad, pdf)
        elif lt == 3:  # area: stratified expectation of the 1-sample estimator
            total_slots += ns_area_light
            g = grid_light
            uu, vv = np.meshgrid((np.arange(g) + 0.5) / g, (np.arange(g) + 0.5) / g)
            us = np.stack([uu.ravel(), vv.ravel()], axis=1)  # (G, 2)
            G = us.shape[0]
            pos = lights.position[li].astype(np.float64)
            dx = lights.dim_x[li].astype(np.float64)
            dy = lights.dim_y[li].astype(np.float64)
            ldir = lights.direction[li].astype(np.float64)
            # (G, M, 3)
            samp = pos + (us[:, 0:1] - 0.5) * dx + (us[:, 1:2] - 0.5) * dy
            d = samp[:, None, :] - P[None, :, :]
            cos_l = d @ ldir
            sq = (d * d).sum(-1)
            dist = np.sqrt(sq)
            wi = d / dist[..., None]
            pdf = sq / (float(lights.area[li]) * np.abs(cos_l))
            rad = np.where(
                (cos_l < 0)[..., None], lights.radiance[li].astype(np.float64), 0.0
            )
            acc = np.zeros((M, 3))
            for gi in range(G):
                acc += _nee_term(
                    scene, P, Nrm, o2w, f, diffuse, wi[gi], dist[gi], rad[gi], pdf[gi]
                )
            L += ns_area_light * acc / G
        else:
            raise NotImplementedError(f"light type {lt} in expectation oracle")
    return L / max(total_slots, 1)


def _nee_term(scene, P, Nrm, o2w, f, diffuse, wi, dist, rad, pdf):
    """One NEE slot: facing test, shadow ray, f * L * cos / pdf."""
    wi_obj = np.einsum("mij,mi->mj", o2w, wi)
    facing = wi_obj[:, 2] >= 0
    live = facing & (pdf > 0) & diffuse
    o = _offset_origin_batch(P, Nrm, wi)
    t_hi = np.where(live, dist * (1.0 - 1e-3) - EPS_F, 0.0)
    occ = intersect_brute_batch(scene, o, wi, EPS_F, t_hi)["hit"]
    cos_t = wi_obj[:, 2] / np.maximum(np.linalg.norm(wi_obj, axis=-1), 1e-30)
    contrib = f * rad * (cos_t / np.maximum(pdf, 1e-30))[:, None]
    return np.where((live & ~occ)[:, None], contrib, 0.0)


def indirect_expectation_batch(
    scene, P, Nrm, bsdf_ids, alive, depth_left, grid_hemi=6, grid_light=4
):
    """Expectation of the RR indirect estimator at a batch of vertices.

    The production step weight is f*cos/(pdf*cpdf) with a cosine-weighted
    sampler, whose expectation for a diffuse vertex is
    albedo * E_{wi~cos}[L(next)]; RR (E[1{cont}]/cpdf = 1) and the
    depth-counting of integrator/path.py:_indirect make the total exactly the
    path integral truncated at depth_left.  Stratified cosine quadrature
    with grid_hemi^2 directions; chains terminate at non-diffuse vertices
    and on miss (no env light here).
    """
    M = P.shape[0]
    if depth_left <= 1 or not alive.any():
        return np.zeros((M, 3))
    diffuse = (np.asarray(scene.bsdfs.bsdf_type)[bsdf_ids] == 0) & alive
    albedo = np.asarray(scene.bsdfs.albedo, np.float64)[bsdf_ids]
    o2w = make_coord_space_batch(Nrm)

    g = grid_hemi
    u1, u2 = np.meshgrid((np.arange(g) + 0.5) / g, (np.arange(g) + 0.5) / g)
    u1, u2 = u1.ravel(), u2.ravel()
    cos_t = np.sqrt(1.0 - u1)  # cosine-weighted: pdf = cos/pi
    sin_t = np.sqrt(u1)
    phi = 2 * np.pi * u2
    wis = np.stack([sin_t * np.cos(phi), sin_t * np.sin(phi), cos_t], axis=1)  # (G,3)

    acc = np.zeros((M, 3))
    for gi in range(wis.shape[0]):
        wi_w = np.einsum("mij,j->mi", o2w, wis[gi])
        o = _offset_origin_batch(P, Nrm, wi_w)
        t_hi = np.where(diffuse, 1e30, 0.0)
        nxt = intersect_brute_batch(scene, o, wi_w, EPS_F, t_hi)
        live = diffuse & nxt["hit"]
        n2 = orient_normals_batch(scene.bsdfs, nxt["bsdf"], nxt["n"], wi_w, nxt["hit"])
        p2 = o + wi_w * nxt["t"][:, None]
        Ld = direct_expectation_batch(
            scene, p2, n2, nxt["bsdf"], live, grid_light=grid_light
        )
        Li = indirect_expectation_batch(
            scene, p2, n2, nxt["bsdf"], live, depth_left - 1, grid_hemi, grid_light
        )
        acc += np.where(live[:, None], Ld + Li, 0.0)
    return albedo * acc / wis.shape[0]


def render_expectation(scene, camera, W, H, max_ray_depth, grid_hemi=6, grid_light=4):
    """Full-image expectation: emission + NEE direct + truncated indirect.

    Deterministic quadrature the production renderer's per-pixel mean must
    converge to (rays through pixel centers, diffuse transport).  Returns
    (total, direct_only) each (H, W, 3).
    """
    M = W * H
    O = np.zeros((M, 3))
    D = np.zeros((M, 3))
    for yy in range(H):
        for xx in range(W):
            o, d = generate_ray(camera, (xx + 0.5) / W, (yy + 0.5) / H)
            O[yy * W + xx] = o
            D[yy * W + xx] = d
    hit = intersect_brute_batch(
        scene, O, D, camera.n_clip, np.full(M, camera.f_clip)
    )
    n = orient_normals_batch(scene.bsdfs, hit["bsdf"], hit["n"], D, hit["hit"])
    p = O + D * np.where(hit["hit"], hit["t"], 0.0)[:, None]
    emission = np.stack(
        [bsdf_emission(scene.bsdfs, int(b)) for b in hit["bsdf"]]
    )
    direct = direct_expectation_batch(
        scene, p, n, hit["bsdf"], hit["hit"], grid_light=grid_light
    )
    indirect = indirect_expectation_batch(
        scene, p, n, hit["bsdf"], hit["hit"], max_ray_depth, grid_hemi, grid_light
    )
    total = np.where(hit["hit"][:, None], emission + direct + indirect, 0.0)
    direct_only = np.where(hit["hit"][:, None], emission + direct, 0.0)
    return total.reshape(H, W, 3), direct_only.reshape(H, W, 3)
