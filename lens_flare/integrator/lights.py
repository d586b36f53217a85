"""Batched light sampling (``src/scene/light.cpp`` semantics).

Light table rows carry a type code; ``sample_light`` evaluates every family
for a (shading-point, light) pair batch and mask-selects — same branch-free
wavefront dispatch as the BSDFs.  The environment light (type LT_ENV) routes
through :mod:`lens_flare.integrator.envlight` CDF tables.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp

from ..scene.build import (
    LT_AREA,
    LT_DIRECTIONAL,
    LT_HEMISPHERE,
    LT_MESH,
    LT_POINT,
    LT_SPHERE,
    LT_SPOT,
)

LT_ENV = 4
INF = jnp.float32(1e30)

# InfiniteHemisphereLight sampleToWorld (light.cpp:30-33)
_HEMI_S2W = jnp.array([[1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]])


class LightArrays(NamedTuple):
    light_type: jnp.ndarray  # (L,)
    radiance: jnp.ndarray  # (L,3)
    position: jnp.ndarray
    direction: jnp.ndarray
    dim_x: jnp.ndarray
    dim_y: jnp.ndarray
    area: jnp.ndarray
    is_delta: jnp.ndarray
    # mesh-light triangle pool (M >= 1, padded): [p0, e1, e2] rows, owning
    # light id, in-light cumulative area fraction
    mesh_tri: jnp.ndarray = jnp.zeros((1, 9), jnp.float32)
    mesh_tri_light: jnp.ndarray = jnp.full(1, -1, jnp.int32)
    mesh_tri_cdf: jnp.ndarray = jnp.ones(1, jnp.float32)


class LightSample(NamedTuple):
    radiance: jnp.ndarray  # (N, 3)
    wi: jnp.ndarray  # (N, 3) world, towards the light
    dist: jnp.ndarray  # (N,)
    pdf: jnp.ndarray  # (N,)


def lights_to_device(table, dtype=jnp.float32) -> LightArrays:
    import numpy as np

    m = len(getattr(table, "mesh_tri", ()))
    if m:
        mesh_tri = jnp.asarray(table.mesh_tri, dtype)
        mesh_light = jnp.asarray(table.mesh_tri_light)
        mesh_cdf = jnp.asarray(table.mesh_tri_cdf, dtype)
    else:  # padded sentinel row so gathers stay in-bounds
        mesh_tri = jnp.zeros((1, 9), dtype)
        mesh_light = jnp.full(1, -1, jnp.int32)
        mesh_cdf = jnp.ones(1, dtype)
    return LightArrays(
        light_type=jnp.asarray(table.light_type),
        radiance=jnp.asarray(table.radiance, dtype),
        position=jnp.asarray(table.position, dtype),
        direction=jnp.asarray(table.direction, dtype),
        dim_x=jnp.asarray(table.dim_x, dtype),
        dim_y=jnp.asarray(table.dim_y, dtype),
        area=jnp.asarray(table.area, dtype),
        is_delta=jnp.asarray(table.is_delta),
        mesh_tri=mesh_tri,
        mesh_tri_light=mesh_light,
        mesh_tri_cdf=mesh_cdf,
    )


def sample_light(lights: LightArrays, li, p, u, env=None, types_present=None):
    """sample_L for light index batch li (N,), points p (N,3), uniforms u (N,2).

    Returns a LightSample; env is the optional EnvLightArrays for LT_ENV rows.

    ``types_present``: optional static collection of the LT_* codes that
    actually occur in the scene's light table.  The light types per NEE slot
    are host-known, so absent families are specialized away at trace time
    instead of being computed for every lane and mask-selected (the
    sphere-cone/hemisphere trig and the mesh-light CDF argmax would
    otherwise run for scenes with none of those lights).
    None computes every family (exact old behavior).
    """

    def has(code):
        return types_present is None or code in types_present

    lt = lights.light_type[li]
    rad = lights.radiance[li]
    xi1, xi2 = u[..., 0], u[..., 1]
    phi = 2.0 * jnp.pi * xi2

    # directional (light.cpp:19-24): wi = dirToLight, dist = inf, pdf = 1
    wi = lights.direction[li]
    dist = jnp.full(p.shape[:-1], INF)
    pdf = jnp.ones(p.shape[:-1])
    out_rad = rad

    if has(LT_POINT) or has(LT_SPOT):
        # point (light.cpp:51-58)
        d_point = lights.position[li] - p
        dist_point = jnp.linalg.norm(d_point, axis=-1)
        wi_point = d_point / jnp.maximum(dist_point[..., None], 1e-30)
        is_pt = (lt == LT_POINT) | (lt == LT_SPOT)
        wi = jnp.where(is_pt[..., None], wi_point, wi)
        dist = jnp.where(is_pt, dist_point, dist)

    if has(LT_AREA):
        # area (light.cpp:76-94)
        uv = u - 0.5
        d_area = (
            lights.position[li]
            + uv[..., 0:1] * lights.dim_x[li]
            + uv[..., 1:2] * lights.dim_y[li]
            - p
        )
        cos_theta = jnp.sum(d_area * lights.direction[li], axis=-1)
        sq_dist = jnp.sum(d_area * d_area, axis=-1)
        dist_area = jnp.sqrt(sq_dist)
        wi_area = d_area / jnp.maximum(dist_area[..., None], 1e-30)
        pdf_area = sq_dist / jnp.maximum(lights.area[li] * jnp.abs(cos_theta), 1e-30)
        rad_area = jnp.where((cos_theta < 0)[..., None], rad, 0.0)
        is_area = lt == LT_AREA
        wi = jnp.where(is_area[..., None], wi_area, wi)
        dist = jnp.where(is_area, dist_area, dist)
        pdf = jnp.where(is_area, pdf_area, pdf)
        out_rad = jnp.where(is_area[..., None], rad_area, out_rad)

    if has(LT_HEMISPHERE):
        # infinite hemisphere (light.cpp:36-43): uniform about +y world
        theta = jnp.arccos(jnp.clip(xi1, -1.0, 1.0))
        local = jnp.stack(
            [
                jnp.sin(theta) * jnp.cos(phi),
                jnp.sin(theta) * jnp.sin(phi),
                jnp.cos(theta),
            ],
            axis=-1,
        )
        wi_hemi = jnp.matmul(local, _HEMI_S2W.T, precision="highest")
        is_hemi = lt == LT_HEMISPHERE
        wi = jnp.where(is_hemi[..., None], wi_hemi, wi)
        pdf = jnp.where(is_hemi, 1.0 / (2.0 * jnp.pi), pdf)

    if has(LT_SPOT):
        # spot (proper implementation of the reference stub, light.cpp:63-71):
        # point-light geometry, radiance scaled by a smooth cone falloff
        cos_cone = lights.dim_x[li][..., 0]
        fall_exp = lights.dim_x[li][..., 1]
        cos_dir = jnp.sum(-wi_point * lights.direction[li], axis=-1)
        spot_scale = jnp.clip(
            (cos_dir - cos_cone) / jnp.maximum(1.0 - cos_cone, 1e-6), 0.0, 1.0
        ) ** jnp.maximum(fall_exp, 1e-6)
        out_rad = jnp.where(
            (lt == LT_SPOT)[..., None], rad * spot_scale[..., None], out_rad
        )

    if has(LT_SPHERE):
        # sphere (proper implementation of the reference stub,
        # light.cpp:99-109): uniform over the subtended solid-angle cone
        sph_r = lights.dim_x[li][..., 0]
        to_c = lights.position[li] - p
        dc = jnp.linalg.norm(to_c, axis=-1)
        axis = to_c / jnp.maximum(dc[..., None], 1e-30)
        sin2_max = jnp.clip((sph_r / jnp.maximum(dc, 1e-30)) ** 2, 0.0, 1.0)
        cos_max = jnp.sqrt(jnp.maximum(1.0 - sin2_max, 0.0))
        cos_t = 1.0 - xi1 * (1.0 - cos_max)
        sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
        # ONB around the cone axis
        h = jnp.where(
            (jnp.abs(axis[..., 0:1]) > 0.9),
            jnp.array([0.0, 1.0, 0.0]),
            jnp.array([1.0, 0.0, 0.0]),
        )
        tx = jnp.cross(axis, jnp.broadcast_to(h, axis.shape))
        tx = tx / jnp.maximum(jnp.linalg.norm(tx, axis=-1, keepdims=True), 1e-30)
        ty = jnp.cross(axis, tx)
        wi_sph = (
            axis * cos_t[..., None]
            + (tx * jnp.cos(phi)[..., None] + ty * jnp.sin(phi)[..., None])
            * sin_t[..., None]
        )
        pdf_sph = 1.0 / jnp.maximum(2.0 * jnp.pi * (1.0 - cos_max), 1e-30)
        # distance to the sphere surface along wi (near quadratic root)
        disc = jnp.maximum(sph_r**2 - (dc * sin_t) ** 2, 0.0)
        dist_sph = jnp.maximum(dc * cos_t - jnp.sqrt(disc), 0.0)
        is_sph = lt == LT_SPHERE
        wi = jnp.where(is_sph[..., None], wi_sph, wi)
        dist = jnp.where(is_sph, dist_sph, dist)
        pdf = jnp.where(is_sph, pdf_sph, pdf)

    if has(LT_MESH):
        # mesh (proper implementation of the reference stub, light.cpp:111-118):
        # area-uniform point via per-tri CDF + rescaled-uniform barycentrics
        tri_owner = lights.mesh_tri_light  # (M,)
        tri_cdf = lights.mesh_tri_cdf  # (M,)
        mine = tri_owner[None, :] == li[..., None]  # (N, M)
        sel = mine & (tri_cdf[None, :] >= u[..., 0:1])
        tri_idx = jnp.argmax(sel, axis=-1)  # first matching tri (N,)
        row = lights.mesh_tri[tri_idx]  # (N, 9)
        cdf_hi = tri_cdf[tri_idx]
        prev_mask = mine & (
            jnp.arange(tri_cdf.shape[0])[None, :] < tri_idx[..., None]
        )
        cdf_lo = jnp.max(jnp.where(prev_mask, tri_cdf[None, :], 0.0), axis=-1)
        u0r = jnp.clip(
            (u[..., 0] - cdf_lo) / jnp.maximum(cdf_hi - cdf_lo, 1e-30), 0.0, 1.0
        )
        su = jnp.sqrt(u0r)
        b1c = 1.0 - su
        b2c = u[..., 1] * su
        mp0, me1, me2 = row[..., 0:3], row[..., 3:6], row[..., 6:9]
        pt = mp0 + b1c[..., None] * me1 + b2c[..., None] * me2
        mn = jnp.cross(me1, me2)
        mn = mn / jnp.maximum(jnp.linalg.norm(mn, axis=-1, keepdims=True), 1e-30)
        d_mesh = pt - p
        sq_mesh = jnp.sum(d_mesh * d_mesh, axis=-1)
        dist_mesh = jnp.sqrt(sq_mesh)
        wi_mesh = d_mesh / jnp.maximum(dist_mesh[..., None], 1e-30)
        cos_mesh = jnp.sum(d_mesh * mn, axis=-1)
        pdf_mesh = sq_mesh / jnp.maximum(lights.area[li] * jnp.abs(cos_mesh), 1e-30)
        is_mesh = lt == LT_MESH
        wi = jnp.where(is_mesh[..., None], wi_mesh, wi)
        dist = jnp.where(is_mesh, dist_mesh, dist)
        pdf = jnp.where(is_mesh, pdf_mesh, pdf)
        # two-sided emitter (the mesh winding is arbitrary); radiance as-is

    if env is not None and has(LT_ENV):
        from . import envlight

        es = envlight.sample_env(env, u)
        is_env = lt == LT_ENV
        wi = jnp.where(is_env[..., None], es.wi, wi)
        pdf = jnp.where(is_env, es.pdf, pdf)
        out_rad = jnp.where(is_env[..., None], es.radiance, out_rad)
        dist = jnp.where(is_env, INF, dist)

    return LightSample(radiance=out_rad, wi=wi, dist=dist, pdf=pdf)


def sample_light_static(lights: LightArrays, row: int, code: int, p, u, env=None):
    """sample_L for ONE host-known light (static row index + LT code).

    NEE slots map to light rows at trace time (``RenderSettings.light_slots``
    is a static tuple), so the per-lane table gathers of :func:`sample_light`
    collapse to static row slices broadcast over the lanes, and only the one
    family's math is traced.

    Semantics are identical to sample_light (same light.cpp formulas);
    ``tests/test_lights_extra.py`` asserts bit-equality per family.
    """
    n = p.shape[0]
    rad = jnp.broadcast_to(lights.radiance[row], (n, 3))
    xi1, xi2 = u[..., 0], u[..., 1]

    if code == LT_DIRECTIONAL:
        # light.cpp:19-24
        wi = jnp.broadcast_to(lights.direction[row], (n, 3))
        return LightSample(rad, wi, jnp.full(n, INF), jnp.ones(n))

    if code in (LT_POINT, LT_SPOT):
        # light.cpp:51-58 (+ cone falloff for the spot stub, light.cpp:63-71)
        d = lights.position[row] - p
        dist = jnp.linalg.norm(d, axis=-1)
        wi = d / jnp.maximum(dist[..., None], 1e-30)
        if code == LT_SPOT:
            cos_cone = lights.dim_x[row, 0]
            fall_exp = lights.dim_x[row, 1]
            cos_dir = jnp.sum(-wi * lights.direction[row], axis=-1)
            scale = jnp.clip(
                (cos_dir - cos_cone) / jnp.maximum(1.0 - cos_cone, 1e-6), 0.0, 1.0
            ) ** jnp.maximum(fall_exp, 1e-6)
            rad = rad * scale[..., None]
        return LightSample(rad, wi, dist, jnp.ones(n))

    if code == LT_AREA:
        # light.cpp:76-94
        uv = u - 0.5
        d = (
            lights.position[row]
            + uv[..., 0:1] * lights.dim_x[row]
            + uv[..., 1:2] * lights.dim_y[row]
            - p
        )
        cos_theta = jnp.sum(d * lights.direction[row], axis=-1)
        sq_dist = jnp.sum(d * d, axis=-1)
        dist = jnp.sqrt(sq_dist)
        wi = d / jnp.maximum(dist[..., None], 1e-30)
        pdf = sq_dist / jnp.maximum(lights.area[row] * jnp.abs(cos_theta), 1e-30)
        rad = jnp.where((cos_theta < 0)[..., None], rad, 0.0)
        return LightSample(rad, wi, dist, pdf)

    if code == LT_HEMISPHERE:
        # light.cpp:36-43
        phi = 2.0 * jnp.pi * xi2
        theta = jnp.arccos(jnp.clip(xi1, -1.0, 1.0))
        local = jnp.stack(
            [
                jnp.sin(theta) * jnp.cos(phi),
                jnp.sin(theta) * jnp.sin(phi),
                jnp.cos(theta),
            ],
            axis=-1,
        )
        wi = jnp.matmul(local, _HEMI_S2W.T, precision="highest")
        return LightSample(rad, wi, jnp.full(n, INF), jnp.full(n, 1.0 / (2.0 * jnp.pi)))

    if code == LT_SPHERE:
        # uniform over the subtended cone (light.cpp:99-109 stub, done right)
        phi = 2.0 * jnp.pi * xi2
        sph_r = lights.dim_x[row, 0]
        to_c = lights.position[row] - p
        dc = jnp.linalg.norm(to_c, axis=-1)
        axis = to_c / jnp.maximum(dc[..., None], 1e-30)
        sin2_max = jnp.clip((sph_r / jnp.maximum(dc, 1e-30)) ** 2, 0.0, 1.0)
        cos_max = jnp.sqrt(jnp.maximum(1.0 - sin2_max, 0.0))
        cos_t = 1.0 - xi1 * (1.0 - cos_max)
        sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
        h = jnp.where(
            (jnp.abs(axis[..., 0:1]) > 0.9),
            jnp.array([0.0, 1.0, 0.0]),
            jnp.array([1.0, 0.0, 0.0]),
        )
        tx = jnp.cross(axis, jnp.broadcast_to(h, axis.shape))
        tx = tx / jnp.maximum(jnp.linalg.norm(tx, axis=-1, keepdims=True), 1e-30)
        ty = jnp.cross(axis, tx)
        wi = (
            axis * cos_t[..., None]
            + (tx * jnp.cos(phi)[..., None] + ty * jnp.sin(phi)[..., None])
            * sin_t[..., None]
        )
        pdf = 1.0 / jnp.maximum(2.0 * jnp.pi * (1.0 - cos_max), 1e-30)
        disc = jnp.maximum(sph_r**2 - (dc * sin_t) ** 2, 0.0)
        dist = jnp.maximum(dc * cos_t - jnp.sqrt(disc), 0.0)
        return LightSample(rad, wi, dist, jnp.broadcast_to(pdf, (n,)))

    if code == LT_MESH:
        # area-uniform point via per-tri CDF (light.cpp:111-118 stub)
        tri_owner = lights.mesh_tri_light  # (M,)
        tri_cdf = lights.mesh_tri_cdf  # (M,)
        mine = (tri_owner == row)[None, :]  # (1, M) — static row
        sel = mine & (tri_cdf[None, :] >= u[..., 0:1])
        tri_idx = jnp.argmax(sel, axis=-1)
        row_tri = lights.mesh_tri[tri_idx]  # (N, 9)
        cdf_hi = tri_cdf[tri_idx]
        prev_mask = mine & (
            jnp.arange(tri_cdf.shape[0])[None, :] < tri_idx[..., None]
        )
        cdf_lo = jnp.max(jnp.where(prev_mask, tri_cdf[None, :], 0.0), axis=-1)
        u0r = jnp.clip(
            (u[..., 0] - cdf_lo) / jnp.maximum(cdf_hi - cdf_lo, 1e-30), 0.0, 1.0
        )
        su = jnp.sqrt(u0r)
        b1c = 1.0 - su
        b2c = u[..., 1] * su
        mp0, me1, me2 = row_tri[..., 0:3], row_tri[..., 3:6], row_tri[..., 6:9]
        pt = mp0 + b1c[..., None] * me1 + b2c[..., None] * me2
        mn = jnp.cross(me1, me2)
        mn = mn / jnp.maximum(jnp.linalg.norm(mn, axis=-1, keepdims=True), 1e-30)
        d = pt - p
        sq = jnp.sum(d * d, axis=-1)
        dist = jnp.sqrt(sq)
        wi = d / jnp.maximum(dist[..., None], 1e-30)
        cos_m = jnp.sum(d * mn, axis=-1)
        pdf = sq / jnp.maximum(lights.area[row] * jnp.abs(cos_m), 1e-30)
        return LightSample(rad, wi, dist, pdf)

    if code == LT_ENV:
        from . import envlight

        es = envlight.sample_env(env, u)
        return LightSample(es.radiance, es.wi, jnp.full(n, INF), es.pdf)

    raise ValueError(f"unknown light type code {code}")
