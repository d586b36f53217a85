"""SphereLight / MeshLight: proper implementations of the reference's
declared-but-stubbed classes (light.h:101-126, light.cpp:99-118).

- sphere: MC irradiance at a point facing the sphere must match the
  analytic cone integral  E = L * pi * sin^2(theta_max)
- mesh: a 2-triangle rectangle mesh light must agree in expectation with
  the reference's AreaLight estimator over the same rectangle
"""

import jax
import jax.numpy as jnp
import numpy as np

from lens_flare.integrator.lights import lights_to_device, sample_light
from lens_flare.scene.build import (
    LT_AREA,
    LightTable,
    add_mesh_light,
    add_sphere_light,
)


def _empty_table() -> LightTable:
    return LightTable(
        light_type=np.zeros(0, np.int32),
        radiance=np.zeros((0, 3), np.float32),
        position=np.zeros((0, 3), np.float32),
        direction=np.zeros((0, 3), np.float32),
        dim_x=np.zeros((0, 3), np.float32),
        dim_y=np.zeros((0, 3), np.float32),
        area=np.zeros(0, np.float32),
        is_delta=np.zeros(0, bool),
    )


def _mc_irradiance(lights, li, p, n, n_samples=200_000, seed=0):
    """E ~ mean(L * max(cos, 0) / pdf) via sample_light."""
    u = jax.random.uniform(jax.random.PRNGKey(seed), (n_samples, 2))
    li_b = jnp.full(n_samples, li, jnp.int32)
    p_b = jnp.broadcast_to(jnp.asarray(p, jnp.float32), (n_samples, 3))
    ls = sample_light(lights, li_b, p_b, u)
    cos = jnp.maximum(jnp.sum(ls.wi * jnp.asarray(n, jnp.float32), axis=-1), 0.0)
    est = ls.radiance * (cos / jnp.maximum(ls.pdf, 1e-30))[:, None]
    return np.asarray(est.mean(axis=0))


def test_sphere_light_matches_analytic_cone():
    t = _empty_table()
    center = np.array([0.0, 0.0, 5.0])
    radius = 1.5
    L = np.array([2.0, 1.0, 0.5])
    li = add_sphere_light(t, center, radius, L)
    lights = lights_to_device(t)

    p = np.zeros(3)
    n = np.array([0.0, 0.0, 1.0])  # facing the sphere
    est = _mc_irradiance(lights, li, p, n)

    sin2 = (radius / 5.0) ** 2
    want = L * np.pi * sin2
    np.testing.assert_allclose(est, want, rtol=2e-2)

    # distances must land on the sphere surface: |p + wi*dist - c| == r
    u = jax.random.uniform(jax.random.PRNGKey(1), (4096, 2))
    ls = sample_light(lights, jnp.full(4096, li, jnp.int32), jnp.zeros((4096, 3)), u)
    hit_pts = ls.wi * ls.dist[:, None]
    r_err = np.abs(np.linalg.norm(np.asarray(hit_pts) - center, axis=-1) - radius)
    assert r_err.max() < 1e-3


def test_mesh_light_matches_area_light():
    # rectangle [-1,1]^2 at z=3 facing -z
    t = _empty_table()
    quad = np.array(
        [
            [[-1, -1, 3], [1, -1, 3], [1, 1, 3]],
            [[-1, -1, 3], [1, 1, 3], [-1, 1, 3]],
        ],
        np.float32,
    )
    L = np.array([1.0, 2.0, 3.0])
    li_mesh = add_mesh_light(t, quad, L)

    from lens_flare.scene.build import _append_light_row

    li_area = _append_light_row(
        t,
        light_type=LT_AREA,
        radiance=L,
        position=np.array([0.0, 0.0, 3.0]),
        direction=np.array([0.0, 0.0, -1.0]),
        dim_x=np.array([2.0, 0.0, 0.0]),
        dim_y=np.array([0.0, 2.0, 0.0]),
        area=4.0,
        is_delta=False,
    )
    lights = lights_to_device(t)

    p = np.array([0.3, -0.2, 0.0])
    n = np.array([0.0, 0.0, 1.0])
    est_mesh = _mc_irradiance(lights, li_mesh, p, n, seed=2)
    est_area = _mc_irradiance(lights, li_area, p, n, seed=3)
    np.testing.assert_allclose(est_mesh, est_area, rtol=3e-2)

    # sampled points must lie on the rectangle plane, inside bounds
    u = jax.random.uniform(jax.random.PRNGKey(4), (4096, 2))
    ls = sample_light(
        lights, jnp.full(4096, li_mesh, jnp.int32), jnp.broadcast_to(jnp.asarray(p, jnp.float32), (4096, 3)), u
    )
    pts = np.asarray(jnp.asarray(p) + ls.wi * ls.dist[:, None])
    assert np.abs(pts[:, 2] - 3.0).max() < 1e-3
    assert pts[:, 0].min() > -1.001 and pts[:, 0].max() < 1.001
    assert pts[:, 1].min() > -1.001 and pts[:, 1].max() < 1.001


def test_sample_light_static_matches_dynamic_all_families():
    """sample_light_static (the NEE fast path with host-static row/type) is
    bit-identical to the generic gather-based sample_light for every family."""
    from lens_flare.integrator.lights import sample_light_static
    from lens_flare.scene.build import (
        LT_DIRECTIONAL,
        LT_HEMISPHERE,
        LT_POINT,
        LT_SPOT,
        _append_light_row,
    )

    t = _empty_table()
    rows = []
    rows.append((_append_light_row(
        t, light_type=LT_DIRECTIONAL, radiance=np.array([1.0, 2.0, 3.0]),
        position=np.zeros(3), direction=np.array([0.3, 0.8, -0.5]) / np.linalg.norm([0.3, 0.8, -0.5]),
        dim_x=np.zeros(3), dim_y=np.zeros(3), area=0.0, is_delta=True,
    ), LT_DIRECTIONAL))
    rows.append((_append_light_row(
        t, light_type=LT_POINT, radiance=np.array([4.0, 0.5, 1.0]),
        position=np.array([1.0, 2.0, -1.0]), direction=np.zeros(3),
        dim_x=np.zeros(3), dim_y=np.zeros(3), area=0.0, is_delta=True,
    ), LT_POINT))
    rows.append((_append_light_row(
        t, light_type=LT_AREA, radiance=np.array([2.0, 2.0, 2.0]),
        position=np.array([0.0, 3.0, 0.0]), direction=np.array([0.0, -1.0, 0.0]),
        dim_x=np.array([1.5, 0.0, 0.0]), dim_y=np.array([0.0, 0.0, 1.2]),
        area=1.8, is_delta=False,
    ), LT_AREA))
    rows.append((_append_light_row(
        t, light_type=LT_HEMISPHERE, radiance=np.array([0.7, 0.7, 0.9]),
        position=np.zeros(3), direction=np.zeros(3),
        dim_x=np.zeros(3), dim_y=np.zeros(3), area=0.0, is_delta=False,
    ), LT_HEMISPHERE))
    rows.append((_append_light_row(
        t, light_type=LT_SPOT, radiance=np.array([5.0, 4.0, 3.0]),
        position=np.array([0.0, 4.0, 0.0]), direction=np.array([0.0, -1.0, 0.0]),
        dim_x=np.array([0.8, 2.0, 0.0]), dim_y=np.zeros(3), area=0.0, is_delta=True,
    ), LT_SPOT))
    rows.append((add_sphere_light(t, np.array([0.0, 0.0, 6.0]), 1.0,
                                  np.array([1.0, 1.0, 1.0])), 6))  # LT_SPHERE
    rows.append((add_mesh_light(t, np.array(
        [[[-1, -1, 3], [1, -1, 3], [1, 1, 3]], [[-1, -1, 3], [1, 1, 3], [-1, 1, 3]]],
        np.float32), np.array([1.0, 2.0, 3.0])), 7))  # LT_MESH

    lights = lights_to_device(t)
    n = 257
    rng = np.random.default_rng(5)
    p = jnp.asarray(rng.uniform(-2, 2, (n, 3)), jnp.float32)
    u = jnp.asarray(rng.uniform(0, 1, (n, 2)), jnp.float32)

    for row, code in rows:
        dyn = sample_light(lights, jnp.full(n, row, jnp.int32), p, u)
        st = sample_light_static(lights, row, code, p, u)
        for f in dyn._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(dyn, f)), np.asarray(getattr(st, f)),
                err_msg=f"family {code} field {f}",
            )
