"""BSDF evaluation/sampling tests: oracle matches, furnace tests, Snell checks."""

import numpy as np
import jax
import jax.numpy as jnp

from lens_flare.integrator import shading
from lens_flare.oracle import tracer as oracle
from lens_flare.scene.build import BSDFTable
from lens_flare.scene.collada import (
    BSDF_DIFFUSE,
    BSDF_GLASS,
    BSDF_MICROFACET,
    BSDF_MIRROR,
    BSDF_REFRACTION,
    MaterialInfo,
)


def _table():
    mats = [
        MaterialInfo(bsdf_type=BSDF_DIFFUSE, albedo=np.array([0.6, 0.5, 0.4])),
        MaterialInfo(bsdf_type=BSDF_MIRROR, reflectance=np.array([0.9, 0.8, 0.7])),
        MaterialInfo(
            bsdf_type=BSDF_MICROFACET,
            eta=np.array([0.2, 0.9, 1.4]),
            k=np.array([3.9, 2.5, 2.1]),
            alpha=0.3,
        ),
        MaterialInfo(
            bsdf_type=BSDF_REFRACTION, transmittance=np.array([1.0, 1.0, 1.0]), ior=1.45
        ),
        MaterialInfo(
            bsdf_type=BSDF_GLASS,
            transmittance=np.ones(3),
            reflectance=np.ones(3),
            ior=1.45,
        ),
    ]
    return shading.bsdf_to_device(BSDFTable.from_materials(mats))


def _sample(bsdfs, row, wo, n=20000, seed=0):
    key = jax.random.PRNGKey(seed)
    u = jax.random.uniform(key, (n, 3))
    b = jnp.full(n, row, jnp.int32)
    wo_b = jnp.broadcast_to(jnp.asarray(wo, jnp.float32), (n, 3))
    return shading.sample_f(bsdfs, b, wo_b, u)


def test_diffuse_furnace():
    """E[f cos / pdf] over cosine samples == albedo (white furnace)."""
    bsdfs = _table()
    s = _sample(bsdfs, 0, [0.1, 0.2, 0.97])
    cos = s.wi[:, 2]
    est = np.asarray((s.f * (cos / s.pdf)[:, None]).mean(axis=0))
    np.testing.assert_allclose(est, [0.6, 0.5, 0.4], rtol=2e-2)


def test_diffuse_pdf_is_cosine():
    bsdfs = _table()
    s = _sample(bsdfs, 0, [0.0, 0.0, 1.0])
    np.testing.assert_allclose(
        np.asarray(s.pdf), np.asarray(s.wi[:, 2]) / np.pi, rtol=1e-5
    )


def test_mirror_reflects():
    bsdfs = _table()
    wo = np.array([0.3, -0.2, 0.93])
    wo /= np.linalg.norm(wo)
    s = _sample(bsdfs, 1, wo, n=4)
    wi = np.asarray(s.wi[0])
    np.testing.assert_allclose(wi, [-wo[0], -wo[1], wo[2]], atol=1e-6)
    # f * cos / pdf == reflectance
    thru = np.asarray(s.f[0]) * wi[2] / float(s.pdf[0])
    np.testing.assert_allclose(thru, [0.9, 0.8, 0.7], rtol=1e-5)


def test_refraction_snell():
    bsdfs = _table()
    wo = np.array([0.5, 0.0, np.sqrt(1 - 0.25)])
    s = _sample(bsdfs, 3, wo, n=4)
    wi = np.asarray(s.wi[0])
    # Snell: sin_t = sin_i / ior (entering)
    sin_i = np.hypot(wo[0], wo[1])
    sin_t = np.hypot(wi[0], wi[1])
    np.testing.assert_allclose(sin_t, sin_i / 1.45, rtol=1e-5)
    assert wi[2] < 0  # transmitted through


def test_refraction_total_internal_reflection():
    bsdfs = _table()
    # from inside (wo.z < 0) at a grazing angle beyond critical
    wo = np.array([0.9, 0.0, -np.sqrt(1 - 0.81)])
    s = _sample(bsdfs, 3, wo, n=4)
    assert not bool(s.valid[0])


def test_glass_energy():
    """Glass branches: reflection throughput == reflectance; refraction
    throughput == transmittance / eta^2 (radiance compression entering the
    denser medium — cancelled on exit)."""
    bsdfs = _table()
    s = _sample(bsdfs, 4, [0.3, 0.1, 0.95], n=20000)
    cos = jnp.abs(s.wi[:, 2])
    thru = np.asarray(s.f * (cos / s.pdf)[:, None])
    reflected = np.asarray(s.wi[:, 2] > 0)
    np.testing.assert_allclose(thru[reflected], 1.0, rtol=1e-4)
    np.testing.assert_allclose(thru[~reflected], 1.45 ** 2, rtol=1e-3)


def test_microfacet_matches_oracle():
    bsdfs = _table()
    host = BSDFTable.from_materials(
        [
            MaterialInfo(
                bsdf_type=BSDF_MICROFACET,
                eta=np.array([0.2, 0.9, 1.4]),
                k=np.array([3.9, 2.5, 2.1]),
                alpha=0.3,
            )
        ]
    )
    rng = np.random.default_rng(1)
    for _ in range(20):
        wi = rng.normal(size=3)
        wi[2] = abs(wi[2])
        wi /= np.linalg.norm(wi)
        wo = rng.normal(size=3)
        wo[2] = abs(wo[2])
        wo /= np.linalg.norm(wo)
        want = oracle.microfacet_f(host, 0, -wi, wo)  # oracle flips wi internally
        got = np.asarray(
            shading.eval_f(
                bsdfs,
                jnp.asarray([2]),
                -jnp.asarray(wi, jnp.float32)[None],
                jnp.asarray(wo, jnp.float32)[None],
            )[0]
        )
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-5)


def test_microfacet_importance_consistency():
    """Beckmann importance sampling: E[f cos / pdf] finite and stable."""
    bsdfs = _table()
    s = _sample(bsdfs, 2, [0.2, 0.1, 0.97], n=40000)
    ok = np.asarray(s.valid)
    cos = np.asarray(s.wi[:, 2])
    f = np.asarray(s.f)
    pdf = np.asarray(s.pdf)
    est = (f[ok] * (cos[ok] / pdf[ok])[:, None]).mean(axis=0)
    assert np.isfinite(est).all()
    # conductor albedo bounded by 1 per channel
    assert np.all(est < 1.2)


def test_make_coord_space_orthonormal():
    rng = np.random.default_rng(2)
    n = rng.normal(size=(64, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    o2w = np.asarray(shading.make_coord_space(jnp.asarray(n)))
    for i in range(64):
        np.testing.assert_allclose(o2w[i].T @ o2w[i], np.eye(3), atol=1e-5)
        np.testing.assert_allclose(o2w[i][:, 2], n[i], atol=1e-6)
        # matches the oracle frame exactly
        np.testing.assert_allclose(o2w[i], oracle.make_coord_space(n[i]), atol=1e-5)


def test_spot_light_cone_falloff():
    """Spot lights (stub in the reference) have smooth cone falloff."""
    import jax.numpy as jnp

    from lens_flare.integrator.lights import LightArrays, sample_light
    from lens_flare.scene.build import LT_SPOT

    lights = LightArrays(
        light_type=jnp.asarray([LT_SPOT]),
        radiance=jnp.asarray([[10.0, 10.0, 10.0]]),
        position=jnp.asarray([[0.0, 0.0, 5.0]]),
        direction=jnp.asarray([[0.0, 0.0, -1.0]]),  # pointing down
        dim_x=jnp.asarray([[np.cos(np.radians(30.0)), 1.0, 0.0]]),
        dim_y=jnp.zeros((1, 3)),
        area=jnp.zeros(1),
        is_delta=jnp.asarray([True]),
    )
    li = jnp.zeros(3, jnp.int32)
    # directly below -> full radiance; ~17 deg off-axis -> attenuated; far out -> 0
    p = jnp.asarray([[0.0, 0.0, 0.0], [1.5, 0.0, 0.0], [50.0, 0.0, 0.0]])
    s = sample_light(lights, li, p, jnp.zeros((3, 2)))
    rad = np.asarray(s.radiance)
    assert np.allclose(rad[0], 10.0, rtol=1e-5)  # on-axis
    assert 0 < rad[1][0] < 10.0  # inside cone edge region or partly off
    assert np.allclose(rad[2], 0.0, atol=1e-5)  # far outside the cone
