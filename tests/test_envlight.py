"""Environment light: CDF importance sampling + miss lookup properties."""

import numpy as np
import jax
import jax.numpy as jnp

from lens_flare.integrator import envlight


def _random_env(h=16, w=32, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 4.0, (h, w, 3)).astype(np.float32)


def test_constant_map_lookup():
    env = envlight.build_env(np.full((8, 16, 3), 2.5, np.float32))
    rng = np.random.default_rng(1)
    d = rng.normal(size=(64, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rad = np.asarray(envlight.sample_dir(env, jnp.asarray(d)))
    np.testing.assert_allclose(rad, 2.5, rtol=1e-5)


def test_direction_roundtrip():
    rng = np.random.default_rng(2)
    d = rng.normal(size=(128, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    theta, phi = envlight.dir_to_theta_phi(jnp.asarray(d, jnp.float32))
    back = np.asarray(envlight.theta_phi_to_dir(theta, phi))
    np.testing.assert_allclose(back, d, atol=1e-5)


def test_importance_sampling_distribution():
    """Sampled texel frequencies track the luminance*sin(theta) pdf."""
    env_map = _random_env(8, 16, seed=3)
    env = envlight.build_env(env_map)
    n = 200_000
    key = jax.random.PRNGKey(0)
    u = jax.random.uniform(key, (n, 2))
    s = envlight.sample_env(env, u)

    # recover texel ids from directions; sampled dirs sit exactly on texel
    # lower edges (xy_to_theta_phi), so round to kill f32 edge jitter
    theta, phi = envlight.dir_to_theta_phi(s.wi)
    y = np.clip(np.rint(np.asarray(theta) / np.pi * 8).astype(int), 0, 7)
    x = np.mod(np.rint(np.asarray(phi) / (2 * np.pi) * 16).astype(int), 16)
    counts = np.zeros((8, 16))
    np.add.at(counts, (y, x), 1)
    freq = counts / n

    pdf = np.asarray(env.pdf_map)
    # compare where pdf is non-negligible
    mask = pdf > pdf.mean() * 0.5
    np.testing.assert_allclose(freq[mask], pdf[mask], rtol=0.15)


def test_importance_sampling_unbiased_integral():
    """E[L / pdf] == integral of the map over the sphere (solid-angle measure)."""
    env_map = _random_env(16, 32, seed=4)
    env = envlight.build_env(env_map)
    n = 400_000
    u = jax.random.uniform(jax.random.PRNGKey(5), (n, 2))
    s = envlight.sample_env(env, u)
    est = np.asarray((s.radiance / s.pdf[:, None]).mean(axis=0))

    # reference integral: sum over texels of L * sin(theta) dtheta dphi
    h, w = env_map.shape[:2]
    theta = np.pi * (np.arange(h)) / h  # texel lower edge, matching xy_to_theta_phi
    dphi = 2 * np.pi / w
    dtheta = np.pi / h
    # pdf uses sin(pi (j+.5)/h); integral estimate with same weights
    weights = np.sin(np.pi * (np.arange(h) + 0.5) / h)[:, None]
    ref = (env_map * weights[..., None]).sum(axis=(0, 1)) * dtheta * dphi
    np.testing.assert_allclose(est, ref, rtol=0.05)
