"""Fast (canonical-card scale_and_translate) ghost splat vs. exact rasterizer.

The fast path resamples bilinearly where the reference fetches nearest
texels, so agreement is at image level (energy + low-frequency structure),
not per pixel.  A ghost's total splatted energy is analytically
scale-invariant: intensity * quad area = (10/s^2) * (2s)^2 * mean(tex)
= 40 * mean(tex) per ghost — both paths must land on it.
"""

import jax.numpy as jnp
import numpy as np

from lens_flare.lens.ghosts import splat_ghosts, splat_ghosts_fast


def _box_down(img, f):
    h, w, c = img.shape
    return img[: h - h % f, : w - w % f].reshape(h // f, f, w // f, f, c).mean((1, 3))


def test_fast_ghosts_match_exact_energy_and_structure():
    rng = np.random.default_rng(0)
    tex_np = (rng.uniform(size=(64, 64)) > 0.3).astype(np.float32)
    tex = jnp.asarray(tex_np)
    # quads 44-56 px across: big enough that nearest-fetch discretization
    # noise in the exact path is small
    r1s = jnp.asarray([-80.0, 30.0, -40.0], jnp.float32)
    r2s = jnp.asarray([60.0, 140.0, 90.0], jnp.float32)
    colors = jnp.eye(3)
    axis = jnp.asarray([0.62, 0.55], jnp.float32)
    W, H = 512, 384

    exact = np.asarray(splat_ghosts(tex, r1s, r2s, colors, axis, W, H))
    fast = np.asarray(splat_ghosts_fast(tex, r1s, r2s, colors, axis, W, H))

    # analytic per-ghost energy: 40 * mean(tex) (quads fully on-screen)
    want = 40.0 * tex_np.mean()
    np.testing.assert_allclose(fast.sum((0, 1)), want, rtol=2e-2)
    np.testing.assert_allclose(exact.sum((0, 1)), want, rtol=6e-2)
    # low-frequency structure: 16x16 box-downsampled images close
    lo_e = _box_down(exact, 16)
    lo_f = _box_down(fast, 16)
    scale = max(lo_e.max(), 1e-6)
    assert np.abs(lo_e - lo_f).max() / scale < 0.15
