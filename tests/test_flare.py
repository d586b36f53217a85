"""Flare pipeline vs. brute-force oracles: FFT==DFT, ghosts, paraxial traces."""

import numpy as np
import pytest

jnp = pytest.importorskip("jax.numpy")
import jax

from lens_flare.flare.starburst import aperture_fft, starburst_field
from lens_flare.lens.aperture import ApertureTexture
from lens_flare.lens.ghosts import splat_ghosts
from lens_flare.lens.paraxial import reference_ghost_pairs, trace_all_ghosts
from lens_flare.lens.prescription import reference_prescription
from lens_flare.oracle import flare as oracle


def _toy_aperture(n=12, seed=0):
    rng = np.random.default_rng(seed)
    a = np.zeros((n, n), np.float32)
    a[2 : n - 3, 3 : n - 2] = rng.uniform(0.1, 1.0, (n - 5, n - 5)).astype(np.float32)
    a[a < 0.3] = 0.0
    return a


@pytest.mark.parametrize(
    "n_ap,W,H",
    [
        (12, 16, 16),  # all even (the round-3 fast path)
        (11, 15, 13),  # all odd: convertCoordinate's real length/2.0 branch
        (12, 17, 16),  # odd width only
        (11, 16, 15),  # odd height, odd aperture
    ],
)
def test_starburst_fft_matches_bruteforce_dft(n_ap, W, H):
    """The FFT formulation == the reference's per-pixel DFT, exhaustively."""
    ap = _toy_aperture(n_ap)
    tex = ApertureTexture.from_array(ap)
    fo = (0.42, 0.61)
    radiances = [np.array([2.0, 1.0, 0.5])]

    fft_mag = aperture_fft(jnp.asarray(ap))
    got = np.asarray(
        starburst_field(
            fft_mag,
            jnp.float32(tex.total_value),
            tex.width,
            jnp.asarray(fo),
            jnp.asarray(radiances[0]),
            W,
            H,
            flare_intensity=0.0,
            flare_radius=3.0,
        )
    )

    bbox = (tex.min_x, tex.min_y, tex.max_x, tex.max_y)
    for y in range(H):
        for x in range(W):
            want = oracle.starburst_pixel(
                ap.astype(np.float64),
                tex.total_value,
                bbox,
                x,
                y,
                W,
                H,
                fo,
                radiances,
                flare_intensity=0.0,
                flare_radius=3.0,
            )
            np.testing.assert_allclose(got[y, x], want, rtol=2e-3, atol=1e-6), (x, y)


def test_paraxial_traces_match_reference_math():
    """Vectorized masked matrix chains == the two C++ trace functions (f64)."""
    jax.config.update("jax_enable_x64", True)
    try:
        lens = reference_prescription(jnp.float64)
        ref = oracle.RefLens()
        theta = 0.37
        r1, r2 = trace_all_ghosts(lens, theta)
    finally:
        jax.config.update("jax_enable_x64", False)
    r1 = np.asarray(r1)
    r2 = np.asarray(r2)
    pairs = reference_ghost_pairs()
    colors = ["red", "green", "blue"]
    for p, (i, j) in enumerate(pairs):
        before = j <= 4
        for c, cname in enumerate(colors):
            if before:
                want1 = oracle.trace_ray_before(ref, 14.5, theta, i, j, cname)[0]
                want2 = oracle.trace_ray_before(ref, -14.5, theta, i, j, cname)[0]
            else:
                want1 = oracle.trace_ray_after(ref, 14.5, theta, i, j, cname)[0]
                want2 = oracle.trace_ray_after(ref, -14.5, theta, i, j, cname)[0]
            np.testing.assert_allclose(r1[p, c], want1, rtol=1e-6), (i, j, cname)
            np.testing.assert_allclose(r2[p, c], want2, rtol=1e-6), (i, j, cname)


def test_ghost_splat_matches_rasterizer_oracle():
    """Batched quad splatting == the scanline rasterizer, pixel for pixel."""
    tex = _toy_aperture(10, seed=3)
    W, H = 48, 40
    axis = np.array([0.6, 0.55])
    cases = [(-20.0, -35.0, "red"), (10.0, 28.0, "green"), (-5.0, 12.0, "blue")]

    buf_ref = np.zeros((H, W, 3), np.float64)
    for r1, r2, cname in cases:
        oracle.draw_ghost(tex.astype(np.float64), buf_ref, cname, r1, r2, axis)

    onehot = {"red": [1, 0, 0], "green": [0, 1, 0], "blue": [0, 0, 1]}
    got = np.asarray(
        splat_ghosts(
            jnp.asarray(tex),
            jnp.asarray([c[0] for c in cases], jnp.float32),
            jnp.asarray([c[1] for c in cases], jnp.float32),
            jnp.asarray([onehot[c[2]] for c in cases], jnp.float32),
            jnp.asarray(axis, jnp.float32),
            W,
            H,
        )
    )
    np.testing.assert_allclose(got, buf_ref, rtol=2e-3, atol=1e-3)


def test_prescription_is_differentiable():
    """Pixel gradients flow to lens curvatures/spacings/IORs (BASELINE config 5)."""
    lens = reference_prescription(jnp.float32)

    def loss(lens):
        r1, r2 = trace_all_ghosts(lens, 0.3)
        return jnp.sum(r1 ** 2) + jnp.sum((r2 - 1.0) ** 2)

    g = jax.grad(loss)(lens)
    assert np.isfinite(np.asarray(g.curvatures)).all()
    assert np.isfinite(np.asarray(g.spacings)).all()
    assert np.isfinite(np.asarray(g.iors)).all()
    assert np.abs(np.asarray(g.curvatures)).sum() > 0
    assert np.abs(np.asarray(g.spacings)).sum() > 0


def test_find_sun_on_vertical_axis():
    """A sun projecting to ns_x == 0 must give angle pi/2, not raise.

    The reference computes atan(ns_y/ns_x) (pathtracer.cpp:50); C++ yields
    atan(+inf) = pi/2 for ns_x == 0 where Python's ``/`` raises — the atan2
    form reproduces the C++ values on the whole [0,1]^2 domain.
    """
    import math

    from lens_flare.flare.pipeline import find_sun
    from lens_flare.scene.build import LT_DIRECTIONAL, LightTable

    class FakeCamera:
        def __init__(self, ns):
            self.ns = ns

        def analyze_world_coord(self, p):
            return self.ns

    def table():
        return LightTable(
            light_type=np.array([LT_DIRECTIONAL], np.int32),
            radiance=np.ones((1, 3), np.float32),
            position=np.zeros((1, 3), np.float32),
            direction=np.zeros((1, 3), np.float32),
            dim_x=np.zeros((1, 3), np.float32),
            dim_y=np.zeros((1, 3), np.float32),
            area=np.zeros(1, np.float32),
            is_delta=np.array([True]),
        )

    _, _, axis, angle = find_sun(table(), FakeCamera((0.0, 0.7)))
    assert angle == pytest.approx(math.pi / 2)
    np.testing.assert_allclose(axis, [0.0, 0.7])

    # in-domain values still match atan(y/x)
    _, _, _, angle = find_sun(table(), FakeCamera((0.5, 0.25)))
    assert angle == pytest.approx(math.atan(0.25 / 0.5))


def test_multi_sun_starburst_and_falloff_semantics():
    """Two-sun semantics parity with raytrace_starburst (pathtracer.cpp:947-1063).

    The reference computes ONE starburst pattern phase-centered on
    flare_origins[0] (compute_phase(0, ...), pathtracer.cpp:968/918) and
    multiplies it by EVERY sun's radiance (the per-light loop at 996-1000)
    — a documented quirk, not per-sun patterns.  The falloff glow, by
    contrast, IS per-sun (per-light origins at 1052-1056).  The pipeline
    must reproduce both behaviors exactly.
    """
    from lens_flare.flare.pipeline import FlarePipeline

    ap = ApertureTexture.from_array(_toy_aperture(16))
    o2 = np.array([[0.3, 0.6], [0.7, 0.2]], np.float32)
    r2 = np.array([[2.0, 1.0, 0.5], [0.5, 3.0, 1.0]], np.float32)

    def pipe(origins, radiances):
        return FlarePipeline(
            width=24, height=20,
            flare_origins=np.asarray(origins, np.float32).reshape(-1, 2),
            flare_radiances=np.asarray(radiances, np.float32).reshape(-1, 3),
            axis_ray=np.asarray(origins, np.float32).reshape(-1, 2)[0],
            angle_to_sun=0.5,
            aperture=ap,
            flare_intensity=1.0,
            flare_radius=3.0,
        )

    both = pipe(o2, r2)
    # starburst: pattern of sun 0 x (r0 + r1) — NOT sum of per-sun patterns
    sb_both = np.asarray(both.starburst())
    sb_sum_rad = np.asarray(pipe(o2[:1], (r2[0] + r2[1])[None]).starburst())
    np.testing.assert_allclose(sb_both, sb_sum_rad, rtol=1e-6, atol=1e-7)
    sb_per_sun = (
        np.asarray(pipe(o2[:1], r2[:1]).starburst())
        + np.asarray(pipe(o2[1:], r2[1:]).starburst())
    )
    assert np.abs(sb_both - sb_per_sun).max() > 1e-4  # distinct semantics

    # falloff: per-sun origins, additive (shared jitter key, like the shared
    # gridSampler sample inside one pixel's loop)
    f_both = np.asarray(both.falloff())
    f_split = (
        np.asarray(pipe(o2[:1], r2[:1]).falloff())
        + np.asarray(pipe(o2[1:], r2[1:]).falloff())
    )
    np.testing.assert_allclose(f_both, f_split, rtol=1e-5, atol=1e-6)
