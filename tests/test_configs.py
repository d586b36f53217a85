"""BASELINE config-level end-to-end tests (VERDICT r1 missing #4).

One test per BASELINE configuration, driven through the public Renderer /
FlarePipeline APIs exactly as a user would:

- config 1: pyramid direct+indirect — deterministic snapshot regression
- config 2: thin-lens + bokeh DoF — focal-plane sharpness vs defocus blur
- config 4: 1080p flare composite — wall-time budget + additivity
- north star: finite-difference pixel gradients through the FULL flare
  composite (ghosts + FFT starburst), not just the paraxial subchain
"""

import time

import numpy as np
import jax
import jax.numpy as jnp

from lens_flare.renderer import Renderer

APERTURE = "/root/reference/final_apertures/pent4_13.png"
GHOST_AP = "/root/reference/apertures/pentsmall.png"
BOKEH = "/root/reference/bokeh/octagonbokeh.png"


def test_config1_pyramid_deterministic_snapshot(dae_dir):
    """config 1: direct+indirect pyramid render, fixed key -> fixed image.

    128^2 @ 16 spp depth 4 (256^2 runs 4x longer for the same regression
    power on the CPU CI mesh).  The values below are the recorded output of
    the deterministic threefry tape; any integrator/sampling change that
    shifts them must be intentional.
    """
    r = Renderer(width=128, height=128, ns_aa=16, max_ray_depth=4, indirect=True, seed=0)
    r.load(dae_dir / "pyramid.dae")
    hdr, cnt = r.render(progress=False)

    np.testing.assert_allclose(
        hdr.mean(axis=(0, 1)), [0.06908412, 0.05755194, 0.04151426], rtol=2e-3
    )
    np.testing.assert_allclose(hdr.std(), 0.13403288, rtol=5e-3)
    np.testing.assert_allclose(
        hdr[64, 64], [0.24742752, 0.1249606, 0.03479141], rtol=5e-3
    )
    np.testing.assert_allclose(
        hdr[96, 96], [0.01010489, 0.00925073, 0.00724509], rtol=5e-3
    )
    assert int(cnt.sum()) == 128 * 128 * 16
    # counters are measured: ~13 rays per camera sample on this scene
    # traced rays exclude NEE lanes whose contribution is provably zero
    # (miss/delta/emitter shading points — skipped since round 3 and counted
    # separately); traced + skipped is the full estimator workload
    assert 300_000 < r.stats.total_rays < 900_000
    workload = r.stats.total_rays + r.stats.total_zero_skipped
    assert 2_500_000 < workload < 5_000_000


def _dof_scene():
    """Small emissive quad at y=0 on black, camera above at y=2 (Y-up)."""
    from lens_flare.scene.build import BSDFTable, FlatScene, LightTable
    from lens_flare.scene.collada import BSDF_EMISSION, MaterialInfo

    s = 0.15
    q = np.array(
        [[[-s, 0, -s], [s, 0, -s], [s, 0, s]], [[-s, 0, -s], [s, 0, s], [-s, 0, s]]],
        np.float32,
    )
    n = np.tile(np.array([0, 1, 0], np.float32), (2, 3, 1))
    scene = FlatScene(
        tri_p=q,
        tri_n=n,
        tri_bsdf=np.zeros(2, np.int32),
        sph_center=np.zeros((0, 3), np.float32),
        sph_radius=np.zeros(0, np.float32),
        sph_bsdf=np.zeros(0, np.int32),
        bsdfs=BSDFTable.from_materials(
            [MaterialInfo(bsdf_type=BSDF_EMISSION, radiance=np.array([8.0, 8.0, 8.0]))]
        ),
        lights=LightTable(
            light_type=np.zeros(0, np.int32),
            radiance=np.zeros((0, 3), np.float32),
            position=np.zeros((0, 3), np.float32),
            direction=np.zeros((0, 3), np.float32),
            dim_x=np.zeros((0, 3), np.float32),
            dim_y=np.zeros((0, 3), np.float32),
            area=np.zeros(0, np.float32),
            is_delta=np.zeros(0, bool),
        ),
    )
    lo, hi = scene.primitive_bboxes()
    scene.bbox_min = lo.min(axis=0).astype(np.float64)
    scene.bbox_max = hi.max(axis=0).astype(np.float64)
    return scene


def _render_dof(scene, focal_distance):
    from lens_flare.scene.camera import Camera

    cam = Camera()
    cam.place(np.zeros(3), 0.0, 0.0, 2.0, 0.1, 50.0)  # camera at (0, 2, 0)
    cam.h_fov = cam.v_fov = 30.0
    cam.screen_w = cam.screen_h = 32
    r = Renderer(
        width=32, height=32, ns_aa=32, max_ray_depth=1, indirect=False,
        lens_radius=0.15, focal_distance=focal_distance, bokeh_path=BOKEH,
        tile_pixels=32 * 32 * 32,
    )
    r.load_flat_scene(scene, camera=cam)
    hdr, _ = r.render(progress=False)
    return hdr


def test_config2_thin_lens_bokeh_dof():
    """config 2: focusing at the emitter's depth gives a sharp image; focusing
    far in front of it smears the emitter into a (bokeh-shaped) disc."""
    scene = _dof_scene()
    sharp = _render_dof(scene, focal_distance=2.0)  # emitter depth
    blur = _render_dof(scene, focal_distance=0.7)  # far in front

    sharp_l = sharp.max(axis=-1)
    blur_l = blur.max(axis=-1)
    # total energy is comparable (defocus redistributes, doesn't create)
    assert 0.4 < blur_l.sum() / sharp_l.sum() < 2.2
    # peak concentration: in focus the emitter keeps its full radiance (8.0);
    # defocus dilutes the peak (measured 4.75 at focal 0.7)
    assert sharp_l.max() > 1.3 * blur_l.max()
    # spatial support: defocus spreads the emitter over more pixels
    thr = 0.05 * sharp_l.max()
    assert (blur_l > thr).sum() > 1.5 * (sharp_l > thr).sum()


def test_config4_flare_composite_1080p_budget(dae_dir):
    """config 4: full 1080p ghost+starburst+falloff composite within budget.

    The CPU CI budget is deliberately loose; it exists to catch accidental eager dispatch or O(W*H*A^2)
    regressions (the reference's per-pixel DFT would take hours here,
    pathtracer.cpp:947-1041).
    """
    from lens_flare.flare.pipeline import FlarePipeline

    r = Renderer(
        width=1920, height=1080, ns_aa=1, max_ray_depth=1, indirect=False,
        aperture_path=APERTURE, ghost_aperture_path=GHOST_AP,
        flare_intensity=1.5, flare_radius=0.3,
    )
    r.load(dae_dir / "pyramid.dae")
    pipe = FlarePipeline.from_renderer(r)
    assert pipe is not None
    hdr = jnp.zeros((1080, 1920, 3))
    # compiled-cost budget: host-independent guard against complexity
    # regressions.  Measured 8.45 GFLOP / 3.07 GB on this config; the
    # reference's per-pixel DFT formulation is ~6e12 multiplies
    # (pathtracer.cpp:947-1041), 3 orders of magnitude over budget — a
    # wall-clock bound alone would need a 10x regression to trip on a
    # fast host.
    ca = jax.jit(pipe.composite).lower(hdr).compile().cost_analysis()
    ca = ca[0] if isinstance(ca, list) else ca
    assert ca.get("flops", 0.0) < 5e10, f"composite FLOPs blew up: {ca.get('flops'):.3g}"
    assert ca.get("bytes accessed", 0.0) < 2e10
    out = np.asarray(pipe.composite(hdr))  # compile
    t0 = time.perf_counter()
    out = np.asarray(pipe.composite(hdr))
    dt = time.perf_counter() - t0
    assert dt < 60.0, f"1080p composite took {dt:.1f}s"
    assert out.shape == (1080, 1920, 3)
    assert np.isfinite(out).all()
    assert (out >= 0).all()  # flare is strictly additive over a black film
    assert out.sum() > 100.0  # ghosts + starburst + falloff all landed


def test_northstar_fd_gradient_through_full_composite():
    """Pixel gradients through ghosts + FFT starburst == finite differences.

    The BASELINE north star demands grad `allclose` through the COMPOSITE,
    not just the paraxial subchain: here loss = windowed sum of
    (smooth ghost splat + starburst field), differentiated w.r.t. a lens
    curvature, a lens spacing, AND two aperture-mask texels (the starburst
    input), all checked against central differences in f64.
    """
    from lens_flare.diff.optimize import ghost_image
    from lens_flare.flare.starburst import aperture_fft, starburst_field
    from lens_flare.lens.prescription import reference_prescription

    jax.config.update("jax_enable_x64", True)
    try:
        w = h = 48
        lens0 = reference_prescription(jnp.float64)
        tex0 = jnp.asarray(
            np.clip(np.random.default_rng(0).uniform(0.2, 1.0, (12, 12)), 0, 1)
        )
        ap0 = jnp.asarray(
            0.3 + 0.6 * np.random.default_rng(1).uniform(size=(16, 16))
        )
        axis = jnp.asarray([0.6, 0.55])
        yy, xx = jnp.meshgrid(jnp.arange(h), jnp.arange(w), indexing="ij")
        window = jnp.exp(-(((xx - 26.0) ** 2 + (yy - 30.0) ** 2) / 300.0))

        def loss(lens, ap):
            ghosts = ghost_image(lens, tex0, axis, 0.35, w, h)
            fft_mag = aperture_fft(ap)
            sb = starburst_field(
                fft_mag, jnp.sum(ap), ap0.shape[1], axis,
                jnp.asarray([1.0, 0.9, 0.8]), w, h,
                flare_intensity=1.0, flare_radius=0.3,
            )
            return jnp.sum((ghosts + sb) * window[:, :, None])

        g_lens, g_ap = jax.grad(loss, argnums=(0, 1))(lens0, ap0)

        checks = []
        for field, idx in (("curvatures", 0), ("curvatures", 7), ("spacings", 2)):
            arr = np.asarray(getattr(lens0, field), np.float64)
            eps = 1e-6 * max(abs(arr[idx]), 1.0)
            lp = lens0.replace(**{field: jnp.asarray(arr).at[idx].add(eps)})
            lm = lens0.replace(**{field: jnp.asarray(arr).at[idx].add(-eps)})
            fd = (float(loss(lp, ap0)) - float(loss(lm, ap0))) / (2 * eps)
            an = float(np.asarray(getattr(g_lens, field))[idx])
            checks.append((f"lens.{field}[{idx}]", fd, an))
        for (i, j) in ((3, 5), (10, 2)):
            eps = 1e-6
            fp = float(loss(lens0, ap0.at[i, j].add(eps)))
            fm = float(loss(lens0, ap0.at[i, j].add(-eps)))
            fd = (fp - fm) / (2 * eps)
            an = float(g_ap[i, j])
            checks.append((f"aperture[{i},{j}]", fd, an))

        for name, fd, an in checks:
            assert abs(fd - an) <= 2e-3 * max(abs(fd), abs(an), 1e-3), (name, fd, an)
    finally:
        jax.config.update("jax_enable_x64", False)
