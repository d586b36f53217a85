"""Thin-lens/bokeh cameras, realistic lens stack, finite-difference gradients,
adaptive sampling, and the lens-design optimization loop."""

import numpy as np
import jax
import jax.numpy as jnp

from lens_flare.integrator.path import BokehMask
from lens_flare.lens.prescription import reference_prescription
from lens_flare.lens.realistic import (
    fresnel_dielectric,
    render_ghosts_stack,
    surface_z,
    trace_ghost_stack,
)
from lens_flare.scene.camera import (
    Camera,
    CameraParams,
    generate_rays,
    generate_rays_thin_lens,
)


def _cam():
    cam = Camera()
    cam.place(np.zeros(3), np.pi / 2, 0.0, 5.0, 0.1, 50.0)
    cam.lens_radius = 0.2
    cam.focal_distance = 5.0
    cam.h_fov = cam.v_fov = 60.0
    return cam.params()


def test_thin_lens_focuses_at_focal_plane():
    """All lens samples for one sensor point converge at the focal plane."""
    cam = _cam()
    n = 64
    x = jnp.full(n, 0.3)
    y = jnp.full(n, 0.7)
    rng = np.random.default_rng(0)
    o, d = generate_rays_thin_lens(
        cam, x, y, jnp.asarray(rng.uniform(size=n), jnp.float32), jnp.asarray(rng.uniform(size=n), jnp.float32)
    )
    o = np.asarray(o)
    d = np.asarray(d)
    # the pinhole ray hits the focal plane at p_focus
    o0, d0 = generate_rays(cam, x[:1], y[:1])
    # focal point: travel along the pinhole dir until camera-space z = -focalDistance
    # easier: all thin-lens rays must intersect in one point: solve pairwise
    t_star = []
    for i in range(1, 8):
        # find t minimizing distance between ray 0 and ray i
        w0 = o[0] - o[i]
        a = d[0] @ d[0]
        b = d[0] @ d[i]
        c = d[i] @ d[i]
        dd = d[0] @ w0
        e = d[i] @ w0
        denom = a * c - b * b
        t0 = (b * e - c * dd) / denom
        p = o[0] + t0 * d[0]
        t_star.append(p)
    t_star = np.asarray(t_star)
    assert np.max(np.std(t_star, axis=0)) < 1e-3  # single convergence point


def test_bokeh_mask_sampling_matches_mask():
    mask = np.zeros((16, 16), np.float32)
    mask[2:6, 10:14] = 1.0  # only one square region transparent
    bm = BokehMask.from_texture(mask)
    u = jax.random.uniform(jax.random.PRNGKey(0), (4096,))
    uv = np.asarray(bm.sample(u))
    # all sampled points inside the square (in [-0.5, .5] coords)
    assert (uv[:, 0] >= 10 / 16 - 0.5 - 1e-6).all() and (uv[:, 0] <= 14 / 16 - 0.5).all()
    assert (uv[:, 1] >= 2 / 16 - 0.5 - 1e-6).all() and (uv[:, 1] <= 6 / 16 - 0.5).all()


def test_fresnel_dielectric_limits():
    # normal incidence: R = ((n1-n2)/(n1+n2))^2
    r0 = float(fresnel_dielectric(jnp.asarray(1.0), 1.0, 1.5))
    np.testing.assert_allclose(r0, ((1 - 1.5) / (1 + 1.5)) ** 2, rtol=1e-6)
    # grazing: R -> 1
    rg = float(fresnel_dielectric(jnp.asarray(0.001), 1.0, 1.5))
    assert rg > 0.95
    # TIR from dense side
    rt = float(fresnel_dielectric(jnp.asarray(0.3), 1.5, 1.0))
    assert rt == 1.0


def test_lens_stack_axial_ray():
    """An on-axis ray through pair (0,1) stays on axis and keeps energy <= 1."""
    lens = reference_prescription()
    o = jnp.asarray([[0.0, 0.0, -1.0]])
    d = jnp.asarray([[0.0, 0.0, 1.0]])
    tr = trace_ghost_stack(lens, o, d, color=1, pair=(0, 1))
    xy = np.asarray(tr.xy[0])
    e = float(tr.energy[0])
    np.testing.assert_allclose(xy, 0.0, atol=1e-4)
    assert 0.0 < e < 0.05  # two Fresnel reflections ~ (4%)^2 with transmissions


def test_lens_stack_vignetting():
    """Rays far off-axis get clipped by the iris (energy 0)."""
    lens = reference_prescription()
    o = jnp.asarray([[30.0, 0.0, -1.0]])  # outside every element
    d = jnp.asarray([[0.0, 0.0, 1.0]])
    tr = trace_ghost_stack(lens, o, d, color=0, pair=(0, 1))
    assert float(tr.energy[0]) == 0.0


def test_render_ghosts_stack_produces_image():
    lens = reference_prescription()
    img = render_ghosts_stack(
        lens,
        jnp.float32(0.3),
        jnp.asarray([1.0, 0.9, 0.7]),
        jnp.asarray([0.6, 0.55]),
        64,
        64,
        pupil_samples=12,
    )
    img = np.asarray(img)
    assert img.shape == (64, 64, 3)
    assert np.isfinite(img).all()
    assert img.sum() > 0


def test_finite_difference_gradient_matches():
    """jax.grad == central finite differences through the optical chain
    (BASELINE north star).  Checked on the smooth paraxial trace in f64;
    the rasterizer's nearest-neighbor fetch is piecewise-constant so FD
    noise there is expected and not a gradient bug."""
    from lens_flare.lens.paraxial import trace_all_ghosts

    jax.config.update("jax_enable_x64", True)
    try:
        lens = reference_prescription(jnp.float64)

        def smooth_loss(lens):
            r1, r2 = trace_all_ghosts(lens, 0.4)
            return jnp.sum(jnp.tanh(r1 / 100.0) ** 2) + jnp.sum(jnp.tanh(r2 / 100.0) ** 2)

        g = jax.grad(smooth_loss)(lens)
        for field in ("spacings", "curvatures"):
            arr = np.asarray(getattr(lens, field))
            garr = np.asarray(getattr(g, field))
            for idx in range(0, len(arr), 3):
                eps = 1e-6 * max(abs(arr[idx]), 1.0)
                lp = lens.replace(**{field: jnp.asarray(arr).at[idx].add(eps)})
                lm = lens.replace(**{field: jnp.asarray(arr).at[idx].add(-eps)})
                fd = (float(smooth_loss(lp)) - float(smooth_loss(lm))) / (2 * eps)
                an = float(garr[idx])
                assert abs(fd - an) <= 1e-4 * max(abs(fd), abs(an), 1.0), (field, idx, fd, an)
    finally:
        jax.config.update("jax_enable_x64", False)


def test_optimize_lens_reduces_loss(tmp_path):
    from lens_flare.diff.optimize import OptimizeConfig, ghost_image, optimize_lens

    tex = jnp.ones((8, 8), jnp.float32) * 0.8
    axis = jnp.asarray([0.6, 0.55])
    angle = 0.35

    # target: ghosts of a perturbed lens
    target_lens = reference_prescription()
    target_lens = target_lens.replace(spacings=target_lens.spacings * 1.03)
    target = ghost_image(target_lens, tex, axis, angle, 48, 48)

    cfg = OptimizeConfig(steps=30, learning_rate=1e-4, log_every=0, checkpoint_dir=str(tmp_path / "ck"))
    lens, losses = optimize_lens(target, tex, axis, angle, cfg)
    assert losses[-1] < losses[0] * 0.2, losses[:3] + losses[-3:]

    # checkpoint resume: continuing from disk starts at the saved step
    cfg2 = OptimizeConfig(steps=35, learning_rate=1e-4, log_every=0, checkpoint_dir=str(tmp_path / "ck"))
    lens2, losses2 = optimize_lens(target, tex, axis, angle, cfg2)
    assert len(losses2) == 5  # only the remaining steps ran


def test_adaptive_sampling_stops_early(pyramid_scene):
    """Converged pixels stop sampling before ns_aa (pathtracer.cpp:862-868)."""
    from lens_flare.accel import build_bvh
    from lens_flare.integrator.lights import lights_to_device
    from lens_flare.integrator.path import SceneBundle, make_settings, render_wavefront
    from lens_flare.integrator.shading import bsdf_to_device
    from lens_flare.ops import scene_to_device
    from lens_flare.scene.camera import place_from_scene_info

    scene, info = pyramid_scene
    lo, hi = scene.primitive_bboxes()
    bundle = SceneBundle(
        scene=scene_to_device(scene, build_bvh(lo, hi)),
        bsdfs=bsdf_to_device(scene.bsdfs),
        lights=lights_to_device(scene.lights),
        env=None,
    )
    settings = make_settings(
        scene.lights,
        ns_aa=64,
        max_ray_depth=1,
        ns_area_light=1,
        indirect=False,
        samples_per_batch=8,
        max_tolerance=0.5,  # loose: delta-light pixels converge immediately
    )
    cam = Camera()
    cam.configure(info.camera, 16, 16)
    place_from_scene_info(cam, info, scene.bbox_min, scene.bbox_max)

    ys, xs = np.mgrid[0:16, 0:16]
    rad, cnt, _stats = jax.jit(
        lambda px, py: render_wavefront(
            bundle, settings, cam.params(), px, py, 16, 16, jax.random.PRNGKey(0)
        )
    )(jnp.asarray(xs.ravel()), jnp.asarray(ys.ravel()))
    cnt = np.asarray(cnt)
    assert cnt.min() >= 8  # at least one batch everywhere
    assert (cnt < 64).any()  # some pixels stopped early
    assert cnt.max() <= 64


def test_config3_realistic_ghosts_over_env_render(dae_dir):
    """BASELINE config 3: HDR-sky env render + physically-based Fresnel ghosts."""
    import numpy as np

    from lens_flare.renderer import Renderer

    env = np.full((8, 16, 3), 1.0, np.float32)
    env[2, 5] = [200.0, 180.0, 150.0]  # sun texel
    r = Renderer(width=48, height=48, ns_aa=2, max_ray_depth=1, indirect=False,
                 envmap=env, tile_pixels=2304)
    r.load(dae_dir / "sky" / "bunny_unlit.dae")
    hdr, _ = r.render(progress=False)

    ghosts = render_ghosts_stack(
        reference_prescription(),
        jnp.float32(0.25),
        jnp.asarray([1.0, 0.9, 0.8]),
        jnp.asarray([0.6, 0.55]),
        48,
        48,
        pupil_samples=8,
    )
    out = hdr + np.asarray(ghosts)
    assert np.isfinite(out).all()
    assert out.sum() > hdr.sum()  # ghosts added energy


def test_realistic_stack_fd_gradient():
    """jax.grad == central finite differences THROUGH the full realistic
    ghost render (trace + Fresnel + bilinear splat), per BASELINE config 3.

    f64 + a smooth spatial loss; the bilinear splat is piecewise-linear in
    ghost position so the gradient exists a.e. and FD matches closely.
    """
    jax.config.update("jax_enable_x64", True)
    try:
        lens = reference_prescription(jnp.float64)
        w = h = 32
        yy, xx = jnp.meshgrid(jnp.arange(h), jnp.arange(w), indexing="ij")
        window = jnp.exp(-(((xx - 14.0) ** 2 + (yy - 20.0) ** 2) / 120.0))
        # a before-aperture, a spanning, and an after-aperture pair keep the
        # grad graph (and its compile time) small while covering all event
        # shapes; the full 13-pair render is exercised by the other tests
        pairs = ((0, 1), (2, 4), (6, 8))

        def loss(lens):
            img = render_ghosts_stack(
                lens,
                jnp.float64(0.3),
                jnp.asarray([1.0, 0.9, 0.7]),
                jnp.asarray([0.6, 0.55]),
                w,
                h,
                pupil_samples=8,
                pairs=pairs,
            )
            return jnp.sum(img * window[:, :, None])

        g = jax.grad(loss)(lens)
        checked = 0
        for field in ("spacings", "curvatures"):
            arr = np.asarray(getattr(lens, field), np.float64)
            garr = np.asarray(getattr(g, field), np.float64)
            for idx in range(0, len(arr), 4):
                eps = 1e-6 * max(abs(arr[idx]), 1.0)
                lp = lens.replace(**{field: jnp.asarray(arr).at[idx].add(eps)})
                lm = lens.replace(**{field: jnp.asarray(arr).at[idx].add(-eps)})
                fd = (float(loss(lp)) - float(loss(lm))) / (2 * eps)
                an = float(garr[idx])
                assert abs(fd - an) <= 2e-3 * max(abs(fd), abs(an), 1e-3), (
                    field, idx, fd, an,
                )
                checked += 1
        assert checked >= 5
    finally:
        jax.config.update("jax_enable_x64", False)


def test_realistic_pipeline_composite(dae_dir):
    """--lens-model realistic end-to-end: the FlarePipeline dispatches to the
    sequential stack trace and adds ghost energy to the film."""
    from lens_flare.flare.pipeline import FlarePipeline
    from lens_flare.renderer import Renderer

    r = Renderer(width=48, height=48, ns_aa=1, max_ray_depth=1, indirect=False,
                 lens_model="realistic", tile_pixels=2304)
    r.load(dae_dir / "pyramid.dae")
    pipeline = FlarePipeline.from_renderer(r)
    assert pipeline is not None and pipeline.lens_model == "realistic"
    gb = np.asarray(pipeline.ghost_buffer())
    assert gb.shape == (48, 48, 3)
    assert np.isfinite(gb).all()
    assert gb.sum() > 0  # the sun is on screen in pyramid.dae
    hdr = np.zeros((48, 48, 3), np.float32)
    out = np.asarray(pipeline.composite(jnp.asarray(hdr)))
    assert (out >= hdr - 1e-6).all()  # flare is strictly additive


def test_batched_trace_matches_unrolled():
    """The event-table lax.scan trace == the per-pair unrolled trace."""
    from lens_flare.lens.realistic import (
        build_event_table,
        trace_ghosts_batched,
    )
    from lens_flare.lens.paraxial import reference_ghost_pairs

    lens = reference_prescription()
    rng = np.random.default_rng(0)
    n = 64
    o = jnp.asarray(
        np.stack(
            [rng.uniform(-14, 14, n), rng.uniform(-14, 14, n), np.full(n, -1.0)],
            axis=-1,
        ),
        jnp.float32,
    )
    d0 = np.array([np.sin(0.3), 0.0, np.cos(0.3)], np.float32)
    d = jnp.broadcast_to(jnp.asarray(d0), o.shape)

    pairs = reference_ghost_pairs()
    surf, kind, bwd = build_event_table(pairs, lens.num_interfaces, lens.aperture_index)
    surf = np.repeat(surf, 3, axis=0)
    kind = np.repeat(kind, 3, axis=0)
    bwd = np.repeat(bwd, 3, axis=0)
    colors = jnp.asarray(np.tile(np.arange(3), len(pairs)), jnp.int32)
    g = len(pairs) * 3
    tr = trace_ghosts_batched(
        lens,
        jnp.broadcast_to(o, (g,) + o.shape),
        jnp.broadcast_to(d, (g,) + d.shape),
        colors,
        jnp.asarray(surf),
        jnp.asarray(kind),
        jnp.asarray(bwd),
    )
    n_live = 0
    for gi, (pair, color) in enumerate(
        [(p, c) for p in pairs for c in range(3)]
    ):
        ref = trace_ghost_stack(lens, o, d, color, pair)
        np.testing.assert_allclose(
            np.asarray(tr.energy[gi]), np.asarray(ref.energy), rtol=2e-5, atol=1e-6,
            err_msg=f"pair={pair} color={color}",
        )
        # xy is only meaningful on unvignetted lanes (energy > 0); dead
        # lanes carry whatever garbage the masked math produced
        live = np.asarray(ref.energy) > 0
        n_live += int(live.sum())
        np.testing.assert_allclose(
            np.asarray(tr.xy[gi])[live], np.asarray(ref.xy)[live],
            rtol=1e-3, atol=1e-3, err_msg=f"pair={pair} color={color}",
        )
    assert n_live > 500  # the comparison actually covered live rays


def test_bokeh_sampling_jitters_within_texels():
    """Lens samples cover texel interiors, not just the texel grid (r1 w6)."""
    mask = np.zeros((8, 8), np.float32)
    mask[2, 3] = 1.0  # single live texel
    bm = BokehMask.from_texture(mask)
    u = jax.random.uniform(jax.random.PRNGKey(1), (512,))
    jit_u = jax.random.uniform(jax.random.PRNGKey(2), (512,))
    uv = np.asarray(bm.sample(u, jitter=jit_u))
    # all inside the one texel
    assert (uv[:, 0] >= 3 / 8 - 0.5).all() and (uv[:, 0] <= 4 / 8 - 0.5).all()
    assert (uv[:, 1] >= 2 / 8 - 0.5).all() and (uv[:, 1] <= 3 / 8 - 0.5).all()
    # and spread across its interior (not quantized to one point)
    assert len(np.unique(np.round(uv[:, 0], 4))) > 100
    assert len(np.unique(np.round(uv[:, 1], 4))) > 100
    assert uv[:, 0].std() > 0.01 and uv[:, 1].std() > 0.01


def test_realistic_linearizes_to_physical_paraxial():
    """The Snell+Fresnel stack's exact linearization == the physical 2x2 chain.

    The one non-circular cross-check between the two ghost models (VERDICT
    r3 item 4a): the autodiff jacobian of the realistic 3-D trace at
    (h, theta) = (0, 0) must equal the analytic first-order matrix product
    of lens/paraxial.py::physical_ghost_matrix for all 13 reference pairs
    x 3 wavelengths.
    """
    import jax

    from lens_flare.lens.paraxial import (
        physical_ghost_matrix,
        reference_ghost_pairs,
    )

    jax.config.update("jax_enable_x64", True)
    try:
        lens = reference_prescription(jnp.float64)

        def real_out(v, i, j, c):
            h, th = v[0], v[1]
            o = jnp.stack([h - jnp.tan(th), 0.0 * h, -1.0 + 0.0 * h])[None]
            d = jnp.stack([jnp.sin(th), 0.0 * th, jnp.cos(th)])[None]
            return trace_ghost_stack(lens, o, d, color=c, pair=(i, j)).xy[0, 0]

        for (i, j) in reference_ghost_pairs():
            for c in range(3):
                jac = jax.jacfwd(lambda v: real_out(v, i, j, c))(jnp.zeros(2))
                M = physical_ghost_matrix(lens, i, j, c)
                np.testing.assert_allclose(
                    np.asarray(jac), np.asarray(M[0]), rtol=1e-8, atol=1e-10,
                    err_msg=f"pair {(i, j)} color {c}",
                )
    finally:
        jax.config.update("jax_enable_x64", False)


def test_realistic_small_angle_convergence_order():
    """Finite-aperture error vs the linear model shrinks ~quadratically.

    real(h, theta) - (A h + B theta) is the aberration residual; halving
    (h, theta) must shrink it by ~4x (second/third-order aberrations) —
    confirms the realistic trace approaches its own paraxial limit at the
    expected rate rather than merely touching it at 0.
    """
    import jax

    from lens_flare.lens.paraxial import physical_ghost_matrix

    jax.config.update("jax_enable_x64", True)
    try:
        lens = reference_prescription(jnp.float64)

        def real_out(h, th, i, j, c):
            o = jnp.asarray([[h - np.tan(th), 0.0, -1.0]])
            d = jnp.asarray([[np.sin(th), 0.0, np.cos(th)]])
            return float(trace_ghost_stack(lens, o, d, color=c, pair=(i, j)).xy[0, 0])

        for (i, j) in [(1, 4), (2, 4), (6, 8)]:
            M = np.asarray(physical_ghost_matrix(lens, i, j, 0))
            errs = []
            for s in (1.0, 0.5, 0.25):
                h, th = 0.8 * s, 0.02 * s
                lin = M[0, 0] * h + M[0, 1] * th
                errs.append(abs(real_out(h, th, i, j, 0) - lin))
            assert errs[0] > errs[1] > errs[2] > 0, (i, j, errs)
            # order >= 2: each halving shrinks the residual by >= ~3.5x
            assert errs[0] / errs[1] > 3.5, (i, j, errs)
            assert errs[1] / errs[2] > 3.5, (i, j, errs)
    finally:
        jax.config.update("jax_enable_x64", False)


def test_reference_paraxial_quirk_documented():
    """trace_ghost (reference parity) == physical chain exactly when the
    backward segment crosses no curved surface, and differs otherwise.

    Documents the intentional divergence (inv(R) backward refraction has
    the wrong curvature sign; see physical_ghost_matrix docstring) so a
    future refactor can't silently conflate the two models.
    """
    import jax

    from lens_flare.lens.paraxial import (
        build_matrices,
        physical_ghost_matrix,
        trace_ghost,
    )

    jax.config.update("jax_enable_x64", True)
    try:
        lens = reference_prescription(jnp.float64)
        T, R, L = build_matrices(lens)

        def ref_linear(i, j, c):
            e = 1e-7
            rA = trace_ghost(lens, T, R[c], L, jnp.asarray(i), jnp.asarray(j),
                             jnp.float64(e), jnp.float64(0.0)).r_out
            rB = trace_ghost(lens, T, R[c], L, jnp.asarray(i), jnp.asarray(j),
                             jnp.float64(0.0), jnp.float64(e)).r_out
            return np.array([float(rA) / e, float(rB) / e])

        # adjacent pairs: empty backward segment -> exact agreement
        for (i, j) in [(0, 1), (1, 2), (3, 4), (6, 7), (7, 8)]:
            M = np.asarray(physical_ghost_matrix(lens, i, j, 0))
            np.testing.assert_allclose(ref_linear(i, j, 0), M[0], rtol=1e-5)

        # backward crossings through curved surfaces -> documented mismatch
        for (i, j) in [(1, 4), (2, 4), (6, 8)]:
            M = np.asarray(physical_ghost_matrix(lens, i, j, 0))
            assert not np.allclose(ref_linear(i, j, 0), M[0], rtol=1e-3), (i, j)
    finally:
        jax.config.update("jax_enable_x64", False)


def test_config5_optimizes_realistic_stack():
    """Lens-design optimization THROUGH the Snell+Fresnel stack (VERDICT r3 4b).

    A perturbed curvature is recovered by gradient descent on the rendered
    physically-based ghost buffer against a target image — BASELINE
    configs 3 + 5 combined: the optimization loop drives the realistic
    model, not just the paraxial one.
    """
    import jax
    import optax

    from lens_flare.lens.realistic import render_ghosts_stack

    W = H = 64
    pairs = ((0, 1), (2, 4), (6, 8))
    lens_true = reference_prescription()

    def img_of(lens):
        return render_ghosts_stack(
            lens, jnp.float32(0.3), jnp.ones(3), jnp.asarray([0.6, 0.55]),
            W, H, pupil_samples=12, pairs=pairs,
        )

    target = img_of(lens_true)
    c_true = float(lens_true.curvatures[7])
    lens0 = lens_true.replace(curvatures=lens_true.curvatures.at[7].multiply(1.25))

    def loss_fn(lens):
        return jnp.mean((img_of(lens) - target) ** 2) * 1e6

    opt = optax.adam(2e-4)
    state = opt.init(lens0)

    @jax.jit
    def step(lens, state):
        loss, g = jax.value_and_grad(loss_fn)(lens)
        mask = jnp.zeros_like(lens.curvatures).at[7].set(1.0)
        g = jax.tree_util.tree_map(jnp.zeros_like, g).replace(
            curvatures=g.curvatures * mask
        )
        up, state = opt.update(g, state, lens)
        return optax.apply_updates(lens, up), state, loss

    loss0 = float(loss_fn(lens0))
    lens, state, loss = lens0, state, None
    for _ in range(150):
        lens, state, loss = step(lens, state)

    c0 = float(lens0.curvatures[7])
    cf = float(lens.curvatures[7])
    assert float(loss) < 1e-3 * loss0, (float(loss), loss0)
    # the perturbed curvature walked back to within 5% of the perturbation
    assert abs(cf - c_true) < 0.05 * abs(c0 - c_true), (c_true, c0, cf)
