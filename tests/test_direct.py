"""Direct-lighting estimator vs. the NumPy oracle (deterministic for delta lights)."""

import numpy as np
import jax
import jax.numpy as jnp

from lens_flare.accel import build_bvh
from lens_flare.integrator.lights import lights_to_device
from lens_flare.integrator.path import SceneBundle, direct_lighting, make_settings
from lens_flare.integrator.shading import bsdf_to_device
from lens_flare.ops import intersect_rays, scene_to_device
from lens_flare.oracle import tracer as oracle
from lens_flare.scene.camera import Camera, place_from_scene_info


def test_direct_lighting_matches_oracle(pyramid_scene):
    scene, info = pyramid_scene
    # pyramid has only delta lights (2 point + 1 directional) -> deterministic
    assert scene.lights.is_delta.all()

    lo, hi = scene.primitive_bboxes()
    bvh = build_bvh(lo, hi)
    bundle = SceneBundle(
        scene=scene_to_device(scene, bvh),
        bsdfs=bsdf_to_device(scene.bsdfs),
        lights=lights_to_device(scene.lights),
        env=None,
    )
    settings = make_settings(scene.lights, ns_aa=1, max_ray_depth=1, ns_area_light=1)

    cam = Camera()
    cam.configure(info.camera, 64, 64)
    place_from_scene_info(cam, info, scene.bbox_min, scene.bbox_max)

    rng = np.random.default_rng(7)
    n = 48
    xs = rng.uniform(0.1, 0.9, n)
    ys = rng.uniform(0.1, 0.9, n)
    origins = np.zeros((n, 3), np.float32)
    dirs = np.zeros((n, 3), np.float32)
    for i in range(n):
        o, d = oracle.generate_ray(cam, xs[i], ys[i])
        origins[i] = o
        dirs[i] = d

    hit = intersect_rays(
        bundle.scene,
        jnp.asarray(origins),
        jnp.asarray(dirs),
        jnp.full(n, cam.n_clip, jnp.float32),
        jnp.full(n, cam.f_clip, jnp.float32),
    )

    hit_p = origins + dirs * np.asarray(hit.t)[:, None]
    keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
        jax.random.PRNGKey(0), jnp.arange(n, dtype=jnp.uint32)
    )
    s = settings.total_light_samples
    u_tape = jax.vmap(lambda k: jax.random.uniform(k, (2 * s,)))(keys)
    L = jax.jit(
        lambda hp, n, wo, b: direct_lighting(bundle, settings, u_tape, hp, n, wo, b)[0]
    )(jnp.asarray(hit_p), hit.n, -jnp.asarray(dirs), hit.bsdf)
    L = np.asarray(L)

    checked = 0
    for i in range(n):
        ref_isect = oracle.intersect_brute(
            scene, origins[i].astype(np.float64), dirs[i].astype(np.float64), cam.n_clip, cam.f_clip
        )
        if ref_isect is None:
            continue
        want = oracle.direct_lighting(
            scene,
            scene.bsdfs,
            origins[i].astype(np.float64),
            dirs[i].astype(np.float64),
            ref_isect,
            ns_area_light=1,
            light_uniforms={},
        )
        np.testing.assert_allclose(L[i], want, rtol=2e-2, atol=2e-3), i
        checked += 1
    assert checked >= 15


def test_make_settings_rejects_stale_specialization(pyramid_scene):
    """A caller-passed light_types/bsdf_families that doesn't cover the
    table's codes must fail loudly instead of silently dropping families."""
    import pytest

    scene, _ = pyramid_scene
    # stale tuple missing the scene's light codes
    with pytest.raises(ValueError, match="light codes"):
        make_settings(scene.lights, light_types=(99,))
    with pytest.raises(ValueError, match="BSDF codes"):
        make_settings(scene.lights, bsdf_table=scene.bsdfs, bsdf_families=(99,))


def test_shadow_ray_rr_unbiased(dae_dir):
    """Contribution-based shadow-ray RR (nee_rr_tau) is unbiased.

    Delta-light NEE lanes are traced with probability p ~ contribution and
    weighted 1/p; the high-spp mean must match the RR-off estimator within
    Monte-Carlo noise, while tracing measurably fewer shadow rays.
    """
    import jax

    from lens_flare.accel import build_bvh
    from lens_flare.integrator.lights import lights_to_device
    from lens_flare.integrator.path import (
        SceneBundle,
        make_settings,
        render_wavefront,
    )
    from lens_flare.integrator.shading import bsdf_to_device
    from lens_flare.ops import scene_to_device
    from lens_flare.scene.build import load_scene
    from lens_flare.scene.camera import Camera, place_from_scene_info

    scene, info = load_scene(dae_dir / "pyramid.dae")
    lo, hi = scene.primitive_bboxes()
    bundle = SceneBundle(
        scene=scene_to_device(scene, build_bvh(lo, hi)),
        bsdfs=bsdf_to_device(scene.bsdfs),
        lights=lights_to_device(scene.lights),
        env=None,
    )
    W = H = 16
    cam = Camera()
    cam.configure(info.camera, W, H)
    place_from_scene_info(cam, info, scene.bbox_min, scene.bbox_max)
    ys, xs = np.mgrid[0:H, 0:W]
    px, py = jnp.asarray(xs.ravel()), jnp.asarray(ys.ravel())
    key = jax.random.PRNGKey(0)
    spp = 64

    def render(tau):
        s = make_settings(
            scene.lights, ns_aa=spp, max_ray_depth=2, ns_area_light=1,
            bsdf_table=scene.bsdfs, samples_per_batch=spp, max_tolerance=0.0,
            nee_rr_tau=tau,
        )
        rad, _, stats = jax.jit(
            lambda: render_wavefront(bundle, s, cam.params(), px, py, W, H, key)
        )()
        return np.asarray(rad), float(stats[0])

    r_off, rays_off = render(0.0)
    r_on, rays_on = render(0.5)
    assert rays_on < 0.97 * rays_off, "RR did not drop any shadow rays"
    np.testing.assert_allclose(
        r_on.mean(axis=0), r_off.mean(axis=0), rtol=0.02
    )


def test_compact_bounces_bitequal(dae_dir):
    """Bounce-wavefront live-lane compaction is a pure reordering: renders
    with compact_bounces on/off must agree to the bit (same rays, results
    unpermuted).  It stays off by default; this test keeps the mechanism
    honest."""
    import jax

    from lens_flare.accel import build_bvh
    from lens_flare.integrator.lights import lights_to_device
    from lens_flare.integrator.path import (
        SceneBundle,
        make_settings,
        render_wavefront,
    )
    from lens_flare.integrator.shading import bsdf_to_device
    from lens_flare.ops import scene_to_device
    from lens_flare.scene.build import load_scene
    from lens_flare.scene.camera import Camera, place_from_scene_info

    scene, info = load_scene(dae_dir / "pyramid.dae")
    lo, hi = scene.primitive_bboxes()
    bundle = SceneBundle(
        scene=scene_to_device(scene, build_bvh(lo, hi)),
        bsdfs=bsdf_to_device(scene.bsdfs),
        lights=lights_to_device(scene.lights),
        env=None,
    )
    W = H = 12
    cam = Camera()
    cam.configure(info.camera, W, H)
    place_from_scene_info(cam, info, scene.bbox_min, scene.bbox_max)
    ys, xs = np.mgrid[0:H, 0:W]
    px, py = jnp.asarray(xs.ravel()), jnp.asarray(ys.ravel())
    key = jax.random.PRNGKey(0)

    def render(compact):
        s = make_settings(
            scene.lights, ns_aa=4, max_ray_depth=3, ns_area_light=1,
            bsdf_table=scene.bsdfs, samples_per_batch=4, max_tolerance=0.0,
            compact_bounces=compact,
        )
        rad, _, _ = jax.jit(
            lambda: render_wavefront(bundle, s, cam.params(), px, py, W, H, key)
        )()
        return np.asarray(rad)

    np.testing.assert_array_equal(render(False), render(True))


def test_sort_bounces_bitequal(dae_dir):
    """Morton-origin bounce sorting is a pure reordering around the trace:
    renders with sort_bounces on/off must agree to the bit."""
    import jax

    from lens_flare.accel import build_bvh
    from lens_flare.integrator.lights import lights_to_device
    from lens_flare.integrator.path import (
        SceneBundle,
        make_settings,
        render_wavefront,
    )
    from lens_flare.integrator.shading import bsdf_to_device
    from lens_flare.ops import scene_to_device
    from lens_flare.scene.build import load_scene
    from lens_flare.scene.camera import Camera, place_from_scene_info

    scene, info = load_scene(dae_dir / "pyramid.dae")
    lo, hi = scene.primitive_bboxes()
    bundle = SceneBundle(
        scene=scene_to_device(scene, build_bvh(lo, hi)),
        bsdfs=bsdf_to_device(scene.bsdfs),
        lights=lights_to_device(scene.lights),
        env=None,
    )
    W = H = 12
    cam = Camera()
    cam.configure(info.camera, W, H)
    place_from_scene_info(cam, info, scene.bbox_min, scene.bbox_max)
    ys, xs = np.mgrid[0:H, 0:W]
    px, py = jnp.asarray(xs.ravel()), jnp.asarray(ys.ravel())
    key = jax.random.PRNGKey(7)
    bbox = (
        tuple(float(v) for v in scene.bbox_min),
        tuple(float(v) for v in scene.bbox_max),
    )

    def render(sort):
        s = make_settings(
            scene.lights, ns_aa=4, max_ray_depth=3, ns_area_light=1,
            bsdf_table=scene.bsdfs, samples_per_batch=4, max_tolerance=0.0,
            sort_bounces=sort, sort_bbox=bbox if sort else None,
        )
        rad, _, _ = jax.jit(
            lambda: render_wavefront(bundle, s, cam.params(), px, py, W, H, key)
        )()
        return np.asarray(rad)

    np.testing.assert_array_equal(render(False), render(True))
