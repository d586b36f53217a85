"""Differentiable path-traced radiance: finite-difference gradient checks.

The BASELINE north star requires pixel gradients w.r.t. *scene radiance*
parameters through the full integrator (reference chain:
``est_radiance_global_illumination``, pathtracer.cpp:282-302), with the
trace detached (hit ids/t/normals treated as constants — SURVEY.md section 7
hard part 3).  Because the discrete hit structure is piecewise constant in
radiometric parameters, ``jax.grad`` of the fixed-RNG estimator must match
central finite differences of the *same* estimator essentially exactly.

Covered parameters: emitter radiance (BSDF row), diffuse albedo (depth-2 so
it enters nonlinearly), NEE light radiance, envmap texels, through the XLA
traversal (the GPU kernel shares its detached-trace contract).  Plus the round-goal demo: recovering an emitter color from a
target render by gradient descent.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from lens_flare.accel import build_bvh
from lens_flare.integrator.lights import lights_to_device
from lens_flare.integrator.path import SceneBundle, make_settings
from lens_flare.integrator.shading import bsdf_to_device
from lens_flare.ops import scene_to_device
from lens_flare.diff.render import recover_emitter, render_image, set_emitter_color
from lens_flare.scene.build import load_scene
from lens_flare.scene.camera import Camera, place_from_scene_info

W = H = 8
SPP = 2


def _make_case(dae_dir, depth=2):
    scene, info = load_scene(dae_dir / "sky" / "CBspheres_lambertian.dae")
    lo, hi = scene.primitive_bboxes()
    bvh = build_bvh(lo, hi)
    bundle = SceneBundle(
        scene=scene_to_device(scene, bvh),
        bsdfs=bsdf_to_device(scene.bsdfs),
        lights=lights_to_device(scene.lights),
        env=None,
    )
    settings = make_settings(
        scene.lights, ns_aa=SPP, max_ray_depth=depth, ns_area_light=1,
        indirect=depth > 1, pixel_jitter=False, samples_per_batch=SPP,
        max_tolerance=0.0, bsdf_table=scene.bsdfs,
    )
    cam = Camera()
    cam.configure(info.camera, W, H)
    place_from_scene_info(cam, info, scene.bbox_min, scene.bbox_max)
    # aim at the ceiling light so the BSDF-radiance (zero-bounce emission)
    # path is exercised, not just the NEE light-table row: 20 of 64 pixels
    # see the emitter directly from here
    lightp = np.asarray(scene.lights.position[0], np.float64)
    centre = (np.asarray(scene.bbox_min) + np.asarray(scene.bbox_max)) / 2.0
    cam.pos = centre - np.array([0.0, 0.4, 0.0]) * (scene.bbox_max[1] - scene.bbox_min[1])
    cam.target_pos = lightp
    d2c = cam.pos - lightp
    d2c /= np.linalg.norm(d2c)
    sx = np.array([1.0, 0.0, 0.0])
    cam.c2w = np.stack([sx, np.cross(d2c, sx), d2c], axis=1)

    ys, xs = np.mgrid[0:H, 0:W]
    px = jnp.asarray(xs.ravel())
    py = jnp.asarray(ys.ravel())
    key = jax.random.PRNGKey(3)
    # a fixed non-uniform pixel window makes d(loss)/d(param) exercise every
    # pixel with a distinct weight
    window = jax.random.uniform(jax.random.PRNGKey(11), (W * H, 3))

    def objective(bundle):
        img = render_image(bundle, settings, cam.params(), px, py, W, H, key, SPP)
        return jnp.sum(window * img)

    # emitter BSDF row (the area light's emission) and a diffuse wall row
    emit_row = int(np.argmax(np.linalg.norm(np.asarray(scene.bsdfs.radiance), axis=1)))
    diffuse_rows = [
        b for b in range(len(scene.bsdfs.bsdf_type))
        if np.linalg.norm(np.asarray(scene.bsdfs.albedo)[b]) > 0.1
        and np.linalg.norm(np.asarray(scene.bsdfs.radiance)[b]) == 0.0
    ]
    return bundle, objective, emit_row, diffuse_rows[0], settings, cam, px, py, key


def _fd_check(objective, bundle, get, put, eps, rtol, atol=1e-4):
    """Central-difference check of d(objective)/d(row) for a (3,) row."""
    grad_fn = jax.grad(lambda row: objective(put(bundle, row)))
    row0 = get(bundle)
    g = np.asarray(grad_fn(row0))
    fd = np.zeros(3)
    for c in range(3):
        e = np.zeros(3, np.float32)
        e[c] = eps
        hi = float(objective(put(bundle, row0 + e)))
        lo = float(objective(put(bundle, row0 - e)))
        fd[c] = (hi - lo) / (2 * eps)
    np.testing.assert_allclose(g, fd, rtol=rtol, atol=atol)
    assert np.linalg.norm(g) > 1e-4, "gradient is identically zero"
    return g


def test_grad_emitter_radiance_fd(dae_dir):
    """d(pixels)/d(emitter BSDF radiance): linear, FD matches tightly."""
    bundle, objective, emit_row, _, *_ = _make_case(dae_dir)
    _fd_check(
        objective, bundle,
        get=lambda b: b.bsdfs.radiance[emit_row],
        put=lambda b, r: b._replace(
            bsdfs=b.bsdfs._replace(radiance=b.bsdfs.radiance.at[emit_row].set(r))
        ),
        eps=0.1, rtol=2e-2,
    )


def test_grad_albedo_fd(dae_dir):
    """d(pixels)/d(wall albedo) at depth 2: enters nonlinearly via indirect."""
    bundle, objective, _, wall_row, *_ = _make_case(dae_dir)
    _fd_check(
        objective, bundle,
        get=lambda b: b.bsdfs.albedo[wall_row],
        put=lambda b, r: b._replace(
            bsdfs=b.bsdfs._replace(albedo=b.bsdfs.albedo.at[wall_row].set(r))
        ),
        eps=0.02, rtol=5e-2,
    )


def test_grad_light_radiance_fd(dae_dir):
    """d(pixels)/d(NEE light-table radiance row)."""
    bundle, objective, *_ = _make_case(dae_dir)
    lrow = int(np.argmax(np.asarray(jnp.linalg.norm(bundle.lights.radiance, axis=1))))
    _fd_check(
        objective, bundle,
        get=lambda b: b.lights.radiance[lrow],
        put=lambda b, r: b._replace(
            lights=b.lights._replace(radiance=b.lights.radiance.at[lrow].set(r))
        ),
        eps=0.1, rtol=2e-2,
    )


def test_grad_envmap_texels_fd(dae_dir):
    """d(pixels)/d(envmap texels) through the miss shader + NEE env row."""
    import copy

    from lens_flare.integrator.envlight import build_env
    from lens_flare.integrator.lights import LT_ENV

    scene, info = load_scene(dae_dir / "sky" / "CBspheres_lambertian.dae")
    lo, hi = scene.primitive_bboxes()
    bvh = build_bvh(lo, hi)
    rng = np.random.default_rng(5)
    env = build_env(rng.uniform(0.2, 1.5, (8, 16, 3)).astype(np.float32))
    lt = copy.deepcopy(scene.lights)
    lt.light_type = np.append(lt.light_type, LT_ENV).astype(np.int32)
    lt.radiance = np.vstack([lt.radiance, np.zeros(3, np.float32)])
    lt.position = np.vstack([lt.position, np.zeros(3, np.float32)])
    lt.direction = np.vstack([lt.direction, np.zeros(3, np.float32)])
    lt.dim_x = np.vstack([lt.dim_x, np.zeros(3, np.float32)])
    lt.dim_y = np.vstack([lt.dim_y, np.zeros(3, np.float32)])
    lt.area = np.append(lt.area, 0.0).astype(np.float32)
    lt.is_delta = np.append(lt.is_delta, False)
    bundle = SceneBundle(
        scene=scene_to_device(scene, bvh),
        bsdfs=bsdf_to_device(scene.bsdfs),
        lights=lights_to_device(lt),
        env=env,
    )
    settings = make_settings(
        lt, ns_aa=SPP, max_ray_depth=1, ns_area_light=1, indirect=False,
        pixel_jitter=False, samples_per_batch=SPP, max_tolerance=0.0,
        bsdf_table=scene.bsdfs,
    )
    cam = Camera()
    cam.configure(info.camera, W, H)
    place_from_scene_info(cam, info, scene.bbox_min, scene.bbox_max)
    # pull the camera back so some primary rays miss into the envmap
    cam.pos = cam.pos + (cam.pos - cam.target_pos) * 1.5
    ys, xs = np.mgrid[0:H, 0:W]
    px, py = jnp.asarray(xs.ravel()), jnp.asarray(ys.ravel())
    key = jax.random.PRNGKey(3)
    window = jax.random.uniform(jax.random.PRNGKey(13), (W * H, 3))

    def objective(data):
        b = bundle._replace(env=bundle.env._replace(data=data))
        img = render_image(b, settings, cam.params(), px, py, W, H, key, SPP)
        return jnp.sum(window * img)

    g = np.asarray(jax.grad(objective)(bundle.env.data))
    assert np.count_nonzero(g) > 0, "no envmap gradient reached any texel"
    # FD along the direction of the gradient's largest texel
    (yy, xx, cc) = np.unravel_index(np.argmax(np.abs(g)), g.shape)
    eps = 0.05
    dplus = bundle.env.data.at[yy, xx, cc].add(eps)
    dminus = bundle.env.data.at[yy, xx, cc].add(-eps)
    fd = (float(objective(dplus)) - float(objective(dminus))) / (2 * eps)
    np.testing.assert_allclose(g[yy, xx, cc], fd, rtol=3e-2, atol=1e-5)


def test_recover_emitter_demo(dae_dir):
    """Round-goal demo: gradient-recover the area light's color from pixels."""
    bundle, _obj, emit_row, _wall, settings, cam, px, py, key = _make_case(dae_dir)
    lrow = int(np.argmax(np.asarray(jnp.linalg.norm(bundle.lights.radiance, axis=1))))
    true_color = jnp.asarray([0.9, 0.55, 0.2])
    target = render_image(
        set_emitter_color(bundle, emit_row, lrow, true_color),
        settings, cam.params(), px, py, W, H, key, SPP,
    )
    color, losses = recover_emitter(
        bundle, settings, cam.params(), px, py, W, H, target,
        emit_row, lrow, init_color=(2.0, 2.0, 2.0), n_samples=SPP,
        steps=80, learning_rate=0.2, key=key,
    )
    assert losses[-1] < losses[0] * 1e-3, f"loss did not converge: {losses[::20]}"
    np.testing.assert_allclose(np.asarray(color), np.asarray(true_color), atol=0.05)
