"""JAX wavefront intersection vs. the NumPy brute-force oracle."""

import numpy as np
import pytest

from lens_flare.accel import build_bvh
from lens_flare.oracle import tracer as oracle
from lens_flare.ops import intersect_rays, occluded_rays, scene_to_device
from lens_flare.scene.build import load_scene
from lens_flare.scene.camera import Camera, place_from_scene_info


def _setup(pyramid_scene, method):
    scene, info = pyramid_scene
    lo, hi = scene.primitive_bboxes()
    bvh = build_bvh(lo, hi, method=method)
    dev = scene_to_device(scene, bvh)
    cam = Camera()
    cam.configure(info.camera, 256, 256)
    place_from_scene_info(cam, info, scene.bbox_min, scene.bbox_max)
    return scene, dev, cam


@pytest.mark.parametrize("method", ["mean", "sah"])
def test_primary_rays_match_oracle(pyramid_scene, method):
    scene, dev, cam = _setup(pyramid_scene, method)

    rng = np.random.default_rng(0)
    n = 128
    xs = rng.uniform(0, 1, n)
    ys = rng.uniform(0, 1, n)

    origins = np.zeros((n, 3), np.float32)
    dirs = np.zeros((n, 3), np.float32)
    for i in range(n):
        o, d = oracle.generate_ray(cam, xs[i], ys[i])
        origins[i] = o
        dirs[i] = d

    t_lo = np.full(n, cam.n_clip, np.float32)
    t_hi = np.full(n, cam.f_clip, np.float32)
    hit = intersect_rays(dev, origins, dirs, t_lo, t_hi)

    n_hits = 0
    for i in range(n):
        ref = oracle.intersect_brute(scene, origins[i].astype(np.float64), dirs[i].astype(np.float64), cam.n_clip, cam.f_clip)
        if ref is None:
            assert not bool(hit.hit[i]), f"ray {i}: false positive"
        else:
            n_hits += 1
            assert bool(hit.hit[i]), f"ray {i}: missed hit at t={ref['t']}"
            assert np.isclose(float(hit.t[i]), ref["t"], rtol=1e-4), f"ray {i}"
            assert int(hit.prim[i]) == ref["prim"], f"ray {i}"
            assert np.allclose(np.asarray(hit.n[i]), ref["n"], atol=1e-3), f"ray {i}"
    assert n_hits > 10  # scene actually covered


def test_occlusion_matches(pyramid_scene):
    scene, dev, cam = _setup(pyramid_scene, "sah")
    rng = np.random.default_rng(1)
    n = 64
    # random shadow-feeler rays from points near the scene
    center = (scene.bbox_min + scene.bbox_max) / 2
    extent = scene.bbox_max - scene.bbox_min
    origins = (center + rng.uniform(-0.6, 0.6, (n, 3)) * extent).astype(np.float32)
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    dirs = dirs.astype(np.float32)
    t_lo = np.full(n, 1e-4, np.float32)
    t_hi = np.full(n, 100.0, np.float32)

    occ = occluded_rays(dev, origins, dirs, t_lo, t_hi)
    for i in range(n):
        ref = oracle.intersect_brute(scene, origins[i].astype(np.float64), dirs[i].astype(np.float64), 1e-4, 100.0)
        assert bool(occ[i]) == (ref is not None), f"ray {i}"


def test_spheres(dae_dir):
    scene, info = load_scene(dae_dir / "sky" / "CBspheres_lambertian.dae")
    assert scene.num_spheres == 2
    lo, hi = scene.primitive_bboxes()
    bvh = build_bvh(lo, hi)
    dev = scene_to_device(scene, bvh)
    cam = Camera()
    cam.configure(info.camera, 256, 256)
    place_from_scene_info(cam, info, scene.bbox_min, scene.bbox_max)

    rng = np.random.default_rng(2)
    n = 64
    xs = rng.uniform(0.2, 0.8, n)
    ys = rng.uniform(0.2, 0.8, n)
    origins = np.zeros((n, 3), np.float32)
    dirs = np.zeros((n, 3), np.float32)
    for i in range(n):
        o, d = oracle.generate_ray(cam, xs[i], ys[i])
        origins[i] = o
        dirs[i] = d
    t_lo = np.full(n, cam.n_clip, np.float32)
    t_hi = np.full(n, cam.f_clip, np.float32)
    hit = intersect_rays(dev, origins, dirs, t_lo, t_hi)
    for i in range(n):
        ref = oracle.intersect_brute(scene, origins[i].astype(np.float64), dirs[i].astype(np.float64), cam.n_clip, cam.f_clip)
        assert bool(hit.hit[i]) == (ref is not None)
        if ref is not None:
            assert np.isclose(float(hit.t[i]), ref["t"], rtol=1e-3)
            assert int(hit.prim[i]) == ref["prim"]
