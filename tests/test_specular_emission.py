"""Emission pickup through delta-BSDF bounces.

NEE cannot sample a mirror/glass path (the BSDF pdf is a delta), so an area
light seen via a specular bounce must be collected as BSDF-sampled emission
at the bounce endpoint (integrator/path.py `_indirect`).  Without it the
light's mirror image renders black.  Spec context: pathtracer.cpp:234-280
plus the delta-BSDF stubs it was meant to drive (advanced_bsdf.cpp:17-145).
"""

import numpy as np
import jax.numpy as jnp

from lens_flare.renderer import Renderer
from lens_flare.scene.build import BSDFTable, FlatScene, LightTable, LT_AREA
from lens_flare.scene.camera import Camera
from lens_flare.scene.collada import (
    BSDF_EMISSION,
    BSDF_MIRROR,
    MaterialInfo,
)

LE = np.array([5.0, 4.0, 3.0], np.float32)


def _mirror_scene():
    """Y-up: mirror plane at y=0 (normal +y), emitting quad at y=4 facing down."""

    def quad(corners):
        a, b, c, d = [np.asarray(p, np.float32) for p in corners]
        return np.stack([np.stack([a, b, c]), np.stack([a, c, d])])

    mirror = quad([(-3, 0, -3), (3, 0, -3), (3, 0, 3), (-3, 0, 3)])
    light = quad([(-1, 4, -1), (1, 4, -1), (1, 4, 1), (-1, 4, 1)])
    tri_p = np.concatenate([mirror, light])
    n_mirror = np.tile(np.array([0, 1, 0], np.float32), (2, 3, 1))
    n_light = np.tile(np.array([0, -1, 0], np.float32), (2, 3, 1))
    tri_n = np.concatenate([n_mirror, n_light])
    tri_bsdf = np.array([0, 0, 1, 1], np.int32)

    mats = [
        MaterialInfo(bsdf_type=BSDF_MIRROR, reflectance=np.ones(3)),
        MaterialInfo(bsdf_type=BSDF_EMISSION, radiance=LE.astype(np.float64)),
    ]
    lights = LightTable(
        light_type=np.array([LT_AREA], np.int32),
        radiance=LE[None, :],
        position=np.array([[0, 4, 0]], np.float32),
        direction=np.array([[0, -1, 0]], np.float32),
        dim_x=np.array([[2, 0, 0]], np.float32),
        dim_y=np.array([[0, 0, 2]], np.float32),
        area=np.array([4.0], np.float32),
        is_delta=np.array([False]),
    )
    scene = FlatScene(
        tri_p=tri_p,
        tri_n=tri_n,
        tri_bsdf=tri_bsdf,
        sph_center=np.zeros((0, 3), np.float32),
        sph_radius=np.zeros(0, np.float32),
        sph_bsdf=np.zeros(0, np.int32),
        bsdfs=BSDFTable.from_materials(mats),
        lights=lights,
    )
    lo, hi = scene.primitive_bboxes()
    scene.bbox_min = lo.min(axis=0).astype(np.float64)
    scene.bbox_max = hi.max(axis=0).astype(np.float64)
    return scene


def test_area_light_visible_in_mirror():
    """The emitter's mirror image carries its full radiance (reflectance 1).

    Camera at (0, 2, 0) looking straight down: the center ray reflects off
    the mirror plane and hits the emitting quad behind the camera, so the
    expected center-pixel radiance is exactly LE (Russian roulette is
    compensated, 64 spp averages its variance down).
    """
    scene = _mirror_scene()
    cam = Camera()
    cam.place(np.zeros(3), 0.0, 0.0, 2.0, 0.1, 50.0)  # phi=0 -> +y orbit pole
    cam.h_fov = cam.v_fov = 40.0
    cam.screen_w = cam.screen_h = 9

    r = Renderer(width=9, height=9, ns_aa=64, max_ray_depth=2, indirect=True,
                 tile_pixels=81 * 64)
    r.load_flat_scene(scene, camera=cam)
    hdr, _ = r.render(progress=False)

    center = hdr[4, 4]
    np.testing.assert_allclose(center, LE, rtol=0.25)
    # without the delta pickup this pixel is exactly black
    assert (center > 0.5 * LE).all()


def test_no_double_counting_on_diffuse():
    """A diffuse plane under the same light gets its energy from NEE only:
    the delta pickup must NOT fire for diffuse chains (double counting)."""
    from lens_flare.scene.collada import BSDF_DIFFUSE

    scene = _mirror_scene()
    # swap the mirror for a white diffuse plane
    mats = [
        MaterialInfo(bsdf_type=BSDF_DIFFUSE, albedo=np.ones(3) * 0.8),
        MaterialInfo(bsdf_type=BSDF_EMISSION, radiance=LE.astype(np.float64)),
    ]
    scene.bsdfs = BSDFTable.from_materials(mats)

    cam = Camera()
    cam.place(np.zeros(3), 0.0, 0.0, 2.0, 0.1, 50.0)
    cam.h_fov = cam.v_fov = 40.0
    cam.screen_w = cam.screen_h = 9

    # depth 1 (direct only) vs depth 4 (indirect on): the center pixel may
    # gain at most the small multi-bounce GI term, NOT a duplicate of the
    # direct term (which a wrong pickup on diffuse chains would add)
    vals = []
    for depth in (1, 4):
        r = Renderer(width=9, height=9, ns_aa=64, max_ray_depth=depth,
                     indirect=depth > 1, tile_pixels=81 * 64)
        r.load_flat_scene(scene, camera=cam)
        hdr, _ = r.render(progress=False)
        vals.append(hdr[4, 4].copy())
    direct, with_gi = vals
    assert (direct > 0.1).all()  # NEE sees the light
    # GI adds a little bounce light; double counting would ~2x the direct term
    assert (with_gi < 1.5 * direct + 0.05).all()
    assert (with_gi > 0.8 * direct).all()


def test_cbspheres_light_reflection_golden(dae_dir):
    """CBspheres (mirror + glass spheres): the area light's image must appear
    in the spheres — hot pixels far below the ceiling light (VERDICT r1 #3).
    """
    r = Renderer(width=32, height=32, ns_aa=8, max_ray_depth=3, indirect=True,
                 tile_pixels=32 * 32 * 8)
    r.load(dae_dir / "sky" / "CBspheres.dae")
    hdr, _ = r.render(progress=False)
    lower = hdr[10:, :, :]  # below the ceiling light
    hot = (lower.max(axis=-1) > 2.0).sum()
    assert hot >= 3, f"specular light reflection missing: {hot} hot pixels"
    assert np.isfinite(hdr).all()


def test_glass_transmission_positive(dae_dir):
    """The glass sphere must transmit the room, not render black: the
    signed cosine in the bounce throughput once flipped glass-transmission
    paths to NEGATIVE radiance (found by visual QA, round 3)."""
    r = Renderer(width=48, height=48, ns_aa=16, max_ray_depth=5, indirect=True,
                 seed=0, tile_pixels=48 * 48 * 16)
    r.load(dae_dir / "sky" / "CBspheres.dae")
    hdr, _ = r.render(progress=False)
    assert float(hdr.min()) >= 0.0, "negative radiance"
    # left-center patch inside the glass sphere: refracted room is bright
    patch = hdr[26:31, 15:21]
    assert patch.mean() > 0.05, f"glass sphere is dark: {patch.mean()}"
