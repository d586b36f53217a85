"""Scene/camera/image/EXR unit tests."""

import math

import numpy as np

from lens_flare.scene.build import load_scene
from lens_flare.scene.camera import Camera, place_from_scene_info
from lens_flare.utils import exr
from lens_flare.utils.image import sampling_rate_heatmap, to_color


def test_pyramid_scene_contents(pyramid_scene):
    scene, info = pyramid_scene
    assert scene.num_triangles == 138
    assert scene.num_spheres == 0
    # 3 lights: 2 point + 1 directional (pyramid.dae:34-158)
    assert sorted(scene.lights.light_type.tolist()) == [1, 2, 2]
    assert scene.lights.is_delta.all()


def test_sky_scene_materials(dae_dir):
    scene, info = load_scene(dae_dir / "sky" / "CBspheres.dae")
    # mirror + glass spheres (CBspheres.dae CGL profile)
    types = set(scene.bsdfs.bsdf_type.tolist())
    assert 2 in types  # mirror
    assert 5 in types  # glass
    assert 1 in types  # emission (area light panel)
    glass_rows = np.nonzero(scene.bsdfs.bsdf_type == 5)[0]
    assert np.isclose(scene.bsdfs.ior[glass_rows[0]], 1.45)


def test_microfacet_scene(dae_dir):
    scene, _ = load_scene(dae_dir / "sky" / "CBbunny_microfacet_cu.dae")
    assert (scene.bsdfs.bsdf_type == 3).any()
    row = np.nonzero(scene.bsdfs.bsdf_type == 3)[0][0]
    assert scene.bsdfs.alpha[row] > 0
    assert np.abs(scene.bsdfs.eta[row]).sum() > 0


def test_camera_configure_aspect_fixup():
    """FOV is expanded along the too-narrow dimension (camera.cpp:69-88)."""
    from lens_flare.scene.collada import CameraInfo

    cam = Camera()
    info = CameraInfo(h_fov=39.59775, v_fov=22.9, n_clip=0.1, f_clip=100.0)
    cam.configure(info, 800, 600)
    ar1 = math.tan(math.radians(cam.h_fov) / 2) / math.tan(math.radians(cam.v_fov) / 2)
    assert np.isclose(ar1, 800 / 600, rtol=1e-6)


def test_camera_settings_roundtrip(tmp_path):
    cam = Camera()
    cam.place(np.array([1.0, 2.0, 3.0]), 1.1, 0.4, 5.0, 0.5, 50.0)
    cam.lens_radius = 0.25
    cam.focal_distance = 4.5
    cam.screen_w, cam.screen_h = 640, 480
    path = tmp_path / "cam.txt"
    cam.dump_settings(path)

    cam2 = Camera()
    cam2.load_settings(path)
    np.testing.assert_allclose(cam2.pos, cam.pos)
    np.testing.assert_allclose(cam2.c2w, cam.c2w)
    assert cam2.lens_radius == cam.lens_radius
    assert cam2.screen_w == 640


def test_analyze_world_coord_center():
    """A point straight ahead projects to the screen center (camera.cpp:245-273)."""
    cam = Camera()
    cam.place(np.zeros(3), math.pi / 2, 0.0, 5.0, 0.1, 50.0)
    # camera at (0,0,5) looking at origin along -z
    ns_x, ns_y = cam.analyze_world_coord(np.array([0.0, 0.0, 0.0]))
    assert np.isclose(ns_x, 0.5, atol=1e-6)
    assert np.isclose(ns_y, 0.5, atol=1e-6)


def test_to_color_matches_reference_transform():
    hdr = np.array([[[0.5, 1.0, 2.0]]], np.float32)
    out = to_color(hdr)
    exposure = np.sqrt(2.0)
    want = np.clip((hdr * exposure) ** (1 / 2.2), 0, 1)
    np.testing.assert_allclose(out, want, rtol=1e-6)


def test_heatmap_shape():
    counts = np.array([[0, 8], [16, 4]])
    hm = sampling_rate_heatmap(counts, 16)
    assert hm.shape == (2, 2, 3)
    assert hm.max() <= 1.0


def test_exr_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 10, (33, 47, 3)).astype(np.float32)
    path = tmp_path / "test.exr"
    exr.write(path, img)
    back = exr.read(path)
    np.testing.assert_allclose(back, img, rtol=1e-6)


def test_exr_roundtrip_uncompressed(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.uniform(0, 5, (16, 16, 3)).astype(np.float32)
    path = tmp_path / "u.exr"
    exr.write(path, img, compression=exr.COMPRESSION_NONE)
    back = exr.read(path)
    np.testing.assert_allclose(back, img, rtol=1e-6)


def test_camera_frame_dump(tmp_path):
    """Auto-dump per placement change (camera.cpp:175-180)."""
    cam = Camera(frame_dump_dir=str(tmp_path / "frames"))
    cam.place(np.zeros(3), 1.0, 0.2, 5.0, 0.5, 50.0)  # frame_num -> 1, no dump
    cam.rotate_by(0.1, 0.2)  # frame_num -> 2, dumps frame_1.txt
    cam.rotate_by(0.1, 0.2)
    files = sorted((tmp_path / "frames").glob("frame_*.txt"))
    assert [f.name for f in files] == ["frame_1.txt", "frame_2.txt"]
    # dumps happen at the top of compute_position (pre-update), like the
    # reference; the file parses back cleanly
    cam2 = Camera()
    cam2.load_settings(files[-1])
    assert np.isfinite(cam2.pos).all()


def test_envmap_probability_debug(tmp_path):
    from lens_flare.integrator import envlight

    env = envlight.build_env(np.random.default_rng(0).uniform(0, 2, (8, 16, 3)).astype(np.float32))
    out = tmp_path / "prob.png"
    envlight.save_probability_debug(env, out)
    assert out.exists()


def test_procedural_terrain_scene():
    from lens_flare.scene.procedural import make_terrain_scene

    scene = make_terrain_scene(16)
    assert scene.num_triangles == 2 * 16 * 16
    assert np.isfinite(scene.tri_p).all()
    # normals unit length
    lens = np.linalg.norm(scene.tri_n.reshape(-1, 3), axis=1)
    np.testing.assert_allclose(lens, 1.0, atol=1e-4)
    assert scene.lights.light_type.tolist() == [1, 2]


def test_all_corpus_scenes_parse(dae_dir):
    """Every .dae in the reference corpus loads into a FlatScene."""
    import pathlib

    count = 0
    for f in sorted(pathlib.Path(dae_dir).rglob("*.dae")):
        scene, info = load_scene(f)
        assert scene.num_triangles + scene.num_spheres > 0, f
        assert info.camera is not None, f
        count += 1
    assert count >= 20
