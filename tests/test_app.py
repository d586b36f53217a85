"""Interactive Application state machine + event surface (SURVEY 2.26).

Drives ``lens_flare.app.Application`` headless with scripted key /
mouse events and asserts the reference's ``Application::keyboard_event`` /
``mouse_*`` semantics (application.cpp:428-631) and
``RaytracedRenderer::key_press`` knob changes (raytraced_renderer.cpp:
537-616), plus progressive-render equivalence with the offline Renderer.
"""

import numpy as np
import pytest

from lens_flare.app import KEY_LEFT, KEY_RIGHT, KEY_UP, LEFT, RIGHT, Application, Mode
from lens_flare.renderer import Renderer


@pytest.fixture(scope="module")
def app_factory(dae_dir):
    def make(**kw):
        kw.setdefault("width", 48)
        kw.setdefault("height", 36)
        kw.setdefault("ns_aa", 2)
        kw.setdefault("max_ray_depth", 1)
        kw.setdefault("indirect", False)
        r = Renderer(**kw)
        r.load(dae_dir / "pyramid.dae")
        return Application(r, preview_width=48, progressive_batch=1)

    return make


def test_mode_transitions(app_factory):
    app = app_factory()
    assert app.mode == Mode.EDIT
    app.keyboard_event("r")
    assert app.mode == Mode.RENDER
    app.keyboard_event("v")
    assert app.mode == Mode.VISUALIZE
    app.keyboard_event("e")
    assert app.mode == Mode.EDIT
    app.keyboard_event("v")
    assert app.mode == Mode.VISUALIZE
    app.keyboard_event("r")
    assert app.mode == Mode.RENDER
    app.keyboard_event("e")
    assert app.mode == Mode.EDIT


def test_key_press_knobs(app_factory, tmp_path):
    app = app_factory()
    r = app.renderer
    app.keyboard_event("r")  # RENDER mode
    app.keyboard_event("]")
    assert r.ns_aa == 4
    app.keyboard_event("[")
    app.keyboard_event("[")
    app.keyboard_event("[")  # clamps at 1
    assert r.ns_aa == 1
    app.keyboard_event("=")
    assert r.ns_area_light == 2
    app.keyboard_event("-")
    assert r.ns_area_light == 1
    app.keyboard_event(">")
    assert r.max_ray_depth == 2
    app.keyboard_event("<")
    assert r.max_ray_depth == 1
    app.keyboard_event("h")
    assert r.direct_hemisphere_sample
    app.keyboard_event("h")
    app.keyboard_event("l")
    assert r.camera.lens_radius == pytest.approx(0.05)
    app.keyboard_event("k")
    assert r.camera.lens_radius == 0.0
    app.keyboard_event("'")
    assert r.camera.focal_distance == pytest.approx(0.1)
    app.keyboard_event(";")
    assert r.camera.focal_distance == 0.0
    # settings were rebuilt to match the knobs (update_settings path)
    assert r.settings.max_ray_depth == 1

    app.filename = str(tmp_path / "t")
    app.keyboard_event("d")
    assert (tmp_path / "t_cam_settings.txt").exists()


def test_progressive_matches_offline(app_factory):
    app = app_factory()
    app.keyboard_event("r")
    while not app.render_done:
        app.frame()
    hdr_app = app._film / np.maximum(app._counts, 1)[..., None]

    offline, counts = app.renderer.render(progress=False)
    assert counts.min() == app.renderer.ns_aa
    # identical RNG per (pixel id, sample index) => same estimator
    np.testing.assert_allclose(hdr_app, offline, rtol=1e-5, atol=1e-6)


def test_orbit_pan_scroll_reset(app_factory):
    app = app_factory()
    cam = app.renderer.camera
    pos0, theta0 = np.array(cam.pos), cam.theta
    # left-drag orbit (mouse1_dragged -> rotate_by)
    app.mouse_pressed(LEFT, 10.0, 10.0)
    app.cursor_event(20.0, 12.0)
    app.mouse_released(LEFT)
    assert cam.theta != theta0
    # right-drag pan (mouse2_dragged -> move_by)
    tp0 = np.array(cam.target_pos)
    app.mouse_pressed(RIGHT, 10.0, 10.0)
    app.cursor_event(14.0, 10.0)
    app.right_down = False  # release without autofocus (EDIT mode anyway)
    assert not np.allclose(cam.target_pos, tp0)
    # scroll dolly
    r0 = cam.r
    app.scroll_event(1.0)
    assert cam.r != r0
    # space resets to the canonical placement
    app.keyboard_event(" ")
    assert np.allclose(cam.theta, theta0)
    assert np.allclose(cam.pos, pos0)


def test_edit_and_visualize_frames(app_factory):
    app = app_factory()
    f = app.frame()
    assert f.shape == (36, 48, 3)
    assert np.isfinite(f).all() and f.max() > 0.1  # scene visible

    app.keyboard_event("v")
    fv = app.frame()
    assert fv.shape == f.shape
    # wireframe overlay drew box edges over the dimmed preview: some pixels
    # must differ from a pure 0.35x dim of the EDIT frame
    changed = np.abs(fv - f * 0.35).max(axis=-1) > 0.2
    assert changed.any()
    # overlay alignment (regression for the y-flip bug): the root AABB
    # bounds all geometry, so its projected row span must cover every row
    # where the preview actually shows geometry
    bvh = app._host_bvh()
    mn, mx = bvh.node_min[0], bvh.node_max[0]
    corners = np.array(
        [[(mx if i & 1 else mn)[0], (mx if i & 2 else mn)[1], (mx if i & 4 else mn)[2]] for i in range(8)]
    )
    _, sy, ok = app._project(corners)
    assert ok.any()
    hit_rows = np.where(app._preview_hit.any(axis=1))[0]
    assert hit_rows.min() >= sy[ok].min() - 2
    assert hit_rows.max() <= sy[ok].max() + 2

    # arrow keys walk the BVH selection stack (selectionHistory semantics)
    assert app.selection_history == [0]
    app.keyboard_event(KEY_LEFT)
    assert len(app.selection_history) == 2
    app.keyboard_event(KEY_RIGHT)
    assert len(app.selection_history) == 3
    app.keyboard_event(KEY_UP)
    app.keyboard_event(KEY_UP)
    assert app.selection_history == [0]
    app.keyboard_event(KEY_UP)  # root: no-op
    assert app.selection_history == [0]

    # 'a' toggles the logged-ray overlay
    app.keyboard_event("a")
    assert app.show_rays
    app.log_ray(np.zeros(3), np.array([0, 0, 1.0]), 5.0, True)
    fr = app.frame()
    assert fr.shape == f.shape


def test_cell_render(app_factory):
    app = app_factory()
    app.keyboard_event("r")
    app.keyboard_event("C")  # cell mode on
    assert app.render_cell
    # drag-select a cell: cursor coords are top-down (like raw GLFW
    # positions) and the Application applies the reference's screenH - y
    # flip into the bottom-up film (application.cpp:556,606 — the film
    # really is bottom-up, proven in tests/test_reference_binary.py), so
    # dragging rows 12..28 selects film rows 36-28 .. 36-12
    app.mouse_pressed(LEFT, 8.0, 12.0)
    app._mouse1_dragged(24.0, 28.0)
    app.mouse_released(LEFT)
    x0, y0, dx, dy = app._cell_bounds()
    assert (x0, y0, dx, dy) == (8, 8, 16, 16)
    app.frame()
    inside = app._counts[y0 : y0 + dy, x0 : x0 + dx]
    assert inside.min() >= 1
    outside = app._counts.copy()
    outside[y0 : y0 + dy, x0 : x0 + dx] = 99
    assert (outside != 99).sum() == (outside == 0).sum()  # untouched outside


def test_autofocus_right_click(app_factory):
    app = app_factory(lens_radius=0.1, focal_distance=1.0)
    app.keyboard_event("r")
    app.mouse_pressed(RIGHT, 24.0, 18.0)
    app.mouse_released(RIGHT)
    # right-click autofocus set focalDistance to the hit depth (pathtracer.cpp:1065-1072)
    assert app.renderer.camera.focal_distance > 0
    assert np.isfinite(app.renderer.camera.focal_distance)


def test_save_image(app_factory, tmp_path):
    app = app_factory()
    app.filename = str(tmp_path / "shot")
    app.keyboard_event("r")
    app.frame()
    path = app.keyboard_event("s") or (tmp_path / "shot.png")
    assert (tmp_path / "shot.png").exists()


def test_mesh_edit_keys(app_factory):
    """EDIT-mode u/d/i/f/s/c (application.cpp:515-536) actually edit the
    selected mesh — the reference declared these but left every operation
    a TODO stub (meshEdit.cpp:6-106)."""
    app = app_factory()
    assert app.mode == Mode.EDIT
    r = app.renderer
    t0 = r.scene.num_triangles

    # upsample: the selected mesh's triangle count quadruples
    ranges = app._mesh_ranges()
    lo, hi = ranges[0]
    app.keyboard_event("u")
    assert r.scene.num_triangles == t0 + 3 * (hi - lo)
    # the renderer was rebuilt: preview + BVH caches invalidated, and a
    # subsequent offline render still works on the edited scene
    assert app._preview_cache is None
    frame = app.frame()
    assert np.isfinite(frame).all()

    # split on the upsampled mesh: +2 faces (interior) or +1 (boundary)
    t1 = r.scene.num_triangles
    app.keyboard_event("s")
    assert r.scene.num_triangles in (t1 + 1, t1 + 2)

    # flip: face count unchanged (may be a rejected no-op on boundary)
    t2 = r.scene.num_triangles
    app.keyboard_event("f")
    assert r.scene.num_triangles == t2

    # collapse: -2 faces when accepted, unchanged when guarded
    app.keyboard_event("c")
    assert r.scene.num_triangles in (t2, t2 - 2)

    # downsample: triangle count drops to ~quarter of the selected mesh
    t3 = r.scene.num_triangles
    app.keyboard_event("d")
    assert r.scene.num_triangles < t3

    # isotropic resample keeps a valid renderable mesh
    app.keyboard_event("i")
    assert r.scene.num_triangles >= 4
    frame = app.frame()
    assert np.isfinite(frame).all()


def test_mesh_edit_nonmanifold_rejected(app_factory):
    """A mesh-edit keypress on non-manifold soup must not crash the app."""
    import dataclasses

    app = app_factory()
    r = app.renderer
    scene = r.scene
    # corrupt mesh 0 into non-manifold soup: duplicate its first triangle
    # (three faces sharing an edge with the same orientation)
    tri_p = np.concatenate([scene.tri_p[:1], scene.tri_p])
    tri_n = np.concatenate([scene.tri_n[:1], scene.tri_n])
    tri_b = np.concatenate([scene.tri_bsdf[:1], scene.tri_bsdf])
    r.load_flat_scene(
        dataclasses.replace(scene, tri_p=tri_p, tri_n=tri_n, tri_bsdf=tri_b),
        camera=r.camera,
    )
    t0 = r.scene.num_triangles
    app.keyboard_event("u")  # rejected, not crashed
    assert r.scene.num_triangles == t0
    app.keyboard_event("f")
    assert r.scene.num_triangles == t0
