"""Camera model: orbit placement, FOV handling, ray generation, projection.

Re-design of the reference camera (``src/pathtracer/camera.cpp``) as a
host-side dataclass plus pure array functions used inside jit:

- :meth:`Camera.configure` — aspect-ratio FOV fixup (camera.cpp:69-88)
- :meth:`Camera.place` / orbit math (camera.cpp:94-106, 171-203)
- :func:`generate_rays` — pinhole ray gen over a pixel wavefront
  (camera.cpp:278-305), fully batched
- :func:`generate_rays_thin_lens` — the thin-lens DoF path the reference
  stubs out (camera_lens.cpp:22-30), implemented for real: concentric lens
  sample towards the focal-plane point, with optional bokeh-mask importance
  sampling (BASELINE config 2)
- :meth:`Camera.analyze_world_coord` — world -> normalized-screen projection
  used by the lens-flare sun finder (camera.cpp:245-273)
- settings dump/load in the reference's text format (camera.cpp:208-242)
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np

EPS_F = 0.00001


class CameraParams(NamedTuple):
    """Traced camera state: everything ray generation needs, as arrays."""

    c2w: any  # (3, 3) columns = [screenX, screenY, dirToCamera] in world space
    pos: any  # (3,)
    tan_half_h: any  # scalar tan(hFov/2)
    tan_half_v: any  # scalar tan(vFov/2)
    n_clip: any
    f_clip: any
    lens_radius: any
    focal_distance: any


@dataclass
class Camera:
    h_fov: float = 50.0  # degrees
    v_fov: float = 35.0
    n_clip: float = 0.001
    f_clip: float = 1000.0
    screen_w: int = 800
    screen_h: int = 600
    screen_dist: float = 1.0
    ar: float = 1.0
    pos: np.ndarray = field(default_factory=lambda: np.zeros(3))
    target_pos: np.ndarray = field(default_factory=lambda: np.zeros(3))
    c2w: np.ndarray = field(default_factory=lambda: np.eye(3))
    phi: float = 0.0
    theta: float = 0.0
    r: float = 1.0
    min_r: float = 0.0
    max_r: float = math.inf
    lens_radius: float = 0.0
    focal_distance: float = 0.0
    # auto-dump settings on every move (camera.cpp:175-180 frames/frame_N.txt)
    frame_dump_dir: str | None = None
    frame_num: int = 0

    # -- configuration (camera.cpp:69-88) -------------------------------

    def configure(self, info, screen_w: int, screen_h: int) -> None:
        self.screen_w = screen_w
        self.screen_h = screen_h
        self.n_clip = info.n_clip
        self.f_clip = info.f_clip
        self.h_fov = info.h_fov
        self.v_fov = info.v_fov
        ar1 = math.tan(math.radians(self.h_fov) / 2) / math.tan(math.radians(self.v_fov) / 2)
        self.ar = screen_w / screen_h
        if ar1 < self.ar:
            self.h_fov = 2 * math.degrees(
                math.atan(math.tan(math.radians(self.v_fov) / 2) * self.ar)
            )
        elif ar1 > self.ar:
            self.v_fov = 2 * math.degrees(
                math.atan(math.tan(math.radians(self.h_fov) / 2) / self.ar)
            )
        self.screen_dist = screen_h / (2.0 * math.tan(math.radians(self.v_fov) / 2))

    def set_screen_size(self, screen_w: int, screen_h: int) -> None:
        self.screen_w = screen_w
        self.screen_h = screen_h
        self.ar = screen_w / screen_h
        self.h_fov = 2 * math.degrees(math.atan(screen_w / (2 * self.screen_dist)))
        self.v_fov = 2 * math.degrees(math.atan(screen_h / (2 * self.screen_dist)))

    # -- placement (camera.cpp:94-106, 171-203) --------------------------

    def place(self, target_pos, phi, theta, r, min_r, max_r) -> None:
        self.target_pos = np.asarray(target_pos, dtype=np.float64)
        self.phi = phi + EPS_F if math.sin(phi) == 0 else phi
        self.theta = theta
        self.r = min(max(r, min_r), max_r)
        self.min_r = min_r
        self.max_r = max_r
        self.compute_position()

    def compute_position(self) -> None:
        # turntable scripting support: dump settings per placement change
        # (camera.cpp:171-180)
        self.frame_num += 1
        if self.frame_dump_dir and self.frame_num > 1:
            import os

            os.makedirs(self.frame_dump_dir, exist_ok=True)
            self.dump_settings(
                os.path.join(self.frame_dump_dir, f"frame_{self.frame_num - 1}.txt")
            )
        sin_phi = math.sin(self.phi)
        if sin_phi == 0:
            self.phi += EPS_F
            sin_phi = math.sin(self.phi)
        dir_to_camera = np.array(
            [
                self.r * sin_phi * math.sin(self.theta),
                self.r * math.cos(self.phi),
                self.r * sin_phi * math.cos(self.theta),
            ]
        )
        self.pos = self.target_pos + dir_to_camera
        up_vec = np.array([0.0, 1.0 if sin_phi > 0 else -1.0, 0.0])
        screen_x = np.cross(up_vec, dir_to_camera)
        screen_x /= np.linalg.norm(screen_x)
        screen_y = np.cross(dir_to_camera, screen_x)
        screen_y /= np.linalg.norm(screen_y)
        c2w = np.empty((3, 3))
        c2w[:, 0] = screen_x
        c2w[:, 1] = screen_y
        c2w[:, 2] = dir_to_camera / np.linalg.norm(dir_to_camera)
        self.c2w = c2w

    def move_by(self, dx: float, dy: float, d: float) -> None:
        scale = d / self.screen_dist
        disp = self.c2w[:, 0] * (dx * scale) + self.c2w[:, 1] * (dy * scale)
        self.pos = self.pos + disp
        self.target_pos = self.target_pos + disp

    def move_forward(self, dist: float) -> None:
        new_r = min(max(self.r - dist, self.min_r), self.max_r)
        self.pos = self.target_pos + (self.pos - self.target_pos) * (new_r / self.r)
        self.r = new_r

    def rotate_by(self, d_phi: float, d_theta: float) -> None:
        self.phi = min(max(self.phi + d_phi, 0.0), math.pi)
        self.theta += d_theta
        self.compute_position()

    # -- projection (camera.cpp:245-273) ---------------------------------

    def analyze_world_coord(self, pos_world) -> tuple[float, float]:
        """World point -> normalized screen coords in [0,1]^2 (if on screen)."""
        edge_x = math.tan(0.5 * math.radians(self.h_fov))
        edge_y = math.tan(0.5 * math.radians(self.v_fov))
        pos_camera = self.c2w.T @ (np.asarray(pos_world) - self.pos)
        pos_image = pos_camera / abs(pos_camera[2])
        ns_x = ((pos_image[0] / edge_x) + 1) / 2.0
        ns_y = ((pos_image[1] / edge_y) + 1) / 2.0
        return float(ns_x), float(ns_y)

    # -- settings files (camera.cpp:208-242) ------------------------------

    def dump_settings(self, filename) -> None:
        with open(filename, "w") as f:
            f.write(f"{self.h_fov} {self.v_fov} {self.ar} {self.n_clip} {self.f_clip}\n")
            f.write(" ".join(str(v) for v in self.pos) + " ")
            f.write(" ".join(str(v) for v in self.target_pos) + " \n")
            f.write(f"{self.phi} {self.theta} {self.r} {self.min_r} {self.max_r}\n")
            f.write(" ".join(str(self.c2w[i // 3, i % 3]) for i in range(9)) + " \n")
            f.write(f"{self.screen_w} {self.screen_h} {self.screen_dist}\n")
            f.write(f"{self.focal_distance} {self.lens_radius}\n")

    def load_settings(self, filename) -> None:
        with open(filename) as f:
            vals = f.read().split()
        it = iter(vals)

        def nxt():
            return float(next(it))

        self.h_fov, self.v_fov, self.ar, self.n_clip, self.f_clip = (nxt() for _ in range(5))
        self.pos = np.array([nxt() for _ in range(3)])
        self.target_pos = np.array([nxt() for _ in range(3)])
        self.phi, self.theta, self.r, self.min_r, self.max_r = (nxt() for _ in range(5))
        self.c2w = np.array([nxt() for _ in range(9)]).reshape(3, 3)
        self.screen_w, self.screen_h = int(nxt()), int(nxt())
        self.screen_dist = nxt()
        self.focal_distance, self.lens_radius = nxt(), nxt()

    # -- traced parameters ------------------------------------------------

    def params(self, dtype=np.float32) -> CameraParams:
        return CameraParams(
            c2w=self.c2w.astype(dtype),
            pos=self.pos.astype(dtype),
            tan_half_h=dtype(math.tan(0.5 * math.radians(self.h_fov))),
            tan_half_v=dtype(math.tan(0.5 * math.radians(self.v_fov))),
            n_clip=dtype(self.n_clip),
            f_clip=dtype(self.f_clip),
            lens_radius=dtype(self.lens_radius),
            focal_distance=dtype(self.focal_distance),
        )


def place_from_scene_info(camera: Camera, scene_info, bbox_min, bbox_max) -> None:
    """Orbit placement from scene bbox, matching ``Application::load`` (application.cpp:278-301).

    The .dae camera transform is only used for the *view direction* — and,
    faithfully to the reference quirk, as a point transform of (0,0,-1)
    (``application.cpp:252-253`` uses Vector4D(v, 1)), not a direction
    transform.  Position is derived from the bbox orbit.
    """
    transform = scene_info.camera.transform
    c_dir = transform @ np.array([0.0, 0.0, -1.0, 1.0])
    c_dir = c_dir[:3] / np.linalg.norm(c_dir[:3])

    target = (np.asarray(bbox_min) + np.asarray(bbox_max)) / 2.0
    extent = np.asarray(bbox_max) - np.asarray(bbox_min)
    canonical = np.linalg.norm(extent) / 2.0 * 1.5
    camera.place(
        target,
        math.acos(c_dir[1]),
        math.atan2(c_dir[0], c_dir[2]),
        canonical * 2.0,
        canonical / 10.0,
        canonical * 20.0,
    )


# ---------------------------------------------------------------------------
# Pure ray-generation functions (used under jit)
# ---------------------------------------------------------------------------


def generate_rays(params: CameraParams, x, y):
    """Pinhole rays for normalized sensor coords x, y in [0,1] (camera.cpp:278-305).

    x, y: arrays of shape (N,).  Returns (origins (N,3), dirs (N,3)).
    """
    import jax.numpy as jnp

    cx = params.tan_half_h * (2.0 * x - 1.0)
    cy = params.tan_half_v * (2.0 * y - 1.0)
    d_cam = jnp.stack([cx, cy, -jnp.ones_like(cx)], axis=-1)
    d_cam = d_cam / jnp.linalg.norm(d_cam, axis=-1, keepdims=True)
    d_world = jnp.matmul(d_cam, params.c2w.T, precision="highest")
    origins = jnp.broadcast_to(params.pos, d_world.shape)
    return origins, d_world


def generate_rays_thin_lens(params: CameraParams, x, y, rnd_r, rnd_theta):
    """Thin-lens rays (implements the reference stub camera_lens.cpp:22-30 for real).

    Standard CS184 thin-lens model: sample a point on the lens disk
    (radius ``lens_radius``), aim at the focal-plane point of the pinhole ray.
    rnd_r, rnd_theta: uniforms in [0,1).
    """
    import jax.numpy as jnp

    cx = params.tan_half_h * (2.0 * x - 1.0)
    cy = params.tan_half_v * (2.0 * y - 1.0)

    # point on the plane of focus (camera space), along the pinhole direction
    p_focus = jnp.stack([cx, cy, -jnp.ones_like(cx)], axis=-1) * params.focal_distance

    r = params.lens_radius * jnp.sqrt(rnd_r)
    theta = 2.0 * jnp.pi * rnd_theta
    p_lens = jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta), jnp.zeros_like(r)], axis=-1)

    d_cam = p_focus - p_lens
    d_cam = d_cam / jnp.linalg.norm(d_cam, axis=-1, keepdims=True)
    d_world = jnp.matmul(d_cam, params.c2w.T, precision="highest")
    origins = params.pos + jnp.matmul(p_lens, params.c2w.T, precision="highest")
    return origins, d_world


def generate_rays_bokeh(params: CameraParams, x, y, lens_uv):
    """Thin-lens rays whose lens point comes from a bokeh-mask sample.

    ``lens_uv``: (N, 2) points in [-0.5, 0.5]^2 importance-sampled from the
    aperture/bokeh texture (see lens.aperture.ApertureTexture.sample);
    scaled by 2*lens_radius so the mask spans the lens diameter.
    """
    import jax.numpy as jnp

    cx = params.tan_half_h * (2.0 * x - 1.0)
    cy = params.tan_half_v * (2.0 * y - 1.0)
    p_focus = jnp.stack([cx, cy, -jnp.ones_like(cx)], axis=-1) * params.focal_distance

    scale = 2.0 * params.lens_radius
    p_lens = jnp.stack(
        [lens_uv[..., 0] * scale, lens_uv[..., 1] * scale, jnp.zeros_like(lens_uv[..., 0])],
        axis=-1,
    )
    d_cam = p_focus - p_lens
    d_cam = d_cam / jnp.linalg.norm(d_cam, axis=-1, keepdims=True)
    d_world = jnp.matmul(d_cam, params.c2w.T, precision="highest")
    origins = params.pos + jnp.matmul(p_lens, params.c2w.T, precision="highest")
    return origins, d_world


def project_world_to_screen(params: CameraParams, pos_world):
    """Batched analyze_world_coord for jit use: world points -> ns coords."""
    import jax.numpy as jnp

    rel = pos_world - params.pos
    # == c2w.T @ rel for each row
    pos_camera = jnp.matmul(rel, params.c2w, precision="highest")
    pos_image = pos_camera / jnp.abs(pos_camera[..., 2:3])
    ns_x = ((pos_image[..., 0] / params.tan_half_h) + 1) / 2.0
    ns_y = ((pos_image[..., 1] / params.tan_half_v) + 1) / 2.0
    return ns_x, ns_y
