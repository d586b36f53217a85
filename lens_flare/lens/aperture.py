"""Aperture-mask textures (starburst + ghost + bokeh masks).

Equivalent of ``CameraApertureTexture`` (``camera.h:18-88``,
``camera.cpp:24-60``): grayscale PNG -> float array (red channel), nonzero
bounding box, total value; uniform bbox sampling returning centered
(u, v) in [-0.5, 0.5]^2, and an additional *importance* sampler (CDF over
mask values) used for bokeh-mask thin-lens sampling where uniform-bbox
rejection would waste lanes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.image import load_png_gray


@dataclass
class ApertureTexture:
    values: np.ndarray  # (H, W) float in [0, 1]
    total_value: float
    min_x: int
    min_y: int
    max_x: int
    max_y: int

    @property
    def width(self) -> int:
        return self.values.shape[1]

    @property
    def height(self) -> int:
        return self.values.shape[0]

    @classmethod
    def load(cls, path) -> "ApertureTexture":
        values = load_png_gray(path)
        return cls.from_array(values)

    @classmethod
    def from_array(cls, values: np.ndarray) -> "ApertureTexture":
        values = np.asarray(values, np.float32)
        ys, xs = np.nonzero(values > 0)
        if len(xs) == 0:
            min_x = min_y = values.shape[1]
            max_x = max_y = -1
        else:
            min_x, max_x = int(xs.min()), int(xs.max())
            min_y, max_y = int(ys.min()), int(ys.max())
        return cls(
            values=values,
            total_value=float(values.sum()),
            min_x=min_x,
            min_y=min_y,
            max_x=max_x,
            max_y=max_y,
        )

    def pdf(self) -> float:
        """BBox-area pdf (camera.cpp:24-29)."""
        total_area = float(self.width * self.height)
        bb_area = float((self.max_x - self.min_x) * (self.max_y - self.min_y))
        return bb_area / total_area

    def sample_uniform_bbox(self, u: np.ndarray, v: np.ndarray):
        """Uniform bbox sampling (camera.cpp:31-60). u, v in [0,1).

        Returns (value, u_centered, v_centered) with coords in [-0.5, 0.5].
        """
        uc = self.min_x + u * (self.max_x - self.min_x)
        vc = self.min_y + v * (self.max_y - self.min_y)
        up = np.round(uc).astype(np.int64)
        vp = np.round(vc).astype(np.int64)
        value = self.values[vp, up]
        return value, up / self.width - 0.5, vp / self.height - 0.5

    # value-proportional sampling lives in integrator.path.BokehMask


def blade_aperture(
    size: int, blades: int, radius: float = 0.42, dust: int = 0, seed: int = 0,
    supersample: int = 4,
) -> np.ndarray:
    """Draw an iris of ``blades`` straight blades as an (size, size) mask in [0, 1].

    A regular polygon of circumradius ``radius`` (in units of the image
    width) centred in the image, rotated by a seeded angle, with
    ``supersample``^2 coverage samples per pixel for anti-aliased edges.
    ``dust`` seeded dark specks inside the opening stand in for the dirt
    on a real aperture that gives a starburst its fine structure.
    """
    rng = np.random.default_rng(seed)
    phase = rng.uniform(0.0, 2.0 * np.pi / blades)
    k = supersample
    g = (np.arange(size * k) + 0.5) / (size * k) - 0.5
    x, y = np.meshgrid(g, g)
    r = np.hypot(x, y)
    a = np.mod(np.arctan2(y, x) - phase, 2.0 * np.pi / blades) - np.pi / blades
    # distance to the polygon edge along the ray at angle a from the centre
    apothem = radius * np.cos(np.pi / blades)
    inside = r * np.cos(a) <= apothem
    for _ in range(dust):
        cx, cy = rng.uniform(-0.6, 0.6, 2) * apothem
        rad = rng.uniform(0.004, 0.015)
        inside &= np.hypot(x - cx, y - cy) > rad
    mask = inside.reshape(size, k, size, k).mean(axis=(1, 3))
    return mask.astype(np.float32)
