"""Lens-flare pipeline: sun finding, ghosts, starburst, falloff, compositing.

Orchestrates the flare stages exactly as ``start_raytracing`` wires them
(raytraced_renderer.cpp:305-311 + the per-pixel additions at
pathtracer.cpp:881-891):

1. :func:`find_sun` — scan directional lights, project ``posLight`` into
   normalized screen coords (``find_sun_pos``, pathtracer.cpp:32-64)
2. ghost buffer — paraxial traces (:mod:`lens_flare.lens.paraxial`) +
   quad splats (:mod:`lens_flare.lens.ghosts`)
3. starburst — FFT Fraunhofer field (:mod:`lens_flare.flare.starburst`)
4. irradiance falloff glow
5. composite: ``film + ghost + starburst + falloff`` in HDR, before gamma

Gating matches the reference: ghosts need a sun on screen (axis_ray != 0);
the starburst needs a non-empty aperture mask; the falloff glow applies
whenever a sun is on screen, even without an aperture.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np

from functools import partial

from ..lens.aperture import ApertureTexture
from ..lens.paraxial import trace_all_ghosts
from ..lens.ghosts import splat_ghosts, splat_ghosts_fast
from ..lens.prescription import LensPrescription, reference_prescription
from ..scene.build import LT_DIRECTIONAL
from .starburst import aperture_fft, irradiance_falloff, starburst_field


@partial(jax.jit, static_argnames=("width", "height", "method", "scale"))
def _ghost_buffer_impl(lens, angle, tex, axis_ray, width, height, method, scale):
    """Jitted ghost stage: paraxial traces + splats in ONE device program
    (eager op-by-op dispatch of the splat loop would launch thousands of
    small ops)."""
    r1, r2 = trace_all_ghosts(lens, angle)  # (P, 3)
    n_pairs = r1.shape[0]
    r1f = r1.reshape(-1)
    r2f = r2.reshape(-1)
    colors = jnp.tile(jnp.eye(3), (n_pairs, 1))
    if method == "fast" and scale == 1:
        return splat_ghosts_fast(tex, r1f, r2f, colors, axis_ray, width, height)
    return splat_ghosts(tex, r1f, r2f, colors, axis_ray, width, height, scale=scale)


def find_sun(light_table, camera):
    """Project directional lights to screen (find_sun_pos).

    Returns (origins (F,2), radiances (F,3), axis_ray (2,), angle_to_sun).
    """
    origins, radiances = [], []
    axis_ray = np.zeros(2)
    angle = 0.0
    for li in range(len(light_table.light_type)):
        if light_table.light_type[li] != LT_DIRECTIONAL:
            continue
        pos_light = light_table.position[li]
        ns_x, ns_y = camera.analyze_world_coord(pos_light)
        if 0 <= ns_x <= 1 and 0 <= ns_y <= 1:
            origins.append([ns_x, ns_y])
            radiances.append(light_table.radiance[li])
            # pathtracer.cpp:50 computes atan(ns_y / ns_x); in C++ a zero
            # ns_x yields atan(+-inf) = +-pi/2, while Python raises
            # ZeroDivisionError.  atan2 reproduces the C++ values exactly on
            # this domain (ns_x, ns_y >= 0), including ns_x == 0 -> pi/2.
            angle = math.atan2(ns_y, ns_x)
            axis_ray = np.array([ns_x, ns_y])
    return (
        np.asarray(origins, np.float32).reshape(-1, 2),
        np.asarray(radiances, np.float32).reshape(-1, 3),
        axis_ray,
        angle,
    )


@dataclass
class FlarePipeline:
    width: int
    height: int
    flare_origins: np.ndarray  # (F, 2)
    flare_radiances: np.ndarray  # (F, 3)
    axis_ray: np.ndarray  # (2,)
    angle_to_sun: float
    aperture: ApertureTexture | None = None
    ghost_aperture: ApertureTexture | None = None
    lens: LensPrescription = None
    flare_intensity: float = 0.0
    flare_radius: float = 0.0
    falloff_key: int = 0
    ghost_scale: int = 1  # >1: subsampled ghost buffer (speed knob)
    # "exact": reference rasterizer (pixel-exact vs oracle, gather-bound);
    # "fast": canonical-card scale_and_translate (bilinear, matmuls);
    # "auto": fast for large films, exact for small
    ghost_method: str = "auto"
    # "paraxial": 2x2 matrix ghosts (reference parity, pathtracer.cpp:511-689)
    # "realistic": sequential Snell+Fresnel lens-stack trace (BASELINE config 3)
    lens_model: str = "paraxial"
    _fft_cache: object = None

    @classmethod
    def from_renderer(cls, renderer) -> "FlarePipeline | None":
        origins, radiances, axis_ray, angle = find_sun(renderer.scene.lights, renderer.camera)
        if len(origins) == 0:
            return None
        ap = (
            ApertureTexture.load(renderer.aperture_path)
            if renderer.aperture_path
            else None
        )
        gap = (
            ApertureTexture.load(renderer.ghost_aperture_path)
            if renderer.ghost_aperture_path
            else None
        )
        return cls(
            width=renderer.width,
            height=renderer.height,
            flare_origins=origins,
            flare_radiances=radiances,
            axis_ray=axis_ray,
            angle_to_sun=angle,
            aperture=ap,
            ghost_aperture=gap,
            lens=reference_prescription(),
            flare_intensity=renderer.flare_intensity,
            flare_radius=renderer.flare_radius,
            falloff_key=renderer.seed,
            ghost_scale=getattr(renderer, "flare_ghost_scale", 1),
            lens_model=getattr(renderer, "lens_model", "paraxial"),
        )

    # ------------------------------------------------------------------

    def ghost_buffer(self) -> jnp.ndarray:
        """(H, W, 3) additive ghost buffer (generate_ghost_buffer)."""
        if (self.axis_ray == 0).all():
            return jnp.zeros((self.height, self.width, 3))
        if self.lens_model == "realistic":
            # physically-based upgrade path: ghost energy comes from the
            # Fresnel products of the sequential stack trace, no texture
            from ..lens.realistic import render_ghosts_stack

            return render_ghosts_stack(
                self.lens,
                jnp.float32(self.angle_to_sun),
                jnp.asarray(self.flare_radiances.sum(axis=0)),
                jnp.asarray(self.axis_ray, jnp.float32),
                self.width,
                self.height,
            )
        if self.ghost_aperture is None or self.ghost_aperture.total_value == 0:
            return jnp.zeros((self.height, self.width, 3))
        method = self.ghost_method
        if method == "auto":
            method = "fast" if self.width * self.height >= (1 << 18) else "exact"
        return _ghost_buffer_impl(
            self.lens,
            jnp.float32(self.angle_to_sun),
            jnp.asarray(self.ghost_aperture.values),
            jnp.asarray(self.axis_ray, jnp.float32),
            self.width,
            self.height,
            method,
            self.ghost_scale,
        )

    def starburst(self) -> jnp.ndarray:
        """(H, W, 3) starburst field (raytrace_starburst minus falloff)."""
        if (
            self.aperture is None
            or self.aperture.total_value == 0
            or len(self.flare_origins) == 0
        ):
            return jnp.zeros((self.height, self.width, 3))
        fft_mag = self._fft_cache
        if fft_mag is None:
            fft_mag = aperture_fft(jnp.asarray(self.aperture.values))
            # cache only concrete arrays: when starburst() is itself traced
            # (e.g. a jitted composite), storing the traced FFT would leak
            # the tracer out of the transformation
            if not isinstance(fft_mag, jax.core.Tracer):
                object.__setattr__(self, "_fft_cache", fft_mag)
        return starburst_field(
            fft_mag,
            jnp.float32(self.aperture.total_value),
            self.aperture.width,
            jnp.asarray(self.flare_origins[0]),
            jnp.asarray(self.flare_radiances.sum(axis=0)),
            self.width,
            self.height,
            flare_intensity=self.flare_intensity,
            flare_radius=self.flare_radius,
        )

    def falloff(self) -> jnp.ndarray:
        if len(self.flare_origins) == 0:
            return jnp.zeros((self.height, self.width, 3))
        return irradiance_falloff(
            jnp.asarray(self.flare_origins),
            jnp.asarray(self.flare_radiances),
            self.width,
            self.height,
            jax.random.PRNGKey(self.falloff_key),
        )

    def composite(self, hdr: jnp.ndarray) -> jnp.ndarray:
        """film + ghost + starburst + falloff (pathtracer.cpp:891)."""
        return hdr + self.ghost_buffer() + self.starburst() + self.falloff()
