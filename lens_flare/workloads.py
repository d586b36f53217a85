"""Named render configurations built from in-repo procedural assets."""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np


def terrain_1080p(out_dir, seed: int = 0, n_quads: int = 512, width: int = 1920,
                  height: int = 1080, **renderer_kw):
    """The dragon-class frame: a loaded ``Renderer`` for the procedural terrain.

    ``make_terrain_scene(n_quads)`` (2 * 512^2 = 524,288 triangles, sun +
    point fill) at 1920x1080, 1 spp, depth 4 with NEE and Russian-roulette
    indirect, and the full flare composite: paraxial ghosts through a
    128x128 pentagon, the FFT starburst of a 512x512 five-blade aperture
    with dust, and the falloff glow.  Both apertures are drawn from ``seed``
    and written as PNGs into ``out_dir``, so the renderer reads them back
    through the PNG loader.  ``renderer_kw`` overrides Renderer fields
    (e.g. ``devices``).  Prints the load + BVH build time.
    """
    from .lens.aperture import blade_aperture
    from .renderer import Renderer
    from .scene.procedural import make_terrain_scene
    from .utils.image import write_png

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    star = out_dir / "aperture_starburst.png"
    ghost = out_dir / "aperture_ghost.png"
    write_png(star, np.round(blade_aperture(512, 5, dust=12, seed=seed) * 255).astype(np.uint8))
    write_png(ghost, np.round(blade_aperture(128, 5, seed=seed + 1) * 255).astype(np.uint8))
    kw = dict(
        width=width, height=height, ns_aa=1, max_ray_depth=4, ns_area_light=1,
        indirect=True, seed=seed, aperture_path=str(star),
        ghost_aperture_path=str(ghost), flare_intensity=1.5, flare_radius=30.0,
    )
    kw.update(renderer_kw)
    r = Renderer(**kw)
    t0 = time.perf_counter()
    r.load_flat_scene(make_terrain_scene(n_quads, seed=seed))
    print(
        f"  scene: {r.scene.num_triangles} triangles, load + BVH build "
        f"{time.perf_counter() - t0:.3f} s", flush=True,
    )
    return r
