"""Render controller: scene setup, tiled jit rendering, file output.

Wavefront replacement for ``RaytracedRenderer`` (``src/pathtracer/
raytraced_renderer.cpp``): the thread pool + 32x32 tile work queue
(``util/work_queue.h``) becomes a jit-compiled wavefront over pixel tiles —
one device launch per tile batch, with the tile size chosen to keep the
wavefront wide.  State machine, counters and image outputs mirror the
reference's (Mrays/s printout, sampling-rate heatmap, cell render).
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from .accel import build_bvh
from .integrator.lights import lights_to_device
from .integrator.path import (
    RenderSettings,
    SceneBundle,
    make_settings,
    render_batch,
    render_wavefront,
)
from .integrator.shading import bsdf_to_device
from .ops import scene_to_device
from .scene.build import FlatScene, load_scene
from .scene.camera import Camera, place_from_scene_info
from .utils import image as img


_render_jit = jax.jit(render_wavefront, static_argnums=(1, 5, 6))  # settings, w, h
_batch_jit = jax.jit(render_batch, static_argnums=(1, 5, 6, 9))  # + n_samples


@dataclass
class RenderStats:
    wall_time: float = 0.0
    bvh_build_time: float = 0.0
    total_rays: int = 0  # measured on device (live wavefront lanes)
    total_isects: int = 0  # measured primitive intersection tests
    # NEE lanes skipped because their contribution is provably zero
    # (miss / delta-BSDF / emitter shading points) — counted on device;
    # rounds 1-2 traced these, so total_rays + total_zero_skipped is the
    # series-comparable workload count
    total_zero_skipped: int = 0
    mrays_per_s: float = 0.0
    isects_per_ray: float = 0.0


@dataclass
class Renderer:
    """Offline renderer (OfflineRenderer interface analogue, renderer.h:14-100)."""

    width: int = 800
    height: int = 600
    ns_aa: int = 1
    max_ray_depth: int = 1
    ns_area_light: int = 1
    samples_per_batch: int = 64
    max_tolerance: float = 0.05
    direct_hemisphere_sample: bool = False
    indirect: bool = True
    lens_radius: float = 0.0
    focal_distance: float = 0.0
    envmap: np.ndarray | None = None
    aperture_path: str | None = None
    ghost_aperture_path: str | None = None
    bokeh_path: str | None = None  # aperture-shaped DoF mask (config 2)
    flare_intensity: float = 0.0
    flare_radius: float = 0.0
    flare_ghost_scale: int = 1  # >1: subsampled ghost buffer (speed)
    lens_model: str = "paraxial"  # "realistic": sequential Snell+Fresnel stack
    camera_settings: str | None = None
    bvh_method: str = "sah"
    tile_pixels: int = 1 << 16  # wavefront width per launch
    seed: int = 0
    # rendering devices: 1 = single device, 0 = all available, N = first N.
    # >1 shards every pixel wavefront over a 1-D jax.sharding.Mesh with the
    # scene replicated (the product wiring of parallel/: the reference's -t
    # actually drove its worker pool, main.cpp:106-108).  RNG is a pure
    # function of (pixel id, sample index), so the sharded render is
    # bit-identical to the single-device one (tests/test_sharding.py).
    devices: int = 1

    # populated by set_scene/set_camera
    scene: FlatScene = None
    camera: Camera = None
    bundle: SceneBundle = None
    settings: RenderSettings = None
    stats: RenderStats = field(default_factory=RenderStats)

    def load(self, dae_path) -> None:
        scene, info = load_scene(dae_path)
        self.scene = scene
        self.camera = Camera()
        self.camera.configure(info.camera, self.width, self.height)
        place_from_scene_info(self.camera, info, scene.bbox_min, scene.bbox_max)
        if self.camera_settings:
            # reference parity (main.cpp:192-194 after resize at 187-189):
            # the settings file restores intrinsics + pose, but the frame
            # size stays the -r request — the file's screenW/H are NOT
            # adopted (Camera::load_settings overwrites the camera's copy,
            # the renderer buffer keeps its own)
            self.camera.load_settings(self.camera_settings)
            self.camera.screen_w, self.camera.screen_h = self.width, self.height
        self.camera.lens_radius = self.lens_radius
        self.camera.focal_distance = self.focal_distance
        self._build()

    def load_flat_scene(self, scene: FlatScene, camera: Camera | None = None) -> None:
        """Use an already-built FlatScene (procedural scenes, tests)."""
        self.scene = scene
        if camera is not None:
            self.camera = camera
        elif self.camera is None:
            import math

            self.camera = Camera()
            center = (scene.bbox_min + scene.bbox_max) / 2
            extent = np.linalg.norm(scene.bbox_max - scene.bbox_min)
            self.camera.place(center, math.pi / 3, math.pi / 4, extent, extent / 10, extent * 10)
            self.camera.screen_w, self.camera.screen_h = self.width, self.height
        self.camera.lens_radius = self.lens_radius
        self.camera.focal_distance = self.focal_distance
        self._build()

    def set_frame_size(self, width: int, height: int) -> None:
        self.width, self.height = width, height
        if self.camera is not None:
            self.camera.set_screen_size(width, height)

    def _build(self) -> None:
        t0 = time.perf_counter()
        lo, hi = self.scene.primitive_bboxes()
        bvh = build_bvh(lo, hi, method=self.bvh_method)
        self.stats.bvh_build_time = time.perf_counter() - t0

        env = None
        lt = self.scene.lights
        if self.envmap is not None:
            import copy

            from .integrator.envlight import build_env
            from .integrator.lights import LT_ENV

            env = build_env(self.envmap)
            # envLight participates in NEE (raytraced_renderer.cpp:127-128).
            # Extend a COPY: mutating scene.lights in place would duplicate
            # the env row on a second _build() (e.g. after set_frame_size)
            # and skew NEE normalization.
            lt = copy.deepcopy(lt)
            lt.light_type = np.append(lt.light_type, LT_ENV).astype(np.int32)
            lt.radiance = np.vstack([lt.radiance, np.zeros(3, np.float32)])
            lt.position = np.vstack([lt.position, np.zeros(3, np.float32)])
            lt.direction = np.vstack([lt.direction, np.zeros(3, np.float32)])
            lt.dim_x = np.vstack([lt.dim_x, np.zeros(3, np.float32)])
            lt.dim_y = np.vstack([lt.dim_y, np.zeros(3, np.float32)])
            lt.area = np.append(lt.area, 0.0).astype(np.float32)
            lt.is_delta = np.append(lt.is_delta, False)

        bokeh = None
        if self.bokeh_path and self.lens_radius > 0:
            from .integrator.path import BokehMask
            from .lens.aperture import ApertureTexture

            bokeh = BokehMask.from_texture(ApertureTexture.load(self.bokeh_path).values)

        self.bundle = SceneBundle(
            scene=scene_to_device(self.scene, bvh),
            bsdfs=bsdf_to_device(self.scene.bsdfs),
            lights=lights_to_device(lt),
            env=env,
            bokeh=bokeh,
        )
        self._light_table = lt  # kept for update_settings()
        self._mesh = None
        n_dev = len(jax.devices()) if self.devices == 0 else min(self.devices, len(jax.devices()))
        if n_dev > 1:
            from .parallel.mesh import make_mesh, replicate

            self._mesh = make_mesh(n_dev)
            # replicate the scene once per build, not per tile launch
            self.bundle = jax.device_put(self.bundle, replicate(self._mesh))
            # every wavefront launch must divide evenly across the mesh
            self.tile_pixels = -(-self.tile_pixels // n_dev) * n_dev
        self.update_settings()

    def update_settings(self) -> None:
        """Rebuild the static RenderSettings from the current knobs.

        Cheap (host-only); used by the interactive Application when keys
        change spp/depth/light-sample counts between progressive renders
        (RaytracedRenderer::key_press semantics) without re-building the
        scene or BVH.
        """
        # Morton-origin bounce sorting stays OFF here: the Renderer feeds
        # wavefronts in 32x32 pixel blocks whose origins are already
        # coherent (RenderSettings.sort_bounces).
        self.settings = make_settings(
            self._light_table,
            bsdf_table=self.scene.bsdfs,
            ns_aa=self.ns_aa,
            max_ray_depth=self.max_ray_depth,
            ns_area_light=self.ns_area_light,
            samples_per_batch=self.samples_per_batch,
            max_tolerance=self.max_tolerance,
            direct_hemisphere_sample=self.direct_hemisphere_sample,
            indirect=self.indirect,
            use_thin_lens=self.lens_radius > 0,
        )

    # ------------------------------------------------------------------

    def _checkpoint_fingerprint(self, cell) -> str:
        """Identity of a render for checkpoint resume purposes.

        A checkpoint is only resumable into a render of the SAME scene,
        camera pose, film size, cell, seed and sampling plan — a stale file
        from a different render must be rejected, not silently merged into
        the film.  Hash of everything that changes the per-pixel estimate.
        """
        import hashlib

        cam = self.camera.params() if self.camera is not None else None
        parts = [
            self.seed, self.width, self.height, cell, self.ns_aa,
            self.samples_per_batch, self.max_tolerance, self.max_ray_depth,
            self.ns_area_light, self.direct_hemisphere_sample, self.indirect,
            self.lens_radius, self.focal_distance,
            self.scene.num_triangles, self.scene.num_spheres,
        ]
        h = hashlib.sha256(repr(parts).encode())
        if cam is not None:
            for leaf in jax.tree_util.tree_leaves(cam):
                h.update(np.asarray(leaf).tobytes())
        h.update(np.asarray(self.scene.bbox_min).tobytes())
        h.update(np.asarray(self.scene.bbox_max).tobytes())
        # scene CONTENT, not just geometry extents: a light-radiance or
        # material retune with identical geometry changes every pixel's
        # estimate, and an old checkpoint must not resume into it
        if self.bundle is not None:
            for group in (self.bundle.lights, self.bundle.bsdfs):
                for leaf in jax.tree_util.tree_leaves(group):
                    h.update(np.asarray(leaf).tobytes())
            if self.bundle.env is not None:
                h.update(np.asarray(self.bundle.env.data).tobytes())
        return h.hexdigest()

    @staticmethod
    def _atomic_savez(path, **arrays) -> None:
        """Crash-safe checkpoint write: temp file + os.replace.

        A plain np.savez over the previous checkpoint leaves a corrupt,
        unresumable file if the process dies mid-write — the failure the
        checkpoint exists to survive.
        """
        import os

        # np.savez appends .npz when the name lacks it — keep the suffix on
        # the temp name so the file lands where os.replace expects it
        tmp = str(path) + ".tmp.npz"
        np.savez(tmp, **arrays)
        os.replace(tmp, path)

    @staticmethod
    def _load_checkpoint(path):
        """np.load that treats an unreadable/corrupt checkpoint as absent."""
        try:
            return np.load(path)
        except Exception as e:  # truncated zip, bad magic, ...
            print(f"[PathTracer] ignoring unreadable checkpoint {path}: {e}")
            return None

    def _mesh_context(self):
        """The render mesh as JAX's context mesh (a no-op single-device).

        Under it the traversal runs under ``shard_map`` over the batch axis
        (ops.traverse), so each device traces only its own lanes.
        """
        if self._mesh is None:
            return contextlib.nullcontext()
        return jax.set_mesh(self._mesh)

    def _shard_input(self, arr):
        """Place a wavefront array on the mesh batch axis (no-op single-device)."""
        if self._mesh is None:
            return arr
        from .parallel.mesh import shard_batch

        return jax.device_put(arr, shard_batch(self._mesh))

    def render(self, cell=None, progress: bool = True, checkpoint_path=None):
        """Render the film (or a subwindow ``cell=(x, y, dx, dy)``).

        Returns (hdr (H, W, 3) float32, sample_counts (H, W) int32).

        ``checkpoint_path``: if given, per-tile progress is persisted there
        (film + counts + cursor) and an interrupted render resumes from the
        last completed tile — the elastic-recovery subsystem the reference
        lacks (SURVEY.md §5.3-5.4).
        """
        w, h = self.width, self.height
        if cell is None:
            x0, y0, dx, dy = 0, 0, w, h
        else:
            x0, y0, dx, dy = cell

        cam_params = self.camera.params()
        key = jax.random.PRNGKey(self.seed)

        # module-level jit (settings/size static): the trace + compile is
        # cached across render() calls and Renderer instances — a fresh
        # jax.jit(lambda ...) per call re-traced the whole program each time.
        # With a mesh active, wavefront inputs are sharded over the batch
        # axis (scene already replicated in _build): GSPMD turns the stats
        # sum into a psum and each device traces its own pixel slice.
        shard_in = self._shard_input
        def render_fn(px, py, valid):
            with self._mesh_context():
                return _render_jit(
                    self.bundle, self.settings, cam_params,
                    shard_in(px), shard_in(py), w, h, key, shard_in(valid),
                )

        ys, xs = np.mgrid[y0 : y0 + dy, x0 : x0 + dx]
        xs = xs.ravel()
        ys = ys.ravel()
        # block-linearize pixels into 32x32 tiles (the reference's tile size,
        # raytraced_renderer.cpp imageTileSize): neighbouring lanes trace
        # coherent rays, so a warp walks similar BVH nodes
        bs = 32
        order = np.argsort(
            ((ys // bs) * ((w + bs - 1) // bs) + (xs // bs)) * bs * bs
            + (ys % bs) * bs
            + (xs % bs),
            kind="stable",
        )
        xs = xs[order]
        ys = ys[order]
        n_px = len(xs)

        film = np.zeros((h, w, 3), np.float32)
        counts = np.zeros((h, w), np.int32)
        # [rays, isect tests, skipped provably-zero NEE rays], measured
        total_stats = np.zeros(3, np.float64)

        tile = self.tile_pixels
        t_start = time.perf_counter()
        n_tiles = -(-n_px // tile)

        fp = self._checkpoint_fingerprint(cell)
        start_tile = 0
        ck = (
            self._load_checkpoint(checkpoint_path)
            if checkpoint_path is not None and Path(checkpoint_path).exists()
            else None
        )
        if ck is not None:
            # "next_tile" marks the tiled/completed format; adaptive renders
            # persist per-STAGE state instead (resumed in _adaptive_render)
            if (
                "next_tile" in ck
                and int(ck["n_tiles"]) == n_tiles
                and ck["film"].shape == film.shape
                and ("fp" in ck and str(ck["fp"]) == fp)
            ):
                film = ck["film"]
                counts = ck["counts"]
                start_tile = int(ck["next_tile"])
                if progress:
                    print(f"[PathTracer] resuming at tile {start_tile}/{n_tiles}")

        # host-repacked adaptive sampling: converged pixels leave the
        # wavefront between batches, so `-a` saves device time instead of
        # merely masking statistics (the reference stops per-pixel work at
        # pathtracer.cpp:862-868; here whole lanes are compacted away)
        adaptive = (
            self.ns_aa > self.settings.samples_per_batch and self.max_tolerance > 0
        )
        n_dev = 1 if self._mesh is None else self._mesh.devices.size
        if adaptive:
            if start_tile < n_tiles:  # not already complete from a checkpoint
                rad, cnt, st = self._adaptive_render(
                    cam_params, key, xs, ys, progress,
                    checkpoint_path=checkpoint_path, fp=fp,
                )
                total_stats += st
                film[ys, xs] = rad
                counts[ys, xs] = cnt
                if checkpoint_path is not None:
                    self._atomic_savez(checkpoint_path, film=film, counts=counts, next_tile=n_tiles, n_tiles=n_tiles, fp=fp)
        else:
            for ti in range(start_tile, n_tiles):
                sl = slice(ti * tile, min((ti + 1) * tile, n_px))
                px = xs[sl]
                py = ys[sl]
                m = len(px)
                # pad to the common tile shape (avoids recompilation) or, for
                # the lone-tile case, to a device-divisible length; padded
                # lanes carry valid=False so they trace nothing and never
                # enter the measured ray/isect counters
                need = tile if n_tiles > 1 else -(-m // n_dev) * n_dev
                pad = need - m
                if pad:
                    px = np.pad(px, (0, pad), mode="edge")
                    py = np.pad(py, (0, pad), mode="edge")
                valid = np.arange(need) < m
                rad, cnt, st = render_fn(
                    jnp.asarray(px), jnp.asarray(py), jnp.asarray(valid)
                )
                rad = np.asarray(rad)[:m]
                cnt = np.asarray(cnt)[:m]
                total_stats += np.asarray(st, np.float64)
                film[ys[sl], xs[sl]] = rad
                counts[ys[sl], xs[sl]] = cnt
                if checkpoint_path is not None:
                    self._atomic_savez(checkpoint_path, film=film, counts=counts, next_tile=ti + 1, n_tiles=n_tiles, fp=fp)
                if progress:
                    print(f"\r[PathTracer] Rendering... {100 * (ti + 1) // n_tiles}%", end="", flush=True)

        self.stats.wall_time = time.perf_counter() - t_start
        # measured on device (raytraced_renderer.cpp:707-709 parity): live
        # wavefront lanes and primitive tests counted inside the kernels
        self.stats.total_rays = int(total_stats[0])
        self.stats.total_isects = int(total_stats[1])
        self.stats.total_zero_skipped = int(total_stats[2])
        self.stats.mrays_per_s = self.stats.total_rays / max(self.stats.wall_time, 1e-9) / 1e6
        self.stats.isects_per_ray = self.stats.total_isects / max(self.stats.total_rays, 1)
        if progress:
            print(
                f"\n[PathTracer] Rendering complete: {self.stats.wall_time:.4f} sec\n"
                f"[PathTracer] Rays traced: {self.stats.total_rays} "
                f"({self.stats.mrays_per_s:.2f} Mrays/s)\n"
                f"[PathTracer] Intersection tests per ray: "
                f"{self.stats.isects_per_ray:.2f}"
            )
        return film, counts

    def _adaptive_render(self, cam_params, key, xs, ys, progress, checkpoint_path=None, fp=""):
        """Adaptive sampling with host re-packing (pathtracer.cpp:862-868).

        Stage-major pipelined: within a stage every tile's batch is
        dispatched asynchronously before any result is read back, so the
        device pipelines tile launches and the host pays one round trip
        per *stage* instead of one per (tile, stage).  At stage boundaries
        converged pixels leave the wavefront (95% CI test) and the global
        active set is re-packed into fresh tiles, so ``-a`` saves device
        time instead of merely masking statistics.  RNG is a pure function
        of (pixel id, sample index), so compaction reproduces the lockstep
        estimator sample-for-sample.

        ``checkpoint_path``: accumulators + the active set are persisted at
        every stage boundary, so a crash at 90% of a long adaptive render
        resumes from the last completed stage instead of losing everything.
        """
        spb = min(self.samples_per_batch, self.ns_aa)
        # geometric batch schedule (spb, spb, 2spb, 4spb, ...): each stage
        # boundary costs a host<->device sync, so sync log-many times
        # instead of ns_aa/spb times — the CI test still runs at every
        # boundary, it just covers bigger strides
        schedule = []
        done = 0
        step = spb
        while done < self.ns_aa:
            ns = min(step, self.ns_aa - done)
            schedule.append(ns)
            done += ns
            if len(schedule) >= 2:
                step *= 2

        n = len(xs)
        film = np.zeros((n, 3), np.float32)
        s1 = np.zeros(n, np.float64)
        s2 = np.zeros(n, np.float64)
        count = np.zeros(n, np.int32)
        stats = np.zeros(3, np.float64)
        active = np.arange(n)
        tile = self.tile_pixels
        n_dev = 1 if self._mesh is None else self._mesh.devices.size
        shard_in = self._shard_input

        start_stage = 0
        s_done = 0
        ck = (
            self._load_checkpoint(checkpoint_path)
            if checkpoint_path is not None and Path(checkpoint_path).exists()
            else None
        )
        if ck is not None:
            if (
                "stage" in ck
                and int(ck["n"]) == n
                and int(ck["ns_aa"]) == self.ns_aa
                # spb defines the stage schedule AND the RNG sample offsets;
                # resuming under a different -a batch size would misalign both
                and ("spb" in ck and int(ck["spb"]) == spb)
                and ("fp" in ck and str(ck["fp"]) == fp)
            ):
                film, s1, s2 = ck["film"], ck["s1"], ck["s2"]
                count, active = ck["count"], ck["active"]
                stats = ck["stats"]
                start_stage = int(ck["stage"])
                s_done = int(ck["s_done"])
                if progress:
                    print(
                        f"[PathTracer] resuming adaptive render at stage "
                        f"{start_stage}/{len(schedule)} ({len(active)} px active)"
                    )

        for si, ns in enumerate(schedule):
            if si < start_stage:
                continue
            if len(active) == 0:
                break
            # dispatch every chunk of the active set before reading any
            # result back; the trailing chunk is padded to a coarse grid of
            # shapes (few enough to bound compiles, fine enough not to
            # waste lanes).  Padded lanes are valid=False: no work, no
            # counter contribution.
            grain = 8192 if tile > 16384 else 256
            grain = -(-grain // n_dev) * n_dev
            launches = []
            for i in range(0, len(active), tile):
                idx = active[i : i + tile]
                m = len(idx)
                bucket = max(min(-(-m // grain) * grain, tile), -(-m // n_dev) * n_dev)
                pa = xs[idx]
                ya = ys[idx]
                if bucket > m:
                    pa = np.pad(pa, (0, bucket - m), mode="edge")
                    ya = np.pad(ya, (0, bucket - m), mode="edge")
                valid = np.arange(bucket) < m
                with self._mesh_context():
                    out = _batch_jit(
                        self.bundle, self.settings, cam_params,
                        shard_in(jnp.asarray(pa)), shard_in(jnp.asarray(ya)),
                        self.width, self.height, key, jnp.uint32(s_done), ns,
                        shard_in(jnp.asarray(valid)),
                    )
                launches.append((idx, out))
            s_done += ns

            for idx, (f, a1, a2, st) in launches:
                m = len(idx)
                stats += np.asarray(st, np.float64)
                film[idx] += np.asarray(f)[:m]
                s1[idx] += np.asarray(a1, np.float64)[:m]
                s2[idx] += np.asarray(a2, np.float64)[:m]
                count[idx] += ns

            # 95% CI early-stop over the whole active set, then re-pack
            nc = np.maximum(count[active], 2).astype(np.float64)
            var = np.maximum(s2[active] - s1[active] ** 2 / nc, 0.0) / (nc - 1.0)
            ci = 1.96 * np.sqrt(var / nc)
            active = active[ci > self.max_tolerance * s1[active] / nc]
            if checkpoint_path is not None:
                self._atomic_savez(
                    checkpoint_path,
                    stage=si + 1, s_done=s_done, n=n, ns_aa=self.ns_aa, spb=spb, fp=fp,
                    film=film, s1=s1, s2=s2, count=count, active=active,
                    stats=stats,
                )
            if progress:
                print(
                    f"\r[PathTracer] Rendering... {100 * s_done // self.ns_aa}%"
                    f" ({len(active)} px active)",
                    end="",
                    flush=True,
                )

        rad = film / np.maximum(count, 1)[:, None]
        return rad, count, stats

    def render_to_file(self, filename, cell=None) -> np.ndarray:
        hdr, counts = self.render(cell=cell)
        hdr = self.composite_flare(hdr)
        # film is bottom-up (see save_hdr_png docstring): flip on save like
        # the reference's save_image / save_sampling_rate
        img.save_hdr_png(filename, hdr, flip_y=True)
        rate_path = Path(filename)
        rate_path = rate_path.with_name(rate_path.stem + "_rate.png")
        img.save_png(
            rate_path,
            img.sampling_rate_heatmap(counts, max(self.ns_aa, 1))[::-1],
        )
        print(f"[PathTracer] saved to {filename}")
        return hdr

    def autofocus(self, x: float, y: float) -> float:
        """Set focalDistance to the hit depth under pixel (x, y) (pathtracer.cpp:1065-1072)."""
        import jax.numpy as jnp

        from .integrator.path import trace_closest
        from .scene.camera import generate_rays

        cam = self.camera.params()
        o, d = generate_rays(
            cam,
            jnp.asarray([x / self.width], jnp.float32),
            jnp.asarray([y / self.height], jnp.float32),
        )
        hit, _ = trace_closest(
            self.bundle,
            o,
            d,
            jnp.asarray([self.camera.n_clip], jnp.float32),
            jnp.asarray([self.camera.f_clip], jnp.float32),
        )
        self.focal_distance = float(hit.t[0])
        self.camera.focal_distance = self.focal_distance
        return self.focal_distance

    def composite_flare(self, hdr: np.ndarray) -> np.ndarray:
        """Add ghost buffer + starburst + falloff if a flare is configured."""
        if (
            self.aperture_path is None
            and self.ghost_aperture_path is None
            and self.lens_model != "realistic"
        ):
            return hdr
        from .flare.pipeline import FlarePipeline

        pipeline = FlarePipeline.from_renderer(self)
        if pipeline is None:
            return hdr
        return np.asarray(pipeline.composite(jnp.asarray(hdr)))
