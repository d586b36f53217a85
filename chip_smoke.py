"""GPU smoke test: the path tracer and the lens-flare pipeline on CUDA devices.

Drives the main path once at full size and checks it against the plain
references.  Exits non-zero, and prints no result, when JAX finds no GPU or
any phase fails.

    python chip_smoke.py                # phases a-c on one GPU
    python chip_smoke.py --four-cards   # phase d only, on four GPUs

a  traversal parity on the 524,288-triangle terrain: the CUDA kernel against
   the XLA traversal on 65,536-lane primary, bounce and shadow wavefronts,
   and a 4,096-lane subset against the NumPy oracle
b  main path: terrain_1080p (1920x1080, 1 spp, depth 4, NEE + Russian
   roulette, 39 paraxial ghosts + FFT starburst + falloff) through
   Renderer.load_flat_scene and render_to_file, with apertures drawn from
   the seed and read back from PNG
c  differentiable step: jax.grad of a pixel loss through render_wavefront
   and one lens train step (parallel.render.make_train_step), each against
   a central finite difference
d  Renderer(devices=4) against devices=1 on terrain_1080p, and the sharded
   train step of __graft_entry__.dryrun_multichip

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT))

# full size; a CPU rehearsal may shrink these (and set KERNEL = "xla")
N_QUADS = 512  # 2 * 512^2 = 524,288 triangles
WIDTH, HEIGHT = 1920, 1080
LANES = 65536
ORACLE_LANES = 4096
KERNEL = "cuda"
# CUDA kernel vs XLA traversal: same algorithm in float32, and the kernel
# is built without FMA contraction, so the two agree to the last bit on
# almost every lane; a division rounded differently may still move a hit
# that grazes a shared edge onto the neighbouring triangle
KERNEL_PRIM_AGREE = 0.9999  # fraction of lanes with the same primitive
KERNEL_T_RTOL = 1e-5  # |t - t_xla| / t where both hit
# float32 traversal vs the float64 oracle
ORACLE_MISMATCH = 0.001  # fraction of lanes whose hit mask or t differs
ORACLE_T_RTOL = 1e-4
ORACLE_PRIM_AGREE = 0.995  # ties on shared edges pick either triangle
FD_RTOL = 2e-2  # tests/test_diff_render.py
# tests/test_ghost_fast.py holds the fast splat to 2% and the exact
# rasterizer to 6% of the analytic energy, so they may differ by 8%
GHOST_ENERGY_RTOL = 8e-2
GHOST_LOWFREQ = 0.15  # tests/test_ghost_fast.py
SHARD_RTOL, SHARD_ATOL = 1e-5, 1e-6  # 4-device film vs 1-device film


class SmokeFailure(AssertionError):
    pass


def check(ok: bool, what: str) -> None:
    print(f"  [{'ok' if ok else 'FAIL'}] {what}", flush=True)
    if not ok:
        raise SmokeFailure(what)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def timed(fn, *args, reps: int = 5) -> float:
    """Median seconds of ``fn(*args)`` after one warm-up, to block_until_ready."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def terrain_renderer(out_dir: Path, seed: int, **kw):
    from lens_flare.workloads import terrain_1080p

    return terrain_1080p(out_dir, seed, n_quads=N_QUADS, width=WIDTH, height=HEIGHT, **kw)


# ---------------------------------------------------------------------------
# a: traversal parity
# ---------------------------------------------------------------------------


def wavefronts(r, rng):
    """65,536-lane primary, random-bounce and shadow wavefronts on the frame."""
    import jax
    import jax.numpy as jnp

    from lens_flare.ops.traverse import traverse
    from lens_flare.scene.camera import generate_rays

    cam = r.camera.params()
    x = rng.uniform(0, 1, LANES).astype(np.float32)
    y = rng.uniform(0, 1, LANES).astype(np.float32)
    o, d = generate_rays(cam, jnp.asarray(x), jnp.asarray(y))
    o, d = np.asarray(o), np.asarray(d)
    lo = np.full(LANES, r.camera.n_clip, np.float32)
    hi = np.full(LANES, r.camera.f_clip, np.float32)
    primary = (o, d, lo, hi)

    # shading points from the primary hits (XLA, a reference both sides share)
    xla = jax.jit(lambda sc, *rays: traverse(sc, *rays, impl="xla"))
    t, prim, _, _, found, _ = (np.asarray(v) for v in xla(r.bundle.scene, o, d, lo, hi))
    p = o + d * np.where(found, t, 0.0)[:, None]
    e1 = np.asarray(r.bundle.scene.tri_e1)[np.maximum(prim, 0)]
    e2 = np.asarray(r.bundle.scene.tri_e2)[np.maximum(prim, 0)]
    n = np.cross(e1, e2)
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-30)
    n *= -np.sign(np.sum(n * d, axis=1, keepdims=True))
    p_off = (p + n * 1e-4 * np.maximum(1.0, np.abs(p).max(axis=1, keepdims=True))).astype(np.float32)

    w = rng.normal(size=(LANES, 3))
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    w *= np.sign(np.sum(w * n, axis=1, keepdims=True))
    b_hi = np.where(found, 1e30, 0.0).astype(np.float32)
    bounce = (p_off, w.astype(np.float32), np.full(LANES, 1e-5, np.float32), b_hi)

    lights = r.scene.lights
    sun = lights.direction[0] / np.linalg.norm(lights.direction[0])
    to_pt = lights.position[1][None] - p_off
    dist = np.linalg.norm(to_pt, axis=1)
    half = np.arange(LANES) < LANES // 2
    s_d = np.where(half[:, None], sun[None], to_pt / dist[:, None]).astype(np.float32)
    s_hi = np.where(half, 1e30, dist * (1 - 1e-3) - 1e-5)
    s_hi = np.where(found, s_hi, 0.0).astype(np.float32)
    shadow = (p_off, s_d, np.full(LANES, 1e-5, np.float32), s_hi)
    return {"primary": primary, "bounce": bounce, "shadow": shadow}


def phase_traversal(r, rng) -> None:
    import jax

    from lens_flare.ops.traverse import traverse
    from lens_flare.oracle.tracer import closest_hits

    scene = r.bundle.scene
    waves = wavefronts(r, rng)
    print(
        f"  tolerances: kernel vs XLA prim agreement >= {KERNEL_PRIM_AGREE}, "
        f"t rtol {KERNEL_T_RTOL}, tests and occlusion identical; vs oracle "
        f"mismatches <= {ORACLE_MISMATCH}, t rtol {ORACLE_T_RTOL}, prim "
        f"agreement >= {ORACLE_PRIM_AGREE}", flush=True,
    )
    fns = {
        (impl, any_hit): jax.jit(
            lambda sc, o, d, lo, hi, impl=impl, any_hit=any_hit: traverse(
                sc, o, d, lo, hi, any_hit=any_hit, impl=impl
            )
        )
        for impl in (KERNEL, "xla")
        for any_hit in (False, True)
    }
    picks = np.array_split(rng.permutation(LANES)[:ORACLE_LANES], 3)
    for (name, rays), pick in zip(waves.items(), picks):
        any_hit = name == "shadow"
        k = [np.asarray(v) for v in fns[KERNEL, any_hit](scene, *rays)]
        x = [np.asarray(v) for v in fns["xla", any_hit](scene, *rays)]
        live = int((rays[3] > 0).sum())
        print(f"  {name}: {LANES} lanes, {live} live, {int(x[4].sum())} hits (XLA)", flush=True)
        if any_hit:
            check(np.array_equal(k[4], x[4]), f"{name}: occlusion masks identical")
        else:
            same = float(np.mean(k[1] == x[1]))
            both = k[4] & x[4]
            rel = np.abs(k[0] - x[0]) / np.maximum(np.abs(x[0]), 1e-30)
            worst = float(rel[both].max()) if both.any() else 0.0
            check(same >= KERNEL_PRIM_AGREE, f"{name}: prim agreement {same:.6f}")
            check(worst <= KERNEL_T_RTOL, f"{name}: max t rel err {worst:.2e} where both hit")
        n_diff = int((k[5] != x[5]).sum())
        check(n_diff == 0, f"{name}: tests identical ({int(k[5].sum())} total, {n_diff} lanes differ)")

        sub = [np.asarray(v)[pick] for v in rays]
        ref = closest_hits(r.scene, *sub)
        kh = k[4][pick]
        rel = np.abs(k[0][pick] - ref["t"]) / np.maximum(np.abs(ref["t"]), 1e-30)
        if any_hit:
            bad = int((kh != ref["hit"]).sum())
        else:
            bad = int(((kh != ref["hit"]) | (kh & ref["hit"] & (rel > ORACLE_T_RTOL))).sum())
        check(bad <= ORACLE_MISMATCH * len(pick), f"{name}: {bad} of {len(pick)} lanes differ from the oracle")
        if not any_hit:
            both = kh & ref["hit"]
            agree = float(np.mean(k[1][pick][both] == ref["prim"][both])) if both.any() else 1.0
            check(agree >= ORACLE_PRIM_AGREE, f"{name}: oracle prim agreement {agree:.4f}")

        times = {}
        for impl in (KERNEL, "xla"):
            times[impl] = timed(fns[impl, any_hit], scene, *rays)
        print(
            f"  {name}: kernel {times[KERNEL] * 1e3:.3f} ms, XLA "
            f"{times['xla'] * 1e3:.3f} ms per {LANES}-lane wavefront", flush=True,
        )


# ---------------------------------------------------------------------------
# b: main path
# ---------------------------------------------------------------------------


def _box_down(img, f):
    h, w, c = img.shape
    return img[: h - h % f, : w - w % f].reshape(h // f, f, w // f, f, c).mean((1, 3))


def phase_main_path(r, out_dir: Path) -> None:
    import jax

    from lens_flare.flare.pipeline import FlarePipeline

    path = out_dir / "terrain_1080p.png"
    t0 = time.perf_counter()
    r.render_to_file(path)
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    hdr = r.render_to_file(path)
    warm = time.perf_counter() - t0
    print(
        f"  render_to_file: {warm:.3f} s warm; first call {cold:.3f} s, of "
        f"which ~{cold - warm:.3f} s compile; {r.stats.total_rays} rays, "
        f"{r.stats.mrays_per_s:.2f} Mrays/s in render", flush=True,
    )
    stats = jax.devices()[0].memory_stats() or {}
    print(f"  peak_bytes_in_use: {stats.get('peak_bytes_in_use', 'n/a')}", flush=True)
    check(hdr.shape == (HEIGHT, WIDTH, 3), f"image shape {hdr.shape}")
    check(bool(np.isfinite(hdr).all()), "image finite")
    film, counts = r.render(progress=False)
    comp = r.composite_flare(film)
    check(bool((comp >= film).all()), "flare composite >= film everywhere")
    check(bool(np.allclose(comp, hdr, rtol=1e-5, atol=1e-6)), "render_to_file matches render + composite")
    check(float((comp - film).max()) > 0, "flare adds light")
    check(path.exists() and path.with_name(path.stem + "_rate.png").exists(), "PNGs written")

    pipe = FlarePipeline.from_renderer(r)
    fast = np.asarray(dataclasses.replace(pipe, ghost_method="fast").ghost_buffer())
    exact = np.asarray(dataclasses.replace(pipe, ghost_method="exact").ghost_buffer())
    e_f, e_x = fast.sum((0, 1)), exact.sum((0, 1))
    check(
        bool(np.allclose(e_f, e_x, rtol=GHOST_ENERGY_RTOL)),
        f"ghost energy fast {e_f} vs exact {e_x} (rtol {GHOST_ENERGY_RTOL})",
    )
    lo_f, lo_x = _box_down(fast, 16), _box_down(exact, 16)
    dev = float(np.abs(lo_f - lo_x).max() / max(lo_x.max(), 1e-6))
    check(dev < GHOST_LOWFREQ, f"ghost low-frequency deviation {dev:.4f} < {GHOST_LOWFREQ}")


# ---------------------------------------------------------------------------
# c: differentiable step
# ---------------------------------------------------------------------------


def _fd_ok(g, fd, rtol):
    return bool(np.all(np.abs(g - fd) <= rtol * np.maximum(np.abs(fd), 1e-4)))


def phase_differentiable(r) -> None:
    import jax
    import jax.numpy as jnp
    import optax

    from lens_flare.integrator.path import render_wavefront
    from lens_flare.lens.prescription import reference_prescription
    from lens_flare.parallel.render import ghost_image_from_lens, make_train_step

    # d(pixel loss)/d(sun radiance) through the whole integrator
    y0, x0 = HEIGHT // 2, WIDTH // 2
    ys, xs = np.mgrid[y0 - 32 : y0 + 32, x0 - 32 : x0 + 32]
    px, py = jnp.asarray(xs.ravel()), jnp.asarray(ys.ravel())
    key = jax.random.PRNGKey(7)
    cam = r.camera.params()
    wts = jnp.asarray(np.random.default_rng(3).uniform(0.5, 1.5, (px.shape[0], 3)), jnp.float32)

    @jax.jit
    def loss(rad):
        b = r.bundle._replace(lights=r.bundle.lights._replace(
            radiance=r.bundle.lights.radiance.at[0].set(rad)))
        img, _, _ = render_wavefront(b, r.settings, cam, px, py, r.width, r.height, key)
        return jnp.sum(img * wts)

    rad0 = r.bundle.lights.radiance[0]
    g = np.asarray(jax.grad(loss)(rad0))
    eps = 0.1
    fd = np.array([
        (float(loss(rad0.at[c].add(eps))) - float(loss(rad0.at[c].add(-eps)))) / (2 * eps)
        for c in range(3)
    ])
    print(f"  grad {g} fd {fd}", flush=True)
    check(bool(np.isfinite(g).all()) and np.linalg.norm(g) > 0, "render gradient finite, nonzero")
    check(_fd_ok(g, fd, FD_RTOL), f"render gradient matches FD (rtol {FD_RTOL})")

    # one lens-design train step, and its gradient against FD
    lens = reference_prescription()
    tex = jnp.asarray(np.random.default_rng(0).uniform(0, 1, (32, 32)), jnp.float32)
    axis, angle, W, H = jnp.asarray([0.6, 0.55]), jnp.float32(0.4), 256, 144
    target = ghost_image_from_lens(
        lens.replace(spacings=lens.spacings * 1.03), tex, axis, angle, W, H
    )

    def lens_loss(c):
        img = ghost_image_from_lens(lens.replace(curvatures=c), tex, axis, angle, W, H)
        return jnp.mean((img - target) ** 2)

    c0 = lens.curvatures
    gl = np.asarray(jax.jit(jax.grad(lens_loss))(c0))
    i = int(np.argmax(np.abs(gl)))
    h = 1e-4 * max(abs(float(c0[i])), 1e-3)  # the loss curves fast in c
    lens_loss_j = jax.jit(lens_loss)
    fd_l = (float(lens_loss_j(c0.at[i].add(h))) - float(lens_loss_j(c0.at[i].add(-h)))) / (2 * h)
    print(f"  lens grad[{i}] {gl[i]:.6e} fd {fd_l:.6e}", flush=True)
    check(_fd_ok(np.array([gl[i]]), np.array([fd_l]), FD_RTOL), f"lens gradient matches FD (rtol {FD_RTOL})")
    opt = optax.adam(1e-3)
    step = make_train_step(opt, tex, axis, angle, W, H)
    new_lens, _, l0 = step(lens, opt.init(lens), target)
    leaves = jax.tree_util.tree_leaves(new_lens)
    check(
        bool(np.isfinite(float(l0))) and all(np.isfinite(np.asarray(x)).all() for x in leaves),
        f"train step finite (loss {float(l0):.6e})",
    )


# ---------------------------------------------------------------------------
# d: four cards
# ---------------------------------------------------------------------------


def phase_four_cards(out_dir: Path, seed: int) -> None:
    import jax

    import __graft_entry__

    n = len(jax.devices())
    check(n >= 4, f"{n} GPUs visible (need 4)")
    r1 = terrain_renderer(out_dir, seed, devices=1)
    r4 = terrain_renderer(out_dir, seed, devices=4)
    film1, counts1 = r1.render(progress=False)
    film4, counts4 = r4.render(progress=False)
    t0 = time.perf_counter()
    r1.render(progress=False)
    t1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    r4.render(progress=False)
    t4 = time.perf_counter() - t0
    print(f"  1080p film: 1 device {t1:.3f} s, 4 devices {t4:.3f} s (warm)", flush=True)
    same = int((film1 == film4).all(axis=-1).sum())
    diff = float(np.abs(film1 - film4).max())
    print(f"  {same} of {film1.shape[0] * film1.shape[1]} pixels bit-identical, max |diff| {diff:.3e}", flush=True)
    check(bool(np.array_equal(counts1, counts4)), "sample counts identical")
    # per-lane math is the same on every device, but XLA compiles the
    # per-device program for a quarter of the lanes and may fuse it
    # differently, so a few pixels can differ in the last bits
    check(
        bool(np.allclose(film1, film4, rtol=SHARD_RTOL, atol=SHARD_ATOL)),
        f"4-device film matches the 1-device film (rtol {SHARD_RTOL}, atol {SHARD_ATOL})",
    )
    check(r1.stats.total_rays == r4.stats.total_rays, "traced-ray counters identical")
    __graft_entry__.dryrun_multichip(4)
    check(True, "sharded train step ran (dryrun_multichip(4))")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true", help="run phase d only, on four GPUs")
    ap.add_argument("--out", default=str(ROOT / "out" / "chip_smoke"), help="output directory")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import jax

    import lens_flare  # noqa: F401  (sets the compile cache)

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform!r}", file=sys.stderr)
        return 2
    print(f"device_kind: {dev.device_kind}; JAX sees {len(jax.devices())} device(s)", flush=True)
    print(f"nvidia-smi: {gpu_name_and_power()}", flush=True)
    out_dir = Path(args.out)
    rng = np.random.default_rng(args.seed)

    t_all = time.perf_counter()
    if args.four_cards:
        print("phase d: four cards", flush=True)
        phase_four_cards(out_dir, args.seed)
    else:
        r = terrain_renderer(out_dir, args.seed)
        print("phase a: traversal parity", flush=True)
        phase_traversal(r, rng)
        print("phase b: main path (terrain_1080p)", flush=True)
        phase_main_path(r, out_dir)
        print("phase c: differentiable step", flush=True)
        phase_differentiable(r)
    print(f"total {time.perf_counter() - t_all:.1f} s", flush=True)
    print(json.dumps({
        "ok": True,
        "device": {"platform": dev.platform, "kind": dev.device_kind, "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
