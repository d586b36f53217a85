"""Command-line interface mirroring the reference flag surface (main.cpp:24-157).

Example::

    lens-flare -t 8 -s 64 -l 4 -m 5 -r 480 360 -f out.png \
        -x apertures/pentsmall.png -y bokeh/octagonbokeh.png dae/pyramid.dae
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="lens-flare",
        description="Differentiable wavefront path tracer with physically-based lens flare",
    )
    p.add_argument("scene", help="COLLADA (.dae) scene file")
    p.add_argument("-s", type=int, default=1, dest="ns_aa", help="camera rays per pixel")
    p.add_argument("-l", type=int, default=1, dest="ns_area_light", help="samples per area light")
    p.add_argument("-t", type=int, default=0, dest="num_threads", help="worker parallelism (reference: thread-pool size; here: rendering devices, same as --devices)")
    p.add_argument("-m", type=int, default=1, dest="max_ray_depth", help="maximum ray depth")
    p.add_argument("-e", dest="envmap", default=None, help="environment map (.exr)")
    p.add_argument("-b", type=float, default=0.0, dest="lens_radius", help="aperture (lens) radius")
    p.add_argument("-d", type=float, default=0.0, dest="focal_distance", help="focal distance")
    p.add_argument("-a", nargs=2, default=None, metavar=("BATCH", "TOL"), help="adaptive sampling: samples per batch + tolerance")
    p.add_argument("-f", dest="output", default="out.png", help="output PNG (windowless render)")
    p.add_argument("-r", nargs=2, type=int, default=[800, 600], metavar=("W", "H"), help="width height")
    p.add_argument("-p", nargs=4, type=int, default=None, metavar=("X", "Y", "DX", "DY"), help="render subwindow cell")
    p.add_argument("-c", dest="cam_settings", default=None, help="camera settings file")
    p.add_argument("-x", dest="aperture", default=None, help="aperture PNG (starburst)")
    p.add_argument("-y", dest="ghost_aperture", default=None, help="ghost-aperture PNG")
    p.add_argument("--bokeh", dest="bokeh", default=None, help="bokeh mask PNG for aperture-shaped DoF")
    p.add_argument("-i", type=float, default=0.0, dest="flare_intensity", help="lens flare intensity")
    p.add_argument("-n", type=float, default=0.0, dest="flare_radius", help="lens flare radius")
    p.add_argument("-H", action="store_true", dest="hemisphere", help="uniform hemisphere direct sampling")
    p.add_argument("--indirect", action="store_true", help="enable indirect bounces (Part-4 transport)")
    p.add_argument(
        "--lens-model",
        choices=("paraxial", "realistic"),
        default="paraxial",
        dest="lens_model",
        help="ghost model: paraxial 2x2 matrices (reference parity) or the "
        "full sequential Snell+Fresnel lens-stack trace (BASELINE config 3)",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument(
        "--upsample", type=int, default=0, metavar="N",
        help="Loop-subdivide every scene mesh N levels before rendering "
        "(the reference's EDIT-mode 'u' key, offline)",
    )
    p.add_argument("--devices", type=int, default=0, help="shard the render over the first N devices (0 = all available)")
    p.add_argument(
        "--trace",
        dest="trace_dir",
        default=None,
        metavar="DIR",
        help="capture a jax.profiler trace of the render into DIR (view with "
        "TensorBoard / xprof; the SURVEY 5.1 profiling subsystem — the "
        "reference only had wall-clock Timer prints)",
    )
    p.add_argument(
        "--view",
        action="store_true",
        help="open the interactive terminal viewer instead of rendering to -f "
        "(the reference's GLFW window, re-imagined for a tty; keys: r/v/e/s, "
        "[ ] - = < > k l ; ' C d, space, arrows; mouse orbit/pan/autofocus)",
    )
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from .renderer import Renderer

    envmap = None
    if args.envmap:
        from .utils import exr

        print(f"[PathTracer] Loading environment map {args.envmap}")
        envmap = exr.read(args.envmap)

    spb, tol = (64, 0.05)
    if args.a is not None:
        spb, tol = int(args.a[0]), float(args.a[1])

    r = Renderer(
        width=args.r[0],
        height=args.r[1],
        ns_aa=args.ns_aa,
        max_ray_depth=args.max_ray_depth,
        ns_area_light=args.ns_area_light,
        samples_per_batch=spb,
        max_tolerance=tol,
        direct_hemisphere_sample=args.hemisphere,
        indirect=args.indirect or args.max_ray_depth > 1,
        lens_radius=args.lens_radius,
        focal_distance=args.focal_distance,
        envmap=envmap,
        aperture_path=args.aperture,
        ghost_aperture_path=args.ghost_aperture,
        bokeh_path=args.bokeh,
        flare_intensity=args.flare_intensity,
        flare_radius=args.flare_radius,
        camera_settings=args.cam_settings,
        lens_model=args.lens_model,
        seed=args.seed,
        # -t is the reference's parallelism knob (its thread-pool size,
        # main.cpp:106-108); here both flags drive the device mesh the pixel
        # wavefront is sharded over, --devices taking precedence, 0 = all
        devices=args.devices if args.devices > 0 else (args.num_threads or 0),
    )
    print(f"[PathTracer] Loading scene {args.scene}")
    r.load(args.scene)
    if args.upsample > 0:
        from .scene.halfedge import subdivide_scene

        t0 = r.scene.num_triangles
        r.load_flat_scene(
            subdivide_scene(r.scene, args.upsample), camera=r.camera
        )
        print(
            f"[PathTracer] Loop-subdivided x{args.upsample}: "
            f"{t0} -> {r.scene.num_triangles} triangles"
        )
    if args.view:
        # interactive mode reuses the fully-configured, already-loaded
        # renderer (every CLI flag applies: envmap, adaptive, flare, ...)
        if args.trace_dir:
            print(
                "[PathTracer] --trace applies to offline renders only; "
                "ignoring it for the interactive viewer"
            )
        from .app import Application
        from .term_viewer import run_viewer

        from pathlib import Path

        return run_viewer(Application(r, filename=str(Path(args.output).with_suffix(""))))
    cell = tuple(args.p) if args.p else None
    if args.trace_dir:
        import jax

        with jax.profiler.trace(args.trace_dir):
            r.render_to_file(args.output, cell=cell)
        print(f"[PathTracer] profiler trace written to {args.trace_dir}")
    else:
        r.render_to_file(args.output, cell=cell)
    return 0


if __name__ == "__main__":
    sys.exit(main())
