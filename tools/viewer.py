"""Standalone launcher for the interactive terminal viewer.

Thin wrapper over :mod:`lens_flare.term_viewer` (the front-end) and
:mod:`lens_flare.app` (the EDIT/VISUALIZE/RENDER state machine).  The
main CLI's ``--view`` flag reaches the same viewer with the full flag
surface; this script exists for quick ad-hoc use:

    python tools/viewer.py dae/pyramid.dae [-s 16] [-m 4] [-r 480 360]
    keys: r render | v visualize BVH | e edit | s save | q quit
          [ ] spp   - = light samples   < > depth   k l lens   ; ' focal
          C cell mode   d dump camera   space reset   arrows walk BVH
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("scene")
    ap.add_argument("-s", type=int, default=16, dest="ns_aa")
    ap.add_argument("-l", type=int, default=1, dest="ns_area_light")
    ap.add_argument("-m", type=int, default=4, dest="max_ray_depth")
    ap.add_argument("-r", nargs=2, type=int, default=[480, 360], metavar=("W", "H"))
    ap.add_argument("-b", type=float, default=0.0, dest="lens_radius")
    ap.add_argument("-d", type=float, default=0.0, dest="focal_distance")
    ap.add_argument("-f", dest="filename", default="screenshot")
    args = ap.parse_args()

    from lens_flare.app import Application
    from lens_flare.renderer import Renderer
    from lens_flare.term_viewer import run_viewer

    r = Renderer(
        width=args.r[0], height=args.r[1], ns_aa=args.ns_aa,
        max_ray_depth=args.max_ray_depth, ns_area_light=args.ns_area_light,
        lens_radius=args.lens_radius, focal_distance=args.focal_distance,
        indirect=args.max_ray_depth > 1,
    )
    print(f"[Viewer] loading {args.scene} ...")
    r.load(args.scene)
    return run_viewer(Application(r, filename=args.filename))


if __name__ == "__main__":
    sys.exit(main())
