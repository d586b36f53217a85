"""Turntable renderer: orbit the camera and render a frame sequence.

Covers the reference's turntable workflow (camera auto-dumps per move to
frames/frame_N.txt, camera.cpp:175-180 + the 'd' key): each frame's camera
settings are dumped alongside the PNG so any frame can be re-rendered with
``-c``.

Usage:
    python tools/turntable.py dae/pyramid.dae --frames 12 --out /tmp/turn
"""

from __future__ import annotations

import argparse
import math
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("scene")
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--out", default="turntable")
    ap.add_argument("--size", type=int, nargs=2, default=[256, 256])
    ap.add_argument("-s", type=int, default=4, dest="spp")
    ap.add_argument("-m", type=int, default=2, dest="depth")
    args = ap.parse_args()

    from lens_flare.renderer import Renderer
    from lens_flare.utils import image as img

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    r = Renderer(
        width=args.size[0],
        height=args.size[1],
        ns_aa=args.spp,
        max_ray_depth=args.depth,
        indirect=args.depth > 1,
    )
    r.load(args.scene)
    r.camera.frame_dump_dir = str(out / "frames")

    d_theta = 2 * math.pi / args.frames
    for i in range(args.frames):
        hdr, _ = r.render(progress=False)
        img.save_hdr_png(out / f"frame_{i:03d}.png", hdr, flip_y=True)  # film is bottom-up
        print(f"[Turntable] frame {i + 1}/{args.frames}")
        r.camera.rotate_by(0.0, d_theta)

    print(f"[Turntable] wrote {args.frames} frames to {out}")


if __name__ == "__main__":
    main()
