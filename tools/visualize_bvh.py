"""BVH / cluster-tree debug visualizer (matplotlib).

Replacement for the reference's OpenGL BVH visualizer + ray log
(``raytraced_renderer.cpp:403-494``): draws node AABBs at a chosen depth and
optionally overlays logged rays colored by hit/miss.

Usage:
    python tools/visualize_bvh.py dae/pyramid.dae --depth 4 --out bvh.png
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).parent.parent))

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("scene")
    ap.add_argument("--depth", type=int, default=4, help="tree depth to draw")
    ap.add_argument("--rays", type=int, default=0, help="overlay N random camera rays")
    ap.add_argument("--axes", default="xy", choices=["xy", "xz", "yz"])
    ap.add_argument("--out", default="bvh_debug.png")
    args = ap.parse_args()

    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Rectangle

    from lens_flare.accel import build_bvh
    from lens_flare.oracle import tracer as oracle
    from lens_flare.scene.build import load_scene
    from lens_flare.scene.camera import Camera, place_from_scene_info

    scene, info = load_scene(args.scene)
    lo, hi = scene.primitive_bboxes()
    bvh = build_bvh(lo, hi)

    ax_ids = {"x": 0, "y": 1, "z": 2}
    a0, a1 = ax_ids[args.axes[0]], ax_ids[args.axes[1]]

    fig, ax = plt.subplots(figsize=(10, 10))

    # walk to the requested depth
    frontier = [(0, 0)]
    boxes = []
    while frontier:
        node, depth = frontier.pop()
        if depth == args.depth or bvh.node_count[node] > 0:
            boxes.append((node, depth))
            continue
        for child in (bvh.node_left[node], bvh.node_right[node]):
            if child >= 0:
                frontier.append((child, depth + 1))

    cmap = plt.cm.viridis
    for node, depth in boxes:
        mn, mx = bvh.node_min[node], bvh.node_max[node]
        ax.add_patch(
            Rectangle(
                (mn[a0], mn[a1]),
                mx[a0] - mn[a0],
                mx[a1] - mn[a1],
                fill=False,
                edgecolor=cmap(depth / max(args.depth, 1)),
                linewidth=0.8,
            )
        )

    if args.rays:
        cam = Camera()
        cam.configure(info.camera, 256, 256)
        place_from_scene_info(cam, info, scene.bbox_min, scene.bbox_max)
        rng = np.random.default_rng(0)
        for _ in range(args.rays):
            o, d = oracle.generate_ray(cam, rng.uniform(), rng.uniform())
            isect = oracle.intersect_brute(scene, o, d, cam.n_clip, cam.f_clip)
            t_end = isect["t"] if isect else 20.0
            p = o + d * t_end
            ax.plot(
                [o[a0], p[a0]],
                [o[a1], p[a1]],
                color="green" if isect else "red",
                linewidth=0.5,
                alpha=0.6,
            )

    ax.autoscale_view()
    ax.set_aspect("equal")
    ax.set_xlabel(args.axes[0])
    ax.set_ylabel(args.axes[1])
    ax.set_title(f"{Path(args.scene).name}: BVH nodes at depth <= {args.depth}")
    fig.savefig(args.out, dpi=120, bbox_inches="tight")
    print(f"saved {args.out} ({len(boxes)} boxes)")


if __name__ == "__main__":
    main()
