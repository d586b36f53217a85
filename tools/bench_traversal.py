"""Time the terrain_1080p frame with the CUDA traversal kernel and with the XLA loop.

    python tools/bench_traversal.py [--reps 3] [--out out/bench_traversal]

Both runs go through the normal Renderer path (render + flare composite +
PNG output, ``render_to_file``); only the traversal differs, forced through
``lens_flare.ops.traverse.traversal_impl``.  Order: kernel, XLA, kernel, each
warmed up first (compile time reported apart).  Needs a GPU; prints the card
and, last, one JSON line with the median seconds per frame.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=str(ROOT / "out" / "bench_traversal"))
    args = ap.parse_args()

    import jax

    import lens_flare.ops.traverse as trav
    from lens_flare.workloads import terrain_1080p

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench_traversal: needs a GPU, JAX found {dev.platform!r}", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"device_kind: {dev.device_kind}; nvidia-smi: {card}", flush=True)

    out = Path(args.out)
    r = terrain_1080p(out)
    choose = trav.traversal_impl
    result = {"device_kind": dev.device_kind, "card": card}
    for impl in ("cuda", "xla", "cuda"):
        trav.traversal_impl = (lambda platform, impl=impl: impl)
        jax.clear_caches()  # re-trace the render with this traversal
        t0 = time.perf_counter()
        r.render_to_file(out / f"frame_{impl}.png")
        first = time.perf_counter() - t0
        film_s, frame_s = [], []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            film, _ = r.render(progress=False)
            film_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            r.render_to_file(out / f"frame_{impl}.png")
            frame_s.append(time.perf_counter() - t0)
        row = {
            "first_call_s": first,
            "render_s": float(np.median(film_s)),
            "render_to_file_s": float(np.median(frame_s)),
            "rays": r.stats.total_rays,
            "isects_per_ray": r.stats.isects_per_ray,
            "film_sum": float(film.sum()),
        }
        print(f"{impl}: {row}", flush=True)
        result.setdefault(impl, []).append(row)
    trav.traversal_impl = choose
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
