"""Profile one warm terrain_1080p film render on the GPU and reduce the trace.

    python tools/profile_frame.py [--out out/profile_frame]

Renders the frame once to compile, then again under ``jax.profiler.trace``
(with a Perfetto trace), and reduces the device events of the traced render:
busy time (union of kernel intervals), idle share of the window from the
first to the last device event, and the kernels that take the most device
time, with the BVH traversal kernel's total apart.  Needs a GPU; the last
line is one JSON object.
"""

from __future__ import annotations

import argparse
import gzip
import json
import subprocess
import sys
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def device_events(trace_json: dict) -> list[dict]:
    """Complete ('X') events on GPU device planes of a Perfetto trace."""
    gpu_pids = {
        e["pid"]
        for e in trace_json.get("traceEvents", [])
        if e.get("ph") == "M" and e.get("name") == "process_name"
        and "GPU" in str(e.get("args", {}).get("name", ""))
    }
    return [
        e for e in trace_json["traceEvents"]
        if e.get("ph") == "X" and e.get("pid") in gpu_pids and "dur" in e
    ]


def reduce_events(events: list[dict], top: int = 15) -> dict:
    """Busy time, idle share and per-kernel totals (microseconds)."""
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events)
    busy, cur_lo, cur_hi = 0.0, None, None
    for lo, hi in spans:
        if cur_hi is None or lo > cur_hi:
            if cur_hi is not None:
                busy += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    if cur_hi is not None:
        busy += cur_hi - cur_lo
    window = (spans[-1][1] - spans[0][0]) if spans else 0.0
    per = defaultdict(float)
    for e in events:
        per[e["name"]] += float(e["dur"])
    kernels = sorted(per.items(), key=lambda kv: -kv[1])
    traverse = sum(v for k, v in per.items() if "traverse_kernel" in k)
    return {
        "window_us": window,
        "busy_us": busy,
        "idle_share": 1.0 - busy / window if window else None,
        "traverse_kernel_us": traverse,
        "n_events": len(events),
        "top_kernels_us": kernels[:top],
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ROOT / "out" / "profile_frame"))
    args = ap.parse_args()

    import jax

    from lens_flare.workloads import terrain_1080p

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"profile_frame: needs a GPU, JAX found {dev.platform!r}", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"device_kind: {dev.device_kind}; nvidia-smi: {card}", flush=True)
    out = Path(args.out)
    r = terrain_1080p(out)
    r.render(progress=False)  # compile + warm up
    with jax.profiler.trace(str(out / "trace"), create_perfetto_trace=True):
        r.render(progress=False)
    path = max((out / "trace").rglob("perfetto_trace.json.gz"), key=lambda p: p.stat().st_mtime)
    with gzip.open(path) as f:
        trace = json.load(f)
    result = reduce_events(device_events(trace))
    result.update(device_kind=dev.device_kind, card=card, wall_s=r.stats.wall_time)
    for name, us in result["top_kernels_us"]:
        print(f"  {us / 1e3:9.3f} ms  {name[:110]}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
