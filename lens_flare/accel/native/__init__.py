"""ctypes loader for the native builder library (compiled on first use)."""

from __future__ import annotations

import ctypes
import subprocess
import threading
from pathlib import Path

import numpy as np

_HERE = Path(__file__).parent
_SRC = _HERE / "builder.cpp"
_SO = _HERE / "_builder.so"
_LOCK = threading.Lock()
_LIB = None
_TRIED = False


def _compile() -> bool:
    cmd = [
        "g++",
        "-O3",
        "-march=native",
        "-shared",
        "-fPIC",
        "-std=c++17",
        str(_SRC),
        "-o",
        str(_SO),
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        return True
    except Exception:
        return False


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
            if not _compile():
                return None
        try:
            lib = ctypes.CDLL(str(_SO))
        except OSError:
            return None

        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        lib.lf_build_bvh.restype = ctypes.c_int
        lib.lf_build_bvh.argtypes = [
            f32p, f32p, ctypes.c_int, ctypes.c_int,
            f32p, f32p, i32p, i32p, i32p, i32p, i32p, i32p,
        ]
        _LIB = lib
        return _LIB


def build_bvh_native(box_min: np.ndarray, box_max: np.ndarray, max_leaf: int = 4):
    """Binary SAH BVH via the C++ builder; returns a FlatBVH or None."""
    lib = get_lib()
    if lib is None:
        return None
    from ..bvh import FlatBVH

    n = len(box_min)
    if n == 0:
        return None
    cap = max(2 * n, 1)
    node_min = np.zeros((cap, 3), np.float32)
    node_max = np.zeros((cap, 3), np.float32)
    node_left = np.zeros(cap, np.int32)
    node_right = np.zeros(cap, np.int32)
    node_start = np.zeros(cap, np.int32)
    node_count = np.zeros(cap, np.int32)
    prim_order = np.zeros(n, np.int32)
    depth = np.zeros(1, np.int32)
    m = lib.lf_build_bvh(
        np.ascontiguousarray(box_min, np.float32),
        np.ascontiguousarray(box_max, np.float32),
        n,
        max_leaf,
        node_min,
        node_max,
        node_left,
        node_right,
        node_start,
        node_count,
        prim_order,
        depth,
    )
    return FlatBVH(
        node_min=node_min[:m].copy(),
        node_max=node_max[:m].copy(),
        node_left=node_left[:m].copy(),
        node_right=node_right[:m].copy(),
        node_start=node_start[:m].copy(),
        node_count=node_count[:m].copy(),
        prim_order=prim_order,
        max_depth=int(depth[0]),
    )
