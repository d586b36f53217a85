"""Ray-BVH traversal dispatch: a CUDA kernel on the GPU, the XLA loop on the CPU.

Both paths walk the binary SAH BVH of :class:`~lens_flare.ops.intersect.SceneArrays`
and return the same tuple ``(t, prim, b1, b2, found, tests)``:

- ``"cuda"``: ``cuda/traverse.cu``, one thread per ray with a private stack,
  called through ``jax.ffi``.  The shared library is built with ``nvcc`` on
  first use into ``cuda/build/`` (or ahead of time with
  ``python -m lens_flare.ops.traverse``) and registered with XLA then, never
  at import: a CPU-only jaxlib has no CUDA platform to register it for.
- ``"xla"``: the ``vmap``-ed ``while_loop`` of :mod:`lens_flare.ops.intersect`.

The platform picks the path (:func:`traversal_impl`).  On a GPU a failed
build or launch raises; nothing falls back to the XLA loop.

The trace is a non-differentiable visibility query (callers detach its
inputs), so neither path has a VJP rule.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P

from ..parallel.mesh import BATCH_AXIS

SOURCE = Path(__file__).parent / "cuda" / "traverse.cu"
BUILD_DIR = Path(__file__).parent / "cuda" / "build"
TARGET = "lf_bvh_traverse"
# -fmad=false: no a*b+c contraction, so the kernel's float32 arithmetic is
# the XLA loop's and both return the same hits and test counts
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)
NODE_WIDTH = 16  # f32 slots per packed node
PRIM_WIDTH = 12  # f32 slots per packed primitive

_LOCK = threading.Lock()
_LIB = None  # the loaded kernel library, once registered with XLA


def traversal_impl(platform: str) -> str:
    """The traversal a JAX platform runs: ``"xla"`` on cpu, ``"cuda"`` on gpu."""
    if platform == "cpu":
        return "xla"
    if platform in ("gpu", "cuda"):
        return "cuda"
    raise ValueError(f"no ray traversal for platform {platform!r}")


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------


def _bits(x):
    return jax.lax.bitcast_convert_type(x.astype(jnp.int32), jnp.float32)


def pack_nodes(node_min, node_max, node_left, node_right, node_start, node_count):
    """Flat BVH -> (M + 1, 16) f32 nodes that hold their children's boxes.

    Row i: [left box min, left box max, right box min, right box max, link0,
    link1, 0, 0], links bit-cast from int32: (left, right) for an interior
    node, (start, -count) for a leaf (whose box slots are zero).  Row M holds
    the root's own box in slots 0-5.  One 64-byte row per popped interior
    node carries both slab tests, instead of a load from each child.
    """
    node_min = jnp.asarray(node_min, jnp.float32)
    node_max = jnp.asarray(node_max, jnp.float32)
    leaf = jnp.asarray(node_count) > 0
    left = jnp.maximum(jnp.asarray(node_left), 0)
    right = jnp.maximum(jnp.asarray(node_right), 0)
    boxes = jnp.concatenate(
        [node_min[left], node_max[left], node_min[right], node_max[right]], axis=1
    )
    boxes = jnp.where(leaf[:, None], 0.0, boxes)
    link0 = jnp.where(leaf, node_start, node_left)
    link1 = jnp.where(leaf, -jnp.asarray(node_count), node_right)
    zeros = jnp.zeros_like(node_min[:, :2])
    rows = jnp.concatenate(
        [boxes, _bits(link0)[:, None], _bits(link1)[:, None], zeros], axis=1
    )
    root = jnp.concatenate([node_min[0], node_max[0], jnp.zeros(10, jnp.float32)])
    return jnp.concatenate([rows, root[None]], axis=0)


def pack_prims(prim_order, tri_p0, tri_e1, tri_e2, sph_center, sph_radius):
    """Primitives in leaf order -> (P, 12) f32 rows.

    Triangle: [p0, e1, e2, id, 0, 0]; sphere: [center, radius, 0 x 5, id,
    0, 0].  ``id`` is the bit-cast int32 primitive id (spheres follow the
    triangles), so a leaf's primitives are one contiguous run of rows.
    """
    prim_order = jnp.asarray(prim_order, jnp.int32)
    n_t = tri_p0.shape[0]
    n_s = sph_center.shape[0]
    geo = []
    if n_t:
        ti = jnp.clip(prim_order, 0, n_t - 1)
        tri = jnp.concatenate([tri_p0[ti], tri_e1[ti], tri_e2[ti]], axis=1)
        geo.append(tri)
    if n_s:
        si = jnp.clip(prim_order - n_t, 0, n_s - 1)
        sph = jnp.concatenate(
            [sph_center[si], sph_radius[si][:, None], jnp.zeros((si.shape[0], 5))],
            axis=1,
        )
        geo.append(sph)
    if not geo:
        return jnp.zeros((0, PRIM_WIDTH), jnp.float32)
    rows = geo[0] if len(geo) == 1 else jnp.where((prim_order < n_t)[:, None], *geo)
    tail = jnp.zeros((prim_order.shape[0], 2), jnp.float32)
    return jnp.concatenate(
        [rows.astype(jnp.float32), _bits(prim_order)[:, None], tail], axis=1
    )


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the GPU traversal kernel cannot be built")


def build_kernel() -> Path:
    """Compile ``cuda/traverse.cu`` once per source version; returns the .so path."""
    include = jax.ffi.include_dir()
    key = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    lib = BUILD_DIR / f"libtraverse-{key[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-I", include, "-o", tmp, str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def _ensure_registered() -> None:
    global _LIB
    with _LOCK:
        if _LIB is not None:
            return
        lib = ctypes.cdll.LoadLibrary(str(build_kernel()))
        jax.ffi.register_ffi_target(
            TARGET, jax.ffi.pycapsule(lib.LfBvhTraverse), platform="CUDA"
        )
        _LIB = lib


def _traverse_cuda(scene, o, d, t_lo, t_hi, any_hit: bool):
    n = o.shape[0]
    _ensure_registered()
    f32 = jax.ShapeDtypeStruct((n,), jnp.float32)
    i32 = jax.ShapeDtypeStruct((n,), jnp.int32)
    t, prim, b1, b2, found, tests = jax.ffi.ffi_call(
        TARGET, (f32, i32, f32, f32, i32, i32), vmap_method="broadcast_all"
    )(
        o, d, t_lo, t_hi, scene.bvh_nodes, scene.bvh_prims,
        num_tris=np.int32(scene.tri_p0.shape[0]), any_hit=np.int32(any_hit),
    )
    return t, prim, b1, b2, found != 0, tests


def _traverse_xla(scene, o, d, t_lo, t_hi, any_hit: bool):
    from .intersect import traverse_xla

    return traverse_xla(scene, o, d, t_lo, t_hi, any_hit=any_hit)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def _misses(n):
    z = jnp.zeros(n, jnp.float32)
    return (
        jnp.full(n, 1e30, jnp.float32), jnp.full(n, -1, jnp.int32), z, z,
        jnp.zeros(n, bool), jnp.zeros(n, jnp.int32),
    )


def pad_lanes(o, d, t_lo, t_hi, multiple: int):
    """Pad a wavefront to a multiple of ``multiple`` lanes with dead rays.

    Padding lanes have an empty interval (t_lo = 1 > t_hi = 0), so they
    visit no node and count no test.  Returns the padded arrays and the
    original lane count (slice results back with ``[:n]``).
    """
    n = o.shape[0]
    pad = -n % multiple
    if pad == 0:
        return (o, d, t_lo, t_hi), n
    return (
        jnp.pad(o, ((0, pad), (0, 0))),
        jnp.pad(d, ((0, pad), (0, 0)), constant_values=1.0),
        jnp.pad(t_lo, (0, pad), constant_values=1.0),
        jnp.pad(t_hi, (0, pad)),
    ), n


def _batch_mesh():
    """The context mesh's batch axis size, if a sharded call applies."""
    mesh = jax.sharding.get_abstract_mesh()
    if mesh.empty or BATCH_AXIS not in mesh.axis_names:
        return None
    if BATCH_AXIS in mesh.manual_axes:  # already inside a shard_map
        return None
    size = mesh.shape[BATCH_AXIS]
    return size if size > 1 else None


def traverse(scene, o, d, t_lo, t_hi, any_hit: bool = False, impl: str | None = None):
    """Closest-hit (or any-hit) traversal of a ray wavefront.

    o, d: (N, 3); t_lo, t_hi: (N,).  Returns ``(t, prim, b1, b2, found,
    tests)``, each (N,): hit distance (1e30 on a miss), primitive id (-1),
    barycentrics of the winning triangle, hit mask, and the number of
    primitive intersection tests the lane ran.  ``impl`` overrides the
    platform's choice (``"xla"`` or ``"cuda"``).

    Under a context mesh with a ``batch`` axis (``jax.set_mesh``) the call
    runs under ``shard_map`` over that axis, each device tracing its own
    lanes against its replica of the scene; the wavefront is padded with
    dead lanes to divide evenly.
    """
    impl = impl or traversal_impl(jax.default_backend())
    fn = {"cuda": _traverse_cuda, "xla": _traverse_xla}[impl]
    o, d = jnp.asarray(o, jnp.float32), jnp.asarray(d, jnp.float32)
    t_lo, t_hi = jnp.asarray(t_lo, jnp.float32), jnp.asarray(t_hi, jnp.float32)
    if scene.bvh_prims.shape[0] == 0:
        return _misses(o.shape[0])

    def run(sc, oo, dd, lo, hi):
        return fn(sc, oo, dd, lo, hi, any_hit)

    n_dev = _batch_mesh()
    if n_dev is None:
        return run(scene, o, d, t_lo, t_hi)
    rays, n = pad_lanes(o, d, t_lo, t_hi, n_dev)
    lanes = P(BATCH_AXIS)
    out = jax.shard_map(
        run, in_specs=(P(), lanes, lanes, lanes, lanes), out_specs=lanes,
        check_vma=False,
    )(scene, *rays)
    if n == rays[0].shape[0]:
        return out
    # a slice that no longer divides over the mesh: keep it replicated
    return tuple(jax.lax.with_sharding_constraint(x[:n], P()) for x in out)


if __name__ == "__main__":
    print(build_kernel())
