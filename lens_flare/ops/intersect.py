"""Wavefront ray-scene intersection: scene arrays and the XLA traversal.

The reference's hottest loop — recursive BVH traversal with per-primitive
Möller-Trumbore / sphere-quadratic tests (``bvh.cpp:201-222``,
``triangle.cpp:25-112``, ``sphere.cpp:11-111``, ``bbox.cpp:12-49``) —
re-designed as a batched, compiler-friendly wavefront: every ray carries an
explicit traversal stack inside a ``lax.while_loop`` and the whole batch is
``vmap``-ed, so XLA lifts it to one lockstep masked loop over the wavefront.
This is the CPU path and the plain reference for the GPU kernel
(``cuda/traverse.cu``); :mod:`lens_flare.ops.traverse` picks between them.

Semantics contract with the reference:
- closest hit over [min_t, max_t], barycentric-interpolated unit normals
  for triangles, geometric normals for spheres
- ``occluded`` short-circuits like ``BVHAccel::has_intersection``
- a lane with an empty interval (t_hi < t_lo, e.g. t_hi = 0 for a dead
  lane) visits no node and counts no test
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

INF = jnp.float32(1e30)


class SceneArrays(NamedTuple):
    """Device-resident scene + BVH pytree (all jnp arrays)."""

    # triangles (T, ...)
    tri_p0: jnp.ndarray  # (T, 3)
    tri_e1: jnp.ndarray  # (T, 3) p1 - p0
    tri_e2: jnp.ndarray  # (T, 3) p2 - p0
    tri_n: jnp.ndarray  # (T, 3, 3) corner normals
    tri_bsdf: jnp.ndarray  # (T,)
    tri_shade: jnp.ndarray  # (T, 10) packed [corner normals (9), bsdf]: one
    # row gather per hit in finalize_hit instead of two
    # spheres (S, ...)
    sph_center: jnp.ndarray
    sph_radius: jnp.ndarray
    sph_bsdf: jnp.ndarray
    # flattened BVH
    node_min: jnp.ndarray
    node_max: jnp.ndarray
    node_left: jnp.ndarray
    node_right: jnp.ndarray
    node_start: jnp.ndarray
    node_count: jnp.ndarray
    prim_order: jnp.ndarray
    # the same BVH packed for the GPU kernel (ops.traverse.pack_nodes/_prims)
    bvh_nodes: jnp.ndarray  # (M + 1, 16)
    bvh_prims: jnp.ndarray  # (P, 12)


class Hit(NamedTuple):
    t: jnp.ndarray  # (N,) hit distance (INF on miss)
    prim: jnp.ndarray  # (N,) primitive id (triangles then spheres), -1 on miss
    bsdf: jnp.ndarray  # (N,) bsdf row id, 0 on miss
    n: jnp.ndarray  # (N, 3) shading normal
    hit: jnp.ndarray  # (N,) bool


def scene_to_device(flat_scene, bvh, dtype=jnp.float32) -> SceneArrays:
    """Upload a host FlatScene + FlatBVH to device arrays."""
    import numpy as _np

    from .traverse import pack_nodes, pack_prims

    tp = jnp.asarray(flat_scene.tri_p, dtype)
    n_t = len(flat_scene.tri_p)
    shade = _np.concatenate(
        [
            _np.asarray(flat_scene.tri_n, _np.float32).reshape(n_t, 9),
            _np.asarray(flat_scene.tri_bsdf, _np.float32).reshape(n_t, 1),
        ],
        axis=1,
    ) if n_t else _np.zeros((0, 10), _np.float32)
    tri_p0, tri_e1, tri_e2 = tp[:, 0], tp[:, 1] - tp[:, 0], tp[:, 2] - tp[:, 0]
    sph_center = jnp.asarray(flat_scene.sph_center, dtype)
    sph_radius = jnp.asarray(flat_scene.sph_radius, dtype)
    return SceneArrays(
        tri_p0=tri_p0,
        tri_e1=tri_e1,
        tri_e2=tri_e2,
        tri_n=jnp.asarray(flat_scene.tri_n, dtype),
        tri_bsdf=jnp.asarray(flat_scene.tri_bsdf),
        tri_shade=jnp.asarray(shade),
        sph_center=sph_center,
        sph_radius=sph_radius,
        sph_bsdf=jnp.asarray(flat_scene.sph_bsdf),
        node_min=jnp.asarray(bvh.node_min, dtype),
        node_max=jnp.asarray(bvh.node_max, dtype),
        node_left=jnp.asarray(bvh.node_left),
        node_right=jnp.asarray(bvh.node_right),
        node_start=jnp.asarray(bvh.node_start),
        node_count=jnp.asarray(bvh.node_count),
        prim_order=jnp.asarray(bvh.prim_order),
        bvh_nodes=pack_nodes(
            bvh.node_min, bvh.node_max, bvh.node_left, bvh.node_right,
            bvh.node_start, bvh.node_count,
        ),
        bvh_prims=pack_prims(
            bvh.prim_order, tri_p0, tri_e1, tri_e2, sph_center, sph_radius
        ),
    )


def _dot(a, b):
    """3-vector dot as explicit products: elementwise f32 on every backend
    (a dot_general may run in TF32 on a GPU), summed in the kernel's order."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def _ray_box(o, inv_d, node_min, node_max, t_lo, t_hi):
    """Slab test (bbox.cpp:12-49). Returns (hit, t_entry)."""
    t1 = (node_min - o) * inv_d
    t2 = (node_max - o) * inv_d
    t_min = jnp.max(jnp.minimum(t1, t2), axis=-1)
    t_max = jnp.min(jnp.maximum(t1, t2), axis=-1)
    hit = (t_min <= t_max) & (t_max >= t_lo) & (t_min <= t_hi)
    return hit, t_min


def _tri_test(scene: SceneArrays, prim, o, d, t_lo, t_hi):
    """Möller–Trumbore (triangle.cpp:25-68). Returns (valid, t, b1, b2)."""
    p0 = scene.tri_p0[prim]
    e1 = scene.tri_e1[prim]
    e2 = scene.tri_e2[prim]
    s = o - p0
    s1 = jnp.cross(d, e2)
    s2 = jnp.cross(s, e1)
    det = _dot(s1, e1)
    inv_det = jnp.where(det != 0, 1.0 / det, 0.0)
    t = _dot(s2, e2) * inv_det
    b1 = _dot(s1, s) * inv_det
    b2 = _dot(s2, d) * inv_det
    valid = (
        (det != 0)
        & (t >= t_lo)
        & (t <= t_hi)
        & (b1 >= 0)
        & (b1 <= 1)
        & (b2 >= 0)
        & (b2 <= 1)
        & (b1 + b2 <= 1)
    )
    return valid, t, b1, b2


def _sph_test(scene: SceneArrays, sidx, o, d, t_lo, t_hi):
    """Sphere quadratic (sphere.cpp:11-111). Returns (valid, t)."""
    c = scene.sph_center[sidx]
    r = scene.sph_radius[sidx]
    oc = o - c
    a = _dot(d, d)
    b = 2.0 * _dot(oc, d)
    cc = _dot(oc, oc) - r * r
    disc = b * b - 4 * a * cc
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    t1 = (-b - sq) / (2 * a)
    t2 = (-b + sq) / (2 * a)
    t1_ok = (t1 >= t_lo) & (t1 <= t_hi)
    t2_ok = (t2 >= t_lo) & (t2 <= t_hi)
    t = jnp.where(t1_ok, t1, t2)
    valid = (disc >= 0) & (t1_ok | t2_ok)
    return valid, t


def _make_traverse(num_tris: int, max_leaf: int, max_stack: int, any_hit: bool):
    """Build the per-ray traversal fn (closed over static sizes)."""

    def traverse(scene: SceneArrays, o, d, t_lo, t_hi):
        # NaN-safe reciprocal: raw 1/d with a zero component and the origin
        # on the slab plane gives 0*inf = NaN and the comparisons silently
        # drop the node
        eps = 1e-12
        inv_d = 1.0 / jnp.where(d >= 0, jnp.maximum(d, eps), jnp.minimum(d, -eps))

        stack = jnp.zeros(max_stack, jnp.int32)
        # state: (stack, sp, best_t, best_prim, best_b1, best_b2)
        root_hit, _ = _ray_box(o, inv_d, scene.node_min[0], scene.node_max[0], t_lo, t_hi)
        sp = jnp.where(root_hit & (t_lo <= t_hi), 1, 0).astype(jnp.int32)

        def cond(state):
            _stack, sp, _t, _prim, _b1, _b2, found, _tests = state
            alive = sp > 0
            if any_hit:
                alive = alive & jnp.logical_not(found)
            return alive

        def body(state):
            stack, sp, best_t, best_prim, best_b1, best_b2, found, tests = state
            # vmap lockstep: the body also runs for lanes whose own cond is
            # false (sp == 0, or any-hit already found).  Without this guard
            # such lanes pop with sp-1 == -1 (clamped reads), "resurrect" by
            # pushing children, and mutate their results.
            lane_active = sp > 0
            if any_hit:
                lane_active = lane_active & jnp.logical_not(found)
            node = stack[jnp.maximum(sp - 1, 0)]
            sp = jnp.where(lane_active, sp - 1, sp)

            count = scene.node_count[node]
            is_leaf = count > 0
            start = scene.node_start[node]

            # --- leaf: test up to max_leaf primitives (masked) ---
            def leaf_scan(carry, i):
                best_t, best_prim, best_b1, best_b2, found, tests = carry
                valid_slot = i < count
                pidx = scene.prim_order[jnp.minimum(start + i, scene.prim_order.shape[0] - 1)]
                is_tri = pidx < num_tris
                tri_idx = jnp.minimum(pidx, num_tris - 1) if num_tris > 0 else 0
                sph_idx = jnp.maximum(pidx - num_tris, 0)
                if num_tris > 0:
                    tv, tt, b1, b2 = _tri_test(scene, tri_idx, o, d, t_lo, jnp.minimum(t_hi, best_t))
                else:
                    tv, tt, b1, b2 = False, INF, 0.0, 0.0
                if scene.sph_center.shape[0] > 0:
                    sv, st = _sph_test(scene, sph_idx, o, d, t_lo, jnp.minimum(t_hi, best_t))
                else:
                    sv, st = False, INF
                valid = valid_slot & is_leaf & lane_active & jnp.where(is_tri, tv, sv)
                t = jnp.where(is_tri, tt, st)
                better = valid & (t < best_t)
                best_t = jnp.where(better, t, best_t)
                best_prim = jnp.where(better, pidx, best_prim)
                best_b1 = jnp.where(better & is_tri, b1, best_b1)
                best_b2 = jnp.where(better & is_tri, b2, best_b2)
                found = found | valid
                # primitive intersection tests actually performed (bvh.h:136)
                tests = tests + (valid_slot & is_leaf & lane_active).astype(jnp.int32)
                return (best_t, best_prim, best_b1, best_b2, found, tests), None

            (best_t, best_prim, best_b1, best_b2, found, tests), _ = jax.lax.scan(
                leaf_scan,
                (best_t, best_prim, best_b1, best_b2, found, tests),
                jnp.arange(max_leaf),
            )

            # --- interior: test child boxes, push near-first ---
            left = scene.node_left[node]
            right = scene.node_right[node]
            limit = jnp.minimum(t_hi, best_t)
            l_ok, l_t = _ray_box(o, inv_d, scene.node_min[left], scene.node_max[left], t_lo, limit)
            r_ok, r_t = _ray_box(
                o, inv_d, scene.node_min[right], scene.node_max[right], t_lo, limit
            )
            interior = jnp.logical_not(is_leaf) & lane_active
            l_ok = l_ok & interior & (left >= 0)
            r_ok = r_ok & interior & (right >= 0)

            # push far child first so near child pops first
            near_is_left = l_t <= r_t
            first = jnp.where(near_is_left, right, left)  # far
            first_ok = jnp.where(near_is_left, r_ok, l_ok)
            second = jnp.where(near_is_left, left, right)  # near
            second_ok = jnp.where(near_is_left, l_ok, r_ok)

            stack = stack.at[sp].set(jnp.where(first_ok, first, stack[sp]))
            sp = sp + first_ok.astype(jnp.int32)
            stack = stack.at[sp].set(jnp.where(second_ok, second, stack[sp]))
            sp = sp + second_ok.astype(jnp.int32)

            return (stack, sp, best_t, best_prim, best_b1, best_b2, found, tests)

        init = (
            stack, sp, INF, jnp.int32(-1), jnp.float32(0), jnp.float32(0),
            jnp.array(False), jnp.int32(0),
        )
        _, _, best_t, best_prim, best_b1, best_b2, found, tests = jax.lax.while_loop(
            cond, body, init
        )
        return best_t, best_prim, best_b1, best_b2, found, tests

    return traverse


def traverse_xla(scene: SceneArrays, o, d, t_lo, t_hi, any_hit: bool = False,
                 max_leaf: int = 4, max_stack: int = 64):
    """Raw traversal of a wavefront: ``(t, prim, b1, b2, found, tests)``, each (N,)."""
    num_tris = int(scene.tri_p0.shape[0])
    traverse = _make_traverse(num_tris, max_leaf, max_stack, any_hit=any_hit)
    return jax.vmap(lambda oo, dd, lo, hi: traverse(scene, oo, dd, lo, hi))(
        o, d, t_lo, t_hi
    )


def intersect_rays(
    scene: SceneArrays, o, d, t_lo, t_hi, max_leaf: int = 4, max_stack: int = 64,
    return_tests: bool = False,
) -> Hit:
    """Closest-hit intersection for a wavefront of rays (XLA path).

    o, d: (N, 3); t_lo, t_hi: (N,) scalars per ray.  With ``return_tests``
    also returns the per-ray primitive intersection-test counts.
    """
    t, prim, b1, b2, found, tests = traverse_xla(
        scene, o, d, t_lo, t_hi, max_leaf=max_leaf, max_stack=max_stack
    )
    hit = finalize_hit(scene, o, d, t, prim, b1, b2, found)
    if return_tests:
        return hit, tests
    return hit


def finalize_hit(scene: SceneArrays, o, d, t, prim, b1, b2, found) -> Hit:
    """Raw traversal results -> Hit with shading normals + bsdf rows."""
    num_tris = int(scene.tri_p0.shape[0])
    is_tri = (prim >= 0) & (prim < num_tris)
    tri_idx = jnp.clip(prim, 0, max(num_tris - 1, 0))
    sph_idx = jnp.clip(prim - num_tris, 0, max(int(scene.sph_center.shape[0]) - 1, 0))

    # triangle: barycentric-interpolated unit normal (triangle.cpp:104-108)
    if num_tris > 0:
        rows = scene.tri_shade[tri_idx]  # (N, 10): normals + bsdf in one gather
        n_corners = rows[:, :9].reshape(-1, 3, 3)
        b0 = 1.0 - b1 - b2
        n_tri = (
            b0[:, None] * n_corners[:, 0]
            + b1[:, None] * n_corners[:, 1]
            + b2[:, None] * n_corners[:, 2]
        )
        n_tri = n_tri / jnp.maximum(jnp.linalg.norm(n_tri, axis=-1, keepdims=True), 1e-30)
        bsdf_tri = rows[:, 9].astype(jnp.int32)
    else:
        n_tri = jnp.zeros_like(o)
        bsdf_tri = jnp.zeros(o.shape[0], jnp.int32)

    if int(scene.sph_center.shape[0]) > 0:
        p_hit = o + d * t[:, None]
        n_sph = p_hit - scene.sph_center[sph_idx]
        n_sph = n_sph / jnp.maximum(jnp.linalg.norm(n_sph, axis=-1, keepdims=True), 1e-30)
        bsdf_sph = scene.sph_bsdf[sph_idx]
    else:
        n_sph = jnp.zeros_like(o)
        bsdf_sph = jnp.zeros(o.shape[0], jnp.int32)

    n = jnp.where(is_tri[:, None], n_tri, n_sph)
    bsdf = jnp.where(is_tri, bsdf_tri, bsdf_sph)
    return Hit(t=t, prim=prim, bsdf=bsdf, n=n, hit=found)


def occluded_rays(
    scene: SceneArrays, o, d, t_lo, t_hi, max_leaf: int = 4, max_stack: int = 64,
    return_tests: bool = False,
):
    """Any-hit query for shadow rays (bvh.cpp:179-199 short-circuit), XLA path."""
    _, _, _, _, found, tests = traverse_xla(
        scene, o, d, t_lo, t_hi, any_hit=True, max_leaf=max_leaf, max_stack=max_stack
    )
    if return_tests:
        return found, tests
    return found
