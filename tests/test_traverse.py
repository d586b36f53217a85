"""Ray traversal: the XLA loop against the oracle, and the CUDA kernel's wrapper.

The CUDA kernel itself runs only on a GPU (``test_cuda_kernel_matches_xla``,
marked ``gpu``).  What surrounds it is tested here on the CPU: the packed
node/primitive layout it reads (walked by a NumPy model of the kernel), the
padding of wavefronts for the sharded call, the choice of path by platform,
and the empty-scene short cut.  All scenes are procedural.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from lens_flare.accel import build_bvh
from lens_flare.oracle import tracer as oracle
from lens_flare.ops import occluded_rays, scene_to_device
from lens_flare.ops.intersect import traverse_xla
from lens_flare.ops.traverse import (
    NODE_WIDTH,
    PRIM_WIDTH,
    pack_nodes,
    pack_prims,
    pad_lanes,
    traversal_impl,
    traverse,
)
from lens_flare.scene.build import BSDFTable, FlatScene
from lens_flare.scene.collada import MaterialInfo
from lens_flare.scene.procedural import make_terrain_scene


def _with_spheres(scene, centers, radii):
    scene.sph_center = np.asarray(centers, np.float32)
    scene.sph_radius = np.asarray(radii, np.float32)
    scene.sph_bsdf = np.zeros(len(radii), np.int32)
    lo, hi = scene.primitive_bboxes()
    scene.bbox_min, scene.bbox_max = lo.min(0), hi.max(0)
    return scene


def _spheres_only(n=24, seed=3):
    rng = np.random.default_rng(seed)
    empty = np.zeros((0, 3, 3), np.float32)
    scene = FlatScene(
        tri_p=empty, tri_n=empty, tri_bsdf=np.zeros(0, np.int32),
        sph_center=np.zeros((0, 3), np.float32), sph_radius=np.zeros(0, np.float32),
        sph_bsdf=np.zeros(0, np.int32),
        bsdfs=BSDFTable.from_materials([MaterialInfo(albedo=np.array([0.5, 0.5, 0.5]))]),
    )
    centers = rng.uniform(-8, 8, (n, 3)) * np.array([1.0, 1.0, 0.3])
    return _with_spheres(scene, centers, rng.uniform(0.4, 1.6, n))


SCENES = {
    "terrain": lambda: make_terrain_scene(12),
    "triangles_and_spheres": lambda: _with_spheres(
        make_terrain_scene(8),
        [[0.0, 0.0, 3.0], [4.0, -3.0, 2.5], [-5.0, 5.0, 2.0], [2.0, 6.0, 4.0]],
        [1.5, 1.0, 2.0, 0.7],
    ),
    "spheres": _spheres_only,
}


def _device(scene):
    lo, hi = scene.primitive_bboxes()
    return scene_to_device(scene, build_bvh(lo, hi))


def _rays(n=192, seed=0):
    """Rays from above the scenes, mostly downward, some grazing."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-9, 9, (n, 3)) * np.array([1.0, 1.0, 0.0]) + np.array([0.0, 0.0, 7.0])
    d = rng.normal(size=(n, 3))
    d[:, 2] = -np.abs(d[:, 2]) - 0.1
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (
        o.astype(np.float32), d.astype(np.float32),
        np.full(n, 1e-4, np.float32), np.full(n, 1e30, np.float32),
    )


# ---------------------------------------------------------------------------
# the XLA traversal against the oracle
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", list(SCENES))
def test_xla_traversal_matches_oracle(name):
    scene = SCENES[name]()
    dev = _device(scene)
    o, d, lo, hi = _rays()
    t, prim, _, _, found, tests = (np.asarray(v) for v in traverse(dev, o, d, lo, hi))
    ref = oracle.closest_hits(scene, o, d, lo, hi)
    assert ref["hit"].sum() > 20, "scene not covered by the rays"
    np.testing.assert_array_equal(found, ref["hit"])
    np.testing.assert_allclose(t[found], ref["t"][found], rtol=1e-4)
    assert np.mean(prim[found] == ref["prim"][found]) >= 0.99
    assert (tests[found] > 0).all()


@pytest.mark.parametrize("name", ["terrain", "triangles_and_spheres"])
def test_any_hit_matches_closest_hit_occlusion(name):
    dev = _device(SCENES[name]())
    o, d, lo, _ = _rays(seed=1)
    # finite shadow intervals: some end before the surface, some after
    hi = np.random.default_rng(2).uniform(0.5, 14.0, len(lo)).astype(np.float32)
    closest = np.asarray(traverse(dev, o, d, lo, hi)[4])
    found, tests = (np.asarray(v) for v in traverse(dev, o, d, lo, hi, any_hit=True)[4:])
    np.testing.assert_array_equal(found, closest)
    np.testing.assert_array_equal(found, np.asarray(occluded_rays(dev, o, d, lo, hi)))
    assert 0 < found.sum() < len(found)
    # any-hit stops at the first hit: never more tests than the closest hit
    assert (tests <= np.asarray(traverse(dev, o, d, lo, hi)[5])).all()


def test_dead_lanes_count_zero_tests():
    dev = _device(SCENES["terrain"]())
    o, d, lo, hi = _rays(n=64)
    # origins on the terrain surface sit inside its boxes: only the empty
    # interval stops the walk
    o[:, 2] = 0.5
    hi[::2] = 0.0
    for any_hit in (False, True):
        _, prim, _, _, found, tests = (
            np.asarray(v) for v in traverse(dev, o, d, lo, hi, any_hit=any_hit)
        )
        assert (tests[::2] == 0).all() and not found[::2].any()
        assert (prim[::2] == -1).all()
        assert tests[1::2].sum() > 0


def test_empty_scene_misses():
    scene = _spheres_only(n=1)
    scene.sph_center, scene.sph_radius = np.zeros((0, 3), np.float32), np.zeros(0, np.float32)
    scene.sph_bsdf = np.zeros(0, np.int32)
    dev = _device(scene)
    o, d, lo, hi = _rays(n=16)
    t, prim, _, _, found, tests = (np.asarray(v) for v in traverse(dev, o, d, lo, hi))
    assert not found.any() and (prim == -1).all() and (tests == 0).all()
    assert (t == np.float32(1e30)).all()


# ---------------------------------------------------------------------------
# the CUDA kernel's wrapper
# ---------------------------------------------------------------------------


def _walk_packed(nodes, prims, num_tris, o, d, t_lo, t_hi, any_hit):
    """NumPy model of cuda/traverse.cu for one ray, over the packed arrays."""
    f = np.float32
    as_int = lambda x: int(np.asarray(x, np.float32).view(np.int32))
    o = o.astype(f)
    d = d.astype(f)
    inv = f(1) / np.where(d >= 0, np.maximum(d, f(1e-12)), np.minimum(d, f(-1e-12)))

    def box(mn, mx, lo, hi):
        t1 = (mn - o) * inv
        t2 = (mx - o) * inv
        tn, tx = np.minimum(t1, t2).max(), np.maximum(t1, t2).min()
        return (tn <= tx) and (tx >= lo) and (tn <= hi), tn

    best_t, best_p, tests, found = f(1e30), -1, 0, False
    root = nodes[-1]
    stack = [0] if t_lo <= t_hi and box(root[0:3], root[3:6], t_lo, t_hi)[0] else []
    while stack:
        if any_hit and found:
            break
        row = nodes[stack.pop()]
        c0, c1 = as_int(row[12]), as_int(row[13])
        if c1 < 0:
            for slot in range(c0, c0 - c1):
                g = prims[slot]
                pid = as_int(g[9])
                hi = min(t_hi, best_t)
                if pid < num_tris:
                    p0, e1, e2 = g[0:3], g[3:6], g[6:9]
                    s = o - p0
                    s1, s2 = np.cross(d, e2), np.cross(s, e1)
                    det = f(s1 @ e1)
                    inv_det = f(1) / det if det != 0 else f(0)
                    t = f(s2 @ e2) * inv_det
                    b1, b2 = f(s1 @ s) * inv_det, f(s2 @ d) * inv_det
                    ok = det != 0 and t_lo <= t <= hi and 0 <= b1 <= 1 and 0 <= b2 <= 1 and b1 + b2 <= 1
                else:
                    oc = o - g[0:3]
                    a, b = f(d @ d), f(2) * f(oc @ d)
                    disc = b * b - f(4) * a * (f(oc @ oc) - g[3] * g[3])
                    sq = np.sqrt(max(disc, f(0)))
                    t1, t2 = (-b - sq) / (f(2) * a), (-b + sq) / (f(2) * a)
                    t = t1 if t_lo <= t1 <= hi else t2
                    ok = disc >= 0 and t_lo <= t <= hi
                if ok:
                    found = True
                    if t < best_t:
                        best_t, best_p = t, pid
                tests += 1
            continue
        hi = min(t_hi, best_t)
        l_ok, l_t = box(row[0:3], row[3:6], t_lo, hi)
        r_ok, r_t = box(row[6:9], row[9:12], t_lo, hi)
        near_left = l_t <= r_t
        for child, ok in ((c1, r_ok), (c0, l_ok)) if near_left else ((c0, l_ok), (c1, r_ok)):
            if ok:
                stack.append(child)
    return best_t, best_p, found, tests


@pytest.mark.parametrize("name", ["terrain", "triangles_and_spheres"])
def test_packed_walk_matches_xla(name):
    """The kernel's algorithm on the packed arrays reproduces the XLA traversal."""
    dev = _device(SCENES[name]())
    nodes, prims = np.asarray(dev.bvh_nodes), np.asarray(dev.bvh_prims)
    o, d, lo, hi = _rays(n=48, seed=4)
    hi[:6] = 0.0
    for any_hit in (False, True):
        t, prim, _, _, found, tests = (
            np.asarray(v) for v in traverse_xla(dev, o, d, lo, hi, any_hit=any_hit)
        )
        for i in range(len(o)):
            wt, wp, wf, wn = _walk_packed(
                nodes, prims, dev.tri_p0.shape[0], o[i], d[i], lo[i], hi[i], any_hit
            )
            assert (wf, wn) == (bool(found[i]), int(tests[i])), (i, any_hit)
            if not any_hit:
                assert wp == prim[i], i
                np.testing.assert_allclose(wt, t[i], rtol=1e-6)


def test_pack_layout():
    dev = _device(SCENES["triangles_and_spheres"]())
    nodes, prims = np.asarray(dev.bvh_nodes), np.asarray(dev.bvh_prims)
    m = dev.node_min.shape[0]
    assert nodes.shape == (m + 1, NODE_WIDTH) and prims.shape == (dev.prim_order.shape[0], PRIM_WIDTH)
    links = nodes[:m, 12:14].view(np.int32)
    leaf = np.asarray(dev.node_count) > 0
    np.testing.assert_array_equal(links[leaf, 0], np.asarray(dev.node_start)[leaf])
    np.testing.assert_array_equal(-links[leaf, 1], np.asarray(dev.node_count)[leaf])
    np.testing.assert_array_equal(links[~leaf, 0], np.asarray(dev.node_left)[~leaf])
    np.testing.assert_array_equal(links[~leaf, 1], np.asarray(dev.node_right)[~leaf])
    # interior rows carry their children's boxes; leaf rows none
    left = np.asarray(dev.node_left)[~leaf]
    np.testing.assert_array_equal(nodes[:m][~leaf, 0:3], np.asarray(dev.node_min)[left])
    np.testing.assert_array_equal(nodes[:m][~leaf, 9:12], np.asarray(dev.node_max)[np.asarray(dev.node_right)[~leaf]])
    assert (nodes[:m][leaf, :12] == 0).all()
    np.testing.assert_array_equal(nodes[m, 0:3], np.asarray(dev.node_min)[0])
    np.testing.assert_array_equal(nodes[m, 3:6], np.asarray(dev.node_max)[0])
    # primitive rows in leaf order, ids bit-cast into slot 9
    ids = prims[:, 9].view(np.int32)
    np.testing.assert_array_equal(ids, np.asarray(dev.prim_order))
    n_t = dev.tri_p0.shape[0]
    tri = ids < n_t
    np.testing.assert_array_equal(prims[tri, 0:3], np.asarray(dev.tri_p0)[ids[tri]])
    np.testing.assert_array_equal(prims[tri, 6:9], np.asarray(dev.tri_e2)[ids[tri]])
    np.testing.assert_array_equal(prims[~tri, 3], np.asarray(dev.sph_radius)[ids[~tri] - n_t])


def test_pack_functions_accept_numpy_and_empty_tables():
    nodes = pack_nodes(
        np.zeros((1, 3)), np.ones((1, 3)), np.array([-1]), np.array([-1]),
        np.array([0]), np.array([2]),
    )
    assert nodes.shape == (2, NODE_WIDTH)
    z3 = jnp.zeros((0, 3))
    prims = pack_prims(np.array([0, 1]), z3, z3, z3, jnp.ones((2, 3)), jnp.array([1.0, 2.0]))
    np.testing.assert_array_equal(np.asarray(prims)[:, 3], [1.0, 2.0])
    assert pack_prims(np.zeros(0, np.int32), z3, z3, z3, z3, jnp.zeros(0)).shape == (0, PRIM_WIDTH)


def test_pad_lanes_adds_dead_lanes():
    o, d, lo, hi = (jnp.asarray(x) for x in _rays(n=10))
    (po, pd, plo, phi), n = pad_lanes(o, d, lo, hi, 4)
    assert n == 10 and po.shape == (12, 3) and pd.shape == (12, 3)
    np.testing.assert_array_equal(np.asarray(po[:10]), np.asarray(o))
    assert (np.asarray(plo[10:]) > np.asarray(phi[10:])).all()  # empty interval
    same, n2 = pad_lanes(o, d, lo, hi, 5)
    assert n2 == 10 and same[0] is o


def test_sharded_traversal_pads_and_matches():
    """Under a context mesh the lanes run under shard_map, padded to divide."""
    from lens_flare.parallel.mesh import make_mesh

    dev = _device(SCENES["triangles_and_spheres"]())
    o, d, lo, hi = _rays(n=30)  # 30 lanes over 4 devices: 2 lanes of padding
    want = [np.asarray(v) for v in traverse(dev, o, d, lo, hi)]
    mesh = make_mesh(4)
    with jax.set_mesh(mesh):
        got = [np.asarray(v) for v in jax.jit(traverse)(dev, o, d, lo, hi)]
        text = jax.jit(traverse).lower(dev, o, d, lo, hi).as_text()
    assert "shard_map" in text or "manual" in text.lower()
    for a, b in zip(got, want):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize(
    "platform,impl", [("cpu", "xla"), ("gpu", "cuda"), ("cuda", "cuda")]
)
def test_traversal_impl_by_platform(platform, impl):
    assert traversal_impl(platform) == impl


def test_traversal_impl_rejects_unknown_platform():
    with pytest.raises(ValueError, match="no ray traversal"):
        traversal_impl("rocm")


def test_traverse_dispatches_by_default_backend(monkeypatch):
    import lens_flare.ops.traverse as trav

    called = []
    monkeypatch.setattr(trav, "_traverse_cuda", lambda *a: called.append("cuda") or trav._misses(a[1].shape[0]))
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    dev = _device(SCENES["terrain"]())
    o, d, lo, hi = _rays(n=8)
    trav.traverse(dev, o, d, lo, hi)
    assert called == ["cuda"]
    monkeypatch.setattr(jax, "default_backend", lambda: "rocm")
    with pytest.raises(ValueError):
        trav.traverse(dev, o, d, lo, hi)


@pytest.mark.gpu
def test_cuda_kernel_matches_xla(gpu_device):
    dev = _device(make_terrain_scene(64))
    o, d, lo, hi = _rays(n=4096, seed=5)
    hi[::7] = 0.0
    for any_hit in (False, True):
        k = [np.asarray(v) for v in jax.jit(lambda *a: traverse(*a, any_hit=any_hit, impl="cuda"))(dev, o, d, lo, hi)]
        x = [np.asarray(v) for v in jax.jit(lambda *a: traverse(*a, any_hit=any_hit, impl="xla"))(dev, o, d, lo, hi)]
        np.testing.assert_array_equal(k[4], x[4])
        np.testing.assert_array_equal(k[5], x[5])
        if not any_hit:
            np.testing.assert_array_equal(k[1], x[1])
            np.testing.assert_allclose(k[0], x[0], rtol=1e-5)
