"""Mesh-edit operations (reference stubs at meshEdit.cpp:6-106).

Covers the three local operations (flip/split/collapse), Loop subdivision
(operation-based sequence vs vectorized array formulation), quadric
downsampling and isotropic resampling, each with full structural-invariant
checks after every mutation.
"""

import numpy as np
import pytest

from lens_flare.scene.halfedge import (
    HalfedgeMesh,
    loop_subdivide,
    weld,
)


def icosahedron():
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    v = np.array([
        [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
        [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
        [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
    ], float)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    f = np.array([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
    ])
    return v, f


def open_grid(n=4):
    """n x n vertex grid (open boundary), 2(n-1)^2 triangles."""
    xs, ys = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    verts = np.stack([xs, ys, np.zeros_like(xs)], axis=-1).reshape(-1, 3)
    faces = []
    for i in range(n - 1):
        for j in range(n - 1):
            a = i * n + j
            b = a + 1
            c = a + n
            d = c + 1
            faces += [[a, b, d], [a, d, c]]
    return verts.astype(float), np.array(faces)


def canon_tris(pos, faces):
    """Order-independent triangle set as sorted rounded coordinate rows."""
    tri = np.round(pos[faces], 5).reshape(len(faces), 9)
    tri = np.sort(tri.reshape(len(faces), 3, 3), axis=1).reshape(-1, 9)
    return set(map(tuple, tri))


def euler(mesh):
    return mesh.n_vertices - mesh.n_edges + mesh.n_faces


# ----------------------------------------------------------------------
# construction
# ----------------------------------------------------------------------
def test_build_closed_and_boundary():
    m = HalfedgeMesh(*icosahedron())
    m.check()
    assert (m.n_vertices, m.n_edges, m.n_faces) == (12, 30, 20)
    assert euler(m) == 2
    assert not any(m.is_boundary_vertex(v) for v in range(12))

    g = HalfedgeMesh(*open_grid(4))
    g.check()
    assert g.n_vertices == 16 and g.n_faces == 18
    assert euler(g) == 1  # disk topology
    assert g.is_boundary_vertex(0) and not g.is_boundary_vertex(5)

    # round-trip through to_arrays rebuilds the identical triangle set
    pos, faces = g.to_arrays()
    assert canon_tris(pos, faces) == canon_tris(*open_grid(4))


# ----------------------------------------------------------------------
# flip
# ----------------------------------------------------------------------
def test_flip_edge():
    m = HalfedgeMesh(*icosahedron())
    before = (m.n_vertices, m.n_edges, m.n_faces)
    # flip every interior edge once; counts are invariant, structure stays
    # manifold, and the flipped edge connects the previous opposite pair
    for e in range(m.n_edges):
        a, b = m.endpoints(e)
        h0 = m.e_half[e]
        c = m.h_vert[m.h_next[m.h_next[h0]]]
        d = m.h_vert[m.h_next[m.h_next[m.h_twin[h0]]]]
        r = m.flip_edge(e)
        m.check()
        if r is None:
            continue
        na, nb = m.endpoints(e)
        assert {na, nb} == {c, d} != {a, b}
    assert (m.n_vertices, m.n_edges, m.n_faces) == before

    # flipping a boundary edge is a silent no-op (mesh.cpp flow)
    g = HalfedgeMesh(*open_grid(3))
    bedges = [e for e in range(g.n_edges) if g.is_boundary_edge(e)]
    assert g.flip_edge(bedges[0]) is None
    g.check()


def test_flip_rejects_duplicate_edge():
    # tetrahedron: flipping any edge would connect already-adjacent verts
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], float)
    f = np.array([[0, 2, 1], [0, 1, 3], [1, 2, 3], [0, 3, 2]])
    t = HalfedgeMesh(v, f)
    for e in range(t.n_edges):
        assert t.flip_edge(e) is None
    t.check()


# ----------------------------------------------------------------------
# split
# ----------------------------------------------------------------------
def test_split_interior_edge():
    m = HalfedgeMesh(*icosahedron())
    V, E, F = m.n_vertices, m.n_edges, m.n_faces
    e = 0
    a, b = m.endpoints(e)
    mid = 0.5 * (m.pos[a] + m.pos[b])
    v, along, cross = m.split_edge(e)
    m.check()
    assert (m.n_vertices, m.n_edges, m.n_faces) == (V + 1, E + 3, F + 2)
    assert np.allclose(m.pos[v], mid)
    # contract: the new vertex's halfedge points along the split edge
    h = m.v_half[v]
    assert m.h_vert[h] == v and m.h_vert[m.h_next[h]] in (a, b)
    # along edges reconnect a-v and v-b; cross edges attach the corners
    ends = {frozenset(m.endpoints(x)) for x in along}
    assert ends == {frozenset((a, v)), frozenset((v, b))}
    for x in cross:
        assert v in m.endpoints(x)
    assert euler(m) == 2


def test_split_boundary_edge():
    g = HalfedgeMesh(*open_grid(3))
    V, E, F = g.n_vertices, g.n_edges, g.n_faces
    e = next(e for e in range(g.n_edges) if g.is_boundary_edge(e))
    v, along, cross = g.split_edge(e)
    g.check()
    # boundary split: 1 face -> 2, +1 vertex, +2 edges (1 along + 1 cross)
    assert (g.n_vertices, g.n_edges, g.n_faces) == (V + 1, E + 2, F + 1)
    assert g.is_boundary_vertex(v)
    assert euler(g) == 1


# ----------------------------------------------------------------------
# collapse
# ----------------------------------------------------------------------
def test_collapse_interior_edge():
    m = HalfedgeMesh(*icosahedron())
    V, E, F = m.n_vertices, m.n_edges, m.n_faces
    e = 0
    a, b = m.endpoints(e)
    mid = 0.5 * (m.pos[a] + m.pos[b])
    v = m.collapse_edge(e)
    m.check()
    assert v is not None
    assert (m.n_vertices, m.n_edges, m.n_faces) == (V - 1, E - 3, F - 2)
    assert np.allclose(m.pos[v], mid)
    assert euler(m) == 2
    # explicit target position is honored (downsample uses this)
    e2 = next(e2 for e2 in range(len(m.e_alive)) if m.e_alive[e2]
              and m.collapse_edge(e2, point=[9.0, 9.0, 9.0]) is not None)
    m.check()


def test_collapse_guards():
    # tetrahedron: any collapse would destroy manifoldness -> rejected
    v = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], float)
    f = np.array([[0, 2, 1], [0, 1, 3], [1, 2, 3], [0, 3, 2]])
    t = HalfedgeMesh(v, f)
    for e in range(t.n_edges):
        assert t.collapse_edge(e) is None
    t.check()
    # boundary edges are rejected
    g = HalfedgeMesh(*open_grid(4))
    be = next(e for e in range(g.n_edges) if g.is_boundary_edge(e))
    assert g.collapse_edge(be) is None
    g.check()


# ----------------------------------------------------------------------
# Loop subdivision: op-based sequence == vectorized array path
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mesh_fn", [icosahedron, lambda: open_grid(4)])
def test_upsample_matches_vectorized(mesh_fn):
    verts, faces = mesh_fn()
    m = HalfedgeMesh(verts, faces)
    V, E, F = m.n_vertices, m.n_edges, m.n_faces
    m.upsample()
    m.check()
    # Loop subdivision counts: V' = V + E, F' = 4F
    assert m.n_vertices == V + E
    assert m.n_faces == 4 * F

    pos_ops, faces_ops = m.to_arrays()
    pos_vec, faces_vec = loop_subdivide(verts, faces)
    assert len(pos_vec) == V + E and len(faces_vec) == 4 * F
    # identical triangle sets (coordinate-level, order-independent)
    assert canon_tris(pos_ops, faces_ops) == canon_tris(pos_vec, faces_vec)


def test_upsample_shrinks_toward_sphere():
    # Loop subdivision of a convex solid is smoothing: strictly inside,
    # and radius spread tightens
    verts, faces = icosahedron()
    pos, f2 = loop_subdivide(verts, faces, levels=2)
    r = np.linalg.norm(pos, axis=1)
    assert r.max() <= 1.0 + 1e-9
    assert r.std() < np.linalg.norm(verts, axis=1).std() + 0.02
    assert len(f2) == len(faces) * 16


# ----------------------------------------------------------------------
# quadric downsample
# ----------------------------------------------------------------------
def test_downsample_quadric():
    verts, faces = icosahedron()
    pos, f4 = loop_subdivide(verts, faces, levels=2)  # 320 faces
    m = HalfedgeMesh(pos, f4)
    m.downsample()  # default target F/4
    m.check()
    assert m.n_faces <= len(f4) // 4
    assert euler(m) == 2  # still a sphere
    # quadric-optimal placement keeps the surface near the unit sphere
    dp, df = m.to_arrays()
    r = np.linalg.norm(dp, axis=1)
    assert 0.65 < r.min() and r.max() < 1.1


def test_downsample_flat_patch_preserves_plane():
    # a flat grid's quadrics are planar: simplified verts stay in-plane
    g = HalfedgeMesh(*open_grid(6))
    faces_before = g.n_faces
    g.downsample(target_faces=faces_before // 2)
    g.check()
    assert g.n_faces <= faces_before // 2 + 2
    dp, _ = g.to_arrays()
    assert np.abs(dp[:, 2]).max() < 1e-6


# ----------------------------------------------------------------------
# isotropic resample
# ----------------------------------------------------------------------
def test_resample_isotropic():
    rng = np.random.default_rng(0)
    verts, faces = icosahedron()
    pos, f2 = loop_subdivide(verts, faces)
    # warp to make edge lengths uneven
    pos = pos * (1.0 + 0.3 * np.sin(5.0 * pos[:, :1]))
    m = HalfedgeMesh(pos, f2)
    lens_before = np.array([m.edge_length(e) for e in range(len(m.e_alive))
                            if m.e_alive[e]])
    m.resample(iterations=3)
    m.check()
    lens_after = np.array([m.edge_length(e) for e in range(len(m.e_alive))
                           if m.e_alive[e]])
    # relative edge-length spread improves
    cv_before = lens_before.std() / lens_before.mean()
    cv_after = lens_after.std() / lens_after.mean()
    assert cv_after < cv_before
    assert euler(m) == 2


# ----------------------------------------------------------------------
# triangle-soup bridge
# ----------------------------------------------------------------------
def test_weld_roundtrip():
    verts, faces = icosahedron()
    soup = verts[faces]  # (T,3,3)
    pos, f = weld(soup)
    assert len(pos) == 12 and len(f) == 20
    assert canon_tris(pos, f) == canon_tris(verts, faces)
    # degenerate (zero-area, repeated-vertex) triangles are dropped
    bad = np.concatenate([soup, soup[:1] * 0.0])
    bad[-1] = bad[-1][0]  # all three corners identical
    pos2, f2 = weld(bad)
    assert len(f2) == 20


def test_subdivide_scene_and_cli(tmp_path):
    """--upsample: Loop subdivision of every scene mesh on the offline path."""
    import jax

    from lens_flare.cli import main
    from lens_flare.renderer import Renderer
    from lens_flare.scene.build import load_scene
    from lens_flare.scene.halfedge import subdivide_scene

    dae = "/root/reference/dae/pyramid.dae"
    scene, _ = load_scene(dae)
    t0 = scene.num_triangles
    s2 = subdivide_scene(scene, 1)
    assert s2.num_triangles == 4 * t0
    # geometry stays inside the original bounds (Loop is contractive)
    assert (s2.bbox_min >= scene.bbox_min - 1e-4).all()
    assert (s2.bbox_max <= scene.bbox_max + 1e-4).all()
    # normals are unit
    nn = np.linalg.norm(s2.tri_n.reshape(-1, 3), axis=1)
    np.testing.assert_allclose(nn, 1.0, atol=1e-4)

    out = tmp_path / "up.png"
    rc = main([
        "-s", "1", "-m", "1", "-r", "24", "18", "--upsample", "1",
        "-f", str(out), dae,
    ])
    assert rc == 0 and out.exists()
