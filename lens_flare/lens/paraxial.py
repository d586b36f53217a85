"""Paraxial ghost tracing: batched 2x2 ray-transfer matrix chains.

Re-design of ``trace_ray_auto_before`` / ``trace_ray_auto_after``
(``pathtracer.cpp:588-689``): instead of two separate recursive C++ functions,
one uniform masked product over interface index k, vmapped over all
(reflection-pair, wavelength) combinations.  The aperture-stop re-cast
(pathtracer.cpp:618-633) occurs exactly once per trace — whenever interface 5
is crossed in a forward phase — so a single masked clamp covers both the
"before" and "after" pair cases.

Matrix conventions (pathtracer.cpp:511-537):
  T(d)        = [[1, d], [0, 1]]                  translation by gap d
  R(c,n1,n2)  = [[1, 0], [c(n1-n2)/n2, n1/n2]]    refraction at curvature c
  L(c)        = [[1, 0], [2c, 1]]                 reflection at curvature c

Everything is differentiable w.r.t. the :class:`LensPrescription` arrays.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .prescription import LensPrescription


def _matmul2(a, b):
    """2x2 matmul for (..., 2, 2) stacks."""
    return jnp.einsum("...ij,...jk->...ik", a, b, precision="highest")


def _inv2(m):
    det = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    inv = jnp.stack(
        [
            jnp.stack([m[..., 1, 1], -m[..., 0, 1]], axis=-1),
            jnp.stack([-m[..., 1, 0], m[..., 0, 0]], axis=-1),
        ],
        axis=-2,
    )
    return inv / det[..., None, None]


def build_matrices(lens: LensPrescription):
    """Per-interface T, R (per wavelength), L stacks.

    Returns (T (N,2,2), R (3,N,2,2), L (N,2,2)) for N interfaces.
    """
    n = lens.num_interfaces
    zeros = jnp.zeros(n)
    ones = jnp.ones(n)

    T = jnp.stack(
        [
            jnp.stack([ones, lens.spacings], axis=-1),
            jnp.stack([zeros, ones], axis=-1),
        ],
        axis=-2,
    )

    c = lens.curvatures[:n]
    n_prev = jnp.concatenate([jnp.ones((3, 1)), lens.iors[:, : n - 1]], axis=1)  # (3, N)
    n_next = lens.iors  # (3, N)
    R = jnp.stack(
        [
            jnp.stack([jnp.ones((3, n)), jnp.zeros((3, n))], axis=-1),
            jnp.stack([c * (n_prev - n_next) / n_next, n_prev / n_next], axis=-1),
        ],
        axis=-2,
    )  # (3, N, 2, 2)

    L = jnp.stack(
        [
            jnp.stack([ones, zeros], axis=-1),
            jnp.stack([2.0 * c, ones], axis=-1),
        ],
        axis=-2,
    )
    return T, R, L


class GhostTrace(NamedTuple):
    r_out: jnp.ndarray  # sensor height
    theta_out: jnp.ndarray  # sensor angle


def trace_ghost(lens: LensPrescription, T, R_c, L, i, j, r_in, theta):
    """Trace one marginal ray through reflection pair (i, j) for one wavelength.

    T: (N,2,2), R_c: (N,2,2) for this wavelength, L: (N,2,2); i < j scalars.
    Mirrors pathtracer.cpp:588-689 with masked per-interface steps.
    """
    n = lens.num_interfaces
    ap = lens.aperture_index
    eye = jnp.eye(2)
    ray = jnp.array([0.0, 0.0]) + jnp.stack([r_in, theta])

    def fwd_step(k, M, ray, active):
        """Forward crossing of interface k: aperture clamp at k == ap."""
        if k == ap:
            a_x = M[0, 0] * ray[0] + M[0, 1] * ray[1]
            over = jnp.abs(a_x) > lens.aperture_height
            # reference quirk: negative rays clamp to -(h - 0.1) (pathtracer.cpp:623-625)
            r_a = jnp.where(r_in < 0, -(lens.aperture_height - 0.1), lens.aperture_height)
            r_e = (r_a - M[0, 1] * ray[1]) / M[0, 0]
            new_ray = jnp.stack([r_e, ray[1]])
            ray = jnp.where(active & over, new_ray, ray)
            M_new = _matmul2(T[k], M)  # crossing the iris: translation only
        else:
            M_new = _matmul2(T[k], _matmul2(R_c[k], M))
        M = jnp.where(active, M_new, M)
        return M, ray

    # phase A: forward through interfaces k < j
    M = eye
    for k in range(n):
        M, ray = fwd_step(k, M, ray, k < j)

    # phase B: reflect off surface j
    M = _matmul2(L[j], M)

    # phase C: backward k = j-1 .. i+1 (inverse refractions)
    for k in range(n - 1, 0, -1):
        active = (k < j) & (k > i)
        M_new = _matmul2(_inv2(R_c[k]), _matmul2(T[k], M))
        M = jnp.where(active, M_new, M)

    # phase D: reflect off surface i and head forward again
    M = _matmul2(T[i], _matmul2(_inv2(L[i]), _matmul2(T[i], M)))

    # phase E: forward k > i to the sensor
    for k in range(n):
        M, ray = fwd_step(k, M, ray, k > i)

    res = jnp.matmul(M, ray, precision="highest")
    return GhostTrace(r_out=res[0], theta_out=res[1])


def physical_ghost_matrix(lens: LensPrescription, i: int, j: int, color: int):
    """Physically-consistent first-order (2x2) matrix for ghost pair (i, j).

    This is the TRUE paraxial limit of the sequential Snell+Fresnel stack
    (lens/realistic.py) under standard mirror unfolding:

      forward crossings:   T(d_k) @ R(c_k, n1, n2)
      first reflection j:  L(+c_j)
      backward crossings:  R(-c_k, n2, n1) @ T(d_k)   (media swapped AND
                           curvature sign flipped — the surface is crossed
                           from the other side)
      second reflection i: L(-c_i)
      forward to sensor:   T(d_k) @ R(c_k, n1, n2)

    It is verified (tests/test_lens.py) that the autodiff jacobian of the
    realistic stack at (h, theta) = (0, 0) equals this product EXACTLY for
    all 13 reference pairs x 3 wavelengths — the non-circular correctness
    check between the two ghost models.

    The REFERENCE's trace (pathtracer.cpp:588-689, reproduced by
    :func:`trace_ghost`) instead uses inv(R(c, n1, n2)) on the backward
    crossings and inv(L(c_i)) at the second bounce.  inv(R) equals the
    physical backward refraction with the WRONG curvature sign (swapping
    media already inverts the n-ratio; the sign of c must flip too), and
    inv(L(c)) = L(-c) matches.  The two models therefore agree exactly
    whenever the backward segment crosses no curved refracting surface
    (e.g. pairs (i, i+1) and the aperture-adjacent after-pairs) and differ
    by a constant linear factor otherwise — an intentional reference
    parity quirk, kept in :func:`trace_ghost`, documented here.

    Returns M (2, 2): [r_out, theta_out] = M @ [r_in, theta_in] with the
    ray state taken just before interface 0, exactly like
    :func:`trace_ghost`.  Differentiable w.r.t. the prescription.
    """
    n = lens.num_interfaces
    ap = lens.aperture_index
    iors = lens.iors[color]

    def Tm(d):
        return jnp.array([[1.0, d], [0.0, 1.0]])

    def Rm(c, n1, n2):
        return jnp.array([[1.0, 0.0], [c * (n1 - n2) / n2, n1 / n2]])

    def Lm(c):
        return jnp.array([[1.0, 0.0], [2.0 * c, 1.0]])

    def media(k):
        n1 = jnp.asarray(1.0, iors.dtype) if k == 0 else iors[k - 1]
        return n1, iors[k]

    M = jnp.eye(2, dtype=lens.curvatures.dtype)
    for k in range(j):
        n1, n2 = media(k)
        Rk = jnp.eye(2) if k == ap else Rm(lens.curvatures[k], n1, n2)
        M = _matmul2(_matmul2(Tm(lens.spacings[k]), Rk), M)
    M = _matmul2(Lm(lens.curvatures[j]), M)
    for k in range(j - 1, i, -1):
        n1, n2 = media(k)
        Rk = jnp.eye(2) if k == ap else Rm(-lens.curvatures[k], n2, n1)
        M = _matmul2(_matmul2(Rk, Tm(lens.spacings[k])), M)
    M = _matmul2(_matmul2(_matmul2(Tm(lens.spacings[i]), Lm(-lens.curvatures[i])), Tm(lens.spacings[i])), M)
    for k in range(i + 1, n):
        n1, n2 = media(k)
        Rk = jnp.eye(2) if k == ap else Rm(lens.curvatures[k], n1, n2)
        M = _matmul2(_matmul2(Tm(lens.spacings[k]), Rk), M)
    return M


def reference_ghost_pairs():
    """The 13 reflection pairs the reference enumerates (pathtracer.cpp:735-762)."""
    pairs = [(i, j) for i in range(5) for j in range(i + 1, 5)]
    pairs += [(i, j) for i in range(6, 9) for j in range(i + 1, 9)]
    return pairs


def trace_all_ghosts(lens: LensPrescription, theta):
    """Sensor footprints for every (pair, wavelength) ghost.

    Returns (r1, r2) each of shape (n_pairs, 3): sensor heights of the
    +marginal_r and -marginal_r rays (pathtracer.cpp:737-746).
    """
    T, R, L = build_matrices(lens)
    pairs = jnp.asarray(reference_ghost_pairs())  # (P, 2)

    def one(pair, color):
        i, j = pair[0], pair[1]
        t1 = trace_ghost(lens, T, R[color], L, i, j, lens.marginal_r, theta)
        t2 = trace_ghost(lens, T, R[color], L, i, j, -lens.marginal_r, theta)
        return t1.r_out, t2.r_out

    f = jax.vmap(jax.vmap(one, in_axes=(None, 0)), in_axes=(0, None))
    r1, r2 = f(pairs, jnp.arange(3))
    return r1, r2
