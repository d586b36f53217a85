r"""FFT Fraunhofer-diffraction starburst.

The reference evaluates, for every output pixel, a brute-force 2-D DFT over
the aperture mask (``raytrace_starburst``, pathtracer.cpp:947-1041):

    I(x, y) = | sum_{xc,yc} A[yc,xc] e^{-2 pi i (u x' + v y')}
                                      e^{+2 pi i (u lr + v ud)} | / total
    with u = xc/apW - 0.5, v = yc/apW - 0.5

— O(W*H*A^2) work (~10^13 mults at 1080p).  This module computes the exact
same field with ONE FFT of the mask + a gather, using the identity::

    u x' + v y' - (u lr + v ud)
      = (xc dX + yc dY) / apW  - (x'-lr + y'-ud)/2

where ``x' = convertCoordinate(x)`` and the shifted sun coords ``lr, ud``
(compute_phase, pathtracer.cpp:917-931) are all integers, so the sum is a
length-apW DFT bin:  |F[dY mod apW, dX mod apW]| with
F = fft2(A zero-padded to (apW, apW)).  The half-integer offset (-0.5 in u,v)
contributes only a constant phase, which the |.| kills.  A small-size
exhaustive test (tests/test_starburst.py) proves the equivalence against the
brute-force oracle.

The post-DFT curves — suppression ``(apW/2 / dist)^8`` outside the mask
radius, amplification ``I^(dist/flare_radius)`` inside, exponent
``3 - flare_intensity`` — and the 16-sample jittered irradiance falloff
(pathtracer.cpp:976-1063) are applied per pixel, fully batched.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def aperture_fft(aperture: jnp.ndarray) -> jnp.ndarray:
    """|FFT2| of the mask zero-padded to (apW, apW) (frequency table)."""
    h_a, w_a = aperture.shape
    if h_a < w_a:
        aperture = jnp.pad(aperture, ((0, w_a - h_a), (0, 0)))
    elif h_a > w_a:
        # the reference divides BOTH axes by width; taller-than-wide masks
        # would alias — no such masks exist in the corpus
        raise ValueError("aperture masks must have height <= width")
    return jnp.abs(jnp.fft.fft2(aperture))


def starburst_field(
    fft_mag: jnp.ndarray,
    total_value,
    ap_width: int,
    flare_origin_ns,  # (2,) sun in normalized screen coords
    flare_radiance,  # (3,) summed radiance of flare lights
    width: int,
    height: int,
    flare_intensity: float = 0.0,
    flare_radius: float = 0.0,
):
    """Starburst radiance for the whole film -> (H, W, 3).

    Matches raytrace_starburst per pixel (minus the stochastic falloff, which
    is :func:`irradiance_falloff`).
    """
    xs = jnp.arange(width)
    ys = jnp.arange(height)
    x, y = jnp.meshgrid(xs, ys)  # (H, W)

    # compute_phase (pathtracer.cpp:917-931)
    lr = jnp.ceil(flare_origin_ns[0] * width)
    ud = jnp.ceil(flare_origin_ns[1] * height)
    lr_c = lr - width / 2.0
    ud_c = height / 2.0 - ud

    # The per-pixel table lookup is a 2M-element gather at 1080p; it
    # factorizes gather-free.  Derivation: the per-texel exponent is
    # u*(x'-lr_c) + v*(y'-ud_c) with x' = convertCoordinate(x) (pathtracer.
    # cpp:933-945).  Both x' and lr_c carry the same real W/2.0 term, so the
    # differences are ALWAYS integers, for odd sizes too:
    #     Dx = x - lr + W*[x < ceil(W/2)]     (x-branch of the fold)
    #     Dy = ud - y + H*[y > floor(H/2)]    (y-branch)
    # and S[y, x] = |F[Dy mod a, Dx mod a]| (the half-integer u,v offsets
    # contribute a constant phase killed by |.|).  Each branch is a
    # contiguous run of pixels whose index advances by +-1, so the field
    # assembles from four dynamic slices of the tiled table (rows flipped,
    # because Dy decreases with y) — no per-pixel gather.  Exactness vs the
    # brute-force DFT oracle is tested for even AND odd W/H/apW
    # (tests/test_flare.py::test_starburst_fft_matches_bruteforce_dft).
    a = ap_width
    ty = -(-(height + a) // a)
    tx = -(-(width + a) // a)
    tiled = jnp.tile(fft_mag, (ty, tx))
    lr_i = lr.astype(jnp.int32)
    ud_i = ud.astype(jnp.int32)
    cx = (width + 1) // 2  # first x with x - W/2.0 >= 0
    cy = height // 2 + 1  # first y with H/2.0 - y < 0
    wt = tiled.shape[1]

    def row_block(start_idx, size):
        # rows with index (start_idx + k) mod a for k in [0, size), flipped
        s = jnp.mod(start_idx, a)
        zero = jnp.zeros((), s.dtype)  # match index dtypes (x64 mode)
        return jnp.flip(jax.lax.dynamic_slice(tiled, (s, zero), (size, wt)), axis=0)

    # y in [0, cy): Dy = ud - y          -> flipped run ending at ud
    # y in [cy, H): Dy = ud - y + H      -> flipped run ending at ud + H - cy
    rows = jnp.concatenate(
        [row_block(ud_i - (cy - 1), cy), row_block(ud_i + 1, height - cy)]
        if height > cy
        else [row_block(ud_i - (cy - 1), cy)],
        axis=0,
    )

    def col_block(start_idx, size):
        s = jnp.mod(start_idx, a)
        zero = jnp.zeros((), s.dtype)
        return jax.lax.dynamic_slice(rows, (zero, s), (height, size))

    # x in [0, cx): Dx = x - lr + W;  x in [cx, W): Dx = x - lr
    base = jnp.concatenate(
        [col_block(width - lr_i, cx), col_block(cx - lr_i, width - cx)]
        if width > cx
        else [col_block(width - lr_i, cx)],
        axis=1,
    )
    mag = base / total_value

    # suppression / amplification (pathtracer.cpp:976-992).  Selected-branch
    # inputs are sanitized before the pow so gradients through the unselected
    # where-branches stay finite (aperture-mask optimization, config 5).
    xs = jnp.arange(width)
    ys = jnp.arange(height)
    x, y = jnp.meshgrid(xs, ys)
    dist = jnp.sqrt((lr - x) ** 2 + (ud - y) ** 2)
    half_ap = ap_width / 2.0

    far_sel = dist > half_ap
    safe_dist = jnp.where(far_sel, jnp.maximum(dist, 1e-6), 1.0)
    mag_far = (half_ap / safe_dist) ** 8 * mag

    near_sel = jnp.logical_not(far_sel) & (dist <= flare_radius) & (flare_radius > 0)
    safe_mag = jnp.where(near_sel, jnp.maximum(mag, 1e-20), 1.0)
    mag_near = safe_mag ** (dist / jnp.maximum(flare_radius, 1e-12))

    mag = jnp.where(far_sel, mag_far, jnp.where(near_sel, mag_near, mag))

    intensity = 3.0 - flare_intensity
    intensity = jnp.where(intensity <= 0, 2.0, intensity)

    return (jnp.maximum(mag, 0.0) ** intensity)[..., None] * flare_radiance


def irradiance_falloff(
    flare_origins_ns,  # (F, 2)
    flare_radiances,  # (F, 3)
    width: int,
    height: int,
    key,
    radius: float = 5.0,
    num_samples: int = 16,
):
    """Jittered radial glow (calculate_irradiance_falloff, pathtracer.cpp:1043-1063)."""
    xs = jnp.arange(width)
    ys = jnp.arange(height)
    x, y = jnp.meshgrid(xs, ys)

    fo_s = flare_origins_ns * jnp.array([width, height])  # (F, 2)

    def one_sample(k):
        jit = jax.random.uniform(k, (2,))
        sx = x + jit[0]
        sy = y + jit[1]
        d = jnp.sqrt(
            (fo_s[:, 0][:, None, None] - sx) ** 2 + (fo_s[:, 1][:, None, None] - sy) ** 2
        )  # (F, H, W)
        r = 1.0 + jnp.maximum(0.0, d - radius)
        w = r ** -1.5  # 1 / r^1.5
        return jnp.einsum("fhw,fc->hwc", w, flare_radiances, precision="highest")

    keys = jax.random.split(key, num_samples)
    total = jax.vmap(one_sample)(keys).sum(axis=0)
    return total / num_samples
