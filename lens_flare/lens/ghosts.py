"""Ghost splatting: textured-quad rasterization as batched array ops.

Re-design of the reference's scanline software rasterizer
(``pathtracer.cpp:305-508``: ``draw_ghost`` -> ``rasterize_textured_triangle``
-> ``fill_textured_pixel``): every ghost quad is two textured triangles; here
each triangle's barycentric edge functions are evaluated for the whole film
at once and accumulated over ghosts with a scan, which keeps results
bit-comparable with the reference's per-pixel loop (same edge functions, same
vertex sort, same half-pixel offsets, same floor-indexed nearest texture
fetch) while being one fused XLA kernel.

Quirks reproduced on purpose (see docstrings): the second triangle of the
quad maps uv(0,0) to the *lr* corner (pathtracer.cpp:496-498), giving the
mirrored texture on that half, and intensity = 10/scale^2 pure-channel color
(pathtracer.cpp:481-494).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def _sort3_by_y(vx, vy, vu, vv):
    """3-element sort network on y (rasterize_textured_triangle:350-369)."""

    def cswap(i, j, vx, vy, vu, vv):
        swap = vy[j] < vy[i]

        def sw(a):
            ai = jnp.where(swap, a[j], a[i])
            aj = jnp.where(swap, a[i], a[j])
            return a.at[i].set(ai).at[j].set(aj)

        return sw(vx), sw(vy), sw(vu), sw(vv)

    vx, vy, vu, vv = cswap(0, 1, vx, vy, vu, vv)
    vx, vy, vu, vv = cswap(0, 2, vx, vy, vu, vv)
    vx, vy, vu, vv = cswap(1, 2, vx, vy, vu, vv)
    return vx, vy, vu, vv


def _raster_triangle(tex, width, height, vx, vy, vu, vv, color, xs, ys, smooth=False, smooth_eps=0.05):
    """One textured triangle -> (H*W, 3) additive contribution.

    tex: (h_a, w_a); vx/vy/vu/vv: (3,) vertex coords + uvs; color: (3,);
    xs, ys: (P,) integer pixel coords of the film.  ``smooth=True`` switches
    to the differentiable bilinear/soft-edge variant.
    """
    vx, vy, vu, vv = _sort3_by_y(vx, vy, vu, vv)
    # pixel centers as integer coords (rasterize:383-388)
    vx = vx - 0.5
    vy = vy - 0.5

    x0, x1, x2 = vx[0], vx[1], vx[2]
    y0, y1, y2 = vy[0], vy[1], vy[2]
    u0, u1, u2 = vu[0], vu[1], vu[2]
    v0, v1, v2 = vv[0], vv[1], vv[2]

    # bounding box, exclusive upper bound (rasterize:391-406)
    min_x = jnp.maximum(0.0, jnp.floor(jnp.minimum(jnp.minimum(x0, x1), x2)))
    max_x = jnp.minimum(width - 1.0, jnp.ceil(jnp.maximum(jnp.maximum(x0, x1), x2)))
    min_y = jnp.maximum(0.0, jnp.floor(y0))
    max_y = jnp.minimum(height - 1.0, jnp.ceil(y2))

    x = xs.astype(vx.dtype)
    y = ys.astype(vy.dtype)
    in_box = (x >= min_x) & (x < max_x) & (y >= min_y) & (y < max_y)

    # edge functions (fill_textured_pixel:309-319)
    alpha = (-(y1 - y0) * (x - x0) + (x1 - x0) * (y - y0)) / (
        -(y1 - y0) * (x2 - x0) + (x1 - x0) * (y2 - y0)
    )
    beta = (-(y2 - y1) * (x - x1) + (x2 - x1) * (y - y1)) / (
        -(y2 - y1) * (x0 - x1) + (x2 - x1) * (y0 - y1)
    )
    gamma = 1.0 - alpha - beta
    inside = (alpha >= 0) & (beta >= 0) & (gamma >= 0)

    u = u2 * alpha + u0 * beta + u1 * gamma
    v = v2 * alpha + v0 * beta + v1 * gamma

    h_a, w_a = tex.shape
    if smooth:
        # differentiable variant: bilinear fetch + sigmoid edge functions —
        # used by the lens-design optimization loop where the reference's
        # floor-indexed nearest fetch would give piecewise-constant gradients
        edge = jnp.minimum(jnp.minimum(alpha, beta), gamma)
        soft_inside = jax.nn.sigmoid(edge / smooth_eps)
        x0f = jnp.clip(u - 0.5, 0.0, w_a - 1.001)
        y0f = jnp.clip(v - 0.5, 0.0, h_a - 1.001)
        xi = jnp.floor(x0f).astype(jnp.int32)
        yi = jnp.floor(y0f).astype(jnp.int32)
        fx = x0f - xi
        fy = y0f - yi
        t00 = tex[yi, xi]
        t01 = tex[yi, jnp.minimum(xi + 1, w_a - 1)]
        t10 = tex[jnp.minimum(yi + 1, h_a - 1), xi]
        t11 = tex[jnp.minimum(yi + 1, h_a - 1), jnp.minimum(xi + 1, w_a - 1)]
        sample = (
            t00 * (1 - fx) * (1 - fy)
            + t01 * fx * (1 - fy)
            + t10 * (1 - fx) * fy
            + t11 * fx * fy
        )
        weight = jnp.where(in_box, sample * soft_inside, 0.0)
        return weight[:, None] * color

    # nearest fetch: pixels[int(floor(v) * w_a + u)] (fill_textured_pixel:338)
    flat_idx = jnp.floor(v) * w_a + u
    flat_idx = jnp.clip(flat_idx.astype(jnp.int32), 0, h_a * w_a - 1)
    sample = tex.reshape(-1)[flat_idx]

    weight = jnp.where(in_box & inside, sample, 0.0)
    return weight[:, None] * color


def ghost_corners(r1, r2, axis_ray, width, height):
    """Quad corners + color scale for one ghost (draw_ghost, pathtracer.cpp:433-498).

    Returns (corner_x (4,), corner_y (4,), intensity scalar) where corners are
    ordered [ul, ll, ur, lr] in screen space.
    """
    angle = jnp.arctan((axis_ray[1] - 0.5) / (axis_ray[0] - 0.5))
    shift_amt = -(r1 + r2) / 2.0 * 0.4
    scale_amt = jnp.abs(r2 - r1) * 0.2

    gb_mid_x = jnp.ceil(axis_ray[0] * width)
    gb_mid_y = jnp.ceil(axis_ray[1] * height)

    ca, sa = jnp.cos(angle), jnp.sin(angle)
    base = jnp.array([[-1.0, 1.0], [-1.0, -1.0], [1.0, 1.0], [1.0, -1.0]])  # ul,ll,ur,lr

    sxy = base * scale_amt
    rx = ca * sxy[:, 0] - sa * sxy[:, 1] + shift_amt * ca
    ry = sa * sxy[:, 0] + ca * sxy[:, 1] + shift_amt * sa

    intensity = 10.0 / jnp.maximum(scale_amt * scale_amt, 1e-12)
    return gb_mid_x + rx, gb_mid_y + ry, intensity


def splat_ghosts(tex, r1s, r2s, colors, axis_ray, width, height, smooth=False, scale=1):
    """Accumulate all ghosts into a ghost buffer (generate_ghost_buffer).

    tex: (h_a, w_a) ghost-aperture mask; r1s/r2s: (G,) sensor footprints;
    colors: (G, 3) pure-channel colors (unit); axis_ray: (2,) sun ns coords.
    Returns (H, W, 3).  ``smooth=True``: differentiable splatting for the
    lens-design loop.  ``scale>1``: evaluate the (pointwise) splat functions
    on a 1/scale subsampled pixel grid and bilinearly upsample — a speed
    knob for large films (the per-pixel texture fetch is gather-bound).
    """
    h_a, w_a = tex.shape
    if scale > 1:
        sub_h = height // scale
        sub_w = width // scale
        ys, xs = jnp.mgrid[0:sub_h, 0:sub_w]
        xs = (xs * scale + scale // 2).reshape(-1)
        ys = (ys * scale + scale // 2).reshape(-1)
        sub = splat_eval(tex, r1s, r2s, colors, axis_ray, width, height, xs, ys, smooth)
        sub = sub.reshape(sub_h, sub_w, 3)
        import jax.image

        return jax.image.resize(sub, (height, width, 3), method="bilinear")

    ys, xs = jnp.mgrid[0:height, 0:width]
    xs = xs.reshape(-1)
    ys = ys.reshape(-1)
    return splat_eval(tex, r1s, r2s, colors, axis_ray, width, height, xs, ys, smooth).reshape(
        height, width, 3
    )


_SQRT2 = 2.0**0.5


def canonical_ghost_card(tex, axis_ray, res: int = 1024):
    """Rotated ghost card on a res^2 grid spanning [-sqrt2, sqrt2]^2 quad units.

    Every ghost is the SAME image — the aperture texture mapped through
    draw_ghost's two-triangle uv assignment (pathtracer.cpp:496-498: the
    second triangle re-uses triangle 1's uvs, mirroring the texture about
    the quad diagonal) and rotated by the common angle-to-sun — differing
    only by scale and translation on the film.  Precomputing it once turns
    the per-ghost splat into a gather-free ``jax.image.scale_and_translate``
    (separable matmuls) instead of a per-pixel texture gather.
    """
    h_a, w_a = tex.shape
    angle = jnp.arctan((axis_ray[1] - 0.5) / (axis_ray[0] - 0.5))
    ca, sa = jnp.cos(angle), jnp.sin(angle)
    ys_, xs_ = jnp.mgrid[0:res, 0:res]
    lx = (xs_ + 0.5) / res * 2 * _SQRT2 - _SQRT2
    ly = (ys_ + 0.5) / res * 2 * _SQRT2 - _SQRT2
    # un-rotate film-local coords into quad coords
    qx = ca * lx + sa * ly
    qy = -sa * lx + ca * ly
    # triangle 1 (ul,ll,ur): u = w(qx+1)/2, v = h(1-qy)/2
    # triangle 2 (lr,ll,ur) with tri-1 uvs: u = w(qy+1)/2, v = h(1-qx)/2
    tri1 = qy >= qx
    u = jnp.where(tri1, w_a * (qx + 1.0) / 2.0, w_a * (qy + 1.0) / 2.0)
    v = jnp.where(tri1, h_a * (1.0 - qy) / 2.0, h_a * (1.0 - qx) / 2.0)
    inside = (jnp.abs(qx) <= 1.0) & (jnp.abs(qy) <= 1.0)
    flat = jnp.clip(jnp.floor(v) * w_a + jnp.floor(u), 0, h_a * w_a - 1).astype(jnp.int32)
    card = jnp.where(inside, tex.reshape(-1)[flat], 0.0)
    return card


def _linear_taps(out_size, res, s, center):
    """(out_size, res) two-tap linear weights mapping film pixel o to the
    canonical card coordinate ((o - center)/s + sqrt2) * res/(2*sqrt2) - 0.5."""
    o = jax.lax.broadcasted_iota(jnp.float32, (out_size, 1), 0)
    i = jax.lax.broadcasted_iota(jnp.float32, (1, res), 1)
    src = ((o - center) / s + _SQRT2) * res / (2.0 * _SQRT2) - 0.5
    return jnp.maximum(0.0, 1.0 - jnp.abs(src - i))


def splat_ghosts_fast(tex, r1s, r2s, colors, axis_ray, width, height, card=None, res: int = 1024):
    """Gather-free ghost buffer: per-ghost separable resample of the card.

    Each ghost is Wy @ card @ Wx^T with explicit two-tap linear weight
    matrices — three matmuls, no per-pixel gathers.  Bilinear instead
    of the reference's nearest texel fetch: not bit-exact vs. the oracle
    rasterizer (use splat_ghosts for that) but visually equivalent and an
    order of magnitude faster on large films.
    """
    if card is None:
        card = canonical_ghost_card(tex, axis_ray, res)
    res = card.shape[0]

    gb_mid_x = jnp.ceil(axis_ray[0] * width)
    gb_mid_y = jnp.ceil(axis_ray[1] * height)
    angle = jnp.arctan((axis_ray[1] - 0.5) / (axis_ray[0] - 0.5))
    ca, sa = jnp.cos(angle), jnp.sin(angle)

    def one_ghost(buf, ghost):
        r1, r2, color = ghost
        shift_amt = -(r1 + r2) / 2.0 * 0.4
        s = jnp.maximum(jnp.abs(r2 - r1) * 0.2, 1e-6)
        cx = gb_mid_x + shift_amt * ca
        cy = gb_mid_y + shift_amt * sa
        wy = _linear_taps(height, res, s, cy)  # (H, R)
        wx = _linear_taps(width, res, s, cx)  # (W, R)
        img = jnp.matmul(jnp.matmul(wy, card, precision="highest"), wx.T, precision="highest")  # (H, W)
        intensity = 10.0 / jnp.maximum(s * s, 1e-12)
        return buf + img[:, :, None] * (color * intensity), None

    buf = jnp.zeros((height, width, 3))
    buf, _ = jax.lax.scan(one_ghost, buf, (r1s, r2s, colors))
    return buf


def splat_eval(tex, r1s, r2s, colors, axis_ray, width, height, xs, ys, smooth=False):
    """Evaluate the additive ghost field at arbitrary pixel coords (P,)."""
    h_a, w_a = tex.shape

    def one_ghost(buf, ghost):
        r1, r2, color = ghost
        cx, cy, intensity = ghost_corners(r1, r2, axis_ray, width, height)
        col = color * intensity
        # triangle 1: (ul, uv 0,0), (ll, uv 0,h), (ur, uv w,0)  [draw_ghost:496]
        t1 = _raster_triangle(
            tex,
            width,
            height,
            jnp.stack([cx[0], cx[1], cx[2]]),
            jnp.stack([cy[0], cy[1], cy[2]]),
            jnp.array([0.0, 0.0, 1.0 * w_a]),
            jnp.array([0.0, 1.0 * h_a, 0.0]),
            col,
            xs,
            ys,
            smooth=smooth,
        )
        # triangle 2: (lr, uv 0,0), (ll, uv 0,h), (ur, uv w,0)  [draw_ghost:498]
        t2 = _raster_triangle(
            tex,
            width,
            height,
            jnp.stack([cx[3], cx[1], cx[2]]),
            jnp.stack([cy[3], cy[1], cy[2]]),
            jnp.array([0.0, 0.0, 1.0 * w_a]),
            jnp.array([0.0, 1.0 * h_a, 0.0]),
            col,
            xs,
            ys,
            smooth=smooth,
        )
        return buf + t1 + t2, None

    buf = jnp.zeros((xs.shape[0], 3))
    # under shard_map the pixel coords are varying over the manual mesh
    # axes while a fresh zeros carry is device-invariant; the scan requires
    # carry-in and carry-out types to match, so promote the carry to xs's
    # varying axes explicitly (no-op outside shard_map)
    vma = getattr(jax.typeof(xs), "vma", frozenset()) | getattr(
        jax.typeof(ys), "vma", frozenset()
    )
    if vma:
        buf = jax.lax.pcast(buf, tuple(vma), to="varying")
    buf, _ = jax.lax.scan(one_ghost, buf, (r1s, r2s, colors))
    return buf
