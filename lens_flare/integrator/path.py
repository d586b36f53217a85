"""Wavefront path-tracing integrator.

Re-design of ``PathTracer::raytrace_pixel`` / ``est_radiance_global_illumination``
(``pathtracer.cpp:282-302, 819-899``) as a batched, jit-compiled estimator:

- per-pixel recursion becomes a bounce loop carrying throughput over a ray
  wavefront (the recursive ``at_least_one_bounce_radiance`` at
  pathtracer.cpp:234-280, including its cpdf=0.7 Russian roulette and
  depth-counting semantics)
- next-event estimation mirrors ``estimate_direct_lighting_importance``
  (pathtracer.cpp:142-213): per light, 1 sample if delta else ns_area_light,
  normalized by the total sample count; the uniform-hemisphere variant
  (pathtracer.cpp:86-140) is kept for the ``-H`` flag
- adaptive sampling is the reference's batch mean/variance 95% CI early-stop
  (pathtracer.cpp:841-870), run in lockstep batches with masked accumulation
- RNG: counter-based ``jax.random`` key folding per (pixel, sample, site) —
  no global Mersenne Twister state (random_util.h replaced)

Note on indirect semantics (documented divergence): the reference's indirect
accumulation uses ``bsdf->f`` (pathtracer.cpp:274), which is zero for delta
BSDFs — but those BSDFs are unimplemented stubs there.  This integrator uses
the sampled BSDF value from ``sample_f`` (the CS184 spec the stubs were meant
to implement) so mirror/glass/microfacet indirect transport actually works.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.intersect import SceneArrays, finalize_hit
from ..ops.traverse import traverse
from ..scene.camera import CameraParams, generate_rays, generate_rays_thin_lens
from . import envlight as envmod
from .lights import LightArrays, sample_light
from .shading import (
    BSDFArrays,
    eval_f,
    get_emission,
    is_delta,
    local_to_world,
    make_coord_space,
    sample_f,
    world_to_local,
)

EPS_F = jnp.float32(0.00001)
CPDF = 0.7  # russian-roulette continuation probability (pathtracer.cpp:245)
# f32-native shadow bias: the reference's absolute EPS_F works in its double
# precision; in float32 the reconstructed hit point can sit past EPS_F on the
# wrong side of its own surface (acne).  Secondary-ray origins are offset
# along the normal, scaled with the hit point's magnitude.
SHADOW_BIAS = 1e-4


def _offset_origin(p, n, w):
    """Offset p along n toward the side that w points to (secondary rays)."""
    side = jnp.sign(jnp.sum(n * w, axis=-1, keepdims=True))
    scale = SHADOW_BIAS * jnp.maximum(1.0, jnp.max(jnp.abs(p), axis=-1, keepdims=True))
    return p + n * side * scale


class RenderSettings(NamedTuple):
    """Integrator knobs, mirroring the CLI surface (main.cpp:24-39)."""

    ns_aa: int = 1  # -s
    max_ray_depth: int = 1  # -m
    ns_area_light: int = 1  # -l
    samples_per_batch: int = 64  # -a
    max_tolerance: float = 0.05  # -a
    direct_hemisphere_sample: bool = False  # -H
    indirect: bool = True  # Part-4 indirect transport (commented out in ref)
    use_thin_lens: bool = False  # -b/-d
    pixel_jitter: bool = True  # False: rays through pixel centers (tests)
    # static light-sampling plan: tuple of light row ids, one per NEE slot
    light_slots: tuple = ()
    # per-slot LT_* type codes (host-known): lets NEE sample each slot's
    # light with static table slices instead of per-lane gathers
    light_slot_types: tuple = None
    total_light_samples: int = 1
    # static scene-content specialization: LT_* / BSDF_* codes present in
    # the scene tables.  None = no specialization (evaluate every family);
    # filled by make_settings from the host tables so jit traces only the
    # sampler/BSDF families a scene can actually hit.
    light_types: tuple = None
    bsdf_families: tuple = None
    # Shadow-ray Russian roulette (0 = off): DELTA-light NEE slots whose
    # unoccluded contribution is dim relative to the wavefront are traced
    # with probability p = clip(lum / (tau * wavefront_mean_lum), floor, 1)
    # and weighted 1/p — unbiased, and the dropped lanes never launch
    # shadow rays.  Delta slots only: their tape uniforms are unused by the
    # light sampler, so one is free to drive the RR decision.  Off by
    # default; its GPU cost/benefit is not measured yet.
    nee_rr_tau: float = 0.0
    nee_rr_floor: float = 0.05
    # Pack live lanes to the front of bounce wavefronts (stable argsort on
    # the alive mask) before tracing, so RR-terminated / missed lanes
    # concentrate into whole dead warps.  Off by default; not measured on
    # the GPU yet.
    compact_bounces: bool = False
    # Spatial bounce-wavefront reordering: sort bounce rays by a Morton code
    # of their ORIGIN (dead lanes keyed last, subsuming compact_bounces)
    # before the trace, undo after.  The Renderer feeds wavefronts in 32x32
    # pixel blocks, which already give origin coherence, so it stays off by
    # default; kept as a tested mechanism for callers with unblocked
    # wavefronts.
    sort_bounces: bool = False
    # static scene bbox ((lo,lo,lo),(hi,hi,hi)) for Morton quantization
    sort_bbox: tuple = None


def make_settings(
    light_table, ns_aa=1, max_ray_depth=1, ns_area_light=1, bsdf_table=None, **kw
) -> RenderSettings:
    """Build settings incl. the static NEE slot plan from the host light table."""
    slots = []
    for li in range(len(light_table.light_type)):
        ns = 1 if light_table.is_delta[li] else ns_area_light
        slots.extend([li] * ns)
    kw.setdefault("light_types", tuple(sorted({int(t) for t in light_table.light_type})))
    if bsdf_table is not None:
        kw.setdefault(
            "bsdf_families", tuple(sorted({int(t) for t in bsdf_table.bsdf_type}))
        )
    kw.setdefault(
        "light_slot_types", tuple(int(light_table.light_type[li]) for li in slots)
    )
    settings = RenderSettings(
        ns_aa=ns_aa,
        max_ray_depth=max_ray_depth,
        ns_area_light=ns_area_light,
        light_slots=tuple(slots),
        total_light_samples=max(len(slots), 1),
        **kw,
    )
    # Specialization contract: the static tuples must cover every type code
    # in the device tables, or jit silently drops whole light/BSDF families
    # (a caller-passed stale light_types/bsdf_families survives the
    # setdefault above — catch it here instead of rendering wrong radiance).
    if settings.light_types is not None:  # None = documented "no specialization"
        missing = {int(t) for t in light_table.light_type} - set(settings.light_types)
        if missing:
            raise ValueError(
                f"light_types {settings.light_types} misses scene light codes {sorted(missing)}"
            )
    if bsdf_table is not None and settings.bsdf_families is not None:
        missing = {int(t) for t in bsdf_table.bsdf_type} - set(settings.bsdf_families)
        if missing:
            raise ValueError(
                f"bsdf_families {settings.bsdf_families} misses scene BSDF codes {sorted(missing)}"
            )
    return settings


class SceneBundle(NamedTuple):
    scene: SceneArrays
    bsdfs: BSDFArrays
    lights: LightArrays
    env: object  # EnvLightArrays | None
    bokeh: object = None  # optional BokehMask for aperture-shaped DoF


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["cdf"], meta_fields=["width", "height"],
)
@dataclasses.dataclass(frozen=True)
class BokehMask:
    """Aperture/bokeh mask for thin-lens sampling (BASELINE config 2).

    Lens points are importance-sampled proportional to the mask value
    (bokeh/octagonbokeh.png) instead of a uniform disk.
    """

    cdf: jnp.ndarray  # (H*W,) inclusive value CDF
    width: int = 1
    height: int = 1

    @staticmethod
    def from_texture(values) -> "BokehMask":
        import numpy as _np

        v = _np.asarray(values, _np.float64).ravel()
        cdf = _np.cumsum(v)
        cdf = cdf / cdf[-1]
        h, w = values.shape
        return BokehMask(cdf=jnp.asarray(cdf, jnp.float32), width=w, height=h)

    def sample(self, u, jitter=None):
        """u (N,) uniforms -> lens points (N, 2) in [-0.5, 0.5]^2.

        Within-texel placement: x uses ``jitter`` (an independent uniform;
        texel center when None), y re-uses the CDF residual — the fraction
        of u inside the chosen texel's CDF span is itself uniform, so no
        extra random number is needed.  Without this the bokeh quantizes to
        the texel grid at small masks.
        """
        idx = jnp.clip(jnp.searchsorted(self.cdf, u, side="right"), 0, self.cdf.shape[0] - 1)
        lo = jnp.where(idx > 0, self.cdf[jnp.maximum(idx - 1, 0)], 0.0)
        span = jnp.maximum(self.cdf[idx] - lo, 1e-12)
        jy = jnp.clip((u - lo) / span, 0.0, 1.0)
        jx = jitter if jitter is not None else 0.5
        y = idx // self.width
        x = idx % self.width
        return jnp.stack(
            [
                (x.astype(jnp.float32) + jx) / self.width - 0.5,
                (y.astype(jnp.float32) + jy) / self.height - 0.5,
            ],
            axis=-1,
        )


def _trace_stats(t_hi, tests):
    """Measured [rays traced, primitive tests, skipped] for one trace call.

    A lane counts as a traced ray when its interval is live (t_hi > 0; dead
    lanes are fed t_hi = 0 by the integrator).  Accumulated in f32: totals
    are rate metrics, and per-call sums stay far below f32's 2^24 integer
    range (raytraced_renderer.cpp:707-709 parity, measured not modeled).

    The third slot counts *skipped provably-zero rays* — NEE lanes the
    round-3 estimator masks off because their contribution is exactly zero
    (miss / delta-BSDF / emitter shading points; see _nee_active).  It is
    filled by direct_lighting, not here; bench.py uses it to report a
    throughput series comparable with rounds 1-2, which traced (and
    counted) those rays.
    """
    rays = jnp.sum((t_hi > 0).astype(jnp.float32))
    return jnp.stack([rays, jnp.sum(tests.astype(jnp.float32)), 0.0])


def _detach(x):
    """stop_gradient over a whole pytree."""
    return jax.tree_util.tree_map(jax.lax.stop_gradient, x)


def trace_closest(bundle: SceneBundle, o, d, t_lo, t_hi):
    """Closest-hit trace of a wavefront (ops.traverse picks the kernel).

    Returns (Hit, stats) with stats = [rays traced, intersection tests].

    Differentiability contract (BASELINE north star; SURVEY.md section 7 hard
    part 3): the trace is a *non-differentiable visibility oracle*.  Inputs
    and geometry tables are detached before the traversal, so no cotangent
    ever reaches the CUDA custom call (which has no VJP rule) or the
    lax.while_loop (whose reverse mode JAX does not support), and the
    returned hit (t, prim, barycentrics, normal) is treated as a constant.
    ``jax.grad`` of a rendered pixel therefore flows through the *shading*
    chain only — emitter radiance, albedo/reflectance, light radiance and
    envmap texels all receive exact gradients of the fixed-RNG estimator
    (the discrete hit structure is piecewise constant in those parameters,
    so detaching it is exact, not an approximation; see
    tests/test_diff_render.py for the finite-difference checks).  The
    reference chain being differentiated is
    ``est_radiance_global_illumination`` (pathtracer.cpp:282-302).
    """
    o, d, t_lo, t_hi = _detach((o, d, t_lo, t_hi))
    scene = _detach(bundle.scene)
    t, prim, b1, b2, found, tests = traverse(scene, o, d, t_lo, t_hi)
    hit = finalize_hit(scene, o, d, t, prim, b1, b2, found)
    return _orient_normals(bundle, d, hit), _trace_stats(t_hi, tests)


def _part1by2(x):
    """Spread 7 bits of x to every third bit (Morton interleave helper)."""
    x = x & 0x7F
    x = (x | (x << 8)) & 0x0700F00F
    x = (x | (x << 4)) & 0x430C30C3
    x = (x | (x << 2)) & 0x49249249
    return x


def _bounce_sort_key(o, alive, bbox):
    """21-bit Morton code of the quantized ray origin; dead lanes last."""
    lo = jnp.asarray(bbox[0], jnp.float32)
    span = jnp.maximum(jnp.asarray(bbox[1], jnp.float32) - lo, 1e-9)
    q = jnp.clip((o - lo) / span, 0.0, 0.9999)
    q = (q * 128.0).astype(jnp.int32)
    morton = (
        _part1by2(q[:, 0]) | (_part1by2(q[:, 1]) << 1) | (_part1by2(q[:, 2]) << 2)
    )
    return morton + jnp.where(alive, 0, 1 << 21)


def _orient_normals(bundle: SceneBundle, d, hit):
    """Face-forward shading normals for reflective materials.

    Several corpus scenes (the sky/CB* Cornell boxes) have wall windings
    whose vertex normals point *outward*; with the raw normal the NEE
    facing test (pathtracer.cpp:186) blacks them out.  Flip backfacing
    normals toward the ray for non-transmissive BSDFs; refraction/glass
    keep the raw normal because its side encodes entering vs. exiting.
    """
    from ..scene.collada import BSDF_GLASS, BSDF_REFRACTION

    t = bundle.bsdfs.bsdf_type[hit.bsdf]
    transmissive = (t == BSDF_REFRACTION) | (t == BSDF_GLASS)
    backface = jnp.sum(hit.n * d, axis=-1) > 0
    flip = backface & jnp.logical_not(transmissive) & hit.hit
    n = jnp.where(flip[:, None], -hit.n, hit.n)
    return hit._replace(n=n)


def trace_occluded(bundle: SceneBundle, o, d, t_lo, t_hi):
    """Any-hit shadow query. Returns (occluded, stats).

    Non-differentiable like :func:`trace_closest` — visibility is detached
    (the occluded mask is boolean anyway; detaching the inputs keeps
    ``jax.grad`` from ever needing a VJP for the any-hit traversal).
    """
    o, d, t_lo, t_hi = _detach((o, d, t_lo, t_hi))
    _, _, _, _, found, tests = traverse(
        _detach(bundle.scene), o, d, t_lo, t_hi, any_hit=True
    )
    return found, _trace_stats(t_hi, tests)


def _uniforms(key, n, shape):
    """shape uniforms per wavefront lane; key: (N,2) keys -> (N, *shape)."""
    return jax.vmap(lambda k: jax.random.uniform(k, shape))(key)


def _fold(keys, tag):
    return jax.vmap(jax.random.fold_in, in_axes=(0, None))(keys, tag)


def tape_size(settings: RenderSettings) -> int:
    """Uniform floats per (pixel, sample) lane, laid out statically.

    [ jitter 2 | lens 2 | camera-NEE 2S | per bounce: rr 1, bsdf 3, NEE 2S ]

    One threefry call fills the whole tape instead of ~40 separate
    per-site ``fold_in`` hashes per sample.
    """
    s = max(settings.total_light_samples, 1)
    return 4 + 2 * s + max(settings.max_ray_depth - 1, 0) * (4 + 2 * s)


def _nee_active(bundle: SceneBundle, bsdf_id, hit_mask):
    """Lanes whose NEE estimate can be nonzero.

    Delta BSDFs (mirror/refraction/glass) and pure emitters have f == 0 for
    every sampled light direction, and missed rays have no shading point —
    their shadow rays are pure waste.  Masking them to t_hi = 0 is exact
    (the contribution is zero either way) and the traversal skips dead
    lanes outright.  (The reference traces these too, but its
    delta BSDFs were stubs returning zero anyway.)
    """
    from ..scene.collada import BSDF_DIFFUSE, BSDF_MICROFACET

    t = bundle.bsdfs.bsdf_type[bsdf_id]
    return hit_mask & ((t == BSDF_DIFFUSE) | (t == BSDF_MICROFACET))


def direct_lighting(bundle: SceneBundle, settings: RenderSettings, u_tape, hit_p, n, w_out_w, bsdf_id, active=None, counted=None, frame=None):
    """NEE estimate at a batch of shading points (pathtracer.cpp:142-213).

    hit_p, n, w_out_w: (N, 3) world-space; bsdf_id: (N,); u_tape: (N, 2S)
    uniforms; active: optional (N,) mask of lanes whose estimate is wanted
    (see _nee_active); counted: optional (N,) mask of real (non-padding)
    lanes — padding lanes neither trace nor enter the skipped-ray counter.
    Returns ((N, 3) radiance, trace stats).

    All NEE slots (one per delta light + ns_area_light per area light) are
    traced as ONE widened shadow-ray wavefront of S*N rays so the BVH
    traversal loop appears once in the compiled program.
    """
    if frame is not None:
        # vertex frame threaded from the caller (the bounce loop computes
        # the same o2w/w_out for BSDF sampling — one make_coord_space +
        # world_to_local per vertex instead of two)
        o2w, w_out = frame
    else:
        o2w = make_coord_space(n)
        w_out = world_to_local(o2w, w_out_w)

    if settings.direct_hemisphere_sample:
        return _direct_hemisphere(
            bundle, settings, u_tape, hit_p, o2w, w_out, bsdf_id,
            active=active, counted=counted,
        )

    if len(settings.light_slots) == 0:
        return jnp.zeros_like(hit_p), jnp.zeros(3)

    n_pts = hit_p.shape[0]
    n_slots = len(settings.light_slots)

    pts = jnp.broadcast_to(hit_p, (n_slots, n_pts, 3)).reshape(-1, 3)
    if settings.light_slot_types is not None:
        # static slot plan: each slot's light row AND type are host-known, so
        # the light params are static slices broadcast over the lanes
        # instead of per-lane gathers
        from .lights import LightSample, sample_light_static

        parts = [
            sample_light_static(
                bundle.lights, row, code, hit_p,
                u_tape[:, 2 * s : 2 * s + 2], env=bundle.env,
            )
            for s, (row, code) in enumerate(
                zip(settings.light_slots, settings.light_slot_types)
            )
        ]
        ls = LightSample(
            *(
                jnp.concatenate([getattr(x, f) for x in parts], axis=0)
                for f in LightSample._fields
            )
        )
    else:
        slot_ids = jnp.asarray(settings.light_slots, jnp.int32)  # (S,)
        u = u_tape.reshape(n_pts, n_slots, 2).transpose(1, 0, 2)  # (S, N, 2)
        li = jnp.broadcast_to(slot_ids[:, None], (n_slots, n_pts))  # (S, N)
        ls = sample_light(
            bundle.lights, li.reshape(-1), pts, u.reshape(-1, 2), env=bundle.env,
            types_present=settings.light_types,
        )

    o2w_b = jnp.broadcast_to(o2w, (n_slots, n_pts, 3, 3)).reshape(-1, 3, 3)
    wi_obj = world_to_local(o2w_b, ls.wi)
    facing = wi_obj[:, 2] >= 0  # dot(wi_obj, z) < 0 -> skip (pathtracer.cpp:186)

    n_b = jnp.broadcast_to(n, (n_slots, n_pts, 3)).reshape(-1, 3)
    # lanes that can't contribute (backfacing / zero pdf / inactive shading
    # point) get t_hi = 0, so the traversal skips them
    live = facing & (ls.pdf > 0)
    if counted is not None:
        live = live & jnp.broadcast_to(counted, (n_slots, n_pts)).reshape(-1)
    skipped = 0.0
    if active is not None:
        would_trace = live
        live = live & jnp.broadcast_to(active, (n_slots, n_pts)).reshape(-1)
        skipped = jnp.sum(would_trace.astype(jnp.float32)) - jnp.sum(
            live.astype(jnp.float32)
        )
    # unoccluded contribution FIRST (it is trace-independent): needed by the
    # shadow-ray RR gate below, and no extra work — it was computed for
    # every lane after the trace anyway
    cos_theta = wi_obj[:, 2] / jnp.maximum(jnp.linalg.norm(wi_obj, axis=-1), 1e-30)
    w_out_b = jnp.broadcast_to(w_out, (n_slots, n_pts, 3)).reshape(-1, 3)
    bsdf_b = jnp.broadcast_to(bsdf_id, (n_slots, n_pts)).reshape(-1)
    f = eval_f(bundle.bsdfs, bsdf_b, -wi_obj, w_out_b, families=settings.bsdf_families)
    contrib = f * ls.radiance * (cos_theta / jnp.maximum(ls.pdf, 1e-30))[:, None]

    if settings.nee_rr_tau > 0 and settings.light_slot_types is not None:
        from ..scene.build import LT_DIRECTIONAL, LT_POINT, LT_SPOT

        delta_slots = np.array(
            [t in (LT_DIRECTIONAL, LT_POINT, LT_SPOT) for t in settings.light_slot_types]
        )
        if delta_slots.any():
            # unbiased shadow-ray RR: dim candidates trace with probability
            # p = clip(lum / (tau * mean-lum-of-candidates), floor, 1) and
            # are weighted 1/p.  p may depend on the other lanes' values
            # (the reference mean) — the RR uniform is independent of all
            # of them, so E[keep * contrib / p] = contrib exactly.
            lum = (
                0.2126 * contrib[:, 0]
                + 0.7152 * contrib[:, 1]
                + 0.0722 * contrib[:, 2]
            )
            cand = live & (lum > 0)
            ref = jnp.sum(jnp.where(cand, lum, 0.0)) / jnp.maximum(
                jnp.sum(cand.astype(jnp.float32)), 1.0
            )
            p = jnp.clip(
                lum / jnp.maximum(settings.nee_rr_tau * ref, 1e-30),
                settings.nee_rr_floor,
                1.0,
            )
            # delta slots' tape uniforms are unused by their light sampler
            u_rr = (
                u_tape.reshape(n_pts, n_slots, 2)[:, :, 0].T.reshape(-1)
            )  # (S*N,) slot-major, matching the widened layout
            dmask = jnp.broadcast_to(
                jnp.asarray(delta_slots)[:, None], (n_slots, n_pts)
            ).reshape(-1)
            roulette = dmask & cand
            live = live & jnp.where(roulette, u_rr < p, True)
            contrib = contrib * jnp.where(roulette, 1.0 / p, 1.0)[:, None]

    # relative shadow clip: area/mesh light sample points lie ON emitter
    # geometry, and the origin's normal offset (SHADOW_BIAS, up to ~1e-4)
    # shortens the hit t below the absolute dist - EPS_F clip — the light
    # then occludes itself and NEE goes black.  1e-3 relative clears the
    # offset at any scene scale.
    occ, stats = trace_occluded(
        bundle,
        _offset_origin(pts, n_b, ls.wi),
        ls.wi,
        jnp.full(n_slots * n_pts, EPS_F),
        jnp.where(live, ls.dist * (1.0 - 1e-3) - EPS_F, 0.0),
    )
    use = live & jnp.logical_not(occ)
    contrib = jnp.where(use[:, None], contrib, 0.0)
    return (
        contrib.reshape(n_slots, n_pts, 3).sum(axis=0) / settings.total_light_samples,
        stats + jnp.array([0.0, 0.0, 1.0]) * skipped,
    )


def _direct_hemisphere(bundle, settings, u_tape, hit_p, o2w, w_out, bsdf_id, active=None, counted=None):
    """Uniform-hemisphere direct estimator (pathtracer.cpp:86-140)."""
    num_samples = settings.total_light_samples  # lights * ns_area_light analogue
    p_w = 1.0 / (2.0 * jnp.pi)
    n_pts = hit_p.shape[0]

    u = u_tape.reshape(n_pts, num_samples, 2).transpose(1, 0, 2).reshape(-1, 2)  # (S*N, 2)
    theta = jnp.arccos(jnp.clip(u[:, 0], -1.0, 1.0))
    phi = 2.0 * jnp.pi * u[:, 1]
    wi = jnp.stack(
        [jnp.sin(theta) * jnp.cos(phi), jnp.sin(theta) * jnp.sin(phi), jnp.cos(theta)],
        axis=-1,
    )
    o2w_b = jnp.broadcast_to(o2w, (num_samples, n_pts, 3, 3)).reshape(-1, 3, 3)
    pts = jnp.broadcast_to(hit_p, (num_samples, n_pts, 3)).reshape(-1, 3)
    wi_world = local_to_world(o2w_b, wi)
    skipped = 0.0
    real = (
        jnp.broadcast_to(counted, (num_samples, n_pts)).reshape(-1)
        if counted is not None
        else None
    )
    if active is not None:
        live = jnp.broadcast_to(active, (num_samples, n_pts)).reshape(-1)
        if real is not None:
            live = live & real
            skipped = jnp.sum((real & jnp.logical_not(live)).astype(jnp.float32))
        else:
            skipped = jnp.sum(jnp.logical_not(live).astype(jnp.float32))
        t_hi = jnp.where(live, 1e30, 0.0)
    elif real is not None:
        t_hi = jnp.where(real, 1e30, 0.0)
    else:
        t_hi = jnp.full(num_samples * n_pts, 1e30)
    hit, stats = trace_closest(
        bundle,
        pts,
        wi_world,
        jnp.full(num_samples * n_pts, EPS_F),
        t_hi,
    )
    stats = stats + jnp.array([0.0, 0.0, 1.0]) * skipped
    emission = get_emission(bundle.bsdfs, hit.bsdf)
    cos_out = wi[:, 2]
    w_out_b = jnp.broadcast_to(w_out, (num_samples, n_pts, 3)).reshape(-1, 3)
    bsdf_b = jnp.broadcast_to(bsdf_id, (num_samples, n_pts)).reshape(-1)
    f = eval_f(bundle.bsdfs, bsdf_b, -wi, w_out_b, families=settings.bsdf_families)
    contrib = f * emission * (cos_out / p_w)[:, None]
    contrib = jnp.where(hit.hit[:, None], contrib, 0.0)
    return contrib.reshape(num_samples, n_pts, 3).sum(axis=0) / num_samples, stats


def radiance_sample(bundle: SceneBundle, settings: RenderSettings, cam: CameraParams, keys, px, py, width, height, valid=None):
    """One radiance sample per pixel lane (est_radiance_global_illumination).

    px, py: (N,) integer pixel coords; keys: (N,2) per-lane RNG keys.
    ``valid``: optional (N,) bool — False lanes are shape padding; their
    primary ray gets t_hi = 0, so the kernels skip them AND the measured
    ray/isect counters exclude them (their radiance output is garbage the
    caller discards).  Returns ((N, 3) radiance, stats [rays, isect tests]).
    """
    n_lanes = px.shape[0]
    s = max(settings.total_light_samples, 1)

    # one threefry fill per (pixel, sample): the whole sample's randomness
    tape = _uniforms(keys, n_lanes, (tape_size(settings),))  # (N, U)

    if settings.pixel_jitter:
        jx, jy = tape[:, 0], tape[:, 1]
    else:
        jx = jy = 0.5
    x = (px.astype(jnp.float32) + jx) / width
    y = (py.astype(jnp.float32) + jy) / height

    if settings.use_thin_lens and bundle.bokeh is not None:
        from ..scene.camera import generate_rays_bokeh

        o, d = generate_rays_bokeh(
            cam, x, y, bundle.bokeh.sample(tape[:, 2], jitter=tape[:, 3])
        )
    elif settings.use_thin_lens:
        o, d = generate_rays_thin_lens(cam, x, y, tape[:, 2], tape[:, 3])
    else:
        o, d = generate_rays(cam, x, y)

    t_lo = jnp.full(n_lanes, cam.n_clip)
    t_hi = jnp.full(n_lanes, cam.f_clip)
    if valid is not None:
        t_hi = jnp.where(valid, t_hi, 0.0)  # padding lanes trace nothing
    hit, stats = trace_closest(bundle, o, d, t_lo, t_hi)

    # miss -> environment lookup (pathtracer.cpp:290-292)
    if bundle.env is not None:
        L_miss = envmod.sample_dir(bundle.env, d)
    else:
        L_miss = jnp.zeros((n_lanes, 3))

    hit_p = o + d * jnp.where(hit.hit, hit.t, 0.0)[:, None]
    # zero bounce
    L = get_emission(bundle.bsdfs, hit.bsdf)
    # camera-vertex direct; the vertex frame is shared with the first
    # bounce's BSDF sampling (one make_coord_space per vertex, not two)
    frame0 = make_coord_space(hit.n)
    w_out0 = world_to_local(frame0, -d)
    Ld, st = direct_lighting(
        bundle, settings, tape[:, 4 : 4 + 2 * s], hit_p, hit.n, -d, hit.bsdf,
        active=_nee_active(bundle, hit.bsdf, hit.hit), counted=valid,
        frame=(frame0, w_out0),
    )
    L = L + Ld
    stats = stats + st

    if settings.indirect and settings.max_ray_depth > 1:
        Li, st = _indirect(
            bundle, settings, tape[:, 4 + 2 * s :], o, d, hit, valid=valid,
            frame=(frame0, w_out0),
        )
        L = L + Li
        stats = stats + st

    L = jnp.where(hit.hit[:, None], L, L_miss)
    return L, stats


def _indirect(bundle: SceneBundle, settings: RenderSettings, tape, o, d, hit, valid=None, frame=None):
    """Iterative form of at_least_one_bounce_radiance (pathtracer.cpp:234-280).

    Returns only the indirect part (bounces 2+); the caller already added the
    camera-vertex direct lighting.  tape: (N, (D-1)*(4+2S)) uniforms, one
    [rr 1 | bsdf 3 | NEE 2S] block per bounce, scanned as xs.
    ``frame``: the camera vertex's (o2w, w_out), threaded through the scan so
    each vertex's shading frame is built exactly once (NEE at vertex v and
    BSDF sampling at v used to each build their own).
    """
    n_lanes = o.shape[0]
    n_bounces = settings.max_ray_depth - 1
    per_bounce = tape.shape[1] // n_bounces
    tape_b = tape.reshape(n_lanes, n_bounces, per_bounce).transpose(1, 0, 2)

    if frame is None:
        o2w0 = make_coord_space(hit.n)
        frame = (o2w0, world_to_local(o2w0, -d))

    def bounce_body(carry, xs):
        bounce, u_b = xs  # u_b: (N, 4+2S)
        cur_o, cur_d, cur_hit, o2w, w_out, throughput, active, L, stats = carry
        depth_remaining = settings.max_ray_depth - (bounce - 1)

        # RR continuation at the current vertex (pathtracer.cpp:254)
        rr = u_b[:, 0]
        cont = active & (depth_remaining > 1) & (rr >= (1.0 - CPDF))

        # sample the BSDF at the current vertex (carried frame)
        bs = sample_f(
            bundle.bsdfs, cur_hit.bsdf, w_out, u_b[:, 1:4],
            families=settings.bsdf_families,
        )
        cont = cont & bs.valid & (bs.pdf > 0)

        wi_world = local_to_world(o2w, bs.wi)
        # clamp t for missed lanes: o + d*1e30 overflows f32 and feeds
        # inf/nan coordinates into the traversal kernels
        safe_t = jnp.where(cur_hit.hit, cur_hit.t, 0.0)
        hit_p = cur_o + cur_d * safe_t[:, None]
        # dead lanes (RR-terminated / invalid sample) get t_hi = 0 so the
        # traversal skips them
        b_o = _offset_origin(hit_p, cur_hit.n, wi_world)
        b_hi = jnp.where(cont, 1e30, 0.0)
        if settings.sort_bounces and settings.sort_bbox is not None:
            # spatial reordering: Morton-of-origin key, dead lanes last
            # (see the RenderSettings.sort_bounces comment for the measured
            # rationale).  Results are bit-identical to the unsorted trace
            # — the per-lane intersection math is invariant to lane
            # grouping — so every golden/sharding test still holds.
            order = jnp.argsort(_bounce_sort_key(b_o, cont, settings.sort_bbox))
            inv = jnp.zeros_like(order).at[order].set(
                jnp.arange(n_lanes, dtype=order.dtype)
            )
            nxt_s, st = trace_closest(
                bundle, b_o[order], wi_world[order],
                jnp.full(n_lanes, EPS_F), b_hi[order],
            )
            nxt = jax.tree_util.tree_map(lambda x: x[inv], nxt_s)
        elif settings.compact_bounces:
            # pack live lanes first: dead lanes collapse into whole dead
            # warps.  The permutation is undone on the hit
            # so everything downstream stays in lane order.
            order = jnp.argsort(jnp.logical_not(cont), stable=True)
            inv = jnp.argsort(order, stable=True)
            nxt_s, st = trace_closest(
                bundle, b_o[order], wi_world[order],
                jnp.full(n_lanes, EPS_F), b_hi[order],
            )
            nxt = jax.tree_util.tree_map(lambda x: x[inv], nxt_s)
        else:
            nxt, st = trace_closest(
                bundle, b_o, wi_world, jnp.full(n_lanes, EPS_F), b_hi
            )
        stats = stats + st
        cont = cont & nxt.hit

        # |cos|: refracted directions point BELOW the shading frame
        # (negative local z), and the estimator weight is f |cos| / pdf —
        # the signed cosine flipped glass-transmission throughput negative
        # (found by visual QA: the CBspheres glass sphere rendered black
        # with negative radiance patches)
        cos_theta = jnp.abs(bs.wi[:, 2]) / jnp.maximum(
            jnp.linalg.norm(bs.wi, axis=-1), 1e-30
        )
        step = bs.f * (cos_theta / (bs.pdf * CPDF))[:, None]
        throughput = jnp.where(cont[:, None], throughput * step, throughput)

        # Emission pickup through delta lobes: NEE cannot sample a mirror/
        # glass/refraction path (pdf is a delta), so an area light seen via a
        # specular bounce would render black without this.  Add the hit
        # emitter's radiance for delta chains ONLY — diffuse chains already
        # collect the light via NEE at the previous vertex, so adding it
        # here too would double count.  (The reference shares this data flow
        # at pathtracer.cpp:234-280 but its delta BSDFs were stubs;
        # BASELINE configs 1/3 use real glass/mirror scenes.)
        delta_bounce = is_delta(bundle.bsdfs, cur_hit.bsdf)
        emit = get_emission(bundle.bsdfs, nxt.bsdf)
        L = L + jnp.where((cont & delta_bounce)[:, None], throughput * emit, 0.0)

        # direct lighting at the new vertex (frame built once, carried into
        # the next iteration's BSDF sampling)
        nxt_p = hit_p + wi_world * nxt.t[:, None]
        o2w_n = make_coord_space(nxt.n)
        w_out_n = world_to_local(o2w_n, -wi_world)
        Ld, st = direct_lighting(
            bundle, settings, u_b[:, 4:], nxt_p, nxt.n, -wi_world, nxt.bsdf,
            active=_nee_active(bundle, nxt.bsdf, cont), counted=valid,
            frame=(o2w_n, w_out_n),
        )
        stats = stats + st
        L = L + jnp.where(cont[:, None], throughput * Ld, 0.0)

        return (hit_p, wi_world, nxt, o2w_n, w_out_n, throughput, cont, L, stats), None

    init = (
        o, d, hit, frame[0], frame[1], jnp.ones((n_lanes, 3)), hit.hit,
        jnp.zeros((n_lanes, 3)), jnp.zeros(3),
    )
    (_, _, _, _, _, _, _, L, stats), _ = jax.lax.scan(
        bounce_body, init, (jnp.arange(1, settings.max_ray_depth), tape_b)
    )
    return L, stats


def render_batch(
    bundle: SceneBundle,
    settings: RenderSettings,
    cam: CameraParams,
    px,
    py,
    width,
    height,
    key,
    s_offset,
    n_samples: int,
    valid=None,
):
    """Unconditionally trace ``n_samples`` samples for every lane.

    The building block of host-repacked adaptive sampling: the Renderer
    compacts unconverged pixels between batches and calls this on the
    shrinking wavefront, so converged pixels stop costing device time
    (the in-graph lockstep loop in :func:`render_wavefront` only masks
    their statistics).  ``s_offset`` is traced — batches reuse one
    compiled program; RNG depends only on (pixel id, sample index), so
    packing doesn't change any sample.

    Returns (film sum (N,3), s1 (N,), s2 (N,), stats (2,)).
    """
    pixel_ids = (py * width + px).astype(jnp.uint32)
    base_keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(key, pixel_ids)
    n_px = px.shape[0]

    def sample_body(carry, j):
        film, s1, s2, stats = carry
        keys = _fold(base_keys, (s_offset + j).astype(jnp.uint32))
        rad, st = radiance_sample(
            bundle, settings, cam, keys, px, py, width, height, valid=valid
        )
        illum = 0.2126 * rad[:, 0] + 0.7152 * rad[:, 1] + 0.0722 * rad[:, 2]
        return (film + rad, s1 + illum, s2 + illum * illum, stats + st), None

    init = (jnp.zeros((n_px, 3)), jnp.zeros(n_px), jnp.zeros(n_px), jnp.zeros(3))
    (film, s1, s2, stats), _ = jax.lax.scan(sample_body, init, jnp.arange(n_samples))
    return film, s1, s2, stats


def render_wavefront(bundle: SceneBundle, settings: RenderSettings, cam: CameraParams, px, py, width, height, key, valid=None):
    """Adaptive-sampled radiance for a batch of pixels (raytrace_pixel).

    px, py: (P,) pixel integer coords.  ``valid``: optional (P,) bool marking
    real lanes (False = shape padding; excluded from work and counters).
    Returns (radiance (P,3), counts (P,), stats [rays traced, isect tests] —
    measured on-device, psum-able).
    """
    n_px = px.shape[0]
    pixel_ids = (py * width + px).astype(jnp.uint32)
    base_keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(key, pixel_ids)

    spb = min(settings.samples_per_batch, settings.ns_aa)
    n_batches = -(-settings.ns_aa // spb)

    def one_sample(s_idx, converged):
        keys = _fold(base_keys, jnp.uint32(s_idx))
        rad, stats = radiance_sample(
            bundle, settings, cam, keys, px, py, width, height, valid=valid
        )
        use = jnp.logical_not(converged) & (s_idx < settings.ns_aa)
        return jnp.where(use[:, None], rad, 0.0), use, stats

    def batch_body(carry, b):
        film, s1, s2, count, converged, stats = carry

        def sample_body(c, j):
            film, s1, s2, count, stats = c
            s_idx = b * spb + j
            rad, use, st = one_sample(s_idx, converged)
            illum = 0.2126 * rad[:, 0] + 0.7152 * rad[:, 1] + 0.0722 * rad[:, 2]
            film = film + rad
            s1 = s1 + jnp.where(use, illum, 0.0)
            s2 = s2 + jnp.where(use, illum * illum, 0.0)
            count = count + use.astype(jnp.int32)
            return (film, s1, s2, count, stats + st), None

        (film, s1, s2, count, stats), _ = jax.lax.scan(
            sample_body, (film, s1, s2, count, stats), jnp.arange(spb)
        )

        # 95% CI early-stop (pathtracer.cpp:862-868)
        n = jnp.maximum(count, 2).astype(jnp.float32)
        var = 1.0 / (n - 1.0) * jnp.maximum(s2 - s1 * s1 / n, 0.0)
        ci = 1.96 * jnp.sqrt(var) / jnp.sqrt(n)
        converged = converged | (ci <= settings.max_tolerance * s1 / n)
        return (film, s1, s2, count, converged, stats), None

    init = (
        jnp.zeros((n_px, 3)),
        jnp.zeros(n_px),
        jnp.zeros(n_px),
        jnp.zeros(n_px, jnp.int32),
        jnp.zeros(n_px, bool),
        jnp.zeros(3),
    )
    adaptive = settings.ns_aa > spb
    if adaptive:
        (film, s1, s2, count, converged, stats), _ = jax.lax.scan(
            batch_body, init, jnp.arange(n_batches)
        )
    else:
        (film, s1, s2, count, converged, stats), _ = batch_body(init, 0)

    radiance = film / jnp.maximum(count, 1)[:, None]
    return radiance, count, stats
