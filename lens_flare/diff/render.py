"""Differentiable path-traced radiance: scene parameters from pixels.

The last leg of the BASELINE north star: ``jax.grad`` of a rendered image
with respect to *scene* parameters — emitter radiance, albedos, light
radiance, envmap texels — through the full wavefront integrator
(``est_radiance_global_illumination``, reference pathtracer.cpp:282-302).

The trace is a detached visibility oracle (see
:func:`lens_flare.integrator.path.trace_closest`): hit ids, distances
and normals are constants of the backward pass, exactly as SURVEY.md
section 7 hard-part 3 scopes it (shading/lens/flare differentiate;
visibility does not).  Because the discrete hit structure is piecewise
constant in radiometric parameters, the detached gradient of the fixed-RNG
estimator is *exact* — verified by finite differences in
tests/test_diff_render.py.

:func:`recover_emitter` is the round-goal demo: recover an unknown emitter
color (the area light's BSDF radiance row *and* its NEE light-table row,
which describe the same physical emitter) from a target render.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import optax

from ..integrator.path import RenderSettings, SceneBundle, render_batch


def set_emitter_color(bundle: SceneBundle, bsdf_row: int, light_row: int, color) -> SceneBundle:
    """One physical emitter = one BSDF radiance row + one light-table row.

    The integrator reads the emitter twice — ``get_emission`` when a path
    vertex lands on it (zero-bounce / delta chains) and the light table when
    NEE samples it — so both rows must carry the same parameter for the
    gradient to see the whole estimator.
    """
    color = jnp.asarray(color, jnp.float32)
    bsdfs = bundle.bsdfs._replace(
        radiance=bundle.bsdfs.radiance.at[bsdf_row].set(color)
    )
    lights = bundle.lights._replace(
        radiance=bundle.lights.radiance.at[light_row].set(color)
    )
    return bundle._replace(bsdfs=bsdfs, lights=lights)


def render_image(bundle, settings: RenderSettings, cam, px, py, width, height, key, n_samples):
    """Fixed-sample-count differentiable render (no adaptive early-stop).

    Adaptive convergence masks are piecewise-constant but *change* under
    finite parameter steps, so the demo and the FD tests use the
    unconditional estimator — same math as production ``render_batch``.
    """
    film, _s1, _s2, _stats = render_batch(
        bundle, settings, cam, px, py, width, height, key, jnp.uint32(0), n_samples
    )
    return film / n_samples


def recover_emitter(
    bundle: SceneBundle,
    settings: RenderSettings,
    cam,
    px,
    py,
    width,
    height,
    target,
    bsdf_row: int,
    light_row: int,
    init_color=(1.0, 1.0, 1.0),
    n_samples: int = 4,
    steps: int = 60,
    learning_rate: float = 0.5,
    key=None,
):
    """Gradient-recover an emitter color from a target render.

    Returns (color, losses).  The loss is the L2 distance between the
    differentiable render and ``target`` with the *same* RNG key, so the
    optimum is exactly the true color (no Monte-Carlo floor).
    """
    if key is None:
        key = jax.random.PRNGKey(7)
    color = jnp.asarray(init_color, jnp.float32)
    optimizer = optax.adam(learning_rate)
    opt_state = optimizer.init(color)

    @jax.jit
    def step(color, opt_state):
        def loss_fn(c):
            img = render_image(
                set_emitter_color(bundle, bsdf_row, light_row, c),
                settings, cam, px, py, width, height, key, n_samples,
            )
            return jnp.mean((img - target) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(color)
        updates, opt_state = optimizer.update(grads, opt_state, color)
        return optax.apply_updates(color, updates), opt_state, loss

    losses = []
    for _ in range(steps):
        color, opt_state, loss = step(color, opt_state)
        losses.append(float(loss))
    return color, losses
