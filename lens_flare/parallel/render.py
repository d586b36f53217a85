"""Sharded rendering and the sharded differentiable training step.

``render_sharded`` data-parallels the pixel wavefront over the mesh batch
axis with the scene replicated; ``make_train_step`` builds the BASELINE
config-5 loop body: render + flare composite + pixel loss + ``jax.grad``
w.r.t. the lens prescription + optax update, all under one pjit — XLA
all-reduces the parameter gradients over the mesh (overlapped with the
backward sweep by the scheduler).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..integrator.path import render_wavefront
from .mesh import BATCH_AXIS, make_mesh, replicate, shard_batch


def render_sharded(bundle, settings, cam, px, py, width, height, key, mesh=None):
    """Data-parallel render: pixels sharded over the mesh, scene replicated.

    px, py must have length divisible by the mesh size.
    """
    if mesh is None:
        mesh = make_mesh()
    data_sharding = shard_batch(mesh)
    repl = replicate(mesh)

    px = jax.device_put(px, data_sharding)
    py = jax.device_put(py, data_sharding)
    bundle = jax.device_put(bundle, repl)

    fn = jax.jit(
        lambda b, x, y: render_wavefront(b, settings, cam, x, y, width, height, key),
        # stats are a global sum over the sharded lanes: XLA all-reduces them
        # and the (2,) vector comes back replicated
        out_shardings=(data_sharding, data_sharding, None),
    )
    with jax.set_mesh(mesh):  # the traversal shards its lanes over the mesh
        return fn(bundle, px, py)


def ghost_image_from_lens(lens, ghost_tex, axis_ray, angle, width, height, mesh=None):
    """Differentiable ghost-buffer forward model (used by the optimization loop).

    With ``mesh``, the film ROWS are sharded over the devices via
    ``shard_map``: each device evaluates the (pointwise-per-pixel) smooth
    splat only on its own row slab, so per-device compute genuinely drops
    ~1/n_devices (the paraxial traces are tiny and replicated).  The
    pixel math is identical to the unsharded path, and the backward pass
    all-reduces the replicated ghost-parameter cotangents across the mesh
    automatically.
    """
    from ..lens.ghosts import splat_eval, splat_ghosts
    from ..lens.paraxial import trace_all_ghosts

    r1, r2 = trace_all_ghosts(lens, angle)
    n_pairs = r1.shape[0]
    colors = jnp.tile(jnp.eye(3), (n_pairs, 1))
    r1f = r1.reshape(-1)
    r2f = r2.reshape(-1)
    if mesh is None:
        return splat_ghosts(ghost_tex, r1f, r2f, colors, axis_ray, width, height, smooth=True)

    from jax.experimental.shard_map import shard_map
    from jax.sharding import PartitionSpec as P

    n_dev = mesh.devices.size
    if height % n_dev:
        raise ValueError(f"height {height} must divide over {n_dev} devices")

    def slab(rows_l, tex, r1f, r2f, colors, axis):
        n_rows = rows_l.shape[0]
        ys = jnp.repeat(rows_l, width)
        xs = jnp.tile(jnp.arange(width), n_rows)
        out = splat_eval(tex, r1f, r2f, colors, axis, width, height, xs, ys, smooth=True)
        return out.reshape(n_rows, width, 3)

    rows = jnp.arange(height)
    return shard_map(
        slab,
        mesh=mesh,
        in_specs=(P(BATCH_AXIS), P(), P(), P(), P(), P()),
        out_specs=P(BATCH_AXIS),
    )(rows, ghost_tex, r1f, r2f, colors, axis_ray)


def make_train_step(optimizer, ghost_tex, axis_ray, angle, width, height, mesh=None):
    """Lens-design optimization step (BASELINE config 5), row-sharded over the mesh.

    loss(lens) = mean((ghost_image(lens) - target)^2); returns jitted
    (lens, opt_state, target) -> (lens, opt_state, loss).  With ``mesh``
    the forward model itself is sharded over film rows (each device
    renders only its slab — see :func:`ghost_image_from_lens`), the
    target arrives row-sharded, and XLA all-reduces the lens gradients.
    """

    def loss_fn(lens, target):
        img = ghost_image_from_lens(
            lens, ghost_tex, axis_ray, angle, width, height, mesh=mesh
        )
        return jnp.mean((img - target) ** 2)

    def step(lens, opt_state, target):
        loss, grads = jax.value_and_grad(loss_fn)(lens, target)
        updates, opt_state = optimizer.update(grads, opt_state, lens)
        import optax

        lens = optax.apply_updates(lens, updates)
        return lens, opt_state, loss

    if mesh is not None:
        data_sharding = jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec(BATCH_AXIS)
        )
        return jax.jit(step, in_shardings=(None, None, data_sharding))
    return jax.jit(step)
