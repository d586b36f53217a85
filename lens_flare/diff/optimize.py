"""Differentiable lens design: optimize the prescription to match a target flare.

BASELINE config 5: pixel gradients flow through the ghost splatter and
paraxial matrix chains (and optionally the starburst) to curvatures, element
spacings, per-wavelength coating IORs and aperture geometry.  Optax Adam
drives the parameters; checkpoints (lens pytree + opt state leaves, and the
step) are ``.npz`` files, so an interrupted optimization resumes exactly — the
checkpoint/resume subsystem the reference lacks entirely (SURVEY.md section
5.4: camera settings files were its only persisted state).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..lens.ghosts import splat_ghosts
from ..lens.paraxial import trace_all_ghosts
from ..lens.prescription import LensPrescription, reference_prescription


@dataclass
class OptimizeConfig:
    steps: int = 200
    learning_rate: float = 1e-4
    width: int = 128
    height: int = 128
    checkpoint_dir: str | None = None
    checkpoint_every: int = 50
    log_every: int = 20


def ghost_image(lens: LensPrescription, ghost_tex, axis_ray, angle, width, height):
    """Differentiable forward model: prescription -> ghost buffer."""
    r1, r2 = trace_all_ghosts(lens, angle)
    n_pairs = r1.shape[0]
    colors = jnp.tile(jnp.eye(3), (n_pairs, 1))
    return splat_ghosts(ghost_tex, r1.reshape(-1), r2.reshape(-1), colors, axis_ray, width, height, smooth=True)


def optimize_lens(
    target: jnp.ndarray,
    ghost_tex: jnp.ndarray,
    axis_ray,
    angle,
    config: OptimizeConfig = OptimizeConfig(),
    init_lens: LensPrescription | None = None,
):
    """Fit the lens prescription so the rendered ghosts match ``target``.

    Returns (lens, losses).
    """
    height, width = target.shape[:2]
    lens = init_lens if init_lens is not None else reference_prescription()
    optimizer = optax.adam(config.learning_rate)
    opt_state = optimizer.init(lens)

    ckpt_mgr = None
    start_step = 0
    if config.checkpoint_dir:
        ckpt_mgr = _CheckpointManager(config.checkpoint_dir)
        restored = ckpt_mgr.restore(lens, opt_state)
        if restored is not None:
            lens, opt_state, start_step = restored

    @jax.jit
    def step(lens, opt_state):
        def loss_fn(lens):
            img = ghost_image(lens, ghost_tex, axis_ray, angle, width, height)
            return jnp.mean((img - target) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)(lens)
        updates, opt_state = optimizer.update(grads, opt_state, lens)
        lens = optax.apply_updates(lens, updates)
        return lens, opt_state, loss

    losses = []
    for s in range(start_step, config.steps):
        lens, opt_state, loss = step(lens, opt_state)
        losses.append(float(loss))
        if config.log_every and s % config.log_every == 0:
            print(f"[LensOpt] step {s}: loss {float(loss):.6e}")
        if ckpt_mgr and config.checkpoint_every and (s + 1) % config.checkpoint_every == 0:
            ckpt_mgr.save(lens, opt_state, s + 1)

    if ckpt_mgr:
        ckpt_mgr.save(lens, opt_state, config.steps)
    return lens, losses


class _CheckpointManager:
    """Checkpoints as ``np.savez`` of the flattened (lens, opt_state) leaves."""

    def __init__(self, directory):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)

    def save(self, lens, opt_state, step: int) -> None:
        flat = jax.tree_util.tree_leaves({"lens": lens, "opt_state": opt_state})
        path = self.dir / f"step_{step}.npz"
        tmp = self.dir / f"step_{step}.tmp.npz"
        np.savez(tmp, *[np.asarray(x) for x in flat])
        os.replace(tmp, path)
        (self.dir / "LATEST").write_text(str(step))

    def restore(self, lens_like, opt_like):
        latest = self.dir / "LATEST"
        if not latest.exists():
            return None
        step = int(latest.read_text())
        flat, treedef = jax.tree_util.tree_flatten({"lens": lens_like, "opt_state": opt_like})
        with np.load(self.dir / f"step_{step}.npz") as data:
            arrays = [jnp.asarray(data[f"arr_{i}"]) for i in range(len(flat))]
        state = jax.tree_util.tree_unflatten(treedef, arrays)
        return state["lens"], state["opt_state"], step
