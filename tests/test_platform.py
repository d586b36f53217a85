"""Process set-up: compile cache, pytree dataclasses, the GPU smoke script."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

import lens_flare

ROOT = Path(__file__).resolve().parents[1]


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert lens_flare.configure_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # nothing set in code


def test_compile_cache_defaults_to_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        got = lens_flare.configure_compile_cache()
        assert got == str(ROOT / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_dataclass_pytrees_roundtrip():
    from lens_flare.integrator.path import BokehMask
    from lens_flare.lens.prescription import reference_prescription

    lens = reference_prescription()
    leaves, treedef = jax.tree_util.tree_flatten(lens)
    assert len(leaves) == 5  # aperture_index is static metadata
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert back.aperture_index == lens.aperture_index
    np.testing.assert_array_equal(back.curvatures, lens.curvatures)
    doubled = jax.tree_util.tree_map(lambda x: x * 2, lens)
    np.testing.assert_allclose(doubled.spacings, lens.spacings * 2)
    assert lens.replace(aperture_index=4).aperture_index == 4

    mask = BokehMask.from_texture(np.ones((3, 5)))
    leaves, treedef = jax.tree_util.tree_flatten(mask)
    assert len(leaves) == 1
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert (back.width, back.height) == (5, 3)
    pts = jax.jit(lambda m, u: m.sample(u))(mask, jnp.linspace(0.0, 0.99, 7))
    assert pts.shape == (7, 2) and bool((jnp.abs(pts) <= 0.5).all())


def test_lens_checkpoint_roundtrip(tmp_path):
    import optax

    from lens_flare.diff.optimize import _CheckpointManager
    from lens_flare.lens.prescription import reference_prescription

    lens = reference_prescription()
    opt = optax.adam(1e-3)
    state = opt.init(lens)
    moved = lens.replace(spacings=lens.spacings + 1.0)
    mgr = _CheckpointManager(tmp_path)
    assert mgr.restore(lens, state) is None
    mgr.save(moved, state, 7)
    got_lens, got_state, step = mgr.restore(lens, state)
    assert step == 7
    np.testing.assert_array_equal(got_lens.spacings, moved.spacings)
    assert jax.tree_util.tree_structure(got_state) == jax.tree_util.tree_structure(state)


def _run_smoke(script, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run(
        [sys.executable, str(script)], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=240,
    )


def test_chip_smoke_fails_without_gpu():
    proc = _run_smoke(ROOT / "chip_smoke.py", ROOT)
    assert proc.returncode != 0
    assert "needs a GPU" in proc.stderr
    assert '"ok"' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path / "chip_smoke.py", tmp_path)
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        assert not line.startswith("{"), line
