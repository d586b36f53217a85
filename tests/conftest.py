"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Multi-device sharding logic is validated without accelerators by faking 8
host devices (the idiomatic JAX approach; SURVEY.md section 4).  Tests run
with ``JAX_PLATFORMS=cpu``; the ones marked ``gpu`` need a CUDA device and
skip without one (see the ``gpu_device`` fixture).
"""

import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import jax

import pathlib

import pytest

REFERENCE = pathlib.Path("/root/reference")


@pytest.fixture(scope="session")
def dae_dir():
    return REFERENCE / "dae"


@pytest.fixture(scope="session")
def apertures_dir():
    return REFERENCE / "apertures"


@pytest.fixture(scope="session")
def pyramid_scene():
    from lens_flare.scene.build import load_scene

    return load_scene(REFERENCE / "dae" / "pyramid.dae")


@pytest.fixture
def gpu_device():
    """The first CUDA device; skips the test where JAX has none."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs a CUDA GPU (run: python chip_smoke.py on the card)")
    return devices[0]


@pytest.fixture(autouse=True, scope="module")
def _clear_jax_caches_per_module():
    """Free compiled executables between test modules.

    The suite compiles several hundred distinct XLA programs in one
    process; past ~130 the CPU backend segfaulted inside
    backend_compile_and_load (observed twice at the same point, tests pass
    in isolation — a compiler-resource failure, not a test bug).  Modules
    rarely share jit shapes, so dropping the caches costs little and keeps
    the peak footprint bounded.
    """
    yield
    jax.clear_caches()
