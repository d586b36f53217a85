"""lens_flare: a differentiable wavefront path tracer with physically-based lens flare.

A from-scratch JAX/XLA re-design of the capability surface of the reference
renderer ``aatifjiwani/lens-flare`` (a CS184 C++ CPU path tracer with a
lens-flare pipeline).  Nothing here is a translation of the C++: the compute
path is wavefront-vectorized over ray batches and compiled with XLA, with a
CUDA kernel (through ``jax.ffi``) for the hot BVH traversal on the GPU and
``jax.sharding`` for multi-device scale-out.

Layout (mirrors reference layers, SURVEY.md section 1):

- ``utils``       image IO, gamma transform, small math      (ref: CGL/, util/image.h)
- ``scene``       COLLADA parsing, flat scene arrays, camera (ref: src/scene/collada, src/pathtracer/camera.*)
- ``accel``       BVH build (host) + flattened GPU arrays    (ref: src/scene/bvh.*)
- ``ops``         ray traversal (XLA loop + CUDA kernel)     (ref: triangle.cpp/sphere.cpp/bbox.cpp)
- ``integrator``  wavefront path tracing, BSDFs, lights      (ref: src/pathtracer/pathtracer.cpp, bsdf.cpp)
- ``lens``        aperture textures, paraxial ghosts,
                  thin-lens + full lens-stack tracing        (ref: pathtracer.cpp:511-817, camera_lens.cpp)
- ``flare``       FFT Fraunhofer starburst + falloff         (ref: pathtracer.cpp:947-1063)
- ``parallel``    device mesh, sharded rendering             (ref: util/work_queue.h thread pool)
- ``diff``        differentiable lens design optimization
- ``oracle``      NumPy reference implementations for tests
"""

__version__ = "0.1.0"

import os as _os
from pathlib import Path as _Path

# default persistent XLA compilation cache: inside the checkout, gitignored
CACHE_DIR = _Path(__file__).resolve().parent.parent / ".jax_cache"


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory; returns it.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is used as JAX reads it and
    nothing is set in code; otherwise the cache lives in
    ``<checkout>/.jax_cache``.
    """
    env = _os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
    return str(CACHE_DIR)


configure_compile_cache()
