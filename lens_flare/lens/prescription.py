"""Lens prescription as a differentiable parameter PyTree.

The reference hardcodes a 9-interface lens (``pathtracer.cpp:539-556``):
element spacings ``Ts``, per-RGB refractive indices, surface curvatures, an
aperture stop at interface 5 with half-height 11.6, marginal rays at
r = +/-14.5.  Here the same data is a PyTree of arrays so the whole flare
pipeline can be differentiated w.r.t. curvatures, spacings, per-wavelength
IORs and aperture geometry (BASELINE config 5: lens-design optimization).
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(
    jax.tree_util.register_dataclass,
    data_fields=["spacings", "curvatures", "iors", "aperture_height", "marginal_r"],
    meta_fields=["aperture_index"],
)
@dataclasses.dataclass(frozen=True)
class LensPrescription:
    """N-interface paraxial prescription (N = 9 for the reference lens).

    All array fields are differentiable pytree leaves; ``aperture_index`` is
    static (it selects a python-level branch in the trace loops).
    """

    spacings: jnp.ndarray  # (N,) gap after interface i (Ts, pathtracer.cpp:541-551)
    curvatures: jnp.ndarray  # (N+1,) surface curvatures (pathtracer.cpp:556)
    iors: jnp.ndarray  # (3, N) refractive index after interface i, per RGB
    aperture_height: jnp.ndarray  # scalar half-height of the iris (11.6)
    marginal_r: jnp.ndarray  # scalar marginal ray height (14.5)
    aperture_index: int = 5

    def replace(self, **changes) -> "LensPrescription":
        """A copy with ``changes`` applied (fields by name)."""
        return dataclasses.replace(self, **changes)

    @property
    def num_interfaces(self) -> int:
        return self.spacings.shape[0]


def reference_prescription(dtype=jnp.float32) -> LensPrescription:
    """The hardcoded lens of the reference (pathtracer.cpp:539-556)."""
    spacings = np.array(
        [7.700, 1.850, 3.520, 1.850, 4.180, 3.000, 1.850, 7.270, 83.91]
    )
    curvatures = np.array(
        [
            1 / 30.810,
            1 / -89.350,
            1 / 580.380,
            1 / -80.630,
            1 / 28.340,
            0.0,
            0.0,
            1 / 32.190,
            1 / -52.990,
            1 / 81.320,
        ]
    )
    red = [1.652, 1.5991, 1, 1.6396, 1, 1, 1.5776, 1.68990, 1]
    green = [1.652, 1.6113, 1, 1.65, 1, 1, 1.5885, 1.6999, 1]
    blue = [1.652, 1.6164, 1, 1.6542, 1, 1, 1.5930, 1.7040, 1]
    return LensPrescription(
        spacings=jnp.asarray(spacings, dtype),
        curvatures=jnp.asarray(curvatures, dtype),
        iors=jnp.asarray(np.array([red, green, blue]), dtype),
        aperture_height=jnp.asarray(11.6, dtype),
        marginal_r=jnp.asarray(14.5, dtype),
        aperture_index=5,
    )
