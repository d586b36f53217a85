"""Deterministic full-pipeline snapshots, one per corpus scene family.

VERDICT r1 "strengthen the golden pyramid": a fixed threefry tape makes the
whole render deterministic, so per-scene image statistics act as regression
hashes over the complete path (loader -> BVH -> integrator -> film).  Any
intentional integrator/sampling change must update the recorded values.

Families: Cornell-box glass+mirror (delta emission pickup), Cornell-box mesh
(bunny), conductor microfacet, keenan (textured point-light scenes), meshedit
(hemisphere-lit). pyramid.dae is covered at 128^2 by test_configs.py.
"""

import jax
import numpy as np
import pytest

from lens_flare.renderer import Renderer

# Snapshot values were captured on this backend; f32 reassociation differs
# across XLA backends/compiler versions, so on any other backend the check
# runs with a loose tolerance (regression smoke) instead of failing
# spuriously.  Regenerate the values when intentionally re-baselining.
CAPTURE_BACKEND = "cpu"
RTOL = 5e-3 if jax.default_backend() == CAPTURE_BACKEND else 5e-2

# (scene, mean RGB, std, probe pixel [16,16]) recorded at 32^2 @ 4spp depth 3
SNAPSHOTS = [
    (
        # re-baselined after the |cos| throughput fix (signed cosine had
        # flipped glass-transmission paths negative)
        "sky/CBspheres.dae",
        [0.11133787, 0.09862471, 0.10962834],
        0.56754231,
        [0.37865689, 0.32233277, 0.32233277],
    ),
    (
        "sky/CBbunny.dae",
        [0.1087497, 0.09655081, 0.10867625],
        0.57026792,
        [0.56077594, 0.56077594, 0.68646806],
    ),
    (
        "sky/CBspheres_microfacet_al_ag.dae",
        [0.10587694, 0.09431833, 0.10632716],
        0.55447704,
        [0.3786569, 0.32233277, 0.32233277],
    ),
    (
        "keenan/banana.dae",
        [0.01043244, 0.00917666, 0.00818372],
        0.037907,
        [0.20693599, 0.11080235, 0.01052521],
    ),
    (
        "meshedit/teapot.dae",
        [0.0100551, 0.0100551, 0.0100551],
        0.02967726,
        [0.09360345, 0.09360345, 0.09360345],
    ),
]


@pytest.mark.parametrize("scene,mean,std,probe", SNAPSHOTS, ids=lambda s: s if isinstance(s, str) else "")
def test_scene_family_snapshot(dae_dir, scene, mean, std, probe):
    r = Renderer(width=32, height=32, ns_aa=4, max_ray_depth=3, indirect=True, seed=0)
    r.load(dae_dir / scene)
    hdr, cnt = r.render(progress=False)
    assert int(cnt.sum()) == 32 * 32 * 4
    np.testing.assert_allclose(hdr.mean(axis=(0, 1)), mean, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(float(hdr.std()), std, rtol=RTOL)
    np.testing.assert_allclose(hdr[16, 16], probe, rtol=RTOL, atol=1e-6)
    assert np.isfinite(hdr).all()
    # radiance is physically non-negative; a signed-cosine bug once flipped
    # glass-transmission throughput negative and the snapshot baked it in
    assert float(hdr.min()) >= 0.0
