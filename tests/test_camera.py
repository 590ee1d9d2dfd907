"""Camera rays and the precision of every contraction on the frame path."""
import jax
import jax.numpy as jnp
import numpy as np

from madarch_tpu.render.camera import (EYE, camera_rays,
                                       orientation_from_angles, pixel_grid)


def test_camera_rays_match_float64_reference():
    """Rays under HIGHEST precision match a float64 numpy pinhole model to
    1e-6 (a TF32 or bf16 contraction would miss by ~1e-3)."""
    w, h = 37, 23
    rot = np.asarray(orientation_from_angles(0.7, -0.4), np.float64)
    pos = np.array([2.0, 2.0, -1.0])
    o, d = jax.jit(camera_rays)(pixel_grid(w, h), jnp.asarray(pos, jnp.float32),
                                jnp.asarray(rot, jnp.float32))

    xs = (np.arange(w) + 0.5) / w * 2.0 - 1.0
    ys = (np.arange(h) + 0.5) / h * 2.0 - 1.0
    gx, gy = np.meshgrid(xs, ys)
    frag = np.stack([gx, gy, np.zeros_like(gx)], axis=-1)
    to_frag = frag - EYE.astype(np.float64)
    local = to_frag / np.linalg.norm(to_frag, axis=-1, keepdims=True)
    d_ref = local @ rot.T
    o_ref = frag @ rot.T + pos
    np.testing.assert_allclose(np.asarray(d), d_ref, atol=1e-6)
    np.testing.assert_allclose(np.asarray(o), o_ref, atol=1e-6)


def _dot_precisions(jaxpr):
    """Precision params of every dot_general in a jaxpr, sub-jaxprs
    included."""
    out = []
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            out.append(eqn.params["precision"])
        for val in eqn.params.values():
            subs = val if isinstance(val, (tuple, list)) else (val,)
            for sub in subs:
                if hasattr(sub, "jaxpr") and hasattr(sub.jaxpr, "eqns"):
                    out += _dot_precisions(sub.jaxpr)
                elif hasattr(sub, "eqns"):
                    out += _dot_precisions(sub)
    return out


def test_every_frame_contraction_states_highest_precision():
    """No contraction of a GI frame is left to the backend's default
    precision (on the GPU that default may be TF32)."""
    from madarch_tpu.core.config import ProbeSettings
    from madarch_tpu.examples import scenes
    from madarch_tpu.render.pipeline import render_frame_impl

    probes = ProbeSettings(radiance_resolution=8, irradiance_resolution=4,
                           probe_count=(6, 6), grid_dimensions=(4, 3, 3),
                           grid_spacing=(2.0, 3.0, 3.0))
    r = scenes.global_illumination(width=16, height=16, probes=probes)
    jaxpr = jax.make_jaxpr(lambda d, c, s: render_frame_impl(
        r.spec, r.probes, r.volumetrics, 16, 16, d, c, s,
        screen_cfg=r.screen_cfg, probe_cfg=r.probe_cfg))(
            r.scene_data, r.camera, r.state)
    precisions = _dot_precisions(jaxpr.jaxpr)
    assert len(precisions) >= 4  # camera ×2, atlas sampling, integration
    for p in precisions:
        assert p is not None and all(
            x == jax.lax.Precision.HIGHEST for x in p), p
