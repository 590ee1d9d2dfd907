"""Direct and indirect lighting (reference lighting.glsl:1-49).

The reference's dynamic ``for (i < total_light_count)`` loop becomes a static
Python loop over light *capacity* slots with live-count masking — each slot's
soft-shadow march runs for the whole shade-point batch at once, so the work is
L sequential batched marches instead of N·L divergent scalar loops.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from madarch_tpu.core.vecmath import EPSILON, PI, dot
from madarch_tpu.render.brdf import cook_torrance_coefficients
from madarch_tpu.render.raymarch import SURFACE_OFFSET, softshadows


def direct_lighting(spec, data, sdf_b, pos, normal, view_dir, albedo,
                    metallic, roughness, *, compute_specular, enabled=None,
                    max_steps=None):
    """compute_direct_lighting (lighting.glsl:1-40) for a batch of points.

    view_dir is the *incoming* ray direction (the reference's ``dir``);
    shading uses V = -dir.  Shadow march: origin pos + n·0.25, k = 64.
    """
    n_pts = pos.shape[0]
    v = -view_dir
    lo = jnp.zeros((n_pts, 3), jnp.float32)

    march_kwargs = {}
    if max_steps is not None:
        march_kwargs["max_steps"] = max_steps

    for ltype, cap, n, static in spec.light_bounds():
        count = None if static else data.light_counts[ltype.name]
        for slot in range(n):
            live = True if static else slot < count
            params = jax.tree.map(lambda a: a[slot], data.lights[ltype.name])
            radiance, ldir, ldist = ltype.sample(params, pos, normal)
            ndotl = jnp.maximum(dot(normal, ldir), 0.0)

            kd, ks = cook_torrance_coefficients(
                normal, v, ldir, ndotl, albedo, metallic, roughness)
            if not compute_specular:
                ks = jnp.zeros_like(ks)

            shadow_on = (ndotl > EPSILON) if static \
                else (ndotl > EPSILON) & live
            if enabled is not None:
                shadow_on = shadow_on & enabled
            shadows = softshadows(
                sdf_b,
                pos + normal * SURFACE_OFFSET,
                ldir,
                jnp.zeros((n_pts,), jnp.float32),
                ldist,
                64.0,
                enabled=shadow_on,
                **march_kwargs,
            )
            shadows = jnp.where(shadow_on, shadows, 0.0)

            contrib = ((kd * albedo / PI + ks)
                       * radiance * (ndotl * shadows)[..., None])
            lo = lo + (contrib if static
                       else jnp.where(live, contrib, 0.0))
    return lo


def indirect_lighting(irradiance, radiance, v, n, l, albedo, metallic,
                      roughness):
    """compute_indirect_lighting (lighting.glsl:42-49):
    kD·irradiance/π + kS·radiance·NdotL, with L the specular direction."""
    ndotl = jnp.maximum(dot(n, l), 0.0)
    kd, ks = cook_torrance_coefficients(
        n, v, l, ndotl, albedo, metallic, roughness)
    return kd * irradiance / PI + ks * radiance * ndotl[..., None]
