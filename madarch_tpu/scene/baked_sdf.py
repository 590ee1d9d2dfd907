"""Baked signed-distance-field primitives: render meshes through a dense 3D
distance grid instead of exact triangles.

Counterpart of the reference's distance-map path
(/root/reference/madarch/support/meshes-distance_maps.ads:5-31 uploads R16F /
RGB32F 3D textures; madarch/glsl/scene_custom.glsl samples them for the
legacy support_test mesh experiments).  Here the baked grid is closed over as
a device constant of the scene function — the analogue of a texture bound at
startup — and sampled trilinearly; the SDF is translated by the instance's
``position`` field, with the grid's box SDF as a conservative far-field
bound so sphere tracing converges from outside the grid.

A trilinear fetch needs 8 data-dependent reads per point per march step;
the grid's cost does not grow with the triangle count, which is what it is
for (huge meshes, physics queries).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from madarch_tpu.scene.primitives import INT, VEC3, PrimitiveType


def trilinear_sample(grid, lo, hi, p):
    """Trilinear lookup of grid f32[X,Y,Z] at world points p[..., 3];
    coordinates clamp to the grid border."""
    dims = jnp.asarray(grid.shape, jnp.float32)
    rel = (p - lo) / (hi - lo) * (dims - 1.0)
    rel = jnp.clip(rel, 0.0, dims - 1.0)
    i0 = jnp.floor(rel).astype(jnp.int32)
    i0 = jnp.minimum(i0, jnp.asarray(grid.shape, jnp.int32) - 2)
    i0 = jnp.maximum(i0, 0)
    f = rel - i0.astype(jnp.float32)

    def g(dx, dy, dz):
        return grid[i0[..., 0] + dx, i0[..., 1] + dy, i0[..., 2] + dz]

    fx, fy, fz = f[..., 0], f[..., 1], f[..., 2]
    c00 = g(0, 0, 0) * (1 - fx) + g(1, 0, 0) * fx
    c10 = g(0, 1, 0) * (1 - fx) + g(1, 1, 0) * fx
    c01 = g(0, 0, 1) * (1 - fx) + g(1, 0, 1) * fx
    c11 = g(0, 1, 1) * (1 - fx) + g(1, 1, 1) * fx
    c0 = c00 * (1 - fy) + c10 * fy
    c1 = c01 * (1 - fy) + c11 * fy
    return c0 * (1 - fz) + c1 * fz


def make_baked_sdf_primitive(name: str, dist_grid, lo, hi,
                             margin: float = 0.0) -> PrimitiveType:
    """PrimitiveType sampling a baked distance grid.

    dist_grid: f32[X,Y,Z] distances baked over the [lo, hi] box (e.g. from
    ``mesh.bake_distance_map``).  Outside the box the SDF falls back to
    the box distance + the grid's border value, keeping the field a valid
    lower bound for sphere tracing.
    """
    grid_c = jnp.asarray(dist_grid, jnp.float32)
    lo_c = jnp.asarray(lo, jnp.float32)
    hi_c = jnp.asarray(hi, jnp.float32)
    center = (lo_c + hi_c) / 2.0
    half = (hi_c - lo_c) / 2.0

    def sdf(params, p):
        q = p - params["position"]
        inside_val = trilinear_sample(grid_c, lo_c, hi_c, q)
        # box SDF of the grid bounds
        d = jnp.abs(q - center) - half
        box = (jnp.sqrt(jnp.sum(jnp.maximum(d, 0.0) ** 2, axis=-1) + 1e-30)
               + jnp.minimum(jnp.max(d, axis=-1), 0.0))
        # geometric outside test: the epsilon inside sqrt would otherwise
        # make box≈1e-15 at the boundary and fake a hit surface there
        outside = jnp.max(d, axis=-1) > 1e-5
        return jnp.where(outside, box + margin, inside_val)

    return PrimitiveType(
        name=name,
        fields=(("position", VEC3), ("material_id", INT)),
        sdf=sdf,
        normal=None,  # autodiff gradient of the trilinear field
    )
