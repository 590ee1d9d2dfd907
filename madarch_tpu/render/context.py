"""SceneCtx: one object bundling the scene-distance closures the marches
need.

Carries the march closure (stop-gradient scene data, chunked over rays for
many-slot scenes) and the differentiable closure used for hit-gradient
reattachment and autodiff normals.  March entry points accept either a bare
batched-SDF callable or a SceneCtx.
"""
from __future__ import annotations

import jax
from jax import lax

from madarch_tpu.scene.scene import SceneData, SceneSpec, scene_sdf

# Ray-chunk size for many-slot scene SDF evaluation: a dense march step
# holds [rays, slots] intermediates, so big scenes sequentialize over ray
# chunks to bound the working set (968 triangles × 640k rays would be
# 2.5 GB per buffer unchunked).
GRID_CHUNK = 32768
# Scenes at or below this many live slots skip chunking: their [rays,
# slots] footprint is small and lax.map would only add scan overhead.
CHUNK_SLOT_THRESHOLD = 128


def _chunked_vmap(fn_one, p, want_chunks=True):
    """vmap(fn_one) over p[N,3], sequentialized in GRID_CHUNK-ray chunks via
    lax.map so the per-step working set stays bounded."""
    import jax.numpy as jnp

    n = p.shape[0]
    if not want_chunks or n <= GRID_CHUNK:
        return jax.vmap(fn_one)(p)
    n_pad = -(-n // GRID_CHUNK) * GRID_CHUNK
    if n_pad != n:
        p = jnp.concatenate(
            [p, jnp.zeros((n_pad - n, 3), p.dtype)], axis=0)
    chunks = p.reshape(-1, GRID_CHUNK, 3)
    out = lax.map(lambda q: jax.vmap(fn_one)(q), chunks)
    return out.reshape(-1)[:n]


class SceneCtx:
    def __init__(self, spec: SceneSpec, data: SceneData):
        data_sg = jax.tree.map(lax.stop_gradient, data)
        self.sdf_b_diff = jax.vmap(lambda p: scene_sdf(spec, data, p))

        # Marches evaluate the full scene *densely* (vectorized over
        # slots), chunked over rays to bound the [rays, slots] working set.
        # The reference's per-ray candidate-list iteration
        # (partitioning_closest, madarch-scenes.adb:839-1118) is not used on
        # the march path; the uniform grid remains the host/query-side
        # structure (grid_closest, builders).  Whether candidate lists or
        # the BVH beat dense evaluation on meshes is an open measurement.
        n_slots = sum(n for _, _, n, _ in spec.prim_bounds())
        chunky = n_slots > CHUNK_SLOT_THRESHOLD
        self.sdf_b = lambda p: _chunked_vmap(
            lambda q: scene_sdf(spec, data_sg, q), p, want_chunks=chunky)
