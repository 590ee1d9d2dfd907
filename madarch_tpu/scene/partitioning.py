"""Uniform-grid space partitioning: per-cell candidate lists + grid-aware
closest-primitive queries.

Scope note: the render-path marches evaluate every scene slot densely
(render/context.py); they do not read these candidate lists.  This module is
the host/query-side structure: ``grid_closest`` serves physics /
eval_distance_to-style point queries and tests, and the builders mirror the
reference's Update_Partitioning semantics.

JAX counterpart of the reference's partitioning codegen
(/root/reference/madarch/madarch-scenes.adb:766-1187) and the three
Update_Partitioning builders (madarch-renderers.adb:539-755):

- ``gpu_fast``: per cell keep primitives with dist(center) <
  closest(center) + cell_diag (the conservative test of
  partitioning_compute_grid_cell, madarch-scenes.adb:1120-1187);
- ``cpu_best``: sample 3×3×3 points per cell and keep only primitives that
  are the actual closest at some sample (madarch-renderers.adb:551-755);
- ``cpu_fast``: the gpu_fast rule (same candidate set, host-triggered).

Candidates are dense i32[num_cells, K] + counts (static shapes); overflow
beyond K keeps the K closest-by-center-distance candidates (the reference
truncates with a warning, madarch-renderers.adb:593-598 — keeping the
nearest ones is strictly better and shape-compatible).
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from madarch_tpu.core.config import PartitioningSettings
from madarch_tpu.scene.scene import SceneData, SceneSpec


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class GridData:
    """Device-side partitioning state (the reference's partitioning SSBO)."""

    cells: jnp.ndarray   # i32[num_cells, K] global primitive indices
    counts: jnp.ndarray  # i32[num_cells]


def _cell_centers(settings: PartitioningSettings):
    nx, ny, nz = settings.grid_dimensions
    off = np.asarray(settings.grid_offset, np.float32)
    sp = np.asarray(settings.grid_spacing, np.float32)
    ix, iy, iz = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij")
    idx = np.stack([ix, iy, iz], axis=-1).reshape(-1, 3)
    return jnp.asarray(off + (idx + 0.5) * sp), idx


def cell_id(settings: PartitioningSettings, idx3):
    """3D cell index -> flat id, x-major then y then z (matches the
    generated lookup order)."""
    nx, ny, nz = settings.grid_dimensions
    return (idx3[..., 0] * ny + idx3[..., 1]) * nz + idx3[..., 2]


def all_slot_dists(spec: SceneSpec, data: SceneData, p):
    """Distances from one point to every capacity slot (dead slots ->
    max_dist), concatenated in global-index order; f32[total_capacity]."""
    out = []
    for ptype, cap, n, static in spec.prim_bounds():
        if cap == 0:
            continue
        if n == 0:
            out.append(jnp.full((cap,), spec.max_dist, jnp.float32))
            continue
        params = jax.tree.map(lambda a: a[:n], data.prims[ptype.name])
        dists = jax.vmap(lambda prm: ptype.sdf(prm, p))(params)
        if not static:
            count = data.prim_counts[ptype.name]
            dists = jnp.where(jnp.arange(n) < count, dists, spec.max_dist)
        if n < cap:  # keep capacity-block global-index layout
            dists = jnp.concatenate(
                [dists, jnp.full((cap - n,), spec.max_dist, jnp.float32)])
        out.append(dists)
    return jnp.concatenate(out)


def planar_prims(spec: SceneSpec, data: SceneData):
    """Per-type planar parameter split: vec3 fields become three f32[cap]
    component arrays (name_x/y/z).  Must be built OUTSIDE any vmap/march
    loop — the split is then a few materialized 1-D arrays instead of a
    strided column slice traced per ray."""
    out = {}
    for ptype, cap in spec.prims:
        if ptype.sdf_planar is None:
            continue
        s = {}
        for fname, kind in ptype.fields:
            arr = data.prims[ptype.name][fname]
            if kind == "vec3":
                for ax_i, ax in enumerate("xyz"):
                    s[f"{fname}_{ax}"] = arr[:, ax_i]
            elif kind == "float":
                s[fname] = arr
            # ints (material_id) are not SDF inputs
        out[ptype.name] = s
    return out


def candidate_dists(spec: SceneSpec, data: SceneData, cand, p, planar=None):
    """Distances from one point to K primitives given by global index
    (dead/-1 entries -> max_dist); f32[K].

    With ``planar`` (from :func:`planar_prims`), parameter gathers are one
    [K] fetch per scalar component instead of [K, 3] vec3 row gathers, so a
    batched query (each holding [rays, K] of these under vmap) keeps dense
    1-D operands.
    """
    k = cand.shape[0]
    dists = jnp.full((k,), spec.max_dist, jnp.float32)
    for ptype, cap in spec.prims:
        if cap == 0:
            continue
        off = spec.prim_offset(ptype)
        in_type = (cand >= off) & (cand < off + cap)
        local = jnp.clip(cand - off, 0, cap - 1)
        if planar is not None and ptype.name in planar:
            s = {name: arr[local] for name, arr in planar[ptype.name].items()}
            d = ptype.sdf_planar(s, p[0], p[1], p[2])
        else:
            params = jax.tree.map(lambda a: a[local],
                                  data.prims[ptype.name])
            d = jax.vmap(lambda prm: ptype.sdf(prm, p))(params)
        dists = jnp.where(in_type, d, dists)
    return dists


@partial(jax.jit, static_argnames=("spec", "settings", "method"))
def build_grid(spec: SceneSpec, settings: PartitioningSettings,
               data: SceneData, method: str = "gpu_fast") -> GridData:
    """Build the per-cell candidate lists (Update_Partitioning)."""
    centers, _ = _cell_centers(settings)             # [nc,3]
    k = settings.index_count
    diag = settings.cell_diag
    total = spec.total_prim_capacity

    def per_cell(center):
        dists = all_slot_dists(spec, data, center)   # [total]
        closest = jnp.min(dists)
        if method in ("gpu_fast", "cpu_fast"):
            keep = dists < closest + diag
        elif method == "cpu_best":
            # 3×3×3 sample points per cell; keep argmin primitives
            offs = jnp.asarray(
                [[(i % 3 - 1), (i // 3 % 3 - 1), (i // 9 - 1)]
                 for i in range(27)], jnp.float32) * 0.5
            sp = jnp.asarray(settings.grid_spacing, jnp.float32)
            samples = center + offs * sp
            sdists = jax.vmap(
                lambda q: all_slot_dists(spec, data, q))(samples)  # [27,T]
            winners = jnp.argmin(sdists, axis=1)
            keep = jnp.zeros((total,), bool).at[winners].set(True)
        else:
            raise ValueError(method)
        keep = keep & (dists < spec.max_dist)
        # pack up to K candidates, nearest first (sorted by center dist)
        order = jnp.argsort(jnp.where(keep, dists, jnp.inf))
        cand = jnp.where(jnp.arange(total) < jnp.sum(keep),
                         order, -1)[:k].astype(jnp.int32)
        count = jnp.minimum(jnp.sum(keep), k).astype(jnp.int32)
        return cand, count

    cells, counts = jax.vmap(per_cell)(centers)
    return GridData(cells=cells, counts=counts)


def grid_closest(spec: SceneSpec, settings: PartitioningSettings,
                 data: SceneData, grid: GridData, p, planar=None):
    """partitioning_closest for one point (madarch-scenes.adb:839-1118):
    candidate-list min, with clamp or full-scene fallback at the border.
    Pass ``planar`` (built outside the vmap) for the memory-lean gathers."""
    off = jnp.asarray(settings.grid_offset, jnp.float32)
    sp = jnp.asarray(settings.grid_spacing, jnp.float32)
    dims = jnp.asarray(settings.grid_dimensions, jnp.int32)

    rel = (p - off) / sp
    idx3 = jnp.floor(rel).astype(jnp.int32)
    inside = jnp.all((idx3 >= 0) & (idx3 < dims))
    idx3c = jnp.clip(idx3, 0, dims - 1)
    cid = cell_id(settings, idx3c)

    cand = grid.cells[cid]
    count = grid.counts[cid]
    dists = candidate_dists(spec, data, cand, p, planar=planar)
    dists = jnp.where(jnp.arange(cand.shape[0]) < count, dists,
                      spec.max_dist)
    dmin = jnp.minimum(jnp.min(dists), spec.max_dist)

    if settings.border_behavior == "fallback":
        from madarch_tpu.scene.scene import scene_sdf
        full = scene_sdf(spec, data, p)
        return jnp.where(inside, dmin, full)
    return dmin
