"""Scene representation: static spec + struct-of-arrays device data.

JAX counterpart of the reference's scene compiler
(/root/reference/madarch/madarch-scenes.ads:47-76).  Where the reference emits
specialized GLSL (structs, dist functions, dispatch loops) and an std140
memory layout at startup, here:

- ``SceneSpec`` is the *static* half — primitive/light types with fixed
  capacities, max_dist, material capacity.  It is hashable and becomes a jit
  static argument, so XLA specializes the compiled scene functions exactly
  like ``Scenes.Compile`` specialized GLSL (madarch-scenes.adb:1189-1266).
- ``SceneData`` is the *dynamic* half — a struct-of-arrays pytree with fixed
  capacities and int32 counts, the analogue of the ``scene_description`` UBO
  (generated block, madarch-scenes.adb:551-600).  Masking by count replaces
  the GLSL ``for (i < count)`` loops; every array keeps a static shape.

The scene-level queries mirror the generated GLSL dispatch helpers:
``sdf`` = closest_primitive (:602-629), ``sdf_info`` = closest_primitive_info
(:631-674), ``primitive_info`` (:676-729), ``sample_light`` (:731-764).
Global primitive indices follow the reference convention: each type occupies
a block of size == its *capacity*, in spec order.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from madarch_tpu.core import vecmath as vm
from madarch_tpu.scene.primitives import (PrimitiveType, kind_dtype,
                                          kind_shape)
from madarch_tpu.scene.lights import LightType

MAX_MATERIALS = 20  # reference materials.glsl:7-10 capacity


@dataclasses.dataclass(frozen=True)
class SceneSpec:
    """Static scene shape: (type, capacity) pairs; a jit static argument.

    ``partitioning`` mirrors Scenes.Compile's Partitioning_Settings argument
    (madarch-scenes.ads:47-55): None disables the grid.
    """

    prims: Tuple[Tuple[PrimitiveType, int], ...]
    lights: Tuple[Tuple[LightType, int], ...]
    max_dist: float = 20.0
    max_materials: int = MAX_MATERIALS
    partitioning: object = None  # Optional[PartitioningSettings]
    # Static *live* counts (aligned with prims/lights order).  When set, the
    # compiled scene functions iterate only over live slots with no dynamic
    # count masking — the analogue of the reference recompiling specialized
    # GLSL for the scene at hand (madarch-scenes.adb:1189-1266).  The caller
    # (Renderer) re-specializes (recompiles) whenever a count changes.
    live_prims: Tuple[int, ...] = None
    live_lights: Tuple[int, ...] = None

    def specialized(self, prim_counts: dict,
                    light_counts: dict) -> "SceneSpec":
        """Bake live counts (name->int dicts) in as static loop bounds."""
        return dataclasses.replace(
            self,
            live_prims=tuple(min(cap, int(prim_counts.get(pt.name, cap)))
                             for pt, cap in self.prims),
            live_lights=tuple(min(cap, int(light_counts.get(lt.name, cap)))
                              for lt, cap in self.lights))

    def prim_bounds(self):
        """Yield (ptype, capacity, static loop bound, counts_are_static)."""
        for k, (ptype, cap) in enumerate(self.prims):
            n = cap if self.live_prims is None else self.live_prims[k]
            yield ptype, cap, n, self.live_prims is not None

    def light_bounds(self):
        for k, (ltype, cap) in enumerate(self.lights):
            n = cap if self.live_lights is None else self.live_lights[k]
            yield ltype, cap, n, self.live_lights is not None

    def prim_offset(self, ptype: PrimitiveType) -> int:
        """Start of this type's global-index block (capacity-based)."""
        off = 0
        for pt, cap in self.prims:
            if pt is ptype:
                return off
            off += cap
        raise KeyError(ptype.name)

    @property
    def total_prim_capacity(self) -> int:
        return sum(cap for _, cap in self.prims)

    def empty_data(self) -> "SceneData":
        prims = {}
        counts = {}
        for ptype, cap in self.prims:
            prims[ptype.name] = {
                fname: jnp.zeros((cap,) + kind_shape(kind), kind_dtype(kind))
                for fname, kind in ptype.fields
            }
            counts[ptype.name] = jnp.zeros((), jnp.int32)
        lights = {}
        lcounts = {}
        for ltype, cap in self.lights:
            lights[ltype.name] = {
                fname: jnp.zeros((cap,) + kind_shape(kind), kind_dtype(kind))
                for fname, kind in ltype.fields
            }
            lcounts[ltype.name] = jnp.zeros((), jnp.int32)
        materials = {
            "albedo": jnp.zeros((self.max_materials, 3), jnp.float32),
            "metallic": jnp.zeros((self.max_materials,), jnp.float32),
            "roughness": jnp.zeros((self.max_materials,), jnp.float32),
        }
        return SceneData(prims=prims, prim_counts=counts, lights=lights,
                         light_counts=lcounts, materials=materials,
                         grid=None)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class SceneData:
    """Device-side scene state (a pytree; all leaves statically shaped)."""

    prims: dict        # type name -> field name -> f32[cap,...]/i32[cap]
    prim_counts: dict  # type name -> i32[]
    lights: dict       # type name -> field name -> arrays
    light_counts: dict  # type name -> i32[]
    materials: dict    # albedo f32[M,3], metallic f32[M], roughness f32[M]
    grid: object = None  # Optional[GridData] from scene/partitioning.py

    def total_light_count(self):
        counts = list(self.light_counts.values())
        return jnp.sum(jnp.stack(counts)) if counts else jnp.zeros((), jnp.int32)


# ---------------------------------------------------------------------------
# Scene-level queries.  All take a single point p: f32[3]; callers vmap.
# ---------------------------------------------------------------------------

def _masked_type_dists(spec: SceneSpec, data: SceneData, ptype: PrimitiveType,
                       n: int, static: bool, p):
    """Distances to the first n slots of one type; with dynamic counts
    (static=False) dead slots -> max_dist."""
    params = jax.tree.map(lambda a: a[:n], data.prims[ptype.name])
    dists = jax.vmap(lambda prm: ptype.sdf(prm, p))(params)
    if static:
        return dists
    count = data.prim_counts[ptype.name]
    valid = jnp.arange(n) < count
    return jnp.where(valid, dists, spec.max_dist)


def scene_sdf(spec: SceneSpec, data: SceneData, p):
    """closest_primitive: min distance over every live primitive, capped at
    max_dist (generated GLSL, madarch-scenes.adb:602-629)."""
    closest = jnp.asarray(spec.max_dist, jnp.float32)
    for ptype, cap, n, static in spec.prim_bounds():
        if n == 0:
            continue
        closest = jnp.minimum(closest, jnp.min(
            _masked_type_dists(spec, data, ptype, n, static, p)))
    return closest


def scene_sdf_info(spec: SceneSpec, data: SceneData, p):
    """closest_primitive_info: (distance, global index) of the closest live
    primitive (madarch-scenes.adb:631-674).  Index is capacity-offset based;
    -1 when nothing is closer than max_dist."""
    closest = jnp.asarray(spec.max_dist, jnp.float32)
    index = jnp.asarray(-1, jnp.int32)
    for ptype, cap, n, static in spec.prim_bounds():
        if n == 0:
            continue
        dists = _masked_type_dists(spec, data, ptype, n, static, p)
        local_best = jnp.argmin(dists)
        local_dist = dists[local_best]
        better = local_dist < closest
        index = jnp.where(
            better, spec.prim_offset(ptype) + local_best.astype(jnp.int32),
            index)
        closest = jnp.minimum(closest, local_dist)
    return closest, index


def primitive_info(spec: SceneSpec, data: SceneData, index, p):
    """(surface normal, material_id) of the primitive with a global index,
    evaluated at hit point p (madarch-scenes.adb:676-729)."""
    normal = jnp.zeros((3,), jnp.float32)
    material_id = jnp.asarray(0, jnp.int32)
    for ptype, cap, n, static in spec.prim_bounds():
        if n == 0:
            continue
        off = spec.prim_offset(ptype)
        in_type = (index >= off) & (index < off + cap)
        local = jnp.clip(index - off, 0, cap - 1)
        params = jax.tree.map(lambda a: a[local], data.prims[ptype.name])
        n = ptype.analytic_or_grad_normal(params, p)
        normal = jnp.where(in_type, n, normal)
        material_id = jnp.where(in_type, params["material_id"], material_id)
    return normal, material_id


def sample_light(spec: SceneSpec, data: SceneData, index, p, n):
    """(radiance, dir-to-light, dist) for global light index, dispatching by
    live-count blocks like the generated sample_light
    (madarch-scenes.adb:731-764): index order is count-based, not
    capacity-based — point lights [0, point_count), then spot lights, etc."""
    radiance = jnp.zeros((3,), jnp.float32)
    ldir = jnp.zeros((3,), jnp.float32)
    ldist = jnp.asarray(1.0, jnp.float32)
    offset = jnp.asarray(0, jnp.int32)
    for ltype, cap, nlive, static in spec.light_bounds():
        if nlive == 0:
            continue
        count = nlive if static else data.light_counts[ltype.name]
        in_type = (index >= offset) & (index < offset + count)
        local = jnp.clip(index - offset, 0, cap - 1)
        params = jax.tree.map(lambda a: a[local], data.lights[ltype.name])
        rad, d, dist = ltype.sample(params, p, n)
        radiance = jnp.where(in_type, rad, radiance)
        ldir = jnp.where(in_type, d, ldir)
        ldist = jnp.where(in_type, dist, ldist)
        offset = offset + count
    return radiance, ldir, ldist


def primitive_material_id(spec: SceneSpec, data: SceneData, index):
    """material_id of a global primitive index via one packed capacity-order
    table — the material half of primitive_info without evaluating every
    type's normal (shading discards those)."""
    table = jnp.concatenate([data.prims[pt.name]["material_id"]
                             for pt, _ in spec.prims])
    return table[jnp.clip(index, 0, table.shape[0] - 1)]


def material_lookup(data: SceneData, material_id):
    mid = jnp.clip(material_id, 0, data.materials["albedo"].shape[0] - 1)
    return (data.materials["albedo"][mid],
            data.materials["metallic"][mid],
            data.materials["roughness"][mid])


# ---------------------------------------------------------------------------
# Host-side scene builder: numpy mirror with the reference's mutation API
# (Add_Primitive / Set_Primitive / Set_Light / Add_Material / Set_Material,
#  madarch-renderers.adb:335-483).
# ---------------------------------------------------------------------------

class SceneBuilder:
    """Mutable host mirror of a SceneData; ``.device_data()`` snapshots it."""

    def __init__(self, spec: SceneSpec):
        self.spec = spec
        self._prims = {}
        self._prim_counts = {}
        self._lights = {}
        self._light_counts = {}
        for ptype, cap in spec.prims:
            self._prims[ptype.name] = {
                fname: np.zeros((cap,) + kind_shape(kind),
                                kind_dtype(kind))
                for fname, kind in ptype.fields
            }
            self._prim_counts[ptype.name] = 0
        for ltype, cap in spec.lights:
            self._lights[ltype.name] = {
                fname: np.zeros((cap,) + kind_shape(kind),
                                kind_dtype(kind))
                for fname, kind in ltype.fields
            }
            self._light_counts[ltype.name] = 0
        self._albedo = np.zeros((spec.max_materials, 3), np.float32)
        self._metallic = np.zeros((spec.max_materials,), np.float32)
        self._roughness = np.zeros((spec.max_materials,), np.float32)
        self._material_count = 0

    # -- primitives --
    def add_primitive(self, ptype: PrimitiveType, **fields) -> int:
        idx = self._prim_counts[ptype.name]
        cap = dict((pt.name, c) for pt, c in self.spec.prims)[ptype.name]
        if idx >= cap:
            raise ValueError(
                f"capacity exceeded for {ptype.name} (cap={cap})")
        self._prim_counts[ptype.name] = idx + 1
        self.set_primitive(ptype, idx, **fields)
        return idx

    def set_primitive(self, ptype: PrimitiveType, index: int, **fields):
        store = self._prims[ptype.name]
        for fname, value in fields.items():
            store[fname][index] = value

    # -- lights --
    def add_light(self, ltype: LightType, **fields) -> int:
        idx = self._light_counts[ltype.name]
        cap = dict((lt.name, c) for lt, c in self.spec.lights)[ltype.name]
        if idx >= cap:
            raise ValueError(
                f"capacity exceeded for {ltype.name} (cap={cap})")
        self._light_counts[ltype.name] = idx + 1
        self.set_light(ltype, idx, **fields)
        return idx

    def set_light(self, ltype: LightType, index: int, **fields):
        store = self._lights[ltype.name]
        for fname, value in fields.items():
            store[fname][index] = value

    # -- materials (albedo, metallic, roughness — madarch-materials.ads) --
    def add_material(self, albedo, metallic, roughness) -> int:
        idx = self._material_count
        self._material_count += 1
        self.set_material(idx, albedo, metallic, roughness)
        return idx

    def set_material(self, index: int, albedo, metallic, roughness):
        if not 0 <= index < self.spec.max_materials:
            raise ValueError(
                f"material index {index} out of range "
                f"(max_materials={self.spec.max_materials})")
        self._albedo[index] = albedo
        self._metallic[index] = metallic
        self._roughness[index] = roughness
        self._material_count = max(self._material_count, index + 1)

    def device_data(self, grid=None) -> SceneData:
        return SceneData(
            grid=grid,
            prims=jax.tree.map(jnp.asarray, self._prims),
            prim_counts={k: jnp.asarray(v, jnp.int32)
                         for k, v in self._prim_counts.items()},
            lights=jax.tree.map(jnp.asarray, self._lights),
            light_counts={k: jnp.asarray(v, jnp.int32)
                          for k, v in self._light_counts.items()},
            materials={
                "albedo": jnp.asarray(self._albedo),
                "metallic": jnp.asarray(self._metallic),
                "roughness": jnp.asarray(self._roughness),
            },
        )
