"""Primitive types: analytic signed-distance functions and normals.

JAX counterpart of the reference's primitive layer
(/root/reference/madarch/madarch-primitives.ads:10-60 and the
Spheres/Planes/Boxes/Triangles child packages).  Where the reference defines
each primitive as a symbolic expression tree that is later compiled to GLSL
and interpreted on the CPU, here a primitive is a plain JAX-traceable Python
function: ``jax.jit`` plays the role of the scene compiler, running the same
function un-jitted plays the role of the CPU interpreter, and ``jax.grad``
replaces the symbolic forward-difference derivatives
(/root/reference/madarch/madarch-exprs-derivatives.adb:20-47).

A ``PrimitiveType`` carries a field schema (name -> kind) mirroring the
reference's Component lists, plus ``sdf``/``normal`` callbacks operating on a
dict of per-instance parameters and a single query point.  Batch dimensions
are added by the scene layer with ``jax.vmap``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import jax
import jax.numpy as jnp

from madarch_tpu.core import vecmath as vm

# Field kinds (the reference's Value_Kind, madarch-values.ads:8-62).
VEC3 = "vec3"
FLOAT = "float"
INT = "int"

_KIND_SHAPE = {VEC3: (3,), FLOAT: (), INT: ()}
_KIND_DTYPE = {VEC3: jnp.float32, FLOAT: jnp.float32, INT: jnp.int32}


def kind_shape(kind: str):
    return _KIND_SHAPE[kind]


def kind_dtype(kind: str):
    return _KIND_DTYPE[kind]


@dataclasses.dataclass(frozen=True, eq=False)
class PrimitiveType:
    """A primitive *type*: schema + distance/normal functions.

    ``eq=False`` gives identity-based hash/eq, matching the reference's
    pointer-identity Hash for primitives (madarch-primitives.adb:139-143) so
    types can key dicts and appear in static jit arguments.
    """

    name: str
    fields: tuple  # tuple[(field_name, kind), ...]; material_id implied last
    sdf: Callable  # (params: dict, p: f32[3]) -> f32[]
    normal: Optional[Callable] = None  # (params, p) -> f32[3]; None => grad
    # Planar form: params hold per-component arrays (vec3 fields appear as
    # name_x/name_y/name_z) and px/py/pz are equally shaped arrays.  Used by
    # the partitioning candidate queries (scene/partitioning.py), whose
    # [K] parameter gathers stay one 1-D fetch per scalar component.
    # None => those queries use the vector ``sdf`` under vmap.
    sdf_planar: Optional[Callable] = None  # (params, px, py, pz) -> dist

    def distance(self, params, p):
        return self.sdf(params, p)

    def analytic_or_grad_normal(self, params, p):
        if self.normal is not None:
            return self.normal(params, p)
        g = jax.grad(lambda q: self.sdf(params, q))(p)
        return vm.normalize(g)

    @property
    def field_names(self):
        return tuple(n for n, _ in self.fields)


# ---------------------------------------------------------------------------
# Sphere (reference madarch-primitives-spheres.ads:13-24)
# ---------------------------------------------------------------------------

def _sphere_sdf(params, p):
    return vm.length(params["center"] - p) - params["radius"]


def _sphere_normal(params, p):
    return vm.normalize(p - params["center"])


def _sphere_sdf_planar(s, px, py, pz):
    dx = s["center_x"] - px
    dy = s["center_y"] - py
    dz = s["center_z"] - pz
    return jnp.sqrt(dx * dx + dy * dy + dz * dz) - s["radius"]


Sphere = PrimitiveType(
    name="sphere",
    fields=(("center", VEC3), ("radius", FLOAT), ("material_id", INT)),
    sdf=_sphere_sdf,
    normal=_sphere_normal,
    sdf_planar=_sphere_sdf_planar,
)


# ---------------------------------------------------------------------------
# Plane (reference madarch-primitives-planes.ads:13-17)
# ---------------------------------------------------------------------------

def _plane_sdf(params, p):
    return vm.dot(params["normal"], p) + params["offset"]


def _plane_normal(params, p):
    return params["normal"] * jnp.ones_like(p)


def _plane_sdf_planar(s, px, py, pz):
    return (s["normal_x"] * px + s["normal_y"] * py + s["normal_z"] * pz
            + s["offset"])


Plane = PrimitiveType(
    name="plane",
    fields=(("normal", VEC3), ("offset", FLOAT), ("material_id", INT)),
    sdf=_plane_sdf,
    normal=_plane_normal,
    sdf_planar=_plane_sdf_planar,
)


# ---------------------------------------------------------------------------
# Box (reference madarch-primitives-boxes.adb:7-43); `side` is a vec3 of
# half-extents, matching the DSL schema used by the examples.
# ---------------------------------------------------------------------------

def _box_sdf(params, p):
    q = jnp.abs(params["center"] - p) - params["side"]
    outside = vm.length(jnp.maximum(q, 0.0))
    inside = jnp.minimum(jnp.max(q, axis=-1), 0.0)
    return outside + inside


def _box_normal(params, p):
    # Axis-select normal with epsilon tie-break (boxes.adb:17-43, eps 0.002).
    eps = 0.002
    d = (p - params["center"]) / params["side"]
    r = jnp.abs(d)
    rx, ry, rz = r[..., 0], r[..., 1], r[..., 2]
    n = vm.vec3(
        (rx > ry - eps) * (rx > rz - eps) * jnp.sign(d[..., 0]),
        (ry > rx - eps) * (ry > rz - eps) * jnp.sign(d[..., 1]),
        (rz > rx - eps) * (rz > ry - eps) * jnp.sign(d[..., 2]),
    )
    return vm.normalize(n)


def _box_sdf_planar(s, px, py, pz):
    qx = jnp.abs(s["center_x"] - px) - s["side_x"]
    qy = jnp.abs(s["center_y"] - py) - s["side_y"]
    qz = jnp.abs(s["center_z"] - pz) - s["side_z"]
    ox = jnp.maximum(qx, 0.0)
    oy = jnp.maximum(qy, 0.0)
    oz = jnp.maximum(qz, 0.0)
    outside = jnp.sqrt(ox * ox + oy * oy + oz * oz)
    inside = jnp.minimum(jnp.maximum(qx, jnp.maximum(qy, qz)), 0.0)
    return outside + inside


Box = PrimitiveType(
    name="box",
    fields=(("center", VEC3), ("side", VEC3), ("material_id", INT)),
    sdf=_box_sdf,
    normal=_box_normal,
    sdf_planar=_box_sdf_planar,
)


# ---------------------------------------------------------------------------
# Triangle — exact unsigned distance (madarch-primitives-triangles.adb:17-47,
# the iq triangle-SDF).  Normal defaults to the autodiff gradient of the SDF,
# replacing the reference's symbolic Forward_Difference (:49-56).
# ---------------------------------------------------------------------------

def _triangle_sdf(params, p):
    v1, v2, v3 = params["v1"], params["v2"], params["v3"]
    v21 = v2 - v1
    v32 = v3 - v2
    v13 = v1 - v3
    p1 = p - v1
    p2 = p - v2
    p3 = p - v3
    nor = vm.cross(v21, v13)

    inside = (
        jnp.sign(vm.dot(vm.cross(v21, nor), p1))
        + jnp.sign(vm.dot(vm.cross(v32, nor), p2))
        + jnp.sign(vm.dot(vm.cross(v13, nor), p3))
    ) < 2.0

    def edge(v, q):
        t = vm.clamp(vm.dot(v, q) / jnp.maximum(vm.dot2(v), 1e-30), 0.0, 1.0)
        return vm.dot2(v * t[..., None] - q)

    edge_d2 = jnp.minimum(jnp.minimum(edge(v21, p1), edge(v32, p2)),
                          edge(v13, p3))
    plane_d2 = vm.dot(nor, p1) ** 2 / jnp.maximum(vm.dot2(nor), 1e-30)
    return jnp.sqrt(jnp.maximum(jnp.where(inside, edge_d2, plane_d2), 1e-30))


def _triangle_sdf_planar(s, px, py, pz):
    def v(name):
        return (s[name + "_x"], s[name + "_y"], s[name + "_z"])

    def sub(a, b):
        return (a[0] - b[0], a[1] - b[1], a[2] - b[2])

    def dotp(a, b):
        return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]

    def crossp(a, b):
        return (a[1] * b[2] - a[2] * b[1],
                a[2] * b[0] - a[0] * b[2],
                a[0] * b[1] - a[1] * b[0])

    v1, v2, v3 = v("v1"), v("v2"), v("v3")
    p = (px, py, pz)
    v21, v32, v13 = sub(v2, v1), sub(v3, v2), sub(v1, v3)
    p1, p2, p3 = sub(p, v1), sub(p, v2), sub(p, v3)
    nor = crossp(v21, v13)

    inside = (jnp.sign(dotp(crossp(v21, nor), p1))
              + jnp.sign(dotp(crossp(v32, nor), p2))
              + jnp.sign(dotp(crossp(v13, nor), p3))) < 2.0

    def edge(vv, q):
        t = jnp.clip(dotp(vv, q) / jnp.maximum(dotp(vv, vv), 1e-30),
                     0.0, 1.0)
        ex = vv[0] * t - q[0]
        ey = vv[1] * t - q[1]
        ez = vv[2] * t - q[2]
        return ex * ex + ey * ey + ez * ez

    edge_d2 = jnp.minimum(jnp.minimum(edge(v21, p1), edge(v32, p2)),
                          edge(v13, p3))
    plane_d2 = dotp(nor, p1) ** 2 / jnp.maximum(dotp(nor, nor), 1e-30)
    return jnp.sqrt(jnp.maximum(jnp.where(inside, edge_d2, plane_d2),
                                1e-30))


Triangle = PrimitiveType(
    name="triangle",
    fields=(("v1", VEC3), ("v2", VEC3), ("v3", VEC3), ("material_id", INT)),
    sdf=_triangle_sdf,
    normal=None,  # jax.grad of the SDF, normalized
    sdf_planar=_triangle_sdf_planar,
)


def make_primitive(name: str, fields: tuple, sdf: Callable,
                   normal: Optional[Callable] = None) -> PrimitiveType:
    """User-defined primitive types (the reference's Primitives.Create)."""
    return PrimitiveType(name=name, fields=tuple(fields), sdf=sdf,
                         normal=normal)
