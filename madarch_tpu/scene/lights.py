"""Light types: point and spot lights plus a registry for user types.

JAX counterpart of the reference's madarch/madarch-lights.ads:6-37 and
the Point_Lights / Spot_Lights child packages.  A light's ``sample`` returns
(radiance, direction-to-light, distance) for a shading point, matching the
generated GLSL ``sample_<light>`` functions (madarch-scenes.adb:497-549).

Semantics follow the *generated* DSL code (what the reference actually runs),
not the checked-in hand-written scene.glsl: the point light is
``color / (d^2 * 0.03)`` with no attenuation cap
(madarch-lights-point_lights.ads:22-25), while the spot light caps its
attenuation at 1.5 and applies the cone falloff
(madarch-lights-spot_lights.adb:6-26).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import jax.numpy as jnp

from madarch_tpu.core import vecmath as vm
from madarch_tpu.scene.primitives import VEC3, FLOAT


@dataclasses.dataclass(frozen=True, eq=False)
class LightType:
    """A light *type*: schema + sampling function (identity hash/eq)."""

    name: str
    fields: tuple  # tuple[(field_name, kind), ...]
    # sample(params, pos, normal) -> (radiance f32[3], dir f32[3], dist f32[])
    sample: Callable
    # position(params) -> f32[3], used by the volumetric visibility pass
    position: Callable

    @property
    def field_names(self):
        return tuple(n for n, _ in self.fields)


def _to_light(params, pos):
    to_l = params["position"] - pos
    dist = vm.length(to_l)
    return to_l / dist[..., None], dist


def _point_sample(params, pos, normal):
    ldir, dist = _to_light(params, pos)
    attenuation = 1.0 / (dist * dist * 0.03)
    radiance = params["color"] * attenuation[..., None]
    return radiance, ldir, dist


PointLight = LightType(
    name="point_light",
    fields=(("position", VEC3), ("color", VEC3)),
    sample=_point_sample,
    position=lambda params: params["position"],
)


def _spot_sample(params, pos, normal):
    ldir, dist = _to_light(params, pos)
    attenuation = 1.0 / (dist * dist * 0.03)
    cos_theta = jnp.maximum(vm.dot(-ldir, params["direction"]), 0.0)
    theta = jnp.arccos(jnp.clip(cos_theta, -1.0, 1.0))
    ratio = vm.clamp(theta / params["aperture"], 0.0, 1.0)
    visible = 1.0 - ratio ** 8.0
    radiance = (params["color"]
                * (jnp.minimum(attenuation, 1.5) * visible)[..., None])
    return radiance, ldir, dist


SpotLight = LightType(
    name="spot_light",
    fields=(("position", VEC3), ("direction", VEC3), ("aperture", FLOAT),
            ("color", VEC3)),
    sample=_spot_sample,
    position=lambda params: params["position"],
)


def make_light(name, fields, sample, position) -> LightType:
    """User-defined light types (the reference's Lights.Create)."""
    return LightType(name=name, fields=tuple(fields), sample=sample,
                     position=position)
