"""Small vector-math helpers shared by the whole framework.

JAX counterpart of the reference's ``Math_Utils`` package
(/root/reference/madarch/support/math_utils.ads:8-96) and of the GLSL
``maths.glsl`` constants (/root/reference/madarch/glsl/maths.glsl:1-8).

Vectors are plain ``jnp`` arrays with a trailing dimension of 3; every helper
broadcasts over arbitrary leading batch dimensions so the same code serves the
single-point physics path and the million-ray render path.
"""
from __future__ import annotations

import jax.numpy as jnp

PI = 3.14159265358
PI_2 = 6.28318530718
# GLSL epsilon used as the hit threshold of the sphere tracer
# (reference maths.glsl:3).
EPSILON = 1e-3


def dot(a, b):
    """Batched vec3 dot product -> scalar with same leading dims."""
    return jnp.sum(a * b, axis=-1)


def dot2(a):
    """dot(a, a) (reference maths.glsl:6-8)."""
    return jnp.sum(a * a, axis=-1)


def length(a):
    return jnp.sqrt(jnp.maximum(dot2(a), 1e-30))


def normalize(a):
    return a / length(a)[..., None]


def cross(a, b):
    return jnp.cross(a, b)


def clamp(x, lo, hi):
    return jnp.clip(x, lo, hi)


def saturate(x):
    return jnp.clip(x, 0.0, 1.0)


def mix(a, b, t):
    """GLSL mix == lerp."""
    return a + (b - a) * t


def reflect(d, n):
    """GLSL reflect: d - 2*dot(d,n)*n."""
    return d - 2.0 * dot(d, n)[..., None] * n


def vec3(x, y, z):
    return jnp.stack(jnp.broadcast_arrays(
        jnp.asarray(x, jnp.float32),
        jnp.asarray(y, jnp.float32),
        jnp.asarray(z, jnp.float32)), axis=-1)


def sign_not_zero(v):
    """+1 for >= 0, -1 otherwise (reference probe_utils.glsl:58-61)."""
    return jnp.where(v >= 0.0, 1.0, -1.0)
