"""Unit tests for primitive SDFs/normals against closed-form values.

Mirrors the reference formulas (madarch-primitives-*.ads/adb); the dual
CPU/GPU interpretation oracle of the reference becomes: the same function,
un-jitted vs jitted, plus autodiff-gradient normals vs analytic normals.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from madarch_tpu.scene import primitives as P
from madarch_tpu.core import vecmath as vm


def v(*xs):
    return jnp.asarray(xs, jnp.float32)


class TestSphere:
    params = {"center": v(1.0, 2.0, 3.0), "radius": jnp.float32(2.0),
              "material_id": jnp.int32(0)}

    def test_distance(self):
        d = P.Sphere.sdf(self.params, v(1.0, 2.0, 6.0))
        assert np.isclose(d, 1.0, atol=1e-6)
        d_inside = P.Sphere.sdf(self.params, v(1.0, 2.0, 3.5))
        assert np.isclose(d_inside, -1.5, atol=1e-6)

    def test_normal_matches_grad(self):
        p = v(3.0, 4.0, 5.0)
        analytic = P.Sphere.analytic_or_grad_normal(self.params, p)
        g = jax.grad(lambda q: P.Sphere.sdf(self.params, q))(p)
        np.testing.assert_allclose(analytic, vm.normalize(g), atol=1e-5)


class TestPlane:
    params = {"normal": v(0.0, 1.0, 0.0), "offset": jnp.float32(1.0),
              "material_id": jnp.int32(0)}

    def test_distance(self):
        assert np.isclose(P.Plane.sdf(self.params, v(5.0, 2.0, -3.0)), 3.0)
        assert np.isclose(P.Plane.sdf(self.params, v(0.0, -1.0, 0.0)), 0.0)

    def test_normal(self):
        n = P.Plane.analytic_or_grad_normal(self.params, v(9.0, 9.0, 9.0))
        np.testing.assert_allclose(n, [0.0, 1.0, 0.0], atol=1e-6)


class TestBox:
    params = {"center": v(0.0, 0.0, 0.0), "side": v(1.0, 2.0, 3.0),
              "material_id": jnp.int32(0)}

    def test_outside_face(self):
        # 1.5 units beyond the +x face
        assert np.isclose(P.Box.sdf(self.params, v(2.5, 0.0, 0.0)), 1.5,
                          atol=1e-6)

    def test_outside_corner(self):
        d = P.Box.sdf(self.params, v(2.0, 3.0, 4.0))
        assert np.isclose(d, np.sqrt(3.0), atol=1e-5)

    def test_inside(self):
        d = P.Box.sdf(self.params, v(0.0, 0.0, 0.0))
        assert np.isclose(d, -1.0, atol=1e-6)  # closest face is x at dist 1

    def test_normal_axis(self):
        n = P.Box.analytic_or_grad_normal(self.params, v(1.7, 0.0, 0.0))
        np.testing.assert_allclose(n, [1.0, 0.0, 0.0], atol=1e-5)
        n = P.Box.analytic_or_grad_normal(self.params, v(0.0, -2.5, 0.0))
        np.testing.assert_allclose(n, [0.0, -1.0, 0.0], atol=1e-5)

    def test_normal_matches_grad_on_faces(self):
        for p in [v(1.9, 0.3, 0.4), v(-0.2, 2.4, 0.1), v(0.5, -0.5, 3.3)]:
            analytic = P.Box.analytic_or_grad_normal(self.params, p)
            g = vm.normalize(jax.grad(
                lambda q: P.Box.sdf(self.params, q))(p))
            np.testing.assert_allclose(analytic, g, atol=1e-4)


class TestTriangle:
    params = {"v1": v(0.0, 0.0, 0.0), "v2": v(2.0, 0.0, 0.0),
              "v3": v(0.0, 2.0, 0.0), "material_id": jnp.int32(0)}

    def test_above_interior(self):
        # directly above the centroid: distance is the height
        d = P.Triangle.sdf(self.params, v(0.5, 0.5, 1.5))
        assert np.isclose(d, 1.5, atol=1e-5)

    def test_beyond_edge(self):
        # beyond the v1-v2 edge in-plane
        d = P.Triangle.sdf(self.params, v(1.0, -2.0, 0.0))
        assert np.isclose(d, 2.0, atol=1e-5)

    def test_beyond_vertex(self):
        d = P.Triangle.sdf(self.params, v(-3.0, -4.0, 0.0))
        assert np.isclose(d, 5.0, atol=1e-5)

    def test_grad_normal_above(self):
        n = P.Triangle.analytic_or_grad_normal(self.params, v(0.5, 0.5, 1.0))
        np.testing.assert_allclose(np.abs(n), [0.0, 0.0, 1.0], atol=1e-4)


def test_jit_matches_eager():
    """The reference's dual CPU/GLSL interpretation oracle: same function,
    jitted (device semantics) vs un-jitted."""
    params = {"center": v(0.3, -0.2, 0.9), "side": v(0.7, 1.1, 0.4),
              "material_id": jnp.int32(0)}
    pts = jnp.asarray(np.random.RandomState(0).randn(64, 3), jnp.float32)
    f = lambda p: P.Box.sdf(params, p)
    eager = jax.vmap(f)(pts)
    jitted = jax.jit(jax.vmap(f))(pts)
    np.testing.assert_allclose(eager, jitted, rtol=1e-6, atol=1e-6)


def test_planar_sdf_matches_vector_sdf():
    """Planar forms (used by the partitioning candidate queries) == vector
    forms used everywhere else."""
    rng = np.random.RandomState(7)
    pts = jnp.asarray(rng.randn(32, 3).astype(np.float32) * 3)
    cases = [
        (P.Sphere, {"center": jnp.asarray([0.5, -1.0, 2.0]),
                    "radius": jnp.float32(1.3)}),
        (P.Plane, {"normal": jnp.asarray([0.0, 1.0, 0.0]),
                   "offset": jnp.float32(2.0)}),
        (P.Box, {"center": jnp.asarray([1.0, 0.0, -1.0]),
                 "side": jnp.asarray([0.5, 1.5, 2.0])}),
        (P.Triangle, {"v1": jnp.asarray([0.0, 0.0, 0.0]),
                      "v2": jnp.asarray([2.0, 0.0, 0.0]),
                      "v3": jnp.asarray([0.0, 2.0, 0.0])}),
    ]
    for ptype, params in cases:
        ref = jax.vmap(lambda p: ptype.sdf(params, p))(pts)
        scal = {}
        for k, val in params.items():
            if val.ndim == 1:
                for i, ax in enumerate("xyz"):
                    scal[f"{k}_{ax}"] = val[i]
            else:
                scal[k] = val
        planar = ptype.sdf_planar(scal, pts[:, 0], pts[:, 1], pts[:, 2])
        np.testing.assert_allclose(planar, ref, rtol=1e-5, atol=1e-5,
                                   err_msg=ptype.name)
