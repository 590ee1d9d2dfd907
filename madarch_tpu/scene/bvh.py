"""Generic SAH bounding-volume hierarchy + BVH-compiled scene SDF.

JAX counterpart of the reference's generic BVH package
(/root/reference/madarch/support/bounding_volume_hierarchies.ads:5-48:
sweep-SAH best split over all 3 axes with pre-sorted per-axis index arrays)
and of the bvh_test example's *BVH-as-expression* trick
(examples/bvh_test/main.adb:60-160): the tree is compiled into a single
nested distance computation — node = let bbd = box_sdf(aabb) in
(bbd < 0.2 ? min(left, right) : bbd) — which is exactly a static unrolled
``jnp.where`` tree here; XLA evaluates all branches and selects, the
batched equivalent of the GLSL early-out (SIMD lanes pay both sides either
way).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence

import jax.numpy as jnp
import numpy as np


# ---------------------------------------------------------------------------
# AABB helpers (support/bounding_boxes.ads:3-20)
# ---------------------------------------------------------------------------

def aabb_extend(lo1, hi1, lo2, hi2):
    return np.minimum(lo1, lo2), np.maximum(hi1, hi2)


def aabb_surface_area(lo, hi):
    d = np.maximum(hi - lo, 0.0)
    return 2.0 * (d[0] * d[1] + d[1] * d[2] + d[0] * d[2])


def aabb_contains(lo, hi, p):
    return bool(np.all(p >= lo) and np.all(p <= hi))


def aabb_sdf(lo, hi, p):
    """Box SDF of an AABB (the BB_Dist_Expr of bvh_test/main.adb:76-84),
    jnp, batched over p's leading dims."""
    center = jnp.asarray((lo + hi) / 2.0, jnp.float32)
    side = jnp.asarray(hi - lo, jnp.float32)  # full extents, per reference
    q = jnp.abs(center - p) - side
    outside = jnp.sqrt(jnp.maximum(jnp.sum(jnp.maximum(q, 0.0) ** 2, -1),
                                   1e-30))
    inside = jnp.minimum(jnp.max(q, axis=-1), 0.0)
    return outside + inside


# ---------------------------------------------------------------------------
# SAH build
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class BVHNode:
    lo: np.ndarray
    hi: np.ndarray
    axis: int = -1
    left: Optional["BVHNode"] = None
    right: Optional["BVHNode"] = None
    indices: Optional[np.ndarray] = None  # leaf payload

    @property
    def is_leaf(self):
        return self.indices is not None

    def dump(self, depth=0):
        pad = "  " * depth
        if self.is_leaf:
            print(f"{pad}leaf {list(self.indices)} bb {self.lo}..{self.hi}")
        else:
            print(f"{pad}node axis={self.axis} bb {self.lo}..{self.hi}")
            self.left.dump(depth + 1)
            self.right.dump(depth + 1)


def build_bvh(bboxes: Sequence, leaf_size: int = 1) -> BVHNode:
    """Sweep-SAH over all 3 axes (bounding_volume_hierarchies.adb:57-160).

    bboxes: sequence of (lo f32[3], hi f32[3]) per primitive.
    """
    los = np.asarray([b[0] for b in bboxes], np.float32)
    his = np.asarray([b[1] for b in bboxes], np.float32)
    centers = (los + his) / 2.0

    def node_bounds(idx):
        return los[idx].min(axis=0), his[idx].max(axis=0)

    def recurse(idx: np.ndarray) -> BVHNode:
        lo, hi = node_bounds(idx)
        if len(idx) <= leaf_size:
            return BVHNode(lo=lo, hi=hi, indices=idx.copy())

        best = None  # (cost, axis, k, order)
        for axis in range(3):
            order = idx[np.argsort(centers[idx, axis], kind="stable")]
            # prefix/suffix AABB surface areas
            n = len(order)
            pref = np.empty(n)
            suff = np.empty(n)
            l_lo, l_hi = los[order[0]].copy(), his[order[0]].copy()
            for i in range(n):
                l_lo, l_hi = aabb_extend(l_lo, l_hi, los[order[i]],
                                         his[order[i]])
                pref[i] = aabb_surface_area(l_lo, l_hi)
            r_lo, r_hi = los[order[-1]].copy(), his[order[-1]].copy()
            for i in range(n - 1, -1, -1):
                r_lo, r_hi = aabb_extend(r_lo, r_hi, los[order[i]],
                                         his[order[i]])
                suff[i] = aabb_surface_area(r_lo, r_hi)
            for k in range(1, n):
                cost = pref[k - 1] * k + suff[k] * (n - k)
                if best is None or cost < best[0]:
                    best = (cost, axis, k, order)

        _, axis, k, order = best
        return BVHNode(lo=lo, hi=hi, axis=axis,
                       left=recurse(order[:k]), right=recurse(order[k:]))

    return recurse(np.arange(len(bboxes)))


def visit(node: BVHNode, leaf_fn: Callable, node_fn: Callable):
    """Generic fold (the reference's Visitors.Visit)."""
    if node.is_leaf:
        return leaf_fn(node)
    left = visit(node.left, leaf_fn, node_fn)
    right = visit(node.right, leaf_fn, node_fn)
    return node_fn(node, left, right)


def bvh_sdf(node: BVHNode, leaf_sdfs: Sequence[Callable],
            threshold: float = 0.2) -> Callable:
    """Compile the tree into one distance function p -> dist, with the
    bvh_test early-out semantics: outside a node's threshold shell the node's
    own box distance stands in for its subtree (a conservative lower bound).

    leaf_sdfs[i]: p -> dist for primitive i.
    """

    def leaf_fn(n: BVHNode):
        i = int(n.indices[0])

        def f(p):
            bbd = aabb_sdf(n.lo, n.hi, p)
            return jnp.where(bbd < threshold, leaf_sdfs[i](p), bbd)
        return f

    def node_fn(n: BVHNode, left, right):
        def f(p):
            bbd = aabb_sdf(n.lo, n.hi, p)
            return jnp.where(bbd < threshold,
                             jnp.minimum(left(p), right(p)), bbd)
        return f

    return visit(node, leaf_fn, node_fn)


def make_bvh_primitive(name: str, node: BVHNode,
                       leaf_sdfs: Sequence[Callable],
                       threshold: float = 0.2):
    """A PrimitiveType whose SDF is the compiled BVH traversal, mirroring
    bvh_test's BVH primitive (fields: position + material_id; the geometry is
    baked in world space, normals via autodiff of the traversal — the
    reference used Forward_Difference, main.adb:161-170)."""
    from madarch_tpu.scene.primitives import INT, VEC3, PrimitiveType

    traverse = bvh_sdf(node, leaf_sdfs, threshold)

    def sdf(params, p):
        return traverse(p)

    return PrimitiveType(
        name=name,
        fields=(("position", VEC3), ("material_id", INT)),
        sdf=sdf,
        normal=None,  # autodiff gradient
    )
