"""Triangle meshes: OBJ loading, bounding boxes, voxelization, SDF baking.

JAX counterpart of the reference's mesh support layer
(/root/reference/madarch/support/meshes.ads:11-19, meshes-obj_loader.adb:22-113,
meshes-voxels.adb:8-54, meshes-distance_maps.adb:17-301,
bounding_boxes.ads:3-20).  Host-side data is numpy; the SDF baker is a jitted
brute-force pairwise reduction (exact closest-triangle distance over a dense
grid — embarrassingly parallel, unlike the reference's sequential
Danielsson sweep transform).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


@dataclasses.dataclass
class Mesh:
    """Indexed triangle mesh (vertices f32[V,3], normals f32[N,3],
    triangles i32[T,3] vertex indices, tri_normals i32[T,3] normal ids)."""

    vertices: np.ndarray
    normals: np.ndarray
    triangles: np.ndarray
    tri_normals: np.ndarray

    @property
    def num_triangles(self) -> int:
        return len(self.triangles)

    def triangle_vertices(self):
        """f32[T, 3(corner), 3(xyz)]."""
        return self.vertices[self.triangles]

    def bounding_box(self):
        """(lo f32[3], hi f32[3]) — Meshes.Compute_Bounding_Box."""
        return self.vertices.min(axis=0), self.vertices.max(axis=0)

    def dump_info(self):
        lo, hi = self.bounding_box()
        print(f"mesh: {len(self.vertices)} vertices, "
              f"{self.num_triangles} triangles, bb {lo} .. {hi}")


def load_obj(path: str) -> Mesh:
    """Minimal OBJ parser: ``v``, ``vn``, ``f`` with v//n indices
    (meshes-obj_loader.adb:22-113); faces are triangulated by fanning."""
    vertices, normals, tris, tri_ns = [], [], [], []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v":
                vertices.append([float(x) for x in parts[1:4]])
            elif parts[0] == "vn":
                normals.append([float(x) for x in parts[1:4]])
            elif parts[0] == "f":
                refs = []
                for tok in parts[1:]:
                    comps = tok.split("/")
                    vi = int(comps[0])
                    ni = int(comps[-1]) if len(comps) >= 3 and comps[-1] \
                        else vi
                    refs.append((vi - 1, ni - 1))
                for i in range(1, len(refs) - 1):  # fan triangulation
                    tris.append([refs[0][0], refs[i][0], refs[i + 1][0]])
                    tri_ns.append([refs[0][1], refs[i][1], refs[i + 1][1]])
    return Mesh(
        vertices=np.asarray(vertices, np.float32),
        normals=(np.asarray(normals, np.float32) if normals
                 else np.zeros((0, 3), np.float32)),
        triangles=np.asarray(tris, np.int32).reshape(-1, 3),
        tri_normals=np.asarray(tri_ns, np.int32).reshape(-1, 3),
    )


def voxelize(mesh: Mesh, dims, lo=None, hi=None) -> np.ndarray:
    """Vertex-sampling voxelization into a bool[W,H,D] grid
    (meshes-voxels.adb:8-54): a voxel is set if any vertex falls in it."""
    lo0, hi0 = mesh.bounding_box()
    lo = lo0 if lo is None else np.asarray(lo, np.float32)
    hi = hi0 if hi is None else np.asarray(hi, np.float32)
    dims = np.asarray(dims, np.int64)
    extent = np.maximum(hi - lo, 1e-12)
    cells = ((mesh.vertices - lo) / extent * dims).astype(np.int64)
    cells = np.clip(cells, 0, dims - 1)
    grid = np.zeros(tuple(dims), bool)
    grid[cells[:, 0], cells[:, 1], cells[:, 2]] = True
    return grid


def _triangle_dist_and_closest(v1, v2, v3, p):
    """Exact point-triangle distance², closest point, and face normal for a
    single triangle against a batch of points p[N,3] (the iq construction,
    meshes-distance_maps.adb:158-301 / primitives-triangles)."""
    v21, v32, v13 = v2 - v1, v3 - v2, v1 - v3
    p1, p2, p3 = p - v1, p - v2, p - v3
    nor = jnp.cross(v21, v13)

    def dot(a, b):
        # full f32: these are distances, not features
        return jnp.dot(a, b, precision=lax.Precision.HIGHEST)

    def edge_closest(v, q, base):
        t = jnp.clip(dot(q, v) / jnp.maximum(dot(v, v), 1e-30), 0.0, 1.0)
        c = base + t[:, None] * v
        return c, jnp.sum((c - p) ** 2, axis=-1)

    c1, d1 = edge_closest(v21, p1, v1)
    c2, d2 = edge_closest(v32, p2, v2)
    c3, d3 = edge_closest(v13, p3, v3)

    inside = (jnp.sign(dot(p1, jnp.cross(v21, nor)))
              + jnp.sign(dot(p2, jnp.cross(v32, nor)))
              + jnp.sign(dot(p3, jnp.cross(v13, nor)))) < 2.0

    nn = nor / jnp.maximum(jnp.linalg.norm(nor), 1e-30)
    plane_off = dot(p1, nn)
    c_plane = p - plane_off[:, None] * nn
    d_plane = plane_off ** 2

    edge_d = jnp.minimum(jnp.minimum(d1, d2), d3)
    c_edge = jnp.where((d1 <= d2)[:, None] & (d1 <= d3)[:, None], c1,
                       jnp.where((d2 <= d3)[:, None], c2, c3))
    d2_final = jnp.where(inside, edge_d, d_plane)
    c_final = jnp.where(inside[:, None], c_edge, c_plane)
    return d2_final, c_final, nn


def bake_distance_map(mesh: Mesh, dims, lo, hi, batch=8192):
    """Exact closest-triangle distance + normal over a dense grid.

    Returns (dist f32[X,Y,Z], normal f32[X,Y,Z,3]).  Back-facing closest
    triangles zero the distance (inside test) per the reference
    (meshes-distance_maps.adb:158-301).
    """
    dims = tuple(int(x) for x in dims)
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    xs = [np.linspace(lo[i] , hi[i], dims[i], dtype=np.float32)
          for i in range(3)]
    gx, gy, gz = np.meshgrid(*xs, indexing="ij")
    pts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)
    tv = jnp.asarray(mesh.triangle_vertices())  # [T,3,3]

    @jax.jit
    def query(p):
        def per_tri(tri):
            d2, c, nn = _triangle_dist_and_closest(tri[0], tri[1], tri[2], p)
            return d2, nn
        d2s, nns = jax.vmap(per_tri)(tv)       # [T,N], [T,3]
        best = jnp.argmin(d2s, axis=0)          # [N]
        d = jnp.sqrt(d2s[best, jnp.arange(p.shape[0])])
        n = nns[best]
        # inside (behind the closest face) => distance 0, reference behavior
        tri_best = tv[best]
        to_p = p - tri_best[:, 0]
        back = jnp.sum(to_p * n, axis=-1) < 0.0
        d = jnp.where(back, 0.0, d)
        return d, n

    out_d = np.empty(len(pts), np.float32)
    out_n = np.empty((len(pts), 3), np.float32)
    for s in range(0, len(pts), batch):
        d, n = query(jnp.asarray(pts[s:s + batch]))
        out_d[s:s + len(d)] = np.asarray(d)
        out_n[s:s + len(n)] = np.asarray(n)
    return out_d.reshape(dims), out_n.reshape(dims + (3,))


def morton_order(points: np.ndarray, bits: int = 10) -> np.ndarray:
    """Z-order sort keys for [N,3] points: spatially adjacent points land
    in adjacent slots."""
    lo = points.min(axis=0)
    extent = np.maximum(points.max(axis=0) - lo, 1e-9)
    q = ((points - lo) / extent * ((1 << bits) - 1)).astype(np.int64)
    key = np.zeros(len(points), np.int64)
    for b in range(bits):
        for a in range(3):
            key |= ((q[:, a] >> b) & 1) << (3 * b + a)
    return np.argsort(key, kind="stable")


def add_mesh_to_renderer(renderer, mesh: Mesh, material_id: int,
                         offset=(0.0, 0.0, 0.0), order="morton"):
    """Add every triangle as a Triangle primitive (obj_mesh/main.adb
    Add_Triangle + Iterate_Triangles).  ``order="morton"`` (default)
    inserts triangles in Z-order — scene order is semantically free, and
    contiguous slot ranges then hold spatially compact triangle groups, as
    any culling bound over slot ranges needs (the dense march itself does
    not depend on the order)."""
    from madarch_tpu.scene.primitives import Triangle
    off = np.asarray(offset, np.float32)
    tv = mesh.triangle_vertices() + off
    if order == "morton":
        tv = tv[morton_order(tv.mean(axis=1))]
    for a, b, c in tv:
        renderer.add_primitive(Triangle, v1=a, v2=b, v3=c,
                               material_id=material_id)
    return mesh.num_triangles
