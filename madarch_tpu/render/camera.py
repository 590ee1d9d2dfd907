"""Pinhole camera model (reference draw_screen.glsl:20-26).

Image plane is z=0 spanning [-1,1]², eye at (0,0,-1.5) in camera space:
dir = R · normalize(frag − eye), origin = R · frag + camera_position.
Row 0 of the generated ray grid is the *bottom* image row (GL framebuffer
convention); flip when exporting PNGs.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
from jax import lax


EYE = np.array([0.0, 0.0, -1.5], np.float32)


def pixel_grid(width: int, height: int):
    """Fragment positions at pixel centers: f32[H, W, 2] in [-1, 1]²."""
    xs = (np.arange(width, dtype=np.float32) + 0.5) / width * 2.0 - 1.0
    ys = (np.arange(height, dtype=np.float32) + 0.5) / height * 2.0 - 1.0
    gx, gy = np.meshgrid(xs, ys)  # [H, W]
    return jnp.asarray(np.stack([gx, gy], axis=-1))


def camera_rays(frag_xy, position, orientation):
    """frag_xy: f32[..., 2] image-plane coords -> (origins, dirs) f32[..., 3].

    position: f32[3]; orientation: f32[3,3] applied as R @ v.
    """
    frag = jnp.concatenate(
        [frag_xy, jnp.zeros(frag_xy.shape[:-1] + (1,), jnp.float32)],
        axis=-1)
    to_frag = frag - jnp.asarray(EYE)
    local_dir = to_frag / jnp.linalg.norm(to_frag, axis=-1, keepdims=True)
    # full f32 for geometry: a reduced-precision matmul would move every
    # ray origin and direction by ~1e-3
    hi = lax.Precision.HIGHEST
    dirs = jnp.einsum("ij,...j->...i", orientation, local_dir, precision=hi)
    origins = jnp.einsum("ij,...j->...i", orientation, frag,
                         precision=hi) + position
    return origins, dirs


def orientation_from_angles(rot_x: float, rot_y: float):
    """Mouse-look orientation as built by the examples
    (global_illumination/main.adb:89-124): pitch about x then yaw about y,
    composed as R = Rx(rot_x) · Ry(rot_y) in their storage convention."""
    cx, sx = np.cos(rot_x), np.sin(rot_x)
    cy, sy = np.cos(rot_y), np.sin(rot_y)
    pitch = np.array([[1, 0, 0], [0, cy, sy], [0, -sy, cy]], np.float32)
    yaw = np.array([[cx, 0, -sx], [0, 1, 0], [sx, 0, cx]], np.float32)
    return jnp.asarray(yaw @ pitch)
