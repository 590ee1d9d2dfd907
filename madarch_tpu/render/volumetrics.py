"""Volumetric lighting (light shafts): froxel visibility grid, scattering
integration, depth-aware composite.

JAX counterpart of the reference's madarch/glsl/
compute_frustrum_visibility.glsl, accumulate_scattering.glsl, and
volumetrics.glsl.  The froxel grid is a f32[vz, vy, vx, 3] array (the
reference packs z-slices vertically into one 2D texture); the scattering map
is f32[sy, sx, 4] storing (in-scattered L, ray length).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from madarch_tpu.core.config import VolumetricsSettings
from madarch_tpu.core.vecmath import PI, dot
from madarch_tpu.render.camera import camera_rays, pixel_grid
from madarch_tpu.render.raymarch import raycast, raycast_visibility

TAU_SCATTERING = 0.1  # volumetrics.glsl:12


def henyey_greenstein_phase(in_dir, out_dir):
    """volumetrics.glsl:20-31 (g = tau_scattering, as the reference does)."""
    cos_angle = dot(in_dir, out_dir)
    g2 = TAU_SCATTERING * TAU_SCATTERING
    return (1.0 - g2) / (4.0 * PI * (1.0 + g2 - 2.0 * TAU_SCATTERING
                                     * cos_angle) ** 1.5)


def rayleigh_phase(in_dir, out_dir):
    cos_angle = dot(in_dir, out_dir)
    return 3.0 * (1.0 + cos_angle * cos_angle) / (16.0 * PI)


def _shard_batch(shard, arrs):
    """Apply a ray sharder to flat batches (pads to a mesh multiple)."""
    if shard is None:
        return arrs
    return [shard(a) for a in arrs]


def _unpad(shard, arr, n_true):
    if shard is None or not hasattr(shard, "unpad"):
        return arr
    return shard.unpad(arr, n_true)


def visibility_pass(spec, data, vol: VolumetricsSettings, sdf_b,
                    camera_position, camera_orientation, *, max_steps=300,
                    shard=None):
    """In-scattered light per froxel (compute_frustrum_visibility.glsl:8-41).

    Froxel (z, y, x) samples the camera ray through pixel (x, y) at ray
    distance z·step: single-scatter Σ_lights exp(−d·τ)·vis·radiance·HG.
    Returns f32[vz, vy, vx, 3].  ``shard`` (a parallel.spmd.RaySharder)
    splits the froxel batch over the mesh's ray axis.
    """
    vx, vy, vz = vol.visibility_resolution
    frag = pixel_grid(vx, vy)                                   # [vy,vx,2]
    origins, dirs = camera_rays(frag, camera_position, camera_orientation)
    depths = jnp.arange(vz, dtype=jnp.float32) * vol.visibility_step_size
    # sample point of each froxel: [vz, vy, vx, 3]
    pts = origins[None] + dirs[None] * depths[:, None, None, None]
    pts_f = pts.reshape(-1, 3)
    dirs_f = jnp.broadcast_to(dirs[None], (vz, vy, vx, 3)).reshape(-1, 3)
    n_true = pts_f.shape[0]

    def froxel_light(pts_f, dirs_f, data):
        """Per-froxel in-scatter; per-device under map_rays so the
        visibility march loops stay collective-free."""
        from madarch_tpu.render.context import SceneCtx
        sb = SceneCtx(spec, data) if not callable(sdf_b) else sdf_b
        result = jnp.zeros_like(pts_f)
        dummy_normal = jnp.broadcast_to(
            jnp.asarray([1.0, 0.0, 0.0], jnp.float32), pts_f.shape)
        for ltype, cap, n, static in spec.light_bounds():
            count = None if static else data.light_counts[ltype.name]
            for slot in range(n):
                live = jnp.asarray(True) if static else slot < count
                params = jax.tree.map(lambda a: a[slot],
                                      data.lights[ltype.name])
                radiance, ldir, ldist = ltype.sample(params, pts_f,
                                                     dummy_normal)
                n_r = pts_f.shape[0]
                vis = raycast_visibility(
                    sb, pts_f, ldir, ldist,
                    enabled=jnp.broadcast_to(live, (n_r,)),
                    max_steps=max_steps)
                l_in = (jnp.exp(-ldist * TAU_SCATTERING) * vis)[..., None] \
                    * radiance
                contrib = l_in * TAU_SCATTERING \
                    * henyey_greenstein_phase(ldir, dirs_f)[..., None]
                result = result + (contrib if static
                                   else jnp.where(live, contrib, 0.0))
        return result

    if shard is not None and hasattr(shard, "map_rays"):
        result = shard.map_rays(froxel_light, (pts_f, dirs_f), (data,))
    else:
        pts_f, dirs_f = _shard_batch(shard, [pts_f, dirs_f])
        result = froxel_light(pts_f, dirs_f, data)
    result = _unpad(shard, result, n_true)
    return result.reshape(vz, vy, vx, 3)


def scattering_pass(spec, data, vol: VolumetricsSettings, sdf_b, visibility,
                    camera_position, camera_orientation, *, max_steps=300,
                    shard=None):
    """Per-pixel in-scatter integral along the view ray
    (accumulate_scattering.glsl:17-31).  Returns f32[sy, sx, 4] = (L, len).

    The per-step froxel fetches are static maps (pixel -> froxel column is
    fixed by the two resolutions, z-slice is fixed per step), so the whole
    integral is gather-free: one dense froxel->scattering-grid resample +
    n_steps masked fused multiply-adds instead of a 19M-element gather
    loop.
    """
    import numpy as np

    from madarch_tpu.core.resample import floor_map, take_static

    sx, sy = vol.scattering_resolution
    vx, vy, vz = vol.visibility_resolution
    frag = pixel_grid(sx, sy)                                   # [sy,sx,2]
    origins, dirs = camera_rays(frag, camera_position, camera_orientation)
    origins_f = origins.reshape(-1, 3)
    dirs_f = dirs.reshape(-1, 3)
    n = origins_f.shape[0]
    max_depth = vol.max_depth
    if shard is not None and hasattr(shard, "map_rays"):
        def _cast(o, d, data):
            from madarch_tpu.render.context import SceneCtx
            sb = SceneCtx(spec, data) if not callable(sdf_b) else sdf_b
            t, hit, _ = raycast(sb, o, d, max_depth, max_steps=max_steps)
            return t, hit
        t, hit = shard.map_rays(_cast, (origins_f, dirs_f), (data,))
    else:
        origins_s, dirs_s = _shard_batch(shard, [origins_f, dirs_f])
        t, hit, _ = raycast(sdf_b, origins_s, dirs_s, max_depth,
                            max_steps=max_steps)
    t = _unpad(shard, t, n)
    hit = _unpad(shard, hit, n)
    length = jnp.minimum(jnp.where(hit, t, max_depth), max_depth)  # [n]

    # froxel column per scattering pixel: (x·vx)//sx, (y·vy)//sy — the
    # reference's normalized nearest-texel map, as dense strided slices.
    vis_up = take_static(visibility, floor_map(sy, vy, offset=0.0), axis=1)
    vis_up = take_static(vis_up, floor_map(sx, vx, offset=0.0), axis=2)
    vis_flat = vis_up.reshape(vz, n, 3)

    n_steps = int(max_depth / vol.scattering_step_size)
    acc = jnp.zeros((n, 3), jnp.float32)
    for i in range(n_steps):
        f = np.float32(np.float32(i) * np.float32(vol.scattering_step_size))
        z = min(max(int(f / np.float32(vol.visibility_step_size)), 0),
                vz - 1)
        w = jnp.where(f < length,
                      jnp.exp(jnp.float32(-f * np.float32(TAU_SCATTERING))),
                      0.0)
        acc = acc + vis_flat[z] * w[..., None]
    l_acc = acc * vol.scattering_step_size
    out = jnp.concatenate([l_acc, length[..., None]], axis=-1)
    return out.reshape(sy, sx, 4)


def composite(vol: VolumetricsSettings, scattering, color, ray_len, width,
              height, max_dist):
    """Depth-aware fog composite (volumetrics.glsl:34-54): 3×3 neighborhood
    search keyed on |stored_len − pixel_len|, then L·exp(−len·τ) + fog_L.

    color/ray_len are flat pixel batches [H·W,3]/[H·W]; the scattering-map
    taps are static per-pixel indices (fixed by the two resolutions), so the
    3×3 search runs on nine dense clamp-shifted resamples of the scattering
    texture instead of 9·H·W scalar-unit gathers.
    """
    import numpy as np

    from madarch_tpu.core.resample import take_static

    sx, sy = vol.scattering_resolution

    def center_map(n_pix, n_tex):
        # same f32 arithmetic as the previous per-pixel formulation:
        # frag = (j+0.5)/n·2−1, tex = (frag+1)/2, i = round(tex·n_tex − 0.5)
        frag = ((np.arange(n_pix, dtype=np.float32) + np.float32(0.5))
                / np.float32(n_pix) * np.float32(2.0) - np.float32(1.0))
        tex = (frag + np.float32(1.0)) * np.float32(0.5)
        return np.round(tex * np.float32(n_tex)
                        - np.float32(0.5)).astype(np.int64)

    ix = center_map(width, sx)
    iy = center_map(height, sy)

    closest = jnp.full(ray_len.shape, max_dist, jnp.float32)
    fog = jnp.zeros_like(color)
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            # the ±1 neighborhood shift folds into the static per-pixel
            # index maps, clipped AFTER shifting — identical to the
            # original per-pixel clamp(i+d) at every resolution ratio
            # (including scattering maps finer than the screen)
            up = take_static(take_static(
                scattering, np.clip(iy + dy, 0, sy - 1), axis=0),
                np.clip(ix + dx, 0, sx - 1), axis=1)
            datum = up.reshape(-1, 4)                           # [H·W,4]
            dist = jnp.abs(datum[..., 3] - ray_len)
            better = dist < closest
            fog = jnp.where(better[..., None], datum[..., :3], fog)
            closest = jnp.minimum(closest, dist)
    return color * jnp.exp(-ray_len * TAU_SCATTERING)[..., None] + fog
