"""The frame pipeline: radiance → irradiance → [visibility → scattering] →
screen, with probe-atlas feedback across frames.

JAX counterpart of ``Madarch.Renderers.Render``
(/root/reference/madarch/madarch-renderers.adb:302-321).  Each GL render pass
becomes a jitted function producing an array; the textures become fields of
``FrameState`` threaded functionally through ``render_frame`` — the radiance
pass reads the *previous* frame's irradiance atlas (the GI feedback that
accumulates light bounces over frames), the irradiance pass integrates the
new radiance, and the screen pass consumes everything.
"""
from __future__ import annotations

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp

from madarch_tpu.core.config import (PROBE_SHADE_CONFIG,
                                     ProbeSettings, ShadeConfig,
                                     VolumetricsSettings,
                                     screen_shade_config)
from madarch_tpu.render import probes as probes_mod
from madarch_tpu.render import volumetrics as vol_mod
from madarch_tpu.render.camera import camera_rays, pixel_grid
from madarch_tpu.render.shading import pixel_color
from madarch_tpu.scene.scene import SceneData, SceneSpec


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class FrameState:
    """Per-frame feedback textures (the reference's framebuffer textures)."""

    radiance: jnp.ndarray     # f32[py·rr, px·rr, 3]
    irradiance: jnp.ndarray   # f32[py·ir, px·ir, 3]
    scattering: jnp.ndarray   # f32[sy, sx, 4]


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class Camera:
    position: jnp.ndarray     # f32[3]
    orientation: jnp.ndarray  # f32[3,3]


def initial_state(probes: ProbeSettings,
                  vol: VolumetricsSettings) -> FrameState:
    sy, sx = (vol.scattering_resolution[1], vol.scattering_resolution[0]) \
        if vol.enabled else (1, 1)
    return FrameState(
        radiance=jnp.zeros(probes.radiance_atlas_shape, jnp.float32),
        irradiance=jnp.zeros(probes.irradiance_atlas_shape, jnp.float32),
        scattering=jnp.zeros((sy, sx, 4), jnp.float32),
    )


def _unpad(shard, arr, n_true):
    """Strip the divisibility padding a RaySharder added (no-op for plain
    callables or unsharded runs)."""
    if shard is None or not hasattr(shard, "unpad"):
        return arr
    return shard.unpad(arr, n_true)


def radiance_pass(spec: SceneSpec, data: SceneData, probes: ProbeSettings,
                  cfg: ShadeConfig, irr_atlas, rad_atlas, shard=None):
    """Trace every probe's octahedral ray set and shade it
    (compute_probe_radiance.glsl:14-27): one batch of
    num_probes·radiance_resolution² rays."""
    rr = probes.radiance_resolution
    p_world = probes_mod.probe_world_positions(probes)       # [P,3]
    dirs = probes_mod.texel_directions(rr)                   # [rr²,3]
    n_probes = probes.num_probes

    # direction-major ray order: neighbouring rays share ONE texel
    # direction across probes instead of every direction of one probe, so
    # march lengths of neighbouring rays are coherent.  Exact: a
    # permutation, inverted below.  It pays off only for a march that
    # exits per block of rays; the batch-wide XLA march is indifferent.
    origins = jnp.tile(p_world, (rr * rr, 1))                # [rr²·P,3]
    ray_dirs = jnp.repeat(dirs, n_probes, axis=0)
    n_rays = origins.shape[0]
    if shard is not None and hasattr(shard, "map_rays"):
        color = shard.map_rays(
            lambda o, d, dat, irr, rad: pixel_color(
                spec, dat, probes, cfg, irr, rad, o, d)[0],
            (origins, ray_dirs), (data, irr_atlas, rad_atlas))
    else:
        if shard is not None:
            origins = shard(origins)
            ray_dirs = shard(ray_dirs)
        color, _, _ = pixel_color(spec, data, probes, cfg, irr_atlas,
                                  rad_atlas, origins, ray_dirs)
    color = _unpad(shard, color, n_rays)
    # invert the direction-major permutation back to probe-major tiles
    tiles = color.reshape(rr * rr, n_probes, 3).transpose(1, 0, 2)
    px, py = probes.probe_count
    if px * py != n_probes:
        pad = jnp.zeros((px * py - n_probes, rr * rr, 3), jnp.float32)
        tiles = jnp.concatenate([tiles, pad], axis=0)
    return probes_mod.tiles_to_atlas(probes, tiles, rr)


BLOCK_H = 32
BLOCK_W = 32


def _to_blocks(arr, height, width):
    """Scanline-flat [H·W, ...] -> 32×32-block-major flat order.

    Each run of 1024 consecutive rays then covers one compact screen square
    instead of 1.28 full scanlines.  Exact (a permutation, inverted by
    _from_blocks); it pays off only for a march that exits or culls per
    block of rays — the batch-wide XLA march is indifferent to it."""
    tail = arr.shape[1:]
    a = arr.reshape(height // BLOCK_H, BLOCK_H, width // BLOCK_W, BLOCK_W,
                    *tail)
    return a.transpose(0, 2, 1, 3, *range(4, a.ndim)).reshape(
        height * width, *tail)


def _from_blocks(arr, height, width):
    tail = arr.shape[1:]
    a = arr.reshape(height // BLOCK_H, width // BLOCK_W, BLOCK_H, BLOCK_W,
                    *tail)
    return a.transpose(0, 2, 1, 3, *range(4, a.ndim)).reshape(
        height * width, *tail)


def screen_pass(spec: SceneSpec, data: SceneData, probes: ProbeSettings,
                vol: VolumetricsSettings, cfg: ShadeConfig, width: int,
                height: int, camera: Camera, irr_atlas, rad_atlas,
                scattering, shard=None):
    """Primary rays -> shade -> volumetric composite -> Reinhard tonemap +
    gamma (draw_screen.glsl:20-29).  Returns f32[H, W, 3], row 0 = bottom."""
    frag = pixel_grid(width, height)                        # [H,W,2]
    origins, dirs = camera_rays(frag, camera.position, camera.orientation)
    origins_f = origins.reshape(-1, 3)
    dirs_f = dirs.reshape(-1, 3)
    n_rays = origins_f.shape[0]
    blocked = height % BLOCK_H == 0 and width % BLOCK_W == 0
    if blocked:
        origins_f = _to_blocks(origins_f, height, width)
        dirs_f = _to_blocks(dirs_f, height, width)
    if shard is not None and hasattr(shard, "map_rays"):
        def _shade(o, d, dat, irr, rad):
            c, _, hp = pixel_color(spec, dat, probes, cfg, irr, rad, o, d)
            return c, hp
        color, hit_pos = shard.map_rays(_shade, (origins_f, dirs_f),
                                        (data, irr_atlas, rad_atlas))
    else:
        if shard is not None:
            origins_f = shard(origins_f)
            dirs_f = shard(dirs_f)
        color, _, hit_pos = pixel_color(spec, data, probes, cfg, irr_atlas,
                                        rad_atlas, origins_f, dirs_f)
    color = _unpad(shard, color, n_rays)
    if blocked:
        color = _from_blocks(color, height, width)
    if cfg.render_volumetrics:
        hit_pos = _unpad(shard, hit_pos, n_rays)
        o_f = _unpad(shard, origins_f, n_rays)
        if blocked:
            hit_pos = _from_blocks(hit_pos, height, width)
            o_f = _from_blocks(o_f, height, width)
        ray_len = jnp.linalg.norm(hit_pos - o_f, axis=-1)
        color = vol_mod.composite(vol, scattering, color, ray_len,
                                  width, height, spec.max_dist)

    color = jnp.maximum(color, 0.0)
    # Reinhard + gamma; the 1e-8 keeps the pow's reverse-mode derivative
    # finite at pure black (value shift ~2e-4, invisible at 8 bits).
    color = ((color + 1e-8) / (color + 1.0)) ** 0.4545
    return color.reshape(height, width, 3)


def render_frame_impl(spec: SceneSpec, probes: ProbeSettings,
                      vol: VolumetricsSettings, width: int, height: int,
                      data: SceneData, camera: Camera, state: FrameState,
                      screen_cfg: ShadeConfig = None,
                      probe_cfg: ShadeConfig = PROBE_SHADE_CONFIG,
                      shard=None):
    """One full frame; returns (image f32[H,W,3], new FrameState).

    ``shard`` is an optional callable applied to the flat ray batches (a
    ``with_sharding_constraint`` closure) so SPMD callers can split rays
    across a device mesh while scene data and probe atlases stay replicated.
    """
    if screen_cfg is None:
        screen_cfg = screen_shade_config(vol.enabled)

    radiance = radiance_pass(spec, data, probes, probe_cfg,
                             state.irradiance, state.radiance, shard=shard)
    irradiance = probes_mod.integrate_irradiance(probes, radiance)

    scattering = state.scattering
    if vol.enabled:
        from madarch_tpu.render.context import SceneCtx
        sdf_b = SceneCtx(spec, data)
        visibility = vol_mod.visibility_pass(
            spec, data, vol, sdf_b, camera.position, camera.orientation,
            max_steps=screen_cfg.max_march_steps, shard=shard)
        scattering = vol_mod.scattering_pass(
            spec, data, vol, sdf_b, visibility, camera.position,
            camera.orientation, max_steps=screen_cfg.max_march_steps,
            shard=shard)

    image = screen_pass(spec, data, probes, vol, screen_cfg, width, height,
                        camera, irradiance, radiance, scattering,
                        shard=shard)
    return image, FrameState(radiance=radiance, irradiance=irradiance,
                             scattering=scattering)


render_frame = partial(jax.jit, static_argnames=(
    "spec", "probes", "vol", "width", "height", "screen_cfg",
    "probe_cfg"))(render_frame_impl)
