"""Per-ray shading: the reference's ``pixel_color_probes``
(/root/reference/madarch/glsl/render_probes.glsl:246-292) over ray batches.

Primary raycast -> primitive info -> direct PBR lighting + probe-sampled
indirect (diffuse always; specular per ShadeConfig mode) × ambient occlusion,
sky gradient on miss.  The volumetric composite is applied by the caller
(screen pass) since it needs the scattering texture.

Marches run on stop-gradient scene data.  With ``cfg.differentiable``
gradients re-enter through the implicit-function-theorem hit reattachment
and autodiff SDF-gradient normals, making the whole shade differentiable
w.r.t. primitive, material, light, and camera parameters.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from madarch_tpu.core.config import ProbeSettings, ShadeConfig
from madarch_tpu.core.vecmath import dot, length, reflect, vec3
from madarch_tpu.render import probes as probes_mod
from madarch_tpu.render.lighting import direct_lighting, indirect_lighting
from madarch_tpu.render.raymarch import (SURFACE_OFFSET, ambient_occlusion,
                                         attach_hit_gradient, raycast,
                                         raycast_visibility, scene_normal)
from madarch_tpu.scene.scene import (SceneData, SceneSpec, material_lookup,
                                     primitive_info, primitive_material_id,
                                     scene_sdf_info)


def sky_color(dirs):
    """Sky gradient on miss (render_probes.glsl:289)."""
    base = vec3(0.30, 0.36, 0.60)
    return base - 0.7 * dirs[..., 1:2]


def shade_hits(spec, data, probe_settings, cfg, sdf_b, irr_atlas, rad_atlas, pos, normal, dirs, hit):
    """Direct + indirect (+ specular) × AO for hit points; f32[N,3]."""
    data_sg = jax.tree.map(lax.stop_gradient, data)
    _, prim_index = jax.vmap(
        lambda p: scene_sdf_info(spec, data_sg, p))(pos)
    material_id = primitive_material_id(spec, data, prim_index)
    albedo, metallic, roughness = material_lookup(data, material_id)

    direct = direct_lighting(
        spec, data, sdf_b, pos, normal, dirs, albedo, metallic, roughness,
        compute_specular=cfg.direct_specular, enabled=hit,
        max_steps=cfg.max_march_steps)

    irradiance = probes_mod.sample_irradiance(
        probe_settings, sdf_b, irr_atlas, pos, normal, enabled=hit,
        max_steps=cfg.max_march_steps)

    specular_dir = reflect(dirs, normal)
    specular_col = jnp.zeros_like(pos)
    if cfg.indirect_specular_mode > 0:
        # roughness < 0.75 gate (render_probes.glsl:268)
        spec_enabled = hit & (roughness < 0.75)
        if cfg.indirect_specular_mode == 1:
            specular_col = sample_radiance_with_specular(
                spec, data, probe_settings, cfg, sdf_b, rad_atlas,
                pos, normal, specular_dir, roughness, enabled=spec_enabled)
        elif cfg.indirect_specular_mode == 2:
            specular_col = sample_radiance_no_specular(
                spec, data, probe_settings, cfg, sdf_b, rad_atlas,
                pos, normal, specular_dir, enabled=spec_enabled)
        else:
            specular_col = compute_indirect_specular(
                spec, data, probe_settings, cfg, sdf_b, irr_atlas,
                pos, normal, specular_dir, enabled=spec_enabled)
        specular_col = jnp.where(spec_enabled[..., None], specular_col, 0.0)

    indirect = indirect_lighting(
        irradiance, specular_col, -dirs, normal, specular_dir,
        albedo, metallic, roughness)

    ao = ambient_occlusion(sdf_b, pos, normal,
                           steps=cfg.ambient_occlusion_steps)
    return ao[..., None] * (direct + indirect)


def _reflection_geometry(spec, data, probe_settings, cfg, sdf_b, from_,
                         spec_dir, *, enabled):
    """Shared secondary-ray geometry for the specular modes: raycast +
    nearest-primitive info + probe visibility around the reflection hit.
    Returns (hit, spec_pos, spec_normal, spec_mid, vis f32[8,N]).
    """
    t, hit, spec_pos = raycast(sdf_b, from_, spec_dir, spec.max_dist,
                               enabled=enabled,
                               max_steps=cfg.max_march_steps)
    data_sg = jax.tree.map(lax.stop_gradient, data)
    _, prim_index = jax.vmap(
        lambda p: scene_sdf_info(spec, data_sg, p))(spec_pos)
    if cfg.differentiable:
        # per-ray primitive_info gathers f32 params by dynamic index,
        # whose transpose XLA serializes as a scatter-add while loop with
        # one update per ray.  The SDF-gradient normal is identical at the
        # winning primitive's surface and its transpose is dense; material
        # ids are an int gather (no grads).
        s_mid = primitive_material_id(spec, data, prim_index)
        sdfd = sdf_b.sdf_b_diff if hasattr(sdf_b, "sdf_b_diff") else sdf_b
        s_normal = scene_normal(sdfd, spec_pos)
    else:
        s_normal, s_mid = jax.vmap(
            lambda i, p: primitive_info(spec, data, i, p))(prim_index,
                                                           spec_pos)

    n_pts = from_.shape[0]
    spacing = jnp.asarray(probe_settings.grid_spacing, jnp.float32)
    dims = jnp.asarray(probe_settings.grid_dimensions, jnp.int32)
    grid_pos = jnp.floor(spec_pos / spacing).astype(jnp.int32)
    offsets = jnp.asarray(
        [[(i >> 0) & 1, (i >> 1) & 1, (i >> 2) & 1] for i in range(8)],
        jnp.int32)
    offseted = jnp.clip(grid_pos[None] + offsets[:, None], 0, dims - 1)
    probe_world = offseted.astype(jnp.float32) * spacing
    to_probe = probe_world - spec_pos[None]
    p_dist = jnp.maximum(length(to_probe), 1e-6)
    dir_to_probe = to_probe / p_dist[..., None]
    vis_enabled = jnp.broadcast_to((enabled & hit)[None], (8, n_pts))
    vis = raycast_visibility(
        sdf_b,
        jnp.broadcast_to(
            spec_pos[None] + s_normal[None] * SURFACE_OFFSET,
            (8, n_pts, 3)).reshape(-1, 3),
        dir_to_probe.reshape(-1, 3),
        (p_dist - SURFACE_OFFSET).reshape(-1),
        enabled=vis_enabled.reshape(-1),
        max_steps=cfg.max_march_steps).reshape(8, n_pts)
    return hit, spec_pos, s_normal, s_mid, vis


def sample_radiance_no_specular(spec, data, probe_settings, cfg, sdf_b,
                                rad_atlas, pos, normal, spec_dir, *, enabled):
    """Indirect specular mode 2 (render_probes.glsl:138-209): reflect-ray
    raycast, best-probe pick by backface+visibility weight, radiance lookup
    at mip 1, plus the direct specular highlight at the reflection point when
    add_indirect_specular (M_ADD_INDIRECT_SPECULAR) is set."""
    n_pts = pos.shape[0]
    settings = probe_settings
    spacing = jnp.asarray(settings.grid_spacing, jnp.float32)
    dims = jnp.asarray(settings.grid_dimensions, jnp.int32)

    from_ = pos + normal * SURFACE_OFFSET
    hit, spec_pos, spec_normal_v, spec_mid, vis = _reflection_geometry(
        spec, data, probe_settings, cfg, sdf_b, from_, spec_dir,
        enabled=enabled)

    grid_pos = jnp.floor(spec_pos / spacing).astype(jnp.int32)
    offsets = jnp.asarray(
        [[(i >> 0) & 1, (i >> 1) & 1, (i >> 2) & 1] for i in range(8)],
        jnp.int32)
    offseted = jnp.clip(grid_pos[None] + offsets[:, None], 0, dims - 1)
    probe_world = offseted.astype(jnp.float32) * spacing       # [8,N,3]
    probe_to_spec = spec_pos[None] - probe_world
    p_dist = jnp.maximum(length(probe_to_spec), 1e-6)
    probe_to_spec = probe_to_spec / p_dist[..., None]

    weight = dot(probe_to_spec, -spec_normal_v[None])          # [8,N]
    weight = weight * vis

    best = jnp.argmax(weight, axis=0)                          # [N]
    idx = (best, jnp.arange(n_pts))
    best_offseted = offseted[best, jnp.arange(n_pts)]          # [N,3]
    best_dir = probe_to_spec[idx]                              # [N,3]
    pid = probes_mod.grid_position_to_probe_id(settings, best_offseted)
    rad_ray_id = probes_mod.dir_to_ray_id(best_dir)
    mip1 = probes_mod.radiance_mip1(settings, rad_atlas)
    # best-probe lookup as an all-tiles contraction + one-hot select
    px_c, py_c = settings.probe_count
    vals_all = probes_mod.sample_all_tiles_bilinear(
        settings, mip1, rad_ray_id, settings.radiance_resolution // 2)
    radiance = probes_mod.probe_one_hot_combine(
        px_c * py_c, pid[None], jnp.ones((1, n_pts), jnp.float32), vals_all)

    if cfg.add_indirect_specular:
        _, spec_metallic, spec_roughness = material_lookup(data, spec_mid)
        highlight = direct_lighting(
            spec, data, sdf_b, spec_pos, spec_normal_v, spec_dir,
            jnp.zeros((n_pts, 3), jnp.float32), spec_metallic,
            spec_roughness, compute_specular=cfg.direct_specular,
            enabled=enabled & hit, max_steps=cfg.max_march_steps)
        radiance = radiance + highlight

    return jnp.where(hit[..., None], radiance, 0.0)


def sample_radiance_with_specular(spec, data, probe_settings, cfg, sdf_b,
                                  rad_atlas, pos, normal, spec_dir,
                                  roughness, *, enabled):
    """Indirect specular mode 1 (render_probes.glsl:71-136): glossy probe
    lookup — reflection raycast, 8-probe soft-shadow-weighted trilinear
    radiance sample at a roughness-driven mip LOD."""
    import math

    n_pts = pos.shape[0]
    settings = probe_settings
    spacing = jnp.asarray(settings.grid_spacing, jnp.float32)
    dims = jnp.asarray(settings.grid_dimensions, jnp.int32)
    rr = settings.radiance_resolution
    radiance_lods = int(math.log2(rr))

    from_ = pos + normal * SURFACE_OFFSET
    t, hit, spec_pos = raycast(sdf_b, from_, spec_dir, spec.max_dist,
                               enabled=enabled,
                               max_steps=cfg.max_march_steps)
    pos_to_spec = spec_pos - pos

    grid_pos = jnp.floor(pos / spacing).astype(jnp.int32)
    alpha = pos / spacing - grid_pos.astype(jnp.float32)
    offsets = jnp.asarray(
        [[(i >> 0) & 1, (i >> 1) & 1, (i >> 2) & 1] for i in range(8)],
        jnp.int32)
    offseted = jnp.clip(grid_pos[None] + offsets[:, None], 0, dims - 1)
    probe_world = offseted.astype(jnp.float32) * spacing
    probe_to_spec = (pos[None] - probe_world) + pos_to_spec[None]
    p_dist = jnp.maximum(length(probe_to_spec), 1e-6)
    probe_to_spec = probe_to_spec / p_dist[..., None]

    # visibility by penumbra march back toward the probe (k = 0.5)
    from madarch_tpu.render.raymarch import softshadows
    vis_enabled = jnp.broadcast_to((enabled & hit)[None], (8, n_pts))
    w = softshadows(
        sdf_b,
        jnp.broadcast_to(spec_pos[None], (8, n_pts, 3)).reshape(-1, 3),
        (-probe_to_spec).reshape(-1, 3),
        jnp.full((8 * n_pts,), SURFACE_OFFSET, jnp.float32),
        (p_dist - SURFACE_OFFSET).reshape(-1),
        0.5,
        enabled=vis_enabled.reshape(-1),
        max_steps=cfg.max_march_steps).reshape(8, n_pts)
    weight = jnp.maximum(w, 0.001)
    tri = (1.0 - alpha[None]) * (1 - offsets[:, None]) \
        + alpha[None] * offsets[:, None]
    weight = weight * tri[..., 0] * tri[..., 1] * tri[..., 2]

    lod = radiance_lods * jnp.clip(roughness * 2.0, 0.0, 1.0)   # [N]
    pid = probes_mod.grid_position_to_probe_id(settings, offseted)
    tx, ty = probes_mod.probe_id_to_tile(settings, pid)
    rad_ray_id = probes_mod.dir_to_ray_id(probe_to_spec)         # [8,N,2]
    mips = probes_mod.radiance_mips(settings, rad_atlas, radiance_lods)
    vals = probes_mod.sample_tile_lod(
        settings, mips, tx.reshape(-1), ty.reshape(-1),
        rad_ray_id.reshape(-1, 2),
        jnp.broadcast_to(lod[None], (8, n_pts)).reshape(-1))
    vals = vals.reshape(8, n_pts, 3)

    total_w = jnp.maximum(jnp.sum(weight, axis=0), 1e-9)
    radiance = jnp.sum(vals * weight[..., None], axis=0) / total_w[..., None]
    return jnp.where(hit[..., None], radiance, 0.0)


def compute_indirect_specular(spec, data, probe_settings, cfg, sdf_b,
                              irr_atlas, pos, normal, spec_dir, *, enabled):
    """Indirect specular mode 3 (render_probes.glsl:211-244): mirror — a
    full secondary shade (direct + irradiance-lit indirect) at the
    reflection hit; sky gradient on miss."""
    from_ = pos + normal * SURFACE_OFFSET
    hit, spec_pos, s_normal, s_mid, vis = _reflection_geometry(
        spec, data, probe_settings, cfg, sdf_b, from_, spec_dir,
        enabled=enabled)
    s_albedo, s_metallic, s_roughness = material_lookup(data, s_mid)

    direct = direct_lighting(
        spec, data, sdf_b, spec_pos, s_normal, spec_dir, s_albedo,
        s_metallic, s_roughness, compute_specular=cfg.direct_specular,
        enabled=enabled & hit, max_steps=cfg.max_march_steps)
    irradiance = probes_mod.sample_irradiance(
        probe_settings, sdf_b, irr_atlas, spec_pos, s_normal,
        enabled=enabled & hit, max_steps=cfg.max_march_steps, vis=vis)
    sec_spec_dir = reflect(spec_dir, s_normal)
    indirect = indirect_lighting(
        irradiance, jnp.zeros_like(spec_pos), -spec_dir, s_normal,
        sec_spec_dir, s_albedo, s_metallic, s_roughness)
    return jnp.where(hit[..., None], indirect + direct, sky_color(spec_dir))


def pixel_color(spec: SceneSpec, data: SceneData,
                probe_settings: ProbeSettings, cfg: ShadeConfig,
                irr_atlas, rad_atlas, origins, dirs):
    """pixel_color_probes minus the volumetric composite: shade a ray batch.

    Returns (color f32[N,3], hit bool[N], hit_pos f32[N,3]).  hit_pos on a
    miss is the max_dist point along the ray (used by the fog composite; the
    reference leaves it undefined there — GLSL UB we replace with the
    sensible choice).
    """
    from madarch_tpu.render.context import SceneCtx
    ctx = SceneCtx(spec, data)
    sdf_b_diff = ctx.sdf_b_diff

    t, hit, _ = raycast(ctx, origins, dirs, spec.max_dist,
                        max_steps=cfg.max_march_steps)
    if cfg.differentiable:
        t = attach_hit_gradient(sdf_b_diff, origins, dirs, t)
    pos = origins + t[:, None] * dirs
    normal = scene_normal(sdf_b_diff, pos)

    lit = shade_hits(spec, data, probe_settings, cfg, ctx, irr_atlas,
                     rad_atlas, pos, normal, dirs, hit)
    sky = sky_color(dirs)
    color = jnp.where(hit[..., None], lit, sky)

    miss_pos = origins + spec.max_dist * dirs
    hit_pos = jnp.where(hit[..., None], pos, miss_pos)
    return color, hit, hit_pos
