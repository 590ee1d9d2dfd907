"""DDGI irradiance probes: octahedral atlases, sampling, integration.

JAX counterpart of the reference's probe subsystem
(/root/reference/madarch/glsl/probe_utils.glsl, render_probes.glsl,
update_probe_irradiance.glsl).  The probe atlases are plain f32[H, W, 3]
arrays; octahedral texel directions are precomputed constants; the per-frame
irradiance re-integration (update_probe_irradiance.glsl:17-42 — a full
cosine-weighted sum over each probe's radiance texels) becomes a single
constant-weight matmul over all probes.

Texture-sampling semantics: the reference reads its atlases through GL
bilinear samplers with half-texel clamps that keep lookups inside one probe
tile; here sampling is explicit bilinear within the tile with the same
half-texel clamp.  (Deviation noted: the irradiance-update pass in GL samples
at texel corners; we integrate at texel centers — same estimator, cleaner.)
"""
from __future__ import annotations

from functools import lru_cache

import jax.numpy as jnp
import numpy as np
from jax import lax

from madarch_tpu.core.config import ProbeSettings
from madarch_tpu.core.vecmath import dot, length, mix, sign_not_zero
from madarch_tpu.render.raymarch import SURFACE_OFFSET, raycast_visibility

# Precision of every atlas contraction: full f32 on every backend, so
# renders on any device stay comparable with the CPU goldens.  Whether a
# cheaper precision (TF32, bf16) holds the golden gates is a measurement
# still to make (PERF.md).
ATLAS_PRECISION = lax.Precision.HIGHEST


# ---------------------------------------------------------------------------
# Octahedral mapping (probe_utils.glsl:64-93)
# ---------------------------------------------------------------------------

def dir_to_oct(v):
    """Unit vec3 -> octahedral coords in [-1, 1]² (float32x3_to_oct).

    The max() guards the zero vectors that masked-out lanes carry (miss
    pixels have a zero normal) — without it the backward pass turns the
    masked NaN into a real one.
    """
    denom = jnp.maximum(
        jnp.abs(v[..., 0]) + jnp.abs(v[..., 1]) + jnp.abs(v[..., 2]), 1e-12)
    p = v[..., :2] / denom[..., None]
    folded = (1.0 - jnp.abs(p[..., ::-1])) * sign_not_zero(p)
    return jnp.where((v[..., 2] <= 0.0)[..., None], folded, p)


def oct_to_dir(e):
    """Octahedral coords in [-1, 1]² -> unit vec3 (oct_to_float32x3)."""
    z = 1.0 - jnp.abs(e[..., 0]) - jnp.abs(e[..., 1])
    xy = jnp.where((z < 0.0)[..., None],
                   (1.0 - jnp.abs(e[..., ::-1])) * sign_not_zero(e),
                   e)
    v = jnp.concatenate([xy, z[..., None]], axis=-1)
    return v / jnp.maximum(jnp.linalg.norm(v, axis=-1, keepdims=True),
                           1e-12)


def dir_to_ray_id(v):
    """Unit direction -> tile-local coords in [0, 1]² (ray_dir_to_ray_id)."""
    return (dir_to_oct(v) + 1.0) * 0.5


def ray_id_to_dir(ray_id):
    return oct_to_dir(ray_id * 2.0 - 1.0)


# ---------------------------------------------------------------------------
# Probe grid / atlas addressing (probe_utils.glsl:19-56)
# ---------------------------------------------------------------------------

def grid_position_to_probe_id(settings: ProbeSettings, grid_pos):
    gx, gy, _ = settings.grid_dimensions
    return (grid_pos[..., 2] * gx * gy + grid_pos[..., 1] * gx
            + grid_pos[..., 0])


def probe_id_to_grid_position(settings: ProbeSettings, pid):
    gx, gy, _ = settings.grid_dimensions
    z = pid // (gx * gy)
    y = (pid - z * gx * gy) // gx
    x = pid - z * gx * gy - y * gx
    return jnp.stack([x, y, z], axis=-1)


def probe_id_to_tile(settings: ProbeSettings, pid):
    """probe id -> (tile_x, tile_y) in the atlas (probe_id_to_coord)."""
    px, _ = settings.probe_count
    ty = pid // px
    tx = pid - ty * px
    return tx, ty


def probe_world_positions(settings: ProbeSettings):
    """f32[num_probes, 3] world positions of all probes."""
    pid = jnp.arange(settings.num_probes)
    gp = probe_id_to_grid_position(settings, pid)
    spacing = jnp.asarray(settings.grid_spacing, jnp.float32)
    return gp.astype(jnp.float32) * spacing


@lru_cache(maxsize=None)
def _texel_dirs(res: int):
    """Octahedral direction of each texel center of a res×res tile, as a
    numpy constant f32[res*res, 3] in row-major (y, x) order."""
    ys, xs = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    ray_id = np.stack([(xs + 0.5) / res, (ys + 0.5) / res],
                      axis=-1).reshape(-1, 2).astype(np.float32)
    e = ray_id * 2.0 - 1.0
    z = 1.0 - np.abs(e[:, 0]) - np.abs(e[:, 1])
    xy = np.where((z < 0.0)[:, None],
                  (1.0 - np.abs(e[:, ::-1])) * np.where(e >= 0, 1.0, -1.0),
                  e)
    v = np.concatenate([xy, z[:, None]], axis=-1)
    return (v / np.linalg.norm(v, axis=-1, keepdims=True)).astype(np.float32)


def texel_directions(res: int):
    return jnp.asarray(_texel_dirs(res))


@lru_cache(maxsize=None)
def _cosine_weights(irr_res: int, rad_res: int):
    """W[irr_res², rad_res²] with W[i,j] = max(dot(irr_dir_i, rad_dir_j), 0),
    the integration weights of update_probe_irradiance.glsl:17-42."""
    irr_dirs = _texel_dirs(irr_res)
    rad_dirs = _texel_dirs(rad_res)
    w = np.maximum(irr_dirs @ rad_dirs.T, 0.0).astype(np.float32)
    return w, w.sum(axis=1, keepdims=True)


# ---------------------------------------------------------------------------
# Atlas access
# ---------------------------------------------------------------------------

def atlas_to_tiles(settings: ProbeSettings, atlas, res: int):
    """[py·res, px·res, 3] -> [px·py, res·res, 3] (tile row-major)."""
    px, py = settings.probe_count
    t = atlas.reshape(py, res, px, res, 3)
    return t.transpose(0, 2, 1, 3, 4).reshape(px * py, res * res, 3)


def tiles_to_atlas(settings: ProbeSettings, tiles, res: int):
    px, py = settings.probe_count
    t = tiles.reshape(py, px, res, res, 3).transpose(0, 2, 1, 3, 4)
    return t.reshape(py * res, px * res, 3)


def sample_tile_bilinear(atlas, tile_x, tile_y, ray_id, res: int):
    """Bilinear lookup inside one probe tile, clamped half a texel from the
    tile border (the irr_min/max_coord clamps of probe_utils.glsl:11-16).

    atlas: f32[H, W, 3]; tile_x/tile_y/ray_id batched [N]/[N]/[N,2].
    """
    rid = jnp.clip(ray_id, 0.5 / res, 1.0 - 0.5 / res)
    fx = rid[..., 0] * res - 0.5
    fy = rid[..., 1] * res - 0.5
    x0 = jnp.floor(fx).astype(jnp.int32)
    y0 = jnp.floor(fy).astype(jnp.int32)
    x0 = jnp.clip(x0, 0, res - 1)
    y0 = jnp.clip(y0, 0, res - 1)
    x1 = jnp.minimum(x0 + 1, res - 1)
    y1 = jnp.minimum(y0 + 1, res - 1)
    wx = (fx - x0)[..., None]
    wy = (fy - y0)[..., None]

    bx = tile_x * res
    by = tile_y * res

    def tex(yy, xx):
        return atlas[by + yy, bx + xx]

    top = tex(y0, x0) * (1 - wx) + tex(y0, x1) * wx
    bot = tex(y1, x0) * (1 - wx) + tex(y1, x1) * wx
    return top * (1 - wy) + bot * wy


def radiance_mips(settings: ProbeSettings, atlas, levels: int):
    """Mip pyramid of the radiance atlas (2×2 box per level) — the GL
    textureLod source for sample_radiance_with_specular
    (render_probes.glsl:105-135).  Levels stay tile-aligned while the tile
    resolution divides by 2."""
    mips = [atlas]
    cur = atlas
    for _ in range(levels):
        h, w, _ = cur.shape
        if h % 2 or w % 2:
            break
        cur = cur.reshape(h // 2, 2, w // 2, 2, 3).mean(axis=(1, 3))
        mips.append(cur)
    return mips


def sample_tile_lod(settings: ProbeSettings, mips, tile_x, tile_y, ray_id,
                    lod):
    """Fractional-LOD bilinear sample inside one probe tile (textureLod):
    lerp between the two adjacent mip levels."""
    n_levels = len(mips)
    lod = jnp.clip(lod, 0.0, n_levels - 1.0)
    lo = jnp.floor(lod).astype(jnp.int32)
    frac = lod - lo.astype(jnp.float32)

    base_res = settings.radiance_resolution
    out_lo = jnp.zeros(ray_id.shape[:-1] + (3,), jnp.float32)
    out_hi = jnp.zeros(ray_id.shape[:-1] + (3,), jnp.float32)
    for lvl in range(n_levels):
        res = base_res >> lvl
        v = sample_tile_bilinear(mips[lvl], tile_x, tile_y, ray_id, res)
        out_lo = jnp.where((lo == lvl)[..., None], v, out_lo)
        hi_lvl = min(lvl + 1, n_levels - 1)
        v_hi = sample_tile_bilinear(mips[hi_lvl], tile_x, tile_y, ray_id,
                                    base_res >> hi_lvl)
        out_hi = jnp.where((lo == lvl)[..., None], v_hi, out_hi)
    return out_lo * (1.0 - frac[..., None]) + out_hi * frac[..., None]


def radiance_mip1(settings: ProbeSettings, atlas):
    """2×2 box-downsample of the radiance atlas — GL mip level 1, used by
    sample_radiance_no_specular's textureLod(..., 1.0)
    (render_probes.glsl:280)."""
    h, w, _ = atlas.shape
    return atlas.reshape(h // 2, 2, w // 2, 2, 3).mean(axis=(1, 3))


# ---------------------------------------------------------------------------
# Matmul atlas sampling: texture gathers as one-hot contractions.
#
# A frame samples the probe atlases tens of millions of times.  Bilinear
# lookup inside a res×res tile is a dot product of a [res²] weight vector
# (4 nonzeros) with the tile's texels, so a batch of N lookups against ALL P
# tiles at once is one [N, res²] × [res², P·3] matmul — dense, no gathers
# anywhere.  Per-probe selection afterwards is a compare-weighted reduction
# over the (small) probe axis.  Whether a direct bilinear gather is cheaper
# on the GPU is an open measurement (PERF.md).
# ---------------------------------------------------------------------------

def bilinear_tile_weight_factors(ray_id, res: int):
    """Per-axis bilinear weights (Wy [N, res], Wx [N, res]) of a tile-local
    lookup at ``ray_id`` [N, 2], matching sample_tile_bilinear's half-texel
    clamp.  The full weight matrix is the outer product Wy ⊗ Wx."""
    rid = jnp.clip(ray_id, 0.5 / res, 1.0 - 0.5 / res)

    def axis_w(f):
        i0 = jnp.clip(jnp.floor(f).astype(jnp.int32), 0, res - 1)
        i1 = jnp.minimum(i0 + 1, res - 1)
        w1 = (f - i0)[..., None]
        lanes = jnp.arange(res)
        return (jnp.where(lanes == i0[..., None], 1.0 - w1, 0.0)
                + jnp.where(lanes == i1[..., None], w1, 0.0))

    wx = axis_w(rid[..., 0] * res - 0.5)
    wy = axis_w(rid[..., 1] * res - 0.5)
    return wy, wx


def sample_all_tiles_bilinear(settings: ProbeSettings, atlas, ray_id,
                              res: int):
    """Bilinear sample of EVERY probe tile at each query: f32[N, P, 3].

    One [N, res²] × [res², P·3] matmul replaces N·P·4 gathers; callers then
    combine over the probe axis with their own per-probe weights.
    """
    px, py = settings.probe_count
    n_tiles = px * py
    tiles = atlas_to_tiles(settings, atlas, res)        # [P, res², 3]
    flat = tiles.transpose(1, 0, 2).reshape(res * res, n_tiles * 3)
    wy, wx = bilinear_tile_weight_factors(ray_id, res)  # [N,res] each
    w = (wy[..., :, None] * wx[..., None, :]).reshape(
        ray_id.shape[:-1] + (res * res,))
    vals = jnp.dot(w, flat, precision=ATLAS_PRECISION,
                   preferred_element_type=jnp.float32)
    return vals.reshape(ray_id.shape[:-1] + (n_tiles, 3))


def probe_one_hot_combine(n_tiles: int, pids, weights, vals):
    """Σ_k weights[k]·vals[:, pids[k]] without gathers: pids [K, N] int,
    weights [K, N], vals [N, P, 3] -> f32[N, 3].

    Builds the [N, P] scatter of per-corner weights with P·K compares (the
    one-hot trick) and contracts over the probe axis.
    """
    w_all = jnp.zeros(vals.shape[:-1], vals.dtype)      # [N, P]
    probe_ids = jnp.arange(n_tiles)
    for k in range(pids.shape[0]):
        w_all = w_all + jnp.where(probe_ids == pids[k][..., None],
                                  weights[k][..., None], 0.0)
    return jnp.einsum("np,npc->nc", w_all, vals, precision=ATLAS_PRECISION,
                      preferred_element_type=jnp.float32)


# ---------------------------------------------------------------------------
# Irradiance integration pass (update_probe_irradiance.glsl)
# ---------------------------------------------------------------------------

def integrate_irradiance(settings: ProbeSettings, radiance_atlas):
    """Cosine-weighted re-integration of every probe's radiance into its
    irradiance tile — one matmul over all probes."""
    rr = settings.radiance_resolution
    ir = settings.irradiance_resolution
    w_np, wsum_np = _cosine_weights(ir, rr)
    w = jnp.asarray(w_np)
    wsum = jnp.asarray(wsum_np)
    rad = atlas_to_tiles(settings, radiance_atlas, rr)      # [P, rr², 3]
    irr = jnp.einsum("ij,pjc->pic", w, rad, precision=ATLAS_PRECISION,
                     preferred_element_type=jnp.float32) / wsum
    return tiles_to_atlas(settings, irr, ir)


# ---------------------------------------------------------------------------
# Irradiance sampling (render_probes.glsl:6-69)
# ---------------------------------------------------------------------------

def sample_irradiance(settings: ProbeSettings, sdf_b, irr_atlas, pos, normal,
                      *, enabled=None, max_steps=300, method="matmul",
                      vis=None):
    """8-corner trilinear, backface- and visibility-weighted probe lookup.

    pos/normal: f32[N,3].  Runs the 8·N visibility raycasts as one batched
    march, unless the caller already marched them (``vis`` f32[8,N], as the
    mode-3 reflection geometry does).  Returns f32[N,3] irradiance
    (sqrt-encode blend then square, as in the reference).  ``method``:
    'matmul' contracts against all tiles at once (the render path);
    'gather' is the reference-shaped texture fetch kept for parity tests.
    """
    n_pts = pos.shape[0]
    spacing = jnp.asarray(settings.grid_spacing, jnp.float32)
    dims = jnp.asarray(settings.grid_dimensions, jnp.int32)
    ir = settings.irradiance_resolution

    grid_pos = jnp.floor(pos / spacing).astype(jnp.int32)       # [N,3]
    alpha = pos / spacing - grid_pos.astype(jnp.float32)        # [N,3]

    offsets = jnp.asarray(
        [[(i >> 0) & 1, (i >> 1) & 1, (i >> 2) & 1] for i in range(8)],
        jnp.int32)                                              # [8,3]

    offseted = jnp.clip(grid_pos[None] + offsets[:, None],
                        0, dims - 1)                            # [8,N,3]
    probe_world = offseted.astype(jnp.float32) * spacing
    hit_to_probe = probe_world - pos[None]                      # [8,N,3]
    # length(): a shade point can sit exactly on a probe (a probe inside
    # geometry hits at t = 0), where the plain norm's gradient is 0/0
    probe_dist = jnp.maximum(length(hit_to_probe), 1e-6)
    dir_to_probe = hit_to_probe / probe_dist[..., None]

    # backface weight: ((dot+1)/2)² + 0.2
    angle = (dot(dir_to_probe, normal[None]) + 1.0) * 0.5
    weight = angle * angle + 0.2

    # batched visibility march for all 8 corners
    if vis is None:
        origins = jnp.broadcast_to(pos[None] + normal[None] * SURFACE_OFFSET,
                                   (8, n_pts, 3)).reshape(-1, 3)
        vis_dirs = dir_to_probe.reshape(-1, 3)
        vis_max = (probe_dist - SURFACE_OFFSET).reshape(-1)
        vis_enabled = None
        if enabled is not None:
            vis_enabled = jnp.broadcast_to(enabled[None],
                                           (8, n_pts)).reshape(-1)
        vis = raycast_visibility(sdf_b, origins, vis_dirs, vis_max,
                                 enabled=vis_enabled,
                                 max_steps=max_steps).reshape(8, n_pts)
    weight = weight * vis

    # crush tiny weights below 0.2: w -> w³ / 0.04
    crush = 0.2
    weight = jnp.where(weight < crush,
                       weight * weight * weight / (crush * crush), weight)

    # trilinear
    tri = mix(1.0 - alpha[None], alpha[None], offsets[:, None].astype(
        jnp.float32))                                           # [8,N,3]
    weight = weight * tri[..., 0] * tri[..., 1] * tri[..., 2]

    # atlas lookup
    pid = grid_position_to_probe_id(settings, offseted)         # [8,N]
    irr_ray_id = dir_to_ray_id(normal)                          # [N,2]
    total_w = jnp.maximum(jnp.sum(weight, axis=0), 1e-9)
    # 1e-12 floor: sqrt' is infinite at 0 and the atlas starts all-zero
    if method == "matmul":
        px, py = settings.probe_count
        vals_all = sample_all_tiles_bilinear(settings, irr_atlas,
                                             irr_ray_id, ir)    # [N,P,3]
        vals_all = jnp.sqrt(jnp.maximum(vals_all, 1e-12))
        irr = probe_one_hot_combine(px * py, pid, weight, vals_all) \
            / total_w[..., None]
    else:
        tx, ty = probe_id_to_tile(settings, pid)
        irr_ray_id8 = jnp.broadcast_to(irr_ray_id[None], (8, n_pts, 2))
        vals = sample_tile_bilinear(irr_atlas, tx.reshape(-1),
                                    ty.reshape(-1),
                                    irr_ray_id8.reshape(-1, 2), ir)
        vals = jnp.sqrt(jnp.maximum(vals, 1e-12)).reshape(8, n_pts, 3)
        irr = jnp.sum(vals * weight[..., None], axis=0) / total_w[..., None]
    return irr * irr
