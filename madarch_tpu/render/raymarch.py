"""Batched sphere-tracing loops: raycast, soft shadows, ambient occlusion.

JAX counterpart of the reference's hot device loops
(/root/reference/madarch/glsl/raymarching.glsl:1-57 and
lighting.glsl:51-69).  The per-fragment divergent ``for`` loops become one
``lax.while_loop`` over the whole ray batch with an active-lane mask: every
lane steps until the slowest ray of the batch converges.  Masked lanes stop
advancing (their ``t`` freezes), so extra iterations cost compute but never
correctness.

Differentiability: ``lax.while_loop`` is not reverse-mode differentiable, so
the march itself runs on stop-gradient scene data and the hit distance is
re-attached through the implicit function theorem (``attach_hit_gradient``):
for f(o + t·d, θ) = 0,  dt/dθ = -(∂f/∂θ) / (d·∇f).  This replaces the
reference's discrete hit event with an exactly-valued, correctly-differentiable
hit, the analogue of its symbolic derivative layer
(madarch-exprs-derivatives.adb:20-47) done right for end-to-end autodiff.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from madarch_tpu.core.vecmath import EPSILON

# Reference loop bounds (raymarching.glsl:1-2).
MAX_STEPS = 300
MIN_STEP_SIZE = 0.05
# Over-relaxation factor for raycast/visibility marches (Keinert et al.,
# "Enhanced Sphere Tracing"): step ω·d and back up when consecutive bounding
# spheres stop overlapping (|d|+prev < step ⇒ geometry may have been
# skipped), then fall back to ω=1 for that lane.  Hit positions remain
# within eps of the surface — the backtrack makes the march exact, it only
# reduces the step count (~1.5× fewer scene evals on open scenes).  A lane
# whose relaxed step lands past its budget is retired only at the next
# evaluation, once the step is verified (or backed up): an unverified
# overshoot may have skipped a surface in front of the budget.  The
# reference marches with ω=1 (raymarching.glsl:25-37); set omega=1.0 to
# reproduce its hits.
RELAXATION = 1.6
# Offset of secondary-ray origins off the surface (lighting.glsl:32,
# render_probes.glsl: `min_step_size * 5`).
SURFACE_OFFSET = MIN_STEP_SIZE * 5.0


def _as_closure(sdf):
    """March entry points take either a batched-SDF callable or a SceneCtx
    (render/context.py); return the batched closure."""
    return sdf if callable(sdf) else sdf.sdf_b


def raycast(sdf, origins, dirs, max_dist, *, eps=EPSILON,
            max_steps=MAX_STEPS, enabled=None, omega=RELAXATION):
    """Sphere-trace a batch of rays (raymarching.glsl:25-51).

    Args:
      sdf_b: batched scene distance, f32[N,3] -> f32[N].  Must already be
        closed over stop-gradient scene data (see attach_hit_gradient).
      origins, dirs: f32[N,3]; dirs unit length.
      max_dist: scalar march budget.
      enabled: optional bool[N]; disabled lanes never march (used to skip
        work the reference guards with dynamic ``if``s).

    Returns (t: f32[N] march distance, hit: bool[N], pos: f32[N,3]).
    """
    # Marches are non-differentiable estimators (lax.while_loop has no
    # reverse rule); gradients re-enter through attach_hit_gradient.
    origins = lax.stop_gradient(origins)
    dirs = lax.stop_gradient(dirs)
    sdf_b = _as_closure(sdf)
    # carries derive arithmetically from the ray arrays (not literal
    # zeros/ones) so their varying-axis type matches the body outputs when
    # the march runs per-device inside shard_map (parallel/spmd.py)
    t0 = origins[:, 0] * 0.0
    active0 = (t0 < 1.0) if enabled is None else enabled

    def cond(state):
        step, _, active = state[:3]
        return (step < max_steps) & jnp.any(active)

    def body(state):
        step, t, active, prev_r, step_len, om, found = state
        p = origins + t[:, None] * dirs
        d = sdf_b(p)
        fail = (om > 1.0) & (jnp.abs(d) + prev_r <= step_len)
        beyond = ~fail & (t >= max_dist)  # verified past the budget: miss
        hit = ~fail & ~beyond & (d < eps)
        found = found | (active & hit)
        new_step = jnp.where(fail, step_len * (1.0 - omega), d * om)
        om = jnp.where(fail, 1.0, om)
        still = active & ~hit & ~beyond
        t = jnp.where(still, t + new_step, t)
        prev_r = jnp.where(still, jnp.abs(d), prev_r)
        step_len = jnp.where(still, new_step, step_len)
        return step + 1, t, still, prev_r, step_len, om, found

    _, t, _, _, _, _, found = lax.while_loop(
        cond, body,
        (jnp.int32(0), t0, active0, t0, t0, t0 + omega, t0 > 1.0))
    pos = origins + t[:, None] * dirs
    # a lane is a hit where the loop stopped it on the surface; lanes that
    # ran out of steps count if they already sit within eps
    hit = found | ((sdf_b(pos) < eps) & (t < max_dist))
    if enabled is not None:
        hit = hit & enabled
    return t, hit, pos


def raycast_visibility(sdf, origins, dirs, max_dists, *, eps=EPSILON,
                       max_steps=MAX_STEPS, enabled=None, omega=RELAXATION):
    """1.0 if the ray reaches max_dist unobstructed, else 0.0
    (raymarching.glsl:39-56).  max_dists is per-ray f32[N].  Marches with
    the same exact over-relaxation as ``raycast``."""
    origins = lax.stop_gradient(origins)
    dirs = lax.stop_gradient(dirs)
    max_dists = lax.stop_gradient(max_dists)
    sdf_b = _as_closure(sdf)
    t0 = origins[:, 0] * 0.0  # varying-typed zeros (see raycast)
    active0 = (t0 < 1.0) if enabled is None else enabled
    active0 = active0 & (t0 < max_dists)

    def cond(state):
        step, _, active = state[:3]
        return (step < max_steps) & jnp.any(active)

    def body(state):
        step, t, active, blocked, prev_r, step_len, om = state
        p = origins + t[:, None] * dirs
        d = sdf_b(p)
        fail = (om > 1.0) & (jnp.abs(d) + prev_r <= step_len)
        beyond = ~fail & (t >= max_dists)  # verified past the budget
        hit = ~fail & ~beyond & (d < eps)
        blocked = blocked | (active & hit)
        new_step = jnp.where(fail, step_len * (1.0 - omega), d * om)
        om = jnp.where(fail, 1.0, om)
        still = active & ~hit & ~beyond
        t = jnp.where(still, t + new_step, t)
        prev_r = jnp.where(still, jnp.abs(d), prev_r)
        step_len = jnp.where(still, new_step, step_len)
        return step + 1, t, still, blocked, prev_r, step_len, om

    _, _, _, blocked, _, _, _ = lax.while_loop(
        cond, body,
        (jnp.int32(0), t0, active0, t0 > 1.0, t0, t0, t0 + omega))
    return jnp.where(blocked, 0.0, 1.0)


def softshadows(sdf, origins, dirs, min_dists, max_dists, k, *,
                eps=EPSILON, max_steps=MAX_STEPS, enabled=None):
    """Cone-approximation penumbra march (raymarching.glsl:4-23).

    Implements the improved-penumbra trick: y = d²/(2·prev),
    shadow = min(shadow, k·sqrt(d²−y²)/max(0, t−y)).  Returns f32[N] in
    [0, 1]; 0 where the shadow ray hits geometry.
    """
    origins = lax.stop_gradient(origins)
    dirs = lax.stop_gradient(dirs)
    min_dists = lax.stop_gradient(min_dists)
    max_dists = lax.stop_gradient(max_dists)
    sdf_b = _as_closure(sdf)
    n = origins.shape[0]
    zeros = origins[:, 0] * 0.0  # varying-typed (see raycast)
    t0 = jnp.broadcast_to(min_dists, (n,)).astype(jnp.float32) + zeros
    res0 = zeros + 1.0
    prev0 = zeros + 1e20
    active0 = (zeros < 1.0) if enabled is None else enabled
    active0 = active0 & (t0 < max_dists)

    def cond(state):
        step = state[0]
        active = state[4]
        return (step < max_steps) & jnp.any(active)

    def body(state):
        step, t, res, prev, active, blocked = state
        p = origins + t[:, None] * dirs
        d = sdf_b(p)
        hit = d < eps
        blocked = blocked | (active & hit)
        still = active & ~hit

        # y/dd per the improved-penumbra trick.  When t−y <= 0 the estimate
        # is 0/0 (the reference computes NaN there and GLSL min() drops it);
        # the sample is only valid for t−y > 0.
        y = d * d / (2.0 * prev)
        dd = jnp.sqrt(jnp.maximum(d * d - y * y, 0.0))
        denom = t - y
        penumbra = jnp.where(denom > 1e-9,
                             k * dd / jnp.maximum(denom, 1e-9),
                             jnp.inf)
        res = jnp.where(still, jnp.minimum(res, penumbra), res)

        prev = jnp.where(still, d, prev)
        t = jnp.where(still, t + d, t)
        still = still & (t < max_dists)
        return step + 1, t, res, prev, still, blocked

    _, _, res, _, _, blocked = lax.while_loop(
        cond, body,
        (jnp.int32(0), t0, res0, prev0, active0, zeros > 1.0))
    return jnp.where(blocked, 0.0, res)


def ambient_occlusion(sdf, pos, normal, *, steps=3, step_size=0.1):
    """Exponentially-weighted SDF probes along the normal
    (lighting.glsl:51-69): ao = 0.6 + 0.4·Σ(wᵢ·sdf(p+n·(i+1)h)) / Σ(wᵢ·(i+1)h)
    with wᵢ = 2^-i."""
    sdf_b = _as_closure(sdf)
    if steps <= 0:
        return jnp.ones(pos.shape[:-1], jnp.float32)
    ao_sum = 0.0
    max_ao_sum = 0.0
    for i in range(steps):
        factor = 1.0 / (2.0 ** i)
        h = (i + 1) * step_size
        ao_sum = ao_sum + factor * sdf_b(pos + normal * h)
        max_ao_sum = max_ao_sum + factor * h
    return 0.6 + 0.4 * ao_sum / max_ao_sum


def attach_hit_gradient(sdf_b_diff, origins, dirs, t):
    """Re-attach parameter gradients to a non-differentiable march distance.

    Given t from ``raycast`` (constant w.r.t. θ) and the *differentiable*
    batched scene sdf, returns t' with identical value whose derivative obeys
    the implicit function theorem at the surface:
        t' = t − (f(o + t·d; θ) − sg(f)) / sg(d·∇f).
    Gradients flow to scene parameters AND to origins/dirs (needed for
    secondary rays and camera derivatives).
    """
    t_sg = lax.stop_gradient(t)
    p = origins + t_sg[:, None] * dirs

    f, df = jax.jvp(sdf_b_diff, (p,), (lax.stop_gradient(dirs),))
    denom = lax.stop_gradient(df)
    # Guard grazing hits: |d·∇f| can approach 0 at silhouettes.
    denom = jnp.where(jnp.abs(denom) < 1e-3,
                      jnp.sign(denom) * 1e-3 + (denom == 0.0) * 1e-3, denom)
    return t_sg - (f - lax.stop_gradient(f)) / denom


def scene_normal(sdf_b_diff, pos):
    """Surface normal as the normalized scene-SDF gradient — the autodiff
    replacement for per-primitive normal expressions; differentiable w.r.t.
    scene parameters via sdf_b_diff's closure."""
    g = jax.grad(lambda q: jnp.sum(sdf_b_diff(q)))(pos)
    # sqrt(x²+eps) instead of max(norm, eps): the latter has a 0·inf = NaN
    # backward at g = 0 (far-miss lanes sit on the constant max_dist clamp).
    norm = jnp.sqrt(jnp.sum(g * g, axis=-1, keepdims=True) + 1e-24)
    return g / norm
