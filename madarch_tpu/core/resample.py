"""Gather-free nearest-neighbor resampling for static index maps.

Every texture resample in this pipeline uses a *static* index map:
destination pixel -> source texel is fixed by the two resolutions.  Such
maps are periodic — ``idx[j + q] = idx[j] + p`` with q = dst/gcd,
p = src/gcd — so the resample is q interleaved strided slices of the source:
pure dense reshapes/stacks with no data-dependent gather.  Falls back to
``jnp.take`` for aperiodic maps.

Replaces the reference's GPU texture-unit nearest samplers for the
volumetric lookups (/root/reference/madarch/glsl/
accumulate_scattering.glsl:17-31, volumetrics.glsl:34-54), bit-exactly:
callers pass the same index maps their gather formulation used.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np

MAX_PERIOD = 128


def _periodic_qp(idx: np.ndarray):
    """Detect idx[k·q + j] == idx[j] + k·p; return (q, p) or None."""
    dst = len(idx)
    for q in range(1, min(MAX_PERIOD, dst) + 1):
        if dst % q:
            continue
        blocks = idx.reshape(dst // q, q)
        steps = blocks[:, 0] - blocks[0, 0]
        if dst == q:
            return q, 0
        p = int(steps[1])
        if p >= 0 and (np.diff(steps) == p).all() \
                and (blocks == blocks[0][None] + steps[:, None]).all():
            return q, p
    return None


def take_static(x, idx: np.ndarray, axis: int = 0):
    """``jnp.take(x, idx, axis)`` for a host-known in-bounds index array,
    lowered to dense strided slices when the map is periodic (the
    resolution-resample case), else a real gather."""
    idx = np.asarray(idx, np.int64)
    dst = len(idx)
    x = jnp.moveaxis(x, axis, 0)
    qp = _periodic_qp(idx)
    if qp is not None:
        q, p = qp
        g = dst // q
        if p == 0:
            cols = [jnp.broadcast_to(x[int(i)], (g,) + x.shape[1:])
                    for i in idx[:q]]
        else:
            cols = [x[int(i)::p][:g] for i in idx[:q]]
        out = jnp.stack(cols, axis=1).reshape((dst,) + x.shape[1:])
    else:
        out = jnp.take(x, jnp.asarray(idx), axis=0)
    return jnp.moveaxis(out, 0, axis)


def floor_map(dst: int, src: int, offset: float = 0.5) -> np.ndarray:
    """floor((j + offset)·src/dst), clipped — the GL nearest-texel map."""
    j = np.arange(dst)
    return np.clip(np.floor((j + offset) * src / dst).astype(np.int64),
                   0, src - 1)


def resample_axis(x, axis: int, dst: int, *, offset: float = 0.5):
    """Nearest-neighbor resample of one axis to size ``dst`` (dense)."""
    if x.shape[axis] == dst:
        return x
    return take_static(x, floor_map(dst, x.shape[axis], offset), axis)


def shift_clamped(x, axis: int, delta: int):
    """Shift along ``axis`` by ``delta`` with edge clamping (the reference's
    clamped neighborhood taps, volumetrics.glsl:38-50), dense."""
    if delta == 0:
        return x
    n = x.shape[axis]
    sel = [slice(None)] * x.ndim
    reps = [1] * x.ndim
    reps[axis] = abs(delta)
    if delta > 0:
        sel[axis] = slice(delta, n)
        body = x[tuple(sel)]
        sel[axis] = slice(n - 1, n)
        return jnp.concatenate([body, jnp.tile(x[tuple(sel)], reps)],
                               axis=axis)
    sel[axis] = slice(0, n + delta)
    body = x[tuple(sel)]
    sel[axis] = slice(0, 1)
    return jnp.concatenate([jnp.tile(x[tuple(sel)], reps), body], axis=axis)
