"""Profiling and frame-timing utilities.

The reference's only instrumentation is a per-frame wall-clock print
(/root/reference/examples/global_illumination/main.adb:168-171).  Here:

- ``FrameTimer``: device timing (each timed window ends in
  ``jax.block_until_ready``) with rays/s accounting from the scene/pass
  configuration;
- ``trace``: context manager around ``jax.profiler`` for XLA-level traces.
"""
from __future__ import annotations

import contextlib
import time

import jax


class FrameTimer:
    """Rolling frame timer: ``with timer.frame(): img = r.render()``."""

    def __init__(self):
        self.times = []

    @contextlib.contextmanager
    def frame(self):
        t0 = time.perf_counter()
        holder = {}
        yield holder
        if "result" in holder:
            jax.block_until_ready(holder["result"])
        self.times.append(time.perf_counter() - t0)

    def time_fn(self, fn, *args, warmup=1, iters=3):
        out = None
        for _ in range(warmup):
            out = fn(*args)
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        jax.block_until_ready(out)
        dt = (time.perf_counter() - t0) / iters
        self.times.append(dt)
        return dt, out

    @property
    def mean(self):
        return sum(self.times) / max(len(self.times), 1)


def rays_per_frame(width, height, probes, n_lights, screen_cfg,
                   volumetrics=None):
    """Count marched rays per frame (primary + shadow + AO + probe
    visibility + reflection), the BASELINE.json accounting."""
    wh = width * height
    per_pixel = 1 + n_lights + 8 + screen_cfg.ambient_occlusion_steps
    if screen_cfg.indirect_specular_mode in (1, 2, 3):
        per_pixel += 1 + (8 if screen_cfg.indirect_specular_mode in (1, 2)
                          else 0)
        if screen_cfg.indirect_specular_mode == 2 \
                and screen_cfg.add_indirect_specular:
            per_pixel += n_lights
        if screen_cfg.indirect_specular_mode == 3:
            per_pixel += n_lights + 8  # secondary direct + irradiance vis
    total = wh * per_pixel

    texels = probes.num_probes * probes.radiance_resolution ** 2
    total += texels * (1 + n_lights + 8)

    if volumetrics is not None and volumetrics.enabled:
        vx, vy, vz = volumetrics.visibility_resolution
        total += vx * vy * vz * n_lights           # froxel shadow rays
        sx, sy = volumetrics.scattering_resolution
        total += sx * sy                           # scattering primaries
    return total


@contextlib.contextmanager
def trace(log_dir: str):
    """XLA-level profiler trace into ``log_dir`` (view with TensorBoard /
    xprof, or read with ``jax.profiler.ProfileData``)."""
    jax.profiler.start_trace(log_dir)
    try:
        yield log_dir
    finally:
        jax.profiler.stop_trace()
