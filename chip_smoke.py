"""Smoke test of the renderer on NVIDIA GPUs, through its normal entry points.

One process, one card (the default):

1. device: JAX's devices, the card's name and power limit; stops unless
   JAX's backend is ``gpu``;
2. rendering: global_illumination and light_shafts at the reference's own
   settings (1000×1000, default probes, default screen config) through
   ``Renderer.render``: 4 converge frames, then 5 timed chained frames;
3. training: 3 steps of ``spmd.make_train_step`` on a 1-device mesh,
   global_illumination at 512², plus the forward/backward split;
4. reference: the five 128² image goldens and the four pixel-gradient
   goldens recomputed on the card and compared with tests/goldens.

``--chips 4`` runs only the SPMD path on four cards: the ray-sharded frame
against the same frame on one device, one sharded train step against the
1-device step, and the collective structure of the sharded frame.

Each phase prints one line; any failure raises, so the script exits
non-zero and prints no result.  The last line of a passing run is
``{"ok": true, "device": {...}}``.

Usage: python chip_smoke.py [--chips 4]
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

from madarch_tpu.utils.runtime import (card_info, enable_compile_cache,  # noqa: E402
                                       require_gpu)

FRAME_SIZE = 1000   # the reference examples' window (examples/scenes.py)
TRAIN_SIZE = 512
CONVERGE_FRAMES = 4
TIMED_FRAMES = 5
TRAIN_STEPS = 3

# A 1000² frame must agree in brightness with the same scene rendered on
# the CPU.  Means of 4-frame CPU renders: global_illumination 0.03085 at
# 128² and 0.03091 at 256²; light_shafts 0.21974 at 128² and 0.21977 at
# 256².  The mean barely moves with resolution, so a band of ±15% catches
# a wrong render without tripping on sampling.
MEAN_RANGE = {"global_illumination": (0.026, 0.036),
              "light_shafts": (0.19, 0.25)}

# Pixel-gradient goldens: the CPU test holds same-backend drift to
# rtol 1e-3.  Across backends each transcendental (sqrt, exp, pow) may
# differ by a few ulp, and a 16×16 loss amplifies that at the few
# near-tie pixels of a 300-step march: ten times the same-backend bound.
GRAD_RTOL = 1e-2

# Sharded vs 1-device frames: the same per-ray arithmetic in batches of
# another shape, so fusion may differ at the last ulp; a discrete choice
# (hit/miss, argmax probe) can then flip at a near-tie.  At most 0.1% of
# pixel channels may differ by more than 1e-4; none by more than one such
# flip's worth (0.5).
SHARD_ATOL = 1e-4
SHARD_MAX_FRAC = 1e-3
# Sharded train-step gradients: psum over devices reorders the pixel sums
# of every parameter gradient (f32 rounding ~1e-6 relative).
SHARD_GRAD_RTOL = 1e-3


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def emit(phase, **fields):
    print(f"{phase}: {json.dumps(fields)}", flush=True)


def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def device_phase():
    from madarch_tpu import native

    devs = jax.devices()
    emit("device", devices=[str(d) for d in devs],
         kind=devs[0].device_kind, count=len(devs),
         native_host_library=native.available())
    # the card's name and power limit, as nvidia-smi reports them
    print(f"card: {card_info()}", flush=True)


def _memory_analysis(compiled):
    m = compiled.memory_analysis()
    if m is None:
        return None
    return {k: getattr(m, k) for k in (
        "argument_size_in_bytes", "output_size_in_bytes",
        "temp_size_in_bytes", "alias_size_in_bytes",
        "generated_code_size_in_bytes") if hasattr(m, k)}


def render_phase(name, size=None):
    """One example scene through Renderer.render at the reference size."""
    from madarch_tpu.examples import scenes
    from madarch_tpu.render.pipeline import render_frame
    from madarch_tpu.utils.profiling import rays_per_frame

    size = size or FRAME_SIZE
    r = getattr(scenes, name)(width=size, height=size)
    # compile the frame once ahead of time: exact compile seconds and the
    # program's memory plan; the persistent cache then serves r.render()
    t0 = time.perf_counter()
    compiled = render_frame.lower(
        r.spec, r.probes, r.volumetrics, r.width, r.height, r.scene_data,
        r.camera, r.state, screen_cfg=r.screen_cfg,
        probe_cfg=r.probe_cfg).compile()
    compile_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    img = r.render()
    jax.block_until_ready(img)
    first_frame_s = time.perf_counter() - t0
    img = r.converge(frames=CONVERGE_FRAMES - 1)
    jax.block_until_ready(img)

    t0 = time.perf_counter()
    for _ in range(TIMED_FRAMES):
        img = r.render()
    jax.block_until_ready(img)
    frame_s = (time.perf_counter() - t0) / TIMED_FRAMES

    arr = np.asarray(img)
    check(arr.shape == (size, size, 3), f"{name}: shape {arr.shape}")
    check(np.isfinite(arr).all(), f"{name}: non-finite pixels")
    check(arr.var() > 0, f"{name}: constant image")
    lo, hi = MEAN_RANGE[name]
    check(lo <= arr.mean() <= hi,
          f"{name}: mean {arr.mean()} outside the CPU range [{lo}, {hi}]")
    rays = rays_per_frame(r.width, r.height, r.probes, 1, r.screen_cfg,
                          r.volumetrics)
    stats = jax.devices()[0].memory_stats() or {}
    emit(f"render {name} {size}x{size}", ms_per_frame=frame_s * 1e3,
         rays_per_s=rays / frame_s, compile_s=compile_s,
         first_frame_s=first_frame_s,
         peak_bytes_in_use=stats.get("peak_bytes_in_use"),
         memory_analysis=_memory_analysis(compiled),
         mean=float(arr.mean()), std=float(arr.std()))


def train_phase(size=None):
    """3 differentiable-render training steps on a 1-device mesh."""
    from functools import partial

    from madarch_tpu.examples import scenes
    from madarch_tpu.parallel import spmd
    from madarch_tpu.render.pipeline import render_frame_impl

    size = size or TRAIN_SIZE
    r = scenes.global_illumination(width=size, height=size)
    mesh = spmd.make_mesh(1)
    data = spmd.replicate(mesh, r.scene_data)
    state = spmd.replicate(mesh, r.state)
    step = spmd.make_train_step(r.spec, r.probes, r.volumetrics, size, size,
                                mesh, screen_cfg=r.screen_cfg)
    target = jnp.zeros((size, size, 3), jnp.float32)

    losses = []
    t0 = time.perf_counter()
    loss, data, state = step(data, r.camera, state, target)
    losses.append(float(loss))
    first_step_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS - 1):
        loss, data, state = step(data, r.camera, state, target)
        losses.append(loss)
    jax.block_until_ready(loss)
    step_s = (time.perf_counter() - t0) / (TRAIN_STEPS - 1)
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"train: non-finite loss {losses}")
    check(len(set(losses)) == len(losses),
          f"train: loss did not change between steps {losses}")
    check(all(bool(jnp.isfinite(x).all())
              for x in spmd.split_float_leaves(data)[0]),
          "train: non-finite scene parameters after the steps")

    # forward/backward split as bench.py computes it: the forward alone on
    # the differentiable configs; backward + update is the remainder
    scfg = dataclasses.replace(r.screen_cfg, differentiable=True)
    pcfg = dataclasses.replace(r.probe_cfg, differentiable=True)
    fwd = jax.jit(partial(render_frame_impl, r.spec, r.probes, r.volumetrics,
                          size, size, screen_cfg=scfg, probe_cfg=pcfg))
    img, _ = fwd(data, r.camera, state)
    jax.block_until_ready(img)
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS - 1):
        img, _ = fwd(data, r.camera, state)
    jax.block_until_ready(img)
    fwd_s = (time.perf_counter() - t0) / (TRAIN_STEPS - 1)
    emit(f"train global_illumination {size}x{size}", losses=losses,
         ms_per_step=step_s * 1e3, first_step_s=first_step_s,
         fwd_ms=fwd_s * 1e3, bwd_update_ms=(step_s - fwd_s) * 1e3)


def reference_phase():
    """The CPU goldens, recomputed on the card."""
    from bench import GOLDEN_GATES, golden_stats

    tool = _load_tool("make_goldens")
    goldens = np.load(os.path.join(REPO, "tests", "goldens", "images.npz"))
    images = {}
    breaches = {}
    for name in ("simple_scene", "global_illumination", "light_shafts",
                 "bvh_test", "ball_game"):
        with contextlib.redirect_stdout(io.StringIO()):  # the tool's log
            img = tool.render_config(name)
        stats = golden_stats(img, goldens[name])
        images[name] = stats
        if stats["breached"]:
            breaches[name] = stats["breached"]

    ref = np.load(os.path.join(REPO, "tests", "goldens", "gradients.npz"))
    with contextlib.redirect_stdout(io.StringIO()):
        got = tool.gradient_goldens()
    grads = {}
    for name in ref.files:
        rel = abs(float(got[name]) - float(ref[name])) / max(
            abs(float(ref[name])), 1e-12)
        grads[name] = {"device": float(got[name]),
                       "golden": float(ref[name]), "rel_diff": rel}
        if rel > GRAD_RTOL:
            breaches[f"grad:{name}"] = rel
    emit("reference", precision="highest", gates=GOLDEN_GATES,
         grad_rtol=GRAD_RTOL, images=images, gradients=grads,
         breaches=breaches)
    check(not breaches, f"reference: breaches {breaches}")


def spmd_phase(n_devices, frame_size=None, train_size=None):
    """Ray-sharded frame and train step on n devices vs one device."""
    from madarch_tpu.examples import scenes
    from madarch_tpu.parallel import spmd

    frame_size = frame_size or FRAME_SIZE
    train_size = train_size or TRAIN_SIZE
    check(len(jax.devices()) >= n_devices,
          f"spmd: {n_devices} devices needed, {len(jax.devices())} found")

    # 1. one frame pair (2 chained frames, so the probe feedback runs)
    frames = {}
    times = {}
    for n in (1, n_devices):
        r = scenes.global_illumination(width=frame_size, height=frame_size)
        mesh = spmd.make_mesh(n)
        data = spmd.replicate(mesh, r.scene_data)
        state = spmd.replicate(mesh, r.state)
        run = spmd.make_sharded_render(
            r.spec, r.probes, r.volumetrics, frame_size, frame_size, mesh,
            screen_cfg=r.screen_cfg, probe_cfg=r.probe_cfg)
        img, st = run(data, r.camera, state)
        img, st = run(data, r.camera, st)
        jax.block_until_ready(img)
        t0 = time.perf_counter()
        for _ in range(TIMED_FRAMES):
            img2, _ = run(data, r.camera, st)
        jax.block_until_ready(img2)
        times[n] = (time.perf_counter() - t0) / TIMED_FRAMES
        frames[n] = np.asarray(img)
        if n == n_devices:
            report = spmd.collective_report(run, data, r.camera, state)
    diff = np.abs(frames[n_devices] - frames[1])
    frac = float((diff > SHARD_ATOL).mean())
    check(frac <= SHARD_MAX_FRAC and diff.max() <= 0.5,
          f"spmd frame: {frac} of channels differ by > {SHARD_ATOL}, "
          f"max {diff.max()}")
    check(report["in_loops"] == 0,
          f"spmd: {report['in_loops']} collectives inside march loops")

    # 2. one train step each; lr = 1 makes new = old − grad
    out = {}
    for n in (1, n_devices):
        r = scenes.global_illumination(width=train_size, height=train_size)
        mesh = spmd.make_mesh(n)
        data = spmd.replicate(mesh, r.scene_data)
        floats0 = [np.asarray(x) for x in
                   spmd.split_float_leaves(r.scene_data)[0]]
        state = spmd.replicate(mesh, r.state)
        step = spmd.make_train_step(r.spec, r.probes, r.volumetrics,
                                    train_size, train_size, mesh, lr=1.0,
                                    screen_cfg=r.screen_cfg)
        target = jnp.zeros((train_size, train_size, 3), jnp.float32)
        loss, new_data, _ = step(data, r.camera, state, target)
        floats1 = spmd.split_float_leaves(new_data)[0]
        out[n] = (float(loss), [a - np.asarray(b)
                                for a, b in zip(floats0, floats1)])
    loss_1, g_1 = out[1]
    loss_n, g_n = out[n_devices]
    check(abs(loss_n - loss_1) <= SHARD_GRAD_RTOL * abs(loss_1),
          f"spmd train: loss {loss_n} vs {loss_1}")
    worst = 0.0
    for a, b in zip(g_1, g_n):
        scale = max(float(np.abs(a).max()), 1e-6)
        worst = max(worst, float(np.abs(a - b).max()) / scale)
    check(worst <= SHARD_GRAD_RTOL,
          f"spmd train: gradient rel diff {worst} > {SHARD_GRAD_RTOL}")
    emit(f"spmd {n_devices} devices", frame_size=frame_size,
         frame_max_absdiff=float(diff.max()), frame_frac_above_atol=frac,
         ms_per_frame_1=times[1] * 1e3,
         ms_per_frame_n=times[n_devices] * 1e3,
         train_size=train_size, loss_1=loss_1, loss_n=loss_n,
         grad_max_rel_diff=worst, collectives_in_loops=report["in_loops"],
         n_collectives=report["n_collectives"],
         collective_bytes=report["bytes"])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1,
                    help="4: run only the SPMD path on four cards")
    args = ap.parse_args(argv)

    require_gpu()
    enable_compile_cache()
    device_phase()
    if args.chips == 4:
        spmd_phase(4)
    else:
        render_phase("global_illumination")
        render_phase("light_shafts")
        train_phase()
        reference_phase()
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
