"""Benchmark: rays/s on one GPU across the five example configs.

Prints ONE JSON line on stdout (headline = the 800×800 global_illumination
scene) with per-config and per-pass detail as extra keys, the device as JAX
reports it, and the card's name and power limit as nvidia-smi reports them;
human-readable progress goes to stderr.  Exits non-zero without a GPU, when
a config breaches its golden gates, or when a collective sits inside a march
loop.

Extra keys: scaling_efficiency (8-device CPU-mesh measure_scaling in a
subprocess that never opens the card — machinery validation only) and
device_vs_golden (128² renders on the card against the CPU goldens under
GOLDEN_GATES).  Ray accounting lives in
madarch_tpu.utils.profiling.rays_per_frame (primary + shadow + AO +
probe-visibility + reflection).

Usage: python bench.py
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# Gates of a device render against the CPU goldens.  Both sides compute in
# f32 with every contraction at HIGHEST precision, but discrete choices —
# silhouette hit/miss and the mode-2 argmax best-probe pick — flip at
# near-ties between backends (~1% of simple_scene's pixels sit on such
# selections).  The gates are robust statistics set just above that
# inherent backend noise, so real shading drift still trips them.
GOLDEN_GATES = {"mean_absdiff": 0.01, "p99_absdiff": 0.15,
                "frac_above_0.05": 0.02}


def golden_stats(img, ref):
    """Robust |img − ref| statistics plus the gates they breach."""
    import numpy as np

    img = np.asarray(img)
    ref = np.asarray(ref)
    diff = np.abs(img - ref)
    stats = {
        "mean_device": float(img.mean()),
        "mean_golden": float(ref.mean()),
        "max_absdiff": float(diff.max()),
        "mean_absdiff": float(diff.mean()),
        "p99_absdiff": float(np.quantile(diff, 0.99)),
        "frac_above_0.05": float((diff > 0.05).mean()),
    }
    stats["breached"] = sorted(
        k for k, lim in GOLDEN_GATES.items() if stats[k] > lim)
    return stats


def bench_renderer(name, r, n_lights, frames=5, converge_frames=3):
    from madarch_tpu.utils.profiling import rays_per_frame

    import jax

    t0 = time.time()
    img = r.converge(frames=converge_frames)
    jax.block_until_ready(img)
    compile_s = time.time() - t0

    t0 = time.time()
    for _ in range(frames):
        img = r.render()
    jax.block_until_ready(img)
    dt = (time.time() - t0) / frames

    rays = rays_per_frame(r.width, r.height, r.probes, n_lights,
                          r.screen_cfg, r.volumetrics)
    rays_per_s = rays / dt
    print(f"{name:24s} {dt * 1e3:8.1f} ms/frame  "
          f"{rays_per_s / 1e6:8.1f} M rays/s  (compile {compile_s:.1f}s)",
          file=sys.stderr)
    return {"frame_ms": round(dt * 1e3, 2),
            "rays_per_s": round(rays_per_s),
            "compile_s": round(compile_s, 1)}


def per_pass_breakdown(r):
    """ms per pipeline pass for the GI scene."""
    import jax
    from functools import partial
    from madarch_tpu.core.config import PROBE_SHADE_CONFIG
    from madarch_tpu.render import probes as probes_mod
    from madarch_tpu.render.pipeline import radiance_pass, screen_pass

    spec, data, cam, st = r.spec, r.scene_data, r.camera, r.state
    probes = r.probes

    f_rad = jax.jit(lambda d, irr, rad: radiance_pass(
        spec, d, probes, PROBE_SHADE_CONFIG, irr, rad))
    f_irr = jax.jit(partial(probes_mod.integrate_irradiance, probes))
    f_scr = jax.jit(lambda d, irr, rad, sc: screen_pass(
        spec, d, probes, r.volumetrics, r.screen_cfg, r.width, r.height,
        cam, irr, rad, sc))

    out = {}
    # chained dispatches, one block_until_ready per pass: host wall time,
    # an upper bound per pass
    iters = 20
    for name, fn, args in (
            ("radiance", f_rad, (data, st.irradiance, st.radiance)),
            ("irradiance_integrate", f_irr, (st.radiance,)),
            ("screen", f_scr, (data, st.irradiance, st.radiance,
                               st.scattering))):
        res = fn(*args)
        jax.block_until_ready(res)
        t0 = time.time()
        for _ in range(iters):
            res = fn(*args)
        jax.block_until_ready(res)
        out[name] = round((time.time() - t0) / iters * 1e3, 2)
    print(f"per-pass (GI): {out}", file=sys.stderr)
    return out


def device_vs_golden():
    """Render GI + simple_scene at 128² on the card and compare against
    the CPU goldens under GOLDEN_GATES.  Returns {} when goldens are
    absent."""
    import numpy as np

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tests", "goldens", "images.npz")
    if not os.path.exists(path):
        return {}
    goldens = np.load(path)
    from madarch_tpu.examples import scenes

    frames = {"global_illumination": 4, "simple_scene": 2}
    out = {}
    for name in ("global_illumination", "simple_scene"):
        r = getattr(scenes, name)(width=128, height=128)
        stats = golden_stats(r.converge(frames=frames[name]), goldens[name])
        out[name] = stats
        print(f"device-vs-golden {name}: {stats}", file=sys.stderr)
        if stats["breached"]:
            print(f"*** GOLDEN DRIFT: {name} breached {stats['breached']} "
                  f"***", file=sys.stderr)
    return out


def bench_train_step():
    """Forward+backward throughput (BASELINE.json north star second half):
    one differentiable-render training step on the 256² GI scene, timed on
    the card, reported as rays/s (counting the forward frame's rays; the
    backward roughly doubles the true march work)."""
    import jax
    import jax.numpy as jnp
    from madarch_tpu.examples import scenes
    from madarch_tpu.parallel import spmd
    from madarch_tpu.utils.profiling import rays_per_frame

    import dataclasses
    from functools import partial
    from madarch_tpu.render.pipeline import render_frame_impl

    size = 256
    r = scenes.global_illumination(width=size, height=size)
    mesh = spmd.make_mesh(1)
    data = spmd.replicate(mesh, r.scene_data)
    state = spmd.replicate(mesh, r.state)
    step = spmd.make_train_step(r.spec, r.probes, r.volumetrics, size, size,
                                mesh, screen_cfg=r.screen_cfg)
    target = jnp.zeros((size, size, 3), jnp.float32)
    t0 = time.time()
    loss, data, state = step(data, r.camera, state, target)
    jax.block_until_ready(loss)
    compile_s = time.time() - t0
    iters = 5
    t0 = time.time()
    for _ in range(iters):
        loss, data, state = step(data, r.camera, state, target)
    jax.block_until_ready(loss)
    dt = (time.time() - t0) / iters
    rays = rays_per_frame(size, size, r.probes, 1, r.screen_cfg,
                          r.volumetrics)

    out = {"frame_ms": round(dt * 1e3, 2), "rays_per_s": round(rays / dt),
           "compile_s": round(compile_s, 1), "size": size,
           "loss_finite": bool(jnp.isfinite(loss))}
    print(f"train_step (GI {size}²):     {dt*1e3:8.1f} ms/step  "
          f"{rays/dt/1e6:8.1f} M rays/s  (compile {compile_s:.1f}s)",
          file=sys.stderr)

    # 512² amortizes the per-dispatch fixed costs that weigh on 256²
    size2 = 512
    r2 = scenes.global_illumination(width=size2, height=size2)
    data2 = spmd.replicate(mesh, r2.scene_data)
    state2 = spmd.replicate(mesh, r2.state)
    step2 = spmd.make_train_step(r2.spec, r2.probes, r2.volumetrics,
                                 size2, size2, mesh,
                                 screen_cfg=r2.screen_cfg)
    target2 = jnp.zeros((size2, size2, 3), jnp.float32)
    loss2, data2, state2 = step2(data2, r2.camera, state2, target2)
    jax.block_until_ready(loss2)
    t0 = time.time()
    for _ in range(iters):
        loss2, data2, state2 = step2(data2, r2.camera, state2, target2)
    jax.block_until_ready(loss2)
    dt2 = (time.time() - t0) / iters
    rays2 = rays_per_frame(size2, size2, r2.probes, 1, r2.screen_cfg,
                           r2.volumetrics)
    # forward/backward split at 512²: the forward alone on the
    # differentiable configs; backward + update is the remainder
    scfg = dataclasses.replace(r2.screen_cfg, differentiable=True)
    pcfg = dataclasses.replace(r2.probe_cfg, differentiable=True)
    fwd = jax.jit(partial(render_frame_impl, r2.spec, r2.probes,
                          r2.volumetrics, size2, size2,
                          screen_cfg=scfg, probe_cfg=pcfg))
    img, _ = fwd(data2, r2.camera, state2)
    jax.block_until_ready(img)
    t0 = time.time()
    for _ in range(iters):
        img, _ = fwd(data2, r2.camera, state2)
    jax.block_until_ready(img)
    fwd_ms = (time.time() - t0) / iters * 1e3

    out["at_512"] = {"frame_ms": round(dt2 * 1e3, 2),
                     "rays_per_s": round(rays2 / dt2),
                     "fwd_ms": round(fwd_ms, 2),
                     "bwd_update_ms": round(dt2 * 1e3 - fwd_ms, 2),
                     "loss_finite": bool(jnp.isfinite(loss2))}
    print(f"train_step (GI {size2}²):     {dt2*1e3:8.1f} ms/step  "
          f"{rays2/dt2/1e6:8.1f} M rays/s  (fwd {fwd_ms:.1f} ms)",
          file=sys.stderr)
    return out


def scaling_efficiency():
    """measure_scaling on an 8-device CPU mesh, in a subprocess that never
    opens the card (this process owns it; JAX_PLATFORMS=cpu in the child's
    environment).  Validates the SPMD machinery only; speed across cards
    needs a run on several GPUs (chip_smoke.py --chips 4)."""
    code = (
        "import os, json\n"
        "os.environ['XLA_FLAGS'] = os.environ.get('XLA_FLAGS','') + "
        "' --xla_force_host_platform_device_count=8'\n"
        "import jax\n"
        "jax.config.update('jax_platforms', 'cpu')\n"
        "import sys; sys.path.insert(0, %r)\n"
        "from madarch_tpu.parallel import spmd\n"
        "from madarch_tpu.examples.scenes import global_illumination\n"
        "out = spmd.measure_scaling(width=96, height=96, frames=2)\n"
        "r = global_illumination(width=96, height=96)\n"
        "mesh = spmd.make_mesh(8)\n"
        "data = spmd.replicate(mesh, r.scene_data)\n"
        "state = spmd.replicate(mesh, r.state)\n"
        "run = spmd.make_sharded_render(r.spec, r.probes, r.volumetrics, "
        "96, 96, mesh, screen_cfg=r.screen_cfg, probe_cfg=r.probe_cfg)\n"
        "rep = spmd.collective_report(run, data, r.camera, state)\n"
        "out['collectives_in_march_loops'] = rep['in_loops']\n"
        "out['collective_bytes_per_frame'] = rep['bytes']\n"
        "out['n_collectives'] = rep['n_collectives']\n"
        "print('SCALING=' + json.dumps(out))\n"
    ) % os.path.dirname(os.path.abspath(__file__))
    try:
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        res = subprocess.run([sys.executable, "-c", code], timeout=900,
                             capture_output=True, text=True, env=env)
        for line in res.stdout.splitlines():
            if line.startswith("SCALING="):
                out = json.loads(line[len("SCALING="):])
                print(f"scaling (8-dev CPU mesh): {out}", file=sys.stderr)
                return out
    except (subprocess.TimeoutExpired, OSError) as e:
        print(f"scaling measurement failed: {e}", file=sys.stderr)
    return {}


def main():
    import jax
    from madarch_tpu.core.config import ProbeSettings
    from madarch_tpu.examples import scenes
    from madarch_tpu.utils.runtime import (card_info, enable_compile_cache,
                                           require_gpu)

    require_gpu()
    enable_compile_cache()
    dev = jax.devices()[0]
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    card = card_info()
    print(f"device: {device}; card: {card}", file=sys.stderr)
    size = 800
    configs = {}

    # 1. simple_scene: spheres/planes/boxes, point light, direct PBR
    r = scenes.simple_scene(width=size, height=size)
    configs["simple_scene"] = bench_renderer("simple_scene", r, n_lights=1)

    # 2. soft shadows + AO + reflections (room scene, spot light): the GI
    # room with minimal probe work so the screen-pass effects dominate
    tiny_probes = ProbeSettings(radiance_resolution=8,
                                irradiance_resolution=4,
                                probe_count=(6, 6),
                                grid_dimensions=(4, 3, 3),
                                grid_spacing=(2.0, 3.0, 3.0))
    r = scenes.global_illumination(width=size, height=size,
                                   probes=tiny_probes)
    configs["room_reflections"] = bench_renderer("room_reflections", r,
                                                 n_lights=1)

    # 3. DDGI global illumination (the headline config)
    r_gi = scenes.global_illumination(width=size, height=size)
    configs["global_illumination"] = bench_renderer(
        "global_illumination", r_gi, n_lights=1)
    passes = per_pass_breakdown(r_gi)

    # 4. volumetric light shafts
    r = scenes.light_shafts(width=size, height=size)
    configs["light_shafts"] = bench_renderer("light_shafts", r, n_lights=1)

    # 5. triangle mesh (suzanne.obj, 968 triangles, dense evaluation in
    # ray chunks); the mesh file is not part of the repository
    mesh_probes = ProbeSettings(radiance_resolution=8,
                                irradiance_resolution=4,
                                probe_count=(6, 6),
                                grid_dimensions=(3, 3, 4),
                                grid_spacing=(2.0, 3.0, 3.0))
    try:
        r = scenes.obj_mesh(width=size, height=size, probes=mesh_probes)
    except FileNotFoundError as e:
        configs["obj_mesh"] = {"not_run": f"mesh file missing: {e}"}
        print(f"obj_mesh not run: {e}", file=sys.stderr)
    else:
        configs["obj_mesh"] = bench_renderer("obj_mesh", r, n_lights=1,
                                             frames=2, converge_frames=1)

    train = bench_train_step()

    failures = {}
    golden_stats_ = device_vs_golden()
    scaling = scaling_efficiency()
    if scaling:
        scaling["note"] = (
            "8 virtual CPU devices: the efficiency number only validates "
            "the shard_map machinery; the structural evidence is "
            "collectives_in_march_loops == 0 and the per-frame collective "
            "byte count.")
        # a collective inside a march loop would serialize every march
        # step across devices
        if scaling.get("collectives_in_march_loops", 0) != 0:
            failures["collectives_in_march_loops"] = \
                scaling["collectives_in_march_loops"]
            print("*** COLLECTIVE IN MARCH LOOP: "
                  f"{scaling['collectives_in_march_loops']} ***",
                  file=sys.stderr)

    golden_breach = sorted(
        f"{name}:{k}" for name, st in golden_stats_.items()
        for k in st.get("breached", ()))
    failed = bool(failures) or bool(golden_breach)
    if failed:
        print(f"*** FAILED: {failures} golden={golden_breach} ***",
              file=sys.stderr)

    print(json.dumps({
        "metric": "rays_per_s_gi_800",
        "value": configs["global_illumination"]["rays_per_s"],
        "unit": "rays/s",
        "device": device,
        "card": card,
        "failed": failed,
        "configs": configs,
        "train_step": train,
        "per_pass_ms": passes,
        "failures": failures,
        "golden_breaches": golden_breach,
        "device_vs_golden": golden_stats_,
        "scaling_efficiency": scaling,
    }))
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
