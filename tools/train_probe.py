"""Bisect the training-step wall time at 256² GI on the GPU.

Times: (a) jitted forward frame on the differentiable configs (no grad),
(b) value_and_grad over materials only, (c) the full train step.  With
BISECT2=1: grad over all float leaves without the mesh.  Exits without a
GPU.  Usage: python tools/train_probe.py
"""
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timeit(label, fn, *args, iters=3):
    import jax
    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.time()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    dt = (time.time() - t0) / iters * 1e3
    print(f"{label:42s} {dt:8.1f} ms", file=sys.stderr)
    return out


def main():
    import dataclasses
    import jax
    import jax.numpy as jnp
    from madarch_tpu.core.config import screen_shade_config, \
        PROBE_SHADE_CONFIG
    from madarch_tpu.examples import scenes
    from madarch_tpu.parallel import spmd
    from madarch_tpu.render.pipeline import render_frame_impl

    size = 256
    r = scenes.global_illumination(width=size, height=size)
    scfg = dataclasses.replace(screen_shade_config(False),
                               differentiable=True)
    pcfg = dataclasses.replace(PROBE_SHADE_CONFIG, differentiable=True)

    # (a) forward only, differentiable configs, plain jit
    fwd = jax.jit(lambda d, c, s: render_frame_impl(
        r.spec, r.probes, r.volumetrics, size, size, d, c, s,
        screen_cfg=scfg, probe_cfg=pcfg))
    timeit("fwd diff-cfg (no grad)", fwd, r.scene_data, r.camera, r.state)

    # (a2) forward on the plain (non-differentiable) configs, for scale
    fwd2 = jax.jit(lambda d, c, s: render_frame_impl(
        r.spec, r.probes, r.volumetrics, size, size, d, c, s))
    timeit("fwd fused-cfg", fwd2, r.scene_data, r.camera, r.state)

    # (b) grad wrt materials only
    target = jnp.zeros((size, size, 3), jnp.float32)

    @jax.jit
    def step_mat(mats, data, cam, state):
        def loss_fn(m):
            d2 = dataclasses.replace(data, materials=m)
            img, st = render_frame_impl(
                r.spec, r.probes, r.volumetrics, size, size, d2, cam,
                state, screen_cfg=scfg, probe_cfg=pcfg)
            return jnp.mean((img - target) ** 2), st
        (l, st), g = jax.value_and_grad(loss_fn, has_aux=True)(mats)
        return l
    timeit("grad wrt materials only", step_mat, r.scene_data.materials,
           r.scene_data, r.camera, r.state)

    # (c) the full train step (all float leaves, shard_map mesh(1));
    # donated buffers force manual rebinding between iterations
    mesh = spmd.make_mesh(1)
    data = spmd.replicate(mesh, r.scene_data)
    state = spmd.replicate(mesh, r.state)
    step = spmd.make_train_step(r.spec, r.probes, r.volumetrics, size,
                                size, mesh, screen_cfg=scfg)
    l, data, state = step(data, r.camera, state, target)
    jax.block_until_ready(l)
    t0 = time.time()
    for _ in range(3):
        l, data, state = step(data, r.camera, state, target)
    jax.block_until_ready(l)
    print(f"{'full train step':42s} {(time.time() - t0) / 3 * 1e3:8.1f} ms",
          file=sys.stderr)


def bisect2():
    """(b2) grad wrt ALL float leaves without shard_map/mesh."""
    import dataclasses
    import jax
    import jax.numpy as jnp
    from madarch_tpu.core.config import screen_shade_config, \
        PROBE_SHADE_CONFIG
    from madarch_tpu.examples import scenes
    from madarch_tpu.parallel.spmd import (merge_float_leaves,
                                           split_float_leaves)
    from madarch_tpu.render.pipeline import render_frame_impl

    size = 256
    r = scenes.global_illumination(width=size, height=size)
    scfg = dataclasses.replace(screen_shade_config(False),
                               differentiable=True)
    pcfg = dataclasses.replace(PROBE_SHADE_CONFIG, differentiable=True)
    target = jnp.zeros((size, size, 3), jnp.float32)

    @jax.jit
    def step_all(data, cam, state):
        floats, aux = split_float_leaves(data)

        def loss_fn(fl):
            full = merge_float_leaves(aux, fl)
            img, st = render_frame_impl(
                r.spec, r.probes, r.volumetrics, size, size, full, cam,
                state, screen_cfg=scfg, probe_cfg=pcfg)
            return jnp.mean((img - target) ** 2), st
        (l, st), g = jax.value_and_grad(loss_fn, has_aux=True)(floats)
        return l
    timeit("grad wrt ALL floats, no shard_map", step_all, r.scene_data,
           r.camera, r.state)


if __name__ == "__main__":
    from madarch_tpu.utils.runtime import enable_compile_cache, require_gpu

    require_gpu()
    enable_compile_cache()
    bisect2() if os.environ.get("BISECT2") else main()
