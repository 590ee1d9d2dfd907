"""Regenerate the golden regression arrays (tests/goldens/*.npz).

Run on CPU (deterministic across hosts):
    JAX_PLATFORMS=cpu python tools/make_goldens.py

Goldens pin today's verified output against regressions: 128² renders of
every example config plus pixel-gradients of named scene parameters
(BASELINE.json: "image + pixel-gradient allclose").  Intentional behavior
changes regenerate them (and the diff shows up in review as a binary churn
+ this script's log of per-config means).
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tests", "goldens")

SIZE = 128
FRAMES = {"global_illumination": 4, "light_shafts": 2}


SCENES = ("simple_scene", "global_illumination", "light_shafts", "obj_mesh",
          "bvh_test", "ball_game")


def render_config(name):
    """The 128² golden render of one example config, f32[H, W, 3]."""
    from madarch_tpu.examples import scenes

    if name == "ball_game":
        # two physics steps then a frame (exercises eval_distance_to +
        # dynamic counts)
        r, step_physics, throw_ball = scenes.ball_game(width=SIZE,
                                                       height=SIZE)
        throw_ball((2.0, 2.0, 0.0), (2.0, 2.0, 4.0))
        for _ in range(2):
            step_physics()
    else:
        r = getattr(scenes, name)(width=SIZE, height=SIZE)
    img = np.asarray(r.converge(frames=FRAMES.get(name, 2)))
    print(f"{name:22s} mean={img.mean():.5f} std={img.std():.5f}")
    return img.astype(np.float32)


def render_configs():
    return {name: render_config(name) for name in SCENES}


def gradient_goldens():
    """dL/d(named param) for the differentiability scene
    (tests/test_differentiability.py's fixture, at its exact configs)."""
    import importlib.util

    import jax.numpy as jnp

    # by file path: another installed package may also be named "tests"
    spec = importlib.util.spec_from_file_location(
        "test_differentiability",
        os.path.join(os.path.dirname(GOLDEN_DIR), "test_differentiability.py"))
    td = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(td)

    grads = {}

    def loss_radius(v):
        radius = td.DATA.prims["sphere"]["radius"].at[0].set(v)
        return td.render_loss(
            td._set(td.DATA, ("prims", "sphere", "radius"), radius),
            interior_only=True)

    def loss_albedo(v):
        albedo = td.DATA.materials["albedo"].at[0, 0].set(v)
        return td.render_loss(td._set(td.DATA, ("materials", "albedo"),
                                      albedo))

    def loss_light_y(v):
        pos = td.DATA.lights["point_light"]["position"].at[0, 1].set(v)
        return td.render_loss(
            td._set(td.DATA, ("lights", "point_light", "position"), pos))

    for name, fn, at in (("sphere_radius", loss_radius, 1.0),
                         ("albedo_r", loss_albedo, 0.8),
                         ("light_y", loss_light_y, 4.0),
                         ("camera_z",
                          lambda v: td.render_loss(td.DATA, cam_z=v), -0.5)):
        g = float(jax.grad(jax.jit(fn))(jnp.float32(at)))
        print(f"grad {name:16s} = {g:+.6e}")
        grads[name] = np.float32(g)
    return grads


def main():
    from madarch_tpu.utils.runtime import enable_compile_cache

    os.environ.setdefault("XLA_FLAGS",
                          "--xla_force_host_platform_device_count=8")
    jax.config.update("jax_platforms", "cpu")
    enable_compile_cache()
    os.makedirs(GOLDEN_DIR, exist_ok=True)
    images = render_configs()
    np.savez_compressed(os.path.join(GOLDEN_DIR, "images.npz"), **images)
    grads = gradient_goldens()
    np.savez(os.path.join(GOLDEN_DIR, "gradients.npz"), **grads)
    print(f"wrote {GOLDEN_DIR}/images.npz + gradients.npz")


if __name__ == "__main__":
    main()
