"""Headless example runner — the counterpart of the reference's example
binaries (each /root/reference/examples/* main is a windowed render loop;
here frames render headlessly to PNG with per-frame timing printed, matching
the reference's wall-clock prints).

Usage:
    python -m madarch_tpu.examples.run SCENE [--frames N] [--size WxH]
        [--out out.png] [--fast]

SCENE: simple_scene | global_illumination | light_shafts | obj_mesh |
       ball_game | bvh_test
"""
from __future__ import annotations

import argparse
import time

import jax

from madarch_tpu.core.config import ProbeSettings, screen_shade_config
from madarch_tpu.examples import scenes as S
from madarch_tpu.io.image import write_png
from madarch_tpu.utils.runtime import enable_compile_cache


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("scene", choices=["simple_scene", "global_illumination",
                                      "light_shafts", "obj_mesh",
                                      "ball_game", "bvh_test"])
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--size", default="800x800")
    ap.add_argument("--out", default=None)
    ap.add_argument("--fast", action="store_true",
                    help="small probes + capped march steps")
    args = ap.parse_args(argv)
    enable_compile_cache()

    w, h = (int(x) for x in args.size.split("x"))
    kwargs = {"width": w, "height": h}
    if args.fast:
        kwargs["probes"] = ProbeSettings(
            radiance_resolution=8, irradiance_resolution=4,
            probe_count=(4, 2), grid_dimensions=(2, 2, 2),
            grid_spacing=(4.0, 4.0, 4.0))

    step_physics = None
    if args.scene == "ball_game":
        r, step_physics, throw_ball = S.ball_game(**kwargs)
        throw_ball(origin=(2.0, 3.0, 2.0), velocity=(0.5, 1.0, 2.0))
    else:
        r = getattr(S, args.scene)(**kwargs)
    if args.fast:
        r.screen_cfg = screen_shade_config(
            r.volumetrics.enabled, max_march_steps=128)

    img = None
    for i in range(args.frames):
        t0 = time.perf_counter()
        if step_physics is not None:
            step_physics()
        img = r.render()
        jax.block_until_ready(img)
        print(f"frame {i}: {time.perf_counter() - t0:.3f}s")

    out = args.out or f"{args.scene}_{w}x{h}.png"
    write_png(out, img)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
