"""Ad-hoc GPU perf probe: time one bench config's frame without the full
bench.py sweep.  Usage: python tools/perf_probe.py [config] [size] [frames]

Prints frame ms + rays/s to stderr and a one-line JSON to stdout (with
PROBE_PASSES=1 also bench.per_pass_breakdown).  Exits without a GPU.
"""
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    name = sys.argv[1] if len(sys.argv) > 1 else "obj_mesh"
    size = int(sys.argv[2]) if len(sys.argv) > 2 else 800
    frames = int(sys.argv[3]) if len(sys.argv) > 3 else 3
    import jax
    from madarch_tpu.examples import scenes
    from madarch_tpu.core.config import ProbeSettings
    from madarch_tpu.utils.profiling import rays_per_frame
    from madarch_tpu.utils.runtime import (card_info, enable_compile_cache,
                                           require_gpu)

    require_gpu()
    enable_compile_cache()
    print(f"device: {jax.devices()[0].device_kind}; card: {card_info()}",
          file=sys.stderr)
    kwargs = {}
    if name == "obj_mesh":
        kwargs["probes"] = ProbeSettings(
            radiance_resolution=8, irradiance_resolution=4,
            probe_count=(6, 6), grid_dimensions=(3, 3, 4),
            grid_spacing=(2.0, 3.0, 3.0))
    r = getattr(scenes, name)(width=size, height=size, **kwargs)
    t0 = time.time()
    img = r.converge(frames=1)
    jax.block_until_ready(img)
    compile_s = time.time() - t0
    t0 = time.time()
    for _ in range(frames):
        img = r.render()
    jax.block_until_ready(img)
    dt = (time.time() - t0) / frames
    rays = rays_per_frame(r.width, r.height, r.probes, 1, r.screen_cfg,
                          r.volumetrics)
    out = {"config": name, "size": size, "frame_ms": round(dt * 1e3, 2),
           "rays_per_s": round(rays / dt), "compile_s": round(compile_s, 1)}
    if os.environ.get("PROBE_PASSES", "") == "1":
        from bench import per_pass_breakdown
        out["per_pass_ms"] = per_pass_breakdown(r)
    print(f"{name} {size}²: {dt*1e3:.1f} ms/frame, "
          f"{rays/dt/1e6:.1f} M rays/s (compile {compile_s:.1f}s)",
          file=sys.stderr)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
