"""Where a global_illumination frame spends its time on the GPU.

Three measurements of the 1000² frame at the reference settings, in one
process, for PERF.md:

1. the per-pass split of bench.per_pass_breakdown (radiance, irradiance
   integration, screen);
2. a same-process A/B of the atlas contractions (render/probes.py
   ATLAS_PRECISION) at HIGHEST against DEFAULT precision, in turns
   A B B A, with the image difference between the two;
3. one profiler trace of 2 frames, reduced to the device's busy and idle
   share and its largest events.

Usage: python tools/bringup_probe.py [size]  (keeps the trace under
.traces/bringup)
"""
import glob
import json
import os
import sys
import time
from collections import defaultdict
from functools import partial

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FRAMES = 5


def _time_frames(fn, args):
    import jax

    out = fn(*args)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(FRAMES):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / FRAMES, out


def atlas_precision_ab(r):
    """HIGHEST vs DEFAULT atlas precision, compiled once each, timed in
    turns A B B A on the same converged state."""
    import jax
    import numpy as np
    from jax import lax

    from madarch_tpu.render import probes as probes_mod
    from madarch_tpu.render.pipeline import render_frame_impl

    args = (r.scene_data, r.camera, r.state)
    fns = {}
    saved = probes_mod.ATLAS_PRECISION
    try:
        for label, prec in (("highest", lax.Precision.HIGHEST),
                            ("default", lax.Precision.DEFAULT)):
            probes_mod.ATLAS_PRECISION = prec
            fns[label] = jax.jit(partial(
                render_frame_impl, r.spec, r.probes, r.volumetrics, r.width,
                r.height, screen_cfg=r.screen_cfg, probe_cfg=r.probe_cfg))
            jax.block_until_ready(fns[label](*args))  # trace + compile now
    finally:
        probes_mod.ATLAS_PRECISION = saved
    ms = defaultdict(list)
    images = {}
    for label in ("highest", "default", "default", "highest"):
        dt, (img, _) = _time_frames(fns[label], args)
        ms[label].append(dt * 1e3)
        images[label] = np.asarray(img)
    diff = np.abs(images["highest"] - images["default"])
    return {"ms_per_frame": dict(ms),
            "image_max_absdiff": float(diff.max()),
            "image_mean_absdiff": float(diff.mean()),
            "image_frac_above_0.05": float((diff > 0.05).mean())}


def device_busy(trace_dir):
    """Busy/idle share of the GPU planes of one trace: busy is the union of
    the event intervals on the CUDA stream lines, over the window from the
    first to the last such event."""
    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                            recursive=True))[-1]
    pd = ProfileData.from_file(path)
    intervals = []
    by_name = defaultdict(lambda: [0, 0.0])
    lines = defaultdict(int)
    for plane in pd.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            lines[f"{plane.name}/{line.name}"] += 1
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
                by_name[ev.name][0] += 1
                by_name[ev.name][1] += ev.duration_ns
    if not intervals:
        return {"error": "no GPU stream events", "lines": dict(lines)}
    intervals.sort()
    busy = 0.0
    cur_s, cur_e = intervals[0]
    for s, e in intervals[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = intervals[-1][1] - intervals[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    memcpy = {k: v for k, v in by_name.items() if "emcpy" in k}
    return {"window_ms": window / 1e6, "busy_ms": busy / 1e6,
            "idle_share": 1.0 - busy / window, "n_events": len(intervals),
            "memcpy_events": {k: {"count": v[0], "ms": v[1] / 1e6}
                              for k, v in memcpy.items()},
            "top_events": [{"name": k[:80], "count": v[0], "ms": v[1] / 1e6}
                           for k, v in top],
            "lines": dict(lines)}


def main():
    import jax

    from bench import per_pass_breakdown
    from madarch_tpu.examples import scenes
    from madarch_tpu.utils.profiling import trace
    from madarch_tpu.utils.runtime import (REPO_ROOT, card_info,
                                           enable_compile_cache, require_gpu)

    require_gpu()
    enable_compile_cache()
    size = int(sys.argv[1]) if len(sys.argv) > 1 else 1000
    print(f"device: {jax.devices()[0].device_kind}; card: {card_info()}",
          flush=True)
    r = scenes.global_illumination(width=size, height=size)
    jax.block_until_ready(r.converge(frames=4))

    out = {"size": size, "per_pass_ms": per_pass_breakdown(r)}
    print(f"per_pass: {json.dumps(out['per_pass_ms'])}", flush=True)
    out["atlas_precision"] = atlas_precision_ab(r)
    print(f"atlas_precision: {json.dumps(out['atlas_precision'])}",
          flush=True)

    trace_dir = os.path.join(REPO_ROOT, ".traces", "bringup")
    with trace(trace_dir):
        for _ in range(2):
            img = r.render()
        jax.block_until_ready(img)
    out["trace"] = device_busy(trace_dir)
    print(f"trace: {json.dumps(out['trace'])}", flush=True)


if __name__ == "__main__":
    main()
