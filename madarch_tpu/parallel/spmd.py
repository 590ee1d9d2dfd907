"""SPMD scaling over a device mesh.

The reference is a single-GPU engine with no distribution
(SURVEY.md §5); this rebuild's scaling design maps rendering onto SPMD:

- **rays** (screen pixels, probe-radiance texels, froxel/scattering samples)
  shard across the mesh's 'rays' axis — the data-parallel axis; batches are
  padded to a mesh multiple so ANY resolution shards;
- **scene data and probe atlases replicate**; the irradiance integration and
  any parameter gradients become cross-chip psums inserted by XLA from the
  sharding annotations;
- the training step (differentiable render + grad) all-reduces parameter
  gradients automatically through jit's partitioner, with donated
  scene/state buffers.

Call ``init_distributed()`` before building the mesh for a multi-host
cluster; a single host with several devices works as-is.
"""
from __future__ import annotations

import dataclasses
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from madarch_tpu.core.config import (PROBE_SHADE_CONFIG, ProbeSettings,
                                     ShadeConfig, VolumetricsSettings,
                                     screen_shade_config)
from madarch_tpu.render.pipeline import (Camera, FrameState,
                                         render_frame_impl)
from madarch_tpu.scene.scene import SceneData, SceneSpec


def init_distributed(coordinator_address=None, num_processes=None,
                     process_id=None):
    """Guarded ``jax.distributed.initialize`` for a multi-host cluster.

    With explicit arguments, joins that cluster (the multi-host test
    drives a 2-process CPU cluster through this — tests/test_multihost.py);
    with none, autodetects from the coordinator env (JAX_COORDINATOR_ADDRESS
    or COORDINATOR_ADDRESS) and no-ops when absent or already
    initialized."""
    if coordinator_address is not None:
        # must run before ANY backend-touching call (including the
        # process_count guard below)
        try:
            jax.distributed.initialize(
                coordinator_address=coordinator_address,
                num_processes=num_processes, process_id=process_id)
        except RuntimeError as e:
            if "already" in str(e):
                return True
            raise
        return True
    if jax.process_count() > 1:
        return True  # already initialized
    has_env = bool(os.environ.get("JAX_COORDINATOR_ADDRESS")
                   or os.environ.get("COORDINATOR_ADDRESS"))
    if not has_env:
        return False
    try:
        jax.distributed.initialize()
        return True
    except (RuntimeError, ValueError):
        return False


def make_mesh(n_devices: int = None, axis: str = "rays") -> Mesh:
    devices = jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis,))


@dataclasses.dataclass(frozen=True)
class RaySharder:
    """Callable sharding policy for flat ray batches.

    ``shard(arr)`` pads the leading (ray) dimension to a mesh multiple and
    constrains it to shard over the mesh axis; padded tail rays march
    alongside real ones and callers slice results back with ``unpad``
    (every pipeline consumer already carries the true count).
    """

    mesh: Mesh
    axis: str = "rays"

    @property
    def n(self) -> int:
        return self.mesh.devices.size

    def pad(self, arr):
        rem = (-arr.shape[0]) % self.n
        if rem == 0:
            return arr
        fill = jnp.zeros((rem,) + arr.shape[1:], arr.dtype)
        return jnp.concatenate([arr, fill], axis=0)

    def unpad(self, arr, n_true: int):
        return arr[:n_true] if arr.shape[0] != n_true else arr

    def __call__(self, arr):
        arr = self.pad(arr)
        spec = P(self.axis, *([None] * (arr.ndim - 1)))
        return lax.with_sharding_constraint(
            arr, NamedSharding(self.mesh, spec))

    def map_rays(self, fn, sharded, replicated=()):
        """Run ``fn(*sharded, *replicated)`` with the ray arrays split over
        the mesh via ``shard_map`` and the rest replicated.

        This — not a sharding constraint — is the right shape for the
        march loops: under a plain constraint XLA makes every
        ``while_loop`` condition a global reduce, i.e. a cross-chip
        ``pred[] all-reduce`` per march iteration (measured: 6 in-loop
        collectives in the GI frame HLO).  Inside shard_map each device
        marches only its rays with a device-local condition.  Outputs are
        sharded on the ray axis; autodiff through shard_map psums gradients
        of replicated operands across chips — the parameter all-reduce of
        the training step.
        """
        sharded = tuple(self.pad(a) for a in sharded)
        in_specs = tuple(P(self.axis) for _ in sharded) \
            + tuple(P() for _ in replicated)
        f = jax.shard_map(fn, mesh=self.mesh, in_specs=in_specs,
                          out_specs=P(self.axis))
        return f(*sharded, *replicated)


def ray_sharder(mesh: Mesh, axis: str = "rays") -> RaySharder:
    return RaySharder(mesh=mesh, axis=axis)


def replicate(mesh: Mesh, tree):
    """Replicate a pytree across the mesh."""
    sharding = NamedSharding(mesh, P())
    return jax.device_put(tree, sharding)


def make_sharded_render(spec: SceneSpec, probes: ProbeSettings,
                        vol: VolumetricsSettings, width: int, height: int,
                        mesh: Mesh,
                        screen_cfg: ShadeConfig = None,
                        probe_cfg: ShadeConfig = PROBE_SHADE_CONFIG):
    """Jitted frame function with rays sharded over the mesh.

    A 1-device mesh skips the shard_map wrapper (it buys nothing there)."""
    shard = ray_sharder(mesh) if mesh.devices.size > 1 else None

    @jax.jit
    def run(data: SceneData, camera: Camera, state: FrameState):
        return render_frame_impl(spec, probes, vol, width, height, data,
                                 camera, state, screen_cfg=screen_cfg,
                                 probe_cfg=probe_cfg, shard=shard)

    return run


def make_train_step(spec: SceneSpec, probes: ProbeSettings,
                    vol: VolumetricsSettings, width: int, height: int,
                    mesh: Mesh, lr: float = 0.01,
                    screen_cfg: ShadeConfig = None,
                    probe_cfg: ShadeConfig = PROBE_SHADE_CONFIG):
    """Differentiable-rendering training step, sharded over the mesh.

    Loss = mean squared error between the rendered frame and a target image;
    gradients flow to every scene parameter (primitive fields, materials,
    lights, camera-independent) and are all-reduced across chips by XLA.
    Scene data and frame state are donated (updated in place on device).
    Returns a jitted step: (data, camera, state, target) ->
    (loss, new_data, new_state).
    """
    # training renders on the differentiable path (IFT hit reattachment +
    # autodiff normals); plain rendering keeps the fused-kernel fast path.
    if screen_cfg is None:
        screen_cfg = screen_shade_config(vol.enabled)
    screen_cfg = dataclasses.replace(screen_cfg, differentiable=True)
    probe_cfg = dataclasses.replace(probe_cfg, differentiable=True)
    # a 1-device mesh skips the shard_map wrapper (it buys nothing there)
    shard = ray_sharder(mesh) if mesh.devices.size > 1 else None

    @partial(jax.jit, donate_argnums=(0, 2))
    def step(data: SceneData, camera: Camera, state: FrameState, target):
        floats, aux = split_float_leaves(data)

        def loss_fn(floats):
            full = merge_float_leaves(aux, floats)
            image, new_state = render_frame_impl(
                spec, probes, vol, width, height, full, camera, state,
                screen_cfg=screen_cfg, probe_cfg=probe_cfg, shard=shard)
            loss = jnp.mean((image - target) ** 2)
            return loss, new_state

        (loss, new_state), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(floats)
        new_floats = jax.tree.map(lambda p, g: p - lr * g, floats, grads)
        return loss, merge_float_leaves(aux, new_floats), new_state

    return step


def split_float_leaves(tree):
    """(float leaves, aux) — differentiate only real-valued scene params."""
    leaves, treedef = jax.tree.flatten(tree)
    is_f = [jnp.issubdtype(l.dtype, jnp.floating) for l in leaves]
    floats = [l for l, f in zip(leaves, is_f) if f]
    return floats, (treedef, leaves, tuple(is_f))


def merge_float_leaves(aux, floats):
    treedef, leaves, is_f = aux
    it = iter(floats)
    merged = [next(it) if f else l for l, f in zip(leaves, is_f)]
    return jax.tree.unflatten(treedef, merged)


_COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter",
                   "collective-permute", "all-to-all")


def _hlo_computations(hlo_text: str):
    """Split optimized HLO text into {computation name: body lines}."""
    comps = {}
    name = None
    body = []
    for line in hlo_text.splitlines():
        stripped = line.strip()
        if not line.startswith(" ") and "{" in line and "(" in line:
            head = stripped.split("(")[0].strip()
            name = head.split()[-1].lstrip("%")
            body = []
            comps[name] = body
        elif name is not None and stripped and stripped != "}":
            body.append(stripped)
    return comps


def _called_comps(line: str, comps):
    """Computation names referenced by an HLO op line (calls/bodies)."""
    out = []
    for key in ("to_apply=", "body=", "condition=", "branch_computations={",
                "called_computations={"):
        idx = 0
        while True:
            idx = line.find(key, idx)
            if idx < 0:
                break
            rest = line[idx + len(key):]
            for tok in rest.replace("{", " ").replace("}", ",").split(","):
                tok = tok.strip().lstrip("%")
                if tok in comps:
                    out.append(tok)
                elif tok:
                    break
            idx += len(key)
    return out


def _shape_bytes(line: str):
    """Bytes of the op's result shape(s), parsed from the HLO line."""
    import re
    m = re.search(r"=\s*(\(?)([a-z0-9\[\],{}\s/():#_\-.]*?)\)?\s*"
                  r"(all-reduce|all-gather|reduce-scatter|"
                  r"collective-permute|all-to-all)", line)
    if not m:
        return 0
    sizes = {"f32": 4, "s32": 4, "u32": 4, "bf16": 2, "f16": 2, "pred": 1,
             "f64": 8, "s64": 8, "u64": 8, "u8": 1, "s8": 1}
    total = 0
    for dt, dims in re.findall(r"(f32|s32|u32|bf16|f16|pred|f64|s64|u64|u8"
                               r"|s8)\[([0-9,]*)\]", m.group(2)):
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * sizes[dt]
    return total


def collective_report(jitted, *args):
    """Inspect a jitted function's optimized HLO for cross-chip traffic.

    Returns {"in_loops": #collective ops reachable from any while-loop
    body/condition (march loops must be collective-free — SURVEY §5),
    "n_collectives": total, "bytes": summed result bytes, "ops": [...]}.
    """
    hlo = jitted.lower(*args).compile().as_text()
    comps = _hlo_computations(hlo)

    loop_roots = []
    for body in comps.values():
        for line in body:
            if " while(" in line:
                loop_roots += _called_comps(line, comps)
    in_loop = set()
    stack = list(loop_roots)
    while stack:
        c = stack.pop()
        if c in in_loop:
            continue
        in_loop.add(c)
        for line in comps.get(c, ()):
            stack.extend(_called_comps(line, comps))

    ops = []
    n_in_loops = 0
    total_bytes = 0
    for cname, body in comps.items():
        for line in body:
            if any(f" {op}(" in line or f"{op}-start(" in line
                   for op in _COLLECTIVE_OPS):
                b = _shape_bytes(line)
                inside = cname in in_loop
                n_in_loops += int(inside)
                total_bytes += b
                ops.append({"comp": cname, "bytes": b, "in_loop": inside,
                            "op": line.split("=")[1].strip()[:60]
                            if "=" in line else line[:60]})
    return {"in_loops": n_in_loops, "n_collectives": len(ops),
            "bytes": total_bytes, "ops": ops}


def measure_scaling(builder=None, width: int = 256, height: int = 256,
                    frames: int = 4, **builder_kw):
    """Rays/s scaling efficiency: sharded render on the full mesh vs a
    1-device mesh, same scene and shapes.  Returns a dict with times and
    efficiency = t1 / (tN · N).  On the CPU fake cluster this validates the
    machinery only; it measures speed only on real devices."""
    import time

    if builder is None:
        from madarch_tpu.examples.scenes import global_illumination
        builder = global_illumination

    results = {}
    n_all = len(jax.devices())
    for n in (1, n_all):
        r = builder(width=width, height=height, **builder_kw)
        mesh = make_mesh(n)
        data = replicate(mesh, r.scene_data)
        state = replicate(mesh, r.state)
        run = make_sharded_render(r.spec, r.probes, r.volumetrics, width,
                                  height, mesh, screen_cfg=r.screen_cfg,
                                  probe_cfg=r.probe_cfg)
        img, st = run(data, r.camera, state)
        jax.block_until_ready(img)
        t0 = time.time()
        for _ in range(frames):
            img, st = run(data, r.camera, st)
        jax.block_until_ready(img)
        results[n] = (time.time() - t0) / frames

    eff = results[1] / (results[n_all] * n_all) if n_all > 1 else 1.0
    return {"devices": n_all, "t1_s": round(results[1], 4),
            "tN_s": round(results[n_all], 4),
            "efficiency": round(eff, 3)}
