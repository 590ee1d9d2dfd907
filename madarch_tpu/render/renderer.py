"""The engine facade: scene mutation API + frame loop.

JAX counterpart of ``Madarch.Renderers``
(/root/reference/madarch/madarch-renderers.ads:46-97): Create/Render,
Add/Set_Primitive, Set/Add_Material, Set_Light, Set_Camera_*,
Eval_Distance_To.  Instead of writing std140 bytes into GL uniform buffers
(madarch-renderers.adb:335-483), mutations edit a host-side numpy mirror and
the next ``render()`` ships the snapshot to the device; the jitted frame
pipeline is cached per static (spec, settings, resolution) exactly as the
reference compiles its specialized shaders once per scene.
"""
from __future__ import annotations

from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from madarch_tpu.core.config import (NO_VOLUMETRICS, PROBE_SHADE_CONFIG,
                                     ProbeSettings, ShadeConfig,
                                     VolumetricsSettings,
                                     screen_shade_config)
from madarch_tpu.render.camera import orientation_from_angles
from madarch_tpu.render.pipeline import (Camera, FrameState, initial_state,
                                         render_frame)
from madarch_tpu.scene.primitives import PrimitiveType
from madarch_tpu.scene.scene import SceneBuilder, SceneSpec


class Renderer:
    """Owns the scene mirror, camera, and probe/scattering feedback state."""

    def __init__(self, spec: SceneSpec, width: int = 1000,
                 height: int = 1000,
                 probes: ProbeSettings = ProbeSettings(),
                 volumetrics: VolumetricsSettings = VolumetricsSettings(),
                 screen_cfg: Optional[ShadeConfig] = None,
                 probe_cfg: ShadeConfig = PROBE_SHADE_CONFIG,
                 specialize_counts: bool = True):
        """``specialize_counts`` bakes the live primitive/light counts into
        the compiled pipeline as static loop bounds (the scene-compiler move:
        the reference generates GLSL for the exact scene shape).  Each
        add_primitive/add_light then triggers a recompile on the next
        render(); pass False for count-dynamic scenes."""
        self.base_spec = spec
        self.specialize_counts = specialize_counts
        self.width = width
        self.height = height
        self.probes = probes
        self.volumetrics = volumetrics
        self.screen_cfg = screen_cfg or screen_shade_config(
            volumetrics.enabled)
        self.probe_cfg = probe_cfg
        self.builder = SceneBuilder(spec)
        self.state = initial_state(probes, volumetrics)
        self.camera_position = np.zeros(3, np.float32)
        self.camera_orientation = np.eye(3, dtype=np.float32)
        self._data = None  # device snapshot; invalidated on mutation

    # -- scene mutation (invalidates the device snapshot) --
    def add_primitive(self, ptype, **fields):
        self._data = None
        return self.builder.add_primitive(ptype, **fields)

    def set_primitive(self, ptype, index, **fields):
        self._data = None
        self.builder.set_primitive(ptype, index, **fields)

    def add_light(self, ltype, **fields):
        self._data = None
        return self.builder.add_light(ltype, **fields)

    def set_light(self, ltype, index, **fields):
        self._data = None
        self.builder.set_light(ltype, index, **fields)

    def add_material(self, albedo, metallic, roughness):
        self._data = None
        return self.builder.add_material(albedo, metallic, roughness)

    def set_material(self, index, albedo, metallic, roughness):
        self._data = None
        self.builder.set_material(index, albedo, metallic, roughness)

    # -- camera --
    def set_camera_position(self, position):
        self.camera_position = np.asarray(position, np.float32)

    def set_camera_orientation(self, orientation):
        self.camera_orientation = np.asarray(orientation, np.float32)

    def set_camera_angles(self, rot_x: float, rot_y: float):
        self.camera_orientation = np.asarray(
            orientation_from_angles(rot_x, rot_y))

    @property
    def spec(self) -> SceneSpec:
        """The static spec the pipeline compiles against — live counts baked
        in when specialize_counts (recompiles when a count changes)."""
        if not self.specialize_counts:
            return self.base_spec
        return self.base_spec.specialized(self.builder._prim_counts,
                                          self.builder._light_counts)

    @property
    def scene_data(self):
        if self._data is None:
            self._data = self.builder.device_data(
                grid=getattr(self, "_grid", None))
        return self._data

    def update_partitioning(self, method: str = "gpu_fast"):
        """Rebuild the uniform-grid candidate lists (Update_Partitioning,
        madarch-renderers.adb:757; methods cpu_best/cpu_fast/gpu_fast).
        No-op when the spec has no partitioning settings."""
        if self.spec.partitioning is None:
            return
        from madarch_tpu.scene.partitioning import build_grid
        base = self.builder.device_data(grid=None)
        self._grid = build_grid(self.spec, self.spec.partitioning, base,
                                method=method)
        self._data = None

    @property
    def camera(self) -> Camera:
        return Camera(position=jnp.asarray(self.camera_position),
                      orientation=jnp.asarray(self.camera_orientation))

    # -- frame loop --
    def render(self):
        """Render one frame; advances the probe feedback state.  Returns the
        tonemapped image f32[H, W, 3] (row 0 = bottom)."""
        image, self.state = render_frame(
            self.spec, self.probes, self.volumetrics, self.width,
            self.height, self.scene_data, self.camera, self.state,
            screen_cfg=self.screen_cfg, probe_cfg=self.probe_cfg)
        return image

    def converge(self, frames: int = 4):
        """Run several frames so multi-bounce GI reaches steady state
        (the reference accumulates bounces across its live frame loop)."""
        img = None
        for _ in range(frames):
            img = self.render()
        return img

    # -- physics query (Eval_Distance_To, madarch-renderers.adb:499-526) --
    def eval_distance_to(self, position,
                         prims: Optional[Sequence[PrimitiveType]] = None):
        """Distance and normal of the closest primitive among ``prims``
        (all types if None) to a world position.  Used by the ball_game CPU
        physics loop; jit-cached per type subset."""
        from madarch_tpu.scene.scene import scene_sdf, scene_sdf_info
        from madarch_tpu.render.raymarch import scene_normal

        names = (tuple(p.name for p in prims) if prims is not None
                 else tuple(pt.name for pt, _ in self.spec.prims))
        data = self.scene_data
        pos = jnp.asarray(position, jnp.float32)[None]

        cache = getattr(self, "_eval_cache", None)
        if cache is None:
            cache = self._eval_cache = {}
        q = cache.get(names)
        if q is None:
            sub_spec = SceneSpec(
                prims=tuple((pt, c) for pt, c in self.spec.prims
                            if pt.name in names),
                lights=self.spec.lights, max_dist=self.spec.max_dist,
                max_materials=self.spec.max_materials)

            @jax.jit
            def q(data, pos):
                sdf_b = jax.vmap(lambda p: scene_sdf(sub_spec, data, p))
                dist = sdf_b(pos)
                normal = scene_normal(sdf_b, pos)
                return dist[0], normal[0]

            cache[names] = q

        dist, normal = q(data, pos)
        return float(dist), np.asarray(normal)
