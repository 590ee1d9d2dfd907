"""Static configuration dataclasses.

The reference's three config layers (typed settings records, GLSL macro
injection at shader load, gpr build switches —
/root/reference/madarch/madarch-renderers.ads:23-44,
madarch-renderers.adb:109-143) collapse into frozen dataclasses that are
hashable and flow into ``jax.jit`` as static arguments, so XLA specializes
the compiled passes exactly like the macro-specialized shaders.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ProbeSettings:
    """DDGI probe configuration (madarch-renderers.ads:23-31 defaults)."""

    radiance_resolution: int = 32
    irradiance_resolution: int = 8
    probe_count: Tuple[int, int] = (6, 6)           # atlas tiles (x, y)
    grid_dimensions: Tuple[int, int, int] = (4, 3, 3)
    grid_spacing: Tuple[float, float, float] = (2.0, 3.0, 3.0)

    @property
    def num_probes(self) -> int:
        gx, gy, gz = self.grid_dimensions
        return gx * gy * gz

    @property
    def radiance_atlas_shape(self):
        px, py = self.probe_count
        r = self.radiance_resolution
        return (py * r, px * r, 3)

    @property
    def irradiance_atlas_shape(self):
        px, py = self.probe_count
        r = self.irradiance_resolution
        return (py * r, px * r, 3)


@dataclasses.dataclass(frozen=True)
class VolumetricsSettings:
    """Light-shaft configuration (madarch-renderers.ads:33-44 defaults)."""

    enabled: bool = True
    visibility_resolution: Tuple[int, int, int] = (100, 100, 100)
    visibility_step_size: float = 0.1
    scattering_resolution: Tuple[int, int] = (250, 250)
    scattering_step_size: float = 0.1

    @property
    def max_depth(self) -> float:
        return self.visibility_step_size * self.visibility_resolution[2]


NO_VOLUMETRICS = VolumetricsSettings(enabled=False)


@dataclasses.dataclass(frozen=True)
class PartitioningSettings:
    """Uniform-grid space partitioning (madarch-scenes.ads:28-43 defaults).

    ``border_behavior``: 'clamp' clamps out-of-grid lookups to the border
    cell; 'fallback' falls back to the full-scene loop outside the grid
    (Partitioning_Border_Behavior, madarch-scenes.adb:799-837).
    """

    index_count: int = 20                     # K candidates per cell
    border_behavior: str = "clamp"            # 'clamp' | 'fallback'
    grid_dimensions: Tuple[int, int, int] = (10, 10, 20)
    grid_spacing: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    grid_offset: Tuple[float, float, float] = (-1.5, -1.5, -10.0)

    @property
    def num_cells(self) -> int:
        nx, ny, nz = self.grid_dimensions
        return nx * ny * nz

    @property
    def cell_diag(self) -> float:
        return float(np.linalg.norm(self.grid_spacing))



@dataclasses.dataclass(frozen=True)
class ShadeConfig:
    """Per-pass shading flags — the reference's M_* macro set
    (madarch-renderers.adb:109-143)."""

    direct_specular: bool = True        # M_COMPUTE_DIRECT_SPECULAR
    indirect_specular_mode: int = 2     # M_COMPUTE_INDIRECT_SPECULAR (0/1/2/3)
    add_indirect_specular: bool = True  # M_ADD_INDIRECT_SPECULAR
    ambient_occlusion_steps: int = 3    # M_AMBIENT_OCCLUSION_STEPS
    render_volumetrics: bool = False    # M_RENDER_VOLUMETRICS
    max_march_steps: int = 300
    # Differentiable shading: re-attach hit-point gradients through the
    # implicit function theorem and compute normals as autodiff SDF
    # gradients.  Off by default — the reference renderer is not
    # differentiable at all, so plain rendering skips the reattachment and
    # training opts in.
    differentiable: bool = False


# Pass-specific configs as wired by Renderers.Create: the probe-radiance pass
# shades without specular, AO, or volumetrics (madarch-renderers.adb:116-117;
# undefined macros read as 0 in GLSL).
PROBE_SHADE_CONFIG = ShadeConfig(
    direct_specular=False,
    indirect_specular_mode=0,
    add_indirect_specular=False,
    ambient_occlusion_steps=0,
    render_volumetrics=False,
)


def screen_shade_config(volumetrics_enabled: bool,
                        max_march_steps: int = 300,
                        differentiable: bool = False) -> ShadeConfig:
    """Screen-pass macro set (madarch-renderers.adb:137-143)."""
    return ShadeConfig(
        direct_specular=True,
        indirect_specular_mode=2,
        add_indirect_specular=True,
        ambient_occlusion_steps=3,
        render_volumetrics=volumetrics_enabled,
        max_march_steps=max_march_steps,
        differentiable=differentiable,
    )
