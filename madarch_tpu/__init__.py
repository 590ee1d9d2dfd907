"""madarch_tpu — a differentiable sphere-tracing renderer in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of Roldak/Madarch
(real-time ray marching with DDGI global illumination, PBR materials, soft
shadows, ambient occlusion, volumetric lighting, triangle meshes with spatial
partitioning), built for accelerator arrays: batched masked ray-march loops,
struct-of-arrays scenes with static shapes, autodiff end-to-end, and SPMD
scaling over device meshes.
"""

__version__ = "0.1.0"
