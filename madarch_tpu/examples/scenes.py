"""The reference example scenes as Renderer builders.

Each function reproduces one of the reference's example programs
(/root/reference/examples/*/main.adb) — same primitives, materials, lights,
camera, and settings — returning a configured ``Renderer``.
"""
from __future__ import annotations

import numpy as np

from madarch_tpu.core.config import (NO_VOLUMETRICS, PartitioningSettings,
                                     ProbeSettings, VolumetricsSettings)
from madarch_tpu.render.renderer import Renderer
from madarch_tpu.scene import lights as L
from madarch_tpu.scene import primitives as P
from madarch_tpu.scene.scene import SceneSpec


def _room(r: Renderer, wall_mats):
    """The 6-plane room shared by several examples."""
    w1, w2, w3 = wall_mats
    for nrm, off, m in [((0.0, 1.0, 0.0), 1.0, w1),
                        ((0.0, -1.0, 0.0), 7.0, w1),
                        ((1.0, 0.0, 0.0), 1.0, w2),
                        ((-1.0, 0.0, 0.0), 7.0, w3),
                        ((0.0, 0.0, 1.0), 6.0, w1),
                        ((0.0, 0.0, -1.0), 7.0, w1)]:
        r.add_primitive(P.Plane, normal=nrm, offset=off, material_id=m)


def simple_scene(width=1000, height=1000, **kwargs) -> Renderer:
    """examples/simple_scene/main.adb: sphere grid + boxes + point light."""
    spec = SceneSpec(prims=((P.Sphere, 20), (P.Plane, 10), (P.Box, 20)),
                     lights=((L.PointLight, 4),))
    r = Renderer(spec, width, height, volumetrics=NO_VOLUMETRICS, **kwargs)
    r.set_material(0, (0.0, 0.0, 0.0), 0.0, 0.6)
    r.set_material(1, (1.0, 0.0, 0.0), 0.0, 0.6)
    r.set_material(2, (0.0, 0.0, 1.0), 0.0, 0.6)
    r.set_material(3, (0.1, 0.1, 0.1), 0.9, 0.1)
    _room(r, (0, 1, 2))
    sphere_centers = ([(0.5 + i, 3.5, 2.0) for i in range(6)]
                     + [(0.5 + i, 0.5, 2.0) for i in range(6)]
                     + [(0.5 + i, 3.5, 5.0) for i in range(6)]
                     + [(0.5, 0.5, 5.0), (1.5, 0.5, 5.0)])
    for c in sphere_centers:
        r.add_primitive(P.Sphere, center=c, radius=0.5, material_id=3)
    boxes = [((3.0, 1.0, 2.0), (0.5, 0.5, 0.5)),
             ((0.0, 1.0, 2.0), (0.3, 0.3, 0.5)),
             ((3.0, 1.0, 4.0), (0.5, 0.5, 0.5)),
             ((4.0, 2.0, 2.0), (0.5, 0.5, 0.5)),
             ((2.0, 2.0, 2.0), (0.5, 0.5, 0.5)),
             ((1.0, 1.0, 6.0), (0.5, 0.5, 0.5)),
             ((3.0, 1.0, 6.0), (0.5, 0.5, 0.5)),
             ((3.0, 1.0, -2.0), (0.5, 0.5, 0.5)),
             ((1.0, 1.0, -2.0), (0.3, 0.3, 0.5)),
             ((3.0, 1.0, -4.0), (0.5, 0.5, 0.5)),
             ((4.0, 2.0, -2.0), (0.5, 0.5, 0.5)),
             ((2.0, 2.0, -2.0), (0.5, 0.5, 0.5)),
             ((1.0, 1.0, -6.0), (0.5, 0.5, 0.5)),
             ((3.0, 1.0, -6.0), (0.5, 0.5, 0.5))]
    for c, s in boxes:
        r.add_primitive(P.Box, center=c, side=s, material_id=2)
    r.add_light(L.PointLight, position=(0.0, 3.0, 0.0),
                color=(0.9, 0.9, 0.9))
    r.set_camera_position((2.0, 2.0, 0.0))
    return r


def global_illumination(width=1000, height=1000, time: float = 0.0,
                        **kwargs) -> Renderer:
    """examples/global_illumination/main.adb: the DDGI showcase — room with
    mirror sphere, metallic green box, animated spot light."""
    spec = SceneSpec(prims=((P.Sphere, 20), (P.Plane, 10), (P.Box, 10)),
                     lights=((L.SpotLight, 4),))
    r = Renderer(spec, width, height, volumetrics=NO_VOLUMETRICS, **kwargs)
    wall1 = r.add_material((0.0, 0.0, 0.0), 0.0, 0.6)
    wall2 = r.add_material((1.0, 0.0, 0.0), 0.0, 0.6)
    wall3 = r.add_material((0.0, 0.0, 1.0), 0.0, 0.6)
    sphere_m = r.add_material((0.1, 0.1, 0.1), 0.9, 0.1)
    box_m = r.add_material((0.0, 1.0, 0.0), 0.8, 0.3)
    _room(r, (wall1, wall2, wall3))
    r.add_primitive(P.Sphere, center=(3.0, 4.0, 3.0), radius=1.0,
                    material_id=sphere_m)
    r.add_primitive(P.Box, center=(3.0, 0.0, 4.0), side=(1.5, 1.5, 1.5),
                    material_id=box_m)
    r.add_light(L.SpotLight, position=(3.5, 5.0, 2.0),
                direction=(np.cos(time), np.sin(time), 0.0),
                aperture=3.1415 / 4.0, color=(0.9, 0.9, 0.8))
    r.set_camera_position((2.0, 2.0, 0.0))
    return r


def light_shafts(width=1000, height=1000, **kwargs) -> Renderer:
    """examples/light_shafts/main.adb: the room with fully-rough matte
    materials (black walls, red +x, GREEN -x), a blue sphere, a green box,
    a white point light at (5,3,6), and volumetrics enabled
    (main.adb:41-60,146-153)."""
    spec = SceneSpec(prims=((P.Sphere, 20), (P.Plane, 10), (P.Box, 10)),
                     lights=((L.PointLight, 4),))
    r = Renderer(spec, width, height,
                 volumetrics=kwargs.pop("volumetrics",
                                        VolumetricsSettings()), **kwargs)
    r.set_material(0, (0.0, 0.0, 0.0), 0.0, 1.0)
    r.set_material(1, (1.0, 0.0, 0.0), 0.0, 1.0)
    r.set_material(2, (0.0, 1.0, 0.0), 0.0, 1.0)
    r.set_material(3, (0.0, 0.0, 1.0), 0.0, 1.0)
    _room(r, (0, 1, 2))
    r.add_primitive(P.Sphere, center=(3.0, 4.0, 3.0), radius=1.0,
                    material_id=3)
    r.add_primitive(P.Box, center=(3.0, 0.0, 4.0), side=(1.5, 1.5, 1.5),
                    material_id=2)
    r.add_light(L.PointLight, position=(5.0, 3.0, 6.0),
                color=(0.9, 0.9, 0.9))
    r.set_camera_position((2.0, 2.0, 0.0))
    return r


def obj_mesh(width=1000, height=1000, obj_path=None, triangle_capacity=1000,
             partition_method="gpu_fast", mode="exact",
             bake_dims=(48, 48, 48), **kwargs) -> Renderer:
    """examples/obj_mesh/main.adb: suzanne.obj with a fine 30×20×20 × 0.1
    partitioning grid.

    ``mode="exact"`` (default): 968 exact Triangle primitives, evaluated
    densely per march step in ray chunks (render/context.py).
    ``mode="baked"``: the mesh baked into a dense distance map sampled
    trilinearly — the reference's distance-map path
    (meshes-distance_maps.adb:158-301 + scene_custom.glsl sampling).
    """
    from madarch_tpu.scene.mesh import add_mesh_to_renderer
    from madarch_tpu.native import load_obj

    if obj_path is None:
        obj_path = "/root/reference/media/suzanne.obj"
    mesh = load_obj(obj_path)
    offset = (1.5, 1.0, 1.0)

    if mode == "baked":
        from madarch_tpu.scene.baked_sdf import make_baked_sdf_primitive
        from madarch_tpu.scene.mesh import bake_distance_map

        lo, hi = mesh.bounding_box()
        margin = 0.1 * float(np.max(hi - lo))
        lo = lo - margin
        hi = hi + margin
        dist, _ = bake_distance_map(mesh, bake_dims, lo, hi)
        baked = make_baked_sdf_primitive("suzanne_sdf", dist, lo, hi)
        spec = SceneSpec(prims=((baked, 1),), lights=((L.PointLight, 4),))
        probes = kwargs.pop("probes", ProbeSettings(
            radiance_resolution=8, irradiance_resolution=4,
            probe_count=(6, 6), grid_dimensions=(3, 3, 4),
            grid_spacing=(2.0, 3.0, 3.0)))
        r = Renderer(spec, width, height, probes=probes,
                     volumetrics=NO_VOLUMETRICS, **kwargs)
        mesh_mat = r.add_material((0.8, 0.2, 0.1), 0.0, 1.0)
        r.add_primitive(baked, position=offset, material_id=mesh_mat)
        r.add_light(L.PointLight, position=(0.0, 1.0, -5.0),
                    color=(0.9, 0.9, 0.9))
        r.set_camera_position((0.0, 1.0, -5.0))
        return r

    spec = SceneSpec(
        prims=((P.Triangle, triangle_capacity),),
        lights=((L.PointLight, 4),),
        partitioning=PartitioningSettings(
            index_count=150, border_behavior="clamp",
            grid_dimensions=(30, 20, 20),
            grid_spacing=(0.1, 0.1, 0.1),
            grid_offset=(0.0, 0.0, 0.0)))
    probes = kwargs.pop("probes", ProbeSettings(
        radiance_resolution=32, irradiance_resolution=8,
        probe_count=(6, 6), grid_dimensions=(3, 3, 4),
        grid_spacing=(2.0, 3.0, 3.0)))
    r = Renderer(spec, width, height, probes=probes,
                 volumetrics=NO_VOLUMETRICS, **kwargs)
    mesh_mat = r.add_material((0.8, 0.2, 0.1), 0.0, 1.0)
    add_mesh_to_renderer(r, mesh, mesh_mat, offset=offset)
    r.add_light(L.PointLight, position=(0.0, 1.0, -5.0),
                color=(0.9, 0.9, 0.9))
    r.set_camera_position((0.0, 1.0, -5.0))
    r.update_partitioning(partition_method)
    return r


def ball_game(width=1000, height=1000, **kwargs):
    """examples/ball_game/main.adb: the GI room plus dynamically thrown
    balls with CPU physics driven by eval_distance_to.  Returns
    (renderer, step_physics, throw_ball)."""
    spec = SceneSpec(prims=((P.Sphere, 20), (P.Plane, 10), (P.Box, 10)),
                     lights=((L.SpotLight, 4),))
    # count-dynamic: throwing a ball must NOT recompile the pipeline (the
    # reference writes the new count into the UBO and keeps its shaders,
    # madarch-renderers.adb:454-455); slot loops mask by live count
    kwargs.setdefault("specialize_counts", False)
    r = Renderer(spec, width, height, volumetrics=NO_VOLUMETRICS, **kwargs)
    wall1 = r.add_material((0.0, 0.0, 0.0), 0.0, 0.6)
    wall2 = r.add_material((1.0, 0.0, 0.0), 0.0, 0.6)
    wall3 = r.add_material((0.0, 0.0, 1.0), 0.0, 0.6)
    ball_m = r.add_material((0.1, 0.1, 0.1), 0.9, 0.1)
    box_m = r.add_material((0.0, 1.0, 0.0), 0.8, 0.3)
    _room(r, (wall1, wall2, wall3))
    r.add_primitive(P.Box, center=(3.0, 0.0, 4.0), side=(1.5, 1.5, 1.5),
                    material_id=box_m)
    r.add_light(L.SpotLight, position=(3.5, 5.0, 2.0),
                direction=(1.0, 0.0, 0.0), aperture=3.1415 / 4.0,
                color=(0.9, 0.9, 0.8))
    r.set_camera_position((2.0, 2.0, 0.0))

    balls = []  # list of dicts: index, pos, vel, radius

    def throw_ball(origin, velocity, radius=0.3):
        idx = r.add_primitive(P.Sphere, center=tuple(origin), radius=radius,
                              material_id=ball_m)
        balls.append({"index": idx, "pos": np.asarray(origin, np.float32),
                      "vel": np.asarray(velocity, np.float32),
                      "radius": radius})
        return idx

    def step_physics(dt=0.016, gravity=(0.0, -9.8, 0.0), restitution=0.8):
        """Gravity integration + collision with planes/boxes via
        Eval_Distance_To, reflect bounce (ball_game/main.adb:190-221)."""
        for ball in balls:
            ball["vel"] = ball["vel"] + np.asarray(gravity) * dt
            new_pos = ball["pos"] + ball["vel"] * dt
            dist, normal = r.eval_distance_to(new_pos,
                                              prims=[P.Plane, P.Box])
            if dist < ball["radius"]:
                vn = float(np.dot(ball["vel"], normal))
                if vn < 0.0:
                    ball["vel"] = (ball["vel"] - 2.0 * vn * normal) \
                        * restitution
                new_pos = ball["pos"] + ball["vel"] * dt
            ball["pos"] = new_pos
            r.set_primitive(P.Sphere, ball["index"],
                            center=tuple(ball["pos"]))

    return r, step_physics, throw_ball


def bvh_test(width=1000, height=1000, n_spheres=16, seed=7,
             **kwargs) -> Renderer:
    """examples/bvh_test/main.adb: a SAH BVH over random spheres compiled
    into a single BVH primitive's distance function (with the 0.2-threshold
    early-out box stand-ins), exercising the tree-to-computation compile."""
    from madarch_tpu.scene.bvh import build_bvh, make_bvh_primitive
    import jax.numpy as jnp

    rng = np.random.RandomState(seed)
    centers = rng.uniform(0.5, 5.5, (n_spheres, 3)).astype(np.float32)
    radius = 0.4
    boxes = [(c - radius, c + radius) for c in centers]
    tree = build_bvh(boxes)
    leaf_sdfs = [
        (lambda p, cc=jnp.asarray(c): jnp.linalg.norm(p - cc, axis=-1)
         - radius)
        for c in centers]
    bvh_prim = make_bvh_primitive("bvh_scene", tree, leaf_sdfs)

    spec = SceneSpec(prims=((bvh_prim, 1), (P.Plane, 6)),
                     lights=((L.PointLight, 2),))
    r = Renderer(spec, width, height, volumetrics=NO_VOLUMETRICS, **kwargs)
    wall = r.add_material((0.4, 0.4, 0.4), 0.0, 0.6)
    ball = r.add_material((0.8, 0.3, 0.1), 0.2, 0.4)
    _room(r, (wall, wall, wall))
    r.add_primitive(bvh_prim, position=(0.0, 0.0, 0.0), material_id=ball)
    r.add_light(L.PointLight, position=(3.0, 5.0, 1.0),
                color=(0.9, 0.9, 0.9))
    r.set_camera_position((3.0, 3.0, -3.0))
    return r
