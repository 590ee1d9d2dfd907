"""The XLA marches (raycast, raycast_visibility, softshadows) against
independent float64 references.

Reference hits are closed-form ray-sphere, ray-plane and ray-box (slab)
intersections and Möller–Trumbore for triangles, computed in numpy float64;
the soft-shadow reference samples a float64 numpy scene SDF densely along
each ray.  Nothing here calls the code under test to build its expectation.

Scenes: a 14-slot mixed scene (spheres/planes/boxes with dynamic live
counts), a ~40-slot specialized scene, and a bounded triangle-only scene.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from madarch_tpu.core.vecmath import EPSILON
from madarch_tpu.render import context
from madarch_tpu.render import raymarch as rm
from madarch_tpu.scene import lights as L
from madarch_tpu.scene import primitives as P
from madarch_tpu.scene.scene import SceneBuilder, SceneSpec, scene_sdf

MAX_DIST = 20.0


# ---------------------------------------------------------------------------
# Scenes: one description feeds both the SceneBuilder and the references.
# ---------------------------------------------------------------------------

def _mixed14():
    geo = {"sphere": [((0.0, 0.0, 5.0), 1.0), ((2.0, 1.0, 7.0), 0.7)],
           "plane": [((0.0, 1.0, 0.0), 1.0)],
           "box": [((-2.0, 0.0, 6.0), (1.0, 1.0, 1.0))],
           "triangle": []}
    spec = SceneSpec(prims=((P.Sphere, 4), (P.Plane, 6), (P.Box, 4)),
                     lights=((L.PointLight, 1),), max_dist=MAX_DIST)
    return spec, geo, _random_rays


def _forty():
    rng = np.random.RandomState(17)
    spheres = [(tuple(rng.uniform([-4, 0, 4], [4, 3, 10])),
                float(rng.uniform(0.3, 0.6))) for _ in range(16)]
    boxes = [(tuple(rng.uniform([-4, 0, 4], [4, 3, 10])),
              tuple(rng.uniform(0.2, 0.5, 3))) for _ in range(10)]
    geo = {"sphere": spheres,
           "plane": [((0.0, 1.0, 0.0), 1.0), ((0.0, 0.0, -1.0), 12.0)],
           "box": boxes, "triangle": []}
    spec = SceneSpec(prims=((P.Sphere, 20), (P.Box, 14), (P.Plane, 6)),
                     lights=((L.PointLight, 1),), max_dist=MAX_DIST)
    spec = spec.specialized({"sphere": 16, "box": 10, "plane": 2},
                            {"point_light": 1})
    return spec, geo, _random_rays


def _triangles():
    rng = np.random.RandomState(5)
    tris = []
    for _ in range(40):
        c = rng.uniform(-1.5, 1.5, 3) + np.array([0.0, 1.0, 5.0])
        tris.append(c + rng.uniform(-0.5, 0.5, (3, 3)))
    geo = {"sphere": [], "plane": [], "box": [], "triangle": tris}
    spec = SceneSpec(prims=((P.Triangle, 40),),
                     lights=((L.PointLight, 1),), max_dist=MAX_DIST)
    spec = spec.specialized({"triangle": 40}, {"point_light": 1})
    return spec, geo, _cloud_rays


def _random_rays(n, seed):
    """Origins in a box above the floor, clear of all geometry."""
    rng = np.random.RandomState(seed)
    origins = rng.uniform(-1, 1, (n, 3))
    origins[:, 1] += 1.0
    dirs = rng.randn(n, 3)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return origins, dirs


def _cloud_rays(n, seed):
    """Rays from ~6 units out aimed into the triangle cloud."""
    rng = np.random.RandomState(seed)
    origins = rng.uniform(-0.5, 0.5, (n, 3))
    origins[:, 2] -= 1.0
    targets = rng.uniform(-1.0, 1.0, (n, 3)) + np.array([0.0, 1.0, 5.0])
    dirs = targets - origins
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return origins, dirs


SCENES = {"mixed14": _mixed14, "forty": _forty, "triangles": _triangles}


def _build(name):
    spec, geo, rays = SCENES[name]()
    b = SceneBuilder(spec)
    b.add_material((0.5, 0.5, 0.5), 0.0, 0.5)
    for c, r in geo["sphere"]:
        b.add_primitive(P.Sphere, center=c, radius=r, material_id=0)
    for n, off in geo["plane"]:
        b.add_primitive(P.Plane, normal=n, offset=off, material_id=0)
    for c, s in geo["box"]:
        b.add_primitive(P.Box, center=c, side=s, material_id=0)
    for v in geo["triangle"]:
        b.add_primitive(P.Triangle, v1=v[0], v2=v[1], v3=v[2],
                        material_id=0)
    b.add_light(L.PointLight, position=(0.0, 5.0, 3.0), color=(1.0,) * 3)
    data = b.device_data()
    sdf_b = jax.vmap(lambda p: scene_sdf(spec, data, p))
    return spec, data, sdf_b, geo, rays


@pytest.fixture(scope="module", params=sorted(SCENES))
def scene(request):
    return _build(request.param)


# ---------------------------------------------------------------------------
# float64 references
# ---------------------------------------------------------------------------

def _dot(a, b):
    return np.sum(a * b, axis=-1)


def reference_hits(geo, o, d):
    """First intersection t (inf on miss) and |cos| between the ray and the
    surface normal there, per ray, in float64."""
    best_t = np.full(len(o), np.inf)
    best_cos = np.ones(len(o))

    def keep(t, normal):
        nonlocal best_t, best_cos
        t = np.where(t > 1e-9, t, np.inf)
        better = t < best_t
        cos = np.abs(_dot(normal, d)) / np.maximum(
            np.linalg.norm(normal, axis=-1), 1e-300)
        best_t = np.where(better, t, best_t)
        best_cos = np.where(better, cos, best_cos)

    with np.errstate(divide="ignore", invalid="ignore"):
        for c, r in geo["sphere"]:
            oc = o - np.asarray(c)
            b = _dot(oc, d)
            disc = b * b - (_dot(oc, oc) - r * r)
            t = np.where(disc >= 0, -b - np.sqrt(np.maximum(disc, 0)),
                         np.inf)
            keep(t, o + t[:, None] * d - np.asarray(c))
        for n, off in geo["plane"]:
            n = np.asarray(n)
            t = -(_dot(o, n) + off) / _dot(d, n)
            keep(t, np.broadcast_to(n, o.shape))
        for c, s in geo["box"]:
            lo = np.asarray(c) - np.asarray(s)
            hi = np.asarray(c) + np.asarray(s)
            t1 = (lo - o) / d
            t2 = (hi - o) / d
            near = np.minimum(t1, t2)
            tmin = near.max(axis=1)
            tmax = np.maximum(t1, t2).min(axis=1)
            t = np.where((tmax >= tmin) & (tmin > 0), tmin, np.inf)
            normal = np.eye(3)[near.argmax(axis=1)]
            keep(t, normal)
        for v in geo["triangle"]:
            e1, e2 = v[1] - v[0], v[2] - v[0]
            pvec = np.cross(d, e2)
            det = _dot(pvec, np.broadcast_to(e1, o.shape))
            inv = 1.0 / det
            tvec = o - v[0]
            u = _dot(tvec, pvec) * inv
            qvec = np.cross(tvec, e1)
            w = _dot(d, qvec) * inv
            t = _dot(qvec, np.broadcast_to(e2, o.shape)) * inv
            ok = (np.abs(det) > 1e-12) & (u >= 0) & (w >= 0) & (u + w <= 1)
            keep(np.where(ok, t, np.inf),
                 np.broadcast_to(np.cross(e1, e2), o.shape))
    return best_t, best_cos


def reference_sdf(geo, p):
    """Scene distance in float64 (min over primitives, capped)."""
    dist = np.full(p.shape[:-1], MAX_DIST)
    for c, r in geo["sphere"]:
        dist = np.minimum(dist, np.linalg.norm(p - np.asarray(c), axis=-1)
                          - r)
    for n, off in geo["plane"]:
        dist = np.minimum(dist, _dot(p, np.asarray(n)) + off)
    for c, s in geo["box"]:
        q = np.abs(p - np.asarray(c)) - np.asarray(s)
        dist = np.minimum(dist, np.linalg.norm(np.maximum(q, 0), axis=-1)
                          + np.minimum(q.max(axis=-1), 0))
    for v in geo["triangle"]:
        dist = np.minimum(dist, _triangle_dist(v, p))
    return dist


def _triangle_dist(v, p):
    """Exact point-triangle distance: face-plane distance when the
    projection falls inside, else the nearest edge segment."""
    a, b, c = v
    nrm = np.cross(b - a, c - a)
    nrm = nrm / np.linalg.norm(nrm)
    h = _dot(p - a, nrm)
    proj = p - h[..., None] * nrm

    def side(x, y):
        return _dot(np.cross(y - x, proj - x), nrm)

    inside = (side(a, b) >= 0) & (side(b, c) >= 0) & (side(c, a) >= 0)

    def seg(x, y):
        e = y - x
        t = np.clip(_dot(p - x, e) / _dot(e, e), 0.0, 1.0)
        return np.linalg.norm(p - (x + t[..., None] * e), axis=-1)

    edge = np.minimum(np.minimum(seg(a, b), seg(b, c)), seg(c, a))
    return np.where(inside, np.abs(h), edge)


def _f32(x):
    return jnp.asarray(x, jnp.float32)


# ---------------------------------------------------------------------------
# raycast
# ---------------------------------------------------------------------------

def test_raycast_matches_analytic(scene):
    spec, data, sdf_b, geo, rays = scene
    o, d = rays(256, seed=1)
    t_ref, cos = reference_hits(geo, o, d)
    t, hit, pos = jax.jit(lambda a, b: rm.raycast(sdf_b, a, b, MAX_DIST))(
        _f32(o), _f32(d))
    t, hit = np.asarray(t), np.asarray(hit)
    ref_hit = t_ref < MAX_DIST
    assert ref_hit.sum() > 20 and (~ref_hit).sum() > 0
    # every clear (non-grazing) reference hit is found at the right depth:
    # the march stops within EPSILON of the surface along the normal
    clear = ref_hit & (cos > 0.2) & (t_ref < MAX_DIST - 0.1)
    assert clear.sum() > 20
    assert hit[clear].all()
    np.testing.assert_allclose(t[clear], t_ref[clear],
                               atol=EPSILON / 0.2 + 1e-3)
    # grazing rays may pass within EPSILON of a surface and register a hit
    # that the exact test misses (or the reverse): a small share only
    assert (hit == ref_hit).mean() >= 0.97
    assert np.isfinite(np.asarray(pos)).all()


def test_raycast_omega_one_gives_same_hits(scene):
    """Over-relaxation (ω = 1.6, the default) only changes the step count:
    the reference's plain march (ω = 1) finds the same hits."""
    spec, data, sdf_b, geo, rays = scene
    o, d = _f32(rays(256, seed=2)[0]), _f32(rays(256, seed=2)[1])
    t_r, hit_r, _ = rm.raycast(sdf_b, o, d, MAX_DIST)
    t_1, hit_1, _ = rm.raycast(sdf_b, o, d, MAX_DIST, omega=1.0)
    hit_r, hit_1 = np.asarray(hit_r), np.asarray(hit_1)
    assert (hit_r == hit_1).mean() >= 0.99
    both = hit_r & hit_1
    np.testing.assert_allclose(np.asarray(t_r)[both], np.asarray(t_1)[both],
                               atol=0.02)


def test_raycast_enabled_mask(scene):
    spec, data, sdf_b, geo, rays = scene
    o, d = rays(128, seed=3)
    o, d = _f32(o), _f32(d)
    enabled = np.random.RandomState(4).rand(128) > 0.5
    t_all, hit_all, _ = rm.raycast(sdf_b, o, d, MAX_DIST)
    t_m, hit_m, _ = rm.raycast(sdf_b, o, d, MAX_DIST,
                               enabled=jnp.asarray(enabled))
    t_m, hit_m = np.asarray(t_m), np.asarray(hit_m)
    # disabled lanes never march and never hit
    assert not hit_m[~enabled].any()
    assert (t_m[~enabled] == 0.0).all()
    # enabled lanes are unaffected by their neighbours' masks
    np.testing.assert_array_equal(hit_m[enabled],
                                  np.asarray(hit_all)[enabled])
    np.testing.assert_allclose(t_m[enabled], np.asarray(t_all)[enabled],
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name", ["mixed14", "forty"])
def test_raycast_max_steps_cap(name):
    """One plain step advances exactly the origin's scene distance; zero
    steps leave every ray at its origin."""
    spec, data, sdf_b, geo, rays = _build(name)
    o, d = rays(64, seed=5)
    d0 = reference_sdf(geo, o)
    assert (d0 > EPSILON).all()
    t1, _, _ = rm.raycast(sdf_b, _f32(o), _f32(d), MAX_DIST, max_steps=1,
                          omega=1.0)
    np.testing.assert_allclose(np.asarray(t1), np.minimum(d0, MAX_DIST),
                               rtol=1e-5, atol=1e-5)
    t0, hit0, _ = rm.raycast(sdf_b, _f32(o), _f32(d), MAX_DIST, max_steps=0)
    assert (np.asarray(t0) == 0.0).all() and not np.asarray(hit0).any()


def test_scene_ctx_chunked_march_matches_dense(monkeypatch):
    """Many-slot scenes march through ray chunks (lax.map): same result
    as the unchunked closure."""
    monkeypatch.setattr(context, "GRID_CHUNK", 64)
    monkeypatch.setattr(context, "CHUNK_SLOT_THRESHOLD", 8)
    spec, data, sdf_b, geo, rays = _build("forty")
    ctx = context.SceneCtx(spec, data)
    o, d = rays(200, seed=6)  # not a multiple of the chunk: padded tail
    t_c, hit_c, _ = rm.raycast(ctx, _f32(o), _f32(d), MAX_DIST)
    t_d, hit_d, _ = rm.raycast(sdf_b, _f32(o), _f32(d), MAX_DIST)
    np.testing.assert_array_equal(np.asarray(hit_c), np.asarray(hit_d))
    np.testing.assert_allclose(np.asarray(t_c), np.asarray(t_d),
                               rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# visibility
# ---------------------------------------------------------------------------

def test_visibility_matches_analytic(scene):
    spec, data, sdf_b, geo, rays = scene
    o, d = rays(256, seed=7)
    max_d = np.random.RandomState(8).uniform(0.5, 15.0, 256)
    t_ref, cos = reference_hits(geo, o, d)
    vis = np.asarray(rm.raycast_visibility(sdf_b, _f32(o), _f32(d),
                                           _f32(max_d)))
    vis_ref = np.where(t_ref < max_d, 0.0, 1.0)
    assert (vis_ref == 0).sum() > 10 and (vis_ref == 1).sum() > 10
    # exact away from grazing rays and from hits at the budget's end
    clear = (np.abs(t_ref - max_d) > 0.05) & ((t_ref == np.inf)
                                               | (cos > 0.2))
    np.testing.assert_array_equal(vis[clear & (vis_ref == 0)], 0.0)
    assert (vis[clear] == vis_ref[clear]).mean() >= 0.98
    assert (vis == vis_ref).mean() >= 0.95


def test_visibility_enabled_mask(scene):
    """Disabled lanes report visible without marching."""
    spec, data, sdf_b, geo, rays = scene
    o, d = rays(128, seed=9)
    enabled = np.random.RandomState(10).rand(128) > 0.5
    max_d = np.full(128, 15.0)
    vis_all = np.asarray(rm.raycast_visibility(sdf_b, _f32(o), _f32(d),
                                               _f32(max_d)))
    vis_m = np.asarray(rm.raycast_visibility(
        sdf_b, _f32(o), _f32(d), _f32(max_d), enabled=jnp.asarray(enabled)))
    assert (vis_m[~enabled] == 1.0).all()
    np.testing.assert_array_equal(vis_m[enabled], vis_all[enabled])


# ---------------------------------------------------------------------------
# soft shadows
# ---------------------------------------------------------------------------

K = 8.0


def _dense_penumbra(geo, o, d, max_d, n=4000):
    """min over densely sampled t in (0, max_d) of k·sdf(p(t))/t, clipped
    to [0, 1] — the continuous quantity the penumbra march estimates."""
    ts = np.linspace(max_d / n, max_d, n)
    pts = o[:, None, :] + ts[None, :, None] * d[:, None, :]
    sd = reference_sdf(geo, pts)
    return np.clip((K * sd / ts[None, :]).min(axis=1), 0.0, 1.0)


def test_softshadows_match_reference(scene):
    spec, data, sdf_b, geo, rays = scene
    o, d = rays(192, seed=11)
    max_d = 10.0
    t_ref, cos = reference_hits(geo, o, d)
    s = np.asarray(rm.softshadows(sdf_b, _f32(o), _f32(d),
                                  jnp.zeros(192), jnp.full((192,), max_d),
                                  K))
    assert ((s >= 0.0) & (s <= 1.0)).all()
    blocked = (t_ref < max_d - 0.05) & (cos > 0.2)
    clear = t_ref > max_d + 0.05
    assert blocked.sum() > 10 and clear.sum() > 10
    # rays that hit geometry are fully shadowed
    np.testing.assert_array_equal(s[blocked], 0.0)
    # unobstructed rays follow the continuous penumbra
    ref = _dense_penumbra(geo, o[clear], d[clear], max_d)
    np.testing.assert_allclose(s[clear], ref, atol=0.1)
