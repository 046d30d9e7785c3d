"""Batched ray-scene intersection (brute force, all primitive types).

The port of the JAX package's brute-force intersectors (reference
source/surface/{triangle,sphere,quadric}.cpp): rays are a batch (R,),
primitives are SoA tables, and each type is intersected as one dense (R x N)
computation with a masked argmin. The cluster-BVH path for triangles lives in
ops/cluster_bvh.py; both funnel their triangle winner through refine_tri_hit.

Hit encoding: surf_id == -1 means miss; uv are barycentric (triangles only).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..scene.loader import SceneMeta, SceneTables
from . import geometry as g


class Hit(NamedTuple):
    t: torch.Tensor        # (R,)
    surf_id: torch.Tensor  # (R,) int32, -1 = miss
    uv: torch.Tensor       # (R, 2) triangle barycentrics
    steps: torch.Tensor | None = None  # (2,) BVH [candidates, rounds] (None: brute)


def _big(dtype):
    return torch.finfo(dtype).max


def _long(x):
    return x.to(torch.int64)


def intersect_tris_block(origin, direction, v0, e1, e2, eps):
    """Moller-Trumbore for (R,) rays x (T,) triangles -> (t (R,T), u, v, valid).

    Mirrors the reference's test (triangle.cpp:23-63): parallel-determinant
    rejection at |det| < eps, u,v in [0,1], u+v <= 1, t > 0.
    """
    d = direction[:, None, :]
    o = origin[:, None, :]
    p = torch.linalg.cross(d.expand(-1, e2.shape[0], -1), e2[None].expand(d.shape[0], -1, -1))
    det = (p * e1[None, :, :]).sum(-1)
    parallel = torch.abs(det) < eps
    inv_det = 1.0 / torch.where(parallel, torch.ones_like(det), det)
    tvec = o - v0[None, :, :]
    u = (p * tvec).sum(-1) * inv_det
    q = torch.linalg.cross(tvec, e1[None].expand_as(tvec))
    v = (q * d).sum(-1) * inv_det
    t = (q * e2[None, :, :]).sum(-1) * inv_det
    valid = (
        ~parallel
        & (u >= 0.0) & (u <= 1.0)
        & (v >= 0.0) & (v <= 1.0)
        & (u + v <= 1.0)
        & (t > 0.0)
    )
    return t, u, v, valid


def build_geo_pack(tables):
    """(n_tris, 9) packed [v0|e1|e2] for refine_tri_hit's row gather."""
    return torch.cat([tables.tri_v0, tables.tri_e1, tables.tri_e2], dim=1)


def refine_tri_hit(tables: SceneTables, meta: SceneMeta, origin, direction, t, surf_id, uv,
                   geo=None):
    """Recompute (t, u, v) of the winning triangle with one exact Moller-Trumbore.

    Both intersection paths (brute block and cluster-BVH forms) funnel their
    triangle winner through this single gathered-triangle evaluation, so the
    final hit values are identical whichever path found the winner."""
    if not meta.n_tris:
        return t, uv
    sid = torch.clamp(surf_id, min=0)
    is_tri = (surf_id >= 0) & (sid < meta.sphere_offset)
    tid = _long(torch.clamp(sid, 0, meta.n_tris - 1))
    if geo is None:
        geo = build_geo_pack(tables)
    grow = geo[tid]
    v0 = grow[:, 0:3]
    e1 = grow[:, 3:6]
    e2 = grow[:, 6:9]
    p = torch.linalg.cross(direction, e2)
    det = (p * e1).sum(-1)
    inv_det = 1.0 / torch.where(det == 0.0, torch.ones_like(det), det)
    tvec = origin - v0
    u = (p * tvec).sum(-1) * inv_det
    q = torch.linalg.cross(tvec, e1)
    v = (q * direction).sum(-1) * inv_det
    tt = (q * e2).sum(-1) * inv_det
    t_out = torch.where(is_tri, tt, t)
    uv_out = torch.where(is_tri[:, None], torch.stack([u, v], dim=-1), uv)
    return t_out, uv_out


def intersect_spheres_block(origin, direction, centers, radii):
    """(R,) rays x (S,) spheres -> (t (R,S), valid).

    The cancellation-free vector-rejection form of the reference's quadratic
    (sphere.cpp:13-26): the perpendicular distance comes from the rejection
    vector, which stays accurate in f32."""
    so = centers[None, :, :] - origin[:, None, :]          # ray origin -> center
    t_ca = (direction[:, None, :] * so).sum(-1)            # closest approach
    perp = so - t_ca[..., None] * direction[:, None, :]
    d2 = (perp * perp).sum(-1)
    r2 = radii[None, :] ** 2
    hit = d2 <= r2
    t_hc = torch.sqrt(torch.where(hit, torch.clamp(r2 - d2, min=1e-30), torch.ones_like(d2)))
    t_min = t_ca - t_hc
    t_max = t_ca + t_hc
    valid = hit & (t_max >= 0.0)
    t = torch.where(t_min < 0.0, t_max, t_min)
    return t, valid


def refine_positions(tables: SceneTables, meta: SceneMeta, surf_id, position):
    """Snap hit points exactly onto analytic surfaces (spheres) to kill the f32
    along-ray error accumulated in position = o + t*d."""
    if not meta.n_sphs:
        return position
    sid = torch.clamp(surf_id, min=0)
    sph_id = _long(torch.clamp(sid - meta.sphere_offset, 0, max(meta.n_sphs - 1, 0)))
    center = tables.sph_origin[sph_id]
    radius = tables.sph_radius[sph_id][:, None]
    on_sphere = center + g.normalize(position - center) * radius
    is_sph = (sid >= meta.sphere_offset) & (sid < meta.quad_offset)
    return torch.where(is_sph[:, None], on_sphere, position)


def _slab_entry(origin, direction, bb_min, bb_max):
    """Ray-AABB slab test for (R,) rays x (Q,) boxes -> (hit, t_entry>=0)."""
    inv_d = 1.0 / direction
    o = origin[:, None, :]
    inv = inv_d[:, None, :]
    t1 = (bb_min[None, :, :] - o) * inv
    t2 = (bb_max[None, :, :] - o) * inv
    t_near = torch.minimum(t1, t2).amax(dim=-1)
    t_far = torch.maximum(t1, t2).amin(dim=-1)
    hit = (t_near <= t_far) & (t_far >= 0.0)
    return hit, torch.clamp(t_near, min=0.0)


def intersect_quadrics_block(origin, direction, Q, bb_min, bb_max):
    """(R,) rays x (Qn,) quadrics -> (t (R,Qn), valid). Reference quadric.cpp:69-100:
    start at the BB entry point, solve the quadratic, reject exits outside the BB."""
    bb_hit, t_bb = _slab_entry(origin, direction, bb_min, bb_max)
    o3 = origin[:, None, :] + direction[:, None, :] * t_bb[..., None]
    o4 = torch.cat([o3, torch.ones_like(o3[..., :1])], dim=-1)            # (R, Qn, 4)
    d4 = torch.cat([direction, torch.zeros_like(direction[..., :1])], dim=-1)  # (R, 4)
    Qo = torch.einsum("qij,rqj->rqi", Q, o4)
    Qd = torch.einsum("qij,rj->rqi", Q, d4)
    a = (d4[:, None, :] * Qd).sum(-1)
    b = (d4[:, None, :] * Qo).sum(-1) * 2.0
    c = (o4 * Qo).sum(-1)
    valid, t_min, t_max = g.solve_quadratic(a, b, c)
    valid = valid & (t_max >= 0.0) & bb_hit
    t_rel = torch.where(t_min < 0.0, t_max, t_min)
    t = t_bb + t_rel
    pos = origin[:, None, :] + direction[:, None, :] * t[..., None]
    inside_bb = ((pos >= bb_min[None, :, :]) & (pos <= bb_max[None, :, :])).all(dim=-1)
    return t, valid & inside_bb


def intersect_brute(tables: SceneTables, meta: SceneMeta, origin, direction) -> Hit:
    """Closest hit across all primitive tables. origin/direction: (R, 3)."""
    dtype = origin.dtype
    R = origin.shape[0]
    dev = origin.device
    big = _big(dtype)
    best_t = torch.full((R,), big, dtype=dtype, device=dev)
    best_id = torch.full((R,), -1, dtype=torch.int32, device=dev)
    best_uv = torch.zeros((R, 2), dtype=dtype, device=dev)

    if meta.n_tris:
        t, u, v, valid = intersect_tris_block(
            origin, direction, tables.tri_v0, tables.tri_e1, tables.tri_e2, 1e-9)
        t = torch.where(valid, t, big)
        tt, idx = torch.min(t, dim=-1)
        hit_valid = tt < best_t
        best_id = torch.where(hit_valid, idx.to(torch.int32), best_id)
        uu = g.row_take(u, idx)
        vv = g.row_take(v, idx)
        best_uv = torch.where(hit_valid[:, None], torch.stack([uu, vv], dim=-1), best_uv)
        best_t = torch.minimum(best_t, tt)

    if meta.n_sphs:
        t, valid = intersect_spheres_block(origin, direction, tables.sph_origin, tables.sph_radius)
        t = torch.where(valid, t, big)
        tt, idx = torch.min(t, dim=-1)
        hit_valid = tt < best_t
        best_id = torch.where(hit_valid, idx.to(torch.int32) + meta.sphere_offset, best_id)
        best_t = torch.minimum(best_t, tt)

    if meta.n_quads:
        t, valid = intersect_quadrics_block(
            origin, direction, tables.quad_Q, tables.quad_bb_min, tables.quad_bb_max)
        t = torch.where(valid, t, big)
        tt, idx = torch.min(t, dim=-1)
        hit_valid = tt < best_t
        best_id = torch.where(hit_valid, idx.to(torch.int32) + meta.quad_offset, best_id)
        best_t = torch.minimum(best_t, tt)

    best_t, best_uv = refine_tri_hit(tables, meta, origin, direction, best_t, best_id, best_uv)
    return Hit(t=best_t, surf_id=best_id, uv=best_uv)


def surface_normal(tables: SceneTables, meta: SceneMeta, surf_id, position):
    """Outward geometric normal at `position` for each surface id (gather +
    dispatch). The integrator reads its packed form (integrator/common.py)."""
    sid = torch.clamp(surf_id, min=0)
    tri_id = _long(torch.clamp(sid, 0, max(meta.n_tris - 1, 0)))
    sph_id = _long(torch.clamp(sid - meta.sphere_offset, 0, max(meta.n_sphs - 1, 0)))
    quad_id = _long(torch.clamp(sid - meta.quad_offset, 0, max(meta.n_quads - 1, 0)))

    n = tables.tri_n[tri_id]
    if meta.n_sphs:
        sph_n = (position - tables.sph_origin[sph_id]) / tables.sph_radius[sph_id][:, None]
        n = torch.where((sid >= meta.sphere_offset)[:, None], sph_n, n)
    if meta.n_quads:
        p4 = torch.cat([position, torch.ones_like(position[..., :1])], dim=-1)
        grad = torch.einsum("rij,rj->ri", tables.quad_G[quad_id], p4)
        n = torch.where((sid >= meta.quad_offset)[:, None], g.normalize(grad), n)
    return n


def shading_normal(tables: SceneTables, meta: SceneMeta, surf_id, uv, geom_n, direction):
    """Interpolated shading normal with geometric fallback when the interpolated
    normal flips sides relative to the ray (reference interaction.cpp:23-30)."""
    sid = torch.clamp(surf_id, min=0)
    tri_id = _long(torch.clamp(sid, 0, max(meta.n_tris - 1, 0)))
    is_tri = sid < meta.sphere_offset
    interp = is_tri & tables.tri_interp[tri_id]
    vn = tables.tri_vn[tri_id]  # (R, 3, 3)
    u, v = uv[..., 0:1], uv[..., 1:2]
    sn = g.normalize((1.0 - u - v) * vn[:, 0] + u * vn[:, 1] + v * vn[:, 2])
    flip_mismatch = (g.dot(direction, geom_n) < 0.0) != (g.dot(direction, sn) < 0.0)
    use_interp = interp & ~flip_mismatch
    return torch.where(use_interp[:, None], sn, geom_n)


def make_brute_fn(tables: SceneTables, meta: SceneMeta):
    """intersect_brute over `tables` as an intersect closure, with the
    `leaves` (the tables), `rebind` and `key` of cluster_bvh.make_intersect_fn."""
    fn = lambda origin, direction: intersect_brute(tables, meta, origin, direction)
    fn.leaves = (tables,)
    fn.rebind = lambda leaves: make_brute_fn(leaves[0], meta)
    fn.key = ("brute", meta)
    return fn
