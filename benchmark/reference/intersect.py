"""Frozen copy of mcrt_tpu_torch/ops/intersect.py for the benchmark's plain reference:
later changes to the port do not reach it.

Batched ray-surface intersection: the parts the reference's closest hits
use (closest_hit.py). A triangle winner is re-evaluated by refine_tri_hit,
and the spheres (reference source/surface/sphere.cpp) are tested as one
dense (R x S) computation; rays are a batch (R,), surfaces SoA tables.

Hit encoding: surf_id == -1 means miss; uv are barycentric (triangles only).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .loader import SceneMeta, SceneTables
from . import geometry as g


class Hit(NamedTuple):
    t: torch.Tensor        # (R,)
    surf_id: torch.Tensor  # (R,) int32, -1 = miss
    uv: torch.Tensor       # (R, 2) triangle barycentrics
    steps: torch.Tensor | None = None  # (2,) BVH [candidates, rounds] (None: brute)


def _long(x):
    return x.to(torch.int64)


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
