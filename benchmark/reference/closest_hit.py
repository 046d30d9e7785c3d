"""The reference's closest hits, found without any BVH of the port.

The scene's triangles are cut into clusters of CLUSTER triangles in the
Morton order of their centroids, and the clusters, in that order, into
groups of GROUP_CLUSTERS. A ray enters the groups' boxes in order of entry
distance; in each group it enters the clusters' boxes in order of entry
distance, and every triangle of an entered cluster is tested in float64 (the
Moller-Trumbore test of ops/intersect.py: det != 0, u, v in [0, 1], u + v <=
1, t > 0) until the next box is entered beyond the best hit. A cluster's box
lies inside its group's, so no box entered before the closest hit is
skipped. The nearest t wins, and among equal t the lower triangle id, so the
answer does not depend on the order of the search. The winner is then
re-evaluated by the frozen `refine_tri_hit` in the tables' dtype and the
spheres are tested as the port's intersect does, so that a path whose hits
agree with the port's follows the same arithmetic.

The same clusters give the work a closest-hit query needs whatever
implements it: the clusters whose box the ray enters no later than its
closest hit (all that it enters, on a miss). `need` reports them for the
traversal's roofline count.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import intersect as isect

CLUSTER = 128          # triangles a cluster
GROUP_CLUSTERS = 64    # clusters a group
RAY_CHUNK = 65536      # rays searched at once
PAIR_CHUNK = 65536     # (ray, group) pairs whose clusters `need` measures at once
ROUND = 4              # clusters a round tests per ray
NO_ID = torch.iinfo(torch.int64).max


class Clusters(NamedTuple):
    lo: torch.Tensor       # (C, 3) float64 box min
    hi: torch.Tensor       # (C, 3) float64 box max
    tri: torch.Tensor      # (C, CLUSTER) int64 triangle ids, -1 for padding
    n_tri: torch.Tensor    # (C,) int64 real triangles a cluster
    v0: torch.Tensor       # (T, 3) float64
    e1: torch.Tensor
    e2: torch.Tensor
    group_lo: torch.Tensor     # (G, 3) float64 box min of a group of clusters
    group_hi: torch.Tensor     # (G, 3)
    members: torch.Tensor      # (G, GROUP_CLUSTERS) int64 cluster ids, -1 for padding


def _spread_bits(x):
    """10-bit integers -> every third bit of a 30-bit Morton code."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def build_clusters(v0, e1, e2, device) -> Clusters:
    """Clusters of the triangles (v0, e1, e2), host arrays of shape (T, 3)."""
    v0 = np.asarray(v0, np.float64)
    e1 = np.asarray(e1, np.float64)
    e2 = np.asarray(e2, np.float64)
    T = len(v0)
    cen = v0 + (e1 + e2) / 3.0
    lo, hi = cen.min(0), cen.max(0)
    q = np.clip(((cen - lo) / np.maximum(hi - lo, 1e-30) * 1023.0).astype(np.int64), 0, 1023)
    code = (_spread_bits(q[:, 0]) << 2) | (_spread_bits(q[:, 1]) << 1) | _spread_bits(q[:, 2])
    order = np.argsort(code, kind="stable")
    C = -(-T // CLUSTER)
    tri = np.full(C * CLUSTER, -1, np.int64)
    tri[:T] = order
    tri = tri.reshape(C, CLUSTER)
    real = tri >= 0
    idx = np.where(real, tri, 0)
    pts = np.stack([v0[idx], v0[idx] + e1[idx], v0[idx] + e2[idx]], axis=2)   # (C, CL, 3, 3)
    lo_c = np.where(real[..., None, None], pts, np.inf).min(axis=(1, 2))
    hi_c = np.where(real[..., None, None], pts, -np.inf).max(axis=(1, 2))
    G = -(-C // GROUP_CLUSTERS)
    members = np.full(G * GROUP_CLUSTERS, -1, np.int64)
    members[:C] = np.arange(C)
    members = members.reshape(G, GROUP_CLUSTERS)
    m = np.maximum(members, 0)
    lo_g = np.where((members >= 0)[..., None], lo_c[m], np.inf).min(axis=1)
    hi_g = np.where((members >= 0)[..., None], hi_c[m], -np.inf).max(axis=1)
    f = lambda x: torch.as_tensor(x, device=device)
    return Clusters(lo=f(lo_c), hi=f(hi_c), tri=f(tri), n_tri=f(real.sum(1)),
                    v0=f(v0), e1=f(e1), e2=f(e2), group_lo=f(lo_g), group_hi=f(hi_g),
                    members=f(members))


def box_entry(o, d, lo, hi):
    """Entry distance of each ray (R, 3) into boxes, clamped at 0, and inf
    where the ray misses the box or leaves it behind its origin; float64.
    Boxes (C, 3) give (R, C), the same boxes for every ray; boxes (R, M, 3)
    give (R, M), a row of boxes a ray."""
    tiny = torch.full_like(d, 1e-300)
    d = torch.where(d.abs() < 1e-300, torch.copysign(tiny, d), d)
    inv = 1.0 / d
    if lo.dim() == 2:
        lo, hi = lo[None], hi[None]
    t1 = (lo - o[:, None]) * inv[:, None]
    t2 = (hi - o[:, None]) * inv[:, None]
    tn = torch.minimum(t1, t2).amax(-1)
    tf = torch.maximum(t1, t2).amin(-1)
    tn = torch.clamp(tn, min=0.0)
    return torch.where(tf >= tn, tn, torch.inf)


def _test_triangles(cl: Clusters, o, d, tri):
    """(A, M) t of rays (A, 3) against triangles tri (A, M); inf where missed
    or padded."""
    ok = tri >= 0
    ix = torch.clamp(tri, min=0)
    v0, e1, e2 = cl.v0[ix], cl.e1[ix], cl.e2[ix]
    dd = d[:, None].expand_as(e2)
    p = torch.linalg.cross(dd, e2)
    det = (p * e1).sum(-1)
    inv = 1.0 / torch.where(det == 0.0, torch.ones_like(det), det)
    tv = o[:, None] - v0
    u = (p * tv).sum(-1) * inv
    q = torch.linalg.cross(tv, e1)
    v = (q * dd).sum(-1) * inv
    t = (q * e2).sum(-1) * inv
    hit = (ok & (det != 0.0) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0)
           & (u + v <= 1.0) & (t > 0.0))
    return torch.where(hit, t, torch.inf)


def _before(key, best_t):
    """Boxes entered no later than the best hit so far."""
    return torch.isfinite(key) & (key <= best_t)


def _search(cl: Clusters, o, d):
    """(t, id) of the closest triangles of the rays (R, 3), float64."""
    R, G = o.shape[0], cl.members.shape[0]
    dev = o.device
    bt = torch.full((R,), torch.inf, dtype=torch.float64, device=dev)
    bid = torch.full((R,), NO_ID, dtype=torch.int64, device=dev)
    gkey, gorder = torch.sort(box_entry(o, d, cl.group_lo, cl.group_hi), dim=1)
    for j in range(G):
        a = _before(gkey[:, j], bt).nonzero().squeeze(1)
        if len(a) == 0:
            break
        cids = cl.members[gorder[a, j]]                           # (A, GROUP_CLUSTERS)
        c = torch.clamp(cids, min=0)
        ckey = torch.where(cids >= 0, box_entry(o[a], d[a], cl.lo[c], cl.hi[c]), torch.inf)
        ckey, corder = torch.sort(ckey, dim=1)
        cids = cids.gather(1, corder)
        for m in range(0, cids.shape[1], ROUND):
            live = _before(ckey[:, m], bt[a]).nonzero().squeeze(1)
            if len(live) == 0:
                break
            r = a[live]
            entered = _before(ckey[live, m:m + ROUND], bt[r, None])
            cols = cids[live, m:m + ROUND]
            tri = torch.where(entered[..., None], cl.tri[torch.clamp(cols, min=0)], -1)
            tri = tri.reshape(len(r), -1)
            t = _test_triangles(cl, o[r], d[r], tri)
            tmin = t.min(dim=1).values
            tid = torch.where(t == tmin[:, None], tri, NO_ID).min(dim=1).values
            better = torch.isfinite(tmin) & ((tmin < bt[r]) | ((tmin == bt[r]) & (tid < bid[r])))
            bt[r] = torch.where(better, tmin, bt[r])
            bid[r] = torch.where(better, tid, bid[r])
    return bt, torch.where(bid == NO_ID, -1, bid)


def _need(cl: Clusters, o, d, bt, need):
    """Adds to `need` the clusters each ray enters no later than its closest
    hit `bt` (inf on a miss). Such a cluster's group is entered no later
    either, so only the clusters of those groups are measured."""
    for r0 in range(0, o.shape[0], RAY_CHUNK):
        oo, dd, b = (x[r0:r0 + RAY_CHUNK] for x in (o, d, bt))
        gkey = box_entry(oo, dd, cl.group_lo, cl.group_hi)
        rays, groups = _before(gkey, b[:, None]).nonzero(as_tuple=True)
        for p0 in range(0, len(rays), PAIR_CHUNK):
            r, g = rays[p0:p0 + PAIR_CHUNK], groups[p0:p0 + PAIR_CHUNK]
            cids = cl.members[g]
            c = torch.clamp(cids, min=0)
            key = torch.where(cids >= 0, box_entry(oo[r], dd[r], cl.lo[c], cl.hi[c]), torch.inf)
            entered = _before(key, b[r, None])
            need["clusters"].index_add_(0, r0 + r, entered.sum(1))
            need["triangles"].index_add_(0, r0 + r, (entered * cl.n_tri[c]).sum(1))
            need["union"][c[entered]] = True


def closest_triangles(cl: Clusters, origin, direction, need=None):
    """(t (R,) float64, inf on a miss; triangle id (R,) int64, -1 on a miss).
    With `need` a dict, adds to it per ray the clusters entered no later than
    the closest hit ("clusters", (R,) int64), their real triangles
    ("triangles", (R,) int64) and, over all the rays, which clusters some ray
    needs ("union", (C,) bool)."""
    o_all = origin.to(torch.float64)
    d_all = direction.to(torch.float64)
    R = o_all.shape[0]
    dev = o_all.device
    best_t = torch.full((R,), torch.inf, dtype=torch.float64, device=dev)
    best_id = torch.full((R,), -1, dtype=torch.int64, device=dev)
    for r0 in range(0, R, RAY_CHUNK):
        best_t[r0:r0 + RAY_CHUNK], best_id[r0:r0 + RAY_CHUNK] = _search(
            cl, o_all[r0:r0 + RAY_CHUNK], d_all[r0:r0 + RAY_CHUNK])
    if need is not None:
        need["clusters"] = torch.zeros(R, dtype=torch.int64, device=dev)
        need["triangles"] = torch.zeros(R, dtype=torch.int64, device=dev)
        need.setdefault("union", torch.zeros(cl.lo.shape[0], dtype=torch.bool, device=dev))
        _need(cl, o_all, d_all, best_t, need)
    return best_t, best_id


def make_intersect(tables, meta, cl: Clusters):
    """The reference's scene intersect for a scene of triangles and spheres:
    closest triangle (above), its hit re-evaluated by refine_tri_hit in the
    tables' dtype, then the spheres, as the port's make_intersect_fn combines
    them. Returns a Hit."""
    geo = isect.build_geo_pack(tables)

    def intersect(origin, direction):
        dtype = origin.dtype
        big = torch.finfo(dtype).max
        R = origin.shape[0]
        # Parked rays (dead lanes, far outside the scene) enter no box.
        live = (origin.detach().abs().amax(dim=1) < 1e29).nonzero().squeeze(1)
        t64 = torch.full((R,), torch.inf, dtype=torch.float64, device=origin.device)
        tid = torch.full((R,), -1, dtype=torch.int64, device=origin.device)
        t64[live], tid[live] = closest_triangles(cl, origin.detach()[live],
                                                 direction.detach()[live])
        best_id = tid.to(torch.int32)
        best_t = torch.where(tid >= 0, t64, big).to(dtype)
        uv = torch.zeros((R, 2), dtype=dtype, device=origin.device)
        best_t, uv = isect.refine_tri_hit(tables, meta, origin, direction, best_t, best_id, uv,
                                          geo=geo)
        if meta.n_sphs:
            t, valid = isect.intersect_spheres_block(origin, direction, tables.sph_origin,
                                                     tables.sph_radius)
            t = torch.where(valid, t, big)
            tt, idx = torch.min(t, dim=-1)
            better = tt < best_t
            best_id = torch.where(better, idx.to(torch.int32) + meta.sphere_offset, best_id)
            best_t = torch.minimum(best_t, tt)
        return isect.Hit(t=best_t, surf_id=best_id, uv=uv)

    return intersect
