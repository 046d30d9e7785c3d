"""Cluster BVH: fat-leaf BVH + per-cluster Moller-Trumbore forms.

The port of the JAX package's cluster BVH. The BVH is built with fat leaves
("clusters" of up to S triangles, S = 128-512); every cluster stores its
triangles' Moller-Trumbore bilinear forms

    det   = d . (E2 x E1)
    u*det = -cr . E2 - d . (E2 x v0)
    v*det =  cr . E1 + d . (E1 x v0)          (cr = d x o)
    t*det =  o . n2 - v0 . n2                 (n2 = E1 x E2)

so a ray meets a whole cluster with a few dot products per triangle, or a
(K, 10) @ (10, 4S) product for a block of K rays.

Two formulations of the closest hit, one per table format; `traverse`
dispatches on the tables' type:

- `ClusterBVH`, the kernel's five tables: cull every cluster AABB, then
  best-first rounds with exact per-ray pruning, in ops/traverse_kernel.py: a
  CUDA kernel for tensors on the card, its plain PyTorch version for tensors
  on the CPU: the JAX package's Pallas kernel route.
- `ClusterTree`, the JAX package's dense cluster tables (`traverse_bestfirst`):
  an exact cull of every (ray, cluster) tiled over the clusters, the
  candidates sorted by entry bound, then rounds of G clusters per block,
  each gathered by rows.

The tables choose the route, once, where they are built: `upload_cluster_bvh`
attaches a `ClusterTree` to the `ClusterBVH` where `takes_bestfirst` says so
(float64 tables on the card, which the kernel does not take), and
`make_intersect_fn` traverses best-first exactly when the BVH carries one.
Best-first's loop ends on a condition of the data that the host reads, so an
intersect through it cannot be captured into a CUDA graph: the closure's
`capturable` says so, and the integrators' loops then run their steps
eagerly on the card.

`make_intersect_fn` wraps a formulation the way the JAX package does:
coherence sort of the rays, traversal, unsort, `refine_tri_hit` of the
winner, then brute-force spheres and quadrics.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..scene.loader import SceneMeta, SceneTables
from . import traverse_kernel
from .intersect import Hit, build_geo_pack, intersect_quadrics_block, intersect_spheres_block, refine_tri_hit

# Record row layout, per triangle (REC_W floats; only the nonzero coefficients
# of the dense 10-feature forms are stored):
#   0:3  det  . d          3:6  udet . d     6:9  udet . cr
#   9:12 vdet . d         12:15 vdet . cr   15:18 tdet . o    18 tdet constant
#   19   zero padding (keeps a row five float4 wide)
REC_W = 20


class ClusterTree(NamedTuple):
    """The JAX package's dense cluster tables (fields of its ClusterBVH),
    which best-first reads. A ClusterBVH carries one in its `tree` field,
    which make_intersect_fn keeps out of its closure's leaves, so that no
    graph's static leaves copy it (`feat` alone is C x 40S values)."""
    feat: torch.Tensor           # (C, 10, 4S) per-triangle forms, cluster-local
    tri_id: torch.Tensor         # (C, S) int32 original triangle id, -1 padding
    center: torch.Tensor         # (C, 3) cluster centroid (the forms' origin)
    cl_bb_min: torch.Tensor      # (C, 3) cluster AABBs
    cl_bb_max: torch.Tensor      # (C, 3)


class ClusterBVH(NamedTuple):
    cl_bb: torch.Tensor   # (C, 8) cluster AABBs: lo xyz, 0, hi xyz, 0 (same dtype as rec:
                          # float32 for the CUDA kernel, float64 for CPU parity runs)
    rec: torch.Tensor     # (C, Sp, REC_W) per-triangle forms, center folded in
    tri: torch.Tensor     # (C, Sp) int32 original triangle ids, -1 padding
    bb_lo: torch.Tensor   # (3,) root AABB (coherence sort key), table dtype
    bb_hi: torch.Tensor   # (3,)
    tree: ClusterTree | None = None   # the best-first route's tables where they take it


def build_cluster_features(v0, e1, e2, dtype=np.float32):
    """(P,3)x3 -> (P, 10, 4) per-triangle bilinear-form matrices (numpy)."""
    n2 = np.cross(e1, e2)
    e2v0 = np.cross(e2, v0)
    e1v0 = np.cross(e1, v0)
    dvn = np.sum(v0 * n2, axis=-1)
    P = len(v0)
    M = np.zeros((P, 10, 4), dtype)
    # F = [d(0:3), o(3:6), cr(6:9), 1(9)]
    M[:, 0:3, 0] = -n2
    M[:, 0:3, 1] = -e2v0
    M[:, 6:9, 1] = -e2
    M[:, 0:3, 2] = e1v0
    M[:, 6:9, 2] = e1
    M[:, 3:6, 3] = n2
    M[:, 9, 3] = -dvn
    return M


def build_traversal_tables(feat, tri_id, center, cl_lo, cl_hi, dtype=np.float32):
    """Host-side build of the kernel's record, triangle-id and AABB tables.

    feat (C, 10, 4S) is form-major [det|udet|vdet|tdet] in cluster-local
    coordinates. The center translation is folded into the matrix so the kernel
    uses global-frame ray features, F_global @ M' == F_local @ M, with the same
    arithmetic as the JAX package's float32 table build (in `dtype`); then only
    the nonzero rows of each form are kept (see REC_W). Returns numpy
    (rec, tri, cl_bb)."""
    C, _, S4 = feat.shape
    S = S4 // 4
    Sp = -(-S // 32) * 32
    M = feat.reshape(C, 10, 4, S)
    Mp = np.zeros((C, 10, 4, Sp), dtype)
    Mp[:, :, :, :S] = M
    # d-rows: M'[0:3] = M[0:3] - c x M[6:9]
    c = center.astype(dtype)                            # (C, 3)
    M69 = Mp[:, 6:9]                                    # (C, 3, 4, Sp)
    cxm = np.cross(c[:, :, None, None], M69, axis=1)
    Mp[:, 0:3] -= cxm
    # 1-row: M'[9] = M[9] - c . M[3:6]
    Mp[:, 9] -= np.einsum("ci,cifs->cfs", c, Mp[:, 3:6])
    rec = np.zeros((C, Sp, REC_W), dtype)
    rows = lambda form, r: Mp[:, r, form, :].transpose(0, 2, 1)   # (C, Sp, len(r))
    rec[:, :, 0:3] = rows(0, [0, 1, 2])
    rec[:, :, 3:9] = rows(1, [0, 1, 2, 6, 7, 8])
    rec[:, :, 9:15] = rows(2, [0, 1, 2, 6, 7, 8])
    rec[:, :, 15:19] = rows(3, [3, 4, 5, 9])
    tri = np.full((C, Sp), -1, np.int32)
    tri[:, :S] = tri_id
    cl_bb = np.zeros((C, 8), dtype)
    cl_bb[:, 0:3] = cl_lo
    cl_bb[:, 4:7] = cl_hi
    return rec, tri, cl_bb


def cluster_dense_numpy(bb_min, bb_max, first, count, prim_order, tri_v0, tri_e1, tri_e2,
                        dtype=np.float32):
    """Flat fat-leaf BVH arrays + triangle arrays -> (leaf_ids, feat (C, 10, 4S),
    tri_id (C, S), center (C, 3)) numpy, as the JAX package's upload builds them."""
    leaf_ids = np.nonzero(count > 0)[0]
    C = len(leaf_ids)
    S = int(count.max()) if C else 1

    # Vectorized gather of each leaf's primitive slice into the (C, S) padded layout.
    first = first[leaf_ids].astype(np.int64)               # (C,)
    count = count[leaf_ids].astype(np.int64)               # (C,)
    col = np.arange(S, dtype=np.int64)[None, :]            # (1, S)
    valid = col < count[:, None]                           # (C, S)
    gidx = first[:, None] + np.minimum(col, np.maximum(count[:, None] - 1, 0))
    prims = prim_order[gidx]                               # (C, S) clamped gather
    tri_id = np.where(valid, prims, -1).astype(np.int32)
    center = 0.5 * (bb_min[leaf_ids] + bb_max[leaf_ids])
    vmask = valid[..., None]
    pv0 = np.where(vmask, tri_v0[prims] - center[:, None, :], 0.0)
    pe1 = np.where(vmask, tri_e1[prims], 0.0)
    pe2 = np.where(vmask, tri_e2[prims], 0.0)

    feat = build_cluster_features(
        pv0.reshape(-1, 3), pe1.reshape(-1, 3), pe2.reshape(-1, 3), dtype
    ).reshape(C, S, 10, 4)
    # (C, S, 10, 4) -> (C, 10, 4, S) -> (C, 10, 4S): output columns grouped by form
    feat = np.ascontiguousarray(feat.transpose(0, 2, 3, 1)).reshape(C, 10, 4 * S)
    return leaf_ids, feat, tri_id, center


def cluster_tables_numpy(bb_min, bb_max, first, count, prim_order, tri_v0, tri_e1, tri_e2,
                         dtype=np.float32):
    """Flat fat-leaf BVH arrays + triangle arrays -> (rec, tri, cl_bb) numpy."""
    leaf_ids, feat, tri_id, center = cluster_dense_numpy(
        bb_min, bb_max, first, count, prim_order, tri_v0, tri_e1, tri_e2, dtype)
    return build_traversal_tables(feat, tri_id, center, bb_min[leaf_ids], bb_max[leaf_ids], dtype)


def cluster_tree_numpy(bb_min, bb_max, first, count, prim_order, tri_v0, tri_e1, tri_e2,
                       dtype=np.float32) -> dict:
    """Flat fat-leaf BVH arrays + triangle arrays -> ClusterTree's fields as
    numpy (the JAX package's upload_cluster_bvh)."""
    leaf_ids, feat, tri_id, center = cluster_dense_numpy(
        bb_min, bb_max, first, count, prim_order, tri_v0, tri_e1, tri_e2, dtype)
    return dict(feat=feat, tri_id=tri_id, center=center, cl_bb_min=bb_min[leaf_ids],
                cl_bb_max=bb_max[leaf_ids])


def takes_bestfirst(device: torch.device, dtype: torch.dtype) -> bool:
    """The route rule: tables of `dtype` on `device` traverse best-first,
    and so carry a ClusterTree, where the kernel route does not run: tables
    other than float32 on the card (the JAX package, too, takes its Pallas
    kernel for float32 tables only). On the CPU the kernel's plain version
    serves every dtype."""
    return device.type == "cuda" and dtype != torch.float32


def upload_cluster_bvh(flat, scene, dtype=np.float32, device=None) -> ClusterBVH:
    """FlatBVH (fat leaves) + host scene triangle data -> ClusterBVH on
    `device`, carrying its ClusterTree where `takes_bestfirst` says so."""
    from ..convert import cluster_bvh_from_numpy

    cbvh = cluster_bvh_from_numpy(
        flat.bb_min, flat.bb_max, flat.first, flat.count, flat.prim_order,
        scene.tri_v0, scene.tri_e1, scene.tri_e2, device=device, dtype=dtype)
    if takes_bestfirst(cbvh.rec.device, cbvh.rec.dtype):
        cbvh = cbvh._replace(tree=upload_cluster_tree(flat, scene, dtype, cbvh.rec.device))
    return cbvh


def upload_cluster_tree(flat, scene, dtype=np.float32, device=None) -> ClusterTree:
    """FlatBVH (fat leaves) + host scene triangle data -> ClusterTree on
    `device`, for the best-first formulation."""
    from ..convert import cluster_tree_from_numpy

    fields = cluster_tree_numpy(
        np.asarray(flat.bb_min), np.asarray(flat.bb_max),
        np.asarray(flat.first), np.asarray(flat.count), np.asarray(flat.prim_order),
        np.asarray(scene.tri_v0, np.float64), np.asarray(scene.tri_e1, np.float64),
        np.asarray(scene.tri_e2, np.float64), dtype=np.dtype(dtype).type)
    return cluster_tree_from_numpy(**fields, device=device, dtype=dtype)


def _part1by2(x):
    """Spread the low 10 bits of x so there are 2 zero bits between each."""
    x = x & 0x3FF
    x = (x | (x << 16)) & 0x030000FF
    x = (x | (x << 8)) & 0x0300F00F
    x = (x | (x << 4)) & 0x030C30C3
    x = (x | (x << 2)) & 0x09249249
    return x


def coherence_key(origin, direction, bb_lo, bb_hi):
    """Sort key grouping rays that start near each other and point the same way.

    Layout (high->low): 3-bit direction octant | 18-bit origin Morton | 9-bit
    direction Morton. Blocks of rays that share a tight frustum cull most
    clusters in the traversal's first step; the direction bits matter for
    pinhole camera rays, whose origins are all identical. Parked dead rays
    (origin ~2e30) clip to the far corner and sort to the tail, so whole blocks
    of dead lanes cost nothing. Integer math in int64 (the key fits in 30 bits).
    """
    i64 = torch.int64
    octant = (
        (direction[:, 0] < 0).to(i64)
        + 2 * (direction[:, 1] < 0).to(i64)
        + 4 * (direction[:, 2] < 0).to(i64)
    )
    q = torch.clamp((origin - bb_lo) / torch.clamp(bb_hi - bb_lo, min=1e-30), 0.0, 1.0)
    cell = (q * 63.0).to(i64)                         # 6 bits/axis
    om = _part1by2(cell[:, 0]) | (_part1by2(cell[:, 1]) << 1) | (_part1by2(cell[:, 2]) << 2)
    qd = torch.clamp((direction + 1.0) * 0.5, 0.0, 1.0)
    dcell = (qd * 7.0).to(i64)                        # 3 bits/axis
    dm = _part1by2(dcell[:, 0]) | (_part1by2(dcell[:, 1]) << 1) | (_part1by2(dcell[:, 2]) << 2)
    return (octant << 27) | (om << 9) | dm


def _ray_features(o, d):
    """(..., 3) origin/direction -> (..., 10) feature vector [d, o, d x o, 1]."""
    cr = torch.linalg.cross(d, o)
    return torch.cat([d, o, cr, torch.ones_like(o[..., :1])], dim=-1)


def _forms(rayF, feat_c):
    """rayF @ feat_c in the tables' dtype, rounded to float32: the JAX
    package's einsum with `preferred_element_type=float32`, which a float64
    product rounds too."""
    return torch.matmul(rayF, feat_c).to(torch.float32)


def _closest(det, udet, vdet, tdet, tri_ok, best_t):
    """Per-triangle (u, v, t) and t where the hit is valid and nearer than
    best_t (inf elsewhere), from float32 forms."""
    inv_det = 1.0 / torch.where(det == 0.0, 1.0, det)
    u = udet * inv_det
    v = vdet * inv_det
    t = tdet * inv_det
    valid = ((det != 0.0) & tri_ok & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0)
             & (u + v <= 1.0) & (t > 0.0) & (t < best_t))
    return u, v, t, torch.where(valid, t, torch.inf)


def intersect_clusters_multi(feat_c, tri_id_c, rayF, best_t, best_id, best_u, best_v):
    """Dense intersection of (B, K) rays against G clusters per block at once.

    feat_c: (B, G, 10, 4S); tri_id_c: (B, G, S); rayF: (B, G, K, 10): each
    cluster keeps its own local-coordinate ray features. The winner of a ray
    is the first minimum over the G * S triangles in (cluster, triangle)
    order, where it is nearer than its best."""
    B, G, _, S4 = feat_c.shape
    S = S4 // 4
    K = rayF.shape[2]
    out = _forms(rayF, feat_c).reshape(B, G, K, 4, S)
    u, v, t, t_m = _closest(out[..., 0, :], out[..., 1, :], out[..., 2, :], out[..., 3, :],
                            (tri_id_c >= 0)[:, :, None, :], best_t[:, None, :, None])
    t_flat = t_m.permute(0, 2, 1, 3).reshape(B, K, G * S)
    tbest, idx = torch.min(t_flat, dim=-1)              # first minimum, (cluster, triangle) order
    improved = torch.isfinite(tbest)
    gi, si = idx // S, idx % S
    bi = torch.arange(B, device=idx.device)[:, None]
    ki = torch.arange(K, device=idx.device)[None, :]
    pick = lambda x: x[bi, gi, ki, si]
    win_id = tri_id_c[bi, gi, si].to(best_id.dtype)
    return (torch.where(improved, tbest, best_t), torch.where(improved, win_id, best_id),
            torch.where(improved, pick(u), best_u), torch.where(improved, pick(v), best_v))


def _blocks(origin, direction, block):
    """(o, d) as (B, K, 3) blocks of K = min(block, R) rays, R padded by
    repeating the last ray, as the JAX package does."""
    R = origin.shape[0]
    K = min(block, R)
    pad = (-R) % K
    if pad:
        origin = torch.cat([origin, origin[-1:].expand(pad, 3)])
        direction = torch.cat([direction, direction[-1:].expand(pad, 3)])
    return origin.reshape(-1, K, 3), direction.reshape(-1, K, 3)


def _unblock(R, *xs):
    return tuple(x.reshape(-1)[:R] for x in xs)


def traverse_bestfirst(tree: ClusterTree, origin, direction, block: int = 256, group: int = 8):
    """Dense-cull best-first traversal: few fat rounds, no tree walk.

    1. CULL: the exact slab test of every (ray, cluster), CT = min(128, C)
       clusters at a time, reduced per block to "some ray hits" and the
       block's nearest entry distance.
    2. ORDER: each block's candidates sorted by that entry bound.
    3. ROUNDS: each round takes the next G = min(group, C) candidates of
       every block (gathered by rows) and intersects them in one product. A
       candidate is active while its bound is below the block's demand, the
       largest best t of its rays that are not parked (|origin| > 1e28):
       a parked ray finds no hit, and would keep its block from stopping.
       The rounds stop when no block has an active candidate.

    Returns per-ray (t, tri_id, u, v) and stats, int64 [candidates, rounds],
    as the JAX package's `traverse_bestfirst`. The host reads the stop
    condition once a round."""
    dtype = origin.dtype
    R = origin.shape[0]
    dev = origin.device
    big = torch.finfo(dtype).max
    o, d = _blocks(origin, direction, block)
    B, K, _ = o.shape
    C = tree.tri_id.shape[0]

    # ---- 1. exact per-ray slab test against every cluster AABB, tiled over C ----
    # (lo - o) * inv_d, not lo * inv_d - o * inv_d: with an axis-aligned ray
    # (inv_d = inf) the latter is inf - inf = NaN and culls every cluster.
    inv_d = 1.0 / d
    CT = min(128, C)
    hit = torch.zeros((B, C), dtype=torch.bool, device=dev)
    t_near_lb = torch.full((B, C), big, dtype=dtype, device=dev)
    for c0 in range(0, C, CT):
        lo = tree.cl_bb_min[c0:c0 + CT]
        hi = tree.cl_bb_max[c0:c0 + CT]
        t1 = (lo - o[:, :, None, :]) * inv_d[:, :, None, :]       # (B, K, ct, 3)
        t2 = (hi - o[:, :, None, :]) * inv_d[:, :, None, :]
        tn = torch.minimum(t1, t2).amax(dim=-1)
        tf = torch.maximum(t1, t2).amin(dim=-1)
        h = (tn <= tf) & (tf >= 0.0)
        hit[:, c0:c0 + CT] = h.any(dim=1)
        t_near_lb[:, c0:c0 + CT] = torch.where(h, tn, big).amin(dim=1)
    n_candidates = hit.sum()
    parked = o.abs().amax(dim=-1) > 1e28                            # (B, K)

    # ---- 2. best-first order ----
    key_s, ids_s = torch.sort(torch.where(hit, t_near_lb, big), dim=1, stable=True)
    # G-wide rounds: the candidate lists padded to a multiple of G with non-hits.
    G = max(1, min(group, C))
    Cr = -(-C // G) * G
    if Cr > C:
        key_s = torch.cat([key_s, torch.full((B, Cr - C), big, dtype=dtype, device=dev)], dim=1)
        ids_s = torch.cat([ids_s, torch.zeros((B, Cr - C), dtype=ids_s.dtype, device=dev)], dim=1)

    best_t = torch.full((B, K), big, dtype=dtype, device=dev)
    best_id = torch.full((B, K), -1, dtype=torch.int32, device=dev)
    best_u = torch.zeros((B, K), dtype=dtype, device=dev)
    best_v = torch.zeros((B, K), dtype=dtype, device=dev)

    def round_inputs(r):
        demand = torch.where(parked, 0.0, best_t).amax(dim=1)
        return ids_s[:, r:r + G], key_s[:, r:r + G] < demand[:, None]

    r = 0
    cl, active = round_inputs(r)
    while r < Cr and bool(active.any()):
        feat_c, tri_c, center_c = tree.feat[cl], tree.tri_id[cl], tree.center[cl]
        tri_c = torch.where(active[:, :, None], tri_c, -1)
        o_local = o[:, None, :, :] - center_c[:, :, None, :]        # (B, G, K, 3)
        rayF = _ray_features(o_local, d[:, None, :, :].expand_as(o_local))
        best_t, best_id, best_u, best_v = intersect_clusters_multi(
            feat_c, tri_c, rayF, best_t, best_id, best_u, best_v)
        r += G
        cl, active = round_inputs(r)
    stats = torch.stack([n_candidates, torch.full_like(n_candidates, r // G)])
    return (*_unblock(R, best_t, best_id, best_u, best_v), stats)


def traverse(tables, origin, direction):
    """Closest triangle hit per ray: (t, tri_id, u, v, stats (2,) int64), by
    the tables' format. A ClusterBVH runs traverse_kernel.traverse, whose
    per-block stats are reduced as the JAX package reduces its Pallas
    kernel's: [candidates summed, most rounds of a block]; t, u and v come
    back in the rays' dtype. A ClusterTree runs traverse_bestfirst."""
    if isinstance(tables, ClusterBVH):
        t, tid, u, v, st = traverse_kernel.traverse(tables, origin, direction)
        cast = lambda x: x.to(origin.dtype)
        return cast(t), tid, cast(u), cast(v), torch.stack([st[:, 0].sum(), st[:, 1].max()]).long()
    if isinstance(tables, ClusterTree):
        return traverse_bestfirst(tables, origin, direction)
    raise TypeError(f"traverse reads a ClusterBVH or a ClusterTree, not a {type(tables).__name__}")


def make_intersect_fn(tables: SceneTables, meta: SceneMeta, cbvh: ClusterBVH, geo_pack=None,
                      sort_rays: bool = True):
    """Scene intersect closure: cluster BVH for triangles + brute spheres/quadrics.

    sort_rays: group rays into coherent blocks by the Morton/octant key inside
    this wrapper (permute origin/direction in, unpermute the hit fields out),
    so the integrator's carry stays in lane order; False traverses the rays
    in lane order.

    The triangles traverse best-first where the BVH carries a ClusterTree
    (`cbvh.tree`, see upload_cluster_bvh) and by the kernel route otherwise.
    Hit.steps is the traversal's stats (see `traverse`). The closure's
    `leaves` are the tensors it reads but the tree, (tables, cbvh without its
    tree, geo_pack: the triangles' packed rows, built here unless given), and
    `rebind(leaves)` builds it over others of the same shapes; `key` names the
    rest, the tree by identity. `capturable` is true for the kernel route
    only: best-first reads its stop condition on the host, so a loop that
    would capture a step holding it runs the step eagerly."""
    tree = cbvh.tree
    trav = cbvh if tree is None else tree
    if geo_pack is None and meta.n_tris:
        geo_pack = build_geo_pack(tables)

    def intersect(origin, direction):
        big = torch.finfo(origin.dtype).max
        # The traversal is discrete (which triangle wins): run it on detached
        # rays; refine_tri_hit below re-evaluates the winner from the real rays.
        sg_o = origin.detach()
        sg_d = direction.detach()
        if sort_rays:
            key = coherence_key(sg_o, sg_d, cbvh.bb_lo, cbvh.bb_hi)
            perm = torch.argsort(key, stable=True)
            t_s, id_s, u_s, v_s, steps = traverse(trav, sg_o[perm], sg_d[perm])
            best_t = torch.empty_like(t_s)
            best_id = torch.empty_like(id_s)
            best_uv = torch.empty((len(perm), 2), dtype=u_s.dtype, device=origin.device)
            best_t[perm] = t_s
            best_id[perm] = id_s
            best_uv[perm] = torch.stack([u_s, v_s], dim=-1)
        else:
            best_t, best_id, u, v, steps = traverse(trav, sg_o, sg_d)
            best_uv = torch.stack([u, v], dim=-1)
        # Re-evaluate the winner exactly (same gathered-triangle ops as the brute
        # path) so BVH and brute-force renders produce identical hits.
        best_t, best_uv = refine_tri_hit(
            tables, meta, origin, direction, best_t, best_id, best_uv, geo=geo_pack)

        if meta.n_sphs:
            t, valid = intersect_spheres_block(origin, direction, tables.sph_origin, tables.sph_radius)
            t = torch.where(valid, t, big)
            tt, idx = torch.min(t, dim=-1)
            better = tt < best_t
            best_id = torch.where(better, idx.to(torch.int32) + meta.sphere_offset, best_id)
            best_t = torch.minimum(best_t, tt)

        if meta.n_quads:
            t, valid = intersect_quadrics_block(
                origin, direction, tables.quad_Q, tables.quad_bb_min, tables.quad_bb_max)
            t = torch.where(valid, t, big)
            tt, idx = torch.min(t, dim=-1)
            better = tt < best_t
            best_id = torch.where(better, idx.to(torch.int32) + meta.quad_offset, best_id)
            best_t = torch.minimum(best_t, tt)

        return Hit(t=best_t, surf_id=best_id, uv=best_uv, steps=steps)

    intersect.leaves = (tables, cbvh._replace(tree=None), geo_pack)
    intersect.rebind = lambda leaves: make_intersect_fn(
        leaves[0], meta, leaves[1]._replace(tree=tree), leaves[2], sort_rays)
    intersect.key = ("cluster_bvh", meta, sort_rays, None if tree is None else id(tree))
    intersect.capturable = tree is None
    return intersect
