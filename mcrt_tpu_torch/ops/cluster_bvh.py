"""Cluster BVH: fat-leaf BVH + per-cluster Moller-Trumbore forms.

The port of the JAX package's cluster BVH. The BVH is built with fat leaves
("clusters" of up to S triangles, S = 128-512); every cluster stores its
triangles' Moller-Trumbore bilinear forms

    det   = d . (E2 x E1)
    u*det = -cr . E2 - d . (E2 x v0)
    v*det =  cr . E1 + d . (E1 x v0)          (cr = d x o)
    t*det =  o . n2 - v0 . n2                 (n2 = E1 x E2)

so a ray meets a whole cluster with a few dot products per triangle. The
traversal itself (cull every cluster AABB, then best-first rounds with exact
per-ray pruning) lives in ops/traverse_kernel.py: a CUDA kernel for tensors on
the card, and its plain PyTorch version for tensors on the CPU.

`make_intersect_fn` wraps it the way the JAX package does: coherence sort of
the rays, traversal, unsort, `refine_tri_hit` of the winner, then brute-force
spheres and quadrics.
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


class ClusterBVH(NamedTuple):
    cl_bb: torch.Tensor   # (C, 8) cluster AABBs: lo xyz, 0, hi xyz, 0 (same dtype as rec:
                          # float32 for the CUDA kernel, float64 for CPU parity runs)
    rec: torch.Tensor     # (C, Sp, REC_W) per-triangle forms, center folded in
    tri: torch.Tensor     # (C, Sp) int32 original triangle ids, -1 padding
    bb_lo: torch.Tensor   # (3,) root AABB (coherence sort key), table dtype
    bb_hi: torch.Tensor   # (3,)


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


def cluster_tables_numpy(bb_min, bb_max, first, count, prim_order, tri_v0, tri_e1, tri_e2,
                         dtype=np.float32):
    """Flat fat-leaf BVH arrays + triangle arrays -> (rec, tri, cl_bb) numpy."""
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
    return build_traversal_tables(feat, tri_id, center, bb_min[leaf_ids], bb_max[leaf_ids], dtype)


def upload_cluster_bvh(flat, scene, dtype=np.float32, device=None) -> ClusterBVH:
    """FlatBVH (fat leaves) + host scene triangle data -> ClusterBVH on `device`."""
    from ..convert import cluster_bvh_from_numpy

    return cluster_bvh_from_numpy(
        flat.bb_min, flat.bb_max, flat.first, flat.count, flat.prim_order,
        scene.tri_v0, scene.tri_e1, scene.tri_e2, device=device, dtype=dtype)


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


def make_intersect_fn(tables: SceneTables, meta: SceneMeta, cbvh: ClusterBVH, geo_pack=None):
    """Scene intersect closure: cluster BVH for triangles + brute spheres/quadrics.

    Rays are grouped into coherent K-ray blocks by the Morton/octant key inside
    this wrapper (permute origin/direction in, unpermute the hit fields out),
    so the integrator's carry stays in lane order.

    Hit.steps is [candidates summed over blocks, most rounds of any block].
    The closure's `leaves` are the tensors it reads, (tables, cbvh, geo_pack:
    the triangles' packed rows, built here unless given), and `rebind(leaves)`
    builds it over others of the same shapes."""
    if geo_pack is None and meta.n_tris:
        geo_pack = build_geo_pack(tables)

    def intersect(origin, direction):
        big = torch.finfo(origin.dtype).max
        # The traversal is discrete (which triangle wins): run it on detached
        # rays; refine_tri_hit below re-evaluates the winner from the real rays.
        sg_o = origin.detach()
        sg_d = direction.detach()
        key = coherence_key(sg_o, sg_d, cbvh.bb_lo, cbvh.bb_hi)
        perm = torch.argsort(key, stable=True)
        t_s, id_s, u_s, v_s, stats = traverse_kernel.traverse(cbvh, sg_o[perm], sg_d[perm])
        best_t = torch.empty_like(t_s)
        best_id = torch.empty_like(id_s)
        best_uv = torch.empty((len(perm), 2), dtype=u_s.dtype, device=origin.device)
        best_t[perm] = t_s
        best_id[perm] = id_s
        best_uv[perm] = torch.stack([u_s, v_s], dim=-1)
        best_t = best_t.to(origin.dtype)
        best_uv = best_uv.to(origin.dtype)
        steps = torch.stack([stats[:, 0].sum(), stats[:, 1].max()])
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

    intersect.leaves = (tables, cbvh, geo_pack)
    intersect.rebind = lambda leaves: make_intersect_fn(leaves[0], meta, leaves[1], leaves[2])
    intersect.key = ("cluster_bvh", meta)
    return intersect
