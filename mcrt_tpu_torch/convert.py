"""Bring a scene's "weights" into the port from host arrays.

A renderer's parameters are its scene tables, its acceleration structure and,
for the photon mapper, its photon maps. These functions build the port's
`SceneTables`, `ClusterBVH`, `ClusterTree` and `PhotonGrid` from numpy
arrays — the port's own loader, or `np.asarray` of every field of the JAX
package's objects — so both packages can compute on identical inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from .accel.photon_grid import PhotonGrid, PhotonGridArrays
from .ops.cluster_bvh import ClusterBVH, ClusterTree, cluster_tables_numpy
from .scene.loader import SceneTables
from .utils.device import resolve_device, torch_dtype


def tables_from_numpy(fields: dict[str, np.ndarray], device=None, dtype=np.float32) -> SceneTables:
    """SceneTables from a dict of every field: bool arrays stay bool, integer
    arrays become int32, floating arrays become `dtype`; all on `device`
    (None: the CUDA device, or raise without one)."""
    device = resolve_device(device)
    fdt = torch_dtype(dtype)
    missing = set(SceneTables._fields) - set(fields)
    if missing:
        raise KeyError(f"tables_from_numpy: missing fields {sorted(missing)}")

    def conv(x):
        x = np.array(x)   # a private, writable copy
        if x.dtype == np.bool_:
            return torch.as_tensor(x, device=device)
        if np.issubdtype(x.dtype, np.integer):
            return torch.as_tensor(x.astype(np.int32), device=device)
        return torch.as_tensor(x.astype(np.float64), device=device).to(fdt)

    return SceneTables(**{name: conv(fields[name]) for name in SceneTables._fields})


def cluster_bvh_from_numpy(bb_min, bb_max, first, count, prim_order, tri_v0, tri_e1, tri_e2,
                           device=None, dtype=np.float32) -> ClusterBVH:
    """ClusterBVH from a fat-leaf flat BVH (node AABBs, leaf first/count, the
    primitive order) and the scene's triangle arrays, all tables in `dtype`
    (the CUDA kernel takes float32)."""
    device = resolve_device(device)
    fdt = torch_dtype(dtype)
    bb_min, bb_max = np.asarray(bb_min), np.asarray(bb_max)
    rec, tri, cl_bb = cluster_tables_numpy(
        bb_min, bb_max, np.asarray(first), np.asarray(count), np.asarray(prim_order),
        np.asarray(tri_v0, np.float64), np.asarray(tri_e1, np.float64),
        np.asarray(tri_e2, np.float64), dtype=np.dtype(dtype).type)
    return ClusterBVH(
        cl_bb=torch.as_tensor(cl_bb, device=device),
        rec=torch.as_tensor(rec, device=device),
        tri=torch.as_tensor(tri, device=device),
        bb_lo=torch.as_tensor(bb_min[0], device=device).to(fdt),
        bb_hi=torch.as_tensor(bb_max[0], device=device).to(fdt),
    )


def cluster_tree_from_numpy(feat, tri_id, center, cl_bb_min, cl_bb_max, device=None,
                            dtype=np.float32) -> ClusterTree:
    """ClusterTree from the JAX package's ClusterBVH fields of the same names
    (or the port's cluster_tree_numpy): the per-cluster forms, triangle ids
    and centers, and the cluster AABBs. Floating tables become `dtype`, the
    ids int32."""
    device = resolve_device(device)
    fdt = torch_dtype(dtype)
    f = lambda x: torch.as_tensor(np.array(x, np.float64), device=device).to(fdt)
    ids = torch.as_tensor(np.asarray(tri_id).astype(np.int32), device=device)
    return ClusterTree(feat=f(feat), tri_id=ids, center=f(center), cl_bb_min=f(cl_bb_min),
                       cl_bb_max=f(cl_bb_max))


def photon_grid_from_numpy(pos, direction, flux, cell_start, bb_min, cell_size, dims, m_per_cell,
                           n_photons, device=None) -> PhotonGrid:
    """PhotonGrid from a built grid's arrays (photons sorted by cell, CSR starts)
    and its static fields, as the JAX package's PhotonGrid holds them; the
    float arrays keep their dtype, cell_start becomes int32."""
    device = resolve_device(device)
    t = lambda x: torch.as_tensor(np.array(x), device=device)
    return PhotonGrid(
        arrays=PhotonGridArrays(pos=t(pos), direction=t(direction), flux=t(flux),
                                cell_start=t(np.asarray(cell_start, np.int32))),
        bb_min=tuple(float(x) for x in bb_min),
        cell_size=float(cell_size),
        dims=tuple(int(x) for x in dims),
        m_per_cell=int(m_per_cell),
        n_photons=int(n_photons),
    )
