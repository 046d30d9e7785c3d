"""The least time a kernel's work needs on one H100, counted from its inputs
and the reference's answers, never from what the kernel visited.

Peaks are the NVIDIA H100 SXM data sheet's, at the full 700 W power limit:
3.35 TB/s of HBM and 67 TFLOP/s in float32 outside the tensor cores. The
least time of a launch is the larger of its bytes over the first and its
operations over the second (`bound_s`).

Traversal, per launch of rays (parked rays, far outside the scene, are not
work): each live ray reads 24 bytes and writes 16; each cluster that some
ray of the launch must test is read once, its box (24 bytes) and its
triangles (36 bytes each). A ray must test a cluster whose box it enters no
later than its closest hit (every box it enters, on a miss), as the reference
finds it over its own clusters of CLUSTER triangles (reference/closest_hit).
Operations are 22 for each such (ray, box) and 38 for each (ray, triangle)
of those clusters.

k-NN, per call: each valid query reads 13 bytes and writes 8 per neighbour
and 4 for its count; each photon of some query's k nearest is read once (12
bytes). Operations are 8 for each (query, neighbour): three differences,
three products, two sums.
"""
from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

RAY_BYTES = 24 + 16
BOX_BYTES = 24
TRI_BYTES = 36
OPS_PER_RAY_BOX = 22
OPS_PER_RAY_TRI = 38

QUERY_BYTES = 13 + 4
NEIGHBOUR_BYTES = 8
PHOTON_BYTES = 12
OPS_PER_QUERY_PHOTON = 8


def bound_s(ops: float, bytes_: float) -> tuple[float, str]:
    """(least seconds, "bytes" or "operations": which of the two bounds it)."""
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops else "operations")


def live_rays(origin, far: float = 1e29):
    """Rays of a launch that are work: parked rays start beyond `far`."""
    return origin.abs().amax(dim=1) < far


def traversal_work(clusters, origin, direction) -> tuple[float, float]:
    """(operations, bytes) of one traversal launch of these rays."""
    from .reference import closest_hit

    live = live_rays(origin)
    o, d = origin[live], direction[live]
    if o.shape[0] == 0:
        return 0.0, 0.0
    need = {}
    closest_hit.closest_triangles(clusters, o, d, need=need)
    ops = (OPS_PER_RAY_BOX * float(need["clusters"].sum())
           + OPS_PER_RAY_TRI * float(need["triangles"].sum()))
    union = need["union"]
    bytes_ = (RAY_BYTES * o.shape[0] + BOX_BYTES * float(union.sum())
              + TRI_BYTES * float(clusters.n_tri[union].sum()))
    return ops, bytes_


def knn_work(pos, points, mask, k: int) -> tuple[float, float]:
    """(operations, bytes) of one exact k-NN call of the queries `points`
    (those under `mask`) on the photons `pos`."""
    from .reference import knn

    q = points if mask is None else points[mask]
    if q.shape[0] == 0 or pos.shape[0] == 0:
        return 0.0, 0.0
    _, idx, valid = knn.knn(pos, q, k)
    pairs = float(valid.sum())
    photons = int(torch.unique(idx[valid]).numel())
    ops = OPS_PER_QUERY_PHOTON * pairs
    bytes_ = QUERY_BYTES * q.shape[0] + NEIGHBOUR_BYTES * pairs + PHOTON_BYTES * photons
    return ops, bytes_
