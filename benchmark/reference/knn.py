"""The reference's exact k nearest photons: every photon of the map is
measured against every query, with no grid.

Distances are d2 = (dx * dx + dy * dy) + dz * dz in float32, one operation
at a time (no fused multiply-add), and neighbours are ordered by (d2, row),
as the port's exact k-NN orders them, so the radiance estimate sums its terms
in the same order.
"""
from __future__ import annotations

import torch

Q_CHUNK = 4096
N_CHUNK = 8192


def knn(pos, points, k: int):
    """pos (N, 3), points (Q, 3), both float32 -> (d2 (Q, k) float32, +inf
    past the map's photons; idx (Q, k) int32; valid (Q, k) bool)."""
    Q, N = points.shape[0], pos.shape[0]
    dev = points.device
    inf_key = torch.iinfo(torch.int64).max
    out_key = torch.empty((Q, k), dtype=torch.int64, device=dev)
    for q0 in range(0, Q, Q_CHUNK):
        q = points[q0:q0 + Q_CHUNK]
        best = torch.full((q.shape[0], k), inf_key, dtype=torch.int64, device=dev)
        for n0 in range(0, N, N_CHUNK):
            p = pos[n0:n0 + N_CHUNK]
            dx = p[None, :, 0] - q[:, None, 0]
            dy = p[None, :, 1] - q[:, None, 1]
            dz = p[None, :, 2] - q[:, None, 2]
            d2 = (dx * dx + dy * dy) + dz * dz
            rows = torch.arange(n0, n0 + p.shape[0], dtype=torch.int64, device=dev)
            key = (d2.view(torch.int32).to(torch.int64) << 32) | rows[None, :]
            best = torch.topk(torch.cat([best, key], dim=1), k, dim=1, largest=False,
                              sorted=True).values
        out_key[q0:q0 + Q_CHUNK] = best
    valid = out_key != inf_key
    d2 = (out_key >> 32).to(torch.int32).view(torch.float32)
    d2 = torch.where(valid, d2, torch.inf)
    idx = torch.where(valid, out_key & 0xFFFFFFFF, 0).to(torch.int32)
    return d2, idx, valid
