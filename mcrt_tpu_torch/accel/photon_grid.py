"""Uniform-grid k-NN for photon maps (the port of the JAX package's
accel/photon_grid.py; the reference searches an octree,
source/octree/linear-octree.cpp:25-117).

Photons are sorted by grid cell on the host (numpy) into a CSR layout with z
the fastest axis. A query reads the photons of the 27 cells around it:

* `knn(..., exact=False)`: the capped one-ring k-NN. Up to M photons of each
  cell are gathered and merged through a running stable top-k; results
  farther than cell_size are dropped. Cells holding more than M photons give a
  uniform random M-subsample whose photons carry weight occ/M, so the flux-sum
  estimate stays unbiased.
* `knn(..., exact=True)`: the exact k-NN at any density. In float32 with
  k <= KPAD on a non-empty map it is the staged k-NN of knn_kernel.knn (the
  CUDA kernels on the card, their plain version on the CPU), whose answer is
  final: one ring, then widening rings, then a whole-map scan, all on the
  device with no host sync. Otherwise (float64, k > KPAD) it is the capped
  search, whose flagged queries (fewer than k photons within cell_size, or
  a subsampled cell touched) are re-answered by `_knn_brute` over the whole
  map. The brute force computes every row and the flagged ones are
  selected, as in the JAX package, whose `lax.cond` skips it when no row is
  flagged; here it always runs, so that this path too syncs nothing and
  can be captured into a CUDA graph. Float64 queries take this route on the
  card too (the kernels take float32), as the JAX package's non-Pallas
  exact route.
"""
from __future__ import annotations

import dataclasses
import functools
import pathlib
from typing import NamedTuple

import numpy as np
import torch

from ..utils.device import resolve_device, torch_dtype
from . import knn_kernel


class PhotonGridArrays(NamedTuple):
    """Photon SoA sorted by cell + CSR starts, all on one device."""
    pos: torch.Tensor         # (N,3)
    direction: torch.Tensor   # (N,3) incoming photon direction (points away from the hit)
    flux: torch.Tensor        # (N,3)
    cell_start: torch.Tensor  # (n_cells+1,) int32


@dataclasses.dataclass(frozen=True)
class PhotonGrid:
    """Static grid geometry + the device arrays."""
    arrays: PhotonGridArrays
    bb_min: tuple
    cell_size: float
    dims: tuple          # (nx, ny, nz)
    m_per_cell: int      # candidate read cap per cell of the capped search
    n_photons: int

    @property
    def empty(self) -> bool:
        return self.n_photons == 0


def _cell_ids(pos, bb_min, cell, dims):
    ij = np.floor((pos - bb_min) / cell).astype(np.int64)
    ij = np.clip(ij, 0, np.asarray(dims) - 1)
    return (ij[:, 0] * dims[1] + ij[:, 1]) * dims[2] + ij[:, 2]


def _upload(pos, direction, flux, cell_start, dtype, device) -> PhotonGridArrays:
    f = lambda x: torch.as_tensor(np.asarray(x, np.float64), device=device).to(dtype)
    return PhotonGridArrays(pos=f(pos), direction=f(direction), flux=f(flux),
                            cell_start=torch.as_tensor(np.asarray(cell_start, np.int32),
                                                       device=device))


def build_photon_grid(
    pos: np.ndarray,
    direction: np.ndarray,
    flux: np.ndarray,
    k: int,
    dtype=np.float32,
    target_occupancy: float | None = None,
    max_cells: int = 1 << 22,
    device=None,
) -> PhotonGrid:
    """Host-side build: choose the cell size from measured occupancy, sort, CSR,
    then upload to `device` (None: the CUDA device, or raise without one)."""
    device = resolve_device(device)
    tdt = torch_dtype(dtype)
    n = len(pos)
    if n == 0:
        z = np.zeros((1, 3))
        return PhotonGrid(_upload(z, z, z, np.zeros(2), tdt, device),
                          (0.0, 0.0, 0.0), 1.0, (1, 1, 1), 1, 0)

    pos = np.asarray(pos, np.float64)
    bb_min = pos.min(axis=0) - 1e-6
    bb_max = pos.max(axis=0) + 1e-6
    extent = np.maximum(bb_max - bb_min, 1e-9)
    # Target max occupancy ~4k: with every cell <= M the one-ring gather is exact
    # within the cell_size radius.
    target = float(target_occupancy if target_occupancy is not None else 4.0 * k)

    cell = float(extent.max() / 8.0)
    dims = (1, 1, 1)
    for _ in range(24):
        dims = tuple(int(x) for x in np.maximum(np.ceil(extent / cell), 1).astype(int))
        if dims[0] * dims[1] * dims[2] > max_cells:
            cell *= 1.3
            continue
        ids = _cell_ids(pos, bb_min, cell, dims)
        occ_max = int(np.bincount(ids).max())
        if occ_max <= target:
            break
        # photons lie on 2D surfaces: occupancy ~ cell^2
        cell *= max(float(np.sqrt(target / occ_max)), 0.25)
    dims = tuple(int(x) for x in np.maximum(np.ceil(extent / cell), 1).astype(int))
    n_cells = dims[0] * dims[1] * dims[2]
    while n_cells > max_cells:  # final safety: coarser grid
        cell *= 1.26
        dims = tuple(int(x) for x in np.maximum(np.ceil(extent / cell), 1).astype(int))
        n_cells = dims[0] * dims[1] * dims[2]

    ids = _cell_ids(pos, bb_min, cell, dims)
    order = np.argsort(ids, kind="stable")
    counts = np.bincount(ids, minlength=n_cells)
    cell_start = np.zeros(n_cells + 1, np.int64)
    np.cumsum(counts, out=cell_start[1:])

    # M = max occupancy, capped at max(8k, 256); cells over the cap are read as a
    # uniform random M-subsample (photon order within a cell is shuffled below)
    # whose flux the capped search rescales by occ/M.
    occ_nonzero = counts[counts > 0]
    occ_max = int(occ_nonzero.max()) if len(occ_nonzero) else 8
    m = min(occ_max, max(8 * k, 256))
    m = int(np.ceil(m / 8) * 8)
    if occ_max > m:
        rng = np.random.RandomState(0x9E3779B9)
        perm = rng.permutation(n)
        order = perm[np.argsort(ids[perm], kind="stable")]

    arrays = _upload(pos[order], np.asarray(direction, np.float64)[order],
                     np.asarray(flux, np.float64)[order], cell_start, tdt, device)
    return PhotonGrid(
        arrays=arrays,
        bb_min=tuple(float(x) for x in bb_min),
        cell_size=float(cell),
        dims=dims,
        m_per_cell=m,
        n_photons=n,
    )


def save_photon_grid(path, grid: PhotonGrid) -> None:
    """Write a built grid (photon SoA + CSR + geometry) to an .npz, with the
    JAX package's keys, so that either package can load it."""
    path = pathlib.Path(path)
    tmp = path.with_suffix(".tmp.npz")
    a = grid.arrays
    np.savez(
        tmp,
        pos=a.pos.cpu().numpy(),
        direction=a.direction.cpu().numpy(),
        flux=a.flux.cpu().numpy(),
        cell_start=a.cell_start.cpu().numpy(),
        bb_min=np.asarray(grid.bb_min),
        cell_size=grid.cell_size,
        dims=np.asarray(grid.dims),
        m_per_cell=grid.m_per_cell,
        n_photons=grid.n_photons,
    )
    tmp.replace(path)  # atomic on POSIX


def load_photon_grid(path, device=None) -> PhotonGrid:
    """A grid saved by either package, on `device` (None: the CUDA device)."""
    device = resolve_device(device)
    z = np.load(path)
    t = lambda key: torch.as_tensor(z[key], device=device)
    return PhotonGrid(
        arrays=PhotonGridArrays(pos=t("pos"), direction=t("direction"), flux=t("flux"),
                                cell_start=t("cell_start").to(torch.int32)),
        bb_min=tuple(float(x) for x in z["bb_min"]),
        cell_size=float(z["cell_size"]),
        dims=tuple(int(x) for x in z["dims"]),
        m_per_cell=int(z["m_per_cell"]),
        n_photons=int(z["n_photons"]),
    )


def _knn_brute(arrays: PhotonGridArrays, points, k: int, n_photons: int,
               chunk: int | None = None):
    """Exact k-NN over ALL photons: a chunked scan carrying a per-query top-k.

    O(Q*N): the exact answer for the queries the one-ring search cannot serve.
    `chunk` photons per step; by default as many as keep a (Q, chunk) distance
    block near 2^24 entries (at least 1024, the JAX package's chunk)."""
    Q = points.shape[0]
    N = arrays.pos.shape[0]
    dev = points.device
    if chunk is None:
        chunk = max(1024, (1 << 24) // max(Q, 1))
    best_d2 = torch.full((Q, k), torch.inf, dtype=points.dtype, device=dev)
    best_ix = torch.zeros((Q, k), dtype=torch.int32, device=dev)
    for c0 in range(0, N, chunk):
        p = arrays.pos[c0:c0 + chunk]
        d = p[None, :, :] - points[:, None, :]
        d2 = torch.sum(d * d, dim=-1)                           # (Q, chunk)
        ix = torch.arange(c0, c0 + p.shape[0], dtype=torch.int32, device=dev)
        d2 = torch.where((ix < n_photons)[None, :], d2, torch.inf)
        cat_d2 = torch.cat([best_d2, d2], dim=1)
        cat_ix = torch.cat([best_ix, ix.expand(Q, -1)], dim=1)
        best_d2, sel = torch.topk(cat_d2, k, dim=1, largest=False, sorted=True)
        best_ix = torch.gather(cat_ix, 1, sel)
    return best_d2, best_ix, torch.isfinite(best_d2)


def _knn_kernel_ok(grid: PhotonGrid, dtype, k: int) -> bool:
    """True when the staged k-NN serves this exact query: float32, k within its
    output width, a non-empty map (the JAX package's `_knn_pallas_ok`, less its
    TPU check: the wrapper chooses the kernels or their plain version by device)."""
    return grid.n_photons > 0 and dtype == torch.float32 and k <= knn_kernel.KPAD


def _exact_fallback(arrays, points, k, N, res, needs):
    """Re-answer the flagged queries `needs` with `_knn_brute`: every row is
    computed and the flagged ones are selected, as the JAX package does, so
    that nothing syncs the host (a captured step runs this)."""
    d2k, idxk, valid, wk = res
    bd2, bix, bval = _knn_brute(arrays, points, k, N)
    m = needs[:, None]
    return (torch.where(m, bd2.to(d2k.dtype), d2k), torch.where(m, bix, idxk),
            torch.where(m, bval, valid), torch.where(m, torch.ones_like(wk), wk))


def knn(grid: PhotonGrid, arrays: PhotonGridArrays, points, k: int, mask=None,
        exact: bool = False, stats: dict | None = None):
    """k nearest photons of each query point (Q,3), within radius cell_size.

    Returns (d2 (Q,k), idx (Q,k) int32, valid (Q,k), w (Q,k) flux weights);
    invalid slots have d2 = +inf. `mask` (Q,) bool marks the queries whose
    result matters: masked-off lanes are not searched in exact mode. With a
    `stats` dict, exact mode adds one call and knn_counted's counts
    (add_knn_stats). The counts are device tensors: read them once, after
    the render."""
    if exact:
        res, counts = knn_counted(grid, arrays, points, k, mask)
        if stats is not None:
            add_knn_stats(stats, counts)
        return res
    return _knn_capped(grid, arrays, points, k)[0]


def knn_counted(grid: PhotonGrid, arrays: PhotonGridArrays, points, k: int, mask=None):
    """knn(exact=True) with its counts as one (3,) int64 tensor on the
    queries' device, [queries, flagged, scanned], in place of a stats dict, so
    that a loop can carry them in its state (a captured step's Python runs
    once, at the capture). `flagged` counts, on the staged k-NN's path, the
    queries that went on to its stage B, and on the capped path those that
    the brute force re-answered; `scanned` the queries that reached the
    staged k-NN's whole-map scan (0 on the capped path). Nothing syncs the
    host. Returns ((d2, idx, valid, w), counts)."""
    dtype = points.dtype
    dev = points.device
    queries = lambda: (torch.full((1,), points.shape[0], dtype=torch.int64, device=dev)
                       if mask is None else mask.sum().view(1))
    if _knn_kernel_ok(grid, dtype, k):
        r = knn_kernel.knn(grid, arrays, points, k, mask=mask)
        return (r.d2, r.idx, r.valid, r.w), torch.cat([queries(), r.queued.to(torch.int64)])
    res, touched_trunc = _knn_capped(grid, arrays, points, k)
    N = grid.n_photons
    flagged = torch.zeros((1,), dtype=torch.int64, device=dev)
    if N > k:
        inexact = touched_trunc | (res[2].sum(dim=1) < k)
        if mask is not None:
            inexact = inexact & mask
        res = _exact_fallback(arrays, points, k, N, res, inexact)
        flagged = inexact.sum().view(1)
    return res, torch.cat([queries(), flagged, torch.zeros_like(flagged)])


def add_knn_stats(stats: dict, counts, calls: int = 1):
    """Add `calls` exact k-NN calls and their summed `counts` [queries,
    flagged, scanned] (knn_counted) to `stats`: "knn_calls", "knn_queries",
    "knn_flagged" and "knn_scanned"."""
    for key, value in (("knn_queries", counts[0]), ("knn_calls", calls),
                       ("knn_flagged", counts[1]), ("knn_scanned", counts[2])):
        stats[key] = stats.get(key, 0) + value


def _knn_capped(grid: PhotonGrid, arrays: PhotonGridArrays, points, k: int):
    """The capped one-ring k-NN: ((d2, idx, valid, w), touched_trunc (Q,),
    the queries that read a subsampled cell)."""
    dtype = points.dtype
    Q = points.shape[0]
    N = grid.n_photons
    dev = points.device
    M = grid.m_per_cell
    nx, ny, nz = grid.dims
    inv_cell = 1.0 / grid.cell_size
    # The grid's constants enter as Python scalars: a tensor built from host
    # values would synchronise the device, which a captured step may not.
    ci = [torch.clamp(torch.floor((points[:, a] - grid.bb_min[a]) * inv_cell).to(torch.int32),
                      0, n - 1) for a, n in enumerate(grid.dims)]

    arange_m = torch.arange(M, dtype=torch.int32, device=dev)
    # The one-ring holds up to 27*M candidates, so the running top-k width is
    # bounded by that, not by the single-cell cap M.
    kk = min(k, 27 * M)
    best_d2 = torch.full((Q, kk), torch.inf, dtype=dtype, device=dev)
    best_ix = torch.zeros((Q, kk), dtype=torch.int32, device=dev)
    best_w = torch.ones((Q, kk), dtype=dtype, device=dev)
    touched_trunc = torch.zeros((Q,), dtype=torch.bool, device=dev)
    # Merge in groups of cells: one selection per group over (Q, k + G*M).
    max_cols = 16384
    group_cells = max(1, min(27, max_cols // max(M, 1)))
    offsets = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1) for dz in (-1, 0, 1)]
    for gstart in range(0, 27, group_cells):
        d2_parts, ix_parts, w_parts = [], [], []
        for off in offsets[gstart:gstart + group_cells]:
            cc = [c + o for c, o in zip(ci, off)]
            in_grid = functools.reduce(torch.logical_and,
                                       [(c >= 0) & (c < n) for c, n in zip(cc, grid.dims)])
            cs = [torch.clamp(c, 0, n - 1).to(torch.int64) for c, n in zip(cc, grid.dims)]
            lin = (cs[0] * ny + cs[1]) * nz + cs[2]
            s = arrays.cell_start[lin]
            e = arrays.cell_start[lin + 1]
            occ = e - s
            truncated = in_grid & (occ > M)
            touched_trunc = touched_trunc | truncated
            w_cell = torch.where(truncated, occ.to(dtype) / M, torch.ones_like(occ, dtype=dtype))
            idx = s[:, None] + arange_m[None, :]
            ok = in_grid[:, None] & (idx < e[:, None])
            idx_safe = torch.clamp(idx, max=max(N - 1, 0))
            p = arrays.pos[idx_safe.to(torch.int64)]                  # (Q, M, 3)
            d = p - points[:, None, :]
            d2_parts.append(torch.where(ok, torch.sum(d * d, dim=-1), torch.inf))
            ix_parts.append(idx_safe)
            w_parts.append(w_cell[:, None].expand(Q, M))
        cat_d2 = torch.cat([best_d2] + d2_parts, dim=1)
        cat_ix = torch.cat([best_ix] + ix_parts, dim=1)
        cat_w = torch.cat([best_w] + w_parts, dim=1)
        # A stable sort keeps lax.top_k's rule: equal distances, lower position first.
        best_d2, sel = torch.sort(cat_d2, dim=1, stable=True)
        best_d2, sel = best_d2[:, :kk], sel[:, :kk]
        best_ix = torch.gather(cat_ix, 1, sel)
        best_w = torch.gather(cat_w, 1, sel)

    # Radius cap: beyond cell_size the one-ring is not guaranteed complete.
    cell2 = grid.cell_size * grid.cell_size
    d2k = torch.where(best_d2 < cell2, best_d2, torch.inf)
    idxk = best_ix
    wk = best_w
    valid = torch.isfinite(d2k)
    if kk < k:  # pad to the requested k
        pad = k - kk
        d2k = torch.nn.functional.pad(d2k, (0, pad), value=torch.inf)
        idxk = torch.nn.functional.pad(idxk, (0, pad))
        wk = torch.nn.functional.pad(wk, (0, pad), value=1.0)
        valid = torch.nn.functional.pad(valid, (0, pad))

    return (d2k, idxk, valid, wk), touched_trunc
