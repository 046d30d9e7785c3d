"""Exact photon k-NN: the CUDA kernels' wrappers and their plain PyTorch version.

Replaces the JAX package's Pallas TPU kernel `_kernel` in
mcrt_tpu/accel/knn_kernel.py and, for float32 queries with k <= KPAD, the
brute-force `_knn_brute` that answers the queries it flags: here the kernels
alone answer every valid query with the k nearest photons of the whole map.

Queries are sorted by their grid cell (float32, clamped to the grid; invalid
queries last). A query's ring r is the box of cells within r of its clamped
cell, clamped to the grid. Each valid query goes through these stages:

  A. ring 1: the k nearest of the photons in its ring-1 box (csrc/knn.cu,
     `knn_ring1`, one warp per query);
  B. for a query stage A does not certify, wider rings, reading only the
     cells each adds (`knn_rings`), while the ring's box holds at most
     CELL_BUDGET cells; past the budget, a scan of all N photons (`knn_scan`).
     The stage is the first ring that certifies the answer.

Keys and order. A photon's key is (float32 bits of d2) << 32 | row, with
d2 = (dx*dx + dy*dy) + dz*dz in float32, each product and sum rounded on its
own. Keys order by (d2, row): the answer is the k smallest keys, ties to the
lower row, whatever order the photons are read in.

Certification. After ring r, with kth the k-th smallest d2 of the photons in
its box (inf while it holds fewer than k), the answer is final when
kth <= R2c(r). R2c bounds from below the d2 of every photon
outside the box: for each face of the box that is not on the grid's boundary,
the squared distance from the query to the part of the grid beyond that face
(its gap to the face, and its distance to the grid along the other two axes),
the least over the faces (inf when the box covers the grid). It is computed
in float32 with each coordinate shrunk by DELTA (the photons' cells were
assigned in float64 from positions that are stored in float32) and scaled by
1 - 2^-18 (the roundings), so a k-th d2 within rounding of the bound goes on
to the next stage. A query outside the grid's box, which `sort_queries`
clamps, is covered by the same rule.

Outputs per query: ids (int32 rows) and d2 of the k nearest, sorted by key
(id 0 and d2 = +inf in empty slots), their count min(k, N), and the stage
that answered it: 1 for stage A, r for ring r, STAGE_SCAN for the whole-map
scan, 0 for a masked query. Also two device counts: the queries that went on
to stage B and those that reached the scan.

The wrapper sends CUDA tensors to the kernels and CPU tensors to the plain
version, and raises for anything else. On the card the two agree bit for bit:
same keys, same certification arithmetic, same stage.
"""
from __future__ import annotations

import ctypes
import pathlib
from typing import NamedTuple

import numpy as np
import torch

from ..ops.traverse_kernel import compile_source
from ..utils.cuda_graph import LaunchCounter

KPAD = 56            # the most neighbours a query can ask for (the TPU kernel's output width)
CELL_BUDGET = 32768  # cells a stage-B ring box may hold (32^3); past it, the whole-map scan
STAGE_SCAN = -1      # stage code of a query answered by the whole-map scan
PLAIN_CHUNK = 1 << 22  # (query, photon) pairs per step of the plain version's scan
_NO_CELL = 1 << 30   # sort key of an invalid query: after every real cell
_INF_KEY = (1 << 63) - 1   # an empty slot's key: above every photon's
_SHRINK = 1.0 - 2.0 ** -18  # R2c's scale for the float32 roundings
_DELTA_REL = 2.0 ** -20     # DELTA as a share of the grid's largest coordinate

_SRC = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "knn.cu"


class _Library:
    """The built CUDA library (loaded at first use) and its ptxas report."""

    def __init__(self):
        self.lib = None
        self.build_log = ""


library = _Library()
# Each kernel's launches that ran (`launches`: eagerly or in a replay of a
# CUDA graph) and that were recorded into a graph under capture (`captured`).
ring1 = LaunchCounter("knn_ring1")      # stage A
rings = LaunchCounter("knn_rings")      # stage B: widening rings
scan = LaunchCounter("knn_scan")        # stage B: the whole-map scan
KERNELS = (ring1, rings, scan)


def build() -> ctypes.CDLL:
    """Compile csrc/knn.cu with nvcc for sm_90a into the package's _build/
    directory (once per source content) and load it with ctypes."""
    if library.lib is not None:
        return library.lib
    lib_path, log = compile_source(_SRC, "knn")
    lib = ctypes.CDLL(str(lib_path))
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    grid_args = [vp, vp, ci, ci, ci, ci] + [cf] * 8 + [ci]
    lib.mcrt_knn_ring1.argtypes = [vp] * 2 + grid_args + [ci] + [vp] * 7 + [ci, vp]
    lib.mcrt_knn_rings.argtypes = [vp] * 2 + grid_args + [vp] * 8 + [ci, vp]
    lib.mcrt_knn_scan.argtypes = [vp] * 2 + grid_args + [vp] * 7 + [ci, vp]
    for f in (lib.mcrt_knn_ring1, lib.mcrt_knn_rings, lib.mcrt_knn_scan):
        f.restype = ci
    lib.mcrt_knn_resident_warps.argtypes = [ci]
    lib.mcrt_knn_resident_warps.restype = ci
    library.build_log = log
    library.lib = lib
    return lib


def resident_warps() -> dict:
    """Warps each kernel keeps resident on one SM (CUDA occupancy API; builds
    the library)."""
    lib = build()
    return {kern.name: lib.mcrt_knn_resident_warps(i) for i, kern in enumerate(KERNELS)}


def _f32(x) -> float:
    return float(np.float32(x))


class Geometry(NamedTuple):
    """The grid's constants as float32 values, shared by the kernels and the
    plain version."""
    dims: tuple          # (nx, ny, nz)
    n: int               # photons
    bb: tuple            # grid's low corner, float32
    cell: float          # cell size, float32
    hi: tuple            # bb + n_a * cell, float32: the grid's high corner
    delta: float         # coordinate slack of the certification


def geometry(grid) -> Geometry:
    bb = tuple(_f32(x) for x in grid.bb_min)
    cell = _f32(grid.cell_size)
    hi = tuple(float(np.float32(b) + np.float32(n) * np.float32(cell))
               for b, n in zip(bb, grid.dims))
    scale = max(max(abs(x) for x in bb), max(abs(x) for x in hi))
    return Geometry(tuple(grid.dims), grid.n_photons, bb, cell, hi, _f32(scale * _DELTA_REL))


class Queries(NamedTuple):
    """Queries sorted by cell (shared by both versions)."""
    qpos: torch.Tensor    # (Q, 4) float32: x, y, z, valid (1.0 or 0.0)
    qcell: torch.Tensor   # (Q, 4) int32: cx, cy, cz, original query index


class KnnResult(NamedTuple):
    d2: torch.Tensor      # (Q, k) in the queries' dtype, +inf in empty slots
    idx: torch.Tensor     # (Q, k) int32 photon rows, 0 in empty slots
    valid: torch.Tensor   # (Q, k) bool
    w: torch.Tensor       # (Q, k) flux weights (all 1: every photon is read)
    stage: torch.Tensor   # (Q,) int32: 1 ring 1, r ring r, STAGE_SCAN, 0 masked
    queued: torch.Tensor  # (2,) int32: queries that went on to stage B, and to the scan


def sort_queries(grid, points, mask=None) -> Queries:
    """Cell of each query (float32: floor((p - bb_min) * (1 / cell)), clamped)
    and a stable sort by cell id with invalid queries last. The grid's
    constants enter as Python scalars: a tensor built from host values would
    synchronise the device at every call."""
    dev = points.device
    Q = points.shape[0]
    nx, ny, nz = grid.dims
    p32 = points.to(torch.float32)
    inv_cell = 1.0 / grid.cell_size
    ci = torch.stack([
        torch.clamp(torch.floor((p32[:, a] - grid.bb_min[a]) * inv_cell).to(torch.int32), 0, n - 1)
        for a, n in enumerate(grid.dims)], dim=1)
    valid = torch.ones(Q, dtype=torch.bool, device=dev) if mask is None else mask
    cell_id = (ci[:, 0].to(torch.int64) * ny + ci[:, 1]) * nz + ci[:, 2]
    cell_id = torch.where(valid, cell_id, _NO_CELL)
    perm = torch.argsort(cell_id, stable=True)
    qpos = torch.cat([p32[perm], valid[perm].to(torch.float32)[:, None]], dim=1)
    qcell = torch.cat([ci[perm], perm.to(torch.int32)[:, None]], dim=1)
    return Queries(qpos.contiguous(), qcell.contiguous())


def _finish(k, Q, dtype, idx, d2, cnt, stage, queued) -> KnnResult:
    valid = torch.arange(k, device=cnt.device)[None, :] < cnt[:, None]
    return KnnResult(d2.to(dtype), idx, valid, torch.ones((Q, k), dtype=dtype, device=cnt.device),
                     stage, queued)


def _grid_args(g: Geometry, arrays):
    nx, ny, nz = g.dims
    return [arrays.pos.data_ptr(), arrays.cell_start.data_ptr(), nx, ny, nz, g.n,
            *g.bb, g.cell, *g.hi, g.delta, CELL_BUDGET]


def knn(grid, arrays, points, k: int, mask=None, evaluated=None) -> KnnResult:
    """Exact k-NN over the whole map of the queries `points` (Q, 3), for a
    non-empty grid and k <= KPAD. CUDA tensors go to the CUDA kernels, CPU
    tensors to the plain version; any other device raises. On the card the
    three kernels run back to back on the current stream, with no host sync:
    stage B's kernels read their queues' lengths on the device, which are
    zeroed on the device too, so a call captured into a CUDA graph is right
    at every replay (the library must be built and its launch shape known
    before a capture: an eager call does both).

    `evaluated`, for measurement on the card: a (Q,) int32 CUDA tensor that
    receives the photons each query's kernels evaluated (the plain version,
    which widens its rings one at a time, has no such count)."""
    if points.device.type == "cpu":
        return knn_plain(grid, arrays, points, k, mask)
    if points.device.type != "cuda":
        raise ValueError(f"knn: unsupported device {points.device}")
    if not 1 <= k <= KPAD:
        raise ValueError(f"knn: k={k} outside 1..{KPAD}")
    if grid.n_photons == 0:
        raise ValueError("knn: the photon map is empty")
    pos, cs = arrays.pos, arrays.cell_start
    for name, x, dt in (("pos", pos, torch.float32), ("cell_start", cs, torch.int32)):
        if x.device != points.device or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"knn: {name} must be contiguous {dt} on {points.device}")
    if pos.data_ptr() % 16:
        raise ValueError("knn: pos must start on a 16-byte boundary (the scan's 16-byte copies)")
    if evaluated is not None and (evaluated.device != points.device or evaluated.dtype != torch.int32
                                  or evaluated.shape != (points.shape[0],)):
        raise ValueError("knn: evaluated must be a (Q,) int32 tensor on the queries' device")
    Q = points.shape[0]
    dev = points.device
    q = sort_queries(grid, points, mask)
    new = lambda shape, dt: torch.empty(shape, dtype=dt, device=dev)
    idx, d2 = new((Q, k), torch.int32), new((Q, k), torch.float32)
    cnt, stage = new((Q,), torch.int32), new((Q,), torch.int32)
    queue = new((Q, 2), torch.int32)      # stage A's queue: (sorted query, photons seen)
    queue2 = new((Q,), torch.int32)       # the rings' queue for the scan
    queued = torch.zeros((2,), dtype=torch.int32, device=dev)
    if Q:
        lib = build()
        g = _grid_args(geometry(grid), arrays)
        outs = [idx.data_ptr(), d2.data_ptr(), cnt.data_ptr(), stage.data_ptr(),
                None if evaluated is None else evaluated.data_ptr()]
        qs = [q.qpos.data_ptr(), q.qcell.data_ptr()]
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.mcrt_knn_ring1(*qs, *g, Q, *outs, queue.data_ptr(), queued.data_ptr(), k,
                                     stream)
            _check(err, ring1)
            err = lib.mcrt_knn_rings(*qs, *g, *outs, queue.data_ptr(), queued.data_ptr(),
                                     queue2.data_ptr(), k, stream)
            _check(err, rings)
            err = lib.mcrt_knn_scan(*qs, *g, *outs, queue2.data_ptr(), queued.data_ptr(), k,
                                    stream)
            _check(err, scan)
    return _finish(k, Q, points.dtype, idx, d2, cnt, stage, queued)


def _check(err: int, kern: LaunchCounter):
    if err != 0:
        raise RuntimeError(f"{kern.name} launch failed: error {err}")
    kern.count()


# ---------------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------------

def _keys(qp, rows, pos):
    """(d2 bits << 32 | row) of query rows `qp` (M, 3) against photons `rows` (M,)."""
    p = pos[rows]
    dx, dy, dz = qp[:, 0] - p[:, 0], qp[:, 1] - p[:, 1], qp[:, 2] - p[:, 2]
    d2 = (dx * dx + dy * dy) + dz * dz
    return (d2.view(torch.int32).to(torch.int64) << 32) | rows


def _key_d2(key):
    """The d2 of keys (+inf for an empty slot)."""
    d2 = (key >> 32).to(torch.int32).view(torch.float32)
    return torch.where(key == _INF_KEY, torch.inf, d2)


def ring_box(c, r: int, dims):
    """The ring-r box (lo, hi) (V, 3) int64 of clamped cells `c` (V, 3)."""
    top = torch.as_tensor(dims, device=c.device) - 1
    return torch.clamp(c - r, min=0), torch.minimum(c + r, top)


def _r2_bound(qp, lo, hi, g: Geometry):
    """R2c (V,) float32 of ring boxes [lo, hi] (V, 3): below the d2 of every
    photon outside the box (see the module docstring). The kernels compute it
    with the same float32 operations in the same order."""
    f32 = lambda x: torch.tensor(x, dtype=torch.float32, device=qp.device)
    zero, delta, cell = f32(0.0), f32(g.delta), f32(g.cell)
    o2 = []
    for a in range(3):
        q = qp[:, a]
        out = torch.maximum(torch.maximum(f32(g.bb[a]) - q, q - f32(g.hi[a])), zero)
        o = torch.maximum(out - delta, zero)
        o2.append(o * o)
    r2 = torch.full_like(qp[:, 0], torch.inf)
    for a in range(3):
        b, c = [x for x in range(3) if x != a]
        rest = o2[b] + o2[c]
        q = qp[:, a]
        face_lo = f32(g.bb[a]) + lo[:, a].to(torch.float32) * cell
        gap = torch.maximum((q - face_lo) - delta, zero)
        r2 = torch.where(lo[:, a] > 0, torch.minimum(r2, gap * gap + rest), r2)
        face_hi = f32(g.bb[a]) + (hi[:, a] + 1).to(torch.float32) * cell
        gap = torch.maximum((face_hi - q) - delta, zero)
        r2 = torch.where(hi[:, a] < g.dims[a] - 1, torch.minimum(r2, gap * gap + rest), r2)
    return r2 * f32(_SHRINK)


def _shell_ranges(cs, lo, hi, plo, phi, dims):
    """Photon ranges of the cells of boxes [lo, hi] outside boxes [plo, phi]
    (an empty previous box has plo > phi): (query (P,), s (P,), e (P,)), one or
    two ranges per (x, y) column, as the kernels read them."""
    dev = lo.device
    _, ny, nz = dims
    V = lo.shape[0]
    nys = hi[:, 1] - lo[:, 1] + 1
    ncol = (hi[:, 0] - lo[:, 0] + 1) * nys
    qi = torch.repeat_interleave(torch.arange(V, device=dev), ncol)
    col = torch.arange(qi.shape[0], device=dev) - (torch.cumsum(ncol, 0) - ncol)[qi]
    gx = lo[qi, 0] + torch.div(col, nys[qi], rounding_mode="floor")
    gy = lo[qi, 1] + col % nys[qi]
    inner = ((gx >= plo[qi, 0]) & (gx <= phi[qi, 0]) & (gy >= plo[qi, 1]) & (gy <= phi[qi, 1]))
    z0, z1 = lo[qi, 2], hi[qi, 2]
    base = (gx * ny + gy) * nz
    cs64 = cs.to(torch.int64)
    # first range: the whole z run of an outer column, the part below the
    # previous box of an inner one; second range: the part above it
    a_hi = torch.where(inner, plo[qi, 2] - 1, z1)
    b_lo = torch.where(inner, phi[qi, 2] + 1, z1 + 1)
    out_q, out_s, out_e = [], [], []
    for za, zb in ((z0, a_hi), (b_lo, z1)):
        ok = za <= zb
        s = cs64[base[ok] + za[ok]]
        e = cs64[base[ok] + zb[ok] + 1]
        out_q.append(qi[ok])
        out_s.append(s)
        out_e.append(e)
    return torch.cat(out_q), torch.cat(out_s), torch.cat(out_e)


def _merge_shell(keys, qp, lo, hi, plo, phi, arrays, dims):
    """Fold the photons of each query's shell into its k smallest keys."""
    V, k = keys.shape
    dev = keys.device
    qi, s, e = _shell_ranges(arrays.cell_start, lo, hi, plo, phi, dims)
    lens = e - s
    tot = int(lens.sum())
    if tot == 0:
        return keys
    cq = torch.repeat_interleave(qi, lens)
    rows = (torch.repeat_interleave(s - (torch.cumsum(lens, 0) - lens), lens)
            + torch.arange(tot, device=dev))
    ck = _keys(qp[cq], rows, arrays.pos.to(torch.float32))
    allq = torch.cat([torch.arange(V, device=dev).repeat_interleave(k), cq])
    allk = torch.cat([keys.reshape(-1), ck])
    order = torch.argsort(allk, stable=True)
    order = order[torch.argsort(allq[order], stable=True)]
    sq, sk = allq[order], allk[order]
    per = torch.bincount(allq, minlength=V)
    rank = torch.arange(sq.shape[0], device=dev) - (torch.cumsum(per, 0) - per)[sq]
    keep = rank < k
    out = torch.full_like(keys, _INF_KEY)
    out[sq[keep], rank[keep]] = sk[keep]
    return out


def _scan_keys(qp, pos, n: int, k: int):
    """The k smallest keys of queries `qp` (S, 3) over all n photons."""
    S = qp.shape[0]
    dev = qp.device
    best = torch.full((S, k), _INF_KEY, dtype=torch.int64, device=dev)
    step = max(1024, PLAIN_CHUNK // max(S, 1))
    for a in range(0, n, step):
        rows = torch.arange(a, min(a + step, n), device=dev)
        p = pos[rows]
        dx = qp[:, 0:1] - p[None, :, 0]
        dy = qp[:, 1:2] - p[None, :, 1]
        dz = qp[:, 2:3] - p[None, :, 2]
        d2 = (dx * dx + dy * dy) + dz * dz
        ck = (d2.view(torch.int32).to(torch.int64) << 32) | rows[None, :]
        best = torch.sort(torch.cat([best, ck], dim=1), dim=1).values[:, :k]
    return best


def knn_plain(grid, arrays, points, k: int, mask=None) -> KnnResult:
    """The kernels' staged function in plain PyTorch, with the same keys,
    certification arithmetic and stages. It widens the rings of stage B one
    at a time; the kernels may skip rings, which changes neither the answer
    nor the stage (the first ring that certifies)."""
    if not 1 <= k <= KPAD:
        raise ValueError(f"knn_plain: k={k} outside 1..{KPAD}")
    if grid.n_photons == 0:
        raise ValueError("knn_plain: the photon map is empty")
    dev = points.device
    Q = points.shape[0]
    g = geometry(grid)
    q = sort_queries(grid, points, mask)
    vi = torch.nonzero(q.qpos[:, 3] > 0.5).squeeze(1)
    V = vi.shape[0]
    qp = q.qpos[vi, :3]
    c = q.qcell[vi, :3].to(torch.int64)
    keys = torch.full((V, k), _INF_KEY, dtype=torch.int64, device=dev)
    stage = torch.zeros(V, dtype=torch.int32, device=dev)
    pending = torch.ones(V, dtype=torch.bool, device=dev)
    to_scan = torch.zeros(V, dtype=torch.bool, device=dev)
    plo, phi = c, c - 1                       # ring 0: an empty box
    r = 1
    while bool(pending.any()):
        lo, hi = ring_box(c, r, g.dims)
        if r > 1:   # stage B: past the budget, the scan
            over = pending & ((hi - lo + 1).prod(dim=1) > CELL_BUDGET)
            to_scan |= over
            pending &= ~over
        p = torch.nonzero(pending).squeeze(1)
        kp = _merge_shell(keys[p], qp[p], lo[p], hi[p], plo[p], phi[p], arrays, g.dims)
        keys[p] = kp
        done = _key_d2(kp[:, k - 1]) <= _r2_bound(qp[p], lo[p], hi[p], g)
        stage[p[done]] = r
        pending[p[done]] = False
        plo, phi = lo, hi
        r += 1
    si = torch.nonzero(to_scan).squeeze(1)
    if si.shape[0]:
        keys[si] = _scan_keys(qp[si], arrays.pos.to(torch.float32), g.n, k)
        stage[si] = STAGE_SCAN
    orig = q.qcell[vi, 3].to(torch.int64)
    out_key = torch.full((Q, k), _INF_KEY, dtype=torch.int64, device=dev)
    out_key[orig] = keys
    out_stage = torch.zeros(Q, dtype=torch.int32, device=dev)
    out_stage[orig] = stage
    empty = out_key == _INF_KEY
    idx = torch.where(empty, 0, out_key & 0xFFFFFFFF).to(torch.int32)
    cnt = (~empty).sum(dim=1).to(torch.int32)
    queued = torch.stack([(stage != 1).sum(), to_scan.sum()]).to(torch.int32)
    return _finish(k, Q, points.dtype, idx, _key_d2(out_key), cnt, out_stage, queued)


def certifying_ring(grid, arrays, points, kth_d2, mask=None):
    """Per query (Q,) int64: the smallest ring r whose box certifies the exact
    answer, by the stages' rule and with no cell budget (0 for a masked query).
    `kth_d2` (Q,) is the exact answer's k-th d2 (+inf when k >= N). A ring
    certifies it when kth_d2 <= R2c(r): the ring's own k-th equals the
    answer's exactly then. Computed from the data alone: it is what the bound
    in chip_smoke.py counts and what the ring histogram shows."""
    g = geometry(grid)
    q = sort_queries(grid, points, mask)
    vi = torch.nonzero(q.qpos[:, 3] > 0.5).squeeze(1)
    qp, c = q.qpos[vi, :3], q.qcell[vi, :3].to(torch.int64)
    kth = kth_d2.to(torch.float32)[q.qcell[vi, 3].to(torch.int64)]
    ring = torch.zeros(vi.shape[0], dtype=torch.int64, device=qp.device)
    todo = torch.ones_like(ring, dtype=torch.bool)
    r = 1
    while bool(todo.any()):
        t = torch.nonzero(todo).squeeze(1)
        lo, hi = ring_box(c[t], r, g.dims)
        ok = kth[t] <= _r2_bound(qp[t], lo, hi, g)
        ring[t[ok]] = r
        todo[t[ok]] = False
        r += 1
    out = torch.zeros(points.shape[0], dtype=torch.int64, device=qp.device)
    out[q.qcell[vi, 3].to(torch.int64)] = ring
    return out
