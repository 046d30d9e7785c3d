"""One-ring photon k-NN: the CUDA kernel's wrapper and its plain PyTorch version.

Replaces the JAX package's Pallas TPU kernel `_kernel` in
mcrt_tpu/accel/knn_kernel.py, which `photon_grid.knn(exact=True)` runs for
the photon mapper's radiance estimates. Both versions compute, for queries
sorted by grid cell and cut into blocks of BLOCK = 128:

  1. The block's box: the one-ring (+-1 cell) around its valid queries' cells
     in x and y, clamped to the grid. Its (x, y) columns are walked in
     ascending column order; a column some valid query's one-ring touches is
     read as ONE contiguous photon range [s, e) (the CSR grid has z as its
     fastest axis): the cells from the touching queries' lowest z - 1 to
     their highest z + 1.
  2. Per valid query, the k nearest of the photons read with d2 <= cell_size^2,
     where d2 = (dx*dx + dy*dy) + dz*dz in float32, each product and sum
     rounded on its own. Ties in d2 go to the lower photon row. Slots past
     the count hold id 0 and d2 = +inf.
  3. Per block, stats [columns read, photons read].

Any photon within cell_size of a query lies in its one-ring, so a query that
finds min(k, N) photons has its exact k nearest. The wrapper flags the others
(`needs_exact`) for the caller's brute-force fallback; nothing else is
flagged: the kernel streams every range it needs, so it has no staging or
column cap to overflow. Photon ids are int32 rows, not float32 values.

The wrapper sends CUDA tensors to the kernel (csrc/knn.cu) and CPU tensors
to the plain version, and raises for anything else. On the card the two
agree bit for bit: same candidates, same float32 roundings, same tie rule.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import NamedTuple

import torch

KPAD = 56            # the most neighbours a query can ask for (the TPU kernel's output width)
BLOCK = 128          # queries per block: one CUDA block of 128 threads, as the TPU kernel's K
PLAIN_CHUNK = 1 << 15  # photons per step of the plain version's running selection
_NO_CELL = 1 << 30   # sort key of an invalid query: after every real cell

_SRC = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "knn.cu"
_BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "_build"


class _Kernel:
    """The built CUDA library (loaded at first use) and its launch count."""

    def __init__(self):
        self.lib = None
        self.build_log = ""
        self.launches = 0


kernel = _Kernel()


def build() -> ctypes.CDLL:
    """Compile csrc/knn.cu with nvcc for sm_90a into the package's _build/
    directory (once per source content) and load it with ctypes."""
    if kernel.lib is not None:
        return kernel.lib
    src = _SRC.read_bytes()
    tag = hashlib.sha1(src).hexdigest()[:12]
    lib_path = _BUILD_DIR / f"libknn_{tag}.so"
    log_path = _BUILD_DIR / f"libknn_{tag}.log"
    if not lib_path.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
               "-o", str(tmp), str(_SRC)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
        log_path.write_text(res.stdout + res.stderr)
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.mcrt_knn.argtypes = [vp] * 8 + [ci] * 5 + [ctypes.c_float, vp]
    lib.mcrt_knn.restype = ci
    kernel.build_log = log_path.read_text() if log_path.exists() else ""
    kernel.lib = lib
    return lib


class Queries(NamedTuple):
    """Queries sorted by cell and padded to whole blocks (shared by both versions)."""
    qpos: torch.Tensor    # (B*BLOCK, 4) float32: x, y, z, valid (1.0 or 0.0)
    qcell: torch.Tensor   # (B*BLOCK, 4) int32: cx, cy, cz, original query index (-1: padding)
    n_blocks: int
    cell2: float          # cell_size^2 rounded to float32


class KnnResult(NamedTuple):
    d2: torch.Tensor           # (Q, k) in the queries' dtype, +inf in empty slots
    idx: torch.Tensor          # (Q, k) int32 photon rows, 0 in empty slots
    valid: torch.Tensor        # (Q, k) bool
    w: torch.Tensor            # (Q, k) flux weights (all 1: every photon is read)
    needs_exact: torch.Tensor  # (Q,) bool: fewer than min(k, N) found, among `mask`
    stats: torch.Tensor        # (B, 2) int32: [columns read, photons read] per block


def sort_queries(grid, points, mask=None) -> Queries:
    """Cell of each query (float32: floor((p - bb_min) * (1 / cell)), clamped),
    a stable sort by cell id with invalid queries last, and padding to BLOCK.
    The grid's constants enter as Python scalars: a tensor built from host
    values would synchronise the device at every call."""
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
    B = -(-Q // BLOCK)
    qpos = torch.zeros((B * BLOCK, 4), dtype=torch.float32, device=dev)
    qcell = torch.full((B * BLOCK, 4), -1, dtype=torch.int32, device=dev)
    qpos[:Q, :3] = p32[perm]
    qpos[:Q, 3] = valid[perm].to(torch.float32)
    qcell[:Q, :3] = ci[perm]
    qcell[:Q, 3] = perm.to(torch.int32)
    cell2 = float(torch.tensor(grid.cell_size * grid.cell_size, dtype=torch.float32))
    return Queries(qpos, qcell, B, cell2)


def _finish(grid, k, Q, mask, dtype, idx, d2, cnt, stats) -> KnnResult:
    slots = torch.arange(k, device=cnt.device)
    valid = slots[None, :] < cnt[:, None]
    want = min(k, grid.n_photons)
    needs = cnt < want
    if mask is not None:
        needs = needs & mask
    return KnnResult(d2.to(dtype), idx, valid, torch.ones((Q, k), dtype=dtype, device=cnt.device),
                     needs, stats)


def knn(grid, arrays, points, k: int, mask=None) -> KnnResult:
    """Exact one-ring k-NN of the queries `points` (Q, 3) among the photons of a
    non-empty grid, for k <= KPAD. CUDA tensors go to the CUDA kernel, CPU
    tensors to the plain version; any other device raises."""
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
    Q = points.shape[0]
    dev = points.device
    q = sort_queries(grid, points, mask)
    idx = torch.empty((Q, k), dtype=torch.int32, device=dev)
    d2 = torch.empty((Q, k), dtype=torch.float32, device=dev)
    cnt = torch.empty((Q,), dtype=torch.int32, device=dev)
    stats = torch.empty((q.n_blocks, 2), dtype=torch.int32, device=dev)
    if q.n_blocks:
        lib = build()
        nx, ny, nz = grid.dims
        with torch.cuda.device(dev):
            err = lib.mcrt_knn(
                q.qpos.data_ptr(), q.qcell.data_ptr(), pos.data_ptr(), cs.data_ptr(),
                idx.data_ptr(), d2.data_ptr(), cnt.data_ptr(), stats.data_ptr(),
                q.n_blocks, k, nx, ny, nz, q.cell2, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            raise RuntimeError(f"knn kernel launch failed: error {err}")
        kernel.launches += 1
    return _finish(grid, k, Q, mask, points.dtype, idx, d2, cnt, stats)


def block_columns(grid, arrays, q: Queries):
    """The photon ranges each block reads: (block (P,), s (P,), e (P,)) int64 over
    the columns some valid query touches, in the kernel's order, and the
    per-block stats (B, 2) int32."""
    dev = q.qpos.device
    B, K = q.n_blocks, BLOCK
    nx, ny, nz = grid.dims
    valid = (q.qpos[:, 3] > 0.5).view(B, K)
    c = q.qcell[:, :3].to(torch.int64).view(B, K, 3)
    cx, cy, cz = c[..., 0], c[..., 1], c[..., 2]
    lo = lambda x: torch.where(valid, x, _NO_CELL).amin(dim=1)
    hi = lambda x: torch.where(valid, x, -1).amax(dim=1)
    x0, x1 = torch.clamp(lo(cx) - 1, min=0), torch.clamp(hi(cx) + 1, max=nx - 1)
    y0, y1 = torch.clamp(lo(cy) - 1, min=0), torch.clamp(hi(cy) + 1, max=ny - 1)
    nys = y1 - y0 + 1
    ncols = torch.where(valid.any(dim=1), (x1 - x0 + 1) * nys, 0)
    blk = torch.repeat_interleave(torch.arange(B, device=dev), ncols)
    first = torch.cumsum(ncols, 0) - ncols
    col = torch.arange(blk.shape[0], device=dev) - first[blk]
    gx = x0[blk] + torch.div(col, nys[blk], rounding_mode="floor")
    gy = y0[blk] + col % nys[blk]
    z0 = torch.empty_like(gx)
    z1 = torch.empty_like(gx)
    step = max(1, (1 << 22) // K)           # (columns, K) touch masks a slab at a time
    for a in range(0, blk.shape[0], step):
        sb = blk[a:a + step]
        touch = (valid[sb] & ((cx[sb] - gx[a:a + step, None]).abs() <= 1)
                 & ((cy[sb] - gy[a:a + step, None]).abs() <= 1))
        z0[a:a + step] = torch.where(touch, cz[sb], _NO_CELL).amin(dim=1)
        z1[a:a + step] = torch.where(touch, cz[sb], -1).amax(dim=1)
    keep = z1 >= 0
    blk, gx, gy, z0, z1 = blk[keep], gx[keep], gy[keep], z0[keep], z1[keep]
    base = (gx * ny + gy) * nz
    cs = arrays.cell_start
    s = cs[base + torch.clamp(z0 - 1, min=0)].to(torch.int64)
    e = cs[base + torch.clamp(z1 + 1, max=nz - 1) + 1].to(torch.int64)
    walked = torch.bincount(blk, minlength=B)
    read = torch.zeros(B, dtype=torch.int64, device=dev).index_add_(0, blk, e - s)
    return blk, s, e, torch.stack([walked, read], dim=1).to(torch.int32)


def knn_plain(grid, arrays, points, k: int, mask=None) -> KnnResult:
    """The kernel's function in plain PyTorch: per block, the rows of its columns
    in ascending order, float32 distances, and a running stable sort (ties in
    d2 keep the lower row), PLAIN_CHUNK photons at a time."""
    if not 1 <= k <= KPAD:
        raise ValueError(f"knn_plain: k={k} outside 1..{KPAD}")
    dev = points.device
    Q = points.shape[0]
    q = sort_queries(grid, points, mask)
    blk, s, e, stats = block_columns(grid, arrays, q)
    pos = arrays.pos.to(torch.float32)
    out_idx = torch.zeros((Q, k), dtype=torch.int32, device=dev)
    out_d2 = torch.full((Q, k), torch.inf, dtype=torch.float32, device=dev)
    out_cnt = torch.zeros((Q,), dtype=torch.int32, device=dev)
    # All rows the blocks read, block after block, and where each block's begin.
    lens = e - s
    rows = (torch.repeat_interleave(s - (torch.cumsum(lens, 0) - lens), lens)
            + torch.arange(int(lens.sum()), device=dev))
    per_block = torch.zeros(q.n_blocks, dtype=torch.int64, device=dev).index_add_(0, blk, lens)
    bounds = [0] + torch.cumsum(per_block, 0).tolist()
    for b in range(q.n_blocks):
        if bounds[b + 1] == bounds[b]:
            continue
        qp = q.qpos[b * BLOCK:(b + 1) * BLOCK]
        vq = qp[:, 3:4] > 0.5
        best_d2 = torch.full((BLOCK, k), torch.inf, dtype=torch.float32, device=dev)
        best_ix = torch.zeros((BLOCK, k), dtype=torch.int32, device=dev)
        for a in range(bounds[b], bounds[b + 1], PLAIN_CHUNK):
            r = rows[a:min(a + PLAIN_CHUNK, bounds[b + 1])]
            p = pos[r]
            dx = qp[:, 0:1] - p[None, :, 0]
            dy = qp[:, 1:2] - p[None, :, 1]
            dz = qp[:, 2:3] - p[None, :, 2]
            d2 = dx * dx + dy * dy + dz * dz
            d2 = torch.where(vq & (d2 <= q.cell2), d2, torch.inf)
            cat_d2 = torch.cat([best_d2, d2], dim=1)
            cat_ix = torch.cat([best_ix, r.to(torch.int32).expand(BLOCK, -1)], dim=1)
            sd2, sel = torch.sort(cat_d2, dim=1, stable=True)
            best_d2 = sd2[:, :k]
            best_ix = torch.gather(cat_ix, 1, sel[:, :k])
        found = torch.isfinite(best_d2)
        orig = q.qcell[b * BLOCK:(b + 1) * BLOCK, 3].to(torch.int64)
        real = orig >= 0
        out_idx[orig[real]] = torch.where(found, best_ix, 0)[real]
        out_d2[orig[real]] = best_d2[real]
        out_cnt[orig[real]] = found.sum(dim=1).to(torch.int32)[real]
    return _finish(grid, k, Q, mask, points.dtype, out_idx, out_d2, out_cnt, stats)
