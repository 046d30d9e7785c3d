"""Cluster-BVH traversal: the CUDA kernel's wrapper and its plain PyTorch version.

Replaces the JAX package's Pallas TPU kernel `_kernel` in
mcrt_tpu/ops/traverse_kernel.py (fused cull + best-first cluster traversal).
For one block of K coherence-sorted rays both versions compute:

  1. CULL: slab-test every cluster AABB, giving each (ray, cluster) entry
     distance (BIG = miss). A cluster some ray of the block hits is a
     candidate; `candidates` counts them.
  2. ROUNDS: a cluster's key is the least entry distance among the rays whose
     entry lies below their best t (exact per-ray pruning); BIG when there is
     none. The first cluster is the candidate of least key with every best t at
     BIG. Then, each round, the NEXT cluster is chosen and marked visited from
     the best t of before the current visit, and only then is the current
     cluster evaluated: the TPU kernel's order, whose choice is one round stale
     so that the next record can be in flight while the current one is
     evaluated. Ties go to the lower cluster index. The rounds stop when the
     current choice's key is BIG. A visit evaluates the cluster's
     Moller-Trumbore forms for every ray of the block and keeps, per ray, the
     nearest valid hit: the first minimum within a cluster, and a strict
     `t < best` across clusters. `rounds` counts visits.

Per ray the result is (t, tri_id, u, v) of the closest hit (BIG, -1, 0, 0 on a
miss); per block [candidates, rounds], with the same meaning as the TPU
kernel's stats. Parked rays (|origin| ~ 2e30) miss every AABB, so a block of
them runs zero rounds.

The kernel (csrc/traverse.cu) chooses with a lazy heap in a producer warp and
stages records by TMA while two threads per ray evaluate the forms, as chains
of FP32 fused multiply-adds; with float32 tables the plain version computes
the same fused multiply-adds exactly (`_fma`), so on the card the two agree bit
for bit, stats included. The wrapper sends CUDA tensors to the kernel and CPU
tensors to the plain version, and raises for anything else.

A launch whose B blocks can all be resident as two-CTA clusters (`pair_width`,
from the clusters the card fits at the launch's shared memory) runs each block
as a pair of CTAs that split every round's triangles; the results are the same
bit for bit. A larger B keeps one CTA a block.

`kernel.launches` counts the kernel's launches that ran. A launch made while
the stream is captured into a CUDA graph runs nothing and is counted in
`kernel.captured` instead; each replay of the graph adds the launches it holds
(utils/cuda_graph.CapturedStep). The forward render's graphed bounce step
holds two, so a render counts two launches a bounce step, as an eager loop
does. `paired` counts the launches that ran as two-CTA clusters, alike.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

import torch

from ..utils.cuda_graph import LaunchCounter

BIG = 3.4e38  # slightly under f32 max: "no hit" sentinel
BLOCK = 256   # rays per block (K), as the TPU kernel's K; the CUDA block has 2 x 256 + 32 threads
TILE = 1024   # clusters per slab of the plain version's entry-distance matrix
# Per-block clock64() counters of the kernel's stamping variant (traverse_cycles).
CYCLES = ("total", "cull", "select", "load", "producer_wait", "staging_wait", "forms")

_SRC = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "traverse.cu"
_BUILD_DIR = pathlib.Path(__file__).resolve().parents[1] / "_build"
_ERR_SMEM = -1  # mcrt_traverse: the record buffers do not fit in shared memory


class _Kernel(LaunchCounter):
    """The built CUDA library (loaded at first use) and its launch counts."""

    def __init__(self):
        super().__init__("traverse_kernel")
        self.lib = None
        self.build_log = ""


kernel = _Kernel()
paired = LaunchCounter("traverse_kernel_paired")   # launches of two-CTA clusters


def compile_source(src: pathlib.Path, stem: str) -> tuple[pathlib.Path, str]:
    """Compile one .cu file with nvcc for sm_90a into the package's _build/
    directory as lib{stem}_{hash}.so, once per source content; returns the
    library's path and ptxas's report (registers, shared memory, spills)."""
    tag = hashlib.sha1(src.read_bytes()).hexdigest()[:12]
    lib_path = _BUILD_DIR / f"lib{stem}_{tag}.so"
    log_path = _BUILD_DIR / f"lib{stem}_{tag}.log"
    if not lib_path.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
        tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC",
               "-o", str(tmp), str(src)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stdout}\n{res.stderr}")
        log_path.write_text(res.stdout + res.stderr)
        os.replace(tmp, lib_path)
    return lib_path, log_path.read_text() if log_path.exists() else ""


def build() -> ctypes.CDLL:
    """Compile csrc/traverse.cu (once per source content) and load it with ctypes."""
    if kernel.lib is not None:
        return kernel.lib
    lib_path, log = compile_source(_SRC, "traverse")
    lib = ctypes.CDLL(str(lib_path))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.mcrt_traverse.argtypes = [vp] * 13 + [ci] * 5 + [vp]
    lib.mcrt_traverse.restype = ci
    lib.mcrt_traverse_pairs.argtypes = [ci] * 3
    lib.mcrt_traverse_pairs.restype = ci
    lib.mcrt_traverse_heap_shared.restype = ci
    lib.mcrt_traverse_ncycles.restype = ci
    if lib.mcrt_traverse_ncycles() != len(CYCLES):
        raise RuntimeError("csrc/traverse.cu and CYCLES disagree on the cycle counters")
    kernel.build_log = log
    kernel.lib = lib
    return lib


def heap_shared() -> int:
    """Candidates a block keeps in its shared-memory heap; a block with more
    keeps the heap in global scratch (CUDA only: builds the kernel)."""
    return build().mcrt_traverse_heap_shared()


def pair_width(blocks: int, resident_pairs: int) -> int:
    """CTAs per ray block of a launch of `blocks` blocks: 2 when every block
    can run as a two-CTA cluster at once (`resident_pairs` of them fit on the
    card), else 1. Pairs that had to wait for each other's SMs would add the
    pair's barriers and buy nothing."""
    return 2 if blocks <= resident_pairs else 1


def resident_pairs(K: int, C: int, Sp: int) -> int:
    """Two-CTA clusters of the kernel that fit on the current card at once at
    the shared memory of a launch of this shape (CUDA's occupancy API, queried
    once per device and size; builds the kernel)."""
    return build().mcrt_traverse_pairs(K, C, Sp)


def ray_features(origin, direction, dtype=torch.float32):
    """(R,3) rays -> ((B, K, 12) [d, 0, o, 0, d x o, 0] in `dtype`, K).

    R is padded to a multiple of K by repeating the last ray, as the JAX package
    does. K is BLOCK, or R rounded up to whole warps of 32 when R is smaller
    (a CUDA block is a whole number of warps). The cross product is taken in
    the input dtype."""
    R = origin.shape[0]
    K = min(BLOCK, -(-R // 32) * 32)
    pad = (-R) % K
    if pad:
        origin = torch.cat([origin, origin[-1:].expand(pad, 3)])
        direction = torch.cat([direction, direction[-1:].expand(pad, 3)])
    cr = torch.linalg.cross(direction, origin)
    z = torch.zeros_like(origin[:, :1])
    ft = torch.cat([direction, z, origin, z, cr, z], dim=1).to(dtype)
    return ft.reshape(-1, K, 12).contiguous(), K


def _fma(a, b, c):
    """a * b + c rounded once, as the kernel's fmaf, for float32 tensors.

    The float32 product is exact in float64; the float64 sum is rounded to odd
    (TwoSum gives its exact error, and an inexact even result steps one ulp
    toward the exact value), and rounding a round-to-odd float64 to float32
    is correctly rounded. Other dtypes: a * b + c."""
    if a.dtype != torch.float32:
        return a * b + c
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    bp = s - p
    err = (p - (s - bp)) + (c - bp)                       # p + c == s + err exactly
    even = (s.view(torch.int64) & 1) == 0
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    return torch.where((err != 0) & even, torch.nextafter(s, toward), s).float()


def _unpad(R, t, tid, u, v):
    return t.reshape(-1)[:R], tid.reshape(-1)[:R], u.reshape(-1)[:R], v.reshape(-1)[:R]


def traverse(cbvh, origin, direction):
    """Closest triangle hit per ray: (t, tri_id, u, v, stats (B, 2) int32).

    CUDA tensors go to the CUDA kernel, CPU tensors to the plain version;
    any other device raises."""
    if origin.device.type == "cpu":
        return traverse_plain(cbvh, origin, direction)
    return _launch(cbvh, origin, direction, stamp=False)


def traverse_cycles(cbvh, origin, direction):
    """The kernel's stamping variant, for measurement only: traverse's outputs
    plus (CTAs, len(CYCLES)) int64 clock64() cycles per CTA: one row a block,
    or, in a paired launch, rows 2b and 2b + 1 for block b's leader and peer.
    Cull runs to the first keys; select (heap build included), load (ids and
    the TMA issues) and producer_wait are the producer warp's (the leader's: a
    peer's read 0); staging_wait and forms (the rounds) are consumer thread
    0's. CUDA tensors only."""
    return _launch(cbvh, origin, direction, stamp=True)


def _launch(cbvh, origin, direction, stamp, width=None):
    """One launch; `width` (1 or 2 CTAs a block) forces the launch shape, for
    tests, in place of pair_width."""
    if origin.device.type != "cuda":
        raise ValueError(f"traverse: unsupported device {origin.device}")
    for name in ("cl_bb", "rec", "tri"):
        x = getattr(cbvh, name)
        if x.device != origin.device or not x.is_contiguous():
            raise ValueError(f"cluster table {name} must be contiguous on {origin.device}")
    if cbvh.rec.dtype != torch.float32 or cbvh.tri.dtype != torch.int32:
        raise ValueError("cluster tables must be float32 records and int32 ids")
    C, Sp, _ = cbvh.rec.shape
    if Sp % 4 or any(getattr(cbvh, n).data_ptr() % 16 for n in ("cl_bb", "rec", "tri")):
        raise ValueError("cluster tables must be 16-byte aligned, with Sp a multiple of 4")
    R = origin.shape[0]
    ft, K = ray_features(origin, direction)
    B = ft.shape[0]
    lib = build()
    dev = origin.device
    f32, i32 = torch.float32, torch.int32
    tn = torch.empty((B, C, K), dtype=f32, device=dev)
    cand = torch.empty((B, C), dtype=i32, device=dev)
    heap = torch.empty((B, C), dtype=torch.int64, device=dev) if C > heap_shared() else None
    t = torch.empty((B, K), dtype=f32, device=dev)
    tid = torch.empty((B, K), dtype=i32, device=dev)
    u = torch.empty((B, K), dtype=f32, device=dev)
    v = torch.empty((B, K), dtype=f32, device=dev)
    stats = torch.empty((B, 2), dtype=i32, device=dev)
    ptr = lambda x: None if x is None else x.data_ptr()
    with torch.cuda.device(dev):
        if width is None:
            width = pair_width(B, resident_pairs(K, C, Sp))
        cycles = (torch.zeros((width * B, len(CYCLES)), dtype=torch.int64, device=dev)
                  if stamp else None)
        err = lib.mcrt_traverse(
            ft.data_ptr(), cbvh.cl_bb.data_ptr(), cbvh.rec.data_ptr(), cbvh.tri.data_ptr(),
            tn.data_ptr(), cand.data_ptr(), ptr(heap), t.data_ptr(), tid.data_ptr(), u.data_ptr(),
            v.data_ptr(), stats.data_ptr(), ptr(cycles), B, K, C, Sp, width,
            torch.cuda.current_stream(dev).cuda_stream)
    if err == _ERR_SMEM:
        raise ValueError(f"traverse: two records of {Sp} triangles do not fit in shared memory")
    if err != 0:
        raise RuntimeError(f"traverse kernel launch failed: CUDA error {err}")
    kernel.count()
    if width == 2:
        paired.count()
    out = (*_unpad(R, t, tid, u, v), stats)
    return (*out, cycles) if stamp else out


def traverse_plain(cbvh, origin, direction):
    """The kernel's function in plain PyTorch, blocks processed in lockstep.

    With float32 tables: the kernel's float32 operations, its fused
    multiply-adds included, with the same roundings. Float64 tables (CPU parity runs) run the same algorithm
    in float64. The entry distance matrix is built TILE clusters at a time."""
    return _plain(cbvh, origin, direction)[:5]


def visited_clusters(cbvh, origin, direction):
    """(B, C) bool: the clusters each ray block visits (its `rounds` of them),
    from the plain version; for counting the work a traversal does."""
    return _plain(cbvh, origin, direction)[5]


def _plain(cbvh, origin, direction):
    R = origin.shape[0]
    fdt = cbvh.rec.dtype
    ft, K = ray_features(origin, direction, fdt)
    B = ft.shape[0]
    dev = ft.device
    big = torch.tensor(BIG, dtype=fdt, device=dev)
    d, o, cr = ft[..., 0:3], ft[..., 4:7], ft[..., 8:11]
    inv = 1.0 / d
    C = cbvh.rec.shape[0]

    # ---- 1. cull: (B, K, C) entry distance, BIG = miss ----
    tn = torch.empty((B, K, C), dtype=fdt, device=dev)
    for c0 in range(0, C, TILE):
        bb = cbvh.cl_bb[c0:c0 + TILE]
        t1 = (bb[:, 0:3] - o[..., None, :]) * inv[..., None, :]     # (B, K, ct, 3)
        t2 = (bb[:, 4:7] - o[..., None, :]) * inv[..., None, :]
        lo = torch.minimum(t1, t2)
        hi = torch.maximum(t1, t2)
        tnear = torch.maximum(torch.maximum(lo[..., 0], lo[..., 1]), lo[..., 2])
        tfar = torch.minimum(torch.minimum(hi[..., 0], hi[..., 1]), hi[..., 2])
        hit = (tnear <= tfar) & (tfar >= 0.0)
        tn[..., c0:c0 + TILE] = torch.where(hit, tnear, big)
    n_cand = (tn.amin(dim=1) < big).sum(dim=1)

    # ---- 2. best-first rounds, in the TPU kernel's order: the next cluster is
    # chosen from the best t of before the current visit ----
    visited = torch.zeros((B, C), dtype=torch.bool, device=dev)
    rounds = torch.zeros(B, dtype=torch.int64, device=dev)
    bt = torch.full((B, K), BIG, dtype=fdt, device=dev)
    bid = torch.full((B, K), -1, dtype=torch.int32, device=dev)
    bu = torch.zeros((B, K), dtype=fdt, device=dev)
    bv = torch.zeros((B, K), dtype=fdt, device=dev)

    def choose(live):
        """Per block the unvisited cluster of least key (first minimum), marked
        visited where it is live; (cluster, live)."""
        key = torch.where(tn < bt[..., None], tn, big).amin(dim=1)       # (B, C)
        kmin, cl = torch.min(key.masked_fill(visited, BIG), dim=1)
        live = live & (kmin < big)
        lb = torch.nonzero(live).squeeze(1)
        visited[lb, cl[lb]] = True
        return cl, live

    cl, live = choose(torch.ones(B, dtype=torch.bool, device=dev))
    for _ in range(C):
        if not bool(live.any()):
            break
        lb = torch.nonzero(live).squeeze(1)
        c = cl[lb]
        rounds += live
        cl, live = choose(live)
        rec = cbvh.rec[c][:, None]                                        # (L, 1, Sp, W)
        tri = cbvh.tri[c][:, None]                                        # (L, 1, Sp)
        r = lambda i: rec[..., i]
        dd, oo, cc = d[lb][..., None, :], o[lb][..., None, :], cr[lb][..., None, :]
        f = lambda x, i: x[..., i]
        # The kernel's chains: the first product, then each term fused into the sum.
        det = _fma(f(dd, 2), r(2), _fma(f(dd, 1), r(1), f(dd, 0) * r(0)))
        udet = f(dd, 0) * r(3)
        vdet = f(dd, 0) * r(9)
        for i, (x, j) in enumerate(((dd, 1), (dd, 2), (cc, 0), (cc, 1), (cc, 2))):
            udet = _fma(f(x, j), r(4 + i), udet)
            vdet = _fma(f(x, j), r(10 + i), vdet)
        tdet = _fma(f(oo, 2), r(17), _fma(f(oo, 1), r(16), f(oo, 0) * r(15))) + r(18)
        inv_det = 1.0 / torch.where(det == 0.0, torch.ones_like(det), det)
        u = udet * inv_det
        v = vdet * inv_det
        t = tdet * inv_det
        btl = bt[lb][..., None]
        valid = ((det != 0.0) & (tri >= 0) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0) & (v <= 1.0)
                 & (u + v <= 1.0) & (t > 0.0) & (t < btl))
        tbest, s = torch.min(torch.where(valid, t, big), dim=2)           # first minimum
        improved = tbest < big
        pick = lambda x: torch.gather(x.expand(valid.shape), 2, s[..., None])[..., 0]
        bt[lb] = torch.where(improved, tbest, bt[lb])
        bid[lb] = torch.where(improved, pick(tri), bid[lb])
        bu[lb] = torch.where(improved, pick(u), bu[lb])
        bv[lb] = torch.where(improved, pick(v), bv[lb])
    stats = torch.stack([n_cand, rounds], dim=1).to(torch.int32)
    return (*_unpad(R, bt, bid, bu, bv), stats, visited)
