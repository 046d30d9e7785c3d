#!/usr/bin/env python3
"""GPU smoke run of mcrt_tpu_torch, the PyTorch + CUDA port of the renderer.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py            # about 1M triangles, 512x512; no options

Phases (each prints its own lines; any failed check exits non-zero):
  1. device   the card's name and power limit (nvidia-smi); no card, no run
  2. build    nvcc builds the three kernel sources, mcrt_tpu_torch/csrc/traverse.cu,
              csrc/knn.cu and csrc/gather_bwd.cu (and the parent's traverse.cu and
              knn.cu when they are handed in at chip_old/), in parallel, and prints
              ptxas's register and spill lines
  3. kernel   the traversal kernel against its plain PyTorch version on the card, on camera
              rays, random rays from surface points, shadow rays, a parked block
              and mixed live/dead blocks, one CTA a block and as two-CTA
              clusters: ids, t, u, v and per-block stats identical bit for bit,
              parked block zero rounds; then, per set at the main path's launch
              shape (paired by the rule), kernel and plain timed (and the
              parent's kernel in turns with this one: old, new, new, old; and
              this one forced to one CTA a block), the candidates and rounds per
              block, the share of SMs that hold a CTA, the bound counted from the
              clusters each block visits, and the split of a launch's clock64()
              cycles per CTA (a pair's leaders and peers apart); then the
              camera and surface rays at LARGE_LAUNCH rays, one CTA a block by
              the rule, in turns with the parent's kernel
  4. render   mcrt_tpu_torch.render of the height-field scene at 512x512, 16 spp,
              max_bounces 64, default RenderConfig, with the kernel's launch count
              reset before and read after: the bounce step captured once as a
              CUDA graph and replayed. Then the same render with the step called
              eagerly (eager_render) and graphed again, timed in turns: launches
              (2 a bounce step), bounce steps and rays identical, images within
              rtol 2e-4, atol 2e-5 (and, given the parent's kernel, the same
              render through it and through this one in turns); then profiled
              1-spp renders, graphed and eager, for the device-busy share and the
              kernel's share of device time
     4b.      at 64x64, 4 spp: the graphed render against the eager loop with the
              same bars, rays, bounce steps and launches; then one chunk driven
              bounce by bounce, whose captured traversal launch is held to the
              plain version bit for bit after replay 1 and replay 3, and the graph
              pool's size
  5. compare  the same scene at 64x64, 4 spp, through the kernel (4b's graphed
              render) and through the plain traversal on the card (the eager
              loop: the plain version syncs, so it cannot be captured), held to
              the golden-image bars
  6. photon   the photon mapper's main path: render(integrator="photon_mapper") of
              the same height field with the photon_map block of
              tests/scenes/caustic_sphere.json (5e5 emissions x 10 caustic_factor,
              k = 50) at 512x512, 4 spp, max_bounces 64, with all four kernels'
              launch counts reset before and read after, and no call of the brute
              fallback allowed: the emission and the eye pass each capture their
              step once as a CUDA graph and replay it. Then the same render with
              every step called eagerly (eager_loops) and graphed again, in turns:
              stored photon rows, photon counts, launches (traversal one an
              emission step and two a bounce step, each k-NN kernel two a bounce
              step), emission and bounce steps and the k-NN counts identical,
              images within rtol 2e-4, atol 2e-5; the photon pass's and the eye
              pass's walls each way, and the graphs' pools; then a profiled 1-spp
              eye pass, graphed and eager, for the device-busy share and the top
              kernels, which must run no topk kernel; then the graphed cell once
              more, its photon pass and its 4-spp eye pass each profiled on its
              own, for each pass's device-busy share and top kernels
     6b.      the 64x64 camera at 16 spp as one chunk through a StreamedEyePass on
              phase 6's maps, driven bounce by bounce: the captured k-NN calls
              (caustic and global) held to the plain version bit for bit after
              replay 1 and replay 3 (ids, d2, counts, stages, queue counts), then
              the chunk against the eager loop with phase 6's bars
     6c.      k = 64, over the kernels' width: the 64x64 camera at 1 spp through a
              StreamedEyePass on phase 6's maps, whose exact k-NN is the capped
              search with its brute force at a fixed shape: captured (no k-NN
              kernel launched, some queries re-answered by the brute force) and
              held to the eager loop with phase 6's bars
  7. knn      the three k-NN kernels (ring 1, widening rings, whole-map scan)
              against their plain version on the card, on the photon render's two
              maps and three query sets (first-bounce hits of 16384 camera rays,
              random mesh points, the hits with every other query masked): ids,
              d2, counts, stages and queue counts identical; the share of queries
              each stage answers, the ring histograms, and the photons evaluated
              per query against those of its own cells; photon_grid.knn in float32
              under CUDA's sync debug mode; then the kernels, the plain version
              (and the parent's kernel with the brute fallback on its flagged
              rows, in turns) timed at the eye pass's launch shape (16384
              queries, k = 50), with the bound counted from the rings that
              certify each query, and the library route to the same k-NN
              (torch.cdist without the matrix product, then torch.topk: two
              calls), its k-th d2 within rtol 1e-6 of the kernels'
  8. golden   tests/scenes/caustic_sphere.json photon-rendered at 48x48, 64 spp,
              2e5 emissions, against the C++ reference's
              tests/goldens/caustic_sphere_48_s8.tga with tests/test_e2e_golden.py's bars
  9. grad     the differentiable path on the height field, float32; on the card
              each trip replays two captured CUDA graphs (utils/cuda_graph.GraphedTrip:
              G_f the trip, G_b its recompute plus backward), captured at a loop's
              first call:
              a. three plain SGD steps of parallel.sharding.train_step(with_bvh=True)
                 at 512x512, 1 spp, max_bounces 64, from perturbed material tables
                 toward a target rendered at the scene's own, and step 0 again eagerly
                 (each trip under torch.utils.checkpoint) and graphed, in turns
                 (graphed, eager, graphed); each step's forward and backward run under
                 CUDA's sync debug mode set to error, and print the loss, the forward
                 and backward times (CUDA events), the traversal launches of the
                 forward and of the backward's recompute (128 + 128 both ways), the
                 material gather backward's kernel calls (64, one a G_b replay, and
                 65 in the capturing step; 64 eagerly; the count set to 0 before
                 the steps and read after them), and the peak memory; the loss and gradients must be finite, the
                 reflectance gradient nonzero, and the loss must fall; eager against
                 graphed: loss rtol 1e-5, gradients within 1e-4 of each table's
                 largest |g|; the memory the graphed step holds (with the trip's pool
                 and static buffers) at most 1.25x the eager step's; the step's Python
                 called 3 times in step 0 (the eager first trip and two captures) and
                 never after; the last step profiled (device-busy share, the top
                 kernels); three replayed launches (262,144 rays, 1024 blocks), G_f's
                 after its replay 8 and G_b's two after its replay 64, held to the
                 plain version, bit for bit as in phase 3; then the gather backward's
                 kernel at the train cell's shape (262,144 float32 rows of 27
                 columns, 4 materials) on card tensors: bit for bit with its plain
                 twin and with its float64 sum rounded once, within 1e-12 of
                 index_put_'s float64 sum, and timed against the twin, index_put_
                 in float64 and its bound
              b. bench.py's bench_bwd point through mcrt_tpu_torch.bench.bench_bwd:
                 trace_streamed(fixed_trips=64) over 2^17 paths a chunk at 1024 spp
                 through 8192 lanes, loss mean(pixel mean^2) over the four tables, a
                 warm-up chunk and then four timed (phase 11a's bench times the
                 point at bench.py's own chunk, 2^19 paths through 32768 lanes):
                 rays traced per second forward+backward
                 graphed, and around it, through bench.bwd_chunk, forward alone
                 (no_grad, the same rays), the traversal launches per trip (2 + 2),
                 chunk 0 graphed (capturing), eagerly and graphed again in turns,
                 timed, with 9a's bars against the eager one, the peak memory with
                 and without remat, and a profiled graphed chunk's device-busy
                 share and the traversal's share of device time; three replayed
                 launches of chunk 0 (8192 rays), G_f's after its replay 8 and G_b's
                 two after its replay 56 (trip 8), held to the plain version
              c. the 64x64 camera, 1 spp, max_bounces 8, remat off: the loss and the
                 four gradient tables through the kernel, through the plain traversal
                 (patched in as in phase 5) and through the kernel again; losses
                 identical, gradients within 1e-4 of each table's largest |g|
  10. multi   the sharded steps of parallel/ on torch.distributed, on the same scene
              at 512x512, 1 spp, max_bounces 64, each with the traversal's launch count
              set to 0 before it and read after (it must be > 0):
              a. a world of one over NCCL in this process: sharded_train_step(with_bvh=True)
                 at 9a's first step's inputs (its trips graphed, as in 9a; the first
                 call of each step captures), under CUDA's sync debug mode set to error,
                 held to that step (loss rtol 1e-5, gradients within 1e-4 of each table's
                 largest |g|), the gather backward's kernel calls (set to 0 before,
                 65 after); then train_step and that sharded step timed in turns
                 (train, sharded, sharded, train); sharded_render_step and
                 render_distributed, held to render(sqrtspp=1) with
                 tests/test_distributed.py's bars (rtol 2e-4, atol 2e-5); walls,
                 launches, peak memory and each batch run's graph pool (their bounce
                 loops replay a captured step, path_tracer.BatchTrace); two launches of
                 render_distributed's first chunk (131,072 rays, 512 blocks) held to
                 the plain version: bounce 0's (eager) and bounce 8's, read from the
                 graph's static tensors after replay 8
              b. two gloo ranks sharing the card, one process each (this script with
                 the arguments `rank R W PORT DIR`), each building the scene anew:
                 render_distributed and the sharded train step, held to 10a's with the
                 same bars; both ranks hold the same results and launch the kernel
              c. render() at 64x64, 1 spp, max_bounces 8, with RenderConfig.profile_dir
                 set: one trace file, which names traverse_kernel, and the image of a
                 render without it
  11. bench    the benchmark, the intersect in lane order and the traversal
              statistics, on the same scene:
              a. `python -m mcrt_tpu_torch.bench` as a child process, as a user runs it
                 (its backward point in a child of its own): the JSON line has
                 bench.py's keys and the card's; its rays/s forward and
                 forward+backward and both traversal counters are finite and above
                 0, its rays per path within 10% of phase 4's, its graphed
                 forward point 2 launches a bounce step (then the same point
                 with the step called eagerly: the same rays and bounce steps,
                 its rays/s beside the bench's; and the forward+backward point,
                 one chunk after a warm-up, graphed and eagerly in one child
                 process of its own, `chip_smoke.py bwd 19`: the same rays and
                 loss, rtol 1e-5, both rates printed), and both of its
                 processes loaded the kernel library this run built from the
                 checkout's source, with nothing new in _build/; the line, the
                 walls and the traversal launches are printed
              b. the 64x64 camera at 4 spp through make_intersect_fn(sort_rays=False)
                 (the rays traversed in lane order) and through the default,
                 both through render()'s streamed chunks graphed
                 (streamed_render), held to each other with
                 tests/test_distributed.py's bars (rtol 2e-4, atol 2e-5); in
                 each order, the graphed step's launch 2 (bounce 1's primary
                 rays, 16384, after the first replay): the lane-order one held to
                 the plain version bit for bit, and its rounds per block printed
                 beside the sorted one's
              c. trace() of the 64x64 camera's rays at 1 spp with return_stats, its
                 step called eagerly (eager_loops): its traversal_steps equal the sum
                 of the primary launches' stats, [candidates summed over blocks, most
                 rounds of a block]; then graphed: the same traversal_steps and bounce
                 steps
              (11a also runs the bench's diagnostic trace eagerly in this process:
              its bounce steps and counters must be the bench's graphed ones, and
              the bench's diagnostic launches 2 a bounce step)
  12. batch    the batch chunks, render(streamed=False) at 512x512, 1 spp, max_bounces
              64 (two chunks of 2^17 paths, each one batch through its
              integrator's batch run: path_tracer.BatchTrace,
              photon_mapper.BatchEyePass), graphed, eagerly (eager_loops) and
              graphed again in turns, for the path tracer and for the photon mapper
              on phase 6's maps (loaded from its checkpoint, not rebuilt): images
              within rtol 2e-4, atol 2e-5, bounce steps, rays, k-NN counts and
              launches (2 traversal launches a step, 2 of each k-NN kernel)
              identical; walls, peak memory and the graphs' pools; the path
              tracer's bounce-0 launch and its captured launch after replay 8
              (131,072 rays) held to the plain version bit for bit and timed with
              their bounds; the eye pass's captured caustic and global k-NN calls
              after replay 1 held to knn_plain bit for bit and timed; a profiled
              graphed render of each, for the device-busy share
  13. methods  the JAX package's best-first traversal, and float64 on the card:
              a. cluster_bvh.traverse of a float32 ClusterTree (best-first, row
                 gathers: 5536 clusters) against that of the ClusterBVH (the
                 kernel) on phase 3's camera, surface and shadow rays (16384 each,
                 sorted) and its mixed set: ids identical to the kernel's on at
                 least 99.9% of rays (its fmaf chains split shared edges
                 differently), parked rays missing; each route's t, u, v against
                 the float64 recompute of its winning triangles (refine_tri_hit),
                 best-first's within 5e-6 of t + |o| and 5e-3 (the kernel's
                 global-frame forms are reported: they lose more at grazing
                 incidence); each route's ms a call, stats and peak memory
              b. float64 on the card, whose BVH carries its ClusterTree and which
                 traverses best-first with every loop
                 step eager (stats["graphed"] False, no kernel launch): render() at
                 512x512, 1 spp, 64 bounces, held to the float32 kernel render with
                 phase 5's bars; a 16x16 camera at 1 spp, 8 bounces (cut from 64x64
                 for time) on the card and on the CPU (the kernel route's plain
                 version): images within rtol
                 1e-9 (atol 1e-12), one train step's loss within rtol 1e-9 and its
                 gradients within 1e-9 of each table's largest |g|; 4096 float64
                 exact k-NN queries (k = 50) of phase 6's maps on the card (the
                 capped search and the brute force, no kernel) and on the CPU: ids
                 identical; walls and peak memory

The line before the last names the card and its power limit; the line before
that is the JSON kernel table; the last line is the JSON result. Imports no JAX
and nothing of the JAX package.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import json
import pathlib
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

# H100 SXM peaks (NVIDIA data sheet) used for the bounds.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
FP64_OPS_PER_S = 34e12

# Per (ray, triangle) operations of one visit: 19 multiplies + 15 adds of the
# forms, one division, three products, plus the compares; per (ray, cluster)
# of the cull: 6 subtracts, 6 multiplies, 10 min/max.
OPS_PER_RAY_TRI = 38
OPS_PER_RAY_BOX = 22
# Per (query, photon) of the exact k-NN: 3 subtracts, 3 multiplies, 2 adds.
OPS_PER_QUERY_PHOTON = 8

# The run's one configuration: the height field at n = 708 (1,002,528
# triangles), rendered at 512x512 and 4^2 = 16 spp as bench.py did; the kernel
# is checked on 2^16 rays of each kind.
GRID_N = 708
WIDTH = 512
SQRTSPP = 4
CHECK_RAYS = 1 << 16
# Phase 3's launch of the batch renders' size, which stays one CTA a block.
LARGE_LAUNCH = 1 << 17
# The photon render: the photon_map block of tests/scenes/caustic_sphere.json on
# the same height field (its glass sphere sits under the light), at 512x512 and
# 2^2 = 4 spp; the k-NN kernel is checked and timed on 2^14 queries (one eye-pass
# launch at the default 16384 lanes), k = 50.
PHOTON_MAP = {"emissions": 5e5, "caustic_factor": 10.0, "k_nearest_photons": 50,
              "direct_visualization": False}
PM_SQRTSPP = 2
KNN_QUERIES = 1 << 14
# Phase 9, the differentiable path on the same scene. 9a: plain SGD steps of the
# train step at 512x512, 1 spp, 64 bounces; the step size is fixed. 9b: bench.py's
# bench_bwd point through mcrt_tpu_torch.bench.bench_bwd at 2^17 paths a chunk
# (1024 spp, 8192 lanes, 64 trips), four chunks after a warm-up (phase 11a's
# bench times the point at 2^19). 9c: the kernel's gradients against the plain
# traversal's at 64x64, 1 spp, 8 bounces.
GRAD_BOUNCES = 64
SGD_STEPS = 3
# 9a's material gather backward at the train cell's shape: one trip's 262,144
# float32 cotangent rows of 27 columns summed into the 4 materials' tables,
# the rows drawn among the materials in the shares GATHER_SHARES; timed as a
# CUDA graph of GATHER_GRAPH_CALLS calls replayed GATHER_REPLAYS times.
GATHER_ROWS = 1 << 18
GATHER_MATERIALS = 4
GATHER_COLUMNS = 27
GATHER_SHARES = (0.70, 0.15, 0.10, 0.05)
GATHER_GRAPH_CALLS = 20
GATHER_REPLAYS = 20
SGD_LR = 3.0
BWD_CHUNK_LG = 17
BWD_SPP = 1024
BWD_TRIPS = 64
BWD_REPS = 4
CHECK_GRAD_WIDTH = 64
CHECK_GRAD_BOUNCES = 8
# Phase 10, the sharded steps on torch.distributed, on the same scene at 512x512,
# 1 spp, 64 bounces: 10a a world of one over NCCL in this process, 10b
# MULTI_RANKS gloo ranks sharing the one card (NCCL takes one rank per card),
# each a process; 10c a profiled render at PROFILE_WIDTH^2. Images are held to
# render() with tests/test_distributed.py's bars.
MULTI_RANKS = 2
MULTI_TIMEOUT_S = 300.0
PROFILE_WIDTH = 64
PROFILE_BOUNCES = 8     # keeps the trace's CPU events (every op of every bounce) small
IMG_RTOL = 2e-4
IMG_ATOL = 2e-5
# Phase 11: the bench as a user runs it (a child process, which runs its
# backward point in a child of its own), then the intersect in lane order and
# the traversal statistics through a SWITCH_WIDTH^2 camera on the same scene.
BENCH_CMD = [sys.executable, "-m", "mcrt_tpu_torch.bench"]
BENCH_TIMEOUT_S = 600.0
BWD_TURN_REPS = 1           # 11a's child: chunks of the bench's forward+backward point each way
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "fwd_bwd_rays_per_s_1024spp",
              "fwd_bwd_chunk", "diag_walk_steps_32k", "diag_leaf_rounds_32k", "card"}
SWITCH_WIDTH = 64
# Phase 13: the JAX package's best-first traversal against the kernel on phase
# 3's ray sets at the main path's launch size, and float64 on the card:
# render() at 512x512, 1 spp, 64 bounces;
# a F64_CHECK_WIDTH^2 camera at 1 spp, CHECK_GRAD_BOUNCES bounces, rendered and
# trained on the card and on the CPU; KNN64_QUERIES float64 exact k-NN queries
# of phase 6's maps on the card and on the CPU.
F64_CHECK_WIDTH = 16    # cut from 64: on the H100 host the CPU half took 106 s at 32
KNN64_QUERIES = 1 << 12
ROOT = pathlib.Path(__file__).resolve().parent
# The parent commit's traverse.cu, when one is handed in beside the checkout (it
# is not part of the repo): phase 3 then times it in turns with this tree's
# kernel, and takes its cycle split. Its C entry is the one before the launch
# width was added: mcrt_traverse(13 pointers, B, K, C, Sp, stream).
OLD_TRAVERSE = ROOT / "chip_old" / "traverse.cu"
# The parent commit's knn.cu (the one-ring kernel whose flagged queries went to
# the brute force), handed in the same way: phase 7 then times it, with
# _knn_brute on the rows it flags, in turns with this tree's kernels.
OLD_KNN = ROOT / "chip_old" / "knn.cu"


def log(phase: str, msg: str):
    print(f"[{phase}] {msg}", flush=True)


def fail(phase: str, msg: str):
    log(phase, "FAIL: " + msg)
    sys.exit(1)


def check(ok: bool, phase: str, msg: str):
    if not ok:
        fail(phase, msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    return out.splitlines()[0]


def cuda_time_ms(fn, reps: int, warmup: int = 1) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def surface_rays(scene, n, rng, toward=None):
    """Rays leaving random points of the mesh (offset 1e-4 along the normal):
    cosine-ish random directions, or directions toward `toward` (shadow rays)."""
    import numpy as np

    tri = rng.integers(0, scene.n_tris, n)
    u, v = rng.random(n), rng.random(n)
    flip = u + v > 1.0
    u[flip], v[flip] = 1.0 - u[flip], 1.0 - v[flip]
    p = scene.tri_v0[tri] + u[:, None] * scene.tri_e1[tri] + v[:, None] * scene.tri_e2[tri]
    nrm = scene.tri_n[tri] * np.where(scene.tri_n[tri, 1:2] < 0, -1.0, 1.0)
    o = p + 1e-4 * nrm
    if toward is None:
        d = rng.normal(size=(n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        d = np.where((d * nrm).sum(1, keepdims=True) < 0, -d, d)
    else:
        d = toward[None, :] + 0.3 * rng.normal(size=(n, 3)) - o
        d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def load_parent_kernel(path):
    """The parent's traversal kernel, built from `path` by nvcc like this tree's,
    with the parent's C entry mcrt_traverse(13 pointers, B, K, C, Sp, stream):
    one CTA a block, and the cycles of tk.CYCLES per block through its 13th
    pointer. None when the file is absent."""
    from mcrt_tpu_torch.ops import traverse_kernel as tk

    if not path.exists():
        return None
    lib = ctypes.CDLL(str(tk.compile_source(path, "traverse_parent")[0]))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.mcrt_traverse.argtypes = [vp] * 13 + [ci] * 4 + [vp]
    lib.mcrt_traverse.restype = ci
    lib.mcrt_traverse_heap_shared.restype = ci
    return lib


def parent_traverse(lib, cbvh, o, d, cycles=False):
    """One launch of the parent's kernel, with its wrapper's scratch; returns
    traverse's outputs (t, tri_id, u, v, stats) and the cycles or None."""
    import torch

    from mcrt_tpu_torch.ops import traverse_kernel as tk

    ft, K = tk.ray_features(o, d)
    B = ft.shape[0]
    C, Sp, _ = cbvh.rec.shape
    new = lambda shape, dt: torch.empty(shape, dtype=dt, device=o.device)
    f32, i32 = torch.float32, torch.int32
    heap = new((B, C), torch.int64) if C > lib.mcrt_traverse_heap_shared() else None
    outs = [new((B, K), f32), new((B, K), i32), new((B, K), f32), new((B, K), f32),
            new((B, 2), i32)]
    cy = torch.zeros((B, len(tk.CYCLES)), dtype=torch.int64, device=o.device) if cycles else None
    ptr = lambda x: None if x is None else x.data_ptr()
    err = lib.mcrt_traverse(
        ft.data_ptr(), cbvh.cl_bb.data_ptr(), cbvh.rec.data_ptr(), cbvh.tri.data_ptr(),
        new((B, C, K), f32).data_ptr(), new((B, C), i32).data_ptr(), ptr(heap),
        *(x.data_ptr() for x in outs), ptr(cy), B, K, C, Sp,
        torch.cuda.current_stream().cuda_stream)
    check(err == 0, "kernel", f"the parent's kernel failed to launch: {err}")
    return (*tk._unpad(o.shape[0], *outs[:4]), outs[4]), cy


def cycle_split(names, cycles) -> str:
    """Mean clock64() cycles per CTA of each counter, as shares of the total."""
    mean = cycles.double().mean(0).tolist()
    total = mean[0]
    return f"{total:.0f} cycles per block: " + ", ".join(
        f"{n} {100 * x / total:.1f}%" for n, x in zip(names[1:], mean[1:]))


def traversal_bound(tk, cbvh, o, d, stats):
    """(bound_ms, bound_by, visits) of one traversal of these rays on this data.

    Bytes: rays in, hits out, the AABBs, and the records and ids (84 bytes per
    triangle) of the real triangles of every cluster some block visits, each
    read once. Operations: the cull of every (ray, cluster), and the forms of
    every (ray, real triangle) of the clusters its block visits; padded slots
    are not counted, since the kernel stops at the first one. The visits come
    from the plain version and must match the kernel's rounds block by block."""
    import torch

    visited = tk.visited_clusters(cbvh, o, d)                     # (B, C) bool
    check(torch.equal(visited.sum(1).to(torch.int32), stats[:, 1]), "kernel",
          "visited clusters disagree with the kernel's rounds")
    n_real = (cbvh.tri >= 0).sum(1).to(torch.float64)             # (C,)
    B, C = visited.shape
    K = o.shape[0] // B
    tri_visits = float((visited.to(torch.float64) @ n_real).sum())
    bytes_ = o.shape[0] * (24 + 16) + C * 24 + float(n_real[visited.any(0)].sum()) * 84
    ops = B * K * C * OPS_PER_RAY_BOX + K * tri_visits * OPS_PER_RAY_TRI
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations"), tri_visits


class CaptureLog:
    """Records each step captured as a CUDA graph (utils/cuda_graph.CapturedStep)
    while its patch is on: the function that built the step, the pool its
    graph reserved, the launches a replay runs by kernel, and the capture's
    host wall in seconds (its synchronise and empty_cache included)."""

    def __init__(self):
        self.made = []

    def patch(self):
        from mcrt_tpu_torch.utils import cuda_graph

        made = self.made

        class Logged(cuda_graph.CapturedStep):
            def __init__(self, fn, state):
                t0 = time.perf_counter()
                super().__init__(fn, state)
                made.append((fn.__qualname__.split(".")[0], self.pool_bytes,
                             {c.name: n for c, n in self.per_replay}, time.perf_counter() - t0))

        return mock.patch.object(cuda_graph, "CapturedStep", Logged)


def eager_advance(loop):
    """utils/cuda_graph.GraphedLoop.advance with the step called eagerly, one
    launch per op, as before the photon mapper's loops were graphed: each
    loop's drain then drives its step in a Python loop (one host sync a
    step) and captures nothing."""
    loop.state = loop.step(loop.state)


def eager_loops():
    """The patch under which render()'s photon mapper runs its emission and
    eye pass eagerly (eager_advance)."""
    from mcrt_tpu_torch.utils import cuda_graph

    return mock.patch.object(cuda_graph.GraphedLoop, "advance", eager_advance)


def photon_phase(scene, card, pm_dir):
    """Phase 6: the photon render at full size, through render() as a user calls
    it, graphed, eagerly (eager_loops) and graphed again in turns; the first run
    checkpoints its photon maps into `pm_dir` for phase 7. Then a profiled
    1-spp eye pass each way. Returns the first run's traversal launches, its
    k-NN kernels' launches by kernel name, and its photon maps."""
    import numpy as np
    import torch

    import mcrt_tpu_torch as mt
    from mcrt_tpu_torch.accel import knn_kernel as kk
    from mcrt_tpu_torch.accel import photon_grid as pg
    from mcrt_tpu_torch.integrator import photon_mapper as pm
    from mcrt_tpu_torch.ops import traverse_kernel as tk

    cam = scene.cameras[0]
    cfg = mt.RenderConfig(max_bounces=64, sqrtspp=PM_SQRTSPP, integrator="photon_mapper")
    spp = PM_SQRTSPP ** 2
    paths = cam.width * cam.height * spp
    emissions = int(PHOTON_MAP["emissions"] * PHOTON_MAP["caustic_factor"])
    captures = CaptureLog()
    real_emit, real_build = pm.emit_photons, pm.build_photon_maps

    def one(how, ckpt):
        """One photon render; returns what the turns compare."""
        stats, rows, maps = {}, [], []

        def emit(*args, **kwargs):
            rows.append(real_emit(*args, **kwargs))
            return rows[-1]

        def build(*args, **kwargs):
            maps.append(real_build(*args, **kwargs))
            return maps[-1]

        tk.kernel.launches = 0
        for kern in kk.KERNELS:
            kern.launches = 0
        with contextlib.ExitStack() as stack:
            stack.enter_context(mock.patch.object(pm, "emit_photons", emit))
            stack.enter_context(mock.patch.object(pm, "build_photon_maps", build))
            fallback = stack.enter_context(
                mock.patch.object(pg, "_exact_fallback", wraps=pg._exact_fallback))
            stack.enter_context(eager_loops() if how == "eager" else captures.patch())
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            hdr = mt.render(scene, 0, cfg, stats=stats, checkpoint_dir=ckpt,
                            checkpoint_every_s=1e9)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        knn = {kern.name: kern.launches for kern in kk.KERNELS}
        counts = {key: int(stats[key]) for key in ("knn_queries", "knn_calls", "knn_flagged",
                                                   "knn_scanned")}
        t_photon = stats["photon_pass_s"]
        t_eye = wall - t_photon
        log("photon", f"{how}: {cam.width}x{cam.height} {spp} spp, {scene.n_tris} triangles, "
            f"{emissions} emission paths: wall {wall:.3f} s = photon pass {t_photon:.3f} s "
            f"({emissions / t_photon / 1e6:.4f} M emissions/s, {stats['emission_steps']} steps, "
            f"{1e3 * t_photon / stats['emission_steps']:.2f} ms a step) + eye pass {t_eye:.3f} s "
            f"({paths / t_eye / 1e6:.4f} M camera rays/s, {stats['bounce_steps']} bounce steps, "
            f"{1e3 * t_eye / stats['bounce_steps']:.2f} ms a step, {stats['chunks']} chunks) | {card}")
        log("photon", f"{how}: photons: caustic {stats['photons_caustic']}, global "
            f"{stats['photons_global']}; launches: traversal {tk.kernel.launches}, k-NN {knn}; k-NN "
            f"queries {counts['knn_queries']} over {counts['knn_calls']} calls: to stage B "
            f"{counts['knn_flagged']} ({100 * counts['knn_flagged'] / max(counts['knn_queries'], 1):.1f}%), "
            f"to the whole-map scan {counts['knn_scanned']} "
            f"({100 * counts['knn_scanned'] / max(counts['knn_queries'], 1):.1f}%); brute fallback "
            f"calls {fallback.call_count} | {card}")
        check(tk.kernel.launches > 0, "photon", f"{how}: the traversal kernel was not launched")
        for name, n in knn.items():
            check(n > 0, "photon", f"{how}: the k-NN kernel {name} was not launched")
        check(tk.kernel.launches == stats["emission_steps"] + 2 * stats["bounce_steps"]
              and all(n == 2 * stats["bounce_steps"] for n in knn.values()), "photon",
              f"{how}: launches {tk.kernel.launches}, {knn} for {stats['emission_steps']} emission "
              f"and {stats['bounce_steps']} bounce steps")
        check(fallback.call_count == 0, "photon", "the float32 exact k-NN went to the brute fallback")
        check(len(rows) == len(maps) == 1, "photon", f"{how}: the maps were not built once")
        check(hdr.shape == (cam.height, cam.width, 3), "photon", f"bad image shape {hdr.shape}")
        check(bool(np.isfinite(hdr).all()) and float(hdr.min()) >= 0.0, "photon",
              "non-finite or negative")
        check(0.01 < float(hdr.mean()) < 100.0, "photon", f"trivial image mean {hdr.mean()}")
        return dict(hdr=hdr, wall=wall, photon=t_photon, eye=t_eye, rows=rows[0], maps=maps[0],
                    knn=knn, counts=counts, trav=tk.kernel.launches,
                    same={key: stats[key] for key in ("photons_caustic", "photons_global",
                                                       "emission_steps", "bounce_steps", "chunks")})

    # The checkpoint key hashes the scene's JSON once (Scene.content_hash, then
    # cached): taken here, so that no run's wall holds it. Each run checkpoints
    # into a directory of its own, so each emits: the first into pm_dir.
    t0 = time.perf_counter()
    scene.content_hash()
    log("photon", f"the checkpoint key's scene hash, once, outside the walls: "
        f"{time.perf_counter() - t0:.3f} s")
    with tempfile.TemporaryDirectory() as d2, tempfile.TemporaryDirectory() as d3:
        runs = [one("graphed", pm_dir), one("eager", d2), one("graphed again", d3)]
    first = runs[0]
    log("photon", f"image mean {first['hdr'].mean():.6f} min {first['hdr'].min():.6f} max "
        f"{first['hdr'].max():.4f}")
    for (name, pool, per, wall) in captures.made:
        log("photon", f"captured {name}: pool {pool / 2**20:.1f} MiB reserved, launches a replay "
            f"{per}, capture {wall:.3f} s | {card}")
    check(sorted({m[0] for m in captures.made}) == ["_make_emission_step",
                                                              "_make_eye_step"],
          "photon", f"the graphed runs captured {[m[0] for m in captures.made]}")
    for other, how in ((runs[1], "eager"), (runs[2], "graphed again")):
        bad, worst = images_apart(first["hdr"], other["hdr"])
        rows_same = all(np.array_equal(a, b) for a, b in zip(first["rows"][0] + first["rows"][1],
                                                             other["rows"][0] + other["rows"][1]))
        log("photon", f"graphed against {how}: stored rows identical {rows_same}; {bad} image "
            f"elements outside rtol {IMG_RTOL} atol {IMG_ATOL}, largest |d| {worst:.3g}; launches, "
            f"steps, photon and k-NN counts identical "
            f"{(first['trav'], first['knn'], first['same'], first['counts']) == (other['trav'], other['knn'], other['same'], other['counts'])} | {card}")
        check(rows_same, "photon", f"graphed and {how} emissions stored different rows")
        check(bad == 0, "photon", f"the graphed and {how} photon renders disagree")
        check(first["same"] == other["same"], "photon",
              f"photon counts or steps differ: {first['same']} and {other['same']}")
        check((first["trav"], first["knn"]) == (other["trav"], other["knn"]), "photon",
              f"launches differ: {first['trav']} {first['knn']}, {other['trav']} {other['knn']}")
        check(first["counts"] == other["counts"], "photon",
              f"k-NN counts differ: {first['counts']} and {other['counts']}")
    log("photon", "walls in turns (graphed, eager, graphed): render "
        + ", ".join(f"{r['wall']:.3f}" for r in runs) + " s; photon pass "
        + ", ".join(f"{r['photon']:.3f}" for r in runs) + " s; eye pass "
        + ", ".join(f"{r['eye']:.3f}" for r in runs) + f" s | {card}")

    # Where the eye pass's device time goes: a profiled 1-spp eye pass each way
    # (the maps load from the checkpoint, so nothing is emitted).
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg1 = dataclasses.replace(cfg, sqrtspp=1)
    walls1 = {}
    for how in ("graphed", "eager"):
        with contextlib.ExitStack() as stack:    # unprofiled, for the share's wall
            if how == "eager":
                stack.enter_context(eager_loops())
            for f in pathlib.Path(pm_dir).glob("film_*.npz"):
                f.unlink()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            mt.render(scene, 0, cfg1, checkpoint_dir=pm_dir, checkpoint_every_s=1e9)
            torch.cuda.synchronize()
            walls1[how] = time.perf_counter() - t1
        for f in pathlib.Path(pm_dir).glob("film_*.npz"):
            f.unlink()
        torch.cuda.synchronize()
        with contextlib.ExitStack() as stack:
            if how == "eager":
                stack.enter_context(eager_loops())
            prof = stack.enter_context(profile(activities=[ProfilerActivity.CPU,
                                                           ProfilerActivity.CUDA]))
            t1 = time.perf_counter()
            mt.render(scene, 0, cfg1, checkpoint_dir=pm_dir, checkpoint_every_s=1e9)
            torch.cuda.synchronize()
            wall1 = time.perf_counter() - t1
        ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        dev_time = lambda e: getattr(e, "self_device_time_total", 0.0)
        dev_us = sum(dev_time(e) for e in ev)
        topk = [e.key for e in ev if "topk" in e.key.lower()]
        check(not topk, "photon", f"topk kernels ran in the eye pass: {topk[:3]}")
        if dev_us > 0:
            part = lambda name: sum(dev_time(e) for e in ev if name in e.key) / dev_us
            knn_share = ", ".join(f"{k.name} {100 * part(k.name):.1f}%" for k in kk.KERNELS)
            log("photon", f"1-spp profiled eye pass, {how}: wall {wall1:.3f} s (profiler on; "
                f"{walls1[how]:.3f} s off), device busy {dev_us / 1e6:.3f} s "
                f"({100 * dev_us / 1e6 / wall1:.1f}% of the profiled wall, "
                f"{100 * dev_us / 1e6 / walls1[how]:.1f}% of the unprofiled); k-NN kernels "
                f"{knn_share}; traversal {100 * part('traverse_kernel'):.1f}% of device time; no "
                f"topk kernels | {card}")
            for e in sorted(ev, key=lambda e: -dev_time(e))[:8]:
                log("photon", f"  {how}: device time {dev_time(e) / 1e3:10.1f} ms x{e.count:7d}  "
                    f"{e.key[:90]}")
        else:
            log("photon", f"device share, {how}: not measured (the profiler recorded no device time)")
        del prof, ev

    # The graphed cell once more (emitting anew: no checkpoint), its photon pass
    # and its 4-spp eye pass each under a CUDA-only profiler of its own: the
    # photon pass from the emission's first step (its five chunks, the first
    # with its eager step and capture) to the rows' return, the eye pass from
    # the maps' return to render()'s.
    passes = {}

    def emit_profiled(*args, **kwargs):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = real_emit(*args, **kwargs)
            torch.cuda.synchronize()
            passes["photon pass"] = [prof, time.perf_counter() - t1]
        return out

    def build_then_profile(*args, **kwargs):
        maps = real_build(*args, **kwargs)
        torch.cuda.synchronize()
        prof = profile(activities=[ProfilerActivity.CUDA])
        prof.__enter__()
        passes["eye pass"] = [prof, time.perf_counter()]
        return maps

    with mock.patch.object(pm, "emit_photons", emit_profiled), \
            mock.patch.object(pm, "build_photon_maps", build_then_profile):
        hdr = mt.render(scene, 0, cfg)
        torch.cuda.synchronize()
        passes["eye pass"][1] = time.perf_counter() - passes["eye pass"][1]
        passes["eye pass"][0].__exit__(None, None, None)
    bad, worst = images_apart(first["hdr"], hdr)
    check(bad == 0, "photon", f"the profiled graphed render disagrees with the first ({bad} elements)")
    unprofiled = {"photon pass": [r["photon"] for r in (runs[0], runs[2])],
                  "eye pass": [r["eye"] for r in (runs[0], runs[2])]}
    for name, (prof, wall) in passes.items():
        by_name = device_ns_by_name(prof)
        dev_s = sum(by_name.values()) / 1e9
        if dev_s > 0:
            log("photon", f"profiled graphed {name} ({spp} spp): wall {wall:.3f} s (profiler on), "
                f"device busy {dev_s:.3f} s ({100 * dev_s / wall:.1f}% of the profiled wall, "
                f"{100 * dev_s / max(unprofiled[name]):.1f}-{100 * dev_s / min(unprofiled[name]):.1f}% "
                f"of the graphed turns' {min(unprofiled[name]):.3f}-{max(unprofiled[name]):.3f} s) | {card}")
            for kname, ns in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
                log("photon", f"  {name}: device time {ns / 1e6:10.1f} ms  {kname[:90]}")
        else:
            log("photon", f"profiled graphed {name}: device share not measured (the profiler "
                "recorded no device time)")
    del passes
    return first["trav"], first["knn"], first["maps"]


class KnnRecorder:
    """Wraps knn_kernel.knn: keeps the grid, the queries, the mask and the
    kernels' outputs of the calls numbered in `at` (0 = the first call), so
    that a captured call, whose tensors hold the last replay's values, can be
    held to knn_plain. Keeps references only: nothing syncs the host."""

    def __init__(self, kk, at):
        self.real, self.at, self.calls, self.seen = kk.knn, set(at), 0, {}

    def __call__(self, grid, arrays, points, k, mask=None, evaluated=None):
        out = self.real(grid, arrays, points, k, mask=mask, evaluated=evaluated)
        if self.calls in self.at:
            self.seen[self.calls] = (grid, arrays, points, k, mask, out)
        self.calls += 1
        return out


def knn_held_to_plain(kk, recorder, what, card, unmasked):
    """Each recorded k-NN call against knn_plain on its grid, queries and
    mask: ids, d2, counts, stages and queue counts bit-identical. Adds each
    call's unmasked queries to `unmasked` (a call may have none at a bounce)."""
    import torch

    check(len(recorder.seen) == len(recorder.at), "photon",
          f"{what}: recorded {len(recorder.seen)} of the calls {sorted(recorder.at)}")
    for i, (grid, arrays, points, k, mask, got) in sorted(recorder.seen.items()):
        want = kk.knn_plain(grid, arrays, points, k, mask)
        torch.cuda.synchronize()
        same = {name: torch.equal(getattr(got, name), getattr(want, name))
                for name in ("idx", "d2", "valid", "stage", "queued")}
        q = int(mask.sum())
        unmasked[i] = unmasked.get(i, 0) + q
        log("photon", f"{what}, k-NN call {i}: {points.shape[0]} queries, {q} unmasked, "
            f"{grid.n_photons} photons; to stage B {int(got.queued[0])}, to the scan "
            f"{int(got.queued[1])}; kernels vs plain bit-identical {same} | {card}")
        check(all(same.values()), "photon", f"{what}, call {i}: kernels and plain version differ")


def photon_replay_phase(scene, maps, card):
    """Phase 6b: the 64x64 camera at 16 spp (65,536 paths through render()'s
    16,384 lanes, so lanes reload paths as theirs end) as one chunk through a
    StreamedEyePass on phase 6's maps, driven bounce by bounce with
    knn_kernel.knn recorded:
    bounce 0 runs eagerly (calls 0 and 1), the capture records calls 2 and 3
    (the caustic and the global estimate) and bounce 1 is its first replay.
    After replays 1 and 3 the two captured calls are held to knn_plain (and
    after later replays, until each call has held unmasked queries); then the
    chunk runs to its end and is held to an eager run of the same chunk."""
    import numpy as np
    import torch

    import mcrt_tpu_torch as mt
    from mcrt_tpu_torch.accel import knn_kernel as kk
    from mcrt_tpu_torch.integrator import photon_mapper as pm
    from mcrt_tpu_torch.ops import cluster_bvh

    dev = torch.device("cuda", 0)
    cam = scene.cameras[1]
    spp = 16
    n = cam.width * cam.height * spp
    lanes = min(mt.RenderConfig().lanes, n)
    tables = scene.tables(np.float32, dev)
    meta = scene.meta()
    ifn = cluster_bvh.make_intersect_fn(tables, meta, scene.build_cluster_bvh(np.float32, dev))
    pmcfg = pm.PMConfig.from_json(scene.photon_map_config)
    make = lambda: pm.StreamedEyePass(tables, meta, pmcfg, maps, cam, spp, n, lanes,
                                      intersect_fn=ifn)
    for kern in kk.KERNELS:
        kern.launches = kern.captured = 0
    rec = KnnRecorder(kk, at=(2, 3))
    tr = make()
    try:
        with mock.patch.object(kk, "knn", rec):
            tr.begin(0)
            tr.advance()
            tr.advance()
        torch.cuda.synchronize()
        check(tr.graph is not None, "photon", "6b: the eye step was not captured at bounce 1")
        counts = [(kern.launches, kern.captured) for kern in kk.KERNELS]
        check(counts == [(4, 2)] * 3, "photon", f"6b: after bounce 1, k-NN (launches, captured) "
              f"{counts} (want 2 eager + 2 replayed, and 2, each)")
        log("photon", f"6b graph of one eye-pass bounce step at {lanes} lanes: pool "
            f"{tr.graph.pool_bytes / 2**20:.1f} MiB reserved, launches a replay "
            f"{ {c.name: m for c, m in tr.graph.per_replay} } | {card}")
        unmasked = {}
        knn_held_to_plain(kk, rec, "6b replay 1 (bounce 1)", card, unmasked)
        tr.advance()
        tr.advance()
        torch.cuda.synchronize()
        knn_held_to_plain(kk, rec, "6b replay 3 (bounce 3)", card, unmasked)
        steps = 4
        # A global estimate needs two non-dirac vertices in a row, so its call
        # may have no query unmasked at bounces 1 and 3: replay on to the
        # first bounce where it has some, and hold that one too.
        while min(unmasked.values()) == 0 and steps < 16 and bool(tr.state.alive.any()):
            tr.advance()
            steps += 1
            torch.cuda.synchronize()
            knn_held_to_plain(kk, rec, f"6b replay {steps - 1} (bounce {steps - 1})", card,
                              unmasked)
        check(min(unmasked.values()) > 0, "photon",
              f"6b: a held k-NN call had no query unmasked: {unmasked}")
        steps += tr.drain()
        got = tr.output(tr.state).clone()
        got_knn = tr.state.knn.clone()
    finally:
        tr.close()
    eager = make()
    try:
        with eager_loops():
            eager.begin(0)
            steps_e = eager.drain()
        want, want_knn = eager.output(eager.state), eager.state.knn
        bad, worst = images_apart(got.cpu().numpy(), want.cpu().numpy())
        log("photon", f"6b 64x64 {spp} spp chunk, graphed vs eager: {bad} elements outside rtol "
            f"{IMG_RTOL} atol {IMG_ATOL}, largest |d| {worst:.3g}; bounce steps {steps} and "
            f"{steps_e}; k-NN [queries, flagged, scanned] {got_knn.tolist()} and "
            f"{want_knn.tolist()} | {card}")
        check(bad == 0 and steps == steps_e and torch.equal(got_knn, want_knn), "photon",
              "6b: the graphed eye pass and the eager loop disagree")
        check(float(got.sum()) > 0.0, "photon", "6b: a black chunk")
    finally:
        eager.close()


def photon_wide_k_phase(scene, maps, card):
    """Phase 6c: k = 64, over the k-NN kernels' width (KPAD), so the exact
    k-NN is the capped search with its brute force, which computes every row
    at a fixed shape and syncs nothing. The 64x64 camera at 1 spp as one chunk
    through a StreamedEyePass on phase 6's maps, graphed and eagerly: the step
    captured, no k-NN kernel launched, some queries re-answered by the brute
    force, and the chunk held to the eager loop with phase 6's bars."""
    import numpy as np
    import torch

    from mcrt_tpu_torch.accel import knn_kernel as kk
    from mcrt_tpu_torch.integrator import photon_mapper as pm
    from mcrt_tpu_torch.ops import cluster_bvh

    dev = torch.device("cuda", 0)
    cam = scene.cameras[1]
    n = cam.width * cam.height
    tables = scene.tables(np.float32, dev)
    meta = scene.meta()
    ifn = cluster_bvh.make_intersect_fn(tables, meta, scene.build_cluster_bvh(np.float32, dev))
    pmcfg = pm.PMConfig.from_json(scene.photon_map_config, k_nearest_photons=64)
    check(pmcfg.k_nearest_photons > kk.KPAD, "photon", "6c: k is within the kernels' width")
    out = {}
    for how in ("graphed", "eager"):
        for kern in kk.KERNELS:
            kern.launches = 0
        tr = pm.StreamedEyePass(tables, meta, pmcfg, maps, cam, 1, n, n, intersect_fn=ifn)
        stats = {}
        try:
            with contextlib.ExitStack() as stack:
                if how == "eager":
                    stack.enter_context(eager_loops())
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                img = tr(0, stats).cpu().numpy()
                wall = time.perf_counter() - t0
            captured = tr.graph is not None
            pool = tr.graph.pool_bytes if captured else 0
        finally:
            tr.close()
        knn = {key: int(v) for key, v in stats.items() if key.startswith("knn_")}
        launched = sum(kern.launches for kern in kk.KERNELS)
        log("photon", f"6c k = 64, 64x64 1 spp, {how}: {wall:.3f} s, {stats['bounce_steps']} bounce "
            f"steps, captured {captured} (pool {pool / 2**20:.1f} MiB), k-NN {knn}, k-NN kernel "
            f"launches {launched} | {card}")
        check(captured == (how == "graphed"), "photon", f"6c {how}: captured {captured}")
        check(launched == 0, "photon", f"6c {how}: a k-NN kernel ran at k = 64")
        check(knn["knn_flagged"] > 0, "photon", f"6c {how}: the brute force re-answered no query")
        out[how] = (img, knn, stats["bounce_steps"])
    (got, kg, sg), (want, ke, se) = out["graphed"], out["eager"]
    bad, worst = images_apart(got, want)
    log("photon", f"6c graphed vs eager: {bad} elements outside rtol {IMG_RTOL} atol {IMG_ATOL}, "
        f"largest |d| {worst:.3g} | {card}")
    check(bad == 0 and kg == ke and sg == se, "photon",
          "6c: the graphed eye pass at k = 64 and the eager loop disagree")
    check(float(got.sum()) > 0.0 and bool(np.isfinite(got).all()), "photon", "6c: a black or "
          "non-finite chunk")


def box_table(grid):
    """(N-cell summed-area table (nx+1, ny+1, nz+1) of photon counts, per-cell
    counts (nx, ny, nz)), int64 on the grid's device."""
    import torch

    cs = grid.arrays.cell_start.to(torch.int64)
    counts = (cs[1:] - cs[:-1]).view(*grid.dims)
    sat = torch.zeros(tuple(n + 1 for n in grid.dims), dtype=torch.int64, device=cs.device)
    sat[1:, 1:, 1:] = counts.cumsum(0).cumsum(1).cumsum(2)
    return sat, counts


def box_count(sat, lo, hi):
    """Photons in the cell boxes [lo, hi] (V, 3), by inclusion-exclusion."""
    a, b = lo, hi + 1
    total = 0
    for cx in (0, 1):
        for cy in (0, 1):
            for cz in (0, 1):
                sign = (-1) ** (3 - cx - cy - cz)
                total = total + sign * sat[(a, b)[cx][:, 0], (a, b)[cy][:, 1], (a, b)[cz][:, 2]]
    return total


def knn_work(kk, grid, pts, mask, k, plain):
    """What the exact k-NN of these queries needs, from the data alone: the
    ring r* that certifies each valid query (no cell budget), and per stage
    the bound's work. `plain` is knn_plain's result, whose k-th d2 fixes r*.

    Operations: 8 per (valid query, photon of its ring-1 box), plus, for a
    query that ring 1 does not certify, 8 per photon of its ring-r* box.
    Bytes: 12 per distinct photon row of those boxes, 8 per distinct (x, y)
    column they touch (its CSR start and end), the queries (12 + 1 bytes) and
    the outputs (k x 8 + 4 bytes), each once. Returns a dict: r* (V,), the
    stage (V,), photons of each query's ring-1 box (V,); (ops, bytes) of the
    whole function ("total") and of each stage's share: ring1 the ring-1
    boxes of all valid queries and the queries and outputs, rings and scan
    the r* boxes of the queries they answer."""
    import torch

    kth = plain.d2[:, k - 1].float()
    rstar = kk.certifying_ring(grid, grid.arrays, pts, kth, mask)
    valid = mask if mask is not None else torch.ones(pts.shape[0], dtype=torch.bool,
                                                     device=pts.device)
    q = kk.sort_queries(grid, pts, mask)
    cells = torch.empty((pts.shape[0], 3), dtype=torch.int64, device=pts.device)
    cells[q.qcell[:, 3].long()] = q.qcell[:, :3].long()
    c, r, stage = cells[valid], rstar[valid], plain.stage[valid].long()
    sat, counts = box_table(grid)
    top = torch.as_tensor(grid.dims, device=c.device) - 1
    box = lambda rr: (torch.clamp(c - rr[:, None], min=0), torch.minimum(c + rr[:, None], top))
    one = box(torch.ones_like(r))
    own = box_count(sat, *one)
    need = torch.where(r > 1, box_count(sat, *box(r)), 0)
    out = {"rstar": r, "stage": stage, "own": own}

    def cover(lo, hi):
        """Photons and (x, y) columns of the union of cell boxes [lo, hi]."""
        diff = torch.zeros(tuple(n + 1 for n in grid.dims), dtype=torch.int32, device=c.device)
        a, b = lo, hi + 1
        for cx in (0, 1):
            for cy in (0, 1):
                for cz in (0, 1):
                    idx = ((a, b)[cx][:, 0], (a, b)[cy][:, 1], (a, b)[cz][:, 2])
                    diff.index_put_(idx, torch.full_like(lo[:, 0], (-1) ** (cx + cy + cz),
                                                         dtype=torch.int32), accumulate=True)
        covered = diff.cumsum(0).cumsum(1).cumsum(2)[:-1, :-1, :-1] > 0
        return int(counts[covered].sum()), int(covered.any(dim=2).sum())

    io = pts.shape[0] * (13 + k * 8 + 4)       # queries in, outputs out
    later = box(r)
    stages = {"ring1": (torch.ones_like(stage, dtype=torch.bool), one, own),
              "rings": (stage > 1, later, need), "scan": (stage == kk.STAGE_SCAN, later, need)}
    for name, (sel, (lo, hi), photons) in stages.items():
        rows, cols = cover(lo[sel], hi[sel])
        out[name] = (OPS_PER_QUERY_PHOTON * float(photons[sel].sum()),
                     rows * 12 + cols * 8 + (io if name == "ring1" else 0))
    beyond = r > 1
    rows, cols = cover(torch.cat([one[0], later[0][beyond]]), torch.cat([one[1], later[1][beyond]]))
    out["total"] = (OPS_PER_QUERY_PHOTON * float(own.sum() + need.sum()), rows * 12 + cols * 8 + io)
    return out


def bound_of(ops, bytes_):
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops else "operations")


def load_parent_knn(path):
    """The parent's one-ring k-NN kernel, built from `path` by nvcc like this
    tree's: its C entry mcrt_knn(8 pointers, B, k, nx, ny, nz, cell2, stream).
    None when the file is absent."""
    from mcrt_tpu_torch.ops import traverse_kernel as tk

    if not path.exists():
        return None
    lib = ctypes.CDLL(str(tk.compile_source(path, "knn_parent")[0]))
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.mcrt_knn.argtypes = [vp] * 8 + [ci] * 5 + [ctypes.c_float, vp]
    lib.mcrt_knn.restype = ci
    return lib


def parent_knn(lib, kk, pg, g, pts, mask, k, fallback=True):
    """The parent's exact k-NN on the card: its kernel on blocks of 128 sorted
    queries, then `_knn_brute` on the rows it flags (fewer than min(k, N)
    photons within the cell radius), as the parent's photon_grid.knn did, with
    its host sync. Returns (idx, d2, count, per-block [columns, photons read],
    flagged rows)."""
    import torch

    dev = pts.device
    q = kk.sort_queries(g, pts, mask)
    Q = pts.shape[0]
    B = -(-Q // 128)
    qpos = torch.zeros((B * 128, 4), dtype=torch.float32, device=dev)
    qcell = torch.full((B * 128, 4), -1, dtype=torch.int32, device=dev)
    qpos[:Q], qcell[:Q] = q.qpos, q.qcell
    idx = torch.empty((Q, k), dtype=torch.int32, device=dev)
    d2 = torch.empty((Q, k), dtype=torch.float32, device=dev)
    cnt = torch.empty((Q,), dtype=torch.int32, device=dev)
    stats = torch.empty((B, 2), dtype=torch.int32, device=dev)
    nx, ny, nz = g.dims
    cell2 = float(torch.tensor(g.cell_size * g.cell_size, dtype=torch.float32))
    err = lib.mcrt_knn(qpos.data_ptr(), qcell.data_ptr(), g.arrays.pos.data_ptr(),
                       g.arrays.cell_start.data_ptr(), idx.data_ptr(), d2.data_ptr(),
                       cnt.data_ptr(), stats.data_ptr(), B, k, nx, ny, nz, cell2,
                       torch.cuda.current_stream().cuda_stream)
    check(err == 0, "knn", f"the parent's k-NN kernel failed to launch: {err}")
    if not fallback:
        return idx, d2, cnt, stats, None
    needs = cnt < min(k, g.n_photons)
    if mask is not None:
        needs &= mask
    rows = torch.nonzero(needs).squeeze(1)     # the parent's host sync
    if rows.shape[0]:
        bd2, bix, _ = pg._knn_brute(g.arrays, pts[rows], k, g.n_photons)
        d2[rows], idx[rows], cnt[rows] = bd2, bix, min(k, g.n_photons)
    return idx, d2, cnt, stats, rows


def library_knn(g, pts, mask, k, got):
    """The library route to the same exact k-NN, for the kernel table's
    yardstick (nothing in the port uses it): torch.cdist over every (query,
    photon) pair without the matrix-product form, then torch.topk of the k
    smallest, two calls over a (Q, N) float32 matrix. Returns (ms of the two,
    largest relative gap of its k-th d2 to the kernels' over the unmasked
    queries)."""
    import torch

    pos = g.arrays.pos.to(torch.float32)

    def run():
        dist = torch.cdist(pts, pos, compute_mode="donot_use_mm_for_euclid_dist")
        return torch.topk(dist, k, dim=1, largest=False).values

    ms = cuda_time_ms(run, reps=3, warmup=1)
    kth = run()[:, -1].double() ** 2
    want = torch.where(got.valid, got.d2, torch.zeros_like(got.d2)).amax(dim=1).double()
    rel = ((kth - want).abs() / want.clamp(min=1e-30))[mask]
    torch.cuda.empty_cache()
    return ms, float(rel.max())


def knn_phase(scene, cam, card, rng, pm_dir, parent):
    """Phase 7: the k-NN kernels against their plain version on the photon
    render's maps, then timed. Returns the kernels' rows of the JSON table
    (less launches), by kernel name."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from mcrt_tpu_torch.accel import knn_kernel as kk
    from mcrt_tpu_torch.accel import photon_grid as pg
    from mcrt_tpu_torch.camera import camera as cam_mod
    from mcrt_tpu_torch.ops import cluster_bvh

    dev = torch.device("cuda", 0)
    k = PHOTON_MAP["k_nearest_photons"]
    maps = {}
    for name in ("caustic", "global"):
        (path,) = pathlib.Path(pm_dir).glob(f"photons_{name}_*.npz")
        maps[name] = pg.load_photon_grid(path, dev)
        g = maps[name]
        log("knn", f"{name} map: {g.n_photons} photons, grid {g.dims}, cell {g.cell_size:.5g}")
    log("knn", f"resident warps per SM: {kk.resident_warps()}; cell budget {kk.CELL_BUDGET}")

    # Query sets: first-bounce hits of camera rays, random mesh points, and the
    # hits with every other query masked off.
    n = KNN_QUERIES
    tables = scene.tables(np.float32, dev)
    isect = cluster_bvh.make_intersect_fn(tables, scene.meta(), scene.build_cluster_bvh(np.float32, dev))
    pix = rng.integers(0, cam.width * cam.height, n)
    cr = cam_mod.generate_rays(cam, torch.as_tensor(pix % cam.width, device=dev),
                               torch.as_tensor(pix // cam.width, device=dev),
                               torch.zeros(n, dtype=torch.int64, device=dev), 0, torch.float32)
    hit = isect(cr.origin, cr.direction)
    eye = cr.origin + cr.direction * torch.where(hit.surf_id >= 0, hit.t, 0.0)[:, None]
    o, _ = surface_rays(scene, n, rng)
    half = (hit.surf_id >= 0).clone()
    half[::2] = False
    sets = {"eye_hits": (eye.contiguous(), hit.surf_id >= 0),
            "mesh_points": (torch.as_tensor(o, dtype=torch.float32, device=dev), None),
            "masked_half": (eye.contiguous(), half)}

    max_err = 0.0
    work = {}
    for mname, g in maps.items():
        for sname, (pts, mask) in sets.items():
            evaluated = torch.zeros(pts.shape[0], dtype=torch.int32, device=dev)
            a = kk.knn(g, g.arrays, pts, k, mask=mask, evaluated=evaluated)
            torch.cuda.synchronize()
            b = kk.knn_plain(g, g.arrays, pts, k, mask=mask)
            same = {f: bool(torch.equal(getattr(a, f), getattr(b, f)))
                    for f in ("idx", "d2", "valid", "stage", "queued")}
            fin = a.valid
            err = float((a.d2[fin] - b.d2[fin]).abs().max()) if bool(fin.any()) else 0.0
            max_err = max(max_err, err)
            check(all(same.values()), "knn", f"{mname} {sname}: kernels != plain: {same}")
            if mask is not None:
                check(not bool(a.valid[~mask].any()) and bool((a.stage[~mask] == 0).all()),
                      "knn", "masked queries returned photons")
            w = knn_work(kk, g, pts, mask, k, b)
            valid = mask if mask is not None else torch.ones_like(a.stage, dtype=torch.bool)
            work[(mname, sname)] = w
            st, nv = w["stage"], w["stage"].shape[0]
            share = lambda sel: f"{100 * float(sel.sum()) / max(nv, 1):.1f}%"
            hist = torch.bincount(st[st > 1]).tolist()
            rh = torch.bincount(w["rstar"]).tolist()
            log("knn", f"{mname:7s} {sname:11s} queries {nv}: stage A {share(st == 1)}, rings "
                f"{share(st > 1)}, scan {share(st == kk.STAGE_SCAN)}; queued {a.queued.tolist()}; "
                f"identical {same}; photons per query: own cells {float(w['own'].float().mean()):.1f},"
                f" evaluated by the kernels {float(evaluated[valid].float().mean()):.1f}")
            log("knn", f"{mname:7s} {sname:11s} answering ring histogram (r: queries) "
                f"{ {r: c for r, c in enumerate(hist) if c} }; certifying ring r* (no budget) "
                f"{ {r: c for r, c in enumerate(rh) if c} }")

    # No host sync, no brute force, no topk on the float32 exact path.
    pts, mask = sets["eye_hits"]
    g = maps["caustic"]
    refuse = mock.Mock(side_effect=AssertionError("called on the float32 exact path"))
    with mock.patch.object(pg, "_knn_brute", refuse), mock.patch.object(torch, "topk", refuse):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            pg.knn(g, g.arrays, pts, k, mask=mask, exact=True, stats={})
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    log("knn", "photon_grid.knn(exact=True), float32: no host sync (sync debug mode 'error'), "
        "no _knn_brute, no torch.topk")

    # Timing at the eye pass's launch shape, on the eye-hit set of each map.
    rows = {kern.name: [] for kern in kk.KERNELS}
    for mname, g in maps.items():
        run = lambda: kk.knn(g, g.arrays, pts, k, mask=mask)
        t_new, t_old, old_kernel_ms, brute_ms, vs_old = [], [], None, None, "parent's kernel: not given"
        if parent is not None:   # in turns: old, new, new, old
            run_old = lambda: parent_knn(parent, kk, pg, g, pts, mask, k)
            t_old.append(cuda_time_ms(run_old, reps=10, warmup=2))
            t_new += [cuda_time_ms(run, reps=20, warmup=2) for _ in range(2)]
            t_old.append(cuda_time_ms(run_old, reps=10, warmup=2))
            oidx, od2, ocnt, ostats, flagged = run_old()
            a = run()
            ours, theirs = a.idx.sort(dim=1).values, oidx.sort(dim=1).values
            differ = int((ours != theirs)[mask].any(dim=1).sum())
            check(differ <= max(1, int(mask.sum()) // 1000), "knn",
                  f"{mname}: {differ} queries' id sets differ from the parent's")
            old_kernel_ms = cuda_time_ms(
                lambda: parent_knn(parent, kk, pg, g, pts, mask, k, fallback=False),
                reps=10, warmup=2)
            brute_ms = (cuda_time_ms(lambda: pg._knn_brute(g.arrays, pts[flagged], k, g.n_photons),
                                     reps=5) if len(flagged) else 0.0)
            per_q = ostats[:, 1].repeat_interleave(128)[:n].double()
            nv = float(mask.sum())
            old_read = float(per_q[kk.sort_queries(g, pts, mask).qpos[:, 3] > 0.5].sum()) / nv
            vs_old = (f"parent's kernel + brute fallback {sum(t_old) / 2:.4f} ms per call "
                      f"({t_old[0]:.4f}, {t_old[1]:.4f}; new {t_new[0]:.4f}, {t_new[1]:.4f}), "
                      f"{sum(t_old) / sum(t_new):.2f}x; of which its kernel alone (no fallback) "
                      f"{old_kernel_ms:.4f} ms and _knn_brute on its "
                      f"{len(flagged)} flagged rows {brute_ms:.4f} ms; its block boxes read "
                      f"{old_read:.1f} photons per valid query; id sets differ on {differ}")
        else:
            t_new.append(cuda_time_ms(run, reps=20, warmup=2))
        ms = sum(t_new) / len(t_new)
        plain_ms = cuda_time_ms(lambda: kk.knn_plain(g, g.arrays, pts, k, mask=mask), reps=2)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                run()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        dev_ms = {}
        for kern in kk.KERNELS:
            us = sum(getattr(e, "self_device_time_total", 0.0) for e in ev if kern.name in e.key)
            dev_ms[kern.name] = us / 10 / 1e3 if us > 0 else None
        w = work[(mname, "eye_hits")]
        ops, bytes_ = w["total"]
        bound_ms, by = bound_of(ops, bytes_)
        r = kk.knn(g, g.arrays, pts, k, mask=mask)
        lib_ms, lib_gap = library_knn(g, pts, mask, k, r)
        log("knn", f"library route {mname:7s}: torch.cdist (no matrix product) + torch.topk, two "
            f"calls over a {n} x {g.n_photons} float32 matrix, {lib_ms:.3f} ms; its k-th d2 within "
            f"{lib_gap:.3g} (relative) of the kernels' on the valid queries | {card}")
        check(lib_gap <= 1e-6, "knn", f"{mname}: the library route's k-th d2 is {lib_gap:.3g} off")
        log("knn", f"time {mname:7s} {n} queries ({int(mask.sum())} valid), k={k}: per call "
            f"{ms:.4f} ms with the wrapper, device ms per kernel {dev_ms}; plain {plain_ms:.3f} ms; "
            f"bound {bound_ms:.5f} ms ({by}; {ops:.4g} operations, {bytes_:.4g} bytes), "
            f"{ms / bound_ms:.1f}x the bound; queued {r.queued.tolist()}; {vs_old} | {card}")
        for stage_name, kern in zip(("ring1", "rings", "scan"), kk.KERNELS):
            b_ms, b_by = bound_of(*w[stage_name])
            k_ms = dev_ms[kern.name]
            rows[kern.name].append(dict(ms=k_ms if k_ms is not None else ms, plain_ms=plain_ms,
                                        bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms))
    out = {}
    for name, rs in rows.items():
        mean = lambda key: sum(x[key] for x in rs) / len(rs)
        out[name] = {"max_abs_err": max_err, "ms": mean("ms"), "plain_ms": mean("plain_ms"),
                     "bound_ms": mean("bound_ms"),
                     "bound_by": max(rs, key=lambda x: x["bound_ms"])["bound_by"],
                     "library_ms": mean("library_ms"),
                     "library": "torch.cdist + torch.topk, two calls, for the whole k-NN call"}
    return out


def golden_phase(card):
    """Phase 8: the reference's caustic, photon-rendered on the card, against the
    C++ reference's image with tests/test_e2e_golden.py's caustic bars."""
    import numpy as np

    import mcrt_tpu_torch as mt
    from mcrt_tpu_torch.camera import image as image_mod

    j = json.loads((ROOT / "tests/scenes/caustic_sphere.json").read_text())
    j["cameras"][0]["image"] = {"width": 48, "height": 48, "plain": True}
    j["cameras"][0]["sqrtspp"] = 8
    j["photon_map"]["emissions"] = 2e5
    scene = mt.Scene(j)
    stats = {}
    t0 = time.perf_counter()
    hdr = mt.render(scene, 0, mt.RenderConfig(rays_per_chunk=1 << 15, integrator="photon_mapper"),
                    stats=stats)
    wall = time.perf_counter() - t0
    ours = np.clip(image_mod.finalize(hdr, scene.cameras[0].image), 0.0, 1.0)
    ref = image_mod.read_tga(ROOT / "tests/goldens/caustic_sphere_48_s8.tga").astype(np.float64) / 255.0
    diff = np.abs(ours - ref)
    mean_d, p95, mdiff = abs(ours.mean() - ref.mean()), float(np.percentile(diff, 95)), diff.mean()
    band_o, band_r = ours[26:30, 18:30].mean(), ref[26:30, 18:30].mean()
    band = abs(band_o - band_r) / band_r
    log("golden", f"caustic_sphere 48x48 64 spp, 2e5 emissions: wall {wall:.3f} s, photons "
        f"caustic {stats['photons_caustic']} global {stats['photons_global']}; image mean diff "
        f"{mean_d:.4g} (bar 0.02), p95 {p95:.4g} (0.10), mean {mdiff:.4g} (0.03), caustic band "
        f"{band_o:.4f} vs {band_r:.4f}: {100 * band:.2f}% (15%) | {card}")
    check(mean_d < 0.02 and p95 < 0.10 and mdiff < 0.03 and band_r > 0.4 and band < 0.15,
          "golden", "the caustic render misses the reference's bars")


def perturbed(truth):
    """The four train tables moved off the scene's own values, inside their
    valid ranges: reflectance x0.8, roughness +0.1, the dielectrics' ior +0.05
    (a material without one keeps its -1), transparency x0.9 (T = 1 is a
    stationary point of the layered mix)."""
    import torch

    ior, tr = truth["mat_ior"], truth["mat_transparency"]
    return {"mat_reflectance": truth["mat_reflectance"] * 0.8,
            "mat_specular_roughness": truth["mat_specular_roughness"] + 0.1,
            "mat_ior": torch.where(ior > 1.0, ior + 0.05, ior),
            "mat_transparency": tr * 0.9}


def sgd_update(params, grads, truth):
    """One plain SGD step of size SGD_LR, clamped to the valid ranges; a
    material without an ior keeps its -1."""
    import torch

    new = {k: v - SGD_LR * grads[k] for k, v in params.items()}
    ior = truth["mat_ior"]
    return {"mat_reflectance": new["mat_reflectance"].clamp(0.0, 1.0),
            "mat_specular_roughness": new["mat_specular_roughness"].clamp(1e-3, 1.0),
            "mat_ior": torch.where(ior > 1.0, new["mat_ior"].clamp(min=1.0), ior),
            "mat_transparency": new["mat_transparency"].clamp(0.0, 1.0)}


class GradSplit:
    """Wraps torch.autograd.grad: records a CUDA event and the traversal's
    launch count where the backward pass starts, so a train step's time and
    launches split into its forward and its backward (with the recompute)."""

    def __init__(self, tk):
        import torch

        self.tk, self.real = tk, torch.autograd.grad
        self.start = torch.cuda.Event(enable_timing=True)
        self.launches = 0

    def __call__(self, *args, **kwargs):
        self.start.record()
        self.launches = self.tk.kernel.launches
        return self.real(*args, **kwargs)


class LaunchRecorder:
    """Wraps traverse_kernel.traverse: keeps the BVH, the rays and the
    kernel's outputs of the calls numbered in `at` (0 = the first call), so
    that those launches can be held against the plain version at the size the
    path gave them. Keeps references only: nothing syncs the host."""

    def __init__(self, tk, at):
        self.real, self.at, self.calls, self.seen = tk.traverse, set(at), 0, {}

    def __call__(self, cbvh, origin, direction):
        out = self.real(cbvh, origin, direction)
        if self.calls in self.at:
            self.seen[self.calls] = (cbvh, origin, direction, out)
        self.calls += 1
        return out


class ReplaySnapshots:
    """Wraps GraphedTrip.replay_f and replay_b (the trip's graph G_f and its
    recompute plus backward G_b): after the replays named in `plan`, clones
    the tensors a LaunchRecorder keeps of a launch the graph captured (a
    captured launch's tensors are the graph's static traversal inputs and
    outputs, which hold the last replay's values), so that the replayed
    launch can be held to the plain version; held_to_plain reads `seen` and
    `at`. plan: {name: (0 for G_f or 1 for G_b, replay number from 1,
    recorder call)}. Keeps references and device copies: nothing syncs."""

    def __init__(self, rec, plan):
        from mcrt_tpu_torch.utils import cuda_graph

        self.rec, self.plan, self.at, self.seen = rec, plan, set(plan), {}
        self.count = [0, 0]
        self.cls = cuda_graph.GraphedTrip
        self.real = (self.cls.replay_f, self.cls.replay_b)

    def _wrap(self, which):
        def replay(trip):
            self.real[which](trip)
            self.count[which] += 1
            for name, (w, n, call) in self.plan.items():
                if w == which and n == self.count[which]:
                    cbvh, o, d, out = self.rec.seen[call]
                    self.seen[name] = (cbvh, o.clone(), d.clone(), tuple(x.clone() for x in out))
        return replay

    def patches(self):
        stack = contextlib.ExitStack()
        stack.enter_context(mock.patch.object(self.cls, "replay_f", self._wrap(0)))
        stack.enter_context(mock.patch.object(self.cls, "replay_b", self._wrap(1)))
        return stack


class LoopSnapshots:
    """Wraps utils/cuda_graph.CapturedStep.replay (a GraphedLoop's captured
    step): after the replays named in `plan`, keeps `keep(entry)` of the entry
    a recorder (LaunchRecorder, KnnRecorder) holds of a call the graph
    captured. A captured call's tensors are the graph's static inputs and
    outputs, which hold the last replay's values, so the kept copies are the
    named replay's call. plan: {name: (replay number from 1, counted over
    every captured step replayed while the patch is on, recorder call)}.
    `seen` and `at` are what held_to_plain and knn_held_to_plain read. Keeps
    device copies: nothing syncs."""

    def __init__(self, rec, plan, keep):
        from mcrt_tpu_torch.utils import cuda_graph

        self.rec, self.plan, self.keep = rec, plan, keep
        self.at, self.seen, self.count = set(plan), {}, 0
        self.cls = cuda_graph.CapturedStep
        self.real = self.cls.replay

    def patch(self):
        def replay(step):
            self.real(step)
            self.count += 1
            for name, (n, call) in self.plan.items():
                if n == self.count:
                    self.seen[name] = self.keep(self.rec.seen[call])
        return mock.patch.object(self.cls, "replay", replay)


def keep_launch(entry):
    """A LaunchRecorder entry with its rays and outputs copied (the BVH is not)."""
    cbvh, o, d, out = entry
    return cbvh, o.clone(), d.clone(), tuple(x.clone() for x in out)


def keep_knn(entry):
    """A KnnRecorder entry with its queries, mask and result copied."""
    grid, arrays, points, k, mask, out = entry
    return (grid, arrays, points.clone(), k, None if mask is None else mask.clone(),
            type(out)(*(x.clone() for x in out)))


class Held:
    """What held_to_plain and knn_held_to_plain read, from named entries."""

    def __init__(self, seen):
        self.seen, self.at = dict(seen), set(seen)


def held_to_plain(tk, recorder, what, card, phase="grad"):
    """Each recorded launch against traverse_plain on its BVH and rays: t, id,
    u, v and the per-block stats must be bit-identical, as in phase 3, and
    every launch must hit something."""
    import torch

    check(len(recorder.seen) == len(recorder.at), phase,
          f"{what}: recorded {len(recorder.seen)} of the launches {sorted(recorder.at)}")
    for i, (cbvh, o, d, got) in sorted(recorder.seen.items()):
        check(bool((got[1] >= 0).any()), phase, f"{what}, launch {i}: no ray hit a triangle")
        t0 = time.perf_counter()
        want = tk.traverse_plain(cbvh, o, d)
        torch.cuda.synchronize()
        same = [torch.equal(a, b) for a, b in zip(got, want)]
        st = got[4]
        log(phase, f"{what}, launch {i}: {o.shape[0]} rays, {st.shape[0]} blocks, hits "
            f"{int((want[1] >= 0).sum())}, rounds max {int(st[:, 1].max())}; kernel vs plain "
            f"bit-identical t, id, u, v, stats: {same} (plain {time.perf_counter() - t0:.1f} s) | {card}")
        check(all(same), phase, f"{what}, launch {i}: kernel and plain version differ")


def device_ns_by_name(prof):
    """{kernel name: device ns} of a CUDA-only profile, summed from the raw
    events: the profiler's own per-event tables take minutes for a chunk's
    kernels."""
    from torch.autograd import DeviceType

    by_name = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            by_name[e.name()] = by_name.get(e.name(), 0) + e.duration_ns()
    return by_name


def eager_render(scene, idx, cfg, stats):
    """render()'s path-tracer main path (streamed chunks, per-pixel sums into a
    box-filtered film) with the bounce step called eagerly, one launch per op,
    as before the step was graphed (streamed_render). Adds "rays",
    "bounce_steps" and "chunks" to `stats`; returns the image as render()."""
    return streamed_render(scene, idx, cfg, stats, graphed=False)


def streamed_render(scene, idx, cfg, stats, ifn=None, graphed=True):
    """render()'s path-tracer main path (streamed chunks, per-pixel sums into a
    box-filtered film) through the intersect `ifn` (None: render()'s own,
    make_intersect_fn's defaults). graphed: each chunk runs through its
    StreamedTrace's graphed loop, as in render(); else each chunk's state from
    StreamedTrace.initial, its make_bounce_step step driven in a Python loop
    (one host sync a bounce), StreamedTrace.output. Adds "rays",
    "bounce_steps" and "chunks" to `stats`; returns the image as render()."""
    import numpy as np
    import torch

    from mcrt_tpu_torch.camera import film as film_mod
    from mcrt_tpu_torch.integrator import path_tracer as pt
    from mcrt_tpu_torch.ops import cluster_bvh
    from mcrt_tpu_torch.render import _add_pixel_sums

    dev = torch.device("cuda", 0)
    cam = scene.cameras[idx]
    spp = (cfg.sqrtspp or cam.sqrtspp) ** 2
    check(film_mod.FilmConfig.from_json(cam.width, cam.height, cam.film).is_pixel_box, "render",
          "the eager loop sums per pixel: the camera's film must be a box")
    tables = scene.tables(np.float32, dev)
    meta = scene.meta()
    if ifn is None:
        ifn = cluster_bvh.make_intersect_fn(tables, meta, scene.build_cluster_bvh(np.float32, dev))
    ptcfg = pt.PTConfig(max_bounces=cfg.max_bounces, global_seed=cfg.global_seed)
    total = cam.width * cam.height * spp
    chunk = min(cfg.rays_per_chunk, total)
    check(chunk % spp == 0 and total % chunk % spp == 0, "render", "chunks of whole pixels")
    film = torch.zeros((cam.height, cam.width, 4), dtype=torch.float32, device=dev)
    traces = {}
    for key in ("rays", "bounce_steps", "chunks"):
        stats[key] = 0
    try:
        for start in range(0, total, chunk):
            n = min(chunk, total - start)
            if n not in traces:
                traces[n] = pt.StreamedTrace(tables, meta, ptcfg, cam, spp, n, min(cfg.lanes, n),
                                             intersect_fn=ifn, pixel_sums=True)
            tr = traces[n]
            if graphed:
                sums, rays = tr(start, stats)
            else:
                st = tr.initial(start)
                while bool(st.alive.any()):
                    st = tr.step(st)
                    stats["bounce_steps"] += 1
                sums, rays = tr.output(st)
            _add_pixel_sums(film, sums, spp, start)
            stats["rays"] = stats["rays"] + rays
            stats["chunks"] += 1
    finally:
        for tr in traces.values():
            tr.close()
    return film_mod.scan(film).cpu().numpy().astype(np.float64)


def graphed_trace(scene, idx, sqrtspp, sort_rays=True):
    """The camera's image at sqrtspp^2 spp as one chunk through a StreamedTrace
    at render()'s default lanes, its intersect made with `sort_rays`, driven
    to the end of bounce 1 with traverse_kernel.traverse recorded: bounce 0
    runs eagerly (launches 0 and 1), the capture records launches 2 and 3 (a
    bounce's primary and shadow rays) and bounce 1 is its first replay.
    Launch 2's tensors are the graph's static traversal inputs and outputs,
    which hold the last replay's values. In lane order (sort_rays=False)
    the launch reads the state's own ray buffers, which the replay then
    overwrites with the next bounce's rays: its rays are kept as they were
    before the replay. Returns (trace, recorder); the caller advances and
    closes the trace."""
    import numpy as np
    import torch

    import mcrt_tpu_torch as mt
    from mcrt_tpu_torch.integrator import path_tracer as pt
    from mcrt_tpu_torch.ops import cluster_bvh
    from mcrt_tpu_torch.ops import traverse_kernel as tk

    dev = torch.device("cuda", 0)
    cam = scene.cameras[idx]
    n = cam.width * cam.height * sqrtspp ** 2
    lanes = min(mt.RenderConfig().lanes, n)
    tables = scene.tables(np.float32, dev)
    meta = scene.meta()
    ifn = cluster_bvh.make_intersect_fn(tables, meta, scene.build_cluster_bvh(np.float32, dev),
                                        sort_rays=sort_rays)
    rec = LaunchRecorder(tk, at=(2,))
    with mock.patch.object(tk, "traverse", rec):
        tr = pt.StreamedTrace(tables, meta, pt.PTConfig(), cam, sqrtspp ** 2, n, lanes,
                              intersect_fn=ifn, pixel_sums=True)
        tr.begin(0)
        tr.advance()
        rays_in = (tr.state.origin.clone(), tr.state.direction.clone())
        tr.advance()
    torch.cuda.synchronize()
    check(tr.graph is not None, "render", "the bounce step was not captured at bounce 1")
    cb, o, d, out = rec.seen[2]
    if o.data_ptr() == tr.state.origin.data_ptr():
        rec.seen[2] = (cb, *rays_in, out)
    return tr, rec


def grad_phase(scene, cbvh, card):
    """Phase 9: the differentiable path. Returns the traversal's launches over
    9a's train steps (forward and recompute), the material gather backward's
    kernel row of the JSON table (with its calls over 9a's train steps), and
    9a's first step: its inputs (tables, params, px, py, si, target) and its
    loss and gradients."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from mcrt_tpu_torch import bench
    from mcrt_tpu_torch.camera import camera as cam_mod
    from mcrt_tpu_torch.camera import film as film_mod
    from mcrt_tpu_torch.integrator import path_tracer as pt
    from mcrt_tpu_torch.materials import gather_bwd as gb
    from mcrt_tpu_torch.ops import cluster_bvh
    from mcrt_tpu_torch.ops import traverse_kernel as tk
    from mcrt_tpu_torch.parallel import sharding

    dev = cbvh.rec.device
    f32 = torch.float32
    cam = scene.cameras[0]
    meta = scene.meta()
    tables = scene.tables(np.float32, dev)
    truth = {k: getattr(tables, k) for k in sharding.DEFAULT_TRAIN_PARAMS}
    film_cfg = film_mod.FilmConfig.from_json(cam.width, cam.height, cam.film)
    cfg = pt.PTConfig(max_bounces=GRAD_BOUNCES)
    n = cam.width * cam.height
    lin = torch.arange(n, device=dev)
    px, py, si = lin % cam.width, lin // cam.width, torch.zeros_like(lin)

    # ---- 9a: SGD steps of the train step at full width ----
    image = sharding.image_step(meta, cfg, cam, film_cfg, f32, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        target = image(tables, cbvh, truth, px, py, si)
    torch.cuda.synchronize()
    log("grad", f"target {cam.width}x{cam.height}, 1 spp, max_bounces {GRAD_BOUNCES}: "
        f"{time.perf_counter() - t0:.3f} s, mean {float(target.mean()):.6f} | {card}")
    check(bool(torch.isfinite(target).all()) and float(target.mean()) > 0.0, "grad", "bad target")
    del image                   # and the trips it captured
    step = sharding.train_step(meta, cfg, cam, film_cfg, f32, with_bvh=True, device=dev)
    params = perturbed(truth)
    step0 = {"tables": tables, "params": params, "px": px, "py": py, "si": si, "target": target}
    split = GradSplit(tk)

    def train_call(params, graphed=True, patches=(), prof=None):
        """One train step under sync debug mode "error" (and inside `prof`, a
        profiler, when given): its loss, gradients, forward and backward ms
        (CUDA events), wall, traversal launches forward and in the
        recompute, peak memory allocated and the peak reserved above what was
        reserved at its start (GiB)."""
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reserved0 = torch.cuda.memory_reserved()
        a, c = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        before, gathers = tk.kernel.launches, gb.kernel.launches
        with prof if prof is not None else contextlib.nullcontext():
            t0 = time.perf_counter()
            a.record()
            torch.cuda.set_sync_debug_mode("error")
            try:
                with contextlib.ExitStack() as stack:
                    stack.enter_context(mock.patch.object(torch.autograd, "grad", split))
                    if not graphed:
                        stack.enter_context(mock.patch.object(pt, "_graph_trips", lambda d: False))
                    for p in patches:
                        stack.enter_context(p)
                    loss, grads = step(tables, cbvh, params, px, py, si, target)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            c.record()
            loss_v = float(loss)            # the step's one host read
            c.synchronize()
        return {"loss": loss_v, "grads": grads, "fwd_ms": a.elapsed_time(split.start),
                "bwd_ms": split.start.elapsed_time(c), "wall": time.perf_counter() - t0,
                "fwd_l": split.launches - before, "bwd_l": tk.kernel.launches - split.launches,
                "gather_l": gb.kernel.launches - gathers,
                "peak": torch.cuda.max_memory_allocated() / 2**30,
                "reserved": (torch.cuda.max_memory_reserved() - reserved0) / 2**30}

    def report(i, how, r, gathers=GRAD_BOUNCES):
        top = {k: float(g.abs().max()) for k, g in r["grads"].items()}
        log("grad", f"step {i} {how}: loss {r['loss']:.9g}; forward {r['fwd_ms']:.1f} ms, backward "
            f"{r['bwd_ms']:.1f} ms, wall {r['wall']:.3f} s; traversal launches forward {r['fwd_l']}, "
            f"recompute {r['bwd_l']}; gather backward kernel calls {r['gather_l']}; peak memory {r['peak']:.3f} GiB allocated, "
            f"{r['reserved']:.3f} GiB reserved above the step's start; largest |g| "
            + ", ".join(f"{k[4:]} {v:.4g}" for k, v in top.items()) + f" | {card}")
        check(np.isfinite(r["loss"]) and all(bool(torch.isfinite(g).all()) for g in r["grads"].values()),
              "grad", f"step {i} {how}: non-finite loss or gradient")
        check(top["mat_reflectance"] > 0.0, "grad", f"step {i} {how}: zero reflectance gradient")
        check(r["fwd_l"] == 2 * GRAD_BOUNCES and r["bwd_l"] == 2 * GRAD_BOUNCES, "grad",
              f"step {i} {how}: expected {2 * GRAD_BOUNCES} traversal launches forward and as many "
              f"in the recompute, got {r['fwd_l']} and {r['bwd_l']}")
        check(r["gather_l"] == gathers, "grad",
              f"step {i} {how}: expected {gathers} gather backward kernel calls, got {r['gather_l']}")

    # Step 0 captures the trip: tk.traverse's calls 0-1 are trip 0's eager
    # warm-up, 2-3 G_f's capture and 4-5 G_b's. Three replayed launches are
    # held to the plain version afterwards: G_f's primary launch after its
    # replay 8 (trip 8's rays, dead lanes parked among them), and G_b's two
    # after its replay 64 (the recompute of trip 0: camera and shadow rays).
    train_rec = LaunchRecorder(tk, at=(2, 4, 5))
    snaps = ReplaySnapshots(train_rec, {"G_f replay 8 (trip 8), primary": (0, 8, 2),
                                        "G_b replay 64 (trip 0), primary": (1, 64, 4),
                                        "G_b replay 64 (trip 0), shadow": (1, 64, 5)})
    losses, train_launches, runs = [], 0, {}
    # The last step runs under the profiler (CUDA activity only). The gather
    # backward's kernel runs once in each G_b replay, and once more in step
    # 0's eager warm-up trip (its first trip, before the capture).
    prof = profile(activities=[ProfilerActivity.CUDA])
    gb.kernel.launches = 0
    for i in range(SGD_STEPS):
        patches = (mock.patch.object(tk, "traverse", train_rec), snaps.patches()) if i == 0 else ()
        last = i == SGD_STEPS - 1
        r = train_call(params, patches=patches, prof=prof if last else None)
        report(i, "graphed, profiled" if last else "graphed", r,
               gathers=GRAD_BOUNCES + 1 if i == 0 else GRAD_BOUNCES)
        train_launches += r["fwd_l"] + r["bwd_l"]
        losses.append(r["loss"])
        if i == 0:
            step0.update(loss=r["loss"], grads=r["grads"])
            (trip,) = step.graphs.values()
            calls = trip.step_calls
            # Step 0 again, eagerly (each trip under torch.utils.checkpoint)
            # and graphed, in turns after the capture: graphed, eager, graphed.
            runs = {"graphed": [r], "eager": [train_call(params, graphed=False)]}
            runs["graphed"].append(train_call(params))
            report(0, "eager", runs["eager"][0])
            report(0, "graphed again", runs["graphed"][1])
            for how, o in (("eager", runs["eager"][0]), ("graphed again", runs["graphed"][1])):
                apart = grads_apart(o["grads"], r["grads"])
                log("grad", f"step 0 {how} against graphed: loss {o['loss']:.9g} vs {r['loss']:.9g}; "
                    f"largest |dg| / largest |g| per table "
                    + ", ".join(f"{k[4:]} {v:.3g}" for k, v in apart.items()) + f" | {card}")
                check(abs(o["loss"] - r["loss"]) <= 1e-5 * abs(r["loss"]), "grad",
                      f"step 0 {how}: the loss is not the graphed step's")
                check(all(v <= 1e-4 for v in apart.values()), "grad",
                      f"step 0 {how}: the gradients are not the graphed step's")
        params = sgd_update(params, r["grads"], truth)
    gather_launches = gb.kernel.launches
    (trip,) = step.graphs.values()
    static = sum(t.numel() * t.element_size() for t in [*trip.leaves, *trip.state, *trip.gout])
    e, g2 = runs["eager"][0], runs["graphed"][1]
    footprint = g2["reserved"] + (trip.pool_bytes + static) / 2**30
    log("grad", f"{SGD_STEPS} SGD steps of size {SGD_LR}: loss {losses[0]:.9g} -> {losses[-1]:.9g} "
        f"(no host sync inside a step: sync debug mode 'error'); gather backward kernel calls over "
        f"9a's {SGD_STEPS + 2} train steps {gather_launches} | {card}")
    per = [sum(n for c, n in trip.per_replay[w] if c is tk.kernel) for w in (0, 1)]
    log("grad", f"the trip's graphs: G_f {per[0]} and G_b {per[1]} traversal launches a replay; pool "
        f"{trip.pool_bytes / 2**30:.3f} GiB reserved, static buffers {static / 2**30:.3f} GiB; the "
        f"step's Python ran {calls} times in step 0 (the eager first trip and the two captures) and "
        f"{trip.step_calls - calls} times in the {SGD_STEPS + 1} graphed steps after | {card}")
    log("grad", f"step 0 in turns (graphed, eager, graphed): walls {runs['graphed'][0]['wall']:.3f}, "
        f"{e['wall']:.3f}, {g2['wall']:.3f} s; forward {runs['graphed'][0]['fwd_ms']:.1f}, "
        f"{e['fwd_ms']:.1f}, {g2['fwd_ms']:.1f} ms; backward {runs['graphed'][0]['bwd_ms']:.1f}, "
        f"{e['bwd_ms']:.1f}, {g2['bwd_ms']:.1f} ms; peak allocated {runs['graphed'][0]['peak']:.3f}, "
        f"{e['peak']:.3f}, {g2['peak']:.3f} GiB; memory the step holds, reserved above its start "
        f"(graphed again: plus the trip's pool and static buffers, reserved before it) "
        f"{e['reserved']:.3f} GiB eager, {footprint:.3f} GiB graphed = "
        f"{footprint / max(e['reserved'], 1e-9):.2f}x | {card}")
    check(trip.step_calls == calls == 3 and per == [2, 2], "grad",
          f"the step's Python ran {calls} times in step 0 and {trip.step_calls - calls} after; "
          f"traversal launches a replay {per}")
    check(footprint <= 1.25 * e["reserved"], "grad",
          f"the graphed step holds {footprint:.3f} GiB, more than 1.25x the eager step's "
          f"{e['reserved']:.3f} GiB")
    check(losses[-1] < losses[0], "grad", "the loss did not fall")
    by_name = device_ns_by_name(prof)
    dev_ns = sum(by_name.values())
    if dev_ns > 0:
        trav_ns = sum(v for k, v in by_name.items() if "traverse_kernel" in k)
        log("grad", f"profiled step {SGD_STEPS - 1}, graphed: wall {r['wall']:.3f} s (profiler on), "
            f"device busy {dev_ns / 1e9:.3f} s ({100 * dev_ns / 1e9 / r['wall']:.1f}% of wall; "
            f"{100 * dev_ns / 1e9 / g2['wall']:.1f}% of graphed step 0's {g2['wall']:.3f} s), traversal "
            f"{trav_ns / 1e9:.3f} s = {100 * trav_ns / dev_ns:.1f}% of device time | {card}")
        for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
            log("grad", f"  device time {v / 1e6:10.1f} ms  {k[:90]}")
    else:
        log("grad", "profiled step: device share not measured (the profiler recorded no device time)")
    del prof
    held_to_plain(tk, snaps, "train step 0", card)
    del train_rec, snaps
    gather_row = gather_bwd_check(card)
    gather_row["launches"] = gather_launches

    # ---- 9b: forward+backward at bench.py's bench_bwd point, through the port's bench ----
    # Its rate from bench.bench_bwd (a warm-up chunk, then BWD_REPS chunks side
    # by side from the middle row); the checks around it run bench.bwd_chunk,
    # the same work, where chunk 0 runs graphed and eagerly (each trip under
    # torch.utils.checkpoint) in turns.
    eager = lambda: mock.patch.object(pt, "_graph_trips", lambda d: False)
    before = tk.kernel.launches
    torch.cuda.synchronize()
    reported = mock.Mock(wraps=bench._report)      # the point's `bench:` line
    try:
        with mock.patch.object(bench, "_report", reported):
            bwd = bench.bench_bwd(scene, dev, chunk_lg=BWD_CHUNK_LG, reps=BWD_REPS, trips=BWD_TRIPS)
    except RuntimeError as e:
        fail("grad", f"bench_bwd point: {e}")
    launches_fb = tk.kernel.launches - before
    bwd.update(reported.call_args.kwargs)
    chunk, leaves = bench.bwd_chunk(scene, dev, chunk_lg=BWD_CHUNK_LG, trips=BWD_TRIPS)

    def fwd_bwd(i, remat=True):
        loss, rays = chunk(i, remat)
        return loss.detach(), rays, torch.autograd.grad(loss, list(leaves.values()))

    def timed_chunk(how):
        """fwd_bwd(0) graphed or eagerly: (result, wall s, traversal launches)."""
        torch.cuda.synchronize()
        n0, t0 = tk.kernel.launches, time.perf_counter()
        with eager() if how == "eager" else contextlib.nullcontext():
            out = fwd_bwd(0)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0, tk.kernel.launches - n0

    before = tk.kernel.launches
    t0 = time.perf_counter()
    with torch.no_grad():
        rays_f = [chunk(i)[1] for i in range(BWD_REPS)]
    torch.cuda.synchronize()
    wall_f = time.perf_counter() - t0
    fwd_launches = tk.kernel.launches - before
    n_rays_f = int(sum(int(r) for r in rays_f))
    check(n_rays_f == bwd["rays"], "grad",
          f"forward alone traced {n_rays_f} rays, with backward {bwd['rays']}")
    check(bwd["trip_step_calls"] == 3, "grad",
          f"bench_bwd: the trip's Python step ran {bwd['trip_step_calls']} times over its "
          f"{BWD_REPS + 1} chunks (3 at the warm-up's capture, none after)")
    peak, base = {}, torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fwd_bwd(0, remat=False)
    torch.cuda.synchronize()
    peak["no remat"] = (torch.cuda.max_memory_allocated() - base) / 2**30
    # Chunk 0 graphed: its first forward+backward captures the trip (its
    # traversal calls 0-1 are trip 0's eager warm-up, 2-3 G_f's capture, 4-5
    # G_b's). G_f's primary launch is held to the plain version after its
    # replay 8 (trip 8), G_b's two after its replay 56 (trip 8's recompute);
    # trip 0's rays, at the row's left end, see only sky.
    bwd_rec = LaunchRecorder(tk, at=(2, 4, 5))
    snaps = ReplaySnapshots(bwd_rec, {"G_f replay 8 (trip 8), primary": (0, 8, 2),
                                      "G_b replay 56 (trip 8), primary": (1, 56, 4),
                                      "G_b replay 56 (trip 8), shadow": (1, 56, 5)})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with mock.patch.object(tk, "traverse", bwd_rec), snaps.patches():
        got, wall_c, launches_c = timed_chunk("graphed")
    peak["remat, graphed, capturing"] = (torch.cuda.max_memory_allocated() - base) / 2**30
    torch.cuda.reset_peak_memory_stats()
    want, wall_e, launches_e = timed_chunk("eager")
    peak["remat, eager"] = (torch.cuda.max_memory_allocated() - base) / 2**30
    torch.cuda.reset_peak_memory_stats()
    again, wall_g, launches_g = timed_chunk("graphed")
    peak["remat, graphed"] = (torch.cuda.max_memory_allocated() - base) / 2**30
    fwd_trips, all_trips = BWD_REPS * BWD_TRIPS, (BWD_REPS + 1) * BWD_TRIPS
    rays0 = int(want[1])
    log("grad", f"bench_bwd point (bench.bench_bwd): {BWD_REPS} chunks of {bwd['chunk']} paths at "
        f"{BWD_SPP} spp from path {chunk.first_path} (the middle row's pixels from x = 0), after one "
        f"warm-up chunk, {bench.bwd_lanes(bwd['chunk'])} lanes, {BWD_TRIPS} trips; forward+backward "
        f"graphed {bwd['time_s']:.3f} s, {bwd['rays']} rays traced (primary + shadow) = "
        f"{bwd['rays_per_s'] / 1e6:.4f} M rays/s; forward alone (no_grad, graphed) {wall_f:.3f} s = "
        f"{n_rays_f / wall_f / 1e6:.4f} M rays/s; forward+backward / forward "
        f"{bwd['time_s'] / wall_f:.2f}x | {card}")
    log("grad", f"bench_bwd chunk 0 in turns (graphed capturing, eager, graphed): walls {wall_c:.3f}, "
        f"{wall_e:.3f}, {wall_g:.3f} s = {rays0 / wall_c / 1e6:.4f}, {rays0 / wall_e / 1e6:.4f}, "
        f"{rays0 / wall_g / 1e6:.4f} M rays/s ({wall_e / wall_g:.2f}x); traversal launches "
        f"{launches_c}, {launches_e}, {launches_g} | {card}")
    log("grad", f"bench_bwd point: traversal launches per trip {fwd_launches / fwd_trips:.2f} forward, "
        f"{launches_fb / all_trips:.2f} forward+backward (with the recompute) | {card}")
    check(fwd_launches == 2 * fwd_trips and launches_fb == 4 * all_trips and
          launches_c == launches_e == launches_g == 4 * BWD_TRIPS, "grad",
          f"bench_bwd point: expected 2 traversal launches a trip forward and 4 with the backward, "
          f"got {fwd_launches} over {fwd_trips} trips and {launches_fb} over {all_trips}; chunk 0 "
          f"{launches_c}, {launches_e}, {launches_g} over {BWD_TRIPS} trips")
    for how, o in (("graphed", got), ("graphed again", again)):
        apart = grads_apart(dict(zip(leaves, o[2])), dict(zip(leaves, want[2])))
        log("grad", f"bench_bwd chunk 0, {how} against eager: loss {float(o[0]):.9g} vs "
            f"{float(want[0]):.9g}, rays {int(o[1])} vs {rays0}; largest |dg| / largest |g| "
            f"per table " + ", ".join(f"{k[4:]} {v:.3g}" for k, v in apart.items()) + f" | {card}")
        check(abs(float(o[0]) - float(want[0])) <= 1e-5 * abs(float(want[0])) and
              int(o[1]) == rays0, "grad", f"bench_bwd chunk 0: the {how} loss or rays are not eager's")
        check(all(v <= 1e-4 for v in apart.values()), "grad",
              f"bench_bwd chunk 0: the {how} gradients are not the eager ones")
    # A profiled chunk, graphed (replays only), CUDA activity only.
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        fwd_bwd(0)
        torch.cuda.synchronize()
        wall1 = time.perf_counter() - t1
    trip = list(chunk.graphs.values())[-1]      # the no_grad forward's trip came first
    log("grad", f"bench_bwd point: peak memory allocated above the scene, one chunk: "
        + ", ".join(f"{k} {v:.3f} GiB" for k, v in peak.items())
        + f"; the graphed trip's pool {trip.pool_bytes / 2**30:.3f} GiB reserved; the trip's "
        f"Python step ran {trip.step_calls} times over chunk 0's three graphed calls, and "
        f"bench_bwd's {bwd['trip_step_calls']} times over its {BWD_REPS + 1} chunks | {card}")
    check(trip.step_calls == 3, "grad",
          f"bench_bwd chunk 0: the trip's Python step ran {trip.step_calls} times (3 at the capture)")
    by_name = device_ns_by_name(prof)
    dev_ns = sum(by_name.values())
    if dev_ns > 0:
        trav_ns = sum(v for k, v in by_name.items() if "traverse_kernel" in k)
        log("grad", f"profiled chunk, graphed: wall {wall1:.3f} s (profiler on), device busy "
            f"{dev_ns / 1e9:.3f} s ({100 * dev_ns / 1e9 / wall1:.1f}% of wall; "
            f"{100 * dev_ns / 1e9 / wall_g:.1f}% of the unprofiled graphed chunk's {wall_g:.3f} s), "
            f"traversal {trav_ns / 1e9:.3f} s = {100 * trav_ns / dev_ns:.1f}% of device time | {card}")
        for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
            log("grad", f"  device time {v / 1e6:10.1f} ms  {k[:90]}")
    else:
        log("grad", "device share: not measured (the profiler recorded no device time)")
    held_to_plain(tk, snaps, "bench_bwd chunk 0", card)
    del bwd_rec, snaps, chunk, leaves

    # ---- 9c: the kernel's gradients against the plain traversal's ----
    cam_s = dataclasses.replace(cam, width=CHECK_GRAD_WIDTH, height=CHECK_GRAD_WIDTH)
    film_s = film_mod.FilmConfig.from_json(cam_s.width, cam_s.height, cam_s.film)
    cfg_s = pt.PTConfig(max_bounces=CHECK_GRAD_BOUNCES)
    lin_s = torch.arange(cam_s.width * cam_s.height, device=dev)
    rays_s = cam_mod.generate_rays(cam_s, lin_s % cam_s.width, lin_s // cam_s.width,
                                   torch.zeros_like(lin_s), 0, f32)

    def small_image(p):
        t = tables._replace(**p)
        rad = pt.trace(t, meta, cfg_s, rays_s.origin, rays_s.direction, rays_s.pixel_index,
                       rays_s.sample_index, intersect_fn=cluster_bvh.make_intersect_fn(t, meta, cbvh),
                       differentiable=True, remat=False)
        return film_mod.scan(film_mod.splat(film_s, rays_s.px, rad))

    with torch.no_grad():
        target_s = small_image(truth)

    def small_grads():
        p = {k: v.detach().clone().requires_grad_() for k, v in perturbed(truth).items()}
        loss = torch.mean((small_image(p) - target_s) ** 2)
        return loss.detach(), dict(zip(p, torch.autograd.grad(loss, list(p.values()))))

    t0 = time.perf_counter()
    k_loss, k_g = small_grads()
    with mock.patch.object(tk, "traverse", tk.traverse_plain):
        p_loss, p_g = small_grads()
    torch.cuda.synchronize()
    t_plain = time.perf_counter() - t0
    k2_loss, k2_g = small_grads()
    worst = {}
    for name, other in (("plain", p_g), ("kernel again", k2_g)):
        rel = {k: float((k_g[k] - other[k]).abs().max()) / max(float(k_g[k].abs().max()), 1e-30)
               for k in k_g}
        worst[name] = rel
        log("grad", f"{cam_s.width}x{cam_s.height} 1 spp, max_bounces {CHECK_GRAD_BOUNCES}, no remat:"
            f" kernel vs {name}: loss {float(k_loss):.9g} vs "
            f"{float(p_loss if name == 'plain' else k2_loss):.9g}; largest |dg| / largest |g| per "
            f"table " + ", ".join(f"{k[4:]} {v:.3g}" for k, v in rel.items()))
        check(all(v <= 1e-4 for v in rel.values()), "grad",
              f"kernel and {name} gradients differ by more than 1e-4 of the largest |g|")
    check(torch.equal(k_loss, p_loss) and torch.equal(k_loss, k2_loss), "grad",
          "the losses through the kernel and through the plain traversal differ")
    log("grad", f"kernel vs plain through the gradient: losses identical; the plain route's "
        f"check took {t_plain:.1f} s | {card}")
    return train_launches, gather_row, step0


def gather_bwd_check(card):
    """Phase 9a's material gather backward at the train cell's shape, on
    card tensors: GATHER_ROWS float32 cotangent rows (mixed signs,
    magnitudes 1e-6 to 1e3) of GATHER_COLUMNS columns, summed by their
    material among GATHER_MATERIALS (drawn in the shares GATHER_SHARES). The
    kernel's result must equal the plain twin's bit for bit, and the float64
    cotangents' result rounded once; the float64 sum must lie within 1e-12
    of index_put_'s in each column (relative to the column's norm). Then
    timed with CUDA events: the kernel (ms: a CUDA graph of
    GATHER_GRAPH_CALLS calls replayed, so no host time between calls; the
    call with its wrapper, eager, beside it), the twin (plain_ms), and the
    library route, index_put_(accumulate=True) in float64 on cotangents
    converted beforehand (library_ms), which the kernel replaced. The bound:
    the bytes read, R * (C * 4 + 8) with float32 cotangents, at the HBM
    rate (the input is warm in the 50 MB L2 between calls). Returns the
    JSON table's row (less launches)."""
    import torch

    from mcrt_tpu_torch.materials import gather_bwd as gb

    dev = torch.device("cuda", 0)
    R, M, C = GATHER_ROWS, GATHER_MATERIALS, GATHER_COLUMNS
    gen = torch.Generator(device=dev).manual_seed(23)
    shares = torch.tensor(GATHER_SHARES, dtype=torch.float64, device=dev)
    m = torch.multinomial(shares, R, replacement=True, generator=gen)
    mag = 10.0 ** (torch.rand((R, C), generator=gen, device=dev, dtype=torch.float64) * 9.0 - 6.0)
    sign = torch.where(torch.rand((R, C), generator=gen, device=dev) < 0.5, -1.0, 1.0)
    grad = (mag * sign).to(torch.float32)
    g64 = grad.to(torch.float64)
    got = gb.gather_rows_backward(m, grad, M)
    plain = gb.gather_rows_backward_plain(m, grad, M)
    got64 = gb.gather_rows_backward(m, g64, M)
    lib = torch.zeros((M, C), dtype=torch.float64, device=dev).index_put_((m,), g64, accumulate=True)
    torch.cuda.synchronize()
    max_err = float((got - plain).abs().max())
    rel = float(((got64 - lib).norm(dim=0) / lib.norm(dim=0)).max())
    chunks, warps, shared = gb.layout(R, M, C)
    log("grad", f"9a gather backward at the cell's shape, {R} x {C} float32 rows into {M} materials "
        f"({chunks} chunks of {gb.CHUNK} rows, {warps} warps a chunk, accumulators in "
        f"{'shared' if shared else 'global'} memory): kernel vs plain twin bit-identical "
        f"{torch.equal(got, plain)} (largest |d| {max_err:.3g}); float64 cotangents' sum rounded "
        f"once equal {torch.equal(got, got64.to(torch.float32))}; float64 sum vs index_put_ in "
        f"float64: largest column gap {rel:.3g} of the column's norm | {card}")
    check(torch.equal(got, plain), "grad", "9a gather backward: the kernel and its plain twin differ")
    check(torch.equal(got, got64.to(torch.float32)), "grad",
          "9a gather backward: the float32 result is not the float64 sum rounded once")
    check(rel <= 1e-12, "grad", f"9a gather backward: {rel:.3g} off index_put_'s float64 sum")
    wrapper_ms = cuda_time_ms(lambda: gb.gather_rows_backward(m, grad, M), reps=50, warmup=2)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(GATHER_GRAPH_CALLS):
            gb.gather_rows_backward(m, grad, M)
    ms = cuda_time_ms(graph.replay, reps=GATHER_REPLAYS) / GATHER_GRAPH_CALLS
    del graph
    plain_ms = cuda_time_ms(lambda: gb.gather_rows_backward_plain(m, grad, M), reps=3)
    library_ms = cuda_time_ms(
        lambda: torch.zeros((M, C), dtype=torch.float64, device=dev).index_put_(
            (m,), g64, accumulate=True), reps=3)
    bytes_, adds = R * (C * 4 + 8), R * C
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, adds / FP64_OPS_PER_S
    bound_ms = max(t_bytes, t_ops) * 1e3
    log("grad", f"9a gather backward timed: {ms:.5f} ms a call replayed in a graph of "
        f"{GATHER_GRAPH_CALLS}, {wrapper_ms:.5f} ms with the wrapper; plain twin {plain_ms:.3f} ms; "
        f"index_put_ in float64 {library_ms:.3f} ms; bound {bound_ms:.5f} ms ({bytes_} bytes, "
        f"{adds} float64 adds), {ms / bound_ms:.1f}x the bound | {card}")
    return {"name": "gather_bwd", "route": "cuda", "source": "mcrt_tpu_torch/csrc/gather_bwd.cu",
            "replaces": None,     # no JAX kernel: XLA's scatter-add served the JAX package
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes > t_ops else "operations", "library_ms": library_ms,
            "library": "torch.Tensor.index_put_(accumulate=True) in float64, one call"}


def run_counted(tk, fn, sync_debug=False):
    """fn() with the traversal's launch count set to 0 just before and read just
    after; returns (result, wall s, launches, peak memory GiB). With
    `sync_debug`, fn runs under CUDA's sync debug mode set to error."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tk.kernel.launches = 0
    t0 = time.perf_counter()
    if sync_debug:
        torch.cuda.set_sync_debug_mode("error")
    try:
        out = fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, tk.kernel.launches, torch.cuda.max_memory_allocated() / 2**30


def grads_apart(got, want) -> dict:
    """Per table, the largest |got - want| over the largest |want|."""
    import numpy as np

    a = lambda x: x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)
    return {k: float(np.abs(a(got[k]) - a(want[k])).max()) / max(float(np.abs(a(want[k])).max()), 1e-30)
            for k in want}


def images_apart(a, b):
    """(elements outside rtol IMG_RTOL, atol IMG_ATOL of b, largest |a - b|)."""
    import numpy as np

    d = np.abs(a - b)
    return int((d > IMG_ATOL + IMG_RTOL * np.abs(b)).sum()), float(d.max())


def rank_main(rank: int, world: int, port: int, work: pathlib.Path) -> int:
    """One rank of phase 10b: a gloo process group of `world` ranks that all
    run on cuda:0 (NCCL takes one rank per card); the height field built anew,
    then render_distributed at 1 spp and the sharded train step at 9a's first
    step's inputs. work/inputs.npz holds those, the grid's n, the image width
    and max_bounces; the results go to work/rank<rank>.npz."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import mcrt_tpu_torch as mt
    from mcrt_tpu_torch.camera import film as film_mod
    from mcrt_tpu_torch.integrator import path_tracer as pt
    from mcrt_tpu_torch.ops import traverse_kernel as tk
    from mcrt_tpu_torch.parallel import distributed, sharding
    from mcrt_tpu_torch.scene.synthetic import height_field_scene

    dev = distributed.initialize(f"127.0.0.1:{port}", world, rank, backend="gloo",
                                 timeout_s=MULTI_TIMEOUT_S)
    try:
        mesh = distributed.global_mesh()
        tk.build()
        z = np.load(work / "inputs.npz")
        bounces = int(z["bounces"])
        t0 = time.perf_counter()
        scene = mt.Scene(height_field_scene(int(z["grid_n"]), int(z["width"]), 1))
        cbvh = scene.build_cluster_bvh(np.float32, dev)
        tables = scene.tables(np.float32, dev)
        torch.cuda.synchronize()
        t_scene = time.perf_counter() - t0
        params = {k: torch.as_tensor(z[k], device=dev) for k in sharding.DEFAULT_TRAIN_PARAMS}
        target = torch.as_tensor(z["target"], device=dev)
        cam = scene.cameras[0]
        lin = torch.arange(cam.width * cam.height, device=dev)
        px, py, si = lin % cam.width, lin // cam.width, torch.zeros_like(lin)
        img, wall_r, launches_r, peak_r = run_counted(tk, lambda: distributed.render_distributed(
            scene, 0, mt.RenderConfig(max_bounces=bounces, sqrtspp=1)))
        step = sharding.sharded_train_step(
            scene.meta(), pt.PTConfig(max_bounces=bounces), cam,
            film_mod.FilmConfig.from_json(cam.width, cam.height, cam.film), mesh, torch.float32,
            with_bvh=True, device=dev)
        (loss, grads), wall_t, launches_t, peak = run_counted(
            tk, lambda: step(tables, cbvh, params, px, py, si, target))
        np.savez(work / f"rank{rank}.npz", img=img, loss=float(loss),
                 launches=np.array([launches_r, launches_t]),
                 **{k: g.cpu().numpy() for k, g in grads.items()})
        log("multi", f"10b rank {rank} of {world} ({dist.get_backend()}, {dev}): scene and BVH "
            f"{t_scene:.2f} s; render_distributed {wall_r:.3f} s, traversal launches "
            f"{launches_r}, peak memory {peak_r:.3f} GiB; sharded train step {wall_t:.3f} s, loss {float(loss):.9g}, "
            f"traversal launches {launches_t}, peak memory {peak:.3f} GiB")
    finally:
        dist.destroy_process_group()
    return 0


def bwd_turns_main(chunk_lg: int) -> int:
    """Phase 11a's child: bench.bench_bwd at 2^chunk_lg paths a chunk on the
    bench's scene, graphed and then eagerly (each trip under
    torch.utils.checkpoint), BWD_TURN_REPS chunks each after a warm-up;
    prints one JSON line {"graphed": ..., "eager": ...} of their results."""
    import torch

    from mcrt_tpu_torch import bench
    from mcrt_tpu_torch.integrator import path_tracer as pt

    dev = torch.device("cuda", 0)
    scene = bench.bench_scene()
    out = {"graphed": bench.bench_bwd(scene, dev, chunk_lg=chunk_lg, reps=BWD_TURN_REPS)}
    with mock.patch.object(pt, "_graph_trips", lambda d: False):
        out["eager"] = bench.bench_bwd(scene, dev, chunk_lg=chunk_lg, reps=BWD_TURN_REPS)
    print(json.dumps(out), flush=True)
    return 0


def multi_phase(scene, cbvh, card, step0):
    """Phase 10: the sharded steps on torch.distributed. Returns the traversal's
    launches and the material gather backward's kernel calls in 10a's sharded
    train step."""
    import numpy as np
    import torch
    import torch.distributed as dist

    import mcrt_tpu_torch as mt
    from mcrt_tpu_torch.camera import film as film_mod
    from mcrt_tpu_torch.integrator import path_tracer as pt
    from mcrt_tpu_torch.materials import gather_bwd as gb
    from mcrt_tpu_torch.ops import traverse_kernel as tk
    from mcrt_tpu_torch.parallel import distributed, sharding

    dev = cbvh.rec.device
    cam = scene.cameras[0]
    meta = scene.meta()
    film_cfg = film_mod.FilmConfig.from_json(cam.width, cam.height, cam.film)
    cfg = pt.PTConfig(max_bounces=GRAD_BOUNCES)
    tables, params, target = step0["tables"], step0["params"], step0["target"]
    rays = (step0["px"], step0["py"], step0["si"])
    cfg1 = mt.RenderConfig(max_bounces=GRAD_BOUNCES, sqrtspp=1)

    # ---- 10a: a world of one over NCCL, in this process ----
    rank_dev = distributed.initialize(f"127.0.0.1:{distributed.free_port()}", 1, 0,
                                      timeout_s=MULTI_TIMEOUT_S)
    try:
        mesh = distributed.global_mesh()
        check(dist.get_backend() == "nccl" and mesh.size == 1 and rank_dev == dev, "multi",
              f"expected a world of one over NCCL on {dev}, got {dist.get_backend()}, "
              f"{mesh.size} ranks, {rank_dev}")
        warm = torch.ones(1, device=dev)
        dist.all_reduce(warm)        # the NCCL communicator is made at its first collective
        torch.cuda.synchronize()
        step = sharding.sharded_train_step(meta, cfg, cam, film_cfg, mesh, torch.float32,
                                           with_bvh=True, device=dev)
        gb.kernel.launches = 0
        (loss, grads), wall, launches_t, peak = run_counted(
            tk, lambda: step(tables, cbvh, params, *rays, target), sync_debug=True)
        gathers_t = gb.kernel.launches
        apart = grads_apart(grads, step0["grads"])
        log("multi", f"10a sharded train step, world of one (nccl), {cam.width}x{cam.height} 1 spp, "
            f"max_bounces {GRAD_BOUNCES}: {wall:.3f} s, loss {float(loss):.9g} (9a step 0: "
            f"{step0['loss']:.9g}), traversal launches {launches_t}, gather backward kernel calls "
            f"{gathers_t}, peak memory {peak:.3f} GiB; "
            f"largest |dg| / largest |g| against 9a step 0: "
            + ", ".join(f"{k[4:]} {v:.3g}" for k, v in apart.items()) + f" | {card}")
        check(launches_t > 0, "multi", "the sharded train step launched no traversal")
        check(gathers_t == GRAD_BOUNCES + 1, "multi",
              f"the sharded train step called the gather backward's kernel {gathers_t} times, not "
              f"{GRAD_BOUNCES + 1} (one a G_b replay, one in the eager warm-up trip)")
        check(abs(float(loss) - step0["loss"]) <= 1e-5 * abs(step0["loss"]), "multi",
              "the sharded train step's loss is not 9a's")
        check(all(v <= 1e-4 for v in apart.values()), "multi",
              "the sharded train step's gradients are not 9a's")
        # The one-device train step and the sharded one over this world of one,
        # in turns on the same inputs and under the same debug mode: whether
        # the group's two all-reduces cost the step any wall.
        one = sharding.train_step(meta, cfg, cam, film_cfg, torch.float32, with_bvh=True, device=dev)
        walls = {"train_step": [], "sharded_train_step": []}
        for name, fn in (("train_step", one), ("sharded_train_step", step),
                         ("sharded_train_step", step), ("train_step", one)):
            (loss_i, _), wall_i, _, _ = run_counted(
                tk, lambda: fn(tables, cbvh, params, *rays, target), sync_debug=True)
            walls[name].append(wall_i)
            check(abs(float(loss_i) - float(loss)) <= 1e-5 * abs(float(loss)), "multi",
                  f"{name}: the loss moved between runs")
        calls = [t.step_calls for fn in (step, one) for t in fn.graphs.values()]
        log("multi", f"10a in turns (train, sharded, sharded, train), walls: train_step "
            + ", ".join(f"{w:.3f}" for w in walls["train_step"]) + " s; sharded_train_step "
            + ", ".join(f"{w:.3f}" for w in walls["sharded_train_step"])
            + f" s (its first call above: {wall:.3f} s; each step's first call captures its "
            f"trip); the trips' Python step calls (sharded, train) {calls} | {card}")
        check(calls == [3, 3], "multi", f"10a: the trips' Python step ran {calls} times "
              "(3 at each step's capture, none after)")
        del one
        rstep = sharding.sharded_render_step(meta, cfg, cam, film_cfg, mesh, torch.float32,
                                             with_bvh=True, device=dev)
        zero = torch.zeros((cam.height, cam.width, 4), device=dev)
        film, wall_s, launches_s, peak_s = run_counted(tk, lambda: rstep(tables, cbvh, *rays, zero))
        img_s = film_mod.scan(film).cpu().numpy()
        check(len(rstep.graphs) == 1, "multi", f"10a: the render step kept {len(rstep.graphs)} runs")
        (run_s,) = rstep.graphs.values()   # one batch size, one run
        check(run_s.graph is not None, "multi", "10a: the render step's bounce step was not captured")
        pools = {"sharded_render_step": run_s.graph.pool_bytes / 2**20}
        run_s.close()
        # Two launches of render_distributed's first chunk (131,072 rays, 512
        # blocks) are held to the plain version afterwards: bounce 0's camera
        # rays (an eager launch) and bounce 8's rays, dead lanes parked among
        # them: the captured launch (recorder call 2), copied after replay 8.
        dist_rec = LaunchRecorder(tk, at=(0, 2))
        dist_snaps = LoopSnapshots(dist_rec, {"bounce 8, replay 8": (8, 2)}, keep_launch)
        dist_caps = CaptureLog()
        with mock.patch.object(tk, "traverse", dist_rec), dist_snaps.patch(), dist_caps.patch():
            img_d, wall_d, launches_d, peak_d = run_counted(
                tk, lambda: distributed.render_distributed(scene, 0, cfg1))
        pools["render_distributed"] = sum(m[1] for m in dist_caps.made) / 2**20
        check(len(dist_caps.made) == 1, "multi",
              f"10a: render_distributed captured {len(dist_caps.made)} steps, not one")
        img_r, wall_r, launches_r, _ = run_counted(tk, lambda: mt.render(scene, 0, cfg1))
        for name, img, w, n_l, pk in (("sharded_render_step", img_s, wall_s, launches_s, peak_s),
                                      ("render_distributed", img_d, wall_d, launches_d, peak_d)):
            bad, worst = images_apart(img, img_r)
            log("multi", f"10a {name}, {cam.width}x{cam.height} 1 spp: {w:.3f} s, traversal "
                f"launches {n_l}, peak memory {pk:.3f} GiB; against render() ({wall_r:.3f} s, "
                f"{launches_r} launches): {bad} elements outside rtol {IMG_RTOL} atol {IMG_ATOL}, "
                f"largest |d| {worst:.3g}; its batch run's graph pool {pools[name]:.1f} MiB | {card}")
            check(n_l > 0, "multi", f"{name} launched no traversal")
            check(bool(np.isfinite(img).all()) and bad == 0, "multi", f"{name} is not render()'s image")
        held = Held({"bounce 0": dist_rec.seen[0], **dist_snaps.seen})
        del dist_rec, dist_snaps
        held_to_plain(tk, held, "10a render_distributed chunk 0", card, phase="multi")
        del held
        loss_a, grads_a = float(loss), {k: g.cpu().numpy() for k, g in grads.items()}
        del step, rstep, film, grads
    finally:
        dist.destroy_process_group()

    # ---- 10b: MULTI_RANKS gloo ranks on the one card, one process each ----
    with tempfile.TemporaryDirectory(prefix="chip_smoke_multi_") as tmp:
        work = pathlib.Path(tmp)
        np.savez(work / "inputs.npz", target=target.cpu().numpy(), grid_n=GRID_N, width=cam.width,
                 bounces=GRAD_BOUNCES, **{k: v.cpu().numpy() for k, v in params.items()})
        torch.cuda.empty_cache()
        port = distributed.free_port()
        t0 = time.perf_counter()
        procs = []
        try:
            for r in range(MULTI_RANKS):
                with open(work / f"rank{r}.log", "w") as out:
                    procs.append(subprocess.Popen(
                        [sys.executable, str(ROOT / "chip_smoke.py"), "rank", str(r),
                         str(MULTI_RANKS), str(port), str(work)],
                        cwd=ROOT, stdout=out, stderr=subprocess.STDOUT))
            while any(p.poll() is None for p in procs) and time.perf_counter() - t0 < MULTI_TIMEOUT_S:
                if any(p.poll() not in (None, 0) for p in procs):
                    break
                time.sleep(0.2)
        finally:
            for p in procs:   # a rank still running after a failure or the timeout is stopped
                if p.poll() is None:
                    p.kill()
                p.wait()
        wall_b = time.perf_counter() - t0
        for r in range(MULTI_RANKS):
            for line in (work / f"rank{r}.log").read_text().splitlines()[-40:]:
                print(f"  rank {r}: {line}" if not line.startswith("[multi]") else line, flush=True)
        codes = [p.returncode for p in procs]
        check(all(c == 0 for c in codes), "multi", f"10b: the ranks exited with {codes} "
              f"after {wall_b:.1f} s (timeout {MULTI_TIMEOUT_S:.0f} s)")
        res = [dict(np.load(work / f"rank{r}.npz")) for r in range(MULTI_RANKS)]
    same = all(np.array_equal(res[0][k], x[k]) for x in res[1:] for k in res[0] if k != "launches")
    bad, worst = images_apart(res[0]["img"], img_d)
    apart = grads_apart(res[0], grads_a)
    log("multi", f"10b {MULTI_RANKS} gloo ranks on {dev}: {wall_b:.1f} s in all; every rank holds "
        f"the same image, loss and gradients: {same}; render_distributed against 10a's: {bad} "
        f"elements outside the bars, largest |d| {worst:.3g}; loss {float(res[0]['loss']):.9g} "
        f"(10a {loss_a:.9g}); largest |dg| / largest |g| against 10a: "
        + ", ".join(f"{k[4:]} {v:.3g}" for k, v in apart.items())
        + f"; traversal launches per rank (render, train) "
        + ", ".join(str(x["launches"].tolist()) for x in res) + f" | {card}")
    check(same, "multi", "10b: the ranks hold different results")
    check(all(bool((x["launches"] > 0).all()) for x in res), "multi",
          "10b: a rank launched no traversal")
    check(bad == 0, "multi", "10b: render_distributed is not 10a's image")
    check(abs(float(res[0]["loss"]) - loss_a) <= 1e-5 * abs(loss_a), "multi",
          "10b: the train step's loss is not 10a's")
    check(all(v <= 1e-4 for v in apart.values()), "multi", "10b: the gradients are not 10a's")

    # ---- 10c: render() with profile_dir writes a trace that names the kernel ----
    scene.cameras.append(dataclasses.replace(cam, width=PROFILE_WIDTH, height=PROFILE_WIDTH))
    idx = len(scene.cameras) - 1
    with tempfile.TemporaryDirectory(prefix="chip_smoke_profile_") as tmp:
        cfg_n = dataclasses.replace(cfg1, max_bounces=PROFILE_BOUNCES)
        cfg_p = dataclasses.replace(cfg_n, profile_dir=tmp)
        img_p, wall_p, launches_p, _ = run_counted(tk, lambda: mt.render(scene, idx, cfg_p))
        files = list(pathlib.Path(tmp).glob("*.pt.trace.json"))
        check(len(files) == 1, "multi", f"10c: {len(files)} trace files in profile_dir")
        text = files[0].read_text()
        events = json.loads(text)["traceEvents"]
        kern = [e for e in events if e.get("cat") == "kernel" and "traverse_kernel" in e.get("name", "")]
        log("multi", f"10c render with profile_dir, {PROFILE_WIDTH}x{PROFILE_WIDTH} 1 spp, max_bounces "
            f"{PROFILE_BOUNCES}: {wall_p:.3f} s "
            f"(profiler on), trace {files[0].name} {len(text) / 2**20:.1f} MiB, {len(events)} events, "
            f"{len(kern)} traverse_kernel kernel events, {launches_p} launches counted | {card}")
        check("traverse_kernel" in text and len(kern) > 0, "multi", "10c: the trace names no traverse_kernel")
    img_n = mt.render(scene, idx, cfg_n)
    bad, worst = images_apart(img_p, img_n)
    check(bad == 0, "multi", f"10c: the profiled image is not the unprofiled one ({bad} elements)")
    scene.cameras.pop()
    return launches_t, gathers_t


def bench_phase(scene, cbvh, card, render_rays_per_path):
    """Phase 11: the bench as a user runs it, then the intersect in lane order
    and the traversal statistics. Returns the traversal launches of the
    bench's two processes."""
    import numpy as np
    import torch

    import mcrt_tpu_torch as mt
    from mcrt_tpu_torch.camera import camera as cam_mod
    from mcrt_tpu_torch.integrator import path_tracer as pt
    from mcrt_tpu_torch.ops import cluster_bvh
    from mcrt_tpu_torch.ops import traverse_kernel as tk

    # ---- 11a: the bench, as a child process ----
    lib = pathlib.Path(tk.kernel.lib._name)
    built = sorted(p.name for p in lib.parent.iterdir())
    t0 = time.perf_counter()
    out = subprocess.run(BENCH_CMD, capture_output=True, text=True, timeout=BENCH_TIMEOUT_S,
                         cwd=str(ROOT))
    wall = time.perf_counter() - t0
    err = out.stderr.splitlines()
    lines = [line for line in out.stdout.splitlines() if line.startswith("{")]
    if out.returncode != 0 or not lines:
        print("\n".join(err[-30:]), flush=True)
        fail("bench", f"`{' '.join(BENCH_CMD[1:])}` exited {out.returncode} with no result line")
    res = json.loads(lines[-1])
    log("bench", f"line: {lines[-1]}")
    points = {r["point"]: r for r in (json.loads(line[len("bench: "):]) for line in err
                                      if line.startswith("bench: "))}
    check(set(res) == BENCH_KEYS, "bench", f"the line's keys {sorted(res)}")
    for key in ("value", "fwd_bwd_rays_per_s_1024spp", "diag_walk_steps_32k", "diag_leaf_rounds_32k"):
        check(isinstance(res[key], (int, float)) and np.isfinite(res[key]) and res[key] > 0, "bench",
              f"{key} = {res[key]!r}")
    check(set(points) == {"forward", "forward+backward"}, "bench", f"points reported: {sorted(points)}")
    fwd, bwd = points["forward"], points["forward+backward"]
    per_path = fwd["rays"] / (fwd["chunks"] * fwd["chunk"])
    check(abs(per_path / render_rays_per_path - 1.0) <= 0.10, "bench",
          f"rays per path {per_path:.4f} against phase 4's {render_rays_per_path:.4f}")
    check(all(p["kernel_library"] == str(lib) for p in points.values()), "bench",
          f"the bench loaded {[p['kernel_library'] for p in points.values()]}, not {lib}")
    check(sorted(p.name for p in lib.parent.iterdir()) == built, "bench",
          f"the bench built something in {lib.parent}")
    launches = fwd["process_launches"] + bwd["process_launches"]
    check(fwd["launches"] > 0 and fwd["diag_launches"] > 0 and bwd["launches"] > 0, "bench",
          f"traversal launches forward {fwd['launches']}, diagnostic {fwd['diag_launches']}, "
          f"forward+backward {bwd['launches']}")
    check(fwd["launches"] == 2 * fwd["bounce_steps"] and fwd["graph_pool_bytes"], "bench",
          f"the forward point's {fwd['launches']} launches for {fwd['bounce_steps']} graphed bounce "
          f"steps, graph pool {fwd['graph_pool_bytes']}")
    check(fwd["diag_launches"] == 2 * fwd["diag_bounce_steps"] and fwd["diag_graph_pool_bytes"],
          "bench", f"the diagnostic trace's {fwd['diag_launches']} launches for "
          f"{fwd['diag_bounce_steps']} graphed bounce steps, graph pool {fwd['diag_graph_pool_bytes']}")
    check(bwd["launches"] == 4 * bwd["reps"] * bwd["trips"] and bwd["graph_pool_bytes"]
          and bwd["trip_step_calls"] == 3, "bench",
          f"the forward+backward point's {bwd['launches']} launches for {bwd['reps']} chunks of "
          f"{bwd['trips']} trips, graph pool {bwd['graph_pool_bytes']}, the trip's Python step "
          f"called {bwd['trip_step_calls']} times (3 at the warm-up's capture, none after)")
    log("bench", f"python -m mcrt_tpu_torch.bench: wall {wall:.1f} s; forward {fwd['chunks']} chunks of "
        f"{fwd['chunk']} paths through {fwd['lanes']} lanes {fwd['time_s']:.3f} s, {fwd['rays']} rays "
        f"({per_path:.4f} a path, phase 4 {render_rays_per_path:.4f}), {fwd['bounce_steps']} bounce steps, "
        f"{fwd['launches']} traversal launches, graph pool {fwd['graph_pool_bytes'] / 2**20:.1f} MiB; diagnostic {fwd['diag_paths']} paths from path "
        f"{fwd['diag_first_path']}, {fwd['diag_bounce_steps']} bounce steps, {fwd['diag_launches']} "
        f"launches, graph pool {fwd['diag_graph_pool_bytes'] / 2**20:.1f} MiB; forward+backward {bwd['reps']} chunks of {bwd['chunk']} paths through "
        f"{bwd['lanes']} lanes, {bwd['trips']} trips, {bwd['time_s']:.3f} s, {bwd['rays']} rays, "
        f"{bwd['launches']} launches, trip graph pool {bwd['graph_pool_bytes'] / 2**30:.3f} GiB; "
        f"{launches} launches in all, warm-ups included; kernel library "
        f"{lib.name} in both processes | {card}")
    # The bench's forward point with the step called eagerly, in turn after the
    # graphed one: the same 16 chunks of 2^18 paths through 16384 lanes, the
    # same rays and bounce steps, one host sync a bounce (no warm-up chunk).
    stats_e = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager_render(scene, 0, mt.RenderConfig(rays_per_chunk=fwd["chunk"], lanes=fwd["lanes"]), stats_e)
    wall_e = time.perf_counter() - t0
    rays_e = int(stats_e["rays"])
    log("bench", f"the forward point eagerly: {stats_e['chunks']} chunks in {wall_e:.3f} s, {rays_e} rays, "
        f"{rays_e / wall_e / 1e6:.4f} M rays/s, {stats_e['bounce_steps']} bounce steps; graphed (the "
        f"bench's value) {fwd['time_s']:.3f} s, {res['value'] / 1e6:.4f} M rays/s, {fwd['bounce_steps']} "
        f"bounce steps | {card}")
    check(rays_e == fwd["rays"] and stats_e["bounce_steps"] == fwd["bounce_steps"], "bench",
          "the eager forward point's rays or bounce steps are not the bench's")
    # The bench's diagnostic trace in this process with the step called
    # eagerly: the bounce steps and both counters of the bench's graphed one.
    from mcrt_tpu_torch import bench

    cam0 = scene.cameras[0]
    rays = bench._camera_rays(cam0, cam0.sqrtspp ** 2, fwd["diag_first_path"], fwd["diag_paths"], 0,
                              torch.float32, cbvh.rec.device)
    tables0 = scene.tables(np.float32, cbvh.rec.device)
    ifn0 = cluster_bvh.make_intersect_fn(tables0, scene.meta(), cbvh)
    with eager_loops():
        _, st_d = pt.trace(tables0, scene.meta(), pt.PTConfig(), rays.origin, rays.direction,
                           rays.pixel_index, rays.sample_index, intersect_fn=ifn0, return_stats=True)
    eager_diag = [int(x) for x in st_d["traversal_steps"]]
    log("bench", f"the diagnostic trace eagerly: {st_d['bounce_steps']} bounce steps, counters "
        f"{eager_diag}; the bench's (graphed) {fwd['diag_bounce_steps']} and "
        f"{[res['diag_walk_steps_32k'], res['diag_leaf_rounds_32k']]} | {card}")
    check(st_d["bounce_steps"] == fwd["diag_bounce_steps"]
          and eager_diag == [res["diag_walk_steps_32k"], res["diag_leaf_rounds_32k"]], "bench",
          "the graphed diagnostic trace's bounce steps or counters are not the eager loop's")
    del rays, tables0, ifn0
    # The bench's forward+backward point graphed and eagerly, in one child
    # process of its own (the bench's chunk, BWD_TURN_REPS chunks each way).
    cmd = [sys.executable, str(ROOT / "chip_smoke.py"), "bwd", str(bwd["chunk"].bit_length() - 1)]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=BENCH_TIMEOUT_S, cwd=str(ROOT))
    wall_t = time.perf_counter() - t0
    lines = [line for line in out.stdout.splitlines() if line.startswith("{")]
    if out.returncode != 0 or not lines:
        print("\n".join(out.stderr.splitlines()[-30:]), flush=True)
        fail("bench", f"the forward+backward point in turns exited {out.returncode} with no result")
    turns = json.loads(lines[-1])
    g, e = turns["graphed"], turns["eager"]
    log("bench", f"the forward+backward point, {BWD_TURN_REPS} chunks of {g['chunk']} paths each way "
        f"in one process ({wall_t:.1f} s with the scene): graphed {g['time_s']:.3f} s, "
        f"{g['rays_per_s'] / 1e6:.4f} M rays/s; eagerly {e['time_s']:.3f} s, "
        f"{e['rays_per_s'] / 1e6:.4f} M rays/s ({g['rays_per_s'] / e['rays_per_s']:.2f}x); rays "
        f"{g['rays']} and {e['rays']}, last loss {g['loss']:.9g} and {e['loss']:.9g}; the bench's "
        f"fwd_bwd_rays_per_s_1024spp (graphed, {bwd['reps']} chunks) "
        f"{res['fwd_bwd_rays_per_s_1024spp'] / 1e6:.4f} M | {card}")
    check(g["rays"] == e["rays"] and abs(g["loss"] - e["loss"]) <= 1e-5 * abs(e["loss"]), "bench",
          "the forward+backward point's rays or loss differ graphed and eagerly")

    # ---- 11b: the intersect in lane order ----
    # make_intersect_fn(sort_rays=False): the kernel sees the rays as the
    # integrator holds them. Both orders render through render()'s streamed
    # chunks, graphed (streamed_render).
    dev = cbvh.rec.device
    scene.cameras.append(dataclasses.replace(scene.cameras[0], width=SWITCH_WIDTH, height=SWITCH_WIDTH))
    ci = len(scene.cameras) - 1
    cfg_s = mt.RenderConfig(sqrtspp=2)
    tables_s = scene.tables(np.float32, dev)
    orders = {"sorted": True, "unsorted": False}
    imgs, walls = {}, {}
    for name, sort_rays in orders.items():
        ifn_s = cluster_bvh.make_intersect_fn(tables_s, scene.meta(), cbvh, sort_rays=sort_rays)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        imgs[name] = streamed_render(scene, ci, cfg_s, {}, ifn=ifn_s)
        walls[name] = time.perf_counter() - t0
    del tables_s, ifn_s
    bad, worst = images_apart(imgs["unsorted"], imgs["sorted"])
    log("bench", f"{SWITCH_WIDTH}x{SWITCH_WIDTH} 4 spp in lane order vs sorted: {bad} elements outside "
        f"rtol {IMG_RTOL} atol {IMG_ATOL}, largest |d| {worst:.3g}, hdr identical "
        f"{bool((imgs['unsorted'] == imgs['sorted']).all())}; walls {walls['unsorted']:.3f} s and "
        f"{walls['sorted']:.3f} s")
    check(bad == 0, "bench", "the render in lane order and the sorted render disagree")
    # Launch 2 (bounce 1's primary rays) of each order: the captured launch after
    # its first replay.
    for name, sort_rays in orders.items():
        tr, rec = graphed_trace(scene, ci, 2, sort_rays=sort_rays)
        try:
            o, st = rec.seen[2][1], rec.seen[2][3][4].double()
            log("bench", f"{name} launch 2: {o.shape[0]} rays, {st.shape[0]} blocks, candidates per block "
                f"mean {float(st[:, 0].mean()):.1f}, rounds per block mean {float(st[:, 1].mean()):.1f} "
                f"max {int(st[:, 1].max())}, rounds in all {int(st[:, 1].sum())} | {card}")
            if name == "unsorted":
                check(o.shape[0] == SWITCH_WIDTH ** 2 * 4, "bench", "the unsorted launch is not one ray a path")
                held_to_plain(tk, rec, "11b unsorted launch", card, phase="bench")
        finally:
            tr.close()
            del tr, rec

    # ---- 11c: the traversal statistics ----
    cam_c = scene.cameras[ci]
    tables = scene.tables(np.float32, dev)
    meta = scene.meta()
    ifn = cluster_bvh.make_intersect_fn(tables, meta, cbvh)
    lin = torch.arange(cam_c.width * cam_c.height, device=dev)
    rays = cam_mod.generate_rays(cam_c, lin % cam_c.width, lin // cam_c.width, torch.zeros_like(lin),
                                 0, torch.float32)
    # Eagerly (eager_loops), so that the recorder sees every launch, then
    # graphed: the recorder sees only the eager first step and the capture.
    rec = LaunchRecorder(tk, at=range(1 << 16))
    trace = lambda: pt.trace(tables, meta, pt.PTConfig(), rays.origin, rays.direction,
                             rays.pixel_index, rays.sample_index, intersect_fn=ifn, return_stats=True)
    with mock.patch.object(tk, "traverse", rec), eager_loops():
        _, st = trace()
    check(len(rec.seen) == 2 * st["bounce_steps"], "bench",
          f"{len(rec.seen)} launches for {st['bounce_steps']} bounce steps")
    want = sum(torch.stack([out[4][:, 0].sum(), out[4][:, 1].max()]).long()
               for i, (_, _, _, out) in rec.seen.items() if i % 2 == 0)
    got = st.get("traversal_steps")
    _, st_g = trace()
    got_g = st_g.get("traversal_steps")
    log("bench", f"{cam_c.width}x{cam_c.height} 1 spp trace, eager: traversal_steps "
        f"{None if got is None else got.tolist()}, the launches' stats {want.tolist()} over "
        f"{st['bounce_steps']} primary launches; graphed: traversal_steps "
        f"{None if got_g is None else got_g.tolist()} over {st_g['bounce_steps']} bounce steps | {card}")
    check(got is not None and torch.equal(got, want), "bench",
          "traversal_steps is not the sum of the primary launches' stats")
    check(got_g is not None and torch.equal(got_g, got) and st_g["bounce_steps"] == st["bounce_steps"],
          "bench", "the graphed trace's traversal_steps or bounce steps are not the eager loop's")
    return launches


def batch_phase(scene, cbvh, card, pm_dir):
    """Phase 12: the batch chunks of both integrators, render(streamed=False),
    each chunk one batch of camera rays through its integrator's batch run
    (path_tracer.BatchTrace, photon_mapper.BatchEyePass; one per chunk size),
    graphed, eagerly (eager_loops) and graphed again in turns; a replayed
    traversal launch and replayed k-NN calls held to their plain versions;
    the traversal (and k-NN) timed at the batch size; a profiled graphed
    render of each integrator."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import mcrt_tpu_torch as mt
    from mcrt_tpu_torch.accel import knn_kernel as kk
    from mcrt_tpu_torch.ops import traverse_kernel as tk
    from mcrt_tpu_torch.utils import cuda_graph

    cam = scene.cameras[0]
    counters = (tk.kernel, *kk.KERNELS)
    captures = CaptureLog()

    real_drain = cuda_graph.GraphedLoop.drain

    def timed_drain(loop, drains):
        """GraphedLoop.drain between two synchronisations, its (steps, wall s)
        appended to `drains`: a chunk's bounce loop apart from its set-up."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps = real_drain(loop)
        torch.cuda.synchronize()
        drains.append((steps, time.perf_counter() - t0))
        return steps

    def turn(integrator, how, cfg, record=None, ckpt=None):
        """One render: (image, stats, wall s, launches by counter, peak GiB)."""
        stats, drains = {}, []
        with contextlib.ExitStack() as stack:
            stack.enter_context(eager_loops() if how == "eager" else captures.patch())
            stack.enter_context(mock.patch.object(cuda_graph.GraphedLoop, "drain",
                                                  lambda loop: timed_drain(loop, drains)))
            for patch in record or ():
                stack.enter_context(patch)
            for c in counters:
                c.launches = 0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            img = mt.render(scene, 0, cfg, stats=stats, checkpoint_dir=ckpt, checkpoint_every_s=1e9)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = {c.name: c.launches for c in counters}
        peak = torch.cuda.max_memory_allocated() / 2**30
        steps = stats["bounce_steps"]
        log("batch", f"{integrator}, {how}: {cam.width}x{cam.height} 1 spp, max_bounces 64, "
            f"{stats['chunks']} chunks of {cfg.rays_per_chunk} paths: wall {wall:.3f} s, {steps} "
            f"bounce steps ({1e3 * wall / steps:.2f} ms a step), launches {launches}, peak memory "
            f"{peak:.3f} GiB" + (f", rays {int(stats['rays'])}" if "rays" in stats else "")
            + "; the chunks' bounce loops (steps, s) " + ", ".join(f"({n}, {t:.3f})" for n, t in drains)
            + f", the rest {wall - sum(t for _, t in drains):.3f} s | {card}")
        check(bool(np.isfinite(img).all()) and float(img.min()) >= 0.0 and float(img.mean()) > 0.0,
              "batch", f"{integrator}, {how}: a non-finite, negative or black image")
        check(launches[tk.kernel.name] == 2 * steps > 0, "batch",
              f"{integrator}, {how}: {launches} launches for {steps} bounce steps")
        if integrator == "photon_mapper":
            check(stats.get("photon_maps_loaded") is True, "batch",
                  f"{how}: the photon maps were not loaded from phase 6's checkpoint")
            check(all(launches[k.name] == 2 * steps for k in kk.KERNELS), "batch",
                  f"{how}: k-NN launches {launches} for {steps} bounce steps")
        return img, stats, wall, launches, peak

    def turns(integrator, cfg, record, ckpts):
        runs = [turn(integrator, how, cfg, record if i == 0 else None, ckpt)
                for i, (how, ckpt) in enumerate(zip(("graphed", "eager", "graphed again"), ckpts))]
        img, stats, _, launches, _ = runs[0]
        same_keys = [k for k in stats if k in ("rays", "bounce_steps") or k.startswith("knn_")]
        for (img_o, stats_o, _, launches_o, _), how in zip(runs[1:], ("eager", "graphed again")):
            bad, worst = images_apart(img, img_o)
            same = all(int(stats[k]) == int(stats_o[k]) for k in same_keys) and launches == launches_o
            log("batch", f"{integrator}, graphed against {how}: {bad} elements outside rtol "
                f"{IMG_RTOL} atol {IMG_ATOL}, largest |d| {worst:.3g}; {', '.join(same_keys)} and "
                f"launches identical {same} | {card}")
            check(bad == 0 and same, "batch", f"{integrator}: the graphed and {how} renders disagree")
        log("batch", f"{integrator}, walls in turns (graphed, eager, graphed): "
            + ", ".join(f"{r[2]:.3f}" for r in runs) + " s; peak memory "
            + ", ".join(f"{r[4]:.3f}" for r in runs) + f" GiB | {card}")
        return runs

    def profiled(integrator, cfg, unprofiled, ckpt=None):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            mt.render(scene, 0, cfg, checkpoint_dir=ckpt, checkpoint_every_s=1e9)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        by_name = device_ns_by_name(prof)
        dev_s = sum(by_name.values()) / 1e9
        if dev_s <= 0:
            log("batch", f"{integrator}: device share not measured (the profiler recorded no "
                "device time)")
            return
        part = lambda key: 100 * sum(ns for n, ns in by_name.items() if key in n) / 1e9 / dev_s
        log("batch", f"{integrator}, profiled graphed render (2 chunks): wall {wall:.3f} s (profiler "
            f"on), device busy {dev_s:.3f} s ({100 * dev_s / wall:.1f}% of the profiled wall, "
            f"{100 * dev_s / max(unprofiled):.1f}-{100 * dev_s / min(unprofiled):.1f}% of the "
            f"graphed turns' {min(unprofiled):.3f}-{max(unprofiled):.3f} s); traversal "
            f"{part('traverse_kernel'):.1f}%, k-NN kernels {part('knn_'):.1f}% of device time | {card}")
        for name, ns in sorted(by_name.items(), key=lambda kv: -kv[1])[:6]:
            log("batch", f"  {integrator}: device time {ns / 1e6:10.1f} ms  {name[:90]}")

    # ---- the path tracer: 2 chunks of 2^17 paths ----
    cfg = mt.RenderConfig(max_bounces=64, sqrtspp=1, streamed=False)
    rec = LaunchRecorder(tk, at=(0, 2))
    snaps = LoopSnapshots(rec, {"bounce 8": (8, 2)}, keep_launch)
    runs = turns("path_tracer", cfg, [mock.patch.object(tk, "traverse", rec), snaps.patch()],
                 (None, None, None))
    for name, pool, per, wall in captures.made:
        log("batch", f"captured {name}: pool {pool / 2**20:.1f} MiB reserved, launches a replay "
            f"{per}, capture {wall:.3f} s | {card}")
    check([m[0] for m in captures.made] == ["make_bounce_step"] * 2, "batch",
          f"the graphed path-tracer renders captured {[m[0] for m in captures.made]} (want one "
          "bounce step each)")
    held = Held({"bounce 0": rec.seen[0], "bounce 8, replay 8": snaps.seen["bounce 8"]})
    del rec, snaps
    held_to_plain(tk, held, "12 batch chunk 0", card, phase="batch")
    for name, (cb, o, d, out) in sorted(held.seen.items()):
        ms = cuda_time_ms(lambda: tk.traverse(cb, o, d), reps=10, warmup=2)
        bound_ms, by, _ = traversal_bound(tk, cb, o, d, out[4])
        log("batch", f"traversal at the batch size, {name}: {o.shape[0]} rays, {out[4].shape[0]} "
            f"blocks, {ms:.3f} ms a launch, bound {bound_ms:.4f} ms ({by}), {ms / bound_ms:.1f}x "
            f"| {card}")
    del held
    profiled("path_tracer", cfg, [runs[0][2], runs[2][2]])
    del runs

    # ---- the photon mapper on phase 6's maps: 2 chunks of 2^17 paths ----
    pm_cfg = dataclasses.replace(cfg, integrator="photon_mapper")
    maps = sorted(pathlib.Path(pm_dir).glob("photons_*.npz"))
    check(len(maps) == 2, "batch", f"phase 6's maps: {[m.name for m in maps]}")
    k = PHOTON_MAP["k_nearest_photons"]
    made = len(captures.made)
    with contextlib.ExitStack() as stack:
        ckpts = [stack.enter_context(tempfile.TemporaryDirectory(prefix="chip_smoke_batch_"))
                 for _ in range(4)]
        for d in ckpts:          # each render loads the maps, none resumes another's film
            for m in maps:
                shutil.copy(m, d)
        krec = KnnRecorder(kk, at=(2, 3))
        ksnaps = LoopSnapshots(krec, {"caustic, replay 1": (1, 2), "global, replay 1": (1, 3)},
                               keep_knn)
        runs = turns("photon_mapper", pm_cfg, [mock.patch.object(kk, "knn", krec), ksnaps.patch()],
                     ckpts[:3])
        for name, pool, per, wall in captures.made[made:]:
            log("batch", f"captured {name}: pool {pool / 2**20:.1f} MiB reserved, launches a "
                f"replay {per}, capture {wall:.3f} s | {card}")
        check([m[0] for m in captures.made[made:]] == ["_make_eye_step"] * 2, "batch",
              f"the graphed photon renders captured {[m[0] for m in captures.made[made:]]}")
        unmasked = {}
        held = Held(ksnaps.seen)
        del krec, ksnaps
        knn_held_to_plain(kk, held, "12 batch eye pass chunk 0", card, unmasked)
        check(min(unmasked.values()) > 0, "batch", f"a held k-NN call had no query unmasked: {unmasked}")
        for name, (grid, arrays, points, kn, mask, _) in sorted(held.seen.items()):
            ms = cuda_time_ms(lambda: kk.knn(grid, arrays, points, kn, mask=mask), reps=5, warmup=1)
            log("batch", f"k-NN at the batch size, {name}: {points.shape[0]} queries "
                f"({int(mask.sum())} unmasked), k = {k}, {grid.n_photons} photons: {ms:.3f} ms a "
                f"call | {card}")
        del held
        profiled("photon_mapper", pm_cfg, [runs[0][2], runs[2][2]], ckpts[3])
        del runs


def kernel_phase(scene, j, cbvh, card, parent, rng):
    """Phase 3: the traversal kernel against its plain version on five ray sets,
    at both launch widths, then timed per set at the main path's launch shape
    and at LARGE_LAUNCH rays. Returns the per-set timing rows, the largest
    |kernel - plain| of t, u and v, and the first `lanes` rays of each set
    (sorted as timed; "mixed" in lane order)."""
    import numpy as np
    import torch

    import mcrt_tpu_torch as mt
    from mcrt_tpu_torch.camera import camera as cam_mod
    from mcrt_tpu_torch.ops import cluster_bvh
    from mcrt_tpu_torch.ops import traverse_kernel as tk

    dev = cbvh.rec.device
    C, Sp, _ = cbvh.rec.shape
    cam = scene.cameras[0]
    R = CHECK_RAYS
    pix = rng.integers(0, cam.width * cam.height, R)
    cr = cam_mod.generate_rays(cam, torch.as_tensor(pix % cam.width, device=dev),
                               torch.as_tensor(pix // cam.width, device=dev),
                               torch.zeros(R, dtype=torch.int64, device=dev), 0, torch.float32)
    light = np.asarray(j["surfaces"][3]["position"], np.float64)
    sets = {"camera": (cr.origin, cr.direction)}
    for name, toward in (("surface", None), ("shadow", light)):
        o, d = surface_rays(scene, R, rng, toward)
        sets[name] = (torch.as_tensor(o, dtype=torch.float32, device=dev),
                      torch.as_tensor(d, dtype=torch.float32, device=dev))
    park_o = torch.full((256, 3), 2e30, device=dev)
    park_d = torch.full((256, 3), 0.57735026, device=dev)
    sets["parked"] = (park_o, park_d)
    mo, md = cr.origin.clone(), cr.direction.clone()
    mo[::2], md[::2] = 2e30, 0.57735026
    sets["mixed"] = (mo, md)

    bbl, bbh = cbvh.bb_lo, cbvh.bb_hi
    sorted_sets = {}
    max_err = 0.0
    for name, (o, d) in sets.items():
        if name != "mixed":   # mixed keeps lane order: dead lanes inside live blocks
            perm = torch.argsort(cluster_bvh.coherence_key(o, d, bbl, bbh), stable=True)
            o, d = o[perm].contiguous(), d[perm].contiguous()
        sorted_sets[name] = (o, d)
        pt_, pid, pu, pv, pst = tk.traverse_plain(cbvh, o, d)
        torch.cuda.synchronize()
        for width in (1, 2):
            tk.kernel.launches = tk.paired.launches = 0
            kt, kid, ku, kv, kst = tk._launch(cbvh, o, d, stamp=False, width=width)
            torch.cuda.synchronize()
            check(tk.kernel.launches == 1 and tk.paired.launches == (width == 2), "kernel",
                  f"{name}: wrapper did not launch the kernel at width {width}")
            ids_same = bool((kid == pid).all())
            hit = pid >= 0
            t_ok = bool(torch.allclose(kt[hit], pt_[hit], rtol=5e-6, atol=0.0))
            uv_err = float(torch.maximum((ku - pu).abs().max(), (kv - pv).abs().max()))
            st_same = bool((kst == pst).all())
            if bool(hit.any()):
                max_err = max(max_err, float((kt[hit] - pt_[hit]).abs().max()), uv_err)
            bitwise = bool((kt == pt_).all() & (ku == pu).all() & (kv == pv).all())
            log("kernel", f"{name:8s} width {width} rays={o.shape[0]} hits={int(hit.sum())} "
                f"ids_same={ids_same} t_ok={t_ok} max|duv|={uv_err:.3g} stats_same={st_same} "
                f"bitwise={bitwise} candidates={int(kst[:, 0].sum())} "
                f"rounds_sum={int(kst[:, 1].sum())} rounds_max={int(kst[:, 1].max())}")
            check(ids_same and st_same and bitwise, "kernel",
                  f"{name}: kernel at width {width} and plain version differ")
            if name == "parked":
                check(int(kst[:, 1].max()) == 0 and bool((kid == -1).all()), "kernel",
                      "parked block ran rounds or hit")
            if name == "mixed":
                check(bool((kid[::2] == -1).all()), "kernel", "parked lanes of mixed blocks hit")

    # Timing at the main path's launch shape: one call per `lanes` sorted rays.
    lanes = mt.RenderConfig().lanes
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    timing = {}
    kinds = ("camera", "surface", "shadow")
    for name in kinds:
        o, d = sorted_sets[name]
        o, d = o[:lanes].contiguous(), d[:lanes].contiguous()
        ms, old_ms, turns = timed_against_parent(tk, parent, cbvh, o, d)
        single_ms = cuda_time_ms(lambda: tk._launch(cbvh, o, d, stamp=False, width=1), reps=20,
                                 warmup=2)
        plain_ms = cuda_time_ms(lambda: tk.traverse_plain(cbvh, o, d), reps=2, warmup=1)
        tk.paired.launches = 0
        *_, st = tk.traverse(cbvh, o, d)
        width = 1 + tk.paired.launches
        B = st.shape[0]
        cand, rnd = st[:, 0].double(), st[:, 1].double()
        rounds = int(rnd.sum())
        bound_ms, by, tri_visits = traversal_bound(tk, cbvh, o, d, st)
        timing[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by)
        log("kernel", f"time {name:8s} {lanes} rays, {B} blocks x {width} CTAs on {n_sm} SMs "
            f"({100 * min(width * B, n_sm) / n_sm:.1f}% of SMs hold a CTA; {tk.resident_pairs(tk.BLOCK, C, Sp)} "
            f"pairs fit); candidates per block mean {float(cand.mean()):.1f} max "
            f"{int(cand.max())}; rounds {rounds}, per block mean {float(rnd.mean()):.1f} max "
            f"{int(rnd.max())}; {tri_visits:.0f} real triangles visited ({tri_visits / (rounds * Sp):.4f} "
            f"of the slots): kernel {ms:.4f} ms (one CTA a block {single_ms:.4f} ms), plain "
            f"{plain_ms:.3f} ms, bound {bound_ms:.4f} ms ({by}), {ms / bound_ms:.1f}x the bound; "
            f"{turns} | {card}")
        *_, cst, cyc = tk.traverse_cycles(cbvh, o, d)
        check(torch.equal(cst, st), "kernel", "the stamping variant's stats differ")
        who = {"": cyc} if width == 1 else {"leaders ": cyc[0::2], "peers ": cyc[1::2]}
        for part, rows in who.items():
            log("kernel", f"cycles {name:8s} kernel, {part}{cycle_split(tk.CYCLES, rows)} (select, "
                f"load and producer_wait are the producer warp's; staging_wait and forms a "
                f"consumer's) | {card}")
        if parent is not None:
            (*_, pst), pcyc = parent_traverse(parent, cbvh, o, d, cycles=True)
            log("kernel", f"cycles {name:8s} parent's kernel: {cycle_split(tk.CYCLES, pcyc)}; "
                f"rounds {int(pst[:, 1].sum())} | {card}")
        torch.cuda.synchronize()
    # A launch of the batch renders' size: one CTA a block by the rule, as in
    # the parent, which it must not be slower than.
    for name in ("camera", "surface"):
        if name == "camera":
            pix = rng.integers(0, cam.width * cam.height, LARGE_LAUNCH)
            r = cam_mod.generate_rays(cam, torch.as_tensor(pix % cam.width, device=dev),
                                      torch.as_tensor(pix // cam.width, device=dev),
                                      torch.zeros(LARGE_LAUNCH, dtype=torch.int64, device=dev), 0,
                                      torch.float32)
            o, d = r.origin, r.direction
        else:
            o, d = (torch.as_tensor(x, dtype=torch.float32, device=dev)
                    for x in surface_rays(scene, LARGE_LAUNCH, rng))
        perm = torch.argsort(cluster_bvh.coherence_key(o, d, bbl, bbh), stable=True)
        o, d = o[perm].contiguous(), d[perm].contiguous()
        tk.paired.launches = 0
        k = tk.traverse(cbvh, o, d)
        torch.cuda.synchronize()
        check(tk.paired.launches == 0, "kernel", f"{LARGE_LAUNCH} rays ran as pairs")
        if parent is not None:
            check(all(torch.equal(a, b) for a, b in zip(k, parent_traverse(parent, cbvh, o, d)[0])),
                  "kernel", f"{name} at {LARGE_LAUNCH} rays: the kernel and the parent's differ")
        ms, _, turns = timed_against_parent(tk, parent, cbvh, o, d)
        log("kernel", f"time {name:8s} {LARGE_LAUNCH} rays, {k[4].shape[0]} blocks x 1 CTA: kernel "
            f"{ms:.4f} ms; {turns} | {card}")
    return timing, max_err, {name: (o[:lanes].contiguous(), d[:lanes].contiguous())
                             for name, (o, d) in sorted_sets.items()}


def timed_against_parent(tk, parent, cbvh, o, d):
    """(ms, the parent's ms or None, a line) of tk.traverse over these rays,
    in turns with the parent's kernel where it is given: old, new, new, old."""
    run = lambda: tk.traverse(cbvh, o, d)
    if parent is None:
        return cuda_time_ms(run, reps=20, warmup=2), None, "parent's kernel: not given"
    run_old = lambda: parent_traverse(parent, cbvh, o, d)
    t_old = [cuda_time_ms(run_old, reps=20, warmup=2)]
    t_new = [cuda_time_ms(run, reps=20, warmup=2) for _ in range(2)]
    t_old.append(cuda_time_ms(run_old, reps=20, warmup=2))
    ms, old_ms = sum(t_new) / 2, sum(t_old) / 2
    return ms, old_ms, (f"parent's kernel {old_ms:.4f} ms ({t_old[0]:.4f}, {t_old[1]:.4f}; new "
                        f"{t_new[0]:.4f}, {t_new[1]:.4f}), {old_ms / ms:.2f}x faster")


def traversal_row(out):
    """(t, tri_id, u, v, stats) of cluster_bvh.traverse as a short text."""
    st = out[4].tolist()
    return f"hits {int((out[1] >= 0).sum())}, stats {st}"


def timed_call(fn):
    """(output, ms, peak MiB above what was allocated before) of one call of
    `fn` on the card, its wall between two synchronisations (best-first
    reads the host between its kernels)."""
    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return out, ms, (torch.cuda.max_memory_allocated() - base) / 2**20


def methods_phase(scene, cbvh, card, launch_sets, pm_dir):
    """Phase 13: the JAX package's best-first traversal on the card (13a) and
    float64 there (13b). Returns the phase's wall in seconds."""
    import numpy as np
    import torch

    import mcrt_tpu_torch as mt
    from mcrt_tpu_torch.accel import knn_kernel as kk
    from mcrt_tpu_torch.accel import photon_grid as pg
    from mcrt_tpu_torch.camera import film as film_mod
    from mcrt_tpu_torch.camera import image as image_mod
    from mcrt_tpu_torch.integrator import path_tracer as pt
    from mcrt_tpu_torch.ops import cluster_bvh
    from mcrt_tpu_torch.ops import traverse_kernel as tk
    from mcrt_tpu_torch.parallel import sharding

    t_phase = time.perf_counter()
    dev = cbvh.rec.device
    C = cbvh.rec.shape[0]

    # ---- 13a: the two routes of the closest hit, float32 ----
    from mcrt_tpu_torch.ops import intersect as isect
    meta = scene.meta()
    tables64 = scene.tables(np.float64, dev)
    geo64 = isect.build_geo_pack(tables64)
    t0 = time.perf_counter()
    tree = cluster_bvh.upload_cluster_tree(scene.build_flat_bvh(np.float32), scene, np.float32, dev)
    torch.cuda.synchronize()
    tree_mib = sum(x.numel() * x.element_size() for x in tree) / 2**20
    log("methods", f"float32 cluster tree: C={tree.tri_id.shape[0]} clusters of "
        f"S={tree.tri_id.shape[1]}, {tree_mib:.1f} MiB, built in {time.perf_counter() - t0:.2f} s")
    check(tree.tri_id.shape[0] == C and cbvh.tree is None, "methods",
          "the tree's clusters are not the kernel's, or the float32 BVH carries a tree")
    for name in ("camera", "surface", "shadow", "mixed"):
        o, d = launch_sets[name]
        outs = {}
        for method in ("kernel", "bestfirst"):
            tables = cbvh if method == "kernel" else tree
            call = lambda: cluster_bvh.traverse(tables, o, d)
            before = tk.kernel.launches
            out, ms, peak = timed_call(call)
            check((tk.kernel.launches > before) == (method == "kernel"), "methods",
                  f"{name} {method}: the kernel was launched {tk.kernel.launches - before} times")
            ms = min(timed_call(call)[1] for _ in range(2))
            outs[method] = out
            log("methods", f"13a {name:8s} {o.shape[0]} rays {method:9s}: {ms:10.3f} ms a call, "
                f"{traversal_row(out)}, peak {peak:.1f} MiB above the inputs | {card}")
        kid = outs["kernel"][1]
        # Each route's t, u, v against the float64 recompute of its winning
        # triangle (refine_tri_hit over float64 tables): their float32 forms
        # lose precision at grazing incidence and on short hits, the kernel's
        # global-frame forms most (phase 3 holds it to its plain version).
        o64, d64 = o.double(), d.double()
        scale = o64.norm(dim=1)
        for method in ("kernel", "bestfirst"):
            t, tid, u, v, _ = outs[method]
            ex_t, ex_uv = isect.refine_tri_hit(tables64, meta, o64, d64, t.double(), tid,
                                               torch.stack([u, v], 1).double(), geo=geo64)
            hit = tid >= 0
            cos = (tables64.tri_n[tid.clamp(min=0).long()] * d64).sum(1).abs()[hit]
            err_t = ((t.double() - ex_t).abs() / (ex_t.abs() + scale))[hit]
            err_uv = torch.maximum((u.double() - ex_uv[:, 0]).abs(),
                                   (v.double() - ex_uv[:, 1]).abs())[hit]
            same = float((tid == kid).double().mean())
            at = lambda e: f"{float(e.max()):.3g} (|cos| there {float(cos[int(e.argmax())]):.3g})" \
                if e.numel() else "none"
            log("methods", f"13a {name:8s} {method:9s}: ids identical to the kernel's on "
                f"{100 * same:.3f}% of rays ({int((tid != kid).sum())} differ); against the float64 "
                f"recompute, |dt| / (t + |o|) max {at(err_t)}, |du|, |dv| max {at(err_uv)}")
            if method != "kernel":
                check(same >= 0.999 and bool((err_t <= 5e-6).all()) and bool((err_uv <= 5e-3).all()),
                      "methods", f"{name}: {method} disagrees with the kernel or the float64 recompute")
        if name == "mixed":
            for method, out in outs.items():
                check(bool((out[1][::2] == -1).all()), "methods", f"{method}: parked rays hit")
    del tree, outs
    t13a = time.perf_counter() - t_phase
    log("methods", f"13a took {t13a:.1f} s | {card}")

    # ---- 13b: float64 on the card ----
    # 1. render() at 512x512, 1 spp, 64 bounces in float64 (best-first, every
    # step eager) against the float32 kernel render of the same settings.
    t1 = time.perf_counter()
    cfg32 = mt.RenderConfig(sqrtspp=1, max_bounces=64)
    cfg64 = mt.RenderConfig(sqrtspp=1, max_bounces=64, dtype="float64")
    st32, st64 = {}, {}
    img32 = mt.render(scene, 0, cfg32, stats=st32)
    t0 = time.perf_counter()
    cb64 = scene.build_cluster_bvh(np.float64, dev)
    torch.cuda.synchronize()
    check(cb64.tree is not None, "methods", "the float64 BVH on the card carries no ClusterTree")
    t_tables = time.perf_counter() - t0
    tk.kernel.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    img64 = mt.render(scene, 0, cfg64, stats=st64)
    torch.cuda.synchronize()
    wall64 = time.perf_counter() - t0
    peak64 = torch.cuda.max_memory_allocated() / 2**30
    fin = lambda x: np.clip(image_mod.finalize(x, scene.cameras[0].image), 0.0, 1.0)
    diff = np.abs(fin(img64) - fin(img32))
    per_channel = np.abs(fin(img64).mean(axis=(0, 1)) - fin(img32).mean(axis=(0, 1)))
    p95 = float(np.percentile(diff, 95))
    log("methods", f"13b float64 render 512x512 1 spp 64 bounces ({scene.n_tris} triangles): wall "
        f"{wall64:.3f} s ({st64['bounce_steps']} eager bounce steps, graphed {st64['graphed']}, "
        f"kernel launches {tk.kernel.launches}), peak {peak64:.3f} GiB, rays {int(st64['rays'])}; the "
        f"float64 tables and tree built beforehand in {t_tables:.2f} s; the float32 kernel render "
        f"graphed {st32['graphed']}, rays {int(st32['rays'])}; float64 against float32: per-channel "
        f"mean diff {per_channel.max():.3g}, p95 {p95:.3g}, mean {diff.mean():.3g} | {card}")
    check(st64["graphed"] is False and st32["graphed"] is True and tk.kernel.launches == 0, "methods",
          "the float64 render captured a step or launched the kernel, or the float32 one did not capture")
    check(bool(np.isfinite(img64).all()) and img64.shape == img32.shape, "methods", "bad float64 image")
    check(bool(np.all(per_channel < 0.02)) and p95 < 0.25 and diff.mean() < 0.05, "methods",
          "the float64 render and the float32 kernel render disagree")
    del img32, img64

    # 2. The 64x64 camera at 1 spp, 8 bounces in float64 on the card and on the
    # CPU (whose default route is the kernel's plain version): the images, and
    # one train step's loss and gradients.
    t0 = time.perf_counter()
    scene.cameras.append(dataclasses.replace(scene.cameras[0], width=F64_CHECK_WIDTH,
                                             height=F64_CHECK_WIDTH))
    ci = len(scene.cameras) - 1
    cam = scene.cameras[ci]
    cfg_s = mt.RenderConfig(sqrtspp=1, max_bounces=CHECK_GRAD_BOUNCES, dtype="float64")
    walls, imgs, out = {}, {}, {}
    lin = np.arange(cam.width * cam.height)
    target = np.random.default_rng(14).random((cam.height, cam.width, 3)) * 0.5
    for where in ("cuda", "cpu"):
        on = dev if where == "cuda" else torch.device("cpu")
        st = {}
        t1 = time.perf_counter()
        imgs[where] = mt.render(scene, ci, cfg_s, device=on, stats=st)
        walls[where] = time.perf_counter() - t1
        check(st["graphed"] is False, "methods", f"the 64x64 float64 render on {where} captured a step")
        tables = scene.tables(np.float64, on)
        cb = scene.build_cluster_bvh(np.float64, on)
        step = sharding.train_step(scene.meta(), pt.PTConfig(max_bounces=CHECK_GRAD_BOUNCES), cam,
                                   film_mod.FilmConfig.from_json(cam.width, cam.height, cam.film),
                                   torch.float64, with_bvh=True, device=on)
        params = {k: getattr(tables, k) for k in sharding.DEFAULT_TRAIN_PARAMS}
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        ix = torch.as_tensor(lin, device=on)
        loss, grads = step(tables, cb, params, ix % cam.width, ix // cam.width, torch.zeros_like(ix),
                           target)
        out[where] = (float(loss), {k: g.cpu() for k, g in grads.items()}, len(step.graphs),
                      time.perf_counter() - t1, torch.cuda.max_memory_allocated() / 2**30)
    bad = np.abs(imgs["cuda"] - imgs["cpu"]) > 1e-9 * np.abs(imgs["cpu"]) + 1e-12
    apart = {k: float((out["cuda"][1][k] - g).abs().max() / max(float(g.abs().max()), 1e-300))
             for k, g in out["cpu"][1].items()}
    rel = np.abs(imgs["cuda"] - imgs["cpu"]) / np.maximum(np.abs(imgs["cpu"]), 1e-300)
    log("methods", f"13b {cam.width}x{cam.height} 1 spp {CHECK_GRAD_BOUNCES} bounces float64, card "
        f"against CPU: render walls {walls['cuda']:.3f} and {walls['cpu']:.3f} s, {int(bad.sum())} "
        f"elements outside rtol 1e-9 atol 1e-12, largest relative |d| {float(rel.max()):.3g}; "
        f"train step walls {out['cuda'][3]:.3f} and {out['cpu'][3]:.3f} s, losses "
        f"{out['cuda'][0]:.12g} and {out['cpu'][0]:.12g}, gradients apart by at most "
        f"{max(apart.values()):.3g} of each table's largest |g| ({apart}), captured trips on the "
        f"card {out['cuda'][2]}, the card's peak {out['cuda'][4]:.3f} GiB | {card}")
    check(int(bad.sum()) == 0, "methods", "the float64 renders on the card and the CPU disagree")
    check(abs(out["cuda"][0] - out["cpu"][0]) <= 1e-9 * abs(out["cpu"][0]) and out["cuda"][2] == 0
          and max(apart.values()) <= 1e-9 and float(out["cpu"][1]["mat_reflectance"].abs().max()) > 0,
          "methods", "the float64 train step on the card and on the CPU disagree")
    del imgs, out
    log("methods", f"13b.2 took {time.perf_counter() - t0:.1f} s | {card}")

    # 3. A float64 exact k-NN on phase 6's maps: capped search plus brute force
    # on the card (no kernel), against the CPU.
    t0 = time.perf_counter()
    k = PHOTON_MAP["k_nearest_photons"]
    q, _ = surface_rays(scene, KNN64_QUERIES, np.random.default_rng(13))
    for name in ("caustic", "global"):
        (path,) = pathlib.Path(pm_dir).glob(f"photons_{name}_*.npz")
        res = {}
        for where in ("cuda", "cpu"):
            on = dev if where == "cuda" else torch.device("cpu")
            g = pg.load_photon_grid(path, on)
            a = g.arrays
            g = dataclasses.replace(g, arrays=a._replace(pos=a.pos.double(), direction=a.direction.double(),
                                                         flux=a.flux.double()))
            for kern in kk.KERNELS:
                kern.launches = 0
            stats = {}
            t1 = time.perf_counter()
            d2, idx, valid, _ = pg.knn(g, g.arrays, torch.as_tensor(q, device=on), k, exact=True,
                                       stats=stats)
            if where == "cuda":
                torch.cuda.synchronize()
            res[where] = (d2.cpu(), idx.cpu(), valid.cpu(), time.perf_counter() - t1,
                          int(stats["knn_flagged"]), sum(kern.launches for kern in kk.KERNELS))
        same = torch.equal(res["cuda"][1], res["cpu"][1]) and torch.equal(res["cuda"][2], res["cpu"][2])
        d2_ok = bool(torch.allclose(res["cuda"][0], res["cpu"][0], rtol=1e-12, atol=0.0))
        log("methods", f"13b float64 exact k-NN, {name} map ({g.n_photons} photons), {KNN64_QUERIES} "
            f"queries, k = {k}: ids identical {same}, d2 within rtol 1e-12 {d2_ok}; flagged for the "
            f"brute force {res['cuda'][4]} (CPU {res['cpu'][4]}); k-NN kernel launches "
            f"{res['cuda'][5]}; walls {res['cuda'][3]:.3f} s on the card, {res['cpu'][3]:.3f} s on the "
            f"CPU | {card}")
        check(same and d2_ok and res["cuda"][5] == 0, "methods",
              f"{name}: the float64 exact k-NN on the card is not the CPU's, or ran a kernel")
    log("methods", f"13b.3 took {time.perf_counter() - t0:.1f} s | {card}")
    return time.perf_counter() - t_phase


def main() -> int:
    t_start = time.perf_counter()
    # ---- 1. device ----
    import torch

    if not torch.cuda.is_available():
        fail("device", "torch.cuda.is_available() is false: this run needs a CUDA card")
    card = gpu_line()
    kind = torch.cuda.get_device_name(0)
    log("device", f"{card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    import numpy as np

    import mcrt_tpu_torch as mt
    from mcrt_tpu_torch.accel import knn_kernel as kk
    from mcrt_tpu_torch.camera import image as image_mod
    from mcrt_tpu_torch.materials import gather_bwd as gb
    from mcrt_tpu_torch.ops import traverse_kernel as tk
    from mcrt_tpu_torch.scene.synthetic import height_field_scene

    # ---- 2. build: one nvcc per source, started together ----
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        futs = [pool.submit(m.build) for m in (tk, kk, gb)]
        parent = pool.submit(load_parent_kernel, OLD_TRAVERSE)
        parent_knn_lib = pool.submit(load_parent_knn, OLD_KNN)
        for fut in futs:
            fut.result()
        parent, parent_knn_lib = parent.result(), parent_knn_lib.result()
    log("build", f"nvcc sm_90a builds + loads {time.perf_counter() - t0:.2f} s; parent's "
        f"traverse.cu {'built' if parent else 'not given'}, parent's knn.cu "
        f"{'built' if parent_knn_lib else 'not given'}")
    for name, log_text in (("traverse.cu", tk.kernel.build_log), ("knn.cu", kk.library.build_log),
                           ("gather_bwd.cu", gb.kernel.build_log)):
        for line in log_text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line or "entry" in line:
                log("build", f"{name}: {line.strip()}")

    # ---- scene (shared by phases 3-5) ----
    t0 = time.perf_counter()
    # One scene for both integrators: the path tracer ignores the photon_map block.
    j = height_field_scene(GRID_N, WIDTH, SQRTSPP, photon_map=PHOTON_MAP)
    scene = mt.Scene(j)
    t_parse = time.perf_counter() - t0
    t0 = time.perf_counter()
    cbvh = scene.build_cluster_bvh(np.float32, dev)
    torch.cuda.synchronize()
    t_bvh = time.perf_counter() - t0
    C, Sp, _ = cbvh.rec.shape
    log("scene", f"{scene.n_tris} triangles, {scene.n_sphs} spheres; parse {t_parse:.2f} s, "
        f"cluster BVH {t_bvh:.2f} s: C={C} clusters, Sp={Sp}")

    # ---- 3. kernel against plain ----
    rng = np.random.default_rng(1234)
    cam = scene.cameras[0]
    timing, max_err, launch_sets = kernel_phase(scene, j, cbvh, card, parent, rng)

    # ---- 4. main path at full size ----
    cfg = mt.RenderConfig(max_bounces=64)
    stats = {}
    tk.kernel.launches = 0
    for kern in kk.KERNELS:
        kern.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hdr = mt.render(scene, 0, cfg, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = tk.kernel.launches
    log("render", f"launches: traversal {launches}, k-NN {[kern.launches for kern in kk.KERNELS]}")
    spp = SQRTSPP ** 2
    cam_rays = cam.width * cam.height * spp
    rays_traced = int(stats["rays"])
    log("render", f"{cam.width}x{cam.height} {spp} spp, {scene.n_tris} triangles, graphed bounce step: "
        f"wall {wall:.3f} s, {cam_rays / wall / 1e6:.4f} M camera rays/s, {rays_traced / wall / 1e6:.4f} M "
        f"rays/s traced (primary + shadow), kernel launches {launches}, bounce steps (host syncs) "
        f"{stats['bounce_steps']}, chunks {stats['chunks']} | {card}")
    check(launches > 0, "render", "the traversal kernel was not launched on the main path")
    check(hdr.shape == (cam.height, cam.width, 3), "render", f"bad image shape {hdr.shape}")
    check(bool(np.isfinite(hdr).all()) and float(hdr.min()) >= 0.0, "render", "non-finite or negative")
    check(0.01 < float(hdr.mean()) < 100.0, "render", f"trivial image mean {hdr.mean()}")
    log("render", f"image mean {hdr.mean():.6f} min {hdr.min():.6f} max {hdr.max():.4f}")
    # The same render with the step called eagerly, then graphed again: the
    # launches, rays and bounce steps must be the eager loop's, the image
    # within the bars (the scatter into the sums is atomic).
    stats_e = {}
    tk.kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hdr_e = eager_render(scene, 0, cfg, stats_e)
    wall_e = time.perf_counter() - t0
    launches_e = tk.kernel.launches
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mt.render(scene, 0, cfg)
    torch.cuda.synchronize()
    wall_g2 = time.perf_counter() - t0
    bad, worst = images_apart(hdr, hdr_e)
    log("render", f"eager loop, same render: wall {wall_e:.3f} s, kernel launches {launches_e}, bounce "
        f"steps {stats_e['bounce_steps']}, rays {int(stats_e['rays'])}; graphed against eager: {bad} "
        f"elements outside rtol {IMG_RTOL} atol {IMG_ATOL}, largest |d| {worst:.3g}; walls in turns "
        f"(graphed, eager, graphed) {wall:.3f}, {wall_e:.3f}, {wall_g2:.3f} s | {card}")
    check(launches == launches_e == 2 * stats["bounce_steps"], "render",
          f"graphed launches {launches}, eager {launches_e}, bounce steps {stats['bounce_steps']}")
    check(stats["bounce_steps"] == stats_e["bounce_steps"] and rays_traced == int(stats_e["rays"]),
          "render", "the graphed render's bounce steps or rays are not the eager loop's")
    check(bad == 0, "render", "the graphed and eager renders disagree")
    del hdr_e
    if parent is not None:   # the same render through the parent's kernel, in turns
        walls = {"parent's": [], "this": [wall]}
        old = lambda cb, o, d: parent_traverse(parent, cb, o, d)[0]
        for who in ("parent's", "this", "parent's"):
            with mock.patch.object(tk, "traverse", old if who == "parent's" else tk.traverse):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                mt.render(scene, 0, cfg)
                torch.cuda.synchronize()
                walls[who].append(time.perf_counter() - t1)
        log("render", "walls in turns (this, parent's, this, parent's): " + "; ".join(
            f"{who} kernel {', '.join(f'{w:.3f}' for w in ws)} s" for who, ws in walls.items())
            + f" | {card}")

    # Device-busy share and the kernel's share of device time, from profiled
    # 1-spp renders of the same scene, graphed and eager. The kernel events
    # counted beside the launches show whether the profiler sees inside replays.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg1 = mt.RenderConfig(max_bounces=64, sqrtspp=1)
    for how, run in (("graphed", lambda st: mt.render(scene, 0, cfg1, stats=st)),
                     ("eager", lambda st: eager_render(scene, 0, cfg1, st))):
        st1 = {}
        tk.kernel.launches = 0
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            run(st1)
            torch.cuda.synchronize()
            wall1 = time.perf_counter() - t1
        dev_events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        dev_time = lambda e: getattr(e, "self_device_time_total", 0.0)
        dev_us = sum(dev_time(e) for e in dev_events)
        kern = [e for e in dev_events if "traverse_kernel" in e.key]
        kern_us = sum(dev_time(e) for e in kern)
        share = "not measured (the profiler recorded no device time)"
        if dev_us > 0:
            share = (f"wall {wall1:.3f} s (profiler on), device busy {dev_us / 1e6:.3f} s "
                     f"({100 * dev_us / 1e6 / wall1:.1f}% of wall), traversal kernel {kern_us / 1e6:.3f} s "
                     f"= {100 * kern_us / dev_us:.1f}% of device time, {sum(e.count for e in kern)} "
                     f"traversal kernel events for {tk.kernel.launches} launches counted, "
                     f"{st1['bounce_steps']} bounce steps")
            for e in sorted(dev_events, key=lambda e: -dev_time(e))[:6]:
                log("render", f"  {how}: device time {dev_time(e) / 1e3:10.1f} ms x{e.count:7d}  {e.key[:80]}")
        log("render", f"profiled 1-spp render, {how}: {share} | {card}")
        del prof, dev_events, kern

    # ---- 4b. graphed against eager at 64x64, 4 spp; a replayed launch ----
    # The same scene (and BVH) through a second, 64x64 camera (also phase 5's).
    scene.cameras.append(dataclasses.replace(cam, width=64, height=64))
    cfg_s = mt.RenderConfig(sqrtspp=2)
    stats_g, stats_e = {}, {}
    img_k, wall_k, launches_k, _ = run_counted(tk, lambda: mt.render(scene, 1, cfg_s, stats=stats_g))
    img_e, wall_e, launches_e, _ = run_counted(tk, lambda: eager_render(scene, 1, cfg_s, stats_e))
    bad, worst = images_apart(img_k, img_e)
    log("render", f"4b 64x64 4 spp graphed vs eager: {bad} elements outside rtol {IMG_RTOL} atol "
        f"{IMG_ATOL}, largest |d| {worst:.3g}; rays {int(stats_g['rays'])} and {int(stats_e['rays'])}, "
        f"bounce steps {stats_g['bounce_steps']} and {stats_e['bounce_steps']}, launches {launches_k} and "
        f"{launches_e}, walls {wall_k:.3f} and {wall_e:.3f} s | {card}")
    check(bad == 0, "render", "4b: the graphed and eager renders disagree")
    check(int(stats_g["rays"]) == int(stats_e["rays"]) and stats_g["bounce_steps"] == stats_e["bounce_steps"],
          "render", "4b: the graphed render's rays or bounce steps are not the eager loop's")
    check(launches_k == launches_e == 2 * stats_g["bounce_steps"], "render",
          f"4b: launches {launches_k} graphed, {launches_e} eager, for {stats_g['bounce_steps']} bounce steps")
    # One chunk driven bounce by bounce: the captured primary launch (launch 2)
    # after replay 1 (bounce 1) and after replay 3 (bounce 3, more dead lanes
    # parked among the rays), each held to traverse_plain on the graph's
    # static inputs.
    tk.kernel.launches = tk.kernel.captured = 0
    tr, rec = graphed_trace(scene, 1, 2)
    try:
        check((tk.kernel.launches, tk.kernel.captured) == (4, 2), "render",
              f"4b: after bounce 1, {tk.kernel.launches} launches counted and {tk.kernel.captured} "
              "captured (want 2 eager + 2 replayed, and 2)")
        log("render", f"4b graph of one bounce step at {tr.regen.lanes} lanes: pool "
            f"{tr.graph.pool_bytes / 2**20:.1f} MiB reserved, {tr.graph.per_replay[0][1]} traversal "
            f"launches a replay | {card}")
        held_to_plain(tk, rec, "4b replay 1 (bounce 1)", card, phase="render")
        tr.advance()
        tr.advance()
        torch.cuda.synchronize()
        held_to_plain(tk, rec, "4b replay 3 (bounce 3)", card, phase="render")
    finally:
        tr.close()
        del tr, rec

    # ---- 5. kernel render against plain render ----
    # The plain traversal syncs the host, so it cannot be captured: its render
    # runs the eager loop; the kernel's is 4b's graphed render.
    with mock.patch.object(tk, "traverse", tk.traverse_plain):
        img_p = eager_render(scene, 1, cfg_s, {})
    fin = lambda x: np.clip(image_mod.finalize(x, scene.cameras[1].image), 0.0, 1.0)
    a, b = fin(img_k), fin(img_p)
    diff = np.abs(a - b)
    per_channel = np.abs(a.mean(axis=(0, 1)) - b.mean(axis=(0, 1)))
    p95 = float(np.percentile(diff, 95))
    log("compare", f"64x64 4 spp kernel (graphed) vs plain (eager): per-channel mean diff "
        f"{per_channel.max():.3g}, p95 {p95:.3g}, mean {diff.mean():.3g}, max {diff.max():.3g}, hdr "
        f"identical {bool((img_k == img_p).all())}")
    check(bool(np.all(per_channel < 0.02)) and p95 < 0.25 and diff.mean() < 0.05, "compare",
          "kernel render and plain render disagree")

    # ---- 6-8. the photon mapper ----
    pm_tmp = tempfile.TemporaryDirectory(prefix="chip_smoke_photons_")   # phases 6, 7, 12 and 13
    pm_dir = pm_tmp.name
    pm_trav, pm_launches, pm_maps = photon_phase(scene, card, pm_dir)
    photon_replay_phase(scene, pm_maps, card)
    photon_wide_k_phase(scene, pm_maps, card)
    del pm_maps
    knn_rows = knn_phase(scene, cam, card, rng, pm_dir, parent_knn_lib)
    golden_phase(card)

    # ---- 9. the differentiable path ----
    t9 = time.perf_counter()
    train_launches, gather_row, step0 = grad_phase(scene, cbvh, card)
    log("done", f"phase 9 took {time.perf_counter() - t9:.1f} s, the whole run "
        f"{time.perf_counter() - t_start:.1f} s | {card}")

    # ---- 10. the multi-device steps ----
    t10 = time.perf_counter()
    multi_launches, multi_gathers = multi_phase(scene, cbvh, card, step0)
    log("done", f"phase 10 took {time.perf_counter() - t10:.1f} s, the whole run "
        f"{time.perf_counter() - t_start:.1f} s | {card}")

    # ---- 11. the bench, the intersect in lane order, the traversal statistics ----
    t11 = time.perf_counter()
    bench_launches = bench_phase(scene, cbvh, card, rays_traced / cam_rays)
    log("done", f"phase 11 took {time.perf_counter() - t11:.1f} s, the whole run "
        f"{time.perf_counter() - t_start:.1f} s | {card}")

    # ---- 12. the batch chunks of both integrators ----
    t12 = time.perf_counter()
    batch_phase(scene, cbvh, card, pm_dir)
    log("done", f"phase 12 took {time.perf_counter() - t12:.1f} s, the whole run "
        f"{time.perf_counter() - t_start:.1f} s | {card}")

    # ---- 13. the JAX package's best-first traversal, and float64 on the card ----
    t13 = methods_phase(scene, cbvh, card, launch_sets, pm_dir)
    pm_tmp.cleanup()
    log("done", f"phase 13 took {t13:.1f} s, the whole run {time.perf_counter() - t_start:.1f} s "
        f"| {card}")

    mean = lambda key: sum(r[key] for r in timing.values()) / len(timing)
    kernels = [{
        "name": "cluster_bvh_traverse",
        "route": "cuda",
        "source": "mcrt_tpu_torch/csrc/traverse.cu",
        "replaces": "mcrt_tpu/ops/traverse_kernel.py:53",
        "launches": launches,   # the path tracer's main path (phase 4)
        "photon_launches": pm_trav,   # the photon mapper's main path (phase 6)
        "train_launches": train_launches,   # phase 9a's train steps, forward and recompute
        "sharded_train_launches": multi_launches,   # phase 10a's sharded train step
        "bench_launches": bench_launches,   # python -m mcrt_tpu_torch.bench, both processes (11a)
        "max_abs_err": max_err,
        "ms": mean("ms"),
        "plain_ms": mean("plain_ms"),
        "bound_ms": mean("bound_ms"),
        "bound_by": timing["camera"]["bound_by"],
        "library_ms": None,
    }] + [{
        "name": name,
        "route": "cuda",
        "source": "mcrt_tpu_torch/csrc/knn.cu",
        "replaces": "mcrt_tpu/accel/knn_kernel.py:59",
        "launches": pm_launches[name],   # the photon mapper's main path (phase 6)
        **knn_rows[name],
    } for name in ("knn_ring1", "knn_rings", "knn_scan")] + [{
        **gather_row,                 # its launches: phase 9a's train steps' calls
        "sharded_train_launches": multi_gathers,   # phase 10a's sharded train step
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["bwd"]:      # phase 11a's child, started by bench_phase
        sys.exit(bwd_turns_main(int(sys.argv[2])))
    if sys.argv[1:2] == ["rank"]:     # one rank of phase 10b, started by multi_phase
        sys.exit(rank_main(int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]),
                           pathlib.Path(sys.argv[5])))
    sys.exit(main())
