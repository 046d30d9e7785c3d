"""Benchmark of the port on the card: path-tracing throughput, as one JSON line.

    python -m mcrt_tpu_torch.bench                  # on the CUDA card
    python -m mcrt_tpu_torch.bench --bwd-only 19    # the forward+backward point alone

The counterpart of the repository's root bench.py, with its function names and
JSON keys. The scene is built in memory: the height field of scene/synthetic.py
at n = 708 (1,002,528 triangles, binary_sah BVH), rendered at 512x512. Both
points run the port's main path and its traversal kernel (csrc/traverse.cu).

The line's keys:
  metric, value, unit   rays traced per second (primary + shadow, counted on
                        the device) by the forward streamed path tracer at
                        16 spp, 64 bounces: chunks of 2^18 paths through 2^14
                        lanes, per-pixel sums into a box-filtered film
  vs_baseline           null: no reference renderer or scene is at hand
  fwd_bwd_rays_per_s_1024spp, fwd_bwd_chunk
                        rays traced per second forward and backward: gradients
                        of mean(pixel mean^2) with respect to four material
                        tables, trace_streamed(fixed_trips=64) with remat over
                        chunks of 2^19 paths at 1024 spp (a child process)
  diag_walk_steps_32k, diag_leaf_rounds_32k
                        the traversal kernel's stats over a 2^15-path trace,
                        summed over the bounces of its primary intersects:
                        [candidates summed over blocks, most rounds of a
                        block]. Not walk steps: the names are bench.py's.
  card                  the card's name and power limit, as nvidia-smi gives them

Each point also writes a line `bench: {...}` to stderr with its walls, its
traversal launches and the kernel library it loaded.

Two deviations from bench.py. The backward chunks and the diagnostic trace
start at the image's middle row: on the height field the top rows see only
sky, where every path ends at its first ray. And there is no fall-through over
backward chunk sizes: bench.py's guarded a TPU kernel fault, and on the card
it would hide a failure. A failed point makes the bench exit non-zero.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

from .camera import film as film_mod
from .integrator import path_tracer as pt
from .ops import cluster_bvh
from .ops import traverse_kernel as tk
from .render import _add_pixel_sums, _camera_rays
from .scene.loader import Scene
from .scene.synthetic import height_field_scene
from .utils.device import resolve_device

GRID_N = 708
SIZE = 512
SQRTSPP = 4                 # 16 spp
CHUNK_LG = 18               # forward: paths per chunk
LANES = 1 << 14             # forward: lanes (RenderConfig.lanes)
DIAG_LG = 15                # paths of the diagnostic trace
BWD_SPP = 1024
BWD_CHUNK_LG = 19           # backward: paths per chunk
BWD_TRIPS = 64
BWD_REPS = 4
PARAM_KEYS = ("mat_reflectance", "mat_specular_roughness", "mat_ior", "mat_transparency")
METRIC = f"pt_rays_per_s_heightfield{GRID_N}_{SIZE}_{SQRTSPP * SQRTSPP}spp"
_ROOT = pathlib.Path(__file__).resolve().parents[1]


def bench_scene(n: int = GRID_N, size: int = SIZE, sqrtspp: int = SQRTSPP) -> Scene:
    """The bench's scene: a 2 n^2-triangle height field, one camera at size^2."""
    return Scene(height_field_scene(n, size, sqrtspp))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _report(point: str, **fields):
    """One `bench: {...}` line on stderr: what the point ran, beside the JSON
    line, with the traversal kernel's launches since the process started and
    the library it loaded."""
    lib = tk.kernel.lib
    fields["process_launches"] = tk.kernel.launches
    fields["kernel_library"] = None if lib is None else lib._name
    print("bench: " + json.dumps({"point": point, **fields}), file=sys.stderr, flush=True)


def _middle_row(cam, spp: int, n: int) -> int:
    """Global index of the first path of the image's middle row, moved back so
    that n paths fit."""
    total = cam.width * cam.height * spp
    return max(0, min((cam.height // 2) * cam.width * spp, total - n))


def bench_ours(scene: Scene, device=None, chunk_lg: int = CHUNK_LG, lanes: int = LANES,
               diag_lg: int = DIAG_LG, seed: int = 0) -> dict:
    """Forward rays/s of the streamed path tracer over the scene's first camera
    at its spp: one warm-up chunk, then every whole chunk of the image timed,
    with the ray counts kept on the device and one synchronisation at the end
    inside the timer. One StreamedTrace runs every chunk, as in render(): on
    the card the warm-up captures its bounce step and the timed chunks replay
    it. Then a 2^diag_lg-path trace from the middle row, whose stats give the
    traversal counters: one batch through path_tracer.trace, whose BatchTrace
    on the card captures its bounce step at the second bounce and replays it
    after; the `bench:` line gives its bounce steps, launches and pool."""
    device = resolve_device(device)
    cam = scene.cameras[0]
    spp = cam.sqrtspp ** 2
    tables = scene.tables(np.float32, device)
    meta = scene.meta()
    cbvh = scene.build_cluster_bvh(np.float32, device)
    intersect_fn = cluster_bvh.make_intersect_fn(tables, meta, cbvh)
    if not film_mod.FilmConfig.from_json(cam.width, cam.height, cam.film).is_pixel_box:
        raise ValueError("the bench accumulates per-pixel sums: the camera's film must be a box")
    cfg = pt.PTConfig(global_seed=seed)
    total = cam.width * cam.height * spp
    chunk = min(1 << chunk_lg, total)
    stats = {}

    trace = pt.StreamedTrace(tables, meta, cfg, cam, spp, chunk, min(lanes, chunk),
                             intersect_fn=intersect_fn, pixel_sums=True)

    def run(start, film):
        sums, rays = trace(start, stats)
        _add_pixel_sums(film, sums, spp, start)
        return rays

    film = torch.zeros((cam.height, cam.width, 4), dtype=torch.float32, device=device)
    try:
        run(0, film)                                # warm-up
        _sync(device)
        film.zero_()
        stats.clear()
        launches = tk.kernel.launches
        ray_counts = []
        done = 0
        t0 = time.perf_counter()
        while done + chunk <= total:
            ray_counts.append(run(done, film))      # stays on the device
            done += chunk
        _sync(device)
        dt = time.perf_counter() - t0
        launches = tk.kernel.launches - launches
        pool_bytes = None if trace.graph is None else trace.graph.pool_bytes
    finally:
        trace.close()
    total_rays = int(torch.stack(ray_counts).sum())
    image_mean = float(film[..., :3].sum() / (3 * film[..., 3].sum()).clamp(min=1))
    if not np.isfinite(image_mean) or image_mean <= 0.0:
        raise RuntimeError(f"bench_ours: bad image (mean radiance {image_mean})")

    n_diag = min(1 << diag_lg, total)
    first = _middle_row(cam, spp, n_diag)
    rays = _camera_rays(cam, spp, first, n_diag, seed, torch.float32, device)
    diag_launches = tk.kernel.launches
    diag_runs = {}
    try:
        _, st = pt.trace(tables, meta, cfg, rays.origin, rays.direction, rays.pixel_index,
                         rays.sample_index, intersect_fn=intersect_fn, return_stats=True,
                         graphs=diag_runs)
        candidates, rounds = (int(x) for x in st["traversal_steps"])
        diag_pool = sum(r.graph.pool_bytes for r in diag_runs.values() if r.graph is not None)
    finally:
        for r in diag_runs.values():
            r.close()
    _report("forward", device=str(device), chunks=len(ray_counts), chunk=chunk,
            lanes=min(lanes, chunk), time_s=dt, rays=total_rays, bounce_steps=stats["bounce_steps"],
            launches=launches, graph_pool_bytes=pool_bytes, image_mean=image_mean,
            diag_paths=n_diag, diag_first_path=first, diag_bounce_steps=st["bounce_steps"], diag_launches=tk.kernel.launches - diag_launches,
            diag_graph_pool_bytes=diag_pool)
    return {
        "paths": done,
        "rays": total_rays,
        "time_s": dt,
        "rays_per_s": total_rays / dt,
        "paths_per_s": done / dt,
        "rays_per_path": total_rays / max(done, 1),
        "walk_steps": candidates,       # from the diagnostic trace
        "leaf_rounds": rounds,
    }


def bwd_lanes(n_paths: int) -> int:
    """The forward+backward point's lanes for a chunk of n_paths paths."""
    return max(1024, n_paths // 16)


def bwd_chunk(scene: Scene, device=None, chunk_lg: int = BWD_CHUNK_LG, trips: int = BWD_TRIPS,
              seed: int = 0):
    """The forward+backward point's unit of work. Returns (chunk, params):
    chunk(i, remat=True) traces the i-th chunk of 2^chunk_lg paths at 1024 spp
    (side by side from the image's middle row) through
    trace_streamed(fixed_trips=trips) over bwd_lanes(2^chunk_lg) lanes, and
    returns (mean(pixel mean^2), rays traced); params are the four material
    tables as leaves that require grad. On the card the first chunk captures
    the trip's graphs (kept in chunk.graphs) and the later chunks replay them."""
    device = resolve_device(device)
    cam = scene.cameras[0]
    n_paths = 1 << chunk_lg
    if n_paths % BWD_SPP:
        raise ValueError(f"a chunk of {n_paths} paths is not whole pixels at {BWD_SPP} spp")
    tables = scene.tables(np.float32, device)
    meta = scene.meta()
    cbvh = scene.build_cluster_bvh(np.float32, device)
    cfg = pt.PTConfig(global_seed=seed)
    params = {k: getattr(tables, k).detach().clone().requires_grad_() for k in PARAM_KEYS}
    total = cam.width * cam.height * BWD_SPP
    first = _middle_row(cam, BWD_SPP, n_paths)
    graphs = {}

    def chunk(i: int, remat: bool = True):
        start = (first + i * n_paths) % (total - n_paths) if total > n_paths else 0
        t = tables._replace(**params)
        ifn = cluster_bvh.make_intersect_fn(t, meta, cbvh)
        out, rays = pt.trace_streamed(t, meta, cfg, cam, BWD_SPP, start, n_paths,
                                      bwd_lanes(n_paths), intersect_fn=ifn, fixed_trips=trips,
                                      remat=remat, graphs=graphs)
        pixel_mean = out.view(-1, BWD_SPP, 3).sum(dim=1) / BWD_SPP
        return (pixel_mean ** 2).mean(), rays

    chunk.first_path = first
    chunk.graphs = graphs
    return chunk, params


def bench_bwd(scene: Scene, device=None, chunk_lg: int = BWD_CHUNK_LG, reps: int = BWD_REPS,
              trips: int = BWD_TRIPS, seed: int = 0) -> dict:
    """Forward+backward rays/s: torch.autograd.grad of bwd_chunk's loss with
    respect to the four material tables, every trip rematerialised. One
    warm-up chunk, whose loss and gradients must be finite, then chunks 0 to
    reps - 1 timed with one synchronisation at the end. On the card the
    warm-up captures the trip's graphs; the `bench:` line gives their pool
    (`graph_pool_bytes`) and the Python step's calls (`trip_step_calls`: 3
    at the capture, none in a replay; without graphs None and 0)."""
    device = resolve_device(device)
    chunk, params = bwd_chunk(scene, device, chunk_lg, trips, seed)
    n_paths = 1 << chunk_lg

    def loss_and_grads(i):
        loss, rays = chunk(i)
        return loss.detach(), rays, torch.autograd.grad(loss, list(params.values()))

    def check_finite(loss, grads, what):
        if not bool(torch.isfinite(loss)) or not all(bool(torch.isfinite(g).all()) for g in grads):
            raise RuntimeError(f"bench_bwd: non-finite loss or gradient ({what})")

    loss, _, grads = loss_and_grads(0)
    check_finite(loss, grads, "warm-up chunk")
    launches = tk.kernel.launches
    rays_list = []
    t0 = time.perf_counter()
    for i in range(reps):
        loss, rays, grads = loss_and_grads(i)
        rays_list.append(rays)
    _sync(device)
    dt = time.perf_counter() - t0
    launches = tk.kernel.launches - launches
    check_finite(loss, grads, "last chunk")
    total_rays = int(torch.stack(rays_list).sum())
    trips_graphed = list(chunk.graphs.values())
    pool_bytes = sum(t.pool_bytes for t in trips_graphed) if trips_graphed else None
    step_calls = sum(t.step_calls for t in trips_graphed)
    _report("forward+backward", device=str(device), reps=reps, chunk=n_paths,
            lanes=bwd_lanes(n_paths), trips=trips, first_path=chunk.first_path, time_s=dt,
            rays=total_rays, launches=launches, graph_pool_bytes=pool_bytes,
            trip_step_calls=step_calls)
    return {
        "rays_per_s": total_rays / dt,
        "chunk": n_paths,
        "reps": reps,
        "time_s": dt,
        "rays": total_rays,
        "loss": float(loss),
    }


def bench_bwd_subprocess(chunk_lg: int = BWD_CHUNK_LG, device: str | None = None,
                         seed: int = 0) -> dict:
    """bench_bwd in a child process (`--bwd-only chunk_lg`), as bench.py runs
    it; the child's `bench:` lines go to this process's stderr. A failed child
    raises with the tail of its stderr."""
    cmd = [sys.executable, "-m", "mcrt_tpu_torch.bench", "--bwd-only", str(chunk_lg),
           "--seed", str(seed)] + ([] if device is None else ["--device", str(device)])
    out = subprocess.run(cmd, capture_output=True, text=True, timeout=1800, cwd=str(_ROOT))
    err = out.stderr.strip().splitlines()
    for line in err:
        if line.startswith("bench: "):
            print(line, file=sys.stderr, flush=True)
    lines = [line for line in out.stdout.strip().splitlines() if line.startswith("{")]
    if out.returncode != 0 or not lines:
        raise RuntimeError(f"bench_bwd at 2^{chunk_lg} paths failed (exit {out.returncode}); "
                           "stderr tail:\n" + "\n".join(err[-15:]))
    return json.loads(lines[-1])


def card_line(device) -> str | None:
    """The card's name and power limit as nvidia-smi gives them; None on the CPU."""
    if device.type != "cuda":
        return None
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
                              "-i", str(device.index or 0)],
                             capture_output=True, text=True, check=True)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        return f"{torch.cuda.get_device_name(device)}, power limit not read"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m mcrt_tpu_torch.bench",
                                 description="Path-tracing throughput of the port, as one JSON line.")
    ap.add_argument("--bwd-only", type=int, metavar="LG",
                    help="run only the forward+backward point at 2^LG paths a chunk and print its result")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; the bench raises without one)")
    ap.add_argument("--seed", type=int, default=0, help="the sampler's global seed (default 0)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    scene = bench_scene()
    if args.bwd_only is not None:
        print(json.dumps(bench_bwd(scene, device, chunk_lg=args.bwd_only, seed=args.seed)), flush=True)
        return 0
    ours = bench_ours(scene, device, seed=args.seed)
    bwd = bench_bwd_subprocess(BWD_CHUNK_LG, args.device, args.seed)
    print(json.dumps({
        "metric": METRIC,
        "value": round(ours["rays_per_s"], 1),
        "unit": "rays/s",
        "vs_baseline": None,
        "fwd_bwd_rays_per_s_1024spp": round(bwd["rays_per_s"], 1),
        "fwd_bwd_chunk": bwd["chunk"],
        "diag_walk_steps_32k": ours["walk_steps"],
        "diag_leaf_rounds_32k": ours["leaf_rounds"],
        "card": card_line(device),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
