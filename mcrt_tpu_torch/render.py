"""Top-level render API: scene -> linear HDR image, on the CUDA device by default.

The port of the JAX package's render driver (reference
source/camera/camera.cpp:101-181): the (pixel, sample) space is split into
chunks of `rays_per_chunk` paths; each chunk runs the path tracer and
accumulates into a film carried across chunks on the device. With
`streamed=True` (the default, the main path) a chunk's paths stream through
`lanes` persistent lanes (`path_tracer.StreamedTrace`, one per chunk size for
the whole render: on the card its bounce step is captured once as a CUDA graph
and replayed every bounce of every chunk), and under the box filter at radius
0.5 the per-pixel sums go straight into the film rows. With `streamed=False`
a chunk is one batch of camera rays through `path_tracer.trace`, whose
`BatchTrace` for that batch size is kept for the whole render and replayed
the same way.
`integrator="photon_mapper"` first builds the photon maps (or loads them from
the checkpoint directory; on the card the emission replays a captured step),
then runs the photon eye pass over the same chunks (one
`photon_mapper.StreamedEyePass`, or with `streamed=False` one
`photon_mapper.BatchEyePass`, per chunk size, replayed as the path tracer's).
Float64 tables on the card traverse best-first (ops/cluster_bvh), whose loop
the host drives, so those loops run every step eagerly; stats["graphed"]
says which route a render took.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import pathlib
import time
import zipfile

import numpy as np
import torch

from .camera import camera as cam_mod
from .camera import film as film_mod
from .camera import image as image_mod
from .accel import photon_grid as pgrid
from .integrator import path_tracer as pt
from .integrator import photon_mapper as pm
from .ops import cluster_bvh
from .ops import traverse_kernel as tk
from .scene.loader import Scene
from .utils import trace
from .utils.device import resolve_device, torch_dtype


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    dtype: str = "float32"
    max_bounces: int = 64
    global_seed: int = 0
    rays_per_chunk: int = 1 << 17     # paths per chunk
    sqrtspp: int | None = None        # override scene camera spp
    integrator: str = "path_tracer"   # or "photon_mapper"
    profile_dir: str | None = None    # write a torch.profiler trace of the render there
    # Persistent-wavefront streaming: a chunk's paths stream through `lanes`
    # lanes; a lane whose path dies immediately loads the next one.
    streamed: bool = True
    lanes: int = 1 << 14


def _ckpt_key(cfg: RenderConfig, cam, spp: int, scene_hash: str) -> str:
    """Fingerprint of everything that must match for a checkpoint to be resumable."""
    return (
        f"{cam.width}x{cam.height}_spp{spp}_b{cfg.max_bounces}_s{cfg.global_seed}"
        f"_c{cfg.rays_per_chunk}_{cfg.integrator}_{cfg.dtype}_{scene_hash}"
    )


def _camera_rays(cam, spp, start, n, seed, dtype, dev):
    """Camera rays of paths [start, start+n): pixel-major, sample-minor."""
    lin = start + torch.arange(n, dtype=torch.int64, device=dev)
    pix = torch.div(lin, spp, rounding_mode="floor")
    return cam_mod.generate_rays(
        cam, pix % cam.width, torch.div(pix, cam.width, rounding_mode="floor"), lin % spp,
        seed, dtype)


def _add_pixel_sums(film_acc, sums, spp, start):
    """Box filter at radius 0.5 puts every sample in its own pixel and paths are
    pixel-major, so a chunk's per-pixel sums add to contiguous film rows."""
    n_px = sums.shape[0]
    pix0 = start // spp
    flat = film_acc.view(-1, 4)
    flat[pix0:pix0 + n_px, :3] += sums
    flat[pix0:pix0 + n_px, 3] += spp
    return film_acc


def _chunk_streamed(traces, tables, meta, ptcfg, cam, film_cfg, intersect_fn, spp, lanes,
                    start, n, film_acc, stats):
    """Paths [start, start+n) through the StreamedTrace of n-path chunks, made
    at the first chunk of that size and kept in `traces`, accumulated into
    film_acc."""
    use_px_sums = film_cfg.is_pixel_box and n % spp == 0
    if n not in traces:
        traces[n] = pt.StreamedTrace(tables, meta, ptcfg, cam, spp, n, min(lanes, n),
                                     intersect_fn=intersect_fn, pixel_sums=use_px_sums)
    radiance, rays = traces[n](start, stats)
    stats["rays"] = stats.get("rays", 0) + rays
    if use_px_sums:
        return _add_pixel_sums(film_acc, radiance, spp, start)
    rays_ = _camera_rays(cam, spp, start, n, ptcfg.global_seed, film_acc.dtype, film_acc.device)
    return film_acc + film_mod.splat(film_cfg, rays_.px, radiance)


def _chunk_plain(traces, tables, meta, ptcfg, cam, film_cfg, intersect_fn, spp, start, n,
                 film_acc, stats):
    """Paths [start, start+n) as one batch of camera rays through trace,
    whose BatchTrace for n-ray batches is made at the first chunk of that
    size and kept in `traces`."""
    rays = _camera_rays(cam, spp, start, n, ptcfg.global_seed, film_acc.dtype, film_acc.device)
    radiance, st = pt.trace(
        tables, meta, ptcfg, rays.origin, rays.direction, rays.pixel_index, rays.sample_index,
        intersect_fn=intersect_fn, return_stats=True, graphs=traces,
    )
    stats["rays"] = stats.get("rays", 0) + st["rays"]
    stats["bounce_steps"] = stats.get("bounce_steps", 0) + st["bounce_steps"]
    return film_acc + film_mod.splat(film_cfg, rays.px, radiance)


def _chunk_pm_streamed(traces, tables, meta, pmcfg, maps, cam, film_cfg, intersect_fn, spp,
                       lanes, start, n, film_acc, stats):
    """Paths [start, start+n) through the photon mapper's StreamedEyePass of
    n-path chunks, made at the first chunk of that size and kept in `traces`,
    accumulated into film_acc."""
    if n not in traces:
        traces[n] = pm.StreamedEyePass(tables, meta, pmcfg, maps, cam, spp, n, min(lanes, n),
                                       intersect_fn=intersect_fn)
    radiance = traces[n](start, stats)
    if film_cfg.is_pixel_box and n % spp == 0:
        return _add_pixel_sums(film_acc, radiance.view(n // spp, spp, 3).sum(dim=1), spp, start)
    rays = _camera_rays(cam, spp, start, n, pmcfg.global_seed, film_acc.dtype, film_acc.device)
    return film_acc + film_mod.splat(film_cfg, rays.px, radiance)


def _chunk_pm_plain(traces, tables, meta, pmcfg, maps, cam, film_cfg, intersect_fn, spp, start,
                    n, film_acc, stats):
    """Paths [start, start+n) as one batch of camera rays through the photon
    mapper's BatchEyePass of n-ray batches, made at the first chunk of that
    size and kept in `traces`."""
    rays = _camera_rays(cam, spp, start, n, pmcfg.global_seed, film_acc.dtype, film_acc.device)
    if n not in traces:
        traces[n] = pm.BatchEyePass(tables, meta, pmcfg, maps, intersect_fn=intersect_fn)
    radiance = traces[n](rays.origin, rays.direction, rays.pixel_index, rays.sample_index, stats)
    return film_acc + film_mod.splat(film_cfg, rays.px, radiance)


def _photon_maps(scene, tables, meta, pmcfg, cam, cfg, intersect_fn, checkpoint_dir,
                 verbose, stats):
    """The photon maps: loaded from `checkpoint_dir` when it holds a matching
    pair, else built (and saved there). The reference rebuilds its maps every
    run (photon-mapper.cpp:24-232)."""
    device = tables.tri_v0.device
    paths = None
    if checkpoint_dir is not None:
        key = hashlib.sha1(repr((pmcfg, cam.width, cam.height, meta, cfg.dtype,
                                 scene.content_hash())).encode()).hexdigest()[:16]
        pm_dir = pathlib.Path(checkpoint_dir)
        pm_dir.mkdir(parents=True, exist_ok=True)
        paths = (pm_dir / f"photons_caustic_{key}.npz", pm_dir / f"photons_global_{key}.npz")
        if all(p.exists() for p in paths):
            try:
                maps = pm.PhotonMaps(caustic=pgrid.load_photon_grid(paths[0], device),
                                     global_=pgrid.load_photon_grid(paths[1], device))
                stats["photon_maps_loaded"] = True
                if verbose:
                    print("Resumed photon maps from checkpoint")
                return maps
            except (OSError, ValueError, KeyError, zipfile.BadZipFile):
                pass  # corrupt or foreign checkpoint: rebuild
    with trace.span("pm.photon_pass") as span:
        maps = pm.build_photon_maps(tables, meta, pmcfg, scene, intersect_fn, verbose=verbose,
                                    stats=stats)
    stats["photon_pass_s"] = span.seconds   # None when not recording: stats is render's own
    if paths is not None:
        pgrid.save_photon_grid(paths[0], maps.caustic)
        pgrid.save_photon_grid(paths[1], maps.global_)
    return maps


@contextlib.contextmanager
def _profiler(profile_dir, device):
    """torch.profiler over the body when profile_dir is set (CPU activity, plus
    the card's kernels on CUDA), writing a TensorBoard trace file
    (<host>_<pid>.<ns>.pt.trace.json) into profile_dir; nothing otherwise.
    The spans of utils/trace land in it as CPU ops."""
    if profile_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts, on_trace_ready=tensorboard_trace_handler(str(profile_dir))):
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)   # the trace ends with the last chunk's kernels


def render(
    scene: Scene,
    camera_idx: int = 0,
    cfg: RenderConfig = RenderConfig(),
    device=None,
    checkpoint_dir=None,
    checkpoint_every_s: float = 30.0,
    stats: dict | None = None,
    verbose: bool = False,
):
    """Render one camera of a scene. Returns the linear HDR image (H, W, 3) as
    float64 numpy.

    device: None renders on the CUDA device (and raises without one); pass
    "cpu" to render on the CPU.
    checkpoint_dir: if set, the film accumulator and progress counter are saved
    there periodically and a matching checkpoint is resumed; a mismatched one
    (other resolution/spp/seed/scene) is ignored. Photon maps are saved there
    too, and reused by a render with the same photon settings.
    stats: if a dict, receives "chunks", "bounce_steps" (host
    synchronisations of the bounce loops: one a bounce step, which on the
    card is one replay of a captured graph after each run's first two) and
    "graphed" (whether the chunk loops replayed captured graphs: False on
    the CPU, and for float64 tables on the card, whose best-first traversal
    runs every step eagerly; the photon pass's loop included); the path
    tracer adds "rays" (a device count),
    the photon mapper
    "photons_caustic", "photons_global", "photon_pass_s" (the span
    `pm.photon_pass`), "emission_steps" and the k-NN counts of
    photon_grid.knn. The render also records into it (utils/trace):
    "spans", {name: [count, seconds, self seconds]} of the spans `render`,
    `render.tables`, `render.bvh`, `render.chunk`, `render.finish`, the
    photon mapper's `pm.photon_pass`, `pm.emit`, `pm.emit.copy` and
    `pm.grid`, and the loops' `loop.load`, `loop.drain`, `loop.warm` and
    `loop.capture`; and the loops' counters (utils/cuda_graph): "loop_steps"
    (every loop's steps: "bounce_steps" plus, for the photon mapper,
    "emission_steps"), "loop_sync_wait_s" (host seconds blocked on the
    steps' syncs and before the captures) and, on the card,
    "graph_pool_bytes" (what the captures' pools reserved, summed); and the
    traversal kernel's launches that ran during the render,
    "traverse_launches", and those of them that ran as two-CTA clusters,
    "traverse_paired_launches" (both 0 on the CPU, where the plain version
    runs). Like the other keys they add to what the dict holds. With stats
    None nothing is recorded and no span reads a clock.
    verbose: print the photon emission and a per-chunk progress line.
    cfg.profile_dir: write a torch.profiler trace of the whole render there,
    set-up, photon pass and spans included.
    """
    if cfg.integrator not in ("path_tracer", "photon_mapper"):
        raise ValueError(f"unknown integrator {cfg.integrator!r}")
    device = resolve_device(device)
    with _profiler(cfg.profile_dir, device), trace.recording(stats), trace.span("render"):
        launches, paired = tk.kernel.launches, tk.paired.launches
        image = _render(scene, camera_idx, cfg, device, checkpoint_dir, checkpoint_every_s,
                        {} if stats is None else stats, verbose)
        trace.count("traverse_launches", tk.kernel.launches - launches)
        trace.count("traverse_paired_launches", tk.paired.launches - paired)
        return image


def _render(scene, camera_idx, cfg, device, checkpoint_dir, checkpoint_every_s, stats, verbose):
    """render()'s body, on a resolved device and into a stats dict."""
    traces = {}   # the chunk loop's run (StreamedTrace, StreamedEyePass, BatchTrace or
                  # BatchEyePass) per chunk size
    dtype = torch_dtype(cfg.dtype)
    stats.pop("graphed", None)   # this render's: the photon pass's and the chunk loop's
    cam = scene.cameras[camera_idx]
    sqrtspp = cfg.sqrtspp if cfg.sqrtspp is not None else cam.sqrtspp
    spp = sqrtspp * sqrtspp

    with trace.span("render.tables"):
        tables = scene.tables(dtype, device)
    meta = scene.meta()
    film_cfg = film_mod.FilmConfig.from_json(cam.width, cam.height, cam.film)
    with trace.span("render.bvh"):
        cbvh = scene.build_cluster_bvh(np.dtype(cfg.dtype), device)
        intersect_fn = None if cbvh is None else cluster_bvh.make_intersect_fn(tables, meta, cbvh)

    if cfg.integrator == "photon_mapper":
        pmcfg = pm.PMConfig.from_json(scene.photon_map_config, max_eye_bounces=cfg.max_bounces,
                                      global_seed=cfg.global_seed)
        maps = _photon_maps(scene, tables, meta, pmcfg, cam, cfg, intersect_fn, checkpoint_dir,
                            verbose, stats)
        stats["photons_caustic"] = maps.caustic.n_photons
        stats["photons_global"] = maps.global_.n_photons
        if cfg.streamed:
            run_chunk = lambda start, n, acc: _chunk_pm_streamed(
                traces, tables, meta, pmcfg, maps, cam, film_cfg, intersect_fn, spp, cfg.lanes,
                start, n, acc, stats)
        else:
            run_chunk = lambda start, n, acc: _chunk_pm_plain(
                traces, tables, meta, pmcfg, maps, cam, film_cfg, intersect_fn, spp, start, n, acc,
                stats)
    else:
        ptcfg = pt.PTConfig(max_bounces=cfg.max_bounces, global_seed=cfg.global_seed)
        if cfg.streamed:
            run_chunk = lambda start, n, acc: _chunk_streamed(
                traces, tables, meta, ptcfg, cam, film_cfg, intersect_fn, spp, cfg.lanes,
                start, n, acc, stats)
        else:
            run_chunk = lambda start, n, acc: _chunk_plain(
                traces, tables, meta, ptcfg, cam, film_cfg, intersect_fn, spp, start, n, acc, stats)

    n_pix = cam.width * cam.height
    total = n_pix * spp
    chunk = min(cfg.rays_per_chunk, total)
    film_acc = torch.zeros((cam.height, cam.width, 4), dtype=dtype, device=device)

    done = 0
    ckpt_path = None
    key = None
    if checkpoint_dir is not None:
        ckpt_dir = pathlib.Path(checkpoint_dir)
        ckpt_dir.mkdir(parents=True, exist_ok=True)
        ckpt_path = ckpt_dir / f"film_{cam.savename}_{camera_idx}.npz"
        key = _ckpt_key(cfg, cam, spp, scene.content_hash())
        if ckpt_path.exists():
            try:
                z = np.load(ckpt_path)
                if str(z["key"]) == key and int(z["done"]) <= total:
                    film_acc = torch.as_tensor(z["film"], dtype=dtype, device=device).clone()
                    done = int(z["done"])
                    if verbose:
                        print(f"Resumed checkpoint at {done}/{total} camera rays")
            except (OSError, ValueError, KeyError):
                pass  # corrupt or foreign checkpoint: start fresh

    def save_ckpt():
        if ckpt_path is None:
            return
        tmp = ckpt_path.with_suffix(".tmp.npz")
        np.savez(tmp, film=film_acc.cpu().numpy(), done=done, key=key)
        tmp.replace(ckpt_path)  # atomic on POSIX

    last_ckpt = time.monotonic()
    # Progress (reference progress thread, camera.cpp:183-226): a moving
    # average of camera rays/s over the last 32 chunks, and the ETA.
    recent = [(last_ckpt, done)]
    stats["chunks"] = 0
    try:
        while done < total:
            n = min(chunk, total - done)
            with trace.span("render.chunk"):
                film_acc = run_chunk(done, n, film_acc)
            done += n
            stats["chunks"] += 1
            if ckpt_path is not None and time.monotonic() - last_ckpt > checkpoint_every_s:
                save_ckpt()
                last_ckpt = time.monotonic()
            if verbose:
                if film_acc.is_cuda:
                    torch.cuda.synchronize(film_acc.device)
                now = time.monotonic()
                recent = (recent + [(now, done)])[-32:]
                dt = now - recent[0][0]
                rate = (done - recent[0][1]) / dt if dt > 0 else 0.0
                eta = (total - done) / rate if rate > 0 else float("inf")
                print(f"\r{done}/{total} camera rays | {rate / 1e6:.2f} M rays/s | "
                      f"ETA {eta:.0f}s   ", end="", flush=True)
        graphed = all(t.graphed for t in traces.values())
        stats["graphed"] = stats.get("graphed", True) and graphed
    finally:
        for t in traces.values():   # the graphs and their pools
            t.close()
    if verbose:
        print()
    save_ckpt()

    with trace.span("render.finish"):
        img = film_mod.scan(film_acc)
        return img.cpu().numpy().astype(np.float64)


def render_to_file(scene: Scene, out_path, camera_idx: int = 0, cfg: RenderConfig = RenderConfig(),
                   device=None):
    """Render, tonemap as the camera's image block says, and write a TGA.
    Returns the linear HDR image."""
    hdr = render(scene, camera_idx, cfg, device=device)
    cam = scene.cameras[camera_idx]
    image_mod.write_tga(out_path, image_mod.finalize(hdr, cam.image))
    return hdr
