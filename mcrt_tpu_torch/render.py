"""Top-level render API: scene -> linear HDR image, on the CUDA device by default.

The port of the JAX package's render driver (reference
source/camera/camera.cpp:101-181): the (pixel, sample) space is split into
chunks of `rays_per_chunk` paths; each chunk runs the path tracer and
accumulates into a film carried across chunks on the device. With
`streamed=True` (the default, the main path) a chunk's paths stream through
`lanes` persistent lanes (`path_tracer.trace_streamed`), and under the box
filter at radius 0.5 the per-pixel sums go straight into the film rows.
"""
from __future__ import annotations

import dataclasses
import pathlib
import time

import numpy as np
import torch

from .camera import camera as cam_mod
from .camera import film as film_mod
from .integrator import path_tracer as pt
from .ops import cluster_bvh
from .scene.loader import Scene
from .utils.device import resolve_device, torch_dtype


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    dtype: str = "float32"
    max_bounces: int = 64
    global_seed: int = 0
    rays_per_chunk: int = 1 << 17     # paths per chunk
    sqrtspp: int | None = None        # override scene camera spp
    integrator: str = "path_tracer"   # "photon_mapper" is not ported yet
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


def _chunk_streamed(tables, meta, ptcfg, cam, film_cfg, intersect_fn, spp, lanes,
                    start, n, film_acc, stats):
    """Paths [start, start+n) through trace_streamed, accumulated into film_acc."""
    dtype = film_acc.dtype
    use_px_sums = film_cfg.is_pixel_box and n % spp == 0
    radiance, rays = pt.trace_streamed(
        tables, meta, ptcfg, cam, spp, start, n, min(lanes, n),
        intersect_fn=intersect_fn, pixel_sums=use_px_sums, stats=stats,
    )
    stats["rays"] = stats.get("rays", 0) + rays
    if use_px_sums:
        # Box filter at radius 0.5 puts every sample in its own pixel and paths
        # are pixel-major, so the chunk's pixel sums add to contiguous film rows.
        n_px = n // spp
        pix0 = start // spp
        flat = film_acc.view(-1, 4)
        flat[pix0:pix0 + n_px, :3] += radiance
        flat[pix0:pix0 + n_px, 3] += spp
        return film_acc
    dev = film_acc.device
    lin = start + torch.arange(n, dtype=torch.int64, device=dev)
    pix = torch.div(lin, spp, rounding_mode="floor")
    rays_ = cam_mod.generate_rays(
        cam, pix % cam.width, torch.div(pix, cam.width, rounding_mode="floor"), lin % spp,
        ptcfg.global_seed, dtype)
    return film_acc + film_mod.splat(film_cfg, rays_.px, radiance)


def _chunk_plain(tables, meta, ptcfg, cam, film_cfg, intersect_fn, spp, start, n,
                 film_acc, stats):
    """Paths [start, start+n) as one batch of camera rays through trace."""
    dtype = film_acc.dtype
    dev = film_acc.device
    lin = start + torch.arange(n, dtype=torch.int64, device=dev)
    pix = torch.div(lin, spp, rounding_mode="floor")
    rays = cam_mod.generate_rays(
        cam, pix % cam.width, torch.div(pix, cam.width, rounding_mode="floor"), lin % spp,
        ptcfg.global_seed, dtype)
    radiance, st = pt.trace(
        tables, meta, ptcfg, rays.origin, rays.direction, rays.pixel_index, rays.sample_index,
        intersect_fn=intersect_fn, return_stats=True,
    )
    stats["rays"] = stats.get("rays", 0) + st["rays"]
    stats["bounce_steps"] = stats.get("bounce_steps", 0) + st["bounce_steps"]
    return film_acc + film_mod.splat(film_cfg, rays.px, radiance)


def render(
    scene: Scene,
    camera_idx: int = 0,
    cfg: RenderConfig = RenderConfig(),
    device=None,
    checkpoint_dir=None,
    checkpoint_every_s: float = 30.0,
    stats: dict | None = None,
):
    """Render one camera of a scene. Returns the linear HDR image (H, W, 3) as
    float64 numpy.

    device: None renders on the CUDA device (and raises without one); pass
    "cpu" to render on the CPU.
    checkpoint_dir: if set, the film accumulator and progress counter are saved
    there periodically and a matching checkpoint is resumed; a mismatched one
    (other resolution/spp/seed/scene) is ignored.
    stats: if a dict, receives "chunks", "rays" (a device count) and
    "bounce_steps" (host synchronisations of the bounce loops).
    """
    if cfg.integrator == "photon_mapper":
        raise NotImplementedError(
            "the photon mapper is not ported yet (port slice 3); use the JAX package")
    if cfg.integrator != "path_tracer":
        raise ValueError(f"unknown integrator {cfg.integrator!r}")
    device = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    stats = {} if stats is None else stats
    cam = scene.cameras[camera_idx]
    sqrtspp = cfg.sqrtspp if cfg.sqrtspp is not None else cam.sqrtspp
    spp = sqrtspp * sqrtspp

    tables = scene.tables(dtype, device)
    meta = scene.meta()
    ptcfg = pt.PTConfig(max_bounces=cfg.max_bounces, global_seed=cfg.global_seed)
    film_cfg = film_mod.FilmConfig.from_json(cam.width, cam.height, cam.film)
    cbvh = scene.build_cluster_bvh(np.dtype(cfg.dtype), device)
    intersect_fn = cluster_bvh.make_intersect_fn(tables, meta, cbvh) if cbvh is not None else None

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
            except (OSError, ValueError, KeyError):
                pass  # corrupt or foreign checkpoint: start fresh

    def save_ckpt():
        if ckpt_path is None:
            return
        tmp = ckpt_path.with_suffix(".tmp.npz")
        np.savez(tmp, film=film_acc.cpu().numpy(), done=done, key=key)
        tmp.replace(ckpt_path)  # atomic on POSIX

    last_ckpt = time.monotonic()
    stats["chunks"] = 0
    while done < total:
        n = min(chunk, total - done)
        if cfg.streamed:
            film_acc = _chunk_streamed(tables, meta, ptcfg, cam, film_cfg, intersect_fn, spp,
                                       cfg.lanes, done, n, film_acc, stats)
        else:
            film_acc = _chunk_plain(tables, meta, ptcfg, cam, film_cfg, intersect_fn, spp,
                                    done, n, film_acc, stats)
        done += n
        stats["chunks"] += 1
        if ckpt_path is not None and time.monotonic() - last_ckpt > checkpoint_every_s:
            save_ckpt()
            last_ckpt = time.monotonic()
    save_ckpt()

    img = film_mod.scan(film_acc)
    return img.cpu().numpy().astype(np.float64)

