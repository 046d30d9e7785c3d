"""Multi-process rendering on torch.distributed: one rank per device.

The port of the JAX package's mcrt_tpu/parallel/distributed.py. Every process
runs the same program; `initialize` joins it to a process group (NCCL between
cards, gloo on the CPU), and `render_distributed` splits each chunk of the
(pixel, sample) batch over the ranks with `sharding.sharded_render_step`, whose
film all-reduce leaves the full image on every rank.

A run is wired by arguments or by the JAX package's variables:
MCRT_COORDINATOR (host:port of rank 0), MCRT_NUM_PROCESSES and
MCRT_PROCESS_ID. With none of them set a process is a world of one and
nothing is initialised. `python -m mcrt_tpu_torch.parallel.dryrun N` starts N
ranks on one host.
"""
from __future__ import annotations

import datetime
import os
import socket

import numpy as np
import torch
import torch.distributed as dist

from ..camera import film as film_mod
from ..integrator import path_tracer as pt
from ..utils.device import resolve_device, torch_dtype
from . import sharding

# Paths a rank traces per chunk, at most: the JAX package's chunk envelope
# (mcrt_tpu/render.py, MAX_VALIDATED_RAYS_PER_CHUNK), kept so that both
# packages cut the batch into the same chunks.
MAX_RAYS_PER_CHUNK = 1 << 18


def initialize(coordinator_address: str | None = None, num_processes: int | None = None,
               process_id: int | None = None, backend: str | None = None, device=None,
               timeout_s: float = 300.0) -> torch.device:
    """Join this process to the process group and return its device.

    Unset arguments come from MCRT_COORDINATOR, MCRT_NUM_PROCESSES and
    MCRT_PROCESS_ID. With none of the three the process is a world of one
    and nothing is initialised. A process group that already exists is kept
    when its size and this process's rank are the ones asked for; otherwise
    this raises.
    device: None is CUDA (raise without a card), where a rank takes card
    LOCAL_RANK, or process_id modulo the card count; "cpu" on request.
    backend: NCCL on CUDA and gloo on the CPU unless given (gloo also
    reduces CUDA tensors, through the host). timeout_s bounds every
    collective and the wait for the other ranks to join."""
    device = resolve_device(device)
    coordinator_address = coordinator_address or os.environ.get("MCRT_COORDINATOR")
    if num_processes is None and "MCRT_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["MCRT_NUM_PROCESSES"])
    if process_id is None and "MCRT_PROCESS_ID" in os.environ:
        process_id = int(os.environ["MCRT_PROCESS_ID"])
    if coordinator_address is None and num_processes is None and process_id is None:
        return device
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("initialize: give the coordinator address, the number of processes "
                         "and the process id, or none of them")
    if device.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", process_id % torch.cuda.device_count()))
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    if dist.is_initialized():
        have = (dist.get_world_size(), dist.get_rank())
        if have != (num_processes, process_id):
            raise RuntimeError(f"initialize: a process group of {have[0]} ranks, this one rank "
                               f"{have[1]}, already exists; asked for rank {process_id} of "
                               f"{num_processes}")
        return device
    dist.init_process_group(
        backend or ("nccl" if device.type == "cuda" else "gloo"),
        init_method=f"tcp://{coordinator_address}", world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    return device


def free_port() -> int:
    """A TCP port on 127.0.0.1 that no socket holds now, for a coordinator
    address on this host."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def global_mesh() -> sharding.Mesh:
    """The mesh over every rank of every host: the default process group."""
    return sharding.make_mesh()


def process_shard(total: int) -> tuple[int, int]:
    """This process's (start, count) of a length-`total` global batch; the
    batch must divide evenly over the ranks."""
    mesh = global_mesh()
    return sharding.shard(total, mesh.rank, mesh.size)


def chunk_pixels(cam, spp: int, total: int, done: int, n: int, ranks: int, device):
    """Global (n_pad,) px, py, si of paths [done, done + n), n_pad the next
    multiple of `ranks`: pixel-major, sample-minor, as one device's render.
    A lane past the last path is a masked lane: its x is width + 8, which puts
    every filter tap off the film, so it splats with weight 0."""
    n_pad = -(-n // ranks) * ranks
    lin = done + torch.arange(n_pad, dtype=torch.int64, device=device)
    pad = lin >= total
    lin = torch.clamp(lin, max=total - 1)
    pix = torch.div(lin, spp, rounding_mode="floor")
    px = torch.where(pad, torch.full_like(pix, cam.width + 8), pix % cam.width)
    py = torch.div(pix, cam.width, rounding_mode="floor") % cam.height
    return px, py, lin % spp


def render_distributed(scene, camera_idx: int = 0, cfg=None, verbose: bool = False, device=None):
    """Multi-process render of one camera. Every rank calls it with the same
    arguments; each returns the full linear HDR image (H, W, 3), float64 numpy.

    Each chunk of min(rays_per_chunk, MAX_RAYS_PER_CHUNK) paths per rank goes
    through the batch path tracer (`pt.trace`) in `sharded_render_step`, with
    the scene's ClusterBVH routed when it has a "bvh" block; the tail is padded
    to a multiple of the rank count with masked lanes. The step's runs
    (`graphs`, one per chunk size: on the card a captured bounce step) serve
    every chunk and are closed when the loop ends. In a world of one this is
    a one-device render by the batch tracer.
    device: None is the rank's CUDA device (raise without one); "cpu" on request."""
    from ..render import RenderConfig

    cfg = cfg or RenderConfig()
    device = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)
    cam = scene.cameras[camera_idx]
    sqrtspp = cfg.sqrtspp if cfg.sqrtspp is not None else cam.sqrtspp
    spp = sqrtspp * sqrtspp

    tables = scene.tables(dtype, device)
    meta = scene.meta()
    ptcfg = pt.PTConfig(max_bounces=cfg.max_bounces, global_seed=cfg.global_seed)
    film_cfg = film_mod.FilmConfig.from_json(cam.width, cam.height, cam.film)
    mesh = global_mesh()
    cbvh = scene.build_cluster_bvh(np.dtype(cfg.dtype), device)
    step = sharding.sharded_render_step(meta, ptcfg, cam, film_cfg, mesh, dtype,
                                        with_bvh=cbvh is not None, device=device)
    args = (tables, cbvh) if cbvh is not None else (tables,)

    total = cam.width * cam.height * spp
    chunk = min(cfg.rays_per_chunk, MAX_RAYS_PER_CHUNK) * mesh.size
    chunk = min(chunk, ((total // mesh.size) or 1) * mesh.size)
    film = torch.zeros((cam.height, cam.width, 4), dtype=dtype, device=device)
    done = 0
    try:
        while done < total:
            n = min(chunk, total - done)
            film = step(*args, *chunk_pixels(cam, spp, total, done, n, mesh.size, device), film)
            done += n
            if verbose and mesh.rank == 0:
                print(f"\r{done}/{total} rays", end="", flush=True)
    finally:
        for run in step.graphs.values():   # the graphs, their pools and static tables
            run.close()
        step.graphs.clear()
    if verbose and mesh.rank == 0:
        print()
    return film_mod.scan(film).cpu().numpy().astype(np.float64)
