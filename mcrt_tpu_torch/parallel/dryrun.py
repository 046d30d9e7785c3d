"""Dry run of the sharded steps: N ranks, one render step and one train step.

    python -m mcrt_tpu_torch.parallel.dryrun N                # N cards, NCCL
    python -m mcrt_tpu_torch.parallel.dryrun N --device cpu   # N CPU ranks, gloo

Started without MCRT_PROCESS_ID, it starts N ranks of itself on this host,
with MCRT_COORDINATOR on a free local port, and exits non-zero if a rank
fails or outlives the timeout. A process started with MCRT_COORDINATOR,
MCRT_NUM_PROCESSES and MCRT_PROCESS_ID set (by this launcher, or by hand on
each host of a fleet) is one rank. Each rank runs `sharded_render_step` and
`sharded_train_step` with the ClusterBVH routed, over the four default
material tables, on the in-repo height field at 8x8, one sample per pixel
and 3 bounces (the JAX package's dry run: `__graft_entry__.dryrun_multichip`);
rank 0 prints the loss and the gradient norm.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

WIDTH = 8
BOUNCES = 3
TIMEOUT_S = 300.0


def run_rank(n: int, device) -> None:
    """One rank of the dry run; raises when a check fails."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from ..camera import film as film_mod
    from ..integrator import path_tracer as pt
    from ..scene.loader import Scene
    from ..scene.synthetic import height_field_scene
    from . import distributed, sharding

    device = distributed.initialize(device=device, timeout_s=TIMEOUT_S)
    try:
        mesh = distributed.global_mesh()
        if mesh.size != n:
            raise RuntimeError(f"dry run of {n} ranks joined a world of {mesh.size}")
        scene = Scene(height_field_scene(8, WIDTH, 1))
        dtype = torch.float32
        tables = scene.tables(np.float32, device)
        cbvh = scene.build_cluster_bvh(np.float32, device)
        if cbvh is None:
            raise RuntimeError("the dry run must route the ClusterBVH")
        meta, cam = scene.meta(), scene.cameras[0]
        cfg = pt.PTConfig(max_bounces=BOUNCES)
        film_cfg = film_mod.FilmConfig.from_json(cam.width, cam.height, cam.film)
        rays = -(-WIDTH * WIDTH // n) * n
        lin = torch.arange(rays, device=device)
        px, py, si = lin % WIDTH, (lin // WIDTH) % WIDTH, torch.zeros_like(lin)

        render = sharding.sharded_render_step(meta, cfg, cam, film_cfg, mesh, dtype,
                                              with_bvh=True, device=device)
        film = render(tables, cbvh, px, py, si, torch.zeros((WIDTH, WIDTH, 4), device=device))
        if not bool(torch.isfinite(film).all()) or float(film[..., 3].sum()) != rays:
            raise RuntimeError("the sharded render step lost samples or is not finite")

        train = sharding.sharded_train_step(meta, cfg, cam, film_cfg, mesh, dtype,
                                            with_bvh=True, device=device)
        params = {k: getattr(tables, k) for k in sharding.DEFAULT_TRAIN_PARAMS}
        loss, grads = train(tables, cbvh, params, px, py, si,
                            torch.zeros((WIDTH, WIDTH, 3), device=device))
        if not np.isfinite(float(loss)):
            raise RuntimeError("the loss is not finite")
        for k, g in grads.items():
            if not bool(torch.isfinite(g).all()):
                raise RuntimeError(f"the gradients of {k} are not finite")
        gnorm = float(torch.sqrt(sum((g * g).sum() for g in grads.values())))
        if mesh.rank == 0:
            print(f"dryrun({n}, {device.type}): loss={float(loss):.6f} grad_norm={gnorm:.6f}",
                  flush=True)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch(n: int, device) -> int:
    """Start n ranks of this module on this host and wait for them; returns 0,
    a failed rank's exit code (the others are stopped), or 1 on a timeout."""
    import torch

    from ..utils.device import resolve_device
    from .distributed import free_port

    dev = resolve_device(device)
    if dev.type == "cuda" and n > torch.cuda.device_count():
        raise ValueError(f"NCCL takes one rank per card: {n} ranks, "
                         f"{torch.cuda.device_count()} cards")
    env = dict(os.environ, MCRT_COORDINATOR=f"127.0.0.1:{free_port()}",
               MCRT_NUM_PROCESSES=str(n))
    cmd = [sys.executable, "-m", __spec__.name, str(n)] + (["--device", device] if device else [])
    procs = [subprocess.Popen(cmd, env=dict(env, MCRT_PROCESS_ID=str(i))) for i in range(n)]
    deadline = time.monotonic() + TIMEOUT_S
    try:
        while True:
            codes = [p.poll() for p in procs]
            failed = [(i, c) for i, c in enumerate(codes) if c not in (None, 0)]
            if failed:
                print(f"dryrun: rank {failed[0][0]} exited with {failed[0][1]}", file=sys.stderr)
                return failed[0][1]
            if all(c == 0 for c in codes):
                return 0
            if time.monotonic() > deadline:
                print(f"dryrun: the ranks did not finish in {TIMEOUT_S:.0f} s", file=sys.stderr)
                return 1
            time.sleep(0.1)
    finally:
        for p in procs:   # a rank still running after a failure is stopped
            if p.poll() is None:
                p.kill()
                p.wait()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, help="number of ranks")
    ap.add_argument("--device", default=None, help='"cpu" for gloo ranks on the CPU')
    args = ap.parse_args(argv)
    if "MCRT_PROCESS_ID" in os.environ:
        run_rank(args.n, args.device)
        return 0
    return launch(args.n, args.device)


if __name__ == "__main__":
    sys.exit(main())
