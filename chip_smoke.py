#!/usr/bin/env python3
"""GPU smoke run of mcrt_tpu_torch, the PyTorch + CUDA port of the renderer.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py            # about 1M triangles, 512x512, 16 spp; no options

Phases (each prints its own lines; any failed check exits non-zero):
  1. device   the card's name and power limit (nvidia-smi); no card, no run
  2. build    nvcc builds the traversal kernel from mcrt_tpu_torch/csrc/traverse.cu
  3. kernel   the kernel against its plain PyTorch version on the card, on camera
              rays, random rays from surface points, a parked block and mixed
              live/dead blocks: ids identical, t within rtol 5e-6, u/v within
              atol 5e-3, per-block stats identical, parked block zero rounds;
              then kernel and plain timed at the main path's launch shape, and
              the bound counted from the clusters each block visits
  4. render   mcrt_tpu_torch.render of the height-field scene at 512x512, 16 spp,
              max_bounces 64, default RenderConfig, with the kernel's launch count
              reset before and read after; then a profiled 1-spp render for the
              kernel's share of device time
  5. compare  the same scene at 64x64, 4 spp, through the kernel and through the
              plain traversal on the card, held to the golden-image bars

The line before the last names the card and its power limit; the line before
that is the JSON kernel table; the last line is the JSON result. Imports no JAX
and nothing of the JAX package.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from unittest import mock

# H100 SXM peaks (NVIDIA data sheet) used for the bounds.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# Per (ray, triangle) operations of one visit: 19 multiplies + 15 adds of the
# forms, one division, three products, plus the compares; per (ray, cluster)
# of the cull: 6 subtracts, 6 multiplies, 10 min/max.
OPS_PER_RAY_TRI = 38
OPS_PER_RAY_BOX = 22

# The run's one configuration: the height field at n = 708 (1,002,528
# triangles), rendered at 512x512 and 4^2 = 16 spp as bench.py did; the kernel
# is checked on 2^16 rays of each kind.
GRID_N = 708
WIDTH = 512
SQRTSPP = 4
CHECK_RAYS = 1 << 16


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


def main() -> int:
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
    from mcrt_tpu_torch.camera import camera as cam_mod
    from mcrt_tpu_torch.camera import image as image_mod
    from mcrt_tpu_torch.ops import cluster_bvh
    from mcrt_tpu_torch.ops import traverse_kernel as tk
    from mcrt_tpu_torch.scene.synthetic import height_field_scene

    # ---- 2. build ----
    t0 = time.perf_counter()
    tk.build()
    log("build", f"nvcc sm_90a build + load {time.perf_counter() - t0:.2f} s")
    for line in tk.kernel.build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log("build", line.strip())

    # ---- scene (shared by phases 3-5) ----
    t0 = time.perf_counter()
    j = height_field_scene(GRID_N, WIDTH, SQRTSPP)
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
        tk.kernel.launches = 0
        kt, kid, ku, kv, kst = tk.traverse(cbvh, o, d)
        torch.cuda.synchronize()
        check(tk.kernel.launches == 1, "kernel", f"{name}: wrapper did not launch the kernel")
        pt_, pid, pu, pv, pst = tk.traverse_plain(cbvh, o, d)
        torch.cuda.synchronize()
        ids_same = bool((kid == pid).all())
        hit = pid >= 0
        t_ok = bool(torch.allclose(kt[hit], pt_[hit], rtol=5e-6, atol=0.0))
        uv_err = float(torch.maximum((ku - pu).abs().max(), (kv - pv).abs().max()))
        st_same = bool((kst == pst).all())
        if bool(hit.any()):
            max_err = max(max_err, float((kt[hit] - pt_[hit]).abs().max()), uv_err)
        bitwise = bool((kt == pt_).all() & (ku == pu).all() & (kv == pv).all())
        log("kernel", f"{name:8s} rays={o.shape[0]} hits={int(hit.sum())} ids_same={ids_same} "
            f"t_ok={t_ok} max|duv|={uv_err:.3g} stats_same={st_same} bitwise={bitwise} "
            f"candidates={int(kst[:, 0].sum())} rounds_sum={int(kst[:, 1].sum())} "
            f"rounds_max={int(kst[:, 1].max())}")
        check(ids_same and t_ok and uv_err <= 5e-3 and st_same, "kernel", f"{name}: mismatch")
        if name == "parked":
            check(int(kst[:, 1].max()) == 0 and bool((kid == -1).all()), "kernel",
                  "parked block ran rounds or hit")
        if name == "mixed":
            check(bool((kid[::2] == -1).all()), "kernel", "parked lanes of mixed blocks hit")

    # Timing at the main path's launch shape: one call per `lanes` sorted rays.
    lanes = mt.RenderConfig().lanes
    timing = {}
    kinds = ("camera", "surface", "shadow")
    for name in kinds:
        o, d = sorted_sets[name]
        o, d = o[:lanes].contiguous(), d[:lanes].contiguous()
        ms = cuda_time_ms(lambda: tk.traverse(cbvh, o, d), reps=20, warmup=2)
        plain_ms = cuda_time_ms(lambda: tk.traverse_plain(cbvh, o, d), reps=2, warmup=1)
        *_, st = tk.traverse(cbvh, o, d)
        B = st.shape[0]
        rounds = int(st[:, 1].sum())
        bound_ms, by, tri_visits = traversal_bound(tk, cbvh, o, d, st)
        timing[name] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=by)
        log("kernel", f"time {name:8s} {lanes} rays, {B} blocks, {rounds} rounds, "
            f"{tri_visits:.0f} real triangles visited ({tri_visits / (rounds * Sp):.4f} of "
            f"the slots): kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms "
            f"({by}), {ms / bound_ms:.1f}x the bound | {card}")

    # ---- 4. main path at full size ----
    cfg = mt.RenderConfig(max_bounces=64)
    stats = {}
    tk.kernel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hdr = mt.render(scene, 0, cfg, stats=stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = tk.kernel.launches
    spp = SQRTSPP ** 2
    cam_rays = cam.width * cam.height * spp
    rays_traced = int(stats["rays"])
    log("render", f"{cam.width}x{cam.height} {spp} spp, {scene.n_tris} triangles: wall {wall:.3f} s, "
        f"{cam_rays / wall / 1e6:.4f} M camera rays/s, {rays_traced / wall / 1e6:.4f} M rays/s traced "
        f"(primary + shadow), kernel launches {launches}, bounce steps (host syncs) "
        f"{stats['bounce_steps']}, chunks {stats['chunks']} | {card}")
    check(launches > 0, "render", "the traversal kernel was not launched on the main path")
    check(hdr.shape == (cam.height, cam.width, 3), "render", f"bad image shape {hdr.shape}")
    check(bool(np.isfinite(hdr).all()) and float(hdr.min()) >= 0.0, "render", "non-finite or negative")
    check(0.01 < float(hdr.mean()) < 100.0, "render", f"trivial image mean {hdr.mean()}")
    log("render", f"image mean {hdr.mean():.6f} min {hdr.min():.6f} max {hdr.max():.4f}")

    # Kernel share of device time, from a profiled 1-spp render of the same scene.
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    cfg1 = mt.RenderConfig(max_bounces=64, sqrtspp=1)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        mt.render(scene, 0, cfg1)
        torch.cuda.synchronize()
        wall1 = time.perf_counter() - t1
    dev_events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    dev_time = lambda e: getattr(e, "self_device_time_total", 0.0)
    dev_us = sum(dev_time(e) for e in dev_events)
    kern_us = sum(dev_time(e) for e in dev_events if "traverse_kernel" in e.key)
    share = "not measured (the profiler recorded no device time)"
    if dev_us > 0:
        share = (f"1-spp profiled render: wall {wall1:.3f} s (profiler on), device busy "
                 f"{dev_us / 1e6:.3f} s ({100 * dev_us / 1e6 / wall1:.1f}% of wall), traversal "
                 f"kernel {kern_us / 1e6:.3f} s = {100 * kern_us / dev_us:.1f}% of device time")
        for e in sorted(dev_events, key=lambda e: -dev_time(e))[:10]:
            log("render", f"  device time {dev_time(e) / 1e3:10.1f} ms x{e.count:7d}  {e.key[:90]}")
    log("render", f"kernel share: {share}")

    # ---- 5. kernel render against plain render ----
    # The same scene (and BVH) through a second, 64x64 camera.
    scene.cameras.append(dataclasses.replace(cam, width=64, height=64))
    cfg_s = mt.RenderConfig(sqrtspp=2)
    img_k = mt.render(scene, 1, cfg_s)
    with mock.patch.object(tk, "traverse", tk.traverse_plain):
        img_p = mt.render(scene, 1, cfg_s)
    fin = lambda x: np.clip(image_mod.finalize(x, scene.cameras[1].image), 0.0, 1.0)
    a, b = fin(img_k), fin(img_p)
    diff = np.abs(a - b)
    per_channel = np.abs(a.mean(axis=(0, 1)) - b.mean(axis=(0, 1)))
    p95 = float(np.percentile(diff, 95))
    log("compare", f"64x64 4 spp kernel vs plain: per-channel mean diff {per_channel.max():.3g}, "
        f"p95 {p95:.3g}, mean {diff.mean():.3g}, max {diff.max():.3g}, hdr identical "
        f"{bool((img_k == img_p).all())}")
    check(bool(np.all(per_channel < 0.02)) and p95 < 0.25 and diff.mean() < 0.05, "compare",
          "kernel render and plain render disagree")

    mean = lambda key: sum(timing[k][key] for k in kinds) / len(kinds)
    kernels = [{
        "name": "cluster_bvh_traverse",
        "route": "cuda",
        "source": "mcrt_tpu_torch/csrc/traverse.cu",
        "replaces": "mcrt_tpu/ops/traverse_kernel.py:53",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": mean("ms"),
        "plain_ms": mean("plain_ms"),
        "bound_ms": mean("bound_ms"),
        "bound_by": timing["camera"]["bound_by"],
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
