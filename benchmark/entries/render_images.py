"""Entry: whole images back to back through the port's `render.render`.

The traffic file gives the image ("width", "sqrtspp"), the chunking
("rays_per_chunk", "lanes", "streamed") and the Sobol scrambles of the
window's images: image i of every run renders `image_seeds[i % n]`, so every
run does the same work. The run's seed draws what the check compares: 1024
pixels of every image; for the photon mapper also the scramble whose image
and photon maps are checked, and a sample of its emissions.

The check, against the plain reference (reference/), which takes only the
scene dict:
- the sampled pixels of the images (path tracer: every image; photon mapper:
  the images of the checked scramble), where the photon mapper's reference
  stores its own photon maps from every emission and runs its eye pass on
  them;
- (photon mapper) the photons each of the port's two maps holds against the
  reference's count, and whether the photons that the sampled emissions
  store in the reference are in the port's maps.

The run drives the port's public entry and reads nothing from it but its
images, its `stats` counters, the photon maps of the checked scramble and,
in a profiled run, its kernels' names and the launches it captured
(recorders.py).
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import time
from unittest import mock

import numpy as np
import torch

from .. import cell, devtrace, recorders, roofline
from ..reference import closest_hit, tracer
from ..reference import loader as ref_loader

PIXEL_TOL = 1e-3      # a pixel is off where a channel differs by more than this share of
PIXEL_FLOOR = 1e-2    # its reference value plus this floor
PHOTON_TOL = 1e-5     # a photon is found where position, direction and flux agree to this
EMIT_BATCH = 1 << 20  # emissions the reference traces at once


def image_seed(traffic, i: int) -> int:
    """The Sobol scramble (RenderConfig.global_seed) of the window's image i."""
    seeds = traffic["image_seeds"]
    return seeds[i % len(seeds)]


def checked_scramble(traffic, seed: int) -> int:
    """The scramble whose images and photon maps a photon-mapper run checks."""
    rng = np.random.default_rng([seed, 3])
    return image_seed(traffic, int(rng.integers(len(traffic["image_seeds"]))))


def render_config(R, config, traffic, global_seed):
    return R.RenderConfig(dtype=config["dtype"], max_bounces=config["max_bounces"],
                          global_seed=global_seed, rays_per_chunk=traffic["rays_per_chunk"],
                          integrator=config["integrator"], streamed=traffic["streamed"],
                          lanes=traffic["lanes"])


def _numbers(stats):
    """A render's stats with device counts read as numbers."""
    return {k: (v.item() if isinstance(v, torch.Tensor) else v) for k, v in stats.items()}


def sample_pixels(seed, n_pixels, count):
    """The pixel ids the check compares, drawn from the seed."""
    rng = np.random.default_rng([seed, 1])
    return np.sort(rng.choice(n_pixels, size=min(count, n_pixels), replace=False))


def sample_emissions(seed, n_emissions, count):
    rng = np.random.default_rng([seed, 2])
    return np.sort(rng.choice(n_emissions, size=min(count, n_emissions), replace=False))


def _is_pm(config):
    return config["integrator"] == "photon_mapper"


def port_photon_maps(maps):
    """The port's (caustic, global) maps as the reference's PhotonMap rows."""
    return tuple(tracer.PhotonMap(g.arrays.pos, g.arrays.direction, g.arrays.flux)
                 for g in (maps.caustic, maps.global_))


def measure(config, traffic, seconds, trace, device, process_start, pixels, keep_maps=None):
    """Set-up, the window and (trace) a profiled render through the port.
    Returns (Run, per image (its scramble, the values of the linear pixel ids
    `pixels`), {scramble `keep_maps`: the port's (caustic, global) photon maps
    of its last render} (photon mapper), the LaunchSamples of the profiled
    render or None)."""
    dev = torch.device(device)
    R = importlib.import_module("mcrt_tpu_torch.render")
    pmm = importlib.import_module("mcrt_tpu_torch.integrator.photon_mapper")
    Scene = importlib.import_module("mcrt_tpu_torch.scene.loader").Scene
    scene = Scene(cell.scene_dict(config, traffic))
    maps = {}
    real_build = pmm.build_photon_maps

    def build_maps(tables, meta, pmcfg, *args, **kwargs):
        built = real_build(tables, meta, pmcfg, *args, **kwargs)
        if pmcfg.global_seed == keep_maps:
            maps[keep_maps] = built
        return built

    images, frames = [], []
    samples, prof = None, None
    with mock.patch.object(pmm, "build_photon_maps", build_maps):
        # Warm-up: the same chunk and lane shapes at fewer samples a pixel.
        # render() returns a host array, so each call ends with the device.
        cfg = render_config(R, config, traffic, image_seed(traffic, 0))
        R.render(scene, 0, dataclasses.replace(cfg, sqrtspp=traffic["warmup_sqrtspp"]),
                 device=dev, stats={})
        maps.clear()
        setup_s = time.time() - process_start
        w0 = time.perf_counter()
        while True:
            stats = {}
            gs = image_seed(traffic, len(images))
            cfg = render_config(R, config, traffic, gs)
            a = time.perf_counter()
            img = R.render(scene, 0, cfg, device=dev, stats=stats)
            b = time.perf_counter()
            images.append({"wall": b - a, "stats": _numbers(stats)})
            frames.append((gs, img.reshape(-1, 3)[pixels]))
            if b - w0 >= seconds:
                break
        window_s = time.perf_counter() - w0
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if trace:
        samples = recorders.LaunchSamples()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        cfg = render_config(R, config, traffic, image_seed(traffic, 0))
        with samples.patches(), torch.profiler.profile(activities=acts) as p:
            a = time.perf_counter()
            R.render(scene, 0, cfg, device=dev, stats={})
            b = time.perf_counter()
        prof = devtrace.summarize(p, b - a)
    cam = scene.cameras[0]
    run = cell.Run(samples_per_image=cam.width * cam.height * traffic["sqrtspp"] ** 2,
                   images=images, window_s=window_s, setup_s=setup_s, peak_bytes=int(peak),
                   profile=prof)
    return run, frames, {gs: port_photon_maps(m) for gs, m in maps.items()}, samples


@dataclasses.dataclass
class Reference:
    """The reference's scene on the device: tables, clusters, intersect."""
    scene: object
    tables: object
    meta: object
    clusters: object
    intersect: object


def bf16_tables(tables):
    """The tables with every float stored in bfloat16 (and computed in their
    own dtype): the control's lower precision."""
    return type(tables)(*(x.to(torch.bfloat16).to(x.dtype) if x.is_floating_point() else x
                          for x in tables))


def reference(sd, dtype, device, control=False):
    rs = ref_loader.Scene(sd)
    tables = rs.tables(dtype, device)
    if control:
        tables = bf16_tables(tables)
    meta = rs.meta()
    v0, e1, e2 = (x.to(torch.float64).cpu().numpy() for x in
                  (tables.tri_v0, tables.tri_e1, tables.tri_e2))
    cl = closest_hit.build_clusters(v0, e1, e2, device)
    return Reference(rs, tables, meta, cl, closest_hit.make_intersect(tables, meta, cl))


def _pm_config(config, seed):
    pmj = config.get("photon_map") or {}
    return tracer.PMConfig(
        emissions=int(pmj.get("emissions", 100_000)),
        caustic_factor=float(pmj.get("caustic_factor", 1.0)),
        k_nearest_photons=int(pmj.get("k_nearest_photons", 50)),
        direct_visualization=bool(pmj.get("direct_visualization", False)),
        max_eye_bounces=config["max_bounces"], global_seed=seed)


def reference_maps(ref: Reference, config, global_seed):
    """The reference's own (caustic, global) photon maps of every emission
    under the scramble `global_seed`."""
    cfg = _pm_config(config, global_seed)
    li, ei, flux_pp = tracer.emission_plan(ref.scene.light_radiosity, ref.scene.light_area, cfg)
    return tracer.emit(ref.tables, ref.meta, cfg, ref.intersect, li, ei, flux_pp,
                       batch=EMIT_BATCH)


def reference_pixels(ref: Reference, config, traffic, seed, pixels, maps=None):
    """(P, 3) reference values of the sampled pixels. The photon mapper's eye
    pass reads the photon maps `maps` ((caustic, global) PhotonMaps)."""
    cam = ref.scene.cameras[0]
    spp = traffic["sqrtspp"] ** 2
    if _is_pm(config):
        return tracer.render_pixels_pm(ref.tables, ref.meta, cam, _pm_config(config, seed),
                                       maps[0], maps[1], ref.intersect, pixels, spp)
    cfg = tracer.PTConfig(max_bounces=config["max_bounces"], global_seed=seed)
    return tracer.render_pixels_pt(ref.tables, ref.meta, cam, cfg, ref.intersect, pixels, spp)


def reference_photons(ref: Reference, config, global_seed, seed, count):
    """The photons that a sample of the emissions, drawn from `seed`, store
    under the scramble `global_seed`: (caustic, global) PhotonMaps."""
    cfg = _pm_config(config, global_seed)
    li, ei, flux_pp = tracer.emission_plan(ref.scene.light_radiosity, ref.scene.light_area, cfg)
    sel = sample_emissions(seed, len(li), count)
    return tracer.emit(ref.tables, ref.meta, cfg, ref.intersect, li[sel], ei[sel], flux_pp)


def image_numbers(frames, ref_px):
    """The worst over the images of the share of the sampled pixels' total
    that they differ by (image_rel_l1), and of the sampled pixels that are
    off (pixels_off_share)."""
    l1, off = 0.0, 0.0
    total = max(float(np.abs(ref_px).sum()), 1e-30)
    for px in frames:
        diff = np.abs(px - ref_px)
        l1 = max(l1, float(diff.sum()) / total)
        bad = (diff > PIXEL_TOL * (np.abs(ref_px) + PIXEL_FLOOR)).any(axis=1)
        off = max(off, float(bad.mean()))
    return {"image_rel_l1": l1, "pixels_off_share": off}


def count_gap(ref_maps, port_maps):
    """The larger over the two maps of |photons the port stores - photons the
    reference stores| / photons the reference stores."""
    return max(abs(have.pos.shape[0] - want.pos.shape[0]) / max(want.pos.shape[0], 1)
               for want, have in zip(ref_maps, port_maps))


def missing_photons(ref_maps, port_maps):
    """(missing, stored): of the reference's stored photons, those that the
    port's map of the same kind does not hold (the nearest photon differs in
    position, direction or flux by more than PHOTON_TOL)."""
    from ..reference import knn

    missing, total = 0, 0
    for want, have in zip(ref_maps, port_maps):
        n = want.pos.shape[0]
        total += n
        if n == 0:
            continue
        if have.pos.shape[0] == 0:
            missing += n
            continue
        pos = have.pos.to(want.pos.dtype)
        _, idx, _ = knn.knn(pos, want.pos, 1)
        j = idx[:, 0].to(torch.int64)
        scale = 1.0 + want.pos.abs().amax(dim=1)
        ok = (((pos[j] - want.pos).abs().amax(dim=1) <= PHOTON_TOL * scale)
              & ((have.direction[j].to(want.pos.dtype) - want.direction).abs().amax(dim=1)
                 <= PHOTON_TOL)
              & ((have.flux[j].to(want.pos.dtype) - want.flux).abs().amax(dim=1)
                 <= PHOTON_TOL * (want.flux.abs().amax(dim=1) + 1e-30)))
        missing += int((~ok).sum())
    return missing, total


def check_numbers(ref: Reference, config, traffic, check, seed, pixels, frames, maps,
                  ref_maps_of=None):
    """Every number the cell compares, from the program's values of the
    sampled pixels `pixels` (`frames`: per image, its scramble and (P, 3)
    values) and, for the photon mapper, its (caustic, global) photon maps of
    the checked scramble (`maps`: {scramble: maps}); `seed` draws the
    emissions sampled. An image or map that the window never produced counts
    as infinitely far off. `ref_maps_of`, a dict, keeps the reference's maps
    by scramble across calls."""
    pm = _is_pm(config)
    nums = {"image_rel_l1": 0.0, "pixels_off_share": 0.0}
    scrambles = list(maps) if pm else list(dict.fromkeys(g for g, _ in frames))
    if pm:
        nums.update(photons_count_gap=0.0, photons_missing_share=0.0)
    if not scrambles or any(all(g != gs for g, _ in frames) for gs in scrambles):
        return {k: float("inf") for k in nums}
    for gs in scrambles:
        ref_maps = None
        if pm:
            kept = {} if ref_maps_of is None else ref_maps_of
            ref_maps = kept[gs] if gs in kept else reference_maps(ref, config, gs)
            kept[gs] = ref_maps
        ref_px = reference_pixels(ref, config, traffic, gs, pixels, ref_maps)
        got = image_numbers([px for g, px in frames if g == gs], ref_px)
        nums.update({k: max(nums[k], got[k]) for k in got})
        if pm:
            nums["photons_count_gap"] = max(nums["photons_count_gap"],
                                            count_gap(ref_maps, maps[gs]))
            sampled = reference_photons(ref, config, gs, seed, check["emissions"])
            missing, stored = missing_photons(sampled, maps[gs])
            nums["photons_missing_share"] = max(nums["photons_missing_share"],
                                                missing / max(stored, 1))
    return nums


def work(ref: Reference, samples: recorders.LaunchSamples):
    """{kernel: (launches kept, their summed least seconds)} from the launches
    kept in a profiled render."""
    out = {}
    if samples.traverse:
        least = sum(roofline.bound_s(*roofline.traversal_work(ref.clusters, o, d))[0]
                    for o, d in samples.traverse)
        out["traverse"] = (len(samples.traverse), least)
    if samples.knn:
        least = sum(roofline.bound_s(*roofline.knn_work(pos, pts, mask, k))[0]
                    for pos, pts, mask, k in samples.knn)
        out["knn"] = (len(samples.knn), least)
    return out


def _dtype(config):
    return {"float32": torch.float32, "float64": torch.float64}[config["dtype"]]


def _free(device):
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def run(config, traffic, check, seed, seconds, trace, device, process_start):
    """(Run, check numbers) of one run of a cell."""
    pixels = sample_pixels(seed, traffic["width"] * traffic["width"], check["pixels"])
    keep = checked_scramble(traffic, seed) if _is_pm(config) else None
    run_, frames, maps, samples = measure(config, traffic, seconds, trace, device,
                                          process_start, pixels, keep)
    _free(device)
    ref = reference(cell.scene_dict(config, traffic), _dtype(config), device)
    nums = check_numbers(ref, config, traffic, check, seed, pixels, frames, maps)
    if samples is not None:
        run_.work = work(ref, samples)
    return run_, nums


def readings(config, traffic, check, seeds, control_seeds, device, out):
    """The readings that the limits are set from, one JSON line each to `out`.
    The i-th of `seeds + control_seeds` reads the image that a run's i-th
    image renders, with the pixels and emissions that the seed draws. For
    each of `seeds`, the port renders it through render.render at the cell's
    own size (sound runs: the lower readings); for each of `control_seeds`,
    the reference computed with its tables stored in bfloat16 takes the
    port's place, its own photon maps included (the upper readings)."""
    R = importlib.import_module("mcrt_tpu_torch.render")
    pmm = importlib.import_module("mcrt_tpu_torch.integrator.photon_mapper")
    Scene = importlib.import_module("mcrt_tpu_torch.scene.loader").Scene
    sd = cell.scene_dict(config, traffic)
    scene = Scene(sd)
    ref = reference(sd, _dtype(config), device)
    ctl = reference(sd, _dtype(config), device, control=True) if control_seeds else None
    pm = _is_pm(config)
    kept, ref_maps_of = {}, {}
    real_build = pmm.build_photon_maps

    def build_maps(*a, **k):
        kept["maps"] = real_build(*a, **k)
        return kept["maps"]

    with mock.patch.object(pmm, "build_photon_maps", build_maps):
        for i, seed in enumerate(list(seeds) + list(control_seeds)):
            control = i >= len(seeds)
            gs = image_seed(traffic, i)
            pixels = sample_pixels(seed, traffic["width"] ** 2, check["pixels"])
            t0 = time.perf_counter()
            if not control:
                img = R.render(scene, 0, render_config(R, config, traffic, gs), device=device,
                               stats={})
                px = img.reshape(-1, 3)[pixels]
                maps = {gs: port_photon_maps(kept.pop("maps"))} if pm else {}
            else:
                maps = {gs: reference_maps(ctl, config, gs)} if pm else {}
                px = reference_pixels(ctl, config, traffic, gs, pixels, maps.get(gs))
            t1 = time.perf_counter()
            nums = check_numbers(ref, config, traffic, check, seed, pixels, [(gs, px)], maps,
                                 ref_maps_of)
            t2 = time.perf_counter()
            out.write(json.dumps({"seed": seed, "image_seed": gs,
                                  "reading": "control" if control else "program",
                                  "numbers": nums, "render_s": t1 - t0, "check_s": t2 - t1})
                      + "\n")
            out.flush()
            del maps
            _free(device)
