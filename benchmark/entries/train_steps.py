"""Entry: inverse rendering, train steps back to back through the port's
`parallel.sharding.train_step`.

The loop of a user who fits a scene's material tables to a target image by
gradient descent: render, take the L2 image loss, step the tables, repeat.
The configuration's "train" block gives the tables fitted ("params"), their
start (the scene's own values, as the reference's loader reads them, moved
by "start"), the update (plain SGD of step "lr", clamped to the tables'
valid ranges, on the device with no host read) and the target (the scene's
own tables rendered by `render.render` at "target_sqrtspp"^2 samples a
pixel under the scramble "target_seed", in set-up). The traffic gives the
image ("width"; "sqrtspp" is 1): every pixel's sample in one batch, the
differentiable trace's fixed trips each replayed from captured graphs on
the card.

Set-up ends with one warm-up step, which captures the trips' graphs; its
update is thrown away. Step k of the window then runs from the configured
start, at camera sample index k for every pixel, reads its loss once (as a
user's loop logs it) and ends with a synchronisation. Each step is one record
of `Run.images`: its wall and the step's own `stats` (its spans and
counters).

The check: the run's seed draws one step of the window, whose input tables,
loss, gradients and updated tables are kept; after the window the plain
reference (reference/train.py) recomputes that step's loss, gradients and
update from the same inputs. Compared (rows of materials without an ior,
-1, left out of the ior table):
- `loss_rel_gap`, |port - reference| / reference;
- `grad_rel_l2`, the worst over the tables of ||g_port - g_ref|| / ||g_ref||;
- `params_change_rel`, the worst over the tables of ||d_port - d_ref|| /
  ||d_ref||, where d_port is the step's updated tables less its input tables
  and d_ref the reference's update (reference/train.py `sgd`), stored in the
  tables' dtype, less them: a step that leaves the tables unchanged reads 1;
- `params_nonfinite`, the non-finite entries of the window's last tables;
- the target, which the port renders, against the reference's own render of
  `pixels` pixels drawn from the seed (`image_rel_l1`, `pixels_off_share`, as
  the render cells compare their images): both sides are held to it.

With --trace 1 one more step runs under torch.profiler; its profile also
holds the device's span, the first device activity's start to the last
one's end (`StepProfile`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import inspect
import json
import time
from unittest import mock

import numpy as np
import torch

from .. import cell, devtrace, roofline
from ..reference import loader as ref_loader
from ..reference import train as ref_train
from ..reference import tracer
from .render_images import _dtype, _numbers, image_numbers, sample_pixels

EVERY = 16   # the profiled step keeps the traversal launches of every EVERY-th replay


def start_params(truth, start):
    """The fitted tables moved off the scene's own values, inside their valid
    ranges: reflectance and transparency scaled, roughness and the
    dielectrics' ior shifted (a material without an ior keeps its -1)."""
    ior = truth["mat_ior"]
    return {"mat_reflectance": truth["mat_reflectance"] * start["reflectance_scale"],
            "mat_specular_roughness": truth["mat_specular_roughness"]
            + start["specular_roughness_shift"],
            "mat_ior": torch.where(ior > 1.0, ior + start["ior_shift"], ior),
            "mat_transparency": truth["mat_transparency"] * start["transparency_scale"]}


def sgd_update(params, grads, truth, lr):
    """One plain SGD step of size `lr`, clamped to the valid ranges; a material
    without an ior keeps its -1. Device ops only: no host read."""
    new = {k: v - lr * grads[k] for k, v in params.items()}
    ior = truth["mat_ior"]
    return {"mat_reflectance": new["mat_reflectance"].clamp(0.0, 1.0),
            "mat_specular_roughness": new["mat_specular_roughness"].clamp(1e-3, 1.0),
            "mat_ior": torch.where(ior > 1.0, new["mat_ior"].clamp(min=1.0), ior),
            "mat_transparency": new["mat_transparency"].clamp(0.0, 1.0)}


def checked_step(seed: int, steps: int) -> int:
    """The window's step that a run's check compares, drawn from its seed."""
    return int(np.random.default_rng([seed, 4]).integers(steps))


def truth_tables(ref_scene, names, dtype, device) -> dict:
    """The scene's own tables `names`, as the reference's loader reads them."""
    arrays = ref_scene.table_arrays()
    return {k: torch.as_tensor(np.asarray(arrays[k], np.float64), device=device).to(dtype)
            for k in names}


@dataclasses.dataclass
class StepProfile(devtrace.Profile):
    device_span_s: float = 0.0   # first device activity's start to the last one's end


def device_span_s(prof) -> float:
    """The span of the profile's device activities, in seconds (0 without any)."""
    from torch.autograd import DeviceType

    lo, hi = None, None
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            a = e.start_ns()
            lo = a if lo is None else min(lo, a)
            hi = a + e.duration_ns() if hi is None else max(hi, a + e.duration_ns())
    return 0.0 if lo is None else (hi - lo) * 1e-9


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


class TripSamples:
    """The traversal launches of a profiled train step, for the roofline
    counts. A trip's graphs are captured in set-up, so `capture()` wraps the
    traversal's entry while a trip is captured and keeps its calls' tensors,
    the graphs' static buffers, per graph (G_f, G_b); in `replays()`, after
    every EVERY-th replay of a graph its kept launches' rays are copied.
    Nothing else is changed, and nothing syncs the host."""

    def __init__(self):
        self.traverse = []      # (origin, direction) of the kept launches
        self._calls = {}        # id(trip) -> ([G_f's launches], [G_b's launches])
        self._graph = None      # the list of the graph being captured

    def capture(self):
        tk = importlib.import_module("mcrt_tpu_torch.ops.traverse_kernel")
        cg = importlib.import_module("mcrt_tpu_torch.utils.cuda_graph")
        rec = self
        real_trav = tk.traverse
        real_f, real_b = cg.GraphedTrip._forward_body, cg.GraphedTrip._backward_body

        def traverse(cbvh, origin, direction):
            out = real_trav(cbvh, origin, direction)
            if rec._graph is not None and torch.cuda.is_current_stream_capturing():
                rec._graph.append((origin, direction))
            return out

        def body(real, which):
            def call(trip):
                rec._graph = rec._calls.setdefault(id(trip), ([], []))[which]
                try:
                    return real(trip)
                finally:
                    rec._graph = None
            return call

        stack = contextlib.ExitStack()
        stack.enter_context(mock.patch.object(tk, "traverse", traverse))
        stack.enter_context(mock.patch.object(cg.GraphedTrip, "_forward_body", body(real_f, 0)))
        stack.enter_context(mock.patch.object(cg.GraphedTrip, "_backward_body", body(real_b, 1)))
        return stack

    def replays(self):
        cg = importlib.import_module("mcrt_tpu_torch.utils.cuda_graph")
        rec, real = self, cg.GraphedTrip._replay
        counts = {}

        def replay(trip, which):
            real(trip, which)
            key = (id(trip), which)
            counts[key] = counts.get(key, 0) + 1
            if counts[key] % EVERY == 0:
                for o, d in rec._calls.get(id(trip), ([], []))[which]:
                    rec.traverse.append((o.clone(), d.clone()))

        return mock.patch.object(cg.GraphedTrip, "_replay", replay)


class TrainLoop:
    """The port's train step on the cell's scene: tables, BVH, target, start."""

    def __init__(self, config, traffic, device):
        self.dev = dev = torch.device(device)
        R = importlib.import_module("mcrt_tpu_torch.render")
        PT = importlib.import_module("mcrt_tpu_torch.integrator.path_tracer")
        S = importlib.import_module("mcrt_tpu_torch.parallel.sharding")
        F = importlib.import_module("mcrt_tpu_torch.camera.film")
        Scene = importlib.import_module("mcrt_tpu_torch.scene.loader").Scene
        if traffic["sqrtspp"] != 1:
            raise ValueError("a train step traces one sample a pixel")
        self.config, self.traffic = config, traffic
        self.train = config["train"]
        self.sd = cell.scene_dict(config, traffic)
        scene = Scene(self.sd)
        cam = scene.cameras[0]
        dtype = _dtype(config)
        self.cfg = PT.PTConfig(max_bounces=config["max_bounces"])
        self.step = S.train_step(scene.meta(), self.cfg, cam,
                                 F.FilmConfig.from_json(cam.width, cam.height, cam.film),
                                 dtype, with_bvh=True, device=dev)
        if "stats" not in inspect.signature(self.step).parameters:
            raise TypeError("this program's train_step records no stats: the cell reads "
                            "its spans and counters")
        self.tables = scene.tables(dtype, dev)
        self.ref_scene = ref_loader.Scene(self.sd)
        self.cbvh = scene.build_cluster_bvh(np.dtype(config["dtype"]), dev)
        rcfg = R.RenderConfig(dtype=config["dtype"], max_bounces=config["max_bounces"],
                              global_seed=self.train["target_seed"],
                              sqrtspp=self.train["target_sqrtspp"],
                              integrator=config["integrator"])
        self.target = torch.as_tensor(R.render(scene, 0, rcfg, device=dev), dtype=dtype,
                                      device=dev)
        self.truth = truth_tables(self.ref_scene, self.train["params"], dtype, dev)
        self.start = start_params(self.truth, self.train["start"])
        lin = torch.arange(cam.width * cam.height, dtype=torch.int64, device=dev)
        self.px, self.py = lin % cam.width, lin // cam.width
        self.samples = lin.shape[0]

    def sample_index(self, k: int):
        """Step k's camera sample index, k, for every pixel."""
        return torch.full_like(self.px, k)

    def __call__(self, params, k: int, stats=None):
        """Step k from `params`: (loss, grads, the updated tables)."""
        loss, grads = self.step(self.tables, self.cbvh, params, self.px, self.py,
                                self.sample_index(k), self.target, stats=stats)
        return loss, grads, sgd_update(params, grads, self.truth, self.train["lr"])

    def close(self):
        """Release the trips' graphs and their pools."""
        self.step.graphs.clear()
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()


def measure(config, traffic, seconds, trace, device, process_start):
    """Set-up, the window and (trace) a profiled step. Returns (Run, the
    window's steps [(input tables, loss, gradients, updated tables)], the last
    tables, the TripSamples of the profiled step or None, the TrainLoop)."""
    samples = TripSamples() if trace else None
    with samples.capture() if trace else contextlib.nullcontext():
        s = TrainLoop(config, traffic, device)
        loss, _, _ = s(s.start, 0, stats={})
        float(loss)
        _sync(s.dev)
    setup_s = time.time() - process_start
    images, kept = [], []
    params = s.start
    w0 = time.perf_counter()
    while True:
        stats = {}
        a = time.perf_counter()
        loss, grads, new = s(params, len(images), stats=stats)
        loss_v = float(loss)
        _sync(s.dev)
        b = time.perf_counter()
        images.append({"wall": b - a, "stats": _numbers(stats), "loss": loss_v})
        kept.append((params, loss_v, grads, new))
        params = new
        if b - w0 >= seconds:
            break
    window_s = time.perf_counter() - w0
    peak = torch.cuda.max_memory_allocated(s.dev) if s.dev.type == "cuda" else 0
    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if s.dev.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with samples.replays(), torch.profiler.profile(activities=acts) as p:
            a = time.perf_counter()
            loss, _, _ = s(s.start, 0)
            float(loss)
            _sync(s.dev)
            b = time.perf_counter()
        prof = StepProfile(**vars(devtrace.summarize(p, b - a)), device_span_s=device_span_s(p))
    run = cell.Run(samples_per_image=s.samples, images=images, window_s=window_s,
                   setup_s=setup_s, peak_bytes=int(peak), profile=prof)
    return run, kept, params, samples, s


def _finite(x: float) -> float:
    return x if np.isfinite(x) else float("inf")


def grad_gap(got: dict, want: dict, ior_rows) -> float:
    """The worst over the tables of ||got - want|| / ||want|| (float64), the ior
    table over the rows `ior_rows` only. A table the program left out counts
    as infinitely far off."""
    worst = 0.0
    for k, w in want.items():
        if k not in got:
            return float("inf")
        g, w = got[k].detach().to(torch.float64).cpu(), w.detach().to(torch.float64).cpu()
        if k == "mat_ior":
            rows = ior_rows.cpu()
            g, w = g[rows], w[rows]
        den, num = float(torch.linalg.vector_norm(w)), float(torch.linalg.vector_norm(g - w))
        worst = max(worst, _finite(num / den) if den > 0 else (0.0 if num == 0 else float("inf")))
    return worst


def change(new: dict, params: dict) -> dict:
    """The tables' change, new - params, in float64."""
    return {k: v.detach().to(torch.float64) - params[k].detach().to(v.device, torch.float64)
            for k, v in new.items()}


def stored(new: dict, params: dict) -> dict:
    """The tables `new` as the tables `params` store them (their dtype)."""
    return {k: v.to(params[k].dtype) for k, v in new.items()}


def check_numbers(params, port, ref, ior_rows, lr, last_params) -> dict:
    """The numbers of one step that the cell compares (see the module's
    docstring). `port` is the step's (loss, gradients, updated tables) from
    the tables `params`, `ref` the reference's (loss, gradients)."""
    loss, grads, new = port
    ref_loss, ref_grads = float(ref[0]), ref[1]
    gap = abs(float(loss) - ref_loss) / ref_loss if ref_loss > 0 else float("inf")
    want = change(stored(ref_train.sgd(params, ref_grads, lr, ior_rows), params), params)
    nonfinite = sum(int((~torch.isfinite(v)).sum()) for v in last_params.values())
    return {"loss_rel_gap": _finite(gap), "grad_rel_l2": grad_gap(grads, ref_grads, ior_rows),
            "params_change_rel": grad_gap(change(new, params), want, ior_rows),
            "params_nonfinite": float(nonfinite)}


def reference(s: TrainLoop, control=False):
    return ref_train.TrainReference(s.sd, _dtype(s.config), s.dev, s.config["max_bounces"],
                                    s.cfg.global_seed, control=control, scene=s.ref_scene)


def target_pixels(ref, s: TrainLoop, pixels):
    """(P, 3) float64 values of the linear pixel ids `pixels` in the reference's
    own render of the target: its tables, the target's scramble and spp."""
    cfg = tracer.PTConfig(max_bounces=s.config["max_bounces"],
                          global_seed=s.train["target_seed"])
    return tracer.render_pixels_pt(ref.tables, ref.meta, ref.cam, cfg, ref.intersect, pixels,
                                   s.train["target_sqrtspp"] ** 2)


def port_target_pixels(s: TrainLoop, pixels):
    """(P, 3) float64 values of the linear pixel ids `pixels` in the port's target."""
    px = s.target.reshape(-1, 3)[torch.as_tensor(pixels, device=s.dev)]
    return px.to(torch.float64).cpu().numpy()


def target_numbers(ref, s: TrainLoop, seed: int, count: int) -> dict:
    """The port's target against the reference's render of `count` pixels drawn
    from `seed` (render_images.image_numbers)."""
    pixels = sample_pixels(seed, s.samples, count)
    return image_numbers([port_target_pixels(s, pixels)], target_pixels(ref, s, pixels))


def reference_step(ref, s: TrainLoop, params, k: int):
    """The reference's (loss, gradients) of step k from the tables `params`."""
    return ref.loss_and_grads(params, s.px, s.py, s.sample_index(k), s.target)


def work(ref, samples: TripSamples):
    """{"traverse": (launches kept, their summed least seconds)}."""
    if not samples.traverse:
        return {}
    least = sum(roofline.bound_s(*roofline.traversal_work(ref.clusters, o, d))[0]
                for o, d in samples.traverse)
    return {"traverse": (len(samples.traverse), least)}


def run(config, traffic, check, seed, seconds, trace, device, process_start):
    """(Run, check numbers) of one run of a cell."""
    run_, kept, last, samples, s = measure(config, traffic, seconds, trace, device,
                                           process_start)
    s.close()
    k = checked_step(seed, len(kept))
    params, loss, grads, new = kept[k]
    ref = reference(s)
    nums = check_numbers(params, (loss, grads, new), reference_step(ref, s, params, k),
                         s.truth["mat_ior"] > 0, s.train["lr"], last)
    nums.update(target_numbers(ref, s, seed, check["pixels"]))
    if samples is not None:
        run_.work = work(ref, samples)
    return run_, nums


def readings(config, traffic, check, seeds, control_seeds, device, out):
    """The readings that the limits are set from, one JSON line each to `out`.
    The port runs the window's steps from the start, as a run does; the i-th
    of `seeds` reads step i against the reference (sound runs: the lower
    readings), the i-th of `control_seeds` reads the reference computed with
    its tables stored in bfloat16, in the port's place, at step i's input
    tables, updated by the reference's own `sgd` (the upper readings). The
    target's numbers read the seed's pixels of the port's target (sound) and
    of the control's render (control) against the reference's render."""
    s = TrainLoop(config, traffic, device)
    ref = reference(s)
    ctl = reference(s, control=True) if control_seeds else None
    n = max(len(seeds), len(control_seeds))
    steps, params = [], s.start
    for k in range(n):
        t0 = time.perf_counter()
        loss, grads, new = s(params, k)
        loss_v = float(loss)
        _sync(s.dev)
        steps.append((params, loss_v, grads, new, time.perf_counter() - t0))
        params = new
    s.close()
    rows, lr = s.truth["mat_ior"] > 0, s.train["lr"]
    jobs = [(seed, k, False) for k, seed in enumerate(seeds)]
    jobs += [(seed, k, True) for k, seed in enumerate(control_seeds)]
    refs = {}
    for seed, k, control in jobs:
        params, loss_v, grads, new, step_s = steps[k]
        t0 = time.perf_counter()
        if k not in refs:
            refs[k] = reference_step(ref, s, params, k)
        pixels = sample_pixels(seed, s.samples, check["pixels"])
        want_px = target_pixels(ref, s, pixels)
        if control:
            loss_v, grads = reference_step(ctl, s, params, k)
            new = stored(ref_train.sgd(params, grads, lr, rows), params)
            got_px = target_pixels(ctl, s, pixels)
        else:
            got_px = port_target_pixels(s, pixels)
        t1 = time.perf_counter()
        nums = check_numbers(params, (loss_v, grads, new), refs[k], rows, lr, new)
        nums.update(image_numbers([got_px], want_px))
        out.write(json.dumps({"seed": seed, "step": k,
                              "reading": "control" if control else "program",
                              "numbers": nums, "step_s": step_s, "check_s": t1 - t0}) + "\n")
        out.flush()
