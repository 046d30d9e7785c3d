"""Wavefront path tracer: NEE + MIS + Russian roulette over a batch of ray lanes.

The port of the JAX package's path tracer (reference
source/integrator/path-tracer/path-tracer.cpp:14-51 and
source/integrator/integrator.cpp:31-129): a batch of rays advances one bounce
per loop iteration; every per-ray decision (event selection, NEE visibility,
RR) is a masked lane; two scene intersections per bounce (primary + shadow).

The forward bounce loops are Python `while`s whose condition reads one flag
from the device once per bounce (the JAX package's `lax.while_loop`);
`trace` and `trace_streamed` count those host synchronisations. Their forward
runs (`BatchTrace` for `trace`, `StreamedTrace` for `trace_streamed`)
capture the bounce step once as a CUDA graph on the card and replay it each
bounce, as the JAX package runs its chunk as one compiled program
(`jax.jit`); on the CPU they call the step eagerly. The
differentiable loops (`trace(differentiable=True)`,
`trace_streamed(fixed_trips=N)`) run a fixed number of trips with no host
sync (the JAX package's `lax.scan`), each trip rematerialised in the
backward pass (its `jax.checkpoint`): on the card every trip replays two
captured CUDA graphs, the trip and its recompute plus backward
(utils/cuda_graph.GraphedTrip), which the `graphs` dict a caller passes
keeps for its later calls of the same shapes; on the CPU each trip runs
under `torch.utils.checkpoint`. Gradients flow through the continuous
BSDF, pdf and throughput chain; the Sobol decisions are integer functions
of the path's indices, and the traversal is detached
(ops/cluster_bvh.make_intersect_fn).
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Callable, NamedTuple

import torch
import torch.utils.checkpoint

from ..camera import camera as cam_mod
from ..ops import intersect as isect
from ..sampling import sobol
from ..scene.loader import SceneMeta, SceneTables
from ..utils import cuda_graph
from ..utils.trace import span
from . import common
from .common import PARK_DIRECTION, PARK_DISTANCE


@dataclasses.dataclass(frozen=True)
class PTConfig:
    max_bounces: int = 64
    min_ray_depth: int = 3            # RR kicks in past this many diffuse bounces
    min_priority_ray_depth: int = 16  # ... or this many total bounces
    ior_stack_size: int = 8
    sky: bool = True                  # add the sky gradient on a miss
    global_seed: int = 0


def ray_offset_eps(dtype) -> float:
    """Shadow-acne offset. The reference uses 1e-9 with f64 (constants.hpp:9); f32
    needs a bigger nudge to survive rounding of position = o + t*d."""
    return 1e-9 if dtype == torch.float64 else 1e-4


def _sample_light_position(tables: SceneTables, light_idx, u, v):
    """Gather the light rows `light_idx`, then sample a position and normal on
    each (the photon mapper's emission; NEE gathers from the light pack)."""
    li = torch.clamp(light_idx, min=0).to(torch.int64)
    return common._sample_light_position_from(
        tables.light_kind[li].to(u.dtype), tables.light_p0[li],
        tables.light_p1[li], tables.light_p2[li], tables.light_normal[li], u, v)


def sky_color(direction):
    """Orange/blue gradient on miss (reference scene.cpp:219-223):
    orange * (1 - fy) + blue * fy, written per channel (the products by 0 and 1
    are exact), so no constant has to be uploaded inside the bounce loop."""
    dy = torch.clamp(direction[..., 1], -1.0, 1.0)
    fy = (1.0 + torch.arcsin(dy) / torch.pi) / 2.0
    return torch.stack([1.0 - fy, 0.5 * (1.0 - fy) + 0.5 * fy, fy], dim=-1)


def scene_bounds(tables: SceneTables, meta: SceneMeta):
    """Conservative scene AABB (lo (3,), hi (3,)) from the tables: every
    triangle's vertices, sphere's box and quadric's box."""
    pts = [tables.tri_v0, tables.tri_v0 + tables.tri_e1, tables.tri_v0 + tables.tri_e2]
    los = [p.amin(dim=0) for p in pts]
    his = [p.amax(dim=0) for p in pts]
    if meta.n_sphs:
        los.append((tables.sph_origin - tables.sph_radius[:, None]).amin(dim=0))
        his.append((tables.sph_origin + tables.sph_radius[:, None]).amax(dim=0))
    if meta.n_quads:
        los.append(tables.quad_bb_min.amin(dim=0))
        his.append(tables.quad_bb_max.amax(dim=0))
    return torch.stack(los).amin(dim=0), torch.stack(his).amax(dim=0)


class PathState(NamedTuple):
    bounce: torch.Tensor            # (R,) int32 — per lane (streamed lanes run paths at different depths)
    ray_count: torch.Tensor         # scalar int64: rays traced (primary + shadow)
    trav_steps: torch.Tensor        # (2,) int64: the primary intersects' Hit.steps, summed
    path_id: torch.Tensor           # (R,) int32 local path index
    next_path: torch.Tensor         # scalar int64: next unassigned path (streamed)
    start: torch.Tensor             # scalar int64: global index of local path 0 (streamed)
    out_rad: torch.Tensor           # finished radiance (streamed): (n_out + 1, 3), last row =
                                    # dump, or (G, L, 3) per generation and lane when strided
    pixel_index: torch.Tensor       # (R,) int64 holding uint32
    sample_index: torch.Tensor      # (R,) int64 holding uint32
    origin: torch.Tensor            # (R,3)
    direction: torch.Tensor         # (R,3)
    medium_ior: torch.Tensor        # (R,)
    refraction_scale: torch.Tensor  # (R,)
    ray_dirac: torch.Tensor         # (R,) bool — current ray spawned by dirac event
    ray_refraction: torch.Tensor    # (R,) bool — current ray is a refraction
    diffuse_depth: torch.Tensor     # (R,) int32
    refraction_level: torch.Tensor  # (R,) int32
    iors: torch.Tensor              # (R,K) RefractionHistory stack
    ior_count: torch.Tensor         # (R,) int32
    throughput: torch.Tensor        # (R,3)
    radiance: torch.Tensor          # (R,3)
    alive: torch.Tensor             # (R,) bool
    prev_light: torch.Tensor        # (R,) int32 global surf id of last NEE light (-1)
    prev_bsdf_pdf: torch.Tensor     # (R,)
    prev_select_prob: torch.Tensor  # (R,)


class RegenCfg(NamedTuple):
    """Path regeneration (persistent wavefront): a lane whose path dies writes
    its radiance out and loads another path, so lanes stay busy instead of
    idling until the batch drains. Two assignment modes, as in the JAX package:

    strided=False (dynamic): a dead lane pulls the globally next unassigned
    path, and its radiance is scatter-added into out_rad[path] (or its pixel's
    row with pixel_sums). The forward render's mode.

    strided=True (lane-strided): lane l owns paths l, l+L, l+2L, ...; path_id
    holds the lane's generation g, and radiance lands in out_rad[g, l] by a
    masked dense write, so no scatter runs, and out_rad.reshape(G*L, 3) is in
    path order. The differentiable fixed-trip mode's default."""
    cam: object              # CameraDef
    consts: object           # camera.CameraConsts on the render device
    width: int
    spp: int
    n_paths: int             # paths a chunk streams (its first is PathState.start)
    lanes: int
    strided: bool
    pixel_sums: bool         # accumulate per-pixel sums instead of per-path radiance (dynamic)
    fixed: bool              # a fixed-trip run, which autograd may differentiate: the dynamic
                             # scatter writes a new out_rad instead of the trip's input


def make_bounce_step(
    tables: SceneTables,
    meta: SceneMeta,
    cfg: PTConfig,
    intersect_fn: Callable,
    regen: RegenCfg | None = None,
    packs: common.ScenePacks | None = None,
):
    """Builds the single-bounce transition function over PathState.

    Each step adds the primary intersect's Hit.steps, where the intersect
    reports them, to PathState.trav_steps on the device (no host sync), and
    sets the returned function's `counted` to True. For the cluster BVH these
    are the traversal kernel's [candidates summed over blocks, most rounds of
    a block] of each launch (the Pallas kernel's stats), summed over bounces;
    the shadow intersect's are not counted.

    The step's `leaves` are the tensors it closes over: the tables, the packs
    (built here from the tables unless given), the camera's constants and the
    intersect's leaves; `rebind(leaves)` builds the same step over others of
    the same shapes, and `key` names the rest of what it depends on (as
    utils/cuda_graph.GraphedTrip asks). An intersect without `leaves` is
    read where it is, and keyed by its identity. The step's `capturable` is
    the intersect's (True when it has none): a step whose intersect reads
    the host cannot be captured, and the loops run it eagerly."""
    dtype = tables.tri_v0.dtype
    eps = ray_offset_eps(dtype)
    K = cfg.ior_stack_size
    if packs is None:
        packs = common.build_packs(tables, meta)

    def step(st: PathState) -> PathState:
        base_ctx = sobol.make_ctx(cfg.global_seed, st.pixel_index, st.sample_index, dtype)
        ctx = sobol.shuffled(base_ctx, st.bounce.to(torch.int64) + 1)
        R = st.origin.shape[0]

        hit = intersect_fn(st.origin, st.direction)
        ray_count = st.ray_count + st.alive.sum()
        trav_steps = st.trav_steps
        if hit.steps is not None:
            this().counted = True
            trav_steps = trav_steps + hit.steps
        missed = hit.surf_id < 0
        radiance = st.radiance
        if cfg.sky:   # sky gradient on miss
            radiance = radiance + torch.where(
                (st.alive & missed)[:, None], st.throughput * sky_color(st.direction),
                torch.zeros_like(st.radiance))
        alive = st.alive & ~missed

        ix = common.interaction_setup(
            tables, meta, st.origin, st.direction, hit,
            st.iors, st.ior_count, st.refraction_level, st.medium_ior,
            packs=packs,
        )

        # ---- sampleEmissive (integrator.cpp:93-110) ----
        radiance = radiance + st.throughput * common.sample_emissive(
            ix, st.direction, st.bounce, st.ray_dirac, st.prev_light,
            st.prev_bsdf_pdf, st.prev_select_prob, hit.surf_id, alive,
        )

        # ---- sampleDirect / NEE (integrator.cpp:31-87) ----
        if meta.has_lights:
            nee, prev_light, prev_select_prob, shadow_rays = common.sample_direct(
                tables, ix, ctx, intersect_fn, eps, alive, packs=packs
            )
            radiance = radiance + st.throughput * nee
            ray_count = ray_count + shadow_rays
        else:
            prev_light = torch.full((R,), -1, dtype=torch.int32, device=st.origin.device)
            prev_select_prob = torch.ones((R,), dtype=dtype, device=st.origin.device)

        # ---- event selection + new ray + BSDF throughput ----
        b = common.bsdf_bounce(ix, st.direction, ctx, eps, flux=False)
        diffuse_depth = st.diffuse_depth + b.is_diffuse.to(torch.int32)
        new_refr_scale = st.refraction_scale * b.refr_scale_mult
        throughput = st.throughput * b.weight
        alive = alive & b.valid

        # ---- Russian roulette (integrator.cpp:112-129); new ray depth = bounce+1 ----
        u_abs = sobol.sample(ctx, 6)
        survive = throughput.amax(dim=-1) * new_refr_scale
        new_depth = st.bounce + 1
        apply_rr = (diffuse_depth > cfg.min_ray_depth) | (new_depth > cfg.min_priority_ray_depth)
        survive_c = torch.clamp(survive, max=0.95)
        rr_kill = apply_rr & (survive_c <= u_abs)
        rr_boost = apply_rr & ~rr_kill
        rr_div = torch.where(rr_boost, survive_c, torch.ones_like(survive_c))
        throughput = torch.where(rr_boost[:, None], throughput / rr_div[:, None], throughput)
        alive = alive & (survive > 0.0) & ~rr_kill

        # ---- RefractionHistory update (ray.cpp:80-98) with the new ray ----
        iors, ior_count, new_level = common.update_ior_stack(
            st.iors, st.ior_count, st.refraction_level, b.level_delta, b.new_medium, K
        )

        bounce = st.bounce + 1
        pixel_index = st.pixel_index
        sample_index = st.sample_index
        path_id = st.path_id
        next_path = st.next_path
        out_rad = st.out_rad
        medium_ior = b.new_medium
        ray_dirac = b.dirac_next
        ray_refraction = b.did_refract

        if regen is not None:
            # Lanes at the depth cap die here so their radiance is finalized.
            alive = alive & (bounce < cfg.max_bounces)
            died_now = st.alive & ~alive
            if regen.strided:
                # 1. finalize: masked dense write into this lane's own row of
                # its generation (path = g * L + lane).
                out_rad = out_rad + torch.where(
                    _generation_rows(out_rad, died_now, path_id), radiance, 0.0)
                # 2. reload: the lane's own next stride.
                next_id = path_id + 1
                new_local = next_id.to(torch.int64) * regen.lanes + torch.arange(
                    regen.lanes, dtype=torch.int64, device=path_id.device)
                has_new = died_now & (new_local < regen.n_paths)
            else:
                # 1. finalize: add dead paths' radiance to their row (the path's,
                # or its pixel's with pixel_sums); live lanes add zero to the dump row.
                dump = out_rad.shape[0] - 1
                tgt = torch.div(path_id, regen.spp, rounding_mode="floor") if regen.pixel_sums else path_id
                slot = torch.where(died_now, tgt, torch.full_like(tgt, dump)).to(torch.int64)
                add = torch.where(died_now[:, None], radiance, torch.zeros_like(radiance))
                if regen.fixed:
                    # Out of place: a checkpointed trip recomputes from its input.
                    out_rad = out_rad.index_add(0, slot, add)
                else:
                    # In place: the previous state is never read again.
                    out_rad.index_add_(0, slot, add)
                # 2. reload: dead lanes pull the next unassigned paths in lane order.
                died_i = died_now.to(torch.int64)
                rank = torch.cumsum(died_i, 0) - died_i
                new_local = next_path + rank
                has_new = died_now & (new_local < regen.n_paths)
                next_path = next_path + died_i.sum()
                next_id = new_local.to(torch.int32)
            lin = st.start + torch.clamp(new_local, max=regen.n_paths - 1)
            pix = torch.div(lin, regen.spp, rounding_mode="floor")
            fresh = cam_mod.generate_rays(
                regen.cam, pix % regen.width, torch.div(pix, regen.width, rounding_mode="floor"),
                lin % regen.spp, cfg.global_seed, dtype, consts=regen.consts,
            )
            sel = has_new[:, None]
            alive = alive | has_new
            new_origin = torch.where(sel, fresh.origin,
                                     torch.where(alive[:, None], b.new_origin, PARK_DISTANCE))
            new_dir = torch.where(sel, fresh.direction,
                                  torch.where(alive[:, None], b.new_dir, PARK_DIRECTION))
            scene_ior = tables.ior.to(dtype)
            zi = torch.zeros_like(bounce)
            bounce = torch.where(has_new, zi, bounce)
            pixel_index = torch.where(has_new, fresh.pixel_index, pixel_index)
            sample_index = torch.where(has_new, fresh.sample_index, sample_index)
            path_id = torch.where(has_new, next_id, path_id)
            medium_ior = torch.where(has_new, scene_ior, medium_ior)
            new_refr_scale = torch.where(has_new, torch.ones_like(new_refr_scale), new_refr_scale)
            ray_dirac = ray_dirac & ~has_new
            ray_refraction = ray_refraction & ~has_new
            diffuse_depth = torch.where(has_new, zi, diffuse_depth)
            new_level = torch.where(has_new, zi, new_level)
            iors = torch.where(sel, scene_ior, iors)
            ior_count = torch.where(has_new, zi + 1, ior_count)
            throughput = torch.where(sel, torch.ones_like(throughput), throughput)
            radiance = torch.where(sel, torch.zeros_like(radiance), radiance)
            prev_light = torch.where(has_new, zi - 1, prev_light)
            b_pdf = torch.where(has_new, torch.zeros_like(b.pdf), b.pdf)
            prev_select_prob = torch.where(has_new, torch.ones_like(prev_select_prob), prev_select_prob)
        else:
            new_origin = torch.where(alive[:, None], b.new_origin, PARK_DISTANCE)
            new_dir = torch.where(alive[:, None], b.new_dir, PARK_DIRECTION)
            b_pdf = b.pdf

        return PathState(
            bounce=bounce,
            ray_count=ray_count,
            trav_steps=trav_steps,
            path_id=path_id,
            next_path=next_path,
            start=st.start,
            out_rad=out_rad,
            pixel_index=pixel_index,
            sample_index=sample_index,
            origin=new_origin,
            direction=new_dir,
            medium_ior=medium_ior,
            refraction_scale=new_refr_scale,
            ray_dirac=ray_dirac,
            ray_refraction=ray_refraction,
            diffuse_depth=diffuse_depth,
            refraction_level=new_level,
            iors=iors,
            ior_count=ior_count,
            throughput=throughput,
            radiance=radiance,
            alive=alive,
            prev_light=prev_light,
            prev_bsdf_pdf=b_pdf,
            prev_select_prob=prev_select_prob,
        )

    # The step reaches itself through a weak reference: a closure over `step`
    # would be a reference cycle, which keeps its tables and packs on the card
    # after the render that made it returns, until a full garbage collection.
    this = weakref.ref(step)
    step.counted = False
    step.capturable = getattr(intersect_fn, "capturable", True)
    bound = hasattr(intersect_fn, "leaves")
    step.leaves = (tables, packs, None if regen is None else regen.consts,
                   intersect_fn.leaves if bound else None)

    def rebind(leaves):
        t, p, consts, isect_leaves = leaves
        return make_bounce_step(
            t, meta, cfg, intersect_fn.rebind(isect_leaves) if bound else intersect_fn,
            None if regen is None else regen._replace(consts=consts), packs=p)

    step.rebind = rebind
    step.key = (meta, cfg, None if regen is None else _regen_key(regen),
                intersect_fn.key if bound else intersect_fn)
    return step


def _regen_key(regen: RegenCfg):
    """RegenCfg's fields but its tensors; the camera by identity (a trip
    built from it keeps it alive, so the identity is not reused)."""
    return (id(regen.cam),) + tuple(regen._replace(cam=None, consts=None))


def _init_state(tables, cfg, origin, direction, pixel_index, sample_index, alive,
                path_id, next_path, start, out_rad) -> PathState:
    dtype = origin.dtype
    L = origin.shape[0]
    dev = origin.device
    f0 = torch.zeros((L,), dtype=dtype, device=dev)
    i0 = torch.zeros((L,), dtype=torch.int32, device=dev)
    scene_ior = tables.ior.to(dtype)
    return PathState(
        bounce=i0,
        ray_count=torch.zeros((), dtype=torch.int64, device=dev),
        trav_steps=torch.zeros((2,), dtype=torch.int64, device=dev),
        path_id=path_id,
        next_path=next_path,
        start=start,
        out_rad=out_rad,
        pixel_index=pixel_index,
        sample_index=sample_index,
        origin=origin,
        direction=direction,
        medium_ior=f0 + scene_ior,
        refraction_scale=f0 + 1.0,
        ray_dirac=i0 != 0,
        ray_refraction=i0 != 0,
        diffuse_depth=i0,
        refraction_level=i0,
        iors=(f0 + scene_ior)[:, None].expand(L, cfg.ior_stack_size).contiguous(),
        ior_count=i0 + 1,
        throughput=torch.ones((L, 3), dtype=dtype, device=dev),
        radiance=torch.zeros((L, 3), dtype=dtype, device=dev),
        alive=alive,
        prev_light=i0 - 1,
        prev_bsdf_pdf=f0,
        prev_select_prob=f0 + 1.0,
    )


def _generation_rows(out_rad, lanes_mask, path_id):
    """(G, L, 1) bool: row g of lane l where lanes_mask[l] and the lane is on
    generation g (path_id holds g in lane-strided mode)."""
    gen = torch.arange(out_rad.shape[0], dtype=path_id.dtype, device=path_id.device)
    return (lanes_mask[None, :] & (gen[:, None] == path_id[None, :]))[..., None]


def _checkpointed(step):
    """`step` under torch.utils.checkpoint: the backward pass keeps only each
    trip's PathState and runs the trip again to rebuild its internals (the
    traversal, the BSDF evaluations, NEE). Non-reentrant, so gradients also
    reach the tensors `step` closes over (the packs built from the
    parameters). The step draws nothing from torch's generators (Sobol is
    integer hashing), so no RNG state is kept; reading the card's would sync."""
    return lambda st: torch.utils.checkpoint.checkpoint(
        step, st, use_reentrant=False, preserve_rng_state=False)


def _graph_trips(device) -> bool:
    """Whether rematerialised trips on `device` replay captured graphs: on
    the card they do, for a step that is capturable (_run_trips asks)."""
    return device.type == "cuda"


def _run_trips(step, st, trips: int, remat: bool, graphs: dict | None = None):
    """`trips` steps with no host sync, each rematerialised when `remat`:
    on the card through a GraphedTrip, found in `graphs` by its key or
    captured and kept there (None: kept for this call alone); elsewhere,
    without remat, and for a step that is not capturable (its intersect
    reads the host: best-first), eagerly, each trip under
    torch.utils.checkpoint when `remat`."""
    if remat and trips and _graph_trips(st.origin.device) and getattr(step, "capturable", True):
        graphs = {} if graphs is None else graphs
        key = cuda_graph.GraphedTrip.key(step, st)
        if key not in graphs:
            graphs[key] = cuda_graph.GraphedTrip(step, st)
        trip = graphs[key]
        st = trip.run(step, st, trips)
        step.counted = trip.step.counted
        return st
    body = _checkpointed(step) if remat else step
    for _ in range(trips):
        st = body(st)
    return st


def trace(
    tables: SceneTables,
    meta: SceneMeta,
    cfg: PTConfig,
    origin,
    direction,
    pixel_index,
    sample_index,
    intersect_fn: Callable | None = None,
    return_stats: bool = False,
    differentiable: bool = False,
    remat: bool = True,
    graphs: dict | None = None,
):
    """Trace a batch of camera rays to radiance. Returns (R,3) radiance
    (and {"rays": count, "bounce_steps": steps run} with return_stats, plus
    "traversal_steps", the primary intersects' Hit.steps summed, when the
    intersect reported them: untouched zeros never pass for a count).

    The default loop stops when every lane died or the slowest reached
    max_bounces, with one host sync per bounce, through a BatchTrace: on the
    card its first bounce runs eagerly, the second captures the step as a
    CUDA graph and every later bounce is one replay. The run is found in
    `graphs` by its key (BatchTrace.key: the batch size and what the step
    depends on) or made and kept there, so later calls of the same shapes
    only copy their tables in and replay; without `graphs` it serves this
    call alone and is closed before the return. `differentiable=True` runs
    exactly cfg.max_bounces steps and never syncs, so autograd can reverse it
    (dead lanes are parked and carry their radiance unchanged); `remat` then
    checkpoints every step, so the backward pass stores one PathState per
    bounce and recomputes the rest; on the card each step replays captured
    graphs, kept in `graphs` for later calls of the same shapes (see
    _run_trips). An intersect that is not capturable (best-first)
    runs every step eagerly, on the card too."""
    if intersect_fn is None:
        intersect_fn = isect.make_brute_fn(tables, meta)
    step = make_bounce_step(tables, meta, cfg, intersect_fn)
    R = origin.shape[0]
    dev = origin.device
    st = _init_state(
        tables, cfg, origin, direction, sobol.as_u32(pixel_index, dev),
        sobol.as_u32(sample_index, dev), torch.ones((R,), dtype=torch.bool, device=dev),
        torch.arange(R, dtype=torch.int32, device=dev),
        torch.full((), R, dtype=torch.int64, device=dev),
        torch.zeros((), dtype=torch.int64, device=dev),
        torch.zeros((1, 3), dtype=origin.dtype, device=dev))
    if differentiable:
        st = _run_trips(step, st, cfg.max_bounces, remat, graphs)
        radiance, rays, trav_steps = st.radiance, st.ray_count, st.trav_steps
        steps, counted = cfg.max_bounces, step.counted
    else:
        runs = {} if graphs is None else graphs
        key = BatchTrace.key(step, st)
        if key not in runs:
            runs[key] = BatchTrace(step, cfg.max_bounces)
        try:
            radiance, rays, trav_steps, steps, counted = runs[key](step, st)
        finally:
            if graphs is None:
                runs[key].close()
    if return_stats:
        stats = {"rays": rays, "bounce_steps": steps}
        if counted:
            stats["traversal_steps"] = trav_steps
        return radiance, stats
    return radiance


class BatchTrace(cuda_graph.GraphedLoop):
    """The batch loop of trace(differentiable=False) for batches of one size:
    the counterpart of the JAX package's `lax.while_loop`, which its chunk
    compiles whole (`jax.jit`).

    The bounce step (make_bounce_step, no regeneration) is rebuilt over
    static copies of its `leaves` (the tables, the packs, the intersect's
    tables, BVH and geometry pack), since a caller builds a new step, and new
    tensors, for every batch. Calling the run with a call's step (built like
    the run's: the same key) and start state copies the step's leaves into
    the static ones and the state into the static buffers, then advances one
    bounce at a time (utils/cuda_graph.GraphedLoop): on the card the first
    bounce runs eagerly, the second captures the step as a CUDA graph, and
    every later bounce, of this batch and the later ones, is one replay; a
    capture that fails raises. On the CPU, and on the card for a step that
    is not capturable, every bounce calls the step, over the same static
    leaves. The loop runs while any lane is alive and the slowest lane is
    below max_bounces, the JAX package's condition, read once a bounce. Returns (radiance, rays traced, the primary intersects'
    Hit.steps summed, bounce steps, whether the intersect reported them),
    the tensors copies: the next batch reuses the buffers."""

    def __init__(self, step, max_bounces: int):
        tensors, pattern, spec = cuda_graph._distinct_tensors(step.leaves)
        self.leaves = [t.detach().clone() for t in tensors]
        self.max_bounces = max_bounces
        self.bounce_step = step.rebind(cuda_graph.rebuild_tree(pattern, spec, self.leaves))
        super().__init__(self.bounce_step)

    @staticmethod
    def key(step, state):
        """What a run depends on beyond the values of its inputs: the batch
        size and dtypes, the step's shapes and configuration."""
        return ("batch",) + cuda_graph.GraphedTrip.key(step, state)

    def running(self, state):
        return state.alive.any() & (state.bounce.min() < self.max_bounces)

    def __call__(self, step, state: PathState):
        with span("loop.load"):
            with torch.no_grad():
                for s, t in zip(self.leaves, cuda_graph._distinct_tensors(step.leaves)[0]):
                    s.copy_(t)
            self.load(state)
        steps = self.drain()
        st = self.state
        # `counted` is set by the step's Python, which on the card runs only
        # in the eager first bounce and the capture.
        return (st.radiance.clone(), st.ray_count.clone(), st.trav_steps.clone(), steps,
                steps > 0 and self.bounce_step.counted)


class StreamedTrace(cuda_graph.GraphedLoop):
    """Streamed traces of chunks of `n_paths` camera paths through `lanes`
    lanes: the bounce step is built once and serves every chunk of that size,
    since a chunk's first path rides in the state (PathState.start, a device
    scalar) and not in the step (the JAX package passes its chunk's `start` as
    a traced scalar for the same reason). A chunk of another size needs its
    own. Arguments as trace_streamed's; `fixed` marks a fixed-trip run.

    Calling it with a chunk's first path runs the forward trace of that chunk
    to the end, one host sync per bounce, and returns trace_streamed's results.
    On a CUDA device the first bounce runs eagerly (it builds the kernels and
    settles the allocator) and leaves its result in the static state buffers;
    the second captures one bounce step over those buffers as a CUDA graph
    (utils/cuda_graph.GraphedLoop, CapturedStep); from then on, in this chunk
    and the later ones, a bounce is one replay. A capture that fails raises. On
    the CPU, and on the card when the intersect is not capturable
    (best-first: `graphed` is then False), every bounce calls the step
    eagerly. `close()` releases the graph and its pool.

    begin(start) and advance() are the same run one bounce at a time, and
    `state` is the state after the last bounce (on the card, the static
    buffers); initial(start), `step` and output(state) are the pieces of an
    eager loop."""

    def __init__(self, tables: SceneTables, meta: SceneMeta, cfg: PTConfig, cam, spp: int,
                 n_paths: int, lanes: int, intersect_fn: Callable | None = None,
                 pixel_sums: bool = False, strided: bool = False, fixed: bool = False):
        if pixel_sums and (strided or n_paths % spp):
            raise ValueError("pixel_sums needs the dynamic mode and an spp-aligned path count")
        self.tables, self.cfg, self.cam = tables, cfg, cam
        dtype = tables.tri_v0.dtype
        if intersect_fn is None:
            intersect_fn = isect.make_brute_fn(tables, meta)
        self.regen = RegenCfg(cam=cam, consts=cam_mod.camera_consts(cam, dtype, tables.tri_v0.device),
                              width=cam.width, spp=spp, n_paths=n_paths, lanes=lanes,
                              strided=strided, pixel_sums=pixel_sums, fixed=fixed)
        super().__init__(make_bounce_step(tables, meta, cfg, intersect_fn, regen=self.regen))
        self.n_out = (n_paths // spp) if pixel_sums else n_paths

    def initial(self, start: int) -> PathState:
        """A new PathState for the chunk whose first path is `start`: the
        first `lanes` paths loaded, the output buffer zero."""
        r = self.regen
        dtype, dev = self.tables.tri_v0.dtype, self.tables.tri_v0.device
        L, spp, cam = r.lanes, r.spp, self.cam
        local0 = torch.arange(L, dtype=torch.int64, device=dev)
        live0 = local0 < r.n_paths
        lin0 = int(start) + torch.clamp(local0, max=r.n_paths - 1)
        pix0 = torch.div(lin0, spp, rounding_mode="floor")
        first = cam_mod.generate_rays(
            cam, pix0 % cam.width, torch.div(pix0, cam.width, rounding_mode="floor"),
            lin0 % spp, self.cfg.global_seed, dtype, consts=r.consts,
        )
        G = -(-r.n_paths // L)
        return _init_state(
            self.tables, self.cfg, torch.where(live0[:, None], first.origin, PARK_DISTANCE),
            first.direction, first.pixel_index, first.sample_index, live0,
            torch.zeros_like(local0, dtype=torch.int32) if r.strided else local0.to(torch.int32),
            torch.full((), min(L, r.n_paths), dtype=torch.int64, device=dev),
            torch.full((), int(start), dtype=torch.int64, device=dev),
            torch.zeros((G, L, 3) if r.strided else (self.n_out + 1, 3), dtype=dtype, device=dev))

    def output(self, st: PathState):
        """(radiance, rays traced) of a chunk's final state, the lanes still
        alive flushed into the radiance (none after a drained run)."""
        r = self.regen
        if r.strided:
            out = st.out_rad + torch.where(
                _generation_rows(st.out_rad, st.alive, st.path_id), st.radiance, 0.0)
            return out.reshape(-1, 3)[:r.n_paths], st.ray_count
        if not r.fixed:
            return st.out_rad[:self.n_out], st.ray_count
        tgt = torch.div(st.path_id, r.spp, rounding_mode="floor") if r.pixel_sums else st.path_id
        slot = torch.where(st.alive, tgt, torch.full_like(tgt, self.n_out)).to(torch.int64)
        out = st.out_rad.index_add(
            0, slot, torch.where(st.alive[:, None], st.radiance, torch.zeros_like(st.radiance)))
        return out[:self.n_out], st.ray_count

    def begin(self, start: int):
        """Load the chunk whose first path is `start` (on the card, into the
        static buffers, which the first chunk allocates)."""
        with span("loop.load"):
            self.load(self.initial(start))

    def __call__(self, start: int, stats: dict | None = None):
        self.begin(start)
        steps = self.drain()
        if stats is not None:
            stats["bounce_steps"] = stats.get("bounce_steps", 0) + steps
        out, rays = self.output(self.state)
        return out.clone(), rays.clone()   # the next chunk reuses the buffers


def trace_streamed(
    tables: SceneTables,
    meta: SceneMeta,
    cfg: PTConfig,
    cam,
    spp: int,
    start: int,
    n_paths: int,
    lanes: int,
    intersect_fn: Callable | None = None,
    pixel_sums: bool = False,
    stats: dict | None = None,
    fixed_trips: int | None = None,
    remat: bool = True,
    strided: bool | None = None,
    graphs: dict | None = None,
):
    """Persistent-wavefront trace: `lanes` lanes stream `n_paths` camera paths
    (global indices [start, start+n_paths), pixel-major x sample-minor as in
    render()). A lane whose path terminates adds its radiance to the output
    buffer and loads another path (see RegenCfg for the two modes).

    fixed_trips: None (the forward render) runs until every path drained, one
    host sync per bounce, through a one-shot StreamedTrace (on the card, a
    captured bounce step, unless the intersect is not capturable). An int
    runs exactly that many steps with no host sync, which autograd can
    reverse: the differentiable wavefront, each trip
    rematerialised when `remat` (on the card, replayed graphs kept in
    `graphs`; see _run_trips). Paths still in flight when the trips
    run out add their partial radiance (truncation, as at max_bounces); paths
    never started add nothing. strided: the assignment mode, by default
    lane-strided exactly when fixed_trips is given; pixel_sums needs the
    dynamic mode.

    Returns (radiance, rays traced): radiance is (n_paths, 3) per path, or
    (n_paths // spp, 3) per-pixel sums with pixel_sums. If `stats` is a dict,
    the steps run are added to its "bounce_steps" (host syncs of a draining
    run; a fixed-trip run syncs never)."""
    if strided is None:
        strided = fixed_trips is not None
    run = StreamedTrace(tables, meta, cfg, cam, spp, n_paths, lanes, intersect_fn=intersect_fn,
                        pixel_sums=pixel_sums, strided=strided, fixed=fixed_trips is not None)
    if fixed_trips is None:
        try:
            return run(start, stats)
        finally:
            run.close()
    st = _run_trips(run.step, run.initial(start), fixed_trips, remat, graphs)
    if stats is not None:
        stats["bounce_steps"] = stats.get("bounce_steps", 0) + fixed_trips
    return run.output(st)
