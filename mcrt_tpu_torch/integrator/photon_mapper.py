"""Two-pass photon mapper: emission pass + grid k-NN radiance estimates.

The port of the JAX package's integrator/photon_mapper.py (reference
source/integrator/photon-mapper/photon-mapper.cpp):

* Pass 1 (photon tracing, photon-mapper.cpp:24-277): emissions stream through
  a pool of lanes; a lane whose photon dies (constant-flux Russian roulette,
  no depth cap) loads the next emission. Stores go into a caustic and a global
  buffer; caustic photons are stored when the incoming ray was dirac-spawned,
  global photons with 1/caustic_factor rejection (:244-255). A chunk whose
  stores overflow a buffer is run again with a larger one: each photon path is
  fixed by its (light, emission) ids, so the set of photons does not change.
* The maps are uniform photon grids (accel/photon_grid), searched by the
  exact staged k-NN (accel/knn_kernel: one ring, widening rings, the whole
  map), on the card with no fallback and no host sync.
* Pass 2 (sampleRay, :279-341): a masked wavefront follows specular chains;
  the caustic estimate is taken at every non-dirac interaction, the global
  estimate one diffuse bounce later unless `direct_visualization`. Estimates
  follow :343-391: global = sum(flux * f |cos| / pdf) / (pi r_k^2), caustic
  cone-filtered with w_p = 1 - d / r_k and 3 / (pi r_k^2).

The JAX package's `while_loop`s are Python loops that read one flag from the
device per step; `stats` counts the steps. Its compiled chunks (`run_chunk`,
the jitted streamed and batch eye passes) are `_EmissionRun`,
`StreamedEyePass` and `BatchEyePass`: one step built per shape, whose
chunk-dependent inputs ride in the state, so on the card it is captured once
as a CUDA graph and replayed for every later step of every chunk
(utils/cuda_graph.GraphedLoop), unless the intersect is not capturable (the
best-first traversal, which float64 tables take on the card): then
every step runs eagerly.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..accel import photon_grid as pgrid
from ..camera import camera as cam_mod
from ..materials import bsdf
from ..ops import geometry as g
from ..ops import intersect as isect
from ..sampling import sobol
from ..scene.loader import SceneMeta, SceneTables
from ..utils import cuda_graph
from ..utils.trace import span
from . import common
from .common import PARK_DIRECTION, PARK_DISTANCE
from .path_tracer import _sample_light_position, ray_offset_eps

# Rows of each store buffer per emission of a chunk. Stores average well under
# one per emission; a chunk that stores more is run again with larger buffers.
STORE_MARGIN = 4
# Emissions a chunk holds at most (the JAX package's ECH): a chunk's emission
# tables ride in the state in buffers of this many rows, so one step serves
# every chunk.
CHUNK_EMISSIONS = 1 << 20


@dataclasses.dataclass(frozen=True)
class PMConfig:
    emissions: int = 100_000
    caustic_factor: float = 1.0
    k_nearest_photons: int = 50
    direct_visualization: bool = False
    max_eye_bounces: int = 64
    min_ray_depth: int = 3
    min_priority_ray_depth: int = 16
    ior_stack_size: int = 8
    global_seed: int = 0
    emission_chunk: int = 1 << 16

    @staticmethod
    def from_json(j: dict | None, **over) -> "PMConfig":
        j = j or {}
        kw = dict(
            emissions=int(j.get("emissions", 100_000)),
            caustic_factor=float(j.get("caustic_factor", 1.0)),
            k_nearest_photons=int(j.get("k_nearest_photons", 50)),
            direct_visualization=bool(j.get("direct_visualization", False)),
        )
        kw.update(over)
        return PMConfig(**kw)


class PhotonMaps(NamedTuple):
    caustic: pgrid.PhotonGrid
    global_: pgrid.PhotonGrid


# ----------------------------------------------------------------------------------
# Pass 1: emission
# ----------------------------------------------------------------------------------

class _EmitStream(NamedTuple):
    """Regenerating-emission state: lane photon state and identity, the
    chunk's emission tables, and the store buffers. Each buffer has CAP rows
    plus one dump row that takes the writes of lanes that store nothing (and
    of stores past CAP)."""
    origin: torch.Tensor
    direction: torch.Tensor
    flux: torch.Tensor
    medium_ior: torch.Tensor
    refraction_level: torch.Tensor
    iors: torch.Tensor
    ior_count: torch.Tensor
    ray_dirac: torch.Tensor
    alive: torch.Tensor
    bounce: torch.Tensor      # (L,) int32 per-lane bounce
    lane_light: torch.Tensor  # (L,) int64 light id
    lane_emis: torch.Tensor   # (L,) int64 emission id (uint32 values)
    next_e: torch.Tensor      # scalar int64: next unassigned emission (chunk-local)
    n_chunk: torch.Tensor     # scalar int64: the chunk's emissions
    light_tab: torch.Tensor   # (ECH,) int64 light id of each emission (rows past n_chunk unused)
    emis_tab: torch.Tensor    # (ECH,) int64 emission id of each emission
    c_buf: torch.Tensor       # (CAP + 1, 9) packed pos|dir|flux, caustic
    c_cnt: torch.Tensor       # scalar int64: stores so far (may exceed CAP)
    g_buf: torch.Tensor       # (CAP + 1, 9) global
    g_cnt: torch.Tensor


def _fresh_photons(tables, cfg: PMConfig, li, ei, eps, flux_pp, dtype):
    """Light position + cosine direction for emission ids (li, ei)
    (photon-mapper.cpp:103-110; Sobol dims 0-3 of the unshuffled ctx)."""
    ctx0 = sobol.make_ctx(cfg.global_seed, li, ei, dtype)
    u0, u1, u2, u3 = sobol.sample_n(ctx0, 0, 4)
    pos, normal = _sample_light_position(tables, li, u0, u1)
    t, bvec = g.orthonormal_basis(normal)
    direction = g.from_local(g.cos_weighted_hemi(u2, u3), t, bvec, normal)
    return pos + normal * eps, direction, flux_pp[li]


def _scatter_stores(buf, cnt, mask, rows):
    """Append the masked rows at cnt, cnt+1, ...; the rest go to the dump row."""
    cap = buf.shape[0] - 1
    m = mask.to(torch.int64)
    slot = cnt + torch.cumsum(m, 0) - m
    slot = torch.where(mask & (slot < cap), slot, cap)
    buf[slot] = rows   # in place: the previous buffer is never read again
    return buf, cnt + m.sum()


def _make_emission_step(tables, meta, cfg: PMConfig, intersect_fn, flux_pp):
    """One regenerating emission bounce over _EmitStream."""
    dtype = tables.tri_v0.dtype
    eps = ray_offset_eps(dtype)
    non_caustic_reject = 1.0 / cfg.caustic_factor
    K = cfg.ior_stack_size
    packs = common.build_packs(tables, meta)
    scene_ior = tables.ior.to(dtype)

    def step(st: _EmitStream) -> _EmitStream:
        base_ctx = sobol.make_ctx(cfg.global_seed, st.lane_light, st.lane_emis, dtype)
        ctx = sobol.shuffled(base_ctx, st.bounce.to(torch.int64) + 1)
        hit = intersect_fn(st.origin, st.direction)
        alive = st.alive & (hit.surf_id >= 0)

        ix = common.interaction_setup(
            tables, meta, st.origin, st.direction, hit,
            st.iors, st.ior_count, st.refraction_level, st.medium_ior,
            packs=packs,
        )

        # Photon deposit (photon-mapper.cpp:242-255): only at non-dirac materials.
        can_store = alive & ~ix.mat.dirac_delta
        caustic_mask = can_store & st.ray_dirac
        u_rej = sobol.sample(ctx, 2)
        global_mask = can_store & ~st.ray_dirac & (non_caustic_reject > u_rej)
        out_flux = torch.where(caustic_mask[:, None], st.flux, st.flux / non_caustic_reject)
        rows = torch.cat([ix.position, -st.direction, out_flux], dim=1)
        c_buf, c_cnt = _scatter_stores(st.c_buf, st.c_cnt, caustic_mask, rows)
        g_buf, g_cnt = _scatter_stores(st.g_buf, st.g_cnt, global_mask, rows)

        # Importance-transport BSDF bounce + constant-flux RR (:257-273)
        b = common.bsdf_bounce(ix, st.direction, ctx, eps, flux=True)
        survive = torch.clamp(b.weight.amax(dim=-1), max=0.95)
        u_abs = sobol.sample(ctx, 6)
        live_next = alive & b.valid & (survive > 0.0) & (survive > u_abs)
        flux = st.flux * b.weight / bsdf._safe(survive)[:, None]

        iors, ior_count, new_level = common.update_ior_stack(
            st.iors, st.ior_count, st.refraction_level, b.level_delta, b.new_medium, K
        )

        # ---- regeneration: dead lanes pull the next unassigned emissions ----
        died = st.alive & ~live_next
        died_i = died.to(torch.int64)
        new_local = st.next_e + torch.cumsum(died_i, 0) - died_i
        has_new = died & (new_local < st.n_chunk)
        le = torch.minimum(new_local, st.n_chunk - 1)
        li_new = st.light_tab[le]
        ei_new = st.emis_tab[le]
        o_f, d_f, fl_f = _fresh_photons(tables, cfg, li_new, ei_new, eps, flux_pp, dtype)
        sel = has_new[:, None]
        alive_next = live_next | has_new
        zi = torch.zeros_like(new_level)
        return _EmitStream(
            origin=torch.where(sel, o_f, torch.where(alive_next[:, None], b.new_origin, PARK_DISTANCE)),
            direction=torch.where(sel, d_f, torch.where(alive_next[:, None], b.new_dir, PARK_DIRECTION)),
            flux=torch.where(sel, fl_f, flux),
            medium_ior=torch.where(has_new, scene_ior, b.new_medium),
            refraction_level=torch.where(has_new, zi, new_level),
            iors=torch.where(sel, scene_ior, iors),
            ior_count=torch.where(has_new, zi + 1, ior_count),
            ray_dirac=b.dirac_next & ~has_new,
            alive=alive_next,
            bounce=torch.where(has_new, zi, st.bounce + 1),
            lane_light=torch.where(has_new, li_new, st.lane_light),
            lane_emis=torch.where(has_new, ei_new, st.lane_emis),
            next_e=st.next_e + died_i.sum(),
            n_chunk=st.n_chunk,
            light_tab=st.light_tab,
            emis_tab=st.emis_tab,
            c_buf=c_buf,
            c_cnt=c_cnt,
            g_buf=g_buf,
            g_cnt=g_cnt,
        )

    step.capturable = getattr(intersect_fn, "capturable", True)
    return step


def emission_plan(scene_np, cfg: PMConfig):
    """Host-side flux-proportional emission split (photon-mapper.cpp:63-78).

    Returns (light_idx (E,) int32, emission_idx (E,) uint32, flux_per_photon
    (L,3)) where E = the emissions scaled by caustic_factor."""
    radiosity = np.asarray(scene_np.light_radiosity, np.float64)
    area = np.asarray(scene_np.light_area, np.float64)
    light_flux = radiosity * area[:, None]           # (L,3)
    total = float(light_flux.sum())
    total_emissions = int(cfg.emissions * cfg.caustic_factor)
    shares = light_flux.sum(axis=1) / total
    counts = (total_emissions * shares).astype(np.int64)
    counts = np.maximum(counts, 1)
    flux_per_photon = light_flux / counts[:, None]
    light_idx = np.repeat(np.arange(len(counts), dtype=np.int32), counts)
    emission_idx = np.concatenate([np.arange(c, dtype=np.uint32) for c in counts])
    return light_idx, emission_idx, flux_per_photon


class _EmissionRun(cuda_graph.GraphedLoop):
    """Chunks of at most `rows` emissions through `lanes` regenerating lanes,
    with store buffers of `cap` rows. The step is built once and serves every
    such chunk, since the chunk's emission tables (in buffers of `rows` rows)
    and its length ride in the state; the JAX package compiles its run_chunk
    once per static (n_chunk, cap) instead. On the card the first step runs
    eagerly, the second is captured as a CUDA graph and every later step of
    every chunk is one replay (utils/cuda_graph.GraphedLoop); on the CPU,
    and for an intersect that is not capturable, every step runs eagerly.
    Calling it with a chunk's (light ids, emission ids) runs the chunk to its
    end and returns its (caustic, global) store counts; the rows are in
    `state.c_buf` and `state.g_buf` until the next chunk is loaded."""

    def __init__(self, tables, meta, cfg: PMConfig, intersect_fn, flux_pp, lanes: int,
                 rows: int, cap: int):
        super().__init__(_make_emission_step(tables, meta, cfg, intersect_fn, flux_pp))
        self.tables, self.cfg, self.flux_pp = tables, cfg, flux_pp
        self.lanes, self.rows, self.cap = lanes, rows, cap

    def initial(self, light_idx, emission_idx) -> _EmitStream:
        """The state of a chunk of emissions given as host arrays: the tables
        padded to `rows`, the first `lanes` emissions loaded, the stores empty."""
        tables, cfg = self.tables, self.cfg
        n_chunk = len(light_idx)
        dtype = tables.tri_v0.dtype
        dev = tables.tri_v0.device
        tab = np.zeros((2, self.rows), np.int64)
        tab[0, :n_chunk] = light_idx
        tab[1, :n_chunk] = emission_idx
        light_tab, emis_tab = torch.as_tensor(tab, device=dev)
        L = self.lanes
        local0 = torch.arange(L, dtype=torch.int64, device=dev)
        live0 = local0 < n_chunk
        le0 = torch.clamp(local0, max=n_chunk - 1)
        li0, ei0 = light_tab[le0], emis_tab[le0]
        eps = ray_offset_eps(dtype)
        o0, d0, fl0 = _fresh_photons(tables, cfg, li0, ei0, eps, self.flux_pp, dtype)
        i0 = torch.zeros((L,), dtype=torch.int32, device=dev)
        scene_ior = tables.ior.to(dtype)
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        return _EmitStream(
            origin=torch.where(live0[:, None], o0, PARK_DISTANCE),
            direction=d0,
            flux=fl0,
            medium_ior=torch.zeros((L,), dtype=dtype, device=dev) + scene_ior,
            refraction_level=i0,
            iors=(torch.zeros((L, cfg.ior_stack_size), dtype=dtype, device=dev) + scene_ior),
            ior_count=i0 + 1,
            ray_dirac=i0 != 0,
            alive=live0,
            bounce=i0, lane_light=li0, lane_emis=ei0,
            next_e=zero + min(L, n_chunk),
            n_chunk=zero + n_chunk,
            light_tab=light_tab, emis_tab=emis_tab,
            c_buf=torch.zeros((self.cap + 1, 9), dtype=dtype, device=dev), c_cnt=zero,
            g_buf=torch.zeros((self.cap + 1, 9), dtype=dtype, device=dev), g_cnt=zero,
        )

    def __call__(self, light_idx, emission_idx, stats: dict):
        with span("loop.load"):
            self.load(self.initial(light_idx, emission_idx))
        stats["emission_steps"] = stats.get("emission_steps", 0) + self.drain()
        return int(self.state.c_cnt), int(self.state.g_cnt)


def emit_photons(
    tables: SceneTables,
    meta: SceneMeta,
    cfg: PMConfig,
    scene_np,
    intersect_fn: Callable | None = None,
    verbose: bool = False,
    stats: dict | None = None,
):
    """Run pass 1. Returns (caustic, global) photon SoA numpy triples.

    Emissions stream through `lanes` lanes in chunks of ECH, all through one
    _EmissionRun. The store buffers hold STORE_MARGIN x ECH rows; a chunk that
    stores more into either is run again through a run with buffers of its
    counted size, which serves the later chunks. With a `stats` dict,
    "emission_steps" and "emission_reruns" are added to it, and "graphed"
    is False unless every chunk replayed a captured step. Each chunk's copy
    of its stores to the host is the span `pm.emit.copy` (utils/trace)."""
    stats = {} if stats is None else stats
    dtype = tables.tri_v0.dtype
    dev = tables.tri_v0.device
    if intersect_fn is None:
        intersect_fn = lambda o, d: isect.intersect_brute(tables, meta, o, d)

    light_idx_all, emission_idx_all, flux_pp = emission_plan(scene_np, cfg)
    flux_pp_dev = torch.as_tensor(flux_pp, device=dev).to(dtype)
    E = len(light_idx_all)
    lanes = min(cfg.emission_chunk, max(256, E))
    ECH = min(E, CHUNK_EMISSIONS)
    cap = max(1, int(STORE_MARGIN * ECH))
    new_run = lambda cap: _EmissionRun(tables, meta, cfg, intersect_fn, flux_pp_dev, lanes,
                                       ECH, cap)

    out = {"caustic": [], "global": []}
    run = new_run(cap)
    done = 0
    try:
        while done < E:
            n = min(ECH, E - done)
            chunk = (light_idx_all[done:done + n], emission_idx_all[done:done + n])
            c_n, g_n = run(*chunk, stats)
            if max(c_n, g_n) > cap:
                # Stores past the buffer were dropped: run the chunk again
                # through buffers of its counted size (a run of its own, which
                # captures its own step); the photon paths, and so the stores,
                # are the same.
                cap = max(c_n, g_n)
                stats["emission_reruns"] = stats.get("emission_reruns", 0) + 1
                run.close()
                run = new_run(cap)
                c_n, g_n = run(*chunk, stats)
            stats["graphed"] = stats.get("graphed", True) and run.graphed
            # Copied to the host before the next chunk reuses the buffers.
            with span("pm.emit.copy"):
                out["caustic"].append(run.state.c_buf[:c_n].cpu().numpy())
                out["global"].append(run.state.g_buf[:g_n].cpu().numpy())
            done += n
            if verbose:
                print(f"\rphotons emitted: {done}/{E}", end="", flush=True)
    finally:
        run.close()
    if verbose:
        print()

    def cat(rows):
        r = np.concatenate(rows) if rows else np.zeros((0, 9))
        return r[:, 0:3], r[:, 3:6], r[:, 6:9]

    return cat(out["caustic"]), cat(out["global"])


def build_photon_maps(tables, meta, cfg: PMConfig, scene_np, intersect_fn=None,
                      verbose=False, stats: dict | None = None) -> PhotonMaps:
    """Both photon maps as grids on the tables' device: the emission is the
    span `pm.emit`, each grid's host build and upload the span `pm.grid`."""
    with span("pm.emit"):
        emitted = emit_photons(tables, meta, cfg, scene_np, intersect_fn, verbose, stats)
    dtype = tables.tri_v0.dtype
    dev = tables.tri_v0.device
    grids = []
    for pos, direction, flux in emitted:   # caustic, then global
        with span("pm.grid"):
            grids.append(pgrid.build_photon_grid(pos, direction, flux, cfg.k_nearest_photons,
                                                 dtype, device=dev))
    return PhotonMaps(*grids)


# ----------------------------------------------------------------------------------
# Radiance estimates (photon-mapper.cpp:343-391)
# ----------------------------------------------------------------------------------

def _expand_mat(mat: bsdf.MatParams) -> bsdf.MatParams:
    """(R,...) material params -> (R,1,...) for broadcasting against (R,k,...)."""
    return bsdf.MatParams._make(x[:, None] for x in mat)


def _estimate(
    grid: pgrid.PhotonGrid,
    arrays: pgrid.PhotonGridArrays,
    ix: common.Interaction,
    k: int,
    cone: bool,
    mask=None,
):
    """Shared k-NN radiance estimate. cone=True -> caustic filter, else global.
    `mask` (R,) marks lanes whose estimate is used (others skip the exact-k-NN
    fallback: dead and parked lanes hold garbage positions). Returns (R,3)
    radiance and the k-NN's counts (photon_grid.knn_counted; None for an
    empty map, which is not searched)."""
    dtype = ix.position.dtype
    if grid.empty:
        return torch.zeros_like(ix.position), None
    # Exact: the reference is exact at every density (linear-octree.cpp:25-117).
    (d2, idx, valid, w), counts = pgrid.knn_counted(grid, arrays, ix.position, k, mask=mask)
    r2k = torch.where(valid, d2, torch.zeros_like(d2)).amax(dim=1)   # k-th (max) distance^2
    any_found = valid.any(dim=1)

    il = idx.to(torch.int64)
    wi_w = arrays.direction[il]                                         # (R,k,3)
    flux = arrays.flux[il] * w[..., None]  # occ/M rescale for subsampled cells
    wi_l = g.to_local(wi_w, ix.tb_t[:, None], ix.tb_b[:, None], ix.sn[:, None])
    f, pdf = bsdf.eval_layered(
        _expand_mat(ix.mat), ix.wo_l[:, None], wi_l,
        ix.n1[:, None], ix.n2[:, None], ix.inside[:, None],
        ix.R_cl[:, None], ix.T[:, None],
        event=torch.zeros(wi_l.shape[:2], dtype=torch.int32, device=wi_l.device), flux=False,
        wi_dirac=torch.zeros(wi_l.shape[:2], dtype=torch.bool, device=wi_l.device),
    )
    absidotn = f * torch.abs(wi_l[..., 2])[..., None]
    ok = valid & (pdf > 0.0)
    contrib = torch.where(ok[..., None], flux * absidotn / bsdf._safe(pdf)[..., None],
                          torch.zeros_like(absidotn))
    if cone:
        wp = torch.clamp(1.0 - torch.sqrt(d2 / bsdf._safe(r2k)[:, None]), min=0.0)
        contrib = contrib * torch.where(ok, wp, torch.zeros_like(wp))[..., None]
        total = torch.sum(contrib, dim=1) * (3.0 / math.pi) / bsdf._safe(r2k)[:, None]
    else:
        total = torch.sum(contrib, dim=1) / (math.pi * bsdf._safe(r2k))[:, None]
    return torch.where(any_found[:, None], total, torch.zeros_like(total)).to(dtype), counts


def _add_stats(stats: dict | None, maps: PhotonMaps, steps: int, knn):
    """Add an eye pass's `steps` bounce steps and its k-NN counts `knn`
    (_EyeState.knn) to `stats`: each step searches each non-empty map once."""
    if stats is None:
        return
    stats["bounce_steps"] = stats.get("bounce_steps", 0) + steps
    pgrid.add_knn_stats(stats, knn, sum(not grid.empty for grid in maps) * steps)


# ----------------------------------------------------------------------------------
# Pass 2: eye paths
# ----------------------------------------------------------------------------------

class _EyeState(NamedTuple):
    bounce: torch.Tensor
    origin: torch.Tensor
    direction: torch.Tensor
    medium_ior: torch.Tensor
    refraction_scale: torch.Tensor
    ray_dirac: torch.Tensor
    diffuse_depth: torch.Tensor
    refraction_level: torch.Tensor
    iors: torch.Tensor
    ior_count: torch.Tensor
    throughput: torch.Tensor
    radiance: torch.Tensor
    alive: torch.Tensor
    prev_light: torch.Tensor
    prev_bsdf_pdf: torch.Tensor
    prev_select_prob: torch.Tensor
    # Regeneration fields (trace_streamed): per-lane path identity + the output
    # buffer dead paths add their radiance to (last row = dump).
    pixel_index: torch.Tensor
    sample_index: torch.Tensor
    path_id: torch.Tensor
    next_path: torch.Tensor
    out_rad: torch.Tensor
    start: torch.Tensor       # scalar int64: global path index of the chunk's local path 0
    knn: torch.Tensor         # (3,) int64: the k-NN's [queries, flagged, scanned] so far


class _Regen(NamedTuple):
    cam: object        # CameraDef
    consts: object     # camera.CameraConsts on the render device
    spp: int
    n_paths: int


def _make_eye_step(tables: SceneTables, meta: SceneMeta, cfg: PMConfig, maps: PhotonMaps,
                   intersect_fn: Callable, regen: _Regen | None = None):
    """One eye-pass bounce over _EyeState. With `regen`, a lane whose path ends
    adds its radiance to out_rad and loads the next (pixel, sample) path. The
    k-NN's counts are added to the state's `knn`: nothing is read on the host."""
    dtype = tables.tri_v0.dtype
    eps = ray_offset_eps(dtype)
    K = cfg.ior_stack_size
    k = cfg.k_nearest_photons
    packs = common.build_packs(tables, meta)
    scene_ior = tables.ior.to(dtype)

    def step(st: _EyeState) -> _EyeState:
        R = st.origin.shape[0]
        dev = st.origin.device
        base_ctx = sobol.make_ctx(cfg.global_seed, st.pixel_index, st.sample_index, dtype)
        ctx = sobol.shuffled(base_ctx, st.bounce.to(torch.int64) + 1)
        hit = intersect_fn(st.origin, st.direction)
        alive = st.alive & (hit.surf_id >= 0)   # miss: no sky term in photon mapping

        ix = common.interaction_setup(
            tables, meta, st.origin, st.direction, hit,
            st.iors, st.ior_count, st.refraction_level, st.medium_ior,
            packs=packs,
        )
        radiance = st.radiance + st.throughput * common.sample_emissive(
            ix, st.direction, st.bounce, st.ray_dirac, st.prev_light,
            st.prev_bsdf_pdf, st.prev_select_prob, hit.surf_id, alive,
        )

        # Event selection decides interaction.dirac_delta (interaction.cpp:53).
        b = common.bsdf_bounce(ix, st.direction, ctx, eps, flux=False)
        ix_dirac = b.dirac_next
        from_cam_or_spec = st.ray_dirac | (st.bounce == 0)

        # Caustic estimate at every non-dirac interaction (:315)
        caustic_mask = alive & ~ix_dirac
        caustic, c_counts = _estimate(maps.caustic, maps.caustic.arrays, ix, k, cone=True,
                                      mask=caustic_mask)
        radiance = radiance + torch.where(caustic_mask[:, None], st.throughput * caustic,
                                          torch.zeros_like(caustic))

        cont_spec = alive & ix_dirac & from_cam_or_spec
        cont_diff = alive & ~ix_dirac & from_cam_or_spec & (not cfg.direct_visualization)
        terminate_global = alive & ~ix_dirac & ~cont_diff

        # NEE only on the delayed-global continuation (:319-326)
        if meta.has_lights:
            nee, prev_light, prev_select_prob, _ = common.sample_direct(
                tables, ix, ctx, intersect_fn, eps, cont_diff, packs=packs
            )
            radiance = radiance + torch.where(cont_diff[:, None], st.throughput * nee,
                                              torch.zeros_like(nee))
            prev_light = torch.where(cont_diff, prev_light, torch.full_like(prev_light, -1))
        else:
            prev_light = torch.full((R,), -1, dtype=torch.int32, device=dev)
            prev_select_prob = torch.ones((R,), dtype=dtype, device=dev)

        # Global estimate terminates the path (:330)
        glob, g_counts = _estimate(maps.global_, maps.global_.arrays, ix, k, cone=False,
                                   mask=terminate_global)
        knn = st.knn
        for counts in (c_counts, g_counts):
            if counts is not None:
                knn = knn + counts
        radiance = radiance + torch.where(terminate_global[:, None], st.throughput * glob,
                                          torch.zeros_like(glob))

        cont = (cont_spec | cont_diff) & b.valid
        throughput = torch.where(cont[:, None], st.throughput * b.weight, st.throughput)
        diffuse_depth = st.diffuse_depth + (cont & b.is_diffuse).to(torch.int32)
        new_refr_scale = st.refraction_scale * torch.where(
            cont, b.refr_scale_mult, torch.ones_like(b.refr_scale_mult))

        # absorb() Russian roulette (integrator.cpp:112-129)
        u_abs = sobol.sample(ctx, 6)
        survive = throughput.amax(dim=-1) * new_refr_scale
        new_depth = st.bounce + 1
        apply_rr = (diffuse_depth > cfg.min_ray_depth) | (new_depth > cfg.min_priority_ray_depth)
        survive_c = torch.clamp(survive, max=0.95)
        rr_kill = apply_rr & (survive_c <= u_abs)
        throughput = torch.where(
            (cont & apply_rr & ~rr_kill)[:, None],
            throughput / bsdf._safe(survive_c)[:, None], throughput,
        )
        alive_next = cont & (survive > 0.0) & ~rr_kill

        iors, ior_count, new_level = common.update_ior_stack(
            st.iors, st.ior_count, st.refraction_level, b.level_delta, b.new_medium, K
        )

        bounce = st.bounce + 1
        alive_next = alive_next & (bounce < cfg.max_eye_bounces)
        pixel_index = st.pixel_index
        sample_index = st.sample_index
        path_id = st.path_id
        next_path = st.next_path
        out_rad = st.out_rad
        medium_ior = b.new_medium
        ray_dirac = b.dirac_next
        prev_bsdf_pdf = b.pdf

        if regen is not None:
            died_now = st.alive & ~alive_next
            dump = out_rad.shape[0] - 1
            slot = torch.where(died_now, path_id, torch.full_like(path_id, dump)).to(torch.int64)
            # In place: the previous state is never read again.
            out_rad.index_add_(
                0, slot, torch.where(died_now[:, None], radiance, torch.zeros_like(radiance)))
            died_i = died_now.to(torch.int64)
            new_local = next_path + torch.cumsum(died_i, 0) - died_i
            has_new = died_now & (new_local < regen.n_paths)
            next_path = next_path + died_i.sum()
            lin = st.start + torch.clamp(new_local, max=regen.n_paths - 1)
            pix = torch.div(lin, regen.spp, rounding_mode="floor")
            w = regen.cam.width
            fresh = cam_mod.generate_rays(
                regen.cam, pix % w, torch.div(pix, w, rounding_mode="floor"),
                lin % regen.spp, cfg.global_seed, dtype, consts=regen.consts)
            sel = has_new[:, None]
            alive_next = alive_next | has_new
            new_origin = torch.where(sel, fresh.origin,
                                     torch.where(alive_next[:, None], b.new_origin, PARK_DISTANCE))
            new_dir = torch.where(sel, fresh.direction,
                                  torch.where(alive_next[:, None], b.new_dir, PARK_DIRECTION))
            zi = torch.zeros_like(bounce)
            bounce = torch.where(has_new, zi, bounce)
            pixel_index = torch.where(has_new, fresh.pixel_index, pixel_index)
            sample_index = torch.where(has_new, fresh.sample_index, sample_index)
            path_id = torch.where(has_new, new_local.to(torch.int32), path_id)
            medium_ior = torch.where(has_new, scene_ior, medium_ior)
            new_refr_scale = torch.where(has_new, torch.ones_like(new_refr_scale), new_refr_scale)
            ray_dirac = ray_dirac & ~has_new
            diffuse_depth = torch.where(has_new, zi, diffuse_depth)
            new_level = torch.where(has_new, zi, new_level)
            iors = torch.where(sel, scene_ior, iors)
            ior_count = torch.where(has_new, zi + 1, ior_count)
            throughput = torch.where(sel, torch.ones_like(throughput), throughput)
            radiance = torch.where(sel, torch.zeros_like(radiance), radiance)
            prev_light = torch.where(has_new, zi - 1, prev_light)
            prev_select_prob = torch.where(has_new, torch.ones_like(prev_select_prob),
                                           prev_select_prob)
        else:
            # Dead lanes are parked: the traversal culls them for free.
            new_origin = torch.where(alive_next[:, None], b.new_origin, PARK_DISTANCE)
            new_dir = torch.where(alive_next[:, None], b.new_dir, PARK_DIRECTION)

        return _EyeState(
            bounce=bounce, origin=new_origin, direction=new_dir, medium_ior=medium_ior,
            refraction_scale=new_refr_scale, ray_dirac=ray_dirac, diffuse_depth=diffuse_depth,
            refraction_level=new_level, iors=iors, ior_count=ior_count, throughput=throughput,
            radiance=radiance, alive=alive_next, prev_light=prev_light,
            prev_bsdf_pdf=prev_bsdf_pdf, prev_select_prob=prev_select_prob,
            pixel_index=pixel_index, sample_index=sample_index, path_id=path_id,
            next_path=next_path, out_rad=out_rad, start=st.start, knn=knn,
        )

    step.capturable = getattr(intersect_fn, "capturable", True)
    return step


def _init_eye(tables, cfg, origin, direction, pixel_index, sample_index, alive, path_id,
              next_path, out_rad, start) -> _EyeState:
    dtype = origin.dtype
    L = origin.shape[0]
    dev = origin.device
    f0 = torch.zeros((L,), dtype=dtype, device=dev)
    i0 = torch.zeros((L,), dtype=torch.int32, device=dev)
    scene_ior = tables.ior.to(dtype)
    return _EyeState(
        bounce=i0, origin=origin, direction=direction, medium_ior=f0 + scene_ior,
        refraction_scale=f0 + 1.0, ray_dirac=i0 != 0, diffuse_depth=i0, refraction_level=i0,
        iors=(f0 + scene_ior)[:, None].expand(L, cfg.ior_stack_size).contiguous(),
        ior_count=i0 + 1, throughput=torch.ones((L, 3), dtype=dtype, device=dev),
        radiance=torch.zeros((L, 3), dtype=dtype, device=dev), alive=alive,
        prev_light=i0 - 1, prev_bsdf_pdf=f0, prev_select_prob=f0 + 1.0,
        pixel_index=pixel_index, sample_index=sample_index, path_id=path_id,
        next_path=next_path, out_rad=out_rad,
        start=torch.full((), int(start), dtype=torch.int64, device=dev),
        knn=torch.zeros((3,), dtype=torch.int64, device=dev),
    )


def trace(
    tables: SceneTables,
    meta: SceneMeta,
    cfg: PMConfig,
    maps: PhotonMaps,
    origin,
    direction,
    pixel_index,
    sample_index,
    intersect_fn: Callable | None = None,
    stats: dict | None = None,
):
    """Photon-mapping eye pass for a batch of camera rays -> (R,3) radiance,
    through a one-shot BatchEyePass (on the card, a captured bounce step), one
    host sync per bounce. With a `stats` dict, "bounce_steps" (host syncs)
    and the k-NN counts of photon_grid.knn are added to it."""
    run = BatchEyePass(tables, meta, cfg, maps, intersect_fn=intersect_fn)
    try:
        return run(origin, direction, pixel_index, sample_index, stats)
    finally:
        run.close()


class BatchEyePass(cuda_graph.GraphedLoop):
    """The eye pass's batch loop (trace) over one (tables, maps, intersect),
    for batches of one size: the counterpart of the JAX package's
    `lax.while_loop`, which its chunk compiles whole (`jax.jit`), and the
    batch twin of StreamedEyePass. The step is built once; a batch's rays ride
    in the state. Calling the run with a batch's camera rays loads them into
    the state (on the card the static buffers, which the first batch
    allocates) and advances one bounce at a time while any lane is alive, one
    host sync a bounce: on the card the first bounce runs eagerly, the second
    captures the step as a CUDA graph, and every later bounce, of this batch
    and the later ones, is one replay (utils/cuda_graph.GraphedLoop); a
    capture that fails raises. On the CPU, and for an intersect that is not
    capturable, every bounce calls the step. Returns
    the (R, 3) radiance (a copy: the next batch reuses the buffers); with a
    `stats` dict, adds what trace adds. `close()` releases the graph and its
    pool."""

    def __init__(self, tables: SceneTables, meta: SceneMeta, cfg: PMConfig, maps: PhotonMaps,
                 intersect_fn: Callable | None = None):
        if intersect_fn is None:
            intersect_fn = lambda o, d: isect.intersect_brute(tables, meta, o, d)
        self.tables, self.cfg, self.maps = tables, cfg, maps
        super().__init__(_make_eye_step(tables, meta, cfg, maps, intersect_fn))

    def __call__(self, origin, direction, pixel_index, sample_index, stats: dict | None = None):
        R = origin.shape[0]
        dev = origin.device
        with span("loop.load"):
            self.load(_init_eye(
                self.tables, self.cfg, origin, direction, sobol.as_u32(pixel_index, dev),
                sobol.as_u32(sample_index, dev), torch.ones((R,), dtype=torch.bool, device=dev),
                torch.arange(R, dtype=torch.int32, device=dev),
                torch.full((), R, dtype=torch.int64, device=dev),
                torch.zeros((1, 3), dtype=origin.dtype, device=dev), 0))
        steps = self.drain()
        _add_stats(stats, self.maps, steps, self.state.knn)
        return self.state.radiance.clone()


class StreamedEyePass(cuda_graph.GraphedLoop):
    """Streamed eye passes over chunks of `n_paths` camera paths through
    `lanes` lanes, the photon mapper's counterpart of
    path_tracer.StreamedTrace: the bounce step is built once and serves every
    chunk of that size, since a chunk's first path rides in the state
    (_EyeState.start, a device scalar), as the JAX package passes its chunk's
    `start` as a traced scalar. A chunk of another size needs its own.

    Calling it with a chunk's first path runs that chunk's eye pass to the
    end, one host sync per bounce, and returns its (n_paths, 3) radiance per
    path (a copy: the next chunk reuses the buffers). On a CUDA device the
    first bounce runs eagerly (it builds the kernels and runs the k-NN's
    launch-shape query), the second captures the step as a CUDA graph, and
    every later bounce of this chunk and the later ones is one replay
    (utils/cuda_graph.GraphedLoop); a capture that fails raises. On the CPU,
    and for an intersect that is not capturable, every bounce calls the step
    eagerly. `close()` releases the graph and its pool. begin(start),
    advance() and `state` are the same run one bounce at a time;
    initial(start), `step` and output(state) the pieces of an eager loop."""

    def __init__(self, tables: SceneTables, meta: SceneMeta, cfg: PMConfig, maps: PhotonMaps,
                 cam, spp: int, n_paths: int, lanes: int, intersect_fn: Callable | None = None):
        dtype = tables.tri_v0.dtype
        if intersect_fn is None:
            intersect_fn = lambda o, d: isect.intersect_brute(tables, meta, o, d)
        self.tables, self.cfg, self.maps, self.lanes = tables, cfg, maps, lanes
        self.regen = _Regen(cam=cam, consts=cam_mod.camera_consts(cam, dtype, tables.tri_v0.device),
                            spp=spp, n_paths=n_paths)
        super().__init__(_make_eye_step(tables, meta, cfg, maps, intersect_fn, regen=self.regen))

    def initial(self, start: int) -> _EyeState:
        """A new _EyeState for the chunk whose first path is `start`: the
        first `lanes` paths loaded, the output buffer and the k-NN counts zero."""
        r, cfg = self.regen, self.cfg
        dtype, dev = self.tables.tri_v0.dtype, self.tables.tri_v0.device
        L, spp, cam = self.lanes, r.spp, r.cam
        local0 = torch.arange(L, dtype=torch.int64, device=dev)
        live0 = local0 < r.n_paths
        lin0 = int(start) + torch.clamp(local0, max=r.n_paths - 1)
        pix0 = torch.div(lin0, spp, rounding_mode="floor")
        first = cam_mod.generate_rays(
            cam, pix0 % cam.width, torch.div(pix0, cam.width, rounding_mode="floor"),
            lin0 % spp, cfg.global_seed, dtype, consts=r.consts,
        )
        return _init_eye(
            self.tables, cfg, torch.where(live0[:, None], first.origin, PARK_DISTANCE),
            first.direction, first.pixel_index, first.sample_index, live0,
            local0.to(torch.int32), torch.full((), min(L, r.n_paths), dtype=torch.int64, device=dev),
            torch.zeros((r.n_paths + 1, 3), dtype=dtype, device=dev), start)

    def output(self, st: _EyeState):
        """(n_paths, 3) radiance of a drained chunk (no lane is left to flush)."""
        return st.out_rad[:self.regen.n_paths]

    def begin(self, start: int):
        """Load the chunk whose first path is `start` (on the card, into the
        static buffers, which the first chunk allocates)."""
        with span("loop.load"):
            self.load(self.initial(start))

    def __call__(self, start: int, stats: dict | None = None):
        self.begin(start)
        steps = self.drain()
        _add_stats(stats, self.maps, steps, self.state.knn)
        return self.output(self.state).clone()


def trace_streamed(
    tables: SceneTables,
    meta: SceneMeta,
    cfg: PMConfig,
    maps: PhotonMaps,
    cam,
    spp: int,
    start: int,
    n_paths: int,
    lanes: int,
    intersect_fn: Callable | None = None,
    stats: dict | None = None,
):
    """Persistent-wavefront eye pass: `lanes` lanes stream `n_paths` camera paths
    (global indices [start, start+n_paths), pixel-major), as
    path_tracer.trace_streamed does, through a one-shot StreamedEyePass (on
    the card, a captured bounce step). Returns (n_paths, 3) radiance; with a
    `stats` dict, adds what trace adds."""
    run = StreamedEyePass(tables, meta, cfg, maps, cam, spp, n_paths, lanes,
                          intersect_fn=intersect_fn)
    try:
        return run(start, stats)
    finally:
        run.close()
