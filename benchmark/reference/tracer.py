"""The reference's integrators: the port's per-path arithmetic, frozen, over a
plain batch of paths.

Each function below is a copy of the port's (mcrt_tpu_torch/integrator/
path_tracer.py and photon_mapper.py) with the streaming, the CUDA graphs and
the counters taken out: a batch of paths runs one bounce a step in eager
PyTorch until every path has ended, through the reference's own closest
hits (closest_hit.py) and exact k-NN (knn.py). A path of the port and the
same path here draw the same Sobol samples, so where their hits agree their
radiance agrees to rounding.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from . import bsdf, common, sobol
from . import camera as cam_mod
from . import geometry as g
from . import knn as knn_mod

PARK_DISTANCE = common.PARK_DISTANCE
PARK_DIRECTION = common.PARK_DIRECTION


@dataclasses.dataclass(frozen=True)
class PTConfig:
    max_bounces: int = 64
    min_ray_depth: int = 3
    min_priority_ray_depth: int = 16
    ior_stack_size: int = 8
    global_seed: int = 0


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


def ray_offset_eps(dtype) -> float:
    return 1e-9 if dtype == torch.float64 else 1e-4


def sky_color(direction):
    dy = torch.clamp(direction[..., 1], -1.0, 1.0)
    fy = (1.0 + torch.arcsin(dy) / torch.pi) / 2.0
    return torch.stack([1.0 - fy, 0.5 * (1.0 - fy) + 0.5 * fy, fy], dim=-1)


class PathState(NamedTuple):
    bounce: torch.Tensor
    pixel_index: torch.Tensor
    sample_index: torch.Tensor
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


def init_state(tables, K, origin, direction, pixel_index, sample_index) -> PathState:
    dtype = origin.dtype
    L = origin.shape[0]
    dev = origin.device
    f0 = torch.zeros((L,), dtype=dtype, device=dev)
    i0 = torch.zeros((L,), dtype=torch.int32, device=dev)
    scene_ior = tables.ior.to(dtype)
    return PathState(
        bounce=i0, pixel_index=pixel_index, sample_index=sample_index, origin=origin,
        direction=direction, medium_ior=f0 + scene_ior, refraction_scale=f0 + 1.0,
        ray_dirac=i0 != 0, diffuse_depth=i0, refraction_level=i0,
        iors=(f0 + scene_ior)[:, None].expand(L, K).contiguous(), ior_count=i0 + 1,
        throughput=torch.ones((L, 3), dtype=dtype, device=dev),
        radiance=torch.zeros((L, 3), dtype=dtype, device=dev),
        alive=torch.ones((L,), dtype=torch.bool, device=dev), prev_light=i0 - 1,
        prev_bsdf_pdf=f0, prev_select_prob=f0 + 1.0)


def _rr(cfg, st, throughput, diffuse_depth, refraction_scale, ctx):
    """Russian roulette (integrator.cpp:112-129): (survive, survive_c, rr_kill, apply_rr)."""
    u_abs = sobol.sample(ctx, 6)
    survive = throughput.amax(dim=-1) * refraction_scale
    apply_rr = (diffuse_depth > cfg.min_ray_depth) | (st.bounce + 1 > cfg.min_priority_ray_depth)
    survive_c = torch.clamp(survive, max=0.95)
    return survive, survive_c, apply_rr & (survive_c <= u_abs), apply_rr


def pt_step(tables, meta, cfg: PTConfig, intersect_fn, packs):
    """The path tracer's bounce (path_tracer.make_bounce_step without regen)."""
    dtype = tables.tri_v0.dtype
    eps = ray_offset_eps(dtype)

    def step(st: PathState) -> PathState:
        base_ctx = sobol.make_ctx(cfg.global_seed, st.pixel_index, st.sample_index, dtype)
        ctx = sobol.shuffled(base_ctx, st.bounce.to(torch.int64) + 1)
        hit = intersect_fn(st.origin, st.direction)
        missed = hit.surf_id < 0
        radiance = st.radiance + torch.where(
            (st.alive & missed)[:, None], st.throughput * sky_color(st.direction),
            torch.zeros_like(st.radiance))
        alive = st.alive & ~missed
        ix = common.interaction_setup(tables, meta, st.origin, st.direction, hit, st.iors,
                                      st.ior_count, st.refraction_level, st.medium_ior,
                                      packs=packs)
        radiance = radiance + st.throughput * common.sample_emissive(
            ix, st.direction, st.bounce, st.ray_dirac, st.prev_light, st.prev_bsdf_pdf,
            st.prev_select_prob, hit.surf_id, alive)
        if meta.has_lights:
            nee, prev_light, prev_select_prob, _ = common.sample_direct(
                tables, ix, ctx, intersect_fn, eps, alive, packs=packs)
            radiance = radiance + st.throughput * nee
        else:
            prev_light = torch.full_like(st.prev_light, -1)
            prev_select_prob = torch.ones_like(st.prev_select_prob)
        b = common.bsdf_bounce(ix, st.direction, ctx, eps, flux=False)
        diffuse_depth = st.diffuse_depth + b.is_diffuse.to(torch.int32)
        new_refr_scale = st.refraction_scale * b.refr_scale_mult
        throughput = st.throughput * b.weight
        alive = alive & b.valid
        survive, survive_c, rr_kill, apply_rr = _rr(cfg, st, throughput, diffuse_depth,
                                                    new_refr_scale, ctx)
        rr_boost = apply_rr & ~rr_kill
        rr_div = torch.where(rr_boost, survive_c, torch.ones_like(survive_c))
        throughput = torch.where(rr_boost[:, None], throughput / rr_div[:, None], throughput)
        alive = alive & (survive > 0.0) & ~rr_kill
        iors, ior_count, new_level = common.update_ior_stack(
            st.iors, st.ior_count, st.refraction_level, b.level_delta, b.new_medium,
            cfg.ior_stack_size)
        return st._replace(
            bounce=st.bounce + 1,
            origin=torch.where(alive[:, None], b.new_origin, PARK_DISTANCE),
            direction=torch.where(alive[:, None], b.new_dir, PARK_DIRECTION),
            medium_ior=b.new_medium, refraction_scale=new_refr_scale, ray_dirac=b.dirac_next,
            diffuse_depth=diffuse_depth, refraction_level=new_level, iors=iors,
            ior_count=ior_count, throughput=throughput, radiance=radiance, alive=alive,
            prev_light=prev_light, prev_bsdf_pdf=b.pdf, prev_select_prob=prev_select_prob)

    return step


def camera_paths(cam, pixels, spp: int, seed: int, dtype, device):
    """Camera rays of every sample of the linear pixel ids `pixels` (P,):
    (origin, direction, pixel_index, sample_index), pixel-major."""
    pix = torch.as_tensor(np.asarray(pixels), dtype=torch.int64, device=device)
    pix = pix.repeat_interleave(spp)
    si = torch.arange(spp, dtype=torch.int64, device=device).repeat(len(pixels))
    rays = cam_mod.generate_rays(cam, pix % cam.width, torch.div(pix, cam.width,
                                 rounding_mode="floor"), si, seed, dtype)
    return rays.origin, rays.direction, rays.pixel_index, rays.sample_index


def render_pixels_pt(tables, meta, cam, cfg: PTConfig, intersect_fn, pixels, spp: int):
    """(P, 3) float64 pixel values (the mean of spp paths, clamped at 0, as the
    film's scan) of the path tracer at the linear pixel ids `pixels`."""
    dtype, dev = tables.tri_v0.dtype, tables.tri_v0.device
    o, d, pi, si = camera_paths(cam, pixels, spp, cfg.global_seed, dtype, dev)
    st = init_state(tables, cfg.ior_stack_size, o, d, pi, si)
    step = pt_step(tables, meta, cfg, intersect_fn, common.build_packs(tables, meta))
    while bool(st.alive.any()) and int(st.bounce.min()) < cfg.max_bounces:
        st = step(st)
    return _pixel_means(st.radiance, spp)


def _pixel_means(radiance, spp):
    sums = radiance.view(-1, spp, 3).sum(dim=1)
    return torch.clamp(sums / float(spp), min=0.0).to(torch.float64).cpu().numpy()


# ----------------------------------------------------------------------------------
# The photon mapper
# ----------------------------------------------------------------------------------

class PhotonMap(NamedTuple):
    """A photon map's rows as the port's grid holds them (any order)."""
    pos: torch.Tensor
    direction: torch.Tensor
    flux: torch.Tensor


def emission_plan(light_radiosity, light_area, cfg: PMConfig):
    """(light_idx (E,), emission_idx (E,), flux_per_photon (L, 3)): the
    flux-proportional split of photon_mapper.emission_plan."""
    radiosity = np.asarray(light_radiosity, np.float64)
    area = np.asarray(light_area, np.float64)
    light_flux = radiosity * area[:, None]
    total = float(light_flux.sum())
    total_emissions = int(cfg.emissions * cfg.caustic_factor)
    counts = np.maximum((total_emissions * light_flux.sum(axis=1) / total).astype(np.int64), 1)
    light_idx = np.repeat(np.arange(len(counts), dtype=np.int32), counts)
    emission_idx = np.concatenate([np.arange(c, dtype=np.uint32) for c in counts])
    return light_idx, emission_idx, light_flux / counts[:, None]


def _fresh_photons(tables, cfg: PMConfig, li, ei, eps, flux_pp, dtype):
    ctx0 = sobol.make_ctx(cfg.global_seed, li, ei, dtype)
    u0, u1, u2, u3 = sobol.sample_n(ctx0, 0, 4)
    lk = torch.clamp(li, min=0).to(torch.int64)
    pos, normal = common._sample_light_position_from(
        tables.light_kind[lk].to(u0.dtype), tables.light_p0[lk], tables.light_p1[lk],
        tables.light_p2[lk], tables.light_normal[lk], u0, u1)
    t, bvec = g.orthonormal_basis(normal)
    direction = g.from_local(g.cos_weighted_hemi(u2, u3), t, bvec, normal)
    return pos + normal * eps, direction, flux_pp[lk]


def emit(tables, meta, cfg: PMConfig, intersect_fn, light_idx, emission_idx, flux_pp,
         batch: int | None = None):
    """The photons that the emissions (light_idx, emission_idx) store: the
    emission bounce of photon_mapper._make_emission_step over batches of
    `batch` emissions (all at once by default) that do not regenerate; a
    photon's lane leaves the batch when its path ends. Returns (caustic,
    global) PhotonMaps of their rows."""
    dtype, dev = tables.tri_v0.dtype, tables.tri_v0.device
    packs = common.build_packs(tables, meta)
    flux_pp = torch.as_tensor(flux_pp, device=dev).to(dtype)
    light_idx = np.asarray(light_idx, np.int64)
    emission_idx = np.asarray(emission_idx, np.int64)
    n = len(light_idx)
    batch = batch or max(n, 1)
    stores = {"caustic": [], "global": []}
    for b0 in range(0, n, batch):
        li = torch.as_tensor(light_idx[b0:b0 + batch], device=dev)
        ei = torch.as_tensor(emission_idx[b0:b0 + batch], device=dev)
        _emit_batch(tables, meta, cfg, intersect_fn, packs, li, ei, flux_pp, stores)
    out = []
    for name in ("caustic", "global"):
        r = torch.cat(stores[name]) if stores[name] else torch.zeros((0, 9), dtype=dtype,
                                                                      device=dev)
        out.append(PhotonMap(r[:, 0:3], r[:, 3:6], r[:, 6:9]))
    return tuple(out)


def _emit_batch(tables, meta, cfg: PMConfig, intersect_fn, packs, li, ei, flux_pp, stores):
    dtype, dev = tables.tri_v0.dtype, tables.tri_v0.device
    eps = ray_offset_eps(dtype)
    non_caustic_reject = 1.0 / cfg.caustic_factor
    origin, direction, flux = _fresh_photons(tables, cfg, li, ei, eps, flux_pp, dtype)
    L = origin.shape[0]
    i0 = torch.zeros((L,), dtype=torch.int32, device=dev)
    scene_ior = tables.ior.to(dtype)
    medium_ior = torch.zeros((L,), dtype=dtype, device=dev) + scene_ior
    iors = torch.zeros((L, cfg.ior_stack_size), dtype=dtype, device=dev) + scene_ior
    ior_count, level, bounce = i0 + 1, i0, i0
    ray_dirac = i0 != 0
    while li.shape[0]:
        base_ctx = sobol.make_ctx(cfg.global_seed, li, ei, dtype)
        ctx = sobol.shuffled(base_ctx, bounce.to(torch.int64) + 1)
        hit = intersect_fn(origin, direction)
        alive = hit.surf_id >= 0
        ix = common.interaction_setup(tables, meta, origin, direction, hit, iors, ior_count,
                                      level, medium_ior, packs=packs)
        can_store = alive & ~ix.mat.dirac_delta
        caustic_mask = can_store & ray_dirac
        u_rej = sobol.sample(ctx, 2)
        global_mask = can_store & ~ray_dirac & (non_caustic_reject > u_rej)
        out_flux = torch.where(caustic_mask[:, None], flux, flux / non_caustic_reject)
        rows = torch.cat([ix.position, -direction, out_flux], dim=1)
        stores["caustic"].append(rows[caustic_mask])
        stores["global"].append(rows[global_mask])
        b = common.bsdf_bounce(ix, direction, ctx, eps, flux=True)
        survive = torch.clamp(b.weight.amax(dim=-1), max=0.95)
        u_abs = sobol.sample(ctx, 6)
        alive = alive & b.valid & (survive > 0.0) & (survive > u_abs)
        flux = flux * b.weight / bsdf._safe(survive)[:, None]
        iors, ior_count, level = common.update_ior_stack(iors, ior_count, level, b.level_delta,
                                                         b.new_medium, cfg.ior_stack_size)
        keep = alive.nonzero().squeeze(1)
        li, ei, flux, iors, ior_count, level = (x[keep] for x in (li, ei, flux, iors,
                                                                  ior_count, level))
        origin, direction = b.new_origin[keep], b.new_dir[keep]
        medium_ior, ray_dirac, bounce = b.new_medium[keep], b.dirac_next[keep], bounce[keep] + 1


def _estimate(pmap: PhotonMap, ix: common.Interaction, k: int, cone: bool):
    """photon_mapper._estimate over the reference's exact k-NN."""
    dtype = ix.position.dtype
    if pmap.pos.shape[0] == 0:
        return torch.zeros_like(ix.position)
    d2, idx, valid = knn_mod.knn(pmap.pos, ix.position, k)
    d2 = d2.to(dtype)
    r2k = torch.where(valid, d2, torch.zeros_like(d2)).amax(dim=1)
    any_found = valid.any(dim=1)
    il = idx.to(torch.int64)
    wi_w = pmap.direction[il]
    flux = pmap.flux[il]
    wi_l = g.to_local(wi_w, ix.tb_t[:, None], ix.tb_b[:, None], ix.sn[:, None])
    mat = bsdf.MatParams._make(x[:, None] for x in ix.mat)
    f, pdf = bsdf.eval_layered(
        mat, ix.wo_l[:, None], wi_l, ix.n1[:, None], ix.n2[:, None], ix.inside[:, None],
        ix.R_cl[:, None], ix.T[:, None],
        event=torch.zeros(wi_l.shape[:2], dtype=torch.int32, device=wi_l.device), flux=False,
        wi_dirac=torch.zeros(wi_l.shape[:2], dtype=torch.bool, device=wi_l.device))
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
    return torch.where(any_found[:, None], total, torch.zeros_like(total)).to(dtype)


def eye_step(tables, meta, cfg: PMConfig, caustic: PhotonMap, global_: PhotonMap,
             intersect_fn, packs):
    """The photon mapper's eye bounce (photon_mapper._make_eye_step without
    regen). Only the lanes whose estimate is used are searched."""
    dtype = tables.tri_v0.dtype
    eps = ray_offset_eps(dtype)
    k = cfg.k_nearest_photons

    def masked_estimate(pmap, ix, mask, cone):
        out = torch.zeros_like(ix.position)
        sel = mask.nonzero().squeeze(1)
        if len(sel):
            sub = common.Interaction(*(x[sel] if isinstance(x, torch.Tensor) else
                                       type(x)._make(y[sel] for y in x) for x in ix))
            out[sel] = _estimate(pmap, sub, k, cone)
        return out

    def step(st: PathState) -> PathState:
        base_ctx = sobol.make_ctx(cfg.global_seed, st.pixel_index, st.sample_index, dtype)
        ctx = sobol.shuffled(base_ctx, st.bounce.to(torch.int64) + 1)
        hit = intersect_fn(st.origin, st.direction)
        alive = st.alive & (hit.surf_id >= 0)
        ix = common.interaction_setup(tables, meta, st.origin, st.direction, hit, st.iors,
                                      st.ior_count, st.refraction_level, st.medium_ior,
                                      packs=packs)
        radiance = st.radiance + st.throughput * common.sample_emissive(
            ix, st.direction, st.bounce, st.ray_dirac, st.prev_light, st.prev_bsdf_pdf,
            st.prev_select_prob, hit.surf_id, alive)
        b = common.bsdf_bounce(ix, st.direction, ctx, eps, flux=False)
        ix_dirac = b.dirac_next
        from_cam_or_spec = st.ray_dirac | (st.bounce == 0)
        caustic_mask = alive & ~ix_dirac
        c_est = masked_estimate(caustic, ix, caustic_mask, True)
        radiance = radiance + torch.where(caustic_mask[:, None], st.throughput * c_est,
                                          torch.zeros_like(c_est))
        cont_spec = alive & ix_dirac & from_cam_or_spec
        cont_diff = alive & ~ix_dirac & from_cam_or_spec & (not cfg.direct_visualization)
        terminate_global = alive & ~ix_dirac & ~cont_diff
        if meta.has_lights:
            nee, prev_light, prev_select_prob, _ = common.sample_direct(
                tables, ix, ctx, intersect_fn, eps, cont_diff, packs=packs)
            radiance = radiance + torch.where(cont_diff[:, None], st.throughput * nee,
                                              torch.zeros_like(nee))
            prev_light = torch.where(cont_diff, prev_light, torch.full_like(prev_light, -1))
        else:
            prev_light = torch.full_like(st.prev_light, -1)
            prev_select_prob = torch.ones_like(st.prev_select_prob)
        g_est = masked_estimate(global_, ix, terminate_global, False)
        radiance = radiance + torch.where(terminate_global[:, None], st.throughput * g_est,
                                          torch.zeros_like(g_est))
        cont = (cont_spec | cont_diff) & b.valid
        throughput = torch.where(cont[:, None], st.throughput * b.weight, st.throughput)
        diffuse_depth = st.diffuse_depth + (cont & b.is_diffuse).to(torch.int32)
        new_refr_scale = st.refraction_scale * torch.where(
            cont, b.refr_scale_mult, torch.ones_like(b.refr_scale_mult))
        survive, survive_c, rr_kill, apply_rr = _rr(cfg, st, throughput, diffuse_depth,
                                                    new_refr_scale, ctx)
        throughput = torch.where((cont & apply_rr & ~rr_kill)[:, None],
                                 throughput / bsdf._safe(survive_c)[:, None], throughput)
        alive_next = cont & (survive > 0.0) & ~rr_kill & (st.bounce + 1 < cfg.max_eye_bounces)
        iors, ior_count, new_level = common.update_ior_stack(
            st.iors, st.ior_count, st.refraction_level, b.level_delta, b.new_medium,
            cfg.ior_stack_size)
        return st._replace(
            bounce=st.bounce + 1,
            origin=torch.where(alive_next[:, None], b.new_origin, PARK_DISTANCE),
            direction=torch.where(alive_next[:, None], b.new_dir, PARK_DIRECTION),
            medium_ior=b.new_medium, refraction_scale=new_refr_scale, ray_dirac=b.dirac_next,
            diffuse_depth=diffuse_depth, refraction_level=new_level, iors=iors,
            ior_count=ior_count, throughput=throughput, radiance=radiance, alive=alive_next,
            prev_light=prev_light, prev_bsdf_pdf=b.pdf, prev_select_prob=prev_select_prob)

    return step


def render_pixels_pm(tables, meta, cam, cfg: PMConfig, caustic: PhotonMap, global_: PhotonMap,
                     intersect_fn, pixels, spp: int):
    """(P, 3) float64 pixel values of the photon mapper's eye pass over the
    photon maps (caustic, global_) at the linear pixel ids `pixels`."""
    dtype, dev = tables.tri_v0.dtype, tables.tri_v0.device
    o, d, pi, si = camera_paths(cam, pixels, spp, cfg.global_seed, dtype, dev)
    st = init_state(tables, cfg.ior_stack_size, o, d, pi, si)
    step = eye_step(tables, meta, cfg, caustic, global_, intersect_fn,
                    common.build_packs(tables, meta))
    while bool(st.alive.any()):
        st = step(st)
    return _pixel_means(st.radiance, spp)
