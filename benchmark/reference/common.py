"""Frozen copy of mcrt_tpu_torch/integrator/common.py for the benchmark's plain reference:
later changes to the port do not reach it.

Shared integrator machinery: interaction setup, NEE, emissive MIS, BSDF bounce.

The port of the JAX package's integrator/common.py (reference
source/integrator/integrator.cpp and source/ray/interaction.cpp): per-hit
frame and Fresnel setup, next-event estimation, BSDF-side MIS, and the
event-select + new-ray block as functions over masked ray lanes.
"""
from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from . import bsdf
from . import geometry as g
from . import intersect as isect
from . import sobol
from .loader import SceneMeta, SceneTables

# Parked rays: dead lanes are rewritten to a ray far outside any scene pointing
# away, so the traversal culls them for free and the coherence sort pushes
# them to the tail blocks.
PARK_DISTANCE = 2e30
PARK_DIRECTION = 0.57735026


class Interaction(NamedTuple):
    """Everything derived from one wavefront hit (reference interaction.cpp:12-53)."""
    position: torch.Tensor    # (R,3)
    normal: torch.Tensor      # (R,3) geometric, flipped toward the incoming ray
    sn: torch.Tensor          # (R,3) shading normal (same side as `normal`)
    tb_t: torch.Tensor        # (R,3) tangent
    tb_b: torch.Tensor        # (R,3) bitangent
    wo_l: torch.Tensor        # (R,3) local outgoing direction (toward previous vertex)
    inside: torch.Tensor      # (R,) bool
    n1: torch.Tensor          # (R,)
    n2: torch.Tensor          # (R,)
    R_cl: torch.Tensor        # (R,) clamped Fresnel reflect probability
    T: torch.Tensor           # (R,) transparency
    mat: bsdf.MatParams
    mat_id: torch.Tensor      # (R,) int32
    area: torch.Tensor        # (R,)
    radiosity: torch.Tensor   # (R,3)
    emissive_idx: torch.Tensor  # (R,) int32, -1 if not emissive
    t_safe: torch.Tensor      # (R,) hit distance (1 on miss lanes)


class ScenePacks(NamedTuple):
    """Packed per-surface, per-material and per-light rows, built once per
    render so each bounce fetches a hit's data with one row gather."""
    shade: torch.Tensor   # (n_surf, 19) see interaction_setup
    mat: torch.Tensor     # (n_mats, 27) see bsdf.pack_materials
    light: torch.Tensor   # (n_lights, 19) see sample_direct


def build_packs(tables: SceneTables, meta: SceneMeta) -> ScenePacks:
    dtype = tables.surf_area.dtype
    n_surf = tables.surf_area.shape[0]
    ntri = meta.n_tris
    pad = n_surf - ntri
    f = lambda x: x.to(dtype)[:, None]

    def tri_col(x):
        return torch.cat([x, x.new_zeros((pad, x.shape[1]))], 0) if pad else x

    shade = torch.cat(
        [
            f(tables.surf_area),                            # 0
            f(tables.surf_mat),                             # 1
            tables.surf_radiosity,                          # 2:5
            f(tables.surf_emissive_idx),                    # 5
            tri_col(tables.tri_n),                          # 6:9
            tri_col(f(tables.tri_interp)),                  # 9
            tri_col(tables.tri_vn.reshape(ntri, 9)),        # 10:19
        ],
        dim=1,
    )
    return ScenePacks(shade=shade, mat=bsdf.pack_materials(tables),
                      light=build_light_pack(tables))


def build_light_pack(tables: SceneTables):
    dtype = tables.surf_area.dtype
    f = lambda x: x.to(dtype)[:, None]
    return torch.cat(
        [
            f(tables.light_surf),           # 0 (ids exact in f32 below 2^24)
            f(tables.light_select_prob),    # 1
            tables.light_radiosity,         # 2:5
            f(tables.light_area),           # 5
            f(tables.light_kind),           # 6
            tables.light_p0,                # 7:10
            tables.light_p1,                # 10:13
            tables.light_p2,                # 13:16
            tables.light_normal,            # 16:19
        ],
        dim=1,
    )


def _surface_normal_packed(tables, meta, sid, row, position):
    """Geometric normal: triangles from pack cols 6:9; sphere normals stay
    analytic (they depend on the hit position)."""
    n = row[:, 6:9]
    if meta.n_sphs:
        sph_id = torch.clamp(sid - meta.sphere_offset, 0, max(meta.n_sphs - 1, 0)).to(torch.int64)
        sph_n = (position - tables.sph_origin[sph_id]) / tables.sph_radius[sph_id][:, None]
        n = torch.where((sid >= meta.sphere_offset)[:, None], sph_n, n)
    return n


def _shading_normal_packed(meta, sid, row, uv, geom_n, direction):
    """Interpolated shading normal from pack cols 9 (interp flag) and 10:19 (the
    three vertex normals), with the flip-side fallback (interaction.cpp:23-30)."""
    is_tri = sid < meta.sphere_offset
    interp = is_tri & (row[:, 9] > 0.5)
    vn = row[:, 10:19]
    u, v = uv[..., 0:1], uv[..., 1:2]
    sn = g.normalize((1.0 - u - v) * vn[:, 0:3] + u * vn[:, 3:6] + v * vn[:, 6:9])
    cos_g = g.dot(direction, geom_n)
    cos_s = g.dot(direction, sn)
    flip_mismatch = (cos_g < 0.0) != (cos_s < 0.0)
    use_interp = interp & ~flip_mismatch
    return torch.where(use_interp[:, None], sn, geom_n)


def interaction_setup(
    tables: SceneTables,
    meta: SceneMeta,
    origin,
    direction,
    hit: isect.Hit,
    iors,
    ior_count,
    refraction_level,
    medium_ior,
    packs: ScenePacks | None = None,
) -> Interaction:
    """Per-hit frame, IOR ordering, Fresnel probabilities (interaction.cpp:12-53)."""
    missed = hit.surf_id < 0
    t_safe = torch.where(missed, torch.ones_like(hit.t), hit.t)
    position = origin + direction * t_safe[:, None]
    position = isect.refine_positions(tables, meta, hit.surf_id, position)

    s = torch.clamp(hit.surf_id, min=0)
    if packs is None:
        packs = build_packs(tables, meta)
    row = packs.shade[s.to(torch.int64)]
    area = row[:, 0]
    mat_id = (row[:, 1] + 0.5).to(torch.int32)
    radiosity = row[:, 2:5]
    emissive_idx = torch.where(row[:, 5] >= 0, row[:, 5] + 0.5, torch.full_like(row[:, 5], -1.0)).to(torch.int32)

    geom_n_raw = _surface_normal_packed(tables, meta, s, row, position)
    cos_g = g.dot(direction, geom_n_raw)
    inside = cos_g > 0.0

    mat = bsdf.gather_materials(tables, mat_id, pack=packs.mat)

    external_ior = g.row_take(iors, torch.minimum(torch.clamp(refraction_level - 1, min=0), ior_count - 1))
    n1 = medium_ior
    n2 = torch.where(inside & ~mat.opaque, external_ior, mat.ior)

    sn_raw = _shading_normal_packed(meta, s, row, hit.uv, geom_n_raw, direction)
    flip = inside[:, None]
    normal = torch.where(flip, -geom_n_raw, geom_n_raw)
    sn = torch.where(flip, -sn_raw, sn_raw)
    tb_t, tb_b = g.orthonormal_basis(sn)
    out = -direction
    wo_l = g.to_local(out, tb_t, tb_b, sn)

    R_f = bsdf.fresnel_dielectric(n1, n2, g.dot(sn, out))
    R_cl = torch.where(mat.rough_specular, torch.clamp(R_f, 0.1, 0.9), R_f)
    return Interaction(
        position=position, normal=normal, sn=sn, tb_t=tb_t, tb_b=tb_b, wo_l=wo_l,
        inside=inside, n1=n1, n2=n2, R_cl=R_cl, T=mat.transparency,
        mat=mat, mat_id=mat_id, area=area, radiosity=radiosity,
        emissive_idx=emissive_idx, t_safe=t_safe,
    )


def sample_emissive(ix: Interaction, direction, bounce, ray_dirac, prev_light,
                    prev_bsdf_pdf, prev_select_prob, hit_surf_id, alive):
    """BSDF-side MIS emission pickup (integrator.cpp:93-110). Returns (R,3) add."""
    is_emissive = ix.emissive_idx >= 0
    direct = (bounce == 0) | ray_dirac
    out = -direction
    cos_light = g.dot(out, ix.normal)
    same_light = prev_light == hit_surf_id
    pdf_used = is_emissive & same_light & (ix.area * cos_light > 0.0)
    light_pdf_e = torch.where(
        pdf_used, ix.t_safe * ix.t_safe / bsdf._safe(ix.area * cos_light), torch.ones_like(ix.area)
    )
    mis_e = g.power_heuristic(prev_bsdf_pdf, light_pdf_e)
    emit = torch.where(
        direct[:, None],
        ix.radiosity,
        torch.where(same_light[:, None], (mis_e / bsdf._safe(prev_select_prob))[:, None] * ix.radiosity,
                    torch.zeros_like(ix.radiosity)),
    )
    return torch.where((alive & is_emissive & ~ix.inside)[:, None], emit, torch.zeros_like(emit))


def _sample_light_position_from(kind, p0, p1, p2, tri_n, u, v):
    """Uniform area sample + normal on an already-gathered light (tri: sqrt-warp
    triangle.cpp:93-97; sphere: uniform sphere.cpp:37-44). `kind` is 0/1 as a float."""
    su = torch.sqrt(u)[..., None]
    tri_pos = (1.0 - su) * p0 + ((1.0 - v)[..., None] * su) * p1 + (v[..., None] * su) * p2
    radius = p2[..., 0]
    z = 1.0 - 2.0 * u
    r = torch.sqrt(torch.clamp(1.0 - z * z, min=0.0))
    phi = 2.0 * math.pi * v
    sph_dir = torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)
    sph_pos = p0 + radius[..., None] * sph_dir
    is_sph = (kind > 0.5)[..., None]
    pos = torch.where(is_sph, sph_pos, tri_pos)
    normal = torch.where(is_sph, sph_dir, tri_n)
    return pos, normal


def sample_direct(
    tables: SceneTables,
    ix: Interaction,
    ctx,
    intersect_fn: Callable,
    eps,
    alive,
    packs: ScenePacks | None = None,
):
    """Next-event estimation with MIS (integrator.cpp:31-87).

    Returns (nee (R,3) unweighted by throughput, prev_light (R,), prev_select_prob,
    shadow_rays count)."""
    u_l0 = sobol.sample(ctx, 0)
    u_l1 = sobol.sample(ctx, 1)
    u_l2 = sobol.sample(ctx, 2)
    n_l = tables.light_cdf.shape[0]
    light_idx = torch.clamp(g.cdf_index(tables.light_cdf, u_l2), 0, n_l - 1)
    lpack = packs.light if packs is not None else build_light_pack(tables)
    lrow = lpack[light_idx]
    lsurf = (lrow[:, 0] + 0.5).to(torch.int32)
    select_prob = lrow[:, 1]
    l_radiosity = lrow[:, 2:5]
    l_area = lrow[:, 5]
    light_pos, l_normal = _sample_light_position_from(
        lrow[:, 6], lrow[:, 7:10], lrow[:, 10:13], lrow[:, 13:16], lrow[:, 16:19], u_l0, u_l1)

    shadow_o = ix.position + ix.normal * eps
    sdir0 = g.normalize(light_pos - shadow_o)
    cos_light_theta = g.dot(-sdir0, l_normal)
    cos_theta_s = g.dot(sdir0, ix.normal)
    retry = (cos_theta_s <= 0.0) & ~ix.mat.opaque & (cos_theta_s != 0.0)
    shadow_o = torch.where(retry[:, None], ix.position - ix.normal * eps, shadow_o)
    sdir = g.normalize(light_pos - shadow_o)

    # Park shadow rays that cannot contribute (dead lanes, dirac materials).
    need = alive & ~ix.mat.dirac_delta
    shadow_o = torch.where(need[:, None], shadow_o, PARK_DISTANCE)
    sdir = torch.where(need[:, None], sdir, PARK_DIRECTION)

    sh = intersect_fn(shadow_o, sdir)
    shadow_rays = need.sum()
    vis = (sh.surf_id == lsurf) & (sh.surf_id >= 0)

    nee_ok = (
        alive & ~ix.mat.dirac_delta & (cos_light_theta > 0.0)
        & ((cos_theta_s > 0.0) | retry) & vis
    )
    # Select BEFORE squaring: on occluded/parked lanes sh.t is float-max. The
    # divisor too: where l_area * cos is 0, _safe's tiny squares to 0 in the
    # backward pass, and 0 * inf turns the lane's zero cotangent into NaN.
    t_vis = torch.where(nee_ok, sh.t, torch.ones_like(sh.t))
    light_den = torch.where(nee_ok, l_area * cos_light_theta, torch.ones_like(t_vis))
    light_pdf = torch.where(
        nee_ok, t_vis * t_vis / bsdf._safe(light_den), torch.ones_like(t_vis)
    )
    wi_l = g.to_local(sdir, ix.tb_t, ix.tb_b, ix.sn)
    f_nee, pdf_nee = bsdf.eval_layered(
        ix.mat, ix.wo_l, wi_l, ix.n1, ix.n2, ix.inside, ix.R_cl, ix.T,
        event=torch.zeros_like(ix.mat_id), flux=False,
        wi_dirac=torch.zeros_like(alive),
    )
    bsdf_absidotn = f_nee * torch.abs(wi_l[..., 2])[:, None]
    nee_ok = nee_ok & (pdf_nee > 0.0)
    mis_w = g.power_heuristic(light_pdf, pdf_nee)
    nee = (mis_w / bsdf._safe(light_pdf * select_prob))[:, None] * bsdf_absidotn * l_radiosity
    nee = torch.where(nee_ok[:, None], nee, torch.zeros_like(nee))
    prev_light = torch.where(ix.mat.dirac_delta | ~alive, torch.full_like(lsurf, -1), lsurf)
    return nee, prev_light, select_prob, shadow_rays


class Bounce(NamedTuple):
    """Result of event selection + new-ray spawn + BSDF weight (ray.cpp:16-66 and
    interaction.cpp:56-72,156-183)."""
    new_dir: torch.Tensor          # (R,3)
    new_origin: torch.Tensor       # (R,3)
    new_medium: torch.Tensor       # (R,)
    did_refract: torch.Tensor      # (R,) bool
    dirac_next: torch.Tensor       # (R,) bool
    is_diffuse: torch.Tensor       # (R,) bool
    weight: torch.Tensor           # (R,3) f * |wi.z| / pdf (1 on invalid lanes)
    pdf: torch.Tensor              # (R,)
    valid: torch.Tensor            # (R,) bool
    level_delta: torch.Tensor      # (R,) int32
    refr_scale_mult: torch.Tensor  # (R,)


def bsdf_bounce(ix: Interaction, direction, ctx, eps, flux: bool) -> Bounce:
    """Stochastic event selection and new ray (Sobol dims 3,4 = BSDF, 5 = event)."""
    u_b0 = sobol.sample(ctx, 3)
    u_b1 = sobol.sample(ctx, 4)
    u_int = sobol.sample(ctx, 5)
    mat = ix.mat
    event = bsdf.select_event(mat, ix.n2, ix.R_cl, ix.T, u_int)
    dirac_next = (event != bsdf.DIFFUSE) & ~mat.rough_specular

    vndf_l = bsdf.ggx_visible_microfacet(u_b0, u_b1, ix.wo_l, bsdf._ggx_safe_alpha(mat))
    spec_n = torch.where(
        mat.rough_specular[:, None], g.from_local(vndf_l, ix.tb_t, ix.tb_b, ix.sn), ix.sn
    )
    refl_dir = g.reflect(direction, spec_n)
    inv_eta = ix.n1 / bsdf._safe(ix.n2)
    cos_m = g.dot(spec_n, direction)
    k = 1.0 - inv_eta * inv_eta * (1.0 - cos_m * cos_m)
    refr_ok = k >= 0.0
    k_safe = torch.where(refr_ok, torch.clamp(k, min=1e-30), torch.ones_like(k))
    refr_dir = (
        inv_eta[:, None] * direction
        - (inv_eta * cos_m + torch.sqrt(k_safe))[:, None] * spec_n
    )
    tir_dir = direction - spec_n * (2.0 * cos_m)[:, None]
    diff_dir = g.from_local(g.cos_weighted_hemi(u_b0, u_b1), ix.tb_t, ix.tb_b, ix.sn)

    is_refl = event == bsdf.REFLECT
    is_refr = event == bsdf.REFRACT
    is_diff = event == bsdf.DIFFUSE
    did_refract = is_refr & refr_ok

    new_dir = torch.where(
        is_refl[:, None], refl_dir,
        torch.where(is_refr[:, None], torch.where(refr_ok[:, None], refr_dir, tir_dir), diff_dir),
    )
    new_dir = g.normalize(new_dir)
    new_medium = torch.where(did_refract, ix.n2, ix.n1)
    new_origin = ix.position + torch.where(did_refract[:, None], -ix.normal * eps, ix.normal * eps)
    one = torch.ones_like(event)
    level_delta = torch.where(did_refract, torch.where(ix.inside, -one, one), 0 * one)
    refr_scale_mult = torch.where(did_refract, (ix.n2 / bsdf._safe(ix.n1)) ** 2, torch.ones_like(ix.n1))

    wi_l_new = g.to_local(new_dir, ix.tb_t, ix.tb_b, ix.sn)
    valid = torch.where(did_refract, wi_l_new[..., 2] < 0.0, wi_l_new[..., 2] > 0.0)
    f_new, pdf_new = bsdf.eval_layered(
        mat, ix.wo_l, wi_l_new, ix.n1, ix.n2, ix.inside, ix.R_cl, ix.T,
        event=event, flux=flux, wi_dirac=dirac_next,
    )
    valid = valid & (pdf_new > 0.0)
    # Double where, as in sample_direct: an invalid lane divides by 1, so a
    # zero pdf never reaches the division, forward or backward.
    pdf_den = torch.where(valid, pdf_new, torch.ones_like(pdf_new))
    weight = torch.where(
        valid[:, None],
        f_new * (torch.abs(wi_l_new[..., 2]) / pdf_den)[:, None],
        torch.ones_like(f_new),
    )
    return Bounce(
        new_dir=new_dir, new_origin=new_origin, new_medium=new_medium,
        did_refract=did_refract, dirac_next=dirac_next, is_diffuse=is_diff,
        weight=weight, pdf=pdf_new, valid=valid,
        level_delta=level_delta, refr_scale_mult=refr_scale_mult,
    )


def update_ior_stack(iors, ior_count, refraction_level, level_delta, new_medium, K: int):
    """RefractionHistory push/pop for the new ray (ray.cpp:80-98)."""
    new_level = refraction_level + level_delta
    push = (new_level > 0) & (new_level == ior_count)
    pop = (new_level > 0) & (new_level < ior_count - 1)
    slot = torch.clamp(ior_count, 0, K - 1)
    at_slot = torch.arange(K, device=iors.device)[None, :] == slot[:, None]
    iors = torch.where(at_slot & push[:, None], new_medium[:, None], iors)
    ior_count = ior_count + push.to(ior_count.dtype) - pop.to(ior_count.dtype)
    ior_count = torch.clamp(ior_count, 1, K)
    return iors, ior_count, new_level
