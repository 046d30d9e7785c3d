"""Layered BSDF: eval, pdf, and sampling — vectorized and branch-free.

The port of the JAX package's material layer (reference
source/material/{material,ggx,fresnel}.cpp and source/ray/interaction.cpp): a
smooth/GGX specular layer over a Lambertian/Oren-Nayar diffuse base with
stochastic event selection (REFLECT/REFRACT/DIFFUSE), dielectric and conductor
Fresnel, and the radiance-vs-importance transport asymmetry for refraction.
Per-material branching is `torch.where` over gathered parameter rows;
directions are in the shading-local frame (z = shading normal). The guards
that keep untaken branches finite are kept as in the JAX package, so the
differentiable path of a later slice can reuse these functions.

Event codes: 0 = REFLECT, 1 = REFRACT, 2 = DIFFUSE.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops import geometry as g
from .gather_bwd import gather_rows_backward

REFLECT, REFRACT, DIFFUSE = 0, 1, 2

_INV_PI = 1.0 / math.pi


class MatParams(NamedTuple):
    """Per-ray gathered material parameters (all leading dim R)."""
    reflectance: torch.Tensor            # (R,3) gamma-expanded
    specular_reflectance: torch.Tensor   # (R,3)
    transmittance: torch.Tensor          # (R,3)
    roughness: torch.Tensor              # (R,) Oren-Nayar sigma
    specular_roughness: torch.Tensor     # (R,) GGX alpha
    transparency: torch.Tensor           # (R,)
    ior: torch.Tensor                    # (R,)
    perfect_mirror: torch.Tensor         # (R,) bool
    has_complex: torch.Tensor            # (R,) bool
    complex_real: torch.Tensor           # (R,3)
    complex_imag: torch.Tensor           # (R,3)
    rough: torch.Tensor                  # (R,) bool
    rough_specular: torch.Tensor         # (R,) bool
    opaque: torch.Tensor                 # (R,) bool
    dirac_delta: torch.Tensor            # (R,) bool
    oren_A: torch.Tensor                 # (R,)
    oren_B: torch.Tensor                 # (R,)


def pack_materials(tables):
    """(n_mats, 27) packed material table: one row gather fetches every field."""
    dtype = tables.mat_reflectance.dtype
    f = lambda x: x.to(dtype)[:, None]
    return torch.cat(
        [
            tables.mat_reflectance,             # 0:3
            tables.mat_specular_reflectance,    # 3:6
            tables.mat_transmittance,           # 6:9
            f(tables.mat_roughness),            # 9
            f(tables.mat_specular_roughness),   # 10
            f(tables.mat_transparency),         # 11
            f(tables.mat_ior),                  # 12
            f(tables.mat_perfect_mirror),       # 13
            f(tables.mat_has_complex),          # 14
            tables.mat_complex_real,            # 15:18
            tables.mat_complex_imag,            # 18:21
            f(tables.mat_rough),                # 21
            f(tables.mat_rough_specular),       # 22
            f(tables.mat_opaque),               # 23
            f(tables.mat_dirac_delta),          # 24
            f(tables.mat_oren_A),               # 25
            f(tables.mat_oren_B),               # 26
        ],
        dim=1,
    )


class _GatherRows(torch.autograd.Function):
    """pack[m], whose backward sums each row's cotangents in float64.

    A material's row gathers one cotangent per ray. Summed in float32, the
    gradient of a batch carries a rounding error that grows with the batch
    and changes when the batch is split over ranks: two ranks differed from
    one by 1e-4 of the largest |g| at 262,144 rays on an H100. Summed in
    float64, the error is far below the float32 result's own rounding. The
    sum is `gather_bwd.gather_rows_backward`: on the card a hand-written
    kernel (csrc/gather_bwd.cu) that adds the rows in an order fixed by the
    shapes alone, with no atomics, so the gradients are deterministic and
    the same on every card; on the CPU its plain twin, in the same order. It
    replaces no JAX kernel: XLA's scatter-add served the JAX package."""

    @staticmethod
    def forward(ctx, pack, m):
        ctx.save_for_backward(m)
        ctx.pack_shape = pack.shape
        return pack[m]

    @staticmethod
    def backward(ctx, grad):
        (m,) = ctx.saved_tensors
        return gather_rows_backward(m, grad, ctx.pack_shape[0]), None


def gather_materials(tables, mat_id, pack=None) -> MatParams:
    """Fetch per-ray material params with one row gather (see pack_materials)."""
    m = torch.clamp(mat_id, min=0).to(torch.int64)
    if pack is None:
        pack = pack_materials(tables)
    row = _GatherRows.apply(pack, m)     # (R, 27)
    b = lambda c: row[:, c] > 0.5
    return MatParams(
        reflectance=row[:, 0:3],
        specular_reflectance=row[:, 3:6],
        transmittance=row[:, 6:9],
        roughness=row[:, 9],
        specular_roughness=row[:, 10],
        transparency=row[:, 11],
        ior=row[:, 12],
        perfect_mirror=b(13),
        has_complex=b(14),
        complex_real=row[:, 15:18],
        complex_imag=row[:, 18:21],
        rough=b(21),
        rough_specular=b(22),
        opaque=b(23),
        dirac_delta=b(24),
        oren_A=row[:, 25],
        oren_B=row[:, 26],
    )


# ----------------------------------------------------------------------------------
# Fresnel
# ----------------------------------------------------------------------------------

def _one_if_zero(x):
    return torch.where(x == 0.0, torch.ones_like(x), x)


def fresnel_dielectric(n1, n2, cos_theta):
    """Lagarde-memo dielectric Fresnel (reference fresnel.cpp:16-27). TIR -> 1."""
    ratio = n2 / _one_if_zero(n1)
    g2 = ratio * ratio + cos_theta * cos_theta - 1.0
    tir = g2 < 0.0
    # sqrt of a positive value only: sqrt's derivative at 0 is inf, and inf
    # times a lane's zero cotangent is NaN in the backward pass. TIR lanes
    # take sqrt(1) = 1 as in the JAX package (their result is overwritten).
    pos = g2 > 0.0
    gr = torch.where(pos | tir, torch.sqrt(torch.where(pos, g2, torch.ones_like(g2))),
                     torch.zeros_like(g2))
    g_p_c = gr + cos_theta
    g_m_c = gr - cos_theta
    term1 = (g_m_c / _one_if_zero(g_p_c)) ** 2
    denom2 = _one_if_zero(g_m_c * cos_theta + 1.0)
    term2 = ((g_p_c * cos_theta - 1.0) / denom2) ** 2
    f = 0.5 * term1 * (1.0 + term2)
    return torch.where(tir, torch.ones_like(f), f)


def fresnel_conductor(n1, eta_real, eta_imag, cos_theta):
    """Per-channel conductor Fresnel with complex IOR (reference fresnel.cpp:30-49).
    n1: (R,), eta_*: (R,3), cos_theta: (R,). Returns (R,3)."""
    ct = torch.clamp(cos_theta[..., None], 0.0, 1.0)
    cos2 = ct * ct
    sin2 = 1.0 - cos2
    n1e = n1[..., None]
    # Non-conductor lanes carry eta == 0; substitute a benign dummy (their
    # results are discarded by the has_complex select in eval_layered).
    real_conductor = (eta_real > 0.0) | (eta_imag > 0.0)
    eta_real = torch.where(real_conductor, eta_real, torch.ones_like(eta_real))
    eta_imag = torch.where(real_conductor, eta_imag, torch.ones_like(eta_imag))
    eta2 = (eta_real / n1e) ** 2
    eta_k2 = (eta_imag / n1e) ** 2
    t0 = eta2 - eta_k2 - sin2
    a2_p_b2 = torch.sqrt(torch.clamp(t0 * t0 + 4.0 * eta2 * eta_k2, min=1e-30))
    t1 = a2_p_b2 + cos2
    t2 = 2.0 * ct * torch.sqrt(torch.clamp(0.5 * (a2_p_b2 + t0), min=1e-30))
    r_perp = (t1 - t2) / (t1 + t2)
    t3 = cos2 * a2_p_b2 + sin2 * sin2
    t4 = t2 * sin2
    r_par = r_perp * (t3 - t4) / (t3 + t4)
    return 0.5 * (r_par + r_perp)


# ----------------------------------------------------------------------------------
# GGX microfacet (isotropic alpha)
# ----------------------------------------------------------------------------------

def _safe(x):
    return torch.where(x == 0.0, torch.full_like(x, torch.finfo(x.dtype).tiny), x)


def ggx_D(m, a):
    """NDF (reference ggx.cpp:21-24), isotropic a; denominator floored at 1e-12."""
    a2 = a * a
    denom = math.pi * a2 * ((m[..., 0] ** 2 + m[..., 1] ** 2) / _safe(a2) + m[..., 2] ** 2) ** 2
    return 1.0 / torch.clamp(denom, min=1e-12)


def ggx_lambda(w, a):
    z2 = torch.clamp(w[..., 2] ** 2, min=1e-12)
    return (-1.0 + torch.sqrt(1.0 + (a * a) * (w[..., 0] ** 2 + w[..., 1] ** 2) / z2)) / 2.0


def ggx_G1(w, a):
    return 1.0 / (1.0 + ggx_lambda(w, a))


def ggx_G2(wi, wo, a):
    return 1.0 / (1.0 + ggx_lambda(wo, a) + ggx_lambda(wi, a))


def _sgn_clamp(x, eps):
    """Clamp |x| >= eps preserving sign (0 treated as +)."""
    mag = torch.clamp(torch.abs(x), min=eps)
    return torch.where(x < 0.0, -mag, mag)


def ggx_DV(m, wo, a):
    return ggx_G1(wo, a) * g.dot(wo, m) * ggx_D(m, a) / _sgn_clamp(wo[..., 2], 1e-9)


def _up_like(x):
    up = torch.zeros_like(x)
    up[..., 2] = 1.0
    return up


def ggx_reflection(wi, wo, a):
    """(brdf_scalar, pdf) for microfacet reflection (reference ggx.cpp:46-52).
    Degenerate wi ~ -wo lanes get a benign half-vector and a zero result."""
    h = wo + wi
    degen = g.dot(h, h) < 1e-8
    m = g.normalize(torch.where(degen[..., None], _up_like(h), h), eps=1e-9)
    pdf = ggx_DV(m, wo, a) / _sgn_clamp(4.0 * g.dot(m, wo), 1e-9)
    f = ggx_D(m, a) * ggx_G2(wi, wo, a) / _sgn_clamp(4.0 * wo[..., 2] * wi[..., 2], 1e-12)
    zero = torch.zeros_like(f)
    return torch.where(degen, zero, f), torch.where(degen, zero, pdf)


def ggx_transmission(wi, wo, n1, n2, a):
    """(btdf_scalar, pdf) for microfacet transmission (reference ggx.cpp:54-65).
    Degenerate half-vectors (n1 ~ n2 and wi ~ -wo) are replaced before any
    nonlinearity and their result forced to 0."""
    m_un = wo * n1[..., None] + wi * n2[..., None]
    m_len2_raw = g.dot(m_un, m_un)
    degen = m_len2_raw < 1e-8
    m_un = torch.where(degen[..., None], _up_like(m_un), m_un)
    m_len2 = g.dot(m_un, m_un)
    m = m_un / torch.sqrt(m_len2)[..., None]
    m = torch.where((n1 < n2)[..., None], -m, m)
    dm_dwi = n2 * n2 * torch.abs(g.dot(wi, m)) / m_len2
    pdf = ggx_DV(m, wo, a) * dm_dwi
    f = torch.abs(ggx_G2(wi, wo, a) * ggx_D(m, a) * g.dot(wo, m) * dm_dwi
                  / _sgn_clamp(wo[..., 2] * wi[..., 2], 1e-12))
    zero = torch.zeros_like(f)
    return torch.where(degen, zero, f), torch.where(degen, zero, pdf)


def ggx_visible_microfacet(u, v, wo, a):
    """Heitz VNDF sampling in local frame (reference ggx.cpp:67-88), isotropic a."""
    vh = g.normalize(torch.stack([a * wo[..., 0], a * wo[..., 1], wo[..., 2]], dim=-1))
    len2 = vh[..., 0] ** 2 + vh[..., 1] ** 2
    inv_len = 1.0 / torch.sqrt(torch.clamp(len2, min=torch.finfo(wo.dtype).tiny))
    x_axis = torch.zeros_like(vh)
    x_axis[..., 0] = 1.0
    t1 = torch.where(
        (len2 > 0.0)[..., None],
        torch.stack([-vh[..., 1] * inv_len, vh[..., 0] * inv_len, torch.zeros_like(inv_len)], dim=-1),
        x_axis,
    )
    t2 = torch.linalg.cross(vh, t1)
    r = torch.sqrt(u)
    phi = v * (2.0 * math.pi)
    p1 = r * torch.cos(phi)
    p2 = r * torch.sin(phi)
    s = 0.5 * (1.0 + vh[..., 2])
    c1 = 1.0 - p1 * p1
    p2 = (1.0 - s) * torch.sqrt(torch.where(c1 > 0.0, c1, torch.ones_like(c1))) * (c1 > 0.0) + s * p2
    c2 = 1.0 - p1 * p1 - p2 * p2
    nh = (
        p1[..., None] * t1
        + p2[..., None] * t2
        + (torch.sqrt(torch.where(c2 > 0.0, c2, torch.ones_like(c2))) * (c2 > 0.0))[..., None] * vh
    )
    return g.normalize(
        torch.stack([a * nh[..., 0], a * nh[..., 1], torch.clamp(nh[..., 2], min=0.0)], dim=-1)
    )


# ----------------------------------------------------------------------------------
# Material lobes (reference material.cpp)
# ----------------------------------------------------------------------------------

def diffuse_reflection(mat: MatParams, wi, wo):
    """(f (R,3), pdf (R,)) — Lambertian or Oren-Nayar by `rough` flag
    (material.cpp:17-27, 76-95). Zero when wi.z < 0."""
    wiz = wi[..., 2]
    pdf = torch.clamp(wiz, min=0.0) * _INV_PI
    lamb = mat.reflectance * _INV_PI

    # Oren-Nayar, trig-free form; the degenerate straight-up directions (den == 0)
    # contribute no cos term.
    num = wi[..., 0] * wo[..., 0] + wi[..., 1] * wo[..., 1]
    den2 = (wi[..., 0] ** 2 + wi[..., 1] ** 2) * (wo[..., 0] ** 2 + wo[..., 1] ** 2)
    cos_dphi = torch.clamp(num / torch.sqrt(torch.where(den2 <= 0.0, torch.ones_like(den2), den2)),
                           0.0, 1.0)
    cos_dphi = torch.where(den2 <= 0.0, torch.zeros_like(cos_dphi), cos_dphi)
    sin2 = (1.0 - wiz ** 2) * (1.0 - wo[..., 2] ** 2)
    D = (torch.sqrt(torch.where(sin2 > 0.0, sin2, torch.ones_like(sin2))) * (sin2 > 0.0)) / _safe(
        torch.maximum(wiz, wo[..., 2])
    )
    on = lamb * (mat.oren_A + mat.oren_B * cos_dphi * D)[..., None]
    f = torch.where(mat.rough[..., None], on, lamb)
    bad = wiz < 0.0
    return torch.where(bad[..., None], torch.zeros_like(f), f), torch.where(bad, torch.zeros_like(pdf), pdf)


def _ggx_safe_alpha(mat: MatParams):
    """GGX alpha for evaluation; smooth lanes (alpha == 0) get a benign 0.25
    whose results are discarded."""
    return torch.where(mat.rough_specular, mat.specular_roughness,
                       torch.full_like(mat.specular_roughness, 0.25))


def specular_reflection(mat: MatParams, wi, wo):
    """(f (R,3), pdf (R,)) — smooth mirror lobe or GGX (material.cpp:29-45)."""
    wiz = wi[..., 2]
    a = _ggx_safe_alpha(mat)
    f_ggx, pdf_ggx = ggx_reflection(wi, wo, a)
    f_rough = mat.specular_reflectance * f_ggx[..., None]
    f_smooth = mat.specular_reflectance / torch.clamp(torch.abs(wiz), min=1e-9)[..., None]
    pdf = torch.where(mat.rough_specular, pdf_ggx, torch.ones_like(pdf_ggx))
    f = torch.where(mat.rough_specular[..., None], f_rough, f_smooth)
    bad = wiz < 0.0
    return torch.where(bad[..., None], torch.zeros_like(f), f), torch.where(bad, torch.zeros_like(pdf), pdf)


def specular_transmission(mat: MatParams, wi, wo, n1, n2, inside, flux):
    """(f (R,3), pdf (R,)) — smooth or GGX transmission with the radiance/importance
    (n2/n1)^2 asymmetry (material.cpp:47-68). Zero when wi.z > 0. `flux` is a
    Python bool (radiance transport=False, photon transport=True)."""
    wiz = wi[..., 2]
    btdf_color = torch.where(inside[..., None], torch.ones_like(mat.transmittance), mat.transmittance)
    ratio_n2n1 = (n2 / _safe(n1)) ** 2
    ratio_n1n2 = (n1 / _safe(n2)) ** 2

    f_ggx, pdf_ggx = ggx_transmission(wi, wo, n1, n2, _ggx_safe_alpha(mat))
    f_rough = btdf_color * f_ggx[..., None]
    if flux:
        f_rough = f_rough * ratio_n2n1[..., None]
    # The reference multiplies transmittance into the smooth branch a second time
    # (btdf = transmittance outside, then btdf *= transmittance / |wi.z|).
    f_smooth = btdf_color * mat.transmittance / torch.clamp(torch.abs(wiz), min=1e-9)[..., None]
    if not flux:
        f_smooth = f_smooth * ratio_n1n2[..., None]
    pdf = torch.where(mat.rough_specular, pdf_ggx, torch.ones_like(pdf_ggx))
    f = torch.where(mat.rough_specular[..., None], f_rough, f_smooth)
    bad = wiz > 0.0
    return torch.where(bad[..., None], torch.zeros_like(f), f), torch.where(bad, torch.zeros_like(pdf), pdf)


# ----------------------------------------------------------------------------------
# Layered BSDF evaluation (reference interaction.cpp:84-153)
# ----------------------------------------------------------------------------------

def eval_layered(
    mat: MatParams,
    wo,            # (R,3) local outgoing (toward camera/previous vertex)
    wi,            # (R,3) local incident (new/light direction)
    n1, n2,        # (R,) ior ordering from the interaction
    inside,        # (R,) bool
    R_clamped,     # (R,) specular reflect probability from the interaction
    T,             # (R,) transparency
    event,         # (R,) int32 event code of the ray that wi came from
    flux: bool,    # importance transport
    wi_dirac,      # (R,) bool: wi is the direction of the ray spawned dirac-ly
):
    """Returns (f (R,3), pdf (R,)) of the full layered BSDF (no |wi.z| factor)."""
    # cos_theta for Fresnel: wo.z, or half-vector based for rough specular.
    # Degenerate half-vectors are substituted with +z before normalize.
    up = _up_like(wi)
    h_refl = wo + wi
    h_refl = torch.where((g.dot(h_refl, h_refl) < 1e-8)[..., None], up, h_refl)
    m_refl = g.normalize(h_refl)
    cos_refl = g.dot(wo, m_refl)
    h_tr = wo * n1[..., None] + wi * n2[..., None]
    h_tr = torch.where((g.dot(h_tr, h_tr) < 1e-8)[..., None], up, h_tr)
    m_tr = g.normalize(h_tr)
    cos_tr = g.dot(wo, m_tr)
    cos_tr = torch.where(n1 < n2, -cos_tr, cos_tr)
    cos_rough = torch.where(wi[..., 2] > 0.0, cos_refl, cos_tr)
    cos_theta = torch.where(mat.rough_specular, cos_rough, wo[..., 2])

    F = fresnel_dielectric(n1, n2, cos_theta)

    f_s, pdf_s = specular_reflection(mat, wi, wo)
    f_d, pdf_d = diffuse_reflection(mat, wi, wo)
    f_t_raw, pdf_t_raw = specular_transmission(mat, wi, wo, n1, n2, inside, flux)
    use_t = F < 1.0
    f_t = torch.where(use_t[..., None], f_t_raw, f_s)
    pdf_t = torch.where(use_t, pdf_t_raw, pdf_s)

    # Mode 1: perfect mirror / conductor — pure specular reflection
    cond = fresnel_conductor(n1, mat.complex_real, mat.complex_imag, cos_theta)
    f_mirror = f_s * torch.where(mat.has_complex[..., None], cond, torch.ones_like(cond))
    pdf_mirror = pdf_s

    # Mode 2: n2 < 1 — forced diffuse
    f_forced_d, pdf_forced_d = f_d, pdf_d

    # Mode 3a: wi is the dirac-sampled ray direction
    is_reflect = event == REFLECT
    f_dirac = torch.where(
        is_reflect[..., None], f_s * F[..., None], f_t * (T * (1.0 - F))[..., None]
    )
    pdf_dirac = torch.where(is_reflect, R_clamped, T * (1.0 - R_clamped))

    # Mode 3b: smooth specular layer, non-dirac wi — diffuse-only layer
    f_smooth_layer = f_d * ((1.0 - F) * (1.0 - T))[..., None]
    pdf_smooth_layer = pdf_d * (1.0 - R_clamped) * (1.0 - T)

    # Mode 3c: rough specular — full lerp mix
    mix = lambda a, b, t: a + (b - a) * t
    f_mix = mix(mix(f_d, f_t, T[..., None]), f_s, F[..., None])
    pdf_mix = mix(mix(pdf_d, pdf_t, T), pdf_s, R_clamped)

    f3 = torch.where(
        wi_dirac[..., None], f_dirac,
        torch.where(mat.rough_specular[..., None], f_mix, f_smooth_layer),
    )
    pdf3 = torch.where(
        wi_dirac, pdf_dirac, torch.where(mat.rough_specular, pdf_mix, pdf_smooth_layer)
    )

    mode1 = mat.perfect_mirror | mat.has_complex
    mode2 = (~mode1) & (n2 < 1.0)
    f = torch.where(mode1[..., None], f_mirror, torch.where(mode2[..., None], f_forced_d, f3))
    pdf = torch.where(mode1, pdf_mirror, torch.where(mode2, pdf_forced_d, pdf3))
    return f, pdf


def select_event(mat: MatParams, n2, R_clamped, T, u):
    """Stochastic event selection (reference interaction.cpp:156-183).
    Returns int32 event code per ray."""
    i32 = lambda c: torch.full_like(u, c, dtype=torch.int32)
    r_or_refract = torch.where(
        R_clamped > u, i32(REFLECT),
        torch.where(R_clamped + (1.0 - R_clamped) * T > u, i32(REFRACT), i32(DIFFUSE)))
    forced_mirror = mat.perfect_mirror | mat.has_complex
    forced_diffuse = (~forced_mirror) & (n2 < 1.0)
    return torch.where(forced_mirror, i32(REFLECT), torch.where(forced_diffuse, i32(DIFFUSE), r_or_refract))
