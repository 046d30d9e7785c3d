"""Vector math helpers for batched rays (torch, dtype-polymorphic).

Everything operates on (..., 3) tensors with no per-ray Python branching. The
JAX package replaced gathers and searchsorted with dense compare-reduce forms
because per-lane gathers were slow on the TPU; on the GPU the plain gather and
`torch.searchsorted` are the natural form and give the same indices.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def dot(a, b):
    return (a * b).sum(dim=-1)


def dot3(a, b):
    return (a * b).sum(dim=-1, keepdim=True)


def cross(a, b):
    return torch.linalg.cross(a, b)


def length(v):
    d2 = dot(v, v)
    return torch.sqrt(torch.where(d2 > 0.0, d2, torch.ones_like(d2))) * (d2 > 0.0)


def normalize(v, eps=1e-9):
    """Unit vector; |v| floored at eps (not dtype-tiny, so that normalize of a
    near-zero difference stays finite and so do its gradients)."""
    floor = float(np.asarray(eps, dtype=str(v.dtype).removeprefix("torch.")) ** 2)
    return v / torch.sqrt(torch.clamp(dot3(v, v), min=floor))


def reflect(d, n):
    """GLM-style reflect: d - 2*dot(d,n)*n."""
    return d - 2.0 * dot3(d, n) * n


def orthonormal_basis(n):
    """Duff et al. branchless ONB (reference coordinate-system.cpp:7-18).

    Returns (t, b) tangent/bitangent with [t, b, n] right-handed orthonormal.
    """
    sign = torch.where(n[..., 2] >= 0.0, 1.0, -1.0).to(n.dtype)
    a = -1.0 / (sign + n[..., 2])
    bval = n[..., 0] * n[..., 1] * a
    t = torch.stack(
        [1.0 + sign * n[..., 0] * n[..., 0] * a, sign * bval, -sign * n[..., 0]], dim=-1
    )
    b = torch.stack([bval, sign + n[..., 1] * n[..., 1] * a, -n[..., 1]], dim=-1)
    return t, b


def to_local(v, t, b, n):
    """World -> shading-local (z = normal)."""
    return torch.stack([dot(v, t), dot(v, b), dot(v, n)], dim=-1)


def from_local(v, t, b, n):
    """Shading-local -> world."""
    return v[..., 0:1] * t + v[..., 1:2] * b + v[..., 2:3] * n


def cos_weighted_hemi(u, v):
    """Cosine-weighted hemisphere sample in local frame (reference sampling.hpp:35-44)."""
    r = torch.sqrt(u)
    azimuth = v * (2.0 * math.pi)
    return torch.stack(
        [r * torch.cos(azimuth), r * torch.sin(azimuth), torch.sqrt(torch.clamp(1.0 - u, min=0.0))],
        dim=-1,
    )


def uniform_disk(u, v):
    """Uniform unit-disk sample (reference sampling.hpp:29-33). Returns (..., 2)."""
    azimuth = v * (2.0 * math.pi)
    r = torch.sqrt(u)
    return torch.stack([r * torch.cos(azimuth), r * torch.sin(azimuth)], dim=-1)


def power_heuristic(a_pdf, b_pdf):
    a2 = a_pdf * a_pdf
    return a2 / (a2 + b_pdf * b_pdf)


def _nonzero(x):
    return torch.where(x == 0.0, torch.ones_like(x), x)


def solve_quadratic(a, b, c):
    """Numerically stable quadratic roots, vectorized (reference util.hpp:60-83).

    Returns (valid, t_min, t_max). Handles the linear (a==0) case; when invalid,
    t_min/t_max are garbage and must be gated by `valid`.
    """
    d = b * b - 4.0 * a * c
    sqrt_d = torch.sqrt(torch.where(d >= 0.0, torch.clamp(d, min=1e-30), torch.ones_like(d)))
    q = -0.5 * (b + torch.where(b < 0.0, -sqrt_d, sqrt_d))
    t0 = q / _nonzero(a)
    t1 = c / _nonzero(q)
    quad_valid = (a != 0.0) & (d >= 0.0)
    lin_t = -c / _nonzero(b)
    lin_valid = (a == 0.0) & (b != 0.0)
    t_min = torch.where(quad_valid, torch.minimum(t0, t1), lin_t)
    t_max = torch.where(quad_valid, torch.maximum(t0, t1), lin_t)
    return quad_valid | lin_valid, t_min, t_max


def cdf_index(cdf, u):
    """Index of the first cdf entry >= u: searchsorted(cdf, u, side='left'),
    i.e. the number of cdf entries strictly below u."""
    return torch.searchsorted(cdf.contiguous(), u.contiguous(), side="left")


def row_take(x, idx):
    """x[arange(R), idx] for (R, K) x."""
    return torch.gather(x, -1, idx[..., None].to(torch.int64))[..., 0]
