"""Film reconstruction: filtered sample splatting as scatter-adds.

The port of the JAX package's film (reference source/camera/{film,filter}.*):
each radiance sample deposits into every pixel within the filter radius with
weight filter_x * filter_y; pixels divide by total weight at scan time. The
splat is `index_add_` over a static K x K footprint.

Filters (filter.hpp:10-65): box, Mitchell-Netravali (B,C), Catmull-Rom,
B-spline, Hermite, Gaussian, Lanczos — evaluated on the normalized argument
x = 2|t|/radius.
"""
from __future__ import annotations

import dataclasses
import math

import torch


def _mitchell_netravali(x, B, C):
    k = 6.0 / (6.0 - 2.0 * B)
    a1 = k * (12.0 - 9.0 * B - 6.0 * C) / 6.0
    b1 = k * (-18.0 + 12.0 * B + 6.0 * C) / 6.0
    d1 = k * (6.0 - 2.0 * B) / 6.0
    a2 = k * (-B - 6.0 * C) / 6.0
    b2 = k * (6.0 * B + 30.0 * C) / 6.0
    c2 = k * (-12.0 * B - 48.0 * C) / 6.0
    d2 = k * (8.0 * B + 24.0 * C) / 6.0
    near = d1 + (b1 + a1 * x) * x * x
    far = d2 + (c2 + (b2 + a2 * x) * x) * x
    return torch.where(x < 1.0, near, far)


def filter_eval(name: str, x):
    """Filter value at normalized x in [0, 2]."""
    if name == "box":
        return torch.ones_like(x)
    if name == "mitchell-netravali":
        return _mitchell_netravali(x, 1.0 / 3.0, 1.0 / 3.0)
    if name == "catmull-rom":
        return _mitchell_netravali(x, 0.0, 0.5)
    if name == "b-spline":
        return _mitchell_netravali(x, 1.0, 0.0)
    if name == "hermite":
        return _mitchell_netravali(x * 0.5, 0.0, 0.0)
    if name == "gaussian":
        alpha = 2.0
        return torch.exp(-alpha * x * x) - math.exp(-alpha * 4.0)
    if name == "lanczos":
        safe = torch.where(x == 0.0, torch.ones_like(x), x)
        val = 2.0 * torch.sin(math.pi * safe) * torch.sin(math.pi * safe / 2.0) / (math.pi * math.pi * safe * safe)
        return torch.where(x == 0.0, torch.ones_like(x), val)
    raise ValueError(f"unknown filter {name!r}")


DEFAULT_RADII = {
    "box": 0.5,
    "mitchell-netravali": 2.0,
    "catmull-rom": 2.0,
    "b-spline": 1.39,
    "hermite": 1.0,
    "gaussian": 1.71,
    "lanczos": 2.0,
}


@dataclasses.dataclass(frozen=True)
class FilmConfig:
    width: int
    height: int
    filter_name: str = "box"
    radius: float = 0.5

    @staticmethod
    def from_json(width: int, height: int, j: dict | None) -> "FilmConfig":
        if not j:
            return FilmConfig(width, height)
        name = str(j.get("filter", "box")).lower()
        if name not in DEFAULT_RADII:
            name = "box"
        radius = float(j.get("radius", DEFAULT_RADII[name]))
        return FilmConfig(width, height, name, radius)

    @property
    def is_pixel_box(self) -> bool:
        """Box filter at radius 0.5: every sample lands in exactly its own pixel."""
        return self.filter_name == "box" and self.radius == 0.5


def splat(cfg: FilmConfig, px, value):
    """Deposit (R,) samples at continuous coords px (R,2) with values (R,3).

    Returns (H, W, 4): rgb weighted sums + weight sum. The footprint window is
    the static K x K pixel block that can be within `radius` of any sample.
    """
    dtype = value.dtype
    radius = cfg.radius
    K = int(math.floor(2.0 * radius + 1.0))  # max pixels per axis within radius
    two_inv_radius = 2.0 / radius

    x, y = px[:, 0], px[:, 1]
    x0 = torch.floor(x + 0.5 - radius).to(torch.int64)
    y0 = torch.floor(y + 0.5 - radius).to(torch.int64)
    x1 = torch.floor(x - 0.5 + radius).to(torch.int64)
    y1 = torch.floor(y - 0.5 + radius).to(torch.int64)

    acc = torch.zeros((cfg.height * cfg.width, 4), dtype=dtype, device=value.device)
    for dy in range(K):
        yy = y0 + dy
        wy = filter_eval(cfg.filter_name, two_inv_radius * torch.abs(yy.to(dtype) + 0.5 - y))
        in_y = (yy >= 0) & (yy < cfg.height) & (yy <= y1)
        for dx in range(K):
            xx = x0 + dx
            wx = filter_eval(cfg.filter_name, two_inv_radius * torch.abs(xx.to(dtype) + 0.5 - x))
            in_x = (xx >= 0) & (xx < cfg.width) & (xx <= x1)
            w = torch.where(in_x & in_y, wx * wy, torch.zeros_like(wx))
            idx = torch.clamp(yy, 0, cfg.height - 1) * cfg.width + torch.clamp(xx, 0, cfg.width - 1)
            acc.index_add_(0, idx, torch.cat([value * w[:, None], w[:, None]], dim=-1))
    return acc.reshape(cfg.height, cfg.width, 4)


def scan(acc):
    """(H, W, 4) accumulator -> (H, W, 3) image: weighted mean, clamped at 0."""
    w = acc[..., 3:4]
    safe_w = torch.where(w == 0.0, torch.ones_like(w), w)
    return torch.clamp(acc[..., :3] / safe_w, min=0.0)
