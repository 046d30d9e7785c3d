"""HDR image post-processing: auto-exposure/gain, tonemapping, sRGB, TGA output.

Parity with the reference's source/camera/{image,pixel-operators}.cpp and
source/common/histogram.cpp: histogram auto-exposure (median brightness -> 0.5 over
65536 bins), auto-gain (99th percentile -> 0.99 post-tonemap), EV compensation,
Hable / ACES-fitted / linear ("plain") tonemappers, sRGB gamma, uncompressed 24bpp
top-left-origin TGA. Host-side numpy — runs once per render.
"""
from __future__ import annotations

import numpy as np

from ..color import cie


def tonemap_hable(x):
    A, B, C, D, E, F, W = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30, 11.2

    def f(v):
        return ((v * (A * v + C * B) + D * E) / (v * (A * v + B) + D * F)) - E / F

    return f(x) / f(np.full_like(x, W))


def tonemap_aces(x):
    # ACES-fitted (Hill/Narkowicz): input/output matrices + RRT/ODT rational fit.
    in_mat = np.array(
        [
            [0.59719, 0.35458, 0.04823],
            [0.07600, 0.90834, 0.01566],
            [0.02840, 0.13383, 0.83777],
        ]
    )
    out_mat = np.array(
        [
            [1.60475, -0.53108, -0.07367],
            [-0.10208, 1.10813, -0.00605],
            [-0.00327, -0.07276, 1.07602],
        ]
    )
    v = x @ in_mat.T
    a = v * (v + 0.0245786) - 0.000090537
    b = v * (0.983729 * v + 0.4329510) + 0.238081
    return np.clip((a / b) @ out_mat.T, 0.0, 1.0)


def tonemap_linear(x):
    return x


TONEMAPPERS = {"HABLE": tonemap_hable, "ACES": tonemap_aces, "LINEAR": tonemap_linear}


def _histogram_level(brightness: np.ndarray, pct: float, num_bins: int = 65536) -> float:
    """Value below which `pct` of the data falls (reference histogram.cpp:25-40)."""
    data = brightness.ravel()
    if np.any(data < 0.0):
        return 0.0
    mx = float(np.max(data)) if data.size else 0.0
    if mx <= 0.0:
        return 0.0
    bin_size = mx / num_bins
    counts, _ = np.histogram(data, bins=num_bins, range=(0.0, mx))
    target = int(data.size * pct)
    cum = np.cumsum(counts)
    i = int(np.searchsorted(cum, target))
    if i >= num_bins:
        i = num_bins - 1
    return (i + 1) * bin_size


def auto_exposure(hdr: np.ndarray) -> float:
    """Exposure factor putting median brightness at 0.5 (image.cpp:63-73)."""
    brightness = np.sum(hdr, axis=-1) / 3.0
    level = _histogram_level(brightness, 0.5)
    return 0.5 / level if level > 0.0 else 1.0


def auto_gain(hdr: np.ndarray, exposure_factor: float, tonemap) -> float:
    """Gain putting the 99th percentile of the tonemapped image at 0.99 (image.cpp:78-88)."""
    brightness = np.sum(tonemap(hdr * exposure_factor), axis=-1) / 3.0
    level = _histogram_level(brightness, 0.99)
    return 0.99 / level if level > 0.0 else 1.0


def finalize(hdr: np.ndarray, image_cfg: dict) -> np.ndarray:
    """HDR (H,W,3) -> display-referred linear->gamma sRGB floats in [0,1]."""
    plain = bool(image_cfg.get("plain", False))
    exposure_scale = 2.0 ** float(image_cfg.get("exposure_compensation", 0.0))
    gain_scale = 2.0 ** float(image_cfg.get("gain_compensation", 0.0))
    name = str(image_cfg.get("tonemapper", "HABLE")).upper()
    tonemap = tonemap_linear if plain else TONEMAPPERS.get(name, tonemap_hable)

    hdr = np.asarray(hdr, dtype=np.float64)
    exposure = 1.0 if plain else auto_exposure(hdr) * exposure_scale
    gain = 1.0 if plain else auto_gain(hdr, exposure, tonemap) * gain_scale
    return cie.gamma_compress(tonemap(hdr * exposure) * gain)


def write_tga(path, srgb: np.ndarray):
    """Uncompressed 24bpp true-color TGA, top-left origin (image.hpp:39-49)."""
    h, w = srgb.shape[:2]
    header = bytearray(18)
    header[2] = 2
    header[12] = w & 0xFF
    header[13] = (w >> 8) & 0xFF
    header[14] = h & 0xFF
    header[15] = (h >> 8) & 0xFF
    header[16] = 24
    header[17] = 32  # top-left origin
    c = np.clip(srgb, 0.0, 1.0) * np.nextafter(256.0, 0.0)
    bgr = c[..., ::-1].astype(np.uint8)
    with open(str(path), "wb") as f:
        f.write(bytes(header))
        f.write(bgr.tobytes())


def read_tga(path):
    """Read back an uncompressed 24bpp TGA as (H,W,3) uint8 RGB (testing aid)."""
    raw = np.fromfile(str(path), dtype=np.uint8)
    w = int(raw[12]) | (int(raw[13]) << 8)
    h = int(raw[14]) | (int(raw[15]) << 8)
    descr = raw[17]
    body = raw[18 : 18 + w * h * 3].reshape(h, w, 3)
    rgb = body[..., ::-1]
    if not (descr & 0x20):  # bottom-left origin -> flip
        rgb = rgb[::-1]
    return rgb
