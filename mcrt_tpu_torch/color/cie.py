"""CIE colorimetry: spectral -> XYZ -> sRGB, illuminant white points, blackbody.

Capability parity with the reference's header-only color layer
(reference source/color/{cie,cmf,d65,illuminant,spectral,srgb}.hpp), re-done as
vectorized numpy over the public CIE 1931 2-deg CMF table (1nm, 360-830nm) and the D65
SPD (5nm, 300-830nm). All of this runs host-side at scene-load time; the renderer's
device hot path only ever sees the resulting linear-sRGB triples.

Midpoint Riemann integration over the CMF support matches the reference's
`CIE::XYZ(distribution, type)` (cie.hpp:45-55): wavelengths sampled at
360.5, 361.5, ..., 829.5 nm, piecewise-linear interpolation of both the CMF and the
input distribution, with REFLECTANCE weighting by D65 and normalization by the
integrated illuminant luminance.
"""
from __future__ import annotations

import enum
import pathlib

import numpy as np

_DATA = pathlib.Path(__file__).resolve().parent / "data"

# Column 0: wavelength [nm]; columns 1-3: xbar, ybar, zbar
CMF = np.load(_DATA / "cmf_1931_2deg.npy")
# Column 0: wavelength [nm]; column 1: relative SPD
D65 = np.load(_DATA / "d65.npy")

CMF_A, CMF_B, CMF_DW = CMF[0, 0], CMF[-1, 0], CMF[1, 0] - CMF[0, 0]

# Midpoint sample wavelengths used for every spectral integral (matches the
# reference's `for (w = CMF.a + 0.5*dw; w < CMF.b; w += dw)` loop).
_WL_MID = np.arange(CMF_A + 0.5 * CMF_DW, CMF_B, CMF_DW)


def _lerp_table(w, table_w, table_v):
    """Piecewise-linear sample of a tabulated function, clamped at the ends."""
    w = np.asarray(w, dtype=np.float64)
    idx = np.clip(np.searchsorted(table_w, w, side="right") - 1, 0, len(table_w) - 2)
    w0, w1 = table_w[idx], table_w[idx + 1]
    t = np.clip((w - w0) / (w1 - w0), 0.0, 1.0)
    v0, v1 = table_v[idx], table_v[idx + 1]
    if table_v.ndim == 2:
        t = t[..., None]
    return v0 + t * (v1 - v0)


def cmf_at(w):
    """CMF (xbar, ybar, zbar) at wavelength(s) w [nm]."""
    return _lerp_table(w, CMF[:, 0], CMF[:, 1:])


def d65_at(w):
    """D65 relative SPD at wavelength(s) w [nm]."""
    return _lerp_table(w, D65[:, 0], D65[:, 1])


class SpectralType(enum.Enum):
    REFLECTANCE = 0
    RADIANCE = 1


# Integrated tristimulus of the D65 and equal-energy illuminants over the CMF support,
# used for normalization (reference cie.hpp:38-40).
_CMF_MID = cmf_at(_WL_MID)
D65_XYZ = CMF_DW * np.sum(d65_at(_WL_MID)[:, None] * _CMF_MID, axis=0)
E_XYZ = CMF_DW * np.sum(_CMF_MID, axis=0)


def xyz_from_xy(xy, Y=1.0):
    """Chromaticity (x, y) + luminance Y -> XYZ."""
    x, y = xy
    n = Y / y
    return np.array([n * x, Y, n * (1.0 - x - y)], dtype=np.float64)


def xyz_from_spectrum(wavelengths, values, kind: SpectralType):
    """Arbitrary tabulated spectrum -> normalized XYZ (reference cie.hpp:45-55).

    `wavelengths` in nm (ascending), `values` same length. REFLECTANCE spectra are
    weighted by D65 and normalized by D65 luminance; RADIANCE by equal-energy
    luminance.
    """
    wavelengths = np.asarray(wavelengths, dtype=np.float64)
    values = np.asarray(values, dtype=np.float64)
    order = np.argsort(wavelengths)
    wavelengths, values = wavelengths[order], values[order]
    # Endpoint behavior: the reference's Spectral::interpolate clamps to the first/last
    # tabulated value, so we clamp too rather than zeroing outside the support.
    wl = _WL_MID
    v = _lerp_table(wl, wavelengths, values)
    contrib = v[:, None] * _CMF_MID
    if kind == SpectralType.REFLECTANCE:
        contrib = contrib * d65_at(wl)[:, None]
        norm = D65_XYZ[1]
    else:
        norm = E_XYZ[1]
    return CMF_DW * np.sum(contrib, axis=0) / norm


def _srgb_matrices():
    # sRGB primaries + D65 white, matching reference srgb.hpp:11-34 (which derives
    # the matrix from CMF-integrated D65 rather than the standard published one).
    primaries = np.stack(
        [
            xyz_from_xy((0.64, 0.33)),
            xyz_from_xy((0.30, 0.60)),
            xyz_from_xy((0.15, 0.06)),
        ],
        axis=1,
    )
    white = D65_XYZ / D65_XYZ[1]
    s = np.linalg.solve(primaries, white)
    rgb2xyz = primaries * s[None, :]
    return rgb2xyz, np.linalg.inv(rgb2xyz)


RGB2XYZ, XYZ2RGB = _srgb_matrices()


def srgb_from_xyz(xyz):
    return np.asarray(xyz, dtype=np.float64) @ XYZ2RGB.T


def xyz_from_srgb(rgb):
    return np.asarray(rgb, dtype=np.float64) @ RGB2XYZ.T


def srgb_from_spectrum(wavelengths, values, kind: SpectralType):
    return srgb_from_xyz(xyz_from_spectrum(wavelengths, values, kind))


def gamma_compress(v):
    v = np.asarray(v, dtype=np.float64)
    return np.where(v <= 0.0031308, 12.92 * v, 1.055 * np.power(np.maximum(v, 0.0), 1.0 / 2.4) - 0.055)


def gamma_expand(v):
    v = np.asarray(v, dtype=np.float64)
    return np.where(v <= 0.04045, v / 12.92, np.power((v + 0.055) / 1.055, 2.4))


# CIE standard illuminant white points (chromaticities), reference illuminant.hpp:18-50.
WHITE_POINTS = {
    "A": (0.44757, 0.40745),
    "B": (0.34842, 0.35161),
    "C": (0.31006, 0.31616),
    "D50": (0.34567, 0.35850),
    "D55": (0.33242, 0.34743),
    "D65": (0.31271, 0.32902),
    "D75": (0.29902, 0.31485),
    "E": (1.0 / 3.0, 1.0 / 3.0),
    "F1": (0.31310, 0.33727),
    "F2": (0.37208, 0.37529),
    "F3": (0.40910, 0.39430),
    "F4": (0.44018, 0.40329),
    "F5": (0.31379, 0.34531),
    "F6": (0.37790, 0.38835),
    "F7": (0.31292, 0.32933),
    "F8": (0.34588, 0.35875),
    "F9": (0.37417, 0.37281),
    "F10": (0.34609, 0.35986),
    "F11": (0.38052, 0.37713),
    "F12": (0.43695, 0.40441),
    "LED-B1": (0.45600, 0.40780),
    "LED-B2": (0.43570, 0.40120),
    "LED-B3": (0.37560, 0.37230),
    "LED-B4": (0.34220, 0.35020),
    "LED-B5": (0.31180, 0.32360),
    "LED-BH1": (0.44740, 0.40660),
    "LED-RGB1": (0.45570, 0.42110),
    "LED-V1": (0.45600, 0.45480),
    "LED-V2": (0.37810, 0.37750),
}
_MISSING_XY = (0.32090, 0.15420)


def white_point(name: str):
    """XYZ white point for a named illuminant (Y=1)."""
    return xyz_from_xy(WHITE_POINTS.get(name.upper(), _MISSING_XY), 1.0)


def blackbody_xyz(temperature: float):
    """Normalized (Y=1) tristimulus of a Planck blackbody at T kelvin
    (reference illuminant.hpp:82-102)."""
    w = _WL_MID * 1e-9
    c = 2.99792458e8
    h = 6.626176e-34
    k = 1.380662e-23
    spd = (2.0 * np.pi * h * c * c) / (np.power(w, 5) * (np.exp((h * c / k) / (temperature * w)) - 1.0))
    xyz = np.sum(spd[:, None] * _CMF_MID, axis=0)
    return xyz / xyz[1]
