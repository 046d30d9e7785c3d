"""A synthetic scene built in memory: a displaced height field under one light.

Used where no scene file can be read (tests, the GPU smoke run). The mesh is
`make_displaced_grid` of the repo's scale test, laid in the x-z plane with y up:
2 n^2 triangles over [0, 10]^2, split in two surfaces — a diffuse half and a
GGX rough-specular half — plus a glass sphere and an emissive sphere for
next-event estimation. The JSON is the reference schema, with the mesh given
inline as a top-level vertex set and an "object" surface with a "bvh" block,
so both packages' loaders read it unchanged.
"""
from __future__ import annotations

import numpy as np


def make_displaced_grid(n: int):
    """2*n*n triangles over a sinusoidally displaced [0,10]^2 height field:
    (v0, e1, e2) arrays of shape (2 n^2, 3), height in the third coordinate."""
    xs = np.linspace(0.0, 10.0, n + 1)
    gx, gy = np.meshgrid(xs, xs, indexing="ij")
    gz = 0.5 * np.sin(gx * 2.1) * np.cos(gy * 1.7)
    verts = np.stack([gx, gy, gz], axis=-1)          # (n+1, n+1, 3)
    a = verts[:-1, :-1].reshape(-1, 3)
    b = verts[1:, :-1].reshape(-1, 3)
    c = verts[:-1, 1:].reshape(-1, 3)
    d = verts[1:, 1:].reshape(-1, 3)
    v0 = np.concatenate([a, b])
    e1 = np.concatenate([b - a, d - b])
    e2 = np.concatenate([c - a, c - b])
    return v0, e1, e2


def height_field_scene(n: int, width: int, sqrtspp: int, as_lists: bool = False,
                       photon_map: dict | None = None) -> dict:
    """Scene JSON (a dict) with a 2 n^2-triangle height field, rendered by one
    camera at width x width and sqrtspp^2 samples per pixel. Arrays are numpy
    unless `as_lists` (plain JSON values). `photon_map`, if given, is the
    scene's "photon_map" block (emissions, caustic_factor, ...), which the
    photon mapper reads."""
    xs = np.linspace(0.0, 10.0, n + 1)
    gx, gz = np.meshgrid(xs, xs, indexing="ij")
    gy = 0.5 * np.sin(gx * 2.1) * np.cos(gz * 1.7)
    verts = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3)   # y up
    idx = np.arange((n + 1) * (n + 1)).reshape(n + 1, n + 1)
    a, b = idx[:-1, :-1].ravel(), idx[1:, :-1].ravel()
    c, d = idx[:-1, 1:].ravel(), idx[1:, 1:].ravel()
    tris = np.concatenate([np.stack([a, b, c], 1), np.stack([b, d, c], 1)])
    centroid_x = verts[tris].mean(axis=1)[:, 0]
    left, right = tris[centroid_x < 5.0], tris[centroid_x >= 5.0]
    conv = (lambda x: x.tolist()) if as_lists else (lambda x: x)
    extra = {} if photon_map is None else {"photon_map": dict(photon_map)}
    return {
        **extra,
        "ior": 1.0,
        "bvh": {"type": "binary_sah"},
        "cameras": [{
            "focal_length": 30, "sensor_width": 35,
            "eye": [5.0, 5.5, -3.5], "look_at": [5.0, 0.0, 5.5],
            "image": {"width": width, "height": width, "plain": True},
            "sqrtspp": sqrtspp, "savename": "height_field",
        }],
        "vertices": {"field": conv(verts)},
        "materials": {
            "ground": {"reflectance": 0.7},
            "glossy": {"reflectance": [0.3, 0.4, 0.6], "specular_roughness": 0.25,
                       "ior": 1.5},
            "glass": {"transparency": 1.0, "ior": 1.5},
            "light": {"reflectance": 0.0, "emittance": [60.0, 55.0, 50.0]},
        },
        "surfaces": [
            {"type": "object", "material": "ground", "vertex_set": "field", "triangles": conv(left)},
            {"type": "object", "material": "glossy", "vertex_set": "field", "triangles": conv(right)},
            {"type": "sphere", "material": "glass", "radius": 1.1, "position": [5.0, 1.3, 5.0]},
            {"type": "sphere", "material": "light", "radius": 0.6, "position": [3.5, 4.5, 6.5]},
        ],
    }
