"""A scene kind: a displaced height field under one light, built in memory
from the configuration's "grid_n" and the traffic's image.

A frozen copy of mcrt_tpu_torch/scene/synthetic.height_field_scene: 2 n^2
triangles over [0, 10]^2 in the x-z plane, y up, a diffuse half and a GGX
half, a glass sphere and an emissive sphere, in the reference schema. The
same dict goes to the port and to the reference.
"""
from __future__ import annotations

import numpy as np


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


def build(config: dict, traffic: dict) -> dict:
    """The scene dict of a configuration whose "scene" is "height_field"."""
    return height_field_scene(config["grid_n"], traffic["width"], traffic["sqrtspp"],
                              photon_map=config.get("photon_map"))
