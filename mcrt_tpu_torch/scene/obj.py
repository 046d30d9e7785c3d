"""Wavefront OBJ parsing (host-side numpy).

Covers what the reference scene loader consumes (reference source/scene/scene.cpp:238-323):
v / vn / f records, 1-based indices, `v`, `v/vt`, `v//vn`, `v/vt/vn` face forms,
triangles only. Also provides area+angle-weighted smooth vertex-normal generation
(scene.cpp:325-355).
"""
from __future__ import annotations

import numpy as np


def parse_obj(path):
    """Returns (vertices (V,3) f64, normals (N,3) f64, tri_v (T,3) int64, tri_vn (T,3) int64 or None).

    A missing file yields empty geometry with a warning, matching the reference's
    print-and-continue behavior (scene.cpp:245-249)."""
    import os
    import sys

    if not os.path.exists(path):
        print(f"{path} not found.", file=sys.stderr)
        return (np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0, 3), np.int64), None)

    from ..native import parse_obj_native

    native = parse_obj_native(path)
    if native is not None:
        v, n, tv, tn = native
        if len(tv) and (tv.min() < 0 or (tn is not None and len(tn) and tn.min() < 0)):
            raise ValueError("OBJ files with negative offsets are not supported.")
        return v, n, tv, tn

    vertices, normals = [], []
    tris_v, tris_vn = [], []
    with open(path, "r", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "v":
                vertices.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif tag == "vn":
                normals.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif tag == "f":
                fv, fn = [], []
                for element in parts[1:4]:
                    idxs = element.split("/")
                    if idxs[0].lstrip("-").isdigit() and int(idxs[0]) < 0:
                        raise ValueError("OBJ files with negative offsets are not supported.")
                    fv.append(int(idxs[0]) - 1)
                    if len(idxs) == 3 and idxs[2]:
                        fn.append(int(idxs[2]) - 1)
                if len(fv) == 3:
                    tris_v.append(fv)
                if len(fn) == 3:
                    tris_vn.append(fn)

    v = np.array(vertices, dtype=np.float64).reshape(-1, 3)
    n = np.array(normals, dtype=np.float64).reshape(-1, 3)
    tv = np.array(tris_v, dtype=np.int64).reshape(-1, 3)
    tn = np.array(tris_vn, dtype=np.int64).reshape(-1, 3) if len(tris_vn) == len(tris_v) and tris_vn else None
    return v, n, tv, tn


def generate_vertex_normals(vertices: np.ndarray, tris: np.ndarray) -> np.ndarray:
    """Area- and angle-weighted smooth vertex normals (reference scene.cpp:325-355)."""
    normals = np.zeros_like(vertices)
    v0 = vertices[tris[:, 0]]
    v1 = vertices[tris[:, 1]]
    v2 = vertices[tris[:, 2]]
    cross = np.cross(v1 - v0, v2 - v0)
    cross_len = np.linalg.norm(cross, axis=-1, keepdims=True)
    face_n = cross / np.maximum(cross_len, 1e-300)
    area = cross_len[:, 0] * 0.5
    awn = face_n * area[:, None]

    def angle(a, b):
        an = a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-300)
        bn = b / np.maximum(np.linalg.norm(b, axis=-1, keepdims=True), 1e-300)
        return np.arccos(np.clip(np.sum(an * bn, axis=-1), -1.0, 1.0))

    w0 = angle(v0 - v1, v0 - v2)
    w1 = angle(v1 - v0, v1 - v2)
    w2 = angle(v2 - v0, v2 - v1)
    np.add.at(normals, tris[:, 0], awn * w0[:, None])
    np.add.at(normals, tris[:, 1], awn * w1[:, None])
    np.add.at(normals, tris[:, 2], awn * w2[:, None])
    norm = np.linalg.norm(normals, axis=-1, keepdims=True)
    return normals / np.maximum(norm, 1e-300)
