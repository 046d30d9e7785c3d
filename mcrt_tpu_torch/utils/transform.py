"""TRS transforms for scene surfaces (host-side numpy).

Capability parity with the reference's Transform (reference source/common/util.cpp:17-34):
matrix = translate(p) @ rotZ @ rotY @ rotX @ scale(s); normals transform by the rotation
applied to n/scale; negative-determinant scales flip triangle winding.
"""
from __future__ import annotations

import numpy as np


def _rot(axis: int, angle: float) -> np.ndarray:
    """Right-handed rotation about x(0), y(1), or z(2) as a 4x4 matrix."""
    c, s = np.cos(angle), np.sin(angle)
    if axis == 0:
        return np.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1.0]])
    if axis == 1:
        return np.array([[c, 0, s, 0], [0, 1, 0, 0], [-s, 0, c, 0], [0, 0, 0, 1.0]])
    return np.array([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1.0]])


class Transform:
    def __init__(self, position, scale, rotation_radians):
        self.position = np.asarray(position, dtype=np.float64)
        self.scale = np.asarray(scale, dtype=np.float64)
        self.rotation = np.asarray(rotation_radians, dtype=np.float64)
        self.negative_determinant = bool(np.prod(self.scale) < 0.0)

        rz, ry, rx = _rot(2, self.rotation[2]), _rot(1, self.rotation[1]), _rot(0, self.rotation[0])
        self.rotation_matrix = rz @ ry @ rx

        t = np.eye(4)
        t[:3, 3] = self.position
        s = np.diag([self.scale[0], self.scale[1], self.scale[2], 1.0])
        self.matrix = t @ self.rotation_matrix @ s

    def points(self, p: np.ndarray) -> np.ndarray:
        """Transform (N,3) points."""
        return p @ self.matrix[:3, :3].T + self.matrix[:3, 3]

    def normals(self, n: np.ndarray) -> np.ndarray:
        """Transform (N,3) normals: rotate(normalize(n / scale))."""
        n = np.asarray(n, dtype=np.float64)
        scaled = n / self.scale
        scaled /= np.linalg.norm(scaled, axis=-1, keepdims=True)
        return scaled @ self.rotation_matrix[:3, :3].T
