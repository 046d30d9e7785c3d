"""Frozen copy of mcrt_tpu_torch/scene/loader.py for the benchmark's plain reference:
later changes to the port do not reach it.

Scene loading: a reference-schema scene dict -> flat SoA torch tables.

Only the part of the schema that the benchmark's scenes use is kept: named
vertex sets with "object" surfaces of triangles, spheres at a "position",
materials with numeric (RGB) values, and cameras. Anything else raises.
Mesh surfaces are accumulated a surface at a time, so a mesh of millions of
triangles loads in seconds. `Scene.tables()` builds the torch `SceneTables`
on a given device and dtype; the quadric tables stay empty. BVH construction
is left out: the reference finds closest hits by closest_hit.py.

Surface global-id space: [0, T) triangles, [T, T+S) spheres.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import numpy as np
import torch

EPSILON = 1e-9


# ----------------------------------------------------------------------------------
# Materials
# ----------------------------------------------------------------------------------

@dataclasses.dataclass
class MaterialDef:
    reflectance: np.ndarray = dataclasses.field(default_factory=lambda: np.ones(3))
    specular_reflectance: np.ndarray = dataclasses.field(default_factory=lambda: np.ones(3))
    transmittance: np.ndarray = dataclasses.field(default_factory=lambda: np.ones(3))
    emittance: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))
    roughness: float = 0.0
    specular_roughness: float = 0.0
    ior: float = -1.0
    transparency: float = 0.0
    perfect_mirror: bool = False
    has_complex_ior: bool = False
    complex_real: np.ndarray = dataclasses.field(default_factory=lambda: np.ones(3))
    complex_imag: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros(3))

    # Derived flags (reference material.cpp:97-111)
    @property
    def rough(self):
        return self.roughness > EPSILON

    @property
    def rough_specular(self):
        return self.specular_roughness > EPSILON

    @property
    def opaque(self):
        return self.transparency < EPSILON or self.has_complex_ior or self.perfect_mirror

    @property
    def emissive(self):
        return float(np.max(self.emittance)) > EPSILON

    @property
    def dirac_delta(self):
        return (
            self.has_complex_ior or self.perfect_mirror or abs(self.transparency - 1.0) < EPSILON
        ) and not self.rough_specular


def _parse_vec3(value) -> np.ndarray:
    """JSON scalar or 3-array -> vec3 (reference util.cpp glm::from_json)."""
    arr = np.asarray(value, dtype=np.float64)
    if arr.ndim == 0:
        return np.full(3, float(arr))
    return arr.reshape(3)


def _gamma_expand(v):
    v = np.asarray(v, dtype=np.float64)
    return np.where(v <= 0.04045, v / 12.92, np.power((v + 0.055) / 1.055, 2.4))


def _unsupported(what):
    raise ValueError(f"{what} is not in the benchmark's scene schema")


def _parse_color(j: dict, field: str, default: np.ndarray) -> np.ndarray:
    if field not in j:
        return default
    if isinstance(j[field], (str, dict)):
        _unsupported(f"material {field} {j[field]!r}")
    return _parse_vec3(j[field])


def parse_material(j: dict) -> MaterialDef:
    m = MaterialDef()
    m.roughness = float(j.get("roughness", m.roughness))
    m.specular_roughness = float(j.get("specular_roughness", m.specular_roughness))
    m.transparency = float(j.get("transparency", m.transparency))
    m.perfect_mirror = bool(j.get("perfect_mirror", m.perfect_mirror))
    m.reflectance = _parse_color(j, "reflectance", m.reflectance)
    m.specular_reflectance = _parse_color(j, "specular_reflectance", m.specular_reflectance)
    m.transmittance = _parse_color(j, "transmittance", m.transmittance)
    # Only `reflectance` is gamma-expanded (reference material.cpp:150).
    m.reflectance = _gamma_expand(m.reflectance)
    m.emittance = _parse_color(j, "emittance", m.emittance)
    if "ior" in j:
        if isinstance(j["ior"], (str, dict)):
            _unsupported(f"material ior {j['ior']!r}")
        m.ior = float(j["ior"])
    return m


# ----------------------------------------------------------------------------------
# Device tables
# ----------------------------------------------------------------------------------

class SceneTables(NamedTuple):
    """Flat tensors the integrator consumes, all on one device."""

    # Triangles
    tri_v0: Any
    tri_e1: Any
    tri_e2: Any
    tri_n: Any       # geometric normal, normalized
    tri_vn: Any      # (T, 3, 3) vertex normals (rows = n0, n1, n2)
    tri_interp: Any  # (T,) bool — interpolate shading normal
    tri_mat: Any     # (T,) int32
    # Spheres
    sph_origin: Any
    sph_radius: Any
    sph_mat: Any
    # Quadrics
    quad_Q: Any       # (Q, 4, 4)
    quad_G: Any       # (Q, 3, 4) gradient matrix (2 * upper 3 rows of Q, row-major)
    quad_bb_min: Any
    quad_bb_max: Any
    quad_mat: Any
    # Per-surface (global id order: tris, spheres, quadrics)
    surf_area: Any
    surf_mat: Any            # (N,) int32 material row
    surf_radiosity: Any      # (N, 3) emitted radiosity (flux / area), 0 if non-emissive
    surf_emissive_idx: Any   # (N,) int32 index into light arrays, -1 if none
    # Materials
    mat_reflectance: Any
    mat_specular_reflectance: Any
    mat_transmittance: Any
    mat_roughness: Any
    mat_specular_roughness: Any
    mat_transparency: Any
    mat_ior: Any
    mat_perfect_mirror: Any
    mat_has_complex: Any
    mat_complex_real: Any
    mat_complex_imag: Any
    mat_rough: Any
    mat_rough_specular: Any
    mat_opaque: Any
    mat_dirac_delta: Any
    mat_oren_A: Any
    mat_oren_B: Any
    # Lights (gather-ready copies of the emissive surfaces' geometry)
    light_surf: Any         # (E,) int32 global surface id
    light_cdf: Any          # (E,) normalized cumulative importance
    light_select_prob: Any  # (E,)
    light_kind: Any         # (E,) int32: 0 = triangle, 1 = sphere
    light_p0: Any           # (E,3) tri v0 / sphere origin
    light_p1: Any           # (E,3) tri v1 / (unused)
    light_p2: Any           # (E,3) tri v2 / (radius in [:,0])
    light_normal: Any       # (E,3) tri geometric normal (spheres: per-point)
    light_area: Any         # (E,)
    light_radiosity: Any    # (E,3)
    # Scene
    ior: Any
    bb_min: Any
    bb_max: Any


@dataclasses.dataclass(frozen=True)
class SceneMeta:
    """Static facts about the scene (shapes and id offsets)."""
    n_tris: int
    n_sphs: int
    n_quads: int
    n_lights: int
    has_lights: bool
    sphere_offset: int  # global id offset of spheres
    quad_offset: int


# ----------------------------------------------------------------------------------
# Cameras
# ----------------------------------------------------------------------------------

@dataclasses.dataclass
class CameraDef:
    eye: np.ndarray
    forward: np.ndarray
    left: np.ndarray
    up: np.ndarray
    focal_length: float  # meters
    sensor_width: float  # meters
    sqrtspp: int
    width: int
    height: int
    savename: str
    aperture_radius: float
    focus_distance: float
    thin_lens: bool
    image: dict          # raw image json block (tonemapper, exposure, plain, ...)
    film: dict | None    # raw film json block (filter, radius, ...)


def _look_at_basis(eye, p):
    forward = p - eye
    forward = forward / np.linalg.norm(forward)
    left = np.cross(np.array([0.0, 1.0, 0.0]), forward)
    n = np.linalg.norm(left)
    left = np.array([-1.0, 0.0, 0.0]) if n < EPSILON else left / n
    up = np.cross(forward, left)
    up = up / np.linalg.norm(up)
    return forward, left, up


def parse_camera(c: dict) -> CameraDef:
    eye = _parse_vec3(c["eye"])
    focal_length = float(c["focal_length"]) / 1000.0
    sensor_width = float(c["sensor_width"]) / 1000.0
    aperture_radius = (focal_length / float(c.get("f_stop", -1.0))) / 2.0
    focus_distance = float(c.get("focus_distance", -1.0))
    if "look_at" in c:
        look_at = _parse_vec3(c["look_at"])
        forward, left, up = _look_at_basis(eye, look_at)
        if focus_distance < 0.0:
            focus_distance = float(np.linalg.norm(eye - look_at))
    else:
        forward = _parse_vec3(c["forward"])
        forward = forward / np.linalg.norm(forward)
        up = _parse_vec3(c["up"])
        up = up / np.linalg.norm(up)
        left = np.cross(up, forward)
        left = left / np.linalg.norm(left)
    img = c["image"]
    return CameraDef(
        eye=eye, forward=forward, left=left, up=up,
        focal_length=focal_length, sensor_width=sensor_width,
        sqrtspp=int(c["sqrtspp"]), width=int(img["width"]), height=int(img["height"]),
        savename=str(c.get("savename", "render")),
        aperture_radius=aperture_radius, focus_distance=focus_distance,
        thin_lens=aperture_radius > 0.0 and focus_distance > 0.0,
        image=dict(img), film=dict(c["film"]) if "film" in c else None,
    )


# ----------------------------------------------------------------------------------
# Scene
# ----------------------------------------------------------------------------------

def _cat(blocks, tail):
    return np.concatenate(blocks, axis=0) if blocks else np.zeros((0,) + tail)


class Scene:
    """Host-side parsed scene. `.tables(dtype, device)` produces the torch tables."""

    def __init__(self, j: dict):
        self.ior = float(j.get("ior", 1.0))
        self.cameras = [parse_camera(c) for c in j.get("cameras", [])]

        named_materials = {name: parse_material(mj) for name, mj in j.get("materials", {}).items()}
        if "default" not in named_materials:
            named_materials["default"] = MaterialDef()

        # Materials table rows; emissive surfaces get their radiosity stored
        # per-surface, so materials can stay shared.
        self._materials: list[MaterialDef] = []
        self._mat_index: dict[int, int] = {}

        def mat_id(m: MaterialDef) -> int:
            key = id(m)
            if key not in self._mat_index:
                self._mat_index[key] = len(self._materials)
                self._materials.append(m)
            return self._mat_index[key]

        vertex_sets = {
            name: np.asarray(v, dtype=np.float64).reshape(-1, 3)
            for name, v in j.get("vertices", {}).items()
        }

        # Accumulators, one block per surface, concatenated in surface order.
        tri_p = []       # (Ti, 3, 3) vertices p0, p1, p2
        tri_vn = []      # (Ti, 3, 3) vertex normals (zeros where not interpolated)
        tri_interp = []  # (Ti,) bool
        tri_mats = []    # (Ti,) int32
        tri_flux = []    # (Ti, 3) emitted flux per triangle — 0 if non-emissive
        sph = []         # (origin, radius, mat, flux)

        for s in j.get("surfaces", []):
            material = named_materials[s.get("material", "default")]
            mid = mat_id(material)
            stype = s["type"]
            if "scale" in s or "rotation" in s or (stype != "sphere" and "position" in s):
                _unsupported(f"a transformed {stype}")
            if stype == "object":
                if "file" in s or s.get("smooth", False):
                    _unsupported("an OBJ file or smooth normals")
                v = vertex_sets[s["vertex_set"]]
                tv = np.asarray(s["triangles"], dtype=np.int64).reshape(-1, 3)
                p0, p1, p2 = v[tv[:, 0]], v[tv[:, 1]], v[tv[:, 2]]
                nt = len(tv)
                areas = 0.5 * np.linalg.norm(np.cross(p1 - p0, p2 - p0), axis=-1)
                total_area = float(np.sum(areas)) if material.emissive else 0.0
                tri_p.append(np.stack([p0, p1, p2], axis=1).reshape(nt, 3, 3))
                tri_vn.append(np.zeros((nt, 3, 3)))
                tri_interp.append(np.zeros(nt, bool))
                tri_mats.append(np.full(nt, mid, np.int32))
                if material.emissive and total_area > EPSILON:
                    # Object flux split across triangles by area (scene.cpp:77-94)
                    tri_flux.append(material.emittance[None, :] * (areas / total_area)[:, None])
                else:
                    tri_flux.append(np.zeros((nt, 3)))
            elif stype == "sphere":
                sph.append((_parse_vec3(s.get("position", 0.0)), float(s["radius"]), mid,
                            material.emittance if material.emissive else np.zeros(3)))
            else:
                _unsupported(f"surface type {stype!r}")

        # ---- pack numpy SoA ----
        tri_p = _cat(tri_p, (3, 3)).astype(np.float64)
        T, S, Qn = len(tri_p), len(sph), 0
        self.n_tris, self.n_sphs, self.n_quads = T, S, Qn

        def pack3(rows):
            return np.array(rows, dtype=np.float64).reshape(-1, 3) if rows else np.zeros((0, 3))

        self.tri_v0 = np.ascontiguousarray(tri_p[:, 0])
        tri_v1 = tri_p[:, 1]
        tri_v2 = tri_p[:, 2]
        self.tri_e1 = tri_v1 - self.tri_v0
        self.tri_e2 = tri_v2 - self.tri_v0
        cr = np.cross(self.tri_e1, self.tri_e2) if T else np.zeros((0, 3))
        cl = np.linalg.norm(cr, axis=-1, keepdims=True) if T else np.zeros((0, 1))
        self.tri_n = cr / np.maximum(cl, 1e-300)
        self.tri_area = cl[:, 0] * 0.5 if T else np.zeros(0)
        self.tri_interp = _cat(tri_interp, ()).astype(bool)
        # Non-interpolated triangles carry their geometric normal in all three rows.
        self.tri_vn = np.where(self.tri_interp[:, None, None], _cat(tri_vn, (3, 3)),
                               self.tri_n[:, None, :])
        self.tri_mat = _cat(tri_mats, ()).astype(np.int32)
        tri_flux = _cat(tri_flux, (3,)).astype(np.float64)

        self.sph_origin = pack3([x[0] for x in sph])
        self.sph_radius = np.array([x[1] for x in sph], dtype=np.float64)
        self.sph_mat = np.array([x[2] for x in sph], dtype=np.int32)
        self.sph_area = 4.0 * np.pi * self.sph_radius ** 2
        sph_flux = pack3([x[3] for x in sph])

        self.surf_area = np.concatenate([self.tri_area, self.sph_area])
        self.surf_mat = np.concatenate([self.tri_mat, self.sph_mat]).astype(np.int32)
        surf_flux = np.concatenate([tri_flux, sph_flux], axis=0)

        # ---- emissives: sort by max flux desc (stable), build CDF, flux -> radiosity ----
        N = T + S + Qn
        max_flux = np.max(surf_flux, axis=1) if N else np.zeros(0)
        emissive_ids = np.nonzero(max_flux > EPSILON)[0]
        emissive_ids = emissive_ids[np.argsort(-max_flux[emissive_ids], kind="stable")]
        self.light_surf = emissive_ids.astype(np.int32)
        E = len(emissive_ids)
        self.n_lights = E
        imp = max_flux[emissive_ids].astype(np.float64)
        cum = np.cumsum(imp)
        total = cum[-1] if E else 1.0
        self.light_cdf = cum / total if E else np.zeros(0)
        self.light_select_prob = imp / total if E else np.zeros(0)

        self.surf_radiosity = np.zeros((N, 3))
        self.surf_emissive_idx = np.full(N, -1, dtype=np.int32)
        self.surf_radiosity[emissive_ids] = surf_flux[emissive_ids] / self.surf_area[emissive_ids, None]
        self.surf_emissive_idx[emissive_ids] = np.arange(E, dtype=np.int32)
        self.surf_flux = surf_flux

        # Gather-ready light geometry (triangles and spheres)
        self.light_kind = np.zeros(E, dtype=np.int32)
        self.light_p0 = np.zeros((E, 3))
        self.light_p1 = np.zeros((E, 3))
        self.light_p2 = np.zeros((E, 3))
        self.light_normal = np.zeros((E, 3))
        self.light_area = np.ones(E)
        self.light_radiosity = np.zeros((E, 3))
        if E:
            self.light_area[:] = self.surf_area[emissive_ids]
            self.light_radiosity[:] = self.surf_radiosity[emissive_ids]
            is_tri = emissive_ids < T
            ti = emissive_ids[is_tri]
            self.light_kind[is_tri] = 0
            self.light_p0[is_tri] = self.tri_v0[ti]
            self.light_p1[is_tri] = self.tri_v0[ti] + self.tri_e1[ti]
            self.light_p2[is_tri] = self.tri_v0[ti] + self.tri_e2[ti]
            self.light_normal[is_tri] = self.tri_n[ti]
            si = emissive_ids[~is_tri] - T
            self.light_kind[~is_tri] = 1
            self.light_p0[~is_tri] = self.sph_origin[si]
            self.light_p2[~is_tri, 0] = self.sph_radius[si]

        # ---- scene bounding box ----
        mins, maxs = [], []
        if T:
            mins.append(np.min(np.minimum(np.minimum(self.tri_v0, tri_v1), tri_v2), axis=0))
            maxs.append(np.max(np.maximum(np.maximum(self.tri_v0, tri_v1), tri_v2), axis=0))
        if S:
            mins.append(np.min(self.sph_origin - self.sph_radius[:, None], axis=0))
            maxs.append(np.max(self.sph_origin + self.sph_radius[:, None], axis=0))
        self.bb_min = np.min(np.stack(mins), axis=0) if mins else np.zeros(3)
        self.bb_max = np.max(np.stack(maxs), axis=0) if maxs else np.zeros(3)

        self.materials = self._materials

    def meta(self) -> SceneMeta:
        return SceneMeta(
            n_tris=self.n_tris, n_sphs=self.n_sphs, n_quads=self.n_quads,
            n_lights=self.n_lights, has_lights=self.n_lights > 0,
            sphere_offset=self.n_tris, quad_offset=self.n_tris + self.n_sphs,
        )

    def table_arrays(self) -> dict[str, np.ndarray]:
        """Every SceneTables field as a host numpy array (float64 / int32 / bool),
        padded exactly as the JAX package pads empty tables."""
        mats = self.materials
        if not mats:
            mats = [MaterialDef()]

        def mstack(fn, dtype=np.float64):
            return np.stack([np.asarray(fn(m), dtype=np.float64) for m in mats]).astype(dtype)

        rough_var = np.array([m.roughness ** 2 for m in mats])
        oren_A = 1.0 - 0.5 * (rough_var / (rough_var + 0.33))
        oren_B = 0.45 * (rough_var / (rough_var + 0.09))

        # Pad empty tables to 1 row so gathers stay valid; meta gates their use.
        nt, ns, nl = self.n_tris, self.n_sphs, self.n_lights

        def pad(arr, n, fill):
            return arr if n else fill

        i32 = lambda x: np.asarray(x, np.int32)
        return dict(
            tri_v0=pad(self.tri_v0, nt, np.zeros((1, 3))),
            tri_e1=pad(self.tri_e1, nt, np.zeros((1, 3))),
            tri_e2=pad(self.tri_e2, nt, np.zeros((1, 3))),
            tri_n=pad(self.tri_n, nt, np.zeros((1, 3))),
            tri_vn=pad(self.tri_vn, nt, np.zeros((1, 3, 3))),
            tri_interp=pad(self.tri_interp, nt, np.zeros(1, bool)),
            tri_mat=i32(pad(self.tri_mat, nt, np.zeros(1))),
            sph_origin=pad(self.sph_origin, ns, np.zeros((1, 3))),
            sph_radius=pad(self.sph_radius, ns, np.ones(1)),
            sph_mat=i32(pad(self.sph_mat, ns, np.zeros(1))),
            quad_Q=np.zeros((1, 4, 4)),
            quad_G=np.zeros((1, 3, 4)),
            quad_bb_min=np.zeros((1, 3)),
            quad_bb_max=np.zeros((1, 3)),
            quad_mat=np.zeros(1, np.int32),
            surf_area=pad(self.surf_area, len(self.surf_area), np.ones(1)),
            surf_mat=i32(pad(self.surf_mat, len(self.surf_mat), np.zeros(1))),
            surf_radiosity=pad(self.surf_radiosity, len(self.surf_radiosity), np.zeros((1, 3))),
            surf_emissive_idx=i32(pad(self.surf_emissive_idx, len(self.surf_emissive_idx),
                                      -np.ones(1))),
            mat_reflectance=mstack(lambda m: m.reflectance),
            mat_specular_reflectance=mstack(lambda m: m.specular_reflectance),
            mat_transmittance=mstack(lambda m: m.transmittance),
            mat_roughness=mstack(lambda m: m.roughness),
            mat_specular_roughness=mstack(lambda m: m.specular_roughness),
            mat_transparency=mstack(lambda m: m.transparency),
            mat_ior=mstack(lambda m: m.ior),
            mat_perfect_mirror=mstack(lambda m: m.perfect_mirror, bool),
            mat_has_complex=mstack(lambda m: m.has_complex_ior, bool),
            mat_complex_real=mstack(lambda m: m.complex_real),
            mat_complex_imag=mstack(lambda m: m.complex_imag),
            mat_rough=mstack(lambda m: m.rough, bool),
            mat_rough_specular=mstack(lambda m: m.rough_specular, bool),
            mat_opaque=mstack(lambda m: m.opaque, bool),
            mat_dirac_delta=mstack(lambda m: m.dirac_delta, bool),
            mat_oren_A=oren_A,
            mat_oren_B=oren_B,
            light_surf=i32(pad(self.light_surf, nl, np.zeros(1))),
            light_cdf=pad(self.light_cdf, nl, np.ones(1)),
            light_select_prob=pad(self.light_select_prob, nl, np.ones(1)),
            light_kind=i32(pad(self.light_kind, nl, np.zeros(1))),
            light_p0=pad(self.light_p0, nl, np.zeros((1, 3))),
            light_p1=pad(self.light_p1, nl, np.zeros((1, 3))),
            light_p2=pad(self.light_p2, nl, np.ones((1, 3))),
            light_normal=pad(self.light_normal, nl, np.zeros((1, 3))),
            light_area=pad(self.light_area, nl, np.ones(1)),
            light_radiosity=pad(self.light_radiosity, nl, np.zeros((1, 3))),
            ior=np.asarray(self.ior),
            bb_min=self.bb_min,
            bb_max=self.bb_max,
        )

    def tables(self, dtype=torch.float32, device="cpu") -> SceneTables:
        """SceneTables on `device`: float fields in `dtype`, ids int32, flags
        bool (the port's convert.tables_from_numpy)."""
        def conv(x):
            x = np.array(x)   # a private, writable copy
            if x.dtype == np.bool_:
                return torch.as_tensor(x, device=device)
            if np.issubdtype(x.dtype, np.integer):
                return torch.as_tensor(x.astype(np.int32), device=device)
            return torch.as_tensor(x.astype(np.float64), device=device).to(dtype)

        fields = self.table_arrays()
        return SceneTables(**{name: conv(fields[name]) for name in SceneTables._fields})

