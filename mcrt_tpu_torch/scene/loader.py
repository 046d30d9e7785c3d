"""Scene loading: reference-schema JSON -> flat SoA torch tables.

The port's copy of the JAX package's loader. Parsing is the same (materials,
cameras, triangles / spheres / quadrics, emissive light tables); mesh surfaces
are accumulated a surface at a time instead of a triangle at a time, so a
million-triangle mesh loads in seconds. `Scene.tables()` builds the torch
`SceneTables` on a given device and dtype, and `build_cluster_bvh` uploads the
port's cluster BVH for the CUDA traversal kernel.

Surface global-id space: [0, T) triangles, [T, T+S) spheres, [T+S, T+S+Q) quadrics.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Any, NamedTuple

import numpy as np

from ..color import cie
from ..utils.transform import Transform
from . import obj as objmod

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


def _parse_reflectance(j: dict, field: str, default: np.ndarray) -> np.ndarray:
    if field not in j:
        return default
    r = j[field]
    if isinstance(r, str):
        if len(r) == 7 and r[0] == "#":
            i = int(r[1:], 16)
            return np.array([(i >> 16) & 0xFF, (i >> 8) & 0xFF, i & 0xFF], dtype=np.float64) / 255.0
        return default
    return _parse_vec3(r)


def _parse_spectral_csv(path: pathlib.Path):
    """refractiveindex.info-style CSV with `wl,n` / `wl,k` sections; wavelengths in um."""
    real_w, real_v, imag_w, imag_v = [], [], [], []
    kind = "n"
    for line in path.read_text(errors="replace").splitlines():
        p = line.find(",")
        if p < 0:
            continue
        wl = line[:p].replace(" ", "")
        v = line[p + 1:].replace(" ", "")
        if wl == "wl":
            if v in ("n", "k"):
                kind = v
        else:
            try:
                w, val = float(wl) * 1e3, float(v)
            except ValueError:
                continue
            if kind == "n":
                real_w.append(w)
                real_v.append(val)
            else:
                imag_w.append(w)
                imag_v.append(val)
    real = cie.srgb_from_spectrum(real_w, real_v, cie.SpectralType.REFLECTANCE) if real_w else np.ones(3)
    imag = cie.srgb_from_spectrum(imag_w, imag_v, cie.SpectralType.REFLECTANCE) if imag_w else np.zeros(3)
    return real, imag


def parse_material(j: dict, scene_dir: pathlib.Path) -> MaterialDef:
    m = MaterialDef()
    m.roughness = float(j.get("roughness", m.roughness))
    m.specular_roughness = float(j.get("specular_roughness", m.specular_roughness))
    m.transparency = float(j.get("transparency", m.transparency))
    m.perfect_mirror = bool(j.get("perfect_mirror", m.perfect_mirror))
    m.reflectance = _parse_reflectance(j, "reflectance", m.reflectance)
    m.specular_reflectance = _parse_reflectance(j, "specular_reflectance", m.specular_reflectance)
    m.transmittance = _parse_reflectance(j, "transmittance", m.transmittance)
    # Only `reflectance` is gamma-expanded (reference material.cpp:150).
    m.reflectance = cie.gamma_expand(m.reflectance)

    if "emittance" in j:
        e = j["emittance"]
        if isinstance(e, dict):
            scale = float(e.get("scale", 1.0))
            temperature = float(e.get("temperature", -1.0))
            if temperature > 0.0:
                m.emittance = cie.srgb_from_xyz(cie.blackbody_xyz(temperature) * scale)
            else:
                name = str(e.get("illuminant", "D65")).upper()
                m.emittance = cie.srgb_from_xyz(cie.white_point(name) * scale)
        else:
            m.emittance = _parse_vec3(e)

    if "ior" in j:
        i = j["ior"]
        if isinstance(i, dict):
            m.has_complex_ior = True
            m.complex_real = _parse_vec3(i.get("real", 1.0))
            m.complex_imag = _parse_vec3(i.get("imaginary", 0.0))
        elif isinstance(i, str):
            p = scene_dir / i
            if p.exists():
                m.has_complex_ior = True
                m.complex_real, m.complex_imag = _parse_spectral_csv(p)
        else:
            m.ior = float(i)
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

    def __init__(self, json_path_or_dict, scene_dir: pathlib.Path | None = None):
        if isinstance(json_path_or_dict, (str, pathlib.Path)):
            path = pathlib.Path(json_path_or_dict)
            with open(path) as f:
                j = json.load(f)
            scene_dir = scene_dir or path.parent
        else:
            j = json_path_or_dict
            scene_dir = scene_dir or pathlib.Path(".")
        self.scene_dir = scene_dir
        self.json = j
        self.ior = float(j.get("ior", 1.0))
        self.bvh_config = j.get("bvh")
        self.photon_map_config = j.get("photon_map")
        self.cameras = [parse_camera(c) for c in j.get("cameras", [])]

        named_materials = {
            name: parse_material(mj, scene_dir) for name, mj in j.get("materials", {}).items()
        }
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
        quads = []       # (Q 4x4, bbmin, bbmax, mat)

        for s in j.get("surfaces", []):
            material = named_materials[s.get("material", "default")]
            mid = mat_id(material)

            transform = None
            if any(k in s for k in ("position", "scale", "rotation")):
                transform = Transform(
                    _parse_vec3(s.get("position", 0.0)),
                    _parse_vec3(s.get("scale", 1.0)),
                    np.radians(_parse_vec3(s.get("rotation", 0.0))),
                )

            stype = s["type"]
            if stype == "object":
                if "file" in s:
                    v, n, tv, tn = objmod.parse_obj(scene_dir / s["file"])
                else:
                    v = vertex_sets[s["vertex_set"]]
                    tv = np.asarray(s["triangles"], dtype=np.int64).reshape(-1, 3)
                    n, tn = np.zeros((0, 3)), None

                smooth = bool(s.get("smooth", False))
                if smooth and len(n) == 0:
                    n = objmod.generate_vertex_normals(v, tv)
                    tn = tv

                p0, p1, p2 = v[tv[:, 0]], v[tv[:, 1]], v[tv[:, 2]]
                if transform is not None:
                    if transform.negative_determinant:
                        p1, p2 = p2, p1
                        if tn is not None:
                            tn = tn[:, [0, 2, 1]]
                    p0, p1, p2 = (transform.points(p) for p in (p0, p1, p2))

                nt = len(tv)
                areas = 0.5 * np.linalg.norm(np.cross(p1 - p0, p2 - p0), axis=-1)
                is_emissive = material.emissive
                total_area = float(np.sum(areas)) if is_emissive else 0.0

                if smooth and tn is not None:
                    vn = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-300)
                    n0, n1, n2 = vn[tn[:, 0]], vn[tn[:, 1]], vn[tn[:, 2]]
                    if transform is not None:
                        n0, n1, n2 = (transform.normals(x) for x in (n0, n1, n2))
                    tri_vn.append(np.stack([n0, n1, n2], axis=1))
                    tri_interp.append(np.ones(nt, bool))
                else:
                    tri_vn.append(np.zeros((nt, 3, 3)))
                    tri_interp.append(np.zeros(nt, bool))

                tri_p.append(np.stack([p0, p1, p2], axis=1).reshape(nt, 3, 3))
                tri_mats.append(np.full(nt, mid, np.int32))
                if is_emissive and total_area > EPSILON:
                    # Object flux split across triangles by area (scene.cpp:77-94)
                    tri_flux.append(material.emittance[None, :] * (areas / total_area)[:, None])
                else:
                    tri_flux.append(np.zeros((nt, 3)))

            elif stype == "triangle":
                vv = np.asarray(s["vertices"], dtype=np.float64).reshape(3, 3)
                p0, p1, p2 = vv[0], vv[1], vv[2]
                if transform is not None:
                    if transform.negative_determinant:
                        p1, p2 = p2, p1
                    p0, p1, p2 = (transform.points(p[None])[0] for p in (p0, p1, p2))
                tri_p.append(np.stack([p0, p1, p2])[None])
                tri_vn.append(np.zeros((1, 3, 3)))
                tri_interp.append(np.zeros(1, bool))
                tri_mats.append(np.full(1, mid, np.int32))
                tri_flux.append((material.emittance if material.emissive else np.zeros(3))[None])

            elif stype == "sphere":
                origin = np.zeros(3)
                radius = float(s["radius"])
                if transform is not None:
                    origin = transform.position.copy()
                    radius = radius * float(np.mean(transform.scale))
                sph.append((origin, radius, mid, material.emittance if material.emissive else np.zeros(3)))

            elif stype == "quadric":
                # Emittance not supported for quadrics (scene.cpp:123-134)
                Q = _quadric_matrix(s)
                bd = _parse_vec3(s.get("bound_dimensions", 1.0))
                bb_min, bb_max = -bd / 2.0, bd / 2.0
                if transform is not None:
                    m_inv = np.linalg.inv(transform.matrix)
                    Q = m_inv.T @ Q @ m_inv
                    bb_min = bb_min + transform.position
                    bb_max = bb_max + transform.position
                quads.append((Q, bb_min, bb_max, mid))

        # ---- pack numpy SoA ----
        tri_p = _cat(tri_p, (3, 3)).astype(np.float64)
        T, S, Qn = len(tri_p), len(sph), len(quads)
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

        self.quad_Q = np.array([q[0] for q in quads], dtype=np.float64).reshape(-1, 4, 4)
        self.quad_bb_min = pack3([q[1] for q in quads])
        self.quad_bb_max = pack3([q[2] for q in quads])
        self.quad_mat = np.array([q[3] for q in quads], dtype=np.int32)
        self.quad_G = 2.0 * self.quad_Q[:, :3, :] if Qn else np.zeros((0, 3, 4))

        self.surf_area = np.concatenate([self.tri_area, self.sph_area, np.ones(Qn)])
        self.surf_mat = np.concatenate([self.tri_mat, self.sph_mat, self.quad_mat]).astype(np.int32)
        surf_flux = np.concatenate([tri_flux, sph_flux, np.zeros((Qn, 3))], axis=0)

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

        # Gather-ready light geometry (triangles and spheres only; quadrics can't emit)
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
        if Qn:
            mins.append(np.min(self.quad_bb_min, axis=0))
            maxs.append(np.max(self.quad_bb_max, axis=0))
        self.bb_min = np.min(np.stack(mins), axis=0) if mins else np.zeros(3)
        self.bb_max = np.max(np.stack(maxs), axis=0) if maxs else np.zeros(3)

        self.materials = self._materials

    # ------------------------------------------------------------------
    def content_hash(self) -> str:
        """Fingerprint of everything that determines the rendered image: the full
        scene JSON (materials, lights, transforms, camera blocks) plus the loaded
        triangle geometry (OBJ content is not visible in the JSON). Folded into
        film checkpoint keys so editing a scene invalidates stale checkpoints
        instead of silently resuming them."""
        cached = getattr(self, "_content_hash", None)
        if cached is None:
            import hashlib

            h = hashlib.sha1()
            h.update(json.dumps(self.json, sort_keys=True, default=str).encode())
            h.update(np.ascontiguousarray(self.tri_v0).tobytes())
            h.update(np.ascontiguousarray(self.tri_e1).tobytes())
            h.update(np.ascontiguousarray(self.tri_e2).tobytes())
            cached = self._content_hash = h.hexdigest()[:16]
        return cached

    def tri_bounds(self):
        """World AABBs of all triangles: (mins (T,3), maxs (T,3))."""
        v1 = self.tri_v0 + self.tri_e1
        v2 = self.tri_v0 + self.tri_e2
        mins = np.minimum(np.minimum(self.tri_v0, v1), v2)
        maxs = np.maximum(np.maximum(self.tri_v0, v1), v2)
        return mins, maxs

    def build_flat_bvh(self, dtype=np.float32):
        """The fat-leaf flat BVH that both cluster builders read, cached per
        dtype. None when the scene has no `bvh` block or too few triangles to
        matter.

        The fat-leaf size is the JAX package's (128, doubled up to 512 while the
        mesh has more than 5000 clusters), so both packages traverse the same
        clusters. The CUDA kernel itself takes any cluster count."""
        if self.bvh_config is None or self.n_tris < 8:
            return None
        cache = self.__dict__.setdefault("_flat_cache", {})
        key = np.dtype(dtype).name
        if key not in cache:
            from ..accel.bvh_build import build_bvh

            cluster_size = 128
            while cluster_size < 512 and self.n_tris / cluster_size > 5000:
                cluster_size *= 2
            # Honor the scene's builder choice (reference bvh.cpp:24-56): the JSON
            # `bvh.type` selects the cluster-formation algorithm.
            kind = str(self.bvh_config.get("type", "binary_sah"))
            bins = int(self.bvh_config.get("bins_per_axis", 16))
            mins, maxs = self.tri_bounds()
            cache[key] = build_bvh(
                mins, maxs, kind=kind, bins=bins,
                max_leaf=cluster_size, dtype=dtype, strict_leaf=True,
            )
        return cache[key]

    def build_cluster_bvh(self, dtype=np.float32, device=None):
        """Fat-leaf cluster BVH (ops/cluster_bvh.upload_cluster_bvh: with its
        ClusterTree where the tables traverse best-first), from
        build_flat_bvh. Cached per (dtype, device); None without a BVH."""
        from ..ops.cluster_bvh import upload_cluster_bvh
        from ..utils.device import resolve_device

        flat = self.build_flat_bvh(dtype)
        if flat is None:
            return None
        device = resolve_device(device)
        cache = self.__dict__.setdefault("_cluster_cache", {})
        key = (np.dtype(dtype).name, str(device))
        if key not in cache:
            cache[key] = upload_cluster_bvh(flat, self, dtype, device)
        return cache[key]

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
        nt, ns, nq, nl = self.n_tris, self.n_sphs, self.n_quads, self.n_lights

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
            quad_Q=pad(self.quad_Q, nq, np.zeros((1, 4, 4))),
            quad_G=pad(self.quad_G, nq, np.zeros((1, 3, 4))),
            quad_bb_min=pad(self.quad_bb_min, nq, np.zeros((1, 3))),
            quad_bb_max=pad(self.quad_bb_max, nq, np.zeros((1, 3))),
            quad_mat=i32(pad(self.quad_mat, nq, np.zeros(1))),
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

    def tables(self, dtype=np.float32, device=None) -> SceneTables:
        """SceneTables on `device` (None: the CUDA device, or raise without one);
        float fields in `dtype`, ids int32, flags bool."""
        from ..convert import tables_from_numpy

        return tables_from_numpy(self.table_arrays(), device, dtype)


def _quadric_matrix(s: dict) -> np.ndarray:
    """Quadric JSON coefficients -> symmetric 4x4 matrix (reference quadric.cpp:9-36)."""
    g = lambda k: float(s.get(k, 0.0))
    XX = g("XX")
    XY = max(g("XY"), g("YX")) / 2.0
    XZ = max(g("XZ"), g("ZX")) / 2.0
    X = g("X") / 2.0
    YY = g("YY")
    YZ = max(g("YZ"), g("ZY")) / 2.0
    Y = g("Y") / 2.0
    ZZ = g("ZZ")
    Z = g("Z") / 2.0
    R = g("R")
    return np.array(
        [
            [XX, XY, XZ, X],
            [XY, YY, YZ, Y],
            [XZ, YZ, ZZ, Z],
            [X, Y, Z, R],
        ],
        dtype=np.float64,
    )
