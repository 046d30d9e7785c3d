"""Port scene tables and cluster tables against the JAX package's, field by field."""
import pathlib

import numpy as np
import pytest
import torch

import mcrt_tpu_torch as mt
from mcrt_tpu_torch import convert
from mcrt_tpu_torch.scene.synthetic import height_field_scene

jnp = pytest.importorskip("jax.numpy")
from mcrt_tpu.ops import cluster_bvh as jcb  # noqa: E402
from mcrt_tpu.scene.loader import Scene as JScene  # noqa: E402

torch.set_num_threads(1)  # pytest-xdist runs several workers on the same cores

SCENES = pathlib.Path(__file__).parent / "scenes"


def _smooth_emissive_mesh():
    """Inline meshes through the loader's harder branches: smooth normals, a
    mirroring transform (winding swap), an emissive mesh (area-split flux)."""
    rng = np.random.default_rng(3)
    verts = rng.normal(size=(30, 3))
    tris = rng.integers(0, 30, size=(40, 3))
    tris = tris[(tris[:, 0] != tris[:, 1]) & (tris[:, 1] != tris[:, 2]) & (tris[:, 0] != tris[:, 2])]
    j = height_field_scene(3, 8, 1, as_lists=True)
    j["vertices"]["blob"] = verts.tolist()
    j["materials"]["glow"] = {"emittance": [3.0, 2.0, 1.0], "reflectance": "#336699"}
    j["surfaces"] += [
        {"type": "object", "material": "glow", "vertex_set": "blob", "triangles": tris.tolist(),
         "smooth": True, "scale": [-1.0, 1.0, 2.0], "rotation": [10, 20, 30], "position": [1, 2, 3]},
        {"type": "triangle", "material": "glossy", "vertices": [[0, 0, 0], [1, 0, 0], [0, 1, 0]],
         "scale": [1, -1, 1]},
        {"type": "quadric", "material": "ground", "XX": 1, "YY": 1, "ZZ": -1, "R": -0.1,
         "bound_dimensions": [1, 1, 1], "position": [0, 5, 0]},
    ]
    return j


CASES = {
    "caustic_sphere": lambda: (SCENES / "caustic_sphere.json", SCENES),
    "height_field": lambda: (height_field_scene(6, 8, 1), None),
    "smooth_emissive_mesh": lambda: (_smooth_emissive_mesh(), None),
}


def _load(case):
    src, d = CASES[case]()
    return mt.Scene(src, d), JScene(src, d)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tables_equal_jax_tables(case):
    ts, js = _load(case)
    ours = ts.tables(np.float64, "cpu")
    ref = js.tables(jnp.float64)
    assert ours._fields == ref._fields
    for name in ours._fields:
        a = getattr(ours, name).numpy()
        b = np.asarray(getattr(ref, name))
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert ts.meta().__dict__ == js.meta().__dict__
    assert ts.content_hash() == js.content_hash()


@pytest.mark.parametrize("case", sorted(CASES))
def test_tables_from_numpy_of_jax_tables(case):
    ts, js = _load(case)
    ref = js.tables(jnp.float32)
    fields = {n: np.asarray(getattr(ref, n)) for n in ref._fields}
    got = convert.tables_from_numpy(fields, "cpu", np.float32)
    ours = ts.tables(np.float32, "cpu")
    for name in ours._fields:
        a, b = getattr(got, name), getattr(ours, name)
        assert a.dtype == b.dtype, name
        assert torch.equal(a, b), name


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_cluster_tables_match_jax_records(dtype):
    """The kernel's record rows are the nonzero rows of the JAX package's
    center-folded form matrices (same float32 arithmetic)."""
    ts, js = _load("height_field")
    from mcrt_tpu.accel.bvh_build import build_bvh

    mins, maxs = js.tri_bounds()
    flat = build_bvh(mins, maxs, kind="binary_sah", max_leaf=32, dtype=np.float32, strict_leaf=True)
    cb = convert.cluster_bvh_from_numpy(flat.bb_min, flat.bb_max, flat.first, flat.count,
                                        flat.prim_order, ts.tri_v0, ts.tri_e1, ts.tri_e2,
                                        "cpu", dtype)
    jb = jcb.upload_cluster_bvh(flat, js, np.float32)
    C, S = np.asarray(jb.tri_id).shape
    Spj = np.asarray(jb.rec).shape[2] // 5
    M = np.asarray(jb.rec).reshape(C, 16, 5, Spj)[:, :, :, :S]          # (C, row, form, tri)
    rec = cb.rec.numpy()[:, :S]                                            # (C, tri, REC_W)
    want = np.concatenate([M[:, [0, 1, 2], 0], M[:, [0, 1, 2, 6, 7, 8], 1],
                           M[:, [0, 1, 2, 6, 7, 8], 2], M[:, [3, 4, 5, 9], 3]], axis=1)
    if dtype is np.float32:
        np.testing.assert_array_equal(rec[:, :, :19], want.transpose(0, 2, 1))
    else:
        np.testing.assert_allclose(rec[:, :, :19], want.transpose(0, 2, 1), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(cb.tri.numpy()[:, :S], np.asarray(jb.tri_id))
    assert (cb.tri.numpy()[:, S:] == -1).all()
    np.testing.assert_array_equal(cb.cl_bb.numpy()[:, 0:3], np.asarray(jb.cl_bb_min))
    np.testing.assert_array_equal(cb.cl_bb.numpy()[:, 4:7], np.asarray(jb.cl_bb_max))
