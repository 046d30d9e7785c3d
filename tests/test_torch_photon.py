"""The port's photon mapper against the JAX package's, on the CPU.

float64 and brute-force intersection unless a test says otherwise, on
tests/scenes/caustic_sphere.json (a glass sphere over a diffuse floor under a
sphere light) at 2000 emissions (x10 caustic_factor) and a 16x16 camera.

Bars:
- emitted photons: the same rows as the JAX package's after a lexicographic
  sort, atol 1e-9 (in fact they come out in the same order);
- eye pass: per-path radiance within rtol 1e-6 of the JAX package's, on the
  same photon maps (the JAX maps brought over by convert.photon_grid_from_numpy),
  on at least 99.5% of paths: the rest would be decision flips, as in
  tests/test_torch_path_tracer.py;
- render: the float32 photon render against mcrt_tpu.render, finalized, to
  the bars of tests/test_e2e_golden.py's caustic test (image mean 0.02, p95 of
  the per-pixel difference 0.10, mean difference 0.03)."""
import json
import pathlib

import numpy as np
import pytest
import torch

import mcrt_tpu_torch as mt
from mcrt_tpu_torch import convert
from mcrt_tpu_torch.camera import camera as tcam
from mcrt_tpu_torch.camera import image as image_mod
from mcrt_tpu_torch.integrator import photon_mapper as tpm
from mcrt_tpu_torch.scene.synthetic import height_field_scene

jnp = pytest.importorskip("jax.numpy")
import mcrt_tpu as jm  # noqa: E402
from mcrt_tpu.camera import camera as jcam  # noqa: E402
from mcrt_tpu.integrator import photon_mapper as jpm  # noqa: E402
from mcrt_tpu.scene.loader import Scene as JScene  # noqa: E402

torch.set_num_threads(1)  # pytest-xdist runs several workers on the same cores

SCENES = pathlib.Path(__file__).parent / "scenes"
W = 16
SPP = 2


def _caustic(emissions=2000, width=W, sqrtspp=1):
    j = json.loads((SCENES / "caustic_sphere.json").read_text())
    j["cameras"][0]["image"] = {"width": width, "height": width, "plain": True}
    j["cameras"][0]["sqrtspp"] = sqrtspp
    j["photon_map"]["emissions"] = emissions
    return j


def _sorted_rows(pos, d, f):
    rows = np.concatenate([np.asarray(pos), np.asarray(d), np.asarray(f)], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


def _port_grid(jgrid):
    a = jgrid.arrays
    return convert.photon_grid_from_numpy(
        np.asarray(a.pos), np.asarray(a.direction), np.asarray(a.flux),
        np.asarray(a.cell_start), jgrid.bb_min, jgrid.cell_size, jgrid.dims,
        jgrid.m_per_cell, jgrid.n_photons, device="cpu")


@pytest.fixture(scope="module")
def caustic():
    """Both packages' scenes and float64 tables, and the JAX photon maps in both forms."""
    j = _caustic()
    ts, js = mt.Scene(j), JScene(j)
    tt, jt = ts.tables(np.float64, "cpu"), js.tables(jnp.float64)
    jcfg = jpm.PMConfig.from_json(js.photon_map_config)
    jmaps = jpm.build_photon_maps(jt, js.meta(), jcfg, js)
    tmaps = tpm.PhotonMaps(_port_grid(jmaps.caustic), _port_grid(jmaps.global_))
    return ts, js, tt, jt, jmaps, tmaps


def _close_share(a, b, rtol=1e-6):
    a, b = np.asarray(a), np.asarray(b)
    err = np.abs(a - b).max(axis=-1)
    return float((err <= rtol * np.abs(b).max(axis=-1) + 1e-300).mean())


def test_emit_photons_match_jax(caustic):
    ts, js, tt, jt, _, _ = caustic
    cfg = tpm.PMConfig.from_json(ts.photon_map_config)
    stats = {}
    tc, tg = tpm.emit_photons(tt, ts.meta(), cfg, ts, stats=stats)
    jc, jg = jpm.emit_photons(jt, js.meta(), jpm.PMConfig.from_json(js.photon_map_config), js)
    assert len(tc[0]) > 100 and len(tg[0]) > 100
    for ours, theirs in ((tc, jc), (tg, jg)):
        assert len(ours[0]) == len(theirs[0])
        np.testing.assert_allclose(_sorted_rows(*ours), _sorted_rows(*theirs), rtol=0, atol=1e-9)
    assert stats["emission_steps"] > 0 and "emission_reruns" not in stats


def test_emission_overflow_grows_the_buffer(caustic, monkeypatch):
    """Store buffers far too small: each chunk is run again with buffers of its
    counted size, and the photons are those of an unhurried run (the JAX package
    raises here)."""
    ts, _, tt, _, _, _ = caustic
    cfg = tpm.PMConfig.from_json(ts.photon_map_config, emission_chunk=4096)
    large = tpm.emit_photons(tt, ts.meta(), cfg, ts)
    monkeypatch.setattr(tpm, "STORE_MARGIN", 1e-3)      # 20 rows for 20,000 emissions
    stats = {}
    small = tpm.emit_photons(tt, ts.meta(), cfg, ts, stats=stats)
    assert stats["emission_reruns"] >= 1
    for a, b in zip(small[0] + small[1], large[0] + large[1]):
        np.testing.assert_array_equal(a, b)


def test_emit_through_cluster_bvh_on_a_mesh():
    """The emission pass through the port's cluster BVH (its plain traversal on
    the CPU) on an inline mesh, against the JAX package's brute-force one."""
    j = height_field_scene(6, 8, 1, photon_map={"emissions": 1000, "caustic_factor": 4.0,
                                                "k_nearest_photons": 16})
    ts, js = mt.Scene(j), JScene(j)
    tt, jt = ts.tables(np.float64, "cpu"), js.tables(jnp.float64)
    cbvh = ts.build_cluster_bvh(np.float64, "cpu")
    assert cbvh is not None
    from mcrt_tpu_torch.ops import cluster_bvh as tcb

    isect = tcb.make_intersect_fn(tt, ts.meta(), cbvh)
    tc, tg = tpm.emit_photons(tt, ts.meta(), tpm.PMConfig.from_json(ts.photon_map_config), ts,
                              intersect_fn=isect)
    jc, jg = jpm.emit_photons(jt, js.meta(), jpm.PMConfig.from_json(js.photon_map_config), js)
    assert len(tc[0]) > 10 and len(tg[0]) > 100
    for ours, theirs in ((tc, jc), (tg, jg)):
        assert len(ours[0]) == len(theirs[0])
        np.testing.assert_allclose(_sorted_rows(*ours), _sorted_rows(*theirs), rtol=0, atol=1e-9)


def _camera_rays(cam, jt):
    n = cam.width * cam.height * SPP
    lin = np.arange(n)
    pix = lin // SPP
    return jcam.generate_rays(cam, pix % cam.width, pix // cam.width, lin % SPP, jt.ior, 0,
                              jnp.float64)


def test_trace_per_path_radiance(caustic):
    ts, js, tt, jt, jmaps, tmaps = caustic
    jr = _camera_rays(js.cameras[0], jt)
    jcfg = jpm.PMConfig.from_json(js.photon_map_config)
    want = jpm.trace(jt, js.meta(), jcfg, jmaps, jmaps.caustic.arrays, jmaps.global_.arrays,
                     jr.origin, jr.direction, jr.pixel_index, jr.sample_index)
    t = lambda x: torch.as_tensor(np.asarray(x).astype(np.float64 if np.asarray(x).dtype.kind == "f"
                                                       else np.int64))
    stats = {}
    got = tpm.trace(tt, ts.meta(), tpm.PMConfig.from_json(ts.photon_map_config), tmaps,
                    t(jr.origin), t(jr.direction), t(jr.pixel_index), t(jr.sample_index),
                    stats=stats)
    assert got.shape == (W * W * SPP, 3)
    assert _close_share(got.numpy(), want) >= 0.995
    assert float(got.mean()) > 0.0
    assert 0 < stats["bounce_steps"] <= 64 and stats["knn_calls"] == 2 * stats["bounce_steps"]
    assert 0 < int(stats["knn_queries"]) and 0 <= stats["knn_flagged"] <= int(stats["knn_queries"])


def test_trace_streamed_per_path_radiance(caustic):
    ts, js, tt, jt, jmaps, tmaps = caustic
    cam_t, cam_j = ts.cameras[0], js.cameras[0]
    start = 2 * SPP                     # a chunk that does not begin at path 0
    n = cam_t.width * cam_t.height * SPP - start
    lanes = 128                         # fewer lanes than paths: lanes reload paths
    jcfg = jpm.PMConfig.from_json(js.photon_map_config)
    want = jpm.trace_streamed(jt, js.meta(), jcfg, jmaps, jmaps.caustic.arrays,
                              jmaps.global_.arrays, cam_j, SPP, start, n, lanes)
    cfg = tpm.PMConfig.from_json(ts.photon_map_config)
    stats = {}
    got = tpm.trace_streamed(tt, ts.meta(), cfg, tmaps, cam_t, SPP, start, n, lanes, stats=stats)
    assert got.shape == (n, 3)
    assert _close_share(got.numpy(), want) >= 0.995
    assert stats["bounce_steps"] > 0
    # Streaming is a schedule: the same paths through one batch of `trace`.
    lin = start + np.arange(n)
    pix = lin // SPP
    r = tcam.generate_rays(cam_t, torch.as_tensor(pix % cam_t.width),
                           torch.as_tensor(pix // cam_t.width), torch.as_tensor(lin % SPP),
                           0, torch.float64)
    batch = tpm.trace(tt, ts.meta(), cfg, tmaps, r.origin, r.direction, r.pixel_index,
                      r.sample_index)
    np.testing.assert_allclose(got.numpy(), batch.numpy(), rtol=1e-12, atol=1e-15)


def _finalize(hdr, scene):
    return np.clip(image_mod.finalize(hdr, scene.cameras[0].image), 0.0, 1.0)


def test_render_matches_jax_golden_bars():
    """The float32 photon render, streamed and batched, against the JAX
    package's (whose k-NN is its capped search plus brute fallback on the CPU,
    where the port's is the kernel's plain version plus the same fallback)."""
    j = _caustic(sqrtspp=2)
    ts, js = mt.Scene(j), jm.Scene(j)
    kw = dict(dtype="float32", integrator="photon_mapper", rays_per_chunk=256, lanes=128)
    ref = _finalize(jm.render(js, 0, jm.RenderConfig(**kw)), js)
    assert ref.mean() > 0.02
    for streamed in (True, False):
        stats = {}
        hdr = mt.render(ts, 0, mt.RenderConfig(streamed=streamed, **kw), device="cpu", stats=stats)
        assert np.isfinite(hdr).all() and hdr.min() >= 0.0
        assert stats["chunks"] == W * W * 4 // 256 and stats["photons_caustic"] > 0
        ours = _finalize(hdr, ts)
        diff = np.abs(ours - ref)
        assert abs(ours.mean() - ref.mean()) < 0.02, (streamed, ours.mean(), ref.mean())
        assert np.percentile(diff, 95) < 0.10, streamed
        assert diff.mean() < 0.03, streamed


def test_photon_render_resumes_from_checkpoint(tmp_path):
    """render(checkpoint_dir=...) saves both photon maps beside the film
    checkpoint; a later render loads them instead of emitting, and gives the
    same image. A corrupt map file is rebuilt."""
    ts = mt.Scene(_caustic(emissions=500, width=8))
    cfg = mt.RenderConfig(integrator="photon_mapper", rays_per_chunk=32, lanes=32)
    s1 = {}
    img1 = mt.render(ts, 0, cfg, device="cpu", checkpoint_dir=tmp_path, stats=s1)
    pm_files = sorted(tmp_path.glob("photons_*.npz"))
    assert len(pm_files) == 2 and "photon_pass_s" in s1
    for f in tmp_path.glob("film_*.npz"):
        f.unlink()        # recompute the image, from the loaded maps
    s2 = {}
    img2 = mt.render(ts, 0, cfg, device="cpu", checkpoint_dir=tmp_path, stats=s2)
    assert s2.get("photon_maps_loaded") and "emission_steps" not in s2
    np.testing.assert_array_equal(img1, img2)
    for f in tmp_path.glob("film_*.npz"):
        f.unlink()
    pm_files[0].write_bytes(b"not an npz")
    s3 = {}
    img3 = mt.render(ts, 0, cfg, device="cpu", checkpoint_dir=tmp_path, stats=s3)
    assert "photon_maps_loaded" not in s3 and s3["emission_steps"] > 0
    np.testing.assert_array_equal(img1, img3)
