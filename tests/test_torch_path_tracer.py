"""Per-path radiance of the port's path tracer against the JAX package's.

float64, brute-force intersection, the same camera rays. `trace` (one batch of
camera rays) and `trace_streamed` (persistent lanes that reload paths, with and
without per-pixel sums) run on `caustic_sphere.json` (a smooth dielectric over a
diffuse floor, NEE to a sphere light) and on the inline height-field mesh
(diffuse, GGX and glass surfaces, a sphere light).

Bar: |port - JAX| <= 1e-8 on at least 99.5% of paths (or pixels). The rest are
decision flips: a path's events are chosen by comparing a Sobol sample with a
probability (event selection, Russian roulette, a Fresnel pick), and the two
packages compute those probabilities with different transcendental
implementations (XLA's against ATen's), which can differ in the last bit; where
the sample falls inside that bit the paths diverge and their radiance is
unrelated from then on."""
import json
import pathlib

import numpy as np
import pytest
import torch

import mcrt_tpu_torch as mt
from mcrt_tpu_torch.camera import camera as tcam
from mcrt_tpu_torch.integrator import path_tracer as tpt
from mcrt_tpu_torch.scene.synthetic import height_field_scene

jnp = pytest.importorskip("jax.numpy")
from mcrt_tpu.camera import camera as jcam  # noqa: E402
from mcrt_tpu.integrator import path_tracer as jpt  # noqa: E402
from mcrt_tpu.scene.loader import Scene as JScene  # noqa: E402

torch.set_num_threads(1)  # pytest-xdist runs several workers on the same cores

SCENES = pathlib.Path(__file__).parent / "scenes"
W = 16
SPP = 2
LANES = 128          # fewer lanes than paths: lanes reload paths as theirs die


def _caustic():
    j = json.loads((SCENES / "caustic_sphere.json").read_text())
    j["cameras"][0]["image"] = {"width": W, "height": W, "plain": True}
    return j


SCENE_JSON = {"caustic_sphere": _caustic, "height_field": lambda: height_field_scene(6, W, 1)}


def _close_share(a, b):
    err = np.abs(np.asarray(a) - np.asarray(b)).max(axis=-1)
    return float((err <= 1e-8).mean())


@pytest.fixture(scope="module", params=sorted(SCENE_JSON))
def scenes(request):
    j = SCENE_JSON[request.param]()
    return mt.Scene(j), JScene(j)


def _camera_paths(cam):
    n = cam.width * cam.height * SPP
    lin = np.arange(n)
    pix = lin // SPP
    return pix % cam.width, pix // cam.width, lin % SPP


def test_trace_per_path_radiance(scenes):
    ts, js = scenes
    tt, jt = ts.tables(np.float64, "cpu"), js.tables(jnp.float64)
    px, py, si = _camera_paths(ts.cameras[0])
    tr = tcam.generate_rays(ts.cameras[0], torch.as_tensor(px), torch.as_tensor(py),
                            torch.as_tensor(si), 0, torch.float64)
    jr = jcam.generate_rays(js.cameras[0], px, py, si, jt.ior, 0, jnp.float64)
    np.testing.assert_allclose(tr.origin.numpy(), np.asarray(jr.origin), rtol=1e-14, atol=1e-15)
    np.testing.assert_allclose(tr.direction.numpy(), np.asarray(jr.direction), rtol=1e-14, atol=1e-15)
    np.testing.assert_array_equal(tr.pixel_index.numpy(), np.asarray(jr.pixel_index))
    # Both packages trace the same rays (the JAX package's).
    o, d = (torch.tensor(np.asarray(x)) for x in (jr.origin, jr.direction))
    got, st = tpt.trace(tt, ts.meta(), tpt.PTConfig(), o, d,
                        tr.pixel_index, tr.sample_index, return_stats=True)
    want, jst = jpt.trace(jt, js.meta(), jpt.PTConfig(), jr.origin, jr.direction,
                          jr.pixel_index, jr.sample_index, return_stats=True)
    assert got.shape == (len(px), 3)
    assert _close_share(got.numpy(), want) >= 0.995
    assert float(got.numpy().mean()) > 0.0
    # Rays traced (primary + shadow) differ only through flipped paths.
    assert abs(int(st["rays"]) - int(jst["rays"])) <= 0.005 * int(jst["rays"])
    assert 0 < st["bounce_steps"] <= tpt.PTConfig().max_bounces


@pytest.mark.parametrize("pixel_sums", [False, True])
def test_trace_streamed_per_path_radiance(scenes, pixel_sums):
    ts, js = scenes
    tt, jt = ts.tables(np.float64, "cpu"), js.tables(jnp.float64)
    cam_t, cam_j = ts.cameras[0], js.cameras[0]
    n = cam_t.width * cam_t.height * SPP
    start = 2 * SPP    # a chunk that does not begin at path 0
    n -= start
    stats = {}
    got, rays = tpt.trace_streamed(tt, ts.meta(), tpt.PTConfig(), cam_t, SPP, start, n, LANES,
                                   pixel_sums=pixel_sums, stats=stats)
    want, jrays = jpt.trace_streamed(jt, js.meta(), jpt.PTConfig(), cam_j, SPP, start, n, LANES,
                                     pixel_sums=pixel_sums)
    assert got.shape == ((n // SPP) if pixel_sums else n, 3)
    assert _close_share(got.numpy(), want) >= 0.995
    assert float(got.numpy().mean()) > 0.0
    assert abs(int(rays) - int(jrays)) <= 0.005 * int(jrays)
    assert stats["bounce_steps"] > 0
    if not pixel_sums:
        # Streaming is a schedule, not a different estimator: the same paths
        # through one batch of `trace` give the same per-path radiance.
        lin = start + np.arange(n)
        pix = lin // SPP
        r = tcam.generate_rays(cam_t, torch.as_tensor(pix % cam_t.width),
                               torch.as_tensor(pix // cam_t.width), torch.as_tensor(lin % SPP),
                               0, torch.float64)
        batch = tpt.trace(tt, ts.meta(), tpt.PTConfig(), r.origin, r.direction,
                          r.pixel_index, r.sample_index)
        np.testing.assert_allclose(got.numpy(), batch.numpy(), rtol=0, atol=1e-12)
