"""The streamed path tracer's reusable chunk step (`path_tracer.StreamedTrace`).

One StreamedTrace serves every chunk of its size: the chunk's first path rides
in the state (`PathState.start`, a device scalar), not in the step. On the card
the step is captured once as a CUDA graph and replayed every bounce; on the CPU
it runs eagerly, and these tests hold the reuse itself:

- a StreamedTrace called for several chunks gives, bit for bit, what a fresh
  `trace_streamed` gives for each chunk (the same float64 operations);
- those chunks against the JAX package's `trace_streamed` in float64, with
  tests/test_torch_path_tracer.py's bar: |port - JAX| <= 1e-8 on at least
  99.5% of pixels (the rest are decision flips between two transcendental
  implementations; see that file);
- `render()` makes one StreamedTrace per chunk size, so a tail chunk of
  another size gets its own, and its image equals the film built from fresh
  per-chunk calls bit for bit.

The card's case (marked `cuda`, skipped without one) holds the graphed run to
an eager loop of the same step. This file imports JAX only inside the parity
test, which skips unless JAX is there in float64 (tests/conftest.py turns
that on), so on a machine with a card the rest runs without the conftest:

    python3 -m pytest --noconftest -q tests/test_torch_graphed.py
"""
import json
import pathlib
from unittest import mock

import numpy as np
import pytest
import torch

import mcrt_tpu_torch as mt
from mcrt_tpu_torch.camera import film as film_mod
from mcrt_tpu_torch.integrator import path_tracer as tpt
from mcrt_tpu_torch.ops import cluster_bvh
from mcrt_tpu_torch.render import _add_pixel_sums
from mcrt_tpu_torch.scene.synthetic import height_field_scene
from mcrt_tpu_torch.utils import cuda_graph

torch.set_num_threads(1)  # pytest-xdist runs several workers on the same cores

SCENES = pathlib.Path(__file__).parent / "scenes"
W = 16
SQRTSPP = 2
SPP = SQRTSPP * SQRTSPP
CHUNK = 192          # paths a chunk: 1024 paths are 5 chunks and a tail of 64
LANES = 48           # fewer lanes than paths: lanes reload paths as theirs die
BOUNCES = 12


def _caustic():
    j = json.loads((SCENES / "caustic_sphere.json").read_text())
    j["cameras"][0]["image"] = {"width": W, "height": W, "plain": True}
    j["cameras"][0]["sqrtspp"] = SQRTSPP
    return j


SCENE_JSON = {"caustic_sphere": _caustic, "height_field": lambda: height_field_scene(6, W, SQRTSPP)}


@pytest.fixture(scope="module", params=sorted(SCENE_JSON))
def scene(request):
    j = SCENE_JSON[request.param]()
    s = mt.Scene(j)
    tables = s.tables(np.float64, "cpu")
    cbvh = s.build_cluster_bvh(np.float64, "cpu")
    ifn = None if cbvh is None else cluster_bvh.make_intersect_fn(tables, s.meta(), cbvh)
    return j, s, tables, ifn


def _starts(total, n):
    return list(range(0, total - n + 1, n))


@pytest.mark.parametrize("pixel_sums", [False, True])
def test_reused_trace_matches_fresh_calls(scene, pixel_sums):
    """One StreamedTrace over five chunks equals trace_streamed called fresh
    for each, bit for bit: radiance, rays traced and bounce steps."""
    _, s, tables, ifn = scene
    cam, cfg = s.cameras[0], tpt.PTConfig(max_bounces=BOUNCES)
    run = tpt.StreamedTrace(tables, s.meta(), cfg, cam, SPP, CHUNK, LANES, intersect_fn=ifn,
                            pixel_sums=pixel_sums)
    starts = _starts(cam.width * cam.height * SPP, CHUNK)
    assert len(starts) >= 3
    for start in starts:
        st_reused, st_fresh = {}, {}
        got, rays = run(start, st_reused)
        want, want_rays = tpt.trace_streamed(tables, s.meta(), cfg, cam, SPP, start, CHUNK, LANES,
                                             intersect_fn=ifn, pixel_sums=pixel_sums, stats=st_fresh)
        assert got.shape == ((CHUNK // SPP) if pixel_sums else CHUNK, 3)
        assert torch.equal(got, want), start
        assert torch.equal(rays, want_rays) and st_reused == st_fresh
        assert int(run.state.start) == start
    assert float(got.sum()) > 0.0


def test_reused_trace_matches_jax(scene):
    """The chunks of a reused StreamedTrace against the JAX package's
    trace_streamed at the same starts, float64, per-pixel sums: |port - JAX|
    <= 1e-8 on at least 99.5% of pixels, rays traced within 0.5%."""
    jax = pytest.importorskip("jax")
    if not jax.config.jax_enable_x64:
        pytest.skip("needs JAX in float64, which tests/conftest.py turns on")
    import jax.numpy as jnp
    from mcrt_tpu.integrator import path_tracer as jpt
    from mcrt_tpu.scene.loader import Scene as JScene

    j, s, tables, _ = scene
    js = JScene(j)
    jt = js.tables(jnp.float64)
    cam = s.cameras[0]
    run = tpt.StreamedTrace(tables, s.meta(), tpt.PTConfig(), cam, SPP, CHUNK, LANES,
                            pixel_sums=True)
    for start in _starts(cam.width * cam.height * SPP, CHUNK)[:3]:
        got, rays = run(start)
        want, jrays = jpt.trace_streamed(jt, js.meta(), jpt.PTConfig(), js.cameras[0], SPP, start,
                                         CHUNK, LANES, pixel_sums=True)
        err = np.abs(got.numpy() - np.asarray(want)).max(axis=-1)
        assert float((err <= 1e-8).mean()) >= 0.995, start
        assert abs(int(rays) - int(jrays)) <= 0.005 * int(jrays)


def _counting_traces():
    """A StreamedTrace subclass that records the chunk size of each one made."""
    made = []

    class Counted(tpt.StreamedTrace):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self.regen.n_paths)

    return Counted, made


def test_render_reuses_one_trace_per_chunk_size(scene):
    """render() with five chunks and a tail makes two StreamedTraces (one per
    size), and its image equals the film built from fresh trace_streamed calls
    per chunk, bit for bit."""
    _, s, tables, ifn = scene
    cam = s.cameras[0]
    total = cam.width * cam.height * SPP
    cfg = mt.RenderConfig(dtype="float64", max_bounces=BOUNCES, rays_per_chunk=CHUNK, lanes=LANES)
    counted, made = _counting_traces()
    stats = {}
    with mock.patch.object(tpt, "StreamedTrace", counted):
        img = mt.render(s, 0, cfg, device="cpu", stats=stats)
    assert made == [CHUNK, total % CHUNK]
    assert stats["chunks"] == len(_starts(total, CHUNK)) + 1

    film = torch.zeros((cam.height, cam.width, 4), dtype=torch.float64)
    steps = {}
    for start in range(0, total, CHUNK):
        n = min(CHUNK, total - start)
        sums, _ = tpt.trace_streamed(tables, s.meta(), tpt.PTConfig(max_bounces=BOUNCES), cam, SPP,
                                     start, n, min(LANES, n), intersect_fn=ifn, pixel_sums=True,
                                     stats=steps)
        _add_pixel_sums(film, sums, SPP, start)
    assert film_mod.FilmConfig.from_json(cam.width, cam.height, cam.film).is_pixel_box
    np.testing.assert_array_equal(img, film_mod.scan(film).numpy())
    assert stats["bounce_steps"] == steps["bounce_steps"]


def test_tail_chunk_gets_its_own_trace(scene):
    """The tail chunk's StreamedTrace (another size, fewer lanes) gives what a
    fresh trace_streamed gives for it, after the full-size trace ran chunks."""
    _, s, tables, ifn = scene
    cam, cfg = s.cameras[0], tpt.PTConfig(max_bounces=BOUNCES)
    total = cam.width * cam.height * SPP
    tail = total % CHUNK
    full = tpt.StreamedTrace(tables, s.meta(), cfg, cam, SPP, CHUNK, LANES, intersect_fn=ifn,
                             pixel_sums=True)
    for start in _starts(total, CHUNK)[:2]:
        full(start)
    last = tpt.StreamedTrace(tables, s.meta(), cfg, cam, SPP, tail, min(LANES, tail),
                             intersect_fn=ifn, pixel_sums=True)
    got, rays = last(total - tail)
    want, want_rays = tpt.trace_streamed(tables, s.meta(), cfg, cam, SPP, total - tail, tail,
                                         min(LANES, tail), intersect_fn=ifn, pixel_sums=True)
    assert got.shape == (tail // SPP, 3)
    assert torch.equal(got, want) and torch.equal(rays, want_rays)


def test_launch_counter_counts_captured_launches_apart():
    """A launch under capture goes to `captured`, one outside to `launches`."""
    counter = cuda_graph.LaunchCounter()
    with mock.patch.object(torch.cuda, "is_current_stream_capturing", return_value=False):
        counter.count()
        counter.count()
    with mock.patch.object(torch.cuda, "is_current_stream_capturing", return_value=True):
        counter.count()
    assert (counter.launches, counter.captured) == (2, 1)
    cuda_graph._COUNTERS.remove(counter)


@pytest.mark.cuda
def test_graphed_trace_matches_eager_on_card():
    """On the card: one StreamedTrace over three chunks (the first bounce
    eager, the step captured at the second, replayed after) against an eager
    loop of the same step (the height field at n=32, 32x32, 4 spp, float32).
    Ray counts and bounce steps identical; per-pixel sums within rtol 2e-4,
    atol 2e-5 (the scatter into the sums is atomic, so its order varies); the
    traversal counted at 2 launches a bounce step both ways."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs and the kernel have no CPU mode); "
                    "chip_smoke.py runs it")
    from mcrt_tpu_torch.ops import traverse_kernel as tk

    s = mt.Scene(height_field_scene(32, 32, 2))
    cam, cfg = s.cameras[0], tpt.PTConfig()
    tables = s.tables(np.float32, "cuda")
    ifn = cluster_bvh.make_intersect_fn(tables, s.meta(), s.build_cluster_bvh(np.float32, "cuda"))
    n, lanes = 1024, 256
    graphed = tpt.StreamedTrace(tables, s.meta(), cfg, cam, 4, n, lanes, intersect_fn=ifn,
                                pixel_sums=True)
    eager = tpt.StreamedTrace(tables, s.meta(), cfg, cam, 4, n, lanes, intersect_fn=ifn,
                              pixel_sums=True)
    try:
        for start in (0, n, 2 * n):
            torch.cuda.synchronize()
            before, stats = tk.kernel.launches, {}
            got, rays = graphed(start, stats)
            torch.cuda.synchronize()
            launches = tk.kernel.launches - before
            st, steps, before = eager.initial(start), 0, tk.kernel.launches
            while bool(st.alive.any()):
                st = eager.step(st)
                steps += 1
            want, want_rays = eager.output(st)
            torch.cuda.synchronize()
            assert int(rays) == int(want_rays) and stats["bounce_steps"] == steps
            assert launches == tk.kernel.launches - before == 2 * steps
            torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)
            assert float(got.sum()) > 0.0
        assert graphed.graph is not None and graphed.graph.pool_bytes > 0
        assert eager.graph is None
    finally:
        graphed.close()
