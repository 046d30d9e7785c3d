"""The batch loops of both integrators, run over static buffers:
`path_tracer.BatchTrace` (`trace(differentiable=False)`) and
`photon_mapper.BatchEyePass` (the photon mapper's `trace`).

The JAX package compiles a batch chunk whole, its `lax.while_loop` included.
The port runs the loop one step at a time over static buffers
(utils/cuda_graph.GraphedLoop): on the card the first step eagerly, the second
captured as a CUDA graph, every later one replayed; on the CPU every step is
called, and these tests hold the reuse itself, float64, on
tests/scenes/caustic_sphere.json (2000 emissions x10 caustic_factor for the
photon mapper) and height_field_scene(6, 16, 2), each at 16x16 and 4 spp:

(a) one run over three batches of rays equals, bit for bit, fresh `trace`
    calls and the loop as it ran before it was graphed (the step called in a
    Python `while` under the JAX package's condition): radiance and stats;
(b) the batches of one kept run against the JAX package's `trace` of all the
    paths: the path tracer with tests/test_torch_path_tracer.py's bar
    (|port - JAX| <= 1e-8 on at least 99.5% of paths, rays within 0.5%), the
    photon mapper with tests/test_torch_photon.py's (rtol 1e-6 on at least
    99.5% of paths), on the same maps;
(c) the stop rule: with a small max_bounces that paths outlive, the run stops
    at the step where that `while` loop stops (the path tracer: no lane alive
    or the slowest at max_bounces; the eye pass: no lane alive), bit for bit;
(d) stale tables: one `sharded_render_step` called with tables A, then B
    (reflectance x0.5), then A gives each time, bit for bit, the film of a
    step made fresh for that call (a run that read the first call's tables
    would give A's film for B);
(e) `render(streamed=False)` with five chunks and a tail makes one run per
    chunk size, closes every run, and its image equals the film of fresh
    per-chunk calls bit for bit;
(f) the bench's diagnostic trace goes through one run, closed, and its
    traversal counters equal those of that `while` loop.

The card's cases (marked `cuda`, skipped without one) hold each integrator's
graphed run to the same loop with the step called eagerly: radiance within
rtol 2e-4, atol 2e-5; bounce steps, rays, k-NN counts and launches identical;
2 traversal launches (and 2 of each k-NN kernel) a replayed step; the step's
Python called twice (the eager step and the capture) and never after. JAX is
imported only inside the parity tests, which skip unless JAX is there in
float64 (tests/conftest.py turns that on), so on a machine with a card the
rest runs without the conftest:

    python3 -m pytest --noconftest -q tests/test_torch_graphed_batch.py
"""
import json
import pathlib
from unittest import mock

import numpy as np
import pytest
import torch

import mcrt_tpu_torch as mt
from mcrt_tpu_torch import bench, convert
from mcrt_tpu_torch.accel import photon_grid as pg
from mcrt_tpu_torch.camera import film as film_mod
from mcrt_tpu_torch.integrator import path_tracer as tpt
from mcrt_tpu_torch.integrator import photon_mapper as tpm
from mcrt_tpu_torch.ops import cluster_bvh
from mcrt_tpu_torch.ops import intersect as isect
from mcrt_tpu_torch.parallel import sharding
from mcrt_tpu_torch.render import _camera_rays
from mcrt_tpu_torch.sampling import sobol
from mcrt_tpu_torch.scene.synthetic import height_field_scene
from mcrt_tpu_torch.utils import cuda_graph

torch.set_num_threads(1)  # pytest-xdist runs several workers on the same cores

SCENES = pathlib.Path(__file__).parent / "scenes"
W = 16
SQRTSPP = 2
SPP = SQRTSPP * SQRTSPP
TOTAL = W * W * SPP  # 1024 paths
BATCH = 192          # five batches and a tail of 64
PM_EMISSIONS = 2000


def _caustic():
    j = json.loads((SCENES / "caustic_sphere.json").read_text())
    j["cameras"][0]["image"] = {"width": W, "height": W, "plain": True}
    j["cameras"][0]["sqrtspp"] = SQRTSPP
    j["photon_map"]["emissions"] = PM_EMISSIONS
    return j


SCENE_JSON = {"caustic_sphere": _caustic, "height_field": lambda: height_field_scene(6, W, SQRTSPP)}


@pytest.fixture(scope="module", params=sorted(SCENE_JSON))
def scene(request):
    """(json, scene, float64 tables, intersect): the cluster BVH's where the
    scene has one, else brute force."""
    j = SCENE_JSON[request.param]()
    s = mt.Scene(j)
    tables = s.tables(np.float64, "cpu")
    cbvh = s.build_cluster_bvh(np.float64, "cpu")
    ifn = isect.make_brute_fn(tables, s.meta()) if cbvh is None else \
        cluster_bvh.make_intersect_fn(tables, s.meta(), cbvh)
    return j, s, tables, ifn


@pytest.fixture(scope="module")
def caustic():
    """The caustic scene, its float64 tables, the port's photon rows and maps."""
    s = mt.Scene(_caustic())
    tables = s.tables(np.float64, "cpu")
    cfg = tpm.PMConfig.from_json(s.photon_map_config)
    rows = tpm.emit_photons(tables, s.meta(), cfg, s)
    maps = tpm.PhotonMaps(*(pg.build_photon_grid(*r, cfg.k_nearest_photons, np.float64,
                                                 device="cpu") for r in rows))
    return s, tables, cfg, rows, maps


def _rays(cam, start, n):
    return _camera_rays(cam, SPP, start, n, 0, torch.float64, torch.device("cpu"))


def _parent_pt(tables, meta, cfg, ifn, o, d, pix, si):
    """trace's loop as it ran before it was graphed: a fresh step called in a
    Python `while` any lane is alive and the slowest is below max_bounces.
    Returns (radiance, stats) as trace(return_stats=True), and the last state."""
    step = tpt.make_bounce_step(tables, meta, cfg, ifn)
    R = o.shape[0]
    st = tpt._init_state(tables, cfg, o, d, sobol.as_u32(pix, "cpu"), sobol.as_u32(si, "cpu"),
                         torch.ones((R,), dtype=torch.bool), torch.arange(R, dtype=torch.int32),
                         torch.full((), R, dtype=torch.int64), torch.zeros((), dtype=torch.int64),
                         torch.zeros((1, 3), dtype=o.dtype))
    steps = 0
    while bool(st.alive.any() & (st.bounce.min() < cfg.max_bounces)):
        st = step(st)
        steps += 1
    stats = {"rays": st.ray_count, "bounce_steps": steps}
    if step.counted:
        stats["traversal_steps"] = st.trav_steps
    return st.radiance, stats, st


def _parent_pm(tables, meta, cfg, maps, o, d, pix, si):
    """The eye pass's batch loop as it ran before it was graphed: a fresh step
    called in a Python `while` any lane is alive. Returns (radiance, stats)."""
    step = tpm._make_eye_step(tables, meta, cfg, maps,
                              lambda a, b: isect.intersect_brute(tables, meta, a, b))
    R = o.shape[0]
    st = tpm._init_eye(tables, cfg, o, d, sobol.as_u32(pix, "cpu"), sobol.as_u32(si, "cpu"),
                       torch.ones((R,), dtype=torch.bool), torch.arange(R, dtype=torch.int32),
                       torch.full((), R, dtype=torch.int64), torch.zeros((1, 3), dtype=o.dtype), 0)
    steps = 0
    while bool(st.alive.any()):
        st = step(st)
        steps += 1
    stats = {}
    tpm._add_stats(stats, maps, steps, st.knn)
    return st.radiance, stats


def _same_stats(a, b):
    assert set(a) == set(b)
    for key in a:
        assert torch.equal(torch.as_tensor(a[key]), torch.as_tensor(b[key])), key


def _counting_runs(cls):
    """A subclass of `cls` that records each instance made, the batch sizes
    each loads (`sizes`) and each close."""
    made, closed = [], []

    class Counted(cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.sizes = set()
            made.append(self)

        def load(self, init):
            self.sizes.add(init.origin.shape[0])
            super().load(init)

        def close(self):
            closed.append(self)
            super().close()

    return Counted, made, closed


# ---- (a) reuse against fresh calls and the parent's loop ----

def test_batch_trace_reused_matches_fresh_calls(scene):
    """One BatchTrace, kept in `graphs`, over three batches equals fresh
    trace calls and the parent's loop bit for bit: radiance, rays, bounce
    steps and (the cluster BVH) traversal_steps."""
    _, s, tables, ifn = scene
    cfg = tpt.PTConfig(max_bounces=12)
    graphs = {}
    for start in (0, BATCH, 3 * BATCH):
        r = _rays(s.cameras[0], start, BATCH)
        args = (tables, s.meta(), cfg, r.origin, r.direction, r.pixel_index, r.sample_index)
        got, st = tpt.trace(*args, intersect_fn=ifn, return_stats=True, graphs=graphs)
        want, st_fresh = tpt.trace(*args, intersect_fn=ifn, return_stats=True)
        parent, st_parent, _ = _parent_pt(tables, s.meta(), cfg, ifn, r.origin, r.direction,
                                          r.pixel_index, r.sample_index)
        assert torch.equal(got, want) and torch.equal(got, parent), start
        _same_stats(st, st_fresh)
        _same_stats(st, st_parent)
        assert st["bounce_steps"] > 0 and float(got.sum()) > 0.0
    (run,) = graphs.values()
    assert isinstance(run, tpt.BatchTrace) and run.state.origin.shape[0] == BATCH
    assert ("traversal_steps" in st) == (ifn.key[0] == "cluster_bvh")
    run.close()
    assert run.state is None and run.graph is None


def test_batch_eye_pass_reused_matches_fresh_calls(caustic):
    """One BatchEyePass over three batches equals fresh photon_mapper.trace
    calls and the parent's loop bit for bit: radiance, bounce steps and the
    k-NN counts."""
    s, tables, cfg, _, maps = caustic
    run = tpm.BatchEyePass(tables, s.meta(), cfg, maps)
    try:
        for start in (0, BATCH, 3 * BATCH):
            r = _rays(s.cameras[0], start, BATCH)
            rays = (r.origin, r.direction, r.pixel_index, r.sample_index)
            st, st_fresh = {}, {}
            got = run(*rays, st)
            want = tpm.trace(tables, s.meta(), cfg, maps, *rays, stats=st_fresh)
            parent, st_parent = _parent_pm(tables, s.meta(), cfg, maps, *rays)
            assert torch.equal(got, want) and torch.equal(got, parent), start
            _same_stats(st, st_fresh)
            _same_stats(st, st_parent)
            assert st["bounce_steps"] > 0 and int(st["knn_queries"]) > 0
            assert float(got.sum()) > 0.0
    finally:
        run.close()
    assert run.state is None and run.graph is None


# ---- (b) parity with the JAX package ----

def _jax_x64():
    jax = pytest.importorskip("jax")
    if not jax.config.jax_enable_x64:
        pytest.skip("needs JAX in float64, which tests/conftest.py turns on")


def _jax_rays(js, jt):
    import jax.numpy as jnp
    from mcrt_tpu.camera import camera as jcam

    cam = js.cameras[0]
    lin = np.arange(TOTAL)
    pix = lin // SPP
    return jcam.generate_rays(cam, pix % cam.width, pix // cam.width, lin % SPP, jt.ior, 0,
                              jnp.float64)


def _as_torch(x):
    x = np.asarray(x)
    return torch.as_tensor(x.astype(np.float64 if x.dtype.kind == "f" else np.int64))


def test_batch_trace_matches_jax(scene):
    """Four batches of 256 paths through one kept BatchTrace against the JAX
    package's trace of all 1024 at once: |port - JAX| <= 1e-8 on at least
    99.5% of paths, rays traced within 0.5%."""
    _jax_x64()
    import jax.numpy as jnp
    from mcrt_tpu.integrator import path_tracer as jpt
    from mcrt_tpu.scene.loader import Scene as JScene

    j, s, tables, _ = scene
    js = JScene(j)
    jt = js.tables(jnp.float64)
    jr = _jax_rays(js, jt)
    want, jst = jpt.trace(jt, js.meta(), jpt.PTConfig(), jr.origin, jr.direction,
                          jr.pixel_index, jr.sample_index, return_stats=True)
    o, d, pix, si = (_as_torch(x) for x in (jr.origin, jr.direction, jr.pixel_index,
                                           jr.sample_index))
    graphs, got, rays = {}, [], 0
    for a in range(0, TOTAL, 256):
        rad, st = tpt.trace(tables, s.meta(), tpt.PTConfig(), o[a:a + 256], d[a:a + 256],
                            pix[a:a + 256], si[a:a + 256], return_stats=True, graphs=graphs)
        got.append(rad)
        rays += int(st["rays"])
    assert len(graphs) == 1
    got = torch.cat(got).numpy()
    err = np.abs(got - np.asarray(want)).max(axis=-1)
    assert float((err <= 1e-8).mean()) >= 0.995
    assert float(got.mean()) > 0.0
    assert abs(rays - int(jst["rays"])) <= 0.005 * int(jst["rays"])


def test_batch_eye_pass_matches_jax(caustic):
    """Four batches of 256 paths through one BatchEyePass against the JAX
    package's trace of all 1024, on the same maps (the JAX grids built from
    the port's photon rows, brought over by convert): within rtol 1e-6 of the
    JAX radiance on at least 99.5% of paths."""
    _jax_x64()
    import jax.numpy as jnp
    from mcrt_tpu.accel import photon_grid as jpg
    from mcrt_tpu.integrator import photon_mapper as jpm
    from mcrt_tpu.scene.loader import Scene as JScene

    s, tables, cfg, rows, _ = caustic
    js = JScene(_caustic())
    jt = js.tables(jnp.float64)
    jmaps = jpm.PhotonMaps(*(jpg.build_photon_grid(*r, cfg.k_nearest_photons, np.float64)
                             for r in rows))
    ours = tpm.PhotonMaps(*(convert.photon_grid_from_numpy(
        np.asarray(g.arrays.pos), np.asarray(g.arrays.direction), np.asarray(g.arrays.flux),
        np.asarray(g.arrays.cell_start), g.bb_min, g.cell_size, g.dims, g.m_per_cell,
        g.n_photons, device="cpu") for g in jmaps))
    jr = _jax_rays(js, jt)
    want = np.asarray(jpm.trace(jt, js.meta(), jpm.PMConfig.from_json(js.photon_map_config),
                                jmaps, jmaps.caustic.arrays, jmaps.global_.arrays, jr.origin,
                                jr.direction, jr.pixel_index, jr.sample_index))
    rays = [_as_torch(x) for x in (jr.origin, jr.direction, jr.pixel_index, jr.sample_index)]
    run = tpm.BatchEyePass(tables, s.meta(), cfg, ours)
    try:
        got = torch.cat([run(*(x[a:a + 256] for x in rays)) for a in range(0, TOTAL, 256)]).numpy()
    finally:
        run.close()
    assert got.shape == want.shape == (TOTAL, 3)
    err = np.abs(got - want).max(axis=-1)
    assert float((err <= 1e-6 * np.abs(want).max(axis=-1) + 1e-300).mean()) >= 0.995
    assert float(got.mean()) > 0.0


# ---- (c) the stop rule ----

def test_batch_trace_stops_at_max_bounces(scene):
    """max_bounces 3, which live paths outlive: the run stops after step 3,
    where the parent's loop stops, with lanes still alive, bit for bit; a
    loop on `alive.any()` alone (GraphedLoop's default rule) would go on."""
    _, s, tables, ifn = scene
    cfg = tpt.PTConfig(max_bounces=3)
    r = _rays(s.cameras[0], BATCH, 2 * BATCH)
    args = (r.origin, r.direction, r.pixel_index, r.sample_index)
    got, st = tpt.trace(tables, s.meta(), cfg, *args, intersect_fn=ifn, return_stats=True)
    want, st_parent, last = _parent_pt(tables, s.meta(), cfg, ifn, *args)
    assert st["bounce_steps"] == st_parent["bounce_steps"] == 3
    assert bool(last.alive.any())
    assert torch.equal(got, want)
    _same_stats(st, st_parent)
    run = tpt.BatchTrace(tpt.make_bounce_step(tables, s.meta(), cfg, ifn), cfg.max_bounces)
    assert bool(cuda_graph.GraphedLoop.running(run, last)) and not bool(run.running(last))


def test_batch_eye_pass_stops_when_no_lane_is_alive(caustic):
    """max_eye_bounces 2: the step itself ends every path at bounce 2, and the
    eye pass's loop (no lane alive) stops there, as the parent's loop does,
    bit for bit."""
    s, tables, _, _, maps = caustic
    cfg = tpm.PMConfig.from_json(s.photon_map_config, max_eye_bounces=2)
    r = _rays(s.cameras[0], 0, 2 * BATCH)
    rays = (r.origin, r.direction, r.pixel_index, r.sample_index)
    st = {}
    got = tpm.trace(tables, s.meta(), cfg, maps, *rays, stats=st)
    want, st_parent = _parent_pm(tables, s.meta(), cfg, maps, *rays)
    assert st["bounce_steps"] == st_parent["bounce_steps"] == 2
    assert torch.equal(got, want)
    _same_stats(st, st_parent)


# ---- (d) stale tables ----

def test_sharded_render_step_reloads_its_tables(scene):
    """One sharded_render_step (world of one) called with tables A, then B
    (reflectance x0.5), then A: each film equals, bit for bit, that of a
    step made fresh for the call; B's differs from A's; one run serves all
    three calls."""
    _, s, tables, _ = scene
    cam = s.cameras[0]
    meta = s.meta()
    cfg = tpt.PTConfig(max_bounces=12)
    film_cfg = film_mod.FilmConfig.from_json(cam.width, cam.height, cam.film)
    cbvh = s.build_cluster_bvh(np.float64, "cpu")
    lin = torch.arange(W * W)
    px, py, si = lin % W, lin // W, torch.zeros_like(lin)
    zero = torch.zeros((cam.height, cam.width, 4), dtype=torch.float64)
    b = tables._replace(mat_reflectance=tables.mat_reflectance * 0.5)

    def make():
        return sharding.sharded_render_step(meta, cfg, cam, film_cfg, sharding.LOCAL,
                                            torch.float64, with_bvh=True, device="cpu")

    step = make()
    films = []
    for t in (tables, b, tables):
        got = step(t, cbvh, px, py, si, zero)
        want = make()(t, cbvh, px, py, si, zero)
        assert torch.equal(got, want)
        films.append(got)
    assert len(step.graphs) == 1
    assert torch.equal(films[0], films[2]) and not torch.equal(films[0], films[1])


# ---- (e) render(streamed=False) ----

def test_batch_render_keeps_one_trace_per_chunk_size(scene):
    """render(streamed=False) with five chunks and a tail makes two
    BatchTraces (one per size) and closes both; its image equals the film of
    fresh trace calls per chunk, bit for bit, with the same bounce steps."""
    _, s, tables, ifn = scene
    cam = s.cameras[0]
    cfg = mt.RenderConfig(dtype="float64", max_bounces=12, rays_per_chunk=BATCH, streamed=False)
    counted, made, closed = _counting_runs(tpt.BatchTrace)
    stats = {}
    with mock.patch.object(tpt, "BatchTrace", counted):
        img = mt.render(s, 0, cfg, device="cpu", stats=stats)
    assert [r.sizes for r in made] == [{BATCH}, {TOTAL % BATCH}]
    assert sorted(map(id, closed)) == sorted(map(id, made))
    assert all(r.state is None and r.graph is None for r in made)
    assert stats["chunks"] == TOTAL // BATCH + 1

    film_cfg = film_mod.FilmConfig.from_json(cam.width, cam.height, cam.film)
    film = torch.zeros((cam.height, cam.width, 4), dtype=torch.float64)
    steps = 0
    for start in range(0, TOTAL, BATCH):
        n = min(BATCH, TOTAL - start)
        r = _rays(cam, start, n)
        rad, st = tpt.trace(tables, s.meta(), tpt.PTConfig(max_bounces=12), r.origin,
                            r.direction, r.pixel_index, r.sample_index, intersect_fn=ifn,
                            return_stats=True)
        film = film + film_mod.splat(film_cfg, r.px, rad)
        steps += st["bounce_steps"]
    np.testing.assert_array_equal(img, film_mod.scan(film).numpy())
    assert stats["bounce_steps"] == steps


def test_batch_photon_render_keeps_one_eye_pass_per_chunk_size(caustic):
    """render(integrator="photon_mapper", streamed=False) with five chunks
    and a tail makes two BatchEyePasses (one per size) and closes both; its
    image equals the film of fresh photon_mapper.trace calls per chunk on its
    own maps, bit for bit, with the same bounce steps and k-NN counts."""
    s, tables, _, _, _ = caustic
    cam = s.cameras[0]
    cfg = mt.RenderConfig(dtype="float64", integrator="photon_mapper", rays_per_chunk=BATCH,
                          streamed=False)
    counted, made, closed = _counting_runs(tpm.BatchEyePass)
    built = []
    real_build = tpm.build_photon_maps

    def build(*args, **kwargs):
        built.append(real_build(*args, **kwargs))
        return built[-1]

    stats = {}
    with mock.patch.object(tpm, "BatchEyePass", counted), \
            mock.patch.object(tpm, "build_photon_maps", build):
        img = mt.render(s, 0, cfg, device="cpu", stats=stats)
    assert [r.sizes for r in made] == [{BATCH}, {TOTAL % BATCH}]
    assert sorted(map(id, closed)) == sorted(map(id, made))
    assert all(r.state is None and r.graph is None for r in made)
    assert stats["chunks"] == TOTAL // BATCH + 1

    pmcfg = tpm.PMConfig.from_json(s.photon_map_config)
    film_cfg = film_mod.FilmConfig.from_json(cam.width, cam.height, cam.film)
    film = torch.zeros((cam.height, cam.width, 4), dtype=torch.float64)
    want = {}
    for start in range(0, TOTAL, BATCH):
        n = min(BATCH, TOTAL - start)
        r = _rays(cam, start, n)
        rad = tpm.trace(tables, s.meta(), pmcfg, built[0], r.origin, r.direction,
                        r.pixel_index, r.sample_index, stats=want)
        film = film + film_mod.splat(film_cfg, r.px, rad)
    np.testing.assert_array_equal(img, film_mod.scan(film).numpy())
    assert stats["bounce_steps"] == want["bounce_steps"]
    assert {k: int(stats[k]) for k in want if k.startswith("knn_")} == \
        {k: int(v) for k, v in want.items() if k.startswith("knn_")}


# ---- (f) the bench's diagnostic trace ----

def test_bench_diagnostic_trace_goes_through_one_run():
    """bench_ours at a tiny size: its diagnostic trace makes one BatchTrace
    and closes it, and its traversal counters [candidates, rounds] are the
    parent's loop's on the same rays."""
    scene = bench.bench_scene(8, 16, 1)
    counted, made, closed = _counting_runs(tpt.BatchTrace)
    with mock.patch.object(tpt, "BatchTrace", counted):
        out = bench.bench_ours(scene, "cpu", chunk_lg=8, lanes=1 << 6, diag_lg=7)
    assert len(made) == 1 and closed == made and made[0].state is None
    assert made[0].sizes == {1 << 7}

    cam = scene.cameras[0]
    tables = scene.tables(np.float32, "cpu")
    ifn = cluster_bvh.make_intersect_fn(tables, scene.meta(),
                                        scene.build_cluster_bvh(np.float32, "cpu"))
    n = 1 << 7
    first = bench._middle_row(cam, 1, n)
    r = _camera_rays(cam, 1, first, n, 0, torch.float32, torch.device("cpu"))
    _, st, _ = _parent_pt(tables, scene.meta(), tpt.PTConfig(), ifn, r.origin, r.direction,
                          r.pixel_index, r.sample_index)
    assert [out["walk_steps"], out["leaf_rounds"]] == st["traversal_steps"].tolist()
    assert out["walk_steps"] > 0


# ---- on the card ----

def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs and the kernels have no CPU mode); "
                    "chip_smoke.py runs it")


def _eager_advance(loop):
    """GraphedLoop.advance with the step called eagerly every time."""
    loop.state = loop.step(loop.state)


def _counting_steps(cls, calls):
    """A subclass of `cls` whose step counts its Python calls in `calls`."""

    class Counted(cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            inner = self.step

            def step(st):
                calls.append(1)
                return inner(st)

            self.step = step

    return Counted


@pytest.mark.cuda
def test_graphed_batch_trace_matches_eager_on_card():
    """On the card: trace(graphs=...) over three batches of 1024 paths of the
    height field at n=32, 32x32, 4 spp, float32, through one BatchTrace
    (the first step eager, the second captured, replays after), against the
    same calls with every step called eagerly: rays, bounce steps,
    traversal_steps and launches identical, radiance within rtol 2e-4, atol
    2e-5; 2 traversal launches a replayed step; the step's Python called
    twice in all."""
    _needs_card()
    from mcrt_tpu_torch.ops import traverse_kernel as tk

    s = mt.Scene(height_field_scene(32, 32, 2))
    cam, cfg = s.cameras[0], tpt.PTConfig()
    tables = s.tables(np.float32, "cuda")
    ifn = cluster_bvh.make_intersect_fn(tables, s.meta(), s.build_cluster_bvh(np.float32, "cuda"))
    n, calls, graphs = 1024, [], {}
    counted = _counting_steps(tpt.BatchTrace, calls)
    try:
        for start in (0, n, 2 * n):
            r = _camera_rays(cam, 4, start, n, 0, torch.float32, torch.device("cuda"))
            args = (tables, s.meta(), cfg, r.origin, r.direction, r.pixel_index, r.sample_index)
            runs = []
            for graphed in (True, False):
                torch.cuda.synchronize()
                before = tk.kernel.launches
                if graphed:
                    with mock.patch.object(tpt, "BatchTrace", counted):
                        out = tpt.trace(*args, intersect_fn=ifn, return_stats=True, graphs=graphs)
                else:
                    with mock.patch.object(cuda_graph.GraphedLoop, "advance", _eager_advance):
                        out = tpt.trace(*args, intersect_fn=ifn, return_stats=True)
                torch.cuda.synchronize()
                runs.append((out, tk.kernel.launches - before))
            ((got, sg), lg), ((want, se), le) = runs
            assert int(sg["rays"]) == int(se["rays"]) and sg["bounce_steps"] == se["bounce_steps"]
            assert torch.equal(sg["traversal_steps"], se["traversal_steps"])
            assert lg == le == 2 * sg["bounce_steps"]
            torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)
            assert float(got.sum()) > 0.0
        (run,) = graphs.values()
        assert run.graph is not None and run.graph.pool_bytes > 0
        assert {c.name: m for c, m in run.graph.per_replay}[tk.kernel.name] == 2
        assert len(calls) == 2
    finally:
        for run in graphs.values():
            run.close()


@pytest.mark.cuda
def test_graphed_batch_eye_pass_matches_eager_on_card():
    """On the card: a BatchEyePass over three batches of 1024 paths on the
    height field at n=32 with the caustic block's photon settings (k = 50),
    float32, graphed against an eager BatchEyePass: radiance within rtol
    2e-4, atol 2e-5; bounce steps, k-NN counts and the traversal's and k-NN
    kernels' launches identical; a replayed step runs 2 of each; the graphed
    run's step called twice in all."""
    _needs_card()
    from mcrt_tpu_torch.accel import knn_kernel as kk
    from mcrt_tpu_torch.ops import traverse_kernel as tk

    s = mt.Scene(height_field_scene(32, 32, 2, photon_map={
        "emissions": 2e4, "caustic_factor": 10.0, "k_nearest_photons": 50}))
    cam = s.cameras[0]
    tables = s.tables(np.float32, "cuda")
    ifn = cluster_bvh.make_intersect_fn(tables, s.meta(), s.build_cluster_bvh(np.float32, "cuda"))
    cfg = tpm.PMConfig.from_json(s.photon_map_config)
    rows = tpm.emit_photons(tables, s.meta(), cfg, s, intersect_fn=ifn)
    maps = tpm.PhotonMaps(*(pg.build_photon_grid(*r, cfg.k_nearest_photons, np.float32,
                                                 device="cuda") for r in rows))
    counters = (tk.kernel, *kk.KERNELS)
    calls = []
    graphed = _counting_steps(tpm.BatchEyePass, calls)(tables, s.meta(), cfg, maps, intersect_fn=ifn)
    eager = tpm.BatchEyePass(tables, s.meta(), cfg, maps, intersect_fn=ifn)
    n = 1024
    try:
        for start in (0, n, 2 * n):
            r = _camera_rays(cam, 4, start, n, 0, torch.float32, torch.device("cuda"))
            rays = (r.origin, r.direction, r.pixel_index, r.sample_index)
            runs = []
            for run, eager_steps in ((graphed, False), (eager, True)):
                torch.cuda.synchronize()
                before, stats = [c.launches for c in counters], {}
                if eager_steps:
                    with mock.patch.object(cuda_graph.GraphedLoop, "advance", _eager_advance):
                        out = run(*rays, stats)
                else:
                    out = run(*rays, stats)
                torch.cuda.synchronize()
                runs.append((out, {k: int(v) for k, v in stats.items() if k != "bounce_steps"},
                             stats["bounce_steps"], [c.launches - b for c, b in zip(counters, before)]))
            (got, kg, sg, lg), (want, ke, se, le) = runs
            assert kg == ke and sg == se and lg == le
            assert lg == [2 * sg] * 4
            torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)
            assert float(got.sum()) > 0.0
        assert graphed.graph is not None and graphed.graph.pool_bytes > 0
        # 1024 rays are 4 blocks: the traversal's launches run as two-CTA clusters.
        assert {c.name: m for c, m in graphed.graph.per_replay} == \
            {c.name: 2 for c in (*counters, tk.paired)}
        assert len(calls) == 2 and eager.graph is None
    finally:
        graphed.close()
        eager.close()
