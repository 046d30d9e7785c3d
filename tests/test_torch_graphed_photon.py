"""The photon mapper's reusable steps: the streamed eye pass
(`photon_mapper.StreamedEyePass`) and the emission (`photon_mapper._EmissionRun`).

Each step is built once and serves every chunk of its shape: the eye pass's
chunk start rides in the state (`_EyeState.start`, a device scalar), and so do
the emission chunk's tables (padded to CHUNK_EMISSIONS rows) and length. The
k-NN's counts ride in the state too (`_EyeState.knn`), since a captured step's
Python runs once. On the card each step is captured once as a CUDA graph and
replayed; on the CPU it runs eagerly, and these tests hold the reuse itself,
float64 unless a case says otherwise, on tests/scenes/caustic_sphere.json at
2000 emissions (x10 caustic_factor) and a 16x16 camera:

- a StreamedEyePass over several chunks and a tail equals fresh
  `trace_streamed` calls bit for bit, with the same stats;
- those chunks against the JAX package's `trace_streamed` on the same maps,
  with tests/test_torch_photon.py's bar (rtol 1e-6 on at least 99.5% of paths);
- emission through one run over several chunks and a short tail stores the
  JAX package's rows (atol 1e-9 after a sort), and a forced overflow reruns
  the chunk once through a run of its own and stores the same rows;
- the k-NN counts carried in the state equal the sums over the calls;
- the k-NN kernels' counters count captured launches apart;
- `render()` keeps one StreamedEyePass per chunk size and closes them.

The card's case (marked `cuda`, skipped without one) holds the graphed passes
to eager loops of the same steps. JAX is imported only inside the parity
tests, which skip unless JAX is there in float64 (tests/conftest.py turns that
on), so on a machine with a card the rest runs without the conftest:

    python3 -m pytest --noconftest -q tests/test_torch_graphed_photon.py
"""
import contextlib
import json
import pathlib
from unittest import mock

import numpy as np
import pytest
import torch

import mcrt_tpu_torch as mt
from mcrt_tpu_torch import convert
from mcrt_tpu_torch.accel import knn_kernel as kk
from mcrt_tpu_torch.accel import photon_grid as pg
from mcrt_tpu_torch.camera import film as film_mod
from mcrt_tpu_torch.integrator import photon_mapper as tpm
from mcrt_tpu_torch.ops import intersect as isect
from mcrt_tpu_torch.render import _add_pixel_sums
from mcrt_tpu_torch.scene.synthetic import height_field_scene
from mcrt_tpu_torch.utils import cuda_graph

torch.set_num_threads(1)  # pytest-xdist runs several workers on the same cores

SCENES = pathlib.Path(__file__).parent / "scenes"
W = 16
SPP = 2
TOTAL = W * W * SPP  # 512 paths
CHUNK = 96           # five chunks and a tail of 32
LANES = 48           # fewer lanes than paths: lanes reload paths as theirs die
EMIT_ROWS = 6000     # 20,000 emissions: three chunks and a tail of 2000
EMIT_LANES = 2048


def _caustic(emissions=2000, sqrtspp=1):
    j = json.loads((SCENES / "caustic_sphere.json").read_text())
    j["cameras"][0]["image"] = {"width": W, "height": W, "plain": True}
    j["cameras"][0]["sqrtspp"] = sqrtspp
    j["photon_map"]["emissions"] = emissions
    return j


@pytest.fixture(scope="module")
def caustic():
    """The scene, its float64 tables, the port's photon rows and its maps in
    float64 and float32 (the same rows)."""
    s = mt.Scene(_caustic())
    tables = s.tables(np.float64, "cpu")
    cfg = tpm.PMConfig.from_json(s.photon_map_config)
    rows = tpm.emit_photons(tables, s.meta(), cfg, s)
    maps = {dt: tpm.PhotonMaps(*(pg.build_photon_grid(*r, cfg.k_nearest_photons, dt, device="cpu")
                                 for r in rows))
            for dt in (np.float64, np.float32)}
    return s, tables, cfg, rows, maps


def _tables(s, tables, dtype):
    return tables if dtype == np.float64 else s.tables(np.float32, "cpu")


def _starts():
    return list(range(0, TOTAL - CHUNK + 1, CHUNK))


def _knn_ints(stats):
    return {k: int(v) for k, v in stats.items() if k.startswith("knn_")}


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_reused_eye_pass_matches_fresh_calls(caustic, dtype):
    """One StreamedEyePass over five chunks, and one for the tail, equal
    trace_streamed called fresh for each chunk, bit for bit: radiance, bounce
    steps and the k-NN counts."""
    s, tables, cfg, _, maps = caustic
    t, maps, cam = _tables(s, tables, dtype), maps[dtype], s.cameras[0]
    run = tpm.StreamedEyePass(t, s.meta(), cfg, maps, cam, SPP, CHUNK, LANES)
    tail = TOTAL % CHUNK
    last = tpm.StreamedEyePass(t, s.meta(), cfg, maps, cam, SPP, tail, LANES)
    got_stats, want_stats = {}, {}
    for start in _starts():
        got = run(start, got_stats)
        want = tpm.trace_streamed(t, s.meta(), cfg, maps, cam, SPP, start, CHUNK, LANES,
                                  stats=want_stats)
        assert torch.equal(got, want), start
    got = last(TOTAL - tail, got_stats)
    want = tpm.trace_streamed(t, s.meta(), cfg, maps, cam, SPP, TOTAL - tail, tail, LANES,
                              stats=want_stats)
    assert got.shape == (tail, 3) and torch.equal(got, want)
    assert float(got.sum()) > 0.0
    assert got_stats["bounce_steps"] == want_stats["bounce_steps"] > 0
    assert _knn_ints(got_stats) == _knn_ints(want_stats)
    run.close()
    last.close()
    assert run.state is None and run.graph is None


def test_reused_eye_pass_matches_jax(caustic):
    """The chunks of a reused StreamedEyePass against the JAX package's
    trace_streamed of all the paths at once, on the same maps (the JAX grids
    built from the port's photon rows, brought over by convert)."""
    jax = pytest.importorskip("jax")
    if not jax.config.jax_enable_x64:
        pytest.skip("the JAX parity runs in float64 (tests/conftest.py enables x64)")
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
    want = np.asarray(jpm.trace_streamed(
        jt, js.meta(), jpm.PMConfig.from_json(js.photon_map_config), jmaps, jmaps.caustic.arrays,
        jmaps.global_.arrays, js.cameras[0], SPP, 0, TOTAL, LANES))
    cam = s.cameras[0]
    tail = TOTAL % CHUNK
    run = tpm.StreamedEyePass(tables, s.meta(), cfg, ours, cam, SPP, CHUNK, LANES)
    last = tpm.StreamedEyePass(tables, s.meta(), cfg, ours, cam, SPP, tail, LANES)
    got = torch.cat([run(start) for start in _starts()] + [last(TOTAL - tail)]).numpy()
    assert got.shape == want.shape == (TOTAL, 3)
    err = np.abs(got - want).max(axis=-1)
    assert float((err <= 1e-6 * np.abs(want).max(axis=-1) + 1e-300).mean()) >= 0.995
    assert float(got.mean()) > 0.0


def _counting_runs(cls):
    """A subclass of `cls` that records each instance made and each close."""
    made, closed = [], []

    class Counted(cls):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

        def close(self):
            closed.append(self)
            super().close()

    return Counted, made, closed


def _sorted_rows(pos, d, f):
    rows = np.concatenate([np.asarray(pos), np.asarray(d), np.asarray(f)], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


def test_reused_emission_matches_jax(caustic, monkeypatch):
    """Emission in chunks of 6000 (three and a tail of 2000) through one
    _EmissionRun stores the rows of the JAX package's emit_photons (one
    chunk), and the rows of one fresh run per chunk, bit for bit."""
    jax = pytest.importorskip("jax")
    if not jax.config.jax_enable_x64:
        pytest.skip("the JAX parity runs in float64 (tests/conftest.py enables x64)")
    import jax.numpy as jnp

    from mcrt_tpu.integrator import photon_mapper as jpm
    from mcrt_tpu.scene.loader import Scene as JScene

    s, tables, _, _, _ = caustic
    cfg = tpm.PMConfig.from_json(s.photon_map_config, emission_chunk=EMIT_LANES)
    monkeypatch.setattr(tpm, "CHUNK_EMISSIONS", EMIT_ROWS)
    counted, made, closed = _counting_runs(tpm._EmissionRun)
    monkeypatch.setattr(tpm, "_EmissionRun", counted)
    stats = {}
    tc, tg = tpm.emit_photons(tables, s.meta(), cfg, s, stats=stats)
    assert len(made) == 1 and closed == made and made[0].state is None
    assert stats["emission_steps"] > 0 and "emission_reruns" not in stats

    js = JScene(_caustic())
    jc, jg = jpm.emit_photons(js.tables(jnp.float64), js.meta(),
                              jpm.PMConfig.from_json(js.photon_map_config), js)
    assert len(tc[0]) > 100 and len(tg[0]) > 100
    for ours, theirs in ((tc, jc), (tg, jg)):
        assert len(ours[0]) == len(theirs[0])
        np.testing.assert_allclose(_sorted_rows(*ours), _sorted_rows(*theirs), rtol=0, atol=1e-9)

    # One fresh run per chunk stores the same rows in the same order.
    light_idx, emission_idx, flux_pp = tpm.emission_plan(s, cfg)
    flux = torch.as_tensor(flux_pp, dtype=torch.float64)
    fresh_c, fresh_g = [], []
    for a in range(0, len(light_idx), EMIT_ROWS):
        ifn = lambda o, d: isect.intersect_brute(tables, s.meta(), o, d)
        run = tpm._EmissionRun(tables, s.meta(), cfg, ifn, flux, EMIT_LANES, EMIT_ROWS,
                               4 * EMIT_ROWS)
        c_n, g_n = run(light_idx[a:a + EMIT_ROWS], emission_idx[a:a + EMIT_ROWS], {})
        fresh_c.append(run.state.c_buf[:c_n].numpy())
        fresh_g.append(run.state.g_buf[:g_n].numpy())
    np.testing.assert_array_equal(np.concatenate(tc, axis=1), np.concatenate(fresh_c))
    np.testing.assert_array_equal(np.concatenate(tg, axis=1), np.concatenate(fresh_g))


def test_emission_overflow_reruns_through_its_own_run(caustic, monkeypatch):
    """Store buffers far too small for the one chunk (20 rows for 20,000
    emissions, as test_emission_overflow_grows_the_buffer forces it): the
    chunk runs again through a second _EmissionRun with buffers of its
    counted size, counted as one rerun, and stores the photons of an unhurried
    run, row for row. Both runs are closed."""
    s, tables, cfg, rows, _ = caustic
    counted, made, closed = _counting_runs(tpm._EmissionRun)
    monkeypatch.setattr(tpm, "_EmissionRun", counted)
    monkeypatch.setattr(tpm, "STORE_MARGIN", 1e-3)
    stats = {}
    small = tpm.emit_photons(tables, s.meta(), cfg, s, stats=stats)
    assert stats["emission_reruns"] == 1
    assert [r.cap for r in made] == [20, max(len(rows[0][0]), len(rows[1][0]))]
    assert closed == made and all(r.state is None for r in made)
    for a, b in zip(small[0] + small[1], rows[0] + rows[1]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_knn_counts_in_state_equal_per_call_sums(caustic, dtype):
    """The k-NN counts a StreamedEyePass carries in its state, added to the
    stats after each chunk, equal the counts summed over its k-NN calls: the
    queries (the mask's), the calls (two a bounce step), and in float32 (the
    staged k-NN's plain version) the queries each call sent to stage B and
    to the scan, in float64 (the capped search) those the brute force
    re-answered and no scan. The brute force runs over every query of every
    call, at a fixed shape, so that nothing syncs the host."""
    s, tables, cfg, _, maps = caustic
    t, maps = _tables(s, tables, dtype), maps[dtype]
    calls, brute_rows = [], []
    real_counted, real_brute = pg.knn_counted, pg._knn_brute

    def counted(grid, arrays, points, k, mask=None):
        calls.append((grid, arrays, points, k, mask))
        return real_counted(grid, arrays, points, k, mask)

    def brute(arrays, points, k, n, chunk=None):
        brute_rows.append(points.shape[0])
        return real_brute(arrays, points, k, n, chunk)

    stats = {}
    run = tpm.StreamedEyePass(t, s.meta(), cfg, maps, s.cameras[0], SPP, CHUNK, LANES)
    with mock.patch.object(pg, "knn_counted", counted), mock.patch.object(pg, "_knn_brute", brute):
        for start in _starts()[:3]:
            run(start, stats)
    run.close()
    assert len(calls) == 2 * stats["bounce_steps"] == stats["knn_calls"]
    assert int(stats["knn_queries"]) == sum(int(c[4].sum()) for c in calls) > 0
    if dtype == np.float32:
        queued = sum(kk.knn_plain(g, a, p, k, m).queued.to(torch.int64) for g, a, p, k, m in calls)
        assert [int(stats["knn_flagged"]), int(stats["knn_scanned"])] == queued.tolist()
    else:
        flagged = 0
        for g, a, p, k, m in calls:
            (_, _, valid, _), trunc = pg._knn_capped(g, a, p, k)
            flagged += int(((trunc | (valid.sum(dim=1) < k)) & m).sum())
        assert int(stats["knn_scanned"]) == 0
        assert int(stats["knn_flagged"]) == flagged > 0
        assert brute_rows == [c[2].shape[0] for c in calls]


def test_knn_counters_count_captured_launches_apart():
    """The three k-NN kernels count on LaunchCounters: a launch under capture
    goes to `captured`, one outside to `launches`, and a replay of a captured
    step adds the launches its graph holds."""
    assert [kern.name for kern in kk.KERNELS] == ["knn_ring1", "knn_rings", "knn_scan"]
    saved = [(kern.launches, kern.captured) for kern in kk.KERNELS]
    try:
        for kern in kk.KERNELS:
            assert isinstance(kern, cuda_graph.LaunchCounter) and kern in cuda_graph._COUNTERS
            kern.launches = kern.captured = 0
            with mock.patch.object(torch.cuda, "is_current_stream_capturing", return_value=False):
                kk._check(0, kern)
                kk._check(0, kern)
            with mock.patch.object(torch.cuda, "is_current_stream_capturing", return_value=True):
                kk._check(0, kern)
            assert (kern.launches, kern.captured) == (2, 1)
            with pytest.raises(RuntimeError, match=kern.name):
                kk._check(1, kern)
        step = object.__new__(cuda_graph.CapturedStep)
        step.graph = mock.Mock()
        step.per_replay = [(kern, 2) for kern in kk.KERNELS]
        step.replay()
        step.replay()
        assert step.graph.replay.call_count == 2
        assert [(kern.launches, kern.captured) for kern in kk.KERNELS] == [(6, 1)] * 3
    finally:
        for kern, (n, c) in zip(kk.KERNELS, saved):
            kern.launches, kern.captured = n, c


def test_render_keeps_one_eye_pass_per_chunk_size(caustic):
    """render(integrator="photon_mapper") with five chunks and a tail makes
    two StreamedEyePasses (one per size) and closes both, and its image
    equals the film built from fresh trace_streamed calls per chunk on its
    own photon maps, bit for bit."""
    s, _, _, _, _ = caustic
    cam = s.cameras[0]
    cfg = mt.RenderConfig(dtype="float64", integrator="photon_mapper", sqrtspp=1,
                          rays_per_chunk=CHUNK // SPP, lanes=LANES)
    total = W * W
    counted, made, closed = _counting_runs(tpm.StreamedEyePass)
    built = []
    real_build = tpm.build_photon_maps

    def build(*args, **kwargs):
        built.append(real_build(*args, **kwargs))
        return built[-1]

    stats = {}
    with mock.patch.object(tpm, "StreamedEyePass", counted), \
            mock.patch.object(tpm, "build_photon_maps", build):
        img = mt.render(s, 0, cfg, device="cpu", stats=stats)
    chunk = CHUNK // SPP
    assert [r.regen.n_paths for r in made] == [chunk, total % chunk]
    assert sorted(map(id, closed)) == sorted(map(id, made))
    assert all(r.state is None for r in made)
    assert stats["chunks"] == total // chunk + 1

    tables = s.tables(np.float64, "cpu")
    pmcfg = tpm.PMConfig.from_json(s.photon_map_config)
    film = torch.zeros((cam.height, cam.width, 4), dtype=torch.float64)
    steps = {}
    for start in range(0, total, chunk):
        n = min(chunk, total - start)
        rad = tpm.trace_streamed(tables, s.meta(), pmcfg, built[0], cam, 1, start, n,
                                 min(LANES, n), stats=steps)
        _add_pixel_sums(film, rad, 1, start)
    assert film_mod.FilmConfig.from_json(cam.width, cam.height, cam.film).is_pixel_box
    np.testing.assert_array_equal(img, film_mod.scan(film).numpy())
    assert stats["bounce_steps"] == steps["bounce_steps"]
    assert _knn_ints(stats) == _knn_ints(steps)


def _eager_advance(loop):
    """GraphedLoop.advance with the step called eagerly every time."""
    loop.state = loop.step(loop.state)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [50, 64])
def test_graphed_photon_passes_match_eager_on_card(k):
    """On the card: emission and a StreamedEyePass over three chunks, each
    graphed (the first step eager, the second captured, replays after) and
    with every step called eagerly, on the height field at n=32 with the
    caustic block's photon settings, float32, k nearest photons. The stored
    rows identical; the eye pass's radiance within rtol 2e-4, atol 2e-5;
    bounce steps, k-NN counts and the traversal's and k-NN kernels' launches
    equal. At k = 50 the staged k-NN kernels run; at k = 64 (over KPAD) the
    capped search and its brute force do, and capture as well."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs and the kernels have no CPU mode); "
                    "chip_smoke.py runs it")
    from mcrt_tpu_torch.ops import cluster_bvh
    from mcrt_tpu_torch.ops import traverse_kernel as tk

    s = mt.Scene(height_field_scene(32, 32, 2, photon_map={
        "emissions": 2e4, "caustic_factor": 10.0, "k_nearest_photons": k}))
    cam = s.cameras[0]
    tables = s.tables(np.float32, "cuda")
    ifn = cluster_bvh.make_intersect_fn(tables, s.meta(), s.build_cluster_bvh(np.float32, "cuda"))
    cfg = tpm.PMConfig.from_json(s.photon_map_config)
    counters = (tk.kernel, *kk.KERNELS)

    def emit():
        before, stats = [c.launches for c in counters], {}
        rows = tpm.emit_photons(tables, s.meta(), cfg, s, intersect_fn=ifn, stats=stats)
        return rows, stats, [c.launches - b for c, b in zip(counters, before)]

    rows_g, stats_g, launches_g = emit()
    with mock.patch.object(cuda_graph.GraphedLoop, "advance", _eager_advance):
        rows_e, stats_e, launches_e = emit()
    for a, b in zip(rows_g[0] + rows_g[1], rows_e[0] + rows_e[1]):
        np.testing.assert_array_equal(a, b)
    assert stats_g == stats_e and launches_g == launches_e and launches_g[0] > 0

    maps = tpm.PhotonMaps(*(pg.build_photon_grid(*r, cfg.k_nearest_photons, np.float32,
                                                 device="cuda") for r in rows_g))
    n, lanes = 1024, 256
    graphed = tpm.StreamedEyePass(tables, s.meta(), cfg, maps, cam, 4, n, lanes, intersect_fn=ifn)
    eager = tpm.StreamedEyePass(tables, s.meta(), cfg, maps, cam, 4, n, lanes, intersect_fn=ifn)
    try:
        for start in (0, n, 2 * n):
            runs = []
            for run, patch in ((graphed, contextlib.nullcontext()),
                               (eager, mock.patch.object(cuda_graph.GraphedLoop, "advance",
                                                         _eager_advance))):
                torch.cuda.synchronize()
                before, stats = [c.launches for c in counters], {}
                with patch:
                    out = run(start, stats)
                torch.cuda.synchronize()
                runs.append((out, _knn_ints(stats), stats["bounce_steps"],
                             [c.launches - b for c, b in zip(counters, before)]))
            (got, kg, sg, lg), (want, ke, se, le) = runs
            assert kg == ke and sg == se and lg == le and lg[0] > 0
            assert min(lg[1:]) > 0 if k <= kk.KPAD else max(lg[1:]) == 0
            assert k <= kk.KPAD or kg["knn_flagged"] > 0   # the brute force re-answered some
            torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)
            assert float(got.sum()) > 0.0
        assert graphed.graph is not None and graphed.graph.pool_bytes > 0
        assert eager.graph is None
    finally:
        graphed.close()
        eager.close()
