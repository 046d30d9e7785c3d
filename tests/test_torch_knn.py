"""The port's photon k-NN against the JAX package's, on the CPU.

The grids are built by the JAX package and brought into the port with
convert.photon_grid_from_numpy, so both search the same sorted photons: the
maps of tests/test_knn_kernel.py and tests/test_photon.py (a volume, a thin
surface, a caustic hot spot over a sparse background, a sparse map), made by
tests/test_torch_knn_on_card.py::grid_and_queries, with three query sets:
each map's own queries, queries outside the map's box, and queries on cell
faces (tests/test_torch_knn_on_card.py::query_set).

Bars:
- the staged k-NN's plain version (knn_kernel.knn_plain, the CUDA kernels'
  CPU twin) against the Pallas kernel in interpret mode on the queries the
  Pallas kernel does not flag, and against brute force on those it flags;
  against the JAX exact k-NN on every masked query: identical id sets, r_k
  within rtol 1e-5 (float32);
- photon_grid.knn(exact=True) against the JAX one on every masked query:
  identical id sets, r_k within rtol 1e-5 in float32 and 1e-12 in float64;
  in float32 it never calls the brute force;
- each query's stage against a float64 recount of the ring that certifies
  it;
- the capped search: the same (id, weight) pairs, d2 within rtol 1e-12;
- save/load round trips, and a load of an .npz the JAX package wrote."""
import numpy as np
import pytest
import torch

from mcrt_tpu_torch import convert
from mcrt_tpu_torch.accel import knn_kernel as tkk
from mcrt_tpu_torch.accel import photon_grid as tpg
from test_torch_knn_on_card import KINDS, QUERY_SETS, photon_set, query_set

jnp = pytest.importorskip("jax.numpy")
from mcrt_tpu.accel import photon_grid as jpg  # noqa: E402
from mcrt_tpu.accel.knn_kernel import knn_pallas  # noqa: E402

torch.set_num_threads(1)  # pytest-xdist runs several workers on the same cores

K_OF = {"volume": 20, "surface": 50, "hotspot": 32, "sparse": 10}


def _jax_grid(kind, dtype, seed=0, qset="own", **kw):
    rng = np.random.RandomState(seed)
    pos, q = photon_set(kind, rng)
    d = rng.normal(size=pos.shape)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    grid = jpg.build_photon_grid(pos, d, rng.rand(*pos.shape), K_OF[kind], dtype, **kw)
    mask = rng.rand(len(q)) < 0.9
    if qset != "own":
        q = query_set(qset, grid.bb_min, grid.cell_size, grid.dims, q)
        mask = np.random.RandomState(seed + 1).rand(len(q)) < 0.9
    return grid, q, mask


def _port_grid(jgrid):
    a = jgrid.arrays
    return convert.photon_grid_from_numpy(
        np.asarray(a.pos), np.asarray(a.direction), np.asarray(a.flux),
        np.asarray(a.cell_start), jgrid.bb_min, jgrid.cell_size, jgrid.dims,
        jgrid.m_per_cell, jgrid.n_photons, device="cpu")


def _sets(idx, valid):
    idx, valid = np.asarray(idx), np.asarray(valid)
    return [frozenset(idx[i][valid[i]].tolist()) for i in range(len(idx))]


def _r2k(d2, valid):
    return np.max(np.where(np.asarray(valid), np.asarray(d2), 0.0), axis=1)


def _brute_sets(jgrid, q, k):
    p = np.asarray(jgrid.arrays.pos, np.float64)
    out = []
    for x in np.asarray(q, np.float64):
        d2 = np.sum((p - x) ** 2, axis=1)
        out.append(frozenset(np.argsort(d2, kind="stable")[:k].tolist()))
    return out


def _check_sorted_full(r, mask, k, n):
    """Every masked query has min(k, N) neighbours sorted by (d2, row); the
    others none."""
    valid, d2, idx = r.valid.numpy(), r.d2.numpy(), r.idx.numpy()
    assert (valid.sum(axis=1)[mask] == min(k, n)).all() and not valid[~mask].any()
    big = np.where(valid, d2, np.inf)
    order = np.lexsort((np.where(valid, idx, np.iinfo(np.int32).max), big), axis=1)
    assert (order == np.arange(k)[None, :]).all()


@pytest.mark.parametrize("kind", KINDS)
def test_plain_kernel_matches_pallas_interpret(kind):
    jgrid, q, mask = _jax_grid(kind, np.float32)
    k = K_OF[kind]
    q32 = q.astype(np.float32)
    tgrid = _port_grid(jgrid)
    r = tkk.knn_plain(tgrid, tgrid.arrays, torch.as_tensor(q32), k, mask=torch.as_tensor(mask))
    jd2, jidx, jvalid, jw, jneeds = map(np.asarray, knn_pallas(
        jgrid, jgrid.arrays, jnp.asarray(q32), k, mask=jnp.asarray(mask), interpret=True))
    ours = _sets(r.idx, r.valid)
    theirs = _sets(jidx, jvalid)
    both = mask & ~jneeds
    for i in np.nonzero(both)[0]:
        assert ours[i] == theirs[i], i
    np.testing.assert_allclose(_r2k(r.d2, r.valid)[both], _r2k(jd2, jvalid)[both], rtol=1e-5)
    # The port answers every masked query itself; those the Pallas kernel
    # flags for the brute fallback must equal brute force.
    only_port = np.nonzero(mask & jneeds)[0]
    if len(only_port):
        brute = _brute_sets(jgrid, q32[only_port], k)
        for i, b in zip(only_port, brute):
            assert ours[i] == b, i
    _check_sorted_full(r, mask, k, jgrid.n_photons)
    assert (r.stage.numpy()[mask] != 0).all() and (r.stage.numpy()[~mask] == 0).all()


@pytest.mark.parametrize("qset", QUERY_SETS)
@pytest.mark.parametrize("kind", KINDS)
def test_plain_kernel_matches_jax_exact(kind, qset):
    jgrid, q, mask = _jax_grid(kind, np.float32, qset=qset)
    k = K_OF[kind]
    q32 = q.astype(np.float32)
    tgrid = _port_grid(jgrid)
    r = tkk.knn_plain(tgrid, tgrid.arrays, torch.as_tensor(q32), k, mask=torch.as_tensor(mask))
    jd2, jidx, jvalid, _ = map(np.asarray, jpg.knn(jgrid, jgrid.arrays, jnp.asarray(q32), k,
                                                   mask=jnp.asarray(mask), exact=True))
    ours, theirs = _sets(r.idx, r.valid), _sets(jidx, jvalid)
    for i in np.nonzero(mask)[0]:
        assert ours[i] == theirs[i], i
    np.testing.assert_allclose(_r2k(r.d2, r.valid)[mask], _r2k(jd2, jvalid)[mask], rtol=1e-5)
    _check_sorted_full(r, mask, k, jgrid.n_photons)


@pytest.mark.parametrize("qset", QUERY_SETS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", KINDS)
def test_exact_knn_matches_jax(kind, dtype, qset):
    """photon_grid.knn(exact=True): the staged k-NN's plain version (float32),
    or the capped search and the brute fallback on its flagged rows (float64)."""
    jgrid, q, mask = _jax_grid(kind, dtype, qset=qset)
    k = K_OF[kind]
    qd = q.astype(dtype)
    tgrid = _port_grid(jgrid)
    stats = {}
    d2, idx, valid, w = tpg.knn(tgrid, tgrid.arrays, torch.as_tensor(qd), k,
                                mask=torch.as_tensor(mask), exact=True, stats=stats)
    jd2, jidx, jvalid, jw = map(np.asarray, jpg.knn(jgrid, jgrid.arrays, jnp.asarray(qd), k,
                                                    mask=jnp.asarray(mask), exact=True))
    ours, theirs = _sets(idx, valid), _sets(jidx, jvalid)
    for i in np.nonzero(mask)[0]:
        assert ours[i] == theirs[i], i
    rtol = 1e-5 if dtype == np.float32 else 1e-12
    np.testing.assert_allclose(_r2k(d2, valid)[mask], _r2k(jd2, jvalid)[mask], rtol=rtol)
    assert (w.numpy()[mask][valid.numpy()[mask]] == 1.0).all()   # exact: unit weights
    assert int(stats["knn_queries"]) == mask.sum() and stats["knn_calls"] == 1
    assert 0 <= int(stats["knn_flagged"]) <= mask.sum()
    if dtype == np.float32:
        assert 0 <= int(stats["knn_scanned"]) <= int(stats["knn_flagged"])


@pytest.mark.parametrize("k", [40, 56])
def test_exact_knn_k_at_least_n(k):
    """k >= N on the sparse map (40 photons): every masked query gets all N
    photons, sorted by (d2, row), as the JAX package's whole-map k-NN
    `_knn_brute` gives them. (The JAX package's exact path on the CPU returns
    its capped result when N <= k; its TPU path and the port return the N.)"""
    jgrid, q, mask = _jax_grid("sparse", np.float32, qset="outside")
    n = jgrid.n_photons
    assert k >= n
    q32 = q.astype(np.float32)
    tgrid = _port_grid(jgrid)
    r = tkk.knn_plain(tgrid, tgrid.arrays, torch.as_tensor(q32), k, mask=torch.as_tensor(mask))
    d2, idx, valid, _ = tpg.knn(tgrid, tgrid.arrays, torch.as_tensor(q32), k,
                                mask=torch.as_tensor(mask), exact=True)
    for x, y in zip((d2, idx, valid), (r.d2, r.idx, r.valid)):
        assert torch.equal(x, y)
    jd2, jidx, jvalid = map(np.asarray, jpg._knn_brute(jgrid.arrays, jnp.asarray(q32), k, n))
    ours, theirs = _sets(r.idx, r.valid), _sets(jidx, jvalid)
    for i in np.nonzero(mask)[0]:
        assert ours[i] == theirs[i] == frozenset(range(n)), i
    _check_sorted_full(r, mask, k, n)


def test_float32_exact_path_never_calls_the_brute_force(monkeypatch):
    """photon_grid.knn(exact=True) in float32 takes the staged k-NN's answer as
    final: with _knn_brute and torch.topk made to raise, it still answers the
    hot spot's outside queries, which reach the whole-map scan."""

    def refuse(*a, **kw):
        raise AssertionError("the float32 exact path must not call this")

    jgrid, q, mask = _jax_grid("hotspot", np.float32, qset="outside")
    tgrid = _port_grid(jgrid)
    monkeypatch.setattr(tpg, "_knn_brute", refuse)
    monkeypatch.setattr(torch, "topk", refuse)
    stats = {}
    d2, idx, valid, w = tpg.knn(tgrid, tgrid.arrays, torch.as_tensor(q.astype(np.float32)), 32,
                                mask=torch.as_tensor(mask), exact=True, stats=stats)
    assert int(stats["knn_scanned"]) > 0
    assert (valid.numpy().sum(axis=1)[mask] == 32).all()


def _recount_rings(jgrid, q32, k, cells):
    """A float64 recount, in numpy, of the ring that certifies each query:
    (lo, hi) (Q,) int, the first ring that the certification rule may pass
    and the first it must pass, given float32 roundings and the coordinate
    slack (the kernels' R2c sits between the two). A ring certifies when the
    k-th d2 over the whole map is at most the squared distance from the
    query to the part of the grid beyond the nearest face of the ring's box
    that is not on the grid's boundary. `cells` (Q, 3) are the queries'
    clamped cells, which centre the rings."""
    pos = np.asarray(jgrid.arrays.pos, np.float64)
    n = len(pos)
    dims = np.asarray(jgrid.dims)
    bb = np.asarray(jgrid.bb_min, np.float64)
    cell = jgrid.cell_size
    hi_g = bb + dims * cell
    slack = 2 * max(np.abs(bb).max(), np.abs(hi_g).max()) * 2.0 ** -20
    qd = q32.astype(np.float64)
    d2 = ((qd[:, None, :] - pos[None]) ** 2).sum(-1)
    kth = np.sort(d2, axis=1)[:, k - 1] if k <= n else np.full(len(qd), np.inf)
    out = np.maximum(np.maximum(bb - qd, qd - hi_g), 0.0)
    first = [np.zeros(len(qd), np.int64), np.zeros(len(qd), np.int64)]
    for r in range(1, int(dims.max()) + 2):
        lo = np.maximum(cells - r, 0)
        hi = np.minimum(cells + r, dims - 1)
        for j, shrink in enumerate((False, True)):      # may pass, must pass
            widen = lambda x: np.maximum(x - slack, 0.0) if shrink else x + slack
            o2 = widen(out) ** 2
            r2 = np.full(len(qd), np.inf)
            for a in range(3):
                rest = o2.sum(1) - o2[:, a]
                gap_lo = widen(qd[:, a] - (bb[a] + lo[:, a] * cell))
                gap_hi = widen(bb[a] + (hi[:, a] + 1) * cell - qd[:, a])
                r2 = np.where(lo[:, a] > 0, np.minimum(r2, gap_lo ** 2 + rest), r2)
                r2 = np.where(hi[:, a] < dims[a] - 1, np.minimum(r2, gap_hi ** 2 + rest), r2)
            r2 = r2 * ((1.0 - 1e-5) if shrink else (1.0 + 1e-5))
            ok = (kth <= r2) & (first[j] == 0)
            first[j][ok] = r
    return first[0], first[1]


@pytest.mark.parametrize("qset", QUERY_SETS)
@pytest.mark.parametrize("kind", KINDS)
def test_stage_matches_float64_recount(kind, qset):
    """Each masked query's stage is the first ring that certifies it (or the
    scan, when that ring's box exceeds the cell budget), by a float64
    brute-force recount."""
    jgrid, q, mask = _jax_grid(kind, np.float32, qset=qset)
    k = K_OF[kind]
    q32 = q.astype(np.float32)
    tgrid = _port_grid(jgrid)
    qt = torch.as_tensor(q32)
    r = tkk.knn_plain(tgrid, tgrid.arrays, qt, k, mask=torch.as_tensor(mask))
    srt = tkk.sort_queries(tgrid, qt)
    cells = np.empty((len(q), 3), np.int64)
    cells[srt.qcell[:, 3].numpy()] = srt.qcell[:, :3].numpy()
    lo, hi = _recount_rings(jgrid, q32, k, cells)
    dims = np.asarray(jgrid.dims)
    box = lambda rr: (np.minimum(cells + rr[:, None], dims - 1)
                      - np.maximum(cells - rr[:, None], 0) + 1).prod(axis=1)
    stage = r.stage.numpy().astype(np.int64)
    scan = stage == tkk.STAGE_SCAN
    ring = mask & ~scan
    assert ((lo <= stage) & (stage <= hi))[ring].all()
    assert (box(stage)[ring & (stage > 1)] <= tkk.CELL_BUDGET).all()
    assert (box(hi)[mask & scan] > tkk.CELL_BUDGET).all()
    assert (lo[mask] == hi[mask]).mean() > 0.9     # the slack decides few queries
    assert (stage[~mask] == 0).all()


@pytest.mark.parametrize("case", ["hotspot", "point"])
def test_capped_knn_matches_jax(case):
    """The capped one-ring search, where cells over the cap M are subsampled and
    their photons carry weight occ/M: tests/test_photon.py's hot spot, and a
    point-like focus no cell size can split."""
    if case == "hotspot":
        jgrid, q, _ = _jax_grid("hotspot", np.float64)
        k = K_OF["hotspot"]
    else:
        rng = np.random.RandomState(11)
        pos = np.concatenate([rng.randn(30_000, 3) * 1e-7, rng.rand(1_000, 3) * 10.0 - 5.0])
        jgrid = jpg.build_photon_grid(pos, pos, np.ones((len(pos), 3)) * 2.0, 32, np.float64)
        q = np.concatenate([rng.randn(48, 3) * 1e-7, rng.rand(16, 3) * 10.0 - 5.0])
        k = 32
    tgrid = _port_grid(jgrid)
    d2, idx, valid, w = tpg.knn(tgrid, tgrid.arrays, torch.as_tensor(q), k)
    jd2, jidx, jvalid, jw = map(np.asarray, jpg.knn(jgrid, jgrid.arrays, jnp.asarray(q), k))
    assert (jw != 1.0).any(), "the cap must bite somewhere"
    d2, idx, valid, w = d2.numpy(), idx.numpy(), valid.numpy(), w.numpy()
    for i in range(len(q)):
        ours = dict(zip(idx[i][valid[i]].tolist(), w[i][valid[i]].tolist()))
        theirs = dict(zip(jidx[i][jvalid[i]].tolist(), jw[i][jvalid[i]].tolist()))
        assert ours == theirs, i
        np.testing.assert_allclose(np.sort(d2[i][valid[i]]), np.sort(jd2[i][jvalid[i]]),
                                   rtol=1e-12)


def test_ties_keep_the_lower_row():
    """Equal distances resolve to the lower photon row, in the kernel's plain
    version and so in the kernel: duplicated photons at one point."""
    base = np.random.RandomState(2).rand(30, 3)
    pos = np.concatenate([base, base, base])          # every point three times
    grid = tpg.build_photon_grid(pos, pos, pos, 4, np.float32, device="cpu")
    q = torch.as_tensor(base[:8] + 1e-3, dtype=torch.float32)
    r = tkk.knn_plain(grid, grid.arrays, q, 4)
    d2, idx = r.d2.numpy(), r.idx.numpy()
    order = np.lexsort((idx, d2), axis=1)
    assert (np.take_along_axis(idx, order, 1) == idx).all()
    # The three copies of a point share d2: they come out in ascending row order.
    assert (d2[:, 0] == d2[:, 1]).all() and (d2[:, 1] == d2[:, 2]).all()
    assert (np.diff(idx[:, :3], axis=1) > 0).all()


def test_save_load_round_trip_and_jax_npz(tmp_path):
    jgrid, q, _ = _jax_grid("volume", np.float32)
    jpath = tmp_path / "jax.npz"
    jpg.save_photon_grid(jpath, jgrid)
    loaded = tpg.load_photon_grid(jpath, "cpu")
    direct = _port_grid(jgrid)
    assert (loaded.bb_min, loaded.cell_size, loaded.dims, loaded.m_per_cell,
            loaded.n_photons) == (direct.bb_min, direct.cell_size, direct.dims,
                                  direct.m_per_cell, direct.n_photons)
    for a, b in zip(loaded.arrays, direct.arrays):
        assert a.dtype == b.dtype and torch.equal(a, b)
    tpath = tmp_path / "port.npz"
    tpg.save_photon_grid(tpath, loaded)
    again = tpg.load_photon_grid(tpath, "cpu")
    for a, b in zip(again.arrays, loaded.arrays):
        assert torch.equal(a, b)
    back = jpg.load_photon_grid(tpath)          # the JAX package reads the port's file
    np.testing.assert_array_equal(np.asarray(back.arrays.pos), np.asarray(jgrid.arrays.pos))
    qt = torch.as_tensor(q.astype(np.float32))
    for x, y in zip(tpg.knn(again, again.arrays, qt, 20, exact=True),
                    tpg.knn(direct, direct.arrays, qt, 20, exact=True)):
        assert torch.equal(x, y)


def test_port_build_matches_jax_build():
    """build_photon_grid is the JAX package's host code: same cells, same order."""
    rng = np.random.RandomState(3)
    pos, _ = photon_set("hotspot", rng)
    d, f = rng.rand(*pos.shape), rng.rand(*pos.shape)
    jgrid = jpg.build_photon_grid(pos, d, f, 32, np.float64)
    tgrid = tpg.build_photon_grid(pos, d, f, 32, np.float64, device="cpu")
    assert (tgrid.bb_min, tgrid.cell_size, tgrid.dims, tgrid.m_per_cell, tgrid.n_photons) == (
        jgrid.bb_min, jgrid.cell_size, jgrid.dims, jgrid.m_per_cell, jgrid.n_photons)
    for a, b in zip(tgrid.arrays, jgrid.arrays):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    empty = tpg.build_photon_grid(np.zeros((0, 3)), np.zeros((0, 3)), np.zeros((0, 3)), 10,
                                  device="cpu")
    assert empty.empty and empty.arrays.pos.shape == (1, 3)
