"""The CUDA k-NN kernels against their plain PyTorch version, on the card.

Imports no JAX, so it also runs on a machine that has a card and no JAX:

    python3 -m pytest --noconftest -q tests/test_torch_knn_on_card.py

(`--noconftest`: tests/conftest.py sets up JAX for the JAX package's tests).
Without a card the kernel tests skip: a CUDA kernel has no CPU mode. The
grids here (a volume, a thin surface, a caustic hot spot over a sparse
background, a sparse map) and the query sets (each map's own queries, queries
outside the map's box, queries on cell faces) are also used by
tests/test_torch_knn.py, where the plain version is held against the JAX
package on the CPU.

Bar: the kernels and the plain version compute the same keys with the same
float32 roundings and the same certification arithmetic, so ids, d2, counts,
per-query stages and the queue counts are identical."""
import numpy as np
import pytest
import torch

from mcrt_tpu_torch.accel import knn_kernel as kk
from mcrt_tpu_torch.accel import photon_grid as pg

KINDS = ("volume", "surface", "hotspot", "sparse")
QUERY_SETS = ("own", "outside", "faces")


def photon_set(kind, rng):
    """(pos, queries) float64 numpy: photons of one kind of map and query points."""
    if kind == "volume":
        pos = rng.rand(5000, 3) * np.array([4, 1, 4])
        q = rng.rand(500, 3) * np.array([4, 1, 4])
    elif kind == "surface":
        n = 100_000
        pos = np.stack([rng.rand(n) * 4, 0.02 * rng.rand(n), rng.rand(n) * 4], 1)
        t = np.sort(rng.rand(1024))
        q = np.stack([t * 4, 0.01 * np.ones_like(t), (np.sin(t * 20) * 0.5 + 0.5) * 4], 1)
    elif kind == "hotspot":
        cluster = rng.randn(50_000, 3) * np.array([0.01, 0.01, 0.001])
        background = rng.rand(2_000, 3) * np.array([10.0, 10.0, 0.3]) - 5.0
        pos = np.concatenate([cluster, background])
        q = np.concatenate([rng.randn(64, 3) * np.array([0.012, 0.012, 0.002]),
                            rng.rand(16, 3) * np.array([10.0, 10.0, 0.3]) - 5.0])
    else:
        pos = rng.rand(40, 3)
        q = rng.rand(50, 3)
    return pos, q


def query_set(name, bb_min, cell_size, dims, q, seed=5, n=200):
    """Query points (float64 numpy) for a map whose grid starts at `bb_min`
    with `dims` cells of `cell_size`: the map's own queries `q`, points
    spread over three times the grid's box in each axis (most outside it,
    where the cell sort clamps them), or points on cell faces (each
    coordinate on a face with probability 0.6)."""
    if name == "own":
        return q
    rng = np.random.RandomState(seed)
    lo = np.asarray(bb_min)
    ext = np.asarray(dims) * cell_size
    if name == "outside":
        return lo + ext * (rng.rand(n, 3) * 3.0 - 1.0)
    i = rng.randint(0, np.asarray(dims), size=(n, 3))
    off = rng.rand(n, 3) * cell_size * (rng.rand(n, 3) < 0.4)
    return lo + i * cell_size + off


def grid_and_queries(kind, k, dtype=np.float32, device="cpu", seed=0, qset="own"):
    rng = np.random.RandomState(seed)
    pos, q = photon_set(kind, rng)
    d = rng.normal(size=pos.shape)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    grid = pg.build_photon_grid(pos, d, rng.rand(*pos.shape), k, dtype, device=device)
    mask = rng.rand(len(q)) < 0.9
    if qset != "own":
        q = query_set(qset, grid.bb_min, grid.cell_size, grid.dims, q)
        mask = np.random.RandomState(seed + 1).rand(len(q)) < 0.9
    return grid, q, mask


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode); chip_smoke.py runs them")


def _same(a, b, what):
    for name in ("idx", "valid", "stage", "queued"):
        assert torch.equal(getattr(a, name), getattr(b, name)), (what, name)
    assert torch.equal(a.d2, b.d2), what   # +inf in the same empty slots


@pytest.mark.cuda
@pytest.mark.parametrize("qset", QUERY_SETS)
@pytest.mark.parametrize("kind", KINDS)
def test_knn_kernel_matches_plain_on_card(kind, qset):
    _card()
    for k in (1, 20, kk.KPAD):
        grid, q, mask = grid_and_queries(kind, k, device="cuda", qset=qset)
        qt = torch.as_tensor(q, dtype=torch.float32, device="cuda")
        mt = torch.as_tensor(mask, device="cuda")
        before = [kern.launches for kern in kk.KERNELS]
        a = kk.knn(grid, grid.arrays, qt, k, mask=mt)
        torch.cuda.synchronize()
        assert [kern.launches for kern in kk.KERNELS] == [x + 1 for x in before]
        b = kk.knn_plain(grid, grid.arrays, qt, k, mask=mt)
        _same(a, b, (kind, qset, k))
        # masked queries read nothing and return nothing
        assert not bool(a.valid[~mt].any()) and bool((a.stage[~mt] == 0).all())
        assert bool((a.valid.sum(1)[mt] == min(k, grid.n_photons)).all())


@pytest.mark.cuda
def test_knn_scan_runs_on_card():
    """Queries outside a hot spot's fine grid need boxes past the cell budget:
    the whole-map scan answers them, bit for bit with the plain version; the
    kernels' count of photons evaluated includes all N for each of them, and
    nothing for a masked query."""
    _card()
    k = 32
    grid, q, mask = grid_and_queries("hotspot", k, device="cuda", qset="outside")
    qt = torch.as_tensor(q, dtype=torch.float32, device="cuda")
    mt = torch.as_tensor(mask, device="cuda")
    evaluated = torch.zeros(len(q), dtype=torch.int32, device="cuda")
    a = kk.knn(grid, grid.arrays, qt, k, mask=mt, evaluated=evaluated)
    b = kk.knn_plain(grid, grid.arrays, qt, k, mask=mt)
    _same(a, b, "scan")
    scanned = a.stage == kk.STAGE_SCAN
    assert int(a.queued[1]) > 0 and int(scanned.sum()) == int(a.queued[1])
    assert bool((evaluated[scanned] >= grid.n_photons).all())
    assert bool((evaluated[~mt] == 0).all())


@pytest.mark.cuda
def test_exact_knn_on_card_has_no_fallback(monkeypatch):
    """photon_grid.knn(exact=True) in float32 on the card runs the three kernels
    once each and neither the brute force nor torch.topk."""
    _card()

    def refuse(*a, **kw):
        raise AssertionError("the float32 exact path must not call this")

    monkeypatch.setattr(pg, "_knn_brute", refuse)
    monkeypatch.setattr(torch, "topk", refuse)
    grid, q, mask = grid_and_queries("hotspot", 32, device="cuda", qset="outside")
    qt = torch.as_tensor(q, dtype=torch.float32, device="cuda")
    mt = torch.as_tensor(mask, device="cuda")
    before = [kern.launches for kern in kk.KERNELS]
    stats = {}
    d2, idx, valid, w = pg.knn(grid, grid.arrays, qt, 32, mask=mt, exact=True, stats=stats)
    assert [kern.launches for kern in kk.KERNELS] == [x + 1 for x in before]
    assert int(stats["knn_scanned"]) > 0 and stats["knn_calls"] == 1
