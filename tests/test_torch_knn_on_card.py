"""The CUDA one-ring k-NN kernel against its plain PyTorch version, on the card.

Imports no JAX, so it also runs on a machine that has a card and no JAX:

    python3 -m pytest --noconftest -q tests/test_torch_knn_on_card.py

(`--noconftest`: tests/conftest.py sets up JAX for the JAX package's tests).
Without a card the kernel test skips: a CUDA kernel has no CPU mode. The
grids here (a volume, a thin surface, a caustic hot spot over a sparse
background, a sparse map) are also used by tests/test_torch_knn.py, where
the plain version is held against the JAX package on the CPU.

Bar: the kernel and the plain version compute the same candidates with the
same float32 roundings and the same tie rule, so ids, d2, counts, flags and
per-block stats are identical."""
import numpy as np
import pytest
import torch

from mcrt_tpu_torch.accel import knn_kernel as kk
from mcrt_tpu_torch.accel import photon_grid as pg

KINDS = ("volume", "surface", "hotspot", "sparse")


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


def grid_and_queries(kind, k, dtype=np.float32, device="cpu", seed=0):
    rng = np.random.RandomState(seed)
    pos, q = photon_set(kind, rng)
    d = rng.normal(size=pos.shape)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    grid = pg.build_photon_grid(pos, d, rng.rand(*pos.shape), k, dtype, device=device)
    mask = rng.rand(len(q)) < 0.9
    return grid, q, mask


@pytest.mark.cuda
@pytest.mark.parametrize("kind", KINDS)
def test_knn_kernel_matches_plain_on_card(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode); chip_smoke.py runs it")
    for k in (1, 20, kk.KPAD):
        grid, q, mask = grid_and_queries(kind, k, device="cuda")
        qt = torch.as_tensor(q, dtype=torch.float32, device="cuda")
        mt = torch.as_tensor(mask, device="cuda")
        before = kk.kernel.launches
        a = kk.knn(grid, grid.arrays, qt, k, mask=mt)
        torch.cuda.synchronize()
        assert kk.kernel.launches == before + 1
        b = kk.knn_plain(grid, grid.arrays, qt, k, mask=mt)
        for name in ("idx", "valid", "needs_exact", "stats"):
            assert torch.equal(getattr(a, name), getattr(b, name)), (kind, k, name)
        assert torch.equal(a.d2, b.d2), (kind, k)   # +inf in the same empty slots
        assert not bool(a.valid[~mt].any())          # masked queries do no work
