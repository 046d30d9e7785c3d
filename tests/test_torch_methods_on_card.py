"""Float64 on the card, whose tables take the best-first route.

Imports no JAX, so it also runs on a machine that has a card and no JAX:

    python3 -m pytest --noconftest -q tests/test_torch_methods_on_card.py

Without a card every test skips (best-first runs on the CPU too, where
tests/test_torch_traverse_methods.py holds it to the JAX package; what is
checked here is the card's own arithmetic and routes): float64 tables on the
card take best-first with every loop step eager, and a render, a train step
and an exact k-NN there agree with the CPU's (whose route is the kernel's
plain version) within rtol 1e-9.
"""
import numpy as np
import pytest
import torch

import mcrt_tpu_torch as mt
from mcrt_tpu_torch.accel import photon_grid as pg
from mcrt_tpu_torch.camera import film as film_mod
from mcrt_tpu_torch.integrator import path_tracer as pt
from mcrt_tpu_torch.parallel import sharding
from mcrt_tpu_torch.scene.synthetic import height_field_scene

NO_CARD = "needs a CUDA card (the float64 route on the card); chip_smoke.py runs it"
PM = {"emissions": 4000, "caustic_factor": 4.0, "k_nearest_photons": 12,
      "direct_visualization": False}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip(NO_CARD)


def _scene(width=16, photon=False):
    return mt.Scene(height_field_scene(16, width, 1, photon_map=PM if photon else None))


@pytest.mark.cuda
@pytest.mark.parametrize("integrator", ["path_tracer", "photon_mapper"])
def test_float64_render_matches_cpu_on_card(integrator):
    """render(RenderConfig(dtype="float64")) on the card (best-first, every
    step eager: stats["graphed"] False) against the same render on the CPU
    (the kernel route's plain version), 16x16, 1 spp, 6 bounces, the
    streamed and batch loops: within rtol 1e-9."""
    _need_card()
    scene = _scene(photon=integrator == "photon_mapper")
    for streamed in (True, False):
        cfg = mt.RenderConfig(dtype="float64", max_bounces=6, integrator=integrator,
                              streamed=streamed, lanes=64)
        stats = {}
        card = mt.render(scene, 0, cfg, stats=stats)
        cpu = mt.render(scene, 0, cfg, device="cpu")
        assert stats["graphed"] is False
        assert float(np.abs(cpu).max()) > 0.0
        np.testing.assert_allclose(card, cpu, rtol=1e-9, atol=1e-12)


@pytest.mark.cuda
def test_float64_train_step_matches_cpu_on_card():
    """One train step in float64 on the card (best-first, from the tree the
    scene's BVH carries there; the trips run eagerly under checkpoint and
    capture nothing) against the CPU's: loss within rtol 1e-9, each table's
    gradients within 1e-9 of its largest |g|."""
    _need_card()
    scene = _scene()
    cam = scene.cameras[0]
    out = {}
    for dev in ("cuda", "cpu"):
        tables = scene.tables(np.float64, dev)
        cbvh = scene.build_cluster_bvh(np.float64, dev)
        assert (cbvh.tree is not None) == (dev == "cuda")
        step = sharding.train_step(scene.meta(), pt.PTConfig(max_bounces=6), cam,
                                   film_mod.FilmConfig.from_json(cam.width, cam.height, cam.film),
                                   torch.float64, with_bvh=True, device=dev)
        lin = torch.arange(cam.width * cam.height, device=dev)
        params = {k: getattr(tables, k) for k in sharding.DEFAULT_TRAIN_PARAMS}
        target = np.random.default_rng(4).random((cam.height, cam.width, 3)) * 0.5
        loss, grads = step(tables, cbvh, params, lin % cam.width, lin // cam.width,
                           torch.zeros_like(lin), target)
        out[dev] = (float(loss), {k: g.cpu() for k, g in grads.items()}, step.graphs)
    assert out["cuda"][2] == {}
    assert abs(out["cuda"][0] - out["cpu"][0]) <= 1e-9 * abs(out["cpu"][0])
    for name, g in out["cpu"][1].items():
        top = float(g.abs().max())
        assert top > 0.0 or name != "mat_reflectance", name
        assert float((out["cuda"][1][name] - g).abs().max()) <= 1e-9 * max(top, 1e-300), name


@pytest.mark.cuda
def test_float64_exact_knn_matches_cpu_on_card():
    """knn(exact=True) with float64 queries on the card takes the capped
    search and the brute force (the JAX package's non-Pallas exact route),
    with no raise: ids identical to the CPU's, d2 within rtol 1e-12."""
    _need_card()
    rng = np.random.default_rng(8)
    pos = rng.uniform(0.0, 10.0, (20000, 3))
    pos[:5000] = rng.normal(5.0, 0.2, (5000, 3))              # a dense clump: subsampled cells
    dirs = rng.normal(size=(20000, 3))
    flux = rng.uniform(0.0, 1.0, (20000, 3))
    q = np.concatenate([rng.uniform(0.0, 10.0, (1024, 3)), rng.normal(5.0, 0.2, (1024, 3))])
    res = {}
    for dev in ("cuda", "cpu"):
        grid = pg.build_photon_grid(pos, dirs, flux, 50, np.float64, device=dev)
        d2, idx, valid, _ = pg.knn(grid, grid.arrays, torch.as_tensor(q, device=dev), 50, exact=True)
        res[dev] = (d2.cpu(), idx.cpu(), valid.cpu())
    assert torch.equal(res["cuda"][1], res["cpu"][1]) and torch.equal(res["cuda"][2], res["cpu"][2])
    np.testing.assert_allclose(res["cuda"][0].numpy(), res["cpu"][0].numpy(), rtol=1e-12)
