"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
and its entry points never run on the CPU unless asked to."""
import ast
import json
import pathlib

import numpy as np
import pytest
import torch

import mcrt_tpu_torch as mt
from mcrt_tpu_torch import cli, convert
from mcrt_tpu_torch.accel import knn_kernel as kk
from mcrt_tpu_torch.accel import photon_grid as pg
from mcrt_tpu_torch.camera.film import FilmConfig
from mcrt_tpu_torch.integrator.path_tracer import PTConfig
from mcrt_tpu_torch.ops import traverse_kernel as tk
from mcrt_tpu_torch.parallel import sharding
from mcrt_tpu_torch.scene.synthetic import height_field_scene

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "mcrt_tpu")


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], node.lineno
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0], node.lineno


PORT_FILES = sorted((ROOT / "mcrt_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_file_imports_no_jax(path):
    bad = [(m, ln) for m, ln in _imported_roots(path) if m in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scan_covers_the_package():
    names = {p.relative_to(ROOT / "mcrt_tpu_torch").as_posix() for p in PORT_FILES[:-1]}
    for must in ("render.py", "scene/loader.py", "ops/cluster_bvh.py", "ops/traverse_kernel.py",
                 "integrator/path_tracer.py", "sampling/sobol.py", "convert.py",
                 "accel/photon_grid.py", "accel/knn_kernel.py", "integrator/photon_mapper.py",
                 "cli.py", "__main__.py", "parallel/sharding.py", "parallel/distributed.py",
                 "parallel/dryrun.py"):
        assert must in names


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


PHOTONS = {"emissions": 200, "caustic_factor": 2.0, "k_nearest_photons": 8}


@pytest.fixture(scope="module")
def small_scene():
    return mt.Scene(height_field_scene(4, 8, 1, photon_map=PHOTONS))


@pytest.mark.parametrize("entry", ["render", "photon_render", "render_to_file", "cli", "tables",
                                   "cluster_bvh", "tables_from_numpy", "cluster_bvh_from_numpy",
                                   "photon_grid", "photon_grid_from_numpy", "load_photon_grid",
                                   "knn", "train_step"])
def test_entry_points_refuse_cpu_without_request(no_cuda, small_scene, entry, tmp_path):
    s = small_scene
    z3 = np.zeros((4, 3))
    grid = lambda: pg.build_photon_grid(np.random.RandomState(0).rand(64, 3), z3[:1].repeat(64, 0),
                                        z3[:1].repeat(64, 0), 4, device="cpu")
    scene_file = tmp_path / "s.json"
    scene_file.write_text(json.dumps(height_field_scene(4, 8, 1, as_lists=True, photon_map=PHOTONS)))
    calls = {
        "render": lambda: mt.render(s, 0, mt.RenderConfig()),
        "photon_render": lambda: mt.render(s, 0, mt.RenderConfig(integrator="photon_mapper")),
        "render_to_file": lambda: mt.render_to_file(s, tmp_path / "o.tga"),
        "cli": lambda: cli.main(["--scene", str(scene_file), "--photon-map", "--quiet",
                                 "--out", str(tmp_path / "o.tga")]),
        "photon_grid": lambda: pg.build_photon_grid(z3, z3, z3, 4),
        "photon_grid_from_numpy": lambda: convert.photon_grid_from_numpy(
            z3, z3, z3, np.zeros(2), np.zeros(3), 1.0, (1, 1, 1), 8, 4),
        "load_photon_grid": lambda: pg.load_photon_grid(_saved_grid(tmp_path, grid())),
        "knn": lambda: kk.knn(grid(), grid().arrays, torch.zeros((2, 3), device="meta"), 4),
        "tables": lambda: s.tables(np.float32),
        "train_step": lambda: sharding.train_step(
            s.meta(), PTConfig(), s.cameras[0], FilmConfig(8, 8), np.float32, with_bvh=True),
        "cluster_bvh": lambda: s.build_cluster_bvh(np.float32),
        "tables_from_numpy": lambda: convert.tables_from_numpy(s.table_arrays()),
        "cluster_bvh_from_numpy": lambda: convert.cluster_bvh_from_numpy(
            np.zeros((1, 3)), np.ones((1, 3)), np.zeros(1, np.int32), np.ones(1, np.int32),
            np.zeros(1, np.int32), s.tri_v0, s.tri_e1, s.tri_e2),
    }
    if entry == "knn":   # a tensor on no device the wrapper serves: it raises, never falls back
        with pytest.raises(ValueError, match="unsupported device"):
            calls[entry]()
        return
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def _saved_grid(tmp_path, grid):
    path = tmp_path / "grid.npz"
    pg.save_photon_grid(path, grid)
    return path


def test_explicit_cpu_request_runs(no_cuda, small_scene):
    img = mt.render(small_scene, 0, mt.RenderConfig(max_bounces=2), device="cpu")
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()


def test_traverse_wrapper_never_falls_back(small_scene):
    """CPU tensors take the plain version; CUDA tensors go to the kernel, and
    any other device raises — the wrapper has no path that quietly runs the
    plain version."""
    cbvh = small_scene.build_cluster_bvh(np.float32, "cpu")
    o = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tk.traverse(cbvh, o, o)


def test_photon_render_runs_on_cpu_request(no_cuda, small_scene):
    stats = {}
    img = mt.render(small_scene, 0, mt.RenderConfig(integrator="photon_mapper", max_bounces=4),
                    device="cpu", stats=stats)
    assert img.shape == (8, 8, 3) and np.isfinite(img).all() and img.min() >= 0.0
    assert stats["photons_global"] > 0 and stats["bounce_steps"] > 0


def test_knn_wrapper_takes_cpu_tensors_to_the_plain_version():
    """On the CPU the k-NN wrapper runs knn_plain and launches nothing."""
    rng = np.random.RandomState(1)
    p = rng.rand(500, 3)
    grid = pg.build_photon_grid(p, p, p, 8, device="cpu")
    q = torch.as_tensor(rng.rand(40, 3), dtype=torch.float32)
    before = [kern.launches for kern in kk.KERNELS]
    a = kk.knn(grid, grid.arrays, q, 8)
    b = kk.knn_plain(grid, grid.arrays, q, 8)
    assert [kern.launches for kern in kk.KERNELS] == before and kk.library.lib is None
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_exact_knn_refuses_float64_on_the_card(monkeypatch):
    """The k-NN kernels refuse float64 exact queries (they are float32): a
    float64 query on a CUDA tensor takes the capped search and the brute
    force, the JAX package's non-Pallas exact route, and neither raises nor
    reaches the kernels' wrapper; checked with a stand-in tensor that
    reports a CUDA device, stopped where the capped search begins."""
    p = np.random.RandomState(2).rand(100, 3)
    grid = pg.build_photon_grid(p, p, p, 8, np.float64, device="cpu")
    assert not pg._knn_kernel_ok(grid, torch.float64, 8) and pg._knn_kernel_ok(grid, torch.float32, 8)

    class CudaLike:
        device = torch.device("cuda", 0)
        dtype = torch.float64
        shape = (4, 3)

    class Capped(Exception):
        pass

    def capped(g, arrays, points, k):
        assert isinstance(points, CudaLike) and k == 8
        raise Capped

    monkeypatch.setattr(pg.knn_kernel, "knn", lambda *a, **kw: pytest.fail("the kernels took it"))
    monkeypatch.setattr(pg, "_knn_capped", capped)
    with pytest.raises(Capped):
        pg.knn(grid, grid.arrays, CudaLike(), 8, exact=True)
