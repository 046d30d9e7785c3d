"""The PyTorch port stands alone: it imports neither JAX nor the JAX package,
and its entry points never run on the CPU unless asked to."""
import ast
import pathlib

import numpy as np
import pytest
import torch

import mcrt_tpu_torch as mt
from mcrt_tpu_torch import convert
from mcrt_tpu_torch.ops import traverse_kernel as tk
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
                 "integrator/path_tracer.py", "sampling/sobol.py", "convert.py"):
        assert must in names


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture(scope="module")
def small_scene():
    return mt.Scene(height_field_scene(4, 8, 1))


@pytest.mark.parametrize("entry", ["render", "tables", "cluster_bvh", "tables_from_numpy",
                                   "cluster_bvh_from_numpy"])
def test_entry_points_refuse_cpu_without_request(no_cuda, small_scene, entry):
    s = small_scene
    calls = {
        "render": lambda: mt.render(s, 0, mt.RenderConfig()),
        "tables": lambda: s.tables(np.float32),
        "cluster_bvh": lambda: s.build_cluster_bvh(np.float32),
        "tables_from_numpy": lambda: convert.tables_from_numpy(s.table_arrays()),
        "cluster_bvh_from_numpy": lambda: convert.cluster_bvh_from_numpy(
            np.zeros((1, 3)), np.ones((1, 3)), np.zeros(1, np.int32), np.ones(1, np.int32),
            np.zeros(1, np.int32), s.tri_v0, s.tri_e1, s.tri_e2),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


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


def test_photon_mapper_not_ported(small_scene):
    with pytest.raises(NotImplementedError, match="slice 3"):
        mt.render(small_scene, 0, mt.RenderConfig(integrator="photon_mapper"), device="cpu")
