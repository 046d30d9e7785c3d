"""Tiny cells for the benchmark's CPU tests: the cells' own configurations on
a 10 x 10 height field (200 triangles) at 8 x 8 pixels."""
import json
import pathlib

import pytest
import torch

HERE = pathlib.Path(__file__).resolve().parents[1]


def tiny_cell(workload: str):
    """(config, traffic, check) of a BENCHMARK.json cell, cut to a CPU test's size."""
    from benchmark import run

    spec = run.cell_spec(json.loads((run.ROOT / "BENCHMARK.json").read_text()), workload)
    config, check = dict(spec["config"]), dict(spec["check"])
    config["grid_n"] = 10
    if "photon_map" in config:
        config["photon_map"] = dict(config["photon_map"], emissions=200)
    traffic = dict(spec["traffic"], width=8, sqrtspp=2, rays_per_chunk=64, lanes=32,
                   warmup_sqrtspp=1, image_seeds=[2**31 + 99])
    check.update(pixels=32, emissions=200)
    return config, traffic, check


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(params=["pt-hf2m-512-16spp", "pm-hf2m-512-4spp"])
def tiny(request):
    return (request.param,) + tiny_cell(request.param)
