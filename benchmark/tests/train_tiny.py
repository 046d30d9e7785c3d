"""The train cell cut to a CPU test's size: its own configuration and traffic
on an 8 x 8 height field (128 triangles) at 12 x 12 pixels, 8 bounces, the
target at 4 samples a pixel."""
import json

from benchmark import run

WORKLOAD = "train-hf2m-512-1spp"


def tiny_train_cell():
    """(config, traffic, check) of the train cell, cut to a CPU test's size."""
    spec = run.cell_spec(json.loads((run.ROOT / "BENCHMARK.json").read_text()), WORKLOAD)
    config = dict(spec["config"], grid_n=8, max_bounces=8)
    config["train"] = dict(config["train"], target_sqrtspp=2)
    traffic = dict(spec["traffic"], width=12)
    return config, traffic, dict(spec["check"])
