"""The control: the reference computed with its tables stored in bfloat16,
its own photon maps included, in the port's place, must come out as not
correct by the cell's limits. The readings on the card at the cells' own
size are benchmark/readings.py's."""
import importlib

import torch

from benchmark import cell

RI = importlib.import_module("benchmark.entries.render_images")


def test_control_fails_the_cells_limits(tiny):
    workload, config, traffic, check = tiny
    seed = traffic["image_seeds"][0]
    sd = cell.scene_dict(config, traffic)
    ref = RI.reference(sd, torch.float32, "cpu")
    ctl = RI.reference(sd, torch.float32, "cpu", control=True)
    pixels = RI.sample_pixels(seed, traffic["width"] ** 2, check["pixels"])
    maps = {seed: RI.reference_maps(ctl, config, seed)} if RI._is_pm(config) else {}
    got = RI.reference_pixels(ctl, config, traffic, seed, pixels, maps.get(seed))
    nums = RI.check_numbers(ref, config, traffic, check, seed, pixels, [(seed, got)], maps)
    assert any(nums[k] > check["limits"][k] for k in nums), nums
