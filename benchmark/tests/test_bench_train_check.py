"""The train cell's check (entries/train_steps.py) on a tiny cell: a sound
run passes the cell's limits; the control (the reference with its tables
stored in bfloat16, in the port's place) fails them, and so do the faults
of the port's timed path: one table's gradient zeroed, the material
gather's backward summed in bfloat16, an update that leaves the tables as
they were or steps them the wrong way, and a target rendered off. The
readings on the card at the cell's own size are benchmark/readings.py's."""
import importlib
import time
from unittest import mock

import pytest
import torch

from benchmark import cell
from benchmark.entries import train_steps as TS
from benchmark.reference import train as ref_train

from train_tiny import tiny_train_cell

B = importlib.import_module("mcrt_tpu_torch.materials.bsdf")
S = importlib.import_module("mcrt_tpu_torch.parallel.sharding")
R = importlib.import_module("mcrt_tpu_torch.render")
SEED = 2**31 + 23


class _Bf16GatherRows(torch.autograd.Function):
    """The gather with its backward's sum in bfloat16."""

    @staticmethod
    def forward(ctx, pack, m):
        ctx.save_for_backward(m)
        ctx.pack_shape = pack.shape
        return pack[m]

    @staticmethod
    def backward(ctx, grad):
        (m,) = ctx.saved_tensors
        acc = torch.zeros(ctx.pack_shape, dtype=torch.bfloat16, device=grad.device)
        return acc.index_put_((m,), grad.to(torch.bfloat16), accumulate=True).to(grad.dtype), None


def _zero_one_gradient(real):
    def train_step(*args, **kwargs):
        step = real(*args, **kwargs)

        def call(*a, stats=None):
            loss, grads = step(*a, stats=stats)
            return loss, dict(grads, mat_specular_roughness=torch.zeros_like(
                grads["mat_specular_roughness"]))

        call.graphs = step.graphs
        return call
    return train_step


def _target_off(real):
    def render(*args, **kwargs):
        return real(*args, **kwargs) * 1.05
    return render


def _wrong_sign(real):
    def sgd_update(params, grads, truth, lr):
        return real(params, {k: -g for k, g in grads.items()}, truth, lr)
    return sgd_update


FAULTS = {
    "gradient_zeroed": lambda: mock.patch.object(S, "train_step",
                                                 _zero_one_gradient(S.train_step)),
    "gather_backward_bf16": lambda: mock.patch.object(B, "_GatherRows", _Bf16GatherRows),
    "update_skipped": lambda: mock.patch.object(TS, "sgd_update",
                                                lambda params, grads, truth, lr: params),
    "update_wrong_sign": lambda: mock.patch.object(TS, "sgd_update",
                                                   _wrong_sign(TS.sgd_update)),
    "target_off": lambda: mock.patch.object(R, "render", _target_off(R.render)),
}


def _passes(nums, check):
    return all(v <= check["limits"][k] for k, v in nums.items())


def test_sound_run_passes():
    config, traffic, check = tiny_train_cell()
    _, nums = cell.run(config, traffic, check, SEED, 0.0, False, "cpu", time.time())
    assert set(nums) == set(check["limits"]) and _passes(nums, check), nums


def test_control_fails_the_limits():
    config, traffic, check = tiny_train_cell()
    s = TS.TrainLoop(config, traffic, "cpu")
    ref, ctl = TS.reference(s), TS.reference(s, control=True)
    rows, lr = s.truth["mat_ior"] > 0, s.train["lr"]
    want = TS.reference_step(ref, s, s.start, 0)
    loss, grads = TS.reference_step(ctl, s, s.start, 0)
    new = TS.stored(ref_train.sgd(s.start, grads, lr, rows), s.start)
    nums = TS.check_numbers(s.start, (loss, grads, new), want, rows, lr, new)
    pixels = TS.sample_pixels(SEED, s.samples, check["pixels"])
    nums.update(TS.image_numbers([TS.target_pixels(ctl, s, pixels)],
                                 TS.target_pixels(ref, s, pixels)))
    assert set(nums) == set(check["limits"]) and not _passes(nums, check), nums


@pytest.mark.parametrize("fault", FAULTS)
def test_broken_run_is_not_correct(fault):
    config, traffic, check = tiny_train_cell()
    with FAULTS[fault]():
        _, nums = cell.run(config, traffic, check, SEED, 0.0, False, "cpu", time.time())
    assert not _passes(nums, check), nums


def test_nonfinite_tables_counted():
    nan = {"mat_ior": torch.tensor([1.5, float("nan"), -1.0]),
           "mat_reflectance": torch.tensor([[0.2, float("inf"), 0.3]])}
    params, g = {"mat_ior": torch.tensor([1.5, 1.3, -1.0])}, {"mat_ior": torch.ones(3)}
    rows = torch.tensor([True, True, False])
    new = TS.stored(ref_train.sgd(params, g, 0.1, rows), params)
    nums = TS.check_numbers(params, (1.0, g, new), (1.0, g), rows, 0.1, nan)
    assert nums == {"loss_rel_gap": 0.0, "grad_rel_l2": 0.0, "params_change_rel": 0.0,
                    "params_nonfinite": 2.0}


@pytest.mark.parametrize("scale,want", [(0.0, 1.0), (-1.0, 2.0), (0.5, 0.5)])
def test_params_change_reads_the_update(scale, want):
    """The updated tables' change against the reference's: kept tables read
    1, a step of the wrong sign 2, a step of half the size 0.5; the ior rows
    without an ior are left out, and the clamps are the reference's."""
    params = {"mat_ior": torch.tensor([1.5, 1.02, -1.0], dtype=torch.float64),
              "mat_reflectance": torch.tensor([[0.5, 0.995, 0.2]], dtype=torch.float64)}
    g = {"mat_ior": torch.tensor([0.01, 0.01, 5.0], dtype=torch.float64),
         "mat_reflectance": torch.tensor([[0.01, -0.01, 0.02]], dtype=torch.float64)}
    rows, lr = torch.tensor([True, True, False]), 3.0
    ref = ref_train.sgd(params, g, lr, rows)
    assert ref["mat_ior"].tolist() == pytest.approx([1.47, 1.0, -1.0])
    assert ref["mat_reflectance"][0].tolist() == pytest.approx([0.47, 1.0, 0.14])
    new = {k: params[k] + scale * (ref[k] - params[k]) for k in params}
    nums = TS.check_numbers(params, (1.0, g, new), (1.0, g), rows, lr, new)
    assert nums["params_change_rel"] == pytest.approx(want, rel=1e-12)
