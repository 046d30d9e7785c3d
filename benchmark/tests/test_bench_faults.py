"""A run with the port's timed path broken underneath comes out as not
correct, for each fault a cell can have: a step that leaves its state
unchanged, half of the batch left out with the mean taken over the rest, an
answer altered where it is produced, and (photon mapper) half of the
emissions' photons left out, or every photon stored twice. A cell on one card has no exchange between
chips to leave out."""
import contextlib
import importlib
import time
from unittest import mock

import pytest
import numpy as np

from benchmark import cell

from conftest import tiny_cell

R = importlib.import_module("mcrt_tpu_torch.render")
PT = importlib.import_module("mcrt_tpu_torch.integrator.path_tracer")
PM = importlib.import_module("mcrt_tpu_torch.integrator.photon_mapper")
REAL_ADD = R._add_pixel_sums
REAL_EMIT = PM.emit_photons


def film_unchanged(film_acc, sums, spp, start):
    return film_acc


def half_the_batch(film_acc, sums, spp, start):
    return REAL_ADD(film_acc, sums[: sums.shape[0] // 2], spp, start)


def half_the_photons(*args, **kwargs):
    return tuple(tuple(x[::2] for x in kind) for kind in REAL_EMIT(*args, **kwargs))


def photons_twice(*args, **kwargs):
    return tuple(tuple(np.concatenate([x, x]) for x in kind) for kind in REAL_EMIT(*args, **kwargs))


def _scaled(real):
    def call(self, *args, **kwargs):
        out = real(self, *args, **kwargs)
        if isinstance(out, tuple):     # the path tracer's (radiance, rays)
            return (out[0] * 1.01,) + out[1:]
        return out * 1.01
    return call


def answer_altered():
    stack = contextlib.ExitStack()
    for cls in (PT.StreamedTrace, PM.StreamedEyePass):
        stack.enter_context(mock.patch.object(cls, "__call__", _scaled(cls.__call__)))
    return stack


FAULTS = {
    "state_unchanged": lambda: mock.patch.object(R, "_add_pixel_sums", film_unchanged),
    "half_the_batch": lambda: mock.patch.object(R, "_add_pixel_sums", half_the_batch),
    "answer_altered": answer_altered,
    "half_the_photons": lambda: mock.patch.object(PM, "emit_photons", half_the_photons),
    "photons_twice": lambda: mock.patch.object(PM, "emit_photons", photons_twice),
}
PM_ONLY = ("half_the_photons", "photons_twice")
CASES = [(w, f) for w in ("pt-hf2m-512-16spp", "pm-hf2m-512-4spp") for f in FAULTS
         if f not in PM_ONLY or w.startswith("pm")]


@pytest.mark.parametrize("workload,fault", CASES)
def test_broken_run_is_not_correct(workload, fault):
    config, traffic, check = tiny_cell(workload)
    with FAULTS[fault]():
        _, nums = cell.run(config, traffic, check, 2**31 + 11, 0.0, False, "cpu", time.time())
    assert any(v > check["limits"][k] for k, v in nums.items()), nums
