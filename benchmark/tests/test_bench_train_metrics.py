"""The train cell's per-layer readers (train.step_p95_s, train.backward_pct,
train.gather_bwd_pct, train.traverse_roofline_pct, device.idle_pct.train):
their values on a hand-made run, nothing where the run has nothing to read
(a program without the train spans, an unprofiled run, a profile without
the kernel), and values on the tiny train cell's window."""
import math
import time

import pytest

from benchmark import cell, devtrace, run
from benchmark.entries import train_steps

from train_tiny import tiny_train_cell

NEW = ("train.step_p95_s", "train.backward_pct", "train.gather_bwd_pct",
       "train.traverse_roofline_pct", "device.idle_pct.train")
GATHER = "void at::native::(anonymous namespace)::indexing_backward_kernel_small_stride<double>"
TRAVERSE = "void (anonymous namespace)::traverse_kernel<false, false, float4>"


def _step(wall, backward):
    return {"wall": wall, "stats": {"spans": {"train.step": [1, wall - 0.01, 0.001],
                                              "train.backward": [1, backward, backward]},
                                    "trip_forward_replays": 64, "trip_backward_replays": 64,
                                    "traverse_launches": 256}}


def _profile(seconds, span=7.5):
    counts = {n: 128 for n in seconds}
    return train_steps.StepProfile(window_s=12.0, busy_s=7.0, seconds_by_name=seconds,
                                   count_by_name=counts, gaps=[], device_span_s=span)


def _run(images, profile=None, work=None):
    return cell.Run(samples_per_image=262144, images=images, window_s=24.0, setup_s=60.0,
                    peak_bytes=1 << 34, profile=profile, work=work or {})


HAND = _run([_step(8.0, 6.0), _step(8.0, 6.2), _step(10.0, 7.0)],
            _profile({GATHER: 5.0, TRAVERSE: 0.5, "other": 1.5}),
            {"traverse": (16, 0.002)})


@pytest.mark.parametrize("name,want", [
    ("train.step_p95_s", 8.0 + 0.9 * 2.0),
    ("train.backward_pct", 100.0 * (6.0 + 6.2 + 7.0) / 26.0),
    ("train.gather_bwd_pct", 100.0 * 5.0 / 7.0),
    ("train.traverse_roofline_pct", 100.0 * 128 * (0.002 / 16) / 0.5),
    ("device.idle_pct.train", 100.0 * (1.0 - 7.0 / 7.5)),
])
def test_reader_on_a_hand_made_run(name, want):
    assert run.load_metric(name).read(HAND) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", NEW)
def test_reader_of_an_empty_run_returns_none(name):
    assert run.load_metric(name).read(_run([])) is None


def test_readers_without_what_they_read_return_none():
    """A program whose step records no spans (the parent of the change that
    added them), a run with no profile, a profile without the gather's
    backward kernel (a change that replaced it) or without kept launches."""
    bare = _run([{"wall": 8.0, "stats": {}}])
    assert run.load_metric("train.backward_pct").read(bare) is None
    for name in ("train.gather_bwd_pct", "train.traverse_roofline_pct",
                 "device.idle_pct.train"):
        assert run.load_metric(name).read(_run(HAND.images, None, HAND.work)) is None
    other = _run(HAND.images, _profile({"segmented_sum": 5.0, TRAVERSE: 0.5}))
    assert run.load_metric("train.gather_bwd_pct").read(other) is None
    assert run.load_metric("train.traverse_roofline_pct").read(other) is None


def test_idle_share_reads_the_profiled_steps_own_gaps():
    """The idle share is the gaps over the profiled step's device span, not
    set against the unprofiled walls: steps shorter than the profiled busy
    time do not floor it, and a profile without the span (devtrace's own,
    as a render entry makes it) or without device activity reads None."""
    idle = run.load_metric("device.idle_pct.train")
    quick = _run([_step(6.0, 4.0)], _profile({GATHER: 5.0}, span=8.0))
    assert idle.read(quick) == pytest.approx(100.0 * (1.0 - 7.0 / 8.0), rel=1e-12)
    assert idle.read(_run(HAND.images, _profile({GATHER: 5.0}, span=7.0))) == 0.0
    plain = devtrace.Profile(window_s=12.0, busy_s=7.0, seconds_by_name={GATHER: 5.0},
                             count_by_name={GATHER: 128}, gaps=[])
    assert idle.read(_run(HAND.images, plain)) is None
    assert idle.read(_run(HAND.images, _profile({}, span=0.0))) is None


def test_readers_on_the_tiny_train_cell():
    """On the CPU the window's steps give the step tail and the backward's
    share; the device readers have no device trace to read."""
    config, traffic, check = tiny_train_cell()
    r, kept, last, samples, s = train_steps.measure(config, traffic, 0.1, True, "cpu",
                                                    time.time())
    assert len(kept) == len(r.images) >= 1 and r.samples_per_image == 144
    for name in ("train.step_p95_s", "train.backward_pct"):
        value = run.load_metric(name).read(r)
        assert value is not None and math.isfinite(value) and value > 0.0, (name, value)
    for name in ("train.gather_bwd_pct", "train.traverse_roofline_pct", "device.idle_pct.train"):
        assert run.load_metric(name).read(r) is None
    assert samples.traverse == []
