"""The train step's spans and counters (parallel/sharding.sharded_train_step's
`stats`, utils/trace): train.step around the call, train.params,
train.forward and train.backward inside it; trip_forward_replays and
trip_backward_replays, the replays of the trips' two graphs
(utils/cuda_graph.GraphedTrip.replays), counted on the caller's side; and
traverse_launches and gather_bwd_launches.

float32 on the CPU, on the benchmark's height field at n = 8, 8 x 8 pixels,
one sample a pixel, 6 bounces. `path_tracer._graph_trips` is patched where a
test sends the CPU's trips through the GraphedTrip route, whose bodies run
where the card replays its graphs. The card's case (marked `cuda`, skipped
without one) counts a graphed step at 64 bounces:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_train_trace.py -q
"""
import threading
from unittest import mock

import numpy as np
import pytest
import torch

from benchmark.scenes.height_field import height_field_scene
from mcrt_tpu_torch.camera import film as tfilm
from mcrt_tpu_torch.integrator import path_tracer as tpt
from mcrt_tpu_torch.materials import gather_bwd
from mcrt_tpu_torch.parallel import sharding as tsh
from mcrt_tpu_torch.scene.loader import Scene
from mcrt_tpu_torch.utils import trace

torch.set_num_threads(1)  # pytest-xdist runs several workers on the same cores

PARAMS = tsh.DEFAULT_TRAIN_PARAMS
SPANS = {"train.step": (), "train.params": ("train.step",),
         "train.forward": ("train.step",), "train.backward": ("train.step",)}


def _setup(n=8, width=8, bounces=6, device="cpu"):
    scene = Scene(height_field_scene(n, width, 1))
    cam = scene.cameras[0]
    tables = scene.tables(np.float32, device)
    cbvh = scene.build_cluster_bvh(np.float32, device)
    params = {k: getattr(tables, k) * 0.9 for k in PARAMS}
    lin = torch.arange(width * width, device=device)
    target = torch.as_tensor(np.random.default_rng(1).random((width, width, 3)) * 0.5,
                             dtype=torch.float32, device=device)
    step = tsh.train_step(scene.meta(), tpt.PTConfig(max_bounces=bounces), cam,
                          tfilm.FilmConfig.from_json(width, width, cam.film), torch.float32,
                          with_bvh=True, device=device)
    return step, (tables, cbvh, params, lin % width, lin // width, torch.zeros_like(lin), target)


def _graphed_trips():
    return mock.patch.object(tpt, "_graph_trips", lambda device: True)


def test_spans_nest_under_train_step():
    """Each span opens under the parents the step gives it (the spans open
    when it opens, read on entry), once a call, and train.step's self time
    is its duration less its three children's."""
    step, args = _setup()
    opened, real_enter = [], trace._Span.__enter__

    def enter(span):
        opened.append((span.name, tuple(s.name for s in trace._rec.open or ())))
        return real_enter(span)

    stats = {}
    with mock.patch.object(trace._Span, "__enter__", enter):
        step(*args, stats=stats)
    assert {name: parents for name, parents in opened if name in SPANS} == SPANS
    assert [name for name, _ in opened if name in SPANS] == list(SPANS)
    spans = stats["spans"]
    assert all(spans[name][0] == 1 for name in SPANS)
    children = sum(spans[name][1] for name in SPANS if name != "train.step")
    assert spans["train.step"][2] == pytest.approx(spans["train.step"][1] - children, abs=1e-6)
    assert 0.0 < children <= spans["train.step"][1]


def test_trip_replays_counted_on_the_callers_side():
    """Through the GraphedTrip route, the first call runs its first trip as
    the warm-up (bounces - 1 forward replays) and every trip's backward
    replay; a later call replays every trip both ways. The counts add up
    over calls into one dict, as render()'s do. No traversal kernel launches
    on the CPU (the plain version runs)."""
    bounces = 6
    step, args = _setup(bounces=bounces)
    stats = {}
    with _graphed_trips():
        step(*args, stats=stats)
        assert (stats["trip_forward_replays"], stats["trip_backward_replays"]) == \
            (bounces - 1, bounces)
        again = {}
        step(*args, stats=again)
    assert (again["trip_forward_replays"], again["trip_backward_replays"]) == (bounces, bounces)
    assert again["traverse_launches"] == 0
    (trip,) = step.graphs.values()
    assert trip.replays == [2 * bounces - 1, 2 * bounces]


@pytest.mark.parametrize("graphed", [False, True], ids=["checkpoint", "trips"])
def test_gather_bwd_launches_recorded_and_zero_on_cpu(graphed):
    """The step records gather_bwd_launches, 0 on the CPU, where each trip's
    backward sums the material gather's cotangents with the kernel's plain
    twin: once a trip in a call after the capturing one."""
    bounces = 6
    step, args = _setup(bounces=bounces)
    with mock.patch.object(tpt, "_graph_trips", lambda device: graphed):
        step(*args, stats={})
        stats = {}
        with mock.patch.object(gather_bwd, "gather_rows_backward_plain",
                               wraps=gather_bwd.gather_rows_backward_plain) as plain:
            step(*args, stats=stats)
    assert stats["gather_bwd_launches"] == 0
    assert plain.call_count == bounces


def test_a_count_on_another_thread_is_not_recorded():
    """The recorder is the recording thread's own: a counter bumped on another
    thread (autograd's device thread runs a backward's replays on the card)
    does not reach the open recording, which is why the step counts the
    trips' replays around the call."""
    stats = {}
    with trace.recording(stats):
        worker = threading.Thread(target=trace.count, args=("elsewhere", 1))
        worker.start()
        worker.join()
        trace.count("here", 1)
    assert stats == {"here": 1}


@pytest.mark.parametrize("graphed", [False, True], ids=["checkpoint", "trips"])
def test_without_stats_nothing_recorded_and_same_results(graphed):
    """stats=None reads no clock, records nothing, and gives the same loss and
    gradients, bit for bit, as a call that records."""
    step, args = _setup()
    with mock.patch.object(tpt, "_graph_trips", lambda device: graphed):
        loss, grads = step(*args, stats={})
        clock = mock.Mock(side_effect=trace._clock)
        with mock.patch.object(trace, "_clock", clock):
            bare_loss, bare_grads = step(*args)
    assert clock.call_count == 0
    assert torch.equal(loss, bare_loss)
    assert all(torch.equal(grads[k], bare_grads[k]) for k in PARAMS)


def test_brute_force_step_takes_stats():
    """The step without a BVH takes the same keyword."""
    scene = Scene(height_field_scene(4, 4, 1))
    cam = scene.cameras[0]
    tables = scene.tables(np.float32, "cpu")
    step = tsh.train_step(scene.meta(), tpt.PTConfig(max_bounces=3), cam,
                          tfilm.FilmConfig.from_json(4, 4, cam.film), torch.float32,
                          device="cpu")
    lin = torch.arange(16)
    stats = {}
    step(tables, {"mat_reflectance": tables.mat_reflectance}, lin % 4, lin // 4,
         torch.zeros_like(lin), torch.zeros((4, 4, 3)), stats=stats)
    assert set(SPANS) <= set(stats["spans"])


@pytest.mark.cuda
def test_graphed_step_counts_on_card():
    """On the card (height field n = 32, 32 x 32, one sample a pixel, 64
    bounces): a step after the capturing one replays each trip's G_f and G_b
    once (64 and 64, though autograd runs the backward's replays on its own
    thread), launches the traversal 256 times (2 a trip forward, 2 in the
    recompute) and calls the gather's backward kernel once a G_b replay; the
    first step replays 63 forward, and its eager warm-up trip calls the
    gather's kernel once more."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs and the kernel have no CPU mode); "
                    "run on the card")
    step, args = _setup(n=32, width=32, bounces=64, device="cuda")
    first, second = {}, {}
    step(*args, stats=first)
    torch.cuda.synchronize()
    loss, _ = step(*args, stats=second)
    torch.cuda.synchronize()
    assert (first["trip_forward_replays"], first["trip_backward_replays"]) == (63, 64)
    assert (second["trip_forward_replays"], second["trip_backward_replays"]) == (64, 64)
    assert second["traverse_launches"] == 256
    assert (first["gather_bwd_launches"], second["gather_bwd_launches"]) == (65, 64)
    assert set(SPANS) <= set(second["spans"]) and torch.isfinite(loss)
