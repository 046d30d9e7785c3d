"""The port's spans and counters (mcrt_tpu_torch/utils/trace.py) inside
render(): names, counts and nesting on the CPU, in the stats dict and in a
torch.profiler trace; no clock read with tracing off; on the card, the
captures' spans and counters and a profile whose device events carry no
span name.

This file imports no JAX, so on a machine with a card it runs without the
conftest:

    python3 -m pytest --noconftest -q tests/test_torch_trace.py
"""
import json
import threading
from unittest import mock

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

import mcrt_tpu_torch as mt
from mcrt_tpu_torch.scene.synthetic import height_field_scene
from mcrt_tpu_torch.utils import cuda_graph, trace

torch.set_num_threads(1)  # pytest-xdist runs several workers on the same cores

PM_BLOCK = {"emissions": 300, "caustic_factor": 2.0, "k_nearest_photons": 8}

# Each span and the spans it may be opened in.
PARENTS = {
    "render": (),
    "render.tables": ("render",),
    "render.bvh": ("render",),
    "render.chunk": ("render",),
    "render.finish": ("render",),
    "pm.photon_pass": ("render",),
    "pm.emit": ("pm.photon_pass",),
    "pm.emit.copy": ("pm.emit",),
    "pm.grid": ("pm.photon_pass",),
    "loop.load": ("render.chunk", "pm.emit"),
    "loop.drain": ("render.chunk", "pm.emit"),
    "loop.warm": ("loop.drain",),
    "loop.capture": ("loop.drain",),
}


def _scene(pm: bool, n=6, width=8):
    return mt.Scene(height_field_scene(n, width, 1, photon_map=PM_BLOCK if pm else None))


def _cfg(pm: bool, streamed=True, **kw):
    kw = {"rays_per_chunk": 24, "lanes": 16, "max_bounces": 6, **kw}
    return mt.RenderConfig(integrator="photon_mapper" if pm else "path_tracer",
                           streamed=streamed, **kw)


CASES = [(False, True), (False, False), (True, True), (True, False)]
IDS = ["pt-streamed", "pt-batch", "pm-streamed", "pm-batch"]


@pytest.mark.parametrize("pm,streamed", CASES, ids=IDS)
def test_render_records_spans_and_counters(pm, streamed):
    """A render with a stats dict records the spans of its layers, with the
    counts the render's own counters give, self time within each duration,
    and every parent at least as long as its children; the loops' counters
    add up to the steps the render reports."""
    stats = {}
    mt.render(_scene(pm), 0, _cfg(pm, streamed), device="cpu", stats=stats)
    spans = stats["spans"]
    want = {"render", "render.tables", "render.bvh", "render.chunk", "render.finish",
            "loop.load", "loop.drain"}
    if pm:
        want |= {"pm.photon_pass", "pm.emit", "pm.emit.copy", "pm.grid"}
    assert set(spans) == want   # nothing is captured on the CPU: no loop.warm, loop.capture
    count = {name: rec[0] for name, rec in spans.items()}
    assert count["render"] == count["render.tables"] == count["render.bvh"] == 1
    assert count["render.finish"] == 1 and count["render.chunk"] == stats["chunks"] > 1
    loops = stats["chunks"]
    if pm:
        assert count["pm.photon_pass"] == count["pm.emit"] == 1 and count["pm.grid"] == 2
        assert count["pm.emit.copy"] == 1    # 300 emissions: one chunk
        loops += count["pm.emit.copy"] + stats.get("emission_reruns", 0)
    assert count["loop.load"] == count["loop.drain"] == loops
    for name, (n, seconds, self_s) in spans.items():
        assert n >= 1 and 0.0 <= self_s <= seconds, name
    # A parent's children sum to no more than it, and its self time is the rest.
    children = {}
    for name, parents in PARENTS.items():
        if name in spans and len(parents) == 1:
            children.setdefault(parents[0], []).append(name)
    for parent, kids in children.items():
        covered = sum(spans[k][1] for k in kids)
        assert covered <= spans[parent][1], parent
        if parent != "pm.emit":   # the emission's loop.load and loop.drain are its children too
            assert spans[parent][2] == pytest.approx(spans[parent][1] - covered, abs=1e-6)
    loop_parents = spans["render.chunk"][1] + (spans["pm.emit"][1] if pm else 0.0)
    loop_kids = spans["loop.load"][1] + spans["loop.drain"][1]
    assert loop_kids + (spans["pm.emit.copy"][1] if pm else 0.0) <= loop_parents
    assert stats["loop_steps"] == stats["bounce_steps"] + stats.get("emission_steps", 0)
    assert 0.0 < stats["loop_sync_wait_s"] <= spans["loop.drain"][1]
    assert "graph_pool_bytes" not in stats
    if pm:
        assert stats["photon_pass_s"] == spans["pm.photon_pass"][1]


@pytest.mark.parametrize("pm", [False, True], ids=["pt", "pm"])
def test_a_reused_stats_dict_adds_every_key_alike(pm):
    """Two renders into one stats dict add their spans and the loops'
    counters alike, so the counters still sum to the steps."""
    stats, once = {}, {}
    mt.render(_scene(pm), 0, _cfg(pm), device="cpu", stats=once)
    for _ in range(2):
        mt.render(_scene(pm), 0, _cfg(pm), device="cpu", stats=stats)
    assert stats["spans"]["render"][0] == 2
    assert {n: rec[0] for n, rec in stats["spans"].items()} == \
        {n: 2 * rec[0] for n, rec in once["spans"].items()}
    assert stats["loop_steps"] == 2 * once["loop_steps"]
    assert stats["loop_steps"] == stats["bounce_steps"] + stats.get("emission_steps", 0)


def test_wait_before_a_capture_is_a_sync_wait(monkeypatch):
    """The wait for the queued work before a capture is counted in
    loop_sync_wait_s and opens no span (so it stays out of loop.capture)."""
    ticks = iter(range(0, 10**9, 1000))
    monkeypatch.setattr(trace, "_clock", lambda: next(ticks))
    synced = []
    monkeypatch.setattr(cuda_graph.torch.cuda, "synchronize", synced.append)
    stats = {}
    with trace.recording(stats):
        cuda_graph.wait_for_device("dev")
    assert synced == ["dev"]
    assert stats == {"loop_sync_wait_s": pytest.approx(1e-6)}


def _host_events(prof):
    return [e for e in prof.profiler.kineto_results.events() if e.name() in PARENTS]


@pytest.mark.parametrize("pm", [False, True], ids=["pt", "pm"])
def test_spans_reach_the_profile_as_host_ops(pm):
    """Under torch.profiler every span is one host event of its name, not a
    user annotation (which kineto would mirror as a CUDA-typed range), as
    many as the stats count, each inside an event of a span it may be opened
    in."""
    stats = {}
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        mt.render(_scene(pm), 0, _cfg(pm), device="cpu", stats=stats)
    events = _host_events(prof)
    got = {}
    for e in events:
        assert e.device_type() == DeviceType.CPU and not e.is_user_annotation(), e.name()
        got[e.name()] = got.get(e.name(), 0) + 1
    assert got == {name: rec[0] for name, rec in stats["spans"].items()}
    intervals = {}
    for e in events:
        intervals.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    for e in events:
        a, b = e.start_ns(), e.start_ns() + e.duration_ns()
        parents = PARENTS[e.name()]
        if parents:
            assert any(lo <= a and b <= hi for p in parents for lo, hi in intervals.get(p, ())), \
                e.name()


def test_profile_without_stats_still_names_spans():
    """With a profiler and no stats dict, the spans still reach the profile,
    and nothing is recorded."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        mt.render(_scene(True), 0, _cfg(True), device="cpu")
    names = {e.name() for e in _host_events(prof)}
    assert {"render", "render.tables", "pm.photon_pass", "pm.grid", "render.chunk",
            "loop.drain", "render.finish"} <= names


def test_profile_dir_trace_holds_the_whole_render(tmp_path):
    """RenderConfig.profile_dir wraps the whole render: its trace holds the
    set-up, the photon pass and the chunks as CPU ops."""
    mt.render(_scene(True), 0, _cfg(True, profile_dir=str(tmp_path)), device="cpu")
    (path,) = tmp_path.glob("*.pt.trace.json")
    events = json.loads(path.read_text())["traceEvents"]
    cats = {e["name"]: e.get("cat") for e in events if e.get("name") in PARENTS}
    assert {"render", "render.tables", "render.bvh", "pm.photon_pass", "pm.emit", "pm.grid",
            "render.chunk", "render.finish"} <= set(cats)
    assert set(cats.values()) == {"cpu_op"}


def test_no_stats_no_profiler_reads_no_clock(monkeypatch):
    """With stats=None and no profiler, no span or counter reads the
    recorder's clock; with a stats dict they do."""
    calls = []

    def clock():
        calls.append(1)
        return len(calls)

    monkeypatch.setattr(trace, "_clock", clock)
    for pm in (False, True):
        mt.render(_scene(pm), 0, _cfg(pm), device="cpu")
    assert calls == []
    assert trace.span("render") is trace.span("render.chunk")   # the one shared null span
    mt.render(_scene(False), 0, _cfg(False), device="cpu", stats={})
    assert calls


def test_self_time_and_counts_on_a_fake_clock(monkeypatch):
    """A span's self time is its duration less its children's; counts add;
    the recording ends with its body and leaves what was open before."""
    ticks = iter(range(0, 10**9, 1000))   # 1 us a clock read
    monkeypatch.setattr(trace, "_clock", lambda: next(ticks))
    stats = {}
    with trace.recording(stats):
        with trace.span("a"):             # reads 0 ... 7000
            with trace.span("b"):         # 1000 ... 2000
                pass
            with trace.span("b"):         # 3000 ... 6000
                with trace.span("c"):     # 4000 ... 5000
                    pass
        trace.count("n", 2)
        trace.count("n")
        assert trace.now() == 8000
    assert stats["spans"] == {"a": [1, pytest.approx(7e-6), pytest.approx(3e-6)],
                              "b": [2, pytest.approx(4e-6), pytest.approx(3e-6)],
                              "c": [1, pytest.approx(1e-6), pytest.approx(1e-6)]}
    assert stats["n"] == 3
    assert trace.now() == 0 and trace._rec.stats is None
    trace.count("n")
    assert stats["n"] == 3


def test_recording_is_per_thread():
    """A recording opened on one thread does not take another thread's spans."""
    stats, other = {}, {}
    with trace.recording(stats):
        t = threading.Thread(target=lambda: other.update(null=trace.span("x") is trace._NULL))
        t.start()
        t.join(timeout=30)
        with trace.span("x"):
            pass
    assert not t.is_alive() and other == {"null": True}
    assert stats["spans"]["x"][0] == 1


# ---------------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------------

@pytest.mark.parametrize("pm", [False, True], ids=["pt", "pm"])
def test_render_counts_its_traversal_launches(pm):
    """render() records the traversal kernel's launches that ran during it
    and those that ran as two-CTA clusters: 0 and 0 on the CPU, where the
    plain version runs; with a wrapper that counts each call as a launch and
    every other one as paired, the change of each counter across the render,
    added to what the dict holds."""
    from mcrt_tpu_torch.ops import traverse_kernel as tk

    stats = {}
    mt.render(_scene(pm), 0, _cfg(pm), device="cpu", stats=stats)
    assert stats["traverse_launches"] == 0 and stats["traverse_paired_launches"] == 0
    calls = []
    real = tk.traverse

    def counted(cbvh, origin, direction):
        calls.append(origin.shape[0])
        tk.kernel.launches += 1
        tk.paired.launches += len(calls) % 2
        return real(cbvh, origin, direction)

    with mock.patch.object(tk, "traverse", counted):
        mt.render(_scene(pm), 0, _cfg(pm), device="cpu", stats=stats)
    assert len(calls) > 2
    assert stats["traverse_launches"] == len(calls)
    assert stats["traverse_paired_launches"] == (len(calls) + 1) // 2


@pytest.mark.parametrize("pm,streamed", CASES, ids=IDS)
def test_render_frees_its_tables_when_it_returns(pm, streamed):
    """Nothing a render builds keeps its tables alive once it has returned,
    with the garbage collector off: no reference cycle holds them (on the
    card a cycle kept each image's tables until a full collection, so a
    window's peak memory grew with its image count)."""
    import gc
    import weakref

    from mcrt_tpu_torch.scene import loader

    refs = []
    real = loader.Scene.tables

    def tables(self, *a, **k):
        t = real(self, *a, **k)
        refs.extend(weakref.ref(x) for x in t if isinstance(x, torch.Tensor))
        return t

    scene = _scene(pm)
    gc.collect()
    gc.disable()
    try:
        with mock.patch.object(loader.Scene, "tables", tables):
            mt.render(scene, 0, _cfg(pm, streamed), device="cpu", stats={})
        assert refs and not any(r() is not None for r in refs)
    finally:
        gc.enable()


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs and the kernels have no CPU mode)")


@pytest.mark.cuda
@pytest.mark.parametrize("pm", [False, True], ids=["pt", "pm"])
def test_capture_counters_on_card(pm):
    """On the card every capture is one loop.capture span, graph_pool_bytes
    sums what the captures reserved, each loop's first step runs eagerly
    once (loop.warm), every later step is one replay, and the waits before
    the captures are counted in loop_sync_wait_s."""
    _card()
    pools, replays, waits = [], [], []
    real_init = cuda_graph.CapturedStep.__init__
    real_replay = cuda_graph.CapturedStep.replay
    real_wait = cuda_graph.wait_for_device

    def init(self, fn, state):
        real_init(self, fn, state)
        pools.append(self.pool_bytes)

    def replay(self):
        replays.append(1)
        real_replay(self)

    def wait(dev):
        waits.append(dev)
        real_wait(dev)

    stats = {}
    with mock.patch.object(cuda_graph.CapturedStep, "__init__", init), \
            mock.patch.object(cuda_graph.CapturedStep, "replay", replay), \
            mock.patch.object(cuda_graph, "wait_for_device", wait):
        mt.render(_scene(pm, 32, 32), 0, _cfg(pm, rays_per_chunk=1024, lanes=256),
                  device="cuda", stats=stats)
    spans = stats["spans"]
    assert stats["graphed"] and spans["loop.capture"][0] == len(pools) == len(waits) > 0
    assert stats["graph_pool_bytes"] == sum(pools) > 0
    assert spans["loop.warm"][0] == len(pools)
    assert stats["loop_steps"] - spans["loop.warm"][0] == len(replays)
    assert 0.0 < stats["loop_sync_wait_s"]
    # 256 lanes are one ray block a launch: every launch runs as a pair.
    assert stats["traverse_launches"] == stats["traverse_paired_launches"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("pm", [False, True], ids=["pt", "pm"])
def test_profiled_render_device_events_carry_no_span_name_on_card(pm):
    """In a render profiled with CPU and CUDA activity, the spans are host
    events and no CUDA-typed event bears a span's name."""
    _card()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    stats = {}
    with torch.profiler.profile(activities=acts) as prof:
        mt.render(_scene(pm, 32, 32), 0, _cfg(pm, rays_per_chunk=1024, lanes=256),
                  device="cuda", stats=stats)
    events = prof.profiler.kineto_results.events()
    device = {e.name() for e in events if e.device_type() == DeviceType.CUDA}
    assert device and not device & set(PARENTS)
    host = {e.name() for e in events if e.device_type() == DeviceType.CPU}
    assert set(stats["spans"]) <= host
    assert np.isfinite(stats["loop_sync_wait_s"])
