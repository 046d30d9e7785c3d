"""The readers of the port's own spans and counters (render.prep_pct,
loops.capture_pct, loops.host_us_per_step, pm.photon_host_pct,
loops.pool_mib): their values on a hand-made run, nothing from a program
that records none, and finite values on both tiny cells."""
import math
import time

import pytest

from benchmark import cell, run
from benchmark.entries import render_images

NEW = ("render.prep_pct", "loops.capture_pct", "loops.host_us_per_step", "pm.photon_host_pct",
       "loops.pool_mib")


def _image(wall, spans, **counters):
    stats = {"spans": {n: [1, s, self_s] for n, (s, self_s) in spans.items()}}
    stats.update(counters)
    return {"wall": wall, "stats": stats}


def _run(images):
    return cell.Run(samples_per_image=1, images=images, window_s=5.0, setup_s=1.0, peak_bytes=0)


HAND = _run([
    _image(2.0, {"render.tables": (0.10, 0.10), "render.bvh": (0.02, 0.02),
                 "loop.warm": (0.05, 0.05), "loop.capture": (0.15, 0.15),
                 "loop.drain": (1.50, 1.30), "pm.photon_pass": (0.8, 0.1),
                 "pm.emit.copy": (0.06, 0.06), "pm.grid": (0.30, 0.30)},
           loop_steps=1000, loop_sync_wait_s=1.2, graph_pool_bytes=3 << 20),
    _image(3.0, {"render.tables": (0.13, 0.13), "render.bvh": (0.05, 0.05),
                 "loop.warm": (0.10, 0.10), "loop.capture": (0.20, 0.20),
                 "loop.drain": (2.50, 2.20), "pm.photon_pass": (0.9, 0.1),
                 "pm.emit.copy": (0.04, 0.04), "pm.grid": (0.40, 0.40)},
           loop_steps=1500, loop_sync_wait_s=2.0, graph_pool_bytes=5 << 20),
])


@pytest.mark.parametrize("name,want", [
    ("render.prep_pct", 100.0 * (0.10 + 0.02 + 0.13 + 0.05) / 5.0),
    ("loops.capture_pct", 100.0 * (0.05 + 0.15 + 0.10 + 0.20) / 5.0),
    ("loops.host_us_per_step", 1e6 * ((1.30 + 2.20) - (1.2 + 2.0)) / 2500),
    ("pm.photon_host_pct", 100.0 * (0.06 + 0.30 + 0.04 + 0.40) / 5.0),
    ("loops.pool_mib", 4.0),
])
def test_reader_on_a_hand_made_run(name, want):
    assert run.load_metric(name).read(HAND) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", NEW)
def test_reader_of_a_program_without_spans_returns_none(name):
    """A program that records no spans or counters (the parent of the
    change that added them) gives None, not an error."""
    bare = _run([{"wall": 2.0, "stats": {"chunks": 3, "bounce_steps": 40}}])
    assert run.load_metric(name).read(bare) is None
    assert run.load_metric(name).read(_run([])) is None


def test_counters_an_image_never_counted_read_as_zero():
    """An image that captured nothing has no graph_pool_bytes (a CPU render):
    its pools read 0; with no loop steps at all there is no time a step."""
    cpu = _image(2.0, {"loop.drain": (0.5, 0.5)}, loop_steps=10, loop_sync_wait_s=0.25)
    assert run.load_metric("loops.pool_mib").read(_run([cpu, HAND.images[0]])) == 1.5
    assert run.load_metric("loops.host_us_per_step").read(_run([cpu])) == \
        pytest.approx(1e6 * 0.25 / 10)
    assert run.load_metric("loops.host_us_per_step").read(
        _run([_image(2.0, {"render.tables": (0.1, 0.1)})])) is None


def test_photon_host_share_is_none_without_a_photon_pass():
    pt = _run([_image(2.0, {"render.tables": (0.1, 0.1)}, loop_steps=10, loop_sync_wait_s=0.0,
                      graph_pool_bytes=0)])
    assert run.load_metric("pm.photon_host_pct").read(pt) is None


def test_readers_on_the_tiny_cells(tiny):
    """Each reader gives a finite value on each tiny cell's window (the
    photon share only on the photon mapper's), from the stats that render()
    fills."""
    workload, config, traffic, check = tiny
    pixels = render_images.sample_pixels(2**31 + 5, traffic["width"] ** 2, check["pixels"])
    r, _, _, _ = render_images.measure(config, traffic, 0.1, False, "cpu", time.time(), pixels)
    pm = workload.startswith("pm-")
    for name in NEW:
        value = run.load_metric(name).read(r)
        if name == "pm.photon_host_pct" and not pm:
            assert value is None
        else:
            assert value is not None and math.isfinite(value) and value >= 0.0, (name, value)
