"""The reader of traverse.paired_pct, the share of the traversal kernel's
launches that ran as two-CTA clusters: its value on a hand-made run, None
from a program that counts no launches, and None on both tiny cells (the
CPU runs the plain traversal, which launches nothing)."""
import time

import pytest

from benchmark import cell, run
from benchmark.entries import render_images


def _run(images):
    return cell.Run(samples_per_image=1, images=images, window_s=5.0, setup_s=1.0, peak_bytes=0)


def _launches(total, paired):
    return {"wall": 2.0, "stats": {"traverse_launches": total, "traverse_paired_launches": paired}}


def _read(r):
    return run.load_metric("traverse.paired_pct").read(r)


@pytest.mark.parametrize("images,want", [
    ([_launches(1408, 1408), _launches(1408, 1408)], 100.0),
    ([_launches(633, 260), _launches(600, 240)], 100.0 * 500 / 1233),
    ([_launches(68, 0)], 0.0),
    ([_launches(10, 10), {"wall": 2.0, "stats": {"traverse_launches": 30}}], 25.0),
])
def test_paired_share_on_a_hand_made_run(images, want):
    assert _read(_run(images)) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("images", [
    [{"wall": 2.0, "stats": {"chunks": 3, "bounce_steps": 40}}],
    [],
    [_launches(0, 0), _launches(0, 0)],
    [_launches(5, 5), {"wall": 2.0, "stats": {"bounce_steps": 40}}],
], ids=["no_counters", "no_images", "no_launches", "one_image_uncounted"])
def test_paired_share_is_none_where_nothing_was_counted(images):
    """None from a program without the counters (the parent of the change
    that added them), from a window of no images, where no launch ran (a CPU
    render counts none), and where an image lacks the counters."""
    assert _read(_run(images)) is None


def test_paired_share_on_the_tiny_cells(tiny):
    """render() counts the launches of each tiny cell's window, and the CPU
    launches none, so the share reads None there."""
    workload, config, traffic, check = tiny
    pixels = render_images.sample_pixels(2**31 + 5, traffic["width"] ** 2, check["pixels"])
    r, _, _, _ = render_images.measure(config, traffic, 0.1, False, "cpu", time.time(), pixels)
    assert r.images and all(im["stats"]["traverse_launches"] == 0 for im in r.images)
    assert all(im["stats"]["traverse_paired_launches"] == 0 for im in r.images)
    assert _read(r) is None
