"""The port's render() against the JAX package's, and its checkpoint/resume.

Both render the same scene in float32 on the CPU; the images are finalized
(`plain`, clipped to [0, 1]) and held to the strictest bars of
tests/test_e2e_golden.py: per-channel image mean within 0.01, 95th percentile of
the per-pixel difference under 0.10, mean difference under 0.03. The two
renders use the same sample streams, so they differ only where float32
rounding flips a path's decision.

Cases: the default (streamed, box filter, per-pixel sums) on the height-field
mesh through the cluster BVH (the port's plain traversal on the CPU); the
streamed path with a Gaussian filter (scatter splat); the non-streamed path."""
import importlib
import json
import pathlib

import numpy as np
import pytest
import torch

import mcrt_tpu_torch as mt
from mcrt_tpu_torch.camera import image as image_mod
from mcrt_tpu_torch.scene.synthetic import height_field_scene

pytest.importorskip("jax")
import mcrt_tpu as jm  # noqa: E402

torch.set_num_threads(1)  # pytest-xdist runs several workers on the same cores

# The package exports the function render(), which hides the module of that name.
render_mod = importlib.import_module("mcrt_tpu_torch.render")

SCENES = pathlib.Path(__file__).parent / "scenes"


def _caustic(filt=None):
    j = json.loads((SCENES / "caustic_sphere.json").read_text())
    j["cameras"][0]["image"] = {"width": 16, "height": 16, "plain": True}
    j["cameras"][0]["sqrtspp"] = 2
    if filt:
        j["cameras"][0]["film"] = {"filter": filt}
    return j


CASES = {
    "height_field_streamed_box": (lambda: height_field_scene(8, 16, 2), True),
    "caustic_streamed_gaussian": (lambda: _caustic("gaussian"), True),
    "caustic_batch_box": (_caustic, False),
}


def _finalize(hdr, scene):
    return np.clip(image_mod.finalize(hdr, scene.cameras[0].image), 0.0, 1.0)


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_matches_jax(case):
    make, streamed = CASES[case]
    j = make()
    ts, js = mt.Scene(j), jm.Scene(j)
    kw = dict(dtype="float32", max_bounces=16, rays_per_chunk=256, lanes=128, streamed=streamed)
    stats = {}
    ours = mt.render(ts, 0, mt.RenderConfig(**kw), device="cpu", stats=stats)
    ref = jm.render(js, 0, jm.RenderConfig(**kw))
    assert ours.shape == ref.shape and np.isfinite(ours).all() and ours.min() >= 0.0
    assert stats["chunks"] == -(-16 * 16 * 4 // 256) and int(stats["rays"]) > 16 * 16 * 4
    a, b = _finalize(ours, ts), _finalize(ref, js)
    assert b.mean() > 0.02
    diff = np.abs(a - b)
    per_channel = np.abs(a.mean(axis=(0, 1)) - b.mean(axis=(0, 1)))
    assert np.all(per_channel < 0.01), per_channel
    assert np.percentile(diff, 95) < 0.10
    assert diff.mean() < 0.03


class _Preempted(Exception):
    pass


def test_checkpoint_resume_is_bit_identical(tmp_path, monkeypatch):
    """A render stopped after two chunks and resumed from its checkpoint gives
    the uninterrupted render's image bit for bit; a checkpoint with another
    key is ignored."""
    scene = mt.Scene(height_field_scene(4, 8, 2))
    cfg = mt.RenderConfig(max_bounces=8, rays_per_chunk=64, lanes=32)    # 8*8*4 paths: 4 chunks
    full = mt.render(scene, 0, cfg, device="cpu")

    real = render_mod._chunk_streamed
    calls = []

    def stop_after_two(*a, **k):
        if len(calls) == 2:
            raise _Preempted
        calls.append(1)
        return real(*a, **k)

    ck = tmp_path / "ck"
    monkeypatch.setattr(render_mod, "_chunk_streamed", stop_after_two)
    with pytest.raises(_Preempted):
        mt.render(scene, 0, cfg, device="cpu", checkpoint_dir=ck, checkpoint_every_s=0.0)
    monkeypatch.setattr(render_mod, "_chunk_streamed", real)
    (path,) = ck.glob("*.npz")
    assert int(np.load(path)["done"]) == 128
    resumed = mt.render(scene, 0, cfg, device="cpu", checkpoint_dir=ck, checkpoint_every_s=0.0)
    np.testing.assert_array_equal(resumed, full)
    assert int(np.load(path)["done"]) == 256

    z = dict(np.load(path))
    np.savez(path, film=np.full_like(z["film"], 999.0), done=128, key="another scene")
    again = mt.render(scene, 0, cfg, device="cpu", checkpoint_dir=ck)
    np.testing.assert_array_equal(again, full)
