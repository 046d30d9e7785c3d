"""The path tracer's traversal statistics and the intersect in lane order,
against the JAX package's `PTConfig(collect_traversal_stats=True)` and
`make_intersect_fn(..., sort_rays=False)`.

The port always sums the primary intersect's Hit.steps and `trace` returns
them as "traversal_steps" when the intersect reported any; it has no switch
for them. The ray order is make_intersect_fn's `sort_rays`, as in the JAX
package.

float64 scene tables on the CPU (the traversal statistics over float32
cluster tables, which the Pallas kernel takes; the unsorted hits in float32
too), in-repo scenes only: the inline height field. Inputs are made from a
seed with numpy and handed to both packages.

Bars:
- radiance: |port - JAX| <= 1e-8 on at least 99.5% of paths, the bar of
  tests/test_torch_path_tracer.py, whose docstring explains the flips it allows;
- traversal statistics: equal as integers to the JAX package's through its
  Pallas kernel in interpret mode, the traversal the port's kernel replaces;
- unsorted hits: ids identical and t within rtol 1e-12 (float64) or 1e-6
  (float32) of the JAX package's, the bars of
  tests/test_torch_traverse.py::test_intersect_fn_matches_jax."""
import functools

import numpy as np
import pytest
import torch

import mcrt_tpu_torch as mt
from mcrt_tpu_torch.camera import camera as tcam
from mcrt_tpu_torch.integrator import path_tracer as tpt
from mcrt_tpu_torch.ops import cluster_bvh as tcb
from mcrt_tpu_torch.scene.synthetic import height_field_scene

jnp = pytest.importorskip("jax.numpy")
from mcrt_tpu.camera import camera as jcam  # noqa: E402
from mcrt_tpu.integrator import path_tracer as jpt  # noqa: E402
from mcrt_tpu.ops import cluster_bvh as jcb  # noqa: E402
from mcrt_tpu.ops import traverse_kernel as jtk  # noqa: E402
from mcrt_tpu.scene.loader import Scene as JScene  # noqa: E402

torch.set_num_threads(1)  # pytest-xdist runs several workers on the same cores

W = 16
BOUNCES = 8


@functools.lru_cache(maxsize=None)
def _scenes(n=6, width=W):
    j = height_field_scene(n, width, 1)
    return mt.Scene(j), JScene(j)


def _close_share(a, b):
    err = np.abs(np.asarray(a) - np.asarray(b)).max(axis=-1)
    return float((err <= 1e-8).mean())


def _camera_rays(js, jt, width, spp, seed=0):
    """The JAX package's camera rays of every (pixel, sample) in a shuffled
    order, as numpy-made indices; returns the JAX rays and the port's copy."""
    n = width * width * spp
    lin = np.random.default_rng(seed).permutation(n)
    pix = lin // spp
    jr = jcam.generate_rays(js.cameras[0], pix % width, pix // width, lin % spp, jt.ior, 0,
                            jnp.float64)
    port = [torch.tensor(np.asarray(x)) for x in (jr.origin, jr.direction)]
    port += [torch.tensor(np.asarray(x).astype(np.int64)) for x in (jr.pixel_index, jr.sample_index)]
    return jr, port


def _bvh_fns(ts, js, tt, jt):
    """Both packages' intersect closures over float64 cluster BVHs."""
    tb, jb = ts.build_cluster_bvh(np.float64, "cpu"), js.build_cluster_bvh(np.float64)
    return tcb.make_intersect_fn(tt, ts.meta(), tb), jcb.make_intersect_fn(jt, js.meta(), jb)


# ---------------------------------------------------------------------------------
# (b) the traversal statistics
# ---------------------------------------------------------------------------------

def _pallas_interpret(cbvh, origin, direction, block=256, method=None, group=8):
    """The JAX package's traversal routed to its Pallas kernel in interpret mode."""
    return jtk.traverse_pallas(cbvh, origin, direction, block, interpret=True)


def test_traversal_steps_match_pallas(monkeypatch):
    """trace(..., return_stats=True) through the cluster BVH at 32x32, 1 spp, on a 4608-triangle height field (63 clusters, so blocks
    prune): stats["traversal_steps"], [candidates, rounds] of the primary
    intersects summed over bounces, equal as integers to the JAX package's
    through the Pallas kernel in interpret mode, with float64 paths over
    float32 cluster tables in both; the rays traced equal too. The
    differentiable route adds the same counts (its extra trips see only parked
    blocks, which cost nothing)."""
    width = 32
    ts, js = _scenes(48, width)
    tt, jt = ts.tables(np.float64, "cpu"), js.tables(jnp.float64)
    tfn = tcb.make_intersect_fn(tt, ts.meta(), ts.build_cluster_bvh(np.float32, "cpu"))
    jb = js.build_cluster_bvh(np.float32)
    jr, (o, d, pi, si) = _camera_rays(js, jt, width, 1, seed=1)
    cfg = tpt.PTConfig(max_bounces=BOUNCES)
    got, st = tpt.trace(tt, ts.meta(), cfg, o, d, pi, si, intersect_fn=tfn, return_stats=True)
    monkeypatch.setattr(jcb, "traverse", _pallas_interpret)
    want, jst = jpt.trace(jt, js.meta(), jpt.PTConfig(max_bounces=BOUNCES, collect_traversal_stats=True),
                          jr.origin, jr.direction, jr.pixel_index, jr.sample_index,
                          intersect_fn=jcb.make_intersect_fn(jt, js.meta(), jb, method="pallas"),
                          return_stats=True)
    steps = st["traversal_steps"]
    assert steps.dtype == torch.int64 and steps.shape == (2,)
    np.testing.assert_array_equal(steps.numpy(), np.asarray(jst["traversal_steps"]))
    assert int(st["rays"]) == int(jst["rays"])
    assert _close_share(got.numpy(), want) >= 0.995
    assert 0 < int(steps[1]) < int(steps[0])          # some blocks pruned a candidate

    _, st_diff = tpt.trace(tt, ts.meta(), cfg, o, d, pi, si, intersect_fn=tfn,
                           return_stats=True, differentiable=True, remat=False)
    assert torch.equal(st_diff["traversal_steps"], steps)


@pytest.mark.parametrize("differentiable", [False, True])
def test_traversal_steps_absent_without_counts(differentiable):
    """The brute-force intersect reports no Hit.steps, so `trace` returns no
    "traversal_steps": zeros that nothing counted never pass for a count.
    The rays and the radiance are those of the same trace through the BVH."""
    ts, js = _scenes()
    tt, jt = ts.tables(np.float64, "cpu"), js.tables(jnp.float64)
    tfn, _ = _bvh_fns(ts, js, tt, jt)
    _, (o, d, pi, si) = _camera_rays(js, jt, W, 1, seed=2)
    cfg = tpt.PTConfig(max_bounces=BOUNCES)
    kw = dict(return_stats=True, differentiable=differentiable, remat=False)
    brute, st = tpt.trace(tt, ts.meta(), cfg, o, d, pi, si, **kw)
    bvh, st_bvh = tpt.trace(tt, ts.meta(), cfg, o, d, pi, si, intersect_fn=tfn, **kw)
    assert "traversal_steps" not in st and "traversal_steps" in st_bvh
    assert int(st["rays"]) == int(st_bvh["rays"])
    assert _close_share(brute.numpy(), bvh.numpy()) >= 0.995


# ---------------------------------------------------------------------------------
# (c) the intersect in lane order
# ---------------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_unsorted_hits_match_jax(dtype):
    """The port's make_intersect_fn with sort_rays=False (rays traversed in
    lane order) against the JAX package's with sort_rays=False, on 1024 rays in a shuffled order (half camera rays, half
    leaving points above the field in random directions): ids identical, t and
    uv at the unsorted-hits bar, and the same hits as the port's sorted
    intersect, on the 63-cluster height field. The lane-order blocks cull
    more clusters than sorted ones."""
    ts, js = _scenes(48, 32)
    tt, jt = ts.tables(np.dtype(dtype), "cpu"), js.tables(jnp.dtype(dtype))
    tb, jb = ts.build_cluster_bvh(np.dtype(dtype), "cpu"), js.build_cluster_bvh(np.dtype(dtype))
    rng = np.random.default_rng(5)
    n = 1024
    lin = rng.permutation(32 * 32)[:n // 2]
    rays = tcam.generate_rays(ts.cameras[0], torch.as_tensor(lin % 32), torch.as_tensor(lin // 32),
                              torch.zeros(n // 2, dtype=torch.int64), 0, getattr(torch, dtype))
    dd = rng.normal(size=(n // 2, 3))
    o = np.concatenate([rays.origin.numpy(),
                        np.stack([rng.uniform(0, 10, n // 2), rng.uniform(0.6, 3, n // 2),
                                  rng.uniform(0, 10, n // 2)], 1)]).astype(dtype)
    d = np.concatenate([rays.direction.numpy(),
                        dd / np.linalg.norm(dd, axis=1, keepdims=True)]).astype(dtype)
    mix = rng.permutation(n)
    o, d = o[mix], d[mix]
    want = jcb.make_intersect_fn(jt, js.meta(), jb, sort_rays=False)(jnp.asarray(o), jnp.asarray(d))
    sorted_ = tcb.make_intersect_fn(tt, ts.meta(), tb)(torch.as_tensor(o), torch.as_tensor(d))
    got = tcb.make_intersect_fn(tt, ts.meta(), tb, sort_rays=False)(torch.as_tensor(o),
                                                                      torch.as_tensor(d))
    np.testing.assert_array_equal(got.surf_id.numpy(), np.asarray(want.surf_id))
    hit = np.asarray(want.surf_id) >= 0
    assert hit.sum() > n // 4
    rtol = 1e-12 if dtype == "float64" else 1e-6
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit], rtol=rtol)
    np.testing.assert_allclose(got.uv.numpy()[hit], np.asarray(want.uv)[hit], rtol=rtol, atol=rtol)
    assert torch.equal(got.surf_id, sorted_.surf_id)
    np.testing.assert_allclose(got.t.numpy()[hit], sorted_.t.numpy()[hit], rtol=rtol)
    assert int(got.steps[0]) > int(sorted_.steps[0])
