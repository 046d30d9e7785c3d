"""The port's differentiable wavefront, trace_streamed(fixed_trips=...), against
the JAX package's; and the machinery of both differentiable loops: the
rematerialisation, repeatability, no host reads, one checkpoint per trip.

float64 on the CPU, at 8x8 and 2 spp, with the scenes, probe point and inputs
of tests/test_torch_grad.py, whose docstring defines the bars' terms. Each
test's docstring states its bar."""
from unittest import mock

import numpy as np
import pytest
import torch

from mcrt_tpu_torch.camera import camera as tcam
from mcrt_tpu_torch.integrator import path_tracer as tpt
from mcrt_tpu_torch.ops import cluster_bvh as tcb
from mcrt_tpu_torch.ops import traverse_kernel as tk
from test_torch_grad import (BOUNCES, PARAMS, W, _assert_tables_close, _port, _port_grads,
                             _port_trace_loss, _probe, _scenes)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from mcrt_tpu.integrator import path_tracer as jpt  # noqa: E402
from mcrt_tpu.ops import cluster_bvh as jcb  # noqa: E402

torch.set_num_threads(1)  # pytest-xdist runs several workers on the same cores

SPP = 2
LANES = 32           # fewer lanes than the 128 paths: each lane runs several
TRIPS = 6            # short of draining them: some paths are flushed in flight, some never start


def _streamed_loss_port(ts, tables, cbvh, params, strided, trips=TRIPS, **kw):
    t = tables._replace(**params)
    ifn = tcb.make_intersect_fn(t, ts.meta(), cbvh) if cbvh is not None else None
    n = W * W * SPP
    rad, rays = tpt.trace_streamed(t, ts.meta(), tpt.PTConfig(max_bounces=BOUNCES), ts.cameras[0],
                                   SPP, 0, n, LANES, intersect_fn=ifn, fixed_trips=trips,
                                   strided=strided, **kw)
    w = torch.as_tensor(np.random.default_rng(1).random((n, 3)))
    return rad, rays, (rad * w).sum()


# ---------------------------------------------------------------------------------
# (b) against the JAX package's
# ---------------------------------------------------------------------------------

def _close_share(a, b):
    return float((np.abs(np.asarray(a) - np.asarray(b)).max(axis=-1) <= 1e-8).mean())


@pytest.mark.parametrize("strided", [True, False], ids=["strided", "dynamic"])
def test_streamed_grads_match_jax(strided):
    """trace_streamed(fixed_trips=6) with 32 lanes for 128 paths, lane-strided
    and dynamic, on the height field through the BVH, against the JAX
    package's: per-path radiance |port - JAX| <= 1e-8 on at least 99.5% of
    paths (the rest are decision flips, tests/test_torch_path_tracer.py), rays
    traced within 0.5%, and per-table gradients of sum(w * radiance) within
    1e-9 of each table's largest |g|. The trips run out before the paths do:
    more than half finish as they would with trips to spare, the others are
    flushed in flight or never start."""
    ts, tables, cbvh = _port("height_field", "bvh")
    _, js = _scenes("height_field")
    jt = js.tables(jnp.float64)
    jb = js.build_cluster_bvh(np.float64)
    n = W * W * SPP
    w = np.random.default_rng(1).random((n, 3))

    def jloss(params):
        t = jt._replace(**params)
        ifn = jcb.make_intersect_fn(t, js.meta(), jb)
        rad, rays = jpt.trace_streamed(t, js.meta(), jpt.PTConfig(max_bounces=BOUNCES),
                                       js.cameras[0], SPP, 0, n, LANES, intersect_fn=ifn,
                                       fixed_trips=TRIPS, strided=strided)
        return jnp.sum(rad * w), (rad, rays)

    (_, (want_rad, want_rays)), want = jax.jit(jax.value_and_grad(jloss, has_aux=True))(_probe(jt))
    params = _probe(tables)
    rad, rays, _ = _streamed_loss_port(ts, tables, cbvh, params, strided)
    assert rad.shape == (n, 3)
    assert _close_share(rad.numpy(), want_rad) >= 0.995
    assert abs(int(rays) - int(want_rays)) <= 0.005 * int(want_rays)
    _, got = _port_grads(lambda p: _streamed_loss_port(ts, tables, cbvh, p, strided)[2], params)
    _assert_tables_close(got, want)
    # The trips ran out: most paths finished as they would have with trips to
    # spare, the others were flushed in flight or never started.
    drained, _, _ = _streamed_loss_port(ts, tables, cbvh, params, strided, trips=64)
    same = (rad == drained).all(dim=1)
    assert n // 2 < int(same.sum()) < n


def test_streamed_strided_without_trips_matches_trace():
    """Lane-strided mode run to the end (fixed_trips=None, strided=True) is a
    schedule of the same paths: its per-path radiance equals one batch of
    `trace` within 1e-12."""
    ts, tables, cbvh = _port("caustic_sphere", "brute")
    n = W * W * SPP
    rad, _ = tpt.trace_streamed(tables, ts.meta(), tpt.PTConfig(max_bounces=BOUNCES), ts.cameras[0],
                                SPP, 0, n, LANES, strided=True)
    lin = np.arange(n)
    pix = lin // SPP
    r = tcam.generate_rays(ts.cameras[0], torch.as_tensor(pix % W), torch.as_tensor(pix // W),
                           torch.as_tensor(lin % SPP), 0, torch.float64)
    batch = tpt.trace(tables, ts.meta(), tpt.PTConfig(max_bounces=BOUNCES), r.origin, r.direction,
                      r.pixel_index, r.sample_index)
    np.testing.assert_allclose(rad.numpy(), batch.numpy(), rtol=0, atol=1e-12)


# ---------------------------------------------------------------------------------
# (e) rematerialisation changes nothing, (f) runs repeat bit for bit
# ---------------------------------------------------------------------------------

def _grads_of(entry, remat):
    ts, tables, cbvh = _port("height_field", "bvh")
    params = _probe(tables)
    if entry == "trace":
        fn = lambda p: _port_trace_loss(ts, tables, cbvh, p, remat=remat)
    else:
        fn = lambda p: _streamed_loss_port(ts, tables, cbvh, p, entry == "strided", remat=remat)[2]
    return _port_grads(fn, params)


@pytest.mark.parametrize("entry", ["trace", "strided", "dynamic"])
def test_remat_gives_identical_grads(entry):
    """remat=True and remat=False give bit-identical losses and gradients
    (trace(differentiable=True), and trace_streamed(fixed_trips) in both
    modes, through the BVH): a checkpointed trip recomputes exactly the
    forward's values, and nothing writes into a trip's input."""
    a_loss, a = _grads_of(entry, True)
    b_loss, b = _grads_of(entry, False)
    assert torch.equal(a_loss, b_loss)
    for k in PARAMS:
        assert torch.equal(a[k], b[k]), k


@pytest.mark.parametrize("entry", ["trace", "dynamic"])
def test_grads_repeat_bit_for_bit(entry):
    """Two runs give bit-identical gradients (float64, CPU)."""
    _, a = _grads_of(entry, True)
    _, b = _grads_of(entry, True)
    for k in PARAMS:
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------------------------------------------------
# The loops' machinery: no host reads, a checkpoint per trip, launches counted
# ---------------------------------------------------------------------------------

def _refuse(*_a, **_k):
    raise AssertionError("the host read a tensor inside the differentiable loop")


@pytest.mark.parametrize("entry", ["trace", "strided", "dynamic"])
def test_differentiable_loops_never_read_the_device(entry, monkeypatch):
    """trace(differentiable=True) and trace_streamed(fixed_trips) read no
    tensor from the host, forward or backward (brute force: the CPU's plain
    traversal reads its own loop flags); the draining forward loop does."""
    ts, tables, _ = _port("caustic_sphere", "brute")
    params = _probe(tables)
    if entry == "trace":
        fn = lambda p: _port_trace_loss(ts, tables, None, p)
    else:
        fn = lambda p: _streamed_loss_port(ts, tables, None, p, entry == "strided")[2]
    leaves = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    with monkeypatch.context() as m:
        for name in ("__bool__", "item", "tolist", "__int__", "__float__", "__index__"):
            m.setattr(torch.Tensor, name, _refuse)
        loss = fn(leaves)
        grads = torch.autograd.grad(loss, list(leaves.values()))
    assert all(torch.isfinite(g).all() for g in grads)
    with monkeypatch.context() as m, pytest.raises(AssertionError, match="host read"):
        m.setattr(torch.Tensor, "__bool__", _refuse)
        tpt.trace_streamed(tables, ts.meta(), tpt.PTConfig(max_bounces=BOUNCES), ts.cameras[0],
                           SPP, 0, W * W * SPP, LANES)


@pytest.mark.parametrize("remat", [True, False])
def test_checkpoint_per_trip_and_traversals_counted(remat):
    """With remat every trip runs under torch.utils.checkpoint, non-reentrant
    and without RNG state; the backward pass runs each trip's two traversals
    (camera and shadow rays) again, so a differentiable trace of 5 bounces
    calls the traversal 10 times forward and 10 more in the backward pass
    (none without remat)."""
    ts, tables, cbvh = _port("height_field", "bvh")
    params = _probe(tables)
    leaves = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    real = torch.utils.checkpoint.checkpoint
    with mock.patch.object(torch.utils.checkpoint, "checkpoint", wraps=real) as ck, \
            mock.patch.object(tk, "traverse", wraps=tk.traverse) as trav:
        loss = _port_trace_loss(ts, tables, cbvh, leaves, remat=remat)
        forward = trav.call_count
        torch.autograd.grad(loss, list(leaves.values()))
        backward = trav.call_count - forward
    assert forward == 2 * BOUNCES and backward == (2 * BOUNCES if remat else 0)
    assert ck.call_count == (BOUNCES if remat else 0)
    for call in ck.call_args_list:
        assert call.kwargs == {"use_reentrant": False, "preserve_rng_state": False}


def test_streamed_pixel_sums_need_dynamic_mode():
    """pixel_sums needs the dynamic mode, as the JAX package asserts."""
    ts, tables, _ = _port("caustic_sphere", "brute")
    with pytest.raises(ValueError, match="dynamic"):
        tpt.trace_streamed(tables, ts.meta(), tpt.PTConfig(max_bounces=2), ts.cameras[0], SPP, 0,
                           W * W * SPP, LANES, fixed_trips=4, pixel_sums=True)
