"""The differentiable loops' trips as a GraphedTrip (utils/cuda_graph.py): on
the card each trip replays two captured CUDA graphs, the trip and its
recompute plus backward; on the CPU the same autograd Function runs the two
bodies where the replays would, over the same static buffers, so these tests
hold the buffers, the copies, the routing of the closure tensors and the
assembly of the gradients. `path_tracer._graph_trips` is patched to send the
CPU's trips down that route; unpatched, the CPU runs each trip under
torch.utils.checkpoint (the checkpoint route).

float64 on the CPU, at 8x8, with the scenes, probe point, inputs and bars of
tests/test_torch_grad.py, whose docstring defines the bars' terms. Each
test's docstring states its bar. The card's case (marked `cuda`, skipped
without one) holds the graphed trips to the eager ones:

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_graphed_trips.py -q
"""
from unittest import mock

import numpy as np
import pytest
import torch

from mcrt_tpu_torch.camera import camera as tcam
from mcrt_tpu_torch.camera import film as tfilm
from mcrt_tpu_torch.integrator import path_tracer as tpt
from mcrt_tpu_torch.ops import cluster_bvh as tcb
from mcrt_tpu_torch.ops import traverse_kernel as tk
from mcrt_tpu_torch.parallel import sharding as tsh

torch.set_num_threads(1)  # pytest-xdist runs several workers on the same cores

PARAMS = tsh.DEFAULT_TRAIN_PARAMS
REL = 1e-12          # the Function's route against the checkpoint route, relative
TRACE_SCENES = {"trace-brute": ("caustic_sphere", "brute"), "trace-bvh": ("height_field", "bvh")}


def _helpers():
    """tests/test_torch_grad.py and test_torch_grad_streamed.py, imported
    where a CPU test needs them; the test skips without JAX in float64
    (tests/conftest.py turns it on), as on the card."""
    jax = pytest.importorskip("jax")
    if not jax.config.jax_enable_x64:
        pytest.skip("needs JAX in float64, which tests/conftest.py turns on")
    import test_torch_grad
    import test_torch_grad_streamed

    return test_torch_grad, test_torch_grad_streamed


def _graphed(on=True):
    """The CPU's trips through the GraphedTrip route (or, off, the checkpoint route)."""
    return mock.patch.object(tpt, "_graph_trips", lambda device: on)


def _train_setup(with_bvh):
    g, gs = _helpers()
    ts, tables, cbvh = g._port("height_field", "bvh" if with_bvh else "brute")
    cam = ts.cameras[0]
    px, py, si, _ = g._inputs(2)
    target = np.random.default_rng(3).random((g.W, g.W, 3)) * 0.5
    step = tsh.train_step(ts.meta(), tpt.PTConfig(max_bounces=g.BOUNCES), cam,
                          tfilm.FilmConfig.from_json(g.W, g.W, cam.film), torch.float64,
                          with_bvh=True, device="cpu")
    args = (torch.as_tensor(px), torch.as_tensor(py), torch.as_tensor(si), torch.as_tensor(target))
    return tables, cbvh, step, args


def _jax_trace(name, route):
    """jax.grad of the JAX package's trace(differentiable=True): (loss, grads)."""
    g, gs = _helpers()
    import jax
    import jax.numpy as jnp
    from mcrt_tpu.camera import camera as jcam
    from mcrt_tpu.integrator import path_tracer as jpt
    from mcrt_tpu.ops import cluster_bvh as jcb

    _, js = g._scenes(name)
    jt = js.tables(jnp.float64)
    jb = js.build_cluster_bvh(np.float64) if route == "bvh" else None
    px, py, si, w = g._inputs(0)
    jr = jcam.generate_rays(js.cameras[0], px, py, si, jt.ior, 0, jnp.float64)

    def jloss(params):
        t = jt._replace(**params)
        ifn = jcb.make_intersect_fn(t, js.meta(), jb) if jb is not None else None
        rad = jpt.trace(t, js.meta(), jpt.PTConfig(max_bounces=g.BOUNCES), jr.origin, jr.direction,
                        jr.pixel_index, jr.sample_index, intersect_fn=ifn, differentiable=True)
        return jnp.sum(rad * w)

    return jax.jit(jax.value_and_grad(jloss))(g._probe(jt))


def _jax_streamed(strided):
    """jax.grad of the JAX package's trace_streamed(fixed_trips=6) on the
    height field through the BVH: (loss, grads)."""
    g, gs = _helpers()
    import jax
    import jax.numpy as jnp
    from mcrt_tpu.integrator import path_tracer as jpt
    from mcrt_tpu.ops import cluster_bvh as jcb

    _, js = g._scenes("height_field")
    jt = js.tables(jnp.float64)
    jb = js.build_cluster_bvh(np.float64)
    n = g.W * g.W * gs.SPP
    w = np.random.default_rng(1).random((n, 3))

    def jloss(params):
        t = jt._replace(**params)
        ifn = jcb.make_intersect_fn(t, js.meta(), jb)
        rad, _ = jpt.trace_streamed(t, js.meta(), jpt.PTConfig(max_bounces=g.BOUNCES),
                                    js.cameras[0], gs.SPP, 0, n, gs.LANES, intersect_fn=ifn,
                                    fixed_trips=gs.TRIPS, strided=strided)
        return jnp.sum(rad * w)

    return jax.jit(jax.value_and_grad(jloss))(g._probe(jt))


def _jax_train(with_bvh):
    """The JAX package's sharded_train_step on a one-device mesh: (loss, grads)."""
    g, gs = _helpers()
    import jax
    import jax.numpy as jnp
    from mcrt_tpu.camera import film as jfilm
    from mcrt_tpu.integrator import path_tracer as jpt
    from mcrt_tpu.parallel import sharding as jsh

    _, js = g._scenes("height_field")
    jt = js.tables(jnp.float64)
    px, py, si, _ = g._inputs(2)
    target = np.random.default_rng(3).random((g.W, g.W, 3)) * 0.5
    mesh = jsh.make_mesh(jax.devices()[:1])
    jstep = jsh.sharded_train_step(js.meta(), jpt.PTConfig(max_bounces=g.BOUNCES), js.cameras[0],
                                   jfilm.FilmConfig.from_json(g.W, g.W, js.cameras[0].film), mesh,
                                   jnp.float64, with_bvh=with_bvh)
    u32 = lambda x: jnp.asarray(x, jnp.uint32)
    jargs = (g._probe(jt), u32(px), u32(py), u32(si), jnp.asarray(target))
    with mesh:
        if with_bvh:
            return jstep(jt, js.build_cluster_bvh(np.float64), *jargs)
        return jstep(jt, *jargs)


def _port_run(entry, graphs=None):
    """(loss, grads) of one entry of the port at the probe point."""
    g, gs = _helpers()
    if entry.startswith("trace"):
        ts, tables, cbvh = g._port(*TRACE_SCENES[entry])
        return g._port_grads(lambda p: g._port_trace_loss(ts, tables, cbvh, p, graphs=graphs),
                             g._probe(tables))
    if entry in ("strided", "dynamic"):
        ts, tables, cbvh = g._port("height_field", "bvh")
        loss = lambda p: gs._streamed_loss_port(ts, tables, cbvh, p, entry == "strided",
                                                graphs=graphs)[2]
        return g._port_grads(loss, g._probe(tables))
    tables, cbvh, step, args = _train_setup(entry == "train-bvh")
    out = step(tables, cbvh if entry == "train-bvh" else None, g._probe(tables), *args)
    if graphs is not None:
        graphs.update(step.graphs)
    return out


ENTRIES = ["trace-brute", "trace-bvh", "strided", "dynamic", "train-brute", "train-bvh"]


@pytest.mark.parametrize("entry", ENTRIES)
def test_graphed_route_matches_checkpoint_and_jax(entry):
    """Each differentiable entry through the GraphedTrip route against the
    checkpoint route and against jax.grad of the JAX package's:
    trace(differentiable=True) by brute force (caustic sphere) and through
    the BVH (height field), trace_streamed(fixed_trips=6) lane-strided and
    dynamic (32 lanes, 128 paths), and train_step by brute force and through
    the BVH. Bars: loss and every table within 1e-12 relative of the
    checkpoint route's; the loss within 1e-12 relative of the JAX package's
    and every table within 1e-9 of its largest |g|."""
    g, gs = _helpers()
    want_ck = _port_run(entry)
    with _graphed():
        graphs = {}
        loss, got = _port_run(entry, graphs)
    assert len(graphs) == 1
    np.testing.assert_allclose(float(loss), float(want_ck[0]), rtol=REL)
    for k in PARAMS:
        a, b = got[k], want_ck[1][k]
        assert float((a - b).abs().max()) <= REL * max(float(b.abs().max()), 1e-300), k

    if entry.startswith("trace"):
        want = _jax_trace(*TRACE_SCENES[entry])
    elif entry in ("strided", "dynamic"):
        want = _jax_streamed(entry == "strided")
    else:
        want = _jax_train(entry == "train-bvh")
    np.testing.assert_allclose(float(loss), float(want[0]), rtol=1e-12)
    g._assert_tables_close(got, want[1])


def _shifted(tables, params):
    """Other tables of the same shapes: the geometry scaled by 1.02 about the
    origin and every parameter moved, within its range."""
    geo = {k: getattr(tables, k) * 1.02 for k in ("tri_v0", "tri_e1", "tri_e2")}
    p = {"mat_reflectance": params["mat_reflectance"] * 0.7,
         "mat_specular_roughness": params["mat_specular_roughness"] + 0.05,
         "mat_ior": torch.where(params["mat_ior"] > 1.0, params["mat_ior"] + 0.1,
                                params["mat_ior"]),
         "mat_transparency": params["mat_transparency"] * 0.8}
    return tables._replace(**geo), p


def test_calls_with_other_tables_reuse_one_trip():
    """Two calls of trace_streamed(fixed_trips=6) (dynamic, brute force,
    caustic sphere) through one `graphs` dict, the second with other
    geometry and parameters of the same shapes, give what two checkpoint-route
    calls give, bit for bit, and keep one trip. So do their forwards run
    first and their backwards after (the second call's leaves are loaded when
    the first's backward runs, so it loads its own again)."""
    g, gs = _helpers()
    ts, tables, _ = g._port("caustic_sphere", "brute")
    tables_b, params_b = _shifted(tables, g._probe(tables))
    runs = [(tables, g._probe(tables)), (tables_b, params_b)]

    def fwd(t, params, graphs):
        leaves = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
        return gs._streamed_loss_port(ts, t, None, leaves, False, graphs=graphs)[2], leaves

    def grads_of(loss, leaves):
        return loss.detach(), torch.autograd.grad(loss, list(leaves.values()))

    want = [grads_of(*fwd(t, p, None)) for t, p in runs]
    assert not torch.equal(want[0][0], want[1][0])
    with _graphed():
        graphs = {}
        one_by_one = [grads_of(*fwd(t, p, graphs)) for t, p in runs]
        assert len(graphs) == 1
        both = [fwd(t, p, graphs) for t, p in runs]
        interleaved = [grads_of(*b) for b in both]
        assert len(graphs) == 1
    for got in (one_by_one, interleaved):
        for (gl, gg), (wl, wg) in zip(got, want):
            assert torch.equal(gl, wl)
            for a, b in zip(gg, wg):
                assert torch.equal(a, b)


def test_many_trips_before_one_backward():
    """64 trips of trace(differentiable=True) (caustic sphere, brute force,
    max_bounces 64) before one backward: the GraphedTrip route's loss and
    gradients equal the checkpoint route's bit for bit. Each trip's outputs
    are clones of the static ones, so no later trip overwrites a state that
    an earlier trip's backward reads."""
    g, gs = _helpers()
    ts, tables, _ = g._port("caustic_sphere", "brute")
    px, py, si, w = g._inputs(0)
    r = tcam.generate_rays(ts.cameras[0], torch.as_tensor(px), torch.as_tensor(py),
                           torch.as_tensor(si), 0, torch.float64)

    def loss(p):
        rad = tpt.trace(tables._replace(**p), ts.meta(), tpt.PTConfig(max_bounces=64), r.origin,
                        r.direction, r.pixel_index, r.sample_index, differentiable=True)
        return (rad * torch.as_tensor(w)).sum()

    want_loss, want = g._port_grads(loss, g._probe(tables))
    with _graphed():
        got_loss, got = g._port_grads(loss, g._probe(tables))
    assert torch.equal(got_loss, want_loss)
    for k in PARAMS:
        assert torch.equal(got[k], want[k]), k


def test_traversal_steps_and_calls_unchanged():
    """trace(differentiable=True, return_stats=True) through the BVH (height
    field, 5 bounces): the GraphedTrip route reports the checkpoint route's
    "traversal_steps" and rays, and calls the traversal as often, 2 a trip
    forward and 2 in the backward's recompute. The trip's Python step runs
    once a trip forward (the first eagerly, for the capture on the card) and
    once a trip backward."""
    g, gs = _helpers()
    ts, tables, cbvh = g._port("height_field", "bvh")
    px, py, si, w = g._inputs(0)
    r = tcam.generate_rays(ts.cameras[0], torch.as_tensor(px), torch.as_tensor(py),
                           torch.as_tensor(si), 0, torch.float64)

    def run(graphs):
        leaves = {k: v.detach().clone().requires_grad_() for k, v in g._probe(tables).items()}
        t = tables._replace(**leaves)
        with mock.patch.object(tk, "traverse", wraps=tk.traverse) as trav:
            rad, stats = tpt.trace(t, ts.meta(), tpt.PTConfig(max_bounces=g.BOUNCES), r.origin,
                                   r.direction, r.pixel_index, r.sample_index,
                                   intersect_fn=tcb.make_intersect_fn(t, ts.meta(), cbvh),
                                   return_stats=True, differentiable=True, graphs=graphs)
            forward = trav.call_count
            torch.autograd.grad((rad * torch.as_tensor(w)).sum(), list(leaves.values()))
        return stats, forward, trav.call_count - forward

    want = run(None)
    with _graphed():
        graphs = {}
        got = run(graphs)
    assert "traversal_steps" in got[0] and torch.equal(got[0]["traversal_steps"],
                                                      want[0]["traversal_steps"])
    assert int(got[0]["rays"]) == int(want[0]["rays"])
    assert got[1:] == want[1:] == (2 * g.BOUNCES, 2 * g.BOUNCES)
    (trip,) = graphs.values()
    assert trip.step_calls == 2 * g.BOUNCES
    assert trip.graphs == () and trip.per_replay == ([], [])


def test_key_separates_shapes_and_gradients():
    """A `graphs` dict keeps one trip per shape and per set of leaves that
    require grad: another lane count, or a call under no_grad (whose packs
    need no gradient), gets its own trip; the same call again reuses one."""
    g, gs = _helpers()
    ts, tables, cbvh = g._port("height_field", "bvh")
    params = g._probe(tables)
    with _graphed():
        graphs = {}
        for lanes in (32, 32, 16):
            leaves = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
            t = tables._replace(**leaves)
            tpt.trace_streamed(t, ts.meta(), tpt.PTConfig(max_bounces=g.BOUNCES), ts.cameras[0],
                               gs.SPP, 0, g.W * g.W * gs.SPP, lanes,
                               intersect_fn=tcb.make_intersect_fn(t, ts.meta(), cbvh),
                               fixed_trips=2, graphs=graphs)
        assert len(graphs) == 2
        with torch.no_grad():
            gs._streamed_loss_port(ts, tables, cbvh, params, True, trips=2, graphs=graphs)
        assert len(graphs) == 3


@pytest.mark.cuda
def test_graphed_trips_match_eager_on_card():
    """On the card (height field n=32, 32x32, 4 spp, float32, 4096 paths
    through 512 lanes, 16 trips): two bench.bwd_chunk-style calls through one
    `graphs` dict, the first capturing the trip and the second replaying it,
    against the eager checkpoint route on the same inputs. Loss rtol 1e-5;
    gradients within 1e-4 of each table's largest |g|; rays traced equal;
    the traversal counted at 2 launches a trip forward and 2 in the
    backward both ways; the Python step not called after the capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (CUDA graphs and the kernel have no CPU mode); "
                    "chip_smoke.py runs it")
    import mcrt_tpu_torch as mt
    from mcrt_tpu_torch.scene.synthetic import height_field_scene

    s = mt.Scene(height_field_scene(32, 32, 2))
    cam, meta = s.cameras[0], s.meta()
    tables = s.tables(np.float32, "cuda")
    cbvh = s.build_cluster_bvh(np.float32, "cuda")
    n, lanes, trips = 4096, 512, 16

    def chunk(graphs, start):
        leaves = {k: getattr(tables, k).detach().clone().requires_grad_() for k in PARAMS}
        t = tables._replace(**leaves)
        torch.cuda.synchronize()
        before = tk.kernel.launches
        out, rays = tpt.trace_streamed(t, meta, tpt.PTConfig(), cam, 4, start, n, lanes,
                                       intersect_fn=tcb.make_intersect_fn(t, meta, cbvh),
                                       fixed_trips=trips, graphs=graphs)
        loss = (out.view(-1, 4, 3).mean(dim=1) ** 2).mean()
        torch.cuda.synchronize()
        mid = tk.kernel.launches
        grads = torch.autograd.grad(loss, list(leaves.values()))
        torch.cuda.synchronize()
        return loss.detach(), int(rays), dict(zip(PARAMS, grads)), (mid - before,
                                                                   tk.kernel.launches - mid)

    graphs = {}
    for start in (16 * 32 * 4, 24 * 32 * 4):
        got = chunk(graphs, start)
        with _graphed(False):
            want = chunk(None, start)
        (trip,) = graphs.values()
        assert trip.step_calls == 3 and len(trip.graphs) == 2 and trip.pool_bytes > 0
        torch.testing.assert_close(got[0], want[0], rtol=1e-5, atol=0.0)
        assert got[1] == want[1] and got[3] == want[3] == (2 * trips, 2 * trips)
        for k in PARAMS:
            bar = 1e-4 * float(want[2][k].abs().max())
            assert float((got[2][k] - want[2][k]).abs().max()) <= bar, k
        assert float(want[2]["mat_reflectance"].abs().max()) > 0.0
