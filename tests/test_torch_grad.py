"""Material gradients of the port's differentiable path tracer against the JAX
package's, and against finite differences of the port itself; the film's
splat and scan under autograd.

float64 on the CPU; in-repo scenes only: `caustic_sphere.json` (a glass sphere
over a diffuse floor, a sphere light) and the inline height field
(`height_field_scene(6, 8, 1)`: diffuse, GGX and glass surfaces, a sphere
light), at 8x8. Pixels, sample indices, loss weights and targets are made
from a seed with numpy and handed to both packages. The parameters sit at a
probe point: transparency 0.5 where the scene has a transparent material
(T = 1 is a stationary point of the layered mix, tests/test_grad.py).

Each test's docstring states its bar. "Of the table's largest |g|": the
largest difference in a table is at most that fraction of the JAX package's
largest |gradient| in the same table. A table whose gradient is zero up to
rounding (the caustic scene's transparency: a smooth dielectric's f/pdf does
not depend on T) is held to 1e-12 of the largest |g| over the four tables.

The differentiable wavefront (trace_streamed(fixed_trips=...)) is held to the
JAX package's in tests/test_torch_grad_streamed.py, and the train step in
tests/test_torch_train_step.py: tracing and compiling one differentiable JAX
program takes about 35 s on a CPU core, so the six of them are spread over
three files that the test workers can run side by side."""
import functools
import json
import pathlib

import numpy as np
import pytest
import torch

import mcrt_tpu_torch as mt
from mcrt_tpu_torch.camera import camera as tcam
from mcrt_tpu_torch.camera import film as tfilm
from mcrt_tpu_torch.integrator import path_tracer as tpt
from mcrt_tpu_torch.ops import cluster_bvh as tcb
from mcrt_tpu_torch.parallel import sharding as tsh
from mcrt_tpu_torch.scene.synthetic import height_field_scene

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from mcrt_tpu.camera import camera as jcam  # noqa: E402
from mcrt_tpu.camera import film as jfilm  # noqa: E402
from mcrt_tpu.integrator import path_tracer as jpt  # noqa: E402
from mcrt_tpu.ops import cluster_bvh as jcb  # noqa: E402
from mcrt_tpu.scene.loader import Scene as JScene  # noqa: E402

torch.set_num_threads(1)  # pytest-xdist runs several workers on the same cores

SCENES = pathlib.Path(__file__).parent / "scenes"
W = 8
PARAMS = tsh.DEFAULT_TRAIN_PARAMS
BOUNCES = 5
REL = 1e-9          # the JAX-parity bar, of each table's largest |g|


def _caustic():
    j = json.loads((SCENES / "caustic_sphere.json").read_text())
    j["cameras"][0]["image"] = {"width": W, "height": W, "plain": True}
    return j


SCENE_JSON = {"caustic_sphere": _caustic, "height_field": lambda: height_field_scene(6, W, 1)}


@functools.lru_cache(maxsize=None)
def _scenes(name):
    j = SCENE_JSON[name]()
    return mt.Scene(j), JScene(j)


def _probe(tables):
    """The four tables at the probe point (transparency 0.5 where nonzero)."""
    p = {k: getattr(tables, k) for k in PARAMS}
    t = p["mat_transparency"]
    if isinstance(t, torch.Tensor):
        p["mat_transparency"] = torch.where(t > 0, torch.full_like(t, 0.5), t)
    else:
        p["mat_transparency"] = jnp.where(t > 0, 0.5, t)
    return p


def _inputs(seed, n=W * W):
    """Every pixel once, sample indices and per-path loss weights from `seed`."""
    rng = np.random.default_rng(seed)
    lin = np.arange(n)
    return lin % W, lin // W, rng.integers(0, 16, n), rng.random((n, 3))


def _port(name, route):
    ts, _ = _scenes(name)
    tables = ts.tables(np.float64, "cpu")
    cbvh = ts.build_cluster_bvh(np.float64, "cpu") if route == "bvh" else None
    return ts, tables, cbvh


def _port_trace_loss(ts, tables, cbvh, params, seed=0, **kw):
    """sum(w * radiance) of trace(differentiable=True) at the tables replaced
    by `params`."""
    px, py, si, w = _inputs(seed)
    t = tables._replace(**params)
    ifn = tcb.make_intersect_fn(t, ts.meta(), cbvh) if cbvh is not None else None
    r = tcam.generate_rays(ts.cameras[0], torch.as_tensor(px), torch.as_tensor(py),
                           torch.as_tensor(si), 0, torch.float64)
    rad = tpt.trace(t, ts.meta(), tpt.PTConfig(max_bounces=BOUNCES), r.origin, r.direction,
                    r.pixel_index, r.sample_index, intersect_fn=ifn, differentiable=True, **kw)
    return (rad * torch.as_tensor(w)).sum()


def _port_grads(loss_fn, params):
    leaves = {k: v.detach().clone().requires_grad_() for k, v in params.items()}
    loss = loss_fn(leaves)
    return loss.detach(), dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))


def _assert_tables_close(got, want, rel=REL):
    floor = 1e-12 * max(float(np.abs(np.asarray(want[k])).max()) for k in PARAMS)
    for k in PARAMS:
        a, b = got[k].numpy(), np.asarray(want[k])
        assert np.isfinite(a).all(), k
        bar = max(rel * np.abs(b).max(), floor)
        assert np.abs(a - b).max() <= bar, (k, np.abs(a - b).max(), np.abs(b).max())


# ---------------------------------------------------------------------------------
# (a) trace(differentiable=True) against jax.grad of the JAX package's
# ---------------------------------------------------------------------------------

@pytest.mark.parametrize("name, route", [("caustic_sphere", "brute"), ("height_field", "bvh")])
def test_trace_grads_match_jax(name, route):
    """Per-table gradients of sum(w * radiance) through trace(differentiable=True),
    max_bounces 5, on the brute-force route and on the BVH route (the port's
    plain traversal against the JAX package's best-first), against jax.grad of
    the JAX package's (the height field by brute force goes through the train
    step's test). Bar: 1e-9 of each table's largest |g|; the loss within
    1e-12 relative. Every table has a gradient above rounding but the caustic
    scene's roughness (it has no rough specular surface) and transparency."""
    ts, tables, cbvh = _port(name, route)
    _, js = _scenes(name)
    jt = js.tables(jnp.float64)
    jb = js.build_cluster_bvh(np.float64) if route == "bvh" else None
    px, py, si, w = _inputs(0)
    jr = jcam.generate_rays(js.cameras[0], px, py, si, jt.ior, 0, jnp.float64)

    def jloss(params):
        t = jt._replace(**params)
        ifn = jcb.make_intersect_fn(t, js.meta(), jb) if jb is not None else None
        rad = jpt.trace(t, js.meta(), jpt.PTConfig(max_bounces=BOUNCES), jr.origin, jr.direction,
                        jr.pixel_index, jr.sample_index, intersect_fn=ifn, differentiable=True)
        return jnp.sum(rad * w)

    want_loss, want = jax.jit(jax.value_and_grad(jloss))(_probe(jt))
    loss, got = _port_grads(lambda p: _port_trace_loss(ts, tables, cbvh, p), _probe(tables))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-12)
    _assert_tables_close(got, want)
    top = max(float(got[k].abs().max()) for k in PARAMS)
    for k in PARAMS:
        if name == "height_field" or k in ("mat_reflectance", "mat_ior"):
            assert float(got[k].abs().max()) > 1e-6 * top, k


def test_float32_grads_are_finite():
    """float32, the card's type: the four tables' gradients through the train
    step are finite on the height field at n=40, 24x24, max_bounces 8, through
    the BVH. Without the double-where guard in bsdf.fresnel_dielectric (the
    sqrt of g2 == 0 on a material whose ior is the -1 of "none"), mat_ior's
    first row is NaN here, as it is in the JAX package (ROADMAP.md section 3)."""
    w, bounces = 24, 8
    ts = mt.Scene(height_field_scene(40, w, 1))
    cam = ts.cameras[0]
    tables = ts.tables(np.float32, "cpu")
    step = tsh.train_step(ts.meta(), tpt.PTConfig(max_bounces=bounces), cam,
                          tfilm.FilmConfig.from_json(w, w, cam.film), torch.float32,
                          with_bvh=True, device="cpu")
    lin = torch.arange(w * w)
    target = torch.as_tensor(np.random.default_rng(5).random((w, w, 3)), dtype=torch.float32)
    loss, grads = step(tables, ts.build_cluster_bvh(np.float32, "cpu"),
                       {k: getattr(tables, k) for k in PARAMS}, lin % w, lin // w,
                       torch.zeros_like(lin), target)
    assert torch.isfinite(loss)
    for k, g in grads.items():
        assert torch.isfinite(g).all(), k
    assert float(grads["mat_ior"].abs().max()) > 0.0


# ---------------------------------------------------------------------------------
# The film: splat and scan as they are
# ---------------------------------------------------------------------------------

@pytest.mark.parametrize("filter_name", ["box", "gaussian"])
def test_film_splat_scan_grad_matches_jax(filter_name):
    """film.splat (an index_add_ into a fresh buffer) then film.scan is
    differentiable as it is: the gradient of sum(w * image) with respect to
    the sample values equals the JAX package's within 1e-12 of its largest
    |g|, and the image within 1e-12."""
    rng = np.random.default_rng(4)
    n = 200
    px = rng.uniform(-0.5, W + 0.5, (n, 2))
    val = rng.random((n, 3))
    w = rng.random((W, W, 3))
    radius = tfilm.DEFAULT_RADII[filter_name]
    cfg_t = tfilm.FilmConfig(W, W, filter_name, radius)
    cfg_j = jfilm.FilmConfig(W, W, filter_name, radius)
    f = lambda v: jnp.sum(jfilm.scan(jfilm.splat(cfg_j, jnp.asarray(px), v)) * w)
    want_img = jfilm.scan(jfilm.splat(cfg_j, jnp.asarray(px), jnp.asarray(val)))
    want = np.asarray(jax.grad(f)(jnp.asarray(val)))
    v = torch.as_tensor(val).requires_grad_()
    img = tfilm.scan(tfilm.splat(cfg_t, torch.as_tensor(px), v))
    (g,) = torch.autograd.grad((img * torch.as_tensor(w)).sum(), [v])
    np.testing.assert_allclose(img.detach().numpy(), np.asarray(want_img), rtol=0, atol=1e-12)
    assert np.abs(g.numpy() - want).max() <= 1e-12 * np.abs(want).max() and np.abs(want).max() > 0


# ---------------------------------------------------------------------------------
# (d) central finite differences of the port alone
# ---------------------------------------------------------------------------------

def _fd_check(f, x0, g, eps_list=(1e-5, 5e-6), rtol=5e-3):
    """The AD gradient `g` against central differences at the largest-|g|
    coordinates, skipping a coordinate whose two stencils disagree by more
    than 5% (an event flipped inside the stencil), as tests/test_grad.py."""
    flat = g.reshape(-1)
    for k in np.argsort(-np.abs(flat))[:4]:
        if flat[k] == 0.0:
            continue
        fds = []
        for eps in eps_list:
            e = np.zeros(flat.shape)
            e[k] = eps
            e = torch.as_tensor(e.reshape(x0.shape))
            fds.append((float(f(x0 + e)) - float(f(x0 - e))) / (2 * eps))
        if abs(fds[0] - fds[1]) > 0.05 * max(abs(fds[0]), 1e-9):
            continue
        assert abs(fds[0] - flat[k]) / max(abs(fds[0]), 1e-12) < rtol, (k, fds, flat[k])
        return
    pytest.fail("no stable finite-difference coordinate (every stencil flips an event)")


@pytest.mark.parametrize("param", PARAMS)
def test_grad_matches_finite_differences(param):
    """Each of the four tables' gradient through trace(differentiable=True) on
    the height field (brute force) against central differences of the same
    estimator at the same samples: relative error under 5e-3 at the largest
    |g| coordinate whose two stencils (1e-5, 5e-6) agree within 5%."""
    ts, tables, _ = _port("height_field", "brute")
    params = _probe(tables)
    _, g = _port_grads(lambda p: _port_trace_loss(ts, tables, None, p), params)
    g = g[param].numpy()
    assert np.isfinite(g).all() and (g != 0).any()
    with torch.no_grad():
        f = lambda x: _port_trace_loss(ts, tables, None, {**params, param: x})
        _fd_check(f, params[param], g)


def test_emission_scale_grad_equals_value():
    """Radiance is affine in emission: with the BSDF-sampled and the NEE copies
    of it (surf_radiosity, light_radiosity) scaled by s, the weighted image
    sum is f(s) = f(0) + s (f(1) - f(0)), f(0) being the sky's share. So the
    gradient at s = 1 equals f(1) - f(0) within 1e-9 relative, and central
    differences within 1e-6 (tests/test_grad.py, whose closed room has no sky,
    compares it with f(1)). Height field, through the BVH."""
    ts, tables, cbvh = _port("height_field", "bvh")

    def f(scale):
        t = tables._replace(surf_radiosity=tables.surf_radiosity * scale,
                            light_radiosity=tables.light_radiosity * scale)
        return _port_trace_loss(ts, t, cbvh, {})

    s = torch.ones((), dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(f(s), [s])
    one = lambda x: torch.tensor(x, dtype=torch.float64)
    with torch.no_grad():
        f1, f0 = float(f(one(1.0))), float(f(one(0.0)))
        eps = 1e-4
        fd = (float(f(one(1.0 + eps))) - float(f(one(1.0 - eps)))) / (2 * eps)
    assert float(g) > 0.0 and f0 > 0.0
    np.testing.assert_allclose(float(g), f1 - f0, rtol=1e-9)
    assert abs(fd - float(g)) / abs(fd) < 1e-6
