"""The port's train step against the JAX package's sharded_train_step on a
one-device mesh.

float64 on the CPU, at 8x8 and one sample per pixel, with the scenes, probe
point and bars of tests/test_torch_grad.py, whose docstring defines the bars'
terms."""
import numpy as np
import pytest
import torch

from mcrt_tpu_torch.camera import film as tfilm
from mcrt_tpu_torch.integrator import path_tracer as tpt
from mcrt_tpu_torch.parallel import sharding as tsh
from test_torch_grad import BOUNCES, PARAMS, W, _assert_tables_close, _inputs, _port, _probe, _scenes

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from mcrt_tpu.camera import film as jfilm  # noqa: E402
from mcrt_tpu.integrator import path_tracer as jpt  # noqa: E402
from mcrt_tpu.parallel import sharding as jsh  # noqa: E402

torch.set_num_threads(1)  # pytest-xdist runs several workers on the same cores


@pytest.mark.parametrize("with_bvh", [False, True], ids=["brute", "bvh"])
def test_train_step_matches_sharded(with_bvh):
    """train_step(with_bvh) against the JAX package's sharded_train_step on a
    one-device CPU mesh, on the height field (max_bounces 5, one sample per
    pixel, a random target): the loss within 1e-12 relative, gradients within
    1e-9 of each table's largest |g|. The bare-tensor form gives the dict
    form's reflectance gradient, bit for bit."""
    ts, tables, cbvh = _port("height_field", "bvh" if with_bvh else "brute")
    _, js = _scenes("height_field")
    jt = js.tables(jnp.float64)
    cam = ts.cameras[0]
    px, py, si, _ = _inputs(2)
    target = np.random.default_rng(3).random((W, W, 3)) * 0.5
    film_t = tfilm.FilmConfig.from_json(W, W, cam.film)
    film_j = jfilm.FilmConfig.from_json(W, W, js.cameras[0].film)
    cfg_t, cfg_j = tpt.PTConfig(max_bounces=BOUNCES), jpt.PTConfig(max_bounces=BOUNCES)
    mesh = jsh.make_mesh(jax.devices()[:1])
    jstep = jsh.sharded_train_step(js.meta(), cfg_j, js.cameras[0], film_j, mesh, jnp.float64,
                                   with_bvh=with_bvh)
    u32 = lambda x: jnp.asarray(x, jnp.uint32)
    jargs = (_probe(jt), u32(px), u32(py), u32(si), jnp.asarray(target))
    with mesh:
        if with_bvh:
            want_loss, want = jstep(jt, js.build_cluster_bvh(np.float64), *jargs)
        else:
            want_loss, want = jstep(jt, *jargs)
    step = tsh.train_step(ts.meta(), cfg_t, cam, film_t, torch.float64, with_bvh=with_bvh,
                          device="cpu")
    args = (_probe(tables), torch.as_tensor(px), torch.as_tensor(py), torch.as_tensor(si),
            torch.as_tensor(target))
    loss, got = step(tables, cbvh, *args) if with_bvh else step(tables, *args)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-12)
    _assert_tables_close(got, want)
    assert set(got) == set(PARAMS) and not loss.requires_grad
    bare = _probe(tables)["mat_reflectance"]
    one = (bare,) + args[1:]
    _, g_refl = step(tables, cbvh, *one) if with_bvh else step(tables, *one)
    assert isinstance(g_refl, torch.Tensor)
    # The bare form differentiates reflectance with the other tables at the
    # scene's own values, so compare with a dict of reflectance alone.
    _, g_dict = step(tables, cbvh, {"mat_reflectance": bare}, *args[1:]) if with_bvh else \
        step(tables, {"mat_reflectance": bare}, *args[1:])
    assert torch.equal(g_refl, g_dict["mat_reflectance"])
