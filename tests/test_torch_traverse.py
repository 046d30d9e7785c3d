"""The traversal's plain version (the CUDA kernel's CPU twin) against the JAX
package's Pallas kernel in interpret mode and its XLA best-first traversal,
and the port's intersect closure against the JAX package's.

Bars (those of the JAX package's own kernel test): triangle ids identical,
t within rtol 5e-6, u/v within atol 5e-3 (u/v pick up global-frame rounding and
only seed refine_tri_hit), and per-block [candidates, rounds] equal to the
Pallas kernel's. The kernel itself is held to the plain version on the card by
tests/test_torch_kernel_on_card.py."""
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mcrt_tpu_torch import convert
from mcrt_tpu_torch.camera import camera as tcam
from mcrt_tpu_torch.ops import cluster_bvh as tcb
from mcrt_tpu_torch.ops import traverse_kernel as tk
from mcrt_tpu_torch.scene import loader as tl
from mcrt_tpu_torch.scene.synthetic import height_field_scene
from test_torch_kernel_on_card import grid_mesh, ray_set

jnp = pytest.importorskip("jax.numpy")
from mcrt_tpu.ops import cluster_bvh as jcb  # noqa: E402
from mcrt_tpu.ops import traverse_kernel as jtk  # noqa: E402
from mcrt_tpu.scene import loader as jl  # noqa: E402

torch.set_num_threads(1)  # pytest-xdist runs several workers on the same cores


@functools.lru_cache(maxsize=None)
def _grid_bvhs(n):
    """A 2 n^2-triangle displaced grid's fat-leaf BVH in both packages' forms."""
    (v0, e1, e2), flat = grid_mesh(n)
    jb = jcb.upload_cluster_bvh(flat, SimpleNamespace(tri_v0=v0, tri_e1=e1, tri_e2=e2), np.float32)
    tb = convert.cluster_bvh_from_numpy(flat.bb_min, flat.bb_max, flat.first, flat.count,
                                        flat.prim_order, v0, e1, e2, "cpu", np.float32)
    return jb, tb


@pytest.fixture(scope="module")
def grid():
    """~2k-triangle displaced grid, its fat-leaf BVH in both packages' forms."""
    return _grid_bvhs(32)


def _assert_matches_pallas(jb, tb, o, d):
    """The plain version against the Pallas kernel at this file's bars; returns
    (tri ids, per-block stats)."""
    pt, pid, pu, pv, pst = _pallas(jb, o, d)
    t, tid, u, v, st = (x.numpy() for x in tk.traverse(tb, torch.as_tensor(o), torch.as_tensor(d)))
    np.testing.assert_array_equal(tid, pid)
    hit = pid >= 0
    np.testing.assert_allclose(t[hit], pt[hit], rtol=5e-6)
    np.testing.assert_allclose(u[hit], pu[hit], atol=5e-3)
    np.testing.assert_allclose(v[hit], pv[hit], atol=5e-3)
    np.testing.assert_array_equal(st, pst)
    return tid, st


def _pallas(jb, o, d, block=256):
    """The JAX kernel in interpret mode: per-ray outputs and per-block stats."""
    R = o.shape[0]
    K = min(block, R)
    pad = (-R) % K
    o = np.concatenate([o, np.broadcast_to(o[-1:], (pad, 3))]) if pad else o
    d = np.concatenate([d, np.broadcast_to(d[-1:], (pad, 3))]) if pad else d
    B = o.shape[0] // K
    o3, d3 = jnp.asarray(o).reshape(B, K, 3), jnp.asarray(d).reshape(B, K, 3)
    ft = jnp.concatenate([d3, o3, jnp.cross(d3, o3), jnp.ones((B, K, 1), o3.dtype),
                          jnp.zeros((B, K, 6), o3.dtype)], axis=-1).astype(jnp.float32)
    t, tid, u, v, st = jtk._run(jb.rec, jb.cl_bb, ft, jb.rec.shape[0], True)
    flat = lambda x: np.asarray(x).reshape(-1)[:R]
    return flat(t), flat(tid), flat(u), flat(v), np.asarray(st)[:, 0, :]


@pytest.mark.parametrize("kind", ["camera", "random", "axis", "parked", "mixed"])
def test_plain_matches_pallas_interpret(grid, kind):
    jb, tb = grid
    tid, st = _assert_matches_pallas(jb, tb, *ray_set(kind))
    hit = tid >= 0
    if kind == "parked":
        assert (tid == -1).all() and st[:, 1].max() == 0
    elif kind == "mixed":
        assert (tid[::2] == -1).all() and hit.sum() > 100
    else:
        assert hit.sum() > 100


@pytest.mark.parametrize("n, kind", [(64, "random"), (64, "camera"), (96, "random"), (96, "mixed")])
def test_plain_stats_match_pallas_when_pruning(n, kind):
    """The visit order. The Pallas kernel chooses the next cluster from the
    best t of before the current visit (one round stale), so blocks that prune
    visit other clusters, and run other rounds, than a choice from fresh best t
    would. At n=32 every block visits every cluster and cannot tell the two
    apart; these grids have blocks that prune."""
    jb, tb = _grid_bvhs(n)
    _, st = _assert_matches_pallas(jb, tb, *ray_set(kind, n=1024, seed=3))
    assert (st[:, 1] < st[:, 0]).any(), "no block pruned a candidate"


@pytest.mark.parametrize("kind", ["camera", "random", "axis"])
def test_plain_matches_bestfirst(grid, kind):
    jb, tb = grid
    o, d = ray_set(kind, n=1024, seed=11)
    bt, bid, bu, bv, _ = (np.asarray(x) for x in jcb.traverse_bestfirst(jb, jnp.asarray(o), jnp.asarray(d)))
    t, tid, u, v, _ = (x.numpy() for x in tk.traverse(tb, torch.as_tensor(o), torch.as_tensor(d)))
    np.testing.assert_array_equal(tid, bid)
    hit = bid >= 0
    np.testing.assert_allclose(t[hit], bt[hit], rtol=5e-6)
    np.testing.assert_allclose(u[hit], bu[hit], atol=5e-3)
    np.testing.assert_allclose(v[hit], bv[hit], atol=5e-3)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_intersect_fn_matches_jax(dtype):
    """Port make_intersect_fn (sort, plain traversal, unsort, refine, spheres)
    against the JAX package's (sort, XLA best-first, unsort, refine, spheres):
    all four Hit fields. steps[1] (most rounds) is held to the Pallas kernel run
    on the same sorted rays, the traversal the port's kernel replaces."""
    j = height_field_scene(16, 16, 1)
    ts, js = tl.Scene(j), jl.Scene(j)
    tt = ts.tables(np.dtype(dtype), "cpu")
    jt = js.tables(jnp.dtype(dtype))
    tb = ts.build_cluster_bvh(np.dtype(dtype), "cpu")
    jb = js.build_cluster_bvh(np.dtype(dtype))
    cam_t, cam_j = ts.cameras[0], js.cameras[0]
    rng = np.random.default_rng(2)
    n = 512
    px, py = rng.integers(0, 16, n), rng.integers(0, 16, n)
    rays = tcam.generate_rays(cam_t, torch.as_tensor(px), torch.as_tensor(py),
                              torch.zeros(n, dtype=torch.int64), 0, getattr(torch, dtype))
    # Half camera rays, half rays leaving the scene's geometry in random directions.
    o = rays.origin.numpy().copy()
    d = rays.direction.numpy().copy()
    o[n // 2:] = np.concatenate([rng.uniform(0, 10, (n // 2, 1)), rng.uniform(0.6, 3, (n // 2, 1)),
                                 rng.uniform(0, 10, (n // 2, 1))], 1)
    dd = rng.normal(size=(n // 2, 3))
    d[n // 2:] = dd / np.linalg.norm(dd, axis=1, keepdims=True)
    got = tcb.make_intersect_fn(tt, ts.meta(), tb)(torch.as_tensor(o), torch.as_tensor(d))
    want = jcb.make_intersect_fn(jt, js.meta(), jb)(jnp.asarray(o), jnp.asarray(d))
    np.testing.assert_array_equal(got.surf_id.numpy(), np.asarray(want.surf_id))
    hit = np.asarray(want.surf_id) >= 0
    assert hit.sum() > n // 4
    rtol = 1e-12 if dtype == "float64" else 1e-6
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit], rtol=rtol)
    np.testing.assert_allclose(got.uv.numpy()[hit], np.asarray(want.uv)[hit], rtol=rtol, atol=rtol)
    assert int(got.steps[0]) == int(want.steps[0])          # candidates summed over blocks
    if dtype == "float32":
        key = jcb.coherence_key(jnp.asarray(o), jnp.asarray(d), jb.bb_min[0], jb.bb_max[0])
        np.testing.assert_array_equal(
            tcb.coherence_key(torch.as_tensor(o), torch.as_tensor(d), tb.bb_lo, tb.bb_hi).numpy(),
            np.asarray(key))
        perm = np.asarray(jnp.argsort(key))
        *_, pst = _pallas(jb, o[perm], d[perm])
        assert int(got.steps[1]) == int(pst[:, 1].max())
