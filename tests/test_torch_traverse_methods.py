"""The JAX package's best-first traversal in the port, `make_intersect_fn`'s
two routes and orders, and the helpers that came with them (`surface_normal`,
`shading_normal`, `scene_bounds`, `PTConfig.sky`), each against its JAX
counterpart on the CPU; then the route rule, `traverse`'s dispatch on the
table format, the BVH upload that carries the best-first tables, and the
loops that run a step eagerly when its intersect cannot be captured.

Inputs are made from numpy seeds and handed to both packages; the cluster
tables come from the JAX package's ClusterBVH through convert.py, or from the
same flat BVH through each package's own builder.

Bars:
- best-first in float64: triangle ids identical, t, u and v within rtol
  1e-10, stats equal as integers (both packages round the forms to float32,
  as the JAX package's einsum does);
- best-first in float32, whose row gathers the JAX package takes by an
  exact one-hot product: ids and stats identical, t, u and v within rtol
  1e-6;
- intersect closures: the bars of
  tests/test_torch_traverse.py::test_intersect_fn_matches_jax (ids identical,
  t and uv within rtol 1e-12 in float64, 1e-6 in float32), steps equal;
- radiance: |port - JAX| <= 1e-8 on at least 99.5% of paths, the bar of
  tests/test_torch_path_tracer.py.
"""
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import mcrt_tpu_torch as mt
from mcrt_tpu_torch import convert
from mcrt_tpu_torch.accel.bvh_build import build_bvh
from mcrt_tpu_torch.camera import camera as tcam
from mcrt_tpu_torch.camera import film as tfilm
from mcrt_tpu_torch.integrator import path_tracer as tpt
from mcrt_tpu_torch.ops import cluster_bvh as tcb
from mcrt_tpu_torch.ops import intersect as tisect
from mcrt_tpu_torch.ops import traverse_kernel as tk
from mcrt_tpu_torch.parallel import distributed as tdist
from mcrt_tpu_torch.parallel import sharding as tsh
from mcrt_tpu_torch.scene.synthetic import height_field_scene, make_displaced_grid
from mcrt_tpu_torch.utils import cuda_graph

jnp = pytest.importorskip("jax.numpy")
from mcrt_tpu.camera import camera as jcam  # noqa: E402
from mcrt_tpu.integrator import path_tracer as jpt  # noqa: E402
from mcrt_tpu.ops import cluster_bvh as jcb  # noqa: E402
from mcrt_tpu.ops import intersect as jisect  # noqa: E402
from mcrt_tpu.ops import traverse_kernel as jtk  # noqa: E402
from mcrt_tpu.scene.loader import Scene as JScene  # noqa: E402

torch.set_num_threads(1)  # pytest-xdist runs several workers on the same cores

TREE_FIELDS = ("feat", "tri_id", "center", "cl_bb_min", "cl_bb_max")
PARK = 2e30


def _random_tris(n, seed=0, spread=10.0):
    """tests/test_bvh.py::_random_tris: (v0, e1, e2) of n random triangles."""
    rng = np.random.RandomState(seed)
    return rng.randn(n, 3) * spread, rng.randn(n, 3), rng.randn(n, 3)


@functools.lru_cache(maxsize=None)
def _meshes(n, seed, leaf, dtype, grid=False):
    """A random mesh's fat-leaf flat BVH (the port's builder) and the JAX
    package's ClusterBVH over it; with `grid`, two n x n displaced grids,
    the second 2 below the first, which it hides from rays from above."""
    if grid:
        v0, e1, e2 = make_displaced_grid(n)
        v0, e1, e2 = np.concatenate([v0, v0 - [0.0, 0.0, 2.0]]), np.tile(e1, (2, 1)), np.tile(e2, (2, 1))
    else:
        v0, e1, e2 = _random_tris(n, seed)
    mins = np.minimum(np.minimum(v0, v0 + e1), v0 + e2)
    maxs = np.maximum(np.maximum(v0, v0 + e1), v0 + e2)
    flat = build_bvh(mins, maxs, kind="binary_sah", max_leaf=leaf, strict_leaf=True, dtype=dtype)
    sc = SimpleNamespace(tri_v0=v0, tri_e1=e1, tri_e2=e2)
    return flat, sc, jcb.upload_cluster_bvh(flat, sc, dtype)


def _tree_from_jax(jb, dtype):
    return convert.cluster_tree_from_numpy(**{k: np.asarray(getattr(jb, k)) for k in TREE_FIELDS},
                                           device="cpu", dtype=dtype)


def _rays(n, seed, dtype, parked=0, axis=0):
    """n rays from origins spread over the mesh with unit directions, the
    last `axis` of them along -z (infinite inv_d components) and `parked`
    of them parked at 2e30, shuffled so that blocks mix them."""
    rng = np.random.RandomState(seed)
    o = rng.randn(n, 3) * 20
    d = rng.randn(n, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    if axis:
        d[n - axis - parked:n - parked] = [0.0, 0.0, -1.0]
    if parked:
        o[n - parked:], d[n - parked:] = PARK, 0.57735026
    mix = rng.permutation(n)
    return o[mix].astype(dtype), d[mix].astype(dtype)


def _grid_rays(n, seed, dtype):
    """n rays from above the two grids pointing down, every one of them
    hitting the upper one, lanes in raster order over [1, 9]^2 (so a block
    covers a strip), every other lane parked: a block stops before the
    hidden grid's clusters only if its parked lanes are left out of the
    pruning demand."""
    rng = np.random.RandomState(seed)
    i = np.arange(n) // 2
    side = int(np.sqrt(n // 2))
    o = np.stack([1.0 + 8.0 * (i % side) / side, 1.0 + 8.0 * (i // side) / side,
                  np.full(n, 3.0)], 1)
    d = np.concatenate([rng.uniform(-0.05, 0.05, (n, 2)), -np.ones((n, 1))], 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o[::2], d[::2] = PARK, 0.57735026
    return o.astype(dtype), d.astype(dtype)


def _assert_hits(got, want, rtol, stats=True):
    ids = np.asarray(want[1])
    np.testing.assert_array_equal(got[1].numpy(), ids)
    hit = ids >= 0
    assert hit.sum() > 10
    for i in (0, 2, 3):
        np.testing.assert_allclose(got[i].numpy()[hit], np.asarray(want[i])[hit], rtol=rtol)
    if stats:
        np.testing.assert_array_equal(got[4].numpy(), np.asarray(want[4]))


# ---------------------------------------------------------------------------------
# (a) best-first, on identical tables
# ---------------------------------------------------------------------------------

# (triangles or grid size, seed, fat-leaf size, block, rays): a short last
# block, parked lanes mixed into live blocks, axis-aligned rays; on the grid
# every live ray hits, so the parked lanes decide when a block stops.
MESHES = {"tris900": (900, 11, 32, 64, 512), "tris2000": (2000, 4, 64, 256, 700),
          "grid24_parked": (24, 3, 32, 128, 512)}


def _mesh_rays(mesh, dtype):
    n, seed, leaf, block, R = MESHES[mesh]
    if mesh.startswith("grid"):
        return _grid_rays(R, seed, dtype)
    return _rays(R, seed + 1, dtype, parked=64, axis=16)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_formulation_matches_jax_float64(mesh):
    """traverse_bestfirst against the JAX package's on identical float64
    tables (convert.cluster_tree_from_numpy of its ClusterBVH): hits and
    stats ([candidates, rounds]). A block that holds parked lanes still
    stops."""
    n, seed, leaf, block, _ = MESHES[mesh]
    _, _, jb = _meshes(n, seed, leaf, np.float64, mesh.startswith("grid"))
    tree = _tree_from_jax(jb, np.float64)
    o, d = _mesh_rays(mesh, np.float64)
    want = jcb.traverse(jb, jnp.asarray(o), jnp.asarray(d), block=block, method="bestfirst")
    got = tcb.traverse_bestfirst(tree, torch.as_tensor(o), torch.as_tensor(d), block=block)
    _assert_hits(got, want, 1e-10)
    assert got[0].dtype == torch.float64 and got[4].dtype == torch.int64


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_bestfirst_float32_rows_match_jax_onehot(mesh):
    """Best-first in float32 over the port's own upload_cluster_tree of the
    flat BVH, which gathers rows, against the JAX package's best-first over
    its upload of the same flat BVH, which gathers by its exact bf16 one-hot
    product (under 2048 clusters): the tables equal bit for bit, the hits
    and stats at the float32 bars."""
    n, seed, leaf, block, _ = MESHES[mesh]
    flat, sc, jb = _meshes(n, seed, leaf, np.float32, mesh.startswith("grid"))
    assert jb.val0 is not None                     # the JAX side takes the one-hot gather
    tree = tcb.upload_cluster_tree(flat, sc, np.float32, "cpu")
    for name in TREE_FIELDS:
        np.testing.assert_array_equal(getattr(tree, name).numpy(), np.asarray(getattr(jb, name)),
                                      err_msg=name)
    o, d = _mesh_rays(mesh, np.float32)
    want = jcb.traverse(jb, jnp.asarray(o), jnp.asarray(d), block=block, method="bestfirst")
    got = tcb.traverse_bestfirst(tree, torch.as_tensor(o), torch.as_tensor(d), block=block)
    _assert_hits(got, want, 1e-6)
    assert got[0].dtype == torch.float32


@pytest.mark.parametrize("group", [1, 3, 8])
def test_bestfirst_group_matches_jax(group):
    """The best-first rounds at G = 1, 3 (a candidate list padded to a
    multiple of G) and 8 clusters a round, float64, against the JAX
    package's: hits identical, and rounds = ceil(visited / G) as its."""
    _, _, jb = _meshes(900, 11, 32, np.float64)
    tree = _tree_from_jax(jb, np.float64)
    o, d = _rays(512, 5, np.float64, parked=32)
    want = jcb.traverse(jb, jnp.asarray(o), jnp.asarray(d), block=128, method="bestfirst",
                        group=group)
    got = tcb.traverse_bestfirst(tree, torch.as_tensor(o), torch.as_tensor(d), block=128,
                                 group=group)
    _assert_hits(got, want, 1e-10)


# ---------------------------------------------------------------------------------
# (b) the helpers that came with them
# ---------------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _normal_scenes():
    """The height field with its ground smooth (interpolated normals) and a
    quadric ellipsoid, in both packages, float64 tables."""
    j = height_field_scene(6, 8, 1)
    j["surfaces"][0]["smooth"] = True
    j["surfaces"].append({"type": "quadric", "material": "glass", "XX": 1.0, "YY": 2.0, "ZZ": 1.0,
                          "R": -0.25, "bound_dimensions": 1.5, "position": [2.0, 1.0, 2.0]})
    ts, js = mt.Scene(j), JScene(j)
    return ts, js, ts.tables(np.float64, "cpu"), js.tables(jnp.float64)


@pytest.mark.parametrize("name", ["surface_normal", "shading_normal", "scene_bounds"])
def test_helper_matches_jax(name):
    """intersect.surface_normal and shading_normal (over triangles with and
    without interpolated normals, spheres and a quadric) and
    path_tracer.scene_bounds against the JAX functions, float64: within rtol
    1e-12 (exact for the bounds)."""
    rng = np.random.default_rng(7)
    ts, js, tt, jt = _normal_scenes()
    meta, jmeta = ts.meta(), js.meta()
    assert (meta.n_tris, meta.n_sphs, meta.n_quads) == (jmeta.n_tris, jmeta.n_sphs, jmeta.n_quads)
    assert meta.n_quads == 1 and bool(ts.tri_interp.any())
    if name == "scene_bounds":
        for a, b in zip(tpt.scene_bounds(tt, meta), jpt.scene_bounds(jt, jmeta)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        return
    n = 256
    sid = rng.integers(-1, meta.quad_offset + meta.n_quads, n).astype(np.int32)
    pos = rng.uniform(0.0, 10.0, (n, 3))
    uv = rng.uniform(0.0, 0.5, (n, 2))
    dd = rng.normal(size=(n, 3))
    dd /= np.linalg.norm(dd, axis=1, keepdims=True)
    t = lambda x: torch.as_tensor(np.array(x))
    geom_j = jisect.surface_normal(jt, jmeta, sid, pos)
    geom_t = tisect.surface_normal(tt, meta, t(sid), t(pos))
    if name == "surface_normal":
        np.testing.assert_allclose(geom_t.numpy(), np.asarray(geom_j), rtol=1e-12, atol=1e-15)
        return
    want = jisect.shading_normal(jt, jmeta, sid, uv, geom_j, dd)
    got = tisect.shading_normal(tt, meta, t(sid), t(uv), t(np.asarray(geom_j)), t(dd))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-15)
    assert not np.allclose(np.asarray(want), np.asarray(geom_j))   # some normals interpolate


# ---------------------------------------------------------------------------------
# (c) make_intersect_fn's routes and order
# ---------------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _hf_scenes(n=24, width=16):
    j = height_field_scene(n, width, 1)
    return mt.Scene(j), JScene(j)


def _pallas_interpret(cbvh, origin, direction, block=256, method=None, group=8):
    """The JAX package's traversal routed to its Pallas kernel in interpret mode."""
    return jtk.traverse_pallas(cbvh, origin, direction, block, interpret=True)


def _scene_rays(ts, n, dtype, seed=2):
    """Half camera rays, half rays leaving points above the field in random
    directions, as numpy."""
    rng = np.random.default_rng(seed)
    w = ts.cameras[0].width
    rays = tcam.generate_rays(ts.cameras[0], torch.as_tensor(rng.integers(0, w, n // 2)),
                              torch.as_tensor(rng.integers(0, w, n // 2)),
                              torch.zeros(n // 2, dtype=torch.int64), 0, getattr(torch, dtype))
    dd = rng.normal(size=(n // 2, 3))
    o = np.concatenate([rays.origin.numpy(),
                        np.stack([rng.uniform(0, 10, n // 2), rng.uniform(0.6, 3, n // 2),
                                  rng.uniform(0, 10, n // 2)], 1)]).astype(dtype)
    d = np.concatenate([rays.direction.numpy(),
                        dd / np.linalg.norm(dd, axis=1, keepdims=True)]).astype(dtype)
    mix = rng.permutation(n)
    return o[mix], d[mix]


def _bvh_taking_bestfirst(scene, dtype, monkeypatch):
    """The scene's ClusterBVH uploaded under the route rule patched to take
    best-first (as float64 tables do on the card): it carries its
    ClusterTree. Uploaded anew, not from the scene's cache."""
    monkeypatch.setattr(tcb, "takes_bestfirst", lambda device, dtype: True)
    return tcb.upload_cluster_bvh(scene.build_flat_bvh(dtype), scene, dtype, "cpu")


@pytest.mark.parametrize("sort_rays", [True, False])
@pytest.mark.parametrize("method", ["bestfirst", "kernel"])
def test_intersect_fn_method_matches_jax(method, sort_rays, monkeypatch):
    """make_intersect_fn(sort_rays=s) against the JAX package's closure with
    the same order and method, on the inline height field's "bvh" block
    (1152 triangles), 512 rays: all four Hit fields and steps. Best-first in
    float64, reached through a BVH that carries its tree; the kernel route
    (the plain version here) in float32 against the Pallas kernel in
    interpret mode, which takes float32 tables only."""
    dtype = "float32" if method == "kernel" else "float64"
    ts, js = _hf_scenes()
    tt, jt = ts.tables(np.dtype(dtype), "cpu"), js.tables(jnp.dtype(dtype))
    tb = (ts.build_cluster_bvh(np.dtype(dtype), "cpu") if method == "kernel"
          else _bvh_taking_bestfirst(ts, np.dtype(dtype), monkeypatch))
    jb = js.build_cluster_bvh(np.dtype(dtype))
    o, d = _scene_rays(ts, 512, dtype)
    fn = tcb.make_intersect_fn(tt, ts.meta(), tb, sort_rays=sort_rays)
    assert (tb.tree is None) == (method == "kernel") == fn.capturable
    got = fn(torch.as_tensor(o), torch.as_tensor(d))
    if method == "kernel":
        monkeypatch.setattr(jcb, "traverse", _pallas_interpret)
    want = jcb.make_intersect_fn(jt, js.meta(), jb, sort_rays=sort_rays,
                                 method="pallas" if method == "kernel" else method)(
        jnp.asarray(o), jnp.asarray(d))
    np.testing.assert_array_equal(got.surf_id.numpy(), np.asarray(want.surf_id))
    hit = np.asarray(want.surf_id) >= 0
    assert hit.sum() > 128
    rtol = 1e-12 if dtype == "float64" else 1e-6
    np.testing.assert_allclose(got.t.numpy()[hit], np.asarray(want.t)[hit], rtol=rtol)
    np.testing.assert_allclose(got.uv.numpy()[hit], np.asarray(want.uv)[hit], rtol=rtol, atol=rtol)
    np.testing.assert_array_equal(got.steps.numpy(), np.asarray(want.steps))


@pytest.mark.parametrize("sky", [False, True])
def test_trace_sky_matches_jax(sky):
    """path_tracer.trace with PTConfig(sky=...) against the JAX package's,
    float64, through both cluster-BVH intersects, 16x16 camera rays, 8
    bounces: radiance at the bar above; without the sky, the paths that
    leave the scene at once add nothing."""
    ts, js = _hf_scenes(6, 16)
    tt, jt = ts.tables(np.float64, "cpu"), js.tables(jnp.float64)
    tfn = tcb.make_intersect_fn(tt, ts.meta(), ts.build_cluster_bvh(np.float64, "cpu"))
    jfn = jcb.make_intersect_fn(jt, js.meta(), js.build_cluster_bvh(np.float64))
    n = 256
    lin = np.random.default_rng(3).permutation(n)
    jr = jcam.generate_rays(js.cameras[0], lin % 16, lin // 16, np.zeros(n, np.int64), jt.ior, 0,
                            jnp.float64)
    o, d = (torch.tensor(np.asarray(x)) for x in (jr.origin, jr.direction))
    pi, si = (torch.tensor(np.asarray(x).astype(np.int64)) for x in (jr.pixel_index, jr.sample_index))
    got = tpt.trace(tt, ts.meta(), tpt.PTConfig(max_bounces=8, sky=sky), o, d, pi, si,
                    intersect_fn=tfn)
    want = jpt.trace(jt, js.meta(), jpt.PTConfig(max_bounces=8, sky=sky), jr.origin, jr.direction,
                     jr.pixel_index, jr.sample_index, intersect_fn=jfn)
    err = np.abs(got.numpy() - np.asarray(want)).max(axis=-1)
    assert float((err <= 1e-8).mean()) >= 0.995
    first = tfn(o, d)
    if not sky:
        assert bool((first.surf_id < 0).any())
        assert float(got[first.surf_id < 0].abs().max()) == 0.0


# ---------------------------------------------------------------------------------
# (d) the route rule, the dispatch on the table format, and the upload
# ---------------------------------------------------------------------------------

@pytest.mark.parametrize("device,dtype,want", [
    ("cpu", "float32", "kernel"), ("cpu", "float64", "kernel"),
    ("cuda", "float32", "kernel"), ("cuda", "float64", "bestfirst")])
def test_default_method(device, dtype, want):
    """The route rule: tables take the kernel route wherever it runs
    (float32 tables on the card; any dtype on the CPU, through its plain
    version) and best-first, with a ClusterTree, for float64 tables on the
    card, the JAX package's rule (its Pallas kernel takes float32 tables
    only). No card is needed to name one. On the CPU the scene's BVH carries
    no tree and its closure is capturable."""
    assert tcb.takes_bestfirst(torch.device(device), getattr(torch, dtype)) == (want == "bestfirst")
    if device == "cpu":
        ts, _ = _hf_scenes(6, 8)
        cbvh = ts.build_cluster_bvh(np.dtype(dtype), "cpu")
        fn = tcb.make_intersect_fn(ts.tables(np.dtype(dtype), "cpu"), ts.meta(), cbvh)
        assert cbvh.tree is None and fn.capturable


@pytest.mark.parametrize("tables", ["bvh", "tree", "other"])
def test_traverse_dispatches_on_table_type(tables):
    """traverse(tables, o, d): a ClusterBVH runs traverse_kernel.traverse
    (its per-block stats reduced to [candidates summed, most rounds]), a
    ClusterTree runs traverse_bestfirst, each bit for bit; any other object
    raises TypeError."""
    flat, sc, _ = _meshes(900, 11, 32, np.float32)
    o, d = (torch.as_tensor(x) for x in _rays(512, 12, np.float32, parked=32, axis=8))
    if tables == "other":
        with pytest.raises(TypeError):
            tcb.traverse(tuple(tcb.upload_cluster_bvh(flat, sc, np.float32, "cpu")), o, d)
        return
    if tables == "bvh":
        cbvh = tcb.upload_cluster_bvh(flat, sc, np.float32, "cpu")
        got = tcb.traverse(cbvh, o, d)
        *want, st = tk.traverse(cbvh, o, d)
        want.append(torch.stack([st[:, 0].sum(), st[:, 1].max()]).long())
    else:
        tree = tcb.upload_cluster_tree(flat, sc, np.float32, "cpu")
        got, want = tcb.traverse(tree, o, d), tcb.traverse_bestfirst(tree, o, d)
    assert bool((got[1] >= 0).any())
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_upload_carries_tree(dtype, monkeypatch):
    """upload_cluster_bvh: float32 tables carry no tree. Float64 tables,
    under the route rule patched as on the card, carry the ClusterTree that
    upload_cluster_tree builds, and the closure over them keeps it out of its
    `leaves` (no graph's static copy holds it) and in its `key` by identity,
    is not capturable, and rebinds over the same tree."""
    ts, _ = _hf_scenes(6, 8)
    if dtype == "float32":
        cbvh = tcb.upload_cluster_bvh(ts.build_flat_bvh(np.float32), ts, np.float32, "cpu")
        assert cbvh.tree is None
        return
    cbvh = _bvh_taking_bestfirst(ts, np.float64, monkeypatch)
    tree = cbvh.tree
    assert isinstance(tree, tcb.ClusterTree)
    want = tcb.upload_cluster_tree(ts.build_flat_bvh(np.float64), ts, np.float64, "cpu")
    for name in TREE_FIELDS:
        assert torch.equal(getattr(tree, name), getattr(want, name)), name
    assert tree.feat.dtype == torch.float64
    fn = tcb.make_intersect_fn(ts.tables(np.float64, "cpu"), ts.meta(), cbvh)
    held = {id(x) for x in cuda_graph._distinct_tensors(fn.leaves)[0]}
    assert fn.leaves[1].tree is None and not held & {id(x) for x in tree}
    assert id(tree) in fn.key and not fn.capturable
    again = fn.rebind(fn.leaves)
    assert again.key == fn.key and not again.capturable


# ---------------------------------------------------------------------------------
# (e) loops that run a step eagerly when its intersect cannot be captured
# ---------------------------------------------------------------------------------

PM = {"emissions": 2000, "caustic_factor": 2.0, "k_nearest_photons": 8,
      "direct_visualization": False}


ROUTES = ["streamed", "batch", "photon", "trips", "sharded_render", "image_step", "distributed"]


@pytest.mark.parametrize("route", ROUTES)
def test_uncapturable_intersect_runs_eagerly(route, monkeypatch):
    """With every device taken for one that captures (cuda_graph.captures and
    path_tracer._graph_trips patched to True) and the route rule taking
    best-first (as float64 tables do on the card), each entry point that
    builds an intersect from the scene's BVH runs best-first with no tree
    passed, and every step eagerly: a capture would need a card. render()'s
    loops (the streamed and batch path tracer, the photon mapper's emission
    and eye pass) report stats["graphed"] False; the train step keeps no
    captured trip; sharded_render_step's batch runs (a world of one) capture
    nothing; image_step and render_distributed (a world of one) render. The
    image, loss and gradients equal those of the kernel route (its plain
    version) within rtol 1e-10."""
    j = height_field_scene(6, 8, 1, photon_map=PM if route == "photon" else None)
    cfg = mt.RenderConfig(dtype="float64", max_bounces=4, streamed=route != "batch",
                          integrator="photon_mapper" if route == "photon" else "path_tracer",
                          lanes=32)
    ptcfg = tpt.PTConfig(max_bounces=4)

    def run():
        scene = mt.Scene(j)   # a new scene: its BVH is uploaded under the rule in force
        stats = {}
        if route in ("streamed", "batch", "photon"):
            return mt.render(scene, 0, cfg, device="cpu", stats=stats), stats
        if route == "distributed":
            return tdist.render_distributed(scene, 0, cfg, device="cpu"), stats
        tables = scene.tables(np.float64, "cpu")
        cbvh = scene.build_cluster_bvh(np.float64, "cpu")
        stats["tree"] = cbvh.tree is not None
        cam = scene.cameras[0]
        film_cfg = tfilm.FilmConfig.from_json(cam.width, cam.height, cam.film)
        lin = torch.arange(cam.width * cam.height)
        px, py, si = lin % cam.width, lin // cam.width, torch.zeros_like(lin)
        params = {"mat_reflectance": tables.mat_reflectance}
        if route == "trips":
            step = tsh.train_step(scene.meta(), ptcfg, cam, film_cfg, "float64", with_bvh=True,
                                  device="cpu")
            loss, grads = step(tables, cbvh, params, px, py, si,
                               np.zeros((cam.height, cam.width, 3)))
            stats["graphs"] = step.graphs
            return (loss, grads["mat_reflectance"]), stats
        if route == "image_step":
            step = tsh.image_step(scene.meta(), ptcfg, cam, film_cfg, "float64", device="cpu")
            return step(tables, cbvh, params, px, py, si).detach().numpy(), stats
        step = tsh.sharded_render_step(scene.meta(), ptcfg, cam, film_cfg, tsh.LOCAL, "float64",
                                       with_bvh=True, device="cpu")
        film = step(tables, cbvh, px, py, si, torch.zeros((cam.height, cam.width, 4),
                                                          dtype=torch.float64))
        stats["graphed"] = any(run.graphed for run in step.graphs.values())
        for run_ in step.graphs.values():
            run_.close()
        return tfilm.scan(film).numpy(), stats

    want, _ = run()
    bestfirst_calls = []
    real_bestfirst = tcb.traverse_bestfirst
    monkeypatch.setattr(tcb, "traverse_bestfirst",
                        lambda *a, **k: bestfirst_calls.append(1) or real_bestfirst(*a, **k))
    monkeypatch.setattr(tcb, "takes_bestfirst", lambda device, dtype: True)
    monkeypatch.setattr(cuda_graph, "captures", lambda device: True)
    monkeypatch.setattr(tpt, "_graph_trips", lambda device: True)
    got, stats = run()
    assert bestfirst_calls
    if route == "trips":
        assert stats["tree"] and stats["graphs"] == {}
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-10, atol=1e-300)
        return
    if route in ("image_step", "sharded_render"):
        assert stats["tree"]
    if route not in ("image_step", "distributed"):
        assert stats["graphed"] is False
    if route in ("streamed", "batch", "photon"):
        assert stats["bounce_steps"] > 0
    assert float(np.abs(want).max()) > 0.0
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-14)
