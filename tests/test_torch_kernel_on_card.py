"""The CUDA traversal kernel against its plain PyTorch version, on the card.

Imports no JAX, so it also runs on a machine that has a card and no JAX:

    python3 -m pytest --noconftest -q tests/test_torch_kernel_on_card.py

(`--noconftest`: tests/conftest.py sets up JAX for the JAX package's tests).
Without a card the kernel tests skip: a CUDA kernel has no CPU mode. The ray
sets here are also used by tests/test_torch_traverse.py. The plain version's
fused multiply-add, which makes it the kernel's bit-for-bit twin, is tested on
the CPU."""
import numpy as np
import pytest
import torch

from mcrt_tpu_torch import convert
from mcrt_tpu_torch.accel.bvh_build import build_bvh
from mcrt_tpu_torch.ops import traverse_kernel as tk
from mcrt_tpu_torch.scene.synthetic import make_displaced_grid

PARK = 2e30
KINDS = ("camera", "random", "axis", "parked", "mixed")


def grid_mesh(n=32):
    """A 2 n^2-triangle displaced grid and its fat-leaf (128-triangle) flat BVH."""
    v0, e1, e2 = make_displaced_grid(n)
    mins = np.minimum(np.minimum(v0, v0 + e1), v0 + e2)
    maxs = np.maximum(np.maximum(v0, v0 + e1), v0 + e2)
    flat = build_bvh(mins, maxs, kind="binary_sah", max_leaf=128, dtype=np.float32, strict_leaf=True)
    return (v0, e1, e2), flat


def ray_set(kind, n=768, seed=5):
    """(origin, direction) float32 numpy rays over the grid of `grid_mesh`."""
    rng = np.random.default_rng(seed)
    if kind == "camera":
        # A pinhole above the grid looking down at it. Directions are jittered:
        # a regular lattice of rays over the regular mesh lands exactly on shared
        # edges, where which triangle wins is decided by the last bit of rounding.
        d = np.concatenate([rng.uniform(-0.7, 0.7, (n, 2)), -np.ones((n, 1))], 1)
        o = np.broadcast_to([5.0, 5.0, 6.0], d.shape).copy()
    elif kind == "random":
        # Origins 1.5-4 above the field (height within +-0.5), directions uniform:
        # every hit is at t > 1, where float32 forms summed in different orders
        # agree to the rtol bar; half the rays point away.
        o = np.concatenate([rng.uniform(0, 10, (n, 2)), rng.uniform(1.5, 4.0, (n, 1))], 1)
        d = rng.normal(size=(n, 3))
    elif kind == "axis":
        # Straight down: inv_d has infinite components (the slab-test NaN trap).
        o = np.concatenate([rng.uniform(0.5, 9.5, (n, 2)), np.full((n, 1), 5.0)], 1)
        d = np.broadcast_to([0.0, 0.0, -1.0], (n, 3)).copy()
    elif kind == "parked":
        o = np.full((256, 3), PARK)
        d = np.full((256, 3), 0.57735026)
    elif kind == "mixed":
        o, d = ray_set("camera", n, seed)
        o[::2], d[::2] = PARK, 0.57735026
        return o, d
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def soup_mesh(n=4600, seed=7):
    """n large random triangles in [0, 10]^3, one per cluster (Sp = 32). Each
    box spans about half the cube on every axis, so a block of `soup_rays`
    has about n candidates: more than the kernel keeps in its shared-memory
    heap (4096), which sends every block's heap to global scratch."""
    rng = np.random.default_rng(seed)
    p = rng.uniform(0.0, 10.0, (n, 3, 3))
    v0, e1, e2 = p[:, 0], p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]
    flat = build_bvh(p.min(1), p.max(1), kind="binary_sah", max_leaf=1, dtype=np.float32,
                     strict_leaf=True)
    return (v0, e1, e2), flat


def soup_rays(n=512, seed=7):
    """Rays from a sphere of radius 12 about the cube's center toward random
    points inside it."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(n, 3))
    o = 5.0 - 12.0 * u / np.linalg.norm(u, axis=1, keepdims=True)
    d = rng.uniform(2.0, 8.0, (n, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode); chip_smoke.py runs it")


def _mesh(mesh):
    soup = mesh.startswith("soup")
    (v0, e1, e2), flat = (soup_mesh(int(mesh[4:] or 4600)) if soup else grid_mesh(int(mesh[4:])))
    return convert.cluster_bvh_from_numpy(flat.bb_min, flat.bb_max, flat.first, flat.count,
                                          flat.prim_order, v0, e1, e2, "cuda", np.float32)


def _launch_counted(cb, o, d, width=None, stamp=False):
    """One launch at `width` (None: the rule's), checked to count one launch,
    and one paired launch where it ran as pairs; (outputs, paired)."""
    before, paired = tk.kernel.launches, tk.paired.launches
    out = tk._launch(cb, o, d, stamp=stamp, width=width)
    torch.cuda.synchronize()
    assert tk.kernel.launches == before + 1
    assert tk.paired.launches - paired in (0, 1)
    return out, tk.paired.launches - paired == 1


def _assert_bitwise(k, p, what):
    for name, a, b in zip(("t", "tri_id", "u", "v", "stats"), k, p):
        assert torch.equal(a, b), (what, name)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [1, 2])
@pytest.mark.parametrize("mesh", ["grid32", "grid64", "soup", "soup301"])
def test_kernel_matches_plain_on_card(mesh, width):
    """Bit for bit: ids, t, u, v and per-block stats, one CTA a block (width
    1) and two-CTA clusters (width 2), on at least two blocks per ray set,
    whole parked blocks and mixed live and parked blocks included, and on one
    block of 100 rays (K = 128: the threads of the missing rays only help
    with the cull); on the soup every block's heap lives in global scratch
    (in a pair, the peer writes its first keys there too); the 301-cluster
    soup keeps an odd number of heap entries in shared memory. The stamping
    variant gives the same outputs and one row of cycles a CTA."""
    _needs_card()
    soup = mesh.startswith("soup")
    cb = _mesh(mesh)
    if mesh == "soup301":
        assert cb.rec.shape[0] == 301
    sets = {"soup": soup_rays()} if soup else {kind: ray_set(kind) for kind in KINDS}
    if not soup:
        sets["few"] = ray_set("camera", n=100, seed=9)
    for kind, (o, d) in sets.items():
        if len(o) < 2 * tk.BLOCK and kind != "few":
            o, d = np.concatenate([o, o]), np.concatenate([d, d])
        o, d = torch.as_tensor(o).cuda(), torch.as_tensor(d).cuda()
        k, paired = _launch_counted(cb, o, d, width)
        assert paired == (width == 2)
        _assert_bitwise(k, tk.traverse_plain(cb, o, d), kind)
        st = k[4]
        assert st.shape[0] == 1 if kind == "few" else st.shape[0] >= 2
        if kind == "parked":
            assert (k[1] == -1).all() and int(st[:, 1].max()) == 0
        if mesh == "soup":
            assert int(st[:, 0].min()) > tk.heap_shared() and bool((st[:, 1] < st[:, 0]).all())
        if kind in ("camera", "soup"):
            (*ks, cy), _ = _launch_counted(cb, o, d, width, stamp=True)
            _assert_bitwise(ks, k, f"{kind} stamped")
            assert cy.shape == (width * st.shape[0], len(tk.CYCLES)) and bool((cy[:, 0] > 0).all())
            if width == 2:   # a peer's producer warp does not choose or stage
                assert int(cy[1::2, 2:5].abs().sum()) == 0 and bool((cy[0::2, 2] > 0).all())


@pytest.mark.cuda
def test_launch_pairs_up_to_the_clusters_the_card_holds_on_card():
    """The rule pairs a launch of B blocks when B is at most the two-CTA
    clusters the card holds at once, and not past it: a launch at the limit
    runs as pairs and one a block past it as single CTAs, each bit for bit
    with the plain version. A query for a shape of less shared memory (two
    clusters of four slots) made in between must not refuse the launches."""
    _needs_card()
    cb = _mesh("grid64")
    C, Sp, _ = cb.rec.shape
    limit = tk.resident_pairs(tk.BLOCK, C, Sp)
    assert tk.resident_pairs(tk.BLOCK, 2, 4) >= 1
    assert limit >= 1
    for blocks in (limit, limit + 1):
        o, d = ray_set("camera", n=blocks * tk.BLOCK, seed=11)
        o, d = torch.as_tensor(o).cuda(), torch.as_tensor(d).cuda()
        before, paired = tk.kernel.launches, tk.paired.launches
        k = tk.traverse(cb, o, d)
        torch.cuda.synchronize()
        assert tk.kernel.launches == before + 1
        assert tk.paired.launches - paired == (1 if blocks == limit else 0), blocks
        assert k[4].shape[0] == blocks
        _assert_bitwise(k, tk.traverse_plain(cb, o, d), blocks)


@pytest.mark.cuda
def test_kernel_route_gradients_match_plain_on_card():
    """The train step through the kernel and through the plain traversal on the
    card (the height field at n=32, 16x16, one sample per pixel, max_bounces 6,
    float32, a random target): identical losses, and each of the four tables'
    gradients within 1e-4 of its largest |g|, as are two kernel runs; the bar
    is not bitwise because the backward passes of the row gathers are atomic
    scatter-adds. Each kernel step launches the kernel twice per bounce
    forward and twice more when the backward pass recomputes the bounce."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode); chip_smoke.py runs it")
    from unittest import mock

    import mcrt_tpu_torch as mt
    from mcrt_tpu_torch.camera import film as film_mod
    from mcrt_tpu_torch.integrator import path_tracer as pt
    from mcrt_tpu_torch.parallel import sharding
    from mcrt_tpu_torch.scene.synthetic import height_field_scene

    width, bounces = 16, 6
    scene = mt.Scene(height_field_scene(32, width, 1))
    cam = scene.cameras[0]
    tables = scene.tables(np.float32, "cuda")
    cbvh = scene.build_cluster_bvh(np.float32, "cuda")
    step = sharding.train_step(scene.meta(), pt.PTConfig(max_bounces=bounces), cam,
                               film_mod.FilmConfig.from_json(width, width, cam.film),
                               torch.float32, with_bvh=True, device="cuda")
    params = {k: getattr(tables, k) for k in sharding.DEFAULT_TRAIN_PARAMS}
    rng = np.random.default_rng(6)
    lin = torch.arange(width * width, device="cuda")
    args = (params, lin % width, lin // width, torch.zeros_like(lin),
            torch.as_tensor(rng.random((width, width, 3)) * 0.5, dtype=torch.float32).cuda())
    before = tk.kernel.launches
    loss, grads = step(tables, cbvh, *args)
    torch.cuda.synchronize()
    assert tk.kernel.launches - before == 4 * bounces
    with mock.patch.object(tk, "traverse", tk.traverse_plain):
        plain_loss, plain = step(tables, cbvh, *args)
    again_loss, again = step(tables, cbvh, *args)
    assert torch.equal(loss, plain_loss) and torch.equal(loss, again_loss)
    for name, g in grads.items():
        top = float(g.abs().max())
        assert torch.isfinite(g).all() and top > 0.0, name
        for other in (plain[name], again[name]):
            assert float((g - other).abs().max()) <= 1e-4 * top, name


@pytest.mark.parametrize("blocks,pairs,width", [
    (64, 66, 2), (66, 66, 2), (67, 66, 1), (1, 66, 2), (256, 66, 1), (1024, 66, 1),
    (1, 0, 1), (64, 132, 2), (133, 132, 1),
])
def test_pair_width_pairs_only_what_the_card_holds_at_once(blocks, pairs, width):
    """Two CTAs a block where every block's pair fits on the card at once,
    one otherwise (and when no pair fits at all)."""
    assert tk.pair_width(blocks, pairs) == width


def test_plain_fma_rounds_once():
    """`_fma` is a * b + c rounded once, as the kernel's fmaf. In these cases the
    float64 sum lands exactly on a float32 midpoint while the exact value does
    not, so rounding twice (float64, then float32) gives the wrong neighbour."""
    lo = 2.0 ** -24 * (1 + 2.0 ** -23)
    a = np.float32([lo, -lo, lo, -lo])
    b = np.full(4, 1 - 2.0 ** -23, np.float32)
    c = np.float32([1, 1, -1, -1]) * np.float32(1 + 2.0 ** -23)
    want = c                   # the exact values lie 2^-70 inside c's rounding interval
    twice = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (twice != want).all()
    got = tk._fma(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    assert (got.view(np.int32) == want.view(np.int32)).all()
    rng = np.random.default_rng(3)
    x, y, z = (rng.normal(size=(3, 1000)) * 10.0 ** rng.integers(-3, 3, (3, 1000))).astype(np.float32)
    fused = (x.astype(np.float64) * y + z).astype(np.float32)   # rounds twice only at midpoints
    assert np.array_equal(tk._fma(*(torch.from_numpy(v) for v in (x, y, z))).numpy(), fused)
