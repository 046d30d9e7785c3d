"""The port's sharded steps against the JAX package's on eight devices, in a
world of one; render_distributed's batch arithmetic; RenderConfig.profile_dir;
the new entry points without a card.

float64 on the CPU, on the in-repo height field (`height_field_scene(8, 8,
1)`: diffuse, GGX and glass surfaces under a sphere light, with a "bvh"
block) at 8x8, one sample per pixel, 3 bounces. Sample indices and the
target image are made from a seed with numpy and handed to both packages;
the material tables sit at the probe point of tests/test_torch_grad.py
(transparency 0.5 where nonzero). The JAX package's steps run on
conftest.py's 8-device CPU mesh. The port's world of one is a gloo process
group of one rank in this process, destroyed after each test.

Bars: films within 1e-12 (relative and absolute: float association only);
the loss within 1e-12 relative; gradients within 1e-9 of each table's
largest |g| (tests/test_torch_train_step.py's bars).

Tracing and compiling one differentiable JAX program on eight CPU devices
takes 45-80 s on a core, so the train step's brute-force route is held here
and its BVH route in tests/test_torch_distributed.py, beside the two-rank
runs: the test workers run the two files side by side. Nothing here imports
JAX at module level, because tests/test_torch_distributed.py imports these
helpers into its rank processes."""
import contextlib
import functools
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

import mcrt_tpu_torch as mt
from mcrt_tpu_torch.camera import camera as tcam
from mcrt_tpu_torch.camera import film as tfilm
from mcrt_tpu_torch.integrator import path_tracer as tpt
from mcrt_tpu_torch.parallel import distributed as tdist
from mcrt_tpu_torch.parallel import dryrun
from mcrt_tpu_torch.parallel import sharding as tsh
from mcrt_tpu_torch.scene.synthetic import height_field_scene

torch.set_num_threads(1)  # pytest-xdist runs several workers on the same cores

W = 8
BOUNCES = 3
PARAMS = tsh.DEFAULT_TRAIN_PARAMS
FILM_TOL = 1e-12
LOSS_RTOL = 1e-12
REL = 1e-9          # of each table's largest |g|


@functools.lru_cache(maxsize=None)
def port_scene(width=W):
    return mt.Scene(height_field_scene(8, width, 1))


def inputs():
    """Every pixel once (R = 64 rays), sample indices and a target from a seed."""
    rng = np.random.default_rng(5)
    lin = np.arange(W * W)
    return lin % W, lin // W, rng.integers(0, 16, W * W), rng.random((W, W, 3)) * 0.5


def probe(tables):
    """The four train tables, transparency 0.5 where nonzero."""
    p = {k: getattr(tables, k) for k in PARAMS}
    t = p["mat_transparency"]
    p["mat_transparency"] = (torch.where(t > 0, torch.full_like(t, 0.5), t)
                             if isinstance(t, torch.Tensor) else np.where(t > 0, 0.5, t))
    return p


def port_parts(route):
    s = port_scene()
    tables = s.tables(np.float64, "cpu")
    cbvh = s.build_cluster_bvh(np.float64, "cpu") if route == "bvh" else None
    film_cfg = tfilm.FilmConfig.from_json(W, W, s.cameras[0].film)
    return s, tables, cbvh, film_cfg


def port_render_step(mesh, route):
    """The port's sharded_render_step of the 64 rays onto a zero film."""
    s, tables, cbvh, film_cfg = port_parts(route)
    px, py, si, _ = inputs()
    step = tsh.sharded_render_step(s.meta(), tpt.PTConfig(max_bounces=BOUNCES), s.cameras[0],
                                   film_cfg, mesh, torch.float64, with_bvh=cbvh is not None,
                                   device="cpu")
    args = (tables, cbvh) if cbvh is not None else (tables,)
    film = step(*args, torch.as_tensor(px), torch.as_tensor(py), torch.as_tensor(si),
                torch.zeros((W, W, 4), dtype=torch.float64))
    return film.numpy()


def port_train_step(mesh, route, params=None):
    """The port's sharded_train_step (train_step when mesh is None) at the
    probe point, or at `params` (a dict, or a bare reflectance table)."""
    s, tables, cbvh, film_cfg = port_parts(route)
    px, py, si, target = inputs()
    cfg = tpt.PTConfig(max_bounces=BOUNCES)
    with_bvh = cbvh is not None
    if mesh is None:
        step = tsh.train_step(s.meta(), cfg, s.cameras[0], film_cfg, torch.float64, with_bvh,
                              device="cpu")
    else:
        step = tsh.sharded_train_step(s.meta(), cfg, s.cameras[0], film_cfg, mesh,
                                      torch.float64, with_bvh, device="cpu")
    args = (probe(tables) if params is None else params, torch.as_tensor(px),
            torch.as_tensor(py), torch.as_tensor(si), torch.as_tensor(target))
    return step(tables, cbvh, *args) if with_bvh else step(tables, *args)


@functools.lru_cache(maxsize=None)
def jax_steps(route, train=True):
    """(film, loss, grads) of the JAX package's sharded_render_step and
    sharded_train_step on eight CPU devices (loss and grads None without
    `train`)."""
    import jax
    import jax.numpy as jnp
    from mcrt_tpu.camera import film as jfilm
    from mcrt_tpu.integrator import path_tracer as jpt
    from mcrt_tpu.parallel import sharding as jsh
    from mcrt_tpu.scene.loader import Scene as JScene

    js = JScene(height_field_scene(8, W, 1))
    jt = js.tables(jnp.float64)
    cam = js.cameras[0]
    film_cfg = jfilm.FilmConfig.from_json(W, W, cam.film)
    cfg = jpt.PTConfig(max_bounces=BOUNCES)
    px, py, si, target = inputs()
    u32 = lambda x: jnp.asarray(x, jnp.uint32)
    with_bvh = route == "bvh"
    args = (jt, js.build_cluster_bvh(np.float64)) if with_bvh else (jt,)
    mesh = jsh.make_mesh(jax.devices()[:8])
    with mesh:
        rstep = jsh.sharded_render_step(js.meta(), cfg, cam, film_cfg, mesh, jnp.float64,
                                        with_bvh=with_bvh)
        film = np.asarray(rstep(*args, u32(px), u32(py), u32(si), jnp.zeros((W, W, 4))))
        if not train:
            return film, None, None
        tstep = jsh.sharded_train_step(js.meta(), cfg, cam, film_cfg, mesh, jnp.float64,
                                       with_bvh=with_bvh)
        loss, grads = tstep(*args, probe(jt), u32(px), u32(py), u32(si), jnp.asarray(target))
    return film, float(loss), {k: np.asarray(v) for k, v in grads.items()}


def assert_films_close(got, want):
    np.testing.assert_allclose(got, want, rtol=FILM_TOL, atol=FILM_TOL)


def assert_step_close(loss, grads, want_loss, want):
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    for k in PARAMS:
        a, b = np.asarray(grads[k]), np.asarray(want[k])
        assert np.isfinite(a).all(), k
        assert np.abs(a - b).max() <= REL * np.abs(b).max(), (k, np.abs(a - b).max(), np.abs(b).max())


@contextlib.contextmanager
def gloo_world_of_one():
    """A gloo process group of one rank in this process; its mesh."""
    tdist.initialize(f"127.0.0.1:{tdist.free_port()}", 1, 0, device="cpu", timeout_s=60)
    try:
        yield tdist.global_mesh()
    finally:
        dist.destroy_process_group()


@pytest.fixture
def world_of_one():
    with gloo_world_of_one() as mesh:
        assert mesh.group is not None and (mesh.rank, mesh.size) == (0, 1)
        yield mesh


# ---------------------------------------------------------------------------------
# A world of one against the JAX package on eight devices
# ---------------------------------------------------------------------------------

@pytest.mark.parametrize("route", ["brute", "bvh"])
def test_render_step_world_of_one_matches_jax(world_of_one, route):
    """sharded_render_step in a gloo world of one gives the JAX package's
    8-device film: the film all-reduce sums the same paths."""
    film, _, _ = jax_steps(route, train=False)
    got = port_render_step(world_of_one, route)
    assert_films_close(got, film)
    assert got[..., 3].sum() == W * W and got[..., :3].mean() > 0.0


def _refuse(*args, **kwargs):
    raise AssertionError("the host read a tensor inside the sharded train step")


def test_train_step_world_of_one_matches_jax_and_train_step(world_of_one, monkeypatch):
    """sharded_train_step by brute force in a gloo world of one: the JAX
    package's 8-device loss and gradients, and train_step's, in the dict form;
    the bare form gives the dict-of-reflectance form's gradient bit for bit.
    The step reads no tensor from the host, all-reduces included."""
    _, want_loss, want = jax_steps("brute")
    with monkeypatch.context() as m:
        for name in ("__bool__", "item", "tolist", "__int__", "__float__", "__index__"):
            m.setattr(torch.Tensor, name, _refuse)
        loss, grads = port_train_step(world_of_one, "brute")
    assert set(grads) == set(PARAMS) and not loss.requires_grad
    assert_step_close(loss, grads, want_loss, want)
    one_loss, one = port_train_step(None, "brute")
    assert_step_close(loss, grads, float(one_loss), one)
    refl = probe(port_parts("brute")[1])["mat_reflectance"]
    _, g_bare = port_train_step(world_of_one, "brute", params=refl)
    _, g_dict = port_train_step(world_of_one, "brute", params={"mat_reflectance": refl})
    assert isinstance(g_bare, torch.Tensor) and torch.equal(g_bare, g_dict["mat_reflectance"])


# ---------------------------------------------------------------------------------
# render_distributed's arithmetic, without processes
# ---------------------------------------------------------------------------------

@pytest.mark.parametrize("total", [64, 81, 96, 1 << 18])
def test_process_shard_matches_jax(monkeypatch, total):
    """shard(total, i, 8) is the JAX package's process_shard for process i of
    8; a batch that does not divide raises in both."""
    import jax
    from mcrt_tpu.parallel import distributed as jdist

    for i in range(8):
        monkeypatch.setattr(jax, "process_count", lambda: 8)
        monkeypatch.setattr(jax, "process_index", lambda i=i: i)
        if total % 8:
            with pytest.raises(AssertionError):
                jdist.process_shard(total)
            with pytest.raises(ValueError, match="does not divide"):
                tsh.shard(total, i, 8)
        else:
            assert tsh.shard(total, i, 8) == jdist.process_shard(total)
    assert tdist.process_shard(total) == (0, total)   # no process group: a world of one


def _record_chunks(module, monkeypatch):
    """Patch module.sharded_render_step with a step that records each chunk's
    global (px, py, si) as int64 numpy and returns the film unchanged (with
    the port's `graphs`, which holds no run)."""
    seen = []

    def fake(*args, **kwargs):
        def step(*a):
            px, py, si, film = a[-4:]
            seen.append(tuple(np.asarray(x).astype(np.int64) for x in (px, py, si)))
            return film
        step.graphs = {}
        return step

    monkeypatch.setattr(module, "sharded_render_step", fake)
    return seen


@pytest.mark.parametrize("sqrtspp", [1, 2])
def test_padded_chunks_match_jax_render_distributed(monkeypatch, sqrtspp):
    """At 8 ranks (devices), the port's render_distributed cuts a 9x9 image
    into the JAX package's chunks (rays_per_chunk 16: chunks of 80 or 128
    paths and a tail), with the same pixel and sample of every lane and the
    tail padded with the same masked lanes (x = width + 8)."""
    from mcrt_tpu import RenderConfig as JConfig
    from mcrt_tpu.parallel import distributed as jdist
    from mcrt_tpu.parallel import sharding as jsh
    from mcrt_tpu.scene.loader import Scene as JScene

    j = height_field_scene(8, 9, sqrtspp)
    want = _record_chunks(jsh, monkeypatch)
    jdist.render_distributed(JScene(j), 0, JConfig(dtype="float64", rays_per_chunk=16))
    got = _record_chunks(tsh, monkeypatch)
    monkeypatch.setattr(tdist, "global_mesh", lambda: tsh.Mesh(None, 0, 8))
    tdist.render_distributed(mt.Scene(j), 0, mt.RenderConfig(dtype="float64", rays_per_chunk=16),
                             device="cpu")
    assert len(got) == len(want) >= 2
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    lanes = np.concatenate([c[0] for c in got])
    assert all(c[0].shape[0] % 8 == 0 for c in got)
    assert (lanes != 9 + 8).sum() == 81 * sqrtspp ** 2 and 0 < (lanes == 9 + 8).sum() < 8


def test_float32_samples_stay_in_their_pixel():
    """Every camera sample of a 512x512 image lies in its own pixel in float32:
    the film's splat (the sharded steps, render_distributed) and render()'s
    per-pixel sums then hold the same samples. Unclamped, x + u rounded up to
    x + 1 for 4 of them, and the splat moved them to the next pixel."""
    cam = mt.Scene(height_field_scene(8, 512, 1)).cameras[0]
    lin = torch.arange(512 * 512)
    for dtype in (torch.float32, torch.float64):
        rays = tcam.generate_rays(cam, lin % 512, lin // 512, torch.zeros_like(lin), 0, dtype)
        cell = torch.floor(rays.px).long()
        moved = int(((cell[:, 0] != lin % 512) | (cell[:, 1] != lin // 512)).sum())
        assert moved == 0, f"{dtype}: {moved} samples left their pixel"


def test_material_gradients_are_summed_in_float64():
    """The material gather's backward sums a row's cotangents in float64, so
    a float32 gradient is the exact sum rounded once, and splitting the rays
    in two changes it by one more rounding at most. (Summed in float32, the
    two-rank train step's reflectance gradient on an H100 differed from one
    rank's by 1e-4 of the largest |g|.)"""
    from mcrt_tpu_torch.materials import bsdf

    tables = port_scene().tables(np.float32, "cpu")
    pack = bsdf.pack_materials(tables).detach().requires_grad_()
    rng = np.random.default_rng(7)
    n = 1 << 18
    mat_id = torch.as_tensor(rng.integers(0, pack.shape[0], n))
    w = torch.as_tensor(rng.normal(size=(n, 3)), dtype=torch.float32)

    def grad(lo, hi):
        rows = bsdf.gather_materials(tables, mat_id[lo:hi], pack=pack)
        return torch.autograd.grad((rows.reflectance * w[lo:hi]).sum(), [pack])[0][:, 0:3]

    def exact(lo, hi):
        acc = torch.zeros((pack.shape[0], 3), dtype=torch.float64)
        return acc.index_add_(0, mat_id[lo:hi], w[lo:hi].double()).float()

    whole, h = grad(0, n), n // 2
    split = grad(0, h) + grad(h, n)
    assert torch.equal(whole, exact(0, n)) and torch.equal(split, exact(0, h) + exact(h, n))
    assert float((split - whole).abs().max()) <= 1e-6 * float(whole.abs().max())


def test_render_distributed_world_of_one_is_a_batch_render():
    """With no process group render_distributed is a one-device render by the
    batch tracer: render(streamed=False)'s image, whose chunks differ."""
    s = port_scene()
    cfg = mt.RenderConfig(dtype="float64", max_bounces=BOUNCES, rays_per_chunk=24)
    got = tdist.render_distributed(s, 0, cfg, device="cpu")
    want = mt.render(s, 0, mt.RenderConfig(dtype="float64", max_bounces=BOUNCES, streamed=False),
                     device="cpu")
    assert got.shape == (W, W, 3) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=FILM_TOL, atol=FILM_TOL)


def test_indivisible_batch_raises():
    """R must divide over the ranks, as shard_map requires."""
    s, tables, cbvh, film_cfg = port_parts("brute")
    step = tsh.sharded_render_step(s.meta(), tpt.PTConfig(max_bounces=BOUNCES), s.cameras[0],
                                   film_cfg, tsh.Mesh(None, 0, 2), torch.float64, device="cpu")
    z = torch.zeros(63, dtype=torch.int64)
    with pytest.raises(ValueError, match="63 rays does not divide over 2"):
        step(tables, z, z, z, torch.zeros((W, W, 4), dtype=torch.float64))


def test_make_mesh_without_a_group():
    assert tsh.make_mesh() == tsh.LOCAL == tdist.global_mesh()
    assert tdist.initialize(device="cpu") == torch.device("cpu") and not dist.is_initialized()
    with pytest.raises(ValueError, match="none of them"):
        tdist.initialize(coordinator_address="127.0.0.1:1", device="cpu")


def test_initialize_keeps_only_a_matching_group():
    """A second initialize with the group's own size and rank is a no-op; one
    that asks for another world or rank raises and leaves the group as it is."""
    with gloo_world_of_one() as mesh:
        group = dist.group.WORLD
        assert tdist.initialize("127.0.0.1:1", 1, 0, device="cpu") == torch.device("cpu")
        for n, rank in ((2, 0), (2, 1)):
            with pytest.raises(RuntimeError, match="already exists"):
                tdist.initialize("127.0.0.1:1", n, rank, device="cpu")
        assert dist.group.WORLD is group and tdist.global_mesh() == mesh


# ---------------------------------------------------------------------------------
# RenderConfig.profile_dir
# ---------------------------------------------------------------------------------

def test_profile_dir_writes_a_trace(tmp_path):
    """A render with profile_dir writes one torch.profiler trace there; one
    without writes none; the images are identical."""
    assert mt.RenderConfig().profile_dir is None
    s = port_scene()
    base = dict(dtype="float64", max_bounces=BOUNCES, rays_per_chunk=32)
    prof = tmp_path / "prof"
    traced = mt.render(s, 0, mt.RenderConfig(**base, profile_dir=str(prof)), device="cpu")
    plain = mt.render(s, 0, mt.RenderConfig(**base), device="cpu")
    files = list(prof.glob("*.pt.trace.json"))
    assert len(files) == 1 and list(tmp_path.iterdir()) == [prof]
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    np.testing.assert_array_equal(traced, plain)


# ---------------------------------------------------------------------------------
# No card: the new entry points raise unless asked for the CPU
# ---------------------------------------------------------------------------------

@pytest.mark.parametrize("entry", ["initialize", "render_distributed", "sharded_render_step",
                                   "sharded_train_step", "dryrun"])
def test_entry_points_refuse_cpu_without_request(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    s = port_scene()
    film_cfg = tfilm.FilmConfig(W, W)
    calls = {
        "initialize": lambda: tdist.initialize(),
        "render_distributed": lambda: tdist.render_distributed(s),
        "sharded_render_step": lambda: tsh.sharded_render_step(
            s.meta(), tpt.PTConfig(), s.cameras[0], film_cfg, tsh.LOCAL, np.float32),
        "sharded_train_step": lambda: tsh.sharded_train_step(
            s.meta(), tpt.PTConfig(), s.cameras[0], film_cfg, tsh.LOCAL, np.float32, True),
        "dryrun": lambda: dryrun.launch(2, None),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()
