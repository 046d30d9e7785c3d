"""Two gloo ranks on the CPU: the port's sharded steps and render_distributed
against one rank and against the JAX package on eight devices; the BVH route
of the train step in a world of one; the dry run.

float64, on the scene, inputs, probe point and bars of
tests/test_torch_sharding.py (the BVH route here, the brute-force route
there). The two ranks are this file run as a script (`__main__` below),
started once for the module by the `ranks` fixture with MCRT_COORDINATOR,
MCRT_NUM_PROCESSES and MCRT_PROCESS_ID set; each writes its results to an
.npz. Their process group and the wait for them time out after 120 s."""
import functools
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import mcrt_tpu_torch as mt
from mcrt_tpu_torch.camera import film as tfilm
from mcrt_tpu_torch.integrator import path_tracer as tpt
from mcrt_tpu_torch.parallel import distributed as tdist
from mcrt_tpu_torch.parallel import sharding as tsh
from test_torch_sharding import (BOUNCES, FILM_TOL, PARAMS, REL, assert_films_close,
                                 assert_step_close, gloo_world_of_one, jax_steps,
                                 port_render_step, port_scene, port_train_step)

torch.set_num_threads(1)  # pytest-xdist runs several workers on the same cores

REPO = pathlib.Path(__file__).resolve().parents[1]
RANKS = 2
TIMEOUT_S = 120.0
# render_distributed's case: 9x9 at one sample per pixel, 81 paths over the
# ranks in chunks of 2 x 16 and a padded tail (a lane of 17 holds one path).
TAIL_WIDTH = 9
TAIL_CFG = dict(dtype="float64", max_bounces=BOUNCES, rays_per_chunk=16)


def rank_main(out_dir: pathlib.Path) -> None:
    """One rank: the render step, the train step (BVH route),
    render_distributed of the 9x9 image, and the film of its padded tail."""
    device = tdist.initialize(device="cpu", timeout_s=TIMEOUT_S)
    try:
        mesh = tdist.global_mesh()
        assert mesh.size == RANKS, mesh
        film = port_render_step(mesh, "bvh")
        loss, grads = port_train_step(mesh, "bvh")
        s9 = port_scene(TAIL_WIDTH)
        img9 = tdist.render_distributed(s9, 0, mt.RenderConfig(**TAIL_CFG), device=device)
        cam = s9.cameras[0]
        step = tsh.sharded_render_step(
            s9.meta(), tpt.PTConfig(max_bounces=BOUNCES), cam,
            tfilm.FilmConfig.from_json(TAIL_WIDTH, TAIL_WIDTH, cam.film), mesh, torch.float64,
            True, device=device)
        n = TAIL_WIDTH * TAIL_WIDTH
        tail = step(s9.tables(np.float64, device), s9.build_cluster_bvh(np.float64, device),
                    *tdist.chunk_pixels(cam, 1, n, 0, n, RANKS, device),
                    torch.zeros((TAIL_WIDTH, TAIL_WIDTH, 4), dtype=torch.float64))
        np.savez(out_dir / f"rank{mesh.rank}.npz", film=film, loss=loss.numpy(), img9=img9,
                 tail=tail.numpy(), **{k: g.numpy() for k, g in grads.items()})
    finally:
        torch.distributed.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's results ({name: array}), after the JAX package's references
    (computed while the ranks run)."""
    out = tmp_path_factory.mktemp("ranks")
    port_scene().build_cluster_bvh(np.float64, "cpu")   # the native BVH builder, built once
    env = dict(os.environ, MCRT_COORDINATOR=f"127.0.0.1:{tdist.free_port()}",
               MCRT_NUM_PROCESSES=str(RANKS),
               PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    procs = [subprocess.Popen([sys.executable, __file__, str(out)], cwd=REPO,
                              env=dict(env, MCRT_PROCESS_ID=str(i)), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for i in range(RANKS)]
    try:
        jax_steps("bvh")
        jax_tail()
        logs = [p.communicate(timeout=TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {i} failed:\n{log[-3000:]}"
    return [dict(np.load(out / f"rank{i}.npz")) for i in range(RANKS)]


@functools.lru_cache(maxsize=None)
def jax_tail():
    """The JAX package's render_distributed of the 9x9 image on eight devices."""
    from mcrt_tpu import RenderConfig as JConfig
    from mcrt_tpu.parallel import distributed as jdist
    from mcrt_tpu.scene.loader import Scene as JScene
    from mcrt_tpu_torch.scene.synthetic import height_field_scene

    return jdist.render_distributed(JScene(height_field_scene(8, TAIL_WIDTH, 1)), 0,
                                    JConfig(**TAIL_CFG))


def test_two_ranks_hold_the_same_results(ranks):
    """Every rank returns the same film, image, loss and gradients."""
    a, b = ranks
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_two_rank_render_step_matches_jax_and_one_rank(ranks):
    """Each rank traced half of the 64 rays; the summed film is the JAX
    package's 8-device film and the one-rank film."""
    film, _, _ = jax_steps("bvh")
    assert_films_close(ranks[0]["film"], film)
    assert_films_close(ranks[0]["film"], port_render_step(tsh.LOCAL, "bvh"))


def test_two_rank_train_step_matches_jax_and_one_rank(ranks):
    """The two-rank loss and gradients are the JAX package's 8-device ones and
    train_step's on one device."""
    r = ranks[0]
    grads = {k: r[k] for k in PARAMS}
    _, want_loss, want = jax_steps("bvh")
    assert_step_close(r["loss"], grads, want_loss, want)
    one_loss, one = port_train_step(None, "bvh")
    assert_step_close(r["loss"], grads, float(one_loss), {k: g.numpy() for k, g in one.items()})


def test_two_rank_gradients_are_not_summed_twice(ranks):
    """The film's cotangent reaches each rank's own film once: the summed
    gradients have the one-rank norm, not twice it (as an all-reduce with a
    backward of its own, followed by the gradient all-reduce, would give)."""
    _, one = port_train_step(None, "bvh")
    for k in PARAMS:
        n1 = float(one[k].norm())
        assert n1 > 0.0, k
        assert abs(float(np.linalg.norm(ranks[0][k])) / n1 - 1.0) <= REL, k


def test_two_rank_render_distributed_keeps_every_sample(ranks):
    """81 paths over two ranks: the padded tail's masked lane adds nothing
    and every pixel keeps its one sample (weight 1 everywhere); the image is
    the JAX package's 8-device render_distributed and the one-rank one."""
    r = ranks[0]
    np.testing.assert_array_equal(r["tail"][..., 3], np.ones((TAIL_WIDTH, TAIL_WIDTH)))
    np.testing.assert_allclose(r["img9"], jax_tail(), rtol=FILM_TOL, atol=FILM_TOL)
    one = tdist.render_distributed(port_scene(TAIL_WIDTH), 0, mt.RenderConfig(**TAIL_CFG),
                                   device="cpu")
    np.testing.assert_allclose(r["img9"], one, rtol=FILM_TOL, atol=FILM_TOL)
    assert r["img9"].mean() > 0.0


def test_train_step_world_of_one_bvh_matches_jax_and_train_step():
    """sharded_train_step with the BVH routed in a gloo world of one: the
    JAX package's 8-device loss and gradients, and train_step's; the bare
    form gives the dict-of-reflectance form's gradient bit for bit."""
    _, want_loss, want = jax_steps("bvh")
    with gloo_world_of_one() as mesh:
        loss, grads = port_train_step(mesh, "bvh")
        refl = port_scene().tables(np.float64, "cpu").mat_reflectance
        _, g_bare = port_train_step(mesh, "bvh", params=refl)
        _, g_dict = port_train_step(mesh, "bvh", params={"mat_reflectance": refl})
    assert_step_close(loss, grads, want_loss, want)
    one_loss, one = port_train_step(None, "bvh")
    assert_step_close(loss, grads, float(one_loss), one)
    assert isinstance(g_bare, torch.Tensor) and torch.equal(g_bare, g_dict["mat_reflectance"])


def test_dryrun_two_cpu_ranks():
    """python -m mcrt_tpu_torch.parallel.dryrun 2 --device cpu exits 0, and
    rank 0 prints the loss and the gradient norm."""
    res = subprocess.run([sys.executable, "-m", "mcrt_tpu_torch.parallel.dryrun", "2",
                          "--device", "cpu"], cwd=REPO, capture_output=True, text=True,
                         timeout=TIMEOUT_S)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert "dryrun(2, cpu): loss=" in res.stdout and "grad_norm=" in res.stdout


if __name__ == "__main__":
    rank_main(pathlib.Path(sys.argv[1]))
