"""The port's train step against the benchmark's plain reference gradient
(benchmark/reference/train.py), which imports nothing of the port or of JAX.

float32 on the CPU: the benchmark's height field at n = 12 (288 triangles),
16 x 16 pixels, one sample a pixel, 8 bounces, with seeded random material
tables inside their valid ranges and a seeded random target. The bars are
set from what the two give here: the port's loss and gradients come out
equal to the reference's to the last bit on every seed tried (the reference
is the port's per-path arithmetic, frozen, and both sum one block of
float32 cotangents in float64), and the blocked reference differs from the
unblocked one by at most 7e-8 of a table's norm (float32 rounding of the
blocks' partial sums), on seeds 0-5. LOSS_REL and GRAD_REL leave room for
rounding of sums taken in another order, and lie far below what the
reference gives with its tables stored in bfloat16 (the control: loss gaps
1.0e-3-2.2e-3, gradient gaps 0.089-1.29 on seeds 0-5), which must fail them.
"""
import numpy as np
import pytest
import torch

from benchmark.reference import train as ref_train
from benchmark.scenes.height_field import height_field_scene
from mcrt_tpu_torch.camera import film as tfilm
from mcrt_tpu_torch.integrator import path_tracer as tpt
from mcrt_tpu_torch.parallel import sharding as tsh
from mcrt_tpu_torch.scene.loader import Scene

torch.set_num_threads(1)  # pytest-xdist runs several workers on the same cores

N, W, BOUNCES = 12, 16, 8
PARAMS = tsh.DEFAULT_TRAIN_PARAMS
LOSS_REL = 1e-6      # |loss_port - loss_ref| / loss_ref
GRAD_REL = 1e-5      # ||g_port - g_ref|| / ||g_ref||, the worst table
BLOCKED_REL = 1e-6   # the blocked reference against the unblocked one, the worst table
SEEDS = [0, 1, 2]


def random_tables(truth, seed):
    """Seeded random material tables inside their valid ranges: reflectance in
    [0.1, 0.9], GGX roughness in [0.05, 0.8], the dielectrics' ior in [1.2,
    1.8] (a material without one keeps its -1), transparency in [0, 1]."""
    g = torch.Generator().manual_seed(seed)
    u = lambda like, lo, hi: lo + (hi - lo) * torch.rand(like.shape, generator=g, dtype=like.dtype)
    ior = truth["mat_ior"]
    return {"mat_reflectance": u(truth["mat_reflectance"], 0.1, 0.9),
            "mat_specular_roughness": u(truth["mat_specular_roughness"], 0.05, 0.8),
            "mat_ior": torch.where(ior > 1.0, u(ior, 1.2, 1.8), ior),
            "mat_transparency": u(truth["mat_transparency"], 0.0, 1.0)}


def _setup(seed):
    sd = height_field_scene(N, W, 1)
    scene = Scene(sd)
    cam = scene.cameras[0]
    tables = scene.tables(np.float32, "cpu")
    cbvh = scene.build_cluster_bvh(np.float32, "cpu")
    params = random_tables({k: getattr(tables, k) for k in PARAMS}, seed)
    lin = torch.arange(W * W)
    px, py, si = lin % W, lin // W, torch.full_like(lin, seed)
    target = torch.as_tensor(np.random.default_rng(seed).random((W, W, 3)) * 0.5,
                             dtype=torch.float32)
    step = tsh.train_step(scene.meta(), tpt.PTConfig(max_bounces=BOUNCES), cam,
                          tfilm.FilmConfig.from_json(W, W, cam.film), torch.float32,
                          with_bvh=True, device="cpu")
    return sd, tables, cbvh, params, (px, py, si, target), step


def _gaps(loss, grads, want_loss, want_grads, ior):
    """(|loss gap| / loss, the worst table's ||g - g_ref|| / ||g_ref||), the ior
    table over the dielectrics' rows."""
    rows = ior > 0
    worst = 0.0
    for k, w in want_grads.items():
        g, w = grads[k].to(torch.float64), w.to(torch.float64)
        if k == "mat_ior":
            g, w = g[rows], w[rows]
        worst = max(worst, float((g - w).norm() / w.norm()))
    return abs(float(loss) - float(want_loss)) / float(want_loss), worst


def _reference(sd, control=False):
    return ref_train.TrainReference(sd, torch.float32, "cpu", BOUNCES, control=control)


@pytest.mark.parametrize("seed", SEEDS)
def test_train_step_matches_reference(seed):
    """The port's loss and four gradients against the reference's on random
    tables: within LOSS_REL and GRAD_REL, every gradient nonzero."""
    sd, tables, cbvh, params, (px, py, si, target), step = _setup(seed)
    loss, grads = step(tables, cbvh, params, px, py, si, target)
    want_loss, want = _reference(sd).loss_and_grads(params, px, py, si, target)
    assert set(grads) == set(want) == set(PARAMS)
    assert all(float(w.norm()) > 0 for w in want.values())
    loss_gap, grad_gap = _gaps(loss, grads, want_loss, want, params["mat_ior"])
    assert loss_gap <= LOSS_REL and grad_gap <= GRAD_REL, (loss_gap, grad_gap)


@pytest.mark.parametrize("block", [37, 100])
def test_blocked_reference_equals_unblocked(block):
    """The reference in blocks of `block` paths (the film first, then each
    block's vector-Jacobian product with the film's cotangent) against one
    block of every path: within BLOCKED_REL."""
    sd, _, _, params, (px, py, si, target), _ = _setup(5)
    ref = _reference(sd)
    want_loss, want = ref.loss_and_grads(params, px, py, si, target, block=px.shape[0])
    loss, grads = ref.loss_and_grads(params, px, py, si, target, block=block)
    loss_gap, grad_gap = _gaps(loss, grads, want_loss, want, params["mat_ior"])
    assert loss_gap <= BLOCKED_REL and grad_gap <= BLOCKED_REL, (loss_gap, grad_gap)


@pytest.mark.parametrize("seed", SEEDS)
def test_bfloat16_control_fails_the_bars(seed):
    """The reference with its tables stored in bfloat16, in the port's place,
    fails the bars that the port meets."""
    sd, _, _, params, (px, py, si, target), _ = _setup(seed)
    want_loss, want = _reference(sd).loss_and_grads(params, px, py, si, target)
    loss, grads = _reference(sd, control=True).loss_and_grads(params, px, py, si, target)
    loss_gap, grad_gap = _gaps(loss, grads, want_loss, want, params["mat_ior"])
    assert loss_gap > LOSS_REL or grad_gap > GRAD_REL, (loss_gap, grad_gap)
