"""The material gather's backward kernel (csrc/gather_bwd.cu) against its plain
twin, on the card.

Imports no JAX, so it also runs on a machine that has a card and no JAX:

    python3 -m pytest --noconftest -q tests/test_torch_gather_on_card.py

Without a card every test skips: a CUDA kernel has no CPU mode. The twin and
its order of summation are tested on the CPU in tests/test_torch_gather_bwd.py,
whose cotangents (mixed signs, magnitudes 1e-6 to 1e3, the last material with
no rows) these tests share. Bars: the kernel equals the twin bit for bit;
its float64 sums lie within 1e-12 of index_put_'s, column by column (two
float64 orders of summation); a whole train step's gradients through the
kernel lie within one float32 rounding a trip (of each table's largest |g|)
of the same step's through index_put_ in float64."""
from unittest import mock

import numpy as np
import pytest
import torch

from mcrt_tpu_torch.materials import bsdf
from mcrt_tpu_torch.materials import gather_bwd as gb

from test_torch_gather_bwd import C, assert_close_per_column, cotangents, index_put_sum

CELL = 262_144   # the train cell's rays a trip


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode); run on the card")


def _on_card(m, grad):
    return m.cuda(), grad.cuda()


def _laid_out(grad, kind):
    """The same values, contiguous, through strides (1, R) ("transposed"),
    or every other column of an (R, 2C) tensor ("strided")."""
    if kind == "transposed":
        out = grad.t().contiguous().t()
        assert out.stride() == (1, grad.shape[0])
    elif kind == "strided":
        wide = torch.zeros((grad.shape[0], 2 * C), dtype=grad.dtype, device=grad.device)
        wide[:, ::2] = grad
        out = wide[:, ::2]
    else:
        return grad
    assert not out.is_contiguous()
    return out


def _kernel(m, grad, M):
    before = gb.kernel.launches
    out = gb.gather_rows_backward(m, grad, M)
    torch.cuda.synchronize()
    assert gb.kernel.launches == before + 1
    return out


CASES = {
    "cell": (CELL, 4, torch.float32, "contiguous", None),
    "R1": (1, 4, torch.float32, "contiguous", None),
    "R255": (255, 4, torch.float32, "contiguous", None),
    "R_odd": (CELL + 13, 4, torch.float32, "contiguous", None),
    "M1": (CELL + 13, 1, torch.float32, "contiguous", None),
    "M37": (CELL + 13, 37, torch.float32, "contiguous", None),
    "M300_global": (100_000, 300, torch.float32, "contiguous", None),
    "f64": (CELL, 4, torch.float64, "contiguous", None),
    "strided": (CELL, 4, torch.float32, "strided", None),
    "transposed": (CELL + 13, 4, torch.float32, "transposed", None),
    "f64_strided": (3000, 37, torch.float64, "strided", None),
    "one_material": (CELL, 4, torch.float32, "contiguous", 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(CASES))
def test_kernel_matches_plain_bit_for_bit_on_card(case):
    """Every output entry equal to the twin's, in the cotangent's dtype and in
    float64; the float64 sums within 1e-12 of index_put_'s; the float32
    result that float64 sum rounded once. M = 300 takes the global-memory
    layout, M = 37 four warps a chunk, the others sixteen."""
    _needs_card()
    R, M, dtype, kind, one = CASES[case]
    m, grad = _on_card(*cotangents(R, M, dtype, seed=R + M, one_material=one))
    grad = _laid_out(grad, kind)
    if case == "M300_global":
        assert not gb.layout(R, M, C)[2]
    got = _kernel(m, grad, M)
    assert got.dtype == dtype and got.shape == (M, C)
    assert torch.equal(got.cpu(), gb.gather_rows_backward_plain(m.cpu(), grad.cpu(), M))
    sum64 = _kernel(m, grad.to(torch.float64), M)
    assert torch.equal(sum64.cpu(), gb.gather_rows_backward_plain(
        m.cpu(), grad.cpu().to(torch.float64), M))
    assert torch.equal(got, sum64.to(dtype))
    assert_close_per_column(sum64.cpu(), index_put_sum(m, grad, M).cpu())
    if one is not None:
        others = [k for k in range(M) if k != one]
        assert bool((got[others] == 0).all()) and bool((got[one] != 0).all())
    elif M > 1:
        assert bool((got[M - 1] == 0).all())


@pytest.mark.cuda
def test_kernel_same_bits_over_20_calls_on_card():
    _needs_card()
    m, grad = _on_card(*cotangents(CELL, 4, seed=21))
    first = _kernel(m, grad, 4)
    for _ in range(19):
        assert torch.equal(_kernel(m, grad, 4), first)


@pytest.mark.cuda
def test_kernel_captured_and_replayed_on_card():
    """Captured into a CUDA graph the call records its launches (counted in
    `captured`) and runs nothing; each replay gives the eager call's bits,
    also after new values are copied into the graph's static inputs."""
    _needs_card()
    m, grad = _on_card(*cotangents(CELL, 4, seed=31))
    eager = _kernel(m, grad, 4)
    graph = torch.cuda.CUDAGraph()
    captured, launches = gb.kernel.captured, gb.kernel.launches
    with torch.cuda.graph(graph):
        out = gb.gather_rows_backward(m, grad, 4)
    assert (gb.kernel.captured, gb.kernel.launches) == (captured + 1, launches)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    m2, grad2 = _on_card(*cotangents(CELL, 4, seed=32))
    m.copy_(m2)
    grad.copy_(grad2)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out.cpu(), gb.gather_rows_backward_plain(m2.cpu(), grad2.cpu(), 4))
    graph.reset()


class _IndexPutGatherRows(torch.autograd.Function):
    """The gather with its backward summed by index_put_ in float64."""

    @staticmethod
    def forward(ctx, pack, m):
        ctx.save_for_backward(m)
        ctx.pack_shape = pack.shape
        return pack[m]

    @staticmethod
    def backward(ctx, grad):
        (m,) = ctx.saved_tensors
        acc = torch.zeros(ctx.pack_shape, dtype=torch.float64, device=grad.device)
        return acc.index_put_((m,), grad.to(torch.float64), accumulate=True).to(grad.dtype), None


@pytest.mark.cuda
def test_graphed_train_step_matches_index_put_on_card():
    """A graphed train step (the height field at n = 32, 32 x 32, one sample
    a pixel, 8 bounces, float32) under deterministic algorithms, so that the
    film's splat adds in a fixed order: two steps through the kernel give
    the same bits, and the same step with the gather's backward summed by
    index_put_ in float64 gives each table's gradient within one float32
    rounding a trip of the table's largest |g|. The step calls the kernel
    once a G_b replay (and once more in the first call's eager warm-up
    trip)."""
    _needs_card()
    import mcrt_tpu_torch as mt
    from mcrt_tpu_torch.camera import film as film_mod
    from mcrt_tpu_torch.integrator import path_tracer as pt
    from mcrt_tpu_torch.parallel import sharding
    from mcrt_tpu_torch.scene.synthetic import height_field_scene

    width, bounces = 32, 8
    scene = mt.Scene(height_field_scene(32, width, 1))
    cam = scene.cameras[0]
    tables = scene.tables(np.float32, "cuda")
    cbvh = scene.build_cluster_bvh(np.float32, "cuda")
    params = {k: getattr(tables, k) for k in sharding.DEFAULT_TRAIN_PARAMS}
    rng = np.random.default_rng(6)
    lin = torch.arange(width * width, device="cuda")
    args = (tables, cbvh, params, lin % width, lin // width, torch.zeros_like(lin),
            torch.as_tensor(rng.random((width, width, 3)) * 0.5, dtype=torch.float32).cuda())

    def steps():
        step = sharding.train_step(scene.meta(), pt.PTConfig(max_bounces=bounces), cam,
                                   film_mod.FilmConfig.from_json(width, width, cam.film),
                                   torch.float32, with_bvh=True, device="cuda")
        first, second = {}, {}
        step(*args, stats=first)
        loss, grads = step(*args, stats=second)
        torch.cuda.synchronize()
        return first, second, loss, grads

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        first, second, loss, grads = steps()
        _, _, again_loss, again = steps()
        with mock.patch.object(bsdf, "_GatherRows", _IndexPutGatherRows):
            _, ref_stats, ref_loss, ref = steps()
    finally:
        torch.use_deterministic_algorithms(was)
    assert first["gather_bwd_launches"] == first["trip_backward_replays"] + 1 == bounces + 1
    assert second["gather_bwd_launches"] == second["trip_backward_replays"] == bounces
    assert ref_stats["gather_bwd_launches"] == 0
    assert torch.equal(loss, again_loss) and torch.equal(loss, ref_loss)
    for name, g in grads.items():
        assert torch.isfinite(g).all() and float(g.abs().max()) > 0.0, name
        assert torch.equal(g, again[name]), name
        gap = float((g - ref[name]).abs().max())
        assert gap <= bounces * 2.0 ** -23 * float(ref[name].abs().max()), (name, gap)
