"""The material gather's backward (materials/gather_bwd.py) on the CPU: the
plain twin of the kernel against index_put_ in float64, its layout, the
wrapper's routes, and the Function the gather applies. The kernel itself is
held to the twin on the card in tests/test_torch_gather_on_card.py.

Cotangents have mixed signs and magnitudes from 1e-6 to 1e3, the last
material takes no rows, and a case gives every row to one material. Bar:
each column's float64 sum within 1e-12 of index_put_'s (relative to the
column's norm; two float64 orders of summation agree to about 1e-14 here),
and the result in the cotangent's dtype that sum rounded once."""
from unittest import mock

import numpy as np
import pytest
import torch

from mcrt_tpu_torch.materials import bsdf
from mcrt_tpu_torch.materials import gather_bwd as gb

torch.set_num_threads(1)  # pytest-xdist runs several workers on the same cores

C = 27


def cotangents(R, M, dtype=torch.float32, contiguous=True, seed=0, one_material=None):
    """(m (R,) int64, grad (R, C)): mixed signs, magnitudes 1e-6..1e3; with
    M > 1 the last material takes no rows; `one_material` takes every row. A
    grad that is not contiguous is every other column of an (R, 2C) tensor."""
    rng = np.random.default_rng(seed)
    g = 10.0 ** rng.uniform(-6, 3, (R, C)) * rng.choice([-1.0, 1.0], (R, C))
    if one_material is not None:
        m = np.full(R, one_material)
    else:
        m = rng.integers(0, max(M - 1, 1), R)
    grad = torch.as_tensor(g, dtype=dtype)
    if not contiguous:
        wide = torch.zeros((R, 2 * C), dtype=dtype)
        wide[:, ::2] = grad
        grad = wide[:, ::2]
        assert not grad.is_contiguous()
    return torch.as_tensor(m, dtype=torch.int64), grad


def index_put_sum(m, grad, M):
    acc = torch.zeros((M, grad.shape[1]), dtype=torch.float64, device=grad.device)
    return acc.index_put_((m,), grad.to(torch.float64), accumulate=True)


def assert_close_per_column(got, want, rel=1e-12):
    """Each column of `got` within rel of `want`'s, by the column's norm (a
    column with no rows exactly 0)."""
    assert got.dtype == want.dtype == torch.float64 and got.shape == want.shape
    norm = want.norm(dim=0)
    gap = (got - want).norm(dim=0)
    assert bool((gap <= rel * norm).all()), float((gap / norm.clamp_min(1e-300)).max())


@pytest.mark.parametrize("contiguous", [True, False], ids=["contiguous", "strided"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("M", [1, 4, 37, 300])
@pytest.mark.parametrize("R", [1, 255, 3000, 262_157])
def test_plain_matches_index_put_in_float64(R, M, dtype, contiguous):
    m, grad = cotangents(R, M, dtype, contiguous, seed=R + M)
    sum64 = gb.gather_rows_backward_plain(m, grad.to(torch.float64), M)
    assert_close_per_column(sum64, index_put_sum(m, grad, M))
    got = gb.gather_rows_backward_plain(m, grad, M)
    assert got.dtype == dtype and torch.equal(got, sum64.to(dtype))
    if M > 1:
        assert bool((got[M - 1] == 0).all())


@pytest.mark.parametrize("R", [1, 1024, 262_144])
def test_plain_with_every_row_on_one_material(R):
    m, grad = cotangents(R, 4, seed=3, one_material=2)
    got = gb.gather_rows_backward_plain(m, grad.to(torch.float64), 4)
    assert_close_per_column(got, index_put_sum(m, grad, 4))
    assert bool((got[[0, 1, 3]] == 0).all())


@pytest.mark.parametrize("R,M,want", [
    (262_144, 4, (256, 16, True)),      # the train cell's shape
    (262_157, 4, (257, 16, True)),
    (0, 4, (0, 16, True)),
    (1, 37, (1, 4, True)),              # 37 * 27 doubles: four runs' fit in 48 KiB
    (5000, 227, (5, 1, True)),          # one run's fit, just
    (5000, 228, (5, 1, False)),         # one run's do not: global memory
])
def test_layout_follows_the_shapes_alone(R, M, want):
    assert gb.layout(R, M, C) == want
    chunks, warps, shared = want
    assert warps * M * C * 8 <= gb.SHARED_BYTES or not shared


def test_plain_sums_in_the_layouts_order():
    """A sum whose float64 result depends on the order: 1.0 in the first
    warp's run, then 1e16 and -1e16 in the second's. The runs are summed on
    their own and then added, which keeps the 1.0; a sum in row order loses
    it to 1e16."""
    rows = gb.CHUNK // gb.layout(gb.CHUNK, 1, 1)[1]
    g = torch.zeros((gb.CHUNK, 1), dtype=torch.float64)
    g[0], g[rows], g[rows + 1] = 1.0, 1e16, -1e16
    m = torch.zeros(gb.CHUNK, dtype=torch.int64)
    assert float(gb.gather_rows_backward_plain(m, g, 1)[0, 0]) == 1.0
    assert float(g[:, 0].cumsum(0)[-1]) == 0.0


def test_empty_batch_gives_zeros():
    m, grad = cotangents(0, 4)
    got = gb.gather_rows_backward(m, grad, 4)
    assert got.shape == (4, C) and got.dtype == torch.float32 and bool((got == 0).all())


def test_wrapper_sends_cpu_tensors_to_the_plain_twin():
    m, grad = cotangents(300, 4, seed=5)
    counts = (gb.kernel.launches, gb.kernel.captured)
    with mock.patch.object(gb, "gather_rows_backward_plain",
                           wraps=gb.gather_rows_backward_plain) as plain, \
            mock.patch.object(gb, "build", side_effect=AssertionError("the CPU route built the kernel")):
        got = gb.gather_rows_backward(m, grad, 4)
    assert plain.call_count == 1
    assert torch.equal(got, gb.gather_rows_backward_plain(m, grad, 4))
    assert (gb.kernel.launches, gb.kernel.captured) == counts


def test_wrapper_raises_for_another_device():
    m = torch.zeros(8, dtype=torch.int64, device="meta")
    grad = torch.zeros((8, C), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        gb.gather_rows_backward(m, grad, 4)


def test_gather_backward_is_the_plain_sum_on_cpu():
    """gather_materials applies _GatherRows, whose backward on the CPU is the
    twin's sum, bit for bit, in the pack's dtype."""
    pack = torch.rand((4, C), dtype=torch.float32, requires_grad=True)
    m, grad = cotangents(2000, 4, seed=9)
    with mock.patch.object(bsdf._GatherRows, "apply", wraps=bsdf._GatherRows.apply) as apply:
        rows = bsdf.gather_materials(None, m.to(torch.int32), pack=pack)
    assert apply.call_count == 1
    (got,) = torch.autograd.grad(rows.reflectance, [pack], grad[:, 0:3])
    want = torch.zeros_like(grad)
    want[:, 0:3] = grad[:, 0:3]
    assert got.dtype == torch.float32
    assert torch.equal(got, gb.gather_rows_backward_plain(m, want, 4))
