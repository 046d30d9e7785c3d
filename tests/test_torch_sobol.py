"""The port's Owen-Sobol sampler is bit-exact with the JAX package's."""
import numpy as np
import pytest
import torch

from mcrt_tpu_torch.sampling import sobol as ts

jnp = pytest.importorskip("jax.numpy")
from mcrt_tpu.sampling import sobol as js  # noqa: E402

torch.set_num_threads(1)  # pytest-xdist runs several workers on the same cores

N = 4096


@pytest.fixture(scope="module")
def indices():
    rng = np.random.default_rng(20)
    pix = rng.integers(0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32)
    si = rng.integers(0, 2 ** 32, N, dtype=np.uint64).astype(np.uint32)
    si[:64] = np.arange(64)          # small sample indices too, as renders use
    return pix, si


def _t(x):
    return torch.as_tensor(np.asarray(x).astype(np.int64))


@pytest.mark.parametrize("fn", ["reverse_bits", "hash32"])
def test_uint32_primitives(indices, fn):
    x = indices[0]
    got = getattr(ts, fn)(_t(x)).numpy()
    want = np.asarray(getattr(js, fn)(jnp.asarray(x))).astype(np.int64)
    np.testing.assert_array_equal(got, want)


def test_hash_combine_and_scramble(indices):
    a, b = indices
    np.testing.assert_array_equal(
        ts.hash_combine(_t(a), _t(b)).numpy(),
        np.asarray(js.hash_combine(jnp.asarray(a), jnp.asarray(b))).astype(np.int64))
    np.testing.assert_array_equal(
        ts.laine_karras_scramble(_t(a), _t(b)).numpy(),
        np.asarray(js.laine_karras_scramble(jnp.asarray(a), jnp.asarray(b))).astype(np.int64))


@pytest.mark.parametrize("dim", range(7))
def test_sobol_bit_reversed(indices, dim):
    x = indices[1]
    np.testing.assert_array_equal(
        ts.sobol_bit_reversed(_t(x), dim).numpy(),
        np.asarray(js.sobol_bit_reversed(jnp.asarray(x), dim)).astype(np.int64))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("sequence", [0, 1, 2, 9])
def test_sample_bit_exact(indices, dtype, sequence):
    pix, si = indices
    seed = 12345
    tdt = getattr(torch, dtype)
    ctx = ts.make_ctx(seed, _t(pix), _t(si), tdt)
    jctx = js.make_ctx(seed, jnp.asarray(pix), jnp.asarray(si), getattr(jnp, dtype))
    if sequence:
        ctx = ts.shuffled(ctx, torch.full((N,), sequence, dtype=torch.int64))
        jctx = js.shuffled(jctx, jnp.full((N,), sequence, jnp.uint32))
    for dim in range(ts.NUM_DIMS):
        got = ts.sample(ctx, dim).numpy()
        want = np.asarray(js.sample(jctx, dim))
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want, err_msg=f"dim {dim}")
    for got, want in zip(ts.sample_n(ctx, 2, 3), js.sample_n(jctx, 2, 3), strict=True):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_sample_matches_numpy_reference():
    cases = [(0, 0, 0, 0), (7, 123, 5, 1), (3, 2 ** 32 - 1, 17, 4), (99, 5, 2 ** 31 + 3, 63)]
    for seed, p, s, seq in cases:
        ctx = ts.make_ctx(seed, torch.tensor([p]), torch.tensor([s]), torch.float64)
        if seq:
            ctx = ts.shuffled(ctx, torch.tensor([seq]))
        for dim in range(ts.NUM_DIMS):
            assert ts.sample(ctx, dim).item() == js.np_reference_sample(seed, p, s, seq, dim)


def test_direction_tables_equal():
    np.testing.assert_array_equal(ts.BIT_REVERSED_DIRECTIONS, js.BIT_REVERSED_DIRECTIONS)
