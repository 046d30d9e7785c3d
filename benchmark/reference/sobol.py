"""Frozen copy of mcrt_tpu_torch/sampling/sobol.py for the benchmark's plain reference:
later changes to the port do not reach it.

Hash-based Owen-scrambled Sobol sampling on torch tensors.

The port of the JAX package's stateless sampler (Brent Burley, "Practical
Hash-based Owen Scrambling", JCGT 2020): every sample is a pure function of
(global_seed, pixel_index, sample_index, sequence, dim), so no generator state
is carried. It is bit-exact with the JAX version.

uint32 arithmetic is done in int64 tensors masked to 32 bits: torch has no
`>>`, `<<` or `+` on uint32 on the CPU, and `>>` on int32 is arithmetic.
Products that could leave int64 are split into 16-bit halves (`_mul32`).

Dimension allocation follows the reference (sampling.hpp:59-76):
  sequence 0 (camera):  PIXEL=0,1  LENS=2,3
  sequence b>=1 (bounce b): LIGHT=0,1,2  BSDF=3,4  INTERACTION=5  ABSORB=6
"""
from __future__ import annotations

import functools

import numpy as np
import torch

# Sobol direction numbers for dimensions 2..7 (first dimension is the bit-reversed
# index). Joe-Kuo "new-joe-kuo-6.21201" primitive polynomials, first 6 dims — public
# data (https://web.maths.unsw.edu.au/~fkuo/sobol/), same set the reference uses.
_S = [1, 2, 3, 3, 4, 4]
_A = [0, 1, 1, 2, 1, 4]
_M = [
    [1],
    [1, 3],
    [1, 3, 1],
    [1, 1, 1],
    [1, 1, 3, 3],
    [1, 3, 5, 13],
]

NUM_DIMS = 7  # dim 0 (van der Corput) + 6 tabulated dimensions
_MASK = 0xFFFFFFFF


def _reverse_bits_u32_np(x: np.ndarray) -> np.ndarray:
    x = ((x & 0xAAAAAAAA) >> 1) | ((x & 0x55555555) << 1)
    x = ((x & 0xCCCCCCCC) >> 2) | ((x & 0x33333333) << 2)
    x = ((x & 0xF0F0F0F0) >> 4) | ((x & 0x0F0F0F0F) << 4)
    x = ((x & 0xFF00FF00) >> 8) | ((x & 0x00FF00FF) << 8)
    return ((x >> 16) | (x << 16)) & 0xFFFFFFFF


def _direction_table() -> np.ndarray:
    """(NUM_DIMS-1, 32) bit-reversed direction numbers (uint32)."""
    table = np.zeros((len(_S), 32), dtype=np.uint64)
    for dim in range(len(_S)):
        s, a, m = _S[dim], _A[dim], _M[dim]
        v = np.zeros(32, dtype=np.uint64)
        for bit in range(s):
            v[bit] = np.uint64(m[bit]) << np.uint64(31 - bit)
        for bit in range(s, 32):
            v[bit] = v[bit - s] ^ (v[bit - s] >> np.uint64(s))
            for k in range(1, s):
                v[bit] ^= np.uint64((a >> (s - 1 - k)) & 1) * v[bit - k]
        table[dim] = v
    return _reverse_bits_u32_np(table.astype(np.uint64) & 0xFFFFFFFF).astype(np.uint32)


BIT_REVERSED_DIRECTIONS = _direction_table()


def _byte_table() -> np.ndarray:
    """(NUM_DIMS-1, 4, 256): XOR of the direction numbers that each value of
    each index byte selects, so a Sobol sample is four lookups, not 32 steps."""
    bits = (np.arange(256)[:, None] >> np.arange(8)[None, :]) & 1          # (256, 8)
    dirs = BIT_REVERSED_DIRECTIONS.astype(np.int64).reshape(-1, 4, 1, 8)  # (D, 4, 1, 8)
    return np.bitwise_xor.reduce(np.where(bits[None, None] == 1, dirs, 0), axis=-1)


_BYTE_TABLE = _byte_table()


@functools.lru_cache(maxsize=None)
def _byte_table_on(device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_BYTE_TABLE, device=device)


def as_u32(x, device=None) -> torch.Tensor:
    """Python int / numpy / tensor -> int64 tensor holding a uint32 value."""
    if isinstance(x, torch.Tensor):
        return x.to(torch.int64) & _MASK
    return torch.as_tensor(np.asarray(x, dtype=np.int64) & _MASK, device=device)


def _mul32(x, c: int):
    """(x * c) mod 2^32 for uint32 x (int64 tensor) and a uint32 constant c."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def reverse_bits(x):
    """Bit-reverse uint32 (vectorized)."""
    x = x & _MASK
    x = ((x & 0xAAAAAAAA) >> 1) | ((x & 0x55555555) << 1)
    x = ((x & 0xCCCCCCCC) >> 2) | ((x & 0x33333333) << 2)
    x = ((x & 0xF0F0F0F0) >> 4) | ((x & 0x0F0F0F0F) << 4)
    x = ((x & 0xFF00FF00) >> 8) | ((x & 0x00FF00FF) << 8)
    return ((x >> 16) | (x << 16)) & _MASK


def hash32(x):
    """hash-prospector 2-round low-bias hash (sampler.hpp:76-84 equivalent);
    takes an int64 tensor of uint32 values or a Python int."""
    x = x & _MASK
    x = x ^ (x >> 15)
    x = _mul32(x, 0xD168AAAD)
    x = x ^ (x >> 15)
    x = _mul32(x, 0xAF723597)
    x = x ^ (x >> 15)
    return x


def hash_combine(seed, v):
    """Boost hash_combine on uint32 (tensors or Python ints)."""
    return (seed ^ ((v + 0x9E3779B9 + (seed << 6) + (seed >> 2)) & _MASK)) & _MASK


def laine_karras_scramble(bit_reversed_x, seed):
    """Improved Laine-Karras hash (Vegdahl variant) acting on a bit-reversed value;
    returns the bit-reversed result — i.e. a nested uniform (Owen) scramble."""
    x = bit_reversed_x & _MASK
    x = x ^ _mul32(x, 0x3D20ADEA)
    x = (x + seed) & _MASK
    x = (x * ((seed >> 16) | 1)) & _MASK      # both factors < 2^32 and < 2^16+1
    x = x ^ _mul32(x, 0x05526C56)
    x = x ^ _mul32(x, 0x53A22864)
    return reverse_bits(x)


def sobol_bit_reversed(index, dim: int):
    """Bit-reversed Sobol sample of dimension `dim` at (plain-order) `index`.

    For dim 0 the Sobol sample is reverse_bits(index), whose bit reversal is the
    index itself. For dims >= 1 the tabulated bit-reversed direction numbers
    selected by the index bits are XORed together, a byte at a time."""
    index = index & _MASK
    if dim == 0:
        return index
    tab = _byte_table_on(index.device)[dim - 1]
    return (tab[0][index & 0xFF] ^ tab[1][(index >> 8) & 0xFF]
            ^ tab[2][(index >> 16) & 0xFF] ^ tab[3][index >> 24])


def _u32_to_unit(x, dtype):
    # * 0x1p-32, matching the reference's float conversion
    return x.to(dtype) * (2.0 ** -32)


class SampleCtx:
    """Pure-functional view of the reference sampler state for a batch of paths.

    base_seed = hash_combine(global_seed, hash(pixel_index))      [initiate]
    per sample_index:                                             [setIndex]
        bit_reversed_index = reverse_bits(sample_index)
        sequence 0: seed = base_seed, shuffled_index = sample_index
    per sequence s >= 1:                                          [shuffle]
        seed_s = hash_combine(base_seed, hash(s))
        shuffled_index_s = laine_karras_scramble(bit_reversed_index, seed_s)
    sample(dim) = laine_karras_scramble(sobol_br(shuffled_index), hash_combine(seed, hash(dim))) * 2^-32
    """

    __slots__ = ("seed", "shuffled_index", "base_seed", "bit_reversed_index", "dtype")

    def __init__(self, seed, shuffled_index, base_seed, bit_reversed_index, dtype):
        self.seed = seed
        self.shuffled_index = shuffled_index
        self.base_seed = base_seed
        self.bit_reversed_index = bit_reversed_index
        self.dtype = dtype


def make_ctx(global_seed, pixel_index, sample_index, dtype=torch.float32) -> SampleCtx:
    """Context at sequence 0 (camera dims). Indices are int64 tensors of uint32 values."""
    pixel_index = as_u32(pixel_index)
    sample_index = as_u32(sample_index, pixel_index.device)
    # A Python-int seed stays on the host: uploading it would synchronise the device.
    gseed = as_u32(global_seed) if isinstance(global_seed, torch.Tensor) else int(global_seed) & _MASK
    base_seed = hash_combine(gseed, hash32(pixel_index))
    return SampleCtx(
        seed=base_seed,
        shuffled_index=sample_index,
        base_seed=base_seed,
        bit_reversed_index=reverse_bits(sample_index),
        dtype=dtype,
    )


def shuffled(ctx: SampleCtx, sequence) -> SampleCtx:
    """Context at bounce `sequence` (>= 1): decorrelates (re-pads) the 7 dims."""
    seq = as_u32(sequence, ctx.base_seed.device)
    seed = hash_combine(ctx.base_seed, hash32(seq))
    shuffled_index = laine_karras_scramble(ctx.bit_reversed_index, seed)
    return SampleCtx(seed, shuffled_index, ctx.base_seed, ctx.bit_reversed_index, ctx.dtype)


def sample(ctx: SampleCtx, dim: int):
    """Owen-scrambled Sobol sample in [0,1) for dimension `dim` at the ctx's sequence."""
    br = sobol_bit_reversed(ctx.shuffled_index, dim)
    scrambled = laine_karras_scramble(br, hash_combine(ctx.seed, hash32(dim)))
    return _u32_to_unit(scrambled, ctx.dtype)


def sample_n(ctx: SampleCtx, start_dim: int, n: int):
    """n consecutive dimensions starting at start_dim; returns a tuple."""
    return tuple(sample(ctx, start_dim + i) for i in range(n))
