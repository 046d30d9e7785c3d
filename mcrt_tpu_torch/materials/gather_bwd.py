"""The material gather's backward: rows of cotangents summed by material, in
float64, in a fixed order; the CUDA kernel's wrapper and its plain twin.

`gather_rows_backward(m, grad, M)` returns the (M, C) table whose row k is
the sum of the rows r of `grad` (R, C) with m[r] == k: the backward of
`pack[m]` (bsdf._GatherRows). The sum is taken in float64 for float32 and
float64 cotangents alike and rounded once to grad's dtype, in an order that
depends on (R, M, C) alone (`layout`):

  1. the rows are cut into chunks of CHUNK rows;
  2. a chunk is cut into W runs of CHUNK / W consecutive rows, one a warp;
     each (material, column) slot of a run is the run's rows of that
     material added one after another, from 0.0;
  3. a chunk's slot is its runs' slots added in run order, from 0.0;
  4. the result is the chunks' slots added in chunk order, from 0.0.

W is the most warps, a power of two up to MAX_WARPS, whose W * M * C float64
accumulators fit in SHARED_BYTES (the kernel's shared memory); where one
run's do not fit, W is 1 and the kernel accumulates in global memory. This
module alone decides the layout: the kernel takes CHUNK, W and the choice
of memory as arguments.

CUDA tensors go to the kernel (csrc/gather_bwd.cu), which reads the grad
through its row and column strides, with no copy; CPU tensors go to
`gather_rows_backward_plain`, which sums in the same order, so on the card
the two agree bit for bit; any other device raises. The JAX package has no
such kernel: XLA's scatter-add served it.

`kernel.launches` counts the kernel's calls that ran (a call is two
launches: the chunks' sums and the final sum); a call made under graph
capture goes to `kernel.captured`, and each replay adds what its graph
holds (utils/cuda_graph).
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from ..ops.traverse_kernel import compile_source
from ..utils.cuda_graph import LaunchCounter

CHUNK = 1024               # rows a chunk (a CTA of the kernel)
MAX_WARPS = 16             # runs (warps) a chunk, at most
SHARED_BYTES = 48 * 1024   # float64 accumulators a chunk keeps in shared memory, at most

_SRC = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "gather_bwd.cu"


class _Kernel(LaunchCounter):
    """The built CUDA library (loaded at first use) and its call counts."""

    def __init__(self):
        super().__init__("gather_bwd_kernel")
        self.lib = None
        self.build_log = ""


kernel = _Kernel()


def build() -> ctypes.CDLL:
    """Compile csrc/gather_bwd.cu (once per source content) and load it with ctypes."""
    if kernel.lib is not None:
        return kernel.lib
    lib_path, log = compile_source(_SRC, "gather_bwd")
    lib = ctypes.CDLL(str(lib_path))
    vp, ci, cl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.mcrt_gather_bwd.argtypes = [vp, vp, ci, cl, ci, cl, cl, ci, ci, ci, ci, vp, vp, vp]
    lib.mcrt_gather_bwd.restype = ci
    kernel.build_log = log
    kernel.lib = lib
    return lib


def layout(R: int, M: int, C: int) -> tuple[int, int, bool]:
    """(chunks, warps a chunk, accumulators in shared memory) of a sum of R
    rows of C columns into M materials."""
    per_warp = M * C * 8
    chunks = -(-R // CHUNK)
    if per_warp > SHARED_BYTES:
        return chunks, 1, False
    warps = MAX_WARPS
    while warps * per_warp > SHARED_BYTES:
        warps //= 2
    return chunks, warps, True


def gather_rows_backward(m, grad, M: int):
    """(M, C) in grad's dtype: the rows of grad (R, C) summed by m (R,) int64,
    in float64, in `layout`'s order. Every m[r] lies in [0, M) (the forward's
    pack[m] has checked it)."""
    if grad.device.type == "cpu":
        return gather_rows_backward_plain(m, grad, M)
    if grad.device.type != "cuda":
        raise ValueError(f"gather_rows_backward: unsupported device {grad.device}")
    if grad.dim() != 2 or grad.dtype not in (torch.float32, torch.float64):
        raise ValueError("gather_rows_backward: grad must be (R, C) float32 or float64")
    R, C = grad.shape
    if m.shape != (R,) or m.dtype != torch.int64 or m.device != grad.device:
        raise ValueError("gather_rows_backward: m must be (R,) int64 on grad's device")
    m = m.contiguous()
    chunks, warps, shared = layout(R, M, C)
    dev = grad.device
    partial = torch.empty((chunks, M, C), dtype=torch.float64, device=dev)
    out = torch.empty((M, C), dtype=grad.dtype, device=dev)
    lib = build()
    with torch.cuda.device(dev):
        err = lib.mcrt_gather_bwd(
            m.data_ptr(), grad.data_ptr(), int(grad.dtype == torch.float64), R, C,
            grad.stride(0), grad.stride(1), M, CHUNK, warps, int(shared), partial.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gather_bwd kernel launch failed: error {err}")
    kernel.count()
    return out


def gather_rows_backward_plain(m, grad, M: int):
    """The kernel's function in plain PyTorch, in its order of summation:
    each warp's run is walked one row a step, all runs at once (adding the
    padding's 0.0 past row R is exact), then runs and chunks are added in
    order."""
    R, C = grad.shape
    chunks, warps, _ = layout(R, M, C)
    rows = CHUNK // warps
    runs = chunks * warps
    g = torch.zeros((runs * rows, C), dtype=torch.float64, device=grad.device)
    g[:R] = grad
    mm = torch.zeros(runs * rows, dtype=torch.int64, device=grad.device)
    mm[:R] = m
    g, mm = g.view(runs, rows, C), mm.view(runs, rows)
    acc = torch.zeros((runs, M, C), dtype=torch.float64, device=grad.device)
    run = torch.arange(runs, device=grad.device)
    for j in range(min(rows, R)):
        acc[run, mm[:, j]] = acc[run, mm[:, j]] + g[:, j]
    acc = acc.view(chunks, warps, M, C)
    part = torch.zeros((chunks, M, C), dtype=torch.float64, device=grad.device)
    for w in range(warps):
        part = part + acc[:, w]
    out = torch.zeros((M, C), dtype=torch.float64, device=grad.device)
    for b in range(chunks):
        out = out + part[b]
    return out.to(grad.dtype)
