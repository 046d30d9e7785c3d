"""The port's benchmark, mcrt_tpu_torch/bench.py, on the CPU at a tiny size.

The height field at n = 8 (128 triangles), 16x16, 1 spp: the forward point in
one chunk of 2^8 paths through 2^6 lanes, the backward point at 2^10 paths
(one pixel at 1024 spp) and 16 trips. The points' results carry the keys of
the root bench.py's (read from its source, not imported: it drives the JAX
package on a TPU). Without a card the bench raises instead of running on the
CPU. Its numbers on the card come from chip_smoke.py's phase 11."""
import ast
import math
import os
import pathlib
import subprocess
import sys
from unittest import mock

import torch

from mcrt_tpu_torch import bench

torch.set_num_threads(1)  # pytest-xdist runs several workers on the same cores

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _keys(path: pathlib.Path, func: str) -> set:
    """The keys of the largest dict literal in `func` of the file at `path`:
    what bench_ours and bench_bwd return, the line that main prints."""
    tree = ast.parse(path.read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == func)
    lit = max((n for n in ast.walk(fn) if isinstance(n, ast.Dict)), key=lambda n: len(n.keys))
    return {k.value for k in lit.keys}


BENCH_PY = ROOT / "bench.py"


def test_bench_ours_tiny():
    out = bench.bench_ours(bench.bench_scene(8, 16, 1), "cpu", chunk_lg=8, lanes=1 << 6, diag_lg=8)
    assert set(out) == _keys(BENCH_PY, "bench_ours")
    assert out["paths"] == 16 * 16
    assert out["rays"] > out["paths"] and math.isfinite(out["rays_per_s"]) and out["rays_per_s"] > 0
    assert out["rays_per_path"] == out["rays"] / out["paths"]
    # The traversal's [candidates, rounds], summed over the diagnostic's bounces.
    assert out["walk_steps"] > 0 and out["leaf_rounds"] > 0


def test_bench_bwd_tiny():
    seen = []
    real = torch.autograd.grad

    def grad(*args, **kwargs):
        g = real(*args, **kwargs)
        seen.append(g)
        return g

    with mock.patch.object(torch.autograd, "grad", grad):
        out = bench.bench_bwd(bench.bench_scene(8, 16, 1), "cpu", chunk_lg=10, reps=2, trips=16)
    assert set(out) == _keys(BENCH_PY, "bench_bwd")
    assert out["chunk"] == 1 << 10 and out["reps"] == 2
    assert math.isfinite(out["loss"]) and out["loss"] > 0
    assert out["rays"] > 0 and out["rays_per_s"] > 0
    assert len(seen) == 3                          # the warm-up chunk, then the two timed
    for grads in seen:
        assert len(grads) == len(bench.PARAM_KEYS)
        assert all(bool(torch.isfinite(g).all()) for g in grads)
    assert float(seen[-1][0].abs().max()) > 0      # the reflectance gradient


def test_bwd_chunk_forward_alone_and_without_remat():
    """bench_bwd's unit of work, as chip_smoke.py's phase 9b checks it around
    bench_bwd: the chunk traced without gradients traces the same rays, and
    its loss and gradients without remat equal those with it."""
    chunk, params = bench.bwd_chunk(bench.bench_scene(8, 16, 1), "cpu", chunk_lg=10, trips=16)
    with torch.no_grad():
        _, rays_f = chunk(1)
    got = {}
    for remat in (True, False):
        loss, rays = chunk(1, remat=remat)
        got[remat] = (loss.detach(), torch.autograd.grad(loss, list(params.values())))
        assert int(rays) == int(rays_f)
    assert torch.equal(got[True][0], got[False][0])
    for a, b in zip(got[True][1], got[False][1]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-9)
    assert chunk.first_path == 8 * 16 * 1024      # the middle row's first pixel


def test_line_keys_are_bench_py_keys():
    """main's line: bench.py's keys, and the card's."""
    assert _keys(pathlib.Path(bench.__file__), "main") == _keys(BENCH_PY, "main") | {"card"}
    assert bench.METRIC == "pt_rays_per_s_heightfield708_512_16spp"


def test_bench_without_card_raises():
    """`python -m mcrt_tpu_torch.bench` with no card visible and no --device:
    a non-zero exit that names the missing card, and no result line."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, "-m", "mcrt_tpu_torch.bench"], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT), env=env)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert not [line for line in out.stdout.splitlines() if line.startswith("{")]
    assert not any(line.startswith("bench: ") for line in out.stderr.splitlines())


def test_card_line_on_cpu_is_none():
    assert bench.card_line(torch.device("cpu")) is None
