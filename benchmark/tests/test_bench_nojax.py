"""Nothing the benchmark runs loads JAX or the JAX package, and the reference
loads nothing of the port."""
import os
import subprocess
import sys

from benchmark import run

REFERENCE = """
import sys
import benchmark.reference.tracer, benchmark.reference.closest_hit, benchmark.reference.knn
import benchmark.roofline
print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'mcrt_tpu',
                                                        'mcrt_tpu_torch'}))
"""

CELL = """
import sys, time, torch
sys.path.insert(0, 'benchmark/tests')
torch.set_num_threads(1)
from conftest import tiny_cell
from benchmark import cell, run
config, traffic, check = tiny_cell('pt-hf2m-512-16spp')
cell.run(config, traffic, check, 3, 0.1, False, 'cpu', time.time())
print(run.banned_modules())
"""


def _run(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True,
                         text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=str(run.ROOT)))
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


def test_reference_loads_neither_jax_nor_the_port():
    assert _run(REFERENCE) == "[]"


def test_a_run_loads_no_jax():
    assert _run(CELL) == "[]"
