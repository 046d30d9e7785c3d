"""The train cell's run (entries/train_steps.py, reference/train.py) loads
neither JAX nor the JAX package, and its reference loads nothing of the port
(test_bench_nojax.py's rule)."""
import os
import subprocess
import sys

from benchmark import run

REFERENCE = """
import sys
import benchmark.reference.train
print(sorted({m.split('.')[0] for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'mcrt_tpu',
                                                        'mcrt_tpu_torch'}))
"""

CELL = """
import sys, time, torch
sys.path.insert(0, 'benchmark/tests')
torch.set_num_threads(1)
from train_tiny import tiny_train_cell
from benchmark import cell, run
config, traffic, check = tiny_train_cell()
cell.run(config, traffic, check, 3, 0.1, False, 'cpu', time.time())
print(run.banned_modules())
"""


def _run(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, capture_output=True,
                         text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=str(run.ROOT)))
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


def test_train_reference_loads_neither_jax_nor_the_port():
    assert _run(REFERENCE) == "[]"


def test_a_train_run_loads_no_jax():
    assert _run(CELL) == "[]"
