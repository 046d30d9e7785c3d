"""mcrt_tpu_torch: the PyTorch + CUDA port of the mcrt_tpu Monte Carlo renderer.

Beside the JAX package, not built on it: this package imports torch and
nothing of `mcrt_tpu` or JAX. Entry points run on the CUDA device unless the
caller passes device="cpu". The cluster-BVH traversal (csrc/traverse.cu),
the photon mapper's exact k-NN (csrc/knn.cu) and the material gather's
float64 backward (csrc/gather_bwd.cu) are hand-written CUDA kernels,
compiled with nvcc at first use. `python -m mcrt_tpu_torch` is the CLI.
"""
from .scene.loader import Scene  # noqa: F401
from .render import RenderConfig, render, render_to_file  # noqa: F401

__version__ = "0.1.0"
