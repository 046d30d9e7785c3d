"""mcrt_tpu_torch: the PyTorch + CUDA port of the mcrt_tpu Monte Carlo renderer.

Beside the JAX package, not built on it: this package imports torch and
nothing of `mcrt_tpu` or JAX. Entry points run on the CUDA device unless the
caller passes device="cpu". The cluster-BVH traversal on the main path is a
hand-written CUDA kernel (csrc/traverse.cu) compiled with nvcc at first use.
"""
from .scene.loader import Scene  # noqa: F401
from .render import RenderConfig, render  # noqa: F401

__version__ = "0.1.0"
