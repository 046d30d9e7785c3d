"""Device and dtype resolution shared by the port's entry points.

Entry points run on the CUDA device unless the caller asks for the CPU. With no
GPU and no explicit request they raise: the port never falls back to the CPU on
its own, so a run on a machine without a card cannot pass for a GPU run.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means the current CUDA device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "mcrt_tpu_torch: no CUDA device is available; pass device='cpu' "
                "to run on the CPU explicitly")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)


def torch_dtype(dtype) -> torch.dtype:
    """'float32' / np.float64 / torch.float32 ... -> torch floating dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return {"float32": torch.float32, "float64": torch.float64}[np.dtype(dtype).name]
