"""Launches of the port's kernels kept from a profiled render, for the
roofline counts.

The forward loops replay a captured CUDA graph, so a Python wrapper of a
kernel's entry sees only the calls of the capture. Those calls' tensors are
the graph's static buffers, which hold the last replay's values: so after
every EVERY-th replay of a graph (at most PER_GRAPH of them), the launches it
captured are copied. The traversal's rays (after the port's coherence sort)
and the k-NN's queries, mask and map are kept; nothing else is changed, and
nothing syncs the host.
"""
from __future__ import annotations

import contextlib
import importlib
from unittest import mock

import torch

EVERY = 40
PER_GRAPH = 16


class LaunchSamples:
    def __init__(self):
        self.traverse = []   # (origin, direction) of kept traversal launches
        self.knn = []        # (photon positions, points, mask, k) of kept k-NN calls
        self._capturing = None   # the calls of the graph being captured

    def patches(self):
        tk = importlib.import_module("mcrt_tpu_torch.ops.traverse_kernel")
        kk = importlib.import_module("mcrt_tpu_torch.accel.knn_kernel")
        cg = importlib.import_module("mcrt_tpu_torch.utils.cuda_graph")
        rec = self
        real_trav, real_knn = tk.traverse, kk.knn
        real_init, real_replay = cg.CapturedStep.__init__, cg.CapturedStep.replay

        def traverse(cbvh, origin, direction):
            out = real_trav(cbvh, origin, direction)
            if rec._capturing is not None and torch.cuda.is_current_stream_capturing():
                rec._capturing.append(("traverse", (origin, direction)))
            return out

        def knn(grid, arrays, points, k, mask=None, evaluated=None):
            out = real_knn(grid, arrays, points, k, mask=mask, evaluated=evaluated)
            if rec._capturing is not None and torch.cuda.is_current_stream_capturing():
                rec._capturing.append(("knn", (arrays.pos, points, mask, k)))
            return out

        def init(step, fn, state):
            step.bench_calls, step.bench_replays = [], 0
            rec._capturing = step.bench_calls
            try:
                real_init(step, fn, state)
            finally:
                rec._capturing = None

        def replay(step):
            real_replay(step)
            step.bench_replays += 1
            n = step.bench_replays
            if n % EVERY == 0 and n // EVERY <= PER_GRAPH:
                for kind, t in step.bench_calls:
                    if kind == "traverse":
                        rec.traverse.append((t[0].clone(), t[1].clone()))
                    else:
                        pos, points, mask, k = t
                        rec.knn.append((pos, points.clone(),
                                        None if mask is None else mask.clone(), k))

        stack = contextlib.ExitStack()
        stack.enter_context(mock.patch.object(tk, "traverse", traverse))
        stack.enter_context(mock.patch.object(kk, "knn", knn))
        stack.enter_context(mock.patch.object(cg.CapturedStep, "__init__", init))
        stack.enter_context(mock.patch.object(cg.CapturedStep, "replay", replay))
        return stack
